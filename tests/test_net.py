"""TCP transport round trip with reference framing
(reference: chalametpir_server/examples/server.rs, client examples)."""

import asyncio

import numpy as np
import pytest

from chalametpir_tpu.models.server import Server
from chalametpir_tpu.net.client import fetch
from chalametpir_tpu.net.server import DEMO_DB, PirTcpServer


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_tcp_round_trip(backend, rng):
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend=backend, rng=rng)
    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            results = await fetch("127.0.0.1", port, [b"banana", b"cherry", b"kiwi"])
        return results

    results = asyncio.run(run())
    assert results[b"banana"] == b"yellow"
    assert results[b"cherry"] == b"red"
    assert results[b"kiwi"] == b"brown"


def test_tcp_multiple_clients(rng):
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            a, b = await asyncio.gather(
                fetch("127.0.0.1", port, [b"apple"]),
                fetch("127.0.0.1", port, [b"plum"]),
            )
        return a, b

    a, b = asyncio.run(run())
    assert a[b"apple"] == b"red"
    assert b[b"plum"] == b"purple"


def test_fetch_returns_partial_results_on_server_drop(rng):
    """A transport death mid-fetch must not discard the values already
    retrieved: fetch() marks the remaining keys failed (None) and
    returns, mirroring its per-key decode isolation."""
    from chalametpir_tpu.net.framing import read_frame, write_frame

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)

    async def run():
        async def drop_after_one(reader, writer):
            writer.write(seed)
            write_frame(writer, hint)
            write_frame(writer, fparams)
            await writer.drain()
            q = await read_frame(reader, 1 << 24)
            write_frame(writer, server.respond(q))
            await writer.drain()
            writer.close()  # drop before the second query's response

        srv = await asyncio.start_server(drop_after_one, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch("127.0.0.1", port, [b"banana", b"kiwi", b"plum"])

    results = asyncio.run(run())
    assert results[b"banana"] == b"yellow"
    assert results[b"kiwi"] is None and results[b"plum"] is None


def test_tcp_client_abort_is_quiet(rng):
    """A peer that dies mid-handshake or mid-query is a normal departure:
    handle() must swallow the ConnectionReset/BrokenPipe from its writes
    (not leak an unhandled task exception) and keep serving others."""
    import socket
    import struct

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    tcp = PirTcpServer(server, seed, hint, fparams)
    loop_errors = []

    async def run():
        asyncio.get_running_loop().set_exception_handler(
            lambda loop, ctx: loop_errors.append(ctx)
        )
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            for payload in (b"", struct.pack("<I", 4) + b"ab"):
                # RST-abort (SO_LINGER 0) while the server is mid-write:
                # its next drain() raises ConnectionResetError
                s = socket.create_connection(("127.0.0.1", port))
                s.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
                if payload:
                    s.sendall(payload)
                s.close()
            await asyncio.sleep(0.2)  # let the aborted handlers finish
            return await fetch("127.0.0.1", port, [b"banana"])

    results = asyncio.run(run())
    assert results[b"banana"] == b"yellow"
    assert loop_errors == []


def test_batch_dispatcher_coalesces_concurrent_queries(rng):
    """Many in-flight queries must be answered by fewer device batches."""
    from chalametpir_tpu.core import matrix_io
    from chalametpir_tpu.net.server import BatchDispatcher

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)

    from chalametpir_tpu.models.client import Client

    client = Client.setup(seed, hint, fparams, device=False)
    keys = [b"apple", b"banana", b"grape", b"kiwi", b"plum", b"peach"]
    queries = []
    for k in keys:
        from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator

        while True:
            try:
                queries.append(client.query(k))
                break
            except ArithmeticOverflowAddingQueryIndicator:
                pass

    dispatcher = BatchDispatcher(server, max_batch=8)

    async def run():
        return await asyncio.gather(*(dispatcher.submit(q) for q in queries))

    responses = asyncio.run(run())
    for k, r in zip(keys, responses):
        assert client.process_response(k, r) == DEMO_DB[k]
    # 6 concurrent queries; the first may ride alone but the rest coalesce
    assert dispatcher.batches < len(keys)


def test_batch_dispatcher_pads_to_one_compiled_shape(rng):
    """pad_batches=True must stack every device batch to exactly max_batch
    rows (one compiled shape on the device — micro-batch sizes vary with
    queue luck and would otherwise each pay a compile) while the
    per-query responses stay exact."""
    from chalametpir_tpu.models.client import Client
    from chalametpir_tpu.net.server import BatchDispatcher

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    client = Client.setup(seed, hint, fparams, device=False)
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator

    keys = [b"apple", b"banana", b"grape"]
    queries = []
    for k in keys:
        while True:
            try:
                queries.append(client.query(k))
                break
            except ArithmeticOverflowAddingQueryIndicator:
                pass

    seen_shapes = []
    real = server.respond_batch

    def spying_respond(rows):
        seen_shapes.append(rows.shape)
        return real(rows)

    disp = BatchDispatcher(
        server, max_batch=8, respond_batch_fn=spying_respond, pad_batches=True
    )

    async def run():
        return await asyncio.gather(*(disp.submit(q) for q in queries))

    responses = asyncio.run(run())
    for k, r in zip(keys, responses):
        assert client.process_response(k, r) == DEMO_DB[k]
    assert seen_shapes and all(s[0] == 8 for s in seen_shapes)
    # default OFF when a custom respond_batch_fn is plugged in (the
    # multi-host wrapper broadcasts the stacked rows)
    assert BatchDispatcher(server, respond_batch_fn=real)._pad_batches is False


def test_batch_dispatcher_rejects_malformed():
    import numpy as np

    from chalametpir_tpu.errors import (
        IncompatibleDimensionForRowVectorTransposedMatrixMultiplication,
    )
    from chalametpir_tpu.net.server import BatchDispatcher

    rng = np.random.default_rng(3)
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    dispatcher = BatchDispatcher(server)

    from chalametpir_tpu.core import matrix_io

    bad = matrix_io.matrix_to_bytes(np.zeros((1, 3), np.uint32))

    async def run():
        with pytest.raises(
            IncompatibleDimensionForRowVectorTransposedMatrixMultiplication
        ):
            await dispatcher.submit(bad)

    asyncio.run(run())


def test_serving_state_save_load_round_trip(rng, tmp_path):
    """A restarted server process (--load-state) serves clients without
    re-running setup, answering queries identically."""
    from chalametpir_tpu.net.server import load_serving_state, save_serving_state

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    prefix = str(tmp_path / "serving")
    save_serving_state(prefix, server, seed, hint, fparams)
    server2, seed2, hint2, fparams2 = load_serving_state(prefix)
    assert (seed2, hint2, fparams2) == (seed, hint, fparams)

    tcp = PirTcpServer(server2, seed2, hint2, fparams2)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch("127.0.0.1", port, [b"banana"])

    assert asyncio.run(run())[b"banana"] == b"yellow"


def test_server_survives_hostile_frames(rng):
    """A peer advertising a gigabyte frame (or sending garbage) must get
    dropped without buffering the payload or disturbing other clients."""
    import struct

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            # hostile peer: huge advertised length
            r, w = await asyncio.open_connection("127.0.0.1", port)
            await r.readexactly(32)  # seed
            from chalametpir_tpu.net.framing import read_frame

            await read_frame(r)  # hint
            await read_frame(r)  # filter params
            w.write(struct.pack("<I", 1 << 30) + b"\x00" * 64)
            await w.drain()
            assert await r.read(1) == b""  # server closed on us
            w.close()

            # garbage query bytes of a plausible size: protocol error,
            # connection dropped, server still alive
            r2, w2 = await asyncio.open_connection("127.0.0.1", port)
            await r2.readexactly(32)
            await read_frame(r2)
            await read_frame(r2)
            w2.write(struct.pack("<I", 40) + b"\xff" * 40)
            await w2.drain()
            assert await r2.read(1) == b""
            w2.close()

            # a well-behaved client is still served
            return await fetch("127.0.0.1", port, [b"apple"])

    assert asyncio.run(run())[b"apple"] == b"red"


def test_fetch_query_helper_reports_pending_conflicts_per_key(rng):
    """A key whose pending entry survived (e.g. after a malformed
    response) must not abort the remaining fetches: the query helper
    returns None for it and real keys keep working."""
    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.net.client import _query_or_none
    from chalametpir_tpu.utils import generate_random_kv_database

    db = generate_random_kv_database(100, rng=rng, value_byte_len=(4, 32))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, backend="numpy", rng=rng)
    client = Client.setup(seed, hint, fparams, device=False)
    k1, k2 = list(db)[:2]
    q1 = _query_or_none(client, k1)
    assert q1 is not None
    # k1 now has a pending entry (no response processed yet): a repeat
    # request reports None instead of raising out of the fetch loop
    assert _query_or_none(client, k1) is None
    q2 = _query_or_none(client, k2)
    assert client.process_response(k2, server.respond(q2)) == db[k2]
    assert client.process_response(k1, server.respond(q1)) == db[k1]


def test_tcp_round_trip_pooled_client(rng):
    """fetch(pool=N) runs the FrodoPIR offline preprocessing after setup;
    results must be identical to the inline path."""
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch(
                "127.0.0.1", port, [b"banana", b"cherry"], pool=8
            )

    results = asyncio.run(run())
    assert results[b"banana"] == b"yellow"
    assert results[b"cherry"] == b"red"


def test_tcp_server_mesh_flag_serves_sharded(rng):
    """--mesh 1x8 builds a mesh-sharded server behind the same TCP
    surface (on the test tier: the 8-device virtual CPU mesh)."""
    from chalametpir_tpu.parallel import make_mesh

    seed = rng.bytes(32)
    mesh = make_mesh(data=1, model=8)
    server, hint, fparams = Server.setup(
        seed, DEMO_DB, mesh=mesh, prg_mode="ctr", rng=rng
    )
    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch("127.0.0.1", port, [b"kiwi"], prg_mode="ctr")

    assert asyncio.run(run())[b"kiwi"] == b"brown"


def test_batch_dispatcher_aclose_quiesces(rng):
    """aclose(): in-flight work completes, late submissions get a clean
    ConnectionError, and no respond call can start afterwards (the
    multi-host shutdown broadcast relies on exactly this ordering)."""
    from chalametpir_tpu.net.server import BatchDispatcher
    from chalametpir_tpu.core import matrix_io
    import numpy as np

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, DEMO_DB, backend="numpy", rng=rng)
    calls = []

    def counting_respond(rows):
        calls.append(rows.shape[0])
        return server.respond_batch(rows)

    disp = BatchDispatcher(server, respond_batch_fn=counting_respond)
    q = np.zeros((1, server.num_query_cols), np.uint32)
    q_bytes = matrix_io.matrix_to_bytes(q)

    async def run():
        out = await disp.submit(q_bytes)
        assert out  # served
        await disp.aclose()
        with pytest.raises(ConnectionError):
            await disp.submit(q_bytes)

    asyncio.run(run())
    assert sum(calls) == 1  # nothing ran after the quiesce


@pytest.mark.parametrize("argv,want", [([], False), (["--device", "host"], False),
                                       (["--device", "gpu"], True)])
def test_client_cli_device_option(argv, want, monkeypatch, capsys):
    """The TCP client keeps A on the host unless --device gpu: a second
    JAX process on a server's card would find its memory reserved."""
    from chalametpir_tpu.net import client as net_client

    seen = {}

    async def fake_fetch(host, port, keys, prg_mode, device, pool):
        seen["device"] = device
        return {k: b"v" for k in keys}

    monkeypatch.setattr(net_client, "fetch", fake_fetch)
    net_client.main(["--key", "banana"] + argv)
    assert seen["device"] is want
    assert "banana: v" in capsys.readouterr().out
