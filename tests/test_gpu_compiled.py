"""Compiled-mode assertions on a GPU (the chip test tier).

The default suite forces the CPU backend, where the Triton scan runs
through the Pallas interpreter; a compiled kernel can diverge from the
interpreter, so this tier re-runs the exactness assertions compiled, at
small sizes and at the real 2^20 widths. Run on a machine with a GPU:

    make check-gpu        # = PIR_TEST_GPU=1 pytest tests/ -m gpu

Whether a GPU is present is decided in the module fixture below: every
test here skips on the CPU.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

PATHS = ("triton", "xla")


@pytest.fixture(scope="module", autouse=True)
def _require_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `make check-gpu` (PIR_TEST_GPU=1 -m gpu)")
    from chalametpir_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()


def _oracle(q, mat):
    return (q.astype(np.uint64) @ mat.astype(np.uint64)).astype(np.uint32)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("b", [8, 9, 10, 12])
def test_respond_packed_compiled_exact(b, path, rng):
    """Compiled packed respond vs the uint64 numpy oracle in every plane
    regime (lo-only b=8, packed hi b=9/10/12)."""
    import jax

    from chalametpir_tpu.ops import respond_pallas

    m, c = 5000, 150
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    db = respond_pallas.build_pallas_db(mat, b)
    for q in (1, 3, 20):
        queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
        out = np.asarray(
            respond_pallas.respond_batch_packed(jax.device_put(queries), db, path=path)
        )
        assert np.array_equal(out, _oracle(queries, mat)), f"b={b} Q={q}"


@pytest.mark.parametrize("path", PATHS + ("digit2",))
def test_respond_int32_wrap_compiled(path):
    """All-max values x all -128 digits over m > 2^18 rows: every int32
    accumulator passes 2^31 and must wrap exactly mod 2^32."""
    import chip_smoke
    import jax

    from chalametpir_tpu.ops import digits, respond, respond_pallas

    m, c, b = 300_000, 256, 9
    mat = np.full((m, c), (1 << b) - 1, np.uint16)
    queries = chip_smoke.extreme_queries(2, m)
    if path == "digit2":
        d0, d1 = digits.db_digit_planes_np(mat)
        got = respond.respond_batch(jax.device_put(queries), d0, d1)
    else:
        db = respond_pallas.build_pallas_db(mat, b)
        got = respond_pallas.respond_batch_packed(queries, db, path=path)
    assert np.array_equal(np.asarray(got), _oracle(queries, mat))


def test_respond_real_width_compiled(rng):
    """Both respond paths at the 2^20 x 1 kB headline geometry (b = 9),
    all m rows against the oracle on 32 columns."""
    import jax

    from chalametpir_tpu.core import codec
    from chalametpir_tpu.core.filter import filter_geometry
    from chalametpir_tpu.ops import respond_pallas

    _, _, m = filter_geometry(3, 1 << 20)
    b = 9
    cols = codec.encoded_row_width(1024, b)
    mat = rng.integers(0, 1 << b, size=(m, cols), dtype=np.uint16)
    db = respond_pallas.build_pallas_db(mat, b)
    for q in (1, 16, 64):
        queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
        want = _oracle(queries, mat[:, :32])
        for path in PATHS:
            out = respond_pallas.respond_batch_packed(jax.device_put(queries), db, path=path)
            assert np.array_equal(np.asarray(out)[:, :32], want), f"{path} Q={q}"


def test_ctr_prg_compiled_matches_host(rng):
    """Device ctr Keccak vs the host XOF, near zero and past 2^32 blocks."""
    from chalametpir_tpu.core import prg
    from chalametpir_tpu.ops import prg_jax
    from chalametpir_tpu.params import LWE_DIMENSION

    seed = rng.bytes(32)
    sw = prg_jax.seed_to_words(seed)
    a = prg.expand_seed(LWE_DIMENSION, 300, seed, mode="ctr")
    slab = np.asarray(prg_jax.expand_fp_slab_device(sw, 0, 300, LWE_DIMENSION))
    assert np.array_equal(slab.T, a)
    part = np.asarray(prg_jax.expand_fp_slab_device(sw, 37, 11, LWE_DIMENSION))
    assert np.array_equal(part.T, a[:, 37:48])
    far = np.asarray(prg_jax.expand_fp_slab_device(sw, 1 << 27, 64, LWE_DIMENSION))
    assert np.array_equal(far, prg.expand_fp_block(LWE_DIMENSION, 1 << 27, 64, seed))


def test_client_device_matvec_compiled_exact(rng):
    """Compiled device client engine (ctr and stream construction) vs
    host math."""
    from chalametpir_tpu.core import prg
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine
    from chalametpir_tpu.params import LWE_DIMENSION

    m = 500
    seed = rng.bytes(32)
    codes = rng.integers(0, 3, size=LWE_DIMENSION).astype(np.int8)
    for prg_mode in ("ctr", "stream"):
        a = prg.expand_seed(LWE_DIMENSION, m, seed, mode=prg_mode)
        if prg_mode == "ctr":
            eng = DeviceQueryEngine.from_seed_ctr(seed, m)
        else:
            eng = DeviceQueryEngine.from_host_matrix(a)
        got = eng.matvec(codes)
        pos = a[codes == 1].sum(axis=0, dtype=np.uint64)
        neg = a[codes == 2].sum(axis=0, dtype=np.uint64)
        want = (pos - neg).astype(np.uint32)
        assert np.array_equal(got, want), f"matvec mismatch ({prg_mode})"


def test_pipelined_setup_compiled_round_trip(rng):
    """Full pipelined ctr setup + pooled client + respond on the GPU,
    hint checked byte-identical against the numpy oracle."""
    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
    from chalametpir_tpu.utils import generate_random_kv_database

    db = generate_random_kv_database(400, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, backend="jax", prg_mode="ctr", rng=np.random.default_rng(3)
    )
    _, hint_np, fp_np = Server.setup(
        seed, db, backend="numpy", prg_mode="ctr", rng=np.random.default_rng(3)
    )
    assert hint == hint_np and fparams == fp_np
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", prepared_queries=2)
    assert client.uses_device
    for key in list(db.keys())[:2]:
        while True:
            try:
                q = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue
        assert client.process_response(key, server.respond(q)) == db[key]


def test_pipelined_setup_multichunk_buffer_reuse_compiled(rng, monkeypatch):
    """Force a multi-chunk pipeline ON THE GPU so the round-robin
    pack-buffer reuse (reuse_bufs — accelerator-only; the CPU backend's
    device_put can zero-copy alias host buffers, so the CPU-tier sibling
    in test_setup_pipeline.py necessarily runs the fresh-buffer path)
    actually cycles: chunks 3+ rewrite a host buffer a prior device_put
    read from, guarded only by block_until_ready on the arrays produced
    from it. Hint must stay byte-identical to the numpy oracle."""
    from chalametpir_tpu import Server
    from chalametpir_tpu.core.filter import filter_geometry
    from chalametpir_tpu.models import server as server_mod
    from chalametpir_tpu.utils import generate_random_kv_database

    monkeypatch.setattr(server_mod, "_CTR_CHUNK_COLS", 2048)
    db = generate_random_kv_database(8192, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server_jax, hint_jax, fp_jax = Server.setup(
        seed, db, arity=3, backend="jax", prg_mode="ctr",
        rng=np.random.default_rng(11),
    )
    _, _, num_fp = filter_geometry(3, len(db))
    assert -(-num_fp // server_mod._ctr_chunk_cols(num_fp)) >= 3
    server_np, hint_np, fp_np = Server.setup(
        seed, db, arity=3, backend="numpy", prg_mode="ctr",
        rng=np.random.default_rng(11),
    )
    assert fp_jax == fp_np
    assert hint_jax == hint_np
    q = np.random.default_rng(3).integers(
        0, 1 << 32, size=(2, server_np.num_query_cols), dtype=np.uint32
    )
    assert np.array_equal(server_jax.respond_batch(q), server_np.respond_batch(q))


def test_sharded_ctr_hint_single_device_mesh(rng):
    """The shard_map ctr hint path compiled on the GPU (a 1x1 mesh on one
    card — the collective structure still runs)."""
    import jax

    from chalametpir_tpu.core import prg
    from chalametpir_tpu.parallel import (
        build_sharded_pallas_db,
        make_mesh,
        sharded_hint_ctr_packed,
    )
    from chalametpir_tpu.params import LWE_DIMENSION

    mesh = make_mesh(devices=jax.devices()[:1], data=1, model=1)
    m, c, b = 700, 40, 8
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    seed = rng.bytes(32)
    db = build_sharded_pallas_db(mesh, mat, b)
    hint = sharded_hint_ctr_packed(mesh, db, seed)
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="ctr")
    assert np.array_equal(hint[:, :c], _oracle(a, mat))


def test_sharded_respond_single_device_mesh(rng):
    """The shard_map packed respond path compiled on the GPU (1x1 mesh),
    exact vs the uint64 oracle."""
    import jax

    from chalametpir_tpu.parallel import (
        build_sharded_pallas_db,
        make_mesh,
        sharded_respond_packed_fn,
    )

    mesh = make_mesh(devices=jax.devices()[:1], data=1, model=1)
    m, c, b = 900, 48, 9
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    db = build_sharded_pallas_db(mesh, mat, b)
    respond = sharded_respond_packed_fn(mesh, db)
    m_pad = db.lo.shape[0]
    q = rng.integers(0, 1 << 32, size=(2, m), dtype=np.uint32)
    q_pad = np.pad(q, ((0, 0), (0, m_pad - m)))
    out = np.asarray(respond(q_pad))[:, :c]
    assert np.array_equal(out, _oracle(q, mat))


def test_tcp_round_trip_compiled(rng):
    """The TCP pair served by the compiled device respond path, with the
    device client in the same process."""
    import asyncio

    from chalametpir_tpu.models.server import Server
    from chalametpir_tpu.net.client import fetch
    from chalametpir_tpu.net.server import DEMO_DB, PirTcpServer

    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, DEMO_DB, backend="jax", prg_mode="ctr", rng=rng
    )
    tcp = PirTcpServer(server, seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            return await fetch(
                "127.0.0.1", port, [b"banana", b"kiwi"], prg_mode="ctr", device=True
            )

    results = asyncio.run(run())
    assert results[b"banana"] == b"yellow"
    assert results[b"kiwi"] == b"brown"


def test_streaming_engine_compiled_exact(rng):
    """Compiled streaming client engine (per-batch ctr slab gen + fold)
    vs the host matvec."""
    from chalametpir_tpu.core import prg
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine
    from chalametpir_tpu.params import LWE_DIMENSION

    m = 700
    seed = rng.bytes(32)
    a = prg.expand_seed(LWE_DIMENSION, m, seed, mode="ctr")
    eng = DeviceQueryEngine.streaming_from_seed_ctr(seed, m, cols_per_step=256)
    codes = rng.integers(0, 3, size=(2, LWE_DIMENSION)).astype(np.int8)
    got = eng.matvec_batch(codes)
    for i in range(2):
        pos = a[codes[i] == 1].sum(axis=0, dtype=np.uint64)
        neg = a[codes[i] == 2].sum(axis=0, dtype=np.uint64)
        assert np.array_equal(got[i], (pos - neg).astype(np.uint32))
