#!/usr/bin/env python3
"""Smoke run of the PIR main path on an NVIDIA GPU.

Drives the system once through the entry points a user calls, at the
reference's headline deployment (2^20 entries x 32 B keys x 1 kB values,
arity 3), and checks every answer exactly against the uint64 numpy
oracle (all products are mod 2^32, so the tolerance is equality):

1. kernels at real widths — the Triton scan and the XLA respond paths at
   b = 8, 9, 10, the digit-plane respond, an adversarial int32-wrap case,
   one ctr hint-chunk fold and the device ctr A slabs;
2. `Server.setup` (ctr, pipelined) + `Client.setup(device=True)`, values
   retrieved pooled and inline, `respond_batch` vs the oracle;
3. the stream-mode (reference-interop) setup and device client at 2^18;
4. the TCP pair (`net.server.PirTcpServer` + `net.client.fetch`) in this
   process.

Run from the repository root:

    python chip_smoke.py                # one card, all phases
    python chip_smoke.py --times        # ... plus kernel times
    python chip_smoke.py --hlo-dir DIR  # ... plus each step's optimized HLO
    python chip_smoke.py --four-cards   # only the 4-card sharded comparison

The last stdout line is one JSON object,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
A failed phase raises, so the script exits non-zero without that line.
Without a GPU it exits 2 before any phase runs.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import re
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


def random_kv_db(n: int, value_len: int, rng) -> dict[bytes, bytes]:
    """n random 32-byte keys -> random value_len-byte values."""
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8).view("V32").ravel().tolist()
    vals = np.frombuffer(rng.bytes(n * value_len), np.uint8).view(f"V{value_len}").tolist()
    db = dict(zip(keys, vals))
    while len(db) < n:  # 32-byte key collisions: vanishingly rare
        db[rng.bytes(32)] = vals[0]
    return db


def oracle(queries: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """(Q, m) x (m, k) mod 2^32 via uint64 wrap."""
    return (queries.astype(np.uint64) @ cols.astype(np.uint64)).astype(np.uint32)


def check(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = "shape" if got.shape != want.shape else int((got != want).sum())
        raise AssertionError(f"{what}: mismatch ({bad} elements differ)")
    log(f"  exact: {what}")


def extreme_queries(q: int, m: int) -> np.ndarray:
    """Queries whose four balanced digits are all -128."""
    from chalametpir_tpu.ops.digits import recode_u32_np

    x = np.uint32((-128 * (1 + (1 << 8) + (1 << 16) + (1 << 24))) % (1 << 32))
    queries = np.full((q, m), x, np.uint32)
    assert (recode_u32_np(queries[:1, :1]) == -128).all()
    return queries


def plane_columns(pdb, cols: np.ndarray) -> np.ndarray:
    """(m, len(cols)) uint32 DB values rebuilt from the device planes."""
    import jax.numpy as jnp

    from chalametpir_tpu.ops.packed import hi_pack_factor

    lo = np.asarray(jnp.take(pdb.lo, jnp.asarray(cols), axis=1))[: pdb.num_rows]
    vals = lo.astype(np.int64) + 128
    if pdb.hi is not None:
        pack = hi_pack_factor(pdb.mat_elem_bit_len)
        bits = 8 // pack if pack > 1 else 8
        pc = pdb.hi.shape[1]
        words = np.asarray(jnp.take(pdb.hi, jnp.asarray(cols % pc), axis=1))[: pdb.num_rows]
        field = ((words.astype(np.int64) >> (bits * (cols // pc))) & ((1 << bits) - 1))
        vals += field << 8
    return vals.astype(np.uint32)


def hlo_summary(text: str) -> dict:
    """What the optimized HLO does with the int8 products."""
    return {
        "cublas_calls": len(re.findall(r'custom_call_target="__cublas', text)),
        "triton_gemms": len(re.findall(r"__triton_gemm|kind=kCustom.*triton", text)),
        "pallas_calls": len(re.findall(r"__gpu\$xla\.gpu\.triton|triton_kernel_call", text)),
        "float_converts": len(re.findall(r"= (?:f32|f16|bf16)\[[^\]]*\]\S* convert\(", text)),
        "pads": len(re.findall(r" pad\(", text)),
        "transposes": len(re.findall(r" transpose\(", text)),
        "copies": len(re.findall(r" copy\(", text)),
    }


def report_compiled(name: str, compiled, hlo_dir: str | None) -> None:
    text = compiled.as_text()
    log(f"  hlo {name}: {hlo_summary(text)}")
    mem = compiled.memory_analysis()
    if mem is not None:
        log(
            f"  memory {name}: args={mem.argument_size_in_bytes} "
            f"out={mem.output_size_in_bytes} temp={mem.temp_size_in_bytes} "
            f"code={mem.generated_code_size_in_bytes}"
        )
    if hlo_dir:
        os.makedirs(hlo_dir, exist_ok=True)
        with open(os.path.join(hlo_dir, f"{name}.hlo.txt"), "w") as f:
            f.write(text)


def time_ms(fn, *args, reps: int = 20) -> float:
    """Mean wall per call over `reps` back-to-back dispatches, ending in
    block_until_ready (the first call, untimed, compiles and warms)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def _retry(fn, key):
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator

    while True:
        try:
            return fn(key)
        except ArithmeticOverflowAddingQueryIndicator:
            continue


# -- phase 1 -------------------------------------------------------------------


def phase_kernels(log_n: int = 20, value_len: int = 1024, q_batch: int = 64,
                  oracle_cols: int = 64, times: bool = False,
                  hlo_dir: str | None = None, seed: int = 1) -> None:
    """Every kept kernel and XLA path at the geometry of 2^log_n entries,
    against the uint64 oracle on all m rows and `oracle_cols` columns."""
    import jax

    from chalametpir_tpu.core import codec, prg
    from chalametpir_tpu.core.filter import filter_geometry
    from chalametpir_tpu.ops import backend, digits, prg_jax, respond
    from chalametpir_tpu.ops.respond_pallas import build_pallas_db, respond_packed_core
    from chalametpir_tpu.params import LWE_DIMENSION

    rng = np.random.default_rng(seed)
    interp = backend.interpret()
    _, _, m = filter_geometry(3, 1 << log_n)
    log(f"phase 1: kernels at 2^{log_n} entries (m = {m})")

    def run_path(queries_dev, pdb, path):
        return respond_packed_core(
            queries_dev, pdb.lo, pdb.hi, pdb.mat_elem_bit_len, pdb.num_cols,
            path, interp,
        )

    for b in (8, 9, 10):
        cols = codec.encoded_row_width(value_len, b)
        mat = rng.integers(0, 1 << b, size=(m, cols), dtype=np.uint16)
        pdb = build_pallas_db(mat, b)
        sub = np.sort(rng.choice(cols, size=min(oracle_cols, cols), replace=False))
        log(f" b={b}: c={cols}, planes {pdb.lo.shape} + "
            f"{None if pdb.hi is None else pdb.hi.shape}")
        for q in (1, q_batch):
            queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
            want = oracle(queries, mat[:, sub])
            q_dev = jax.device_put(queries)
            for path in backend.RESPOND_PATHS:
                got = np.asarray(run_path(q_dev, pdb, path))
                check(got[:, sub], want, f"respond {path} b={b} Q={q}")
                if b == 9 and not interp:
                    report_compiled(
                        f"respond_{path}_b9_q{q}",
                        respond_packed_core.lower(
                            q_dev, pdb.lo, pdb.hi, b, cols, path, interp
                        ).compile(),
                        hlo_dir,
                    )
            if b == 10:
                d0, d1 = (jax.device_put(p) for p in digits.db_digit_planes_np(mat))
                got = np.asarray(respond.respond_batch(q_dev, d0, d1))
                check(got[:, sub], want, f"respond digit2 b={b} Q={q}")
                if not interp:
                    report_compiled(
                        f"respond_digit2_b10_q{q}",
                        respond.respond_batch.lower(q_dev, d0, d1).compile(), hlo_dir,
                    )
                del d0, d1
        if times and b == 9:
            _kernel_times(pdb, mat, m, rng)
        if b == 9:
            _check_hint_fold(pdb, mat, m, rng, hlo_dir, interp)
        del mat, pdb
        gc.collect()

    # adversarial wrap: all-max values x all -128 digits over all m rows
    b = 9
    cols = codec.encoded_row_width(value_len, b)
    mat = np.full((m, cols), (1 << b) - 1, np.uint16)
    queries = extreme_queries(2, m)
    log(f" adversarial: |lo partial| = m*128*127 = {m * 128 * 127} "
        f"({'>' if m * 128 * 127 > 2**31 else '<='} 2^31)")
    want = oracle(queries, mat[:, :oracle_cols])
    pdb = build_pallas_db(mat, b)
    q_dev = jax.device_put(queries)
    for path in backend.RESPOND_PATHS:
        got = np.asarray(run_path(q_dev, pdb, path))
        check(got[:, :oracle_cols], want, f"int32 wrap {path} b={b}")
    d0, d1 = (jax.device_put(p) for p in digits.db_digit_planes_np(mat))
    got = np.asarray(respond.respond_batch(q_dev, d0, d1))
    check(got[:, :oracle_cols], want, "int32 wrap digit2")
    del mat, pdb, d0, d1

    # ctr A slabs: the device generator vs core/prg.py at far offsets,
    # the second one past 2^32 ctr blocks (the high counter word carries)
    seed_bytes = rng.bytes(32)
    sw = prg_jax.seed_to_words(seed_bytes)
    for col0, ncols in ((max(0, m - 4096), 4096), (1 << 27, 1024)):
        got = np.asarray(prg_jax.expand_fp_slab_device(sw, col0, ncols, LWE_DIMENSION))
        want = prg.expand_fp_block(LWE_DIMENSION, col0, ncols, seed_bytes)
        check(got, want, f"ctr A slab at fingerprint {col0} (+{ncols})")
    assert (1 << 27) * LWE_DIMENSION * 4 // prg_jax.RATE > 1 << 32


def _check_hint_fold(pdb, mat, m, rng, hlo_dir, interp) -> None:
    """One ctr hint-chunk fold (Keccak slab + XLA int8 GEMMs) through the
    server's own fold function, vs the host ctr A and the uint64 oracle."""
    import jax.numpy as jnp

    from chalametpir_tpu.core import prg
    from chalametpir_tpu.models import server as server_mod
    from chalametpir_tpu.ops import prg_jax
    from chalametpir_tpu.ops.respond_pallas import ROW_ALIGN
    from chalametpir_tpu.params import LWE_DIMENSION

    seed_bytes = rng.bytes(32)
    cc = min(server_mod._ctr_chunk_cols(m), pdb.lo.shape[0])
    r0 = max(0, (m - cc) // ROW_ALIGN * ROW_ALIGN)
    fold = server_mod._make_fold(tight=False)
    args = (
        prg_jax.seed_to_words(seed_bytes), *prg_jax.fp_block_start(r0, LWE_DIMENSION),
        pdb.lo, pdb.hi if pdb.hi is not None else pdb.lo, jnp.int32(r0),
    )
    kw = dict(cc=cc, c=pdb.num_cols, c_pad=pdb.lo.shape[1],
              bit_len=pdb.mat_elem_bit_len, has_hi=pdb.hi is not None)
    out = np.asarray(fold(*args, **kw))
    a_rows = np.sort(rng.choice(LWE_DIMENSION, size=64, replace=False))
    cols = np.sort(rng.choice(pdb.num_cols, size=64, replace=False))
    rows_in = min(cc, m - r0)
    a = prg.expand_fp_block(LWE_DIMENSION, r0, rows_in, seed_bytes).T  # (k, rows)
    want = oracle(a[a_rows], mat[r0 : r0 + rows_in][:, cols])
    check(out[a_rows][:, cols], want, f"ctr hint fold chunk ({cc} rows at {r0})")
    if not interp:
        report_compiled("hint_fold_chunk", fold.lower(*args, **kw).compile(), hlo_dir)


def _kernel_times(pdb, mat, m, rng) -> None:
    """Hand-written vs XLA times at the 2^20 b = 9 shapes (PERF.md)."""
    import jax
    import jax.numpy as jnp

    from chalametpir_tpu.models import server as server_mod
    from chalametpir_tpu.ops import backend, digits, prg_jax, respond
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine
    from chalametpir_tpu.ops.respond_pallas import respond_packed_core
    from chalametpir_tpu.params import LWE_DIMENSION

    b, cols = pdb.mat_elem_bit_len, pdb.num_cols
    interp = backend.interpret()
    d0, d1 = (jax.device_put(p) for p in digits.db_digit_planes_np(mat))
    log(f" times (ms, mean of 20 back-to-back calls), b={b}, planes "
        f"{pdb.device_bytes / 1e9:.3f} GB packed, "
        f"{(d0.size + d1.size) / 1e9:.3f} GB digit2")
    for q in (1, 4, 16, 64):
        q_dev = jax.device_put(rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32))
        row = {}
        for path in backend.RESPOND_PATHS:
            row[path] = time_ms(
                respond_packed_core, q_dev, pdb.lo, pdb.hi, b, cols, path, interp
            )
        row["digit2"] = time_ms(respond.respond_batch, q_dev, d0, d1)
        # end to end from host queries: copy, scan, readback
        q_host = np.asarray(q_dev)
        for path in backend.RESPOND_PATHS:
            row[f"e2e {path}"] = time_ms(
                lambda p=path: np.asarray(
                    respond_packed_core(q_host, pdb.lo, pdb.hi, b, cols, p, interp)
                ),
                reps=10,
            )
        log(f"  time respond Q={q}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()))
    del d0, d1

    sw = prg_jax.seed_to_words(rng.bytes(32))
    cc = server_mod._ctr_chunk_cols(m)
    blk0, off = prg_jax.fp_block_start(0, LWE_DIMENSION)
    slab_fn = jax.jit(
        lambda sw, blk0, off: prg_jax.rows_from_blocks(sw, blk0, off, cc, LWE_DIMENSION)
    )
    t_slab = time_ms(slab_fn, sw, blk0, off, reps=5)
    g = jnp.pad(slab_fn(sw, blk0, off),
                ((0, 0), (0, server_mod.K_PAD - LWE_DIMENSION))).T
    lo_c, hi_c = pdb.lo[:cc], pdb.hi[:cc]
    row = {
        path: time_ms(respond_packed_core, g, lo_c, hi_c, b, cols, path, interp, reps=5)
        for path in backend.RESPOND_PATHS
    }
    fold = server_mod._make_fold(tight=False)
    t_fold = time_ms(
        lambda: fold(sw, blk0, off, pdb.lo, pdb.hi, jnp.int32(0), cc=cc, c=cols,
                     c_pad=pdb.lo.shape[1], bit_len=b, has_hi=True),
        reps=5,
    )
    log(f"  time hint chunk ({cc} rows): A slab {t_slab:.3f}, GEMM "
        + ", ".join(f"{k} {v:.3f}" for k, v in row.items())
        + f", fold (slab + xla) {t_fold:.3f}")
    t0 = time.perf_counter()
    eng = DeviceQueryEngine.from_seed_ctr(rng.bytes(32), m)
    jax.block_until_ready(eng._planes)
    t_planes = (time.perf_counter() - t0) * 1e3
    codes = rng.integers(0, 3, size=(1, LWE_DIMENSION)).astype(np.int8)
    t_mv = time_ms(eng.matvec_batch_async, codes, reps=5)
    log(f"  time client planes (m={m}, incl. compile): {t_planes:.1f}, "
        f"matvec Q=1 {t_mv:.3f}")
    del eng


# -- phase 2 -------------------------------------------------------------------


def phase_server_client(log_n: int = 20, value_len: int = 1024, n_keys: int = 8,
                        q_batch: int = 64, oracle_cols: int = 64,
                        hlo_dir: str | None = None, seed: int = 2) -> None:
    """ctr setup through the pipelined path + device client round trips."""
    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.ops import backend, client_device
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine

    rng = np.random.default_rng(seed)
    log(f"phase 2: server + device client, ctr, 2^{log_n} x {value_len} B")
    t0 = time.perf_counter()
    db = random_kv_db(1 << log_n, value_len, rng)
    log(f"  db built in {time.perf_counter() - t0:.1f} s")
    pir_seed = rng.bytes(32)
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(
        pir_seed, db, arity=3, backend="jax", prg_mode="ctr", rng=rng
    )
    stats = server.setup_stats
    log(f"  Server.setup {time.perf_counter() - t0:.2f} s (b={server.mat_elem_bit_len}, "
        f"m={server.num_query_cols}, c={server.num_response_cols}); "
        f"phases_s={stats.get('phases_s')} cpu_s={stats.get('cpu_s')}")
    if "phases_s" not in stats:
        raise AssertionError("ctr setup did not take the pipelined path")
    t0 = time.perf_counter()
    client = Client.setup(
        pir_seed, hint, fparams, prg_mode="ctr", device=True,
        prepared_queries=n_keys,
    )
    log(f"  Client.setup(device=True, prepared_queries={n_keys}) "
        f"{time.perf_counter() - t0:.2f} s, engine "
        f"{type(client._engine).__name__}")
    if not isinstance(client._engine, DeviceQueryEngine):
        raise AssertionError("the client did not keep A resident on the device")
    if not backend.interpret():
        import jax

        signs = jax.device_put(np.zeros((1, client_device.K_PAD), np.int8))
        matvec = client_device._jit_of("matvec", client_device._matvec_impl)
        report_compiled("client_matvec_q1",
                        matvec.lower(signs, client._engine._planes).compile(), hlo_dir)

    keys = list(db)[: n_keys + n_keys // 2]
    for i, key in enumerate(keys):
        inline = i >= n_keys
        query = _retry(client.query_inline if inline else client.query, key)
        value = client.process_response(key, server.respond(query))
        if value != db[key]:
            raise AssertionError(f"retrieved value != db[key] (key {i})")
    log(f"  retrieved {n_keys} keys pooled and {len(keys) - n_keys} inline: "
        "every value == db[key]")

    sub = np.sort(rng.choice(server.num_response_cols,
                             size=min(oracle_cols, server.num_response_cols),
                             replace=False))
    db_cols = plane_columns(server._planes, sub)
    for q in (1, 8, q_batch):
        queries = rng.integers(0, 1 << 32, size=(q, server.num_query_cols), dtype=np.uint32)
        check(server.respond_batch(queries)[:, sub], oracle(queries, db_cols),
              f"Server.respond_batch Q={q}")
    del server, client, db


# -- phases 3 and 4 --------------------------------------------------------------


def phase_stream(log_n: int = 18, value_len: int = 1024, n_keys: int = 4,
                 seed: int = 3):
    """Reference-interop setup (host XOF A, packed hint stream) and the
    device client built from the host matrix. Returns what phase 4
    serves."""
    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.ops.client_device import DeviceQueryEngine

    rng = np.random.default_rng(seed)
    log(f"phase 3: stream mode, 2^{log_n} x {value_len} B")
    db = random_kv_db(1 << log_n, value_len, rng)
    pir_seed = rng.bytes(32)
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(
        pir_seed, db, arity=3, backend="jax", prg_mode="stream", rng=rng
    )
    log(f"  Server.setup(prg_mode='stream') {time.perf_counter() - t0:.2f} s "
        f"(layout {server._layout})")
    t0 = time.perf_counter()
    client = Client.setup(pir_seed, hint, fparams, prg_mode="stream", device=True)
    log(f"  Client.setup(device=True) {time.perf_counter() - t0:.2f} s")
    if not isinstance(client._engine, DeviceQueryEngine):
        raise AssertionError("stream-mode client is not on the device")
    for key in list(db)[:n_keys]:
        value = client.process_response(key, server.respond(_retry(client.query, key)))
        if value != db[key]:
            raise AssertionError("stream-mode retrieved value != db[key]")
    log(f"  retrieved {n_keys} keys: every value == db[key]")
    return server, pir_seed, hint, fparams, db


def phase_tcp(server, pir_seed, hint, fparams, db, prg_mode: str = "stream",
              n_keys: int = 3) -> None:
    """PirTcpServer + net.client.fetch over a real socket in this process."""
    from chalametpir_tpu.net.client import fetch
    from chalametpir_tpu.net.server import PirTcpServer

    log("phase 4: TCP pair in-process")
    keys = list(db)[-n_keys:]
    tcp = PirTcpServer(server, pir_seed, hint, fparams)

    async def run():
        srv = await asyncio.start_server(tcp.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        async with srv:
            out = await fetch("127.0.0.1", port, keys, prg_mode=prg_mode, device=True)
        await tcp._dispatcher.aclose()
        return out

    results = asyncio.run(run())
    for key in keys:
        if results.get(key) != db[key]:
            raise AssertionError("TCP fetch value != db[key]")
    log(f"  fetched {n_keys} keys over TCP: every value == db[key]")


# -- four cards --------------------------------------------------------------------


def phase_four_cards(log_n: int = 22, value_len: int = 1024, n_queries: int = 16,
                     n_keys: int = 4, oracle_cols: int = 64, devices=None,
                     seed: int = 4) -> None:
    """Sharded ctr setup on a (data=1, model=4) mesh; its responses must
    equal the same DB served unsharded on the first device byte for byte
    (the int32 partials wrap across shards, so this checks that the
    cross-device sum wraps exactly)."""
    import jax

    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.ops.respond_pallas import PallasDB
    from chalametpir_tpu.parallel import make_mesh

    devices = list(devices if devices is not None else jax.devices())[:4]
    if len(devices) != 4:
        raise AssertionError(f"--four-cards needs 4 devices, found {len(devices)}")
    rng = np.random.default_rng(seed)
    log(f"four cards: sharded ctr setup, 2^{log_n} x {value_len} B, mesh 1x4")
    db = random_kv_db(1 << log_n, value_len, rng)
    pir_seed = rng.bytes(32)
    mesh = make_mesh(devices, data=1, model=4)
    t0 = time.perf_counter()
    server, hint, fparams = Server.setup(
        pir_seed, db, arity=3, prg_mode="ctr", mesh=mesh, rng=rng
    )
    log(f"  Server.setup(mesh=1x4) {time.perf_counter() - t0:.2f} s "
        f"(b={server.mat_elem_bit_len}, m={server.num_query_cols})")
    sharded = server._planes
    one = jax.devices()[0]
    single = Server(
        "jax",
        PallasDB(
            jax.device_put(sharded.lo, one),
            None if sharded.hi is None else jax.device_put(sharded.hi, one),
            sharded.mat_elem_bit_len, sharded.num_rows, sharded.num_cols,
        ),
        server.num_query_cols, server.num_response_cols, server.mat_elem_bit_len,
        "packed",
    )
    queries = rng.integers(0, 1 << 32, size=(n_queries, server.num_query_cols),
                           dtype=np.uint32)
    got = server.respond_batch(queries)
    check(got, single.respond_batch(queries),
          f"sharded respond_batch Q={n_queries} == unsharded on device 0")
    sub = np.arange(min(oracle_cols, server.num_response_cols))
    check(got[:, sub], oracle(queries, plane_columns(single._planes, sub)),
          f"sharded respond_batch Q={n_queries} vs oracle")
    del single
    client = Client.setup(pir_seed, hint, fparams, prg_mode="ctr", device=True)
    keys = list(db)[:n_keys]
    for key, query in zip(keys, client.query_batch(keys)):
        if client.process_response(key, server.respond(query)) != db[key]:
            raise AssertionError("sharded retrieved value != db[key]")
    log(f"  retrieved {n_keys} keys through the sharded server "
        f"(client engine {type(client._engine).__name__}): every value == db[key]")


# -- driver ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded comparison")
    ap.add_argument("--times", action="store_true",
                    help="also time each hand-written kernel against XLA")
    ap.add_argument("--hlo-dir", help="write each step's optimized HLO here")
    args = ap.parse_args(argv)

    import jax
    import jaxlib

    from chalametpir_tpu.utils import telemetry

    smi = telemetry.nvidia_smi_name_and_power_limit()
    log(f"card: {smi} | jax {jax.__version__} jaxlib {jaxlib.__version__} | "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found platform {device.platform!r}",
              file=sys.stderr)
        return 2

    from chalametpir_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for phase in (
            lambda: phase_kernels(times=args.times, hlo_dir=args.hlo_dir),
            lambda: phase_server_client(hlo_dir=args.hlo_dir),
            lambda: phase_tcp(*phase_stream()),
        ):
            t0 = time.perf_counter()
            phase()
            gc.collect()
            log(f"  ({time.perf_counter() - t0:.1f} s)")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(smi or "nvidia-smi unavailable")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
