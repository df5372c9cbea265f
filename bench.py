"""Benchmark harness: reproduces the reference's divan config matrix.

Every line this harness prints to stdout is a COMPACT (<1.8 KB),
self-contained JSON record — headline fields, the device the run used,
and one short dict per completed config — and each line supersedes the
previous one, so a cut run still leaves a parseable last line. The full
record (every field, phase breakdowns) is continuously rewritten to
BENCH_FULL.json next to this file.

Every record names its device: `device` carries JAX's platform,
device_kind and device count, and the `nvidia-smi` name and power limit.

Compact row legend (full names in BENCH_FULL.json):
  c   config, e.g. "20a3" = 2^20 entries arity 3 ("s" suffix = prg=stream,
      the reference-interop mode; no suffix = ctr, A generated on device)
  b   mat_elem_bit_len                su  server_setup seconds
  fl  setup upload seconds (device_put + drain, from server.setup_stats)
  rs  server_respond ms (single)     gb  respond scan GB/s (ref convention)
  bq  batched respond ms/query       q   pooled client_query ms
  qi  inline client_query ms         e2  serialized respond e2e ms
  pr  process_response us (median-32)

Respond is measured as the slope of k chained scans inside one jit (each
iteration's query depends on the previous response, so XLA can neither
hoist nor parallelise the scans) — constant overheads cancel exactly.

Env knobs:
  PIR_BENCH_LOG_N      log2 of headline DB entries (default 20)
  PIR_BENCH_ARITY      3 or 4 (default 3)
  PIR_BENCH_VALUE_LEN  value bytes (default 1024)
  PIR_BENCH_BATCH      batched-respond size (default 64)
  PIR_BENCH_BUDGET_S   wall budget; stages are skipped when the remaining
                       budget cannot fit them (default 1200)
  PIR_BENCH_MATRIX     "0" disables the small-config matrix
  PIR_BENCH_STREAM     "0" disables the stream-mode (interop) rows
  PIR_BENCH_PRG        headline PRG mode: "ctr" (default) or "stream"
  PIR_BENCH_SCALING_LOG_N  real-setup scaling size (default 22; 0 off)
  PIR_BENCH_PROFILE    directory: capture a jax profiler trace around the
                       headline respond measurement
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

LOG_N = int(os.environ.get("PIR_BENCH_LOG_N", "20"))
ARITY = int(os.environ.get("PIR_BENCH_ARITY", "3"))
VALUE_LEN = int(os.environ.get("PIR_BENCH_VALUE_LEN", "1024"))
BATCH = int(os.environ.get("PIR_BENCH_BATCH", "64"))
BUDGET_S = float(os.environ.get("PIR_BENCH_BUDGET_S", "1200"))
RUN_MATRIX = os.environ.get("PIR_BENCH_MATRIX", "1") not in ("0", "")
RUN_STREAM = os.environ.get("PIR_BENCH_STREAM", "1") not in ("0", "")
PRG_MODE = os.environ.get("PIR_BENCH_PRG", "ctr")

BASELINE_RESPOND_GBPS = 102.51  # m8g.8xlarge, README.md:60-61
T_START = time.perf_counter()

FULL_PATH = os.environ.get("PIR_BENCH_FULL_PATH") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "BENCH_FULL.json"
)
MAX_LINE = 1800  # hard cap: the driver's tail window is ~2 KB


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter()-T_START:6.1f}s] {msg}", file=sys.stderr, flush=True)


def left() -> float:
    return BUDGET_S - (time.perf_counter() - T_START)


# ---------------------------------------------------------------------------
# compact-artifact state: one short dict per config, rebuilt and re-printed
# after every completed (or partially completed) stage

_SHORT = [
    ("server_setup_s", "su", 1),
    ("server_setup_upload_s", "fl", 1),
    ("server_respond_ms", "rs", 3),
    ("respond_scan_GBps", "gb", 1),
    ("server_respond_batch_per_query_ms", "bq", 4),
    ("client_query_ms", "q", 2),
    ("client_query_inline_ms", "qi", 1),
    ("server_respond_e2e_ms", "e2", 1),
    ("client_process_response_us", "pr", 1),
]
# dropped from compact rows first (fat record keeps everything) if the
# final line would overflow the driver's tail window
_TRIM_ORDER = ["bq", "pr", "fl", "qi"]

STATE: dict = {
    "result": {
        "metric": "server_respond_db_scan_GBps",
        "value": None,
        "unit": "GB/s",
        "vs_baseline": None,
        "device": None,
    },
    "rows": [],  # compact per-config dicts, in run order
    "fat_rows": [],  # full per-config dicts, same order
    "scaling": [],
}


def _compact(rec: dict) -> dict:
    cfg = rec.get("config", "?")
    # "2^20x1024B arity3 prg=ctr" -> "20a3"; stream mode gets an "s" suffix
    short = cfg
    if cfg.startswith("2^"):
        body = cfg[2:]
        logn = body.split("x")[0]
        ar = body.split("arity")[1][0] if "arity" in body else "?"
        short = f"{logn}a{ar}" + ("s" if "stream" in cfg else "")
        if "SYNTH" in cfg:
            short += "synth"
    out = {"c": short}
    if "b" in rec:
        out["b"] = rec["b"]
    for full, key, nd in _SHORT:
        if rec.get(full) is not None:
            out[key] = round(rec[full], nd)
    # cap free-text fields: multiple ~110-char skip projections in one
    # run would overflow MAX_LINE and force whole measured
    # rows out of the compact line (the fat record keeps the full text)
    if "skipped" in rec:
        out["skip"] = rec["skipped"][:60]
    if "error" in rec:
        out["err"] = rec["error"][:60]
    return out


def emit_state() -> None:
    """Print the compact record (guaranteed <= MAX_LINE bytes) to stdout
    and rewrite the fat record to BENCH_FULL.json."""
    res = STATE["result"]
    line_obj = dict(res)
    # copies: the overflow trimming below must not eat STATE's own rows
    line_obj["rows"] = [dict(r) for r in STATE["rows"]]
    if STATE["scaling"]:
        line_obj["scaling"] = [dict(r) for r in STATE["scaling"]]
    line_obj["full"] = "BENCH_FULL.json"
    line = json.dumps(line_obj, separators=(",", ":"))
    for drop in _TRIM_ORDER:
        if len(line) <= MAX_LINE:
            break
        for row in line_obj["rows"]:
            row.pop(drop, None)
        line = json.dumps(line_obj, separators=(",", ":"))
    while len(line) > MAX_LINE and len(line_obj["rows"]) > 1:
        # last resort: drop the oldest non-headline row entirely
        line_obj["rows"].pop(1)
        line = json.dumps(line_obj, separators=(",", ":"))
    print(line, flush=True)
    try:
        fat = {
            **res,
            "legend": "see bench.py docstring; rows are full-name records",
            "rows": STATE["fat_rows"],
            "scaling": STATE["scaling_fat"] if STATE.get("scaling_fat") else STATE["scaling"],
            "extra": STATE.get("extra_fat", []),
        }
        with open(FULL_PATH, "w") as f:
            json.dump(fat, f, indent=1)
        global _FULL_WRITTEN
        _FULL_WRITTEN = True
    except Exception as e:  # the stdout artifact must never die to disk I/O
        log(f"BENCH_FULL.json write failed: {e!r}")


# has THIS run written FULL_PATH yet? Guards the atexit vmstat hook: a
# run that dies before its first emit_state must not stamp its deltas
# into a previous round's committed artifact.
_FULL_WRITTEN = False


def add_row(rec: dict) -> int:
    STATE["rows"].append(_compact(rec))
    STATE["fat_rows"].append(rec)
    return len(STATE["rows"]) - 1


def update_row(idx: int, rec: dict) -> None:
    STATE["rows"][idx] = _compact(rec)
    STATE["fat_rows"][idx] = rec


# ---------------------------------------------------------------------------

_db_cache: dict = {}


def build_db(n: int, value_len: int, rng: np.random.Generator) -> dict[bytes, bytes]:
    """Random KV DB; the most recent (n, value_len) build is cached so the
    arity-3 and arity-4 rows of one size share it (a 2^20 dict takes ~40 s
    of pure Python to construct — rebuilding it was most of the budget
    that used to squeeze the 2^20 arity-4 row out of the artifact)."""
    key = (n, value_len)
    if key in _db_cache:
        return _db_cache[key]
    from chalametpir_tpu.native.engine import alloc_array

    # values must be genuinely random (incompressible, like real data).
    # Generate into a MAP_POPULATE buffer in chunks (a GB-scale
    # rng.bytes() spends seconds demand-paging its output) and
    # materialize bytes objects via numpy 'V' views, not a Python loop.
    vals_buf = alloc_array((n * value_len,), np.uint8)
    step = 64 << 20
    for i in range(0, vals_buf.size, step):
        chunk = min(step, vals_buf.size - i)
        vals_buf[i : i + chunk] = np.frombuffer(rng.bytes(chunk), np.uint8)
    keys_buf = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    # V (void) dtype, not S: numpy S-dtype strips trailing NUL bytes on
    # tolist(), silently shortening ~1/256 of the keys/values
    keys = keys_buf.view("V32").ravel().tolist()
    vals = vals_buf.view(f"V{value_len}").tolist()
    db = dict(zip(keys, vals))
    while len(db) < n:  # vanishingly unlikely 32-byte key collisions
        k = rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()
        db[k] = vals[0]
    _db_cache.clear()  # keep at most one DB alive
    _db_cache[key] = db
    return db


def make_respond_chain(server):
    """Returns scan_seconds(queries, nq): the per-scan latency measured as
    the slope of k chained DB scans inside one jit.

    The loop body is the respond path plus a one-element XOR dependency,
    so the chained program stays small."""
    import jax
    import jax.numpy as jnp

    if server._layout == "packed":
        from chalametpir_tpu.ops import backend
        from chalametpir_tpu.ops.respond_pallas import respond_packed_core

        db = server._planes
        interp = backend.interpret()

        # planes are call-time jit arguments: captured arrays would bake the
        # database into the program hash (fresh compile per DB)
        @jax.jit
        def chain_packed(q, k, lo, hi):
            path = backend.respond_path(q.shape[0])

            def body(i, q):
                out = respond_packed_core(
                    q, lo, hi, db.mat_elem_bit_len, db.num_cols, path, interp
                )
                return q ^ (jnp.max(out) & 1)

            return jnp.max(jax.lax.fori_loop(0, k, body, q))

        def chain(q, k):
            return chain_packed(q, k, db.lo, db.hi)

        def prepare(queries, nq):
            return jax.device_put(np.resize(queries, (nq, queries.shape[1])))
    else:
        from chalametpir_tpu.ops import respond as respond_ops

        d0, d1 = server._planes

        @jax.jit
        def chain_digit2(q, k, p0, p1):
            def body(i, q):
                out = respond_ops.respond_batch(q, p0, p1)
                return q ^ jnp.max(out)

            return jnp.max(jax.lax.fori_loop(0, k, body, q))

        def chain(q, k):
            return chain_digit2(q, k, d0, d1)

        def prepare(queries, nq):
            return jax.device_put(np.resize(queries, (nq, queries.shape[1])))

    def _slope(q_dev, k_lo, k_hi, reps=3):
        out = {}
        for k in (k_lo, k_hi):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                float(np.asarray(chain(q_dev, k)))
                best = min(best, time.perf_counter() - t0)
            out[k] = best
        return (out[k_hi] - out[k_lo]) / (k_hi - k_lo)

    def scan_seconds(queries, nq, k_lo=4, k_hi=24):
        q_dev = prepare(queries, nq)
        float(np.asarray(chain(q_dev, 1)))  # compile+warm
        slope = _slope(q_dev, k_lo, k_hi)
        # small DBs scan in tens of us — grow k until the measured delta
        # clears timer/dispatch noise (>= ~30 ms between the two points)
        while slope * (k_hi - k_lo) < 0.03 and k_hi < 4096:
            k_lo, k_hi = k_lo * 8, k_hi * 8
            slope = _slope(q_dev, k_lo, k_hi)
        return max(slope, 1e-9)

    return scan_seconds


def _setup_stats_fields(rec: dict, server) -> None:
    """Copy server.setup_stats attribution into a bench row — the ONE
    mapping for headline and scaling rows alike, so a new stats field
    can't silently diverge between the two row shapes.

    The fields: the upload seconds and bytes measured inside the setup
    itself, the per-thread CPU split (models/server.py: main + worker +
    runtime + external), and the worker page-fault count."""
    stats = getattr(server, "setup_stats", None) or {}
    if stats.get("upload_bytes"):
        rec["server_setup_upload_GB"] = round(stats["upload_bytes"] / 1e9, 3)
        rec["server_setup_upload_s"] = stats["upload_s"]
        if stats["upload_s"]:
            rec["server_setup_upload_GBps"] = round(
                stats["upload_bytes"] / 1e9 / stats["upload_s"], 4
            )
        if stats.get("phases_s"):
            rec["server_setup_phases_s"] = stats["phases_s"]
    if stats.get("cpu_s"):
        rec["server_setup_cpu_s"] = stats["cpu_s"]
    if stats.get("worker_minflt") is not None:
        rec["server_setup_worker_minflt"] = stats["worker_minflt"]


def run_config(log_n, arity, value_len, rng, prg_mode="ctr", batch=None,
               client_device="auto", emit=None):
    """Run one divan config; returns a metrics dict. `emit(partial)` is
    called as soon as the respond scan number exists. The GC freeze taken
    while the config's DB dict is hot is undone afterwards so finished
    configs stay collectable."""
    import gc

    try:
        return _run_config(log_n, arity, value_len, rng, prg_mode=prg_mode,
                           batch=batch, client_device=client_device, emit=emit)
    finally:
        gc.unfreeze()
        gc.collect()


def _run_config(log_n, arity, value_len, rng, prg_mode, batch, client_device,
                emit):
    from chalametpir_tpu import Server
    from chalametpir_tpu.core import matrix_io

    n = 1 << log_n
    rec = {"config": f"2^{log_n}x{value_len}B arity{arity} prg={prg_mode}"}

    t0 = time.perf_counter()
    db = build_db(n, value_len, rng)
    log(f"2^{log_n} a{arity} {prg_mode}: db built in {time.perf_counter()-t0:.1f}s")
    # the 2^20 dict pins >2M objects in the old generation; JAX
    # tracing/compilation allocates heavily, and every gen-2 collection
    # then scans millions of objects — freeze() exempts them (measured:
    # this was most of a 20+ minute "compile"). The caller unfreezes when
    # the config is done so dead configs stay collectable.
    import gc

    gc.freeze()

    seed = rng.bytes(32)
    t0 = time.perf_counter()
    server, hint_bytes, filter_param_bytes = Server.setup(
        seed, db, arity=arity, prg_mode=prg_mode, rng=rng
    )
    rec["server_setup_s"] = round(time.perf_counter() - t0, 2)
    rec["b"] = server.mat_elem_bit_len
    log(f"2^{log_n} a{arity} {prg_mode}: server_setup {rec['server_setup_s']}s "
        f"(b={server.mat_elem_bit_len})")

    _setup_stats_fields(rec, server)

    # --- respond scan (the headline): measured before any client work so a
    # timeout can never eat it. Uses synthetic uniform queries — the scan
    # is input-independent integer work, asserted exact vs oracle in tests.
    q_rng = np.random.default_rng(0xD15C)
    queries = q_rng.integers(0, 1 << 32, size=(1, server.num_query_cols), dtype=np.uint32)
    if server._backend == "jax":
        import contextlib

        from chalametpir_tpu.utils import telemetry

        profile_dir = os.environ.get("PIR_BENCH_PROFILE", "")
        prof = (
            telemetry.profile_to(profile_dir) if profile_dir
            else contextlib.nullcontext()
        )
        scan_seconds = make_respond_chain(server)
        with prof:
            t_respond = scan_seconds(queries, 1)
        batch = batch or BATCH
        t_respond_batch_per_q = scan_seconds(queries, batch) / batch
    else:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            server.respond_batch(queries[:1])
            times.append(time.perf_counter() - t0)
        t_respond = float(np.median(times))
        t_respond_batch_per_q = t_respond
        batch = batch or 1

    cf = matrix_io.compression_factor(server.mat_elem_bit_len)
    ref_db_bytes = server.num_query_cols * (-(-server.num_response_cols // cf)) * 4
    scan_gbps = ref_db_bytes / t_respond / 1e9
    rec.update(
        server_respond_ms=round(t_respond * 1e3, 3),
        server_respond_batch_per_query_ms=round(t_respond_batch_per_q * 1e3, 4),
        respond_scan_GBps=round(scan_gbps, 2),
        respond_batch_scan_GBps=round(ref_db_bytes / t_respond_batch_per_q / 1e9, 2),
    )
    log(
        f"2^{log_n} a{arity} {prg_mode}: respond {t_respond*1e3:.3f} ms single "
        f"({scan_gbps:.1f} GB/s), {t_respond_batch_per_q*1e3:.4f} ms/q batched x{batch}"
    )
    if emit is not None:
        emit(rec)

    # --- client phases (kept non-fatal: the respond numbers above are
    # already emitted; a client-side device failure must not zero them)
    try:
        _client_phases(rec, log_n, arity, db, server, seed, hint_bytes,
                       filter_param_bytes, prg_mode, client_device)
    except Exception as e:
        log(f"2^{log_n} a{arity}: client phases failed: {e!r}")
        rec["client_error"] = repr(e)
    return rec


def _client_phases(rec, log_n, arity, db, server, seed, hint_bytes,
                   filter_param_bytes, prg_mode, client_device):
    from chalametpir_tpu import Client
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator

    # --- client phases. Methodology mirrors divan's medians
    # (integrations/benches/offline_phase.rs:59): one discarded warm call,
    # then the median of N.
    t0 = time.perf_counter()
    client = Client.setup(seed, hint_bytes, filter_param_bytes,
                          prg_mode=prg_mode, device=client_device)
    rec["client_setup_s"] = round(time.perf_counter() - t0, 2)
    rec["client_on_device"] = client.uses_device
    cstats = getattr(client, "setup_stats", None) or {}
    # attribution (models/client.py): a_expand_s is the host XOF wall for
    # A, cpu_s the thread's CPU over the whole setup.
    if cstats.get("a_expand_s") is not None:
        rec["client_setup_xof_s"] = cstats["a_expand_s"]
    if cstats.get("cpu_s") is not None:
        rec["client_setup_cpu_s"] = cstats["cpu_s"]
    if cstats.get("sys_s") is not None:
        rec["client_setup_sys_s"] = cstats["sys_s"]
        rec["client_setup_minflt"] = cstats.get("minflt")
    if cstats.get("alloc_s") is not None:
        # expand_seed alloc-vs-sponge split (core/prg.py)
        rec["client_setup_alloc_s"] = cstats["alloc_s"]
        rec["client_setup_sponge_s"] = cstats.get("xof_s")
    log(f"2^{log_n} a{arity}: client_setup {rec['client_setup_s']}s "
        f"(device={client.uses_device}, xof={cstats.get('a_expand_s')}, "
        f"cpu={cstats.get('cpu_s')})")

    # FrodoPIR offline preprocessing (ia.cr/2022/981): the (b, c) pair is
    # key-independent, so the paper's client computes it before the query
    # key is known; the reference evaluates it lazily inside query()
    # (client.rs:106-107). Both split costs are reported: the amortized
    # offline cost per query, and the online (pooled) query latency.
    pool = 16
    t0 = time.perf_counter()
    client.prepare_queries(pool)
    prep_s = time.perf_counter() - t0
    rec["client_prepare_per_query_ms"] = round(prep_s / pool * 1e3, 2)
    rec["client_pool"] = pool
    pstats = dict(getattr(client, "prepare_stats", {}) or {})
    if pstats:
        # host sampling vs residual device wait vs b-vector readback
        rec["client_prepare_phases_s"] = pstats
    log(f"2^{log_n} a{arity}: prepare_queries({pool}) {prep_s:.2f}s"
        + (f" (readback {pstats.get('readback_s')}s of it)"
           if "readback_s" in pstats else ""))

    def _query_retry(fn, key):
        while True:
            try:
                return fn(key)
            except ArithmeticOverflowAddingQueryIndicator:
                continue

    keys = list(db.keys())[:16]
    # online (pooled) query: warm 1, median of 8
    _query_retry(client.query, keys[0])
    times, queries_bytes = [], []
    for key in keys[1:9]:
        t0 = time.perf_counter()
        queries_bytes.append(_query_retry(client.query, key))
        times.append(time.perf_counter() - t0)
    rec["client_query_ms"] = round(float(np.median(times)) * 1e3, 3)
    # inline query (the reference's lazy order): warm 1, median of 5
    _query_retry(client.query_inline, keys[9])
    times = []
    for key in keys[10:15]:
        t0 = time.perf_counter()
        _query_retry(client.query_inline, key)
        times.append(time.perf_counter() - t0)
    rec["client_query_inline_ms"] = round(float(np.median(times)) * 1e3, 2)
    log(
        f"2^{log_n} a{arity}: client_query {rec['client_query_ms']} ms online "
        f"(pool), {rec['client_query_inline_ms']} ms inline, "
        f"prepare {rec['client_prepare_per_query_ms']} ms/q amortized"
    )

    # end-to-end serialized respond (query copy + scan + readback):
    # warm 1, median of 5
    response_bytes = server.respond(queries_bytes[0])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.respond(queries_bytes[0])
        times.append(time.perf_counter() - t0)
    rec["server_respond_e2e_ms"] = round(float(np.median(times)) * 1e3, 2)

    # process_response: warm 1, median of 32 (pending state restored via
    # the reference's own bench hooks, client.rs:60-71)
    key0 = keys[1]
    value = client.process_response(key0, response_bytes)
    assert value == db[key0], "retrieval mismatch!"
    pending = client.discard_query(keys[2])
    resp2 = server.respond(queries_bytes[1])
    times = []
    for _ in range(32):
        client.insert_query(keys[2], pending)
        t0 = time.perf_counter()
        value = client.process_response(keys[2], resp2)
        times.append(time.perf_counter() - t0)
    assert value == db[keys[2]], "retrieval mismatch (hooked)!"
    rec["client_process_response_us"] = round(float(np.median(times)) * 1e6, 2)
    log(
        f"2^{log_n} a{arity}: e2e {rec['server_respond_e2e_ms']} ms, "
        f"process_response {rec['client_process_response_us']} us (median-32)"
    )


def _run_scaling_point(log_n, rng, prg_mode="ctr"):
    """Respond-scan + setup at a >2^20 size (the 2^23 sharded target's
    kernel regime on one chip): value 1 kB, arity 3."""
    import gc

    from chalametpir_tpu import Server
    from chalametpir_tpu.core import matrix_io

    n = 1 << log_n
    rec = {"config": f"2^{log_n}x1024B arity3 prg={prg_mode}"}
    db = build_db(n, 1024, rng)
    gc.freeze()
    try:
        seed = rng.bytes(32)
        t0 = time.perf_counter()
        server, hint_bytes, fpb = Server.setup(
            seed, db, arity=3, prg_mode=prg_mode, rng=rng
        )
        rec["server_setup_s"] = round(time.perf_counter() - t0, 2)
        rec["b"] = server.mat_elem_bit_len
        _setup_stats_fields(rec, server)
        q_rng = np.random.default_rng(0xD15C)
        queries = q_rng.integers(
            0, 1 << 32, size=(1, server.num_query_cols), dtype=np.uint32
        )
        scan_seconds = make_respond_chain(server)
        t_respond = scan_seconds(queries, 1)
        cf = matrix_io.compression_factor(server.mat_elem_bit_len)
        ref_db_bytes = server.num_query_cols * (-(-server.num_response_cols // cf)) * 4
        rec["server_respond_ms"] = round(t_respond * 1e3, 3)
        rec["respond_scan_GBps"] = round(ref_db_bytes / t_respond / 1e9, 2)
        log(
            f"scaling 2^{log_n}: setup {rec['server_setup_s']}s, "
            f"scan {rec['respond_scan_GBps']} GB/s"
        )
        # one real retrieval through the full protocol at this scale: the
        # scaling chain proves encode + client correctness, not just the
        # kernel rate
        try:
            from chalametpir_tpu import Client
            from chalametpir_tpu.errors import (
                ArithmeticOverflowAddingQueryIndicator,
            )

            client = Client.setup(seed, hint_bytes, fpb, prg_mode=prg_mode)
            key = next(iter(db))
            while True:
                try:
                    q = client.query(key)
                    break
                except ArithmeticOverflowAddingQueryIndicator:
                    continue
            value = client.process_response(key, server.respond(q))
            assert value == db[key], "scaling retrieval mismatch"
            rec["retrieval_ok"] = True
            log(f"scaling 2^{log_n}: retrieval OK "
                f"(client engine {type(client._engine).__name__})")
        except Exception as e:
            rec["retrieval_ok"] = False
            rec["retrieval_error"] = repr(e)[:120]
            log(f"scaling 2^{log_n}: retrieval check failed: {e!r}")
        return rec
    finally:
        gc.unfreeze()
        gc.collect()


def _run_scaling_synthetic(log_n=23, value_len=1024):
    """Respond scan at the BASELINE config-5 regime (2^23 x 1 kB, b=8,
    lo-plane only, ~10.9 GB resident) on ONE device, with SYNTHETIC
    planes: the geometry (m, cols, b, padding) is exactly what a real
    setup derives for this size, but the plane content is
    device-generated random bytes — the scan is input-independent integer
    work (asserted exact vs oracle in tests), so the rate is the real one
    without a real setup's encode and upload. Clearly labeled
    SYNTHETIC-PLANES in the artifact."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from chalametpir_tpu.core import codec, matrix_io
    from chalametpir_tpu.core.filter import filter_geometry
    from chalametpir_tpu.models.server import Server
    from chalametpir_tpu.ops import respond_pallas
    from chalametpir_tpu.params import find_mat_elem_bit_len

    n = 1 << log_n
    b = find_mat_elem_bit_len(n)
    _, _, m = filter_geometry(3, n)
    cols = codec.encoded_row_width(value_len, b)
    m_pad = -(-m // respond_pallas.ROW_ALIGN) * respond_pallas.ROW_ALIGN
    c_pad = -(-cols // respond_pallas.COL_ALIGN) * respond_pallas.COL_ALIGN
    rec = {
        "config": f"2^{log_n}x{value_len}B arity3 SYNTHETIC-PLANES",
        "b": b,
        "note": "geometry exact (m,cols,padding from a real setup); plane "
                "content device-generated random (scan is input-independent)",
    }
    if b > 8:
        rec["error"] = "synthetic path only models the lo-only regime"
        return rec

    chunk = 1 << 19  # 512k rows x c_pad ~= 0.6 GB per generation step

    @partial(jax.jit, donate_argnums=0, static_argnames=("rows",))
    def fill(buf, key, r0, rows):
        bits = jax.random.bits(key, (rows, c_pad), dtype=jnp.uint8)
        chunk8 = jax.lax.bitcast_convert_type(bits, jnp.int8)
        return jax.lax.dynamic_update_slice(buf, chunk8, (r0, jnp.int32(0)))

    t0 = time.perf_counter()
    lo = jnp.full((m_pad, c_pad), -128, jnp.int8)
    key = jax.random.PRNGKey(0x23)
    for r0 in range(0, m_pad, chunk):
        key, sub = jax.random.split(key)
        rows = min(chunk, m_pad - r0)
        lo = fill(lo, sub, jnp.int32(r0), rows)
    lo.block_until_ready()
    rec["plane_gen_s"] = round(time.perf_counter() - t0, 2)
    rec["resident_GB"] = round(lo.nbytes / 1e9, 2)

    pdb = respond_pallas.PallasDB(lo, None, b, m, cols)
    server = Server("jax", pdb, m, cols, b, "packed")
    q_rng = np.random.default_rng(0xD15C)
    queries = q_rng.integers(0, 1 << 32, size=(1, m), dtype=np.uint32)
    scan_seconds = make_respond_chain(server)
    t_respond = scan_seconds(queries, 1)
    cf = matrix_io.compression_factor(b)
    ref_db_bytes = m * (-(-cols // cf)) * 4
    rec["server_respond_ms"] = round(t_respond * 1e3, 3)
    rec["respond_scan_GBps"] = round(ref_db_bytes / t_respond / 1e9, 2)
    # batch amortization at the big-DB regime: one scan serves the batch
    t_batch_per_q = scan_seconds(queries, 16) / 16
    rec["server_respond_batch_per_query_ms"] = round(t_batch_per_q * 1e3, 3)
    log(
        f"scaling 2^{log_n} synth: planes {rec['resident_GB']} GB in "
        f"{rec['plane_gen_s']}s, scan {rec['respond_scan_GBps']} GB/s "
        f"({rec['server_respond_ms']} ms)"
    )
    # free the ~11 GB plane NOW (not at gc time): later stages must see
    # the same device memory headroom whether or not this stage ran
    lo.delete()
    return rec


def _run_serve_qps(rng, log_n=16, n_conns=16, per_conn=8, max_batch=16):
    """Online serving throughput through the REAL TCP surface (net/):
    n_conns concurrent framed connections into the micro-batching
    dispatcher, device respond batches padded to one compiled shape
    (reference analogue: chalametpir_server/examples/server.rs:44-92 —
    but one device batch serves every concurrent client instead of one
    CPU respond per tokio task). Queries are well-formed random (1, m)
    rows: the scan is input-independent integer work, so the throughput
    is the real one without paying n_conns client setups."""
    import asyncio

    from chalametpir_tpu import Server
    from chalametpir_tpu.core import matrix_io
    from chalametpir_tpu.net.framing import read_frame, write_frame
    from chalametpir_tpu.net.server import PirTcpServer

    n = 1 << log_n
    rec = {"config": f"serve 2^{log_n} conns={n_conns} batch<={max_batch}"}
    db = build_db(n, VALUE_LEN, rng)
    seed = rng.bytes(32)
    server, hint_bytes, fpb = Server.setup(seed, db, arity=3, prg_mode="ctr", rng=rng)
    m = server.num_query_cols
    q_rng = np.random.default_rng(0x5E11)
    query_frames = [
        matrix_io.matrix_to_bytes(
            q_rng.integers(0, 1 << 32, size=(1, m), dtype=np.uint32)
        )
        for _ in range(n_conns)
    ]
    max_resp = server.num_response_cols * 4 + 64

    async def run():
        pir = PirTcpServer(server, seed, hint_bytes, fpb, max_batch=max_batch)
        srv = await asyncio.start_server(pir.handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]

        async def connect():
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            await reader.readexactly(32)
            await read_frame(reader, 1 << 30)  # hint
            await read_frame(reader, 4096)  # filter params
            return reader, writer

        conns = await asyncio.gather(*[connect() for _ in range(n_conns)])

        async def pump(i, count):
            reader, writer = conns[i]
            for _ in range(count):
                write_frame(writer, query_frames[i])
                await writer.drain()
                resp = await read_frame(reader, max_resp)
                assert len(resp) == server.num_response_cols * 4 + 8
            return count

        # warm: compiles the (max_batch, m) respond once
        await asyncio.gather(*[pump(i, 1) for i in range(n_conns)])
        # count only the timed phase so serve_queries/serve_batches
        # reconcile with serve_qps * elapsed (warm traffic excluded)
        warm_batches = pir._dispatcher.batches
        warm_served = pir._dispatcher.served
        t0 = time.perf_counter()
        served = sum(await asyncio.gather(
            *[pump(i, per_conn) for i in range(n_conns)]
        ))
        dt = time.perf_counter() - t0
        for _, writer in conns:
            writer.close()
        srv.close()
        await srv.wait_closed()
        await pir._dispatcher.aclose()
        return (served / dt, pir._dispatcher.batches - warm_batches,
                pir._dispatcher.served - warm_served)

    qps, batches, total_served = asyncio.run(run())
    rec["serve_qps"] = round(qps, 1)
    rec["serve_batches"] = batches
    rec["serve_queries"] = total_served
    log(f"serve_qps 2^{log_n}: {rec['serve_qps']} q/s over {n_conns} conns "
        f"({batches} device batches)")
    return rec


_VMSTAT_KEYS = (
    "compact_stall", "compact_fail", "compact_success",
    "allocstall_movable", "allocstall_normal",
    "pgsteal_direct", "pgscan_direct", "thp_fault_alloc",
    "thp_collapse_alloc", "pgmajfault",
)


def _vmstat_snapshot() -> dict:
    """Kernel memory-management counters: the delta across the run
    decides whether slow page population came from direct compaction,
    direct reclaim, or neither."""
    out = {}
    try:
        with open("/proc/vmstat") as f:
            for line in f:
                k, _, v = line.partition(" ")
                if k in _VMSTAT_KEYS:
                    out[k] = int(v)
    except OSError:
        pass
    return out


def main() -> None:
    from chalametpir_tpu.utils import compile_cache, telemetry

    telemetry.set_trace(True)  # phase spans on stderr
    compile_cache.enable_compile_cache()
    vm0 = _vmstat_snapshot()
    import atexit

    def _record_vmstat():
        vm1 = _vmstat_snapshot()
        delta = {k: vm1[k] - vm0.get(k, 0) for k in vm1}
        log(f"vmstat deltas: {delta}")
        if not _FULL_WRITTEN:
            # FULL_PATH still holds a PREVIOUS run's artifact (we died
            # before the first emit_state) — don't contaminate it
            return
        try:
            with open(FULL_PATH) as f:
                fat = json.load(f)
            fat["vmstat_delta"] = delta
            with open(FULL_PATH, "w") as f:
                json.dump(fat, f, indent=1)
        except Exception:
            pass

    atexit.register(_record_vmstat)

    rng = np.random.default_rng(0xBEEF)

    # every record names the device it ran on
    res = STATE["result"]
    res["device"] = telemetry.device_info()
    emit_state()
    log(f"device={res['device']} headline=2^{LOG_N} arity{ARITY} "
        f"{VALUE_LEN}B budget={BUDGET_S}s")

    def on_partial(idx):
        def emit(rec):
            if idx == 0 and rec.get("respond_scan_GBps"):
                res["value"] = rec["respond_scan_GBps"]
                res["vs_baseline"] = round(
                    rec["respond_scan_GBps"] / BASELINE_RESPOND_GBPS, 3
                )
            update_row(idx, rec)
            emit_state()

        return emit

    def run_stage(log_n, arity, prg_mode="ctr", need=0.0, batch=None,
                  client_device="auto", need_note=None):
        rec = {"config": f"2^{log_n}x{VALUE_LEN}B arity{arity} prg={prg_mode}"}
        idx = add_row(rec)
        if need and left() < need:
            log(f"skip 2^{log_n} a{arity} {prg_mode} (need ~{need:.0f}s, "
                f"left {left():.0f}s)")
            rec["skipped"] = need_note or "budget"
            update_row(idx, rec)
            emit_state()
            return
        try:
            rec = run_config(log_n, arity, VALUE_LEN, rng, prg_mode=prg_mode,
                             batch=batch, client_device=client_device,
                             emit=on_partial(idx))
        except Exception as e:
            log(f"2^{log_n} a{arity} {prg_mode} failed: {e!r}")
            rec["error"] = repr(e)
        update_row(idx, rec)
        emit_state()

    # 1. headline (always)
    run_stage(LOG_N, ARITY, PRG_MODE)

    # 2. headline-size arity-4 row, right after the arity-3 headline: it
    #    shares the cached DB dict and the device state. The gate prices
    #    the row from the measured same-run a3 setup wall plus a reserve
    #    for the later stages.
    if RUN_MATRIX and LOG_N == 20:
        su_a3 = float(
            (STATE["fat_rows"][0].get("server_setup_s") or 60.0)
            if STATE["fat_rows"] else 60.0
        )
        run_stage(20, 4, "ctr", need=su_a3 * 1.1 + 320, batch=16,
                  need_note=f"projected ~{su_a3 * 1.1:.0f}s (same-run a3 "
                            f"setup wall {su_a3:.0f}s) + 320s reserve for "
                            f"later stages")

    # 3. the BASELINE config-5 regime on one device (synthetic planes,
    #    cheap: no DB build, no upload); the plane is deleted device-side
    #    when the stage ends
    if LOG_N >= 20:
        if left() > 120:
            try:
                rec = _run_scaling_synthetic(23, VALUE_LEN)
            except Exception as e:
                log(f"scaling synth failed: {e!r}")
                rec = {"config": "2^23 SYNTHETIC-PLANES", "error": repr(e)}
        else:
            rec = {"config": "2^23x1024B arity3 SYNTHETIC-PLANES",
                   "skipped": f"budget ({left():.0f}s left, need ~120s)"}
        STATE["scaling"].append(_compact(rec))
        STATE.setdefault("scaling_fat", []).append(rec)
        emit_state()
        import gc

        gc.collect()  # release the host-side refs too

    # 4. online serving throughput through the real TCP surface (2^16 DB)
    if RUN_MATRIX:
        if left() > 60:
            try:
                rec = _run_serve_qps(rng)
                res["serve_qps"] = rec["serve_qps"]
            except Exception as e:
                log(f"serve_qps failed: {e!r}")
                rec = {"config": "serve 2^16", "error": repr(e)}
        else:
            rec = {"config": "serve 2^16",
                   "skipped": f"budget ({left():.0f}s left, needs ~60s)"}
            log(f"serve_qps skipped: {rec['skipped']}")
        # NOT fat_rows: update_row() indexes rows/fat_rows in lockstep, so
        # an unpaired append would be overwritten by the next stage
        STATE.setdefault("extra_fat", []).append(rec)
        emit_state()

    # 5. the divan small-config matrix + the stream-mode (interop) rows.
    #    Stream rows ride the same cached DB as their ctr sibling; the
    #    arity-4 rows rebuild their DB if needed.
    if RUN_MATRIX:
        run_stage(16, 3, "ctr", need=25, batch=16)
        if RUN_STREAM:
            # reference-interop mode: A is a serial host XOF squeeze
            # (matrix.rs:541-558); host client models the Rust/WASM
            # interop peer
            run_stage(16, 3, "stream", need=60, batch=16, client_device=False)
        run_stage(18, 3, "ctr", need=45, batch=16)
        if RUN_STREAM:
            run_stage(18, 3, "stream", need=120, batch=16, client_device=False)
        run_stage(16, 4, "ctr", need=35, batch=16)
        run_stage(18, 4, "ctr", need=55, batch=16)

    # 6. real-setup scaling anchor above 2^20 (one device; default 2^22,
    #    with a retrieved-value assert)
    scale_default = "22" if LOG_N >= 20 else "0"
    scale_log_n = int(os.environ.get("PIR_BENCH_SCALING_LOG_N", scale_default))
    if scale_log_n:
        # DB-dict build + encode + upload + client retrieval check
        scale_need = 140 * (1 << scale_log_n) / (1 << 21)
        if left() > scale_need:
            try:
                rec = _run_scaling_point(scale_log_n, rng)
            except Exception as e:
                log(f"scaling 2^{scale_log_n} failed: {e!r}")
                rec = {"config": f"2^{scale_log_n}", "error": repr(e)}
        else:
            log(f"scaling 2^{scale_log_n}: skipped (need ~{scale_need:.0f}s, "
                f"left {left():.0f}s)")
            rec = {"config": f"2^{scale_log_n}x1024B arity3 prg=ctr",
                   "skipped": f"projected ~{scale_need:.0f}s"}
        STATE["scaling"].append(_compact(rec))
        STATE.setdefault("scaling_fat", []).append(rec)
        emit_state()

    # 7. the flagship-size stream-mode (interop) row, or its explicit skip
    #    record: stream setup expands A (4 * 1774 * m bytes) on the host
    #    and copies it with the packed DB to the device
    if RUN_MATRIX and RUN_STREAM and LOG_N == 20:
        run_stage(20, 3, "stream", need=300, batch=16, client_device=False,
                  need_note="projected ~300s (host XOF of A + A and DB copy)")


if __name__ == "__main__":
    main()
