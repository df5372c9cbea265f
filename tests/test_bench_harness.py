"""The bench harness is a driver-facing artifact: a syntax error or a
broken helper zeroes the official BENCH record. Smoke-test its pieces
with no device dependency."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_importable_and_db_builder():
    import bench

    rng = np.random.default_rng(1)
    db = bench.build_db(256, 64, rng)
    assert len(db) == 256
    assert all(len(k) == 32 and len(v) == 64 for k, v in db.items())


def test_bench_run_config_numpy_backend(monkeypatch):
    """run_config end-to-end against the numpy backend (no device): must
    return a complete record with the headline fields."""
    import bench

    import chalametpir_tpu.models.server as server_mod

    orig = server_mod.Server.setup.__func__

    def numpy_setup(cls, seed, db, **kw):
        kw["backend"] = "numpy"
        return orig(cls, seed, db, **kw)

    monkeypatch.setattr(server_mod.Server, "setup", classmethod(numpy_setup))
    rng = np.random.default_rng(2)
    rec = bench.run_config(8, 3, 64, rng, batch=2)
    for field in (
        "server_setup_s",
        "respond_scan_GBps",
        "client_setup_s",
        "client_query_ms",
        "client_process_response_us",
    ):
        assert field in rec, field
    assert rec["respond_scan_GBps"] > 0


def test_bench_serve_qps_stage_end_to_end(monkeypatch):
    """_run_serve_qps drives the REAL net/ TCP surface; run it tiny on
    the numpy backend so a broken helper can't first surface in a chip
    run."""
    import bench

    import chalametpir_tpu.models.server as server_mod

    orig = server_mod.Server.setup.__func__

    def numpy_setup(cls, seed, db, **kw):
        kw["backend"] = "numpy"
        return orig(cls, seed, db, **kw)

    monkeypatch.setattr(server_mod.Server, "setup", classmethod(numpy_setup))
    rng = np.random.default_rng(3)
    rec = bench._run_serve_qps(rng, log_n=8, n_conns=2, per_conn=2, max_batch=2)
    assert rec["serve_qps"] > 0
    assert rec["serve_queries"] == 4
    assert rec["serve_batches"] >= 1


def test_bench_emits_valid_json_lines(tmp_path):
    """Tiny full bench run in a subprocess on the CPU backend: every
    stdout line must be a valid JSON record carrying the headline metric."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import runpy, sys\n"
        "sys.argv = ['bench.py']\n"
        "runpy.run_path(%r, run_name='__main__')\n" % os.path.join(REPO, 'bench.py')
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=600,
        env={
            **os.environ,
            "PYTHONPATH": REPO,
            "PIR_BENCH_LOG_N": "8",
            "PIR_BENCH_VALUE_LEN": "64",
            "PIR_BENCH_MATRIX": "0",
            # keep the smoke run from clobbering the repo's real artifact
            "PIR_BENCH_FULL_PATH": str(tmp_path / "bench_full_smoke.json"),
            "PIR_BENCH_BATCH": "2",
        },
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert lines, out.stderr[-1000:]
    for line in lines:
        rec = json.loads(line)
        assert rec["metric"] == "server_respond_db_scan_GBps"
        # the driver parses a ~2 KB output tail: every line must fit it
        # with room to spare (the round-3 artifact died to this)
        assert len(line) <= 1900, f"bench line too long ({len(line)} B)"
    final = json.loads(lines[-1])
    assert final["value"] is not None
    assert final["rows"], "final record must carry the per-config rows"
    # every record names the device it ran on
    assert final["device"]["platform"] == "cpu"
    assert final["device"]["count"] >= 1
    assert "kind" in final["device"] and "nvidia_smi" in final["device"]


def test_bench_compact_line_trimming(capsys, monkeypatch, tmp_path):
    """The last-resort overflow trimming: with far more rows than the
    driver's tail window fits, emit_state must still print one valid
    JSON line under the cap, preserving the headline row."""
    import importlib

    import bench as bench_mod

    bench = importlib.reload(bench_mod)  # fresh STATE
    fat = {
        "config": "2^20x1024B arity3 prg=ctr",
        "b": 9,
        "server_setup_s": 83.41,
        "server_setup_upload_s": 26.93,
        "server_respond_ms": 1.838,
        "respond_scan_GBps": 805.92,
        "server_respond_batch_per_query_ms": 0.0634,
        "client_query_ms": 1.69,
        "client_query_inline_ms": 187.5,
        "server_respond_e2e_ms": 157.8,
        "client_process_response_us": 6.78,
    }
    for i in range(40):  # ~40 full rows ≈ 5+ KB uncompacted
        rec = dict(fat)
        rec["config"] = f"2^{10 + i}x1024B arity3 prg=ctr"
        bench.add_row(rec)
    # don't let the test write the repo's BENCH_FULL.json
    monkeypatch.setattr(bench, "FULL_PATH", str(tmp_path / "bench_full_test.json"))
    bench.emit_state()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line) <= bench.MAX_LINE, len(line)
    rec = json.loads(line)
    assert rec["metric"] == "server_respond_db_scan_GBps"
    assert rec["rows"][0]["c"] == "10a3"  # headline slot survives
    # STATE's own rows were not mutated by the trimming
    assert "qi" in bench.STATE["rows"][5]


def test_bench_compact_caps_free_text():
    """Skip-projection and error text are capped at 60 chars in the
    compact row: multiple ~110-char projections in one run must not
    overflow the compact line and force measured rows out."""
    import bench

    rec = bench._compact(
        {"config": "2^20x1024B arity3 stream",
         "skipped": "projected ~1234s (~14.9 GB A+DB ship at measured "
                     "h2d 0.0035 GB/s, sustained-rate gated)" * 2,
         "error": "x" * 200}
    )
    assert rec["c"] == "20a3s"
    assert len(rec["skip"]) <= 60
    assert len(rec["err"]) <= 60


def test_thread_rusage_degrades_off_linux(monkeypatch):
    """Attribution stats are advisory: where RUSAGE_THREAD is missing
    (macOS/Windows) the helper returns a zeroed stand-in instead of
    crashing the API being measured."""
    import resource

    from chalametpir_tpu.utils import telemetry

    monkeypatch.delattr(resource, "RUSAGE_THREAD")
    ru = telemetry.thread_rusage()
    assert ru.ru_stime == 0.0 and ru.ru_minflt == 0
    monkeypatch.undo()
    assert telemetry.thread_rusage().ru_stime >= 0.0
