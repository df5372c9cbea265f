"""chip_smoke.py: it refuses to run without a GPU, and each of its phases
passes at tiny sizes on the CPU (interpret mode, virtual devices)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four-cards"], ["--times"]])
def test_main_exits_nonzero_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out.strip().splitlines()
    # a header line, but no result line
    assert out and not any(ln.startswith("{") for ln in out)


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_kernels_tiny():
    chip_smoke.phase_kernels(log_n=10, q_batch=8, oracle_cols=16)


def test_phase_server_client_tiny():
    chip_smoke.phase_server_client(log_n=10, value_len=64, n_keys=3, q_batch=8,
                                   oracle_cols=16)


def test_phase_stream_and_tcp_tiny():
    chip_smoke.phase_tcp(*chip_smoke.phase_stream(log_n=9, value_len=64, n_keys=2),
                         n_keys=2)


def test_phase_four_cards_tiny():
    """The 4-card comparison on 4 of the virtual CPU devices."""
    import jax

    chip_smoke.phase_four_cards(log_n=11, value_len=64, n_queries=4, n_keys=2,
                                oracle_cols=16, devices=jax.devices()[:4])


def test_four_cards_needs_four_devices():
    import jax

    with pytest.raises(AssertionError, match="needs 4 devices"):
        chip_smoke.phase_four_cards(log_n=9, devices=jax.devices()[:2])


def test_hlo_summary_counts():
    text = (
        '%a = s32[4,8]{1,0} custom-call(s8[4,16] %x), custom_call_target="__cublas$lt$matmul"\n'
        "%b = f32[4,8]{1,0} convert(s32[4,8] %a)\n"
        "%c = s8[8,16]{1,0} pad(s8[7,16] %y, s8[] %z)\n"
        "%d = s8[16,8]{1,0} transpose(s8[8,16] %c)\n"
    )
    got = chip_smoke.hlo_summary(text)
    assert got["cublas_calls"] == 1
    assert got["float_converts"] == 1
    assert got["pads"] == 1 and got["transposes"] == 1


def test_random_kv_db_fixed_widths():
    import numpy as np

    db = chip_smoke.random_kv_db(300, 40, np.random.default_rng(0))
    assert len(db) == 300
    assert all(len(k) == 32 and len(v) == 40 for k, v in db.items())
    assert json.dumps({"n": len(db)})
