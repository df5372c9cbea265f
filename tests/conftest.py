"""Test harness.

Default tier: force the CPU backend with 8 virtual devices so the full
sharding story runs anywhere (the Triton scan runs in interpret mode).

Chip tier: PIR_TEST_GPU=1 keeps the real backend; `make check-gpu`
(= pytest -m gpu) runs tests/test_gpu_compiled.py's compiled-mode
assertions on a GPU — mirroring the reference's CI running the same
suite under `--features gpu` (test_ci.yml:36-48). Whether a GPU is
present is decided inside that module's fixture, never here.

Randomized property tier: the `rng` fixture draws a FRESH seed per
session (mirroring the reference's randomized co-located tests,
matrix.rs:1136-1232), printed in the header and echoed on failure —
reproduce any run with PIR_TEST_SEED=<seed>.
"""

import os
import secrets

_GPU_MODE = os.environ.get("PIR_TEST_GPU", "") not in ("", "0")

flags = os.environ.get("XLA_FLAGS", "")
if not _GPU_MODE and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not _GPU_MODE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

def _parse_seed(x: str) -> int:
    """base-0 first (accepts the 0x... form the header may print), with a
    decimal fallback so values like '012' keep parsing as base-10."""
    try:
        return int(x, 0)
    except ValueError:
        return int(x, 10)


_SEED = _parse_seed(os.environ.get("PIR_TEST_SEED", "0") or "0") or secrets.randbits(48)


def pytest_report_header(config):
    return (
        f"chalametpir_tpu: backend={jax.default_backend()} "
        f"PIR_TEST_SEED={_SEED} (set env to reproduce)"
    )


@pytest.fixture
def rng(request):
    """Fresh randomized generator, derived from the session seed and a
    STABLE hash of the test id (hash() is salted per process and would
    break reproducibility) so every test gets an independent stream and
    any failure is reproducible from the printed PIR_TEST_SEED."""
    import zlib

    node_key = zlib.crc32(request.node.nodeid.encode())
    return np.random.default_rng([_SEED, node_key])
