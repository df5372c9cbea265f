"""The one place that picks where device work runs (ops/backend.py), and
the compile cache location (utils/compile_cache.py)."""

import os

import numpy as np
import pytest

from chalametpir_tpu.errors import AcceleratorError
from chalametpir_tpu.ops import backend


@pytest.mark.parametrize("name,interp", [("cpu", True), ("gpu", False)])
def test_platform_choice(name, interp, monkeypatch):
    """cpu -> kernels interpreted (the test tier); gpu -> compiled."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert backend.platform() == name
    assert backend.interpret() is interp
    assert backend.accelerator_present() is (name == "gpu")


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(name, monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: name)
    for fn in (backend.platform, backend.interpret, backend.accelerator_present):
        with pytest.raises(AcceleratorError, match="unsupported JAX platform"):
            fn()


def test_respond_path_by_shape():
    assert backend.respond_path(1) == "triton"
    assert backend.respond_path(backend.TRITON_MAX_QUERIES) == "triton"
    assert backend.respond_path(backend.TRITON_MAX_QUERIES + 1) == "xla"
    assert backend.respond_path(1 << 12) == "xla"
    assert set(backend.RESPOND_PATHS) == {"triton", "xla"}


@pytest.mark.parametrize("name,interp", [("cpu", True), ("gpu", False)])
@pytest.mark.parametrize("q", [1, 40])
def test_respond_batch_packed_passes_platform_choice(name, interp, q, monkeypatch):
    """The packed respond entry point takes the interpret flag and the
    path from ops/backend: never interpreted on the GPU."""
    from chalametpir_tpu.ops import respond_pallas

    seen = {}

    def fake_core(queries, lo, hi, b, c, path, interpret):
        seen.update(path=path, interpret=interpret)
        return np.zeros((queries.shape[0], c), np.uint32)

    monkeypatch.setattr(backend, "platform", lambda: name)
    monkeypatch.setattr(respond_pallas, "respond_packed_core", fake_core)
    db = respond_pallas.PallasDB(
        np.zeros((1024, 128), np.int8), None, 8, 1000, 100
    )
    respond_pallas.respond_batch_packed(np.zeros((q, 1000), np.uint32), db)
    assert seen == {"path": backend.respond_path(q), "interpret": interp}


def test_respond_batch_packed_rejects_wrong_length():
    from chalametpir_tpu.ops import respond_pallas

    db = respond_pallas.PallasDB(np.zeros((1024, 128), np.int8), None, 8, 1000, 100)
    with pytest.raises(ValueError, match="query length"):
        respond_pallas.respond_batch_packed(np.zeros((1, 999), np.uint32), db)


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls made by enable_compile_cache."""
    import jax

    from chalametpir_tpu.utils import compile_cache

    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(compile_cache, "_DONE", False)
    monkeypatch.delenv("CHALAMETPIR_NO_COMPILE_CACHE", raising=False)
    return calls


def test_compile_cache_honours_env_dir(config_calls, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, and no other
    directory is set in code."""
    from chalametpir_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert compile_cache.cache_dir() == str(tmp_path)
    compile_cache.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in config_calls
    assert config_calls["jax_persistent_cache_min_compile_time_secs"] == 0.5
    assert config_calls["jax_include_full_tracebacks_in_locations"] is False


def test_compile_cache_default_dir_fixed_in_checkout(config_calls, monkeypatch):
    """Without the variable the cache lands in one fixed directory at the
    root of the checkout, which .gitignore lists."""
    from chalametpir_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")
    compile_cache.enable_compile_cache()
    assert config_calls["jax_compilation_cache_dir"] == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    # idempotent: a second call changes nothing
    config_calls.clear()
    compile_cache.enable_compile_cache()
    assert config_calls == {}


@pytest.mark.parametrize("opt_out", [False, True])
def test_compile_cache_off_on_cpu_and_opt_out(config_calls, monkeypatch, opt_out):
    """The CPU platform (test tier) and CHALAMETPIR_NO_COMPILE_CACHE=1
    leave JAX's config untouched."""
    from chalametpir_tpu.utils import compile_cache

    if opt_out:
        monkeypatch.setenv("CHALAMETPIR_NO_COMPILE_CACHE", "1")
        monkeypatch.setattr(backend, "platform", lambda: "gpu")
    else:
        monkeypatch.setattr(backend, "platform", lambda: "cpu")
    compile_cache.enable_compile_cache()
    assert config_calls == {}
