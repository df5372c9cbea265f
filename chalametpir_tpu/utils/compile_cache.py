"""Persistent XLA compilation cache for the GPU programs.

The device programs here (the packed respond scan, the ctr Keccak, the
hint folds) take seconds to compile but are byte-stable across
processes, so the persistent cache makes a restart skip the compiles.

Where it lives:

* `JAX_COMPILATION_CACHE_DIR`, if set — JAX reads that variable itself,
  and this module then sets no other directory;
* otherwise `.jax_cache/` at the root of the checkout, a fixed path (the
  cache is keyed by path, so a directory that moves never hits), listed
  in `.gitignore`.

The cache is turned on for the GPU platform only. CPU runs (the test
tier) compile small programs, and a reloaded XLA:CPU artifact prints a
multi-KB feature-mismatch error line on every load.

Besides the directory, the first device setup sets two process-global
knobs: the min-compile-time / min-entry-size thresholds, and
`jax_include_full_tracebacks_in_locations=False` (full tracebacks bake
caller source locations into kernel payloads, so the cache key would
change on ANY caller edit). Opt out with CHALAMETPIR_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os

_DONE = False

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> None:
    """Idempotently enable JAX's persistent compilation cache (GPU only)."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    if os.environ.get("CHALAMETPIR_NO_COMPILE_CACHE", "") not in ("", "0"):
        return
    import jax

    from ..ops import backend

    if backend.platform() != "gpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # cache everything that took measurable compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
