"""Lightweight tracing/observability.

The reference library is deliberately silent (SURVEY.md section 5 —
println! only in examples); for a production serving framework we keep
the default silent but provide opt-in phase spans and JAX profiler
integration:

* `CHALAMETPIR_TRACE=1` (or `set_trace(True)`) prints span timings to
  stderr;
* `profile_to(logdir)` wraps a block in a `jax.profiler` trace so device
  kernels show up in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_ENABLED = os.environ.get("CHALAMETPIR_TRACE", "") not in ("", "0")


def set_trace(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = enabled


class _NullRusage:
    """Zero-valued stand-in where per-thread rusage is unavailable
    (RUSAGE_THREAD is Linux-only; the resource module is absent on
    Windows). Attribution stats are advisory — they must never take
    down the API that is being measured."""

    ru_stime = 0.0
    ru_utime = 0.0
    ru_minflt = 0
    ru_majflt = 0


def thread_rusage():
    """Per-thread getrusage snapshot, or a zeroed stand-in off-Linux."""
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_THREAD)
    except (ImportError, AttributeError, OSError):
        return _NullRusage()


def trace_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a phase; prints `[trace] name took 1.23s {fields}` when enabled."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        extra = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[trace] {name}: {dt:.3f}s {extra}".rstrip(), file=sys.stderr, flush=True)


def trace_event(name: str, **fields) -> None:
    """One-off trace line (no timing) when tracing is enabled."""
    if not _ENABLED:
        return
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[trace] {name}: {extra}".rstrip(), file=sys.stderr, flush=True)


@contextlib.contextmanager
def profile_to(logdir: str):
    """JAX profiler trace around a block (device kernel timeline,
    TensorBoard-loadable). Non-fatal: a backend that cannot trace logs
    the failure and runs the block unprofiled rather than killing the
    measurement it wraps."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception as e:  # pragma: no cover - backend-dependent
        print(f"[trace] profiler unavailable: {e!r}", file=sys.stderr)
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:  # pragma: no cover
                print(f"[trace] profiler stop failed: {e!r}", file=sys.stderr)


def nvidia_smi_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one
    "name, limit" entry per card joined by "; ", or None without
    nvidia-smi. A card set below its maximum power runs slower under
    load, so every recorded time carries this beside it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return "; ".join(ln.strip() for ln in out.stdout.splitlines() if ln.strip())


def device_info() -> dict:
    """The device a measurement ran on: JAX's platform, device kind and
    device count, and the nvidia-smi name and power limit."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": nvidia_smi_name_and_power_limit(),
    }
