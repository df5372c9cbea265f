"""Where device work runs: the platform, whether Pallas kernels run in
interpret mode, how much device memory a resident structure may take,
and which respond path serves a given shape.

Every other module asks here instead of testing the JAX backend itself,
so a platform the program does not know fails loudly in one place.
"""

from __future__ import annotations

from ..errors import AcceleratorError

SUPPORTED_PLATFORMS = ("cpu", "gpu")

# Packed-plane respond paths (ops/respond_pallas.py): "triton" is the
# hand-written split-K scan, "xla" unpacks the high plane with XLA and
# hands both int8 products to XLA's own GEMMs.
RESPOND_PATHS = ("triton", "xla")

# Query batches up to this size are served by the Triton scan; larger
# batches go to XLA's GEMMs. On an H100 at the 2^20 x 1 kB geometry the
# scan wins at Q = 1, 4 and 16 and loses at Q = 64 (PERF.md, "Findings").
TRITON_MAX_QUERIES = 16


def platform() -> str:
    """The JAX platform of the default device: "cpu" or "gpu"."""
    import jax

    name = jax.default_backend()
    if name not in SUPPORTED_PLATFORMS:
        raise AcceleratorError(
            f"unsupported JAX platform {name!r} (expected one of "
            f"{', '.join(SUPPORTED_PLATFORMS)})"
        )
    return name


def interpret() -> bool:
    """Pallas kernels run in interpret mode on the CPU (the test tier)
    and compiled on the GPU — never interpreted there."""
    return platform() == "cpu"


def accelerator_present() -> bool:
    """True when the default JAX device is a GPU."""
    try:
        import jax  # noqa: F401
    except ImportError:  # pragma: no cover - host-only deploy without jax
        return False
    return platform() == "gpu"


def _memory_stats() -> dict | None:
    import jax

    return jax.devices()[0].memory_stats()


def device_memory_budget(fraction: float = 0.5) -> int | None:
    """Bytes a new resident device structure may take: `fraction` of the
    default device's memory not yet in use. None where the backend keeps
    no memory statistics (the CPU backend), meaning host memory."""
    stats = _memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    free = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
    return max(0, int(free * fraction))


def respond_path(num_queries: int) -> str:
    """Packed-plane respond path for a batch of `num_queries`."""
    return "triton" if num_queries <= TRITON_MAX_QUERIES else "xla"
