"""Device-resident client query engine: s . A as int8 products.

The client's dominant costs are (a) expanding the 32-byte seed into the
(1774, m) public LWE matrix A (~8.4 GB at the 2^20 headline config) and
(b) the per-query ternary matvec s . A. The reference does both on a
many-core CPU (reference: chalametpir_client/src/client.rs:39-57,
client.rs:106 + matrix.rs:541-558, 1031-1059); here both run on the
device.

Design:

* A is stored as four biased int8 byte planes, planes[j] = ((A >> 8j)
  & 255) - 128 — same 4 B/element footprint as uint32, but each plane is
  a native int8 GEMM operand. The planes are laid out (4, m, k_pad):
  fingerprint-major, with the contraction dimension k = 1774 padded to
  K_PAD (a multiple of 16) once at construction, so every query's batched
  dot has a K-minor layout and an aligned contraction on both operands.
  The padded columns meet zero signs and contribute nothing.
* In "ctr" PRG mode the planes are *generated on device* (ops/prg_jax.py)
  — client setup never copies A from the host. ctr A is fingerprint-major
  (core/prg.py), so the planes are generated in contiguous
  fingerprint-range slabs. In "stream" mode (reference-interop) A is
  squeezed by the host XOF row-major, copied once per plane and
  transposed on the device.
* A query computes all four plane dots as one batched einsum over the
  contraction and recombines mod 2^32 with the bias correction
  128 * sum(s) per plane:
      s . A = sum_j (s . plane_j + 128 * sum(s)) << 8j   (mod 2^32)
  Exactness: each dot is int8 x int8 -> int32 with k <= 1774 terms, so
  |partial| <= 1774 * 128 * 128 < 2^25 — no int32 overflow before the
  mod-2^32 wrap (which is the arithmetic we want).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..params import LWE_DIMENSION

K_PAD = -(-LWE_DIMENSION // 16) * 16  # 1776


def _jax():
    try:
        import jax
    except Exception as e:  # pragma: no cover - host-only deploy
        from ..errors import AcceleratorError

        raise AcceleratorError(f"device client requested but jax unavailable: {e}")
    return jax


def _recode_planes_jnp(slab_u32):
    """(r, k) uint32 -> (4, r, K_PAD) int8 biased byte planes, on device
    (the padded columns hold zero bytes; they meet zero signs)."""
    import jax.numpy as jnp

    slab_u32 = jnp.pad(slab_u32, ((0, 0), (0, K_PAD - slab_u32.shape[1])))
    planes = []
    for j in range(4):
        p = (slab_u32 >> np.uint32(8 * j)) & np.uint32(255)
        planes.append((p.astype(jnp.int32) - 128).astype(jnp.int8))
    return jnp.stack(planes)


def _signs(codes: np.ndarray, k: int) -> np.ndarray:
    """(Q, k) ternary codes {0, 1, 2} -> (Q, K_PAD) int8 signs {0, 1, -1}."""
    if codes.ndim != 2 or codes.shape[1] != k:
        from ..errors import InvalidDimensionForVector

        raise InvalidDimensionForVector()
    signs = np.zeros((codes.shape[0], K_PAD), np.int8)
    signs[:, :k] = np.where(codes == 2, -1, codes).astype(np.int8)
    return signs


class DeviceQueryEngine:
    """Holds the A byte planes (4, m_pad, K_PAD) on the device and runs
    s . A per query batch."""

    def __init__(self, planes, k: int, m: int):
        self._planes = planes
        self.k = k
        self.m = m

    # -- construction --------------------------------------------------------

    @classmethod
    def from_seed_ctr(
        cls, seed: bytes, m: int, cols_per_step: int = 32768
    ) -> "DeviceQueryEngine":
        """Generate A's planes entirely on device (ctr PRG mode,
        fingerprint-major): each step generates a contiguous ctr slab of
        `cols_per_step` fingerprint columns and recodes it to byte planes
        in place."""
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        jax = _jax()
        import jax.numpy as jnp

        from . import prg_jax

        k = LWE_DIMENSION
        n_steps = -(-m // cols_per_step)
        m_pad = n_steps * cols_per_step

        # seed_words is an argument, not a closure capture — a captured
        # array is baked into the program, making every new seed a fresh
        # compile
        @partial(jax.jit, static_argnames=("ncols", "lwe_rows"))
        def gen(sw, blk0_words, offset, ncols, lwe_rows):
            return _recode_planes_jnp(
                prg_jax.rows_from_blocks(sw, blk0_words, offset, ncols, lwe_rows)
            )

        seed_words = prg_jax.seed_to_words(seed)
        buf = jnp.zeros((4, m_pad, K_PAD), jnp.int8)
        for c0 in range(0, m, cols_per_step):
            blk0_words, offset = prg_jax.fp_block_start(c0, k)
            slab = gen(seed_words, blk0_words, offset, cols_per_step, k)
            buf = _write_cols(buf, slab, jnp.int32(c0))
        # columns m..m_pad hold PRG output that must not contribute — they
        # are OUTPUT positions here, so callers slice [:m]; no masking
        # needed on the contraction.
        return cls(buf, k, m)

    @classmethod
    def streaming_from_seed_ctr(
        cls, seed: bytes, m: int, cols_per_step: int = 65536
    ) -> "StreamingQueryEngine":
        """ctr-mode engine that never materialises A: each matvec batch
        regenerates A in fingerprint slabs and folds the dots chunk by
        chunk — O(cols_per_step) device memory at ANY m. Used when the
        resident planes (4 * m * K_PAD B) exceed the device memory
        budget; trades per-batch Keccak regeneration for that residency."""
        return StreamingQueryEngine(seed, m, cols_per_step)

    @classmethod
    def from_host_matrix(cls, a_host: np.ndarray) -> "DeviceQueryEngine":
        """Upload a host-expanded (k, m) A (stream PRG mode / interop):
        one byte plane at a time, transposed to (m, K_PAD) on the device."""
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        jax = _jax()
        import jax.numpy as jnp

        k, m = a_host.shape
        buf = jnp.zeros((4, m, K_PAD), jnp.int8)
        for j in range(4):
            p = (a_host >> np.uint32(8 * j)).astype(np.uint8)
            plane = (p.astype(np.int16) - 128).astype(np.int8)
            buf = _write_plane_transposed(buf, jax.device_put(plane), j)
        return cls(buf, k, m)

    # -- query ---------------------------------------------------------------

    def matvec(self, codes: np.ndarray) -> np.ndarray:
        """(k,) int8 ternary codes {0:0, 1:+1, 2:-1} -> (m,) uint32 s . A."""
        if codes.shape != (self.k,):
            from ..errors import InvalidDimensionForVector

            raise InvalidDimensionForVector()
        return self.matvec_batch(codes[None, :])[0]

    def matvec_batch(self, codes: np.ndarray) -> np.ndarray:
        """(Q, k) ternary codes -> (Q, m) uint32; all Q secrets ride one
        batched einsum (the A planes stream from device memory once per
        batch). The device result carries m_pad output columns of PRG
        padding — sliced off here."""
        return np.asarray(self.matvec_batch_async(codes))[:, : self.m].astype(
            np.uint32
        )

    def matvec_batch_async(self, codes: np.ndarray):
        """Dispatch the batched matvec and return the device array without
        waiting — callers overlap host work (error sampling, the s . M
        unblinding matvec) with the device dot and the d2h readback."""
        jax = _jax()

        signs = _signs(codes, self.k)
        return _jit_of("matvec", _matvec_impl)(jax.device_put(signs), self._planes)


class StreamingQueryEngine:
    """Drop-in for DeviceQueryEngine when A's planes exceed the device
    memory budget: s . A is
    computed against on-the-fly ctr slabs of A (fingerprint-major), one
    `cols_per_step` chunk per device call. Same matvec_batch* surface."""

    def __init__(self, seed: bytes, m: int, cols_per_step: int = 65536):
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        from . import prg_jax

        self.k = LWE_DIMENSION
        self.m = m
        self._seed_words = prg_jax.seed_to_words(seed)
        self._step = cols_per_step

    def matvec(self, codes: np.ndarray) -> np.ndarray:
        if codes.shape != (self.k,):
            from ..errors import InvalidDimensionForVector

            raise InvalidDimensionForVector()
        return self.matvec_batch(codes[None, :])[0]

    def matvec_batch(self, codes: np.ndarray) -> np.ndarray:
        return np.asarray(self.matvec_batch_async(codes))[:, : self.m].astype(
            np.uint32
        )

    def matvec_batch_async(self, codes: np.ndarray):
        """Dispatches all chunk folds; returns the (Q, m_pad) device array
        without draining, like DeviceQueryEngine.matvec_batch_async."""
        jax = _jax()
        import jax.numpy as jnp

        from . import prg_jax

        signs_dev = jax.device_put(_signs(codes, self.k))
        q = codes.shape[0]
        n_steps = -(-self.m // self._step)
        out = jnp.zeros((q, n_steps * self._step), jnp.uint32)
        for c0 in range(0, self.m, self._step):
            blk0_words, offset = prg_jax.fp_block_start(c0, self.k)
            out = _streaming_fold(
                out, self._seed_words, blk0_words, offset, signs_dev,
                jnp.int32(c0), ncols=self._step, lwe_rows=self.k,
            )
        return out


_streaming_fold_jit = {}


def _streaming_fold(out, sw, blk0_words, offset, signs, c0, *, ncols, lwe_rows):
    """out[:, c0:c0+ncols] = s . A[:, c0:c0+ncols] over a freshly
    generated ctr slab (donated accumulator; the slab is a jit temp)."""
    jax = _jax()

    fn = _streaming_fold_jit.get("fold")
    if fn is None:
        import jax.numpy as jnp

        from . import prg_jax

        @partial(jax.jit, donate_argnums=0, static_argnames=("ncols", "lwe_rows"))
        def fold(out, sw, blk0_words, offset, signs, c0, ncols, lwe_rows):
            planes = _recode_planes_jnp(
                prg_jax.rows_from_blocks(sw, blk0_words, offset, ncols, lwe_rows)
            )  # (4, ncols, K_PAD)
            part = _matvec_impl(signs, planes)  # (q, ncols) uint32
            return jax.lax.dynamic_update_slice(out, part, (jnp.int32(0), c0))

        fn = _streaming_fold_jit["fold"] = fold
    return fn(out, sw, blk0_words, offset, signs, c0, ncols, lwe_rows)


def _combine_plane_dots(dots, signs):
    """(4, Q, m) int32 plane dots + (Q, k) signs -> (Q, m) uint32."""
    import jax.numpy as jnp

    s_sum = jnp.sum(signs.astype(jnp.int32), axis=1)  # (Q,)
    acc = jnp.zeros(dots.shape[1:], jnp.uint32)
    for j in range(4):
        term = (dots[j] + 128 * s_sum[:, None]).astype(jnp.uint32)
        acc = acc + (term << np.uint32(8 * j))
    return acc


def _matvec_impl(signs, planes):
    import jax.numpy as jnp

    q, k = signs.shape
    s_mat = jnp.broadcast_to(signs[None, :, :], (4, q, k))
    # planes are (4, m, K_PAD): the contraction is the minor dim of both
    # operands
    dots = jnp.einsum(
        "bqk,bmk->bqm", s_mat, planes, preferred_element_type=jnp.int32
    )
    return _combine_plane_dots(dots, signs)


def _write_cols(buf, slab_planes, c0):
    """Donated write of a (4, ncols, K_PAD) slab at fingerprint c0."""
    import jax.numpy as jnp

    def impl(buf, slab_planes, c0):
        return _jax().lax.dynamic_update_slice(buf, slab_planes, (0, c0, jnp.int32(0)))

    return _jit_of("write_cols", impl, donate_argnums=0)(buf, slab_planes, c0)


def _write_plane_transposed(buf, plane_km, j: int):
    """Donated write of one (k, m) byte plane as buf[j, :, :k]."""
    import jax.numpy as jnp

    def impl(buf, plane_km, j):
        k = plane_km.shape[0]
        mk = jnp.pad(plane_km.T, ((0, 0), (0, K_PAD - k)))
        return _jax().lax.dynamic_update_slice(
            buf, mk[None], (j, jnp.int32(0), jnp.int32(0))
        )

    return _jit_of("write_plane", impl, donate_argnums=0)(buf, plane_km, jnp.int32(j))


_jitted = {}


def _jit_of(name, impl, **jit_kw):
    fn = _jitted.get(name)
    if fn is None:
        # jit lazily so importing this module never initialises a device
        fn = _jitted[name] = _jax().jit(impl, **jit_kw)
    return fn
