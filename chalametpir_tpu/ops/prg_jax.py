"""On-device ctr-mode TurboSHAKE128: the LWE matrix A is generated on
the device and never crosses the host link.

Keccak-p[1600,12] vectorised across independent counter blocks, with each
64-bit lane emulated as a (lo, hi) uint32 pair (jnp uint64 needs the x64
flag). Pure jnp: the permutation is one long elementwise chain that XLA
fuses into one kernel per round, so no hand-written kernel is needed.

Used by the server's `prg_mode="ctr"` setup path and the device client
engines: with A generated on device, setup's only host->device traffic
is the packed DB itself. Block semantics match core/prg.py ctr mode
bit-for-bit (asserted in tests): block i = TurboSHAKE128(seed ||
LE64(i))[:168].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.keccak import KECCAK_RC, RATE, _PI_DEST, _RHO

_U32 = jnp.uint32


def _rotl64(lo, hi, s: int):
    if s == 0:
        return lo, hi
    if s == 32:
        return hi, lo
    if s < 32:
        return (
            (lo << np.uint32(s)) | (hi >> np.uint32(32 - s)),
            (hi << np.uint32(s)) | (lo >> np.uint32(32 - s)),
        )
    t = s - 32
    return (
        (hi << np.uint32(t)) | (lo >> np.uint32(32 - t)),
        (lo << np.uint32(t)) | (hi >> np.uint32(32 - t)),
    )


# (12, 2) uint32: the final 12 Keccak round constants as (lo, hi) words
_RC12 = np.array(
    [[rc & 0xFFFFFFFF, rc >> 32] for rc in KECCAK_RC[12:]], dtype=np.uint32
)


def _round(lo, hi, rc_lo, rc_hi):
    clo = [lo[x] ^ lo[x + 5] ^ lo[x + 10] ^ lo[x + 15] ^ lo[x + 20] for x in range(5)]
    chi_ = [hi[x] ^ hi[x + 5] ^ hi[x + 10] ^ hi[x + 15] ^ hi[x + 20] for x in range(5)]
    dlo, dhi = [], []
    for x in range(5):
        rl, rh = _rotl64(clo[(x + 1) % 5], chi_[(x + 1) % 5], 1)
        dlo.append(clo[(x + 4) % 5] ^ rl)
        dhi.append(chi_[(x + 4) % 5] ^ rh)
    lo = [lo[i] ^ dlo[i % 5] for i in range(25)]
    hi = [hi[i] ^ dhi[i % 5] for i in range(25)]
    blo: list = [None] * 25
    bhi: list = [None] * 25
    for i in range(25):
        rl, rh = _rotl64(lo[i], hi[i], _RHO[i])
        blo[_PI_DEST[i]] = rl
        bhi[_PI_DEST[i]] = rh
    lo = [
        blo[i] ^ (~blo[((i % 5 + 1) % 5) + 5 * (i // 5)] & blo[((i % 5 + 2) % 5) + 5 * (i // 5)])
        for i in range(25)
    ]
    hi = [
        bhi[i] ^ (~bhi[((i % 5 + 1) % 5) + 5 * (i // 5)] & bhi[((i % 5 + 2) % 5) + 5 * (i // 5)])
        for i in range(25)
    ]
    lo[0] = lo[0] ^ rc_lo
    hi[0] = hi[0] ^ rc_hi
    return lo, hi


def _keccak_p12_pairs(lo, hi):
    """12-round permutation over two lists of 25 uint32 arrays.

    Rounds run under lax.fori_loop — unrolling all 12 produces a graph
    XLA takes minutes to compile, for no runtime benefit."""
    rc = jnp.asarray(_RC12)

    def body(r, state):
        lo, hi = state
        lo, hi = _round(list(lo), list(hi), rc[r, 0], rc[r, 1])
        return tuple(lo), tuple(hi)

    lo, hi = jax.lax.fori_loop(0, 12, body, (tuple(lo), tuple(hi)))
    return list(lo), list(hi)


@partial(jax.jit, static_argnames=("nblocks",))
def ctr_blocks_u32(seed_words, block0_words, nblocks: int):
    """(nblocks, 42) uint32: ctr blocks [block0, block0+nblocks).

    seed_words: (8,) uint32 — the 32-byte seed as LE words.
    block0_words: (2,) uint32 — the starting block index as (lo, hi)
    (64-bit math from uint32 parts; jnp u64 needs the x64 flag).
    """
    idx = jnp.arange(nblocks, dtype=_U32)
    ctr_lo = block0_words[0] + idx
    carry = (ctr_lo < block0_words[0]).astype(_U32)
    ctr_hi = block0_words[1] + carry

    zeros = jnp.zeros(nblocks, _U32)
    lo = [zeros] * 25
    hi = [zeros] * 25
    # absorb seed (lanes 0..3), counter (lane 4), domain 0x1F at byte 40
    # (lane 5 byte 0), pad bit at byte 167 (lane 20 byte 7)
    for lane in range(4):
        lo[lane] = jnp.full(nblocks, seed_words[2 * lane], _U32)
        hi[lane] = jnp.full(nblocks, seed_words[2 * lane + 1], _U32)
    lo[4] = ctr_lo
    hi[4] = ctr_hi
    lo[5] = jnp.full(nblocks, np.uint32(0x1F), _U32)
    hi[20] = jnp.full(nblocks, np.uint32(0x80000000), _U32)

    lo, hi = _keccak_p12_pairs(lo, hi)
    words = []
    for lane in range(RATE // 8):  # 21 lanes = 168 bytes
        words.append(lo[lane])
        words.append(hi[lane])
    return jnp.stack(words, axis=1)  # (nblocks, 42)


def seed_to_words(seed: bytes) -> jnp.ndarray:
    return jnp.asarray(np.frombuffer(seed, "<u4"))


def rows_from_blocks(seed_words, blk0_words, offset, nrows: int, cols: int):
    """(nrows, cols) uint32 slab of the ctr-mode A matrix, traceable form:
    the caller supplies the starting block (as two uint32 words) and the
    u32-word offset of the slab's first element within that block."""
    nelems = nrows * cols
    # fixed block count for any alignment, so repeated row slabs of the
    # same size share one compilation
    nblocks = nelems * 4 // RATE + 2
    words = ctr_blocks_u32(seed_words, blk0_words, nblocks).reshape(-1)
    return jax.lax.dynamic_slice(words, (offset,), (nelems,)).reshape(nrows, cols)


def fp_block_start(col0: int, lwe_rows: int):
    """(blk0_words, offset) addressing fingerprint column `col0` of the
    ctr-mode A matrix (fingerprint-major: A[r, c] = word c*lwe_rows + r).
    Python ints in, device-ready values out — callers with traced column
    indices compute the same two values inline."""
    word0 = col0 * lwe_rows
    blk0 = (word0 * 4) // RATE
    blk0_words = jnp.asarray(
        np.array([blk0 & 0xFFFFFFFF, blk0 >> 32], dtype=np.uint32)
    )
    return blk0_words, jnp.int32(word0 - blk0 * (RATE // 4))


def expand_fp_slab_device(seed_words, col0: int, ncols: int, lwe_rows: int):
    """(ncols, lwe_rows) uint32 slab of ctr-mode A covering fingerprint
    columns [col0, col0+ncols): slab[j] = A[:, col0+j]. The slab is one
    contiguous ctr word range, so shards and pipeline chunks each generate
    exactly their own slice of A on device (host ctr counterpart:
    core/prg.py expand_fp_block)."""
    blk0_words, offset = fp_block_start(col0, lwe_rows)
    return rows_from_blocks(seed_words, blk0_words, offset, ncols, lwe_rows)
