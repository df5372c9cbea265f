"""Packed-layout respond: stream the bit-packed DB once per query batch.

The digit-plane respond (ops/respond.py) reads 2 bytes per DB element.
The packed layout of ops/packed.py reads 1.0-1.25 B/element in the
large-DB regimes (b <= 10): a biased low-byte int8 plane plus a
bit-packed high plane. Replaces the role of the reference's fused
unpack-multiply-accumulate respond loop
(reference: chalametpir_common/src/matrix.rs:328-485).

Two paths serve the same planes (ops/backend.respond_path picks one):

* **triton** — a Pallas kernel through Triton. The grid runs over
  (row block x column block x K-split) tiles and a K loop runs inside
  each program: the low tile and the packed-high tile stream in, the
  high field is unpacked in registers (one shift, one mask), and both
  int8 x int8 -> int32 products run on the tensor cores. Each split
  writes its own int32 partial; XLA sums the splits, and int32 wrap
  keeps the sum exact mod 2^32. Column blocks never straddle a packed
  field, so a program extracts one field of the words it loads.
* **xla** — XLA unpacks the high plane and hands both int8 products to
  its own GEMMs. It serves the hint folds (1792 A rows x 4 digits is a
  real GEMM) and query batches past the scan's regime.

Layout note: the high plane is packed **column-block interleaved**:
field j of packed word t holds logical column j*pc + t.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .digits import NUM_U32_DIGITS, recode_u32_jnp
from .packed import hi_bits, hi_pack_factor

# Padded plane geometry. Rows: a multiple of every scan K block, so K
# loops never need a mask. Columns: a multiple of 128, so a column block
# (a power of two, as Triton requires) divides both the plane width and
# the packed width c_pad / pack for every pack factor up to 8.
ROW_ALIGN = 1024
COL_ALIGN = 128

# Scan tiling (triton path), keyed by the query-digit rows per program
# (16 for Q <= 4, else 64): (widest column block, K rows per loop step,
# num_warps, num_stages). Picked by a sweep on an H100 at the 2^20 x 1 kB
# geometry (PERF.md, "Findings"). The grid should hold about
# _TARGET_PROGRAMS programs (a few per SM).
_TILING = {16: (128, 128, 8, 3), 64: (64, 128, 2, 3)}
_TARGET_PROGRAMS = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@partial(jax.jit, donate_argnums=0)
def _write_rows(buf, chunk, r0):
    """Donated row-range write: lands an uploaded chunk in the
    pre-allocated plane without ever holding two copies."""
    return jax.lax.dynamic_update_slice(buf, chunk, (r0, jnp.int32(0)))


@dataclass
class PallasDB:
    """Device-resident packed DB in the scan's native layout."""

    lo: jax.Array  # (m_pad, c_pad) int8, biased low bytes
    hi: jax.Array | None  # (m_pad, pc) uint8, block-interleaved packed
    mat_elem_bit_len: int
    num_rows: int  # logical m
    num_cols: int  # logical c
    # bytes copied from the host to build the planes (the tight pack path
    # ships unpadded chunks, so this is smaller than the device
    # footprint); 0 = built without a host upload (device-generated)
    shipped_bytes: int = 0

    @property
    def device_bytes(self) -> int:
        return self.lo.size + (self.hi.size if self.hi is not None else 0)


def build_pallas_db(
    mat: np.ndarray,
    mat_elem_bit_len: int,
    chunk_rows: int = 1 << 17,
    m_align: int = ROW_ALIGN,
    sharding=None,
) -> PallasDB:
    """(m, c) uint16/uint32 encoded DB -> packed device planes.

    Packing and upload are pipelined in row chunks: device_put dispatches
    asynchronously, so chunk i copies while the host packs chunk i+1.

    m_align rounds the padded fingerprint dimension up (sharded serving
    passes model_shards * ROW_ALIGN so every shard gets whole K blocks);
    `sharding` places the planes straight onto a mesh."""
    try:
        from ..native import engine as _native
    except Exception:  # pragma: no cover - native build unavailable
        _native = None

    m, c = mat.shape
    m_pad = _round_up(m, m_align)
    c_pad = _round_up(c, COL_ALIGN)
    hb = hi_bits(mat_elem_bit_len)
    pack = hi_pack_factor(mat_elem_bit_len) if hb > 0 else 0
    bits = (8 // pack if pack > 1 else 8) if pack else 0

    chunk_rows = _round_up(chunk_rows, ROW_ALIGN)
    if sharding is not None:
        # sharded placement: build the full host planes and land them with
        # ONE sharded device_put each — chunk accumulation + concatenate
        # would hold ~2x the DB in device memory at peak
        chunk_rows = m_pad
    # unsharded chunks ship a TIGHT lo (no zero columns/rows) and land in a
    # pre-allocated device buffer via donated dynamic_update_slice —
    # accumulating chunks for a concatenate would double the peak footprint
    tight = _native is not None and mat.dtype == np.uint16 and sharding is None
    if tight:
        pc = (c_pad // pack if pack > 1 else c_pad) if hb > 0 else 0
        # padded rows hold biased -128 == VALUE ZERO, so they contribute
        # nothing for ANY query — the ctr hint folds multiply nonzero A
        # values against them (a zero-padded-queries-only invariant would
        # silently corrupt the hint)
        lo_dev = jnp.full((m_pad, c_pad), -128, jnp.int8)
        hi_dev = jnp.zeros((m_pad, pc), jnp.uint8) if hb > 0 else None
        shipped = 0
        for r0 in range(0, m, chunk_rows):
            rows_pad = min(chunk_rows, m_pad - r0)
            rows = min(rows_pad, m - r0)
            lo_host, hi_host = _native.build_packed_planes(
                mat[r0 : r0 + rows], rows_pad, c_pad, pack, bits, tight_lo=True
            )
            shipped += lo_host.nbytes
            lo_dev = _write_rows(lo_dev, jax.device_put(lo_host), r0)
            if hb > 0:
                shipped += hi_host.nbytes
                hi_dev = _write_rows(hi_dev, jax.device_put(hi_host), r0)
        return PallasDB(lo_dev, hi_dev, mat_elem_bit_len, m, c,
                        shipped_bytes=shipped)

    lo_chunks, hi_chunks = [], []
    shipped = 0
    for r0 in range(0, m_pad, chunk_rows):
        rows_pad = min(chunk_rows, m_pad - r0)
        rows = max(0, min(rows_pad, m - r0))
        sub = mat[r0 : r0 + rows]
        if _native is not None and rows > 0:
            lo_host, hi_host = _native.build_packed_planes(sub, rows_pad, c_pad, pack, bits)
        else:
            # padded rows/cols hold biased -128 == value zero: exact for
            # any query, including the nonzero A slabs of the hint folds
            lo_host = np.full((rows_pad, c_pad), -128, np.int8)
            lo_host[:rows, :c] = ((sub & np.uint16(255)).astype(np.int16) - 128).astype(np.int8)
            hi_host = None
            if hb > 0:
                pc = c_pad // pack if pack > 1 else c_pad
                hi_full = np.zeros((rows_pad, c_pad), np.uint8)
                hi_full[:rows, :c] = (sub >> 8).astype(np.uint8)
                if pack == 1:
                    hi_host = hi_full
                else:
                    # block interleave: field j of word t <- logical col j*pc+t
                    hi_host = np.zeros((rows_pad, pc), np.uint8)
                    for j in range(pack):
                        hi_host |= hi_full[:, j * pc : (j + 1) * pc] << np.uint8(bits * j)
        lo_chunks.append(jax.device_put(lo_host, sharding))
        shipped += lo_host.nbytes
        if hb > 0:
            if hi_host is None:  # native pack==0 path never lands here
                pc = c_pad // pack if pack > 1 else c_pad
                hi_host = np.zeros((rows_pad, pc), np.uint8)
            hi_chunks.append(jax.device_put(hi_host, sharding))
            shipped += hi_host.nbytes

    lo_dev = lo_chunks[0] if len(lo_chunks) == 1 else jnp.concatenate(lo_chunks, axis=0)
    hi_dev = None
    if hi_chunks:
        hi_dev = hi_chunks[0] if len(hi_chunks) == 1 else jnp.concatenate(hi_chunks, axis=0)
    return PallasDB(lo_dev, hi_dev, mat_elem_bit_len, m, c, shipped_bytes=shipped)


def _pack_params(mat_elem_bit_len: int) -> tuple[int, int]:
    """(pack, bits) of the high plane: values per byte, bits per value."""
    pack = hi_pack_factor(mat_elem_bit_len)
    return pack, (8 // pack if pack > 1 else 8)


# -- triton path ---------------------------------------------------------------


def _scan_kernel(qd_ref, lo_ref, *refs, has_hi, bits, block_r, block_n,
                 block_k, steps_per_split, n_steps):
    """One (row block, column block, K split) tile: sum the int8 products
    of its query-digit rows with the DB rows of its split."""
    import jax.experimental.pallas as pl

    if has_hi:
        hi_ref, out_lo_ref, out_hi_ref = refs
    else:
        (out_lo_ref,) = refs
    r0 = pl.multiple_of(pl.program_id(0) * block_r, block_r)
    col0 = pl.multiple_of(pl.program_id(1) * block_n, block_n)
    step0 = pl.program_id(2) * steps_per_split
    n_iter = jnp.minimum(steps_per_split, n_steps - step0)
    rows = pl.ds(r0, block_r)
    cols = pl.ds(col0, block_n)
    if has_hi:
        # the column block lies inside one packed field: words
        # [word0, word0 + block_n) hold it at bit offset shift
        pc = hi_ref.shape[1]
        field = col0 // pc
        words = pl.ds(pl.multiple_of(col0 - field * pc, block_n), block_n)
        shift = field * bits
        mask = (1 << bits) - 1

    def body(i, acc):
        k = pl.ds(pl.multiple_of((step0 + i) * block_k, block_k), block_k)
        q = qd_ref[rows, k]
        acc_lo = acc[0] + pl.dot(q, lo_ref[k, cols])
        if not has_hi:
            return (acc_lo,)
        w = hi_ref[k, words].astype(jnp.int32)
        h = ((w >> shift) & mask).astype(jnp.int8)
        return acc_lo, acc[1] + pl.dot(q, h)

    zero = jnp.zeros((block_r, block_n), jnp.int32)
    acc = jax.lax.fori_loop(0, n_iter, body, (zero, zero) if has_hi else (zero,))
    out_lo_ref[...] = acc[0]
    if has_hi:
        out_hi_ref[...] = acc[1]


def scan_config(rows: int, m_pad: int, c_pad: int, pc: int) -> dict:
    """Tiling of the triton scan for `rows` query-digit rows over
    (m_pad, c_pad) planes with packed width pc (0 = no high plane)."""
    block_r = 16 if rows <= 16 else 64
    block_n, block_k, num_warps, num_stages = _TILING[block_r]
    while c_pad % block_n or (pc and pc % block_n):
        block_n //= 2
    if block_n < 16:
        raise ValueError(f"no column block divides c_pad={c_pad}, pc={pc}")
    n_steps = m_pad // block_k
    tiles = _round_up(rows, block_r) // block_r * (c_pad // block_n)
    splits = min(n_steps, max(1, -(-_TARGET_PROGRAMS // tiles)))
    steps_per_split = -(-n_steps // splits)
    return dict(
        block_r=block_r, block_n=block_n, block_k=block_k,
        splits=-(-n_steps // steps_per_split), steps_per_split=steps_per_split,
        n_steps=n_steps, num_warps=num_warps, num_stages=num_stages,
    )


def _scan_triton(qd, lo, hi, bits, interpret):
    """(R, m_pad) int8 digits x planes -> (R_pad, c_pad) int32 products
    with the low plane and with the unpacked high plane (or None)."""
    import jax.experimental.pallas as pl
    import jax.experimental.pallas.triton as plgpu

    rows, m_pad = qd.shape
    c_pad = lo.shape[1]
    pc = hi.shape[1] if hi is not None else 0
    cfg = scan_config(rows, m_pad, c_pad, pc)
    if m_pad % cfg["block_k"]:
        raise ValueError(f"planes have {m_pad} rows, not a multiple of {cfg['block_k']}")
    block_r, block_n, splits = cfg["block_r"], cfg["block_n"], cfg["splits"]
    rows_pad = _round_up(rows, block_r)
    qd = jnp.pad(qd, ((0, rows_pad - rows), (0, 0)))
    n_out = 2 if hi is not None else 1
    out_spec = pl.BlockSpec(
        (pl.squeezed, block_r, block_n), lambda r, n, s: (s, r, n)
    )
    parts = pl.pallas_call(
        partial(
            _scan_kernel, has_hi=hi is not None, bits=bits, block_r=block_r,
            block_n=block_n, block_k=cfg["block_k"],
            steps_per_split=cfg["steps_per_split"], n_steps=cfg["n_steps"],
        ),
        grid=(rows_pad // block_r, c_pad // block_n, splits),
        out_specs=[out_spec] * n_out,
        out_shape=[jax.ShapeDtypeStruct((splits, rows_pad, c_pad), jnp.int32)] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=cfg["num_warps"], num_stages=cfg["num_stages"]
        ),
        interpret=interpret,
        name="packed_scan",
    )(*((qd, lo, hi) if hi is not None else (qd, lo)))
    sums = [p.sum(axis=0, dtype=jnp.int32) for p in parts]
    return sums[0], (sums[1] if hi is not None else None)


# -- xla path ------------------------------------------------------------------


def unpack_hi_plane(hi, pack: int, bits: int):
    """(m, pc) block-interleaved packed bytes -> (m, pc * pack) int8."""
    if pack == 1:
        return hi.astype(jnp.int8)
    mask = np.uint8((1 << bits) - 1)
    fields = [(hi >> np.uint8(bits * j)) & mask for j in range(pack)]
    return jnp.concatenate(fields, axis=1).astype(jnp.int8)


def _dot_i8(a, b):
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )


def _scan_xla(qd, lo, hi, pack, bits, q):
    out_lo = _dot_i8(qd, lo)
    if hi is None:
        return out_lo, None
    return out_lo, _dot_i8(qd[: 3 * q], unpack_hi_plane(hi, pack, bits))


# -- entry points --------------------------------------------------------------


@partial(jax.jit, static_argnames=("mat_elem_bit_len", "num_cols", "path", "interpret"))
def respond_packed_core(queries_u32, lo, hi, mat_elem_bit_len: int, num_cols: int,
                        path: str, interpret: bool = False):
    """Traceable core: (Q, m) uint32 x (lo, hi) planes -> (Q, c) uint32.

    Takes the planes as ARGUMENTS so callers can wrap it in an outer jit
    without baking the (GB-scale, per-database) arrays into the program as
    constants — a captured array changes the program hash, which means a
    fresh compile for every new database. Queries may be shorter than
    the planes (zero digits over the padded rows)."""
    q, m = queries_u32.shape
    m_pad = lo.shape[0]
    qd = recode_u32_jnp(queries_u32).reshape(NUM_U32_DIGITS * q, m)
    sums = jnp.sum(qd.astype(jnp.int32), axis=1).reshape(NUM_U32_DIGITS, q)
    qd = jnp.pad(qd, ((0, 0), (0, m_pad - m)))
    pack, bits = _pack_params(mat_elem_bit_len)
    if path == "triton":
        out_lo, out_hi = _scan_triton(qd, lo, hi, bits, interpret)
    elif path == "xla":
        out_lo, out_hi = _scan_xla(qd, lo, hi, pack, bits, q)
    else:
        raise ValueError(f"unknown respond path {path!r}")
    return _combine(out_lo, out_hi, sums, q, num_cols)


def respond_batch_packed(queries_u32, db: PallasDB, path: str | None = None):
    """(Q, m) uint32 queries x PallasDB -> (Q, c) uint32 responses."""
    from . import backend

    q, m = queries_u32.shape
    if m != db.num_rows:
        raise ValueError(f"query length {m} != DB rows {db.num_rows}")
    return respond_packed_core(
        queries_u32, db.lo, db.hi, db.mat_elem_bit_len, db.num_cols,
        path or backend.respond_path(q), backend.interpret(),
    )


def _combine(out_lo, out_hi, sums, q, c):
    """Undo the bias, apply digit shifts, fold to (Q, c) uint32."""
    p_lo = out_lo[: NUM_U32_DIGITS * q, :c].reshape(NUM_U32_DIGITS, q, c)
    p_lo = p_lo + (sums * 128)[:, :, None]
    acc = p_lo[0]
    for i in range(1, NUM_U32_DIGITS):
        acc = acc + (p_lo[i] << (8 * i))
    if out_hi is not None:
        p_hi = out_hi[: 3 * q, :c].reshape(3, q, c)
        for i in range(3):
            acc = acc + (p_hi[i] << (8 * (i + 1)))
    return acc.astype(jnp.uint32)
