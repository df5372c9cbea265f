"""Sharded PIR serving over a jax.sharding.Mesh.

The reference has no multi-device story (its parallelism is rayon
threads + one Vulkan device; SURVEY.md section 2). The scaling design:

* **model axis** — the fingerprint dimension `m` of the encoded DB is
  sharded across devices (a DB too big for one device splits its planes
  row-wise). Each device computes a partial (Q, C) int32 product over its
  local rows; a `psum` (NCCL on GPUs) reduces partials. int32 psum wraps
  two's-complement, so the reduction is exact mod 2^32.
* **data axis** — a batch of queries is sharded across devices; each
  query subset rides the same local DB shard.

The same mesh serves setup: A row blocks are replicated over `data`,
their columns (= m) sharded over `model`, and the hint partials psum'd.

Everything here is shape-polymorphic over the mesh; the driver validates
it on an 8-device virtual CPU mesh via `__graft_entry__.dryrun_multichip`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.digits import NUM_U32_DIGITS, recode_u32_jnp

_DN = (((1,), (0,)), ((), ()))


def make_mesh(devices=None, data: int | None = None, model: int | None = None) -> Mesh:
    """Build a (data, model) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None and model is None:
        model = n
        data = 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(np.asarray(devices).reshape(data, model), ("data", "model"))


def pad_db_planes(p0: np.ndarray, p1: np.ndarray, num_shards: int):
    """Zero-pad the m dimension to a multiple of the model axis; zero rows
    contribute nothing to the products."""
    m = p0.shape[0]
    pad = (-m) % num_shards
    if pad:
        p0 = np.pad(p0, ((0, pad), (0, 0)))
        p1 = np.pad(p1, ((0, pad), (0, 0)))
    return p0, p1


def shard_db_planes(mesh: Mesh, p0: np.ndarray, p1: np.ndarray):
    """Place digit planes on the mesh: m sharded over `model`, replicated
    over `data`."""
    p0, p1 = pad_db_planes(p0, p1, mesh.shape["model"])
    sharding = NamedSharding(mesh, P("model", None))
    return jax.device_put(p0, sharding), jax.device_put(p1, sharding)


def _respond_local(queries_u32, d0, d1):
    """Local-shard respond partial: (Q, m_local) x (m_local, C) -> int32."""
    q, m = queries_u32.shape
    qd = recode_u32_jnp(queries_u32)
    p0 = jax.lax.dot_general(
        qd.reshape(NUM_U32_DIGITS * q, m), d0, _DN, preferred_element_type=jnp.int32
    ).reshape(NUM_U32_DIGITS, q, -1)
    p1 = jax.lax.dot_general(
        qd[:3].reshape(3 * q, m), d1, _DN, preferred_element_type=jnp.int32
    ).reshape(3, q, -1)
    out = p0[0]
    for i in range(1, NUM_U32_DIGITS):
        out = out + (p0[i] << (8 * i))
    for i in range(3):
        out = out + (p1[i] << (8 * (i + 1)))
    return out


def sharded_respond_fn(mesh: Mesh):
    """jit'd (Q, m) x planes -> (Q, C) uint32 with queries sharded over
    `data`, m sharded over `model`, exact mod-2^32 psum reduction."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("data", "model"), P("model", None), P("model", None)),
        out_specs=P("data", None),
    )
    def _respond(queries, d0, d1):
        partial_out = _respond_local(queries, d0, d1)
        return jax.lax.psum(partial_out, "model")

    @jax.jit
    def respond(queries, d0, d1):
        return _respond(queries, d0, d1).astype(jnp.uint32)

    return respond


def build_sharded_pallas_db(mesh: Mesh, mat: np.ndarray, mat_elem_bit_len: int):
    """Pack the encoded DB and place its planes row-sharded over `model`
    (replicated over `data`). The fingerprint dimension is padded to whole
    ROW_ALIGN blocks per shard so every shard's scan has whole K blocks."""
    from ..ops import respond_pallas

    model = mesh.shape["model"]
    sharding = NamedSharding(mesh, P("model", None))
    return respond_pallas.build_pallas_db(
        mat,
        mat_elem_bit_len,
        m_align=model * respond_pallas.ROW_ALIGN,
        sharding=sharding,
    )


def _packed_partial_i32(queries_local, lo_local, hi_local, db, path=None):
    """Local-shard packed respond partial -> (Q, c) int32 (pre-psum).

    Everything downstream of the dots is linear in the DB rows, so
    combining locally and psum'ing the int32 accumulator is exact."""
    from ..ops import backend, respond_pallas

    return respond_pallas.respond_packed_core(
        queries_local, lo_local, hi_local, db.mat_elem_bit_len, db.num_cols,
        path or backend.respond_path(queries_local.shape[0]),
        backend.interpret(),
    ).astype(jnp.int32)


def _sharded_packed_fn(mesh: Mesh, db, lead_specs: tuple, body, out_specs=P(None, None)):
    """Shared scaffolding for the packed shard_map kernels: `body` maps
    (lead args..., lo, hi_or_None) -> local int32 partial; the wrapper
    psums over `model`, jits with the planes as call-time ARGUMENTS (not
    closure constants, so one compiled program serves every database of a
    geometry), and closes over db only at call time."""
    planes = (db.lo,) if db.hi is None else (db.lo, db.hi)
    in_specs = lead_specs + (P("model", None),) * len(planes)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    def _mapped(*args):
        lead, ps = args[: len(lead_specs)], args[len(lead_specs) :]
        lo, hi = ps[0], (ps[1] if len(ps) > 1 else None)
        return jax.lax.psum(body(*lead, lo, hi), "model")

    jitted = jax.jit(lambda *args: _mapped(*args).astype(jnp.uint32))
    return lambda *lead: jitted(*lead, *planes)


def sharded_respond_packed_fn(mesh: Mesh, db):
    """jit'd (Q, m_pad) -> (Q, c) uint32 over the packed planes: queries
    sharded (data, model), DB rows sharded over model, exact int32 psum.

    Callers must pad queries to db.lo.shape[0] columns (zero pad — padded
    DB rows are zero, padded query digits are zero, so the tail
    contributes nothing)."""

    def body(queries, lo, hi):
        return _packed_partial_i32(queries, lo, hi, db)

    return _sharded_packed_fn(
        mesh, db, (P("data", "model"),), body, out_specs=P("data", None)
    )


def sharded_hint_packed_fn(mesh: Mesh, db):
    """jit'd hint step over the packed planes: an A row block is a batch of
    'queries' replicated over `data`, columns sharded over `model`."""

    def body(a_block, lo, hi):
        return _packed_partial_i32(a_block, lo, hi, db, path="xla")

    return _sharded_packed_fn(mesh, db, (P(None, "model"),), body)


def _sharded_chunk_rows(m_local: int, align: int) -> int:
    """Rows per hint-fold chunk on one shard: a multiple of `align` that
    divides m_local exactly (the fold slices fixed windows at j*cc — an
    overhang would re-read rows), targeting ~<= 2^17 rows. m_local = t *
    align by construction (build_sharded_pallas_db aligns m_pad to model
    * ROW_ALIGN); the largest divisor of t within the target is chosen,
    and 1 always works."""
    if m_local % align != 0:
        raise AssertionError(
            f"sharded planes misaligned: m_local={m_local} align={align}"
        )
    t = m_local // align
    max_blocks = max(1, (1 << 17) // align)
    for cand in range(min(t, max_blocks), 0, -1):
        if t % cand == 0:
            return cand * align
    return align


def sharded_hint_ctr_packed(mesh: Mesh, db, seed: bytes) -> np.ndarray:
    """Full (LWE_DIMENSION, c) uint32 hint over the mesh, ctr PRG mode.

    ctr A is fingerprint-major (core/prg.py), so each shard's local
    fingerprint range of A is ONE contiguous ctr word range — every shard
    generates exactly its own slice on device (never the full A slab, so
    per-chip A memory is m_local * K, not m * K) and folds it against its
    local packed DB rows; partials psum across devices, exact mod 2^32.
    Within a shard the fold walks fixed-size column chunks so the slab
    working set stays bounded at any DB size.

    Per-(shard, chunk) ctr block starts are computed on the host with
    exact Python integers and shipped in as a model-sharded array — no
    64-bit arithmetic needs to be traced."""
    from ..ops import prg_jax, respond_pallas
    from ..params import LWE_DIMENSION

    k_pad = -(-LWE_DIMENSION // 128) * 128
    model = mesh.shape["model"]
    m_pad = db.lo.shape[0]
    m_local = m_pad // model
    cc = _sharded_chunk_rows(m_local, respond_pallas.ROW_ALIGN)
    n_chunks = m_local // cc

    def body(seed_words, blk0_local, off_local, j0, lo, hi):
        slab = prg_jax.rows_from_blocks(
            seed_words, blk0_local[0], off_local[0], cc, LWE_DIMENSION
        )
        g = jnp.pad(slab, ((0, 0), (0, k_pad - LWE_DIMENSION))).T
        lo_c = jax.lax.dynamic_slice(lo, (j0, jnp.int32(0)), (cc, lo.shape[1]))
        hi_c = (
            jax.lax.dynamic_slice(hi, (j0, jnp.int32(0)), (cc, hi.shape[1]))
            if hi is not None
            else None
        )
        return respond_pallas.respond_packed_core(
            g, lo_c, hi_c, db.mat_elem_bit_len, db.num_cols, path="xla"
        ).astype(jnp.int32)

    step = _sharded_packed_fn(
        mesh, db, (P(), P("model", None), P("model"), P()), body
    )

    seed_words = prg_jax.seed_to_words(seed)
    hint = np.zeros((k_pad, db.num_cols), np.uint32)
    for j in range(n_chunks):
        blk0_all = np.zeros((model, 2), np.uint32)
        off_all = np.zeros(model, np.int32)
        for s in range(model):
            word0 = (s * m_local + j * cc) * LWE_DIMENSION
            blk0 = (word0 * 4) // prg_jax.RATE
            blk0_all[s] = (blk0 & 0xFFFFFFFF, blk0 >> 32)
            off_all[s] = word0 - blk0 * (prg_jax.RATE // 4)
        out = step(seed_words, blk0_all, off_all, jnp.int32(j * cc))
        hint += np.asarray(out)  # uint32 wrap add == exact mod 2^32
    return hint[:LWE_DIMENSION]


def sharded_hint_accumulate_fn(mesh: Mesh):
    """jit'd hint-matmul step: acc (R, C) int32 += A_block (R, m) u32 . D.

    A blocks arrive replicated over `data` and column-sharded over
    `model`; the per-shard digit products psum into the full accumulator.
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P(None, "model"), P("model", None), P("model", None)),
        out_specs=P(None, None),
    )
    def _step(acc, a_u32, d0, d1):
        ad = recode_u32_jnp(a_u32)
        out = acc
        for i in range(NUM_U32_DIGITS):
            out = out + (
                jax.lax.dot_general(ad[i], d0, _DN, preferred_element_type=jnp.int32)
                << (8 * i)
            )
        for i in range(NUM_U32_DIGITS - 1):
            out = out + (
                jax.lax.dot_general(ad[i], d1, _DN, preferred_element_type=jnp.int32)
                << (8 * (i + 1))
            )
        # each model shard holds a partial over its m columns; reduce, then
        # keep a single copy (out_specs replicates)
        return jax.lax.psum(out - acc, "model") + acc

    return jax.jit(_step)
