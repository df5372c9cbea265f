"""The PIR server: device-resident encoded DB, int8 tensor-core respond.

Equivalent of the reference Server (reference:
chalametpir_server/src/server.rs:16-218), redesigned for an accelerator:

* the encoded DB is stored on the device as int8 planes in the (m, C)
  orientation (packed low/high planes, or two balanced digit planes) —
  no transpose/compress step, the int8 products stream the K dimension
  directly (the reference's transposed + bit-packed layout exists to
  please CPU caches);
* the hint matmul A . D runs as int8 products on the device, with A
  generated there (ctr mode) or streamed from the host XOF in row blocks
  (stream mode), so the full (1774, m) matrix never occupies the device;
* respond accepts one query or a batch; a batch is one scan of the DB.

A numpy backend (`backend="numpy"`) provides the same semantics without
a device, used as the cross-check oracle in tests.
"""

from __future__ import annotations

import contextlib
import gc
from functools import partial

import numpy as np

from ..core import encode_db, matrix_io, prg
from ..errors import (
    EmptyKVDatabase,
    IncompatibleDimensionForRowVectorTransposedMatrixMultiplication,
)
from ..params import (
    LWE_DIMENSION,
    MAX_CIPHER_TEXT_BIT_LEN,
    MIN_CIPHER_TEXT_BIT_LEN,
    SEED_BYTE_LEN,
    SERVER_SETUP_MAX_ATTEMPT_COUNT,
    find_mat_elem_bit_len,
)


class Server:
    """Stateful PIR server holding the device-resident encoded database."""

    def __init__(
        self,
        backend: str,
        planes,
        num_query_cols: int,
        num_response_cols: int,
        mat_elem_bit_len: int,
        layout: str = "digit2",
        mesh=None,
    ):
        self._backend = backend
        # jax/digit2: (d0, d1) int8 device arrays; jax/packed: a PallasDB;
        # numpy: the raw uint16 D matrix
        self._planes = planes
        self._layout = layout
        self._num_query_cols = num_query_cols
        self._num_response_cols = num_response_cols
        self.mat_elem_bit_len = mat_elem_bit_len
        self._mesh = mesh
        # measured setup attribution (upload seconds/bytes, phase and CPU
        # split), filled by the device setup paths and read by bench.py
        self.setup_stats: dict = {}
        self._sharded_respond = None
        if mesh is not None:
            from ..parallel import sharded_respond_packed_fn

            self._sharded_respond = sharded_respond_packed_fn(mesh, planes)

    # -- setup ---------------------------------------------------------------

    @classmethod
    def setup(
        cls,
        seed: bytes,
        db: dict[bytes, bytes],
        arity: int = 3,
        backend: str = "auto",
        layout: str = "auto",
        prg_mode: str = "stream",
        hint_block_rows: int | None = None,
        rng: np.random.Generator | None = None,
        mesh=None,
        mat_elem_bit_len: int | None = None,
    ) -> tuple["Server", bytes, bytes]:
        """Encode `db`, compute the hint M = A . D, return
        (server, hint_bytes, filter_param_bytes)
        (reference: server.rs:47-78).

        prg_mode: "stream" derives A exactly like the reference (serial
        host XOF, wire-compatible with Rust peers); "ctr" derives A in
        independent counter blocks so it is generated *on the device* and
        never crosses the host link — both peers must use the same mode
        (see core/prg.py).

        mesh: a jax.sharding.Mesh with ("data", "model") axes. The encoded
        DB's fingerprint dimension is sharded over `model` (for DBs beyond
        one device's memory), query batches over `data`; hint partials and
        responses psum across devices, exact mod 2^32.

        mat_elem_bit_len overrides the derived element width (expert /
        test knob — the reference always derives it from the DB size,
        server.rs:193-218; scaled-down sharding tests use the override to
        exercise a big-DB geometry on small data)."""
        if len(db) == 0:
            raise EmptyKVDatabase()
        if len(seed) != SEED_BYTE_LEN:
            raise ValueError(f"seed must be {SEED_BYTE_LEN} bytes")
        if layout not in ("auto", "packed", "digit2"):
            raise ValueError(f"unknown layout {layout!r} (auto/packed/digit2)")
        # 0-byte values encode fine but are PERMANENTLY unretrievable: the
        # row codec requires the 0x81 boundary marker strictly after the
        # 32-byte digest (serialization.rs:164-183 and our codec alike),
        # so an empty value always decodes as RowNotDecodable. Surface the
        # data loss at setup instead of at every future query.
        if any(len(v) == 0 for v in db.values()):
            raise ValueError("0-byte values are not encodable by the row codec")
        backend = _resolve_backend(backend)

        from ..utils import telemetry

        # a million-entry `db` dict pins millions of objects in the old GC
        # generation while tracing/compilation below allocates heavily —
        # every gen-2 collection then walks the whole dict. Suspend the
        # collector for the duration (no cycles are created that must be
        # reclaimed mid-setup; anything cyclic is collected on exit).
        if mat_elem_bit_len is not None and not (
            MIN_CIPHER_TEXT_BIT_LEN <= mat_elem_bit_len <= MAX_CIPHER_TEXT_BIT_LEN
        ):
            from ..errors import ImpossibleEncodedDBMatrixElementBitLength

            raise ImpossibleEncodedDBMatrixElementBitLength()

        with _gc_paused():
            bit_len = (
                mat_elem_bit_len
                if mat_elem_bit_len is not None
                else find_mat_elem_bit_len(len(db))
            )
            # device fast path: ctr PRG + packed layout + native engine
            # => the streaming pipeline (encode chunks -> pack -> async
            # upload -> on-device hint fold, all overlapped)
            if (
                mesh is None
                and backend == "jax"
                and prg_mode == "ctr"
                and layout in ("auto", "packed")
                and bit_len <= 12
                and encode_db._native is not None
            ):
                server, hint, filt = cls._setup_jax_ctr_pipelined(
                    seed, db, arity, bit_len, rng
                )
                return server, matrix_io.matrix_to_bytes(hint), filt.to_bytes()
            with telemetry.span("server_setup.encode_db", entries=len(db), b=bit_len):
                mat_d, filt = encode_db.from_kv_database(
                    db, arity, bit_len, SERVER_SETUP_MAX_ATTEMPT_COUNT, rng
                )
            m, cols = mat_d.shape

            if mesh is not None:
                server, hint = cls._setup_sharded(seed, mat_d, bit_len, prg_mode, mesh)
            elif backend == "numpy":
                mat_a = prg.expand_seed(LWE_DIMENSION, m, seed, mode=prg_mode)
                hint = (mat_a.astype(np.uint64) @ mat_d.astype(np.uint64)).astype(np.uint32)
                server = cls("numpy", mat_d, m, cols, bit_len)
            else:
                server, hint = cls._setup_jax(
                    seed, mat_d, bit_len, layout, prg_mode, hint_block_rows
                )

        return server, matrix_io.matrix_to_bytes(hint), filt.to_bytes()

    @classmethod
    def _setup_jax_ctr_pipelined(cls, seed, db_dict, arity, bit_len, rng):
        """Streaming device setup (ctr mode): the native engine
        assembles D in fingerprint-chunk order (chunk-priority topological
        execution, core/encode_db.from_kv_database_streaming); as each
        chunk finalises it is packed, device_put (async DMA), folded into
        the hint on device (A[:, chunk] . D[chunk] from the on-device ctr
        PRG), and written into the serving planes. The encode pass, the
        host->device upload, and the whole hint matmul all overlap — wall
        time approaches the pure upload cost.

        Replaces the reference's sequential setup (server.rs:47-78:
        encode, then A expansion, then A . D, then transpose+compress)."""
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        import jax
        import jax.numpy as jnp

        from ..core.filter import filter_geometry
        from ..native import engine as _native_eng
        from ..ops import backend, prg_jax, respond_pallas
        from ..ops.packed import hi_bits, hi_pack_factor
        from ..utils import telemetry

        # filter geometry is a function of the DB size alone, so the chunk
        # size is known before the filter is built
        _, _, num_fp = filter_geometry(arity, len(db_dict))
        cc = _ctr_chunk_cols(num_fp)

        # whole-setup CPU attribution (see setup_stats below): every second
        # of wall is this thread's CPU, the encode worker's, some other
        # thread of this process (jax dispatch, host->device copies), or
        # time the process did not have a core
        import time as _time

        wall0 = _time.perf_counter()
        main_cpu0 = _time.thread_time()
        proc_cpu0 = _time.process_time()
        worker_stats: dict = {}

        with telemetry.span(
            "server_setup.encode_stream", entries=len(db_dict), b=bit_len, chunk=cc
        ):
            mat16, filt, chunks = encode_db.from_kv_database_streaming(
                db_dict, arity, bit_len, cc, SERVER_SETUP_MAX_ATTEMPT_COUNT,
                rng, stats=worker_stats,
            )
        m = filt.num_fingerprints
        m_pad, cols = mat16.shape
        n_chunks = m_pad // cc

        hb = hi_bits(bit_len)
        pack = hi_pack_factor(bit_len) if hb > 0 else 0
        bits = (8 // pack if pack > 1 else 8) if pack else 0
        c_pad = -(-cols // respond_pallas.COL_ALIGN) * respond_pallas.COL_ALIGN
        pc = (c_pad // pack if pack > 1 else c_pad) if hb > 0 else 0

        # -128 biased == value zero everywhere a chunk never writes
        lo_dev = jnp.full((m_pad, c_pad), -128, jnp.int8)
        hi_dev = jnp.zeros((m_pad, pc), jnp.uint8) if hb > 0 else None
        hint_buf = jnp.zeros((K_PAD, cols), jnp.uint32)
        seed_words = prg_jax.seed_to_words(seed)

        phase = dict(wait=0.0, pack=0.0, put=0.0, dispatch=0.0, drain=0.0)
        upload_bytes = 0
        # two host pack-buffer pairs reused round-robin: fresh GB-scale
        # MAP_POPULATE allocations per chunk degrade late in a long-lived
        # jax process. A pair is only rewritten after the device arrays
        # produced from it two chunks ago are ready — on an accelerator
        # device_put copies host->device, so block_until_ready means the
        # copy (the host memory's only reader) has completed. On the CPU
        # backend device_put can zero-copy ALIAS page-aligned host buffers
        # permanently (reuse there corrupts the hint), so the CPU path
        # allocates fresh buffers per chunk — it only serves tests.
        reuse_bufs = backend.accelerator_present()
        pack_bufs: list = [(None, None), (None, None)]
        in_flight: list = [(), ()]
        with telemetry.span(
            "server_setup.stream_pack_upload_fold", chunks=n_chunks, m=m, cols=cols
        ):
            it = iter(chunks)
            while True:
                t0 = _time.perf_counter()
                j = next(it, None)
                phase["wait"] += _time.perf_counter() - t0
                if j is None:
                    break
                r0 = j * cc
                slot = j % 2
                t0 = _time.perf_counter()
                for dev_arr in in_flight[slot]:
                    dev_arr.block_until_ready()
                phase["put"] += _time.perf_counter() - t0
                t0 = _time.perf_counter()
                c0 = _time.thread_time()
                lo_host, hi_host = _native_eng.build_packed_planes(
                    mat16[r0 : r0 + cc], cc, c_pad, pack, bits, tight_lo=True,
                    out=pack_bufs[slot] if reuse_bufs else None,
                )
                if reuse_bufs:
                    pack_bufs[slot] = (lo_host, hi_host)
                phase["pack"] += _time.perf_counter() - t0
                phase["pack_cpu"] = phase.get("pack_cpu", 0.0) + (
                    _time.thread_time() - c0
                )
                upload_bytes += lo_host.nbytes + (hi_host.nbytes if hb > 0 else 0)
                t0 = _time.perf_counter()
                lo_c = jax.device_put(lo_host)
                hi_c = jax.device_put(hi_host) if hb > 0 else None
                if reuse_bufs:
                    in_flight[slot] = (lo_c,) + ((hi_c,) if hb > 0 else ())
                phase["put"] += _time.perf_counter() - t0
                t0 = _time.perf_counter()
                blk0_words, offset = prg_jax.fp_block_start(r0, LWE_DIMENSION)
                out = _gen_fold_tight(
                    seed_words, blk0_words, offset, lo_c, hi_c,
                    c_pad=c_pad, bit_len=bit_len,
                )
                hint_buf = _accum_hint(hint_buf, out)
                lo_dev = respond_pallas._write_rows(lo_dev, lo_c, jnp.int32(r0))
                if hb > 0:
                    hi_dev = respond_pallas._write_rows(hi_dev, hi_c, jnp.int32(r0))
                phase["dispatch"] += _time.perf_counter() - t0
            t0 = _time.perf_counter()
            hint = np.asarray(hint_buf)[:LWE_DIMENSION].astype(np.uint32)
            phase["drain"] = _time.perf_counter() - t0
        telemetry.trace_event(
            "stream_pipeline_phases",
            **{k: round(v, 2) for k, v in phase.items()},
        )

        pdb = respond_pallas.PallasDB(lo_dev, hi_dev, bit_len, m, cols)
        server = cls("jax", pdb, m, cols, bit_len, "packed")
        # measured upload attribution: `put` is the wall time spent inside
        # the chunk device_put calls and `drain` the final queue drain.
        #
        # cpu_s splits the CPU time: main (this thread: pack + waits +
        # numpy), worker (the C++ encode thread), runtime (every OTHER
        # thread of this process — jax dispatch and host->device copies),
        # and external (wall not covered by this process's CPU time). All
        # are measured via thread_time/process_time, never modeled.
        wall = _time.perf_counter() - wall0
        main_cpu = _time.thread_time() - main_cpu0
        proc_cpu = _time.process_time() - proc_cpu0
        worker_cpu = worker_stats.get("worker_cpu_s", 0.0)
        server.setup_stats = {
            "upload_bytes": upload_bytes,
            "upload_s": round(phase["put"] + phase["drain"], 3),
            "phases_s": {k: round(v, 2) for k, v in phase.items()},
            "cpu_s": {
                "wall": round(wall, 2),
                "main": round(main_cpu, 2),
                "worker": round(worker_cpu, 2),
                "runtime": round(max(proc_cpu - main_cpu - worker_cpu, 0.0), 2),
                "external": round(max(wall - proc_cpu, 0.0), 2),
            },
            "worker_minflt": worker_stats.get("worker_minflt"),
        }
        return server, hint, filt

    @classmethod
    def _setup_sharded(cls, seed, mat_d, bit_len, prg_mode, mesh):
        """Multi-chip setup: packed planes row-sharded over the `model`
        axis, hint computed as sharded packed matvecs over host A blocks."""
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        import jax

        from ..parallel import build_sharded_pallas_db, sharded_hint_packed_fn
        from ..utils import telemetry

        m, cols = mat_d.shape
        with telemetry.span("server_setup.pack_and_shard", m=m, cols=cols):
            db = build_sharded_pallas_db(mesh, mat_d, bit_len)
        m_pad = db.lo.shape[0]

        if prg_mode == "ctr":
            # A never exists on the host: every shard generates ONLY its
            # local fingerprint range of A (one contiguous ctr word range,
            # fingerprint-major layout) and folds it on device
            from ..parallel import sharded_hint_ctr_packed

            with telemetry.span("server_setup.hint_sharded_ctr", m_pad=m_pad):
                hint = sharded_hint_ctr_packed(mesh, db, seed)
            return cls("jax", db, m, cols, bit_len, "packed", mesh=mesh), hint

        hint_step = sharded_hint_packed_fn(mesh, db)
        block_rows = max(1, (16 << 20) // max(1, 4 * m))
        block_rows = min(block_rows, LWE_DIMENSION)
        hint_parts = []
        with telemetry.span("server_setup.hint_sharded", m_pad=m_pad):
            for _, block in prg.prefetch_iter(
                prg.iter_row_blocks(LWE_DIMENSION, m, seed, block_rows, mode=prg_mode)
            ):
                r = block.shape[0]
                if r < block_rows:
                    block = np.pad(block, ((0, block_rows - r), (0, 0)))
                block = np.pad(block, ((0, 0), (0, m_pad - m)))
                hint_parts.append((r, hint_step(block)))
            hint = np.concatenate(
                [np.asarray(h)[:r] for r, h in hint_parts], axis=0
            ).astype(np.uint32)
        return cls("jax", db, m, cols, bit_len, "packed", mesh=mesh), hint

    @classmethod
    def _setup_jax(cls, seed, mat_d, bit_len, layout, prg_mode, hint_block_rows):
        from ..utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        import jax
        import jax.numpy as jnp

        from ..ops import digits, matmul_u32, respond_pallas

        import time as _t

        wall0, main_cpu0, proc_cpu0 = (
            _t.perf_counter(), _t.thread_time(), _t.process_time(),
        )
        prefetch_stats: dict = {}

        def _cpu_attrib():
            # CPU attribution (see _setup_jax_ctr_pipelined): producer =
            # the XOF prefetch thread; runtime = jax dispatch + copies
            wall = _t.perf_counter() - wall0
            main = _t.thread_time() - main_cpu0
            proc = _t.process_time() - proc_cpu0
            producer = prefetch_stats.get("producer_cpu_s", 0.0)
            return {
                "wall": round(wall, 2),
                "main": round(main, 2),
                "producer": round(producer, 2),
                "runtime": round(max(proc - main - producer, 0.0), 2),
                "external": round(max(wall - proc, 0.0), 2),
            }

        m, cols = mat_d.shape
        if layout == "auto":
            # the packed layout reads ~1-1.5 B/element instead of 2; use
            # it wherever the high byte packs below a full byte
            layout = "packed" if bit_len <= 12 else "digit2"

        # Stream A row blocks host->device, folding each into M = A . D.
        # Block size targets ~16 MB copies. Every block is padded to the
        # same shape so the device matmul compiles exactly once.
        if hint_block_rows is None:
            hint_block_rows = max(1, (16 << 20) // max(1, 4 * m))
        hint_block_rows = min(hint_block_rows, LWE_DIMENSION)

        from ..utils import telemetry

        if layout == "packed":
            # ctr hint folds slice the planes in _ctr_chunk_cols chunks —
            # align the padded fingerprint dim to whole chunks
            m_align = (
                _ctr_chunk_cols(m) if prg_mode == "ctr" else respond_pallas.ROW_ALIGN
            )
            import time as _time

            t0 = _time.perf_counter()
            with telemetry.span("server_setup.pack_and_upload", m=m, cols=cols):
                db = respond_pallas.build_pallas_db(mat_d, bit_len, m_align=m_align)
            pack_upload_s = _time.perf_counter() - t0

            # The hint matmul IS a batched respond: each A row block is a
            # batch of hint_block_rows "queries". The hint accumulates in
            # a device buffer; only the final (1774 x cols) matrix crosses
            # back to the host. In ctr mode the A rows are generated
            # on-device too — setup then uploads nothing but the DB.
            n_blocks = -(-LWE_DIMENSION // hint_block_rows)
            pad_rows = n_blocks * hint_block_rows

            if prg_mode == "ctr":
                # fingerprint-major ctr A (core/prg.py): the hint folds per
                # DB row chunk — A[:, chunk] . D[chunk] with each chunk's A
                # slab one contiguous on-device ctr generation. This is the
                # non-pipelined fallback (CPU tests / no native engine);
                # the streaming path in _setup_jax_ctr_pipelined fuses the
                # same folds with the chunked DB upload.
                from ..ops import prg_jax

                seed_words = prg_jax.seed_to_words(seed)
                m_pad = db.lo.shape[0]
                cc = m_align  # m_pad is chunk-aligned by construction
                n_chunks = m_pad // cc
                with telemetry.span("server_setup.hint_ctr_on_device", chunks=n_chunks):
                    hint_buf = jnp.zeros((K_PAD, cols), jnp.uint32)
                    for j in range(n_chunks):
                        blk0_words, offset = prg_jax.fp_block_start(
                            j * cc, LWE_DIMENSION
                        )
                        out = _gen_fold_sliced(
                            seed_words, blk0_words, offset, db.lo, db.hi,
                            jnp.int32(j * cc), cc=cc, c=cols, bit_len=bit_len,
                        )
                        hint_buf = _accum_hint(hint_buf, out)
                    hint = np.asarray(hint_buf)[:LWE_DIMENSION].astype(np.uint32)
                server = cls("jax", db, m, cols, bit_len, "packed")
                server.setup_stats = {
                    # bytes actually copied (the tight pack path ships
                    # unpadded chunks, smaller than the device planes)
                    "upload_bytes": db.shipped_bytes or db.device_bytes,
                    "upload_s": round(pack_upload_s, 3),
                    "cpu_s": _cpu_attrib(),
                }
                return server, hint

            # planes are jit ARGUMENTS (see respond_packed_core) so the
            # compiled program is reused across databases of one geometry

            @partial(jax.jit, donate_argnums=0, static_argnames=("bit_len", "ncols"))
            def hint_step(hint_buf, block, r0, lo, hi, bit_len, ncols):
                out = respond_pallas.respond_packed_core(
                    block, lo, hi, bit_len, ncols, path="xla"
                )
                return jax.lax.dynamic_update_slice(
                    hint_buf, out, (r0, jnp.int32(0))
                )

            up_bytes, up_s = 0, 0.0
            with telemetry.span("server_setup.hint_stream", blocks=n_blocks):
                hint_buf = jnp.zeros((pad_rows, cols), jnp.uint32)
                blocks = prg.prefetch_iter(
                    # mode is always "stream" on this branch (the ctr branch
                    # returned above) — forwarded so an unknown mode raises
                    # here like every other backend/layout path
                    prg.iter_row_blocks(
                        LWE_DIMENSION, m, seed, hint_block_rows, mode=prg_mode
                    ),
                    stats=prefetch_stats,
                )
                for r0, block in blocks:
                    if block.shape[0] < hint_block_rows:
                        block = np.pad(block, ((0, hint_block_rows - block.shape[0]), (0, 0)))
                    up_bytes += block.nbytes
                    t0 = _time.perf_counter()
                    block_dev = jax.device_put(block)
                    up_s += _time.perf_counter() - t0
                    hint_buf = hint_step(
                        hint_buf, block_dev, jnp.int32(r0),
                        db.lo, db.hi, bit_len, cols,
                    )
                # the hint readback is also the queue drain: it cannot
                # complete until every dispatched A-block copy has — its
                # wall time belongs to the upload measurement (the
                # per-block put timings above are dispatch-only)
                t0 = _time.perf_counter()
                hint = np.asarray(hint_buf)[:LWE_DIMENSION].astype(np.uint32)
                drain_s = _time.perf_counter() - t0
            server = cls("jax", db, m, cols, bit_len, "packed")
            # stream mode ships the XOF-expanded A blocks AND the packed DB
            # planes to the device — both measured, both attributed
            server.setup_stats = {
                "upload_bytes": up_bytes + (db.shipped_bytes or db.device_bytes),
                # A-block put dispatches + final drain + the DB pack/upload
                # pass (host pack CPU time included)
                "upload_s": round(up_s + drain_s + pack_upload_s, 3),
                "a_upload_bytes": up_bytes,
                "cpu_s": _cpu_attrib(),
            }
            return server, hint

        p0_host, p1_host = digits.db_digit_planes_np(mat_d)
        d0 = jax.device_put(p0_host)
        d1 = jax.device_put(p1_host)
        hint_rows = []
        for r0, block in prg.prefetch_iter(
            prg.iter_row_blocks(LWE_DIMENSION, m, seed, hint_block_rows, mode=prg_mode)
        ):
            r = block.shape[0]
            if r < hint_block_rows:
                block = np.pad(block, ((0, hint_block_rows - r), (0, 0)))
            acc = jnp.zeros((hint_block_rows, cols), jnp.int32)
            acc = matmul_u32.digit_matmul_accumulate(acc, jax.device_put(block), d0, d1)
            hint_rows.append((r, acc))
        hint = np.concatenate(
            [np.asarray(h)[:r] for r, h in hint_rows], axis=0
        ).astype(np.uint32)
        return cls("jax", (d0, d1), m, cols, bit_len, "digit2"), hint

    # -- online --------------------------------------------------------------

    def respond(self, query: bytes) -> bytes:
        """Answer a single serialized client query
        (reference: server.rs:184-190)."""
        q = matrix_io.matrix_from_bytes(query)
        if q.shape[0] != 1 or q.shape[1] != self._num_query_cols:
            raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
        out = self.respond_batch(q)
        return matrix_io.matrix_to_bytes(out)

    def respond_batch(self, queries: np.ndarray) -> np.ndarray:
        """(Q, m) uint32 -> (Q, C) uint32. A batch is one scan of the DB."""
        queries = np.asarray(queries, np.uint32)
        if queries.ndim != 2 or queries.shape[1] != self._num_query_cols:
            raise IncompatibleDimensionForRowVectorTransposedMatrixMultiplication()
        if self._backend == "numpy":
            return (
                queries.astype(np.uint64) @ self._planes.astype(np.uint64)
            ).astype(np.uint32)
        import jax

        if self._sharded_respond is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            mesh = self._mesh
            m_pad = self._planes.lo.shape[0]
            data = mesh.shape["data"]
            q = queries.shape[0]
            q_pad = -(-q // data) * data
            queries = np.pad(queries, ((0, q_pad - q), (0, m_pad - queries.shape[1])))
            q_dev = jax.device_put(
                queries, NamedSharding(mesh, P("data", "model"))
            )
            out = np.asarray(self._sharded_respond(q_dev)).astype(np.uint32)
            return out[:q]

        if self._layout == "packed":
            from ..ops import respond_pallas

            out = respond_pallas.respond_batch_packed(jax.device_put(queries), self._planes)
        else:
            from ..ops import respond as respond_ops

            d0, d1 = self._planes
            out = respond_ops.respond_batch(jax.device_put(queries), d0, d1)
        return np.asarray(out).astype(np.uint32)

    @property
    def num_query_cols(self) -> int:
        return self._num_query_cols

    @property
    def num_response_cols(self) -> int:
        return self._num_response_cols

    # -- persistence ---------------------------------------------------------
    #
    # The reference has no long-job checkpointing; its serialization formats
    # *are* the state transfer (SURVEY.md section 5). We go one step further
    # and let a server persist its full online state, so a restarted
    # process can resume serving without re-running setup.

    def save(self, path: str) -> None:
        """Persist the online serving state (not the hint/filter — those
        already left the building at setup time)."""
        meta = dict(
            backend=self._backend,
            layout=self._layout,
            num_query_cols=self._num_query_cols,
            num_response_cols=self._num_response_cols,
            mat_elem_bit_len=self.mat_elem_bit_len,
        )
        # write through a file handle: np.savez(str) appends ".npz" to
        # suffix-less paths, which load() would then fail to find
        if self._backend == "numpy":
            arrays = dict(mat_d=self._planes)
        elif self._layout == "packed":
            db = self._planes
            arrays = dict(lo=np.asarray(db.lo))
            if db.hi is not None:
                arrays["hi"] = np.asarray(db.hi)
        else:
            d0, d1 = self._planes
            arrays = dict(d0=np.asarray(d0), d1=np.asarray(d1))
        with open(path, "wb") as f:
            np.savez(f, meta=np.array([repr(meta)]), **arrays)

    @classmethod
    def load(cls, path: str) -> "Server":
        """Rebuild a serving-ready Server from a save() archive."""
        import ast

        with np.load(path) as archive:
            meta = ast.literal_eval(str(archive["meta"][0]))
            if meta["backend"] == "numpy":
                planes = archive["mat_d"]
            elif meta["layout"] == "packed":
                import jax

                from ..ops.respond_pallas import PallasDB

                planes = PallasDB(
                    lo=jax.device_put(archive["lo"]),
                    hi=jax.device_put(archive["hi"]) if "hi" in archive else None,
                    mat_elem_bit_len=meta["mat_elem_bit_len"],
                    num_rows=meta["num_query_cols"],
                    num_cols=meta["num_response_cols"],
                )
            else:
                import jax

                planes = (jax.device_put(archive["d0"]), jax.device_put(archive["d1"]))
        return cls(
            meta["backend"],
            planes,
            meta["num_query_cols"],
            meta["num_response_cols"],
            meta["mat_elem_bit_len"],
            meta["layout"],
        )


# -- ctr hint folds ----------------------------------------------------------
#
# Fingerprint-major ctr A (core/prg.py) makes the hint a sum of per-DB-row-
# chunk folds: M = sum_chunks A[:, chunk] . D[chunk], with each chunk's A
# slab one contiguous on-device ctr generation. Each fold is a real GEMM
# (K_PAD A rows x 4 digits against the chunk's planes) served by XLA's own
# int8 GEMMs. K_PAD rounds the LWE dimension up to whole 128-row tiles; the
# padded A rows are zero, so their hint rows are zero and get sliced off.

K_PAD = -(-LWE_DIMENSION // 128) * 128  # 1792
_CTR_CHUNK_COLS = 1 << 17

_jit_cache: dict = {}


def _ctr_chunk_cols(m: int) -> int:
    """DB-row chunk size for ctr hint folds / the streaming upload:
    ~2^17 rows, whole ROW_ALIGN blocks, chunks sized EVENLY over m. A
    fixed 2^17 chunk would round m up to whole chunks (25% pure padding
    at the 2^18/arity-3 geometry); dividing m evenly keeps the overhang
    under one block per chunk."""
    from ..ops.respond_pallas import ROW_ALIGN

    n_chunks = max(1, -(-m // _CTR_CHUNK_COLS))
    per_chunk = -(-m // n_chunks)
    return -(-per_chunk // ROW_ALIGN) * ROW_ALIGN


def _accum_hint(buf, out):
    import jax

    fn = _jit_cache.get("accum")
    if fn is None:
        fn = _jit_cache["accum"] = jax.jit(lambda b, o: b + o, donate_argnums=0)
    return fn(buf, out)


def _make_fold(tight: bool):
    import jax
    import jax.numpy as jnp

    from ..ops import prg_jax, respond_pallas

    @partial(jax.jit, static_argnames=("cc", "c", "c_pad", "bit_len", "has_hi"))
    def fold(sw, blk0_words, offset, lo, hi, r0, cc, c, c_pad, bit_len, has_hi):
        slab = prg_jax.rows_from_blocks(sw, blk0_words, offset, cc, LWE_DIMENSION)
        g = jnp.pad(slab, ((0, 0), (0, K_PAD - LWE_DIMENSION))).T  # (K_PAD, cc)
        if tight:
            lo_c = jnp.pad(lo, ((0, 0), (0, c_pad - lo.shape[1])))
            hi_c = hi if has_hi else None
        else:
            lo_c = jax.lax.dynamic_slice(lo, (r0, jnp.int32(0)), (cc, lo.shape[1]))
            hi_c = (
                jax.lax.dynamic_slice(hi, (r0, jnp.int32(0)), (cc, hi.shape[1]))
                if has_hi
                else None
            )
        return respond_pallas.respond_packed_core(g, lo_c, hi_c, bit_len, c, path="xla")

    return fold


def _gen_fold_sliced(sw, blk0_words, offset, lo, hi, r0, *, cc, c, bit_len):
    """(K_PAD, c) uint32 hint partial for DB rows [r0, r0+cc), slicing the
    chunk out of the full device planes."""
    fn = _jit_cache.get("fold_sliced")
    if fn is None:
        fn = _jit_cache["fold_sliced"] = _make_fold(tight=False)
    c_pad = lo.shape[1]
    return fn(sw, blk0_words, offset, lo, lo if hi is None else hi, r0,
              cc, c, c_pad, bit_len, hi is not None)


def _gen_fold_tight(sw, blk0_words, offset, lo_tight, hi_c, *, c_pad, bit_len):
    """(K_PAD, c) uint32 hint partial over a freshly-uploaded tight chunk
    (lo (cc, c) int8 padded to c_pad on device — zero columns are never
    copied from the host)."""
    import jax.numpy as jnp

    fn = _jit_cache.get("fold_tight")
    if fn is None:
        fn = _jit_cache["fold_tight"] = _make_fold(tight=True)
    cc, c = lo_tight.shape
    return fn(sw, blk0_words, offset, lo_tight, lo_tight if hi_c is None else hi_c,
              jnp.int32(0), cc, c, c_pad, bit_len, hi_c is not None)


@contextlib.contextmanager
def _gc_paused():
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        try:
            import jax  # noqa: F401

            return "jax"
        except Exception:  # pragma: no cover
            return "numpy"
    if backend == "jax":
        try:
            import jax  # noqa: F401
        except Exception as e:  # pragma: no cover - no jax in this deploy
            from ..errors import AcceleratorError

            raise AcceleratorError(f"jax backend requested but unavailable: {e}")
    if backend not in ("jax", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend
