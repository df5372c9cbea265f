"""Streaming ctr setup pipeline: exactness vs the numpy oracle backend.

The pipelined path (models/server._setup_jax_ctr_pipelined) overlaps the
chunk-ordered encode, the packed upload, and the on-device hint folds; it
must produce byte-identical (hint, filter params) to the oracle numpy
backend for the same filter seed, and a serving-equivalent database.
"""

import numpy as np
import pytest

from chalametpir_tpu import Client, Server
from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
from chalametpir_tpu.utils import generate_random_kv_database


@pytest.mark.parametrize("arity", [3, 4])
def test_pipelined_setup_matches_numpy_oracle(arity, rng):
    db = generate_random_kv_database(600, rng=rng, value_byte_len=(1, 96))
    seed = rng.bytes(32)

    server_jax, hint_jax, fp_jax = Server.setup(
        seed, db, arity=arity, backend="jax", prg_mode="ctr",
        rng=np.random.default_rng(7),
    )
    assert server_jax._layout == "packed"  # took the pipelined/packed path
    server_np, hint_np, fp_np = Server.setup(
        seed, db, arity=arity, backend="numpy", prg_mode="ctr",
        rng=np.random.default_rng(7),
    )
    assert fp_jax == fp_np
    assert hint_jax == hint_np  # byte-identical hint matrix

    # the packed DB serves identically to the oracle
    q = np.random.default_rng(1).integers(
        0, 1 << 32, size=(2, server_np.num_query_cols), dtype=np.uint32
    )
    assert np.array_equal(server_jax.respond_batch(q), server_np.respond_batch(q))


def test_pipelined_setup_round_trip(rng):
    db = generate_random_kv_database(500, rng=rng, value_byte_len=(900, 1024))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, backend="jax", prg_mode="ctr", rng=rng
    )
    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device=False)
    for key in list(db.keys())[:3]:
        while True:
            try:
                q = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                continue
        assert client.process_response(key, server.respond(q)) == db[key]


def test_ctr_chunk_cols_even_division():
    """Chunks divide m evenly (waste < one row block per chunk) — a fixed
    2^17 chunk copied up to 25% pure padding at 2^18/arity-3-like
    geometries."""
    from chalametpir_tpu.models.server import _CTR_CHUNK_COLS, _ctr_chunk_cols
    from chalametpir_tpu.ops.respond_pallas import ROW_ALIGN

    for m in (1, 2048, 74752, 294912, 302173, 1048576, 1179648, 2359296):
        cc = _ctr_chunk_cols(m)
        assert cc % ROW_ALIGN == 0
        n_chunks = -(-m // cc)
        m_pad = n_chunks * cc
        assert m_pad >= m
        # padding bounded by one block per chunk (plus block rounding of cc)
        assert m_pad - m < n_chunks * ROW_ALIGN + ROW_ALIGN
        # chunks stay near the 2^17 target, never above one block over it
        assert cc <= _CTR_CHUNK_COLS + ROW_ALIGN


def test_pipelined_setup_multichunk_buffer_reuse(rng, monkeypatch):
    """Force a multi-chunk pipeline so the chunked pack/upload/fold path
    actually cycles. NOTE: on the CPU backend reuse_bufs is forced off
    (device_put can zero-copy alias host buffers there), so this tier
    exercises the multi-chunk pipeline with fresh buffers; the reuse
    path itself — chunks 3+ rewriting a buffer a prior device_put read
    from — only runs on the GPU and is guarded by the chip-tier sibling
    (test_gpu_compiled.test_pipelined_setup_multichunk_buffer_reuse_
    compiled)."""
    from chalametpir_tpu.models import server as server_mod

    monkeypatch.setattr(server_mod, "_CTR_CHUNK_COLS", 512)
    db = generate_random_kv_database(8192, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server_jax, hint_jax, fp_jax = Server.setup(
        seed, db, arity=3, backend="jax", prg_mode="ctr",
        rng=np.random.default_rng(11),
    )
    assert server_jax._layout == "packed"
    # the forced chunk size must actually have produced several chunks
    from chalametpir_tpu.core.filter import filter_geometry

    _, _, num_fp = filter_geometry(3, len(db))
    assert -(-num_fp // server_mod._ctr_chunk_cols(num_fp)) >= 3
    server_np, hint_np, fp_np = Server.setup(
        seed, db, arity=3, backend="numpy", prg_mode="ctr",
        rng=np.random.default_rng(11),
    )
    assert fp_jax == fp_np
    assert hint_jax == hint_np
    q = np.random.default_rng(3).integers(
        0, 1 << 32, size=(2, server_np.num_query_cols), dtype=np.uint32
    )
    assert np.array_equal(server_jax.respond_batch(q), server_np.respond_batch(q))
