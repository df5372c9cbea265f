"""Multi-device sharding on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

from chalametpir_tpu.ops import digits
from chalametpir_tpu.ops.respond import respond_batch_np
from chalametpir_tpu.parallel import (
    make_mesh,
    shard_db_planes,
    sharded_hint_accumulate_fn,
    sharded_respond_fn,
)


@pytest.fixture(scope="module")
def mesh():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(data=2, model=4)


def test_sharded_respond_exact(mesh, rng):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    q, m, c = 4, 512, 40
    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    db = rng.integers(0, 1 << 12, size=(m, c), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(db)
    d0, d1 = shard_db_planes(mesh, p0, p1)
    respond = sharded_respond_fn(mesh)
    q_sharded = jax.device_put(queries, NamedSharding(mesh, P("data", "model")))
    got = np.asarray(respond(q_sharded, d0, d1))
    assert np.array_equal(got, respond_batch_np(queries, db))


def test_sharded_respond_with_padding(mesh, rng):
    # m not divisible by the model axis: planes are zero-padded
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    q, m, c = 2, 509, 24
    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    db = rng.integers(0, 1 << 10, size=(m, c), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(db)
    d0, d1 = shard_db_planes(mesh, p0, p1)
    m_pad = d0.shape[0]
    q_pad = np.pad(queries, ((0, 0), (0, m_pad - m)))
    respond = sharded_respond_fn(mesh)
    q_sharded = jax.device_put(q_pad, NamedSharding(mesh, P("data", "model")))
    got = np.asarray(respond(q_sharded, d0, d1))
    assert np.array_equal(got, respond_batch_np(queries, db))


def test_sharded_hint_accumulate_exact(mesh, rng):
    import jax.numpy as jnp

    r, m, c = 16, 256, 24
    a = rng.integers(0, 1 << 32, size=(r, m), dtype=np.uint32)
    db = rng.integers(0, 1 << 12, size=(m, c), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(db)
    d0, d1 = shard_db_planes(mesh, p0, p1)
    step = sharded_hint_accumulate_fn(mesh)
    acc = jnp.zeros((r, c), jnp.int32)
    half = m // 2
    acc = step(acc, a[:, :half], d0[:half], d1[:half])
    acc = step(acc, a[:, half:], d0[half:], d1[half:])
    want = (a.astype(np.uint64) @ db.astype(np.uint64)).astype(np.uint32)
    assert np.array_equal(np.asarray(acc).astype(np.uint32), want)


@pytest.mark.parametrize("bit_len", [8, 10])  # 8 = lo-only plane (2^23-scale geometry)
def test_sharded_packed_respond_exact(mesh, rng, bit_len):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from chalametpir_tpu.parallel import build_sharded_pallas_db, sharded_respond_packed_fn

    q, m, c = 4, 700, 40
    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    mat = rng.integers(0, 1 << bit_len, size=(m, c), dtype=np.uint16)
    db = build_sharded_pallas_db(mesh, mat, bit_len)
    assert db.lo.shape[0] % (4 * 512) == 0  # whole tiles per model shard
    respond = sharded_respond_packed_fn(mesh, db)
    q_pad = np.pad(queries, ((0, 0), (0, db.lo.shape[0] - m)))
    q_sharded = jax.device_put(q_pad, NamedSharding(mesh, P("data", "model")))
    got = np.asarray(respond(q_sharded))
    assert np.array_equal(got, respond_batch_np(queries, mat.astype(np.uint32)))


def test_server_api_sharded_round_trip(mesh, rng):
    """Full protocol through Server.setup(mesh=...) — the product path."""
    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
    from chalametpir_tpu.utils import generate_random_kv_database

    db = generate_random_kv_database(500, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(seed, db, arity=3, mesh=mesh, rng=rng)
    assert server._mesh is mesh

    client = Client.setup(seed, hint, fparams, device=False)
    for key in list(db)[:3]:
        while True:
            try:
                q = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                pass
        assert client.process_response(key, server.respond(q)) == db[key]


def test_server_api_sharded_scaled_2pow23_geometry(mesh, rng):
    """The 2^23 x 1 kB target config, scaled down: b=8 (what
    find_mat_elem_bit_len gives at 2^23 entries) and 1 kB values exercise
    the exact kernel/layout the full config would use, on a small DB."""
    from chalametpir_tpu import Server
    from chalametpir_tpu.utils import generate_random_kv_database

    db = generate_random_kv_database(300, rng=rng, value_byte_len=(1024, 1024))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, arity=3, mesh=mesh, rng=rng, mat_elem_bit_len=8
    )
    assert server.mat_elem_bit_len == 8
    assert server._planes.hi is None  # b=8 stores a single byte plane
    queries = rng.integers(0, 1 << 32, size=(3, server.num_query_cols), dtype=np.uint32)
    got = server.respond_batch(queries)

    from chalametpir_tpu.core import encode_db as encode_db_mod

    mat, _ = encode_db_mod.from_kv_database(db, 3, 8, 100, np.random.default_rng(1))
    # oracle on this server's own planes: reconstruct D from the device
    lo = np.asarray(server._planes.lo).astype(np.int16)
    d = ((lo + 128).astype(np.uint16))[: server.num_query_cols, : server.num_response_cols]
    want = (queries.astype(np.uint64) @ d.astype(np.uint64)).astype(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arity", [3, 4])
def test_server_api_sharded_ctr_round_trip(mesh, rng, arity):
    """ctr PRG mode under a mesh: every shard regenerates A on device; the
    hint must be byte-identical to the single-device ctr derivation."""
    from chalametpir_tpu import Client, Server
    from chalametpir_tpu.errors import ArithmeticOverflowAddingQueryIndicator
    from chalametpir_tpu.utils import generate_random_kv_database

    db = generate_random_kv_database(400, rng=rng, value_byte_len=(1, 64))
    seed = rng.bytes(32)
    server, hint, fparams = Server.setup(
        seed, db, arity=arity, mesh=mesh, prg_mode="ctr", rng=rng
    )

    from chalametpir_tpu.core import matrix_io
    from chalametpir_tpu.params import LWE_DIMENSION

    # the round trip below proves the hint algebra end-to-end (a wrong
    # hint fails decryption); here just pin the shape contract
    hm = matrix_io.matrix_from_bytes(hint)
    assert hm.shape == (LWE_DIMENSION, server.num_response_cols)

    client = Client.setup(seed, hint, fparams, prg_mode="ctr", device=False)
    for key in list(db)[:3]:
        while True:
            try:
                q = client.query(key)
                break
            except ArithmeticOverflowAddingQueryIndicator:
                pass
        assert client.process_response(key, server.respond(q)) == db[key]


def test_sharded_chunk_rows_always_tile_aligned_and_exact():
    """Regression: the old halving chunk picker could return a chunk that
    was not a multiple of the row block (e.g. m_local = 2048*130 -> 66560,
    66560 % 2048 = 1024), silently dropping rows from the hint. The
    picker must return a block multiple that divides m_local exactly."""
    from chalametpir_tpu.parallel.sharding import _sharded_chunk_rows

    align = 2048
    for t in list(range(1, 400)) + [1009, 1024, 130 * 4, 197 * 3]:
        m_local = t * align
        cc = _sharded_chunk_rows(m_local, align)
        assert cc % align == 0
        assert m_local % cc == 0
        assert cc <= max(1 << 17, align)
    # the concrete old-failure geometry
    assert _sharded_chunk_rows(266240, 2048) % 2048 == 0
    assert 266240 % _sharded_chunk_rows(266240, 2048) == 0


def test_sharded_ctr_hint_multi_chunk_matches_single_device(mesh, rng, monkeypatch):
    """e2e regression for the chunk-picker bug: force several fold chunks
    per shard and require the mesh hint to be byte-identical to the
    single-device ctr derivation (a dropped or re-read row changes it)."""
    from chalametpir_tpu import Server
    from chalametpir_tpu.core import matrix_io
    from chalametpir_tpu.parallel import sharding as sh
    from chalametpir_tpu.utils import generate_random_kv_database

    # every shard folds in single-block chunks -> m_local/align chunks
    monkeypatch.setattr(sh, "_sharded_chunk_rows", lambda m_local, align: align)

    db = generate_random_kv_database(7000, rng=rng, value_byte_len=(1, 48))
    seed = rng.bytes(32)
    # identical generators: both setups must draw the same filter seed
    fseed = int(rng.integers(0, 2**63))
    _, hint_mesh, fp_mesh = Server.setup(
        seed, db, arity=3, mesh=mesh, prg_mode="ctr",
        rng=np.random.default_rng(fseed),
    )
    _, hint_one, fp_one = Server.setup(
        seed, db, arity=3, backend="jax", prg_mode="ctr",
        rng=np.random.default_rng(fseed),
    )
    assert fp_mesh == fp_one
    assert np.array_equal(
        matrix_io.matrix_from_bytes(hint_mesh), matrix_io.matrix_from_bytes(hint_one)
    )
