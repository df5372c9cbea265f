"""Packed-layout respond paths vs the host oracle: the Triton scan in
interpret mode and the XLA path on the CPU (the compiled scan is checked
on the GPU by tests/test_gpu_compiled.py and chip_smoke.py)."""

import numpy as np
import pytest

from chalametpir_tpu.ops import packed
from chalametpir_tpu.ops.respond import respond_batch_np
from chalametpir_tpu.ops.respond_pallas import build_pallas_db, respond_batch_packed


@pytest.mark.parametrize("b", [4, 8, 9, 10, 12, 14])
def test_pack_roundtrip(b, rng):
    mat = rng.integers(0, 1 << b, size=(40, 37), dtype=np.uint32)
    db = packed.pack_db(mat, b)
    assert np.array_equal(packed.unpack_db(db), mat)
    expected_bpe = {4: 1.0, 8: 1.0, 9: 1.125, 10: 1.25, 12: 1.5, 14: 2.0}[b]
    assert db.bytes_per_element == pytest.approx(expected_bpe, rel=0.2)


@pytest.mark.parametrize("b", [9, 10, 12])
def test_pack_db_layout_matches_kernel(b, rng):
    """pack_db and build_pallas_db emit the SAME block-interleaved hi
    layout: a PackedDB's planes must be directly consumable by the
    scan. Uses a COL_ALIGN-aligned geometry so the two builders'
    packed widths coincide; then compares the hi planes byte-for-byte
    and pins the kernel-style unpack (shift/mask each field, concatenate
    field blocks along columns) against the raw high bytes."""
    from chalametpir_tpu.ops.packed import hi_pack_factor

    m, c = 64, 256  # c a multiple of COL_ALIGN=128 -> no column padding
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    host = packed.pack_db(mat, b)
    dev = build_pallas_db(mat, b)
    hi_dev = np.asarray(dev.hi)[:m]
    assert np.array_equal(host.hi_packed, hi_dev)
    # scan unpack (respond_pallas._scan_kernel): field j -> block j
    pack = hi_pack_factor(b)
    bits = 8 // pack if pack > 1 else 8
    mask = (1 << bits) - 1
    hp = host.hi_packed.astype(np.int32)
    unpacked = np.concatenate(
        [(hp >> (bits * j)) & mask for j in range(max(pack, 1))], axis=1
    )
    assert np.array_equal(unpacked[:, :c].astype(np.uint8), (mat >> 8).astype(np.uint8))


@pytest.mark.parametrize("path", ["triton", "xla"])
@pytest.mark.parametrize("b", [8, 9, 10, 12])
@pytest.mark.parametrize("q", [1, 5])
def test_respond_packed_exact(b, q, path, rng):
    m, c = 700, 150  # not multiples of the block sizes
    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    db = build_pallas_db(mat, b)
    got = np.asarray(respond_batch_packed(queries, db, path=path))
    assert np.array_equal(got, respond_batch_np(queries, mat))


def test_shipped_bytes_accounting(rng):
    """setup_stats prices upload GB/s off shipped_bytes — pin that the
    builder records what the link actually carried: positive, never more
    than the padded device planes, and strictly less on the tight native
    path (m=700/c=150 force both row and column padding)."""
    m, c, b = 700, 150, 9
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint16)
    db = build_pallas_db(mat, b)
    assert 0 < db.shipped_bytes <= db.device_bytes
    try:
        from chalametpir_tpu.native import engine as _native  # noqa: F401
        tight = True
    except Exception:
        tight = False
    if tight:
        assert db.shipped_bytes < db.device_bytes
    # accounting must not perturb the scan's answer
    queries = rng.integers(0, 1 << 32, size=(2, m), dtype=np.uint32)
    got = np.asarray(respond_batch_packed(queries, db))
    assert np.array_equal(got, respond_batch_np(queries, mat.astype(np.uint32)))


@pytest.mark.parametrize("path", ["triton", "xla"])
def test_respond_packed_exact_large_batch(path, rng):
    """Q = 20 -> 80 digit rows: two 64-row blocks of the scan grid."""
    m, c, b = 512, 128, 9
    queries = rng.integers(0, 1 << 32, size=(20, m), dtype=np.uint32)
    mat = rng.integers(0, 1 << b, size=(m, c), dtype=np.uint32)
    db = build_pallas_db(mat, b)
    got = np.asarray(respond_batch_packed(queries, db, path=path))
    assert np.array_equal(got, respond_batch_np(queries, mat))


@pytest.mark.parametrize("path", ["triton", "xla", "digit2"])
def test_respond_int32_wrap_exact(path):
    """m = 2^18 rows of all-max values against extreme digits: every
    int32 accumulator (one dot, each split-K partial and their sum)
    passes 2^31 and must wrap exactly mod 2^32."""
    import jax

    from chalametpir_tpu.ops import digits, respond
    from chip_smoke import extreme_queries

    m, c, b = 1 << 18, 128, 9
    mat = np.full((m, c), (1 << b) - 1, np.uint32)
    queries = extreme_queries(2, m)
    # |lo partial| = m * 128 * 127 > 2^31
    assert m * 128 * 127 > 1 << 31
    if path == "digit2":
        d0, d1 = digits.db_digit_planes_np(mat)
        got = respond.respond_batch(jax.device_put(queries), d0, d1)
    else:
        db = build_pallas_db(mat.astype(np.uint16), b)
        got = respond_batch_packed(queries, db, path=path)
    assert np.array_equal(np.asarray(got), respond_batch_np(queries, mat))


def test_scan_config_shapes():
    """Tiling choice by shape: power-of-two blocks that divide the planes
    and the packed width, 16- or 64-row blocks, the measured tiling of
    each, and a split count whose K ranges cover every step exactly once."""
    from chalametpir_tpu.ops.respond_pallas import _TILING, scan_config

    cfg = scan_config(4, 1182720, 1024, 128)  # 2^20 x 1 kB, b = 9, Q = 1
    block_n, block_k, warps, stages = _TILING[16]
    assert cfg["block_r"] == 16
    assert (cfg["block_n"], cfg["block_k"]) == (min(block_n, 128), block_k)
    assert (cfg["num_warps"], cfg["num_stages"]) == (warps, stages)
    assert cfg["n_steps"] == 1182720 // block_k
    assert (cfg["splits"] - 1) * cfg["steps_per_split"] < cfg["n_steps"]
    assert cfg["splits"] * cfg["steps_per_split"] >= cfg["n_steps"]
    # b = 10 at a 640-column width: pc = 160 -> 32-column blocks
    assert scan_config(4, 4096, 640, 160)["block_n"] == 32
    # more than 16 digit rows: 64-row blocks with their own tiling
    big = scan_config(4 * 64, 1 << 20, 1024, 0)
    assert big["block_r"] == 64
    assert big["num_warps"] == _TILING[64][2]
    assert scan_config(4 * 5, 1 << 20, 1024, 0)["block_r"] == 64
    with pytest.raises(ValueError):
        scan_config(4, 4096, 136, 17)
