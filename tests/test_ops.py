"""Device ops: balanced-digit recode and exact mod-2^32 int8 matmuls."""

import numpy as np
import pytest

from chalametpir_tpu.ops import digits


def test_recode_roundtrip(rng):
    x = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    d = digits.recode_u32_np(x)
    assert d.dtype == np.int8
    assert np.array_equal(digits.digits_to_u32_np(d), x)


def test_recode_jnp_matches_np(rng):
    import jax

    x = rng.integers(0, 1 << 32, size=(7, 50), dtype=np.uint32)
    got = np.asarray(jax.jit(digits.recode_u32_jnp)(x))
    assert np.array_equal(got, digits.recode_u32_np(x))


def test_db_digit_planes(rng):
    d = rng.integers(0, 1 << 14, size=(64, 32), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(d)
    assert p0.dtype == p1.dtype == np.int8
    assert (p1 >= 0).all() and (p1 <= 64).all()
    back = p0.astype(np.int64) + 256 * p1.astype(np.int64)
    assert np.array_equal(back, d.astype(np.int64))


def test_digit_matmul_exact(rng):
    import jax.numpy as jnp

    from chalametpir_tpu.ops import matmul_u32

    a = rng.integers(0, 1 << 32, size=(16, 300), dtype=np.uint32)
    d = rng.integers(0, 1 << 14, size=(300, 24), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(d)
    got = np.asarray(
        matmul_u32.matmul_u32_x_db(a, jnp.asarray(p0), jnp.asarray(p1))
    ).astype(np.uint32)
    want = matmul_u32.matmul_u32_np(a, d)
    assert np.array_equal(got, want)


def test_digit_matmul_accumulate_chunks(rng):
    import jax.numpy as jnp

    from chalametpir_tpu.ops import matmul_u32

    a = rng.integers(0, 1 << 32, size=(8, 256), dtype=np.uint32)
    d = rng.integers(0, 1 << 10, size=(256, 16), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(d)
    acc = jnp.zeros((8, 16), jnp.int32)
    for lo in range(0, 256, 64):
        acc = matmul_u32.digit_matmul_accumulate(
            acc, a[:, lo : lo + 64], jnp.asarray(p0[lo : lo + 64]), jnp.asarray(p1[lo : lo + 64])
        )
    assert np.array_equal(np.asarray(acc).astype(np.uint32), matmul_u32.matmul_u32_np(a, d))


def test_digit_matmul_full_u32xu32(rng):
    import jax.numpy as jnp

    from chalametpir_tpu.ops import matmul_u32

    a = rng.integers(0, 1 << 32, size=(5, 70), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(70, 9), dtype=np.uint32)
    got = np.asarray(
        matmul_u32.digit_matmul_full(
            jnp.asarray(digits.recode_u32_np(a)), jnp.asarray(digits.recode_u32_np(b)), 5
        )
    ).astype(np.uint32)
    assert np.array_equal(got, matmul_u32.matmul_u32_np(a, b))


@pytest.mark.parametrize("q", [1, 5])
def test_respond_batch_exact(q, rng):
    import jax.numpy as jnp

    from chalametpir_tpu.ops import respond

    m, c = 500, 40
    queries = rng.integers(0, 1 << 32, size=(q, m), dtype=np.uint32)
    db = rng.integers(0, 1 << 12, size=(m, c), dtype=np.uint32)
    p0, p1 = digits.db_digit_planes_np(db)
    got = np.asarray(respond.respond_batch(queries, jnp.asarray(p0), jnp.asarray(p1)))
    assert np.array_equal(got, respond.respond_batch_np(queries, db))


def test_int32_accumulator_wrap_regression():
    # the whole digit design rests on XLA integer dots wrapping
    # two's-complement; pin that behavior
    import jax
    import jax.numpy as jnp

    k = 1 << 20
    a = jnp.full((1, k), 127, jnp.int8)
    b = jnp.full((k, 1), 127, jnp.int8)
    r = jax.jit(
        lambda a, b: jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    )(a, b)
    want = (127 * 127 * k) % (1 << 32)
    if want >= 1 << 31:
        want -= 1 << 32
    assert int(r[0, 0]) == want
