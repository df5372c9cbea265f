"""Balanced base-256 digit decomposition — the bridge from Z_{2^32}
arithmetic to int8 tensor-core products. Fills the role of the
reference's wrapping u32 arithmetic core (reference:
chalametpir_common/src/matrix.rs:1031-1059 matmul, matrix.rs:328-485
respond matvec) with a representation the tensor cores execute natively.

The tensor cores have no 32-bit integer product, but they multiply int8
at twice the bf16 rate with exact int32 accumulation, and XLA integer
overflow wraps two's-complement. A u32 value x is therefore recoded into
four *balanced* digits c_i in [-128, 127] with

    x == sum_i c_i * 256^i  (mod 2^32),

so a mod-2^32 matrix product becomes a handful of int8 products whose
int32 partials are shifted and re-summed; every dropped carry is a
multiple of 2^32 and vanishes. Balanced (signed) digits avoid the bias
corrections an unsigned 0..255 decomposition would need.

DB-side elements are < 2^b <= 2^14 and need only two digit planes
(the second in [0, 64]); that makes the online respond scan touch
exactly 2 bytes per DB element.

Both numpy (host) and jnp (device) variants are provided; the math is
identical.
"""

from __future__ import annotations

import numpy as np

try:
    import jax.numpy as jnp
except Exception:  # pragma: no cover
    jnp = None

NUM_U32_DIGITS = 4
NUM_DB_DIGITS = 2


def recode_u32_np(x: np.ndarray) -> np.ndarray:
    """(...,) uint32 -> (4, ...) int8 balanced digits, numpy."""
    x = np.asarray(x, np.uint32)
    digits = np.empty((NUM_U32_DIGITS,) + x.shape, dtype=np.int8)
    carry = np.zeros(x.shape, np.uint32)
    for i in range(NUM_U32_DIGITS):
        t = ((x >> np.uint32(8 * i)) & np.uint32(255)) + carry
        tb = t + np.uint32(128)
        digits[i] = ((tb & np.uint32(255)).astype(np.int16) - 128).astype(np.int8)
        carry = tb >> np.uint32(8)
    return digits


def recode_u32_jnp(x):
    """(...,) uint32/int32 -> (4, ...) int8 balanced digits, on device."""
    x = x.astype(jnp.uint32)
    digits = []
    carry = jnp.zeros_like(x)
    for i in range(NUM_U32_DIGITS):
        t = ((x >> np.uint32(8 * i)) & np.uint32(255)) + carry
        tb = t + np.uint32(128)
        digits.append(((tb & np.uint32(255)).astype(jnp.int32) - 128).astype(jnp.int8))
        carry = tb >> np.uint32(8)
    return jnp.stack(digits)


def db_digit_planes_np(d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(m, c) uint32 with elements < 2^14 -> two (m, c) int8 balanced planes.

    plane0 in [-128, 127], plane1 in [0, 64]; d == plane0 + 256*plane1.
    """
    d = np.asarray(d, np.uint32)
    tb = d + np.uint32(128)
    p0 = ((tb & np.uint32(255)).astype(np.int16) - 128).astype(np.int8)
    p1 = (tb >> np.uint32(8)).astype(np.int8)
    return p0, p1


def digits_to_u32_np(digits: np.ndarray) -> np.ndarray:
    """Inverse of recode_u32_np (testing helper)."""
    acc = np.zeros(digits.shape[1:], np.int64)
    for i in range(digits.shape[0]):
        acc += digits[i].astype(np.int64) << (8 * i)
    return (acc % (1 << 32)).astype(np.uint32)
