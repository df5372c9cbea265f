"""Exact mod-2^32 matrix products as int8 GEMMs via balanced digits.

Replaces the reference's rayon CPU matmul and Vulkan mat_x_mat shader
(reference: chalametpir_common/src/matrix.rs:1040-1059,
chalametpir_server/src/shaders/mat_x_mat.glsl) with int8 dots:

    A (R,K) u32, D (K,C) u32 with D < 2^14:
    M = sum_{i<4, j<2, i+j<=3} (A_i . D_j) << 8(i+j)   (mod 2^32)

int32 accumulator wrap-around is harmless — every lost bit is a
multiple of 2^32 (the tests and chip_smoke.py check it against the
uint64 oracle).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .digits import NUM_U32_DIGITS, recode_u32_jnp

_DN = (((1,), (0,)), ((), ()))


def _dot_i8(a, b):
    return jax.lax.dot_general(a, b, _DN, preferred_element_type=jnp.int32)


@jax.jit
def digit_matmul_accumulate(acc, a_u32, d0, d1):
    """acc (R,C) int32 += A_chunk (R,Kc) u32 . [d0|d1] (Kc,C) int8, mod 2^32.

    The chunked form lets the caller stream A from the host XOF without
    ever materialising the full (R, K) matrix on the device.
    """
    ad = recode_u32_jnp(a_u32)  # (4, R, Kc) int8
    for i in range(NUM_U32_DIGITS):
        acc = acc + (_dot_i8(ad[i], d0) << (8 * i))
    for i in range(NUM_U32_DIGITS - 1):
        acc = acc + (_dot_i8(ad[i], d1) << (8 * (i + 1)))
    return acc


@jax.jit
def matmul_u32_x_db(a_u32, d0, d1):
    """One-shot A (R,K) u32 . D (K,C) where D is given as digit planes."""
    acc = jnp.zeros((a_u32.shape[0], d0.shape[1]), jnp.int32)
    return digit_matmul_accumulate(acc, a_u32, d0, d1)


@partial(jax.jit, static_argnames=("out_rows",))
def digit_matmul_full(a_digits, b_digits, out_rows):
    """General u32 x u32 product from full 4-digit planes of both sides:
    sum_{i+j<=3} (A_i . B_j) << 8(i+j) — the device analogue of the
    reference's unrestricted Matrix::mul (matrix.rs:1031-1059) for
    right-hand sides not bounded by 2^14 (the protocol's own products all
    have a narrow side; this is the general-API form)."""
    acc = jnp.zeros((out_rows, b_digits.shape[-1]), jnp.int32)
    for i in range(NUM_U32_DIGITS):
        for j in range(NUM_U32_DIGITS - i):
            acc = acc + (_dot_i8(a_digits[i], b_digits[j]) << (8 * (i + j)))
    return acc


def matmul_u32_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host reference: exact (a @ b) mod 2^32 via uint64 wrap-around."""
    if a.shape[-1] != b.shape[0]:
        from ..errors import IncompatibleDimensionForMatrixMultiplication

        raise IncompatibleDimensionForMatrixMultiplication()
    return (a.astype(np.uint64) @ b.astype(np.uint64)).astype(np.uint32)
