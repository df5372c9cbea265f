"""Online respond kernel: encrypted query x encoded DB, mod 2^32.

This is the protocol's hot path (reference:
chalametpir_common/src/matrix.rs:328-485 — the rayon
row_vector_x_compressed_transposed_matrix). The device design differs
from the CPU one on purpose: instead of bit-unpacking a compressed DB on
the fly, the DB lives in device memory as two int8 digit planes (2 bytes
per element, see ops/digits.py) and each query's four balanced digits
are int8 operands of XLA's GEMMs:

    out[c] = sum_k q[k] * D[k, c]
           = sum_{i<4} 2^{8i} (q_i . D_0)[c] + sum_{i<3} 2^{8(i+1)} (q_i . D_1)[c]

A batch of Q queries is one (4Q, m) x (m, C) int8 matmul — batching is
nearly free until the tensor cores, not memory, bound the scan. The
packed layout (ops/respond_pallas.py) reads fewer bytes per element and
serves the large-DB regimes; this path serves b > 12.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .digits import NUM_U32_DIGITS, recode_u32_jnp

_DN = (((1,), (0,)), ((), ()))


def _dot_i8(a, b):
    return jax.lax.dot_general(a, b, _DN, preferred_element_type=jnp.int32)


@jax.jit
def respond_batch(queries_u32, d0, d1):
    """(Q, m) uint32 queries x digit-plane DB -> (Q, C) uint32 responses."""
    q, m = queries_u32.shape
    qd = recode_u32_jnp(queries_u32)  # (4, Q, m) int8
    p0 = _dot_i8(qd.reshape(NUM_U32_DIGITS * q, m), d0).reshape(NUM_U32_DIGITS, q, -1)
    p1 = _dot_i8(qd[:3].reshape(3 * q, m), d1).reshape(3, q, -1)
    out = p0[0]
    for i in range(1, NUM_U32_DIGITS):
        out = out + (p0[i] << (8 * i))
    for i in range(3):
        out = out + (p1[i] << (8 * (i + 1)))
    return out.astype(jnp.uint32)


def respond_batch_np(queries_u32: np.ndarray, db_u32: np.ndarray) -> np.ndarray:
    """Host reference path: (Q, m) x (m, C) mod 2^32 via uint64 wrap."""
    return (queries_u32.astype(np.uint64) @ db_u32.astype(np.uint64)).astype(np.uint32)
