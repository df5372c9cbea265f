"""L0 protocol parameters for the ChalametPIR framework.

Values mirror the reference constants exactly (reference:
chalametpir_common/src/params.rs:1-17) — they are part of the wire
protocol and must not drift if interop with reference peers is desired.
"""

from __future__ import annotations

from .errors import KVDatabaseSizeTooLarge

# LWE secret dimension (reference: params.rs:1).
LWE_DIMENSION: int = 1774

# The parameter choice provides 128-bit security (reference: params.rs:4).
BIT_SECURITY_LEVEL: int = 128

# Seed for expanding the public LWE matrix A (reference: params.rs:5).
SEED_BYTE_LEN: int = (2 * BIT_SECURITY_LEVEL) // 8  # 32

# TurboSHAKE128 digest length used as the canonical key identity
# (reference: params.rs:6).
HASHED_KEY_BYTE_LEN: int = (2 * BIT_SECURITY_LEVEL) // 8  # 32
HASHED_KEY_BIT_LEN: int = HASHED_KEY_BYTE_LEN * 8  # 256

# Maximum number of fresh-seed retries when building a binary fuse filter
# (reference: params.rs:10).
SERVER_SETUP_MAX_ATTEMPT_COUNT: int = 100

# Bounds on the encoded-DB matrix element bit width `b`; derived from
# FrodoPIR eq. 8 for DB sizes between 1 and 2^42 entries
# (reference: params.rs:14-17).
MIN_CIPHER_TEXT_BIT_LEN: int = 4
MAX_CIPHER_TEXT_BIT_LEN: int = 14

# All matrix arithmetic is carried out in Z_q with q = 2^32.
MODULUS_BIT_LEN: int = 32
MODULUS: int = 1 << MODULUS_BIT_LEN

# TurboSHAKE128 domain separator used for every hash in the protocol
# (the reference uses the `turboshake` crate's default, 0x1F).
TURBOSHAKE_DOMAIN_SEPARATOR: int = 0x1F


def find_mat_elem_bit_len(db_entry_count: int) -> int:
    """Largest bit width `b` such that 2^32 >= 8 * (2^b)^2 * floor(sqrt(n)).

    This is the FrodoPIR correctness condition (eq. 8, ia.cr/2022/981);
    mirrors reference: chalametpir_server/src/server.rs:193-218.
    """
    sqrt_n = _isqrt(db_entry_count)

    bit_len = 0
    while MODULUS >= 8 * (1 << (2 * bit_len)) * sqrt_n:
        bit_len += 1
    bit_len -= 1

    if bit_len < MIN_CIPHER_TEXT_BIT_LEN:
        raise KVDatabaseSizeTooLarge()
    return bit_len


def query_indicator(mat_elem_bit_len: int) -> int:
    """Delta = floor(2^32 / 2^b) (reference: client.rs:277-282)."""
    return MODULUS // (1 << mat_elem_bit_len)


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)
