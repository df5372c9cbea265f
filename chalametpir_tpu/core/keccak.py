"""TurboSHAKE128 — the protocol's only cryptographic hash.

Used for (a) the canonical 32-byte key digest, (b) expanding the 32-byte
public seed into the LWE matrix A, and (c) nothing else. Must be
bit-exact with the reference's `turboshake` crate (TurboSHAKE128 with
domain separator 0x1F, i.e. Keccak-p[1600,12] sponge at rate 168;
reference: chalametpir_common/src/binary_fuse_filter.rs:568-584 and
matrix.rs:541-558).

Two engines live here:

* a **batched numpy engine** that hashes millions of independent short
  messages at once by running the permutation across a (n, 25) uint64
  lane array — this is the host-side analogue of the SIMD/SPMD style the
  rest of the framework uses on the device;
* a **streaming single-instance engine** for the sequential XOF squeeze
  (seed -> matrix A expansion is one serial sponge stream and cannot be
  parallelised). The native C++ engine in `chalametpir_tpu.native`
  replaces this hot path when available; this pure-Python version is the
  semantic reference and test fallback.

Machinery is validated in tests against hashlib's SHAKE128 (identical
sponge and padding byte, 24-round permutation) plus the published
TurboSHAKE128 test vector.
"""

from __future__ import annotations

import numpy as np

RATE = 168  # TurboSHAKE128 / SHAKE128 rate in bytes
DEFAULT_DOMAIN_SEPARATOR = 0x1F

_MASK64 = (1 << 64) - 1

# Standard Keccak-f[1600] round constants; Keccak-p[1600,12] uses the last 12.
KECCAK_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rho rotation offsets, indexed by lane x + 5*y.
_RHO = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)

# Pi: lane (x, y) moves to (y, 2x+3y). Destination index for source lane i.
_PI_DEST = tuple((i // 5 + 5 * ((2 * (i % 5) + 3 * (i // 5)) % 5)) for i in range(25))


def _rotl_np(x: np.ndarray, s: int) -> np.ndarray:
    if s == 0:
        return x
    return (x << np.uint64(s)) | (x >> np.uint64(64 - s))


def keccak_p(state: np.ndarray, nrounds: int = 12) -> np.ndarray:
    """Keccak-p[1600, nrounds] over a (..., 25) uint64 lane array.

    Vectorised across all leading batch dimensions. `nrounds=12` gives the
    TurboSHAKE permutation (the final 12 rounds of Keccak-f[1600]);
    `nrounds=24` gives full Keccak-f[1600] (used only for validation).
    """
    a = [state[..., i] for i in range(25)]
    for rc in KECCAK_RC[24 - nrounds:]:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl_np(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b: list = [None] * 25
        for i in range(25):
            b[_PI_DEST[i]] = _rotl_np(a[i], _RHO[i])
        # chi
        a = [
            b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        # iota
        a[0] = a[0] ^ np.uint64(rc)
    return np.stack(a, axis=-1)


class TurboShake128:
    """Streaming single-instance TurboSHAKE128 XOF (absorb/finalize/squeeze).

    Mirrors the reference crate's API shape: absorb any number of times,
    finalize once with a domain separator, then squeeze arbitrarily many
    bytes.
    """

    def __init__(self, nrounds: int = 12) -> None:
        self._state = np.zeros(25, dtype=np.uint64)
        self._buf = bytearray()  # partial block; whole blocks XOR at offset 0
        self._nrounds = nrounds
        self._finalized = False
        self._squeeze_block = b""
        self._squeeze_off = 0

    def _xor_block(self, block: bytes) -> None:
        arr = np.frombuffer(block, dtype=np.uint8)
        self._state.view(np.uint8)[: len(arr)] ^= arr

    def absorb(self, data: bytes) -> None:
        assert not self._finalized
        self._buf += data
        # absorb all complete rate blocks
        while len(self._buf) >= RATE:
            self._xor_block(bytes(self._buf[:RATE]))
            del self._buf[:RATE]
            self._state = keccak_p(self._state, self._nrounds)

    def finalize(self, domain_separator: int = DEFAULT_DOMAIN_SEPARATOR) -> None:
        assert not self._finalized
        # absorb the remaining partial block, then D, then pad10*1
        rem = bytes(self._buf)
        self._xor_block(rem)
        pos = len(rem)  # < RATE by the absorb loop invariant
        sbytes = self._state.view(np.uint8)
        sbytes[pos] ^= np.uint8(domain_separator)
        sbytes[RATE - 1] ^= np.uint8(0x80)
        self._state = keccak_p(self._state, self._nrounds)
        self._buf.clear()
        self._finalized = True
        self._squeeze_block = self._state.view(np.uint8)[:RATE].tobytes()
        self._squeeze_off = 0

    def squeeze(self, n: int) -> bytes:
        assert self._finalized
        out = bytearray()
        while n > 0:
            if self._squeeze_off == RATE:
                self._state = keccak_p(self._state, self._nrounds)
                self._squeeze_block = self._state.view(np.uint8)[:RATE].tobytes()
                self._squeeze_off = 0
            take = min(n, RATE - self._squeeze_off)
            out += self._squeeze_block[self._squeeze_off : self._squeeze_off + take]
            self._squeeze_off += take
            n -= take
        return bytes(out)


def turboshake128(data: bytes, out_len: int, domain_separator: int = DEFAULT_DOMAIN_SEPARATOR) -> bytes:
    """One-shot TurboSHAKE128."""
    h = TurboShake128()
    h.absorb(data)
    h.finalize(domain_separator)
    return h.squeeze(out_len)


def turboshake128_batch(
    msgs: np.ndarray,
    lengths: np.ndarray,
    out_len: int,
    domain_separator: int = DEFAULT_DOMAIN_SEPARATOR,
) -> np.ndarray:
    """TurboSHAKE128 over `n` independent messages at once.

    Arguments:
      msgs: (n, max_len) uint8, each row a message left-aligned and
        zero-padded to max_len.
      lengths: (n,) actual byte length per message.
      out_len: bytes to squeeze per message (<= RATE currently).

    Returns (n, out_len) uint8. The permutation runs vectorised across all
    n sponges — this is what makes hashing 2^20 keys take milliseconds
    instead of minutes.
    """
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    n, max_len = msgs.shape
    if out_len > RATE:
        raise ValueError("batched squeeze beyond one rate block not supported")

    nblocks = max(1, -(-(int(lengths.max(initial=0)) + 1) // RATE))  # +1 for D byte
    padded = np.zeros((n, nblocks * RATE), dtype=np.uint8)
    padded[:, :max_len] = msgs
    # zero out any stray bytes beyond each message's length
    col = np.arange(max_len)
    padded[:, :max_len] = np.where(col[None, :] < lengths[:, None], padded[:, :max_len], 0)
    # domain separator directly after the message, 0x80 into the last byte
    # of the final rate block (the TurboSHAKE pad10*1 rule)
    padded[np.arange(n), lengths] = domain_separator
    last_block = (lengths + 1 + RATE - 1) // RATE  # block count actually used
    final_block = np.maximum(last_block, 1)
    padded[np.arange(n), final_block * RATE - 1] ^= 0x80

    state = np.zeros((n, 25), dtype=np.uint64)
    state_bytes = state.view(np.uint8).reshape(n, 200)
    blocks = padded.reshape(n, nblocks, RATE)
    for bi in range(nblocks):
        # sponges whose message (plus padding) already ended stop permuting
        active = bi < final_block
        if not active.all():
            xor_src = np.where(active[:, None], blocks[:, bi, :], 0)
        else:
            xor_src = blocks[:, bi, :]
        state_bytes[:, :RATE] ^= xor_src
        if active.all():
            state = keccak_p(state)
        else:
            state[active] = keccak_p(state[active])
        state_bytes = state.view(np.uint8).reshape(n, 200)
    return state_bytes[:, :out_len].copy()
