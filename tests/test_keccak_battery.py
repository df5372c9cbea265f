"""TurboSHAKE128 cross-implementation battery.

With no Rust toolchain in this image, byte-exactness vs the reference's
`turboshake` crate (binary_fuse_filter.rs:568-584, matrix.rs:541-558)
cannot be certified directly. This battery is the strongest locally
possible substitute:

* an INDEPENDENT from-the-spec Keccak-p[1600] reimplementation lives in
  this file — round constants generated by the rc(t) LFSR (FIPS 202
  section 3.2.5), rho offsets by the (t+1)(t+2)/2 walk (section 3.2.2),
  pi by formula — so a transcription error in the hand-copied constant
  tables of core/keccak.py or native/engine.cpp cannot hide;
* at 24 rounds + domain 0x1F the independent sponge must equal OpenSSL's
  SHAKE128 (hashlib) — a third-party anchor — across multi-rate-block
  absorbs and >2-block squeezes;
* at 12 rounds it must equal core/keccak.py (python), the C++ engine,
  and ops/prg_jax.py (the device ctr Keccak) on randomized inputs, again
  covering multi-block absorb, long squeeze, and (where supported)
  non-default domain bytes.

TurboSHAKE128 differs from SHAKE128 ONLY in running the final 12 of the
24 Keccak-f rounds; the LFSR-derived constant list makes that "final 12"
slice explicit, so the 24-round hashlib anchor + the shared slicing rule
pin the 12-round variant about as hard as vectors would.
"""

import hashlib

import numpy as np
import pytest

from chalametpir_tpu.core.keccak import RATE, TurboShake128, turboshake128

try:
    from chalametpir_tpu.native import engine as native_eng
except Exception:  # pragma: no cover - native build unavailable
    native_eng = None


# -- independent reimplementation -------------------------------------------

_M64 = (1 << 64) - 1


def _spec_round_constants() -> list[int]:
    """RC[0..23] via the rc(t) LFSR of FIPS 202 (x^8+x^6+x^5+x^4+1)."""

    def rc_bit(t: int) -> int:
        if t % 255 == 0:
            return 1
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    consts = []
    for ir in range(24):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * ir):
                rc |= 1 << ((1 << j) - 1)
        consts.append(rc)
    return consts


def _spec_rho_offsets() -> dict:
    """Rotation offsets via the (x,y) -> (y, 2x+3y) walk of FIPS 202."""
    offs = {(0, 0): 0}
    x, y = 1, 0
    for t in range(24):
        offs[(x, y)] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return offs


_RC = _spec_round_constants()
_RHO = _spec_rho_offsets()


def _rot(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & _M64 if s else v


def _spec_permute(lanes: list[int], nrounds: int) -> list[int]:
    """Keccak-p[1600, nrounds]; lane i = A[x, y] with i = x + 5y."""
    a = {(x, y): lanes[x + 5 * y] for x in range(5) for y in range(5)}
    for rc in _RC[24 - nrounds :]:
        c = {x: a[x, 0] ^ a[x, 1] ^ a[x, 2] ^ a[x, 3] ^ a[x, 4] for x in range(5)}
        d = {x: c[(x - 1) % 5] ^ _rot(c[(x + 1) % 5], 1) for x in range(5)}
        a = {(x, y): a[x, y] ^ d[x] for x in range(5) for y in range(5)}
        b = {
            (y, (2 * x + 3 * y) % 5): _rot(a[x, y], _RHO[x, y])
            for x in range(5)
            for y in range(5)
        }
        a = {
            (x, y): b[x, y] ^ (~b[(x + 1) % 5, y] & _M64 & b[(x + 2) % 5, y])
            for x in range(5)
            for y in range(5)
        }
        a[0, 0] ^= rc
    return [a[x, y] for y in range(5) for x in range(5)]


def _spec_xof(msg: bytes, out_len: int, nrounds: int = 12, domain: int = 0x1F) -> bytes:
    """Sponge at rate 168 over the independent permutation (state bytes:
    lane i little-endian at offset 8i)."""
    state = bytearray(200)

    def permute() -> None:
        lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
        lanes = _spec_permute(lanes, nrounds)
        for i, v in enumerate(lanes):
            state[8 * i : 8 * i + 8] = v.to_bytes(8, "little")

    padded = bytearray(msg)
    padded.append(domain)
    while len(padded) % RATE:
        padded.append(0)
    padded[-1] ^= 0x80
    for off in range(0, len(padded), RATE):
        for i in range(RATE):
            state[i] ^= padded[off + i]
        permute()
    out = bytearray()
    while len(out) < out_len:
        out += state[:RATE]
        if len(out) < out_len:
            permute()
    return bytes(out[:out_len])


# -- anchor: independent impl vs OpenSSL at 24 rounds ------------------------


@pytest.mark.parametrize("msg_len", [0, 1, 167, 168, 169, 336, 1000])
@pytest.mark.parametrize("out_len", [32, 168, 337, 600])
def test_spec_impl_matches_openssl_shake128(msg_len, out_len):
    msg = bytes((7 * i + 3) & 0xFF for i in range(msg_len))
    assert _spec_xof(msg, out_len, nrounds=24) == hashlib.shake_128(msg).digest(out_len)


def test_spec_constants_are_the_published_tables():
    """The LFSR/walk derivations must reproduce the hand-copied tables in
    core/keccak.py — a transcription error in either fails here."""
    from chalametpir_tpu.core.keccak import KECCAK_RC, _RHO as CORE_RHO

    assert tuple(_RC) == KECCAK_RC
    assert tuple(_RHO[i % 5, i // 5] for i in range(25)) == CORE_RHO


# -- 12-round cross-implementation agreement ---------------------------------


def _random_messages(rng):
    lens = [0, 1, 31, 32, 167, 168, 169, 335, 336, 500]
    lens += [int(n) for n in rng.integers(0, 4 * RATE, size=6)]
    return [rng.bytes(n) for n in lens]


def test_spec_vs_python_turboshake(rng):
    for msg in _random_messages(rng):
        for out_len in (32, 200, 500):
            assert _spec_xof(msg, out_len) == turboshake128(msg, out_len)


def test_spec_vs_python_nondefault_domain(rng):
    for msg in _random_messages(rng)[:6]:
        for domain in (0x01, 0x07, 0x0B, 0x7F):
            assert _spec_xof(msg, 64, domain=domain) == turboshake128(
                msg, 64, domain_separator=domain
            )


@pytest.mark.skipif(native_eng is None, reason="native engine unavailable")
def test_spec_vs_native_engine(rng):
    for msg in _random_messages(rng):
        # one-shot (covers multi-block absorb)
        assert _spec_xof(msg, 400) == native_eng.turboshake128(msg, 400)
    # incremental long squeeze across rate-block boundaries
    stream = native_eng.XofStream(b"battery-seed")
    got = b"".join(stream.squeeze(n).tobytes() for n in (1, 167, 168, 169, 400))
    assert got == _spec_xof(b"battery-seed", 1 + 167 + 168 + 169 + 400)


def test_spec_vs_ctr_modes(rng):
    """ctr-mode blocks (TurboSHAKE128(seed || LE64(i))[:168]) across the
    numpy batch engine, the native engine, and the device Pallas Keccak."""
    from chalametpir_tpu.core import prg

    seed = rng.bytes(32)
    want = np.stack(
        [
            np.frombuffer(_spec_xof(seed + int(i).to_bytes(8, "little"), RATE), np.uint8)
            for i in range(6)
        ]
    )
    got = prg._ctr_blocks(seed, 0, 6)  # native when available, numpy else
    assert np.array_equal(got, want)
    if native_eng is not None:
        assert np.array_equal(native_eng.ctr_expand(seed, 0, 6), want)
        # numpy fallback path, explicitly
        saved = prg._native
        try:
            prg._native = None
            assert np.array_equal(prg._ctr_blocks(seed, 0, 6), want)
        finally:
            prg._native = saved

    from chalametpir_tpu.ops import prg_jax

    sw = prg_jax.seed_to_words(seed)
    dev = np.asarray(prg_jax.ctr_blocks_u32(sw, _blk0_words_for(prg_jax, 0), 6))
    assert np.array_equal(dev.reshape(6, -1).view(np.uint8)[:, :RATE], want)


def _blk0_words_for(prg_jax, block0: int):
    import jax.numpy as jnp

    return jnp.array([block0 & 0xFFFFFFFF, block0 >> 32], dtype=jnp.uint32)


def test_incremental_absorb_matches_spec():
    msg = bytes(range(256)) * 2
    h = TurboShake128()
    h.absorb(msg[:100])
    h.absorb(msg[100:300])
    h.absorb(msg[300:])
    h.finalize()
    assert h.squeeze(700) == _spec_xof(msg, 700)
