// Native host engine for chalametpir_tpu.
//
// Accelerates the sequential / pointer-chasing host paths that numpy cannot
// vectorise (and that the reference implements in Rust):
//   * TurboSHAKE128 streaming XOF        (reference: turboshake crate;
//     used by matrix.rs:541-558 seed->A expansion)
//   * batched key digests                (binary_fuse_filter.rs:568-584)
//   * binary fuse filter peel            (binary_fuse_filter.rs:40-456)
//   * KV row bit-pack encode             (serialization.rs:22-116)
//   * reverse-peel-order row assembly    (matrix.rs:707-746, 839-885)
//   * ternary {0,+1,-1} vector-matrix    (client query path, matrix.rs:1040-1059)
//
// Exposed as a plain C ABI consumed via ctypes (chalametpir_tpu/native/engine.py).
// Build: make -C chalametpir_tpu/native

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <sys/mman.h>

// ---------------------------------------------------------------------------
// Keccak-p[1600,12] and the TurboSHAKE128 sponge (rate 168, domain 0x1F).
// ---------------------------------------------------------------------------

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline uint64_t rotl64(uint64_t x, int s) {
  return (x << s) | (x >> (64 - s));
}

// One permutation: `nr` final rounds of Keccak-f[1600].
static void keccak_p(uint64_t a[25], int nr) {
  uint64_t c0, c1, c2, c3, c4, d0, d1, d2, d3, d4;
  for (int r = 24 - nr; r < 24; ++r) {
    // theta
    c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
    c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
    c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
    c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
    c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
    d0 = c4 ^ rotl64(c1, 1);
    d1 = c0 ^ rotl64(c2, 1);
    d2 = c1 ^ rotl64(c3, 1);
    d3 = c2 ^ rotl64(c4, 1);
    d4 = c3 ^ rotl64(c0, 1);
    a[0] ^= d0; a[5] ^= d0; a[10] ^= d0; a[15] ^= d0; a[20] ^= d0;
    a[1] ^= d1; a[6] ^= d1; a[11] ^= d1; a[16] ^= d1; a[21] ^= d1;
    a[2] ^= d2; a[7] ^= d2; a[12] ^= d2; a[17] ^= d2; a[22] ^= d2;
    a[3] ^= d3; a[8] ^= d3; a[13] ^= d3; a[18] ^= d3; a[23] ^= d3;
    a[4] ^= d4; a[9] ^= d4; a[14] ^= d4; a[19] ^= d4; a[24] ^= d4;
    // rho + pi
    uint64_t b[25];
    b[0] = a[0];
    b[10] = rotl64(a[1], 1);
    b[20] = rotl64(a[2], 62);
    b[5] = rotl64(a[3], 28);
    b[15] = rotl64(a[4], 27);
    b[16] = rotl64(a[5], 36);
    b[1] = rotl64(a[6], 44);
    b[11] = rotl64(a[7], 6);
    b[21] = rotl64(a[8], 55);
    b[6] = rotl64(a[9], 20);
    b[7] = rotl64(a[10], 3);
    b[17] = rotl64(a[11], 10);
    b[2] = rotl64(a[12], 43);
    b[12] = rotl64(a[13], 25);
    b[22] = rotl64(a[14], 39);
    b[23] = rotl64(a[15], 41);
    b[8] = rotl64(a[16], 45);
    b[18] = rotl64(a[17], 15);
    b[3] = rotl64(a[18], 21);
    b[13] = rotl64(a[19], 8);
    b[14] = rotl64(a[20], 18);
    b[24] = rotl64(a[21], 2);
    b[9] = rotl64(a[22], 61);
    b[19] = rotl64(a[23], 56);
    b[4] = rotl64(a[24], 14);
    // chi
    for (int y = 0; y < 25; y += 5) {
      uint64_t t0 = b[y], t1 = b[y + 1], t2 = b[y + 2], t3 = b[y + 3], t4 = b[y + 4];
      a[y] = t0 ^ (~t1 & t2);
      a[y + 1] = t1 ^ (~t2 & t3);
      a[y + 2] = t2 ^ (~t3 & t4);
      a[y + 3] = t3 ^ (~t4 & t0);
      a[y + 4] = t4 ^ (~t0 & t1);
    }
    // iota
    a[0] ^= RC[r];
  }
}

static const int RATE = 168;
static const uint8_t DOMAIN = 0x1F;

struct Xof {
  uint64_t st[25];
  int off;  // squeeze offset within the current rate block
};

// Absorb a short message (<= arbitrary length) and finalize with D=0x1F.
static void xof_init(Xof* x, const uint8_t* msg, int64_t len) {
  std::memset(x->st, 0, sizeof(x->st));
  uint8_t* sb = reinterpret_cast<uint8_t*>(x->st);
  int64_t pos = 0;
  while (len - pos >= RATE) {
    for (int i = 0; i < RATE; ++i) sb[i] ^= msg[pos + i];
    keccak_p(x->st, 12);
    pos += RATE;
  }
  int rem = static_cast<int>(len - pos);
  for (int i = 0; i < rem; ++i) sb[i] ^= msg[pos + i];
  sb[rem] ^= DOMAIN;
  sb[RATE - 1] ^= 0x80;
  keccak_p(x->st, 12);
  x->off = 0;
}

static void xof_squeeze(Xof* x, uint8_t* out, int64_t n) {
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(x->st);
  while (n > 0) {
    if (x->off == RATE) {
      keccak_p(x->st, 12);
      x->off = 0;
    }
    int64_t take = RATE - x->off;
    if (take > n) take = n;
    std::memcpy(out, sb + x->off, static_cast<size_t>(take));
    out += take;
    x->off += static_cast<int>(take);
    n -= take;
  }
}

extern "C" {

void* ts128_xof_new(const uint8_t* seed, int64_t seed_len) {
  Xof* x = new Xof();
  xof_init(x, seed, seed_len);
  return x;
}

void ts128_xof_squeeze(void* handle, uint8_t* out, int64_t n) {
  xof_squeeze(static_cast<Xof*>(handle), out, n);
}

void ts128_xof_free(void* handle) { delete static_cast<Xof*>(handle); }

// Batched 32-byte digests of n variable-length keys (concatenated bytes +
// offsets array of n+1 entries).
void ts128_hash_keys(const uint8_t* data, const int64_t* offsets, int64_t n,
                     uint8_t* out32) {
  for (int64_t i = 0; i < n; ++i) {
    Xof x;
    xof_init(&x, data + offsets[i], offsets[i + 1] - offsets[i]);
    xof_squeeze(&x, out32 + 32 * i, 32);
  }
}

// Counter-mode TurboSHAKE expansion: block i of the stream is the first
// 168 bytes of TurboSHAKE128(seed || LE64(i)). Unlike the reference's
// single serial sponge, blocks are independent — the same function runs
// embarrassingly parallel on host SIMD or on the device (ops/prg_jax.py).
void ts128_ctr_expand(const uint8_t* seed, int64_t seed_len, int64_t block0,
                      int64_t nblocks, uint8_t* out) {
  std::vector<uint8_t> msg(static_cast<size_t>(seed_len) + 8);
  std::memcpy(msg.data(), seed, static_cast<size_t>(seed_len));
  for (int64_t i = 0; i < nblocks; ++i) {
    const uint64_t ctr = static_cast<uint64_t>(block0 + i);
    std::memcpy(msg.data() + seed_len, &ctr, 8);
    Xof x;
    xof_init(&x, msg.data(), static_cast<int64_t>(msg.size()));
    std::memcpy(out + i * RATE, reinterpret_cast<const uint8_t*>(x.st), RATE);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Filter hash family.
// ---------------------------------------------------------------------------

static inline uint64_t murmur64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

static inline void hash_rows(uint64_t h, uint32_t arity, uint32_t seg_len,
                             uint32_t seg_cnt_len, uint32_t out[4]) {
  uint32_t mask = seg_len - 1;
  uint64_t hi = static_cast<uint64_t>(
      (static_cast<__uint128_t>(h) * seg_cnt_len) >> 64);
  uint32_t h0 = static_cast<uint32_t>(hi);
  if (arity == 3) {
    out[0] = h0;
    out[1] = (h0 + seg_len) ^ (static_cast<uint32_t>(h >> 18) & mask);
    out[2] = (h0 + 2 * seg_len) ^ (static_cast<uint32_t>(h) & mask);
  } else {
    out[0] = h0;
    out[1] = (h0 + seg_len) ^ (static_cast<uint32_t>(h) & mask);
    out[2] = (h0 + 2 * seg_len) ^ (static_cast<uint32_t>(h >> 16) & mask);
    out[3] = (h0 + 3 * seg_len) ^ (static_cast<uint32_t>(h >> 32) & mask);
  }
}

extern "C" {

// Count degrees and peel. hashes: n fused (deduplicated) key hashes.
// Outputs reverse_order (peel-order hashes) and reverse_h (slot codes).
// Returns 1 on success, 0 when peeling stalls (caller retries with a new
// seed) — mirrors binary_fuse_filter.rs:102-215. Returns -1 when the
// working vectors (13 B/slot) cannot be allocated: a bad_alloc must not
// unwind through the ctypes FFI frames (std::terminate -> process
// abort); the binding converts -1 into a Python MemoryError.
int32_t bff_peel(const uint64_t* hashes, int64_t n, int64_t num_fp,
                 uint32_t arity, uint32_t seg_len, uint32_t seg_cnt_len,
                 uint64_t* reverse_order, uint8_t* reverse_h) try {
  std::vector<int32_t> count(num_fp, 0);
  std::vector<uint64_t> hxor(num_fp, 0);
  std::vector<uint8_t> pxor(num_fp, 0);
  const int32_t max_degree = (arity == 4) ? 31 : 63;

  uint32_t rows[4];
  for (int64_t i = 0; i < n; ++i) {
    hash_rows(hashes[i], arity, seg_len, seg_cnt_len, rows);
    for (uint32_t p = 0; p < arity; ++p) {
      uint32_t r = rows[p];
      count[r] += 1;
      hxor[r] ^= hashes[i];
      pxor[r] ^= static_cast<uint8_t>(p);
      if (count[r] > max_degree) return 0;
    }
  }

  std::vector<uint32_t> queue;
  queue.reserve(static_cast<size_t>(n));
  for (int64_t s = 0; s < num_fp; ++s)
    if (count[s] == 1) queue.push_back(static_cast<uint32_t>(s));

  int64_t top = 0;
  while (!queue.empty()) {
    uint32_t slot = queue.back();
    queue.pop_back();
    if (count[slot] != 1) continue;
    uint64_t h = hxor[slot];
    uint8_t code = pxor[slot];
    reverse_order[top] = h;
    reverse_h[top] = code;
    ++top;
    hash_rows(h, arity, seg_len, seg_cnt_len, rows);
    for (uint32_t p = 0; p < arity; ++p) {
      if (p == code) continue;
      uint32_t r = rows[p];
      count[r] -= 1;
      hxor[r] ^= h;
      pxor[r] ^= static_cast<uint8_t>(p);
      if (count[r] == 1) queue.push_back(r);
    }
  }
  return top == n ? 1 : 0;
} catch (const std::bad_alloc&) {
  return -1;
}

// Bit-pack (digest || value || 0x81) streams into b-bit row elements
// (reference: serialization.rs:22-116). digests: (n,32); values
// concatenated with offsets (n+1).
void encode_rows(const uint8_t* digests, const uint8_t* values,
                 const int64_t* offsets, int64_t n, int32_t b, int64_t cols,
                 uint32_t* out) {
  const uint32_t mask = (1u << b) - 1;
  std::vector<uint8_t> stream;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t vlen = offsets[i + 1] - offsets[i];
    const int64_t stream_len = 32 + vlen + 1;
    stream.assign(static_cast<size_t>((cols * b + 7) / 8 + 8), 0);
    std::memcpy(stream.data(), digests + 32 * i, 32);
    std::memcpy(stream.data() + 32, values + offsets[i], static_cast<size_t>(vlen));
    stream[static_cast<size_t>(stream_len - 1)] = 0x81;
    uint32_t* row = out + i * cols;
    for (int64_t e = 0; e < cols; ++e) {
      const int64_t bit = e * b;
      uint64_t w;
      std::memcpy(&w, stream.data() + (bit >> 3), 8);
      row[e] = static_cast<uint32_t>(w >> (bit & 7)) & mask;
    }
  }
}

// Reverse-peel-order row assembly into the filter matrix D
// (reference: matrix.rs:707-746 / 839-885):
//   D[rows[code]] = (enc - sum_{p != code} D[rows[p]] - mix(hash, col)) mod 2^b
void assemble_rows(uint32_t* mat, const uint32_t* enc_rows,
                   const uint64_t* reverse_order, const uint8_t* reverse_h,
                   int64_t n, int64_t cols, uint32_t arity, uint32_t seg_len,
                   uint32_t seg_cnt_len, int32_t b) {
  const uint32_t mask = (1u << b) - 1;
  uint32_t rows[4];
  for (int64_t i = n - 1; i >= 0; --i) {
    const uint64_t h = reverse_order[i];
    const uint8_t code = reverse_h[i];
    hash_rows(h, arity, seg_len, seg_cnt_len, rows);
    const uint32_t* enc = enc_rows + i * cols;
    uint32_t* dst = mat + static_cast<int64_t>(rows[code]) * cols;
    const uint32_t* oth1 = mat + static_cast<int64_t>(rows[(code + 1) % arity]) * cols;
    const uint32_t* oth2 = mat + static_cast<int64_t>(rows[(code + 2) % arity]) * cols;
    const uint32_t* oth3 =
        arity == 4 ? mat + static_cast<int64_t>(rows[(code + 3) % arity]) * cols : nullptr;
    for (int64_t c = 0; c < cols; ++c) {
      uint32_t acc = enc[c] - oth1[c] - oth2[c];
      if (oth3) acc -= oth3[c];
      acc -= static_cast<uint32_t>(murmur64(h + static_cast<uint64_t>(c)));
      dst[c] = acc & mask;
    }
  }
}

namespace {

struct StepCtx;
static void assemble_one(StepCtx& ctx, int64_t i);

// Shared per-entry state of the fused encode+assemble: both the batch
// entry point (encode_assemble_rows16) and the chunk-ordered one
// (encode_assemble_rows16_ordered) run the SAME per-entry assignment
// through assemble_one, so the encode/assemble math exists exactly once.
struct StepCtx {
  const uint8_t* digests;
  const uint8_t* const* value_ptrs;
  const int64_t* value_lens;
  const int64_t* key_index;
  const uint64_t* reverse_order;
  const uint8_t* reverse_h;
  int32_t b;
  int64_t cols;
  uint32_t arity, seg_len, seg_cnt_len;
  uint16_t* mat;
  std::vector<uint8_t> stream;
  std::vector<uint16_t> enc, msk;

  StepCtx(const uint8_t* digests_, const uint8_t* const* value_ptrs_,
          const int64_t* value_lens_, const int64_t* key_index_,
          const uint64_t* reverse_order_, const uint8_t* reverse_h_,
          int32_t b_, int64_t cols_, uint32_t arity_, uint32_t seg_len_,
          uint32_t seg_cnt_len_, uint16_t* mat_)
      : digests(digests_), value_ptrs(value_ptrs_), value_lens(value_lens_),
        key_index(key_index_), reverse_order(reverse_order_),
        reverse_h(reverse_h_), b(b_), cols(cols_), arity(arity_),
        seg_len(seg_len_), seg_cnt_len(seg_cnt_len_), mat(mat_),
        stream(static_cast<size_t>((cols_ * b_ + 7) / 8 + 8), 0),
        enc(static_cast<size_t>(cols_)), msk(static_cast<size_t>(cols_)) {}
};

// One peel entry's assignment:
//   D[rows[code]] = (enc - sum others - mask) mod 2^b
// stream = digest || value || 0x81 || zero tail, read straight out of the
// caller's (Python bytes) buffers — at GB scale a contiguous join costs
// more in page faults than the whole encode. Branchless extraction:
// b <= 14 and bit%8 <= 7 need at most 21 bits, so one unaligned u32 load
// covers any element (no refill branch, no loop-carried dependency).
static void assemble_one(StepCtx& ctx, int64_t i) {
  const uint32_t mask = (1u << ctx.b) - 1;
  const int64_t cols = ctx.cols;
  const int64_t src = ctx.key_index[i];
  const int64_t vlen = ctx.value_lens[src];
  std::memcpy(ctx.stream.data(), ctx.digests + 32 * src, 32);
  std::memcpy(ctx.stream.data() + 32, ctx.value_ptrs[src],
              static_cast<size_t>(vlen));
  ctx.stream[static_cast<size_t>(32 + vlen)] = 0x81;
  std::memset(ctx.stream.data() + 33 + vlen, 0, ctx.stream.size() - 33 - vlen);
  const uint8_t* sp = ctx.stream.data();
  int64_t bit = 0;
  for (int64_t e = 0; e < cols; ++e, bit += ctx.b) {
    uint32_t w;
    std::memcpy(&w, sp + (bit >> 3), 4);
    ctx.enc[static_cast<size_t>(e)] =
        static_cast<uint16_t>((w >> (bit & 7)) & mask);
  }
  const uint64_t h = ctx.reverse_order[i];
  const uint8_t code = ctx.reverse_h[i];
  uint32_t rows[4];
  hash_rows(h, ctx.arity, ctx.seg_len, ctx.seg_cnt_len, rows);
  // split loops so each one auto-vectorises (AVX512: vpmullq exists)
  for (int64_t c = 0; c < cols; ++c)
    ctx.msk[static_cast<size_t>(c)] =
        static_cast<uint16_t>(murmur64(h + static_cast<uint64_t>(c)));
  uint16_t* dst = ctx.mat + static_cast<int64_t>(rows[code]) * cols;
  const uint16_t* o1 =
      ctx.mat + static_cast<int64_t>(rows[(code + 1) % ctx.arity]) * cols;
  const uint16_t* o2 =
      ctx.mat + static_cast<int64_t>(rows[(code + 2) % ctx.arity]) * cols;
  if (ctx.arity == 4) {
    const uint16_t* o3 =
        ctx.mat + static_cast<int64_t>(rows[(code + 3) % ctx.arity]) * cols;
    for (int64_t c = 0; c < cols; ++c)
      dst[c] = static_cast<uint16_t>(
          (ctx.enc[static_cast<size_t>(c)] - o1[c] - o2[c] - o3[c] -
           ctx.msk[static_cast<size_t>(c)]) & mask);
  } else {
    for (int64_t c = 0; c < cols; ++c)
      dst[c] = static_cast<uint16_t>(
          (ctx.enc[static_cast<size_t>(c)] - o1[c] - o2[c] -
           ctx.msk[static_cast<size_t>(c)]) & mask);
  }
}

}  // namespace

// Fused row-encode + reverse-peel-order assembly into a uint16 matrix D.
//
// Equivalent to encode_rows followed by assemble_rows, but the encoded row
// lives in a ~4 KB scratch buffer instead of a GB-scale intermediate array
// (whose page-in alone dominated setup), and D is uint16: every element is
// < 2^b <= 2^14, and all the mod-2^b algebra commutes with mod-2^16
// wraparound. Inputs are in *original key order*; key_index[i] maps peel
// position i to the original row (reference: matrix.rs:707-746, 839-885 +
// serialization.rs:22-116 for the row codec).
void encode_assemble_rows16(const uint8_t* digests,
                            const uint8_t* const* value_ptrs,
                            const int64_t* value_lens, const int64_t* key_index,
                            const uint64_t* reverse_order,
                            const uint8_t* reverse_h, int64_t n, int32_t b,
                            int64_t cols, uint32_t arity, uint32_t seg_len,
                            uint32_t seg_cnt_len, uint16_t* mat) {
  StepCtx ctx(digests, value_ptrs, value_lens, key_index, reverse_order,
              reverse_h, b, cols, arity, seg_len, seg_cnt_len, mat);
  for (int64_t i = n - 1; i >= 0; --i) assemble_one(ctx, i);
}

// --- streaming (chunk-ordered) encode ------------------------------------
//
// encode_assemble_rows16 processes peel entries in reverse peel order, so
// the rows of D become final in hash-scattered order and nothing can
// consume D until the whole pass ends. The ordered variant executes the
// same per-entry assignments in a *chunk-priority topological order*:
// fingerprint-row chunk 0's writers (and their transitive dependencies)
// run first, then chunk 1's, etc. This is semantics-preserving: each row
// is written exactly once, and in the original order every row an entry
// reads is already final when read (a later write to a read row would
// mean that slot had degree >= 2 at the earlier entry's peel time —
// contradiction with it having been a degree-1 peel slot). The only
// ordering constraints are therefore write-before-read edges, which the
// topological execution preserves. Per-chunk progress counters let the
// caller pack + upload + hint-fold each chunk while later chunks are
// still being assembled.

extern "C" {

// Per-chunk expected write counts: expected[k] = number of peel entries
// whose destination row falls in fingerprint chunk k. Cheap (one hash
// pass); the caller uses it as the completion target for progress[k].
void assemble_plan(const uint64_t* reverse_order, const uint8_t* reverse_h,
                   int64_t n, uint32_t arity, uint32_t seg_len,
                   uint32_t seg_cnt_len, int64_t chunk_rows,
                   int64_t n_chunks, int64_t* expected) {
  for (int64_t k = 0; k < n_chunks; ++k) expected[k] = 0;
  uint32_t rows[4];
  for (int64_t i = 0; i < n; ++i) {
    hash_rows(reverse_order[i], arity, seg_len, seg_cnt_len, rows);
    expected[rows[reverse_h[i]] / chunk_rows] += 1;
  }
}

// Chunk-ordered encode+assemble. Same inputs/outputs as
// encode_assemble_rows16 plus (chunk_rows, n_chunks, progress):
// progress[k] counts rows of chunk k written so far (release-ordered
// atomic increments; the Python caller polls until it matches the plan).
void encode_assemble_rows16_ordered(
    const uint8_t* digests, const uint8_t* const* value_ptrs,
    const int64_t* value_lens, const int64_t* key_index,
    const uint64_t* reverse_order, const uint8_t* reverse_h, int64_t n,
    int32_t b, int64_t cols, uint32_t arity, uint32_t seg_len,
    uint32_t seg_cnt_len, uint16_t* mat, int64_t num_fp, int64_t chunk_rows,
    int64_t n_chunks, int64_t* progress) {
  // dst row and writer-of-row maps
  std::vector<uint32_t> dstrow(static_cast<size_t>(n));
  std::vector<int64_t> writer(static_cast<size_t>(num_fp), -1);
  uint32_t rows[4];
  for (int64_t i = 0; i < n; ++i) {
    hash_rows(reverse_order[i], arity, seg_len, seg_cnt_len, rows);
    dstrow[static_cast<size_t>(i)] = rows[reverse_h[i]];
    writer[rows[reverse_h[i]]] = i;
  }
  // dependency CSR: step i depends on the writers of the rows it reads
  std::vector<int32_t> ndeps(static_cast<size_t>(n), 0);
  std::vector<int64_t> dep_off(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    hash_rows(reverse_order[i], arity, seg_len, seg_cnt_len, rows);
    const uint8_t code = reverse_h[i];
    for (uint32_t p = 0; p < arity; ++p) {
      if (p == code) continue;
      if (writer[rows[p]] >= 0) ndeps[static_cast<size_t>(i)] += 1;
    }
    dep_off[static_cast<size_t>(i) + 1] =
        dep_off[static_cast<size_t>(i)] + ndeps[static_cast<size_t>(i)];
  }
  std::vector<int64_t> deps(static_cast<size_t>(dep_off[n]));
  {
    std::vector<int64_t> fill(dep_off.begin(), dep_off.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      hash_rows(reverse_order[i], arity, seg_len, seg_cnt_len, rows);
      const uint8_t code = reverse_h[i];
      for (uint32_t p = 0; p < arity; ++p) {
        if (p == code) continue;
        const int64_t w = writer[rows[p]];
        if (w >= 0) deps[static_cast<size_t>(fill[static_cast<size_t>(i)]++)] = w;
      }
    }
  }
  // bucket steps by destination chunk
  std::vector<int64_t> bucket_off(static_cast<size_t>(n_chunks) + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    bucket_off[dstrow[static_cast<size_t>(i)] / chunk_rows + 1] += 1;
  for (int64_t k = 0; k < n_chunks; ++k)
    bucket_off[static_cast<size_t>(k) + 1] += bucket_off[static_cast<size_t>(k)];
  std::vector<int64_t> buckets(static_cast<size_t>(n));
  {
    std::vector<int64_t> fill(bucket_off.begin(), bucket_off.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      buckets[static_cast<size_t>(
          fill[dstrow[static_cast<size_t>(i)] / chunk_rows]++)] = i;
  }

  StepCtx ctx(digests, value_ptrs, value_lens, key_index, reverse_order,
              reverse_h, b, cols, arity, seg_len, seg_cnt_len, mat);

  std::vector<uint8_t> done(static_cast<size_t>(n), 0);
  std::vector<int64_t> stack;
  stack.reserve(1024);
  for (int64_t k = 0; k < n_chunks; ++k) {
    for (int64_t bi = bucket_off[static_cast<size_t>(k)];
         bi < bucket_off[static_cast<size_t>(k) + 1]; ++bi) {
      const int64_t root = buckets[static_cast<size_t>(bi)];
      if (done[static_cast<size_t>(root)]) continue;
      stack.push_back(root);
      while (!stack.empty()) {
        const int64_t t = stack.back();
        if (done[static_cast<size_t>(t)]) {
          stack.pop_back();
          continue;
        }
        bool ready = true;
        for (int64_t d = dep_off[static_cast<size_t>(t)];
             d < dep_off[static_cast<size_t>(t) + 1]; ++d) {
          const int64_t w = deps[static_cast<size_t>(d)];
          if (!done[static_cast<size_t>(w)]) {
            stack.push_back(w);
            ready = false;
          }
        }
        if (!ready) continue;
        assemble_one(ctx, t);
        done[static_cast<size_t>(t)] = 1;
        stack.pop_back();
        __atomic_fetch_add(&progress[dstrow[static_cast<size_t>(t)] / chunk_rows],
                           1, __ATOMIC_RELEASE);
      }
    }
  }
}

}  // extern "C"

// Shared core of build_packed_planes{,16}: biased low-byte plane plus the
// block-interleaved bit-packed high plane, one streaming read of D.
// lo_stride lets the caller request a TIGHT lo plane (stride == c) so the
// zero column padding never crosses the host link; the device pads.
// hi stays c_pad-based: its block-interleave layout is defined over c_pad.
extern "C++" {
template <typename T>
static void pack_planes_impl(const T* mat, int64_t m, int64_t c,
                             int64_t lo_stride, int64_t c_pad, int8_t* lo,
                             uint8_t* hi, int32_t pack, int32_t bits) {
  const int64_t pc = (pack > 1) ? c_pad / pack : c_pad;
  for (int64_t r = 0; r < m; ++r) {
    const T* src = mat + r * c;
    int8_t* lo_row = lo + r * lo_stride;
    for (int64_t j = 0; j < c; ++j)
      lo_row[j] = static_cast<int8_t>(static_cast<uint8_t>(src[j]) - 128u);
    if (hi == nullptr) continue;
    uint8_t* hi_row = hi + r * pc;
    if (pack <= 1) {
      for (int64_t j = 0; j < c; ++j)
        hi_row[j] = static_cast<uint8_t>(src[j] >> 8);
    } else {
      // field-major (no per-element division, vectorizes):
      // field f of word t <- logical column f*pc + t
      for (int64_t f = 0; f * pc < c; ++f) {
        const int64_t t_end = std::min(pc, c - f * pc);
        const T* col = src + f * pc;
        const int shift = bits * static_cast<int>(f);
        for (int64_t t = 0; t < t_end; ++t)
          hi_row[t] |= static_cast<uint8_t>(col[t] >> 8) << shift;
      }
    }
  }
}
}  // extern "C++"

// uint16-input variant of build_packed_planes (D is stored as uint16).
void build_packed_planes16(const uint16_t* mat, int64_t m, int64_t c,
                           int64_t lo_stride, int64_t c_pad, int8_t* lo,
                           uint8_t* hi, int32_t pack, int32_t bits) {
  pack_planes_impl(mat, m, c, lo_stride, c_pad, lo, hi, pack, bits);
}

// ---------------------------------------------------------------------------
// ChaCha8 CSPRNG + uniform ternary sampling (LWE secret/error vectors).
// The reference samples from ChaCha8Rng seeded with OS entropy
// (matrix.rs:572-619); a statistically-uniform-but-predictable generator
// is an encryption-key defect, so numpy RNGs are not an option here.
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int s) {
  return (x << s) | (x >> (32 - s));
}

#define CHACHA_QR(a, b, c, d)                          \
  a += b; d ^= a; d = rotl32(d, 16);                   \
  c += d; b ^= c; b = rotl32(b, 12);                   \
  a += b; d ^= a; d = rotl32(d, 8);                    \
  c += d; b ^= c; b = rotl32(b, 7)

// One ChaCha8 block: 16 output words from (key, counter, nonce).
static void chacha8_block(const uint32_t key[8], uint64_t counter,
                          const uint32_t nonce[2], uint32_t out[16]) {
  uint32_t s[16] = {
      0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
      key[0], key[1], key[2], key[3], key[4], key[5], key[6], key[7],
      static_cast<uint32_t>(counter), static_cast<uint32_t>(counter >> 32),
      nonce[0], nonce[1]};
  uint32_t x[16];
  std::memcpy(x, s, sizeof(x));
  for (int r = 0; r < 4; ++r) {  // 8 rounds = 4 double-rounds
    CHACHA_QR(x[0], x[4], x[8], x[12]);
    CHACHA_QR(x[1], x[5], x[9], x[13]);
    CHACHA_QR(x[2], x[6], x[10], x[14]);
    CHACHA_QR(x[3], x[7], x[11], x[15]);
    CHACHA_QR(x[0], x[5], x[10], x[15]);
    CHACHA_QR(x[1], x[6], x[11], x[12]);
    CHACHA_QR(x[2], x[7], x[8], x[13]);
    CHACHA_QR(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
}

extern "C" {

// n uniform ternary codes {0, 1, 2} (2 encodes -1) from ChaCha8 keyed with
// 32 bytes of caller-supplied (OS) entropy. Rejection sampling: a u32 draw
// is rejected iff it falls in the final partial bucket of size 2^32 mod 3
// (probability 2^-32), so the %3 map is exactly uniform.
void chacha8_ternary(const uint8_t* key32, int64_t n, int8_t* out) {
  uint32_t key[8];
  std::memcpy(key, key32, 32);
  const uint32_t nonce[2] = {0, 0};
  const uint32_t limit = 0xFFFFFFFFu - (0xFFFFFFFFu % 3u);  // 3 * floor(2^32/3)
  uint64_t ctr = 0;
  int64_t i = 0;
  uint32_t block[16];
  while (i < n) {
    chacha8_block(key, ctr++, nonce, block);
    for (int w = 0; w < 16 && i < n; ++w) {
      const uint32_t v = block[w];
      if (v >= limit) continue;  // rejected draw; next word
      out[i++] = static_cast<int8_t>(v % 3u);
    }
  }
}

}  // extern "C"

// Ternary vector x matrix mod 2^32: codes[k] in {0:zero, 1:+1, 2:-1}
// (client query path; replaces the reference's rayon matmul for s.A / s.M).
void ternary_matvec(const int8_t* codes, const uint32_t* mat, int64_t k,
                    int64_t m, uint32_t* out) {
  std::memset(out, 0, static_cast<size_t>(m) * 4);
  for (int64_t r = 0; r < k; ++r) {
    const int8_t c = codes[r];
    if (c == 0) continue;
    const uint32_t* row = mat + r * m;
    if (c == 1) {
      for (int64_t j = 0; j < m; ++j) out[j] += row[j];
    } else {
      for (int64_t j = 0; j < m; ++j) out[j] -= row[j];
    }
  }
}

// Scalar mix256: fold a 4-word hashed key with a 32-byte seed
// (reference: binary_fuse_filter.rs:588-601). The online client calls
// this once per query/response; the Python-int version costs ~70 us.
uint64_t mix256_scalar(const uint64_t* key_words, const uint8_t* seed32) {
  uint64_t seed_words[4];
  std::memcpy(seed_words, seed32, 32);
  uint64_t total = 0;
  for (int j = 0; j < 4; ++j) {
    uint64_t acc = 0;
    for (int w = 0; w < 4; ++w)
      acc = murmur64(acc + murmur64(key_words[j] + seed_words[w]));
    total += acc;
  }
  return total;
}

// Whole client response post-processing in one call (reference:
// client.rs:209-275 + serialization.rs:132-184): decrypt (subtract c,
// round by the query indicator), unmask (murmur), bit-pack the b-bit
// plaintext elements back into bytes, locate the 0x81 boundary and
// validate the zero tail. Returns the kv byte length (digest || value)
// or -1 when the row fails to decode.
int64_t decrypt_decode_row(const uint32_t* resp, const uint32_t* c,
                           int64_t cols, int32_t b, uint64_t h,
                           uint8_t* out) {
  const uint32_t mask = (1u << b) - 1;
  const uint32_t delta = static_cast<uint32_t>((1ull << 32) >> b);
  const uint32_t half = delta / 2;
  // decrypt + unmask + bit-pack in one pass
  uint64_t acc = 0;
  int nbits = 0;
  int64_t nbytes = 0;
  const int64_t total_bytes = (cols * b) / 8;  // whole bytes only
  for (int64_t e = 0; e < cols; ++e) {
    const uint32_t unscaled = resp[e] - c[e];
    uint32_t rounded = unscaled / delta + ((unscaled % delta) > half ? 1u : 0u);
    const uint32_t plain =
        ((rounded & mask) + static_cast<uint32_t>(
                                murmur64(h + static_cast<uint64_t>(e)))) & mask;
    acc |= static_cast<uint64_t>(plain) << nbits;
    nbits += b;
    while (nbits >= 8 && nbytes < total_bytes) {
      out[nbytes++] = static_cast<uint8_t>(acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
  // find last 0x81 with an all-zero tail; need > 32 bytes before it
  int64_t boundary = -1;
  for (int64_t i = total_bytes - 1; i >= 0; --i) {
    if (out[i] == 0x81) { boundary = i; break; }
    if (out[i] != 0) return -1;
  }
  if (boundary <= 32) return -1;
  return boundary;
}

// Entire client response handling in ONE call (reference:
// client.rs:209-275): hash the key, fold with the filter seed, decrypt
// and decode the row, verify the 32-byte digest prefix. Returns the
// value length (out holds digest || value), -1 when the row fails to
// decode, -2 when the digest prefix mismatches. One ctypes crossing
// instead of four keeps the per-response cost in the tens of
// microseconds.
int64_t client_process_response(const uint8_t* key, int64_t key_len,
                                const uint8_t* filter_seed32,
                                const uint32_t* resp, const uint32_t* c,
                                int64_t cols, int32_t b, uint8_t* out) {
  uint8_t digest[32];
  Xof x;
  xof_init(&x, key, key_len);
  xof_squeeze(&x, digest, 32);
  uint64_t key_words[4];
  std::memcpy(key_words, digest, 32);
  const uint64_t fused = mix256_scalar(key_words, filter_seed32);
  const int64_t n = decrypt_decode_row(resp, c, cols, b, fused, out);
  if (n < 0) return -1;
  if (n < 32 || std::memcmp(out, digest, 32) != 0) return -2;
  return n - 32;
}

// Wire-level variant of client_process_response: takes the serialized
// response (matrix wire format, matrix_io: rows:u32 LE || cols:u32 LE ||
// elements) so the Python layer does no parsing at all — one native call
// per response with zero numpy work on the hot path. Returns the value
// length, -1 (row not decodable), -2 (digest prefix mismatch), or
// -3 (malformed/mis-shaped response vector; the caller must keep the
// pending query in that case, mirroring client.rs:210-217).
int64_t client_process_response_wire(const uint8_t* key, int64_t key_len,
                                     const uint8_t* filter_seed32,
                                     const uint8_t* resp_bytes,
                                     int64_t resp_len, const uint32_t* c,
                                     int64_t cols, int32_t b, uint8_t* out) {
  if (resp_len != 8 + 4 * cols) return -3;
  uint32_t rows_field, cols_field;
  std::memcpy(&rows_field, resp_bytes, 4);
  std::memcpy(&cols_field, resp_bytes + 4, 4);
  if (rows_field != 1 || cols_field != static_cast<uint32_t>(cols)) return -3;
  // CPython bytes payloads are 8-aligned, so +8 keeps u32 alignment
  const uint32_t* resp = reinterpret_cast<const uint32_t*>(resp_bytes + 8);
  return client_process_response(key, key_len, filter_seed32, resp, c, cols,
                                 b, out);
}

// murmur64(h + col) & mask for a whole row (response unmask path).
void mix_row_mask(uint64_t h, int64_t cols, uint32_t mask, uint32_t* out) {
  for (int64_t c = 0; c < cols; ++c)
    out[c] = static_cast<uint32_t>(murmur64(h + static_cast<uint64_t>(c))) & mask;
}

// Single-pass build of the Pallas respond layout (ops/respond_pallas.py):
// biased low-byte plane plus the block-interleaved bit-packed high plane.
// Replaces several GB-scale numpy passes with one streaming read of D.
// mat: (m, c) u32; lo: (m_pad, c_pad) i8 zero-initialised; hi: packed
// plane (m_pad, pc) u8 zero-initialised or null when hi_bits == 0.
void build_packed_planes(const uint32_t* mat, int64_t m, int64_t c,
                         int64_t m_pad, int64_t c_pad, int8_t* lo,
                         uint8_t* hi, int32_t pack, int32_t bits) {
  (void)m_pad;
  pack_planes_impl(mat, m, c, /*lo_stride=*/c_pad, c_pad, lo, hi, pack, bits);
}

// Pre-populated anonymous mappings for GB-scale buffers. On this class of
// VM, demand paging from user space costs ~20 us per 4 KB page (~0.2 GB/s
// of "first touch"); MAP_POPULATE faults the range inside one syscall,
// ~3-4x faster, and writes afterwards run at full DRAM speed.
void* pir_alloc_populated(int64_t nbytes) {
  void* p = mmap(nullptr, static_cast<size_t>(nbytes), PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
  return p == MAP_FAILED ? nullptr : p;
}

#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif

// Variant for buffers whose fill must stay fast in a LONG-LIVED process:
// late in a jax serving process, plain populate/first-touch of GB-scale
// ranges degrades by an order of magnitude (measured: a 2^22 encode's
// 8.5 GB first-touch fill burned ~190 s of worker CPU at +8 min process
// age vs ~25 s in a fresh process; huge-page direct compaction on a
// fragmented heap is the prime suspect). MADV_NOHUGEPAGE opts the range
// out of transparent-huge-page machinery entirely, and
// MADV_POPULATE_WRITE (kernel 5.14+) fills 4 KB pages in-kernel without
// the per-fault user/kernel round trip; falls back to MAP_POPULATE
// semantics via a manual touch loop on older kernels.
void* pir_alloc_populated_nothp(int64_t nbytes) {
  void* p = mmap(nullptr, static_cast<size_t>(nbytes), PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return nullptr;
  madvise(p, static_cast<size_t>(nbytes), MADV_NOHUGEPAGE);
  if (madvise(p, static_cast<size_t>(nbytes), MADV_POPULATE_WRITE) != 0) {
    volatile uint8_t* b = static_cast<volatile uint8_t*>(p);
    for (int64_t off = 0; off < nbytes; off += 4096) b[off] = 0;
  }
  return p;
}

// Huge-page variant: MADV_HUGEPAGE + populate = 512x fewer page-table
// events per byte — kept ONLY as a probe target. MEASURED VERDICT on
// this VM class: 2 GB populated in 239 s (vs 0.32 s for the nothp
// variant) — direct compaction here is pathological, so this path must
// never be a default. The motivating observation stands (late in a
// long-lived jax process a 4 KB fault can cost tens of us of sys time
// vs ~1.2 us fresh), but the fix has to come from somewhere other than
// huge mappings.
void* pir_alloc_populated_huge(int64_t nbytes) {
  void* p = mmap(nullptr, static_cast<size_t>(nbytes), PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return nullptr;
#ifdef MADV_HUGEPAGE
  madvise(p, static_cast<size_t>(nbytes), MADV_HUGEPAGE);
#endif
  if (madvise(p, static_cast<size_t>(nbytes), MADV_POPULATE_WRITE) != 0) {
    volatile uint8_t* b = static_cast<volatile uint8_t*>(p);
    for (int64_t off = 0; off < nbytes; off += 4096) b[off] = 0;
  }
  return p;
}

void pir_free_populated(void* p, int64_t nbytes) {
  if (p != nullptr) munmap(p, static_cast<size_t>(nbytes));
}

// Acquire-ordered read of one streaming-encode progress slot: pairs with
// the __ATOMIC_RELEASE increments in encode_assemble_rows16_ordered so
// the consumer's subsequent reads of that chunk's rows are ordered after
// the worker's row stores. A plain numpy load is enough on x86 (TSO)
// but NOT on weakly-ordered hosts (aarch64), where the consumer could
// see the count before the rows and pack a stale chunk.
int64_t progress_load_acquire(const int64_t* progress, int64_t idx) {
  return __atomic_load_n(&progress[idx], __ATOMIC_ACQUIRE);
}

}  // extern "C"
