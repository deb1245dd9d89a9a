// ChaCha20 keystream XOR: the AEAD's cipher pass, plus the per-row and
// shared-key block entries.  One kernel template, three coordinate modes.
//
// ss_chacha20_cipher_pass is every cipher pass of the AEAD in one launch:
// batched seal/open and MAC-key derivation (the window engine) replace
// repro/kernels/chacha20/chacha20.py::_chacha_rows_kernel (pallas_call in
// chacha20_xor_rows); scalar seal/open and derive_mac_keys (the per-chunk
// engine, serving) replace _chacha_kernel (pallas_call in
// chacha20_xor_blocks), as the same entry at B = 1 with a shared key.
// Item b's keystream block j runs at counter j (u32), computed here:
// block 0 is the MAC-key block, whose thread writes the reference's
// _clamp, min(w & 0x7FFFFFFF, 0x7FFFFFFE), of words 0-3 into mac_keys[b]
// and reads no payload; blocks 1..N XOR words 16(j-1) .. min(16j, n) - 1
// of item b's row of the caller's (B, n) payload into the (B, n)
// ciphertext, the ragged tail masked.  So the pass reads the caller's
// tensors as they are: no padded copy, no zero block, no counter, nonce
// or key rows exist, and n = 0 is the MAC-key derivation alone.  The
// reference built those operands around its Pallas call inside one jitted
// program; eagerly they were ~5-7 glue kernels and ~10 host ops a call.
//
// ss_chacha20_xor_rows (per-row key, nonce and counter) and
// ss_chacha20_xor_blocks (counter0 + block index, u32 wrap) are the same
// kernel with general coordinates, kept callable for the checks.
//
// Bound on an H100 SXM: memory traffic, narrowly, when the call is large.
// A block moves 64 B in + 64 B out and costs 992 32-bit adds, xors and
// rotates: ~7.8 operations per byte, under the ~10 per byte at which 33.5
// T int32 operations/s (132 SMs x 128 issue lanes x 1.98 GHz, with nvcc's
// IMADs on the FP32 lanes) and 3.35 TB/s balance.  The main path's calls
// are small: a window's seal or open (8 items x 16,384 words: 8,200
// blocks) is ~0.31 us of traffic and ~0.24 us of integer work, a 64 KB
// chunk's (1,025 blocks) ~40 ns, a derivation (8 blocks) nothing: each is
// bound by the launch and by one thread's chain of ~1,000 dependent-ish
// integer operations (~0.5 us), not by the card's rates.  Only a payload
// of many MB (100 MB: ~63 us of traffic) reaches the bytes bound.
//
// Design: one thread per 64-byte block (4 lanes a block, one column each
// with the diagonals by __shfl_sync, lengthen that chain: see
// csrc/probes/chacha20_probes.cu and PERF.md); the state stays in
// registers and the rounds are unrolled (chacha_core.cuh).  A thread
// loads its key and nonce first; in a call within one wave (every call of
// the main paths) its payload loads go out right behind them, before the
// rounds, so their latency hides under the rounds; a call of many waves
// loads the payload after the rounds, where the 16 words held through
// them would cost occupancy (chip_smoke.py times both placements).  A
// shared key is read once per CTA into shared memory.  Loads and stores
// name the global space.  Rows whose words are 16-byte aligned (n % 4 ==
// 0 and an aligned payload) load and store 16-byte vectors; others go
// word by word.  The CTA is sized per call (128 threads down to 32) so
// that a call spreads over about two CTAs an SM before any CTA grows: a
// chunk's 1,025 blocks take 33 SMs, a window's 8,200 all 132.
#include <cuda_runtime.h>

#include "chacha_core.cuh"

namespace {

// About one wave of this kernel on an H100 (132 SMs x ~1,024 resident
// threads at 40-48 registers): a call of at most this many blocks is
// bound by one thread's latency, a larger one by the card's throughput.
constexpr long long kOneWave = 132 * 1024;

// One thread's 64-byte block: its coordinates and where its words are.
struct Block {
  const uint32_t* key;     // 8 words (not read when the key is shared)
  const uint32_t* nonce;   // 3 words
  uint32_t ctr;
  const uint32_t* src;     // payload words; null for a MAC-key block
  uint32_t* dst;           // ciphertext words, or the 4 MAC-key words
  int words;               // payload words of the block, 0..16
};

// ss_chacha20_xor_rows: row r under keys[r * key_stride], nonces[r],
// counters[r].
struct Rows {
  const uint32_t* keys;
  int key_stride;
  const uint32_t* nonces;
  const uint32_t* counters;
  const uint32_t* data;
  uint32_t* out;
  __device__ Block at(long long r) const {
    return {keys + r * key_stride, nonces + 3 * r, __ldg(counters + r),
            data + 16 * r, out + 16 * r, 16};
  }
};

// ss_chacha20_xor_blocks: block r under one key and nonce at counter0 + r.
struct Blocks {
  const uint32_t* nonce;
  uint32_t counter0;
  const uint32_t* data;
  uint32_t* out;
  __device__ Block at(long long r) const {
    return {nullptr, nonce, counter0 + (uint32_t)r,   // u32 wrap
            data + 16 * r, out + 16 * r, 16};
  }
};

// ss_chacha20_cipher_pass: item b's block j at counter j; block 0 writes
// the item's MAC keys.
struct Items {
  const uint32_t* keys;
  int key_stride;
  const uint32_t* nonces;
  const uint32_t* payload;
  uint32_t* ct;
  uint32_t* mac_keys;
  long long n;             // payload words per item
  uint32_t per_item;       // blocks per item: 1 + ceil(n / 16)
  __device__ Block at(long long t) const {
    const uint32_t b = (uint32_t)t / per_item;   // t < 2^31 (wrapper)
    const uint32_t j = (uint32_t)t - b * per_item;
    const uint32_t* key = keys + (long long)b * key_stride;
    if (j == 0) return {key, nonces + 3 * b, 0u, nullptr, mac_keys + 4 * b,
                        0};
    const long long w0 = 16LL * (j - 1);
    const long long w = (long long)b * n + w0;
    return {key, nonces + 3 * b, j, payload + w, ct + w,
            (int)(n - w0 < 16 ? n - w0 : 16)};
  }
};

__device__ __forceinline__ uint32_t clamp31(uint32_t w) {
  return min(w & 0x7FFFFFFFu, 0x7FFFFFFEu);
}

// kShared: one key for every block, read once per CTA into shared memory
// (shared_key); otherwise each block's own key words.  kVec: 16-byte
// aligned words.  kEarly: the payload loads go out before the rounds (a
// call within one wave); otherwise after them, which keeps 8 registers
// fewer live through the rounds (a call of many waves).
template <class Coords, bool kVec, bool kShared, bool kEarly>
__global__ void __launch_bounds__(ss::kMaxThreads)
chacha20_kernel(Coords c, const uint32_t* __restrict__ shared_key,
                long long count) {
  __shared__ uint32_t skey[8];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < count;
  uint32_t k[8], n[3], x[16], ks[16];
  Block blk{};
  if (live) {             // the rounds' inputs first
    blk = c.at(t);
    if (!kShared) {
#pragma unroll
      for (int i = 0; i < 8; ++i) k[i] = __ldg(blk.key + i);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) n[i] = __ldg(blk.nonce + i);
    if (kEarly) ss::load_words<kVec>(blk.src, blk.words, x);
  }
  if (kShared) {
    if (threadIdx.x < 8) skey[threadIdx.x] = __ldg(shared_key + threadIdx.x);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = skey[i];
  }
  if (!live) return;
  ss::block(k, blk.ctr, n, ks);
  if (blk.src == nullptr) {          // the MAC-key block of an item
    __stwb(reinterpret_cast<uint4*>(blk.dst), make_uint4(
        clamp31(ks[0]), clamp31(ks[1]), clamp31(ks[2]), clamp31(ks[3])));
    return;
  }
  if (!kEarly) ss::load_words<kVec>(blk.src, blk.words, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  ss::store_words<kVec>(blk.dst, blk.words, x);
}

template <class Coords, bool kVec, bool kShared>
int launch(const Coords& c, const void* shared_key, long long count,
           void* stream) {
  if (count <= 0) return 0;
  const int t = ss::cta_threads(count);
  const unsigned grid = (unsigned)((count + t - 1) / t);
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* key = (const uint32_t*)shared_key;
  if (count <= kOneWave)
    chacha20_kernel<Coords, kVec, kShared, true><<<grid, t, 0, s>>>(
        c, key, count);
  else
    chacha20_kernel<Coords, kVec, kShared, false><<<grid, t, 0, s>>>(
        c, key, count);
  return (int)cudaGetLastError();
}

}  // namespace

// key: (8,) shared (key_stride 0) or (B, 8) per item (key_stride 8);
// nonces (B, 3); payload (B, n) or null when n = 0; vec: payload rows
// 16-byte aligned (n % 4 == 0 and an aligned base); ct (B, n); mac_keys
// (B, 4), 16-byte aligned.  B * (1 + ceil(n / 16)) < 2^31 (one grid.x);
// the largest pass of any path, a sealed llama3.2-1b checkpoint of ~151k
// rows x 4,096 words, is 3.9e7 blocks.
extern "C" int ss_chacha20_cipher_pass(const void* key, int key_stride,
                                       const void* nonces,
                                       const void* payload, int vec, void* ct,
                                       void* mac_keys, long long B,
                                       long long n, void* stream) {
  const Items c{(const uint32_t*)key, key_stride, (const uint32_t*)nonces,
                (const uint32_t*)payload, (uint32_t*)ct,
                (uint32_t*)mac_keys, n, (uint32_t)(1 + (n + 15) / 16)};
  const long long count = B * c.per_item;
  if (key_stride == 0)
    return vec ? launch<Items, true, true>(c, key, count, stream)
               : launch<Items, false, true>(c, key, count, stream);
  return vec ? launch<Items, true, false>(c, nullptr, count, stream)
             : launch<Items, false, false>(c, nullptr, count, stream);
}

extern "C" int ss_chacha20_xor_rows(const void* keys, int key_stride,
                                    const void* nonces, const void* counters,
                                    const void* data, void* out, long long R,
                                    void* stream) {
  const Rows c{(const uint32_t*)keys, key_stride, (const uint32_t*)nonces,
               (const uint32_t*)counters, (const uint32_t*)data,
               (uint32_t*)out};
  return key_stride == 0 ? launch<Rows, true, true>(c, keys, R, stream)
                         : launch<Rows, true, false>(c, nullptr, R, stream);
}

extern "C" int ss_chacha20_xor_blocks(const void* key, const void* nonce,
                                      uint32_t counter0, const void* data,
                                      void* out, long long N, void* stream) {
  const Blocks c{(const uint32_t*)nonce, counter0, (const uint32_t*)data,
                 (uint32_t*)out};
  return launch<Blocks, true, true>(c, key, N, stream);
}

extern "C" const char* ss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
