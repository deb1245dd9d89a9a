// The enclave executor: fused decrypt -> static operator -> re-encrypt.
// One kernel template, three coordinate modes.
//
// ss_enclave_map_window replaces
// repro/kernels/enclave_map/enclave_map.py::_enclave_rows_kernel
// (pallas_call in enclave_apply_rows) together with the operand glue
// around it in the window engine's enclave hop
// (repro/core/enclave.py::run_static_window): it reads the window's (B, n)
// ciphertext words as they are, a shared (8,) or per-item (B, 8) key on
// each side and (B, 3) inbound and outbound nonces (which may be one
// array), runs item b's payload block j at counter j + 1, computed here,
// and writes the (B, n) output in the same layout.  No padded copy and no
// per-row key, nonce or counter rows exist.  A ragged tail (n % 16 != 0)
// is decrypted as the reference pads it, with absent words as ciphertext
// 0: they decrypt to their keystream words, the op sees those (the delay
// filter decides on word 1, which can be one), and they are not stored.
// ss_enclave_map_blocks replaces _enclave_kernel (pallas_call in
// enclave_apply): one chunk under a shared key pair and nonce, block i at
// counter counter0 + i (u32 wrap), the same nonce and counter in and out
// -- the enclave hop of the per-chunk oracle engine and the paper's
// chunk-copy experiment (Fig. 4).  ss_enclave_map_rows (per-row keys,
// nonces and counters in and out) is the same kernel with general
// coordinates, kept callable for the checks.
//
// The paper's SGX enclave became a VMEM-resident Pallas kernel on the TPU;
// here it is a kernel whose plaintext lives only in registers: only
// ciphertext is loaded from or stored to device memory.  A register spill
// would put plaintext in local memory, which is device memory, so the
// build must report 0 bytes of spill stores for every instance of this
// kernel (-Xptxas -v, checked by chip_smoke.py).
//
// Bound on an H100 SXM: integer operations.  A block costs two ChaCha20
// blocks (~2000 int32 operations) for 64 B in + 64 B out: ~16 operations
// per byte against the ~10 per byte at which 33.5 T int32 operations/s
// and 3.35 TB/s balance.  The main paths' calls are small: a window's hop
// (8 items x 1024 blocks) is ~0.5 us of integer work, a 64 KB chunk
// (1024 blocks) ~60 ns; each is bound by the launch and by one thread's
// chain of ~1,000 dependent-ish integer operations a keystream, not by
// the card's rates.  Only the chunk-copy experiment's 100 MB in one call
// (~0.1 ms of integer work) reaches the operations bound.
//
// Design: a lane pair a 64-byte block.  The two keystreams depend only on
// (key, nonce, counter), never on the data or on each other, so the even
// lane computes the inbound one and the odd lane the outbound one, in the
// same instructions; the odd lane then hands its keystream (never the
// plaintext) to the even lane by __shfl_down_sync, and the even lane
// decrypts, applies the op and re-encrypts.  The chain a call waits on is
// one keystream, not two in series (one thread interleaving both: see
// csrc/probes/enclave_map_probes.cu and PERF.md).  Each lane loads its
// key and nonce first; in a call within one wave the even lane's payload
// loads go out right behind them, before the rounds, so their latency
// hides under the rounds; a call of many waves loads after the rounds.
// The CTA is sized per call (ss::cta_threads) so that a call spreads over
// about two CTAs an SM before any CTA grows.  Words that are 16-byte
// aligned (n % 4 == 0 and aligned tensors) move as 16-byte vectors,
// others word by word.  The operator is a template parameter over the six
// static ops (the reference's static `op`).  The float ops reproduce the
// reference's bits exactly as its CPU backend computes them, spelled out
// on bit patterns so that no compiler flag decides them (see
// enclave_map.py): denormal inputs read as signed zero; a product whose
// exact value (a double holds it exactly) is below 2^-126 flushes to
// signed zero before rounding; NaN propagation follows x86 mulss.
#include <cuda_runtime.h>

#include <cstdint>

#include "chacha_core.cuh"

namespace {

// About one wave of this kernel on an H100 (132 SMs x ~1,024 resident
// threads): a call of at most this many threads is bound by one thread's
// latency, a larger one by the card's throughput.
constexpr long long kOneWave = 132 * 1024;

enum Op { kIdentity = 0, kScale, kRelu, kSquare, kThreshold, kDelay };

__device__ __forceinline__ bool is_nan(uint32_t b) {
  return (b & 0x7FFFFFFFu) > 0x7F800000u;
}

__device__ __forceinline__ float daz(uint32_t b) {
  return __uint_as_float((b & 0x7F800000u) == 0 ? (b & 0x80000000u) : b);
}

// f32 a * b on bit patterns under DAZ + FTZ-before-rounding
__device__ __forceinline__ uint32_t mul_ftz(uint32_t a, uint32_t b) {
  if (is_nan(b)) return b | 0x00400000u;
  if (is_nan(a)) return a | 0x00400000u;
  const double p = (double)daz(a) * (double)daz(b);   // exact
  if (p != p) return 0xFFC00000u;                     // 0 x inf
  if (fabs(p) < 0x1p-126) return signbit(p) ? 0x80000000u : 0u;
  return __float_as_uint(__double2float_rn(p));
}

template <int OP>
__device__ __forceinline__ void apply(uint32_t x[16], uint32_t cbits,
                                      int ci) {
  if (OP == kDelay) {
    const bool keep = (int32_t)x[1] > ci;
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = keep ? x[i] : 0u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t v = x[i];
    if (OP == kScale) x[i] = mul_ftz(v, cbits);
    if (OP == kSquare) x[i] = mul_ftz(v, v);
    if (OP == kRelu) x[i] = (is_nan(v) || daz(v) > 0.0f) ? v : 0u;
    if (OP == kThreshold) x[i] = daz(v) > daz(cbits) ? v : 0u;
  }
}

// One side of a 64-byte block: the keystream coordinates of one lane of
// its pair (inbound or outbound) and where the block's words are.
struct Lane {
  const uint32_t* key;     // 8 words
  const uint32_t* nonce;   // 3 words
  uint32_t ctr;
  const uint32_t* src;     // ciphertext words in
  uint32_t* dst;           // ciphertext words out
  int words;               // words of the block, 0..16
};

// ss_enclave_map_rows: row r under (kin[r * kin_stride], nonces[r],
// counters[r]) in and (kout[r * kout_stride], nonces_out[r],
// counters_out[r]) out.
struct Rows {
  const uint32_t* kin;
  int kin_stride;
  const uint32_t* kout;
  int kout_stride;
  const uint32_t* nonces;
  const uint32_t* counters;
  const uint32_t* nonces_out;
  const uint32_t* counters_out;
  const uint32_t* data;
  uint32_t* out;
  __device__ Lane at(long long r, bool outbound) const {
    return {outbound ? kout + r * kout_stride : kin + r * kin_stride,
            (outbound ? nonces_out : nonces) + 3 * r,
            __ldg((outbound ? counters_out : counters) + r),
            data + 16 * r, out + 16 * r, 16};
  }
};

// ss_enclave_map_blocks: block r under one key pair and nonce at counter0
// + r, the same both ways.
struct Blocks {
  const uint32_t* kin;
  const uint32_t* kout;
  const uint32_t* nonce;
  uint32_t counter0;
  const uint32_t* data;
  uint32_t* out;
  __device__ Lane at(long long r, bool outbound) const {
    return {outbound ? kout : kin, nonce, counter0 + (uint32_t)r,  // wraps
            data + 16 * r, out + 16 * r, 16};
  }
};

// ss_enclave_map_window: item b's payload block j at counter j + 1 under
// item b's nonces, words 16j .. min(16j + 16, n) - 1 of its row.
struct Items {
  const uint32_t* kin;
  int kin_stride;
  const uint32_t* kout;
  int kout_stride;
  const uint32_t* nonces_in;
  const uint32_t* nonces_out;
  const uint32_t* words;
  uint32_t* out;
  long long n;             // words per item
  uint32_t per_item;       // blocks per item: ceil(n / 16)
  __device__ Lane at(long long p, bool outbound) const {
    const uint32_t b = (uint32_t)p / per_item;   // p < 2^31 (wrapper)
    const uint32_t j = (uint32_t)p - b * per_item;
    const long long w0 = 16LL * j;
    const long long w = (long long)b * n + w0;
    return {outbound ? kout + (long long)b * kout_stride
                     : kin + (long long)b * kin_stride,
            (outbound ? nonces_out : nonces_in) + 3 * b, j + 1,
            words + w, out + w, (int)(n - w0 < 16 ? n - w0 : 16)};
  }
};

// Thread 2p computes block p's inbound keystream and holds its words,
// thread 2p + 1 its outbound keystream (and runs the op on nothing).  kVec: 16-byte aligned words.
// kEarly: the payload loads go out before the rounds (a call within one
// wave); otherwise after them, with 16 registers fewer live through the
// rounds (a call of many waves).
template <class Coords, int OP, bool kVec, bool kEarly>
__global__ void __launch_bounds__(ss::kMaxThreads)
enclave_kernel(Coords c, long long count, uint32_t cbits, int ci) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = t >> 1;
  const bool outbound = t & 1;
  // a pair is live or dead as a whole, and never straddles a warp
  const bool live = p < count;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, live);
  if (!live) return;
  const Lane ln = c.at(p, outbound);
  // the odd lane moves no words: its loads and stores are predicated off
  // (no branch, so the pair stays converged)
  const int words = outbound ? 0 : ln.words;
  uint32_t k[8], n[3], ks[16], ko[16], x[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(ln.key + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = __ldg(ln.nonce + i);
  if (kEarly) ss::load_words<kVec>(ln.src, words, x);
  ss::block(k, ln.ctr, n, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) ko[i] = __shfl_down_sync(mask, ks[i], 1);
  if (!kEarly) ss::load_words<kVec>(ln.src, words, x);
  // ---- decrypt (plaintext exists only from here ...)
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  // ---- the enclaved operator
  apply<OP>(x, cbits, ci);
  // ---- re-encrypt (... to here — never stored to device memory)
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ko[i];
  ss::store_words<kVec>(ln.dst, words, x);
}

template <class Coords, int OP, bool kVec>
void launch_op(const Coords& c, long long count, uint32_t cbits, int ci,
               cudaStream_t s) {
  const long long threads = 2 * count;
  const int t = ss::cta_threads(threads);
  const unsigned grid = (unsigned)((threads + t - 1) / t);
  if (threads <= kOneWave)
    enclave_kernel<Coords, OP, kVec, true><<<grid, t, 0, s>>>(
        c, count, cbits, ci);
  else
    enclave_kernel<Coords, OP, kVec, false><<<grid, t, 0, s>>>(
        c, count, cbits, ci);
}

template <class Coords, bool kVec>
int launch(int op, const Coords& c, long long count, uint32_t cbits, int ci,
           void* stream) {
  if (count <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kIdentity: launch_op<Coords, kIdentity, kVec>(c, count, cbits, ci, s);
      break;
    case kScale: launch_op<Coords, kScale, kVec>(c, count, cbits, ci, s);
      break;
    case kRelu: launch_op<Coords, kRelu, kVec>(c, count, cbits, ci, s);
      break;
    case kSquare: launch_op<Coords, kSquare, kVec>(c, count, cbits, ci, s);
      break;
    case kThreshold:
      launch_op<Coords, kThreshold, kVec>(c, count, cbits, ci, s);
      break;
    case kDelay: launch_op<Coords, kDelay, kVec>(c, count, cbits, ci, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// kin/kout: (8,) shared (stride 0) or (B, 8) per item (stride 8);
// nonces_in, nonces_out: (B, 3), may be the same array; words, out: (B, n)
// contiguous.  B * ceil(n / 16) < 2^30.
extern "C" int ss_enclave_map_window(int op, const void* kin, int kin_stride,
                                     const void* kout, int kout_stride,
                                     const void* nonces_in,
                                     const void* nonces_out,
                                     const void* words, void* out,
                                     long long B, long long n,
                                     uint32_t cbits, int ci, void* stream) {
  const Items c{(const uint32_t*)kin, kin_stride, (const uint32_t*)kout,
                kout_stride, (const uint32_t*)nonces_in,
                (const uint32_t*)nonces_out, (const uint32_t*)words,
                (uint32_t*)out, n, (uint32_t)((n + 15) / 16)};
  const long long count = B * c.per_item;
  return n % 4 == 0 && aligned16(words) && aligned16(out)
             ? launch<Items, true>(op, c, count, cbits, ci, stream)
             : launch<Items, false>(op, c, count, cbits, ci, stream);
}

extern "C" int ss_enclave_map_rows(int op, const void* kin, int kin_stride,
                                   const void* kout, int kout_stride,
                                   const void* nonces, const void* counters,
                                   const void* nonces_out,
                                   const void* counters_out,
                                   const void* data, void* out, long long R,
                                   uint32_t cbits, int ci, void* stream) {
  const Rows c{(const uint32_t*)kin, kin_stride, (const uint32_t*)kout,
               kout_stride, (const uint32_t*)nonces,
               (const uint32_t*)counters, (const uint32_t*)nonces_out,
               (const uint32_t*)counters_out, (const uint32_t*)data,
               (uint32_t*)out};
  return launch<Rows, true>(op, c, R, cbits, ci, stream);
}

extern "C" int ss_enclave_map_blocks(int op, const void* kin, const void* kout,
                                     const void* nonce, uint32_t counter0,
                                     const void* data, void* out, long long N,
                                     uint32_t cbits, int ci, void* stream) {
  const Blocks c{(const uint32_t*)kin, (const uint32_t*)kout,
                 (const uint32_t*)nonce, counter0, (const uint32_t*)data,
                 (uint32_t*)out};
  return launch<Blocks, true>(op, c, N, cbits, ci, stream);
}
