// ChaCha20 block function shared by the cipher and enclave-map kernels.
//
// Replaces the round function of the reference's Pallas kernels
// (repro/kernels/chacha20/common.py::keystream_vectors).  One thread owns
// one 64-byte block: the 16-word state lives in registers, the 10
// double-rounds are fully unrolled, and every rotate is one funnel shift.
#pragma once

#include <cstdint>

namespace ss {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b,
                                        uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// ks = ChaCha20(key, counter, nonce) — RFC 7539 §2.3, with the
// feed-forward of the initial state.
__device__ __forceinline__ void block(const uint32_t k[8], uint32_t ctr,
                                      const uint32_t n[3], uint32_t ks[16]) {
  uint32_t x0 = 0x61707865u, x1 = 0x3320646eu, x2 = 0x79622d32u,
           x3 = 0x6b206574u;
  uint32_t x4 = k[0], x5 = k[1], x6 = k[2], x7 = k[3];
  uint32_t x8 = k[4], x9 = k[5], x10 = k[6], x11 = k[7];
  uint32_t x12 = ctr, x13 = n[0], x14 = n[1], x15 = n[2];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    quarter(x0, x4, x8, x12);
    quarter(x1, x5, x9, x13);
    quarter(x2, x6, x10, x14);
    quarter(x3, x7, x11, x15);
    quarter(x0, x5, x10, x15);
    quarter(x1, x6, x11, x12);
    quarter(x2, x7, x8, x13);
    quarter(x3, x4, x9, x14);
  }
  ks[0] = x0 + 0x61707865u;  ks[1] = x1 + 0x3320646eu;
  ks[2] = x2 + 0x79622d32u;  ks[3] = x3 + 0x6b206574u;
  ks[4] = x4 + k[0];   ks[5] = x5 + k[1];   ks[6] = x6 + k[2];
  ks[7] = x7 + k[3];   ks[8] = x8 + k[4];   ks[9] = x9 + k[5];
  ks[10] = x10 + k[6]; ks[11] = x11 + k[7]; ks[12] = x12 + ctr;
  ks[13] = x13 + n[0]; ks[14] = x14 + n[1]; ks[15] = x15 + n[2];
}

// CTA size per call: 128 threads down to 32, so that a call of
// `threads` threads spreads over about two CTAs an SM before any CTA
// grows (a small call takes more SMs, each with fewer warps).
constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr long long kTargetCtas = 2 * 132;   // two CTAs on each H100 SM

inline int cta_threads(long long threads) {
  int t = kMaxThreads;
  while (t > kMinThreads && (threads + t - 1) / t < kTargetCtas) t /= 2;
  return t;
}

// The `words` (0..16) words of one 64-byte block into x, absent words 0,
// and back.  kVec: 16-byte aligned words, as uint4 loads and stores.
// Loads and stores name the global space: the pointers reach the kernels
// through structs, whose members nvcc would otherwise access as generic
// addresses (LD/ST, not LDG/STG).  The inputs are read-only for the
// kernel's life.
template <bool kVec>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ src,
                                           int words, uint32_t x[16]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (4 * q < words) v = __ldg(reinterpret_cast<const uint4*>(src) + q);
      x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = i < words ? __ldg(src + i) : 0u;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst,
                                            int words, const uint32_t x[16]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * q < words)
        __stwb(reinterpret_cast<uint4*>(dst) + q, make_uint4(
            x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < words) __stwb(dst + i, x[i]);
  }
}

}  // namespace ss
