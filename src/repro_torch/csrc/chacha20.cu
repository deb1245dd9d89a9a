// ChaCha20 keystream XOR: per-row coordinates (the window engine) and a
// shared key and nonce over consecutive counters (the per-chunk engine).
//
// ss_chacha20_xor_rows replaces
// repro/kernels/chacha20/chacha20.py::_chacha_rows_kernel (pallas_call in
// chacha20_xor_rows), behind every batched AEAD seal and open and, here,
// the batched MAC-key derivation.  ss_chacha20_xor_blocks replaces
// _chacha_kernel (pallas_call in chacha20_xor_blocks): the scalar AEAD
// seal/open and MAC-key derivation of the per-chunk oracle engine.
//
// Bound on an H100 SXM: memory traffic, narrowly.  A row moves 64 B in +
// 64 B out + 16 B of nonce and counter (a shared key is read once) and
// costs 992 32-bit adds, xors and rotates: ~7 operations per byte, under
// the ~10 per byte at which 33.5 T int32 operations/s (132 SMs x 128
// issue lanes x 1.98 GHz, with nvcc's IMADs on the FP32 lanes) and 3.35
// TB/s balance.  At the main path's shape (8 chunks x 1025 rows of a 64
// KB chunk) that is ~0.35 us of traffic against ~0.25 us of integer work:
// launch latency dominates either.  The blocks entry reads no per-row
// coordinates at all (128 B per block): one 64 KB chunk (1025 blocks) is
// ~40 ns of traffic, so it too is launch-bound; only a payload of many
// MB (100 MB: ~63 us of traffic against ~49 us of integer work) is not.
// The SASS mix (chip_smoke.py phase 1) sets a tighter limit: nvcc issues
// the adds as IMAD on the FP32 lanes, but the xors and rotates (672 ALU
// instructions a thread) share the 64 INT32 lanes of an SM, ~66 us at
// 100 MB.
//
// Design: one thread per 64-byte block; the state stays in registers and
// the rounds are unrolled (chacha_core.cuh); a block loads and stores as
// four 16-byte vectors; a shared (8,) key is passed with row stride 0
// instead of being materialised per row.  The blocks entry computes its
// counter as counter0 + block index in uint32_t, so it wraps exactly as
// the reference's u32 add does and no counter array exists.  The grid is
// the row count rounded up to a block and the tail is masked, so the
// caller never pads.
#include <cuda_runtime.h>

#include "chacha_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
chacha20_xor_rows_kernel(const uint32_t* __restrict__ keys, int key_stride,
                         const uint32_t* __restrict__ nonces,
                         const uint32_t* __restrict__ counters,
                         const uint4* __restrict__ data,
                         uint4* __restrict__ out, long long R) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  uint32_t k[8], n[3], ctr, ks[16], x[16];
  ss::load_coords(keys, key_stride, nonces, counters, r, k, n, ctr);
  ss::block(k, ctr, n, ks);
  ss::load_row(data, r, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  ss::store_row(out, r, x);
}

__global__ void __launch_bounds__(kThreads)
chacha20_xor_blocks_kernel(const uint32_t* __restrict__ key,
                           const uint32_t* __restrict__ nonce,
                           uint32_t counter0, const uint4* __restrict__ data,
                           uint4* __restrict__ out, long long N) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint32_t k[8], n[3], ks[16], x[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = key[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = nonce[i];
  ss::block(k, counter0 + (uint32_t)r, n, ks);   // u32 wrap, as reference
  ss::load_row(data, r, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  ss::store_row(out, r, x);
}

}  // namespace

extern "C" int ss_chacha20_xor_rows(const void* keys, int key_stride,
                                    const void* nonces, const void* counters,
                                    const void* data, void* out, long long R,
                                    void* stream) {
  if (R <= 0) return 0;
  long long blocks = (R + kThreads - 1) / kThreads;
  chacha20_xor_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)keys, key_stride, (const uint32_t*)nonces,
      (const uint32_t*)counters, (const uint4*)data, (uint4*)out, R);
  return (int)cudaGetLastError();
}

extern "C" int ss_chacha20_xor_blocks(const void* key, const void* nonce,
                                      uint32_t counter0, const void* data,
                                      void* out, long long N, void* stream) {
  if (N <= 0) return 0;
  long long blocks = (N + kThreads - 1) / kThreads;
  chacha20_xor_blocks_kernel<<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint32_t*)nonce, counter0,
      (const uint4*)data, (uint4*)out, N);
  return (int)cudaGetLastError();
}

extern "C" const char* ss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
