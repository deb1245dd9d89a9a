// ChaCha20 keystream XOR over rows with per-row (key, nonce, counter).
//
// Replaces: repro/kernels/chacha20/chacha20.py::_chacha_rows_kernel
// (pallas_call in chacha20_xor_rows), behind every batched AEAD seal and
// open and, here, the batched MAC-key derivation.
//
// Bound on an H100 SXM: integer operations, narrowly.  A row moves 64 B in
// + 64 B out + 16 B of nonce and counter (a shared key is read once) and
// costs 992 32-bit adds, xors and rotates: ~7 operations per byte, above
// the ~5 per byte at which 16.7 T int32 operations/s (132 SMs x 64 INT32
// lanes x 1.98 GHz) and 3.35 TB/s balance.  At the main path's shape (8
// chunks x 1025 rows of a 64 KB chunk) that is ~0.5 us of integer work
// against ~0.35 us of traffic: launch latency dominates either.
//
// Design: one thread per row; the state stays in registers and the rounds
// are unrolled (chacha_core.cuh); a row loads and stores as four 16-byte
// vectors; a shared (8,) key is passed with row stride 0 instead of being
// materialised per row.  The grid is R rounded up to a block and the tail
// is masked, so the caller never pads.
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

extern "C" const char* ss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
