// The enclave executor: fused decrypt -> static operator -> re-encrypt.
//
// ss_enclave_map_rows replaces
// repro/kernels/enclave_map/enclave_map.py::_enclave_rows_kernel
// (pallas_call in enclave_apply_rows), the enclave-mode hop of the window
// engine.  ss_enclave_map_blocks replaces _enclave_kernel (pallas_call in
// enclave_apply): one chunk under a shared key pair and nonce, block i at
// counter counter0 + i (u32 wrap), the same nonce and counter in and out
// -- the enclave hop of the per-chunk oracle engine and the paper's
// chunk-copy experiment (Fig. 4).  The paper's SGX enclave became a VMEM-resident Pallas kernel on
// the TPU; here it is a kernel whose plaintext lives only in registers:
// the 16 words of a row are decrypted, transformed and re-encrypted by
// one thread, and only ciphertext is loaded from or stored to device
// memory.  A register spill would put plaintext in local memory, which is
// device memory, so the build must report 0 bytes of spill stores for
// every instance of this kernel (-Xptxas -v, checked by chip_smoke.py).
//
// Bound on an H100 SXM: integer operations.  A row costs two ChaCha20
// blocks (~2000 int32 operations) for 64 B in + 64 B out + 32 B of
// nonces and counters: ~12 operations per byte against the ~10 per byte
// at which 33.5 T int32 operations/s and 3.35 TB/s balance.  At the main
// path's shape (8 chunks x 1024 rows) that is ~0.5 us of integer work.
// The blocks entry reads no per-row coordinates (128 B per block, ~16
// operations per byte): one 64 KB chunk (1024 blocks) is ~60 ns, under
// the launch latency; the chunk-copy experiment's 100 MB payload is
// ~0.1 ms of integer work whatever the chunk size, so small chunks pay
// their launches on top of it.
//
// Design: one thread per row, the operator a template parameter over the
// six static ops (the reference's static `op`), per-row keys (stride 8) or
// a shared key (stride 0) on each side, and separate outbound nonce and
// counter columns (the re-execution path re-seals under fresh
// coordinates).  The blocks entry shares the op device code and the
// register-only dataflow; its counter is computed in the kernel, so no
// coordinate array is read or materialised.  The float ops reproduce the reference's bits exactly as
// its CPU backend computes them, spelled out on bit patterns
// so that no compiler flag decides them (see enclave_map.py): denormal
// inputs read as signed zero; a product whose exact value (a double
// holds it exactly) is below 2^-126 flushes to signed zero before
// rounding; NaN propagation follows x86 mulss.
#include <cuda_runtime.h>

#include "chacha_core.cuh"

namespace {

constexpr int kThreads = 128;

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

template <int OP>
__global__ void __launch_bounds__(kThreads)
enclave_rows_kernel(const uint32_t* __restrict__ kin, int kin_stride,
                    const uint32_t* __restrict__ kout, int kout_stride,
                    const uint32_t* __restrict__ nonces,
                    const uint32_t* __restrict__ counters,
                    const uint32_t* __restrict__ nonces_out,
                    const uint32_t* __restrict__ counters_out,
                    const uint4* __restrict__ data, uint4* __restrict__ out,
                    long long R, uint32_t cbits, int ci) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  uint32_t k[8], n[3], ctr, ks[16], x[16];
  // ---- decrypt (plaintext exists only from here ...)
  ss::load_coords(kin, kin_stride, nonces, counters, r, k, n, ctr);
  ss::block(k, ctr, n, ks);
  ss::load_row(data, r, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  // ---- the enclaved operator
  apply<OP>(x, cbits, ci);
  // ---- re-encrypt (... to here — never stored to device memory)
  ss::load_coords(kout, kout_stride, nonces_out, counters_out, r, k, n, ctr);
  ss::block(k, ctr, n, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  ss::store_row(out, r, x);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
enclave_blocks_kernel(const uint32_t* __restrict__ kin,
                      const uint32_t* __restrict__ kout,
                      const uint32_t* __restrict__ nonce, uint32_t counter0,
                      const uint4* __restrict__ data, uint4* __restrict__ out,
                      long long N, uint32_t cbits, int ci) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint32_t k[8], n[3], ks[16], x[16];
  const uint32_t ctr = counter0 + (uint32_t)r;   // u32 wrap, as reference
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = nonce[i];
  // ---- decrypt (plaintext exists only from here ...)
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = kin[i];
  ss::block(k, ctr, n, ks);
  ss::load_row(data, r, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  // ---- the enclaved operator
  apply<OP>(x, cbits, ci);
  // ---- re-encrypt under kout, same nonce and counter (... to here)
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = kout[i];
  ss::block(k, ctr, n, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  ss::store_row(out, r, x);
}

template <int OP>
void launch_blocks(const void* kin, const void* kout, const void* nonce,
                   uint32_t counter0, const void* data, void* out,
                   long long N, uint32_t cbits, int ci, cudaStream_t stream) {
  long long blocks = (N + kThreads - 1) / kThreads;
  enclave_blocks_kernel<OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)kin, (const uint32_t*)kout, (const uint32_t*)nonce,
      counter0, (const uint4*)data, (uint4*)out, N, cbits, ci);
}

template <int OP>
void launch(const void* kin, int kin_stride, const void* kout,
            int kout_stride, const void* nonces, const void* counters,
            const void* nonces_out, const void* counters_out,
            const void* data, void* out, long long R, uint32_t cbits, int ci,
            cudaStream_t stream) {
  long long blocks = (R + kThreads - 1) / kThreads;
  enclave_rows_kernel<OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)kin, kin_stride, (const uint32_t*)kout, kout_stride,
      (const uint32_t*)nonces, (const uint32_t*)counters,
      (const uint32_t*)nonces_out, (const uint32_t*)counters_out,
      (const uint4*)data, (uint4*)out, R, cbits, ci);
}

}  // namespace

extern "C" int ss_enclave_map_rows(int op, const void* kin, int kin_stride,
                                   const void* kout, int kout_stride,
                                   const void* nonces, const void* counters,
                                   const void* nonces_out,
                                   const void* counters_out,
                                   const void* data, void* out, long long R,
                                   uint32_t cbits, int ci, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SS_LAUNCH(OPV)                                                      \
  launch<OPV>(kin, kin_stride, kout, kout_stride, nonces, counters,        \
              nonces_out, counters_out, data, out, R, cbits, ci, s)
  switch (op) {
    case kIdentity: SS_LAUNCH(kIdentity); break;
    case kScale: SS_LAUNCH(kScale); break;
    case kRelu: SS_LAUNCH(kRelu); break;
    case kSquare: SS_LAUNCH(kSquare); break;
    case kThreshold: SS_LAUNCH(kThreshold); break;
    case kDelay: SS_LAUNCH(kDelay); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int ss_enclave_map_blocks(int op, const void* kin, const void* kout,
                                     const void* nonce, uint32_t counter0,
                                     const void* data, void* out, long long N,
                                     uint32_t cbits, int ci, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SS_LAUNCH(OPV) \
  launch_blocks<OPV>(kin, kout, nonce, counter0, data, out, N, cbits, ci, s)
  switch (op) {
    case kIdentity: SS_LAUNCH(kIdentity); break;
    case kScale: SS_LAUNCH(kScale); break;
    case kRelu: SS_LAUNCH(kRelu); break;
    case kSquare: SS_LAUNCH(kSquare); break;
    case kThreshold: SS_LAUNCH(kThreshold); break;
    case kDelay: SS_LAUNCH(kDelay); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}
