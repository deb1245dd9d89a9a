// Measurement probes beside the enclave-map kernels, built apart from the
// kernel library (chip_smoke.py builds this file into its own shared
// library; nothing in the package loads it).
//
// ss_probe_enclave_empty: an empty kernel launched over the grid the
// enclave kernel gives `count` blocks (a lane pair each) -- the launch
// floor under its time.
//
// ss_probe_enclave_map_window_interleaved / _blocks_interleaved: the
// other design for running the two keystreams at once, one thread a
// block that interleaves both blocks' rounds (8 independent quarter-round
// chains instead of 4, twice the registers), with the same arguments as
// ss_enclave_map_window / ss_enclave_map_blocks and the same result.
//
// ss_probe_enclave_map_rows_v1 / _blocks_v1: the kernels as they were
// before the lane-pair design (one thread a block running the inbound
// keystream, then the payload loads, then the outbound keystream, in 128-
// thread CTAs), with the arguments of ss_enclave_map_rows / _blocks.
#include "../enclave_map.cu"

namespace {

__global__ void empty_kernel() {}

#define SS_OP_SWITCH(LAUNCH)                                   \
  switch (op) {                                                \
    case kIdentity: LAUNCH(kIdentity); break;                  \
    case kScale: LAUNCH(kScale); break;                        \
    case kRelu: LAUNCH(kRelu); break;                          \
    case kSquare: LAUNCH(kSquare); break;                      \
    case kThreshold: LAUNCH(kThreshold); break;                \
    case kDelay: LAUNCH(kDelay); break;                        \
    default: return (int)cudaErrorInvalidValue;                \
  }

// ---- one thread a block, both keystreams' rounds interleaved

__device__ __forceinline__ void init_state(const uint32_t k[8], uint32_t ctr,
                                           const uint32_t n[3],
                                           uint32_t s[16]) {
  s[0] = 0x61707865u; s[1] = 0x3320646eu; s[2] = 0x79622d32u;
  s[3] = 0x6b206574u;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[4 + i] = k[i];
  s[12] = ctr; s[13] = n[0]; s[14] = n[1]; s[15] = n[2];
}

#define SS_QR2(A, B, C, D)                          \
  ss::quarter(a[A], a[B], a[C], a[D]);              \
  ss::quarter(b[A], b[B], b[C], b[D])

// ksa, ksb = ChaCha20 blocks of two coordinate sets, computed together
__device__ __forceinline__ void block2(const uint32_t ka[8], uint32_t ca,
                                       const uint32_t na[3],
                                       const uint32_t kb[8], uint32_t cb,
                                       const uint32_t nb[3],
                                       uint32_t ksa[16], uint32_t ksb[16]) {
  uint32_t a[16], b[16], a0[16], b0[16];
  init_state(ka, ca, na, a0);
  init_state(kb, cb, nb, b0);
#pragma unroll
  for (int i = 0; i < 16; ++i) { a[i] = a0[i]; b[i] = b0[i]; }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    SS_QR2(0, 4, 8, 12); SS_QR2(1, 5, 9, 13);
    SS_QR2(2, 6, 10, 14); SS_QR2(3, 7, 11, 15);
    SS_QR2(0, 5, 10, 15); SS_QR2(1, 6, 11, 12);
    SS_QR2(2, 7, 8, 13); SS_QR2(3, 4, 9, 14);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ksa[i] = a[i] + a0[i];
    ksb[i] = b[i] + b0[i];
  }
}

template <class Coords, int OP, bool kVec, bool kEarly>
__global__ void __launch_bounds__(ss::kMaxThreads)
interleaved_kernel(Coords c, long long count, uint32_t cbits, int ci) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= count) return;
  const Lane in = c.at(p, false), out = c.at(p, true);
  uint32_t ki[8], ni[3], ko[8], no[3], ksi[16], kso[16], x[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) { ki[i] = __ldg(in.key + i);
                                ko[i] = __ldg(out.key + i); }
#pragma unroll
  for (int i = 0; i < 3; ++i) { ni[i] = __ldg(in.nonce + i);
                                no[i] = __ldg(out.nonce + i); }
  if (kEarly) ss::load_words<kVec>(in.src, in.words, x);
  block2(ki, in.ctr, ni, ko, out.ctr, no, ksi, kso);
  if (!kEarly) ss::load_words<kVec>(in.src, in.words, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ksi[i];
  apply<OP>(x, cbits, ci);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= kso[i];
  ss::store_words<kVec>(in.dst, in.words, x);
}

template <class Coords, bool kVec>
int launch_interleaved(int op, const Coords& c, long long count,
                       uint32_t cbits, int ci, void* stream) {
  if (count <= 0) return 0;
  const int t = ss::cta_threads(count);
  const unsigned grid = (unsigned)((count + t - 1) / t);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool early = count <= kOneWave;
#define SS_LAUNCH(OPV)                                                     \
  if (early)                                                              \
    interleaved_kernel<Coords, OPV, kVec, true><<<grid, t, 0, s>>>(       \
        c, count, cbits, ci);                                             \
  else                                                                    \
    interleaved_kernel<Coords, OPV, kVec, false><<<grid, t, 0, s>>>(      \
        c, count, cbits, ci)
  SS_OP_SWITCH(SS_LAUNCH)
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}

// ---- the kernels before the lane-pair design, as they were

namespace v1 {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_coords(const uint32_t* __restrict__ keys,
                                            int key_stride,
                                            const uint32_t* __restrict__ nonces,
                                            const uint32_t* __restrict__ ctrs,
                                            long long r, uint32_t k[8],
                                            uint32_t n[3], uint32_t& ctr) {
  const uint32_t* kp = keys + r * key_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = kp[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = nonces[r * 3 + i];
  ctr = ctrs[r];
}

__device__ __forceinline__ void load_row(const uint4* __restrict__ data,
                                         long long r, uint32_t x[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 v = data[r * 4 + q];
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_row(uint4* __restrict__ out,
                                          long long r, const uint32_t x[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[r * 4 + q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                x[4 * q + 3]);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const uint32_t* __restrict__ kin, int kin_stride,
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
  load_coords(kin, kin_stride, nonces, counters, r, k, n, ctr);
  ss::block(k, ctr, n, ks);
  load_row(data, r, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  apply<OP>(x, cbits, ci);
  load_coords(kout, kout_stride, nonces_out, counters_out, r, k, n, ctr);
  ss::block(k, ctr, n, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  store_row(out, r, x);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
blocks_kernel(const uint32_t* __restrict__ kin,
              const uint32_t* __restrict__ kout,
              const uint32_t* __restrict__ nonce, uint32_t counter0,
              const uint4* __restrict__ data, uint4* __restrict__ out,
              long long N, uint32_t cbits, int ci) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint32_t k[8], n[3], ks[16], x[16];
  const uint32_t ctr = counter0 + (uint32_t)r;
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = nonce[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = kin[i];
  ss::block(k, ctr, n, ks);
  load_row(data, r, x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  apply<OP>(x, cbits, ci);
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = kout[i];
  ss::block(k, ctr, n, ks);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= ks[i];
  store_row(out, r, x);
}

}  // namespace v1

}  // namespace

extern "C" int ss_probe_enclave_empty(long long count, void* stream) {
  if (count <= 0) return 0;
  const int t = ss::cta_threads(2 * count);
  empty_kernel<<<(unsigned)((2 * count + t - 1) / t), t, 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int ss_probe_enclave_map_window_interleaved(
    int op, const void* kin, int kin_stride, const void* kout,
    int kout_stride, const void* nonces_in, const void* nonces_out,
    const void* words, void* out, long long B, long long n, uint32_t cbits,
    int ci, void* stream) {
  const Items c{(const uint32_t*)kin, kin_stride, (const uint32_t*)kout,
                kout_stride, (const uint32_t*)nonces_in,
                (const uint32_t*)nonces_out, (const uint32_t*)words,
                (uint32_t*)out, n, (uint32_t)((n + 15) / 16)};
  const long long count = B * c.per_item;
  return n % 4 == 0 && aligned16(words) && aligned16(out)
      ? launch_interleaved<Items, true>(op, c, count, cbits, ci, stream)
      : launch_interleaved<Items, false>(op, c, count, cbits, ci, stream);
}

extern "C" int ss_probe_enclave_map_blocks_interleaved(
    int op, const void* kin, const void* kout, const void* nonce,
    uint32_t counter0, const void* data, void* out, long long N,
    uint32_t cbits, int ci, void* stream) {
  const Blocks c{(const uint32_t*)kin, (const uint32_t*)kout,
                 (const uint32_t*)nonce, counter0, (const uint32_t*)data,
                 (uint32_t*)out};
  return launch_interleaved<Blocks, true>(op, c, N, cbits, ci, stream);
}

extern "C" int ss_probe_enclave_map_rows_v1(
    int op, const void* kin, int kin_stride, const void* kout,
    int kout_stride, const void* nonces, const void* counters,
    const void* nonces_out, const void* counters_out, const void* data,
    void* out, long long R, uint32_t cbits, int ci, void* stream) {
  if (R <= 0) return 0;
  const unsigned grid = (unsigned)((R + v1::kThreads - 1) / v1::kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
#define SS_LAUNCH(OPV)                                                     \
  v1::rows_kernel<OPV><<<grid, v1::kThreads, 0, s>>>(                     \
      (const uint32_t*)kin, kin_stride, (const uint32_t*)kout,            \
      kout_stride, (const uint32_t*)nonces, (const uint32_t*)counters,    \
      (const uint32_t*)nonces_out, (const uint32_t*)counters_out,         \
      (const uint4*)data, (uint4*)out, R, cbits, ci)
  SS_OP_SWITCH(SS_LAUNCH)
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int ss_probe_enclave_map_blocks_v1(
    int op, const void* kin, const void* kout, const void* nonce,
    uint32_t counter0, const void* data, void* out, long long N,
    uint32_t cbits, int ci, void* stream) {
  if (N <= 0) return 0;
  const unsigned grid = (unsigned)((N + v1::kThreads - 1) / v1::kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
#define SS_LAUNCH(OPV)                                                     \
  v1::blocks_kernel<OPV><<<grid, v1::kThreads, 0, s>>>(                   \
      (const uint32_t*)kin, (const uint32_t*)kout, (const uint32_t*)nonce, \
      counter0, (const uint4*)data, (uint4*)out, N, cbits, ci)
  SS_OP_SWITCH(SS_LAUNCH)
#undef SS_LAUNCH
  return (int)cudaGetLastError();
}
