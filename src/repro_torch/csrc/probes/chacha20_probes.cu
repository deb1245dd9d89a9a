// Measurement probes beside the ChaCha20 cipher pass, built apart from the
// kernel library (chip_smoke.py builds this file into its own shared
// library; nothing in the package loads it).
//
// ss_probe_empty: an empty kernel launched over the grid the cipher pass
// gives `count` blocks -- the launch floor under the pass's time.
//
// ss_probe_cipher_pass_4lane: the cipher pass with one 64-byte block split
// over 4 lanes, lane l owning column l of the state; the diagonal rounds
// rotate columns b, c and d across the 4 lanes with __shfl_sync and back.
// It computes what ss_chacha20_cipher_pass computes (same arguments, word
// loads only), so the two can be timed on the same inputs: 4x the threads
// and a quarter of the round work a thread, against two shuffle round
// trips on each double round's dependent chain.
#include "../chacha20.cu"

namespace {

__global__ void empty_kernel() {}

__device__ __forceinline__ uint32_t column_constant(int l) {
  return l == 0 ? 0x61707865u : l == 1 ? 0x3320646eu
       : l == 2 ? 0x79622d32u : 0x6b206574u;
}

template <bool kShared>
__global__ void __launch_bounds__(ss::kMaxThreads)
cipher_pass_4lane_kernel(Items c, const uint32_t* __restrict__ shared_key,
                         long long count) {
  __shared__ uint32_t skey[8];
  const long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int l = threadIdx.x & 3;
  const bool live = t < count;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, live);
  Block blk{};
  uint32_t a = column_constant(l), b = 0, cc = 0, d = 0, x[4];
  if (live) {
    blk = c.at(t);
    if (!kShared) { b = blk.key[l]; cc = blk.key[4 + l]; }
    d = l == 0 ? blk.ctr : blk.nonce[l - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = 4 * i + l < blk.words ? blk.src[4 * i + l] : 0u;
  }
  if (kShared) {
    if (threadIdx.x < 8) skey[threadIdx.x] = shared_key[threadIdx.x];
    __syncthreads();
    b = skey[l];
    cc = skey[4 + l];
  }
  if (!live) return;
  const uint32_t a0 = a, b0 = b, c0 = cc, d0 = d;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    ss::quarter(a, b, cc, d);                         // column l
    b = __shfl_sync(mask, b, (l + 1) & 3, 4);
    cc = __shfl_sync(mask, cc, (l + 2) & 3, 4);
    d = __shfl_sync(mask, d, (l + 3) & 3, 4);
    ss::quarter(a, b, cc, d);                         // diagonal l
    b = __shfl_sync(mask, b, (l + 3) & 3, 4);
    cc = __shfl_sync(mask, cc, (l + 2) & 3, 4);
    d = __shfl_sync(mask, d, (l + 1) & 3, 4);
  }
  const uint32_t ks[4] = {a + a0, b + b0, cc + c0, d + d0};
  if (blk.src == nullptr) {                           // MAC-key block
    blk.dst[l] = clamp31(ks[0]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * i + l < blk.words) blk.dst[4 * i + l] = x[i] ^ ks[i];
}

}  // namespace

extern "C" int ss_probe_empty(long long count, void* stream) {
  if (count <= 0) return 0;
  const int t = ss::cta_threads(count);
  empty_kernel<<<(unsigned)((count + t - 1) / t), t, 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int ss_probe_cipher_pass_4lane(const void* key, int key_stride,
                                          const void* nonces,
                                          const void* payload, int vec,
                                          void* ct, void* mac_keys,
                                          long long B, long long n,
                                          void* stream) {
  (void)vec;
  const Items c{(const uint32_t*)key, key_stride, (const uint32_t*)nonces,
                (const uint32_t*)payload, (uint32_t*)ct,
                (uint32_t*)mac_keys, n, (uint32_t)(1 + (n + 15) / 16)};
  const long long count = B * c.per_item;
  if (count <= 0) return 0;
  const int t = ss::cta_threads(4 * count);
  const unsigned grid = (unsigned)((4 * count + t - 1) / t);
  if (key_stride == 0)
    cipher_pass_4lane_kernel<true><<<grid, t, 0, (cudaStream_t)stream>>>(
        c, (const uint32_t*)key, count);
  else
    cipher_pass_4lane_kernel<false><<<grid, t, 0, (cudaStream_t)stream>>>(
        c, nullptr, count);
  return (int)cudaGetLastError();
}
