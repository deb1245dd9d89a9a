// Carter-Wegman MAC partials over GF(2^31 - 1), batched over rows.
//
// ss_cwmac_partials replaces
// repro/kernels/cwmac/cwmac.py::_mac_tile_batch_kernel (pallas_call in
// mac_partials_batch), behind every batched AEAD MAC (seal, open, and the
// enclave hop's ciphertext MAC and re-tag).  ss_cwmac_mac_partials
// replaces _mac_tile_kernel (pallas_call in mac_partials): the tiles of
// ONE message under K in {1, 2} keys, behind the scalar AEAD seal/open
// and the per-chunk enclave hop's MAC check and re-tag.  The single
// message is literally the batched case at B = 1 (row q of the K key rows
// reads word row q % 1 = 0), so it is a thin entry over the same
// __global__ with its own symbol, which keeps its own launch count.
//
// The tag of a row of n words under key (r, s) is
//     tag = ( sum_l limb_l * r^(2n - l) + s ) mod p,  p = 2^31 - 1,
// over the 16-bit limbs (lo, hi) of each word.  Block (q, t) sums the
// words of tile t of row q, each already multiplied by its ABSOLUTE power
// of r, so the host fold is a plain sum of the T partials plus s (the
// reference multiplies unscaled partials by Horner on the host).  A tag is
// the value of one polynomial: tile size, padding and reduction order do
// not change its bits, and every reduction here is exact — products are
// 64-bit and folded twice by (t & p) + (t >> 31), where the reference
// splits into 16-bit halves because the TPU has no 64-bit multiply.
//
// Bound on an H100 SXM: memory traffic, narrowly.  Each word costs two
// multiply-add steps mod p per key (~16 int32 operations) for 4 bytes read
// once for both keys of mac2 (~8 operations per byte, under the ~10 at
// which 33.5 T int32 operations/s and 3.35 TB/s balance): at the main
// path's shape (2 keys x 8 rows x 16384 words) ~0.16 us of traffic
// against ~0.13 us of integer work; one 64 KB chunk under 2 keys (the
// per-chunk engine) is ~0.02 us, far under the launch latency; one 100 MB
// message under 2 keys is ~31 us of traffic against ~25 us of integer
// work.
//
// Design: a (row x tile) grid, 256 threads per block, tiles of 2048 words
// (4096 limbs, the reference's tile).  Thread i walks its words from the
// end of the tile backwards, so its power of r is one square-and-multiply
// at the start and one multiply per step after; loads are coalesced
// (neighbouring threads, neighbouring words).  mac2 passes both keys as
// 2B rows over the same B word rows (row q reads words row q % B).  A
// shared-memory add-mod tree reduces the block.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kP = 0x7FFFFFFFu;

__device__ __forceinline__ uint32_t fold(uint64_t t) {
  t = (t & kP) + (t >> 31);          // < 2^32
  t = (t & kP) + (t >> 31);          // <= p + 1
  return (uint32_t)(t >= kP ? t - kP : t);
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  return fold((uint64_t)a * b);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  uint32_t t = a + b;                // a, b < p: no u32 overflow
  return t >= kP ? t - kP : t;
}

__device__ uint32_t powmod(uint32_t r, unsigned long long e) {
  uint32_t acc = 1, base = r;
  while (e) {
    if (e & 1) acc = mulmod(acc, base);
    base = mulmod(base, base);
    e >>= 1;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
cwmac_partials_kernel(const uint32_t* __restrict__ words, long long B,
                      long long n, const uint32_t* __restrict__ rkeys,
                      int tile_words, uint32_t* __restrict__ partials,
                      int T) {
  __shared__ uint32_t red[kThreads];
  const long long q = blockIdx.x / T;
  const int t = blockIdx.x % T;
  const uint32_t r = rkeys[q];
  const uint32_t* row = words + (q % B) * n;
  const long long base = (long long)t * tile_words;
  const long long end = min(base + tile_words, n);
  const int i = threadIdx.x;
  uint32_t acc = 0;
  if (base + i < end) {
    // last word of this thread in the tile, then step back by kThreads
    long long w = base + i + ((end - 1 - base - i) / kThreads) * kThreads;
    uint32_t x = powmod(r, (unsigned long long)(2 * (n - w) - 1));
    const uint32_t step = powmod(r, 2ull * kThreads);
    for (; w >= base + i; w -= kThreads) {
      const uint32_t v = row[w];
      // lo * r^(2(n-w)) + hi * r^(2(n-w)-1)  ==  (lo * r + hi) * x
      const uint32_t lohi = addmod(mulmod(v & 0xFFFFu, r), v >> 16);
      acc = addmod(acc, mulmod(lohi, x));
      x = mulmod(x, step);
    }
  }
  red[i] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (i < s) red[i] = addmod(red[i], red[i + s]);
    __syncthreads();
  }
  if (i == 0) partials[q * T + t] = red[0];
}

}  // namespace

extern "C" int ss_cwmac_partials(const void* words, long long B, long long n,
                                 const void* rkeys, long long rows,
                                 int tile_words, void* partials, int T,
                                 void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  if (tile_words <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cwmac_partials_kernel<<<(unsigned)(rows * T), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)words, B, n, (const uint32_t*)rkeys, tile_words,
      (uint32_t*)partials, T);
  return (int)cudaGetLastError();
}

extern "C" int ss_cwmac_mac_partials(const void* words, long long n,
                                     const void* rkeys, int K, int tile_words,
                                     void* partials, int T, void* stream) {
  if (K <= 0 || T <= 0) return 0;
  if (tile_words <= 0) return (int)cudaErrorInvalidValue;
  cwmac_partials_kernel<<<(unsigned)(K * T), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)words, 1, n, (const uint32_t*)rkeys, tile_words,
      (uint32_t*)partials, T);
  return (int)cudaGetLastError();
}
