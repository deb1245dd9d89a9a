// Carter-Wegman MAC tags over GF(2^31 - 1): one launch writes finished tags.
//
// ss_cwmac_tags replaces repro/kernels/cwmac/cwmac.py::_mac_tile_batch_kernel
// (pallas_call in mac_partials_batch), behind every batched AEAD MAC (seal,
// open, and the enclave hop's ciphertext MAC and re-tag).  ss_cwmac_mac_tags
// replaces _mac_tile_kernel (pallas_call in mac_partials): ONE message under
// K in {1, 2} keys, behind the scalar AEAD seal/open and the per-chunk
// enclave hop's MAC check and re-tag.  It is the batched entry at B = 1 with
// its own symbol, which keeps its own launch count.
//
// The tag of a row of n words under key (r, s) is
//     tag = ( sum_l limb_l * r^(2n - l) + s ) mod p,  p = 2^31 - 1,
// over the 16-bit limbs (lo, hi) of each word.  A tag is the value of one
// polynomial, so how the row is split and in which order the pieces are
// summed does not change its bits: every reduction here is exact.
//
// Bound on an H100 SXM: memory traffic.  Each word is read once for both
// keys (4 bytes) and costs ~4 int32 operations per key here; at the main
// path's shapes the traffic is sub-microsecond (8 rows x 16384 words: 0.16
// us; one 64 KB chunk: 0.02 us), so a call is bound by one launch's
// latency.  One 100 MB message under 2 keys is 31 us of traffic.
//
// What the design does about it:
//   * one launch per MAC call writes the (rows, K) tags with s added: the
//     cross-block fold happens on the card, in the same launch;
//   * each word is loaded once for all K keys, as 16-byte vector loads when
//     the row allows it (n % 4 == 0 and 16-byte aligned words);
//   * no powmod per thread.  A row is cut into G blocks of m*256 groups of 4
//     words (8 limbs), left-padded with zero words to G*m*1024 (leading
//     zeros do not change the polynomial), so every block, thread and group
//     sits at a power of r that squaring alone reaches: a group is
//     sum_j limb_j * r^(7-j) (eight 16x31-bit products summed in 64 bits,
//     one Mersenne fold), a thread runs Horner over its groups with
//     y^256 (y = r^8), the lanes of a warp and then the warps of a block
//     combine by Horner on shuffle trees with y, y^2, .., y^128, and
//     blocks by Horner with X = y^(256m).  Reduction mod p is lazy
//     (values kept below 2^32, folded twice, made canonical once);
//   * a thread's groups are loaded together before the powers' chain is
//     computed, so that chain and one memory latency overlap;
//   * the blocks of a row fold through distributed shared memory as one
//     thread-block cluster (G <= 8: rows up to 131,072 words, every row of
//     the stream engines); longer rows (a 100 MB message) use up to two
//     blocks per SM: each block writes its partial, and the last block of a
//     row to draw a ticket folds the row's partials (each thread one
//     stride of them) and resets the ticket to 0, so no memset launch is
//     needed.  The wrapper keeps one zeroed ticket array per (device,
//     stream): launches on one stream run in order, so no two launches that
//     can run at once share a ticket.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kP = 0x7FFFFFFFu;

struct Args {
  const uint32_t* words;
  long long n;              // words per row
  long long pad;            // zero words put in front of each row
  int G, m;                 // blocks per row, groups per thread
  const uint32_t* r[2];     // key arrays, element strides per row
  const uint32_t* s[2];
  long long rs[2], ss[2];
  uint32_t* tags;           // (rows, K)
  uint32_t* scratch;        // (rows, G, K) partials (ticket path)
  int* tickets;             // (rows,) zero between launches (ticket path)
};

// t mod p up to a small multiple: any 64-bit t -> below 2^31 + 7
__device__ __forceinline__ uint32_t fold2(uint64_t t) {
  t = (t & kP) + (t >> 31);
  t = (t & kP) + (t >> 31);
  return (uint32_t)t;
}

__device__ __forceinline__ uint32_t canon(uint32_t x) {   // x < 2p
  return x >= kP ? x - kP : x;
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return fold2((uint64_t)a * b);
}

__device__ uint32_t powmod(uint32_t x, long long e) {
  uint32_t acc = 1;
  while (e) {
    if (e & 1) acc = mul(acc, x);
    x = mul(x, x);
    e >>= 1;
  }
  return acc;
}

// a key word read as the plain version reads it: signed int32, mod p
// (-2^31 <= v < 2^31 needs at most two additions of p, no division)
__device__ __forceinline__ uint32_t key_mod_p(uint32_t raw) {
  long long v = (int32_t)raw;
  v += v < 0 ? (long long)kP : 0;
  v += v < 0 ? (long long)kP : 0;
  return (uint32_t)(v >= kP ? v - kP : v);
}

// the finished tag from the row's lazy sum (r already applied)
__device__ __forceinline__ uint32_t finish(uint32_t acc, uint32_t s_raw) {
  const uint32_t t = canon(fold2(acc)) + key_mod_p(s_raw);
  return t >= kP ? t - kP : t;
}

template <int K>
struct Powers {
  uint32_t r[K];
  uint32_t rp[K][8];        // r^0 .. r^7
  uint32_t yd[K][8];        // y, y^2, .., y^128 (y = r^8)
  uint32_t yT[K];           // y^256
};

template <int K>
__device__ __forceinline__ void powers(const Args& a, long long q,
                                       Powers<K>& pw) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t r = key_mod_p(a.r[k][q * a.rs[k]]);
    pw.r[k] = r;
    uint32_t* rp = pw.rp[k];
    rp[0] = 1;
    rp[1] = r;
    rp[2] = mul(r, r);
    rp[3] = mul(rp[2], r);
    rp[4] = mul(rp[2], rp[2]);
    rp[5] = mul(rp[4], r);
    rp[6] = mul(rp[4], rp[2]);
    rp[7] = mul(rp[4], rp[3]);
    uint32_t y = mul(rp[4], rp[4]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pw.yd[k][i] = y;
      y = mul(y, y);
    }
    pw.yT[k] = y;                                  // y^256
  }
}

// sum_j limb_j r^(7-j) over the limbs lo0, hi0, .., lo3, hi3: < 2^50
__device__ __forceinline__ uint64_t group_sum(const uint32_t v[4],
                                              const uint32_t rp[8]) {
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc += (uint64_t)(v[j] & 0xFFFFu) * rp[7 - 2 * j];
    acc += (uint64_t)(v[j] >> 16) * rp[6 - 2 * j];
  }
  return acc;
}

// group i of this thread's m, or zeros where it lies in the left pad
template <bool VEC>
__device__ __forceinline__ void load_group(const uint32_t* row, long long w0,
                                           uint32_t v[4]) {
  v[0] = v[1] = v[2] = v[3] = 0;
  if (VEC) {                       // pad % 4 == 0: a group is all real or all pad
    if (w0 >= 0) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + w0));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (w0 + j >= 0) v[j] = __ldg(row + w0 + j);
  }
}

// V[k] = sum_i h_i y^(255 - i) over the block's threads, in thread 0.  A
// thread's groups are loaded CHUNK at a time, all in flight together, and
// the first chunk before the powers of r are computed, so one memory
// latency covers a chunk and the powers' chain hides behind it.
template <int K, bool VEC, int CHUNK>
__device__ __forceinline__ void block_values(const Args& a, long long q,
                                             int g, Powers<K>& pw,
                                             uint32_t V[K]) {
  __shared__ uint32_t warp_v[K][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* row = a.words + q * a.n;
  const long long P0 = (long long)g * a.m * kThreads + tid;   // virtual group
  uint32_t h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) h[k] = 0;
  for (int i0 = 0; i0 < a.m; i0 += CHUNK) {
    uint32_t v[CHUNK][4];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i)
      if (i0 + i < a.m)
        load_group<VEC>(row, 4 * (P0 + (long long)(i0 + i) * kThreads) - a.pad,
                        v[i]);
    if (i0 == 0) powers<K>(a, q, pw);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (i0 + i >= a.m) break;
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[k] = fold2((uint64_t)h[k] * pw.yT[k] + group_sum(v[i], pw.rp[k]));
    }
  }
  // lanes: v_i <- v_i y^d + v_(i+d); lane 0 ends with sum_i v_i y^(31-i)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    uint32_t x = h[k];
#pragma unroll
    for (int st = 0; st < 5; ++st) {
      const uint32_t other = __shfl_down_sync(0xffffffffu, x, 1 << st);
      x = fold2((uint64_t)x * pw.yd[k][st] + other);
    }
    if (lane == 0) warp_v[k][warp] = x;
  }
  __syncthreads();
  // the warps the same way, y^32 .. y^128 apart, in warp 0
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t x = lane < kWarps ? warp_v[k][lane] : 0;
#pragma unroll
      for (int st = 0; st < 3; ++st) {
        const uint32_t other = __shfl_down_sync(0xffffffffu, x, 1 << st);
        x = fold2((uint64_t)x * pw.yd[k][5 + st] + other);
      }
      V[k] = x;
    }
  }
}

// one thread-block cluster of G blocks per row (grid (G, rows))
template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
cwmac_tags_cluster_kernel(Args a) {
  __shared__ uint32_t part[K];
  cg::cluster_group cluster = cg::this_cluster();
  const long long q = blockIdx.y;
  const int g = (int)cluster.block_rank();
  Powers<K> pw;
  uint32_t V[K];
  block_values<K, VEC, 16>(a, q, g, pw, V);   // m <= 16: one chunk
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k] = V[k];
  }
  cluster.sync();                  // every block's partial is in its smem
  if (g == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t X = powmod(pw.yT[k], a.m);      // y^(256 m)
      uint32_t acc = 0;
      for (int b = 0; b < a.G; ++b)
        acc = fold2((uint64_t)acc * X + *cluster.map_shared_rank(&part[k], b));
      a.tags[q * K + k] =
          finish(fold2((uint64_t)acc * pw.r[k]), a.s[k][q * a.ss[k]]);
    }
  }
  cluster.sync();                  // keep every block's smem until it is read
}

// rows longer than a cluster covers: partials, then the last block folds
template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
cwmac_tags_ticket_kernel(Args a) {
  __shared__ int last;
  __shared__ uint64_t warp_sum[K][kWarps];
  const long long q = blockIdx.y;
  const int g = blockIdx.x, tid = threadIdx.x;
  Powers<K> pw;
  uint32_t V[K];
  block_values<K, VEC, 8>(a, q, g, pw, V);
  uint32_t* part = a.scratch + q * a.G * K;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[g * K + k] = V[k];
    __threadfence();               // the partial is visible before the ticket
    last = atomicAdd(&a.tickets[q], 1) == a.G - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // block b's partial carries X^(G-1-b): thread t takes b = G-1-t-j*256
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t X = powmod(pw.yT[k], a.m);
    uint32_t XT = X;
#pragma unroll
    for (int i = 0; i < 8; ++i) XT = mul(XT, XT);   // X^256
    uint32_t xp = powmod(X, tid);
    uint64_t sum = 0;
    for (int e = tid; e < a.G; e += kThreads) {
      sum += fold2((uint64_t)__ldcg(part + (a.G - 1 - e) * K + k) * xp);
      xp = mul(xp, XT);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if ((tid & 31) == 0) warp_sum[k][tid >> 5] = sum;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint64_t sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += warp_sum[k][w];
      a.tags[q * K + k] =
          finish(fold2((uint64_t)fold2(sum) * pw.r[k]), a.s[k][q * a.ss[k]]);
    }
    a.tickets[q] = 0;              // zero again for the next launch
  }
}

template <int K, bool VEC>
cudaError_t launch(const Args& a, long long rows, bool cluster,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)a.G, (unsigned)rows);
  if (!cluster) {
    cwmac_tags_ticket_kernel<K, VEC><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, cwmac_tags_cluster_kernel<K, VEC>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int tags(const void* words, long long B, long long n, const void* r0,
         const void* s0, const void* r1, const void* s1, long long rs0,
         long long ss0, long long rs1, long long ss1, int K, int G, int m,
         int cluster, void* out, void* scratch, void* tickets,
         void* stream) {
  if (B <= 0) return 0;
  const long long pad = (long long)G * m * kThreads * 4 - n;
  if ((K != 1 && K != 2) || G <= 0 || m <= 0 || n < 0 || pad < 0 ||
      B > 65535 ||
      (cluster && G > 8) || (!cluster && (!scratch || !tickets)))
    return (int)cudaErrorInvalidValue;
  Args a{(const uint32_t*)words, n, pad, G, m,
         {(const uint32_t*)r0, (const uint32_t*)(K == 2 ? r1 : r0)},
         {(const uint32_t*)s0, (const uint32_t*)(K == 2 ? s1 : s0)},
         {rs0, K == 2 ? rs1 : rs0}, {ss0, K == 2 ? ss1 : ss0},
         (uint32_t*)out, (uint32_t*)scratch, (int*)tickets};
  const bool vec = n % 4 == 0 && (uintptr_t)words % 16 == 0;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (K == 1)
    err = vec ? launch<1, true>(a, B, cluster, st)
              : launch<1, false>(a, B, cluster, st);
  else
    err = vec ? launch<2, true>(a, B, cluster, st)
              : launch<2, false>(a, B, cluster, st);
  return (int)err;
}

}  // namespace

// words (B, n) contiguous, B <= 65,535 (rows sit on gridDim.y; the Python
// wrapper launches once per slab of a larger batch); key k's r and s at
// r_k[q * rs_k], s_k[q * ss_k]
// (int32-carried, read as signed mod p); tags (B, K).  G blocks per row of
// m groups per thread; cluster != 0 folds through a cluster (G <= 8), else
// through scratch (B*G*K words) and tickets (B ints, zero on entry and on
// exit).
extern "C" int ss_cwmac_tags(const void* words, long long B, long long n,
                             const void* r0, const void* s0, const void* r1,
                             const void* s1, long long rs0, long long ss0,
                             long long rs1, long long ss1, int K, int G,
                             int m, int cluster, void* out, void* scratch,
                             void* tickets, void* stream) {
  return tags(words, B, n, r0, s0, r1, s1, rs0, ss0, rs1, ss1, K, G, m,
              cluster, out, scratch, tickets, stream);
}

// one message of n words under K scalar keys -> (K,) tags
extern "C" int ss_cwmac_mac_tags(const void* words, long long n,
                                 const void* r0, const void* s0,
                                 const void* r1, const void* s1, int K, int G,
                                 int m, int cluster, void* out, void* scratch,
                                 void* tickets, void* stream) {
  return tags(words, 1, n, r0, s0, r1, s1, 0, 0, 0, 0, K, G, m, cluster, out,
              scratch, tickets, stream);
}
