// Flash-attention backward for Hopper: dQ, dK and dV of kernel 7's
// attention from its log-sum-exp, the scores recomputed on chip.
//
// Replaces no TPU kernel: the reference computes the backward
// (repro/models/flash.py::_flash_bwd, under jax.custom_vjp) in jnp over
// (q_chunk, kv_chunk) blocks, and the port's plain version
// (repro_torch/models/flash.py::flash_backward_plain) repeats it in f32
// torch ops.  For each (batch b, head h), with s_ij = scale q_i . k_j,
// p_ij = exp(s_ij - lse_i) (lse: the forward's natural-log log-sum-exp),
// delta_i = sum_d do_id o_id:
//     dv_j = sum_i p_ij do_i            dp_ij = do_i . v_j
//     ds_ij = p_ij (dp_ij - delta_i)
//     dk_j = scale sum_i ds_ij q_i      dq_i = scale sum_j ds_ij k_j
// over the pairs the causal mask keeps (TOP-LEFT aligned, as kernel 7's:
// query i sees keys 0..i), every pair otherwise.  Products run on bf16
// operands (q, k, v, do as given; p and ds rounded to bf16 as the tensor
// cores' A operand, as kernel 7 rounds p before P V) with f32
// accumulation; the softmax recompute, delta and every sum are f32.
//
// Bound on an H100 SXM at musicgen's training shape (B=3, S=2048, H=32,
// D=64, bf16, causal): operations.  Five products of 2 D FLOP an attended
// pair, 10 D B H S(S+1)/2 = 1.29e11 FLOP, are 0.130 ms at 989 TFLOP/s; the
// recompute needs B H S(S+1)/2 = 2.0e8 exp2, 0.048 ms at the SFUs' 16 an
// SM a clock; q, k, v, o, do, the lse and dq, dk, dv are 202 MB, 0.060 ms
// at 3.35 TB/s.
//
// Three launches (ss_flash_attention_bwd_preprocess, ss_flash_attention_bwd,
// ss_flash_attention_bwd_convert):
//   1. preprocess, bound by memory: delta = rowsum(do * o) in f32 and the
//      lse in exp2 units (lse * log2 e), both (B, H, Sq_pad) with Sq_pad =
//      Sq rounded up to the 64-row Q tile and rows past Sq at delta 0, lse
//      +inf (so p = 0 there); the f32 dQ accumulator (B, H, Sq_pad, Dp)
//      zeroed.  o and do are read in place through their strides.
//   2. the main kernel.  One block of two warpgroups owns one (b, h,
//      128-key KV tile); grid (KV tiles, H, B), tile 0 (the most causal
//      work) first in each (b, h), so the blocks on the card at once share
//      a few (b, h)'s Q and dO in L2 (heaviest first over the whole grid
//      ran 16 % slower at musicgen's shape):
//      * thread 0 is also the producer: it loads K_j
//        and V_j once by TMA, then streams Q_i, dO_i (TMA, 128-byte
//        swizzle) and the tile's lse and delta rows (bulk copies) through
//        a ring of stages on mbarriers, over the Q tiles the causal mask
//        leaves (from the diagonal on), refilling a stage at the top of
//        the iteration after the one that used it;
//      * warpgroups 0 and 1 own 64 keys each and walk the same Q tiles:
//          S^T  = K_c Q_i^T             wgmma m64n64, both from smem
//          dP^T = V_c dO_i^T            wgmma m64n64, both from smem
//          P^T  = exp2(S^T scale log2e - lse_i log2e), masked on the
//                 diagonal and past Skv only
//          dS^T = P^T (dP^T - delta_i)
//          dV_c += P^T dO_i             wgmma, P in bf16 from registers,
//                                       dO as an MN-major B (no transpose)
//          dK_c += dS^T Q_i             wgmma, dS from registers
//          dQ_i += dS K_c               dS^T stored to shared memory
//                                       (swizzled) and read as an
//                                       M-major A; K_c as an MN-major B;
//                                       64 columns a product
//        then the warpgroup's dQ sum (64 x Dp f32) goes to shared memory
//        and one thread has the TMA unit add it into the f32 accumulator
//        (cp.reduce.async.bulk .add.f32, one bulk operation a tile; the
//        same sums added by each thread, 4,096 red.global.add.f32 a tile,
//        held the kernel at 12 % of its bound; the order of the adds
//        varies from run to run).  dK_c and dV_c stay in registers across the Q loop
//        and are scaled, rounded to bf16 and stored once, straight into
//        the (B, S, H, D) outputs.
//      Each warpgroup has its own dS and dQ buffers and a named barrier;
//      the two meet only on the stage ring (a stage is released once all
//      eight warps are done with it, and thread 0 waits for that before
//      it refills the stage).
//   3. convert: dq = accumulator * scale, rounded to bf16, in (B, S, H, D);
//      the accumulator's tiles of 64 rows are in the main kernel's
//      register order, which the convert reads back.
// Deterministic mode (the caller asks for it under
// torch.use_deterministic_algorithms): each warpgroup stores its dQ sums
// to an accumulator of its own 64 keys (a "slot", bulk stores in place of
// adds) and the convert adds the slots that wrote a row in key order, so
// the bits do not depend on the order the blocks ran in; it costs
// 2 x (KV tiles) accumulators of memory and their reads.
// No transposed or f32 copies of q, k, v or do are made.
//
// Tiles: 128 keys (two warpgroups of 64) x 64 queries at both padded widths
// Dp = 64 and 128.  The register file decides: a consumer keeps dK and dV
// (2 x Dp/2 floats) and S^T and dP^T (2 x 32), 192 at Dp = 128 (S^T and
// dP^T die into their 32 bf16 fragments, packed as they are computed,
// before the 32 of the dQ partial are live).  Hence no producer warps:
// with a producer warpgroup (384 threads, setmaxnreg 40 / 232, as kernel
// 7) or a producer warp (288 threads: three warps on some of the SM's
// four register files) ptxas reported 168 registers a thread and spilled
// 432 and 852 bytes at Dp = 128; eight warps may take 255 each, and use
// 199 (Dp = 64) and 255 (Dp = 128) with no spills.  64 x 128 (KV x Q)
// tiles would need 64 registers more for S^T and dP^T.  The ring holds 4
// stages at Dp = 64 and 2 at Dp = 128 (Q and dO tiles of 8 or 16 KB),
// beside each consumer's 8 KB dS^T and 16 or 32 KB dQ sum.
// Head dims.  As kernel 7: the real D (1..128, a multiple of 8: TMA's
// 16-byte strides; the wrapper pads other D) is read through D-wide tensor
// maps, so columns D..Dp-1 read as zeros and add nothing; only the D real
// columns are stored.  K and V may be views with any (b, s, h) strides
// (grouped KV heads repeated by a stride-0 view); dK and dV are written per
// query head.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_tma.cuh"

namespace {

using namespace ss;   // flash_tma.cuh: mbarriers, TMA, wgmma descriptors

constexpr int kConsumers = 2;            // consumer warpgroups, 64 keys each
constexpr int kBc = 64 * kConsumers;     // keys per block
constexpr int kBr = 64;                  // queries per Q tile
constexpr int kThreads = 128 * kConsumers;

struct BwdParams {
  const float* lse2;                // (B, H, Sq_pad): lse * log2 e
  const float* delta;               // (B, H, Sq_pad)
  float* dq_acc;                    // B H Sq_pad Dp f32, zeroed; tiles of
                                    // 64 rows in the convert's order;
                                    // with slots, one such a 64 keys
  long long slot_stride;            // floats a slot; 0: one accumulator
  void* dk;
  void* dv;
  int Sq, Skv, SqPad, causal;
  int D;                            // columns stored, <= Dp
  float scale;                      // 1 / sqrt(the unpadded head dim)
  // element strides of batch, sequence and head for dk and dv
  long long dkb, dks, dkh, dvb, dvs, dvh;
};

template <int Dp>
struct Dims {
  static_assert(Dp == 64 || Dp == 128, "whole 64-column blocks, at most 2");
  static constexpr int kCols = Dp / kColBlock;
  static constexpr int kStages = Dp == 64 ? 4 : 2;
  static constexpr int kKVBytes = kBc * Dp * 2;     // K or V: 16 or 32 KB
  static constexpr int kQBytes = kBr * Dp * 2;      // Q or dO: 8 or 16 KB
  static constexpr int kRowBytes = kBr * 4;         // a tile's lse or delta
  static constexpr int kDsBytes = 64 * kBr * 2;     // a consumer's dS^T
  static constexpr int kDqBytes = kBr * Dp * 4;     // a consumer's dQ sum
  static constexpr int kStageTx = 2 * kQBytes + 2 * kRowBytes;
  static constexpr int kTiles =                     // 1024-B aligned part
      2 * kKVBytes + kStages * 2 * kQBytes +
      kConsumers * (kDsBytes + kDqBytes);
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmemBytes =
      kTiles + kStages * 2 * kRowBytes + 8 * kBars + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
};

// the block's shared memory from a 1024-byte aligned base: K, V, the Q and
// dO rings, the consumers' dS^T tiles and dQ sums, the lse and delta rows,
// mbarriers.
// A tile of R rows is kCols blocks of R x 128 bytes, one a 64-column block
template <int Dp>
struct Smem {
  using Dm = Dims<Dp>;
  uint32_t base;
  __device__ uint32_t k() const { return base; }
  __device__ uint32_t v() const { return base + Dm::kKVBytes; }
  __device__ uint32_t q(int st) const {
    return base + 2 * Dm::kKVBytes + st * Dm::kQBytes;
  }
  __device__ uint32_t dout(int st) const {
    return base + 2 * Dm::kKVBytes + (Dm::kStages + st) * Dm::kQBytes;
  }
  __device__ uint32_t ds(int c) const {
    return base + 2 * Dm::kKVBytes + 2 * Dm::kStages * Dm::kQBytes +
           c * Dm::kDsBytes;
  }
  __device__ uint32_t dq(int c) const {
    return ds(kConsumers) + c * Dm::kDqBytes;
  }
  __device__ uint32_t lse(int st) const {
    return base + Dm::kTiles + st * Dm::kRowBytes;
  }
  __device__ uint32_t delta(int st) const {
    return base + Dm::kTiles + (Dm::kStages + st) * Dm::kRowBytes;
  }
  __device__ uint32_t bar(int i) const {
    return base + Dm::kTiles + 2 * Dm::kStages * Dm::kRowBytes + 8 * i;
  }
  __device__ uint32_t full_kv() const { return bar(0); }
  __device__ uint32_t full(int st) const { return bar(1 + st); }
  __device__ uint32_t empty(int st) const {
    return bar(1 + Dm::kStages + st);
  }
};

// a contiguous run of `bytes` (a multiple of 16, both ends 16-B aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// dst[i] += src[i] over `bytes` (a multiple of 16, both 16-B aligned),
// f32, by the TMA unit; one bulk group a call
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// dst[i] = src[i] over `bytes` (as bulk_reduce_add), one bulk group
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the bulk groups of this thread have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until the bulk groups of this thread are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// D (m64n64, f32) = or += A B, both from shared memory; TA / TB: A is
// M-major / B is N-major (the transpose bits), else K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// acc (m64n(Dp)) += A (64 x 64 bf16 in registers, k-steps of 16 of its
// columns) B (64 rows of an MN-major tile at `b_addr`, Dp columns)
template <int Dp>
__device__ __forceinline__ void issue_rs(float (&acc)[Dp / 2],
                                         uint32_t (&a)[16], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kBr / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    if constexpr (Dp == 64)
      wgmma_rs64(acc, f, sw128_desc(b_addr + kk * 16 * 128));
    else
      wgmma_rs128(acc, f, sw128_desc(b_addr + kk * 16 * 128, kBr * 128));
  }
}

// the consumer warpgroup's accumulators across the Q loop
template <int Dp>
struct Grads {
  float dk[Dp / 2], dv[Dp / 2];     // m64n(Dp) layout, 64 keys
};

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do, BwdParams p,
                 Slots sq, Slots skv) {
  using Dm = Dims<Dp>;
  constexpr int kStages = Dm::kStages, kCols = Dm::kCols;
  extern __shared__ uint8_t smem_raw[];
  const Smem<Dp> sm{(smem_u32(smem_raw) + 1023) & ~1023u};
  const int tid = threadIdx.x, lane = tid % 32;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int k0 = j * kBc;
  const int n_q = (p.Sq + kBr - 1) / kBr;
  // causal: the first Q tile with a query at or after the block's first key
  const int i0 = p.causal ? min(k0 / kBr, n_q) : 0;
  const int n_it = n_q - i0;
  const long long row0 = ((long long)b * H + h) * p.SqPad;  // lse, delta

  if (tid == 0) {
    mbar_init(sm.full_kv(), 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(sm.full(i), 1);
      mbar_init(sm.empty(i), 4 * kConsumers);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 keeps the ring full: K_j and V_j once, then Q_i, dO_i and the
  // tile's lse and delta rows for iteration `it` into stage it % kStages
  auto load = [&](int it) {
    const int st = it % kStages, q0 = (i0 + it) * kBr;
    mbar_expect_tx(sm.full(st), Dm::kStageTx);
    for (int cb = 0; cb < kCols; ++cb) {
      tma_load(sm.q(st) + cb * kBr * 128, &map_q, sm.full(st), q0, h, b, sq,
               cb * kColBlock);
      tma_load(sm.dout(st) + cb * kBr * 128, &map_do, sm.full(st), q0, h, b,
               sq, cb * kColBlock);
    }
    bulk_load(sm.lse(st), p.lse2 + row0 + q0, Dm::kRowBytes, sm.full(st));
    bulk_load(sm.delta(st), p.delta + row0 + q0, Dm::kRowBytes,
              sm.full(st));
  };
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(sm.full_kv(), 2 * Dm::kKVBytes);
    for (int cb = 0; cb < kCols; ++cb) {
      tma_load(sm.k() + cb * kBc * 128, &map_k, sm.full_kv(), k0, h, b, skv,
               cb * kColBlock);
      tma_load(sm.v() + cb * kBc * 128, &map_v, sm.full_kv(), k0, h, b, skv,
               cb * kColBlock);
    }
    for (int it = 0; it < min(kStages, n_it); ++it) load(it);
  }

  // ---- consumers: warpgroup c owns keys kc .. kc + 63
  const int c = tid / 128, warp = (tid % 128) / 32;
  const int kc = k0 + 64 * c;
  const int r_a = warp * 16 + (lane >> 2);      // this thread's key rows
  const int key_a = kc + r_a, key_b = key_a + 8;
  const int col2 = 2 * (lane & 3);
  const float scale2 = p.scale * kLog2e;
  const uint32_t k_rows = sm.k() + 64 * c * 128;  // this warpgroup's K, V
  const uint32_t v_rows = sm.v() + 64 * c * 128;
  const uint32_t ds = sm.ds(c);
  const bool leader = tid % 128 == 0;   // issues the warpgroup's bulk adds
  Grads<Dp> g;
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) g.dk[i] = g.dv[i] = 0.f;
  fence_regs(g.dk);
  fence_regs(g.dv);
  if (n_it > 0) mbar_wait(sm.full_kv(), 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages, q0 = (i0 + it) * kBr;
    // the stage iteration it - 1 used, refilled once all eight warps have
    // released it, with iteration it - 1 + kStages
    if (tid == 0 && it > 0 && it - 1 + kStages < n_it) {
      mbar_wait(sm.empty((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load(it - 1 + kStages);
    }
    __syncwarp();                   // warp 0 converged for the wgmmas
    mbar_wait(sm.full(st), (it / kStages) & 1);
    // every key of this warpgroup after every query, or past Skv: p = 0
    if ((p.causal && kc > q0 + kBr - 1) || kc >= p.Skv) {
      if (lane == 0) mbar_arrive(sm.empty(st));
      continue;
    }
    const uint32_t q_t = sm.q(st), do_t = sm.dout(st);
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {      // S^T = K_c Q^T
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss64<0, 0>(s, sw128_desc(k_rows + (kk / 4) * kBc * 128 + off),
                       sw128_desc(q_t + (kk / 4) * kBr * 128 + off), kk);
    }
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {      // dP^T = V_c dO^T
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss64<0, 0>(dp, sw128_desc(v_rows + (kk / 4) * kBc * 128 + off),
                       sw128_desc(do_t + (kk / 4) * kBr * 128 + off), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T: columns are queries q0 + 8 nt + col2 (+1); each group
    // of 4 is packed to bf16 at once (the A fragments of the products over
    // the 64 queries: k-step kk takes [4kk .. 4kk+3]), so the f32 values
    // die as they go
    const bool masked =
        (p.causal && kc + 63 > q0) || kc + 64 > p.Skv;
    uint32_t pf[16], dsf[16];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l = lds_f2(sm.lse(st) + (8 * nt + col2) * 4);
      const float2 dl = lds_f2(sm.delta(st) + (8 * nt + col2) * 4);
      float pr[4], dsr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e;
        pr[e] = ex2(fmaf(s[i], scale2, -((e & 1) ? l.y : l.x)));
        if (masked) {
          const int key = (e & 2) ? key_b : key_a;
          const int query = q0 + 8 * nt + col2 + (e & 1);
          if (key >= p.Skv || (p.causal && key > query)) pr[e] = 0.f;
        }
        dsr[e] = pr[e] * (dp[i] - ((e & 1) ? dl.y : dl.x));
      }
      pf[2 * nt] = pack_bf16(pr[0], pr[1]);
      pf[2 * nt + 1] = pack_bf16(pr[2], pr[3]);
      dsf[2 * nt] = pack_bf16(dsr[0], dsr[1]);
      dsf[2 * nt + 1] = pack_bf16(dsr[2], dsr[3]);
    }
    // dV += P^T dO and dK += dS^T Q, from registers
    fence_regs(g.dv);
    fence_regs(g.dk);
    fence_regs(pf);
    fence_regs(dsf);
    wgmma_fence();
    issue_rs<Dp>(g.dv, pf, do_t);
    issue_rs<Dp>(g.dk, dsf, q_t);
    wgmma_commit();
    // dS^T to shared memory, 128-byte swizzled rows of 64 queries, for
    // dQ's A operand (the chunk of 16 bytes XOR the row's low 3 bits),
    // once the last tile's dQ sums have been read out of dq(c)
    if (leader) bulk_wait_read();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t col = ((nt ^ (r_a & 7)) << 4) + 4 * (lane & 3);
      sts_u32(ds + r_a * 128 + col, dsf[2 * nt]);
      sts_u32(ds + (r_a + 8) * 128 + col, dsf[2 * nt + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    // dQ_i's sum over these 64 keys, dS K_c, 64 columns a product, into
    // dq(c) in the accumulator's own order (a slab of 256 floats for each
    // (nt, row half), 2 a thread: no bank conflicts)
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      float dq[32];
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64<1, 1>(dq, sw128_desc(ds + kk * 16 * 128),
                         sw128_desc(k_rows + cb * kBc * 128 + kk * 16 * 128),
                         kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(pf);               // read by dV's and dK's wgmmas until here
      fence_regs(dsf);
      const uint32_t slab = sm.dq(c) + cb * 64 * 64 * 4 + 8 * (tid % 128);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        sts_f2(slab + (2 * nt) * 1024, dq[4 * nt], dq[4 * nt + 1]);
        sts_f2(slab + (2 * nt + 1) * 1024, dq[4 * nt + 2], dq[4 * nt + 3]);
      }
    }
    if (lane == 0) mbar_arrive(sm.empty(st));
    // the TMA unit adds the sums into the f32 accumulator's tile, whose
    // order the convert kernel reads back (the order of the adds from the
    // blocks of one (b, h) varies from run to run)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (leader && p.slot_stride == 0)
      bulk_reduce_add(p.dq_acc + (row0 + q0) * Dp, sm.dq(c),
                      Dm::kDqBytes);
    else if (leader)                // this warpgroup's own slot, kc / 64
      bulk_store(p.dq_acc + (kc / 64) * p.slot_stride + (row0 + q0) * Dp,
                 sm.dq(c), Dm::kDqBytes);
    fence_regs(g.dv);
    fence_regs(g.dk);
  }
  if (leader) bulk_wait_all();   // its shared memory is read, its adds done

  // dK (times the scale) and dV in bf16, the D real columns of the keys
  // below Skv (D is a multiple of 8: a column pair lies wholly on one side)
  auto* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dkb + h * p.dkh;
  auto* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dvb + h * p.dvh;
#pragma unroll
  for (int dt = 0; dt < Dp / 8; ++dt) {
    const int col = dt * 8 + col2;
    if (col >= p.D) break;
    if (key_a < p.Skv) {
      *reinterpret_cast<uint32_t*>(dkp + key_a * p.dks + col) = pack_bf16(
          g.dk[4 * dt] * p.scale, g.dk[4 * dt + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + key_a * p.dvs + col) =
          pack_bf16(g.dv[4 * dt], g.dv[4 * dt + 1]);
    }
    if (key_b < p.Skv) {
      *reinterpret_cast<uint32_t*>(dkp + key_b * p.dks + col) = pack_bf16(
          g.dk[4 * dt + 2] * p.scale, g.dk[4 * dt + 3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + key_b * p.dvs + col) =
          pack_bf16(g.dv[4 * dt + 2], g.dv[4 * dt + 3]);
    }
  }
}

// ------------------------------------------------- preprocess and convert

constexpr int kRowThreads = 8;           // threads a row, 8 columns each
constexpr int kRowsPerBlock = 32;

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

struct PrepParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;                 // (B, H, Sq), natural log
  float* delta;                     // (B, H, Sq_pad)
  float* lse2;                      // (B, H, Sq_pad)
  float* dq_acc;                    // (B, H, Sq_pad, Dp)
  int H, Sq, SqPad, D, Dp;
  long long rows;                   // B H Sq_pad
  long long ob, os, oh, db, ds, dh;
};

__global__ void __launch_bounds__(kRowThreads * kRowsPerBlock)
flash_bwd_preprocess_kernel(PrepParams p) {
  const long long r =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  const int part = threadIdx.x % kRowThreads;
  if (r >= p.rows) return;          // never splits a warp: rows % 64 == 0
  const int s = (int)(r % p.SqPad);
  const long long bh = r / p.SqPad;
  const int h = (int)(bh % p.H), b = (int)(bh / p.H);
  float sum = 0.f;
  if (s < p.Sq) {
    const __nv_bfloat16* orow = p.o + b * p.ob + s * p.os + h * p.oh;
    const __nv_bfloat16* drow = p.dout + b * p.db + s * p.ds + h * p.dh;
    for (int c = part * 8; c < p.D; c += kRowThreads * 8)
      sum += dot8(*reinterpret_cast<const uint4*>(orow + c),
                  *reinterpret_cast<const uint4*>(drow + c));
  }
#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part == 0) {
    p.delta[r] = sum;
    p.lse2[r] = s < p.Sq ? p.lse[bh * p.Sq + s] * kLog2e : INFINITY;
  }
  float4* acc = reinterpret_cast<float4*>(p.dq_acc + r * p.Dp);
  for (int c = part; c < p.Dp / 4; c += kRowThreads)
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

struct ConvertParams {
  const float* dq_acc;              // (B, H, Sq_pad, Dp), or slots of it
  __nv_bfloat16* dq;
  int H, Sq, SqPad, D, Dp;
  int slots, causal, Skv;           // slots: 0, or the main kernel's
  long long slot_stride;
  float scale;
  long long rows;                   // B H Sq
  long long qb, qs, qh;
};

__global__ void __launch_bounds__(kRowThreads * kRowsPerBlock)
flash_bwd_convert_kernel(ConvertParams p) {
  const long long r =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  const int part = threadIdx.x % kRowThreads;
  if (r >= p.rows) return;
  const int s = (int)(r % p.Sq);
  const long long bh = r / p.Sq;
  const int h = (int)(bh % p.H), b = (int)(bh / p.H);
  // the main kernel's order within a tile of 64 rows: (64-column block,
  // 8-column group nt, row half, warp, lane, 2), with row = 16 warp +
  // lane / 4 + 8 half and column = 64 block + 8 nt + 2 (lane % 4) + (0, 1):
  // 8 columns of a row are 8 floats in a run
  const int t = s % kBr, tt = t % 16;       // the row in its tile
  const float* tile =
      p.dq_acc + (bh * p.SqPad + s - t) * p.Dp +
      ((tt / 8) * 256 + ((t / 16) * 32 + (tt % 8) * 4) * 2);
  __nv_bfloat16* qrow = p.dq + b * p.qb + s * p.qs + h * p.qh;
  // with slots, the 64-key chunks that wrote this row's tile, in order:
  // those below Skv and, causal, at or before the tile
  int n = 1;
  if (p.slots) {
    n = min(p.slots, (p.Skv + 63) / 64);
    if (p.causal) n = min(n, s / kBr + 1);
  }
  for (int c = part * 8; c < p.D; c += kRowThreads * 8) {
    const float* run = tile + (c / 64) * 4096 + ((c % 64) / 8) * 512;
    float4 x = *reinterpret_cast<const float4*>(run);
    float4 y = *reinterpret_cast<const float4*>(run + 4);
    for (int k = 1; k < n; ++k) {
      const float4 u =
          *reinterpret_cast<const float4*>(run + k * p.slot_stride);
      const float4 w =
          *reinterpret_cast<const float4*>(run + k * p.slot_stride + 4);
      x = make_float4(x.x + u.x, x.y + u.y, x.z + u.z, x.w + u.w);
      y = make_float4(y.x + w.x, y.y + w.y, y.z + w.z, y.w + w.w);
    }
    uint4 out;
    out.x = pack_bf16(x.x * p.scale, x.y * p.scale);
    out.y = pack_bf16(x.z * p.scale, x.w * p.scale);
    out.z = pack_bf16(y.x * p.scale, y.y * p.scale);
    out.w = pack_bf16(y.z * p.scale, y.w * p.scale);
    *reinterpret_cast<uint4*>(qrow + c) = out;
  }
}

// ------------------------------------------------------------------ host

constexpr int kTmaHeadDim = 128;

int padded_dim(int D) { return D <= 64 ? 64 : 128; }
int padded_rows(int Sq) { return (Sq + kBr - 1) / kBr * kBr; }
// the deterministic mode's slots: one for each 64 keys of every block
int bwd_slots(int Skv) { return (Skv + kBc - 1) / kBc * kConsumers; }

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <int Dp>
int launch_main(const void* q, const void* k, const void* v,
                const void* dout, const BwdParams& p, int B, int H,
                const long long* st, cudaStream_t stream) {
  constexpr int kSmemBytes = Dims<Dp>::kSmemBytes;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  Slots sq, sk, sv, sdo;
  int err = make_map(fn, &mq, &sq, q, p.D, kBr, p.Sq, H, B, st[1], st[2],
                     st[0]);
  if (!err)
    err = make_map(fn, &mk, &sk, k, p.D, kBc, p.Skv, H, B, st[4], st[5],
                   st[3]);
  if (!err)
    err = make_map(fn, &mv, &sv, v, p.D, kBc, p.Skv, H, B, st[7], st[8],
                   st[6]);
  if (!err)
    err = make_map(fn, &mdo, &sdo, dout, p.D, kBr, p.Sq, H, B, st[10],
                   st[11], st[9]);
  if (err) return err;
  if (sk.s != sv.s || sk.h != sv.h || sk.b != sv.b || sq.s != sdo.s ||
      sq.h != sdo.h || sq.b != sdo.b)
    return (int)cudaErrorInvalidValue;   // k, v and q, do strides order alike
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.Skv + kBc - 1) / kBc), (unsigned)H,
                  (unsigned)B);
  flash_bwd_kernel<Dp><<<grid, kThreads, kSmemBytes, stream>>>(
      mq, mk, mv, mdo, p, sq, sk);
  return (int)cudaGetLastError();
}

bool bad_dims(int B, int H, int S, int D) {
  return B <= 0 || H <= 0 || S <= 0 || D < 8 || D > kTmaHeadDim || D % 8;
}

}  // namespace

// The backward's three launches, in order, on one stream.  bf16 tensors
// in the (B, S, H, D) layout given by element strides of (batch, sequence,
// head), a unit D stride, 16-byte aligned, strides multiples of 8; D a
// multiple of 8, at most 128.  The f32 scratch arrays are contiguous:
// delta and lse2 (B, H, Sq_pad), dq_acc (B, H, Sq_pad, Dp) or, with slots,
// (slots, B, H, Sq_pad, Dp), with Sq_pad = ss_flash_attention_bwd_rows(Sq),
// Dp = ss_flash_attention_bwd_width(D), slots from
// ss_flash_attention_bwd_slots(Skv).

extern "C" int ss_flash_attention_bwd_rows(int Sq) { return padded_rows(Sq); }

extern "C" int ss_flash_attention_bwd_width(int D) { return padded_dim(D); }

extern "C" int ss_flash_attention_bwd_slots(int Skv) { return bwd_slots(Skv); }

// delta = rowsum(do * o), lse2 = lse * log2 e (rows past Sq: 0 and +inf),
// dq_acc = 0.  strides: o's then do's (batch, sequence, head)
extern "C" int ss_flash_attention_bwd_preprocess(
    const void* o, const void* dout, const float* lse, float* delta,
    float* lse2, float* dq_acc, int B, int H, int Sq, int D,
    const long long* strides, void* stream) {
  if (bad_dims(B, H, Sq, D)) return (int)cudaErrorInvalidValue;
  PrepParams p{static_cast<const __nv_bfloat16*>(o),
               static_cast<const __nv_bfloat16*>(dout), lse, delta, lse2,
               dq_acc, H, Sq, padded_rows(Sq), D, padded_dim(D),
               (long long)B * H * padded_rows(Sq), strides[0], strides[1],
               strides[2], strides[3], strides[4], strides[5]};
  flash_bwd_preprocess_kernel<<<row_blocks(p.rows),
                                kRowThreads * kRowsPerBlock, 0,
                                (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dk, dv (unscaled sums times `scale` for dk) and the dQ sums: added into
// dq_acc (slots 0), or, with slots = ss_flash_attention_bwd_slots(Skv),
// each 64 keys' sums stored to a slot of its own (B H Sq_pad Dp floats
// each), which the convert adds in order: the same bits every run.
// strides: q, k, v, do, dk, dv (batch, sequence, head), 18 in all
extern "C" int ss_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse2, const float* delta, float* dq_acc, void* dk,
    void* dv, int B, int H, int Sq, int Skv, int D, int causal, float scale,
    int slots, const long long* strides, void* stream) {
  if (bad_dims(B, H, Sq, D) || Skv <= 0 ||
      (slots && slots != bwd_slots(Skv)))
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const long long slot_stride =
      slots ? (long long)B * H * padded_rows(Sq) * padded_dim(D) : 0;
  BwdParams p{lse2, delta, dq_acc, slot_stride, dk, dv, Sq, Skv,
              padded_rows(Sq), causal ? 1 : 0, D, scale, st[12], st[13],
              st[14], st[15], st[16], st[17]};
  const cudaStream_t s = (cudaStream_t)stream;
  return D <= 64 ? launch_main<64>(q, k, v, dout, p, B, H, st, s)
                 : launch_main<128>(q, k, v, dout, p, B, H, st, s);
}

// dq = dq_acc (or the sum of its slots, as the main kernel wrote them) *
// scale in bf16.  strides: dq's (batch, sequence, head)
extern "C" int ss_flash_attention_bwd_convert(const float* dq_acc, void* dq,
                                              int B, int H, int Sq, int Skv,
                                              int D, int causal, float scale,
                                              int slots,
                                              const long long* strides,
                                              void* stream) {
  if (bad_dims(B, H, Sq, D) || (slots && slots != bwd_slots(Skv)))
    return (int)cudaErrorInvalidValue;
  ConvertParams p{dq_acc, static_cast<__nv_bfloat16*>(dq), H, Sq,
                  padded_rows(Sq), D, padded_dim(D), slots,
                  causal ? 1 : 0, Skv,
                  (long long)B * H * padded_rows(Sq) * padded_dim(D), scale,
                  (long long)B * H * Sq, strides[0], strides[1], strides[2]};
  flash_bwd_convert_kernel<<<row_blocks(p.rows), kRowThreads * kRowsPerBlock,
                             0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one main-kernel block at head dim D, bytes
// (reported by chip_smoke.py); -1 for a head dim the kernel does not take
extern "C" int ss_flash_attention_bwd_smem_bytes(int D) {
  if (D < 1 || D > kTmaHeadDim) return -1;
  return D <= 64 ? Dims<64>::kSmemBytes : Dims<128>::kSmemBytes;
}
