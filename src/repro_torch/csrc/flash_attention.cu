// Causal flash attention forward with an online softmax, for Hopper.
//
// ss_flash_attention_fwd replaces
// repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention_bhsd), which the model's prefill runs
// once per layer (models/layers.py::mha, attn_impl="pallas_flash").  For
// each (batch b, head h) and query row i:
//     out_i = sum_j softmax_j(q_i . k_j / sqrt(D)) v_j
// over keys j <= i when causal (the mask is TOP-LEFT aligned, as the TPU
// kernel's q_pos = iq*q_chunk + iota: query row i sees keys 0..i whatever
// Skv is), over every key otherwise.  Scores and the softmax are f32, the
// running max starts at -1e30, the normaliser is clamped at 1e-30, p is
// rounded to bf16 before P V (the tensor cores' A operand) and the output
// is cast to the input type.  With a non-null `lse` the kernel also writes
// each row's log-sum-exp of its scaled scores, natural log, f32, in a
// contiguous (B, H, Sq) array: lse_i = max_j s_ij + log(sum_j exp(s_ij -
// max_j s_ij)) with s_ij = q_i . k_j / sqrt(D), the normaliser clamped at
// 1e-30 as the output's.  It is the residual models/flash.py's backward
// recomputes the probabilities from (p_ij = exp(s_ij - lse_i)); the
// reference's _flash_fwd_impl returns the same m + log(l).  Serving passes
// null and writes nothing more.
//
// Bound on an H100 SXM at the serving path's shape (B=8 requests, S=4096,
// H=32 heads, D=64, bf16, causal): operations, twice over.  4*B*H*D*S(S+1)/2
// = 5.50e11 FLOP is 0.556 ms at the 989 TFLOP/s bf16 tensor-core peak; the
// softmax needs B*H*S(S+1)/2 = 2.15e9 exp2, 0.51 ms at the special-function
// units' 16 results per SM per clock (132 SMs x 1.98 GHz = 4.2e12/s; 0.55 ms
// at 1.83 GHz), so the two must overlap to get near either; q, k, v and the
// output are 537 MB, 0.160 ms at 3.35 TB/s.
//
// Design (bf16).  One block of three warpgroups owns one (b, h, 128-row
// query tile) and walks 128-key KV tiles up to the diagonal:
//   * warp specialisation: warpgroup 0 is the producer (setmaxnreg down
//     to 40 registers); one of its threads keeps K/V tiles in flight with
//     TMA (cp.async.bulk.tensor, completion on mbarriers with complete_tx)
//     into a 4-stage ring of 128-byte-swizzled shared-memory tiles (a row
//     of D = 64 bf16 is one 128-byte swizzle row).  Warpgroups 1 and 2 are
//     consumers, 64 query rows each; a stage is handed back through an
//     "empty" mbarrier once all eight consumer warps have read it;
//   * wgmma for both products: S = Q K^T as m64n128k16 with Q and K read
//     from shared memory (both K-major), O += P V as m64n64k16 with P from
//     registers (the S accumulators re-packed to bf16) and V from shared
//     memory as an MN-major B operand (the descriptor's transpose bit): no
//     transposed copy of V;
//   * overlap: a consumer issues P(j) V(j) and S(j+1) = Q K(j+1)^T back to
//     back and waits for both, so the tensor cores run one warpgroup's
//     products under the other's softmax (two warpgroups at 168 registers
//     each fill the register file; a second S buffer, to overlap inside a
//     warpgroup as well, does not fit);
//   * the softmax is written for two warps a scheduler: row maxima and
//     sums are trees, not chains, and O's rescale is skipped (exactly) once
//     every factor of a warp is 1;
//   * 128-row query tiles halve the K/V tile loads of 64-row tiles; the
//     loop stops at the diagonal (causal), as the TPU kernel's
//     fori_loop(0, hi) does, and only tiles that straddle the diagonal or
//     the ragged end of Skv are masked element by element; query tiles are
//     issued longest-first so the diagonal's uneven work leaves no tail;
//   * q, k and v are read through 4-D tensor maps over their (b, s, h)
//     strides, so the model's (B, S, H, D) layout needs no transposed copy
//     and TMA zero-fills rows past Sq or Skv (S = 4097 takes no padding
//     copy); the maps are encoded on the host for each call
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library links no -lcuda).
// Head dims.  The TMA kernel takes any head dim 1 <= D <= 128 (the real D
// is a runtime value; 128 < D <= 256 runs the wide kernel further down); it
// is one template over the padded width Dp that a tile is computed at,
// whole 128-byte swizzle rows of 64 columns each: Dp = 64 for D <= 64, Dp =
// 128 (two 64-column blocks, one TMA box each) above.  The tensor maps are
// D wide, so TMA zero-fills columns D..Dp-1 of Q, K and V: they add nothing
// to Q K^T, give zero columns of O, and only the D real columns are stored.
// TMA needs every global stride to be a multiple of 16 bytes, so in the
// (B, S, H, D) and (B, H, S, D) layouts D is a multiple of 8 in bf16 (4 in
// f32); for another D the wrapper passes zero-padded copies at the next such
// width with the real D's scale.  At Dp = 128 a K or V tile is 32 KB, so
// the ring holds 2 stages (Q 32 KB + 4 x 32 KB), and the consumers' O
// accumulator doubles to 64 registers (m64n128 P V): the register split is
// 24 / 240.  D = 64 is the design above, tile for tile.
// The f32 kernel (one thread per query row, scalar FMAs) is the algorithm's
// check at full precision; no path serves f32.  It is a template over a
// padded width too, Dp = 16, 32, 64 or 128, with columns past D read as
// zeros (adding exact zeros to each score) and not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_tma.cuh"

namespace {

using namespace ss;   // flash_tma.cuh: mbarriers, TMA, wgmma descriptors

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                       // (B, H, Sq) f32, or null: not written
  int Sq, Skv, causal;
  int D;                            // the real head dim, <= the padded Dp
  float scale;                      // 1 / sqrt(the unpadded head dim)
  // element strides of batch, sequence and head for q, k, v, o
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ------------------------------------------------------------- bf16 path

constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kConsumers;  // query rows per block
constexpr int kBN = 128;            // keys per KV tile
constexpr int kThreads = 128 * (1 + kConsumers);   // + the producer

// the bf16 kernel's sizes at padded width Dp
template <int Dp>
struct Dims {
  static_assert(Dp == 64 || Dp == 128, "whole 64-column blocks, at most 2");
  static constexpr int kDp = Dp;
  static constexpr int kCols = kDp / kColBlock;     // 64-column blocks
  static constexpr int kStages = kDp == 64 ? 4 : 2;  // K/V ring depth
  // registers a thread: 168 at launch (384 threads, one block an SM);
  // after setmaxnreg the producer keeps 40 (24) and the consumers may take
  // 232 (240) at Dp = 64 (128)
  static constexpr int kProducerRegs = kDp == 64 ? 40 : 24;
  static constexpr int kConsumerRegs = kDp == 64 ? 232 : 240;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                    168 * kThreads,
                "setmaxnreg asks for more registers than the block holds");
  static constexpr int kQBytes = kBM * kDp * 2;
  static constexpr int kTileBytes = kBN * kDp * 2;   // 16 KB or 32 KB
  static constexpr int kSmemBytes =
      kQBytes + 2 * kStages * kTileBytes + 1024 + 128;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
};

// S (m64n128, f32) = or += A (m64k16 from smem) B (k16n128 from smem)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// the block's shared memory: Q, the K and V rings, then the mbarriers,
// from a 1024-byte aligned base (128-byte swizzle needs it).  A tile of R
// rows is kCols blocks of R x 128 bytes, one a 64-column block
template <int Dp>
struct Smem {
  using Dm = Dims<Dp>;
  static constexpr int kStages = Dm::kStages;
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int st) const {
    return base + Dm::kQBytes + st * Dm::kTileBytes;
  }
  __device__ uint32_t v(int st) const {
    return base + Dm::kQBytes + (kStages + st) * Dm::kTileBytes;
  }
  __device__ uint32_t bar(int i) const {
    return base + Dm::kQBytes + 2 * kStages * Dm::kTileBytes + 8 * i;
  }
  __device__ uint32_t full_q() const { return bar(0); }
  __device__ uint32_t full_k(int st) const { return bar(1 + st); }
  __device__ uint32_t full_v(int st) const { return bar(1 + kStages + st); }
  __device__ uint32_t empty(int st) const {
    return bar(1 + 2 * kStages + st);
  }
};

// one consumer warpgroup's state for its 64 query rows
template <int Dp>
struct Rows {
  float o[Dp / 2];                  // O accumulator, m64n(Dp) layout
  float m_a, m_b, l_a, l_b;         // rows g and g + 8 of this thread
};

// softmax of one S tile in place: scores masked where needed, the row
// max and sum carried in `st`, p = exp2 of the scaled scores left in s
// (f32).  -> the factors (rows g, g + 8) that rescale O to the new max
template <int Dp>
__device__ __forceinline__ float2 softmax_tile(float (&s)[kBN / 2],
                                               Rows<Dp>& st,
                                               bool masked, int k0, int row_a,
                                               int Skv, bool causal,
                                               float scale2, int lane) {
  const int col2 = 2 * (lane & 3);
  const int row_b = row_a + 8;
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int key = k0 + (i / 4) * 8 + col2 + (i & 1);
      const int row = (i & 2) ? row_b : row_a;
      if (key >= Skv || (causal && key > row)) s[i] = -INFINITY;
    }
  }
  // row maxima as trees, not chains: two warps a scheduler leave little to
  // hide a chain's latency behind
  float mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = s[i];
#pragma unroll
  for (int i = 8; i < kBN / 2; ++i) mx[i % 8] = fmaxf(mx[i % 8], s[i]);
  // s[i] belongs to row a when (i & 2) == 0
  float mx_a = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[4], mx[5]));
  float mx_b = fmaxf(fmaxf(mx[2], mx[3]), fmaxf(mx[6], mx[7]));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {        // the 4 lanes of a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  // scores enter exp2 units as fma(s, scale2, -m): scale2 > 0 keeps the max
  const float m_a = fmaxf(st.m_a, mx_a * scale2);
  const float m_b = fmaxf(st.m_b, mx_b * scale2);
  const float2 corr = make_float2(ex2(st.m_a - m_a), ex2(st.m_b - m_b));
  st.m_a = m_a;
  st.m_b = m_b;
  float sum[8];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale2, (i & 2) ? -m_b : -m_a));
    sum[i % 8] = i < 8 ? s[i] : sum[i % 8] + s[i];   // this lane's partials
  }
  st.l_a = st.l_a * corr.x + ((sum[0] + sum[1]) + (sum[4] + sum[5]));
  st.l_b = st.l_b * corr.y + ((sum[2] + sum[3]) + (sum[6] + sum[7]));
  return corr;
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float2 corr) {
  // once the row maxima settle, every factor is 1: skip the multiplies
  if (__all_sync(0xffffffffu, corr.x == 1.f && corr.y == 1.f)) return;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    o[4 * i] *= corr.x;
    o[4 * i + 1] *= corr.x;
    o[4 * i + 2] *= corr.y;
    o[4 * i + 3] *= corr.y;
  }
}

// p (f32, the S accumulator layout) -> P V's A fragments in bf16
__device__ __forceinline__ void to_bf16(const float (&s)[kBN / 2],
                                        uint32_t (&p)[kBN / 4]) {
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    p[2 * nt] = pack_bf16(s[4 * nt], s[4 * nt + 1]);
    p[2 * nt + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
  }
}

// issue S = Q K^T for one KV tile (Dp/16 k-steps of 16 dims), committed.
// k-step kk reads 32 bytes of 64-column block kk/4 of Q's and K's rows
template <int Dp>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Dp / 16; ++kk)
    wgmma_qk(s, sw128_desc(q_addr + (kk / 4) * kBM * 128 + (kk % 4) * 32),
             sw128_desc(k_addr + (kk / 4) * kBN * 128 + (kk % 4) * 32), kk);
  wgmma_commit();
  fence_regs(s);
}

// issue O += P V for one KV tile (k-steps of 16 keys), committed
template <int Dp>
__device__ __forceinline__ void issue_pv(float (&o)[Dp / 2],
                                         uint32_t (&p)[kBN / 4],
                                         uint32_t v_addr) {
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    // P's A fragment for keys 16kk..16kk+15: S chunks 2kk and 2kk + 1
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    if constexpr (Dp == 64)
      wgmma_rs64(o, a, sw128_desc(v_addr + kk * 16 * 128));
    else
      wgmma_rs128(o, a, sw128_desc(v_addr + kk * 16 * 128, kBN * 128));
  }
  wgmma_commit();
  fence_regs(o);
}

template <int Dp>
struct Consumer {
  static constexpr int kDp = Dp;
  static constexpr int kStages = Dims<Dp>::kStages;
  const Smem<Dp>& sm;
  const Params& p;
  uint32_t q_addr;
  int hi, q0w, row_a, lane;
  float scale2;
  bool lane0;

  __device__ float2 softmax(int j, float (&s)[kBN / 2],
                           Rows<kDp>& st) const {
    const int k0 = j * kBN;
    const bool masked =
        k0 + kBN > p.Skv || (p.causal && k0 + kBN - 1 > q0w);
    return softmax_tile(s, st, masked, k0, row_a, p.Skv, p.causal != 0,
                        scale2, lane);
  }
  __device__ void qk(int j, float (&s)[kBN / 2]) const {
    const int st = j % kStages;
    mbar_wait(sm.full_k(st), (j / kStages) & 1);
    issue_qk<kDp>(s, q_addr, sm.k(st));
  }
  __device__ void pv(int j, Rows<kDp>& st, uint32_t (&pf)[kBN / 4]) const {
    const int s0 = j % kStages;
    mbar_wait(sm.full_v(s0), (j / kStages) & 1);
    issue_pv<kDp>(st.o, pf, sm.v(s0));
  }
  __device__ void release(int j) const {
    if (lane0) mbar_arrive(sm.empty(j % kStages));
  }

  // softmax(j), then P(j) V(j) and S(j+1) issued together: the other
  // consumer warpgroup's softmax runs under these products
  __device__ void run(Rows<kDp>& st) const {
    float s[kBN / 2];
    uint32_t pf[kBN / 4];
    qk(0, s);
    for (int j = 0; j < hi; ++j) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(st.o);
      fence_regs(pf);
      if (j > 0) release(j - 1);
      rescale(st.o, softmax(j, s, st));
      to_bf16(s, pf);
      pv(j, st, pf);
      if (j + 1 < hi) qk(j + 1, s);
    }
    wgmma_wait<0>();
    fence_regs(st.o);
  }
};

template <int Dp>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, Params p,
                      Slots sq, Slots skv) {
  using Dm = Dims<Dp>;
  constexpr int kStages = Dm::kStages, kDp = Dm::kDp;
  extern __shared__ uint8_t smem_raw[];
  const Smem<Dp> sm{(smem_u32(smem_raw) + 1023) & ~1023u};
  const int tid = threadIdx.x, lane = tid % 32;
  // the warpgroup, provably uniform across each warp (setmaxnreg needs it)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  int hi = (p.Skv + kBN - 1) / kBN;
  if (p.causal) hi = min(hi, (q0 + kBM + kBN - 1) / kBN);

  if (tid == 0) {
    mbar_init(sm.full_q(), 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(sm.full_k(i), 1);
      mbar_init(sm.full_v(i), 1);
      mbar_init(sm.empty(i), 4 * kConsumers);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(Dm::kProducerRegs));
    if (tid == 0) {
      // one box a 64-column block; the barrier counts the whole tile
      mbar_expect_tx(sm.full_q(), Dm::kQBytes);
      for (int cb = 0; cb < Dm::kCols; ++cb)
        tma_load(sm.q() + cb * kBM * 128, &map_q, sm.full_q(), q0, h, b, sq,
                 cb * kColBlock);
      for (int j = 0; j < hi; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(sm.empty(st), (j / kStages - 1) & 1);
        mbar_expect_tx(sm.full_k(st), Dm::kTileBytes);
        for (int cb = 0; cb < Dm::kCols; ++cb)
          tma_load(sm.k(st) + cb * kBN * 128, &map_k, sm.full_k(st), j * kBN,
                   h, b, skv, cb * kColBlock);
        mbar_expect_tx(sm.full_v(st), Dm::kTileBytes);
        for (int cb = 0; cb < Dm::kCols; ++cb)
          tma_load(sm.v(st) + cb * kBN * 128, &map_v, sm.full_v(st), j * kBN,
                   h, b, skv, cb * kColBlock);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows q0 + 64c .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(Dm::kConsumerRegs));
    const int c = wg - 1, warp = (tid % 128) / 32;
    const int q0w = q0 + 64 * c;
    const int row_a = q0w + warp * 16 + (lane >> 2);
    const float scale2 = p.scale * kLog2e;
    const uint32_t q_addr = sm.q() + c * 64 * 128;
    Rows<kDp> st;
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) st.o[i] = 0.f;
    fence_regs(st.o);               // zeroed before the first wgmma is issued
    st.m_a = st.m_b = kNegInf;
    st.l_a = st.l_b = 0.f;
    mbar_wait(sm.full_q(), 0);
    const Consumer<Dp> con{sm, p, q_addr, hi, q0w, row_a, lane, scale2,
                           lane == 0};
    con.run(st);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      st.l_a += __shfl_xor_sync(0xffffffffu, st.l_a, off);
      st.l_b += __shfl_xor_sync(0xffffffffu, st.l_b, off);
    }
    const float den_a = fmaxf(st.l_a, 1e-30f), den_b = fmaxf(st.l_b, 1e-30f);
    auto* op = static_cast<__nv_bfloat16*>(p.o) + b * p.ob + h * p.oh;
    const int row_b = row_a + 8, col2 = 2 * (lane & 3);
    // the running max is in exp2 units (scores times scale * log2 e):
    // times ln 2 it is the max of the scaled scores; the four lanes of a
    // row hold the same max and sum, the first of them writes
    if (p.lse != nullptr && (lane & 3) == 0) {
      float* lp = p.lse + ((long long)b * gridDim.y + h) * p.Sq;
      if (row_a < p.Sq) lp[row_a] = fmaf(st.m_a, kLn2, logf(den_a));
      if (row_b < p.Sq) lp[row_b] = fmaf(st.m_b, kLn2, logf(den_b));
    }
    // the D real columns (columns D..Dp-1 of O are zeros, not stored; D is
    // a multiple of 8, so a column pair lies wholly on one side)
#pragma unroll
    for (int dt = 0; dt < kDp / 8; ++dt) {
      const int col = dt * 8 + col2;
      if (col >= p.D) break;
      if (row_a < p.Sq)
        *reinterpret_cast<uint32_t*>(op + row_a * p.os + col) =
            pack_bf16(st.o[4 * dt] / den_a, st.o[4 * dt + 1] / den_a);
      if (row_b < p.Sq)
        *reinterpret_cast<uint32_t*>(op + row_b * p.os + col) =
            pack_bf16(st.o[4 * dt + 2] / den_b, st.o[4 * dt + 3] / den_b);
    }
  }
}

// -------------------------------------------------------------- f32 path

constexpr int kBM32 = 64;           // query rows (one thread each) per block

// keys per KV tile: 64, or 32 above Dp = 64 (two f32 tiles within the 48
// KB of static shared memory)
template <int Dp>
constexpr int kBN32Of = Dp <= 64 ? 64 : 32;

template <int Dp>
__device__ __forceinline__ int kv_tiles32(const Params& p, int q0) {
  constexpr int kBN32 = kBN32Of<Dp>;
  int n = (p.Skv + kBN32 - 1) / kBN32;
  if (p.causal) n = min(n, (q0 + kBM32 + kBN32 - 1) / kBN32);
  return n;
}

// q and acc of Dp floats a thread live in registers; at Dp = 128 they
// spill.  Columns D..Dp-1 are zeros in q, K and V
template <int Dp>
__global__ void __launch_bounds__(kBM32)
flash_fwd_f32_kernel(Params p) {
  constexpr int kD = Dp, kBN32 = kBN32Of<Dp>;
  __shared__ float sK[kBN32][kD];
  __shared__ float sV[kBN32][kD];

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + tid;
  const float* kp = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vp = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const int hi = kv_tiles32<Dp>(p, q0);

  float q[kD], acc[kD];
  const float* qrow = static_cast<const float*>(p.q) + b * p.qb + h * p.qh +
                      (long long)row * p.qs;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    q[d] = row < p.Sq && d < p.D ? qrow[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kBN32;
    __syncthreads();                  // the previous tile is consumed
    for (int i = tid; i < kBN32 * kD; i += kBM32) {
      const int r = i / kD, d = i % kD;
      const bool ok = k0 + r < p.Skv && d < p.D;
      sK[r][d] = ok ? kp[(long long)(k0 + r) * p.ks + d] : 0.f;
      sV[r][d] = ok ? vp[(long long)(k0 + r) * p.vs + d] : 0.f;
    }
    __syncthreads();
    int n = min(kBN32, p.Skv - k0);
    if (p.causal) n = min(n, row - k0 + 1);
    for (int jj = 0; jj < n; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(q[d], sK[jj][d], s);
      s *= p.scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new), pj = expf(s - m_new);
      l = l * corr + pj;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(pj, sV[jj][d], acc[d] * corr);
      m = m_new;
    }
  }
  if (row < p.Sq) {
    float* orow = static_cast<float*>(p.o) + b * p.ob + h * p.oh +
                  (long long)row * p.os;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d < p.D) orow[d] = acc[d] / den;
    if (p.lse != nullptr)
      p.lse[((long long)b * gridDim.y + h) * p.Sq + row] = m + logf(den);
  }
}

// ------------------------------------------------------------- wide path

// Head dims 128 < D <= 256, bf16 or f32: no config attends there, but the
// TPU kernel takes any D, so this kernel is written to be right and simple
// (the wgmma template above would need m64n256 P V accumulators, 128
// registers a thread beside S and P, and spill).  One block of 256 threads
// owns a (b, h, 32-row query tile) and walks 32-key tiles up to the
// diagonal with an online softmax, everything f32 in shared memory:
//   * Q (32 x 256), K (32 x 256) and V (32 x 256), converted to f32 as they
//     are loaded (columns past D and rows past the end as zeros); Q and K
//     rows have an odd pitch, so the 8 keys and 4 query rows a warp reads at
//     one column fall in distinct banks;
//   * S = Q K^T: thread t computes row t / 8 against keys t % 8 + 8 i (i < 4)
//     over the D real columns;
//   * the softmax: a warp per 4 rows, a lane per key (32 keys a tile), the
//     row max and sum by shuffles; p stays f32 (the plain version's), the
//     running max starts at -1e30 and the normaliser is clamped at 1e-30;
//   * O += P V: thread t owns row t / 8 at columns t % 8 + 8 i (i < 32).
// Bound: the same FLOPs as the bf16 kernel at D, but on the FP32 lanes
// through shared memory (about one shared load an FMA): it is slow by
// design; PERF.md gives its time beside SDPA's.
constexpr int kWideDp = 256;
constexpr int kWideBM = 32;
constexpr int kWideBN = 32;
constexpr int kWideThreads = 256;
constexpr int kWidePitch = kWideDp + 1;   // Q and K rows: odd, no conflicts
constexpr int kWideSmemBytes =
    4 * (2 * kWideBM * kWidePitch + kWideBN * kWideDp +
         kWideBM * (kWideBN + 1) + 3 * kWideBM);

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide_kernel(Params p) {
  extern __shared__ float wide_smem[];
  float* sQ = wide_smem;                          // [kWideBM][kWidePitch]
  float* sK = sQ + kWideBM * kWidePitch;          // [kWideBN][kWidePitch]
  float* sV = sK + kWideBN * kWidePitch;          // [kWideBN][kWideDp]
  float* sP = sV + kWideBN * kWideDp;             // [kWideBM][kWideBN + 1]
  float* sM = sP + kWideBM * (kWideBN + 1);       // running max a row
  float* sL = sM + kWideBM;                       // running sum a row
  float* sC = sL + kWideBM;                       // this tile's rescale

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWideBM;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qp = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* kp = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* vp = static_cast<const T*>(p.v) + b * p.vb + h * p.vh;
  int hi = (p.Skv + kWideBN - 1) / kWideBN;
  if (p.causal) hi = min(hi, (q0 + kWideBM + kWideBN - 1) / kWideBN);

  for (int i = tid; i < kWideBM * kWideDp; i += kWideThreads) {
    const int r = i / kWideDp, d = i % kWideDp;
    sQ[r * kWidePitch + d] =
        q0 + r < p.Sq && d < p.D ? load_f32(qp + (q0 + r) * p.qs + d) : 0.f;
  }
  if (tid < kWideBM) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  const int r = tid / 8, c0 = tid % 8;            // S and O: row, column
  float acc[kWideDp / 8];
#pragma unroll
  for (int i = 0; i < kWideDp / 8; ++i) acc[i] = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kWideBN;
    __syncthreads();                              // the last tile is used
    for (int i = tid; i < kWideBN * kWideDp; i += kWideThreads) {
      const int kr = i / kWideDp, d = i % kWideDp;
      const bool ok = k0 + kr < p.Skv && d < p.D;
      sK[kr * kWidePitch + d] =
          ok ? load_f32(kp + (long long)(k0 + kr) * p.ks + d) : 0.f;
      sV[kr * kWideDp + d] =
          ok ? load_f32(vp + (long long)(k0 + kr) * p.vs + d) : 0.f;
    }
    __syncthreads();
    {                                             // S = Q K^T, scaled
      float s[kWideBN / 8] = {0.f, 0.f, 0.f, 0.f};
      const float* qr = sQ + r * kWidePitch;
#pragma unroll 8
      for (int d = 0; d < p.D; ++d) {
        const float qd = qr[d];
#pragma unroll
        for (int i = 0; i < kWideBN / 8; ++i)
          s[i] = fmaf(qd, sK[(c0 + 8 * i) * kWidePitch + d], s[i]);
      }
#pragma unroll
      for (int i = 0; i < kWideBN / 8; ++i)
        sP[r * (kWideBN + 1) + c0 + 8 * i] = s[i] * p.scale;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWideBM / 8; ++rr) {    // the softmax, a warp
      const int row = warp * (kWideBM / 8) + rr;  // per 4 rows
      const int key = k0 + lane;
      float s = sP[row * (kWideBN + 1) + lane];
      if (key >= p.Skv || (p.causal && key > q0 + row)) s = -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      const float pj = expf(s - m_new);
      float sum = pj;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[row * (kWideBN + 1) + lane] = pj;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[row] = corr;
        sL[row] = sL[row] * corr + sum;
        sM[row] = m_new;
      }
    }
    __syncthreads();
    const float corr = sC[r];                     // O += P V
#pragma unroll
    for (int i = 0; i < kWideDp / 8; ++i) acc[i] *= corr;
    const int n = min(kWideBN, p.Skv - k0);
    for (int jj = 0; jj < n; ++jj) {
      const float pj = sP[r * (kWideBN + 1) + jj];
      const float* vr = sV + jj * kWideDp + c0;
#pragma unroll
      for (int i = 0; i < kWideDp / 8; ++i) acc[i] = fmaf(pj, vr[8 * i], acc[i]);
    }
  }
  __syncthreads();
  const int row = q0 + r;
  if (row < p.Sq) {
    const float den = fmaxf(sL[r], 1e-30f);
    T* orow = static_cast<T*>(p.o) + b * p.ob + h * p.oh +
              (long long)row * p.os;
#pragma unroll
    for (int i = 0; i < kWideDp / 8; ++i)
      if (c0 + 8 * i < p.D) store_from_f32(orow + c0 + 8 * i, acc[i] / den);
    if (p.lse != nullptr && c0 == 0)
      p.lse[((long long)b * gridDim.y + h) * p.Sq + row] =
          sM[r] + logf(den);
  }
}

// ------------------------------------------------------------------ host

template <int Dp>
int launch_bf16(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr int kSmemBytes = Dims<Dp>::kSmemBytes;
  const int D = p.D;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  Slots sq, sk, sv;
  int err =
      make_map(fn, &mq, &sq, p.q, D, kBM, p.Sq, H, B, p.qs, p.qh, p.qb);
  if (!err)
    err = make_map(fn, &mk, &sk, p.k, D, kBN, p.Skv, H, B, p.ks, p.kh, p.kb);
  if (!err)
    err = make_map(fn, &mv, &sv, p.v, D, kBN, p.Skv, H, B, p.vs, p.vh, p.vb);
  if (err) return err;
  if (sk.s != sv.s || sk.h != sv.h || sk.b != sv.b)
    return (int)cudaErrorInvalidValue;        // k and v strides order alike
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<Dp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.Sq + kBM - 1) / kBM), (unsigned)H,
                  (unsigned)B);
  flash_fwd_bf16_kernel<Dp><<<grid, kThreads, kSmemBytes, stream>>>(
      mq, mk, mv, p, sq, sk);
  return (int)cudaGetLastError();
}

template <int Dp>
int launch_f32(const Params& p, int B, int H, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.Sq + kBM32 - 1) / kBM32), (unsigned)H,
                  (unsigned)B);
  flash_fwd_f32_kernel<Dp><<<grid, kBM32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const Params& p, int B, int H, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.Sq + kWideBM - 1) / kWideBM), (unsigned)H,
                  (unsigned)B);
  flash_fwd_wide_kernel<T><<<grid, kWideThreads, kWideSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

constexpr int kTmaHeadDim = 128;    // the wgmma kernel's widest tile
constexpr int kMaxHeadDim = kWideDp;

}  // namespace

// dtype: 0 bf16, 1 f32.  strides: 12 element strides, (batch, sequence,
// head) of q, k, v and out in that order; the D stride is 1.  D <= 128 runs
// the TMA kernels (16-byte strides), 128 < D <= 256 the wide kernel (any
// strides).  scale: the softmax scale, 1 / sqrt of the real head dim (a
// caller that zero-pads D to reach TMA's strides passes the unpadded one).  lse: a
// contiguous (B, H, Sq) f32 array for each row's log-sum-exp, or null.
extern "C" int ss_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int dtype,
                                      int B, int H, int Sq, int Skv, int D,
                                      int causal, float scale,
                                      const long long* strides,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Skv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (D < 1 || D > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, lse, Sq, Skv, causal ? 1 : 0, D, scale,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11]};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D > kTmaHeadDim)
    return dtype == 0 ? launch_wide<__nv_bfloat16>(p, B, H, st)
                      : launch_wide<float>(p, B, H, st);
  if (dtype == 0)
    return D <= 64 ? launch_bf16<64>(p, B, H, st)
                   : launch_bf16<128>(p, B, H, st);
  if (D <= 16) return launch_f32<16>(p, B, H, st);
  if (D <= 32) return launch_f32<32>(p, B, H, st);
  if (D <= 64) return launch_f32<64>(p, B, H, st);
  return launch_f32<128>(p, B, H, st);
}

// dynamic shared memory of one bf16 block at head dim D, bytes (reported
// by chip_smoke.py); -1 for a head dim the kernel does not take
extern "C" int ss_flash_attention_smem_bytes(int D) {
  if (D < 1 || D > kMaxHeadDim) return -1;
  if (D > kTmaHeadDim) return kWideSmemBytes;
  return D <= 64 ? Dims<64>::kSmemBytes : Dims<128>::kSmemBytes;
}
