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
// Head dims.  The kernel takes any head dim 1 <= D <= 128 (the real D is a
// runtime value); it is one template over the padded width Dp that a tile
// is computed at, whole 128-byte swizzle rows of 64 columns each: Dp = 64
// for D <= 64, Dp = 128 (two 64-column blocks, one TMA box each) above.
// The tensor maps are D wide, so TMA zero-fills columns D..Dp-1 of Q, K and
// V: they add nothing to Q K^T, give zero columns of O, and only the D real
// columns are stored.  TMA needs every global stride to be a multiple of 16
// bytes, so in the (B, S, H, D) and (B, H, S, D) layouts D is a multiple of
// 8 in bf16 (4 in f32); the wrapper refuses other strides.  At Dp = 128 a K or V tile is 32 KB, so the ring holds
// 2 stages (Q 32 KB + 4 x 32 KB), and the consumers' O accumulator doubles
// to 64 registers (m64n128 P V): the register split is 24 / 240.  D = 64 is
// the design above, tile for tile.
// The f32 kernel (one thread per query row, scalar FMAs) is the algorithm's
// check at full precision; no path serves f32.  It is a template over a
// padded width too, Dp = 16, 32, 64 or 128, with columns past D read as
// zeros (adding exact zeros to each score) and not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                       // (B, H, Sq) f32, or null: not written
  int Sq, Skv, causal;
  int D;                            // the real head dim, <= the padded Dp
  float scale;                      // 1 / sqrt(D)
  // element strides of batch, sequence and head for q, k, v, o
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// ------------------------------------------------------------- bf16 path

constexpr int kConsumers = 2;       // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kConsumers;  // query rows per block
constexpr int kBN = 128;            // keys per KV tile
constexpr int kThreads = 128 * (1 + kConsumers);   // + the producer
constexpr int kColBlock = 64;       // columns of a 128-byte swizzle row

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

// 4-D tensor map coordinates: the slot of each of (s, h, b) in dims 1..3
struct Slots {
  int s, h, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers and tiles are addressed by their shared-space addresses
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait that
// never completes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box: columns col..col+63 of `rows` rows at (row, h, b)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h, int b,
                                         Slots sl, int col) {
  int c[4];
#pragma unroll
  for (int i = 1; i < 4; ++i)        // selects, no runtime-indexed array
    c[i] = sl.s == i ? row : (sl.h == i ? h : b);
  c[0] = col;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c[0]),
      "r"(c[1]), "r"(c[2]), "r"(c[3])
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; tiles 1024-B aligned.
// `lbo`: an MN-major operand's stride from one 64-column block to the next
// (read only when N spans more than one block)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) |        // 8 rows of 128 B
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving definitions or uses of r across a wgmma
// fence, commit or wait (a definition inside the pipeline stage would make
// ptxas serialise the wgmmas)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

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

// O (m64n64, f32) += P (m64k16 bf16 in registers) V (k16n64, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (m64n128, f32) += P (m64k16 bf16 in registers) V (k16n128, MN-major,
// two 64-column blocks `lbo` bytes apart)
__device__ __forceinline__ void wgmma_pv128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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
      wgmma_pv(o, a, sw128_desc(v_addr + kk * 16 * 128));
    else
      wgmma_pv128(o, a, sw128_desc(v_addr + kk * 16 * 128, kBN * 128));
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

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a bf16 (D, s, h, b) tensor as a 4-D tensor map, its outer dims ordered
// by stride; boxes of 64 columns x `rows` x 1 x 1, 128-byte swizzle; rows
// past the end and columns past D read as zeros.  -> 0 or a CUDA error
int make_map(EncodeTiled fn, CUtensorMap* map, Slots* slots, const void* base,
             int D, int rows, long long S, long long H, long long B,
             long long ss, long long sh, long long sb) {
  struct Dim {
    long long size, stride;
    cuuint32_t box;
    int which;                      // 0 s, 1 h, 2 b
  } d[3] = {{S, ss, (cuuint32_t)rows, 0}, {H, sh, 1, 1}, {B, sb, 1, 2}};
  for (int i = 1; i < 3; ++i)       // insertion sort by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)d[0].size,
                        (cuuint64_t)d[1].size, (cuuint64_t)d[2].size};
  cuuint64_t strides[3] = {(cuuint64_t)d[0].stride * 2,
                           (cuuint64_t)d[1].stride * 2,
                           (cuuint64_t)d[2].stride * 2};
  cuuint32_t box[4] = {(cuuint32_t)kColBlock, d[0].box, d[1].box,
                       d[2].box};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  int* slot[3] = {&slots->s, &slots->h, &slots->b};
  for (int i = 0; i < 3; ++i) *slot[d[i].which] = i + 1;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

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

constexpr int kMaxHeadDim = 128;

}  // namespace

// dtype: 0 bf16, 1 f32.  strides: 12 element strides, (batch, sequence,
// head) of q, k, v and out in that order; the D stride is 1.  lse: a
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
  return D <= 64 ? Dims<64>::kSmemBytes : Dims<128>::kSmemBytes;
}
