// Causal flash attention forward with an online softmax.
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
// running max starts at -1e30, the normaliser is clamped at 1e-30 and the
// output is cast to the input type.
//
// Bound on an H100 SXM at the serving path's shape (B=8 requests, S=4096,
// H=32 heads, D=64, bf16, causal): operations.  4*B*H*D*S(S+1)/2 = 5.50e11
// FLOP is 0.556 ms at the 989 TFLOP/s bf16 tensor-core peak; q, k, v and
// the output are 537 MB, 0.160 ms at 3.35 TB/s.
//
// Design (right and simple first; wgmma, TMA and warp specialisation are
// later work).  The TPU grid (B, H, q blocks) runs in order on one core
// with K/V of a whole (b, h) resident in VMEM; here each block of 4 warps
// owns one (b, h, 64-row query tile) and walks the KV tiles itself:
//   * the loop over 64-key tiles stops at the diagonal (causal), as the
//     TPU kernel's fori_loop(0, hi) does, so masked tiles cost nothing and
//     the work is the ~S^2/2 of the bound; only tiles that straddle the
//     diagonal or the ragged end of Skv are masked element by element;
//   * Q, K and V tiles go to shared memory by cp.async (K/V double
//     buffered: tile j+1 loads while tile j computes), rows padded by 16 B
//     so the ldmatrix reads are free of bank conflicts; rows past Sq or
//     Skv are zero-filled, never read;
//   * bf16: each warp owns 16 query rows; S = Q K^T and O += P V run on
//     the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     the S accumulator is re-packed in registers as P's A fragment (no
//     trip through shared memory), and the online-softmax rescale is f32
//     in exp2 units (scores pre-multiplied by log2 e);
//   * f32: one thread per query row with scalar FMAs (no TF32), the
//     algorithm check at full precision;
//   * query tiles are issued longest-first (the last causal tile first) so
//     the diagonal's uneven work does not leave a tail of long blocks.
// q, k, v and the output are read and written through (b, s, h) strides
// with a unit stride on D, so the model's (B, S, H, D) layout needs no
// transposed copy; the TPU wrapper's swapaxes was layout plumbing.
//
// Numerics against the TPU kernel: there, p (f32) multiplies V cast to
// f32; on the tensor cores p is rounded to bf16 before P V (the A operand
// of mma.sync is bf16).  That is a rounding difference within the bf16
// tolerance the checks state (max-abs 3e-2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 64;              // the head dim instantiated (llama3.2-1b)
constexpr int kBM = 64;             // query rows per block
constexpr int kBN = 64;             // keys per KV tile
constexpr int kWarps = kBM / 16;    // 16 query rows per warp (bf16 path)
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;         // smem row: 144 B, 16 B of padding
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, causal;
  float scale;                      // 1 / sqrt(D)
  // element strides of batch, sequence and head for q, k, v, o
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  int n = (p.Skv + kBN - 1) / kBN;
  if (p.causal) n = min(n, (q0 + kBM + kBN - 1) / kBN);
  return n;
}

// ------------------------------------------------------------- bf16 path

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of one (b, h) slice into a padded smem tile
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int rows, int tid) {
  constexpr int kChunks = kD / 8;                     // 16 B per chunk
#pragma unroll
  for (int i = 0; i < kBN * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* src =
        ok ? base + (long long)(row0 + r) * row_stride + col : base;
    cp_async16(dst + r * kLd + col, src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(Params p) {
  __shared__ __align__(128) __nv_bfloat16 sQ[kBM * kLd];
  __shared__ __align__(128) __nv_bfloat16 sK[2][kBN * kLd];
  __shared__ __align__(128) __nv_bfloat16 sV[2][kBN * kLd];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const auto* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.qb + h * p.qh;
  const auto* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.kb + h * p.kh;
  const auto* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.vb + h * p.vh;
  auto* op = static_cast<__nv_bfloat16*>(p.o) + b * p.ob + h * p.oh;
  const int hi = kv_tiles(p, q0);

  load_tile(sQ, qp, p.qs, q0, p.Sq, tid);
  load_tile(sK[0], kp, p.ks, 0, p.Skv, tid);
  load_tile(sV[0], vp, p.vs, 0, p.Skv, tid);
  cp_async_commit();

  // this thread's rows of the warp's 16: g and g + 8 (mma C layout)
  const int row_a = q0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int col2 = 2 * (lane & 3);
  const float scale2 = p.scale * kLog2e;
  uint32_t qf[kD / 16][4];
  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int cur = j & 1;
    if (j + 1 < hi) {
      load_tile(sK[cur ^ 1], kp, p.ks, (j + 1) * kBN, p.Skv, tid);
      load_tile(sV[cur ^ 1], vp, p.vs, (j + 1) * kBN, p.Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        ldsm_x4(qf[kk], &sQ[(warp * 16 + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8]);
    }

    // S = Q K^T, 16 x 64 per warp
    float s[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBN / 8; nt += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, &sK[cur][(nt * 8 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                             kk * 16 + ((lane >> 3) & 1) * 8]);
        mma16816(s[nt], qf[kk], bk[0], bk[1]);
        mma16816(s[nt + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask (diagonal and ragged tiles only), scale to log2 units, row max
    const int k0 = j * kBN;
    const bool masked = k0 + kBN > p.Skv || (p.causal && k0 + kBN - 1 > q0);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2;
        if (masked) {
          const int key = k0 + nt * 8 + col2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= p.Skv || (p.causal && key > row)) x = -INFINITY;
        }
        s[nt][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {      // the 4 lanes of a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      o[i][0] *= corr_a;
      o[i][1] *= corr_a;
      o[i][2] *= corr_b;
      o[i][3] *= corr_b;
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx_a);
      s[nt][1] = exp2f(s[nt][1] - mx_a);
      s[nt][2] = exp2f(s[nt][2] - mx_b);
      s[nt][3] = exp2f(s[nt][3] - mx_b);
      l_a += s[nt][0] + s[nt][1];                  // this lane's partial
      l_b += s[nt][2] + s[nt][3];
    }

    // O += P V: P's A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kD / 8; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, &sV[cur][(kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kLd +
                                   dt * 8 + (lane >> 4) * 8]);
        mma16816(o[dt], a, bv[0], bv[1]);
        mma16816(o[dt + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();       // every warp is done with buffer cur
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = dt * 8 + col2;
    if (row_a < p.Sq)
      *reinterpret_cast<uint32_t*>(op + row_a * p.os + col) =
          pack_bf16(o[dt][0] / den_a, o[dt][1] / den_a);
    if (row_b < p.Sq)
      *reinterpret_cast<uint32_t*>(op + row_b * p.os + col) =
          pack_bf16(o[dt][2] / den_b, o[dt][3] / den_b);
  }
}

// -------------------------------------------------------------- f32 path

__global__ void __launch_bounds__(kBM)
flash_fwd_f32_kernel(Params p) {
  __shared__ float sK[kBN][kD];
  __shared__ float sV[kBN][kD];

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + tid;
  const float* kp = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vp = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const int hi = kv_tiles(p, q0);

  float q[kD], acc[kD];
  const float* qrow = static_cast<const float*>(p.q) + b * p.qb + h * p.qh +
                      (long long)row * p.qs;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    q[d] = row < p.Sq ? qrow[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kBN;
    __syncthreads();                  // the previous tile is consumed
    for (int i = tid; i < kBN * kD; i += kBM) {
      const int r = i / kD, d = i % kD;
      const bool ok = k0 + r < p.Skv;
      sK[r][d] = ok ? kp[(long long)(k0 + r) * p.ks + d] : 0.f;
      sV[r][d] = ok ? vp[(long long)(k0 + r) * p.vs + d] : 0.f;
    }
    __syncthreads();
    int n = min(kBN, p.Skv - k0);
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
    for (int d = 0; d < kD; ++d) orow[d] = acc[d] / den;
  }
}

}  // namespace

// dtype: 0 bf16, 1 f32.  strides: 12 element strides, (batch, sequence,
// head) of q, k, v and out in that order; the D stride is 1.
extern "C" int ss_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int H, int Sq, int Skv, int D,
                                      int causal, float scale,
                                      const long long* strides,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (D != kD || Skv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, Sq, Skv, causal ? 1 : 0, scale,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11]};
  const dim3 grid((unsigned)((Sq + kBM - 1) / kBM), (unsigned)H, (unsigned)B);
  if (dtype == 0)
    flash_fwd_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    flash_fwd_f32_kernel<<<grid, kBM, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
