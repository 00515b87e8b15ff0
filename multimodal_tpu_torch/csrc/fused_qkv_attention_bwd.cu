// Backward of the fused QKV self-attention, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_qkv_attention_bwd_impl`
// (kernel bodies `_qkv_attn_bwd_kernel` / `_qkv_attn_bwd_kernel_kb`, head
// loop `_qkv_attn_bwd_loop`).
//
// What it computes, per batch row b and head h (Dh = D / H), from qkv
// (B, S, 3D) and the output gradient g (B, S, D), both of the compute type T:
//   s    = (q_h . k_h^T) * scale (+ key_bias[b, :]), causal -> -1e30 above
//          the diagonal; p = softmax(s)                       fp32, recomputed
//   dv   = T(p)^T . g_h                                        fp32 sum
//   dp   = g_h . v_h^T                                         fp32
//   ds   = p * (dp - rowsum(dp * p)) * scale                   from the fp32 p
//   dq   = T(ds) . k_h,  dk = T(ds)^T . q_h                    fp32 sums
// dq, dk and dv are written into dqkv (B, S, 3D) at the head's column offsets
// of the [q | k | v] layout, rounded to T. The scores, p and ds never reach
// device memory; the forward saved nothing but qkv.
//
// What bounds it on this card: bytes. It must read qkv and g once and write
// dqkv once, 7 * B * S * D * sizeof(T) bytes (138 MB for the CLIP vision
// tower at batch 256 in bf16), against 5 products of S x S x Dh per
// (b, h), a few GFLOP, far below the card's balance point.
//
// Design: one block per (head, batch row), as the forward, so the head's q,
// k, v and g are read straight from the fused layouts (row strides 3D and
// D, no split copy). Two phases:
//   1. warps own query rows: recompute the whole score row (exact softmax,
//      S <= 256, no online rescaling), dp, the row sum and ds in fp32; dq
//      of the row is a sum over its own keys, so it is finished and written
//      here;
//   2. warps own key rows: dv and dk sum over the query rows.
// Masked keys (causal, or a -1e30 key bias) get exp() == 0 exactly, hence
// p = ds = 0 and dk = dv = 0 for a key no query sees. Under the causal mask
// a row whose every visible key the key bias masks has every score at
// -1e30, above the diagonal too (the TPU kernel adds the bias, then writes
// -1e30 there): its p is 1 / S at every key, and every route takes all S
// keys into that row's sums and that row into every key's.
//
// bf16 at head width 64 and S <= 128 (CLIP, ViT-B/32, BERT-base) runs on
// the tensor cores: q, k, v, g staged in bf16 with cp.async; a warp per
// 16-row tile; q . k^T and g . v^T are `mma.sync` m16n8k16 products with
// the score and dp tiles in registers; the ds tiles, rounded, are re-used in
// registers as the A fragment of dq = ds . k. Phase 1 leaves the T(p) and
// T(ds) matrices in shared memory, and phase 2 reads their tiles transposed
// with `ldmatrix.trans` as the A fragments of dv = p^T . g and
// dk = ds^T . q. The two S x S bf16 matrices are what caps this path at
// S <= 128. From S = 81 to 256 (ViT-B/16's 197), the route
// (ops/fused_encoder.py:_attention_bwd_route) takes the Hopper kernel,
// qkv_attention_bwd_wgmma_kernel: TMA brings the head's q, k, v and g (128
// KB at S = 256) through 3-d views of the fused layouts, and every product
// runs on `wgmma` (csrc/wgmma_gemm.cuh). Its bound at ViT-B/16's
// (256, 197, 768, 12) is bytes, 0.162 ms at 3.35 TB/s. Its old `mma.sync`
// kernel there recomputed the score tiles four times and dp three, with no
// load in flight under the products (1.556 ms against the library
// backward's 0.648 on an H100 80GB HBM3 at 700 W, PERF.md); this one computes
// each score row once a pass: pass 1 keeps a 64-query tile's whole score
// and dp rows in the registers of the two warpgroups, half the keys each
// (an exact softmax, no sweeps), and keeps per query row the softmax's max,
// sum and rowsum(dp p); pass 2 recomputes the transposed tiles of 64 keys
// once from those statistics, so no S x S matrix is ever stored; up to
// S = 224 each warpgroup's half is 112 rows, not 128, so the padding's
// last 32 rows cost nothing. What holds it (0.637-0.651 ms at ViT-B/16's
// shape against the library's 0.644, PERF.md): 167 KB of shared memory keep one
// block on an SM, whose loads and products mostly take turns, and the
// ragged last 64-row tile costs a whole tile; k and v arrive on one
// barrier and q's and g's 64-row boxes on one each, so pass 1's first tile
// starts before the rest has landed. Below S = 81 its padding to 128 rows
// costs more than the `mma.sync` kernel's S x S matrices (0.156 against
// 0.092 ms at CLIP's S = 50), so the route keeps that kernel there.
//
// Every other shape the forward takes (S <= 256, head width up to 128, fp32
// or bf16) runs on the FP32 pipes with no S x S matrix in shared memory:
// phase 1 stages K and V transposed in fp32 (odd pitch: conflict-free
// whether a lane walks keys or columns) and keeps, per query row, only the
// softmax's max, sum and rowsum(dp p) (3 floats); phase 2 stages Q and G
// transposed in their place and, for each key row, recomputes that key's
// column of scores and dp from them: p and ds come out bitwise as in phase
// 1 (the same fp32 sums in the same order). Shared memory is two head-sized
// matrices, the statistics and each warp's rows, 226 KB at most (head width
// 128, S = 181, the forward's limit there), so the backward takes exactly
// the forward's shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using mm::from_f;
using mm::to_f;

constexpr int kWarps = 8;  // warps per block on the FP32-pipe path

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Under the causal mask with a key bias, the query rows [0, n) of batch row
// b whose every visible key the bias masks: n is the first key the bias
// leaves open (above -1e20), S if none. Such a row's scores all sit at
// -1e30, the keys above the diagonal too, so its p is uniform over all S
// keys (as in the TPU kernel) and every key enters its p, dp, ds and dq and
// takes it into dk and dv. kb: the batch row's S biases; the whole warp
// calls it.
__device__ __forceinline__ int masked_rows(const float* kb, int S) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < S; j0 += 32) {
    const unsigned open = __ballot_sync(0xffffffffu, j0 + lane < S && kb[j0 + lane] > -1e20f);
    if (open) return j0 + __ffs(open) - 1;
  }
  return S;
}

// Shared memory, in floats, of the FP32-pipe path at sequence length `s`
// and head width `dh`: two transposed head matrices, three statistics per
// query row, and each warp's two rows of width dh and two of width s.
__host__ __device__ inline int smem_floats(int s, int dh) {
  const int sp = ((s + 31) / 32) * 32;
  return 2 * dh * (sp + 1) + 3 * sp + kWarps * (2 * dh + 2 * sp);
}

// NT: 32-key chunks per score row (S <= 32 * NT).
// NC: 32-column chunks of the head a lane owns (Dh <= 32 * NC).
template <typename T, int NT, int NC>
__global__ void __launch_bounds__(kWarps * 32)
qkv_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                         const float* __restrict__ key_bias, T* __restrict__ dqkv, int S, int D,
                         int Dh, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int sp = ((S + 31) / 32) * 32;
  const int kp = sp + 1;                  // odd pitch of the transposed matrices
  float* at = smem;                       // [Dh][kp]  K^T, then Q^T
  float* bt = at + Dh * kp;               // [Dh][kp]  V^T, then G^T
  float* row_m = bt + Dh * kp;            // [sp]      per query row: the max score
  float* row_l = row_m + sp;              //           the softmax's sum
  float* row_rs = row_l + sp;             //           rowsum(dp * p)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ra = row_rs + sp + warp * (2 * Dh + 2 * sp);  // [Dh] the warp's q or k row
  float* rb = ra + Dh;                                 // [Dh] its g or v row
  float* w0 = rb + Dh;                                 // [sp] T(ds), then T(p)
  float* w1 = w0 + sp;                                 // [sp] T(ds) in phase 2

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d3 = 3 * D;
  const T* base = qkv + (size_t)b * S * d3 + h * Dh;
  const T* gbase = g + (size_t)b * S * D + h * Dh;
  T* obase = dqkv + (size_t)b * S * d3 + h * Dh;
  const float* kb = key_bias ? key_bias + (size_t)b * S : nullptr;

  // Stage x^T and y^T of the head ([Dh][kp]); padded rows read as zero.
  auto stage = [&](const T* x, int ldx, const T* y, int ldy) {
    for (int idx = threadIdx.x; idx < sp * Dh; idx += blockDim.x) {
      const int j = idx / Dh;
      const int c = idx - j * Dh;
      const bool in = j < S;
      at[c * kp + j] = in ? to_f(x[(size_t)j * ldx + c]) : 0.f;
      bt[c * kp + j] = in ? to_f(y[(size_t)j * ldy + c]) : 0.f;
    }
  };

  // Rows [0, nm) may see only keys the bias masks (masked_rows).
  const int nm = causal && kb ? masked_rows(kb, S) : 0;

  // Phase 1: a warp owns query rows; K^T and V^T staged.
  stage(base + D, d3, base + 2 * D, d3);
  __syncthreads();
  for (int i = warp; i < S; i += kWarps) {
    for (int c = lane; c < Dh; c += 32) {
      ra[c] = to_f(base[(size_t)i * d3 + c]);
      rb[c] = to_f(gbase[(size_t)i * D + c]);
    }
    __syncwarp();
    const int jend = causal && i >= nm ? i + 1 : S;  // keys with p > 0 in row i
    float sc[NT], dp[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) sc[t] = dp[t] = 0.f;
    for (int c = 0; c < Dh; ++c) {
      const float qc = ra[c], gc = rb[c];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (32 * t < jend) {
          sc[t] = fmaf(qc, at[c * kp + 32 * t + lane], sc[t]);
          dp[t] = fmaf(gc, bt[c * kp + 32 * t + lane], dp[t]);
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = 32 * t + lane;
      float s;
      if (j >= S) {
        s = -INFINITY;  // padding: not a key at all
      } else {
        s = sc[t] * scale;
        if (kb) s += kb[j];
        if (causal && j > i) s = -1e30f;
      }
      sc[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float e = expf(sc[t] - m);
      sc[t] = e;
      l += e;
    }
    l = warp_sum(l);
    float rs = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      sc[t] = sc[t] / l;  // p; 0 on padded and masked keys
      rs = fmaf(sc[t], dp[t], rs);
    }
    rs = warp_sum(rs);
    if (lane == 0) {
      row_m[i] = m;
      row_l[i] = l;
      row_rs[i] = rs;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = 32 * t + lane;
      if (j < S) w0[j] = to_f(from_f<T>(sc[t] * (dp[t] - rs) * scale));
    }
    __syncwarp();

    float acc[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[cc] = 0.f;
    for (int j = 0; j < jend; ++j) {
      const float d = w0[j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = 32 * cc + lane;
        if (c < Dh) acc[cc] = fmaf(d, at[c * kp + j], acc[cc]);
      }
    }
    T* orow = obase + (size_t)i * d3;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = 32 * cc + lane;
      if (c < Dh) orow[c] = from_f<T>(acc[cc]);
    }
    __syncwarp();  // ra, rb and w0 are rewritten by the next row
  }
  __syncthreads();

  // Phase 2: a warp owns key rows; Q^T and G^T staged in K^T's and V^T's
  // place. Key j's column of scores and dp over the queries that see it
  // gives p and ds as phase 1 had them; dv and dk sum over those queries.
  stage(base, d3, gbase, D);
  __syncthreads();
  for (int j = warp; j < S; j += kWarps) {
    for (int c = lane; c < Dh; c += 32) {
      ra[c] = to_f(base[(size_t)j * d3 + D + c]);
      rb[c] = to_f(base[(size_t)j * d3 + 2 * D + c]);
    }
    __syncwarp();
    const int istart = causal && nm == 0 ? j : 0;  // queries with p > 0 at key j
    float sc[NT], dp[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) sc[t] = dp[t] = 0.f;
    for (int c = 0; c < Dh; ++c) {
      const float kc = ra[c], vc = rb[c];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (32 * t + 31 >= istart && 32 * t < S) {
          sc[t] = fmaf(kc, at[c * kp + 32 * t + lane], sc[t]);
          dp[t] = fmaf(vc, bt[c * kp + 32 * t + lane], dp[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int i = 32 * t + lane;
      if (i < S) {
        float p = 0.f, ds = 0.f;
        if (i >= istart) {
          // above the diagonal -1e30, as in phase 1: p = 0 but in a row
          // the bias masks wholly (its maximum -1e30)
          float s = sc[t] * scale;
          if (kb) s += kb[j];
          if (causal && j > i) s = -1e30f;
          p = expf(s - row_m[i]) / row_l[i];
          ds = p * (dp[t] - row_rs[i]) * scale;
        }
        w0[i] = to_f(from_f<T>(p));
        w1[i] = to_f(from_f<T>(ds));
      }
    }
    __syncwarp();

    float dv[NC], dk[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dv[cc] = dk[cc] = 0.f;
    for (int i = istart; i < S; ++i) {
      const float p = w0[i];
      const float d = w1[i];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = 32 * cc + lane;
        if (c < Dh) {
          dv[cc] = fmaf(p, bt[c * kp + i], dv[cc]);
          dk[cc] = fmaf(d, at[c * kp + i], dk[cc]);
        }
      }
    }
    T* orow = obase + (size_t)j * d3;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = 32 * cc + lane;
      if (c < Dh) {
        orow[D + c] = from_f<T>(dk[cc]);
        orow[2 * D + c] = from_f<T>(dv[cc]);
      }
    }
    __syncwarp();  // ra, rb, w0 and w1 are rewritten by the next key
  }
}

template <typename T, int NT, int NC>
cudaError_t launch(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B, int S,
                   int D, int H, float scale, int causal, cudaStream_t stream) {
  const int dh = D / H;
  const size_t smem = sizeof(float) * (size_t)smem_floats(S, dh);
  auto kernel = qkv_attention_bwd_kernel<T, NT, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<const float*>(key_bias),
      static_cast<T*>(dqkv), S, D, dh, scale, causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t dispatch_nt(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                        int S, int D, int H, float scale, int causal, cudaStream_t st) {
  if (S <= 64) return launch<T, 2, NC>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  if (S <= 128) return launch<T, 4, NC>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  return launch<T, 8, NC>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                     int S, int D, int H, float scale, int causal, cudaStream_t st) {
  if (D / H <= 64) return dispatch_nt<T, 2>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  return dispatch_nt<T, 4>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 at head width 64, S <= 128.
// ---------------------------------------------------------------------------

constexpr int kHd = 64;          // head width of this path
constexpr int kPitch = kHd + 8;  // bf16 row pitch of q, k, v, g in shared memory

// KG: 16-row groups, S <= 16 * KG; one warp per group. MASKED: causal with a
// key bias, so that rows may see only masked keys (masked_rows); without
// it the kernel skips that test and keeps its causal walk.
template <int KG, bool MASKED>
__global__ void __launch_bounds__(KG * 32)
qkv_attention_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ g,
                             const float* __restrict__ key_bias,
                             __nv_bfloat16* __restrict__ dqkv, int S, int D, float scale,
                             int causal) {
  constexpr int SP = 16 * KG;  // rows and keys padded to whole groups
  constexpr int PP = SP + 8;   // bf16 row pitch of the S x S matrices
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [SP][kPitch]
  __nv_bfloat16* ks = qs + SP * kPitch;                            // [SP][kPitch]
  __nv_bfloat16* vs = ks + SP * kPitch;                            // [SP][kPitch]
  __nv_bfloat16* gs = vs + SP * kPitch;                            // [SP][kPitch]
  __nv_bfloat16* pbs = gs + SP * kPitch;                           // [SP][PP]  T(p)
  __nv_bfloat16* dss = pbs + SP * PP;                              // [SP][PP]  T(ds)
  float* kbias = reinterpret_cast<float*>(dss + SP * PP);          // [SP]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d3 = 3 * D;
  const __nv_bfloat16* base = qkv + (size_t)b * S * d3 + h * kHd;
  const __nv_bfloat16* gbase = g + (size_t)b * S * D + h * kHd;
  __nv_bfloat16* obase = dqkv + (size_t)b * S * d3 + h * kHd;

  // Stage q, k, v and g (16 bytes a copy); padded rows are zero.
  for (int idx = threadIdx.x; idx < 4 * SP * 8; idx += blockDim.x) {
    const int part = idx / (SP * 8);
    const int rem = idx - part * SP * 8;
    const int j = rem >> 3;
    const int c = (rem & 7) * 8;
    const bool in = j < S;
    const __nv_bfloat16* src =
        part < 3 ? base + (size_t)j * d3 + part * D + c : gbase + (size_t)j * D + c;
    mm::cp_async16(qs + (part * SP + j) * kPitch + c, in ? src : base, in ? 16 : 0);
  }
  mm::cp_async_commit();
  // Key bias, with padded keys at -inf: they get probability 0.
  for (int j = threadIdx.x; j < SP; j += blockDim.x)
    kbias[j] = j < S ? (key_bias ? key_bias[(size_t)b * S + j] : 0.f) : -INFINITY;
  mm::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  // Rows [0, nm) may see only keys the bias masks (masked_rows).
  const int nm = MASKED ? masked_rows(kbias, S) : 0;

  // Phase 1: warp `warp` owns query rows m0 .. m0 + 15.
  {
    const int m0 = 16 * warp;
    // With the causal mask, key groups past the tile's last row are masked
    // for all of its rows (-1e30) and need no product, unless a row sees
    // only keys the bias masks: they then count as its every key does.
    const int kg_end = causal && (!MASKED || m0 >= nm) ? min(KG, warp + 1) : KG;

    float sc[2 * KG][4];  // scores, then p; 8-key tile nt holds keys 8nt + 2t, +1
    float dp[2 * KG][4];  // g . v^T, then ds
#pragma unroll
    for (int nt = 0; nt < 2 * KG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;

#pragma unroll
    for (int kd = 0; kd < kHd; kd += 16) {
      uint32_t aq[4], ag[4];
      mm::ldsm_x4(aq, qs + (m0 + (lane & 15)) * kPitch + kd + (lane >> 4) * 8);
      mm::ldsm_x4(ag, gs + (m0 + (lane & 15)) * kPitch + kd + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        if (j < kg_end) {
          const int off = (16 * j + (lane & 7) + ((lane >> 4) << 3)) * kPitch + kd +
                          ((lane >> 3) & 1) * 8;
          uint32_t bk[4], bv[4];
          mm::ldsm_x4(bk, ks + off);
          mm::mma_bf16(sc[2 * j], aq, bk[0], bk[1]);
          mm::mma_bf16(sc[2 * j + 1], aq, bk[2], bk[3]);
          mm::ldsm_x4(bv, vs + off);
          mm::mma_bf16(dp[2 * j], ag, bv[0], bv[1]);
          mm::mma_bf16(dp[2 * j + 1], ag, bv[2], bv[3]);
        }
      }
    }

    // Exact softmax over each row; a row's values sit in the 4 lanes of a quad.
    const int r0 = m0 + gq;
    const int r1 = r0 + 8;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2 * KG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * nt + 2 * t4 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float s = sc[nt][e] * scale + kbias[key];
        if (causal && key > row && (!MASKED || key < S)) s = -1e30f;  // padded keys: -inf
        sc[nt][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2 * KG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - mx[e >> 1]);
        sc[nt][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
    // p (padded rows: 0), and the row sums of dp * p.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2 * KG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const float p = row < S ? sc[nt][e] / sum[e >> 1] : 0.f;
        sc[nt][e] = p;
        rs[e >> 1] = fmaf(p, dp[nt][e], rs[e >> 1]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
    // ds from the fp32 p; T(p) and T(ds) rows go to shared memory.
#pragma unroll
    for (int nt = 0; nt < 2 * KG; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = hf ? r1 : r0;
        const int col = 8 * nt + 2 * t4;
        const float p0 = sc[nt][2 * hf], p1 = sc[nt][2 * hf + 1];
        const float d0 = p0 * (dp[nt][2 * hf] - rs[hf]) * scale;
        const float d1 = p1 * (dp[nt][2 * hf + 1] - rs[hf]) * scale;
        dp[nt][2 * hf] = d0;
        dp[nt][2 * hf + 1] = d1;
        *reinterpret_cast<__nv_bfloat162*>(pbs + row * PP + col) = __floats2bfloat162_rn(p0, p1);
        *reinterpret_cast<__nv_bfloat162*>(dss + row * PP + col) = __floats2bfloat162_rn(d0, d1);
      }

    // dq = T(ds) . k: the ds tiles of a 16-key group are the A fragment.
    float o[kHd / 8][4];
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      if (j < kg_end) {
        uint32_t a[4];
        a[0] = mm::pack_bf16(dp[2 * j][0], dp[2 * j][1]);
        a[1] = mm::pack_bf16(dp[2 * j][2], dp[2 * j][3]);
        a[2] = mm::pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
        a[3] = mm::pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
#pragma unroll
        for (int dt = 0; dt < kHd / 8; dt += 2) {
          uint32_t bk[4];
          mm::ldsm_x4_trans(bk, ks + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                                    8 * dt + (lane >> 4) * 8);
          mm::mma_bf16(o[dt], a, bk[0], bk[1]);
          mm::mma_bf16(o[dt + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt) {
      const int col = 8 * dt + 2 * t4;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)r0 * d3 + col) =
            __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      if (r1 < S)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)r1 * d3 + col) =
            __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
  }
  __syncthreads();

  // Phase 2: warp `warp` owns keys j0 .. j0 + 15; dv = T(p)^T . g and
  // dk = T(ds)^T . q sum over the query groups that can see them.
  {
    const int j0 = 16 * warp;
    float dv[kHd / 8][4], dk[kHd / 8][4];
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[dt][e] = dk[dt][e] = 0.f;
    for (int it = causal && (!MASKED || nm == 0) ? warp : 0; it < KG; ++it) {
      const int i0 = 16 * it;
      // A (16 keys x 16 query rows) is the transpose of a stored tile.
      const int aoff = (i0 + (lane & 7) + ((lane >> 4) << 3)) * PP + j0 + ((lane >> 3) & 1) * 8;
      uint32_t ap[4], ad[4];
      mm::ldsm_x4_trans(ap, pbs + aoff);
      mm::ldsm_x4_trans(ad, dss + aoff);
#pragma unroll
      for (int dt = 0; dt < kHd / 8; dt += 2) {
        const int boff = (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + 8 * dt +
                         (lane >> 4) * 8;
        uint32_t bg[4], bq[4];
        mm::ldsm_x4_trans(bg, gs + boff);
        mm::mma_bf16(dv[dt], ap, bg[0], bg[1]);
        mm::mma_bf16(dv[dt + 1], ap, bg[2], bg[3]);
        mm::ldsm_x4_trans(bq, qs + boff);
        mm::mma_bf16(dk[dt], ad, bq[0], bq[1]);
        mm::mma_bf16(dk[dt + 1], ad, bq[2], bq[3]);
      }
    }
    const int k0 = j0 + gq;
    const int k1 = k0 + 8;
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt) {
      const int col = 8 * dt + 2 * t4;
      if (k0 < S) {
        __nv_bfloat16* row = obase + (size_t)k0 * d3 + col;
        *reinterpret_cast<__nv_bfloat162*>(row + D) = __floats2bfloat162_rn(dk[dt][0], dk[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(row + 2 * D) =
            __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
      }
      if (k1 < S) {
        __nv_bfloat16* row = obase + (size_t)k1 * d3 + col;
        *reinterpret_cast<__nv_bfloat162*>(row + D) = __floats2bfloat162_rn(dk[dt][2], dk[dt][3]);
        *reinterpret_cast<__nv_bfloat162*>(row + 2 * D) =
            __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
      }
    }
  }
}

template <int KG>
cudaError_t launch_mma(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                       int S, int D, int H, float scale, int causal, cudaStream_t stream) {
  constexpr int SP = 16 * KG;
  const size_t smem =
      sizeof(__nv_bfloat16) * (4 * SP * kPitch + 2 * SP * (SP + 8)) + sizeof(float) * SP;
  auto kernel = causal && key_bias ? qkv_attention_bwd_mma_kernel<KG, true>
                                   : qkv_attention_bwd_mma_kernel<KG, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), KG * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(key_bias), static_cast<__nv_bfloat16*>(dqkv), S, D, scale,
      causal);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                         int S, int D, int H, float scale, int causal, cudaStream_t st) {
  if (S <= 64) return launch_mma<4>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  if (S <= 80) return launch_mma<5>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  return launch_mma<8>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
}

// ---------------------------------------------------------------------------
// Hopper path: bf16 at head width 64, S <= 256, on `wgmma` + TMA.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgThreads = 256;    // two warpgroups
constexpr int kBox = 64 * 64 * 2;  // one 64 x 64 bf16 box, 128-byte rows

// Shared memory of the kernel at SP = S padded to 128 or 256, from a
// 1024-byte aligned base: the head's q, k, v and g (SP / 64 boxes each), then
// fp32: the key bias (SP), each query row's max, inverse sum and
// rowsum(dp p) (3 SP), the warpgroups' row statistics in exchange (3 x 2 x
// 64), each thread's 32 partial sums in exchange (2 x 32 x 128), and the
// 1 + SP / 64 mbarriers.
template <int SP>
constexpr size_t wg_smem() {
  return 1024 + 4 * (SP / 64) * (size_t)kBox +
         sizeof(float) * (4 * SP + 3 * 2 * 64 + 2 * 32 * 128) + (1 + SP / 64) * sizeof(uint64_t);
}

struct WgParams {
  CUtensorMap qkv;  // (B, 3H, S, 64) view of qkv (B, S, 3D): 64 x 64 boxes
  CUtensorMap g;    // (B, H, S, 64) view of g (B, S, D)
  const float* key_bias;
  __nv_bfloat16* dqkv;
  int S, D, H;
  float scale, scale_log2;
  int causal;
};

// Descriptors of 64 x 64 boxes (128-byte rows, 128-byte swizzle), as in
// csrc/flash_attention_bwd.cu: K-major, k-step kk 32 bytes into the rows
// (boxes of consecutive rows back to back make one operand of 128 rows);
// MN-major, k-step kk 16 rows (2048 bytes) on.
__device__ __forceinline__ uint64_t desc_k(uint32_t box, int kk) {
  return wg::desc(box + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t box, int kk) {
  return wg::desc(box + kk * 2048, kBox, 1024);
}

// d (64 x 112) (+)= A (64 x 16) . B (16 x 112), both K-major from shared
// memory: the key (query) half of a warpgroup at S <= 224.
__device__ __forceinline__ void mma_m64n112k16(float (&d)[56], uint64_t da, uint64_t db,
                                               int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, %59, %60;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(acc), "n"(0), "n"(0));  // both K-major
}

// d (64 x KT) (+)= A (64 x 16) . B (16 x KT), both K-major from shared memory.
template <int KT>
__device__ __forceinline__ void mma_rows(float (&d)[KT / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (KT == 128)
    wg::mma_m64n128k16<wg::K, wg::K>(d, da, db, acc);
  else if constexpr (KT == 112)
    mma_m64n112k16(d, da, db, acc);
  else
    wg::mma_m64n64k16<wg::K, wg::K>(d, da, db, acc);
}

// An accumulator (64 x KT, rounded and packed) as the A fragments of its
// KT / 16 k-steps (see wg::mma_m64n64k16_rs).
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&f)[KT / 16][4], const float (&d)[KT / 2]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = mm::pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// The sum of a 64 x 64 product that both warpgroups hold a part of (their
// accumulators have the same layout thread for thread): warpgroup wgi
// finishes columns [32 wgi, 32 wgi + 32), taking the other's part of them
// through `xbuf` ([2][32][128] floats, 16 of a thread's from `slot`); returns,
// in d's first 16 elements, the sum of its columns' elements 4 n + e, n in
// [4 wgi, 4 wgi + 4). A named barrier between the two orders the exchange.
// The branches on wgi keep every index a constant: an accumulator indexed by
// a register value would live in local memory.
__device__ __forceinline__ void exchange_halves(const float (&d)[32], float* xbuf, int slot,
                                                int wgi, int tw) {
  float* dst = xbuf + (wgi * 32 + slot) * 128 + tw;
  if (wgi == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i * 128] = d[16 + i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i * 128] = d[i];
  }
}
__device__ __forceinline__ void take_halves(float (&d)[32], const float* xbuf, int slot, int wgi,
                                            int tw) {
  const float* src = xbuf + ((1 - wgi) * 32 + slot) * 128 + tw;
  if (wgi == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] += src[i * 128];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = d[16 + i] + src[i * 128];
  }
}

// Writes a warpgroup's 64 rows x 32 columns (d[0..15] from take_halves,
// columns 32 wgi + 8 n + 2 t4 and + 1) at `base` + row * ld for rows < S.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld, int row0, int S,
                                           const float (&d)[32], int wgi) {
  const int lane = threadIdx.x & 31;
  const int ww = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * ww + (lane >> 2) + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      *reinterpret_cast<__nv_bfloat162*>(base + row * ld + 32 * wgi + 8 * n + 2 * (lane & 3)) =
          __floats2bfloat162_rn(d[4 * n + 2 * hh], d[4 * n + 2 * hh + 1]);
  }
}

// -1e30 in log2 units: the causal fill beside a key bias in log2 units, so
// that a row whose every visible key the bias masks (-1e30) has every score
// at its maximum, above the diagonal too, as in the TPU kernel.
constexpr float kMasked2 = -1e30f * kLog2e;

// Pass 2's p^T of key tile j0 (the warpgroup's queries from qw0) from the
// scores s^T in `sacc` and the rows' statistics: element 4 n + e is key
// j0 + 16 ww + gq + 8 (e / 2), query qw0 + 8 n + 2 t4 + e % 2. With CAUSAL
// the keys above the diagonal take pass 1's kMasked2, so p is 0 there but
// in a row the bias masks wholly (its maximum kMasked2: p = 1 / S).
template <int KT, bool CAUSAL>
__device__ __forceinline__ void probs_t(float (&sacc)[KT / 2], const float* kb2,
                                        const float* row_m, const float* row_il, float sl2,
                                        int j0, int qw0) {
  const int lane = threadIdx.x & 31;
  const int ww = (threadIdx.x % 128) / 32;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const float kbk[2] = {kb2[j0 + 16 * ww + gq], kb2[j0 + 16 * ww + gq + 8]};
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    const int q = qw0 + 8 * n + 2 * t4;
    const float2 m2 = *reinterpret_cast<const float2*>(row_m + q);
    const float2 l2 = *reinterpret_cast<const float2*>(row_il + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s2 = fmaf(sacc[4 * n + e], sl2, kbk[e >> 1]);
      if (CAUSAL && j0 + 16 * ww + gq + 8 * (e >> 1) > q + (e & 1)) s2 = kMasked2;
      sacc[4 * n + e] = exp2f(s2 - ((e & 1) ? m2.y : m2.x)) * ((e & 1) ? l2.y : l2.x);
    }
  }
}

// One block of two warpgroups per (head, batch row). The head's q, k, v and
// g arrive by TMA through 3-d views of the fused layouts, rows past S as
// zeros. Both warpgroups work on the same 64-row tile, each on one half of
// the other axis (KT keys or queries: SP / 2, or 112 where S <= 224, which
// skips the padding's last 32 rows), so that a product's whole row fits one
// warpgroup's registers next to the second product's:
//   pass 1, query tiles: s = q k^T and dp = g v^T over the warpgroup's keys;
//     the softmax's max and sum and rowsum(dp p) are exchanged between the
//     warpgroups; ds = p (dp - rowsum) scale from the fp32 p; dq = T(ds) k
//     with ds as the register A operand, the two halves' sums exchanged;
//     each row's max, 1 / sum and rowsum go to shared memory;
//   pass 2, key tiles: s^T = k q^T and dp^T = v g^T over the warpgroup's
//     queries give p^T and ds^T from those statistics; dv = T(p^T) g and
//     dk = T(ds^T) q, A from registers, the halves exchanged.
// Seven products of 64 x 2 KT x 64 per tile row, each score element computed
// once per pass. Scores are in log2 units (scale * log2(e)), padded keys
// carry a -inf bias and padded query rows a +inf max, so neither adds to any
// sum; masked keys give p = ds = 0 exactly, so dk = dv = 0 for a key no
// query sees. The keys above the causal diagonal take -1e30 in the bias's
// log2 units (kMasked2) in both passes, so that a row whose every visible
// key the bias masks spreads p over all S keys, as the TPU kernel's does.
// The causal mask is a pass of its own, and every product is issued on
// every tile.
template <int SP, int KT>
__global__ void __launch_bounds__(kWgThreads, 1)
    qkv_attention_bwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  static_assert(2 * KT <= SP && KT % 16 == 0, "a warpgroup's half of the padded rows");
  constexpr int NB = SP / 64;  // boxes of a head's tensor
  constexpr int NS = KT / 2;   // accumulator floats of a 64 x KT product
  constexpr int KS = KT / 16;  // k-steps of a product over KT
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint8_t* qs = sm;
  uint8_t* ks = qs + NB * kBox;
  uint8_t* vs = ks + NB * kBox;
  uint8_t* gs = vs + NB * kBox;
  float* kb2 = reinterpret_cast<float*>(gs + NB * kBox);  // [SP] key bias, log2 units
  float* row_m = kb2 + SP;                                // [SP] per query row, log2 units
  float* row_il = row_m + SP;                             // [SP] 1 / sum
  float* row_rs = row_il + SP;                            // [SP] rowsum(dp p)
  float* xm = row_rs + SP;                                // [2][64] exchange: max
  float* xl = xm + 128;                                   // [2][64] sum
  float* xr = xl + 128;                                   // [2][64] rowsum
  float* xbuf = xr + 128;                                 // [2][32][128] partial sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(xbuf + 2 * 32 * 128);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int S = p.S;
  const int tid = threadIdx.x;
  // bars[0]: all of k and v (every query tile of pass 1 reads them);
  // bars[1 + t]: q's and g's box t, so that pass 1's tile t starts as soon
  // as its own rows are in.
  if (tid == 0) {
    for (int t = 0; t <= NB; ++t) wg::bar_init(&bars[t], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    wg::bar_expect_tx(&bars[0], 2 * NB * kBox);
    for (int t = 0; t < NB; ++t) {
      wg::tma_box_4d(ks + t * kBox, &p.qkv, &bars[0], 0, 64 * t, p.H + h, b);
      wg::tma_box_4d(vs + t * kBox, &p.qkv, &bars[0], 0, 64 * t, 2 * p.H + h, b);
    }
    for (int t = 0; t < NB; ++t) {
      wg::bar_expect_tx(&bars[1 + t], 2 * kBox);
      wg::tma_box_4d(qs + t * kBox, &p.qkv, &bars[1 + t], 0, 64 * t, h, b);
      wg::tma_box_4d(gs + t * kBox, &p.g, &bars[1 + t], 0, 64 * t, h, b);
    }
  }
  for (int j = tid; j < SP; j += kWgThreads) {
    kb2[j] = j < S ? (p.key_bias ? p.key_bias[(size_t)b * S + j] * kLog2e : 0.f) : -INFINITY;
    row_m[j] = INFINITY;  // rows past S: exp2(s - inf) = 0
    row_il[j] = 0.f;
    row_rs[j] = 0.f;
  }

  const int lane = tid & 31;
  const int wgi = tid / 128;
  const int tw = tid % 128;
  const int ww = tw / 32;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int nt = (S + 63) / 64;  // 64-row tiles of queries (pass 1) and keys (pass 2)
  const float scale = p.scale;
  const float sl2 = p.scale_log2;
  __nv_bfloat16* obase = p.dqkv + (size_t)b * S * 3 * p.D + h * 64;
  const long long ld = 3LL * p.D;

  float sacc[NS], dacc[NS], acc0[32], acc1[32];
  uint32_t fa[KS][4], fb[KS][4];  // live until the products that read them are done
  __syncthreads();  // kb2 and the row statistics' defaults
  wg::bar_wait(&bars[0], 0);

  // Pass 1: query tile t; this warpgroup's keys [KT wgi, KT wgi + KT).
  const int k0w = KT * wgi;
  const uint32_t kh = wg::smem_u32(ks) + wgi * KT * 128;  // 128-byte rows
  const uint32_t vh = wg::smem_u32(vs) + wgi * KT * 128;
  // s and dp of query tile t, two groups
  auto issue_sdp = [&](int t) {
    const uint32_t qb = wg::smem_u32(qs) + t * kBox;
    const uint32_t gb = wg::smem_u32(gs) + t * kBox;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rows<KT>(sacc, desc_k(qb, kk), desc_k(kh, kk), kk);
    wg::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rows<KT>(dacc, desc_k(gb, kk), desc_k(vh, kk), kk);
    wg::wgmma_commit();
  };
  // Per tile: s and dp, the softmax under dp, then dq. (Issuing the next
  // tile's s and dp before dq's halves are exchanged made ptxas serialize
  // the products, C7514, at 255 registers: 0.80 against 0.70 ms at
  // ViT-B/16's shape, PERF.md.)
  for (int t = 0; t < nt; ++t) {
    const int q0 = 64 * t;
    wg::bar_wait(&bars[1 + t], 0);
    __syncwarp();  // the warp leaves the polls together: `wgmma` is .aligned
    issue_sdp(t);
    wg::wgmma_wait<1>();
    wg::fence_acc(sacc);
    // element 4 n + e: row q0 + 16 ww + gq + 8 (e / 2), key k0w + 8 n + 2 t4 + e % 2
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float2 kb = *reinterpret_cast<const float2*>(kb2 + k0w + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[4 * n + e] = fmaf(sacc[4 * n + e], sl2, (e & 1) ? kb.y : kb.x);
    }
    if (p.causal) {
      // -1e30 above the diagonal in the bias's log2 units, as the TPU kernel
      // sets it after the bias; keys past S stay -inf (no keys at all)
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0w + 8 * n + 2 * t4 + (e & 1);
          if (key > q0 + 16 * ww + gq + 8 * (e >> 1) && key < S) sacc[4 * n + e] = kMasked2;
        }
    }
    // The row's max, then sum, over both warpgroups' keys; a row's values sit
    // in the 4 lanes of a quad.
    const int lr = 16 * ww + gq;  // the thread's rows: lr and lr + 8 of the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < NS; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sacc[x]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (t4 == 0) xm[64 * wgi + lr + 8 * i] = mx[i];
    }
    wg::named_sync(1, kWgThreads);
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = fmaxf(xm[lr + 8 * i], xm[64 + lr + 8 * i]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      const float e = exp2f(sacc[x] - mx[(x >> 1) & 1]);
      sacc[x] = e;
      sum[(x >> 1) & 1] += e;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (t4 == 0) xl[64 * wgi + lr + 8 * i] = sum[i];
    }
    wg::named_sync(1, kWgThreads);
    float il[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) il[i] = 1.f / (xl[lr + 8 * i] + xl[64 + lr + 8 * i]);
#pragma unroll
    for (int x = 0; x < NS; ++x) sacc[x] *= il[(x >> 1) & 1];  // p
    wg::wgmma_wait<0>();
    wg::fence_acc(dacc);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < NS; ++x) rs[(x >> 1) & 1] = fmaf(sacc[x], dacc[x], rs[(x >> 1) & 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      if (t4 == 0) xr[64 * wgi + lr + 8 * i] = rs[i];
    }
    wg::named_sync(1, kWgThreads);
#pragma unroll
    for (int i = 0; i < 2; ++i) rs[i] = xr[lr + 8 * i] + xr[64 + lr + 8 * i];
#pragma unroll
    for (int x = 0; x < NS; ++x) dacc[x] = sacc[x] * (dacc[x] - rs[(x >> 1) & 1]) * scale;  // ds
    pack_a<KT>(fa, dacc);
    if (wgi == 0 && t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + lr + 8 * i;
        if (row < S) {
          row_m[row] = mx[i];
          row_il[row] = il[i];
          row_rs[row] = rs[i];
        }
      }
    }
    // dq = T(ds) k over this warpgroup's keys (k MN-major), then both halves
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wg::mma_m64n64k16_rs<wg::MN>(acc0, fa[kk], desc_mn(kh, kk), kk);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(acc0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wg::fence_regs(fa[kk]);
    exchange_halves(acc0, xbuf, 0, wgi, tw);
    wg::named_sync(1, kWgThreads);
    take_halves(acc0, xbuf, 0, wgi, tw);
    store_rows(obase, ld, q0, S, acc0, wgi);
  }
  for (int t = nt; t < NB; ++t) wg::bar_wait(&bars[1 + t], 0);  // boxes past S: zeros
  __syncwarp();
  __syncthreads();  // the row statistics

  // Pass 2: key tile t; this warpgroup's queries [KT wgi, KT wgi + KT).
  const int qw0 = KT * wgi;
  const uint32_t qh = wg::smem_u32(qs) + wgi * KT * 128;
  const uint32_t gh = wg::smem_u32(gs) + wgi * KT * 128;
  // s^T and dp^T of key tile t, two groups
  auto issue_sdp_t = [&](int t) {
    const uint32_t kb = wg::smem_u32(ks) + t * kBox;
    const uint32_t vb = wg::smem_u32(vs) + t * kBox;
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rows<KT>(sacc, desc_k(kb, kk), desc_k(qh, kk), kk);
    wg::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rows<KT>(dacc, desc_k(vb, kk), desc_k(gh, kk), kk);
    wg::wgmma_commit();
  };
  for (int t = 0; t < nt; ++t) {
    const int j0 = 64 * t;
    issue_sdp_t(t);
    wg::wgmma_wait<1>();
    wg::fence_acc(sacc);
    // element 4 n + e: key j0 + 16 ww + gq + 8 (e / 2), query qw0 + 8 n + 2 t4 + e % 2
    if (p.causal)
      probs_t<KT, true>(sacc, kb2, row_m, row_il, sl2, j0, qw0);
    else
      probs_t<KT, false>(sacc, kb2, row_m, row_il, sl2, j0, qw0);
    wg::wgmma_wait<0>();
    wg::fence_acc(dacc);
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float2 r2 = *reinterpret_cast<const float2*>(row_rs + qw0 + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dacc[4 * n + e] = sacc[4 * n + e] * (dacc[4 * n + e] - ((e & 1) ? r2.y : r2.x)) * scale;
    }
    pack_a<KT>(fa, sacc);  // T(p^T)
    pack_a<KT>(fb, dacc);  // T(ds^T)
    // dv = T(p^T) g and dk = T(ds^T) q over this warpgroup's queries
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wg::mma_m64n64k16_rs<wg::MN>(acc0, fa[kk], desc_mn(gh, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wg::mma_m64n64k16_rs<wg::MN>(acc1, fb[kk], desc_mn(qh, kk), kk);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(acc0);
    wg::fence_acc(acc1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wg::fence_regs(fa[kk]);
      wg::fence_regs(fb[kk]);
    }
    exchange_halves(acc0, xbuf, 0, wgi, tw);
    exchange_halves(acc1, xbuf, 16, wgi, tw);
    wg::named_sync(1, kWgThreads);
    take_halves(acc0, xbuf, 0, wgi, tw);
    take_halves(acc1, xbuf, 16, wgi, tw);
    store_rows(obase + 2 * p.D, ld, j0, S, acc0, wgi);  // dv
    store_rows(obase + p.D, ld, j0, S, acc1, wgi);      // dk
    wg::named_sync(1, kWgThreads);  // xbuf is rewritten by the next tile
  }
}

template <int SP, int KT>
cudaError_t launch_wgmma(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                         int S, int D, int H, float scale, int causal, cudaStream_t st) {
  auto kernel = qkv_attention_bwd_wgmma_kernel<SP, KT>;
  static const cudaError_t smem_err = wg::allow_smem(kernel, wg_smem<SP>());
  if (smem_err != cudaSuccess) return smem_err;
  WgParams p;
  cudaError_t err;
  const long long qkv_st[3] = {(long long)S * 3 * D, 64, 3LL * D};
  const long long g_st[3] = {(long long)S * D, 64, (long long)D};
  if ((err = wg::map_bhsd(&p.qkv, qkv, B, 3 * H, S, qkv_st)) != cudaSuccess) return err;
  if ((err = wg::map_bhsd(&p.g, g, B, H, S, g_st)) != cudaSuccess) return err;
  p.key_bias = static_cast<const float*>(key_bias);
  p.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  p.S = S;
  p.D = D;
  p.H = H;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  kernel<<<dim3(H, B), kWgThreads, wg_smem<SP>(), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv and dqkv: (B, S, 3D); g: (B, S, D); all of `dtype` (0 = fp32,
// 1 = bf16), contiguous, 16-byte aligned; key_bias: (B, S) fp32 or null.
// `route` names the kernel (ops/fused_encoder.py:_attention_bwd_route):
// 0 the FP32 pipes (any shape of `fused_attention_bwd_supported`, the
// forward's domain), 1 the `mma.sync` kernel (bf16, head width 64,
// S <= 128), 2 the `wgmma` kernel (bf16, head width 64, S <= 256); a route
// that cannot take the shape is refused. Launches on `stream`, allocates
// nothing and returns cudaGetLastError() of the launch.
int mm_qkv_attention_bwd(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                         int S, int D, int H, float scale, int causal, int dtype, int route,
                         void* stream) {
  if (B <= 0 || S <= 0 || S > 256 || H <= 0 || D % H != 0 || (D / H) % 8 != 0 ||
      D / H > 128 || (dtype != 0 && dtype != 1) || route < 0 || route > 2 ||
      (route > 0 && (dtype != 1 || D / H != kHd)) || (route == 1 && S > 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (S <= 128)
      return (int)launch_wgmma<128, 64>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
    if (S <= 224)
      return (int)launch_wgmma<256, 112>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
    return (int)launch_wgmma<256, 128>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  }
  if (route == 1)
    return (int)dispatch_mma(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  if (dtype == 0) return (int)dispatch<float>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  return (int)dispatch<__nv_bfloat16>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
}

}  // extern "C"
