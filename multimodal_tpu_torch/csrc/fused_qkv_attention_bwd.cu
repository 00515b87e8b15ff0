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
// p = ds = 0 and dk = dv = 0 for a key no query sees.
//
// bf16 at head width 64 and S <= 128 (CLIP, ViT-B/32, BERT-base) runs on
// the tensor cores: q, k, v, g staged in bf16 with cp.async; a warp per
// 16-row tile; q . k^T and g . v^T are `mma.sync` m16n8k16 products with
// the score and dp tiles in registers; the ds tiles, rounded, are re-used in
// registers as the A fragment of dq = ds . k. Phase 1 leaves the T(p) and
// T(ds) matrices in shared memory, and phase 2 reads their tiles transposed
// with `ldmatrix.trans` as the A fragments of dv = p^T . g and
// dk = ds^T . q. The two S x S bf16 matrices are what caps this path at
// S <= 128. Past it, up to S = 256 (ViT-B/16's 197), a second tensor-core
// kernel keeps only q, k, v and g of the head (147 KB at S = 256) and, per
// query row, the softmax's max, sum and rowsum(dp p): pass 1 sweeps the key
// groups three times (max; sum and rowsum; ds and dq), each time
// recomputing the score and dp tiles, and pass 2 recomputes the transposed
// tiles for its key rows from those statistics, as a flash-attention
// backward does, so no S x S matrix is ever stored.
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

  // Phase 1: a warp owns query rows; K^T and V^T staged.
  stage(base + D, d3, base + 2 * D, d3);
  __syncthreads();
  for (int i = warp; i < S; i += kWarps) {
    for (int c = lane; c < Dh; c += 32) {
      ra[c] = to_f(base[(size_t)i * d3 + c]);
      rb[c] = to_f(gbase[(size_t)i * D + c]);
    }
    __syncwarp();
    const int jend = causal ? i + 1 : S;  // keys row i can see
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
    const int istart = causal ? j : 0;  // queries that can see key j
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
          float s = sc[t] * scale;
          if (kb) s += kb[j];
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

template <int KG>  // 16-row groups: S <= 16 * KG; one warp per group
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

  // Phase 1: warp `warp` owns query rows m0 .. m0 + 15.
  {
    const int m0 = 16 * warp;
    // With the causal mask, key groups past the tile's last row are masked
    // for all of its rows and need no product.
    const int kg_end = causal ? min(KG, warp + 1) : KG;

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
        if (causal && key > row) s = -1e30f;
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
    for (int it = causal ? warp : 0; it < KG; ++it) {
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
  auto kernel = qkv_attention_bwd_mma_kernel<KG>;
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
// Tensor-core path for 128 < S <= 256: bf16 at head width 64, no S x S
// matrix in shared memory.
// ---------------------------------------------------------------------------

// c = the 16 x 16 tile (rows [ra, ra + 16) of `as`) . (rows [rb, rb + 16) of
// `bs`)^T over the head width, both [row][kPitch] bf16 in shared memory, as
// two m16n8 fragments (columns 0-7 and 8-15).
__device__ __forceinline__ void tile16(float (&c)[2][4], const __nv_bfloat16* as, int ra,
                                       const __nv_bfloat16* bs, int rb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kHd; kd += 16) {
    uint32_t a[4], bk[4];
    mm::ldsm_x4(a, as + (ra + (lane & 15)) * kPitch + kd + (lane >> 4) * 8);
    mm::ldsm_x4(bk, bs + (rb + (lane & 7) + ((lane >> 4) << 3)) * kPitch + kd +
                        ((lane >> 3) & 1) * 8);
    mm::mma_bf16(c[0], a, bk[0], bk[1]);
    mm::mma_bf16(c[1], a, bk[2], bk[3]);
  }
}

// o (16 x 64) += T(c) (16 x 16, two m16n8 fragments rounded to bf16 as an A
// fragment) . rows [r0, r0 + 16) of `bs` (16 x 64), read transposed.
__device__ __forceinline__ void tile_times(float (&o)[kHd / 8][4], const float (&c)[2][4],
                                           const __nv_bfloat16* bs, int r0) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  a[0] = mm::pack_bf16(c[0][0], c[0][1]);
  a[1] = mm::pack_bf16(c[0][2], c[0][3]);
  a[2] = mm::pack_bf16(c[1][0], c[1][1]);
  a[3] = mm::pack_bf16(c[1][2], c[1][3]);
#pragma unroll
  for (int dt = 0; dt < kHd / 8; dt += 2) {
    uint32_t b[4];
    mm::ldsm_x4_trans(b, bs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + 8 * dt +
                             (lane >> 4) * 8);
    mm::mma_bf16(o[dt], a, b[0], b[1]);
    mm::mma_bf16(o[dt + 1], a, b[2], b[3]);
  }
}

// One warp per 16-row group (S <= 16 * KG). Pass 1, warps own query rows:
// three sweeps over the key groups, each product recomputed from q, k, v
// and g in shared memory: the row max; the softmax's sum and rowsum(dp p);
// then p, ds and dq = T(ds) . k. A row's max, sum and rowsum go to shared
// memory. Pass 2, warps own key rows: for each query group, the key rows'
// s^T and dp^T tiles give p^T and ds^T from those statistics, and
// dv += T(p)^T . g, dk += T(ds)^T . q sum in registers.
template <int KG>
__global__ void __launch_bounds__(KG * 32)
qkv_attention_bwd_mma_long_kernel(const __nv_bfloat16* __restrict__ qkv,
                                  const __nv_bfloat16* __restrict__ g,
                                  const float* __restrict__ key_bias,
                                  __nv_bfloat16* __restrict__ dqkv, int S, int D, float scale,
                                  int causal) {
  constexpr int SP = 16 * KG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [SP][kPitch]
  __nv_bfloat16* ks = qs + SP * kPitch;                            // [SP][kPitch]
  __nv_bfloat16* vs = ks + SP * kPitch;                            // [SP][kPitch]
  __nv_bfloat16* gs = vs + SP * kPitch;                            // [SP][kPitch]
  float* kbias = reinterpret_cast<float*>(gs + SP * kPitch);       // [SP]
  float* row_m = kbias + SP;                                       // [SP] per query row
  float* row_l = row_m + SP;
  float* row_rs = row_l + SP;

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

  // Pass 1: warp `warp` owns query rows m0 .. m0 + 15.
  {
    const int m0 = 16 * warp;
    const int r0 = m0 + gq;
    const int r1 = r0 + 8;
    // key groups past the tile's last row are masked for all of its rows
    const int kg_end = causal ? warp + 1 : KG;
    // the scaled, biased and masked scores of key group j
    auto scores = [&](float (&sc)[2][4], int j) {
      tile16(sc, qs, m0, ks, 16 * j);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * j + 8 * nt + 2 * t4 + (e & 1);
          float s = sc[nt][e] * scale + kbias[key];
          if (causal && key > (e < 2 ? r0 : r1)) s = -1e30f;
          sc[nt][e] = s;
        }
    };
    // a row's values sit in the 4 lanes of a quad
    auto quad_max = [](float v) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    };
    auto quad_sum = [](float v) {
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      return v + __shfl_xor_sync(0xffffffffu, v, 2);
    };
    float sc[2][4], dp[2][4];
    float mx[2] = {-INFINITY, -INFINITY};
    for (int j = 0; j < kg_end; ++j) {
      scores(sc, j);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
    for (int j = 0; j < kg_end; ++j) {
      scores(sc, j);
      tile16(dp, gs, m0, vs, 16 * j);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[nt][e] - mx[e >> 1]);
          sum[e >> 1] += p;
          rs[e >> 1] = fmaf(p, dp[nt][e], rs[e >> 1]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = quad_sum(sum[i]);
      rs[i] = quad_sum(rs[i]) / sum[i];  // rowsum(dp * p)
    }
    float o[kHd / 8][4];
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    for (int j = 0; j < kg_end; ++j) {
      scores(sc, j);
      tile16(dp, gs, m0, vs, 16 * j);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[nt][e] - mx[e >> 1]) / sum[e >> 1];
          dp[nt][e] = p * (dp[nt][e] - rs[e >> 1]) * scale;  // ds
        }
      tile_times(o, dp, ks, 16 * j);  // dq += T(ds) . k
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
    if (t4 == 0) {
      row_m[r0] = mx[0];
      row_l[r0] = sum[0];
      row_rs[r0] = rs[0];
      row_m[r1] = mx[1];
      row_l[r1] = sum[1];
      row_rs[r1] = rs[1];
    }
  }
  __syncthreads();

  // Pass 2: warp `warp` owns keys j0 .. j0 + 15; dv and dk sum over the
  // query groups that can see them.
  {
    const int j0 = 16 * warp;
    const int k0 = j0 + gq;
    const int k1 = k0 + 8;
    const float kb[2] = {kbias[k0], kbias[k1]};
    float dv[kHd / 8][4], dk[kHd / 8][4];
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[dt][e] = dk[dt][e] = 0.f;
    for (int it = causal ? warp : 0; it < KG; ++it) {
      const int i0 = 16 * it;
      float st[2][4], dpt[2][4];
      tile16(st, ks, j0, qs, i0);   // s^T: keys x queries
      tile16(dpt, vs, j0, gs, i0);  // dp^T
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = i0 + 8 * nt + 2 * t4 + (e & 1);
          const int key = e < 2 ? k0 : k1;
          float p = 0.f, ds = 0.f;
          if (q < S && !(causal && key > q)) {
            p = expf(st[nt][e] * scale + kb[e >> 1] - row_m[q]) / row_l[q];
            ds = p * (dpt[nt][e] - row_rs[q]) * scale;
          }
          st[nt][e] = p;
          dpt[nt][e] = ds;
        }
      tile_times(dv, st, gs, i0);   // dv += T(p)^T . g
      tile_times(dk, dpt, qs, i0);  // dk += T(ds)^T . q
    }
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
cudaError_t launch_mma_long(const void* qkv, const void* g, const void* key_bias, void* dqkv,
                            int B, int S, int D, int H, float scale, int causal,
                            cudaStream_t stream) {
  constexpr int SP = 16 * KG;
  const size_t smem = sizeof(__nv_bfloat16) * 4 * SP * kPitch + sizeof(float) * 4 * SP;
  auto kernel = qkv_attention_bwd_mma_long_kernel<KG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), KG * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(g),
      static_cast<const float*>(key_bias), static_cast<__nv_bfloat16*>(dqkv), S, D, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv and dqkv: (B, S, 3D); g: (B, S, D); all of `dtype` (0 = fp32,
// 1 = bf16), contiguous, 16-byte aligned; key_bias: (B, S) fp32 or null.
// Needs the shape to pass `fused_attention_bwd_supported` (ops/
// fused_encoder.py), which is the forward's domain. Launches on `stream`,
// allocates nothing and returns cudaGetLastError() of the launch.
int mm_qkv_attention_bwd(const void* qkv, const void* g, const void* key_bias, void* dqkv, int B,
                         int S, int D, int H, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || S > 256 || H <= 0 || D % H != 0 || (D / H) % 8 != 0 ||
      D / H > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D / H == kHd) {
    if (S <= 128) return (int)dispatch_mma(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
    if (S <= 208)  // ViT-B/16's 197
      return (int)launch_mma_long<13>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
    return (int)launch_mma_long<16>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  }
  if (dtype == 0) return (int)dispatch<float>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
  return (int)dispatch<__nv_bfloat16>(qkv, g, key_bias, dqkv, B, S, D, H, scale, causal, st);
}

}  // extern "C"
