// Fused self-attention straight off the fused QKV projection, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_qkv_attention_impl`
// (kernel bodies `_qkv_attn_kernel` / `_qkv_attn_kernel_kb`, head loop
// `_attn_head_loop`).
//
// What it computes, per batch row b and head h (Dh = D / H):
//   s    = (q_h . k_h^T) * scale                      fp32
//   s   += key_bias[b, :]                             optional (B, S) fp32
//   s    = causal ? (col <= row ? s : -1e30) : s
//   p    = exp(s - max(s)) / sum(exp(s - max(s)))     exact, whole row
//   o_h  = T(p) . v_h                                 p rounded to the compute
//                                                     type, fp32 sum
// q, k and v are read in place from qkv (B, S, 3D), laid out [q | k | v] with
// heads contiguous (row stride 3D); o is written into out (B, S, D) at the
// head's column offset. No split or transposed copy is made, and neither the
// scores nor the probabilities reach device memory.
//
// What bounds it on this card: bytes. At the CLIP shapes (S = 50 / 77,
// Dh = 64) the kernel must read qkv once and write out once (about 160 MB at
// batch 512) while doing about 4-6 GFLOP, far below the card's 295 FLOP per
// byte balance point.
//
// Design: one block per (head, batch row). The head's K and V (and, on the
// tensor-core path, Q) are staged once into shared memory, so every qkv
// byte is read from device memory once; the softmax is exact over the whole
// row (max, then sum; S <= 256 needs no online rescaling).
//
// bf16 at head width 64 (CLIP, ViT-B, BERT-base) runs on the tensor cores:
// Q, K and V are copied in bf16 with cp.async, and each of 4 warps owns 16
// query rows. q . k^T is an `mma.sync` m16n8k16 product with fragments from
// `ldmatrix`, the score row stays in registers (a row's values spread over
// the 4 lanes of a quad, reduced with two shuffles), and the probability
// tiles, rounded to bf16, are re-used in registers as the A fragment of
// p . v, whose B fragment is V read with `ldmatrix.trans`. With the causal
// mask, key groups past a tile's last row are skipped. Row pitches of 72
// elements keep the ldmatrix reads free of bank conflicts.
//
// fp32, and bf16 at other head widths, run on the FP32 pipes: K (transposed,
// odd pitch, conflict-free both ways) and V staged in fp32; each warp
// carries four query rows at a time, so every shared-memory read of K or V
// feeds four rows' FMAs; a lane keeps its 32-key slices of the four score
// rows in registers (at most eight values per row per lane) and the
// probabilities go through a small per-warp buffer to be broadcast for
// p . v. This path is held by shared-memory and FMA throughput well above
// its byte bound. TMA staging and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mm::from_f;
using mm::to_f;

constexpr int kWarps = 8;  // warps per block
constexpr int kRows = 4;   // query rows a warp carries at once (float4 of p)

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

// Shared memory, in floats, for a block at sequence length `s` and head
// width `dh`; the Python wrapper's shape predicate uses the same formula.
__host__ __device__ inline int smem_floats(int s, int dh) {
  const int sp = ((s + 31) / 32) * 32;
  return dh * (sp + 1) + s * dh + kWarps * kRows * dh + kWarps * sp * kRows;
}

// NT: 32-key chunks per score row (S <= 32 * NT).
// NC: 32-column chunks of the head a lane owns in the output (Dh <= 32 * NC).
template <typename T, int NT, int NC>
__global__ void __launch_bounds__(kWarps * 32)
qkv_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ key_bias,
                     T* __restrict__ out, int S, int D, int Dh, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int sp = ((S + 31) / 32) * 32;  // keys padded to whole warps
  const int kp = sp + 1;                // odd pitch of the transposed K
  float* kt = smem;                     // [Dh][kp]   K^T of this head
  float* vs = kt + Dh * kp;             // [S][Dh]    V of this head
  float* qs = vs + S * Dh;              // [kWarps][kRows][Dh]
  float* ps = qs + kWarps * kRows * Dh; // [kWarps][sp][kRows]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d3 = 3 * D;
  const T* base = qkv + (size_t)b * S * d3;
  const int koff = D + h * Dh;
  const int voff = 2 * D + h * Dh;

  // Stage K^T and V; padded keys (S <= j < sp) read as zero.
  for (int idx = threadIdx.x; idx < sp * Dh; idx += blockDim.x) {
    const int j = idx / Dh;
    const int c = idx - j * Dh;
    float kv = 0.f;
    if (j < S) {
      const T* row = base + (size_t)j * d3;
      kv = to_f(row[koff + c]);
      vs[j * Dh + c] = to_f(row[voff + c]);
    }
    kt[c * kp + j] = kv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * kRows * Dh;
  float* pw = ps + warp * sp * kRows;
  const float* kb = key_bias ? key_bias + (size_t)b * S : nullptr;
  const int groups = (S + kRows - 1) / kRows;

  for (int g = warp; g < groups; g += kWarps) {
    const int i0 = g * kRows;
    for (int idx = lane; idx < kRows * Dh; idx += 32) {
      const int r = idx / Dh;
      const int c = idx - r * Dh;
      const int i = i0 + r;
      qw[idx] = i < S ? to_f(base[(size_t)i * d3 + h * Dh + c]) : 0.f;
    }
    __syncwarp();

    // Keys any row of this group can see; with the causal mask the rest
    // are masked for every row of the group and need no product.
    const int jend = causal ? min(S, i0 + kRows) : S;

    float sc[kRows][NT];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t) sc[r][t] = 0.f;

    for (int c = 0; c < Dh; c += 4) {
      float4 q4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        q4[r] = *reinterpret_cast<const float4*>(qw + r * Dh + c);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (32 * t < jend) {
          const float* kcol = kt + c * kp + 32 * t + lane;
          const float k0 = kcol[0], k1 = kcol[kp], k2 = kcol[2 * kp], k3 = kcol[3 * kp];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = sc[r][t];
            a = fmaf(q4[r].x, k0, a);
            a = fmaf(q4[r].y, k1, a);
            a = fmaf(q4[r].z, k2, a);
            a = fmaf(q4[r].w, k3, a);
            sc[r][t] = a;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = 32 * t + lane;
        float s;
        if (j >= S) {
          s = -INFINITY;  // padding: not a key at all
        } else {
          s = sc[r][t] * scale;
          if (kb) s += kb[j];
          if (causal && j > i) s = -1e30f;
        }
        sc[r][t] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e = expf(sc[r][t] - m);
        sc[r][t] = e;
        l += e;
      }
      l = warp_sum(l);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = 32 * t + lane;
        if (j < sp) pw[j * kRows + r] = to_f(from_f<T>(sc[r][t] / l));
      }
    }
    __syncwarp();

    float o[kRows][NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) o[r][cc] = 0.f;

    for (int j = 0; j < jend; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pw + j * kRows);
      const float* vrow = vs + j * Dh + lane;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float v = (32 * cc + lane < Dh) ? vrow[32 * cc] : 0.f;
        o[0][cc] = fmaf(p4.x, v, o[0][cc]);
        o[1][cc] = fmaf(p4.y, v, o[1][cc]);
        o[2][cc] = fmaf(p4.z, v, o[2][cc]);
        o[3][cc] = fmaf(p4.w, v, o[3][cc]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= S) break;
      T* orow = out + ((size_t)b * S + i) * D + h * Dh;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = 32 * cc + lane;
        if (c < Dh) orow[c] = from_f<T>(o[r][cc]);
      }
    }
    __syncwarp();  // qw / pw are rewritten by the next group
  }
}

template <typename T, int NT, int NC>
cudaError_t launch(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                   int H, float scale, int causal, cudaStream_t stream) {
  const int dh = D / H;
  const size_t smem = sizeof(float) * (size_t)smem_floats(S, dh);
  auto kernel = qkv_attention_kernel<T, NT, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(key_bias), static_cast<T*>(out),
      S, D, dh, scale, causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t dispatch_nt(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                        int H, float scale, int causal, cudaStream_t stream) {
  if (S <= 64) return launch<T, 2, NC>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  if (S <= 128) return launch<T, 4, NC>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  return launch<T, 8, NC>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                     int H, float scale, int causal, cudaStream_t stream) {
  if (D / H <= 64) return dispatch_nt<T, 2>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  return dispatch_nt<T, 4>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
}


// ---------------------------------------------------------------------------
// Tensor-core path: bf16 at head width 64.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;      // warps per block; a warp owns 16 query rows
constexpr int kHd = 64;           // head width of this path
constexpr int kPitch = kHd + 8;   // bf16 row pitch of Q, K, V in shared memory

template <int KG>  // 16-key groups: S <= 16 * KG
__global__ void __launch_bounds__(kMmaWarps * 32)
qkv_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const float* __restrict__ key_bias, __nv_bfloat16* __restrict__ out,
                         int S, int D, float scale, int causal) {
  constexpr int SP = 16 * KG;  // keys (and query rows) padded to whole groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [SP][kPitch]
  __nv_bfloat16* ks = qs + SP * kPitch;                            // [SP][kPitch]
  __nv_bfloat16* vs = ks + SP * kPitch;                            // [SP][kPitch]
  float* kbias = reinterpret_cast<float*>(vs + SP * kPitch);      // [SP]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d3 = 3 * D;
  const __nv_bfloat16* base = qkv + (size_t)b * S * d3 + h * kHd;

  // Stage the head's q, k and v rows (16 bytes a copy); padded rows are zero.
  for (int idx = threadIdx.x; idx < 3 * SP * 8; idx += blockDim.x) {
    const int part = idx / (SP * 8);
    const int rem = idx - part * SP * 8;
    const int j = rem >> 3;
    const int c = (rem & 7) * 8;
    const bool in = j < S;
    mm::cp_async16(qs + (part * SP + j) * kPitch + c,
                   in ? base + (size_t)j * d3 + part * D + c : base, in ? 16 : 0);
  }
  mm::cp_async_commit();
  // Key bias, with padded keys at -inf: they get probability 0.
  for (int j = threadIdx.x; j < SP; j += blockDim.x)
    kbias[j] = j < S ? (key_bias ? key_bias[(size_t)b * S + j] : 0.f) : -INFINITY;
  mm::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  for (int m0 = 16 * warp; m0 < S; m0 += 16 * kMmaWarps) {
    // With the causal mask, key groups past the tile's last row are masked
    // for all of its rows and need no product.
    const int kg_end = causal ? min(KG, m0 / 16 + 1) : KG;

    float sc[2 * KG][4];  // scores: 8-key tile nt holds keys 8nt + 2t, +1
#pragma unroll
    for (int nt = 0; nt < 2 * KG; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;

#pragma unroll
    for (int kd = 0; kd < kHd; kd += 16) {
      uint32_t a[4];
      mm::ldsm_x4(a, qs + (m0 + (lane & 15)) * kPitch + kd + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < KG; ++j) {
        if (j < kg_end) {
          uint32_t bk[4];
          mm::ldsm_x4(bk, ks + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * kPitch + kd +
                              ((lane >> 3) & 1) * 8);
          mm::mma_bf16(sc[2 * j], a, bk[0], bk[1]);
          mm::mma_bf16(sc[2 * j + 1], a, bk[2], bk[3]);
        }
      }
    }

    // Exact softmax over each row; a row's values sit in the 4 lanes of a quad.
    const int r0 = m0 + g;
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
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
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

    // o = bf16(p) . v: the score tiles of a 16-key group are the A fragment.
    float o[kHd / 8][4];
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      if (j < kg_end) {
        uint32_t a[4];
        a[0] = mm::pack_bf16(sc[2 * j][0] / sum[0], sc[2 * j][1] / sum[0]);
        a[1] = mm::pack_bf16(sc[2 * j][2] / sum[1], sc[2 * j][3] / sum[1]);
        a[2] = mm::pack_bf16(sc[2 * j + 1][0] / sum[0], sc[2 * j + 1][1] / sum[0]);
        a[3] = mm::pack_bf16(sc[2 * j + 1][2] / sum[1], sc[2 * j + 1][3] / sum[1]);
#pragma unroll
        for (int dt = 0; dt < kHd / 8; dt += 2) {
          uint32_t bv[4];
          mm::ldsm_x4_trans(bv, vs + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                                    8 * dt + (lane >> 4) * 8);
          mm::mma_bf16(o[dt], a, bv[0], bv[1]);
          mm::mma_bf16(o[dt + 1], a, bv[2], bv[3]);
        }
      }
    }

#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt) {
      const int col = h * kHd + 8 * dt + 2 * t4;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + r0) * D + col) =
            __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      if (r1 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * S + r1) * D + col) =
            __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
  }
}

template <int KG>
cudaError_t launch_mma(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                       int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = 3 * sizeof(__nv_bfloat16) * 16 * KG * kPitch + sizeof(float) * 16 * KG;
  auto kernel = qkv_attention_mma_kernel<KG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(key_bias),
      static_cast<__nv_bfloat16*>(out), S, D, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                         int H, float scale, int causal, cudaStream_t stream) {
  if (S <= 64) return launch_mma<4>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  if (S <= 80) return launch_mma<5>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  if (S <= 128) return launch_mma<8>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  return launch_mma<16>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
}

}  // namespace

extern "C" {

// qkv: (B, S, 3D) and out: (B, S, D), both of `dtype` (0 = fp32, 1 = bf16),
// contiguous; key_bias: (B, S) fp32 or null. Launches on `stream`, allocates
// nothing and returns cudaGetLastError() of the launch.
int mm_qkv_attention(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                     int H, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || S > 256 || H <= 0 || D % H != 0 || (D / H) % 8 != 0 ||
      D / H > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(qkv, key_bias, out, B, S, D, H, scale, causal, st);
  if (D / H == kHd)
    return (int)dispatch_mma(qkv, key_bias, out, B, S, D, H, scale, causal, st);
  return (int)dispatch<__nv_bfloat16>(qkv, key_bias, out, B, S, D, H, scale, causal, st);
}

}  // extern "C"
