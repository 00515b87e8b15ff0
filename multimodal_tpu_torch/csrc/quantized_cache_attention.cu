// Decode attention of a few query rows against an int8 KV cache, for Hopper.
//
// Replaces: multimodal_tpu/ops/quantized_attention.py,
// `quantized_cache_attention` (kernel body `_kernel`).
//
// What it computes, per batch row b and kv head h, for the R = group * S
// query rows that share the head (a GQA group's heads stacked, each with its
// S rows), over L cache positions:
//   q'   = bf16(q)                                  (also for fp32 inputs)
//   s_j  = (q' . kq_j) * (k_scale_j * sm_scale)     fp32, kq_j int8 -> exact
//   s_j  = mask[b, s, j] ? s_j : -1e30
//   p_j  = exp(s_j - max s) / sum exp(s - max s)
//   p'_j = bf16(p_j * v_scale_j)
//   o    = sum_j p'_j vq_j                          fp32, then the output type
// The per-position scales ride the score and probability rows after the
// products (q . (k s) = (q . k) s, p . (v s) = (p s) . v), so the dense cache
// never exists anywhere: the int8 rows are read with 16-byte vector loads and
// converted in registers.
//
// What bounds it on this card: bytes. A decode tick reads the int8 K and V,
// 2 * b * h * L * d bytes, and 8 * b * h * L bytes of scales, for 4 FLOPs per
// cache byte. The kernel reads only the positions it needs: a K row is loaded
// only when some query row of the block may see it (the mask), and a V row only
// when some row's probability there is not exactly 0 (masked positions get
// exp(-1e30 - max) = 0 unless the whole row is masked). So a slot at position
// 600 of a 4096-long cache reads 601 rows of K and V, not 4096.
//
// Design: one block of 8 warps per (kv head, batch row) holds the whole score
// row set (R x L fp32) in shared memory, so the softmax is exact and needs no
// rescaling; this caps L at (232,448 bytes - 36 R d) / (4 R), which the
// wrapper's predicate checks. d / 16 lanes share a cache row (16 bytes each);
// a warp covers 32 / (d / 16) rows a step, and each thread keeps a few 16-byte
// loads in flight. Splitting L over blocks with an lse merge (flash-decoding)
// would fill the 132 SMs better at small b * h; at the LM decode shape
// (33 x 12 = 396 blocks, 3 a SM) the whole-row layout already has every SM
// streaming, so the simpler layout was chosen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mm::from_f;
using mm::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

struct QArgs {
  const void* q;
  long long qs[3];  // batch, head, row strides of q in elements (last dim contiguous)
  const int8_t* kq;
  const float* kscale;
  const int8_t* vq;
  const float* vscale;
  const uint8_t* mask;
  long long ms[3];  // batch, row, position strides of the bool mask (0 = broadcast)
  void* o;
  long long os[3];
  int Hq, Hkv, S, L, group;
  float sm_scale;
};

__host__ __device__ inline size_t smem_bytes(int R, int L, int D) {
  return sizeof(float) * ((size_t)R * L + (size_t)R * D + (size_t)kWarps * R * D +
                          2 * (size_t)kWarps * R);
}

__device__ __forceinline__ void to_floats(const int4& raw, float (&x)[16]) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int c = 0; c < 16; ++c) x[c] = (float)v[c];
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) quantized_cache_attention_kernel(QArgs a) {
  constexpr int TPK = D / 16;        // threads sharing a cache row
  constexpr int KPI = kThreads / TPK;  // rows a block covers a step
  constexpr int U = R <= 2 ? 4 : 2;  // steps whose loads are in flight together
  extern __shared__ __align__(16) float smem[];
  const int L = a.L;
  float* sc = smem;                   // [R][L]    scores, then probabilities
  float* qsm = sc + R * L;            // [R][D]
  float* red = qsm + R * D;           // [kWarps][R][D]
  float* wmax = red + kWarps * R * D;  // [kWarps][R]
  float* wsum = wmax + kWarps * R;    // [kWarps][R]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = a.group * a.S;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = tid / TPK;  // which row of a step this thread reads
  const int part = tid % TPK;  // which 16 columns
  const size_t cache_row0 = ((size_t)b * a.Hkv + h) * L;
  const uint8_t* mrow = a.mask + b * a.ms[0];

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    float x = 0.f;
    if (r < rows) {
      const int hq = h * a.group + r / a.S;
      const T* qrow = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[1] + (r % a.S) * a.qs[2];
      x = __bfloat162float(__float2bfloat16_rn(to_f(qrow[c])));
    }
    qsm[idx] = x;
  }
  __syncthreads();

  // Phase 1: scores. K rows that no query row may see are not read.
  {
    float qreg[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) qreg[r][c] = qsm[r * D + part * 16 + c];
    for (int j0 = 0; j0 < L; j0 += KPI * U) {
      int4 raw[U];
      bool need[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * KPI + sub;
        need[u] = false;
        if (j < L)
          for (int s = 0; s < a.S; ++s) need[u] |= mrow[s * a.ms[1] + j * a.ms[2]] != 0;
        if (need[u])
          raw[u] = __ldg(reinterpret_cast<const int4*>(a.kq + (cache_row0 + j) * D + part * 16));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * KPI + sub;
        float dot[R];
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = 0.f;
        if (need[u]) {
          float kv[16];
          to_floats(raw[u], kv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < 16; ++c) dot[r] = fmaf(qreg[r][c], kv[c], dot[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int o = 1; o < TPK; o <<= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
        if (part == 0 && j < L) {
          const float f = need[u] ? a.kscale[cache_row0 + j] * a.sm_scale : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < rows) {
              const bool see = need[u] && mrow[(r % a.S) * a.ms[1] + j * a.ms[2]] != 0;
              sc[r * L + j] = see ? dot[r] * f : kMasked;
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: exact softmax of each row, then p * v_scale rounded to bf16.
  float mx[R], sm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mx[r] = -INFINITY;
    if (r < rows)
      for (int j = tid; j < L; j += kThreads) mx[r] = fmaxf(mx[r], sc[r * L + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    if (lane == 0) wmax[warp * R + r] = mx[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w * R + r]);
    sm[r] = 0.f;
    if (r < rows)
      for (int j = tid; j < L; j += kThreads) {
        const float e = expf(sc[r * L + j] - m);
        sc[r * L + j] = e;
        sm[r] += e;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sm[r] += __shfl_xor_sync(0xffffffffu, sm[r], o);
    if (lane == 0) wsum[warp * R + r] = sm[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += wsum[w * R + r];
    for (int j = tid; j < L; j += kThreads) {
      const float p = sc[r * L + j] / l;
      sc[r * L + j] = __bfloat162float(__float2bfloat16_rn(p * a.vscale[cache_row0 + j]));
    }
  }
  __syncthreads();

  // Phase 3: o = p' . v. V rows whose probability is 0 in every row are not read.
  float acc[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < L; j0 += KPI * U) {
    int4 raw[U];
    bool need[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * KPI + sub;
      need[u] = false;
      if (j < L)
#pragma unroll
        for (int r = 0; r < R; ++r) need[u] |= r < rows && sc[r * L + j] != 0.f;
      if (need[u])
        raw[u] = __ldg(reinterpret_cast<const int4*>(a.vq + (cache_row0 + j) * D + part * 16));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!need[u]) continue;
      const int j = j0 + u * KPI + sub;
      float vv[16];
      to_floats(raw[u], vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = r < rows ? sc[r * L + j] : 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }
  // Sum over the threads that own the same 16 columns: in the warp by
  // shuffles, then over the warps in shared memory.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int o = TPK; o < 32; o <<= 1) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
  if (lane < TPK) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[(warp * R + r) * D + part * 16 + c] = acc[r][c];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[(w * R + r) * D + c];
    const int hq = h * a.group + r / a.S;
    T* orow = static_cast<T*>(a.o) + b * a.os[0] + hq * a.os[1] + (r % a.S) * a.os[2];
    orow[c] = from_f<T>(o);
  }
}

template <typename T, int D, int R>
cudaError_t launch(const QArgs& a, int B, cudaStream_t stream) {
  auto kernel = quantized_cache_attention_kernel<T, D, R>;
  const size_t smem = smem_bytes(R, a.L, D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rows(const QArgs& a, int B, cudaStream_t stream) {
  const int rows = a.group * a.S;
  if (rows <= 1) return launch<T, D, 1>(a, B, stream);
  if (rows <= 2) return launch<T, D, 2>(a, B, stream);
  if (rows <= 4) return launch<T, D, 4>(a, B, stream);
  return launch<T, D, 8>(a, B, stream);
}

template <typename T>
cudaError_t dispatch(const QArgs& a, int B, int D, cudaStream_t stream) {
  if (D == 32) return dispatch_rows<T, 32>(a, B, stream);
  if (D == 64) return dispatch_rows<T, 64>(a, B, stream);
  return dispatch_rows<T, 128>(a, B, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes; the wrapper's predicate asks.
long long mm_quantized_cache_attention_smem(int rows, int L, int D) {
  const int R = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
  return (long long)smem_bytes(R, L, D);
}

// q (B, Hq, S, D) of `dtype` (0 = fp32, 1 = bf16), last dimension contiguous,
// other strides in elements; k_q / v_q (B, Hkv, L, D) int8 and k_scale /
// v_scale (B, Hkv, L) fp32, contiguous; mask: bool bytes with strides (batch,
// row, position), 0 on broadcast dimensions; out like q. Hq = group * Hkv,
// group * S <= 8, D in {32, 64, 128}. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
int mm_quantized_cache_attention(const void* q, const long long* q_strides, const void* k_q,
                                 const void* k_scale, const void* v_q, const void* v_scale,
                                 const void* mask, const long long* mask_strides, void* out,
                                 const long long* out_strides, int B, int Hq, int Hkv, int S,
                                 int L, int D, float sm_scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || L <= 0 ||
      (Hq / Hkv) * S > 8 || (D != 32 && D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.q = q;
  a.kq = static_cast<const int8_t*>(k_q);
  a.kscale = static_cast<const float*>(k_scale);
  a.vq = static_cast<const int8_t*>(v_q);
  a.vscale = static_cast<const float*>(v_scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i];
    a.ms[i] = mask_strides[i];
    a.os[i] = out_strides[i];
  }
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.L = L;
  a.group = Hq / Hkv;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(a, B, D, st);
  return (int)dispatch<__nv_bfloat16>(a, B, D, st);
}

}  // extern "C"
