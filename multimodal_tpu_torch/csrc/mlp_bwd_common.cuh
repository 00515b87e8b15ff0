// Pieces of the MLP backward kernels: the activations with their
// derivatives (csrc/fused_mlp_bwd.cu and csrc/fused_mlp_bwd_acc.cu), and for
// the first the warp-level 16x8x16 products in bf16 (tensor cores) and fp32
// (FP32 pipes) behind one fragment interface, and the cp.async tile copy.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace mm {

// (act(z), act'(z)) in fp32: the analytic forms of `_act_and_grad`. Codes
// match `_ACT_CODES` in ops/fused_encoder.py.
template <int ACT>
__device__ __forceinline__ void act_and_grad(float z, float& h, float& d) {
  if (ACT == 0) {  // quick_gelu
    const float s = 1.f / (1.f + expf(-1.702f * z));
    h = z * s;
    d = s * (1.f + 1.702f * z * (1.f - s));
  } else if (ACT == 1) {  // gelu, tanh form
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (z + 0.044715f * z * z * z));
    const float du = c * (1.f + 3.f * 0.044715f * z * z);
    h = 0.5f * z * (1.f + t);
    d = 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
  } else if (ACT == 2) {  // gelu_exact
    const float e = erff(z * 0.7071067811865476f);
    const float pdf = expf(-0.5f * z * z) * 0.3989422804014327f;
    h = 0.5f * z * (1.f + e);
    d = 0.5f * (1.f + e) + z * pdf;
  } else if (ACT == 3) {  // relu
    h = fmaxf(z, 0.f);
    d = z > 0.f ? 1.f : 0.f;
  } else {  // silu
    const float s = 1.f / (1.f + expf(-z));
    h = z * s;
    d = s * (1.f + z * (1.f - s));
  }
}

// Warp-level 16x8x16 products on tiles in shared memory. A is 16 x 16,
// stored [m][k] (`load_a`) or [k][m] (`load_a_t`), pitch lda. B is 16 x 8,
// stored [n][k] (`load_b`) or [k][n] (`load_b2_t`, two adjacent 8-column
// tiles at once). The accumulator follows the mma.m16n8 layout: with
// g = lane / 4 and t = lane % 4, c[0], c[1] are (g, 2t), (g, 2t + 1) and
// c[2], c[3] the same columns of row g + 8.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ void load_a(A& a, const __nv_bfloat16* p, int lda) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(a.r, p + (lane & 15) * lda + (lane >> 4) * 8);
  }
  // A^T stored row-major: the four 8 x 8 blocks are read transposed, in the
  // order (m0, k0), (m8, k0), (m0, k8), (m8, k8) that the fragment wants.
  static __device__ __forceinline__ void load_a_t(A& a, const __nv_bfloat16* p, int lda) {
    const int lane = threadIdx.x & 31;
    ldsm_x4_trans(a.r, p + ((lane & 7) + (lane >> 4) * 8) * lda + ((lane >> 3) & 1) * 8);
  }
  static __device__ __forceinline__ void load_b(B& b, const __nv_bfloat16* p, int ldb) {
    const int lane = threadIdx.x & 31;
    ldsm_x2(b.r, p + (lane & 7) * ldb + ((lane >> 3) & 1) * 8);
  }
  static __device__ __forceinline__ void load_b2_t(B& b0, B& b1, const __nv_bfloat16* p,
                                                   int ldb) {
    const int lane = threadIdx.x & 31;
    uint32_t r[4];
    ldsm_x4_trans(r, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8);
    b0.r[0] = r[0];
    b0.r[1] = r[1];
    b1.r[0] = r[2];
    b1.r[1] = r[3];
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_bf16(c, a.r, b.r[0], b.r[1]);
  }
};

template <>
struct Mma<float> {
  struct A { const float* p; int ldm; int ldk; };  // element (m, k) at p[m * ldm + k * ldk]
  struct B { const float* p; int ldk; int ldn; };  // element (k, n) at p[k * ldk + n * ldn]
  static __device__ __forceinline__ void load_a(A& a, const float* p, int lda) {
    a.p = p;
    a.ldm = lda;
    a.ldk = 1;
  }
  static __device__ __forceinline__ void load_a_t(A& a, const float* p, int lda) {
    a.p = p;
    a.ldm = 1;
    a.ldk = lda;
  }
  static __device__ __forceinline__ void load_b(B& b, const float* p, int ldb) {
    b.p = p;
    b.ldk = 1;
    b.ldn = ldb;
  }
  static __device__ __forceinline__ void load_b2_t(B& b0, B& b1, const float* p, int ldb) {
    b0.p = p;
    b0.ldk = ldb;
    b0.ldn = 1;
    b1.p = p + 8;
    b1.ldk = ldb;
    b1.ldn = 1;
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    const int lane = threadIdx.x & 31;
    const float* a0 = a.p + (lane >> 2) * a.ldm;
    const float* a1 = a0 + 8 * a.ldm;
    const float* b0 = b.p + 2 * (lane & 3) * b.ldn;
    const float* b1 = b0 + b.ldn;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float x0 = a0[k * a.ldk], x1 = a1[k * a.ldk];
      const float y0 = b0[k * b.ldk], y1 = b1[k * b.ldk];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

// Start copying a ROWS x COLS tile at (r0, c0) of a row-major matrix with
// leading dimension ld into shared memory (pitch `pitch`), 16 bytes per
// thread and step over the block's NT threads, with cp.async; rows >= rmax
// and columns >= cmax are zero-filled without being read.
template <typename T, int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile_async(T* s, int pitch, const T* g, int ld, int r0,
                                                int c0, int rmax, int cmax) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CV = COLS / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CV; idx += NT) {
    const int r = idx / CV;
    const int c = (idx - r * CV) * VEC;
    const bool in = r0 + r < rmax && c0 + c < cmax;
    cp_async16(s + r * pitch + c, in ? g + (size_t)(r0 + r) * ld + c0 + c : g, in ? 16 : 0);
  }
}

}  // namespace mm
