// Pieces that the MLP backward kernels share: the activation table, and the
// first two stages of kernel #4 (csrc/fused_mlp_bwd.cu: dx, da and h) and
// kernel #5 (csrc/fused_mlp_bwd_acc.cu: dx and the weight gradients), which
// compute the same tensors:
//  1. z and dh: a block owns a 128-row x 128-column tile of (R, Dff) and
//     runs x . W1 (K = Din) and then g . W2^T (K = Dout) into two
//     accumulators. Its epilogue adds b1, applies the activation table,
//     forms da = dh * act'(z), and writes da_c = T(da) and h_c = T(act(z));
//     #5's instance also writes the tile's fp32 column sums of the
//     unrounded da, one db1 partial per 128-row tile.
//  2. dx = da_c . W1^T (K = Dff), a block per 128 x 128 tile of dx, with K
//     split into `splits` runs where the tiles alone leave SMs idle (#4 at a
//     few hundred rows): each run then writes an fp32 partial that a
//     fixed-order pass sums, so two launches give the same bits.
// In bf16 both are GEMMs on the core of csrc/wgmma_gemm.cuh (stage 1 holds
// two accumulators, 128 registers a thread, at one block an SM; stage 2
// one, at two). fp32 has no `wgmma` without TF32, which would change the
// numbers: it runs the same stages as 128 x 64 tiles on the FP32 pipes,
// each thread 8 x 4 of a tile. Each kernel file wraps the bodies in
// `__global__` functions of its own names, so a profile files them under
// their kernel.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the stages on the GEMM core
// ---------------------------------------------------------------------------

using wg::BK;
using wg::BM;
using wg::BN;

constexpr int kZdhStages = 6;  // one block an SM
constexpr int kStages = 3;     // two blocks an SM
constexpr size_t kZdhSmem = wg::smem_bytes<kZdhStages>(8 * BN * sizeof(float));
constexpr size_t kSmem = wg::smem_bytes<kStages>(0);

struct ZdhParams {
  CUtensorMap x, w1, g, w2;  // x (R, Din), W1^T (Dff, Din), g (R, Dout), W2^T (Dout, Dff)
  const __nv_bfloat16* b1;
  __nv_bfloat16* dac;  // (R, Dff)
  __nv_bfloat16* hc;   // (R, Dff)
  float* dbp;          // (R / 128 tiles, Dff): the tiles' column sums of da (#5)
  int R, Din, Dff, Dout;
};

struct DxParams {
  CUtensorMap dac, w1;  // da_c (R, Dff), W1^T (Dff, Din)
  __nv_bfloat16* dx;    // splits == 1: T(da_c . W1^T)
  float* part;          // splits > 1: run r's fp32 partial at part + r R Din
  int R, Din, Dff, splits, kb_per_run;  // run r: k-blocks [r kb_per_run, + kb_per_run)
};

// A consumer thread's accumulator element d[4 j + 2 hf + e] is row
// acc_row0() + 8 hf, column acc_col0() + 8 j + e of the block's tile.
__device__ __forceinline__ int acc_row0() {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4;
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x % 4); }

__device__ __forceinline__ void clear(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wg::fence_acc(d);
}

// Stage 1 in a kernel of wg::kThreads threads and kZdhSmem bytes of dynamic
// shared memory at `smem_raw`: z and dh of 128 x 128 tiles of (R, Dff),
// column tiles fastest, then h_c, da_c and, with DB1, each tile's db1
// partial.
template <int ACT, bool DB1>
__device__ __forceinline__ void zdh_stage(const ZdhParams& p, uint8_t* smem_raw) {
  const wg::Ring<kZdhStages> ring(smem_raw);
  float* red = reinterpret_cast<float*>(ring.extra);  // [8 warps][BN]
  const int nk1 = p.Din / BK;
  const int ftiles = (p.Dff + BN - 1) / BN;
  const int row_tiles = (p.R + BM - 1) / BM;
  auto tile = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  float z[64], dh[64];
  clear(z);
  clear(dh);
  wg::run2(
      ring, wg::items_of_block(row_tiles * ftiles), [&](int) { return nk1; },
      [&](int) { return p.Dout / BK; },
      [&](int i, int kb, uint8_t* a, uint8_t* b, uint64_t* bar) {
        const int m0 = tile(i) / ftiles * BM, n0 = tile(i) % ftiles * BN;
        if (kb < nk1) {
          wg::load_operand<wg::K>(a, &p.x, bar, m0, kb * BK);
          wg::load_operand<wg::K>(b, &p.w1, bar, n0, kb * BK);
        } else {
          wg::load_operand<wg::K>(a, &p.g, bar, m0, (kb - nk1) * BK);
          wg::load_operand<wg::MN>(b, &p.w2, bar, n0, (kb - nk1) * BK);
        }
      },
      [&](int, uint32_t a, uint32_t b) {
        wg::fence_acc(z);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::K>(z, a, b, kk);
        wg::fence_acc(z);
      },
      [&](int, uint32_t a, uint32_t b) {
        wg::fence_acc(dh);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::MN>(dh, a, b, kk);
        wg::fence_acc(dh);
      },
      [&](int i) {
        // fp32 bias, act and act'; da_c and h_c out; db1 from the unrounded
        // da of the rows below R, summed over rows in a fixed order.
        wg::fence_acc(z);
        wg::fence_acc(dh);
        const int mt = tile(i) / ftiles, n0 = tile(i) % ftiles * BN;
        const int r0 = mt * BM + acc_row0();
        const int warp = threadIdx.x / 32;
        const int lane = threadIdx.x % 32;
        if (DB1) wg::consumer_sync();  // the previous tile's reads of red are done
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + acc_col0();
          float s0 = 0.f, s1 = 0.f;
          if (c < p.Dff) {
            const float bias0 = mm::to_f(p.b1[c]), bias1 = mm::to_f(p.b1[c + 1]);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = r0 + 8 * hf;
              float h0, d0, h1, d1;
              act_and_grad<ACT>(z[4 * j + 2 * hf] + bias0, h0, d0);
              act_and_grad<ACT>(z[4 * j + 2 * hf + 1] + bias1, h1, d1);
              const float da0 = dh[4 * j + 2 * hf] * d0;
              const float da1 = dh[4 * j + 2 * hf + 1] * d1;
              if (r < p.R) {
                const size_t o = (size_t)r * p.Dff + c;
                *reinterpret_cast<__nv_bfloat162*>(p.dac + o) = __floats2bfloat162_rn(da0, da1);
                *reinterpret_cast<__nv_bfloat162*>(p.hc + o) = __floats2bfloat162_rn(h0, h1);
                s0 += da0;
                s1 += da1;
              }
            }
          }
          if (DB1) {
            // the 8 lanes that share lane % 4 hold the warp's 16 rows of a column
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, o);
              s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            }
            if (lane < 4) {
              red[warp * BN + 8 * j + 2 * lane] = s0;
              red[warp * BN + 8 * j + 2 * lane + 1] = s1;
            }
          }
        }
        if (DB1) {
          wg::consumer_sync();
          if (threadIdx.x < BN && n0 + (int)threadIdx.x < p.Dff) {
            float s = 0.f;
            for (int w = 0; w < 8; ++w) s += red[w * BN + threadIdx.x];
            p.dbp[(size_t)mt * p.Dff + n0 + threadIdx.x] = s;
          }
        }
        clear(z);
        clear(dh);
      });
}

// Stage 2 in a kernel of wg::kThreads threads and kSmem bytes of dynamic
// shared memory: items (tile, run) over the 128 x 128 tiles of dx = da_c .
// W1^T, tiles fastest, each over the k-blocks of its run of Dff.
__device__ __forceinline__ void dx_stage(const DxParams& p, uint8_t* smem_raw) {
  const wg::Ring<kStages> ring(smem_raw);
  const int ntiles = (p.Din + BN - 1) / BN;
  const int tiles = (p.R + BM - 1) / BM * ntiles;
  const int nk = p.Dff / BK;
  auto item = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  auto kb0 = [&](int i) { return item(i) / tiles * p.kb_per_run; };
  float acc[64];
  clear(acc);
  wg::run(
      ring, wg::items_of_block(tiles * p.splits),
      [&](int i) { return min(nk, kb0(i) + p.kb_per_run) - kb0(i); },
      [&](int i, int kb, uint8_t* a, uint8_t* b, uint64_t* bar) {
        const int t = item(i) % tiles;
        wg::load_operand<wg::K>(a, &p.dac, bar, t / ntiles * BM, (kb0(i) + kb) * BK);
        wg::load_operand<wg::MN>(b, &p.w1, bar, t % ntiles * BN, (kb0(i) + kb) * BK);
      },
      [&](int, uint32_t a, uint32_t b) {
        wg::fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::MN>(acc, a, b, kk);
        wg::fence_acc(acc);
      },
      [&](int i) {
        wg::fence_acc(acc);
        const int t = item(i) % tiles;
        const int r0 = t / ntiles * BM + acc_row0();
        const int n0 = t % ntiles * BN;
        float* part = p.part + (size_t)(item(i) / tiles) * p.R * p.Din;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + acc_col0();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            if (r < p.R && c < p.Din) {
              const size_t o = (size_t)r * p.Din + c;
              if (p.splits == 1)
                *reinterpret_cast<__nv_bfloat162*>(p.dx + o) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
              else
                *reinterpret_cast<float2*>(part + o) =
                    make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
            }
          }
        }
        clear(acc);
      });
}

// Host: the maps and launches of the two stages on `st`, #5's with db1
// partials into dbp, #4's without (dbp null). dx_part: fp32 room for
// `splits` partials of dx when splits > 1. ACT and DB1 name the kernels'
// instance, so that each instance sets its shared-memory size once.
template <int ACT, bool DB1, class ZdhKernel, class DxKernel>
cudaError_t launch_stages(ZdhKernel zdh_kernel, DxKernel dx_kernel, const void* x, const void* g,
                          const void* w1, const void* b1, const void* w2, void* dx, void* dac,
                          void* hc, float* dbp, float* dx_part, int R, int Din, int Dff,
                          int Dout, int splits, cudaStream_t st) {
  static const cudaError_t smem_err = [&] {
    const cudaError_t e = wg::allow_smem(zdh_kernel, kZdhSmem);
    return e != cudaSuccess ? e : wg::allow_smem(dx_kernel, kSmem);
  }();
  if (smem_err != cudaSuccess) return smem_err;
  const int row_tiles = (R + BM - 1) / BM;
  cudaError_t err;
  ZdhParams zp;
#define MM_MAP(map, ptr, rows, cols) \
  if ((err = wg::make_map(&(map), ptr, rows, cols)) != cudaSuccess) return err
  MM_MAP(zp.x, x, R, Din);
  MM_MAP(zp.w1, w1, Dff, Din);
  MM_MAP(zp.g, g, R, Dout);
  MM_MAP(zp.w2, w2, Dout, Dff);
  zp.b1 = static_cast<const __nv_bfloat16*>(b1);
  zp.dac = static_cast<__nv_bfloat16*>(dac);
  zp.hc = static_cast<__nv_bfloat16*>(hc);
  zp.dbp = dbp;
  zp.R = R;
  zp.Din = Din;
  zp.Dff = Dff;
  zp.Dout = Dout;
  zdh_kernel<<<wg::persistent_grid((Dff + BN - 1) / BN * row_tiles, 1), wg::kThreads, kZdhSmem,
               st>>>(zp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  DxParams xp;
  MM_MAP(xp.dac, dac, R, Dff);
#undef MM_MAP
  xp.w1 = zp.w1;
  xp.dx = static_cast<__nv_bfloat16*>(dx);
  xp.part = dx_part;
  xp.R = R;
  xp.Din = Din;
  xp.Dff = Dff;
  xp.splits = splits;
  xp.kb_per_run = (Dff / BK + splits - 1) / splits;
  dx_kernel<<<wg::persistent_grid((Din + BN - 1) / BN * row_tiles * splits, 2), wg::kThreads,
              kSmem, st>>>(xp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the stages on the FP32 pipes
// ---------------------------------------------------------------------------

constexpr int FM = 128, FN = 64, FK = 16;

struct F32Smem {
  float a[FK][FM + 1];
  float b[FK][FN + 1];
};

// c[i][j] += sum over k in [k0, k1) of A(m0 + ty + 16 i, k) B(k, n0 + tx + 16 j)
// with tx = thread % 16, ty = thread / 16; A(m, k) = a[m sam + k sak] and
// B(k, n) = b[k sbk + n sbn]; rows m >= M and columns n >= N read as 0.
__device__ __forceinline__ void f32_tile(float (&c)[8][4], const float* __restrict__ a,
                                         long long sam, long long sak, int M,
                                         const float* __restrict__ b, long long sbk,
                                         long long sbn, int N, int m0, int n0, int k0, int k1,
                                         F32Smem& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int kb = k0; kb < k1; kb += FK) {
    __syncthreads();  // the previous step's reads are done
    for (int idx = threadIdx.x; idx < FM * FK; idx += 256) {
      // neighbouring threads walk the operand's contiguous axis
      const int m = sak == 1 ? idx / FK : idx % FM;
      const int k = sak == 1 ? idx % FK : idx / FM;
      sm.a[k][m] = m0 + m < M && kb + k < k1 ? a[(m0 + m) * sam + (kb + k) * sak] : 0.f;
    }
    for (int idx = threadIdx.x; idx < FN * FK; idx += 256) {
      const int n = sbk == 1 ? idx / FK : idx % FN;
      const int k = sbk == 1 ? idx % FK : idx / FN;
      sm.b[k][n] = n0 + n < N && kb + k < k1 ? b[(kb + k) * sbk + (n0 + n) * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = sm.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }
}

// Stage 1 in a block of 256 threads, grid (Dff / FN, R / FM): da_c, h_c and,
// where dbp is not null, the tile's db1 partial.
template <int ACT>
__device__ __forceinline__ void zdh_f32_stage(const float* __restrict__ x,
                                              const float* __restrict__ g,
                                              const float* __restrict__ w1,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ w2,
                                              float* __restrict__ dac, float* __restrict__ hc,
                                              float* __restrict__ dbp, int R, int Din, int Dff,
                                              int Dout) {
  __shared__ F32Smem sm;
  __shared__ float red[16][FN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  float z[8][4] = {}, dh[8][4] = {};
  f32_tile(z, x, Din, 1, R, w1, 1, Din, Dff, m0, n0, 0, Din, sm);
  f32_tile(dh, g, Dout, 1, R, w2, Dff, 1, Dff, m0, n0, 0, Dout, sm);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = n0 + tx + 16 * j;
    float s = 0.f;
    if (f < Dff) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = m0 + ty + 16 * i;
        float h, d;
        act_and_grad<ACT>(z[i][j] + b1[f], h, d);
        const float da = dh[i][j] * d;
        if (r < R) {
          dac[(size_t)r * Dff + f] = da;
          hc[(size_t)r * Dff + f] = h;
          s += da;
        }
      }
    }
    red[ty][tx + 16 * j] = s;
  }
  if (dbp == nullptr) return;
  __syncthreads();
  if (threadIdx.x < FN && n0 + (int)threadIdx.x < Dff) {
    float s = 0.f;
    for (int i = 0; i < 16; ++i) s += red[i][threadIdx.x];
    dbp[(size_t)blockIdx.y * Dff + n0 + threadIdx.x] = s;
  }
}

// Stage 2 in a block of 256 threads, grid (Din / FN, R / FM).
__device__ __forceinline__ void dx_f32_stage(const float* __restrict__ dac,
                                             const float* __restrict__ w1,
                                             float* __restrict__ dx, int R, int Din, int Dff) {
  __shared__ F32Smem sm;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  float c[8][4] = {};
  f32_tile(c, dac, Dff, 1, R, w1, Din, 1, Din, m0, n0, 0, Dff, sm);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, d = n0 + tx + 16 * j;
      if (r < R && d < Din) dx[(size_t)r * Din + d] = c[i][j];
    }
}

}  // namespace mm
