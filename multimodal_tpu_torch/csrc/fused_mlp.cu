// Fused two-layer MLP, act(x . W1 + b1) . W2 + b2, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_mlp_impl` (kernel body
// `_mlp_kernel`, activation table `_KERNEL_ACTIVATIONS`).
//
// What it computes, on x (R, Din), W1 (Din, Dff), W2 (Dff, Dout) and the
// biases, all of the compute type T (fp32 or bf16). The weights are taken
// column-major, that is as the transposes of row-major (Dff, Din) and
// (Dout, Dff) matrices: the layout in which torch.nn.Linear holds them, and
// the [n][k] layout the tensor cores read B in, so neither needs a copy:
//   z   = x . W1 (fp32 sum) + b1 (fp32)
//   h   = T(act(z))            activation in fp32, then rounded to T
//   out = T(h . W2 (fp32 sum) + b2 (fp32))
// The (R, Dff) intermediate never reaches device memory as a whole: it lives
// in shared memory one (64 x 64) chunk at a time.
//
// What bounds it on this card: operations. At the CLIP shapes (R = 25,600 or
// 39,424 rows, 768 -> 3072 -> 768 and 512 -> 2048 -> 512) the two products
// are 165-242 GFLOP against about 85-88 MB of bytes that must move.
//
// Design: the TPU kernel keeps both weight matrices resident in VMEM, which
// does not fit 227 KB of shared memory (768 x 3072 in bf16 alone is
// 4.7 MB). What has to stay on chip is the fp32 output accumulator,
// rows x Dout. Each block owns 64 rows and, in bf16, the whole of Dout up
// to 768 columns: 16 warps keep the 64 x 768 fp32 accumulator in registers
// (32 x 96 each). It walks Dff in chunks of 64: it computes the chunk of h
// for its 64 rows (x . W1 streamed in 64-wide slices; 16 x 16 a warp),
// applies bias and activation in fp32, rounds to T into shared memory, and
// adds h_chunk . W2_chunk to its accumulator. So each product runs once per
// row (no recompute), nothing is reduced across blocks (deterministic, no
// atomics, no fp32 partials in device memory), and every block re-reads
// the weights from L2 with 64 rows of reuse per weight byte. Splitting Dff
// across blocks instead would write and re-read fp32 partials of the whole
// output per chunk. In bf16 the products run on the tensor cores through
// `mma.sync` m16n8k16 with fragments loaded by `ldmatrix`; in fp32 (no
// tensor-core fp32 without TF32 rounding) the same tiling, at 256 output
// columns a block, runs the fragments' products on the FP32 pipes. Copies
// into shared memory are cp.async, two stages deep for the x / W1 slices,
// and the W2 chunk's copy runs under the first product. The 16 x 16 warp
// tile of the first product reads more shared memory per `mma` than the
// tensor cores need; `wgmma` (B read from shared memory by the hardware),
// TMA and warp specialisation are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mm::cp_async_commit;
using mm::cp_async_wait;
using mm::from_f;
using mm::to_f;

constexpr int BM = 64;   // rows per block
constexpr int BF = 64;   // Dff chunk
constexpr int BK = 64;   // Din slice of the first product
constexpr int kThreads = 512;
// Shared-memory row pitches, in elements: +8 keeps rows 16-byte aligned
// and staggers them across banks for ldmatrix.
constexpr int XP = BK + 8;
constexpr int W1P = BK + 8;
constexpr int HP = BF + 8;
constexpr int W2P = BF + 8;

// NJ: 8-column mma tiles a warp owns in the second product; the block's
// output tile is BN = 64 * NJ columns wide (8 warps across).
template <typename T, int NJ>
struct Smem {
  T xs[2][BM * XP];     // x slice, two stages      (BM x BK)
  T w1s[2][BF * W1P];   // W1^T slice, two stages   (BF x BK)
  T hs[BM * HP];        // h chunk                  (BM x BF)
  T w2s[64 * NJ * W2P]; // W2^T chunk               (BN x BF)
};

// Activation codes match `_ACT_CODES` in ops/fused_encoder.py.
template <int ACT>
__device__ __forceinline__ float act(float z) {
  if (ACT == 0) return z / (1.f + expf(-1.702f * z));  // quick_gelu
  if (ACT == 1)                                         // gelu, tanh form
    return 0.5f * z * (1.f + tanhf(0.7978845608028654f * (z + 0.044715f * z * z * z)));
  if (ACT == 2) return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));  // gelu_exact
  if (ACT == 3) return fmaxf(z, 0.f);                                     // relu
  return z / (1.f + expf(-z));                                            // silu
}

// Warp-level 16x8x16 product on tiles in shared memory: A is 16 x 16
// row-major [m][k] (pitch lda), B is 16 x 8 stored [n][k] (pitch ldb). The
// accumulator follows the mma.m16n8 layout: with g = lane / 4 and
// t = lane % 4, c[0], c[1] are (g, 2t), (g, 2t + 1) and c[2], c[3] the same
// columns of row g + 8.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ void load_a(A& a, const __nv_bfloat16* p, int lda) {
    const int lane = threadIdx.x & 31;
    mm::ldsm_x4(a.r, p + (lane & 15) * lda + (lane >> 4) * 8);
  }
  static __device__ __forceinline__ void load_b(B& b, const __nv_bfloat16* p, int ldb) {
    const int lane = threadIdx.x & 31;
    mm::ldsm_x2(b.r, p + (lane & 7) * ldb + ((lane >> 3) & 1) * 8);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mm::mma_bf16(c, a.r, b.r[0], b.r[1]);
  }
};

template <>
struct Mma<float> {
  struct A { const float* p; int ld; };
  struct B { const float* p; int ld; };
  static __device__ __forceinline__ void load_a(A& a, const float* p, int lda) {
    a.p = p;
    a.ld = lda;
  }
  static __device__ __forceinline__ void load_b(B& b, const float* p, int ldb) {
    b.p = p;
    b.ld = ldb;
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    const int lane = threadIdx.x & 31;
    const float* a0 = a.p + (lane >> 2) * a.ld;
    const float* a1 = a0 + 8 * a.ld;
    const float* b0 = b.p + 2 * (lane & 3) * b.ld;
    const float* b1 = b0 + b.ld;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float x0 = a0[k], x1 = a1[k];
      const float y0 = b0[k], y1 = b1[k];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

// Start copying a ROWS x COLS tile at (r0, c0) of a row-major matrix with
// leading dimension ld into shared memory (pitch `pitch`), 16 bytes per
// thread and step, with cp.async; rows >= rmax and columns >= cmax are
// zero-filled without being read.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile_async(T* s, int pitch, const T* g, int ld, int r0,
                                                int c0, int rmax, int cmax) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CV = COLS / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CV; idx += kThreads) {
    const int r = idx / CV;
    const int c = (idx - r * CV) * VEC;
    const bool in = r0 + r < rmax && c0 + c < cmax;
    mm::cp_async16(s + r * pitch + c, in ? g + (size_t)(r0 + r) * ld + c0 + c : g, in ? 16 : 0);
  }
}

template <typename T, int ACT, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                 int R, int Din, int Dff, int Dout) {
  using M = Mma<T>;
  constexpr int BN = 64 * NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, NJ>& sm = *reinterpret_cast<Smem<T, NJ>*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * BN;  // output column tile
  const int m0 = blockIdx.y * BM;  // row tile

  // First product: a warp owns 16 rows x 16 columns of the h chunk.
  const int w1r = (warp >> 2) * 16;
  const int w1c = (warp & 3) * 16;
  // Second product: a warp owns 32 rows x 8 * NJ columns of the output tile;
  // its column tiles at or past Dout (a multiple of 8) are skipped.
  const int w2r = (warp >> 3) * 32;
  const int w2c = (warp & 7) * 8 * NJ;

  float acc2[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[mi][nj][e] = 0.f;

  for (int f0 = 0; f0 < Dff; f0 += BF) {
    float acc1[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[j][e] = 0.f;

    // The W2 chunk does not depend on the first product: its copy runs
    // under it. The x / W1 slices go through two stages, the copy of
    // slice k + 1 running under the products of slice k.
    load_tile_async<T, BN, BF>(sm.w2s, W2P, w2, Dff, n0, f0, Dout, Dff);
    cp_async_commit();
    const int nk = Din / BK;
    load_tile_async<T, BM, BK>(sm.xs[0], XP, x, Din, m0, 0, R, Din);
    load_tile_async<T, BF, BK>(sm.w1s[0], W1P, w1, Din, f0, 0, Dff, Din);
    cp_async_commit();
    for (int ks = 0; ks < nk; ++ks) {
      const int st = ks & 1;
      if (ks + 1 < nk) {
        load_tile_async<T, BM, BK>(sm.xs[st ^ 1], XP, x, Din, m0, (ks + 1) * BK, R, Din);
        load_tile_async<T, BF, BK>(sm.w1s[st ^ 1], W1P, w1, Din, f0, (ks + 1) * BK, Dff, Din);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        typename M::A a;
        M::load_a(a, sm.xs[st] + w1r * XP + kk, XP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          typename M::B bf;
          M::load_b(bf, sm.w1s[st] + (w1c + 8 * j) * W1P + kk, W1P);
          M::mma(acc1[j], a, bf);
        }
      }
      __syncthreads();  // stage st is refilled by the copy issued next step
    }

    // Epilogue of the first product: fp32 bias and activation, round to T.
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = w1r + g + (e >> 1) * 8;
        const int col = w1c + 8 * j + 2 * t4 + (e & 1);
        const float z = acc1[j][e] + to_f(b1[f0 + col]);
        sm.hs[row * HP + col] = from_f<T>(act<ACT>(z));
      }
    __syncthreads();  // the W2 chunk landed with the last slice's wait

#pragma unroll
    for (int kk = 0; kk < BF; kk += 16) {
      typename M::A a[2];
      M::load_a(a[0], sm.hs + w2r * HP + kk, HP);
      M::load_a(a[1], sm.hs + (w2r + 16) * HP + kk, HP);
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        if (n0 + w2c + 8 * nj < Dout) {
          typename M::B bf;
          M::load_b(bf, sm.w2s + (w2c + 8 * nj) * W2P + kk, W2P);
          M::mma(acc2[0][nj], a[0], bf);
          M::mma(acc2[1][nj], a[1], bf);
        }
      }
    }
    __syncthreads();  // hs and w2s are rewritten by the next chunk
  }

  // Epilogue of the second product: fp32 bias, round to T.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + w2r + 16 * mi + g + (e >> 1) * 8;
        const int col = n0 + w2c + 8 * nj + 2 * t4 + (e & 1);
        if (row < R && col < Dout)
          out[(size_t)row * Dout + col] = from_f<T>(acc2[mi][nj][e] + to_f(b2[col]));
      }
}

template <typename T, int ACT, int NJ>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int R, int Din, int Dff, int Dout,
                   cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<T, ACT, NJ>;
  const size_t smem = sizeof(Smem<T, NJ>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Dout + 64 * NJ - 1) / (64 * NJ), (R + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), R, Din, Dff,
      Dout);
  return cudaGetLastError();
}

// Output tile width: bf16 covers Dout up to 768 with one block per 64 rows
// (NJ = 12: 96 accumulator registers a thread), so the first product runs
// once per row; a narrower Dout takes the narrowest tile that covers it,
// and a wider one splits into 768-column tiles. fp32 keeps 256 columns
// (NJ = 4): its W2 chunk would not fit shared memory at 768.
template <typename T, int ACT>
cudaError_t launch_tile(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int R, int Din, int Dff, int Dout,
                      cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    return launch<T, ACT, 4>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
  } else {
    if (Dout <= 256) return launch<T, ACT, 4>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    if (Dout <= 384) return launch<T, ACT, 6>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    if (Dout <= 512) return launch<T, ACT, 8>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    return launch<T, ACT, 12>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int R, int Din, int Dff, int Dout, int act,
                     cudaStream_t st) {
  switch (act) {
    case 0: return launch_tile<T, 0>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    case 1: return launch_tile<T, 1>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    case 2: return launch_tile<T, 2>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    case 3: return launch_tile<T, 3>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    case 4: return launch_tile<T, 4>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (R, Din), b1 (Dff), b2 (Dout) and out (R, Dout) row-major; w1 and w2
// are W1^T (Dff, Din) and W2^T (Dout, Dff) row-major. All contiguous,
// 16-byte aligned and of `dtype` (0 = fp32, 1 = bf16); `act` is an
// activation code. Needs Din, Dff and Dout to be multiples of 64. Launches
// on `stream`, allocates nothing and returns cudaGetLastError() of the
// launch.
int mm_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, int R, int Din, int Dff, int Dout, int act, int dtype,
                 void* stream) {
  if (R <= 0 || Din <= 0 || Dff <= 0 || Dout <= 0 || Din % BK || Dff % BF || Dout % 64 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, act, st);
  return (int)dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, act, st);
}

}  // extern "C"
