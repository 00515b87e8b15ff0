// Backward of the fused two-layer MLP, stage 1, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_mlp_bwd_pallas` (kernel
// body `_mlp_bwd_kernel`, derivative table `_act_and_grad`).
//
// What it computes, on x (R, Din), the output gradient g (R, Dout), W1
// (Din, Dff), b1 (Dff) and W2 (Dff, Dout), all of the compute type T (fp32
// or bf16). As in the forward kernel, the weights are taken column-major,
// that is as W1^T (Dff, Din) and W2^T (Dout, Dff) row-major, the layout of
// torch.nn.Linear's weights, so the layer passes them without a copy:
//   z   = x . W1 (fp32 sum) + b1 (fp32)           recomputed, never stored
//   h   = T(act(z))                                for dW2 = h^T g outside
//   da  = T((g . W2^T) (fp32 sum) * act'(z))       for dW1 = x^T da, db1
//   dx  = T(da . W1^T) (fp32 sum)
// The fp32 (R, Dff) tensors z, act'(z) and g . W2^T never reach device
// memory; the weight and bias gradients are large plain products and sums
// left to the caller, as in the JAX package.
//
// What bounds it on this card: operations. Three products of
// 2 * R * Dff * {Din, Dout, Din} FLOPs: 181 GFLOP for the CLIP vision MLP at
// batch 256 (12,800 rows, 768 -> 3072 -> 768), 124 GFLOP for the text MLP,
// against about 226 MB that must move.
//
// Design: the forward kernel's shape, turned around. A block owns 64 rows
// and, in bf16, all of Din up to 768 columns of dx: 16 warps keep the
// 64 x 768 fp32 dx accumulator in registers. It walks Dff in chunks of 64.
// For each chunk it streams, through one two-stage cp.async pipeline, first
// the (x, W1^T) slices of z = x . W1[:, chunk] (K = Din) and then the
// (g, W2^T) slices of g . W2[chunk, :]^T (K = Dout), both into one 16 x 16
// warp-tile accumulator; z is parked in fp32 shared memory between the two
// (each thread its own fragment), so bias, act, act' and the product
// da = dh * act' are elementwise in each thread. h and da go out to
// device memory and da into shared memory; then dx += da . W1^T[chunk, :]
// against the W1^T chunk, whose copy ran under the two products. So every
// product runs once per row, nothing is reduced across blocks, and no fp32
// (R, Dff) tensor is written. In bf16 the products are `mma.sync` m16n8k16
// with fragments from `ldmatrix` (`.trans` where a weight is read along its
// other axis: W2^T in the second product, W1^T in the third); in fp32 the
// same tiling runs the fragments' products on the FP32 pipes at 256 dx
// columns a block, re-running the first two products per column tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlp_bwd_common.cuh"

namespace {

using mm::act_and_grad;
using mm::cp_async_commit;
using mm::cp_async_wait;
using mm::from_f;
using mm::load_tile_async;
using mm::Mma;
using mm::to_f;

constexpr int BM = 64;  // rows per block
constexpr int BF = 64;  // Dff chunk
constexpr int BK = 64;  // K slice of the first two products
constexpr int kThreads = 512;
// Shared-memory row pitches, in elements: +8 keeps rows 16-byte aligned and
// staggers them across banks for ldmatrix.
constexpr int SLP = BK + 8;  // stage tiles
constexpr int DAP = BF + 8;  // da chunk
constexpr int ZSP = BF + 8;  // fp32 z chunk: float2 stores of a fragment row hit 32 banks

// NJ: 8-column mma tiles a warp owns in dx; the block's dx tile is
// BN = 64 * NJ columns wide (8 warps across).
template <typename T, int NJ>
struct Smem {
  T a[2][BM * SLP];              // x or g slice, two stages         (BM x BK)
  T b[2][64 * SLP];              // W1^T [f][k] or W2^T [o][f] slice  (64 x 64)
  T das[BM * DAP];               // da chunk                         (BM x BF)
  float zs[BM * ZSP];            // z chunk, fp32, without b1        (BM x BF)
  T w1c[BF * (64 * NJ + 8)];     // W1^T chunk [f][d]                (BF x BN)
};

template <typename T, int ACT, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ w1,
                     const T* __restrict__ b1, const T* __restrict__ w2, T* __restrict__ dx,
                     T* __restrict__ da, T* __restrict__ h, int R, int Din, int Dff, int Dout) {
  using M = Mma<T>;
  constexpr int BN = 64 * NJ;
  constexpr int WP = BN + 8;  // pitch of the W1^T chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, NJ>& sm = *reinterpret_cast<Smem<T, NJ>*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * BN;  // dx column tile
  const int m0 = blockIdx.y * BM;  // row tile
  const bool writes_hda = blockIdx.x == 0;  // one column tile writes h and da

  // First two products: a warp owns 16 rows x 16 columns of the chunk.
  const int cr = (warp >> 2) * 16;
  const int cc = (warp & 3) * 16;
  // Third product: a warp owns 32 rows x 8 * NJ columns of the dx tile; its
  // column tiles at or past Din (a multiple of 64) are skipped.
  const int xr = (warp >> 3) * 32;
  const int xc = (warp & 7) * 8 * NJ;

  float acc[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  const int nk1 = Din / BK;
  const int ns = nk1 + Dout / BK;
  // Slice s < nk1: x[:, s*BK..] and W1^T[f0.., s*BK..] (both [row][k]);
  // slice s >= nk1: g[:, o0..] and W2^T[o0.., f0..] ([k][n]).
  auto load_slice = [&](int s, int st, int f0) {
    if (s < nk1) {
      load_tile_async<T, BM, BK, kThreads>(sm.a[st], SLP, x, Din, m0, s * BK, R, Din);
      load_tile_async<T, BF, BK, kThreads>(sm.b[st], SLP, w1, Din, f0, s * BK, Dff, Din);
    } else {
      const int o0 = (s - nk1) * BK;
      load_tile_async<T, BM, BK, kThreads>(sm.a[st], SLP, g, Dout, m0, o0, R, Dout);
      load_tile_async<T, BK, BF, kThreads>(sm.b[st], SLP, w2, Dff, o0, f0, Dout, Dff);
    }
    cp_async_commit();
  };

  for (int f0 = 0; f0 < Dff; f0 += BF) {
    // One accumulator serves both products: z, parked in shared memory when
    // its last slice is in, then dh. Each thread reads back only what it
    // parked, so the park needs no barrier; it frees 8 registers for dx's.
    float c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;

    // The W1^T chunk of the third product does not depend on the first
    // two: its copy runs under them.
    load_tile_async<T, BF, BN, kThreads>(sm.w1c, WP, w1, Din, f0, n0, Dff, Din);
    cp_async_commit();
    load_slice(0, 0, f0);
    for (int s = 0; s < ns; ++s) {
      const int st = s & 1;
      if (s + 1 < ns) {
        load_slice(s + 1, st ^ 1, f0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (s < nk1) {  // z += x . W1[:, chunk]
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          typename M::A a;
          M::load_a(a, sm.a[st] + cr * SLP + kk, SLP);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            typename M::B bf;
            M::load_b(bf, sm.b[st] + (cc + 8 * j) * SLP + kk, SLP);
            M::mma(c[j], a, bf);
          }
        }
      } else {  // dh += g . W2[chunk, :]^T
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          typename M::A a;
          M::load_a(a, sm.a[st] + cr * SLP + kk, SLP);
          typename M::B b0, b1;
          M::load_b2_t(b0, b1, sm.b[st] + kk * SLP + cc, SLP);
          M::mma(c[0], a, b0);
          M::mma(c[1], a, b1);
        }
      }
      __syncthreads();  // stage st is refilled by the next step's copy
      if (s == nk1 - 1) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int row = cr + gq + (e >> 1) * 8;
            const int col = cc + 8 * j + 2 * t4;
            *reinterpret_cast<float2*>(&sm.zs[row * ZSP + col]) =
                make_float2(c[j][e], c[j][e + 1]);
            c[j][e] = c[j][e + 1] = 0.f;
          }
      }
    }

    // fp32 bias, act and act'; h and da rounded to T.
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = cr + gq + (e >> 1) * 8;
        const int col = cc + 8 * j + 2 * t4 + (e & 1);
        float hv, dv;
        act_and_grad<ACT>(sm.zs[row * ZSP + col] + to_f(b1[f0 + col]), hv, dv);
        const T dav = from_f<T>(c[j][e] * dv);
        sm.das[row * DAP + col] = dav;
        if (writes_hda && m0 + row < R) {
          const size_t o = (size_t)(m0 + row) * Dff + f0 + col;
          h[o] = from_f<T>(hv);
          da[o] = dav;
        }
      }
    __syncthreads();  // das is complete; the W1^T chunk landed with the last wait

    // dx += da . W1^T[chunk, :]
#pragma unroll
    for (int kk = 0; kk < BF; kk += 16) {
      typename M::A a[2];
      M::load_a(a[0], sm.das + xr * DAP + kk, DAP);
      M::load_a(a[1], sm.das + (xr + 16) * DAP + kk, DAP);
#pragma unroll
      for (int nj = 0; nj < NJ; nj += 2) {
        if (n0 + xc + 8 * nj < Din) {
          typename M::B b0, b1;
          M::load_b2_t(b0, b1, sm.w1c + kk * WP + xc + 8 * nj, WP);
          M::mma(acc[0][nj], a[0], b0);
          M::mma(acc[1][nj], a[1], b0);
          M::mma(acc[0][nj + 1], a[0], b1);
          M::mma(acc[1][nj + 1], a[1], b1);
        }
      }
    }
    __syncthreads();  // das and w1c are rewritten by the next chunk
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + xr + 16 * mi + gq + (e >> 1) * 8;
        const int col = n0 + xc + 8 * nj + 2 * t4 + (e & 1);
        if (row < R && col < Din) dx[(size_t)row * Din + col] = from_f<T>(acc[mi][nj][e]);
      }
}

// Launches the kernel at dx tile width 64 * NJ on a grid of dx column
// tiles by 64-row tiles.
template <typename T, int ACT, int NJ>
cudaError_t launch(const T* x, const T* g, const T* w1, const T* b1, const T* w2, T* dx, T* da,
                   T* h, int R, int Din, int Dff, int Dout, cudaStream_t stream) {
  auto kernel = fused_mlp_bwd_kernel<T, ACT, NJ>;
  const size_t smem = sizeof(Smem<T, NJ>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Din + 64 * NJ - 1) / (64 * NJ), (R + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout);
  return cudaGetLastError();
}

// dx tile width: bf16 covers Din up to 768 with one block per 64 rows, so
// the first two products run once per row; a narrower Din takes the
// narrowest tile that covers it, a wider one splits into 768-column tiles.
// fp32 keeps 256 columns (NJ = 4): its W1^T chunk would not fit shared
// memory at 768. At 768 columns the 96 fp32 dx accumulators of a thread
// leave too few of the 128 registers it has at 512 threads, and the kernel
// spills.
template <typename T, int ACT>
cudaError_t launch_tile(const void* x, const void* g, const void* w1, const void* b1,
                        const void* w2, void* dx, void* da, void* h, int R, int Din, int Dff,
                        int Dout, cudaStream_t st) {
  const T *xt = static_cast<const T*>(x), *gt = static_cast<const T*>(g);
  const T *w1t = static_cast<const T*>(w1), *b1t = static_cast<const T*>(b1);
  const T* w2t = static_cast<const T*>(w2);
  T *dxt = static_cast<T*>(dx), *dat = static_cast<T*>(da), *ht = static_cast<T*>(h);
#define MM_TILE(NJ) launch<T, ACT, NJ>(xt, gt, w1t, b1t, w2t, dxt, dat, ht, R, Din, Dff, Dout, st)
  if constexpr (sizeof(T) == 4) {
    return MM_TILE(4);
  } else {
    if (Din <= 256) return MM_TILE(4);
    if (Din <= 384) return MM_TILE(6);
    if (Din <= 512) return MM_TILE(8);
    return MM_TILE(12);
  }
#undef MM_TILE
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* w1, const void* b1,
                     const void* w2, void* dx, void* da, void* h, int R, int Din, int Dff,
                     int Dout, int act, cudaStream_t st) {
  switch (act) {
    case 0: return launch_tile<T, 0>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, st);
    case 1: return launch_tile<T, 1>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, st);
    case 2: return launch_tile<T, 2>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, st);
    case 3: return launch_tile<T, 3>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, st);
    case 4: return launch_tile<T, 4>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (R, Din), g (R, Dout), b1 (Dff), dx (R, Din), da and h (R, Dff)
// row-major; w1 and w2 are W1^T (Dff, Din) and W2^T (Dout, Dff) row-major.
// All contiguous, 16-byte aligned and of `dtype` (0 = fp32, 1 = bf16);
// `act` is an activation code. Needs Din, Dff and Dout to be multiples of
// 64. Launches on `stream`, allocates
// nothing and returns cudaGetLastError() of the launch.
int mm_fused_mlp_bwd(const void* x, const void* g, const void* w1, const void* b1,
                     const void* w2, void* dx, void* da, void* h, int R, int Din, int Dff,
                     int Dout, int act, int dtype, void* stream) {
  if (R <= 0 || Din <= 0 || Dff <= 0 || Dout <= 0 || Din % BK || Dff % BF || Dout % BK ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, act, st);
  return (int)dispatch<__nv_bfloat16>(x, g, w1, b1, w2, dx, da, h, R, Din, Dff, Dout, act, st);
}

}  // extern "C"
