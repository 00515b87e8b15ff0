// Backward of the fused two-layer MLP with the weight gradients, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_mlp_bwd_acc_pallas`
// (kernel body `_mlp_bwd_acc_kernel`, derivative table `_act_and_grad`).
//
// What it computes, on x (R, Din), the output gradient g (R, Dout), W1
// (Din, Dff), b1 (Dff) and W2 (Dff, Dout), all of the compute type T (fp32
// or bf16), the weights taken column-major as the layer holds them (W1^T
// (Dff, Din) and W2^T (Dout, Dff) row-major):
//   z    = x . W1 (fp32 sum) + b1,  (h, act') = (act(z), act'(z)) in fp32
//   da   = (g . W2^T) (fp32 sum) * act',  da_c = T(da),  h_c = T(h)
//   dx   = T(da_c . W1^T) (fp32 sum)
//   dW1  = x^T da_c,  dW2 = h_c^T g,  db1 = sum over rows of da (unrounded),
// the last three in fp32 over all rows, rows past R contributing nothing.
//
// What bounds it on this card: operations. The five products of the
// function are 2 * R * Dff * (2 Din + Dout) + 2 * R * Dff * (Din + Dout)
// FLOPs, 302 GFLOP for FLAVA's image MLP at batch 64 (12,608 rows, 768 ->
// 3072 -> 768), against about 80 MB that must move.
//
// Why the TPU design does not carry over: there the grid runs in order on
// one core and the fp32 dW1 and dW2 (18.9 MB at 768/3072) stay in VMEM
// across it, each row block adding into them. Here blocks run in parallel
// and in no order, and a block's shared memory holds 227 KB. dx sums over
// Dff for each row and dW sums over rows for each weight element, so one
// block cannot own both reductions.
//
// Design: two passes over the rows and a fixed-order reduction, all in
// fixed order, so two launches on the same inputs give the same bits (no
// atomics).
//  1. dx: the staged kernel's body (csrc/fused_mlp_bwd.cu, kernel #4's)
//     with its h and da stores compiled out, launched as
//     `fused_mlp_bwd_acc_dx_kernel`: a block owns 64 rows and up to 512
//     columns of dx (384-column tiles where Din > 512: wider tiles spill),
//     and walks all of Dff, so dx is summed in registers and written once.
//  2. dW: a block owns a 16-wide slice of Dff and one of `chunks` equal
//     runs of row tiles (64 rows in bf16, 32 in fp32). Per tile it copies
//     the tile's x and g into shared memory, where they stay (up to 768
//     wide), while it recomputes z and g . W2^T for its slice (4 warps
//     each, K = Din and K = Dout, the W slices double-buffered); it forms
//     h_c and da_c in shared memory and, from the resident x and g, adds
//     x^T da_c (its 16 rows of dW1^T) and g^T h_c (its 16 columns of
//     dW2^T) into fp32 accumulators that stay in registers across all its
//     tiles (96 a thread at Din = Dout = 768), and db1 from the unrounded
//     da. It writes its chunk's partial once.
//  3. With more than one chunk, a reduction sums the chunks' partials in
//     chunk order into the outputs.
// The z and g . W2^T products thus run once per dx column tile and once
// more in the dW pass (9 products for the function's 5 at Din = 768, two
// dx tiles); the (R, Dff) h and da never reach device memory, only
// `chunks` fp32 partials of dW1, dW2 and db1. In bf16 the products are
// `mma.sync` m16n8k16 with fragments from `ldmatrix` (`.trans` where an
// operand is read along its other axis); in fp32 the same tiling runs the
// fragments' products on the FP32 pipes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_bwd_common.cuh"

extern "C" int mm_fused_mlp_bwd(const void* x, const void* g, const void* w1, const void* b1,
                                const void* w2, void* dx, void* da, void* h, int R, int Din,
                                int Dff, int Dout, int act, int dtype, void* stream);

namespace {

using mm::act_and_grad;
using mm::cp_async_commit;
using mm::cp_async_wait;
using mm::from_f;
using mm::load_tile_async;
using mm::Mma;
using mm::to_f;

constexpr int BF = 16;       // Dff slice of a block
constexpr int BK = 64;       // K slice (Din or Dout) of a copy
constexpr int kMaxWidth = 768;
constexpr int NS = kMaxWidth / BK;  // K slices the register accumulators cover
constexpr int kThreads = 256;
// Shared-memory row pitches, in elements: +8 keeps rows 16-byte aligned and
// staggers them across banks for ldmatrix.
constexpr int XP = kMaxWidth + 8;  // resident x and g
constexpr int SLP = BK + 8;        // W1^T slices
constexpr int FP = BF + 8;         // W2^T slices, h_c and da_c
constexpr int ZP = BF + 1;         // fp32 z and g . W2^T

// Row tile: 64 rows in bf16, 32 in fp32, so that the tile's x and g fit
// shared memory at the widest Din and Dout (225,280 and 231,680 bytes).
template <typename T>
struct Smem {
  static constexpr int BM = sizeof(T) == 2 ? 64 : 32;
  T xs[BM * XP];       // x[rows, :Din], resident for the tile
  T gs[BM * XP];       // g[rows, :Dout]
  T w1s[2][BF * SLP];  // W1^T[f slice, k slice]  [f][k], two stages
  T w2s[2][BK * FP];   // W2^T[k slice, f slice]  [o][f]
  float zs[BM * ZP];   // z without b1
  float dhs[BM * ZP];  // g . W2^T
  T das[BM * FP];      // da_c
  T hs[BM * FP];       // h_c
  float red[kThreads];  // db1 partial sums of the threads
};

// Grid (Dff / BF, chunks). Warps 0-3 compute z and own dW1^T rows
// [f0, f0 + 16) x Din; warps 4-7 compute g . W2^T and own dW2^T columns
// Dout x [f0, f0 + 16). acc[s] holds a warp's 16 x 16 share of K slice s.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_acc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2, float* __restrict__ part, int R, int Din,
                         int Dff, int Dout) {
  using M = Mma<T>;
  constexpr int BM = Smem<T>::BM;
  // z and g . W2^T: BM / 16 m16 tiles x 2 n8 tiles over 4 warps: warp q
  // takes m tile q % MT and NJ n8 tiles from j0.
  constexpr int MT = BM / 16;
  constexpr int NJ = MT / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const bool w1_warp = warp < 4;  // z and dW1; else g . W2^T and dW2
  const int q = warp & 3;
  const int mq = q % MT;
  const int j0 = (q / MT) * NJ;
  const int f0 = blockIdx.x * BF;
  const int tiles = (R + BM - 1) / BM;
  const int t_begin = (int)((long long)tiles * blockIdx.y / gridDim.y);
  const int t_end = (int)((long long)tiles * (blockIdx.y + 1) / gridDim.y);
  const int nk1 = Din / BK, nk2 = Dout / BK;
  const int nk = nk1 > nk2 ? nk1 : nk2;
  // my share of the reduction: K slices that exist for my role
  const int nmine = w1_warp ? nk1 : nk2;

  float acc[NS][2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
  float db = 0.f;  // db1 of column threadIdx % BF over my rows

  // Copy K slice s of the row tile at m0: x and g into their resident
  // places, the W1^T and W2^T slices into stage st.
  auto load = [&](int s, int st, int m0) {
    if (s < nk1) {
      load_tile_async<T, BM, BK, kThreads>(sm.xs + s * BK, XP, x, Din, m0, s * BK, R, Din);
      load_tile_async<T, BF, BK, kThreads>(sm.w1s[st], SLP, w1, Din, f0, s * BK, Dff, Din);
    }
    if (s < nk2) {
      load_tile_async<T, BM, BK, kThreads>(sm.gs + s * BK, XP, g, Dout, m0, s * BK, R, Dout);
      load_tile_async<T, BK, BF, kThreads>(sm.w2s[st], FP, w2, Dff, s * BK, f0, Dout, Dff);
    }
    cp_async_commit();
  };

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int m0 = tile * BM;

    // z[rows, f slice] (warps 0-3) and g . W2^T[rows, f slice] (warps 4-7)
    float c[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
    load(0, 0, m0);
    for (int s = 0; s < nk; ++s) {
      const int st = s & 1;
      if (s + 1 < nk) {
        load(s + 1, st ^ 1, m0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (s < nmine) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          typename M::A a;
          typename M::B b[2];
          if (w1_warp) {
            M::load_a(a, sm.xs + mq * 16 * XP + s * BK + kk, XP);
            M::load_b(b[0], sm.w1s[st] + kk, SLP);
            M::load_b(b[1], sm.w1s[st] + 8 * SLP + kk, SLP);
          } else {
            M::load_a(a, sm.gs + mq * 16 * XP + s * BK + kk, XP);
            M::load_b2_t(b[0], b[1], sm.w2s[st] + kk * FP, FP);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) M::mma(c[j], a, j0 + j == 0 ? b[0] : b[1]);
        }
      }
      __syncthreads();  // W stage st is refilled by the next step's copy
    }
    float* cs = w1_warp ? sm.zs : sm.dhs;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[(mq * 16 + gq + (e >> 1) * 8) * ZP + (j0 + j) * 8 + 2 * t4 + (e & 1)] = c[j][e];
    __syncthreads();

    // fp32 bias, act and act'; h_c and da_c for the dW products, db1 from
    // the unrounded da. Rows past R contribute nothing.
    {
      const int col = threadIdx.x % BF;
      const float bias = to_f(b1[f0 + col]);
#pragma unroll
      for (int i = 0; i < BM * BF / kThreads; ++i) {
        const int row = threadIdx.x / BF + i * (kThreads / BF);
        float hv, dv;
        act_and_grad<ACT>(sm.zs[row * ZP + col] + bias, hv, dv);
        float dav = sm.dhs[row * ZP + col] * dv;
        if (m0 + row >= R) hv = dav = 0.f;
        db += dav;
        sm.das[row * FP + col] = from_f<T>(dav);
        sm.hs[row * FP + col] = from_f<T>(hv);
      }
    }
    __syncthreads();  // da_c and h_c complete

    // dW1^T[f slice, k slice] += da_c^T x[rows, k slice]   (warps 0-3)
    // dW2^T[k slice, f slice] += g[rows, k slice]^T h_c    (warps 4-7)
    // from the resident x and g. Each warp owns 16 columns (dW1^T) or 16
    // rows (dW2^T) of each slice; the loop is unrolled so that acc[s] stays
    // in registers.
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s < nmine) {
#pragma unroll
        for (int kk = 0; kk < BM; kk += 16) {
          typename M::A a;
          typename M::B b0, b1;
          if (w1_warp) {
            M::load_a_t(a, sm.das + kk * FP, FP);
            M::load_b2_t(b0, b1, sm.xs + kk * XP + s * BK + q * 16, XP);
          } else {
            M::load_a_t(a, sm.gs + kk * XP + s * BK + q * 16, XP);
            M::load_b2_t(b0, b1, sm.hs + kk * FP, FP);
          }
          M::mma(acc[s][0], a, b0);
          M::mma(acc[s][1], a, b1);
        }
      }
    }
    __syncthreads();  // x, g, da_c and h_c are rewritten by the next tile
  }

  // This chunk's partial: [dW1^T (Dff x Din) | dW2^T (Dout x Dff) | db1].
  float* out = part + (size_t)blockIdx.y * ((size_t)Dff * Din + (size_t)Dout * Dff + Dff);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s < nmine) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = gq + (e >> 1) * 8;
          const int n = j * 8 + 2 * t4 + (e & 1);
          if (w1_warp)
            out[(size_t)(f0 + m) * Din + s * BK + q * 16 + n] = acc[s][j][e];
          else
            out[(size_t)Dff * Din + (size_t)(s * BK + q * 16 + m) * Dff + f0 + n] = acc[s][j][e];
        }
    }
  }
  sm.red[threadIdx.x] = db;
  __syncthreads();
  if (threadIdx.x < BF) {
    float sum = 0.f;
    for (int i = 0; i < kThreads / BF; ++i) sum += sm.red[i * BF + threadIdx.x];
    out[(size_t)Dff * Din + (size_t)Dout * Dff + f0 + threadIdx.x] = sum;
  }
}

// out[i] = sum over c of part[c * n + i], in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long n, int chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[c * n + i];
    out[i] = s;
  }
}

template <typename T, int ACT>
cudaError_t launch_dw(const void* x, const void* g, const void* w1, const void* b1,
                      const void* w2, float* part, int R, int Din, int Dff, int Dout, int chunks,
                      cudaStream_t stream) {
  auto kernel = fused_mlp_bwd_acc_kernel<T, ACT>;
  const size_t smem = sizeof(Smem<T>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Dff / BF, chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), part, R, Din, Dff, Dout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dw(const void* x, const void* g, const void* w1, const void* b1,
                        const void* w2, float* part, int R, int Din, int Dff, int Dout,
                        int chunks, int act, cudaStream_t st) {
  switch (act) {
    case 0: return launch_dw<T, 0>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks, st);
    case 1: return launch_dw<T, 1>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks, st);
    case 2: return launch_dw<T, 2>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks, st);
    case 3: return launch_dw<T, 3>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks, st);
    case 4: return launch_dw<T, 4>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (R, Din), g (R, Dout), b1 (Dff) and dx (R, Din) row-major; w1 and w2
// are W1^T (Dff, Din) and W2^T (Dout, Dff) row-major; all contiguous,
// 16-byte aligned and of `dtype` (0 = fp32, 1 = bf16). `out` is fp32
// [dW1^T (Dff, Din) | dW2^T (Dout, Dff) | db1 (Dff)]; `part` is fp32 room
// for `chunks` such partials, and may be `out` itself when chunks == 1.
// `act` is an activation code. Needs Din and Dout to be multiples of 64 up
// to 768, Dff a multiple of 64 and 1 <= chunks. Launches on `stream`,
// allocates nothing and returns the first launch error.
int mm_fused_mlp_bwd_acc(const void* x, const void* g, const void* w1, const void* b1,
                         const void* w2, void* dx, float* part, float* out, int R, int Din,
                         int Dff, int Dout, int chunks, int act, int dtype, void* stream) {
  if (R <= 0 || Din <= 0 || Dff <= 0 || Dout <= 0 || Din % BK || Dout % BK || Dff % BK ||
      Din > kMaxWidth || Dout > kMaxWidth || chunks < 1 || (chunks > 1 && part == out) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = mm_fused_mlp_bwd(x, g, w1, b1, w2, dx, nullptr, nullptr, R, Din, Dff, Dout, act,
                             dtype, stream);
  if (err != 0) return err;
  err = dtype == 0
            ? (int)dispatch_dw<float>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks, act, st)
            : (int)dispatch_dw<__nv_bfloat16>(x, g, w1, b1, w2, part, R, Din, Dff, Dout, chunks,
                                              act, st);
  if (err != 0 || chunks == 1) return err;
  const long long n = (long long)Dff * Din + (long long)Dout * Dff + Dff;
  sum_chunks_kernel<<<264, 512, 0, st>>>(part, out, n, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
