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
// What bounds it on this card: operations. Its five products are
// 2 R Dff (3 Din + 2 Dout) FLOPs, 297 GFLOP for FLAVA's image MLP at batch
// 64 (12,608 rows, 768 -> 3072 -> 768), a bound of 0.30 ms at 989 TF/s;
// writing da_c and h_c and reading them back adds 155 MB there, 0.05 ms.
//
// Why the TPU design does not carry over: there the grid runs in order on
// one core and the fp32 dW1 and dW2 (18.9 MB at 768/3072) stay in VMEM
// across it. Here blocks run in parallel and in no order, dx sums over Dff
// for each row and dW over rows for each weight, so no block owns both
// reductions; recomputing z and g . W2^T for each owner (this kernel's
// first design) cost 9 products for 5.
//
// Design: the function's five products as three stages of GEMMs, each
// product run once, the (R, Dff) da_c and h_c written once in T and read
// back (a workspace the wrapper allocates):
//  1. z and dh into da_c, h_c and one db1 partial per 128-row tile, and
//  2. dx = da_c . W1^T (K = Dff), a block per 128 x 128 tile of dx: the
//     stages that kernel #4 shares (csrc/mlp_bwd_common.cuh);
//  3. dW1^T = da_c^T x and dW2^T = g^T h_c (K = R), one launch over the
//     tiles of both, split over rows into `splits` runs so that the launch
//     fills whole waves of the card's SMs; each run writes an fp32 partial.
//  4. A pass sums the runs' partials and the db1 partials, each in a fixed
//     order, into the outputs.
// No atomics: two launches on the same inputs give the same bits.
//
// In bf16 every product is the GEMM core of csrc/wgmma_gemm.cuh: TMA copies
// by a producer warp into an mbarrier ring of shared-memory stages, `wgmma`
// m64n128k16 with fp32 accumulators in two consumer warpgroups, persistent
// blocks that walk their tiles (stage 3 one accumulator at two blocks an
// SM), all four of stage 3's operands MN-major. fp32 has no `wgmma` without
// TF32, which would change the numbers, and no timed path runs it: it runs
// the same stages as 128 x 64 tiles on the FP32 pipes, each thread 8 x 4 of
// a tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_bwd_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mm::acc_row0;
using mm::acc_col0;
using mm::BK;
using mm::BM;
using mm::BN;
using mm::clear;
using mm::kSmem;
using mm::kStages;

struct DwParams {
  CUtensorMap dac, x, g, hc;  // da_c (R, Dff), x (R, Din), g (R, Dout), h_c (R, Dff)
  float* out;  // run s at out + s * (n1 + n2): [dW1^T (Dff, Din) | dW2^T (Dout, Dff)]
  long long n1, n2;
  int R, Din, Dff, Dout, rows_per_split, splits, tiles1, tiles1_n, tiles2_n, tiles;
};

// Stages 1 and 2 (csrc/mlp_bwd_common.cuh), with db1 partials.
template <int ACT>
__global__ void __launch_bounds__(wg::kThreads, 1)
fused_mlp_bwd_acc_zdh_kernel(const __grid_constant__ mm::ZdhParams p) {
  extern __shared__ uint8_t smem_raw[];
  mm::zdh_stage<ACT, true>(p, smem_raw);
}

__global__ void __launch_bounds__(wg::kThreads, 2)
fused_mlp_bwd_acc_dx_kernel(const __grid_constant__ mm::DxParams p) {
  extern __shared__ uint8_t smem_raw[];
  mm::dx_stage(p, smem_raw);
}

// Stage 3: items (tile, run) over the 128 x 128 tiles of dW1^T (Dff, Din) =
// da_c^T x (tile < tiles1) and of dW2^T (Dout, Dff) = g^T h_c, tiles
// fastest, each over the rows of its run; all four operands MN-major.
__global__ void __launch_bounds__(wg::kThreads, 2)
fused_mlp_bwd_acc_dw_kernel(const __grid_constant__ DwParams p) {
  extern __shared__ uint8_t smem_raw[];
  const wg::Ring<kStages> ring(smem_raw);
  auto item = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  // the item's tile origin (m0, n0), its problem and its run's first row
  struct Work {
    int m0, n0, r_begin, nk;
    bool first;
  };
  auto work = [&](int i) {
    Work w;
    const int t = item(i) % p.tiles;
    const int split = item(i) / p.tiles;
    w.first = t < p.tiles1;
    const int tt = w.first ? t : t - p.tiles1;
    const int tn = w.first ? p.tiles1_n : p.tiles2_n;
    w.m0 = tt / tn * BM;
    w.n0 = tt % tn * BN;
    w.r_begin = split * p.rows_per_split;
    const int r_end = min(p.R, w.r_begin + p.rows_per_split);
    w.nk = r_end > w.r_begin ? (r_end - w.r_begin + BK - 1) / BK : 0;
    return w;
  };
  float acc[64];
  clear(acc);
  wg::run(
      ring, wg::items_of_block(p.tiles * p.splits), [&](int i) { return work(i).nk; },
      [&](int i, int kb, uint8_t* a, uint8_t* b, uint64_t* bar) {
        const Work w = work(i);
        wg::load_operand<wg::MN>(a, w.first ? &p.dac : &p.g, bar, w.m0, w.r_begin + kb * BK);
        wg::load_operand<wg::MN>(b, w.first ? &p.x : &p.hc, bar, w.n0, w.r_begin + kb * BK);
      },
      [&](int, uint32_t a, uint32_t b) {
        wg::fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::MN, wg::MN>(acc, a, b, kk);
        wg::fence_acc(acc);
      },
      [&](int i) {
        wg::fence_acc(acc);
        const Work w = work(i);
        const int M = w.first ? p.Dff : p.Dout;
        const int N = w.first ? p.Din : p.Dff;
        float* out = p.out + (item(i) / p.tiles) * (p.n1 + p.n2) + (w.first ? 0 : p.n1);
        const int r0 = w.m0 + acc_row0();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = w.n0 + 8 * j + acc_col0();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            if (r < M && c < N)
              *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
                  make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
          }
        }
        clear(acc);
      });
}

// ---------------------------------------------------------------------------
// fp32: the same stages on the FP32 pipes
// ---------------------------------------------------------------------------

using mm::F32Smem;
using mm::f32_tile;
using mm::FM;
using mm::FN;

template <int ACT>
__global__ void __launch_bounds__(256)
fused_mlp_bwd_acc_zdh_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                 const float* __restrict__ w1, const float* __restrict__ b1,
                                 const float* __restrict__ w2, float* __restrict__ dac,
                                 float* __restrict__ hc, float* __restrict__ dbp, int R, int Din,
                                 int Dff, int Dout) {
  mm::zdh_f32_stage<ACT>(x, g, w1, b1, w2, dac, hc, dbp, R, Din, Dff, Dout);
}

// (256, 1): with no minimum, ptxas held it to 80 registers and spilled.
__global__ void __launch_bounds__(256, 1)
fused_mlp_bwd_acc_dx_f32_kernel(const float* __restrict__ dac, const float* __restrict__ w1,
                                float* __restrict__ dx, int R, int Din, int Dff) {
  mm::dx_f32_stage(dac, w1, dx, R, Din, Dff);
}

__global__ void __launch_bounds__(256)
fused_mlp_bwd_acc_dw_f32_kernel(const float* __restrict__ dac, const float* __restrict__ x,
                                const float* __restrict__ g, const float* __restrict__ hc,
                                float* __restrict__ out, long long n1, long long n2, int R,
                                int Din, int Dff, int Dout, int rows_per_split, int tiles1,
                                int tiles1_n, int tiles2_n) {
  __shared__ F32Smem sm;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool first = (int)blockIdx.x < tiles1;
  const int t = first ? blockIdx.x : blockIdx.x - tiles1;
  const int tn = first ? tiles1_n : tiles2_n;
  const int m0 = (t / tn) * FM, n0 = (t % tn) * FN;
  const int M = first ? Dff : Dout, N = first ? Din : Dff;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float c[8][4] = {};
  if (first)  // A(f, r) = da_c[r, f], B(r, d) = x[r, d]
    f32_tile(c, dac, 1, Dff, Dff, x, Din, 1, Din, m0, n0, r_begin, r_end, sm);
  else  // A(o, r) = g[r, o], B(r, f) = h_c[r, f]
    f32_tile(c, g, 1, Dout, Dout, hc, Dff, 1, Dff, m0, n0, r_begin, r_end, sm);
  float* o = out + blockIdx.y * (n1 + n2) + (first ? 0 : n1);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (r < M && col < N) o[(size_t)r * N + col] = c[i][j];
    }
}

// ---------------------------------------------------------------------------
// Stage 4, both types: the fixed-order sums
// ---------------------------------------------------------------------------

// With splits > 1: out[i] = sum over runs s of part[s * nw + i] for i < nw,
// in run order. Always: out[nw + f] = sum over row tiles t of dbp[t * Dff +
// f], in tile order.
__global__ void fused_mlp_bwd_acc_sum_kernel(const float* __restrict__ part,
                                             const float* __restrict__ dbp,
                                             float* __restrict__ out, long long nw, int splits,
                                             int Dff, int row_tiles) {
  const long long nsum = splits > 1 ? nw : 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nsum + Dff;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < nsum) {
      for (int c = 0; c < splits; ++c) s += part[c * nw + i];
      out[i] = s;
    } else {
      const int f = (int)(i - nsum);
      for (int t = 0; t < row_tiles; ++t) s += dbp[(size_t)t * Dff + f];
      out[nw + f] = s;
    }
  }
}

template <int ACT>
cudaError_t launch_bf16(const void* x, const void* g, const void* w1, const void* b1,
                        const void* w2, void* dx, void* dah, float* part, float* out, int R,
                        int Din, int Dff, int Dout, int splits, cudaStream_t st) {
  const int row_tiles = (R + BM - 1) / BM;
  const long long n1 = (long long)Dff * Din, n2 = (long long)Dout * Dff;
  bf16* dac = static_cast<bf16*>(dah);
  bf16* hc = dac + (size_t)R * Dff;
  float* dbp = part + (splits > 1 ? splits * (n1 + n2) : 0);
  cudaError_t err;

  if ((err = mm::launch_stages<ACT, true>(fused_mlp_bwd_acc_zdh_kernel<ACT>,
                                          fused_mlp_bwd_acc_dx_kernel, x, g, w1, b1, w2, dx,
                                          dac, hc, dbp, nullptr, R, Din, Dff, Dout, 1, st)) !=
      cudaSuccess)
    return err;

  DwParams wp;
#define MM_MAP(map, ptr, rows, cols) \
  if ((err = wg::make_map(&(map), ptr, rows, cols)) != cudaSuccess) return err
  MM_MAP(wp.dac, dac, R, Dff);
  MM_MAP(wp.x, x, R, Din);
  MM_MAP(wp.g, g, R, Dout);
  MM_MAP(wp.hc, hc, R, Dff);
#undef MM_MAP
  wp.out = splits > 1 ? part : out;
  wp.n1 = n1;
  wp.n2 = n2;
  wp.R = R;
  wp.Din = Din;
  wp.Dff = Dff;
  wp.Dout = Dout;
  wp.rows_per_split = ((R + BK - 1) / BK + splits - 1) / splits * BK;
  wp.splits = splits;
  wp.tiles1_n = (Din + BN - 1) / BN;
  wp.tiles2_n = (Dff + BN - 1) / BN;
  wp.tiles1 = (Dff + BM - 1) / BM * wp.tiles1_n;
  wp.tiles = wp.tiles1 + (Dout + BM - 1) / BM * wp.tiles2_n;
  if ((err = wg::allow_smem(fused_mlp_bwd_acc_dw_kernel, kSmem)) != cudaSuccess) return err;
  fused_mlp_bwd_acc_dw_kernel<<<wg::persistent_grid(wp.tiles * splits, 2), wg::kThreads, kSmem,
                                st>>>(wp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  fused_mlp_bwd_acc_sum_kernel<<<264, 512, 0, st>>>(part, dbp, out, n1 + n2, splits, Dff,
                                                    row_tiles);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_f32(const float* x, const float* g, const float* w1, const float* b1,
                       const float* w2, float* dx, float* dah, float* part, float* out, int R,
                       int Din, int Dff, int Dout, int splits, cudaStream_t st) {
  const int row_tiles = (R + FM - 1) / FM;
  const long long n1 = (long long)Dff * Din, n2 = (long long)Dout * Dff;
  float* dac = dah;
  float* hc = dah + (size_t)R * Dff;
  float* dbp = part + (splits > 1 ? splits * (n1 + n2) : 0);
  fused_mlp_bwd_acc_zdh_f32_kernel<ACT><<<dim3((Dff + FN - 1) / FN, row_tiles), 256, 0, st>>>(
      x, g, w1, b1, w2, dac, hc, dbp, R, Din, Dff, Dout);
  fused_mlp_bwd_acc_dx_f32_kernel<<<dim3((Din + FN - 1) / FN, row_tiles), 256, 0, st>>>(
      dac, w1, dx, R, Din, Dff);
  const int rows_per_split = (R + splits - 1) / splits;
  const int tiles1_n = (Din + FN - 1) / FN, tiles2_n = (Dff + FN - 1) / FN;
  const int tiles1 = (Dff + FM - 1) / FM * tiles1_n;
  const int tiles = tiles1 + (Dout + FM - 1) / FM * tiles2_n;
  fused_mlp_bwd_acc_dw_f32_kernel<<<dim3(tiles, splits), 256, 0, st>>>(
      dac, x, g, hc, splits > 1 ? part : out, n1, n2, R, Din, Dff, Dout, rows_per_split, tiles1,
      tiles1_n, tiles2_n);
  fused_mlp_bwd_acc_sum_kernel<<<264, 512, 0, st>>>(part, dbp, out, n1 + n2, splits, Dff,
                                                    row_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (R, Din), g (R, Dout), b1 (Dff) and dx (R, Din) row-major; w1 and w2
// are W1^T (Dff, Din) and W2^T (Dout, Dff) row-major; all contiguous,
// 16-byte aligned and of `dtype` (0 = fp32, 1 = bf16). `dah` is room for
// da_c and h_c, 2 x (R, Dff) of `dtype`. `out` is fp32 [dW1^T (Dff, Din) |
// dW2^T (Dout, Dff) | db1 (Dff)]; `part` is fp32 room for `splits` partials
// of the first two when splits > 1, then for the ceil(R / 128) db1
// partials. `act` is an activation code. Needs Din, Dff and Dout to be
// multiples of 64 and splits >= 1. Launches on `stream`, allocates nothing
// and returns the first launch error.
int mm_fused_mlp_bwd_acc(const void* x, const void* g, const void* w1, const void* b1,
                         const void* w2, void* dx, void* dah, float* part, float* out, int R,
                         int Din, int Dff, int Dout, int splits, int act, int dtype,
                         void* stream) {
  if (R <= 0 || Din <= 0 || Dff <= 0 || Dout <= 0 || Din % BK || Dout % BK || Dff % BK ||
      splits < 1 || act < 0 || act > 4 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MM_ACT(A)                                                                           \
  case A:                                                                                   \
    return dtype == 1 ? (int)launch_bf16<A>(x, g, w1, b1, w2, dx, dah, part, out, R, Din,   \
                                            Dff, Dout, splits, st)                          \
                      : (int)launch_f32<A>(                                                 \
                            static_cast<const float*>(x), static_cast<const float*>(g),     \
                            static_cast<const float*>(w1), static_cast<const float*>(b1),   \
                            static_cast<const float*>(w2), static_cast<float*>(dx),         \
                            static_cast<float*>(dah), part, out, R, Din, Dff, Dout, splits, \
                            st);
  switch (act) {
    MM_ACT(0)
    MM_ACT(1)
    MM_ACT(2)
    MM_ACT(3)
    MM_ACT(4)
  }
#undef MM_ACT
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
