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
//  1. z and dh: a block owns a 128-row x 128-column tile of (R, Dff) and
//     runs x . W1 (K = Din) and then g . W2^T (K = Dout) into two
//     accumulators. Its epilogue adds b1, applies the activation table,
//     forms da, writes da_c and h_c, and writes the tile's fp32 column sums
//     of the unrounded da: one db1 partial per 128-row tile.
//  2. dx = da_c . W1^T (K = Dff), a block per 128 x 128 tile of dx.
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
// blocks that walk their tiles (stage 1 holds two accumulators, 128
// registers a thread, at one block an SM; stages 2 and 3 one, at two
// blocks an SM). Stage 1's second product reads W2^T, and stage 3 all four
// of its operands, MN-major. fp32 has no `wgmma` without TF32, which would
// change the numbers, and no timed path runs it: it runs the same stages as
// 128 x 64 tiles on the FP32 pipes, each thread 8 x 4 of a tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_bwd_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mm::act_and_grad;
using mm::to_f;
using wg::BK;
using wg::BM;
using wg::BN;

constexpr int kZdhStages = 6;  // one block an SM
constexpr int kStages = 3;     // two blocks an SM
constexpr size_t kZdhSmem = wg::smem_bytes<kZdhStages>(8 * BN * sizeof(float));
constexpr size_t kSmem = wg::smem_bytes<kStages>(0);

struct ZdhParams {
  CUtensorMap x, w1, g, w2;  // x (R, Din), W1^T (Dff, Din), g (R, Dout), W2^T (Dout, Dff)
  const bf16* b1;
  bf16* dac;   // (R, Dff)
  bf16* hc;    // (R, Dff)
  float* dbp;  // (R / 128 tiles, Dff): the tiles' column sums of da
  int R, Din, Dff, Dout;
};

struct DxParams {
  CUtensorMap dac, w1;  // da_c (R, Dff), W1^T (Dff, Din)
  bf16* dx;
  int R, Din, Dff;
};

struct DwParams {
  CUtensorMap dac, x, g, hc;  // da_c (R, Dff), x (R, Din), g (R, Dout), h_c (R, Dff)
  float* out;  // run s at out + s * (n1 + n2): [dW1^T (Dff, Din) | dW2^T (Dout, Dff)]
  long long n1, n2;
  int R, Din, Dff, Dout, rows_per_split, splits, tiles1, tiles1_n, tiles2_n, tiles;
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

// Stage 1: z and dh of 128 x 128 tiles of (R, Dff), column tiles fastest,
// then h_c, da_c and each tile's db1 partial.
template <int ACT>
__global__ void __launch_bounds__(wg::kThreads, 1)
fused_mlp_bwd_acc_zdh_kernel(const __grid_constant__ ZdhParams p) {
  extern __shared__ uint8_t smem_raw[];
  const wg::Ring<kZdhStages> ring(smem_raw);
  float* red = reinterpret_cast<float*>(ring.extra);  // [8 warps][BN]
  const int nk1 = p.Din / BK;
  const int ftiles = (p.Dff + BN - 1) / BN;
  const int row_tiles = (p.R + BM - 1) / BM;
  auto tile = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  float z[64], dh[64];
  clear(z);
  clear(dh);
  wg::run(
      ring, wg::items_of_block(row_tiles * ftiles), [&](int) { return nk1 + p.Dout / BK; },
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
      [&](int kb, uint32_t a, uint32_t b) {
        if (kb < nk1) {
          wg::fence_acc(z);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::K>(z, a, b, kk);
          wg::fence_acc(z);
        } else {
          wg::fence_acc(dh);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::MN>(dh, a, b, kk);
          wg::fence_acc(dh);
        }
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
        wg::consumer_sync();  // the previous tile's reads of red are done
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + acc_col0();
          float s0 = 0.f, s1 = 0.f;
          if (c < p.Dff) {
            const float bias0 = to_f(p.b1[c]), bias1 = to_f(p.b1[c + 1]);
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
        wg::consumer_sync();
        if (threadIdx.x < BN && n0 + (int)threadIdx.x < p.Dff) {
          float s = 0.f;
          for (int w = 0; w < 8; ++w) s += red[w * BN + threadIdx.x];
          p.dbp[(size_t)mt * p.Dff + n0 + threadIdx.x] = s;
        }
        clear(z);
        clear(dh);
      });
}

// Stage 2: 128 x 128 tiles of dx = da_c . W1^T, column tiles fastest.
__global__ void __launch_bounds__(wg::kThreads, 2)
fused_mlp_bwd_acc_dx_kernel(const __grid_constant__ DxParams p) {
  extern __shared__ uint8_t smem_raw[];
  const wg::Ring<kStages> ring(smem_raw);
  const int ntiles = (p.Din + BN - 1) / BN;
  const int row_tiles = (p.R + BM - 1) / BM;
  auto tile = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  float acc[64];
  clear(acc);
  wg::run(
      ring, wg::items_of_block(row_tiles * ntiles), [&](int) { return p.Dff / BK; },
      [&](int i, int kb, uint8_t* a, uint8_t* b, uint64_t* bar) {
        wg::load_operand<wg::K>(a, &p.dac, bar, tile(i) / ntiles * BM, kb * BK);
        wg::load_operand<wg::MN>(b, &p.w1, bar, tile(i) % ntiles * BN, kb * BK);
      },
      [&](int, uint32_t a, uint32_t b) {
        wg::fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::MN>(acc, a, b, kk);
        wg::fence_acc(acc);
      },
      [&](int i) {
        wg::fence_acc(acc);
        const int r0 = tile(i) / ntiles * BM + acc_row0();
        const int n0 = tile(i) % ntiles * BN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + acc_col0();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            if (r < p.R && c < p.Din)
              *reinterpret_cast<__nv_bfloat162*>(p.dx + (size_t)r * p.Din + c) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
          }
        }
        clear(acc);
      });
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

template <int ACT>
__global__ void __launch_bounds__(256)
fused_mlp_bwd_acc_zdh_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                 const float* __restrict__ w1, const float* __restrict__ b1,
                                 const float* __restrict__ w2, float* __restrict__ dac,
                                 float* __restrict__ hc, float* __restrict__ dbp, int R, int Din,
                                 int Dff, int Dout) {
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
  __syncthreads();
  if (threadIdx.x < FN && n0 + (int)threadIdx.x < Dff) {
    float s = 0.f;
    for (int i = 0; i < 16; ++i) s += red[i][threadIdx.x];
    dbp[(size_t)blockIdx.y * Dff + n0 + threadIdx.x] = s;
  }
}

// (256, 1): with no minimum, ptxas held it to 80 registers and spilled.
__global__ void __launch_bounds__(256, 1)
fused_mlp_bwd_acc_dx_f32_kernel(const float* __restrict__ dac, const float* __restrict__ w1,
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

  ZdhParams zp;
#define MM_MAP(map, ptr, rows, cols) \
  if ((err = wg::make_map(&(map), ptr, rows, cols)) != cudaSuccess) return err
  MM_MAP(zp.x, x, R, Din);
  MM_MAP(zp.w1, w1, Dff, Din);
  MM_MAP(zp.g, g, R, Dout);
  MM_MAP(zp.w2, w2, Dout, Dff);
  zp.b1 = static_cast<const bf16*>(b1);
  zp.dac = dac;
  zp.hc = hc;
  zp.dbp = dbp;
  zp.R = R;
  zp.Din = Din;
  zp.Dff = Dff;
  zp.Dout = Dout;
  if ((err = wg::allow_smem(fused_mlp_bwd_acc_zdh_kernel<ACT>, kZdhSmem)) != cudaSuccess)
    return err;
  fused_mlp_bwd_acc_zdh_kernel<ACT><<<wg::persistent_grid((Dff + BN - 1) / BN * row_tiles, 1),
                                      wg::kThreads, kZdhSmem, st>>>(zp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  DxParams xp;
  MM_MAP(xp.dac, dac, R, Dff);
  xp.w1 = zp.w1;
  xp.dx = static_cast<bf16*>(dx);
  xp.R = R;
  xp.Din = Din;
  xp.Dff = Dff;
  if ((err = wg::allow_smem(fused_mlp_bwd_acc_dx_kernel, kSmem)) != cudaSuccess) return err;
  fused_mlp_bwd_acc_dx_kernel<<<wg::persistent_grid((Din + BN - 1) / BN * row_tiles, 2),
                                wg::kThreads, kSmem, st>>>(xp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  DwParams wp;
  wp.dac = xp.dac;
  wp.x = zp.x;
  wp.g = zp.g;
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
