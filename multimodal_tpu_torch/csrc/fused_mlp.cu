// Fused two-layer MLP, act(x . W1 + b1) . W2 + b2, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_mlp_impl` (kernel body
// `_mlp_kernel`, activation table `_KERNEL_ACTIVATIONS`).
//
// What it computes, on x (R, Din), W1 (Din, Dff), W2 (Dff, Dout) and the
// biases, all of the compute type T (fp32 or bf16). The weights are taken
// column-major, that is as the transposes of row-major (Dff, Din) and
// (Dout, Dff) matrices: the layout in which torch.nn.Linear holds them, and
// K-major for both products, so neither needs a copy:
//   z   = x . W1 (fp32 sum) + b1 (fp32)
//   h   = T(act(z))            activation in fp32, then rounded to T
//   out = T(h . W2 (fp32 sum) + b2 (fp32))
//
// What bounds it on this card: operations at many rows, bytes at few. The
// two products are 2 R Dff (Din + Dout) FLOPs: 119 GFLOP for FLAVA's image
// MLP at batch 64 (12,608 rows, 768 -> 3072 -> 768), 0.12 ms at 989 TF/s. A
// decode tick's 33 rows are 0.3 GFLOP against 9.4 MB of weights, 2.8 us at
// 3.35 TB/s.
//
// Why the TPU design does not carry over: there both weight matrices stay
// in VMEM while a grid of row blocks runs in order on one core, and h never
// leaves the core. Here 227 KB of shared memory holds neither weight (768 x
// 3072 in bf16 is 4.7 MB), and at Dout 768 the fp32 output accumulator of a
// 128-row block (384 KB) does not fit the register file, so a block that
// keeps h on chip owns few rows and re-reads both weights for them. This
// kernel's first design did so (64-row blocks walking Dff in 64-column
// chunks, `mma.sync`): 3-9x the library's time, and a decode tick's 33
// rows ran on one SM.
//
// Design, bf16: the two products as two persistent GEMMs on the core of
// csrc/wgmma_gemm.cuh (TMA into an mbarrier ring, `wgmma` m64n128k16, a
// producer warp), each item a 128 x 128 output tile with one accumulator,
// at two blocks an SM so that one block's epilogue runs under the other's
// products. Stage H writes h = T(act(x . W1 + b1)) once to a (R, Dff)
// workspace; stage O writes out = T(h . W2 + b2). Writing and reading back
// h costs 4 R Dff bytes (155 MB at FLAVA's image rows, 0.05 ms): less than
// re-reading the weights for every 64 rows. At a decode tick's 33 rows the
// stages have 24 and 6 tiles, so few SMs work; each reads its tiles'
// weight columns once, and the call takes about 0.04 ms of device time,
// under the 0.1 ms of the library's three calls (PERF.md).
// fp32 (on no timed path; `wgmma` has no fp32 without TF32, which would
// change the numbers): one kernel on the FP32 pipes, a block per 64 rows x
// 256 output columns, walking Dff in 64-column chunks with h in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using mm::cp_async_commit;
using mm::cp_async_wait;
using mm::from_f;
using mm::to_f;

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

// Start copying rows [r0, r0 + rows) x columns [c0, c0 + cols) of a
// row-major matrix with leading dimension ld into shared memory (pitch
// `pitch`), 16 bytes a thread and step over the block's NT threads, with
// cp.async; rows >= rmax and columns >= cmax are zero-filled without being
// read.
template <typename T, int NT>
__device__ __forceinline__ void load_tile_async(T* s, int pitch, const T* g, int ld, int r0,
                                                int c0, int rows, int cols, int rmax,
                                                int cmax) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = cols / VEC;
  for (int idx = threadIdx.x; idx < rows * cv; idx += NT) {
    const int r = idx / cv;
    const int c = (idx - r * cv) * VEC;
    const bool in = r0 + r < rmax && c0 + c < cmax;
    mm::cp_async16(s + r * pitch + c, in ? g + (size_t)(r0 + r) * ld + c0 + c : g, in ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// bf16, many rows: stages H and O on the GEMM core
// ---------------------------------------------------------------------------

using wg::BK;
using wg::BM;
using wg::BN;

constexpr int kStages = 3;  // of the ring, at two blocks an SM in each stage
constexpr size_t kSmem = wg::smem_bytes<kStages>(0);

struct GemmParams {
  CUtensorMap a, b;  // A (R, K) and B^T (N, K) row-major: both K-major
  const bf16* bias;  // (N)
  bf16* out;         // (R, N)
  int R, K, N;
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

// The block's 128 x 128 tiles of out = T(f(A . B + bias)), column tiles
// fastest: f the activation ACT, or none for ACT < 0. The bias is added in
// fp32; rows past R and columns past N are not stored.
template <int STAGES, int ACT>
__device__ __forceinline__ void gemm_tiles(const GemmParams& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const wg::Ring<STAGES> ring(smem_raw);
  const int ntiles = (p.N + BN - 1) / BN;
  const int row_tiles = (p.R + BM - 1) / BM;
  auto tile = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  float acc[64];
  clear(acc);
  wg::run(
      ring, wg::items_of_block(row_tiles * ntiles), [&](int) { return p.K / BK; },
      [&](int i, int kb, uint8_t* a, uint8_t* b, uint64_t* bar) {
        wg::load_operand<wg::K>(a, &p.a, bar, tile(i) / ntiles * BM, kb * BK);
        wg::load_operand<wg::K>(b, &p.b, bar, tile(i) % ntiles * BN, kb * BK);
      },
      [&](int, uint32_t a, uint32_t b) {
        wg::fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::K, wg::K>(acc, a, b, kk);
        wg::fence_acc(acc);
      },
      [&](int i) {
        wg::fence_acc(acc);
        const int r0 = tile(i) / ntiles * BM + acc_row0();
        const int n0 = tile(i) % ntiles * BN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = n0 + 8 * j + acc_col0();
          if (c < p.N) {
            const float bias0 = to_f(p.bias[c]), bias1 = to_f(p.bias[c + 1]);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = r0 + 8 * hf;
              float v0 = acc[4 * j + 2 * hf] + bias0;
              float v1 = acc[4 * j + 2 * hf + 1] + bias1;
              if constexpr (ACT >= 0) {
                v0 = act<ACT>(v0);
                v1 = act<ACT>(v1);
              }
              if (r < p.R)
                *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)r * p.N + c) =
                    __floats2bfloat162_rn(v0, v1);
            }
          }
        }
        clear(acc);
      });
}

// Stage H: h = T(act(x . W1 + b1)), tiles of (R, Dff), K = Din.
template <int ACT>
__global__ void __launch_bounds__(wg::kThreads, 2)
fused_mlp_fwd_h_kernel(const __grid_constant__ GemmParams p) {
  gemm_tiles<kStages, ACT>(p);
}

// Stage O: out = T(h . W2 + b2), tiles of (R, Dout), K = Dff.
__global__ void __launch_bounds__(wg::kThreads, 2)
fused_mlp_fwd_o_kernel(const __grid_constant__ GemmParams p) {
  gemm_tiles<kStages, -1>(p);
}

template <int ACT>
cudaError_t launch_gemm(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, void* h, int R, int Din, int Dff, int Dout,
                        cudaStream_t st) {
  // once an instance, not once a launch: the decode tick is held by the host
  static const cudaError_t smem_h = wg::allow_smem(fused_mlp_fwd_h_kernel<ACT>, kSmem);
  static const cudaError_t smem_o = wg::allow_smem(fused_mlp_fwd_o_kernel, kSmem);
  if (smem_h != cudaSuccess) return smem_h;
  if (smem_o != cudaSuccess) return smem_o;
  const int row_tiles = (R + BM - 1) / BM;
  cudaError_t err;
  GemmParams hp;
  if ((err = wg::make_map(&hp.a, x, R, Din)) != cudaSuccess) return err;
  if ((err = wg::make_map(&hp.b, w1, Dff, Din)) != cudaSuccess) return err;
  hp.bias = static_cast<const bf16*>(b1);
  hp.out = static_cast<bf16*>(h);
  hp.R = R;
  hp.K = Din;
  hp.N = Dff;
  fused_mlp_fwd_h_kernel<ACT><<<wg::persistent_grid(row_tiles * ((Dff + BN - 1) / BN), 2),
                                wg::kThreads, kSmem, st>>>(hp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GemmParams op;
  if ((err = wg::make_map(&op.a, h, R, Dff)) != cudaSuccess) return err;
  if ((err = wg::make_map(&op.b, w2, Dout, Dff)) != cudaSuccess) return err;
  op.bias = static_cast<const bf16*>(b2);
  op.out = static_cast<bf16*>(out);
  op.R = R;
  op.K = Dff;
  op.N = Dout;
  fused_mlp_fwd_o_kernel<<<wg::persistent_grid(row_tiles * ((Dout + BN - 1) / BN), 2),
                           wg::kThreads, kSmem, st>>>(op);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the FP32 pipes
// ---------------------------------------------------------------------------

constexpr int FM = 64;   // rows per block
constexpr int BF = 64;   // Dff chunk
constexpr int FK = 64;   // Din slice of the first product
constexpr int kThreads = 512;
// Shared-memory row pitches, in elements: +8 keeps rows 16-byte aligned.
constexpr int XP = FK + 8;
constexpr int W1P = FK + 8;
constexpr int HP = BF + 8;
constexpr int W2P = BF + 8;

// NJ: 8-column tiles a warp owns in the second product; the block's output
// tile is 64 * NJ columns wide (8 warps across).
template <typename T, int NJ>
struct Smem {
  T xs[2][FM * XP];     // x slice, two stages      (FM x FK)
  T w1s[2][BF * W1P];   // W1^T slice, two stages   (BF x FK)
  T hs[FM * HP];        // h chunk                  (FM x BF)
  T w2s[64 * NJ * W2P]; // W2^T chunk               (64 NJ x BF)
};

// Warp-level 16x8x16 product on the FP32 pipes, on tiles in shared memory:
// A is 16 x 16 row-major [m][k] (pitch lda), B is 16 x 8 stored [n][k]
// (pitch ldb). The accumulator follows the mma.m16n8 layout: with
// g = lane / 4 and t = lane % 4, c[0], c[1] are (g, 2t), (g, 2t + 1) and
// c[2], c[3] the same columns of row g + 8.
template <typename T>
struct Mma;

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

// A block owns 64 rows and 64 NJ output columns: it walks Dff in chunks of
// 64, computes the chunk of h for its rows (x . W1 streamed in 64-wide
// slices; 16 x 16 a warp), applies bias and activation in fp32 into shared
// memory, and adds h_chunk . W2_chunk to its accumulator (32 x 8 NJ a warp).
template <typename T, int ACT, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                 const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                 int R, int Din, int Dff, int Dout) {
  using M = Mma<T>;
  constexpr int TN = 64 * NJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, NJ>& sm = *reinterpret_cast<Smem<T, NJ>*>(smem_raw);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * TN;  // output column tile
  const int m0 = blockIdx.y * FM;  // row tile

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
    load_tile_async<T, kThreads>(sm.w2s, W2P, w2, Dff, n0, f0, TN, BF, Dout, Dff);
    cp_async_commit();
    const int nk = Din / FK;
    load_tile_async<T, kThreads>(sm.xs[0], XP, x, Din, m0, 0, FM, FK, R, Din);
    load_tile_async<T, kThreads>(sm.w1s[0], W1P, w1, Din, f0, 0, BF, FK, Dff, Din);
    cp_async_commit();
    for (int ks = 0; ks < nk; ++ks) {
      const int st = ks & 1;
      if (ks + 1 < nk) {
        load_tile_async<T, kThreads>(sm.xs[st ^ 1], XP, x, Din, m0, (ks + 1) * FK, FM, FK, R,
                                     Din);
        load_tile_async<T, kThreads>(sm.w1s[st ^ 1], W1P, w1, Din, f0, (ks + 1) * FK, BF, FK,
                                     Dff, Din);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; kk += 16) {
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

// fp32 keeps 256 output columns a block (NJ = 4): its W2 chunk would not
// fit shared memory at 768.
template <int ACT>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int R, int Din, int Dff, int Dout,
                       cudaStream_t st) {
  constexpr int NJ = 4;
  auto kernel = fused_mlp_kernel<float, ACT, NJ>;
  constexpr size_t smem = sizeof(Smem<float, NJ>);
  static const cudaError_t smem_err = wg::allow_smem(kernel, smem);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((Dout + 64 * NJ - 1) / (64 * NJ), (R + FM - 1) / FM);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), R,
      Din, Dff, Dout);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                   void* out, void* h, int R, int Din, int Dff, int Dout, int dtype,
                   cudaStream_t st) {
  if (dtype == 0) return launch_f32<ACT>(x, w1, b1, w2, b2, out, R, Din, Dff, Dout, st);
  return launch_gemm<ACT>(x, w1, b1, w2, b2, out, h, R, Din, Dff, Dout, st);
}

}  // namespace

extern "C" {

// x (R, Din), b1 (Dff), b2 (Dout) and out (R, Dout) row-major; w1 and w2
// are W1^T (Dff, Din) and W2^T (Dout, Dff) row-major. All contiguous,
// 16-byte aligned and of `dtype` (0 = fp32, 1 = bf16); `act` is an
// activation code. Needs Din, Dff and Dout to be multiples of 64. bf16
// needs `h`, room for the intermediate, (R, Dff) bf16; fp32 takes none.
// Launches on `stream`, allocates nothing and returns the first launch
// error.
int mm_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, void* h, int R, int Din, int Dff, int Dout, int act, int dtype,
                 void* stream) {
  if (R <= 0 || Din <= 0 || Dff <= 0 || Dout <= 0 || Din % 64 || Dff % 64 || Dout % 64 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && h == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MM_ACT(A) \
  case A:         \
    return (int)launch<A>(x, w1, b1, w2, b2, out, h, R, Din, Dff, Dout, dtype, st);
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
