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
// The weight and bias gradients are large plain products and sums left to
// the caller, as in the JAX package.
//
// What bounds it on this card: operations. Three products of
// 2 * R * Dff * {Din, Dout, Din} FLOPs: 181 GFLOP for the CLIP vision MLP at
// batch 256 (12,800 rows, 768 -> 3072 -> 768, 0.18 ms at 989 TF/s), 5.6
// GFLOP at FLAVA's gradient check's 394 image rows (0.0056 ms).
//
// Design: the function is kernel #5's first two stages
// (csrc/mlp_bwd_common.cuh), whose tensors are exactly these outputs:
//  1. z and dh as two GEMMs into one 128 x 128 tile of (R, Dff) a block,
//     the epilogue writing da and h (the z/dh stage without #5's db1
//     partials): fused_mlp_bwd_zdh_kernel;
//  2. dx = da . W1^T (K = Dff) in 128 x 128 tiles: fused_mlp_bwd_dx_kernel.
//     At a few hundred rows its tiles fill few of the 132 SMs (394 x 768 is
//     24 tiles), so the wrapper splits K into runs (ops/fused_encoder.py,
//     `_mlp_bwd_splits`); each run writes an fp32 partial into a workspace
//     and fused_mlp_bwd_dx_sum_kernel adds them in run order into dx. No
//     atomics: two launches give the same bits.
// In bf16 both are `wgmma` GEMMs fed by TMA (csrc/wgmma_gemm.cuh); fp32 runs
// the same stages on the FP32 pipes, without a split.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_bwd_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

template <int ACT>
__global__ void __launch_bounds__(wg::kThreads, 1)
fused_mlp_bwd_zdh_kernel(const __grid_constant__ mm::ZdhParams p) {
  extern __shared__ uint8_t smem_raw[];
  mm::zdh_stage<ACT, false>(p, smem_raw);
}

__global__ void __launch_bounds__(wg::kThreads, 2)
fused_mlp_bwd_dx_kernel(const __grid_constant__ mm::DxParams p) {
  extern __shared__ uint8_t smem_raw[];
  mm::dx_stage(p, smem_raw);
}

// dx = T(sum over runs r of part[r n4 + i]), four columns a thread, the runs
// added in order.
__global__ void fused_mlp_bwd_dx_sum_kernel(const float4* __restrict__ part,
                                            __nv_bfloat16* __restrict__ dx, long long n4,
                                            int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float4 v = part[r * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(dx)[i] = w;
  }
}

template <int ACT>
__global__ void __launch_bounds__(256)
fused_mlp_bwd_zdh_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                             const float* __restrict__ w1, const float* __restrict__ b1,
                             const float* __restrict__ w2, float* __restrict__ da,
                             float* __restrict__ h, int R, int Din, int Dff, int Dout) {
  mm::zdh_f32_stage<ACT>(x, g, w1, b1, w2, da, h, nullptr, R, Din, Dff, Dout);
}

// (256, 1): with no minimum, ptxas held #5's instance to 80 registers and
// spilled.
__global__ void __launch_bounds__(256, 1)
fused_mlp_bwd_dx_f32_kernel(const float* __restrict__ da, const float* __restrict__ w1,
                            float* __restrict__ dx, int R, int Din, int Dff) {
  mm::dx_f32_stage(da, w1, dx, R, Din, Dff);
}

template <int ACT>
cudaError_t launch(const void* x, const void* g, const void* w1, const void* b1, const void* w2,
                   void* dx, void* da, void* h, float* part, int R, int Din, int Dff, int Dout,
                   int splits, int dtype, cudaStream_t st) {
  if (dtype == 0) {
    fused_mlp_bwd_zdh_f32_kernel<ACT><<<dim3((Dff + mm::FN - 1) / mm::FN,
                                             (R + mm::FM - 1) / mm::FM),
                                        256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<float*>(da), static_cast<float*>(h), R, Din,
        Dff, Dout);
    fused_mlp_bwd_dx_f32_kernel<<<dim3((Din + mm::FN - 1) / mm::FN, (R + mm::FM - 1) / mm::FM),
                                  256, 0, st>>>(static_cast<const float*>(da),
                                                static_cast<const float*>(w1),
                                                static_cast<float*>(dx), R, Din, Dff);
    return cudaGetLastError();
  }
  cudaError_t err = mm::launch_stages<ACT, false>(fused_mlp_bwd_zdh_kernel<ACT>,
                                                  fused_mlp_bwd_dx_kernel, x, g, w1, b1, w2, dx,
                                                  da, h, nullptr, part, R, Din, Dff, Dout,
                                                  splits, st);
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = (long long)R * Din / 4;
  const long long blocks = (n4 + 255) / 256;
  fused_mlp_bwd_dx_sum_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), static_cast<__nv_bfloat16*>(dx), n4, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (R, Din), g (R, Dout), b1 (Dff), dx (R, Din), da and h (R, Dff)
// row-major; w1 and w2 are W1^T (Dff, Din) and W2^T (Dout, Dff) row-major.
// All contiguous, 16-byte aligned and of `dtype` (0 = fp32, 1 = bf16);
// `act` is an activation code. `splits` runs of K = Dff in dx's product, 1
// in fp32 and at most Dff / 64 with every run non-empty; with more than
// one, `part` is fp32 room for splits x (R, Din) partials (else unused).
// Needs Din, Dff and Dout to be multiples of 64. Launches on `stream`,
// allocates nothing and returns the first launch error.
int mm_fused_mlp_bwd(const void* x, const void* g, const void* w1, const void* b1,
                     const void* w2, void* dx, void* da, void* h, float* part, int R, int Din,
                     int Dff, int Dout, int splits, int act, int dtype, void* stream) {
  const int nk = Dff / 64;
  if (R <= 0 || Din <= 0 || Dff <= 0 || Dout <= 0 || Din % 64 || Dff % 64 || Dout % 64 ||
      act < 0 || act > 4 || (dtype != 0 && dtype != 1) || splits < 1 ||
      (dtype == 0 && splits != 1) || (splits - 1) * ((nk + splits - 1) / splits) >= nk ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MM_ACT(A) \
  case A:         \
    return (int)launch<A>(x, g, w1, b1, w2, dx, da, h, part, R, Din, Dff, Dout, splits, dtype, st);
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
