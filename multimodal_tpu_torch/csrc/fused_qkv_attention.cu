// Fused self-attention straight off the fused QKV projection, for Hopper.
//
// Replaces: multimodal_tpu/ops/fused_encoder.py, `_qkv_attention_impl`
// (kernel bodies `_qkv_attn_kernel` / `_qkv_attn_kernel_kb`, head loop
// `_attn_head_loop`).
//
// What it computes, per batch row b and head h (Dh = D / H):
//   s    = (q_h . k_h^T) * scale                      fp32
//   s   += key_bias[b, :]                             optional (B, S) fp32
//   s    = causal ? (col <= row ? s : -1e30) : s
//   p    = exp(s - max(s)) / sum(exp(s - max(s)))     exact, whole row
//   o_h  = T(p) . v_h                                 p rounded to the compute
//                                                     type, fp32 sum
// q, k and v are read in place from qkv (B, S, 3D), laid out [q | k | v] with
// heads contiguous (row stride 3D); o is written into out (B, S, D) at the
// head's column offset. No split or transposed copy is made, and neither the
// scores nor the probabilities reach device memory.
//
// What bounds it on this card: bytes. The kernel must read qkv once and
// write out once (160 MB at CLIP's batch 512; 67 MB, 0.020 ms at 3.35 TB/s,
// at CoCa-L's (32, 256, 3 x 1024)) while doing 4 S^2 Dh FLOPs a head, far
// below the card's 295 FLOP per byte balance point.
//
// Design, bf16 at head width 64 (CLIP, ViT-B, BERT-base, ViT-L's 16 heads
// of 64), on `wgmma` + TMA (qkv_attention_wgmma_kernel<NC>): one block of
// one warpgroup per (64-row query tile, head, batch row); the tiles of a
// head sit side by side in the grid and find its K and V in L2. Thread 0
// loads the tile's Q box and the head's K and V boxes (64 keys each, only
// the chunks the tile's rows see under the causal mask) by TMA straight
// from the fused layout, through a 4-d map of qkv as (B, 3H, S, 64), so a
// box past S reads zeros; Q with K's first chunk lands on one mbarrier,
// each further K chunk on its own, V on the last. Each chunk's score
// product S_c = Q K_c^T (`wgmma` m64n64k16, both operands K-major in shared
// memory, fp32 accumulators) is issued as its box lands, and the previous
// chunk is scaled, biased and masked (log2 units, `ex2`) and reduced to
// its row maxima under it. S <= 256 keeps the whole score row in the
// thread's registers, so the softmax is the TPU kernel's: exact over the
// row (maximum, then sum, in fp32), the key bias added before the maximum,
// causal keys at -1e30, p normalised (one reciprocal a row) and then
// rounded to bf16, as the A fragments in registers of O = P V (m64n64k16,
// V MN-major from shared memory). P never leaves the registers. Registers
// are held to 168 a thread (a 256-key row is 128 of them) and shared memory
// is 75 KB a block at S = 256, so three blocks share an SM. What holds it
// (PERF.md): at CoCa-L's (32, 256, 3 x 1024) it takes 0.036 ms
// against a 0.020 bound, and the loads alone 0.023: three blocks an SM are
// too few for one block's softmax and products to run wholly under the
// others' loads. Multicasting K and V to the head's blocks as one cluster
// measured slower, as did issuing P V a chunk at a time (PERF.md). Under the
// causal mask a tile computes only the key chunks its rows see; the keys
// past them are at -1e30 as every causal key is, and count only in a row
// whose every visible key the bias masks (its maximum -1e30): a tile with
// such a row computes every chunk, so that the row averages V over all S
// keys, as the TPU kernel's does. It replaced an earlier
// `mma.sync` kernel (a block per head that staged all of the head's Q, K
// and V by cp.async before computing), which it beat at every path's S.
//
// fp32, and bf16 at other head widths, run on the FP32 pipes: K (transposed,
// odd pitch, conflict-free both ways) and V staged in fp32; each warp
// carries four query rows at a time, so every shared-memory read of K or V
// feeds four rows' FMAs; a lane keeps its 32-key slices of the four score
// rows in registers (at most eight values per row per lane) and the
// probabilities go through a small per-warp buffer to be broadcast for
// p . v. This path is held by shared-memory and FMA throughput well above
// its byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using mm::ex2;
using mm::from_f;
using mm::to_f;

constexpr int kWarps = 8;  // warps per block
constexpr int kRows = 4;   // query rows a warp carries at once (float4 of p)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats, for a block at sequence length `s` and head
// width `dh`; the Python wrapper's shape predicate uses the same formula.
__host__ __device__ inline int smem_floats(int s, int dh) {
  const int sp = ((s + 31) / 32) * 32;
  return dh * (sp + 1) + s * dh + kWarps * kRows * dh + kWarps * sp * kRows;
}

// NT: 32-key chunks per score row (S <= 32 * NT).
// NC: 32-column chunks of the head a lane owns in the output (Dh <= 32 * NC).
template <typename T, int NT, int NC>
__global__ void __launch_bounds__(kWarps * 32)
qkv_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ key_bias,
                     T* __restrict__ out, int S, int D, int Dh, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int sp = ((S + 31) / 32) * 32;  // keys padded to whole warps
  const int kp = sp + 1;                // odd pitch of the transposed K
  float* kt = smem;                     // [Dh][kp]   K^T of this head
  float* vs = kt + Dh * kp;             // [S][Dh]    V of this head
  float* qs = vs + S * Dh;              // [kWarps][kRows][Dh]
  float* ps = qs + kWarps * kRows * Dh; // [kWarps][sp][kRows]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d3 = 3 * D;
  const T* base = qkv + (size_t)b * S * d3;
  const int koff = D + h * Dh;
  const int voff = 2 * D + h * Dh;

  // Stage K^T and V; padded keys (S <= j < sp) read as zero.
  for (int idx = threadIdx.x; idx < sp * Dh; idx += blockDim.x) {
    const int j = idx / Dh;
    const int c = idx - j * Dh;
    float kv = 0.f;
    if (j < S) {
      const T* row = base + (size_t)j * d3;
      kv = to_f(row[koff + c]);
      vs[j * Dh + c] = to_f(row[voff + c]);
    }
    kt[c * kp + j] = kv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * kRows * Dh;
  float* pw = ps + warp * sp * kRows;
  const float* kb = key_bias ? key_bias + (size_t)b * S : nullptr;
  const int groups = (S + kRows - 1) / kRows;

  for (int g = warp; g < groups; g += kWarps) {
    const int i0 = g * kRows;
    for (int idx = lane; idx < kRows * Dh; idx += 32) {
      const int r = idx / Dh;
      const int c = idx - r * Dh;
      const int i = i0 + r;
      qw[idx] = i < S ? to_f(base[(size_t)i * d3 + h * Dh + c]) : 0.f;
    }
    __syncwarp();

    // Keys any row of this group can see; with the causal mask the rest
    // are masked for every row of the group (-1e30) and need no product.
    // They enter p . v only for a row whose every visible key the bias
    // masks (its maximum -1e30: p is uniform over all S keys, as in the TPU
    // kernel); pv_end then takes them in.
    const int jend = causal ? min(S, i0 + kRows) : S;
    int pv_end = jend;

    float sc[kRows][NT];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t) sc[r][t] = 0.f;

    for (int c = 0; c < Dh; c += 4) {
      float4 q4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        q4[r] = *reinterpret_cast<const float4*>(qw + r * Dh + c);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (32 * t < jend) {
          const float* kcol = kt + c * kp + 32 * t + lane;
          const float k0 = kcol[0], k1 = kcol[kp], k2 = kcol[2 * kp], k3 = kcol[3 * kp];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = sc[r][t];
            a = fmaf(q4[r].x, k0, a);
            a = fmaf(q4[r].y, k1, a);
            a = fmaf(q4[r].z, k2, a);
            a = fmaf(q4[r].w, k3, a);
            sc[r][t] = a;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = 32 * t + lane;
        float s;
        if (j >= S) {
          s = -INFINITY;  // padding: not a key at all
        } else {
          s = sc[r][t] * scale;
          if (kb) s += kb[j];
          if (causal && j > i) s = -1e30f;
        }
        sc[r][t] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      if (m <= -1e30f) pv_end = S;
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float e = expf(sc[r][t] - m);
        sc[r][t] = e;
        l += e;
      }
      l = warp_sum(l);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = 32 * t + lane;
        if (j < sp) pw[j * kRows + r] = to_f(from_f<T>(sc[r][t] / l));
      }
    }
    __syncwarp();

    float o[kRows][NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) o[r][cc] = 0.f;

    for (int j = 0; j < pv_end; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pw + j * kRows);
      const float* vrow = vs + j * Dh + lane;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float v = (32 * cc + lane < Dh) ? vrow[32 * cc] : 0.f;
        o[0][cc] = fmaf(p4.x, v, o[0][cc]);
        o[1][cc] = fmaf(p4.y, v, o[1][cc]);
        o[2][cc] = fmaf(p4.z, v, o[2][cc]);
        o[3][cc] = fmaf(p4.w, v, o[3][cc]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= S) break;
      T* orow = out + ((size_t)b * S + i) * D + h * Dh;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = 32 * cc + lane;
        if (c < Dh) orow[c] = from_f<T>(o[r][cc]);
      }
    }
    __syncwarp();  // qw / pw are rewritten by the next group
  }
}

template <typename T, int NT, int NC>
cudaError_t launch(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                   int H, float scale, int causal, cudaStream_t stream) {
  const int dh = D / H;
  const size_t smem = sizeof(float) * (size_t)smem_floats(S, dh);
  auto kernel = qkv_attention_kernel<T, NT, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(key_bias), static_cast<T*>(out),
      S, D, dh, scale, causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t dispatch_nt(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                        int H, float scale, int causal, cudaStream_t stream) {
  if (S <= 64) return launch<T, 2, NC>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  if (S <= 128) return launch<T, 4, NC>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  return launch<T, 8, NC>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                     int H, float scale, int causal, cudaStream_t stream) {
  if (D / H <= 64) return dispatch_nt<T, 2>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  return dispatch_nt<T, 4>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
}


// ---------------------------------------------------------------------------
// Hopper path: bf16 at head width 64 on `wgmma` + TMA.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHd = 64;            // head width of this path
constexpr int kWgThreads = 128;    // one warpgroup: 64 query rows
constexpr int kBox = 64 * 64 * 2;  // one 64 x 64 bf16 box, 128-byte rows

// Shared memory of a block at NC 64-key chunks (S <= 64 NC), from a
// 1024-byte aligned base: Q's box, K's and V's NC boxes each, the key bias
// in log2 units (64 NC floats) and NC + 1 mbarriers. The Python wrapper's
// shape predicate mirrors it (ops/fused_encoder.py).
template <int NC>
constexpr size_t wg_smem() {
  return 1024 + (1 + 2 * NC) * (size_t)kBox + 64 * NC * sizeof(float) +
         (NC + 1) * sizeof(uint64_t);
}

struct WgParams {
  CUtensorMap qkv;  // (B, 3H, S, 64) view of qkv (B, S, 3D): 64 x 64 boxes
  const float* key_bias;
  __nv_bfloat16* out;
  int S, D, H;
  float scale_log2;  // scale * log2(e)
  int causal;
};

// A query tile's attention over its first C 64-key chunks (the keys any of
// its rows sees). The thread's rows are r0 and r0 + 8; s[c][4 j + e] holds
// row r0 + 8 (e / 2), key 64 c + 8 j + 2 t4 + e % 2 (the `wgmma`
// accumulator layout), and o[4 j + 2 hh + e] row r0 + 8 hh, column 8 j +
// 2 t4 + e. The score product of chunk c is issued as soon as its K box has
// landed (k_bars[c]), and chunk c - 1 is scaled, biased, masked and reduced
// to its row maxima under it; after the exponentials and the row sums, P is
// packed and P V issued.
// The scores of chunk c (of rows r0, r0 + 8) in log2 units: the key bias
// added, keys above the causal diagonal set to -1e30 (as the TPU kernel sets
// them), keys past S at -inf (they are no keys at all); and their row
// maxima into `part`, four partials a row (element 4 j + e: partial
// 2 (j % 2) + e % 2, row e / 2), so that no long chain of dependent
// instructions stalls the warp.
template <bool CAUSAL>
__device__ __forceinline__ void scale_and_max(float (&sc)[32], float (&part)[2][4],
                                              const float* kb2, float scale_log2, int c, int r0,
                                              int t4, int S) {
  const float masked = -1e30f * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = 64 * c + 8 * j + 2 * t4;
    const float2 bias = *reinterpret_cast<const float2*>(kb2 + key);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = fmaf(sc[4 * j + e], scale_log2, (e & 1) ? bias.y : bias.x);
      if (CAUSAL && key + (e & 1) > r0 + 8 * (e >> 1) && key + (e & 1) < S) v = masked;
      sc[4 * j + e] = v;
      float& pm = part[e >> 1][(j & 1) << 1 | (e & 1)];
      pm = fmaxf(pm, v);
    }
  }
}

template <int C, bool CAUSAL>
__device__ __forceinline__ void attend(const WgParams& p, const uint8_t* qs, const uint8_t* ks,
                                       const uint8_t* vs, const float* kb2,
                                       uint64_t* k_bars, uint64_t* v_bar, int q0, int h, int b) {
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
  const int S = p.S;
  const uint32_t qb = wg::smem_u32(qs);
  const uint32_t kb = wg::smem_u32(ks);
  float part[2][4];
#pragma unroll
  for (int x = 0; x < 8; ++x) part[(x >> 1) & 1][((x >> 2) & 1) << 1 | (x & 1)] = -INFINITY;

  // S = Q K^T, both K-major: one m64n64 product a chunk, four k-steps each,
  // a commit group a chunk
  float s[C][32];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wg::bar_wait(&k_bars[c], 0);
    __syncwarp();  // the warp leaves the poll together: `wgmma` is .aligned
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_m64n64k16<wg::K, wg::K>(s[c], wg::desc(qb + kk * 32, 16, 1024),
                                      wg::desc(kb + c * kBox + kk * 32, 16, 1024), kk);
    wg::wgmma_commit();
    if (c > 0) {
      wg::wgmma_wait<1>();  // chunk c - 1 is done; chunk c runs on
      wg::fence_acc(s[c - 1]);
      scale_and_max<CAUSAL>(s[c - 1], part, kb2, p.scale_log2, c - 1, r0, t4, S);
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(s[C - 1]);
  scale_and_max<CAUSAL>(s[C - 1], part, kb2, p.scale_log2, C - 1, r0, t4, S);

  float mx[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(fmaxf(part[hh][0], part[hh][1]), fmaxf(part[hh][2], part[hh][3]));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    if (mx[hh] == -INFINITY) mx[hh] = 0.f;  // (no row of a block sees no key)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[hh][i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1;
      s[c][x] = ex2(s[c][x] - mx[hh]);
      part[hh][((x >> 2) & 1) << 1 | (x & 1)] += s[c][x];
    }
  float il[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = (part[hh][0] + part[hh][1]) + (part[hh][2] + part[hh][3]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    il[hh] = 1.f / sum;
  }

  // O = P V, V MN-major (k-step kk is 16 key rows, 2048 bytes, on): p
  // normalised, then rounded to bf16 and packed as the A fragments (k-step
  // kl of chunk c holds keys 64 c + 16 kl ..).
  float o[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) o[x] = 0.f;
  uint32_t pa[C][4][4];
  wg::bar_wait(v_bar, 0);
  __syncwarp();
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kl = 0; kl < 4; ++kl)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[c][kl][r] = mm::pack_bf16(s[c][8 * kl + 2 * r] * il[r & 1],
                                     s[c][8 * kl + 2 * r + 1] * il[r & 1]);
  const uint32_t vb = wg::smem_u32(vs);
  wg::wgmma_fence();
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kl = 0; kl < 4; ++kl)
      wg::mma_m64n64k16_rs<wg::MN>(o, pa[c][kl],
                                   wg::desc(vb + (4 * c + kl) * 2048, kBox, 1024), 1);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_acc(o);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int kl = 0; kl < 4; ++kl) wg::fence_regs(pa[c][kl]);

  __nv_bfloat16* ob = p.out + (size_t)b * S * p.D + h * 64;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * p.D + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
  }
}

// attend<c> at the block's chunk count nc <= C, a compile-time count in
// each branch, so that every product is issued unconditionally.
template <int C, bool CAUSAL>
__device__ __forceinline__ void attend_chunks(int nc, const WgParams& p, const uint8_t* qs,
                                              const uint8_t* ks, const uint8_t* vs,
                                              const float* kb2, uint64_t* bars, uint64_t* v_bar,
                                              int q0, int h, int b) {
  if constexpr (C > 1) {
    if (nc < C) {
      attend_chunks<C - 1, CAUSAL>(nc, p, qs, ks, vs, kb2, bars, v_bar, q0, h, b);
      return;
    }
  }
  attend<C, CAUSAL>(p, qs, ks, vs, kb2, bars, v_bar, q0, h, b);
}

// One block of one warpgroup per (64-row query tile, head, batch row),
// query tiles of a head side by side in the grid, so that they find the
// head's K and V in L2. TMA brings the tile's Q box and the head's K and V
// boxes (64 keys each, the chunks the tile's rows can see) straight from
// the fused layout through the 4-d map, rows past S as zeros: Q with K's
// chunk 0 on one barrier, each further K chunk on one of its own, V on the
// last, so that the products start as the first bytes land and run under
// the rest. S <= 256 keeps a row's scores in the thread's registers (C x 32
// floats), so the softmax is exact over the whole row, as the TPU kernel's
// is, and P never leaves the registers.
template <int NC>
__global__ void __launch_bounds__(kWgThreads, 3)  // three blocks an SM, as shared memory allows
    qkv_attention_wgmma_kernel(const __grid_constant__ WgParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint8_t* ks = qs + kBox;
  uint8_t* vs = ks + NC * kBox;
  float* kb2 = reinterpret_cast<float*>(vs + NC * kBox);  // [64 NC], log2 units
  uint64_t* bars = reinterpret_cast<uint64_t*>(kb2 + 64 * NC);  // [NC] Q and K, [NC] V

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = 64 * t;
  const int S = p.S;
  if (threadIdx.x == 0) {
    for (int c = 0; c <= NC; ++c) wg::bar_init(&bars[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // With the causal mask the tile's rows see keys up to q0 + 63: the chunks
  // past t need no product and no copy, their keys being -1e30 for every
  // row of the tile. They count only in a row whose every visible key the
  // bias masks (its maximum -1e30: p is uniform over all S keys, as in the
  // TPU kernel), so the tile takes every chunk unless its first row, and so
  // every row, sees a key the bias leaves open (above -1e20).
  bool open = false;
  if (p.causal && p.key_bias)
    for (int j = threadIdx.x; j <= q0 && j < S; j += kWgThreads)
      open |= p.key_bias[(size_t)b * S + j] > -1e20f;
  open = __syncthreads_or(open);
  const int nc = p.causal && (open || !p.key_bias) ? min(NC, t + 1) : NC;
  if (threadIdx.x == 0) {
    for (int c = 0; c < nc; ++c) wg::bar_expect_tx(&bars[c], (c == 0 ? 2 : 1) * kBox);
    wg::bar_expect_tx(&bars[NC], nc * kBox);
    wg::tma_box_4d(qs, &p.qkv, &bars[0], 0, q0, h, b);
    for (int c = 0; c < nc; ++c)
      wg::tma_box_4d(ks + c * kBox, &p.qkv, &bars[c], 0, 64 * c, p.H + h, b);
    for (int c = 0; c < nc; ++c)
      wg::tma_box_4d(vs + c * kBox, &p.qkv, &bars[NC], 0, 64 * c, 2 * p.H + h, b);
  }
  for (int j = threadIdx.x; j < 64 * NC; j += kWgThreads)
    kb2[j] = j < S ? (p.key_bias ? p.key_bias[(size_t)b * S + j] * kLog2e : 0.f) : -INFINITY;
  __syncthreads();  // kb2
  if (p.causal)
    attend_chunks<NC, true>(nc, p, qs, ks, vs, kb2, bars, &bars[NC], q0, h, b);
  else
    attend<NC, false>(p, qs, ks, vs, kb2, bars, &bars[NC], q0, h, b);
}

template <int NC>
cudaError_t launch_wgmma(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                         int H, float scale, int causal, cudaStream_t stream) {
  auto kernel = qkv_attention_wgmma_kernel<NC>;
  static const cudaError_t smem_err = wg::allow_smem(kernel, wg_smem<NC>());
  if (smem_err != cudaSuccess) return smem_err;
  WgParams p;
  const long long st[3] = {(long long)S * 3 * D, 64, 3LL * D};
  const cudaError_t err = wg::map_bhsd(&p.qkv, qkv, B, 3 * H, S, st);
  if (err != cudaSuccess) return err;
  p.key_bias = static_cast<const float*>(key_bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.S = S;
  p.D = D;
  p.H = H;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + 63) / 64, H, B);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = wg_smem<NC>();
  cfg.stream = stream;
  // launched as clusters of one block: 4% faster at CoCa-L's (32, 256, 3 x 1024)
  // than a plain launch (PERF.md), the blocks placed otherwise
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, kernel, p);
  return launch != cudaSuccess ? launch : cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                           int H, float scale, int causal, cudaStream_t stream) {
  if (S <= 64) return launch_wgmma<1>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  if (S <= 128) return launch_wgmma<2>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  if (S <= 192) return launch_wgmma<3>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
  return launch_wgmma<4>(qkv, key_bias, out, B, S, D, H, scale, causal, stream);
}

}  // namespace

extern "C" {

// qkv: (B, S, 3D) and out: (B, S, D), both of `dtype` (0 = fp32, 1 = bf16),
// contiguous, 16-byte aligned; key_bias: (B, S) fp32 or null. bf16 at head
// width 64 runs the `wgmma` kernel, every other shape the FP32 pipes.
// Launches on `stream`, allocates nothing and returns cudaGetLastError() of
// the launch.
int mm_qkv_attention(const void* qkv, const void* key_bias, void* out, int B, int S, int D,
                     int H, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || S > 256 || H <= 0 || D % H != 0 || (D / H) % 8 != 0 ||
      D / H > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(qkv, key_bias, out, B, S, D, H, scale, causal, st);
  if (D / H == kHd)
    return (int)dispatch_wgmma(qkv, key_bias, out, B, S, D, H, scale, causal, st);
  return (int)dispatch<__nv_bfloat16>(qkv, key_bias, out, B, S, D, H, scale, causal, st);
}

}  // extern "C"
