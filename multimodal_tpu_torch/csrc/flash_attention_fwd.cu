// Flash attention forward (blockwise online softmax in log2 space), for Hopper.
//
// Replaces: multimodal_tpu/ops/flash_attention.py, `flash_attention_forward`
// (kernel body `_flash_kernel`).
//
// What it computes, per batch b, head h and query row i (Sq rows, Sk keys):
//   s2_ij = (q_i . k_j) * scale * log2(e) + bias[b, h, i, j] * log2(e)
//   key j is visible iff j < Sk, (causal) j <= i + Sk - Sq (bottom-right
//   alignment), and (segments) q_seg[b, i] == kv_seg[b, j]
//   o_i   = sum_j T(exp2(s2_ij - m_i)) v_j / sum_j exp2(s2_ij - m_i)
//   lse_i = m_i + log2(sum_j exp2(s2_ij - m_i))            (log2 space)
// with m the running maximum of the online softmax: the probabilities are
// rounded to the compute type T relative to the running maximum before the
// product with v, and the row sum is taken in fp32 unrounded, as the TPU
// kernel does. The bias is fp32 of any broadcast shape: its four strides
// come from the wrapper (0 on a size-1 dimension), so a broadcast bias is
// read in place and never materialised. A row that sees no key at all (l = 0)
// is defined here as o = 0 and lse = -inf.
//
// What bounds it on this card: operations. At the LM shapes (8, 12, S, 64)
// bf16 causal the products are 4 * 64 FLOPs a visible (query, key) pair:
// 52 GFLOP at S = 2048 (prefill, 0.052 ms at 989 TF/s) and 825 GFLOP at
// S = 8192 (a train step's call, 0.834 ms), against 4 * 8 * 12 * S * 64 * 2
// bytes of q, k, v and o (0.015 and 0.06 ms at 3.35 TB/s).
//
// Design, bf16 at head width 32, 64 or 96, with or without a bias
// (flash_fwd_wgmma_kernel<D, BIAS, WGS>): one block of two warpgroups per
// (128-query tile, head, batch), 64 query rows a warpgroup; up to 64
// queries (kShortQueries: BLIP-2's 32 text queries) a block is one
// warpgroup of 64 rows with a two-stage ring, so that no warpgroup owns
// padding rows only and two blocks share an SM. The grid walks a
// chunk of heads at a time (about a wave of blocks: 8 heads at S = 2048, 2
// at 8192; 3% faster at S = 2048 than every head's same query tile
// together), and inside a chunk the longest causal rows first. Thread 0
// loads the block's Q once by TMA and the first key tiles of K and V (128
// keys each) into a ring of stages, each guarded by an mbarrier; there is no
// producer warp (a ninth warp would cap every thread at 168 registers). The
// last of the eight warps to be done with a stage refills it. Per key tile t
// a warpgroup issues S(t) = Q K(t)^T (`wgmma` m64n128k16, D / 16 k-steps,
// both operands K-major in shared memory, fp32 accumulators) and then O +=
// P(t - 1) V(t - 1) (m64n64k16 or m64n96k16 with P, rounded to bf16 and
// packed, as the A fragments in registers and V MN-major), waits for S(t)
// alone and runs the softmax of tile t (fp32, `ex2`, row maxima and sums in
// four partials) while the tensor cores run P(t - 1) V(t - 1); the two
// warpgroups take turns to issue (named barriers), so one's softmax also
// runs under the other's products. P never goes through shared memory. Key
// tiles wholly above the causal diagonal are never loaded; the leading tiles
// that every row of the block sees whole run a loop without masks, the rest
// (the diagonal, a ragged Sk edge, segment ids, every tile with a bias) a
// loop with one straight pass of selects before the softmax (each element
// visible where its key is at most its row's last one and its segment bit
// is set, the tests combined with bitwise operators: with `&&` the compiler
// branched around elements, 7% slower at the LM prefill), the segment ids
// read as bits and the bias as the thread's 64 fp32 values of the tile
// (through its four strides, in place) before the tile's products, so that
// their loads run under them. With a bias the scores go into log2 units
// with the bias added before the row maxima: a row that the bias masks
// wholly (every score -1e30) has every score equal to its maximum and
// averages its visible keys' V, as the plain version does; o = 0 and lse =
// -inf only where a row has no visible key (causal, segments). Rows past Sq
// read zeros and are not stored. A 64-wide row is 128 bytes, one box in the
// 128-byte swizzle, and six stages of K and V fit; a 96-wide row (192
// bytes) is past that swizzle, so at D = 96 a tile is three 32-column
// chunks in the 64-byte swizzle (the descriptors' chunks one chunk apart)
// and four stages of 48 KB fit beside Q. At (8, 12, 2048, 64) causal it
// takes 0.188 ms, at (8, 12, 8192, 64) 2.28-2.31 ms, against SDPA's
// 0.14 and 1.78 (H100 80GB HBM3, 700.00 W; PERF.md): what remains is mostly
// the `ex2`s, 16 a clock an SM, as many clocks a tile as the tensor cores'
// products. At CoCa's and BLIP-2's short shapes (one or two key tiles a
// block) a block's load and softmax latencies show: with a bias a thread
// holds 254 registers, one two-warpgroup block an SM (CoCa's fusion mask
// 0.021 device ms against SDPA's 0.007-0.014; the pooler at D = 96 0.033
// against 0.024, PERF.md).
//
// At head width 32 (MDETR's 8 heads of 32) a pair's products are 128 FLOPs
// and its `ex2` one of 16 an SM a clock, so the `ex2` units, not the tensor
// cores, are the floor (MDETR's encoder, (8, 8, 1220, 1220) with key
// padding, 72.6 M visible pairs: 0.017 ms at 1,980 MHz, against 0.0094
// for operations). A 32-wide row is 64 bytes, one 32-column chunk in the
// 64-byte swizzle (as each of D = 96's three): S = Q K^T is two k-steps of m64n128k16 and O +=
// P V eight of m64n32k16, O 16 floats a thread. Every block is one
// warpgroup of 64 query rows with a two-stage ring: 168 registers a
// thread, so three blocks share an SM where a block of two warpgroups
// held it alone (the encoder 0.0829 ms against 0.0962). Segment ids are
// compared element by element in the mask pass, the tile's 128 key ids
// copied into the stage with K and V by one bulk copy (the wrapper pads
// kvseg's rows to whole 128-key tiles): packing them first into
// segment_bits' 64-bit word, as at D = 64 and 96, is a chain of 64
// dependent ORs a tile, which here doubled the kernel's time (0.184 ms
// against 0.088 with every bit set). MDETR's encoder 0.081-0.087 ms and
// cross-attention 0.018-0.021 against SDPA's 0.114-0.121 and 0.024-0.025
// (H100 80GB HBM3, 700.00 W; PERF.md). A split of the cross-attention's
// key tiles into runs merged after (as #10 does) took it to 0.016, 2 us a
// call, and is not kept (PERF.md section 7).
//
// The other routes, chosen by type and head width, never after a failure:
// - bf16 at head width 128 (flash_fwd_mma_kernel), with or without a
//   bias: one block of 4 warps per (64-query tile, head, batch); each warp
//   owns 16 query rows and keeps its q fragments, its 16 x 64 score tile and
//   its 16 x D output accumulator in registers. The block walks 64-key tiles
//   of K and V staged in a two-stage cp.async double buffer; q . k^T and
//   T(p) . v are `mma.sync` m16n8k16 products (fragments by `ldmatrix`, V by
//   `ldmatrix.trans`), the score tile, rounded to bf16, reused in registers
//   as the A fragment of p . v. The causal walk and the masks as above.
// - fp32, and bf16 at other head widths, on the FP32 pipes: a block of 8
//   warps owns 32 query rows (4 per warp), stages 32-key tiles of K
//   (transposed, odd pitch) and V in fp32 shared memory; a lane owns one key
//   of the tile for the scores and 32-column slices of the output for p . v,
//   with the probabilities broadcast by shuffles.

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

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, row strides in elements
  const float* bias;
  long long bs[4];  // bias strides (batch, head, row, key); 0 on broadcast dims
  const int* qseg;
  const int* kvseg;
  long long qseg_b, kvseg_b;  // batch strides of the segment ids (row stride 1)
  float* lse;                 // (B, H, Sq) fp32 or null
  int B, H, Sq, Sk;
  float scale_log2;  // sm_scale * log2(e)
  int causal;
};

// Whether key j (< Sk) is visible from query row i (< Sq), and the fp32
// log2-space bias to add.
__device__ __forceinline__ bool visible(const Args& a, int b, int i, int j) {
  if (a.causal && j > i + (a.Sk - a.Sq)) return false;
  if (a.qseg && a.qseg[b * a.qseg_b + i] != a.kvseg[b * a.kvseg_b + j]) return false;
  return true;
}

__device__ __forceinline__ float bias_at(const Args& a, int b, int h, int i, int j) {
  return a.bias[b * a.bs[0] + h * a.bs[1] + i * a.bs[2] + j * a.bs[3]] * kLog2e;
}

// ---------------------------------------------------------------------------
// `mma.sync` path: bf16 at head width 128.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows a block owns
constexpr int kBK = 64;           // keys a tile holds

template <int D>
struct Tile {
  static constexpr int kPitch = D + 8;  // bf16 row pitch: conflict-free ldmatrix
  static constexpr int kElems = 64 * kPitch;
  static constexpr size_t kSmem = 5 * kElems * sizeof(__nv_bfloat16);  // Q, 2 x (K, V)
};

// Copy 64 rows of width D (bf16) from `src` (row stride `rs`) into `dst`;
// rows at or past `n` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kWarps * 32) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool in = r < n;
    mm::cp_async16(dst + r * Tile<D>::kPitch + c, in ? src + r * rs + c : src, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_mma_kernel(Args a) {
  constexpr int P = Tile<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kbuf = qs + Tile<D>::kElems;            // [2][64][P]
  __nv_bfloat16* vbuf = kbuf + 2 * Tile<D>::kElems;       // [2][64][P]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = a.Sk - a.Sq;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + h * a.vs[1];

  // Key tiles any row of this query tile can see.
  int n_tiles = (a.Sk + kBK - 1) / kBK;
  if (a.causal) {
    const int last_key = min(a.Sq, q0 + kBQ) - 1 + off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBK + 1);
  }

  load_tile<D>(qs, qg, a.qs[2], a.Sq - q0);
  if (n_tiles > 0) {
    load_tile<D>(kbuf, kg, a.ks[2], a.Sk);
    load_tile<D>(vbuf, vg, a.vs[2], a.Sk);
  }
  mm::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // rows of this lane: row0 and row0 + 8
  const int rows[2] = {row0, row0 + 8};

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's partial row sums
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  uint32_t qf[D / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = (t + 1) * kBK;
      load_tile<D>(kbuf + (st ^ 1) * Tile<D>::kElems, kg + k1 * a.ks[2], a.ks[2], a.Sk - k1);
      load_tile<D>(vbuf + (st ^ 1) * Tile<D>::kElems, vg + k1 * a.vs[2], a.vs[2], a.Sk - k1);
      mm::cp_async_commit();
      mm::cp_async_wait<1>();
    } else {
      mm::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        mm::ldsm_x4(qf[kd], qs + (16 * warp + (lane & 15)) * P + 16 * kd + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = kbuf + st * Tile<D>::kElems;
    const __nv_bfloat16* vs = vbuf + st * Tile<D>::kElems;
    const int k0 = t * kBK;

    // s = q . k^T: 8-key tile nt holds keys 8 nt + 2 t4, +1.
    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        uint32_t bk[4];
        mm::ldsm_x4(bk, ks + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * P + 16 * kd +
                            ((lane >> 3) & 1) * 8);
        mm::mma_bf16(sc[2 * j], qf[kd], bk[0], bk[1]);
        mm::mma_bf16(sc[2 * j + 1], qf[kd], bk[2], bk[3]);
      }
    }

    // Scale, bias and masks in log2 space; the running maximum. A tile that
    // every row of the block sees whole (below the causal diagonal, inside
    // Sq and Sk, no bias or segments) skips the per-element checks.
    float mx[2] = {-INFINITY, -INFINITY};
    const bool whole = !a.bias && !a.qseg && q0 + kBQ <= a.Sq && k0 + kBK <= a.Sk &&
                       (!a.causal || k0 + kBK - 1 <= q0 + off);
    if (whole) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] *= a.scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e >> 1];
          const int j = k0 + 8 * nt + 2 * t4 + (e & 1);
          float s = -INFINITY;
          if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
            s = sc[nt][e] * a.scale_log2;
            if (a.bias) s += bias_at(a, b, h, i, j);
          }
          sc[nt][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: p = 0
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nt][e] - mu[e >> 1]);
        sc[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // o += bf16(p) . v: the score tiles of a 16-key group are the A fragment.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = mm::pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = mm::pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = mm::pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = mm::pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        mm::ldsm_x4_trans(bv, vs + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * P + 8 * dt +
                                  (lane >> 4) * 8);
        mm::mma_bf16(o[dt], pa, bv[0], bv[1]);
        mm::mma_bf16(o[dt + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
  mm::cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    if (i >= a.Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(og + i * a.os[2] + 8 * dt + 2 * t4) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (a.lse && t4 == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + i] = l[r] == 0.f ? -INFINITY : m[r] + log2f(l[r]);
  }
}

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<D>;
  const size_t smem = Tile<D>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Sq + kBQ - 1) / kBQ, a.H, a.B), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at head width 32, 64 or 96, with or without a bias: `wgmma` + TMA.
// ---------------------------------------------------------------------------

constexpr int kWgKeys = 128;  // keys a tile holds
// Query lengths up to which a block is one warpgroup (64 query rows) with
// a ring of kShortStages, not two (128 rows) with the head width's
// kStages: a second warpgroup would own padding rows only, and two such
// blocks share an SM (2x faster at BLIP-2's 32 text queries; at 76-256
// queries the blocks of two warpgroups were as fast or faster, PERF.md).
constexpr int kShortQueries = 64;
constexpr int kShortStages = 2;

// The layout of a head width's tiles in shared memory. A tile of R rows is
// D / kCols column chunks, each R rows of kRowBytes, the rows of a chunk
// back to back (so a chunk is one K-major operand of up to 128 rows, or one
// MN-major run of keys), each 64 rows of it one TMA box. At D = 64 a row is
// 128 bytes, one chunk in the 128-byte swizzle; a 192-byte row at D = 96 is
// past that swizzle's span, so it is three 32-column chunks of 64-byte rows
// in the 64-byte swizzle. kStages: K and V tiles in flight, as many as 227
// KB hold beside Q.
template <int D>
struct WgShape;
template <>
struct WgShape<32> {
  static constexpr int kCols = 32;
  static constexpr int kStages = kShortStages;  // blocks of one warpgroup only
  static constexpr uint64_t kSwizzle = 2;  // 64-byte swizzle
  static constexpr CUtensorMapSwizzle kMapSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <>
struct WgShape<64> {
  static constexpr int kCols = 64;
  static constexpr int kStages = 6;
  static constexpr uint64_t kSwizzle = 1;  // the descriptors' 128-byte swizzle
  static constexpr CUtensorMapSwizzle kMapSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
};
template <>
struct WgShape<96> {
  static constexpr int kCols = 32;
  static constexpr int kStages = 4;
  static constexpr uint64_t kSwizzle = 2;  // 64-byte swizzle
  static constexpr CUtensorMapSwizzle kMapSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
};

template <int D>
struct Wg : WgShape<D> {
  static constexpr int kRowBytes = 2 * WgShape<D>::kCols;
  static constexpr int kChunks = D / WgShape<D>::kCols;
  static constexpr int kBox = 64 * kRowBytes;          // 64 rows of a chunk
  static constexpr int kTile = kChunks * 2 * kBox;     // 128 rows, every chunk
  static constexpr int kKvBytes = 2 * kTile;           // a stage: K's tile, then V's
  static constexpr int kKSteps = D / 16;               // k-steps of Q K^T
};

// A block's two warpgroups take turns to issue their products (named
// barriers 3 and 4), so that one's softmax runs under the other's products,
// besides each overlapping its own softmax of tile t with its product of
// t - 1.
constexpr bool kPingPong = true;

// A block of WGS warpgroups (64 query rows each) at head width D.
template <int D, int WGS>
struct Blk {
  static constexpr int kRows = 64 * WGS;  // query rows a block owns
  static constexpr int kThreads = 128 * WGS;  // one lane issues each copy
  static constexpr int kWarps = 4 * WGS;
  static constexpr int kStages = WGS == 2 ? WgShape<D>::kStages : kShortStages;
  // The two warpgroups take turns to issue their products (kPingPong).
  static constexpr bool kTurns = kPingPong && WGS == 2;
  static constexpr int kQTile = WGS * Wg<D>::kChunks * Wg<D>::kBox;  // Q: kRows rows
  // At head width 32 each stage also holds its tile's key segment ids (128
  // int32), copied with K and V.
  static constexpr int kSegBytes = D == 32 ? kStages * kWgKeys * 4 : 0;
  // Shared memory, from a 1024-byte aligned base: Q's tile, the stages,
  // their segment ids, their `full` barriers and Q's, and a count a stage
  // of the warps done with it.
  static constexpr size_t kSmem = 1024 + kQTile + (size_t)kStages * Wg<D>::kKvBytes +
                                  kSegBytes + (kStages + 1) * sizeof(uint64_t) +
                                  kStages * sizeof(int);
};
static_assert(Blk<64, 2>::kSmem <= 232448 && Blk<96, 2>::kSmem <= 232448,
              "a block's shared memory");

// Blocks that a chunk of heads spans (about a wave of the card's 132 SMs at
// a block an SM): the blocks of a few heads run together and share their K
// and V in L2.
constexpr int kChunkBlocks = 132;

struct WgParams {
  CUtensorMap q, k, v;  // (B, H, S, D) bf16, 64-row boxes of a chunk's columns
  Args a;
};

// A shared-memory descriptor in head width D's swizzle (wg::desc's fields).
template <int D>
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (wg::desc(addr, lbo, sbo) & ~(3ull << 62)) | (Wg<D>::kSwizzle << 62);
}
// K-major descriptor of k-step kk (16 columns) of the rows at `tile` + `row0`
// bytes of each chunk (a tile of ROWS rows): chunk kk / (kCols / 16), 32
// bytes a k-step into its rows, 8-row groups 8 rows apart.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, uint32_t row0, int kk) {
  constexpr int per = Wg<D>::kCols / 16;
  return wg_desc<D>(tile + (kk / per) * ROWS * Wg<D>::kRowBytes + row0 + (kk % per) * 32, 16,
                    8 * Wg<D>::kRowBytes);
}
// MN-major descriptor of k-step kk (16 keys) of a V tile: 16 rows on, the
// chunks (N) one chunk apart.
template <int D>
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  return wg_desc<D>(tile + kk * 16 * Wg<D>::kRowBytes, 2 * Wg<D>::kBox, 8 * Wg<D>::kRowBytes);
}

// The boxes of the 64 R rows of a (B, H, S, D) tensor from row r0 into a
// tile at `dst`, reported to `bar`.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int r0, int h, int b) {
#pragma unroll
  for (int c = 0; c < Wg<D>::kChunks; ++c)
#pragma unroll
    for (int j = 0; j < R; ++j)
      wg::tma_box_4d(dst + (R * c + j) * Wg<D>::kBox, map, bar, c * Wg<D>::kCols, r0 + 64 * j,
                     h, b);
}

// The copies of key tile t (K and V, 128 rows each) into its stage,
// reported to the stage's `full` barrier; at head width 32 with segment ids
// also the tile's 128 key ids (rows of kvseg padded to whole tiles), after
// the STAGES stages.
template <int D, int STAGES>
__device__ __forceinline__ void load_kv(const WgParams& p, uint8_t* kv, uint64_t* full, int t,
                                        int h, int b) {
  const int s = t % STAGES;
  uint8_t* dst = kv + s * Wg<D>::kKvBytes;
  if constexpr (D == 32) {
    wg::bar_expect_tx(&full[s], Wg<D>::kKvBytes + (p.a.qseg ? kWgKeys * 4 : 0));
    if (p.a.qseg)
      wg::bulk_copy(kv + STAGES * Wg<D>::kKvBytes + s * kWgKeys * 4,
                    p.a.kvseg + b * p.a.kvseg_b + t * kWgKeys, kWgKeys * 4, &full[s]);
  } else {
    wg::bar_expect_tx(&full[s], Wg<D>::kKvBytes);
  }
  load_tile<D, 2>(dst, &p.k, &full[s], t * kWgKeys, h, b);
  load_tile<D, 2>(dst + Wg<D>::kTile, &p.v, &full[s], t * kWgKeys, h, b);
}

// O += P V over the 128 keys of a V tile (eight k-steps, P in registers).
template <int D>
__device__ __forceinline__ void pv_products(float (&o)[D / 2], const uint32_t (&pa)[8][4],
                                            uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if constexpr (D == 32)
      wg::mma_m64n32k16_rs<wg::MN>(o, pa[kk], desc_v<D>(v_tile, kk), 1);
    else if constexpr (D == 64)
      wg::mma_m64n64k16_rs<wg::MN>(o, pa[kk], desc_v<D>(v_tile, kk), 1);
    else
      wg::mma_m64n96k16_rs<wg::MN>(o, pa[kk], desc_v<D>(v_tile, kk), 1);
  }
}

// Which of a thread's scores of key tile k0 pair a query and a key of one
// segment: bit 4 j + 2 hh + c for row r0 + 8 hh and key k0 + 8 j + 2 t4 + c.
// Read before the tile's products are issued, so that the loads' latency
// runs under them.
__device__ __forceinline__ uint64_t segment_bits(const Args& a, int b, int k0, int t4,
                                                 const int (&qid)[2]) {
  const int* kvseg = a.kvseg + b * a.kvseg_b;
  uint64_t bits = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t4 + c;
      const int kid = key < a.Sk ? kvseg[key] : 0;  // keys past Sk are masked anyway
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        bits |= (uint64_t)(kid == qid[hh]) << (4 * j + 2 * hh + c);
    }
  return bits;
}

// The bias of a thread's scores of key tile k0 (bv[4 j + 2 hh + c] for row
// r0 + 8 hh and key k0 + 8 j + 2 t4 + c), fp32 read in place through its
// four strides; rows and keys past the ends read the last ones (masked
// anyway). Read before the tile's products are issued, as the segment ids
// are; CoCa's rows of 77 floats are not 16-byte aligned, so these are
// ordinary loads.
__device__ __forceinline__ void bias_tile(float (&bv)[64], const Args& a, int b, int h, int r0,
                                          int k0, int t4) {
  const float* base = a.bias + b * a.bs[0] + h * a.bs[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float* row = base + min(r0 + 8 * hh, a.Sq - 1) * a.bs[2];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        bv[4 * j + 2 * hh + c] = row[min(k0 + 8 * j + 2 * t4 + c, a.Sk - 1) * a.bs[3]];
  }
}

// mask_tile at head width 32 with segment ids: each element's key id read
// from the tile's 128 ids in shared memory (`kvs`, copied with K and V) and
// compared with its row's, element by element. (Packing the comparisons
// into segment_bits' 64-bit word first is a chain of 64 dependent ORs a
// tile, which at this width held the kernel: MDETR's encoder 0.184 ms
// against 0.088 with every bit set, PERF.md.)
template <bool BIAS>
__device__ __forceinline__ void mask_tile_ids(float (&s)[64], const Args& a, int r0, int k0,
                                              int t4, const int* kvs, const int (&qid)[2],
                                              const float (&bv)[64]) {
  const int last[2] = {a.causal ? min(a.Sk - 1, r0 + a.Sk - a.Sq) : a.Sk - 1,
                       a.causal ? min(a.Sk - 1, r0 + 8 + a.Sk - a.Sq) : a.Sk - 1};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int2 kid = *reinterpret_cast<const int2*>(kvs + 8 * j + 2 * t4);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t4 + c;
      const int id = c ? kid.y : kid.x;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh + c;
        const bool vis = (key <= last[hh]) & (id == qid[hh]);
        const float v = BIAS ? fmaf(s[x], a.scale_log2, bv[x] * kLog2e) : s[x];
        s[x] = vis ? v : -INFINITY;
      }
    }
  }
}

// The per-element masks of key tile k0 on a thread's scores (s[4 j + e] is
// row r0 + 8 (e / 2), key k0 + 8 j + 2 t4 + e % 2): -inf where a key lies
// past Sk, above the causal diagonal or, by `seg` (segment_bits; all ones
// without segment ids), in another segment. With BIAS the visible scores
// are scaled into log2 units and the bias (bias_tile) added, in place. One
// straight pass of selects: no branch around an element.
template <bool BIAS>
__device__ __forceinline__ void mask_tile(float (&s)[64], const Args& a, int r0, int k0, int t4,
                                          uint64_t seg, const float (&bv)[64]) {
  // the last key each of the thread's two rows sees: Sk - 1, or its causal
  // diagonal before it
  const int last[2] = {a.causal ? min(a.Sk - 1, r0 + a.Sk - a.Sq) : a.Sk - 1,
                       a.causal ? min(a.Sk - 1, r0 + 8 + a.Sk - a.Sq) : a.Sk - 1};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t4 + c;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh + c;
        const bool vis = (key <= last[hh]) & (((seg >> x) & 1) != 0);
        const float v = BIAS ? fmaf(s[x], a.scale_log2, bv[x] * kLog2e) : s[x];
        s[x] = vis ? v : -INFINITY;
      }
    }
}

// One key tile t of a warpgroup: the products S(t) = Q K(t)^T (D / 16
// k-steps, the first overwriting S) and O += P(t - 1) V(t - 1) (eight, P
// from registers) issued as two groups; the softmax of S(t) once the first
// group is done, under the second; then, with both done, the stage of t - 1
// released, O rescaled and P(t) packed. No instruction writes registers of
// a product in flight (ptxas would serialize the products), and every
// product is issued, unconditionally: for t = 0, P is 0 and V is tile 0's.
// Scores are raw products, scaled inside the softmax, except with BIAS,
// where mask_tile leaves them in log2 units with the bias added.
template <int D, int WGS, bool MASK, bool BIAS>
__device__ __forceinline__ void flash_tile(const WgParams& p, uint8_t* kv, uint64_t* full,
                                           int* released, int t, int n, int h, int b, int r0,
                                           const int (&qid)[2], uint32_t q_tile, uint32_t q_row0,
                                           float (&s)[64], float (&o)[D / 2],
                                           uint32_t (&pa)[8][4], float (&m)[2], float (&l)[2]) {
  using B = Blk<D, WGS>;
  constexpr int kStages = B::kStages;
  constexpr bool kTurns = B::kTurns;
  const Args& a = p.a;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int wgi = threadIdx.x / 128;
  const int st = t % kStages;
  const int pv = t == 0 ? 0 : (t - 1) % kStages;
  const int k0 = t * kWgKeys;
  uint64_t seg = ~0ull;
  if constexpr (D != 32) seg = MASK && a.qseg ? segment_bits(a, b, k0, t4, qid) : ~0ull;
  float bv[64];
  if (BIAS) bias_tile(bv, a, b, h, r0, k0, t4);
  wg::bar_wait(&full[st], (t / kStages) & 1);
  __syncwarp();  // the warp leaves the poll together: `wgmma` is .aligned
  if (kTurns) wg::named_sync(3 + wgi, B::kThreads);
  const uint32_t k_tile = wg::smem_u32(kv + st * Wg<D>::kKvBytes);
  const uint32_t v_tile = wg::smem_u32(kv + pv * Wg<D>::kKvBytes + Wg<D>::kTile);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Wg<D>::kKSteps; ++kk)
    wg::mma_m64n128k16<wg::K, wg::K>(s, desc_k<D, B::kRows>(q_tile, q_row0, kk),
                                     desc_k<D, kWgKeys>(k_tile, 0, kk), kk);
  wg::wgmma_commit();
  pv_products<D>(o, pa, v_tile);
  wg::wgmma_commit();
  if (kTurns) wg::named_arrive(3 + (wgi ^ 1), B::kThreads);
  wg::wgmma_wait<1>();  // S(t) is done; P(t - 1) V(t - 1) runs on
  wg::fence_acc(s);

  if constexpr (D == 32) {
    if (MASK && a.qseg)
      mask_tile_ids<BIAS>(
          s, a, r0, k0, t4,
          reinterpret_cast<const int*>(kv + kStages * Wg<D>::kKvBytes) + st * kWgKeys, qid, bv);
    else if (MASK)
      mask_tile<BIAS>(s, a, r0, k0, t4, seg, bv);
  } else if (MASK) {
    mask_tile<BIAS>(s, a, r0, k0, t4, seg, bv);
  }
  // Row maxima and sums in four partials a row (x = 4 j + e: partial j % 4,
  // row e / 2), so that no chain of 32 dependent instructions stalls the
  // warp.
  float part[2][4];
#pragma unroll
  for (int x = 0; x < 8; ++x) part[(x >> 1) & 1][x >> 2 << 1 | (x & 1)] = s[x];
#pragma unroll
  for (int x = 8; x < 64; ++x) {
    float& pm = part[(x >> 1) & 1][((x >> 2) & 1) << 1 | (x & 1)];
    pm = fmaxf(pm, s[x]);
  }
  float mx[2], alpha[2], mu[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(fmaxf(part[hh][0], part[hh][1]), fmaxf(part[hh][2], part[hh][3]));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    // max(s) * c is max(s * c) exactly: the rounding is monotonic, c > 0
    const float m_new = fmaxf(m[hh], BIAS ? mx[hh] : mx[hh] * a.scale_log2);
    mu[hh] = m_new == -INFINITY ? 0.f : m_new;  // no visible key yet: p = 0
    alpha[hh] = ex2(m[hh] - mu[hh]);
    m[hh] = m_new;
  }
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int hh = (x >> 1) & 1;
    if constexpr (BIAS)
      s[x] = ex2(s[x] - mu[hh]);  // a row the bias masks wholly: every s = mu, p = 1
    else
      s[x] = ex2(fmaf(s[x], a.scale_log2, -mu[hh]));
    float& ps = part[hh][((x >> 2) & 1) << 1 | (x & 1)];
    ps = x < 8 ? s[x] : ps + s[x];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = l[hh] * alpha[hh] + ((part[hh][0] + part[hh][1]) + (part[hh][2] + part[hh][3]));

  wg::wgmma_wait<0>();
  wg::fence_acc(o);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wg::fence_regs(pa[kk]);
  // The stage of t - 1 is done in this warp; the last of the block's warps
  // to be done refills it with tile t - 1 + kStages.
  if (t > 0 && lane == 0) {
    const int rs = (t - 1) % kStages;
    __threadfence_block();
    if (atomicAdd(&released[rs], 1) == B::kWarps - 1) {
      released[rs] = 0;
      __threadfence_block();
      wg::fence_async_smem();
      if (t - 1 + kStages < n) load_kv<D, kStages>(p, kv, full, t - 1 + kStages, h, b);
    }
  }
  __syncwarp();
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = mm::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int D, bool BIAS, int WGS>
__global__ void __launch_bounds__(Blk<D, WGS>::kThreads, WGS == 2 ? 1 : 2)
    flash_fwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  using B = Blk<D, WGS>;
  constexpr int kStages = B::kStages;
  constexpr int kWgRows = B::kRows;
  constexpr bool kTurns = B::kTurns;
  const Args& a = p.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint8_t* kv = sm + B::kQTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + kStages * Wg<D>::kKvBytes + B::kSegBytes);
  uint64_t* q_bar = full + kStages;
  int* released = reinterpret_cast<int*>(q_bar + 1);

  // The grid is walked a chunk of heads at a time (kChunkBlocks); inside a
  // chunk, query tiles from the last: under the causal mask the longest
  // rows start first.
  const int nq = (a.Sq + kWgRows - 1) / kWgRows;
  const int heads = a.B * a.H;
  const int per_chunk = max(1, min(heads, kChunkBlocks / nq));  // heads a chunk
  const int chunk = (int)blockIdx.x / (per_chunk * nq);
  const int in_chunk = min(per_chunk, heads - chunk * per_chunk);
  const int j = (int)blockIdx.x - chunk * per_chunk * nq;
  const int bh = chunk * per_chunk + j % in_chunk;
  const int h = bh % a.H;
  const int b = bh / a.H;
  const int q0 = (nq - 1 - j / in_chunk) * kWgRows;
  const int off = a.Sk - a.Sq;
  // Key tiles [0, n) are walked, at least one (a block whose rows see no
  // key masks all of tile 0); [0, n_full) need no per-element mask: every
  // row of the block sees every key of them (and there is no bias).
  int n = (a.Sk + kWgKeys - 1) / kWgKeys;
  if (a.causal) {
    const int last_key = min(a.Sq, q0 + kWgRows) - 1 + off;
    n = max(1, min(n, last_key / kWgKeys + 1));
  }
  int n_full = a.qseg || BIAS ? 0 : min(n, a.Sk / kWgKeys);
  if (a.causal) n_full = min(n_full, q0 + off + 1 > 0 ? (q0 + off + 1) / kWgKeys : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], 1);
      released[s] = 0;
    }
    wg::bar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect_tx(q_bar, B::kQTile);
    load_tile<D, WGS>(sm, &p.q, q_bar, q0, h, b);
    for (int t = 0; t < kStages && t < n; ++t) load_kv<D, kStages>(p, kv, full, t, h, b);
  }

  // Warpgroup wgi owns rows [q0 + 64 wgi, + 64); a thread rows r0 and
  // r0 + 8, and of O columns 8 j + 2 t4 and + 1 (o[4 j + 2 hh + c]).
  const int lane = threadIdx.x & 31;
  const int wgi = threadIdx.x / 128;
  const int t4 = lane & 3;
  const int r0 = q0 + 64 * wgi + 16 * ((threadIdx.x / 32) % 4) + (lane >> 2);
  int qid[2] = {0, 0};
  if (a.qseg)
    for (int hh = 0; hh < 2; ++hh)
      qid[hh] = r0 + 8 * hh < a.Sq ? a.qseg[b * a.qseg_b + r0 + 8 * hh] : 0;

  float s[64], o[D / 2];
  uint32_t pa[8][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's partial row sums
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = 0u;
  // the zeros are written here, not sunk into the first products' flight
  wg::fence_acc(o);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wg::fence_regs(pa[kk]);
  if (kTurns && wgi == 1) wg::named_arrive(3, B::kThreads);  // warpgroup 0 issues first
  wg::bar_wait(q_bar, 0);
  __syncwarp();
  const uint32_t q_tile = wg::smem_u32(sm);
  const uint32_t q_row0 = wgi * 64 * Wg<D>::kRowBytes;

  if constexpr (!BIAS)
    for (int t = 0; t < n_full; ++t)
      flash_tile<D, WGS, false, false>(p, kv, full, released, t, n, h, b, r0, qid, q_tile,
                                       q_row0, s, o, pa, m, l);
  for (int t = n_full; t < n; ++t)
    flash_tile<D, WGS, true, BIAS>(p, kv, full, released, t, n, h, b, r0, qid, q_tile, q_row0,
                                   s, o, pa, m, l);

  // O += P(n - 1) V(n - 1)
  if (kTurns) wg::named_sync(3 + wgi, B::kThreads);
  const uint32_t v_last =
      wg::smem_u32(kv + ((n - 1) % kStages) * Wg<D>::kKvBytes + Wg<D>::kTile);
  wg::wgmma_fence();
  pv_products<D>(o, pa, v_last);
  wg::wgmma_commit();
  if (kTurns && wgi == 0) wg::named_arrive(4, B::kThreads);
  wg::wgmma_wait<0>();
  wg::fence_acc(o);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + 8 * hh;
    if (i >= a.Sq) continue;
    const float inv = l[hh] == 0.f ? 0.f : 1.f / l[hh];
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc)
      *reinterpret_cast<__nv_bfloat162*>(og + i * a.os[2] + 8 * jc + 2 * t4) =
          __floats2bfloat162_rn(o[4 * jc + 2 * hh] * inv, o[4 * jc + 2 * hh + 1] * inv);
    if (a.lse && t4 == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + i] =
          l[hh] == 0.f ? -INFINITY : m[hh] + log2f(l[hh]);
  }
}

// A TMA map of a bf16 (B, H, S, D) tensor with element strides st (batch,
// head, row): boxes of 64 rows by a chunk's columns, in D's swizzle. Rows
// past S read zeros.
template <int D>
cudaError_t map_bhsd(CUtensorMap* map, const void* base, int B, int H, int S,
                     const long long (&st)[3]) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Wg<D>::kCols, 64, 1, 1};
  return wg::make_map_nd<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                            Wg<D>::kMapSwizzle);
}

template <int D, bool BIAS, int WGS>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using B = Blk<D, WGS>;
  static const cudaError_t smem_err =
      wg::allow_smem(flash_fwd_wgmma_kernel<D, BIAS, WGS>, B::kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  WgParams p;
  p.a = a;
  cudaError_t err;
  if ((err = map_bhsd<D>(&p.q, a.q, a.B, a.H, a.Sq, a.qs)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.k, a.k, a.B, a.H, a.Sk, a.ks)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.v, a.v, a.B, a.H, a.Sk, a.vs)) != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D, BIAS, WGS><<<(a.Sq + B::kRows - 1) / B::kRows * a.H * a.B,
                                         B::kThreads, B::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of one warpgroup up to kShortQueries queries, of two past them;
// at head width 32 of one at every length: three such blocks share an SM
// (168 registers a thread), where a block of two would hold it alone
// (MDETR's encoder 0.0829 ms against 0.0962, PERF.md).
template <int D, bool BIAS>
cudaError_t dispatch_blocks(const Args& a, cudaStream_t stream) {
  if constexpr (D == 32)
    return launch_wgmma<D, BIAS, 1>(a, stream);
  else
    return a.Sq <= kShortQueries ? launch_wgmma<D, BIAS, 1>(a, stream)
                                 : launch_wgmma<D, BIAS, 2>(a, stream);
}

template <int D>
cudaError_t dispatch_wgmma(const Args& a, cudaStream_t stream) {
  return a.bias ? dispatch_blocks<D, true>(a, stream) : dispatch_blocks<D, false>(a, stream);
}

// ---------------------------------------------------------------------------
// FP32-pipe path: fp32, and bf16 at other head widths (D % 8 == 0, D <= 128).
// ---------------------------------------------------------------------------

constexpr int kFWarps = 8;
constexpr int kFRows = 4;                // query rows a warp carries
constexpr int kFBQ = kFWarps * kFRows;   // query rows a block owns
constexpr int kFBK = 32;                 // keys a tile holds: one a lane

__host__ __device__ inline int fp32_smem_floats(int D) {
  return D * (kFBK + 1) + kFBK * D + kFBQ * D;  // K^T, V, Q
}

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

template <typename T, int NC>  // NC: 32-column slices of the head a lane owns
__global__ void __launch_bounds__(kFWarps * 32) flash_fwd_fp32_kernel(Args a, int D) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int kp = kFBK + 1;
  float* kt = fsm;              // [D][kp]  K^T of the tile
  float* vsm = kt + D * kp;     // [kFBK][D]
  float* qsm = vsm + kFBK * D;  // [kFBQ][D]

  const int q0 = blockIdx.x * kFBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = a.Sk - a.Sq;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];

  for (int idx = threadIdx.x; idx < kFBQ * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    qsm[idx] = q0 + r < a.Sq ? to_f(qg[(q0 + r) * a.qs[2] + c]) : 0.f;
  }

  int n_tiles = (a.Sk + kFBK - 1) / kFBK;
  if (a.causal) {
    const int last_key = min(a.Sq, q0 + kFBQ) - 1 + off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kFBK + 1);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = q0 + warp * kFRows;
  float m[kFRows], l[kFRows], o[kFRows][NC];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) o[r][cc] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFBK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int idx = threadIdx.x; idx < kFBK * D; idx += blockDim.x) {
      const int j = idx / D;
      const int c = idx - j * D;
      const bool in = k0 + j < a.Sk;
      kt[c * kp + j] = in ? to_f(kg[(k0 + j) * a.ks[2] + c]) : 0.f;
      vsm[idx] = in ? to_f(vg[(k0 + j) * a.vs[2] + c]) : 0.f;
    }
    __syncthreads();

    float s[kFRows];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) s[r] = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float k0v = kt[c * kp + lane], k1v = kt[(c + 1) * kp + lane];
      const float k2v = kt[(c + 2) * kp + lane], k3v = kt[(c + 3) * kp + lane];
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qsm + (warp * kFRows + r) * D + c);
        s[r] = fmaf(q4.x, k0v, s[r]);
        s[r] = fmaf(q4.y, k1v, s[r]);
        s[r] = fmaf(q4.z, k2v, s[r]);
        s[r] = fmaf(q4.w, k3v, s[r]);
      }
    }

    const int j = k0 + lane;
    float p[kFRows];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const int i = i0 + r;
      float sv = -INFINITY;
      if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
        sv = s[r] * a.scale_log2;
        if (a.bias) sv += bias_at(a, b, h, i, j);
      }
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - mu);
      m[r] = m_new;
      const float e = exp2f(sv - mu);
      l[r] = l[r] * alpha + warp_sum(e);
      p[r] = to_f(from_f<T>(e));  // rounded to the compute type before p . v
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) o[r][cc] *= alpha;
    }
    for (int jj = 0; jj < kFBK; ++jj) {
      const float* vrow = vsm + jj * D + lane;
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          if (32 * cc + lane < D) o[r][cc] = fmaf(pj, vrow[32 * cc], o[r][cc]);
      }
    }
  }

  T* og = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    const int i = i0 + r;
    if (i >= a.Sq) break;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = 32 * cc + lane;
      if (c < D) og[i * a.os[2] + c] = from_f<T>(o[r][cc] * inv);
    }
    if (a.lse && lane == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + i] = l[r] == 0.f ? -INFINITY : m[r] + log2f(l[r]);
  }
}

template <typename T, int NC>
cudaError_t launch_fp32(const Args& a, int D, cudaStream_t stream) {
  auto kernel = flash_fwd_fp32_kernel<T, NC>;
  const size_t smem = sizeof(float) * (size_t)fp32_smem_floats(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Sq + kFBQ - 1) / kFBQ, a.H, a.B), kFWarps * 32, smem, stream>>>(a, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fp32(const Args& a, int D, cudaStream_t stream) {
  if (D <= 32) return launch_fp32<T, 1>(a, D, stream);
  if (D <= 64) return launch_fp32<T, 2>(a, D, stream);
  if (D <= 96) return launch_fp32<T, 3>(a, D, stream);
  return launch_fp32<T, 4>(a, D, stream);
}

}  // namespace

extern "C" {

// The forward's kernels at head width D in `dtype`: 2 the `wgmma` kernel
// (bf16 at 32, 64 and 96), 1 `mma.sync` (bf16 at 128), 0 the FP32 pipes.
int mm_flash_attention_fwd_route(int D, int dtype) {
  if (dtype == 1 && (D == 32 || D == 64 || D == 96)) return 2;
  return dtype == 1 && D == 128 ? 1 : 0;
}

// q (B, H, Sq, D), k and v (B, H, Sk, D), o (B, H, Sq, D), all of `dtype`
// (0 = fp32, 1 = bf16) with the last dimension contiguous and the other
// three strides given in elements (16-byte aligned rows). bias: fp32 with
// strides bs (0 on broadcast dimensions) or null. qseg (B, Sq) / kvseg
// (B, Sk) int32 with batch strides, both or neither (at head width 32 in
// bf16 kvseg 16-byte aligned, kvseg_b a multiple of 128, the ids past Sk
// read but masked). lse: (B, H, Sq) fp32 or null. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int mm_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                           const long long* q_strides, const long long* k_strides,
                           const long long* v_strides, const long long* o_strides,
                           const void* bias, const long long* bias_strides, const void* qseg,
                           long long qseg_b, const void* kvseg, long long kvseg_b, void* lse,
                           int B, int H, int Sq, int Sk, int D, float sm_scale, int causal,
                           int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D % 8 != 0 || D > 128 ||
      (dtype != 0 && dtype != 1) || ((qseg == nullptr) != (kvseg == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && D == 32 && kvseg &&
      (kvseg_b % kWgKeys != 0 || reinterpret_cast<uintptr_t>(kvseg) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i];
    a.ks[i] = k_strides[i];
    a.vs[i] = v_strides[i];
    a.os[i] = o_strides[i];
  }
  a.bias = static_cast<const float*>(bias);
  for (int i = 0; i < 4; ++i) a.bs[i] = bias ? bias_strides[i] : 0;
  a.qseg = static_cast<const int*>(qseg);
  a.kvseg = static_cast<const int*>(kvseg);
  a.qseg_b = qseg_b;
  a.kvseg_b = kvseg_b;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale_log2 = sm_scale * kLog2e;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_fp32<float>(a, D, st);
  if (D == 64) return (int)dispatch_wgmma<64>(a, st);
  if (D == 96) return (int)dispatch_wgmma<96>(a, st);
  if (D == 32) return (int)dispatch_wgmma<32>(a, st);
  if (D == 128) return (int)launch_mma<128>(a, st);
  return (int)dispatch_fp32<__nv_bfloat16>(a, D, st);
}

}  // extern "C"
