// Flash attention backward (blockwise, probabilities recomputed from the
// forward's log2-space lse), for Hopper.
//
// Replaces: multimodal_tpu/ops/flash_attention.py, `_flash_backward`'s three
// kernel bodies: `_bwd_dq_kernel` (#7, here flash_bwd_dq_*_kernel),
// `_bwd_dkv_kernel` (#8, flash_bwd_dkv_*_kernel) and `_bwd_dbias_kernel`
// (#9, flash_bwd_dq_*_kernel<..., kDbias = true>).
//
// What they compute, per batch b and head h, for query row i (Sq rows) and
// key j (Sk keys), with the forward's scores and visibility rules:
//   s2_ij = (q_i . k_j) * scale * log2(e) + bias[b, h, i, j] * log2(e)
//   key j is visible from row i iff j < Sk, i < Sq, (causal) j <= i + Sk - Sq,
//   and (segments) q_seg[b, i] == kv_seg[b, j]
//   p_ij  = visible ? exp2(s2_ij - lse_i) : 0    (lse_i = -inf gives 0)
//   dp_ij = do_i . v_j,   ds_ij = p_ij * (dp_ij - delta_i)
//   #7:  dq_i = scale * sum_j T(ds_ij) k_j
//   #8:  dk_j = scale * sum_i T(ds_ij) q_i,   dv_j = sum_i T(p_ij) do_i
//   #9:  dbias_ij = ds_ij (fp32), 0 on key tiles the causal skip leaves out
// with delta_i = rowsum(do_i * o_i) (and the lse cotangent folded in) and
// lse from the caller, T the rounding to the compute type, every sum fp32.
// lse and s2 are the forward kernel's exactly (the same scale * log2(e) and
// bias * log2(e) products), so p is the normalised probability.
//
// What bounds them on this card: operations. At the LM training shape
// (8, 12, 8192, 64) bf16 causal there are 3.2e9 visible pairs; #7 does three
// products over them (2 * 64 FLOPs each a pair: 1.24 TFLOP, 1.25 ms at
// 989 TF/s) and #8 four (1.67 ms), against 4 * 8 * 12 * 8192 * 64 * 2 bytes
// of q, k, v and do (0.02 ms at 3.35 TB/s). #9 writes the fp32 (Sq, Sk)
// matrix and so is bound by bytes (25.8 GB, 7.7 ms at that shape).
//
// Design (bf16 at head width 32, 64 or 128; `mma.sync` m16n8k16, fragments
// by `ldmatrix`, as the forward's tensor-core path):
// - #7: one block of 4 warps per (64-query tile, head, batch); each warp owns
//   16 query rows and keeps its scores, dp and its 16 x D fp32 dq accumulator
//   in registers. The TPU's sequential key-grid axis is the loop over 64-key
//   tiles inside the block, up to the last tile the query tile can see; K
//   and V tiles are double-buffered by cp.async. q and do stay in shared
//   memory (their fragments are re-read by ldmatrix a tile, which costs
//   shared-memory bandwidth but keeps the registers for the accumulators).
//   ds is reused in registers as the A fragment of ds . k (K by
//   ldmatrix.trans).
// - #8: one block of 4 warps per (64-key tile, head, batch), each warp 16
//   keys with fp32 dk and dv accumulators in registers; the loop walks query
//   tiles from the first one that can see the key tile (the causal offset
//   Sk - Sq decides it), q, do, lse and delta staged in a two-stage cp.async
//   buffer. The transposed products s^T = k q^T and dp^T = v do^T put keys on
//   the rows, so p^T and ds^T are A fragments in registers for p^T . do and
//   ds^T . q. Registers bound its occupancy: the two accumulators are
//   2 * D / 2 fp32 a thread, and a first version that held p^T and dp^T for
//   all 64 queries of a tile (64 registers more) used 207-218 registers at
//   D = 64, so 2 blocks (8 warps) an SM. The 64-query tile is now consumed in
//   two passes of 32 queries and the kernel bounded to 3 blocks an SM at
//   D <= 64 (the ptxas report that chip_smoke.py prints shows registers and
//   spills); PERF.md has both versions' times.
// - #9: #7's block at a single key tile: grid x enumerates (query tile, key
//   tile); each writes its ds tile in fp32, or zeros where the causal skip
//   applies.
// The per-element masks run only on tiles that cross the diagonal or an edge,
// or carry a bias or segments, as in the forward.
//
// fp32, and bf16 at other head widths, run on the FP32 pipes: #7 / #9 as a
// block of 8 warps owning 32 query rows (4 a warp) over 32-key tiles (a lane
// owns a key for the scores, 32-column slices of dq for ds . k, with ds
// broadcast by shuffles); #8 as a block of 8 warps owning 32 keys over
// 32-query tiles, mirrored. Tiles are staged transposed with an odd pitch.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using mm::from_f;
using mm::to_f;

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out0;  // dq (#7), dk (#8), dbias (#9)
  void* out1;  // dv (#8)
  long long qs[3], ks[3], vs[3], dos[3];  // batch, head, row strides in elements
  long long o0s[3], o1s[3];
  const float* bias;
  long long bs[4];  // bias strides (batch, head, row, key); 0 on broadcast dims
  const int* qseg;
  const int* kvseg;
  long long qseg_b, kvseg_b;  // batch strides of the segment ids (row stride 1)
  const float* lse;    // (B, H, Sq) log2 space
  const float* delta;  // (B, H, Sq)
  int B, H, Sq, Sk;
  float scale;
  float scale_log2;  // scale * log2(e)
  int causal;
};

__device__ __forceinline__ bool visible(const Args& a, int b, int i, int j) {
  if (a.causal && j > i + (a.Sk - a.Sq)) return false;
  if (a.qseg && a.qseg[b * a.qseg_b + i] != a.kvseg[b * a.kvseg_b + j]) return false;
  return true;
}

__device__ __forceinline__ float bias_at(const Args& a, int b, int h, int i, int j) {
  return a.bias[b * a.bs[0] + h * a.bs[1] + i * a.bs[2] + j * a.bs[3]] * kLog2e;
}

// The row's lse with -inf (a row that sees no key) and rows past Sq made
// +inf, so that exp2(s2 - lse) is 0 there without a select.
__device__ __forceinline__ float row_lse(const Args& a, long long bh, int i) {
  if (i >= a.Sq) return INFINITY;
  const float l = a.lse[bh * a.Sq + i];
  return l == -INFINITY ? INFINITY : l;
}

__device__ __forceinline__ float row_delta(const Args& a, long long bh, int i) {
  return i < a.Sq ? a.delta[bh * a.Sq + i] : 0.f;
}

// Key tiles [0, n) that query rows [q0, q0 + rows) can see.
__device__ __forceinline__ int key_tiles(const Args& a, int q0, int rows, int tile) {
  int n = (a.Sk + tile - 1) / tile;
  if (a.causal) {
    const int last_key = min(a.Sq, q0 + rows) - 1 + (a.Sk - a.Sq);
    n = last_key < 0 ? 0 : min(n, last_key / tile + 1);
  }
  return n;
}

// The first query tile that can see a key of [k0, ...): the first row i with
// k0 <= i + Sk - Sq. Returns the number of query tiles when none can.
__device__ __forceinline__ int first_query_tile(const Args& a, int k0, int tile) {
  const int nq = (a.Sq + tile - 1) / tile;
  if (!a.causal) return 0;
  const int i0 = k0 - (a.Sk - a.Sq);
  if (i0 >= a.Sq) return nq;
  return max(i0, 0) / tile;
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 at head width 32, 64 or 128.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // #7: query rows a block owns; #8: keys a block owns
constexpr int kBK = 64;           // #7: keys a tile holds

template <int D>
struct Pitch {
  static constexpr int kP = D + 8;  // bf16 row pitch: conflict-free ldmatrix
};

// Copy `rows` rows of width D (bf16) from `src` (row stride `rs`) into `dst`;
// rows at or past `n` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int rows, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kWarps * 32) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool in = r < n;
    mm::cp_async16(dst + r * Pitch<D>::kP + c, in ? src + r * rs + c : src, in ? 16 : 0);
  }
}

// acc (16 x 8 NT) = A (16 x D) . B (8 NT x D)^T, A's 16 rows and B's 8 NT
// rows in shared memory at pitch D + 8. acc[nt] holds columns 8 nt + 2 t4, +1
// of rows g and g + 8 (g = lane / 4, t4 = lane % 4).
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int P = Pitch<D>::kP;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    mm::ldsm_x4(af, a + (lane & 15) * P + 16 * kd + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      mm::ldsm_x4(bf, b + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * P + 16 * kd +
                          ((lane >> 3) & 1) * 8);
      mm::mma_bf16(acc[2 * j], af, bf[0], bf[1]);
      mm::mma_bf16(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// o (16 x D) += bf16(x) (16 x 8 NT) . B (8 NT x D): x in mma_abt's
// accumulator layout is the A fragment; B (shared memory, pitch D + 8) by
// ldmatrix.trans.
template <int D, int NT>
__device__ __forceinline__ void mma_xb(float (&o)[D / 8][4], const float (&x)[NT][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int P = Pitch<D>::kP;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t xa[4];
    xa[0] = mm::pack_bf16(x[2 * j][0], x[2 * j][1]);
    xa[1] = mm::pack_bf16(x[2 * j][2], x[2 * j][3]);
    xa[2] = mm::pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    xa[3] = mm::pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t bv[4];
      mm::ldsm_x4_trans(bv, b + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * P + 8 * dt +
                                (lane >> 4) * 8);
      mm::mma_bf16(o[dt], xa, bv[0], bv[1]);
      mm::mma_bf16(o[dt + 1], xa, bv[2], bv[3]);
    }
  }
}

// Write a warp's 16 x D fp32 accumulator (rows r0, r0 + 8 of this lane) times
// `mul` as bf16 rows of `dst` (row stride rs), rows at or past n skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long rs, const float (&acc)[D / 8][4],
                                           int r0, int n, float mul, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + 8 * r;
    if (i >= n) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * rs + 8 * dt + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * r] * mul, acc[dt][2 * r + 1] * mul);
  }
}

// #7 (kDbias = false) and #9 (kDbias = true).
template <int D, bool kDbias>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_mma_kernel(Args a) {
  constexpr int P = Pitch<D>::kP;
  constexpr int kElems = 64 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qsm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dosm = qsm + kElems;
  __nv_bfloat16* kbuf = dosm + kElems;      // [2][64][P]
  __nv_bfloat16* vbuf = kbuf + 2 * kElems;  // [2][64][P]

  const int nk = (a.Sk + kBK - 1) / kBK;
  const int qt = kDbias ? blockIdx.x / nk : blockIdx.x;
  const int q0 = qt * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int off = a.Sk - a.Sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // rows of this lane: row0 and row0 + 8

  int t_begin = 0, t_end = key_tiles(a, q0, kBQ, kBK);
  if (kDbias) {
    const int kt = blockIdx.x - qt * nk;
    if (kt >= t_end) {  // the causal skip: this tile of ds is zero
      float* dst = static_cast<float*>(a.out0) + bh * a.Sq * (long long)a.Sk;
      for (int idx = threadIdx.x; idx < kBQ * kBK; idx += kWarps * 32) {
        const int i = q0 + idx / kBK, j = kt * kBK + idx % kBK;
        if (i < a.Sq && j < a.Sk) dst[(long long)i * a.Sk + j] = 0.f;
      }
      return;
    }
    t_begin = kt;
    t_end = kt + 1;
  }

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2];
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos[0] + h * a.dos[1] + q0 * a.dos[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + h * a.vs[1];

  load_tile<D>(qsm, qg, a.qs[2], 64, a.Sq - q0);
  load_tile<D>(dosm, dog, a.dos[2], 64, a.Sq - q0);
  if (t_end > t_begin) {
    const int k0 = t_begin * kBK;
    load_tile<D>(kbuf, kg + k0 * a.ks[2], a.ks[2], 64, a.Sk - k0);
    load_tile<D>(vbuf, vg + k0 * a.vs[2], a.vs[2], 64, a.Sk - k0);
  }
  mm::cp_async_commit();

  const int rows[2] = {row0, row0 + 8};
  const float lse[2] = {row_lse(a, bh, rows[0]), row_lse(a, bh, rows[1])};
  const float delta[2] = {row_delta(a, bh, rows[0]), row_delta(a, bh, rows[1])};

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const int k1 = (t + 1) * kBK;
      load_tile<D>(kbuf + (st ^ 1) * kElems, kg + k1 * a.ks[2], a.ks[2], 64, a.Sk - k1);
      load_tile<D>(vbuf + (st ^ 1) * kElems, vg + k1 * a.vs[2], a.vs[2], 64, a.Sk - k1);
      mm::cp_async_commit();
      mm::cp_async_wait<1>();
    } else {
      mm::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kbuf + st * kElems;
    const __nv_bfloat16* vs = vbuf + st * kElems;
    const int k0 = t * kBK;

    float sc[kBK / 8][4], dp[kBK / 8][4];
    mma_abt<D, kBK / 8>(sc, qsm + 16 * warp * P, ks, lane);
    mma_abt<D, kBK / 8>(dp, dosm + 16 * warp * P, vs, lane);

    const bool whole = !a.bias && !a.qseg && q0 + kBQ <= a.Sq && k0 + kBK <= a.Sk &&
                       (!a.causal || k0 + kBK - 1 <= q0 + off);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1];
        const int j = k0 + 8 * nt + 2 * t4 + (e & 1);
        float s = sc[nt][e] * a.scale_log2;
        if (!whole) {
          if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
            if (a.bias) s += bias_at(a, b, h, i, j);
          } else {
            s = -INFINITY;
          }
        }
        const float p = exp2f(s - lse[e >> 1]);
        sc[nt][e] = p * (dp[nt][e] - delta[e >> 1]);  // ds
      }

    if (kDbias) {
      float* dst = static_cast<float*>(a.out0) + bh * a.Sq * (long long)a.Sk;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e >> 1];
          const int j = k0 + 8 * nt + 2 * t4 + (e & 1);
          if (i < a.Sq && j < a.Sk) dst[(long long)i * a.Sk + j] = sc[nt][e];
        }
    } else {
      mma_xb<D, kBK / 8>(dq, sc, ks, lane);  // dq += bf16(ds) . k
    }
    __syncthreads();  // the next iteration refills this stage
  }
  mm::cp_async_wait<0>();  // no copy outlives the block

  if (!kDbias) {
    __nv_bfloat16* dqg =
        static_cast<__nv_bfloat16*>(a.out0) + b * a.o0s[0] + h * a.o0s[1];
    store_rows<D>(dqg, a.o0s[2], dq, row0, a.Sq, a.scale, t4);
  }
}

// #8. QT: query rows a staged tile holds; QH: query columns of p^T and ds^T
// held in registers at a time. minBlocks: 3 at D <= 64 (12 warps an SM, at
// most 170 registers a thread), 2 at D = 128 (shared memory allows no more).
template <int D, int QT, int QH>
__global__ void __launch_bounds__(kWarps * 32, D <= 64 ? 3 : 2)
    flash_bwd_dkv_mma_kernel(Args a) {
  constexpr int P = Pitch<D>::kP;
  constexpr int kKElems = 64 * P;
  constexpr int kQElems = QT * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ksm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vsm = ksm + kKElems;
  __nv_bfloat16* qbuf = vsm + kKElems;         // [2][QT][P]
  __nv_bfloat16* dobuf = qbuf + 2 * kQElems;   // [2][QT][P]
  float* lbuf = reinterpret_cast<float*>(dobuf + 2 * kQElems);  // [2][QT] lse
  float* dbuf = lbuf + 2 * QT;                                  // [2][QT] delta

  const int k0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int off = a.Sk - a.Sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int key0 = k0 + 16 * warp + g;  // keys of this lane: key0 and key0 + 8
  const int keys[2] = {key0, key0 + 8};

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(a.dout) + b * a.dos[0] + h * a.dos[1];
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + h * a.ks[1] + k0 * a.ks[2];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + h * a.vs[1] + k0 * a.vs[2];

  const int nq = (a.Sq + QT - 1) / QT;
  const int t_begin = first_query_tile(a, k0, QT);

  auto stage = [&](int t, int st) {
    const int q0 = t * QT;
    load_tile<D>(qbuf + st * kQElems, qg + q0 * a.qs[2], a.qs[2], QT, a.Sq - q0);
    load_tile<D>(dobuf + st * kQElems, dog + q0 * a.dos[2], a.dos[2], QT, a.Sq - q0);
    for (int r = threadIdx.x; r < QT; r += kWarps * 32) {
      lbuf[st * QT + r] = row_lse(a, bh, q0 + r);
      dbuf[st * QT + r] = row_delta(a, bh, q0 + r);
    }
  };

  load_tile<D>(ksm, kg, a.ks[2], 64, a.Sk - k0);
  load_tile<D>(vsm, vg, a.vs[2], 64, a.Sk - k0);
  if (t_begin < nq) stage(t_begin, 0);
  mm::cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  for (int t = t_begin; t < nq; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < nq) {
      stage(t + 1, st ^ 1);
      mm::cp_async_commit();
      mm::cp_async_wait<1>();
    } else {
      mm::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qs = qbuf + st * kQElems;
    const __nv_bfloat16* dos = dobuf + st * kQElems;
    const float* ls = lbuf + st * QT;
    const float* ds_ = dbuf + st * QT;
    const int q0 = t * QT;

    const bool whole = !a.bias && !a.qseg && q0 + QT <= a.Sq && k0 + kBQ <= a.Sk &&
                       (!a.causal || k0 + kBQ - 1 <= q0 + off);
#pragma unroll
    for (int hq = 0; hq < QT; hq += QH) {
      // p^T: rows are this warp's keys, columns the queries hq.. of the tile.
      float pt[QH / 8][4];
      mma_abt<D, QH / 8>(pt, ksm + 16 * warp * P, qs + hq * P, lane);
#pragma unroll
      for (int nt = 0; nt < QH / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hq + 8 * nt + 2 * t4 + (e & 1);  // query within the tile
          const int i = q0 + c;
          const int j = keys[e >> 1];
          float s = pt[nt][e] * a.scale_log2;
          if (!whole) {
            if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
              if (a.bias) s += bias_at(a, b, h, i, j);
            } else {
              s = -INFINITY;
            }
          }
          pt[nt][e] = exp2f(s - ls[c]);
        }
      mma_xb<D, QH / 8>(dv, pt, dos + hq * P, lane);  // dv += bf16(p^T) . do

      float dpt[QH / 8][4];
      mma_abt<D, QH / 8>(dpt, vsm + 16 * warp * P, dos + hq * P, lane);
#pragma unroll
      for (int nt = 0; nt < QH / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - ds_[hq + 8 * nt + 2 * t4 + (e & 1)]);  // ds^T
      mma_xb<D, QH / 8>(dk, dpt, qs + hq * P, lane);  // dk += bf16(ds^T) . q
    }
    __syncthreads();  // the next iteration refills this stage
  }
  mm::cp_async_wait<0>();

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.out0) + b * a.o0s[0] + h * a.o0s[1];
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.out1) + b * a.o1s[0] + h * a.o1s[1];
  store_rows<D>(dkg, a.o0s[2], dk, key0, a.Sk, a.scale, t4);
  store_rows<D>(dvg, a.o1s[2], dv, key0, a.Sk, 1.f, t4);
}

template <int D>
constexpr size_t dq_smem() {
  return 6 * 64 * Pitch<D>::kP * sizeof(__nv_bfloat16);  // Q, dO, 2 x (K, V)
}

template <int D, int QT>
constexpr size_t dkv_smem() {
  return (2 * 64 + 4 * QT) * Pitch<D>::kP * sizeof(__nv_bfloat16) + 4 * QT * sizeof(float);
}

template <int D>
cudaError_t launch_mma(int which, const Args& a, cudaStream_t stream) {
  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int nk = (a.Sk + kBK - 1) / kBK;
  if (which == 1) {
    auto kernel = flash_bwd_dkv_mma_kernel<D, 64, 32>;
    const size_t smem = dkv_smem<D, 64>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(nk, a.H, a.B), kWarps * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
  auto kernel = which == 0 ? flash_bwd_dq_mma_kernel<D, false> : flash_bwd_dq_mma_kernel<D, true>;
  const size_t smem = dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(which == 0 ? nq : nq * nk, a.H, a.B), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FP32-pipe path: fp32, and bf16 at other head widths (D % 8 == 0, D <= 128).
// ---------------------------------------------------------------------------

constexpr int kFWarps = 8;
constexpr int kFRows = 4;               // rows (#7 / #9: queries, #8: keys) a warp carries
constexpr int kFB = kFWarps * kFRows;   // rows a block owns
constexpr int kFT = 32;                 // columns a tile holds: one a lane
constexpr int kTP = kFT + 1;            // pitch of a transposed tile

__host__ __device__ inline int fp32_smem_floats(int D) {
  return 2 * D * kTP + 2 * kFB * D + 2 * kFT;  // two transposed tiles, two row tiles, lse, delta
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// #7 (kDbias = false) and #9 (kDbias = true): a warp's 4 query rows, a lane's
// key of the 32-key tile.
template <typename T, int NC, bool kDbias>
__global__ void __launch_bounds__(kFWarps * 32) flash_bwd_dq_fp32_kernel(Args a, int D) {
  extern __shared__ __align__(16) float fsm[];
  float* kt = fsm;              // [D][kTP]  K^T of the tile
  float* vt = kt + D * kTP;     // [D][kTP]  V^T of the tile
  float* qsm = vt + D * kTP;    // [kFB][D]
  float* dosm = qsm + kFB * D;  // [kFB][D]

  const int nk = (a.Sk + kFT - 1) / kFT;
  const int qt = kDbias ? blockIdx.x / nk : blockIdx.x;
  const int q0 = qt * kFB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = q0 + warp * kFRows;

  int t_begin = 0, t_end = key_tiles(a, q0, kFB, kFT);
  if (kDbias) {
    const int ktile = blockIdx.x - qt * nk;
    if (ktile >= t_end) {
      float* dst = static_cast<float*>(a.out0) + bh * a.Sq * (long long)a.Sk;
      const int j = ktile * kFT + lane;
      for (int r = 0; r < kFRows; ++r)
        if (i0 + r < a.Sq && j < a.Sk) dst[(long long)(i0 + r) * a.Sk + j] = 0.f;
      return;
    }
    t_begin = ktile;
    t_end = ktile + 1;
  }

  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* dog = static_cast<const T*>(a.dout) + b * a.dos[0] + h * a.dos[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  for (int idx = threadIdx.x; idx < kFB * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const bool in = q0 + r < a.Sq;
    qsm[idx] = in ? to_f(qg[(q0 + r) * a.qs[2] + c]) : 0.f;
    dosm[idx] = in ? to_f(dog[(q0 + r) * a.dos[2] + c]) : 0.f;
  }
  float lse[kFRows], delta[kFRows], dq[kFRows][NC];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    lse[r] = row_lse(a, bh, i0 + r);
    delta[r] = row_delta(a, bh, i0 + r);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dq[r][cc] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kFT;
    __syncthreads();  // the previous tile is consumed (and Q, dO are staged)
    for (int idx = threadIdx.x; idx < kFT * D; idx += blockDim.x) {
      const int j = idx / D;
      const int c = idx - j * D;
      const bool in = k0 + j < a.Sk;
      kt[c * kTP + j] = in ? to_f(kg[(k0 + j) * a.ks[2] + c]) : 0.f;
      vt[c * kTP + j] = in ? to_f(vg[(k0 + j) * a.vs[2] + c]) : 0.f;
    }
    __syncthreads();

    float s[kFRows], dp[kFRows];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float kv[4], vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        kv[u] = kt[(c + u) * kTP + lane];
        vv[u] = vt[(c + u) * kTP + lane];
      }
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qsm + (warp * kFRows + r) * D + c);
        const float4 d4 = *reinterpret_cast<const float4*>(dosm + (warp * kFRows + r) * D + c);
        s[r] = fmaf(q4.x, kv[0], fmaf(q4.y, kv[1], fmaf(q4.z, kv[2], fmaf(q4.w, kv[3], s[r]))));
        dp[r] = fmaf(d4.x, vv[0], fmaf(d4.y, vv[1], fmaf(d4.z, vv[2], fmaf(d4.w, vv[3], dp[r]))));
      }
    }

    const int j = k0 + lane;
    float ds[kFRows];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const int i = i0 + r;
      float sv = -INFINITY;
      if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
        sv = s[r] * a.scale_log2;
        if (a.bias) sv += bias_at(a, b, h, i, j);
      }
      const float p = exp2f(sv - lse[r]);
      ds[r] = p * (dp[r] - delta[r]);
    }
    if (kDbias) {
      float* dst = static_cast<float*>(a.out0) + bh * a.Sq * (long long)a.Sk;
#pragma unroll
      for (int r = 0; r < kFRows; ++r)
        if (i0 + r < a.Sq && j < a.Sk) dst[(long long)(i0 + r) * a.Sk + j] = ds[r];
    } else {
#pragma unroll
      for (int r = 0; r < kFRows; ++r) ds[r] = round_to<T>(ds[r]);
      for (int jj = 0; jj < kFT; ++jj) {
#pragma unroll
        for (int r = 0; r < kFRows; ++r) {
          const float dsj = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            if (32 * cc + lane < D)
              dq[r][cc] = fmaf(dsj, kt[(32 * cc + lane) * kTP + jj], dq[r][cc]);
        }
      }
    }
  }

  if (!kDbias) {
    T* dqg = static_cast<T*>(a.out0) + b * a.o0s[0] + h * a.o0s[1];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const int i = i0 + r;
      if (i >= a.Sq) break;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = 32 * cc + lane;
        if (c < D) dqg[i * a.o0s[2] + c] = from_f<T>(dq[r][cc] * a.scale);
      }
    }
  }
}

// #8: a warp's 4 keys, a lane's query of the 32-query tile.
template <typename T, int NC>
__global__ void __launch_bounds__(kFWarps * 32) flash_bwd_dkv_fp32_kernel(Args a, int D) {
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;               // [D][kTP]  Q^T of the tile
  float* dot = qt + D * kTP;     // [D][kTP]  dO^T of the tile
  float* ksm = dot + D * kTP;    // [kFB][D]
  float* vsm = ksm + kFB * D;    // [kFB][D]
  float* lsm = vsm + kFB * D;    // [kFT]
  float* dsm = lsm + kFT;        // [kFT]

  const int k0 = blockIdx.x * kFB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = k0 + warp * kFRows;

  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* dog = static_cast<const T*>(a.dout) + b * a.dos[0] + h * a.dos[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[1];
  for (int idx = threadIdx.x; idx < kFB * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const bool in = k0 + r < a.Sk;
    ksm[idx] = in ? to_f(kg[(k0 + r) * a.ks[2] + c]) : 0.f;
    vsm[idx] = in ? to_f(vg[(k0 + r) * a.vs[2] + c]) : 0.f;
  }
  float dk[kFRows][NC], dv[kFRows][NC];
#pragma unroll
  for (int r = 0; r < kFRows; ++r)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dk[r][cc] = dv[r][cc] = 0.f;

  const int nq = (a.Sq + kFT - 1) / kFT;
  for (int t = first_query_tile(a, k0, kFT); t < nq; ++t) {
    const int q0 = t * kFT;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFT * D; idx += blockDim.x) {
      const int i = idx / D;
      const int c = idx - i * D;
      const bool in = q0 + i < a.Sq;
      qt[c * kTP + i] = in ? to_f(qg[(q0 + i) * a.qs[2] + c]) : 0.f;
      dot[c * kTP + i] = in ? to_f(dog[(q0 + i) * a.dos[2] + c]) : 0.f;
    }
    if (threadIdx.x < kFT) {
      lsm[threadIdx.x] = row_lse(a, bh, q0 + threadIdx.x);
      dsm[threadIdx.x] = row_delta(a, bh, q0 + threadIdx.x);
    }
    __syncthreads();

    float s[kFRows], dp[kFRows];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float qv[4], dv4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qv[u] = qt[(c + u) * kTP + lane];
        dv4[u] = dot[(c + u) * kTP + lane];
      }
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        const float4 k4 = *reinterpret_cast<const float4*>(ksm + (warp * kFRows + r) * D + c);
        const float4 v4 = *reinterpret_cast<const float4*>(vsm + (warp * kFRows + r) * D + c);
        s[r] = fmaf(k4.x, qv[0], fmaf(k4.y, qv[1], fmaf(k4.z, qv[2], fmaf(k4.w, qv[3], s[r]))));
        dp[r] = fmaf(v4.x, dv4[0], fmaf(v4.y, dv4[1], fmaf(v4.z, dv4[2], fmaf(v4.w, dv4[3], dp[r]))));
      }
    }

    const int i = q0 + lane;
    float p[kFRows], ds[kFRows];
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const int j = j0 + r;
      float sv = -INFINITY;
      if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
        sv = s[r] * a.scale_log2;
        if (a.bias) sv += bias_at(a, b, h, i, j);
      }
      const float pv = exp2f(sv - lsm[lane]);
      ds[r] = round_to<T>(pv * (dp[r] - dsm[lane]));
      p[r] = round_to<T>(pv);
    }
    for (int ii = 0; ii < kFT; ++ii) {
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        const float pi = __shfl_sync(0xffffffffu, p[r], ii);
        const float dsi = __shfl_sync(0xffffffffu, ds[r], ii);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = 32 * cc + lane;
          if (c < D) {
            dv[r][cc] = fmaf(pi, dot[c * kTP + ii], dv[r][cc]);
            dk[r][cc] = fmaf(dsi, qt[c * kTP + ii], dk[r][cc]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.out0) + b * a.o0s[0] + h * a.o0s[1];
  T* dvg = static_cast<T*>(a.out1) + b * a.o1s[0] + h * a.o1s[1];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    const int j = j0 + r;
    if (j >= a.Sk) break;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = 32 * cc + lane;
      if (c < D) {
        dkg[j * a.o0s[2] + c] = from_f<T>(dk[r][cc] * a.scale);
        dvg[j * a.o1s[2] + c] = from_f<T>(dv[r][cc]);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch_fp32(int which, const Args& a, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)fp32_smem_floats(D);
  const int nq = (a.Sq + kFB - 1) / kFB;
  const int nk = (a.Sk + kFT - 1) / kFT;
  if (which == 1) {
    auto kernel = flash_bwd_dkv_fp32_kernel<T, NC>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((a.Sk + kFB - 1) / kFB, a.H, a.B), kFWarps * 32, smem, stream>>>(a, D);
    return cudaGetLastError();
  }
  auto kernel =
      which == 0 ? flash_bwd_dq_fp32_kernel<T, NC, false> : flash_bwd_dq_fp32_kernel<T, NC, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(which == 0 ? nq : nq * nk, a.H, a.B), kFWarps * 32, smem, stream>>>(a, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fp32(int which, const Args& a, int D, cudaStream_t stream) {
  if (D <= 32) return launch_fp32<T, 1>(which, a, D, stream);
  if (D <= 64) return launch_fp32<T, 2>(which, a, D, stream);
  if (D <= 96) return launch_fp32<T, 3>(which, a, D, stream);
  return launch_fp32<T, 4>(which, a, D, stream);
}

}  // namespace

extern "C" {

// which: 0 = dq (#7; out0 dq), 1 = dk and dv (#8; out0 dk, out1 dv), 2 = the
// full fp32 (B, H, Sq, Sk) bias gradient ds (#9; out0, contiguous).
// q, do (B, H, Sq, D), k, v (B, H, Sk, D) and the bf16/fp32 outputs, all of
// `dtype` (0 = fp32, 1 = bf16) with the last dimension contiguous; in_strides
// holds the batch, head and row strides (in elements, 16-byte aligned rows)
// of q, k, v and do, out_strides those of out0 and out1. bias: fp32 with
// strides bias_strides (0 on broadcast dims) or null. qseg (B, Sq) / kvseg
// (B, Sk) int32 with batch strides, both or neither. lse (log2 space) and
// delta: (B, H, Sq) fp32 contiguous. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
int mm_flash_attention_bwd(int which, const void* q, const void* k, const void* v,
                           const void* dout, void* out0, void* out1,
                           const long long* in_strides, const long long* out_strides,
                           const void* bias, const long long* bias_strides, const void* qseg,
                           long long qseg_b, const void* kvseg, long long kvseg_b,
                           const void* lse, const void* delta, int B, int H, int Sq, int Sk,
                           int D, float sm_scale, int causal, int dtype, void* stream) {
  if (which < 0 || which > 2 || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D % 8 != 0 || D > 128 || (dtype != 0 && dtype != 1) ||
      ((qseg == nullptr) != (kvseg == nullptr)) || (which == 1 && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out0 = out0;
  a.out1 = out1;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = in_strides[i];
    a.ks[i] = in_strides[3 + i];
    a.vs[i] = in_strides[6 + i];
    a.dos[i] = in_strides[9 + i];
    a.o0s[i] = out_strides[i];
    a.o1s[i] = out_strides[3 + i];
  }
  a.bias = static_cast<const float*>(bias);
  for (int i = 0; i < 4; ++i) a.bs[i] = bias ? bias_strides[i] : 0;
  a.qseg = static_cast<const int*>(qseg);
  a.kvseg = static_cast<const int*>(kvseg);
  a.qseg_b = qseg_b;
  a.kvseg_b = kvseg_b;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = sm_scale;
  a.scale_log2 = sm_scale * kLog2e;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_fp32<float>(which, a, D, st);
  if (D == 32) return (int)launch_mma<32>(which, a, st);
  if (D == 64) return (int)launch_mma<64>(which, a, st);
  if (D == 128) return (int)launch_mma<128>(which, a, st);
  return (int)dispatch_fp32<__nv_bfloat16>(which, a, D, st);
}

}  // extern "C"
