// Flash attention backward (blockwise, probabilities recomputed from the
// forward's log2-space lse), for Hopper.
//
// Replaces: multimodal_tpu/ops/flash_attention.py, `_flash_backward`'s three
// kernel bodies: `_bwd_dq_kernel` (#7, its pallas_call at :625) and
// `_bwd_dkv_kernel` (#8, :650), both here flash_bwd_wgmma_kernel<D> in bf16
// at head widths 64 and 96, and `_bwd_dbias_kernel` (#9, :679, here
// flash_bwd_dbias_kernel<D, BIAS> in bf16 at head widths 32, 64 and 96).
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
// (8, 12, 8192, 64) bf16 causal there are 3.22e9 visible pairs, and the
// function needs five products over them (s, dp, dv, dk, dq: 10 * 64 FLOPs
// a pair, 2.06 TFLOP, 2.085 ms at 989 TF/s), against 0.7 GB of q, k, v, do,
// dq, dk and dv (0.2 ms at 3.35 TB/s). The TPU's split into a dq kernel and
// a dk/dv kernel computes s and dp in both, seven products (2.92 ms): no
// split design can reach the library's backward. #9 writes the fp32 (Sq, Sk)
// matrix and so is bound by bytes (25.8 GB, 7.7 ms at that shape).
//
// Design, bf16 at head width 64 (flash_bwd_wgmma_kernel<64>): one block of two
// warpgroups per (128-key block, head, batch), 64 keys a warpgroup; blocks
// of a head are numbered from key block 0, which under the causal mask sees
// the most query tiles, so the longest start first. Thread 0 loads the
// block's K and V once by TMA and streams q and do (64-query tiles, 64 x 64
// boxes with the 128-byte swizzle) and the tile's lse and delta (bulk
// copies of rows that a small kernel pads first: a row that sees no key or
// lies past Sq gets lse +inf, so p = 0 there) through a ring of three
// stages, two tiles ahead, each stage guarded by an mbarrier. A stage is
// refilled after the per-tile named barrier of both warpgroups, which
// follows their last reads of it. Each warpgroup keeps its K and V as
// register A fragments and, per query tile (M = its 64 keys), runs the
// five products on `wgmma` (csrc/wgmma_gemm.cuh):
//   1. s^T = K q^T and 2. dp^T = V do^T, q and do from shared memory; then
//   p^T and ds^T in fp32 in registers (the per-element masks only on tiles
//   that cross the diagonal or an edge, or carry a bias or segments);
//   3. dv += T(p^T) do and 4. dk += T(ds^T) q with A from registers: the
//   accumulator layout, rounded and packed, is the A fragment;
//   5. the block's part of dq = T(ds) K over its 128 keys: each warpgroup
//   writes T(ds^T) once into shared memory in the swizzled layout (two
//   buffers by tile parity), the warpgroups meet at a named barrier, and
//   each computes 32 of dq's 64 columns from both halves (A = ds and B = K,
//   both MN-major).
// dv/dk of tile t, s/dp of t + 1 and dq of t are in flight together; a
// tile starts by waiting for all of them, since ptxas serializes the
// products (C7515) if ordinary instructions write their registers while
// any is in flight. dq's part, 64 x 64 fp32, then goes through shared
// memory to a TMA reduction (cp.reduce.async.bulk.tensor .add) into an
// fp32 (B H, Sq, 64) workspace that the entry point zero-fills on the
// stream first; a last kernel writes dq = T(scale * workspace). dk and dv
// stay in registers across the block's query tiles and are written once.
// The sum over key blocks into the workspace runs in no fixed order, so dq
// is not bitwise repeatable from launch to launch (as with the library's
// flash backward); dk and dv are each owned by one block and are. Rows
// that see no key get dq = 0. There is no producer warp: a tenth warp
// would put three warps on one of the SM's four sub-partitions and cap
// every thread at 168 registers, and ptxas does not lift that cap after
// `setmaxnreg`; two warpgroups get 246. At (8, 12, 8192, 64) bf16 causal
// the call takes 5.84 ms against the 2.085 ms bound and the library's
// 4.79 (H100 80GB HBM3, 700.00 W; PERF.md).
//
// At head width 96 (flash_bwd_wgmma_kernel<96>, CoCa's attention pooler)
// the same pass, shaped by three limits. Registers: dk and dv take 96 of a
// thread's, so K and V stay in shared memory as the A operands of s^T and
// dp^T (their fragments would add 48, past 255), and dk takes T(ds^T) from
// the buffer dq reads, issued with dq after the barrier, so only p^T's
// fragments stay in registers. The swizzle: a 192-byte row is past the
// 128-byte swizzle, so K, V, q and do are 32-column chunks of 64-byte rows
// in the 64-byte swizzle (TMA boxes of 64 rows x 32 columns; the products'
// descriptors step through the chunks), while T(ds^T) keeps its 128-byte
// rows. dq's split: 96 columns do not halve into whole 32-column chunks, so
// warpgroup 0 computes columns 0-63 and warpgroup 1 64-95 with the same
// m64n64 products (its other 32 columns read V's first chunk and are
// dropped): products issued under a branch on the warpgroup would be
// serialized. Its fp32 part goes out in 32-column boxes, the workspace
// (B H, Sq, 96). Shared memory: K and V 48 KB, three stages of q and do
// 72 KB, T(ds^T) 32 KB, dq's boxes 48 KB: 200 KB (a fourth stage would pass
// 227 KB). 240 registers, no spills. At CoCa's pooler (32, 8, 256, 256, 96)
// the call takes 0.095 device ms (the kernel 0.079; the FP32 pipes took
// 1.75-1.78) against the 0.026 ms bound and SDPA's backward 0.101; the
// 64 + 32 split by a branch made ptxas serialize the products (C7519,
// C7520) and ran 12% slower (H100 80GB HBM3, 700.00 W; PERF.md).
//
// #9 in bf16 at head width 32, 64 or 96 (flash_bwd_dbias_kernel<D, BIAS>):
// bound by bytes, the fp32 (B, H, Sq, Sk) ds it writes (25.8 GB at (8, 12,
// 8192, 64) causal, 7.7 ms at 3.35 TB/s, against 0.83 ms of products and
// about 0.85 ms of `ex2`), so its design keeps the store stream full. One
// block of two warpgroups per (128-query tile, head, batch), 64 query rows
// a warpgroup, walks the key tiles (64 keys) that any of its rows sees:
// thread 0 loads Q and dO once by TMA and K and V through a ring of four
// stages (three at D = 96), refilled by the last of the eight warps done
// with a stage (as the forward's). Per tile a warpgroup issues S = Q K^T
// and dP = dO V^T (`wgmma` m64n64k16, D / 16 k-steps each, fp32), forms
// ds = p (dp - delta), p = exp2(s2 - lse), in registers (masks only on the
// tiles that cross the diagonal or carry segment ids; the bias read through
// its strides before the products), writes it into one of its two staging
// buffers in the 128-byte swizzle of 64 x 32 fp32 boxes, and two TMA stores
// (cp.async.bulk.tensor, a bulk group a tile) stream it out while the next
// tile's products run; a buffer is written again once its stores have read
// it (wait_group.read). The tiles wholly above the causal diagonal load and
// multiply nothing: each warpgroup stores them from one zeroed box, so no
// separate fill writes the bytes twice. ds's rows are padded to a multiple
// of 4 floats (TMA's 16-byte strides; the wrapper returns the [..., :Sk]
// view), and the store's map clips the ragged edges, so padded keys and
// rows need no mask. 110-147 registers, no spills, one block an SM (168 KB
// of shared memory at D = 64). At (8, 12, 8192, 64) causal with an ALiBi
// (1, H, 1, S) bias it takes 9.99 ms against the 7.815 ms bound (78%;
// the `mma.sync` tiles it replaced took 22.44) and the library's 74.99 (SDPA's
// memory-efficient backward with a differentiable mask; H100 80GB HBM3,
// 700.00 W; PERF.md).
//
// Other routes, chosen by type and head width, never after a failure:
// - bf16 at head width 32 or 128: `mma.sync` m16n8k16, fragments by
//   `ldmatrix` (at 128 the dk and dv accumulators alone would take 128
//   registers of a consumer thread). #7 is one block of 4 warps per
//   (64-query tile, head, batch), each warp 16 query rows with its scores,
//   dp and fp32 dq accumulator in registers, K and V tiles double-buffered
//   by cp.async; #8 is one block of 4 warps per (64-key tile, head, batch),
//   each warp 16 keys with fp32 dk and dv in registers, walking query tiles
//   (two passes of 32 queries) from the first that can see its keys, with
//   the transposed products s^T = k q^T and dp^T = v do^T, so that p^T and
//   ds^T are A fragments in registers.
// - #9 in bf16 at head width 128: #7's `mma.sync` block at a single key
//   tile: grid x enumerates (query tile, key tile); each writes its ds tile
//   in fp32, or zeros where the causal skip applies.
// - fp32, and bf16 at other head widths: the FP32 pipes. #7 / #9 as a block
//   of 8 warps owning 32 query rows (4 a warp) over 32-key tiles (a lane
//   owns a key for the scores, 32-column slices of dq for ds . k, with ds
//   broadcast by shuffles); #8 as a block of 8 warps owning 32 keys over
//   32-query tiles, mirrored. Tiles are staged transposed with an odd pitch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using mm::from_f;
using mm::to_f;

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out0;  // dq (#7), dk (#8 and the one-pass kernel), dbias (#9)
  void* out1;  // dv (#8 and the one-pass kernel)
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
// bf16 at head width 64 or 96: one pass over each key block, `wgmma` + TMA.
// ---------------------------------------------------------------------------

constexpr int kWgKeys = 128;  // keys a block owns: 64 a warpgroup
constexpr int kWgTile = 64;   // queries a ring stage holds
constexpr int kWgThreads = 256;  // two warpgroups; thread 0 issues the copies
constexpr int kBox = 64 * 64 * 2;  // a 64 x 64 bf16 box (128-byte rows); a 64 x 32 fp32 one

// The layout of head width D's tiles. A tile of R rows is D / kCols column
// chunks, each R rows of kRowBytes back to back, each 64 rows of it one TMA
// box. At D = 64 a row is 128 bytes, one chunk in the 128-byte swizzle; a
// 192-byte row at D = 96 is past that swizzle's span, so there it is three
// 32-column chunks of 64-byte rows in the 64-byte swizzle (as the forward's).
template <int D>
struct WgShape;
template <>
struct WgShape<32> {  // #9's kernel only
  static constexpr int kCols = 32;
  static constexpr CUtensorMapSwizzle kMapSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kDq = 16;
  static constexpr int kStages = 3;
};
template <>
struct WgShape<64> {
  static constexpr int kCols = 64;
  static constexpr CUtensorMapSwizzle kMapSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int kDq = 16;  // dq accumulator floats: 64 queries x 32 columns
  static constexpr int kStages = 3;  // ring stages of q and do
};
template <>
struct WgShape<96> {
  static constexpr int kCols = 32;
  static constexpr CUtensorMapSwizzle kMapSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kDq = 32;  // 64 queries x 64 columns
  static constexpr int kStages = 3;  // a fourth would pass 227 KB
};

// Shared memory, from a 1024-byte aligned base, in chunk boxes (64 rows of
// a chunk: kUnit bytes, one kBox at D = 64, half of one at 96): K and V
// (128 rows each), q and do of each stage (64 rows each), T(ds^T) of both
// warpgroups in two buffers (128 keys x 64 queries, 128-byte rows, by tile
// parity), the fp32 dq part in two buffers (a 64 x 32 box a 32-column
// chunk), then each stage's lse and delta (64 floats each) and the
// barriers. (Offsets in units, as (offset + index) * unit, keep the D = 64
// instance's code that of the kernel before D = 96.)
template <int D>
struct Wg : WgShape<D> {
  static constexpr int kRowBytes = 2 * WgShape<D>::kCols;
  static constexpr int kChunks = D / WgShape<D>::kCols;
  static constexpr int kUnit = 64 * kRowBytes;
  static constexpr int kPerBox = kBox / kUnit;  // units of a kBox
  static constexpr int kBoxK = 0;
  static constexpr int kBoxV = 2 * kChunks;
  static constexpr int kBoxQ = 4 * kChunks;
  static constexpr int kBoxDo = kBoxQ + WgShape<D>::kStages * kChunks;
  static constexpr int kBoxDs = kBoxDo + WgShape<D>::kStages * kChunks;
  static constexpr int kBoxDq = kBoxDs + 4 * kPerBox;
  static constexpr int kBoxes = kBoxDq + 2 * (D / 32) * kPerBox;
  static constexpr size_t kSmem = 1024 + (size_t)kBoxes * kUnit +
                                  2 * WgShape<D>::kStages * kWgTile * sizeof(float) +
                                  (WgShape<D>::kStages + 1) * sizeof(uint64_t);
};
static_assert(Wg<64>::kBoxes == 18 && Wg<64>::kUnit == kBox && Wg<96>::kSmem <= 232448,
              "a block's shared memory");

struct WgParams {
  CUtensorMap q, k, v, dout;  // (B, H, S, D) bf16, 64-row boxes of a chunk's columns
  CUtensorMap dq_acc;         // (B H, Sq, D) fp32, 64-row x 32-column boxes
  const float* lse_pad;       // (B H, sq_pad): row_lse, +inf past Sq
  const float* delta_pad;     // (B H, sq_pad): row_delta, 0 past Sq
  int sq_pad;                 // Sq rounded up to the query tile
  Args a;                     // out0 dk, out1 dv
};

// Shared-memory descriptors of 64-row boxes with the 128-byte swizzle (see
// wg::operand_desc): K-major, k-step kk 32 bytes into the rows; MN-major,
// k-step kk 16 rows (2048 bytes) on.
__device__ __forceinline__ uint64_t desc_k(uint32_t box, int kk) {
  return wg::desc(box + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t box, int kk) {
  return wg::desc(box + kk * 2048, kBox, 1024);
}
// Head width 96's, in the 64-byte swizzle (8-row groups of 64-byte rows 512
// bytes apart) of a tile whose chunks hold `rows` rows: K-major, k-step kk
// in chunk kk / 2, 32 bytes into its rows; MN-major, k-step kk 16 rows
// (1024 bytes) on, the chunks `rows` rows apart.
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo) {
  return (wg::desc(addr, lbo, 512) & ~(3ull << 62)) | (2ull << 62);
}
__device__ __forceinline__ uint64_t desc_k96(uint32_t tile, int rows, int kk) {
  return desc64(tile + (kk >> 1) * rows * 64 + (kk & 1) * 32, 16);
}
__device__ __forceinline__ uint64_t desc_mn96(uint32_t tile, int rows, int kk) {
  return desc64(tile + kk * 1024, rows * 64);
}

// Thread 0: the copies of query tile `it` of the block into its stage: q
// and do (a box a chunk each), lse and delta (256 bytes each), reported to
// full.
template <int D>
__device__ __forceinline__ void load_stage(const WgParams& p, uint8_t* sm, float* lse_s,
                                           float* delta_s, uint64_t* full, int it, int t_begin,
                                           int h, int b, long long bh) {
  using L = Wg<D>;
  const int s = it % L::kStages;
  const int q0 = (t_begin + it) * kWgTile;
  wg::bar_expect_tx(&full[s], 2 * L::kChunks * L::kUnit + 2 * kWgTile * sizeof(float));
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
    wg::tma_box_4d(sm + (L::kBoxQ + s * L::kChunks + c) * L::kUnit, &p.q, &full[s],
                   c * L::kCols, q0, h, b);
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
    wg::tma_box_4d(sm + (L::kBoxDo + s * L::kChunks + c) * L::kUnit, &p.dout, &full[s],
                   c * L::kCols, q0, h, b);
  wg::bulk_copy(lse_s + s * kWgTile, p.lse_pad + bh * p.sq_pad + q0, kWgTile * sizeof(float),
                &full[s]);
  wg::bulk_copy(delta_s + s * kWgTile, p.delta_pad + bh * p.sq_pad + q0,
                kWgTile * sizeof(float), &full[s]);
}

// Steps 1 and 2 of query tile `it` of a block: s^T = K q^T and dp^T =
// V do^T (a warpgroup's 64 keys x 64 queries; q and do K-major), issued as
// one group once the tile's stage has landed. At D = 64 K and V are the
// register fragments kf and vf; at D = 96 they are read from shared memory
// (the warpgroup's 64 rows of each chunk): their fragments would take 48
// registers a thread, past the cap beside dk's and dv's 96. The first
// k-step overwrites the accumulators (scale-d 0): no other instruction may
// write registers of a product in flight, or ptxas serializes the
// products.
template <int D>
__device__ __forceinline__ void issue_sdp(float (&st)[32], float (&dpt)[32], uint8_t* sm,
                                          uint64_t* full, int it, const uint32_t (&kf)[4][4],
                                          const uint32_t (&vf)[4][4]) {
  using L = Wg<D>;
  const int s = it % L::kStages;
  wg::bar_wait(&full[s], (it / L::kStages) & 1);
  __syncwarp();  // the warp leaves the poll together: `wgmma` is .aligned
  const uint32_t q_box = wg::smem_u32(sm + (L::kBoxQ + s * L::kChunks) * L::kUnit);
  const uint32_t do_box = wg::smem_u32(sm + (L::kBoxDo + s * L::kChunks) * L::kUnit);
  wg::wgmma_fence();
  if constexpr (D == 64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_m64n64k16_rs<wg::K>(st, kf[kk], desc_k(q_box, kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_m64n64k16_rs<wg::K>(dpt, vf[kk], desc_k(do_box, kk), kk);
  } else {
    const uint32_t k_rows = wg::smem_u32(sm + (L::kBoxK + threadIdx.x / 128) * L::kUnit);
    const uint32_t v_rows = wg::smem_u32(sm + (L::kBoxV + threadIdx.x / 128) * L::kUnit);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_m64n64k16<wg::K, wg::K>(st, desc_k96(k_rows, kWgKeys, kk),
                                      desc_k96(q_box, kWgTile, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_m64n64k16<wg::K, wg::K>(dpt, desc_k96(v_rows, kWgKeys, kk),
                                      desc_k96(do_box, kWgTile, kk), kk);
  }
  wg::wgmma_commit();
}

// A warpgroup's 64 x 64 box (128-byte rows, 128-byte swizzle) as the A
// fragments of its four k-steps: f[kk][r] holds row 16 ww + g + 8 (r % 2),
// columns 16 kk + 2 t4 + 8 (r / 2) and + 1.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], const uint8_t* box) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ww = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * ww + g + 8 * (r & 1);
      const int col = 16 * kk + 2 * t4 + 8 * (r >> 1);
      f[kk][r] = *reinterpret_cast<const uint32_t*>(box + row * 128 +
                                                    (((col >> 3) ^ g) << 4) + (col & 7) * 2);
    }
}

// Columns 8 n + 2 t4 (+ 1) of dq[4 n + e], n in [4 h, 4 h + 4), into an fp32
// 64 x 32 box (query row r, column c at 16-byte chunk c / 4 ^ (r % 8) of
// its 128-byte row).
template <int N>
__device__ __forceinline__ void dq_box(const float (&dq)[N], uint8_t* box, int h) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ww = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * ww + g + 8 * hh;
      *reinterpret_cast<float2*>(box + r * 128 + (((2 * n + (t4 >> 1)) ^ g) << 4) +
                                 8 * (t4 & 1)) = make_float2(dq[4 * (4 * h + n) + 2 * hh],
                                                             dq[4 * (4 * h + n) + 2 * hh + 1]);
    }
}

// The dq part of query tile q0 (64 queries x warpgroup wgi's 32 columns)
// from its accumulator into one of the warpgroup's fp32 boxes, then added
// into the workspace by TMA.
__device__ __forceinline__ void add_dq_part(const float (&dq)[16], uint8_t* box,
                                            const CUtensorMap* map, int wgi, int q0, int bh,
                                            bool issuer) {
  dq_box(dq, box, 0);
  wg::fence_async_smem();
  wg::named_sync(2 + wgi, 128);
  if (issuer) wg::tma_reduce_add_3d(map, box, 32 * wgi, q0, bh);
}

// The same at head width 96: warpgroup 0's part is dq's columns 0-63 (two
// boxes), warpgroup 1's columns 64-95 (one box; its accumulator's other 32
// columns hold nothing); box c of the 32-column chunks at `boxes` + 2 c kBox.
// A warpgroup's reductions go out as one bulk group.
__device__ __forceinline__ void add_dq_part_96(const float (&dq)[32], uint8_t* boxes,
                                               const CUtensorMap* map, int wgi, int q0, int bh,
                                               bool issuer) {
  dq_box(dq, boxes + 4 * wgi * kBox, 0);
  if (wgi == 0) dq_box(dq, boxes + 2 * kBox, 1);
  wg::fence_async_smem();
  wg::named_sync(2 + wgi, 128);
  if (issuer) {
    wg::tma_reduce_add_3d_part(map, boxes + 4 * wgi * kBox, 64 * wgi, q0, bh);
    if (wgi == 0) wg::tma_reduce_add_3d_part(map, boxes + 2 * kBox, 32, q0, bh);
    wg::bulk_commit();
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  using L = Wg<D>;
  const Args& a = p.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  float* lse_s = reinterpret_cast<float*>(sm + L::kBoxes * L::kUnit);  // [stage][64]
  float* delta_s = lse_s + L::kStages * kWgTile;          // [stage][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + L::kStages * kWgTile);
  uint64_t* kv_bar = full + L::kStages;

  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * a.H + h;
  const int k0 = kb * kWgKeys;
  const int nq = (a.Sq + kWgTile - 1) / kWgTile;
  const int t_begin = first_query_tile(a, k0, kWgTile);
  const int ntiles = nq - t_begin;  // >= 1: the block's first key is < Sk
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) wg::bar_init(&full[s], 1);
    wg::bar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect_tx(kv_bar, 4 * L::kChunks * L::kUnit);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      for (int j = 0; j < 2; ++j) {
        wg::tma_box_4d(sm + (L::kBoxK + 2 * c + j) * L::kUnit, &p.k, kv_bar, c * L::kCols,
                       k0 + 64 * j, h, b);
        wg::tma_box_4d(sm + (L::kBoxV + 2 * c + j) * L::kUnit, &p.v, kv_bar, c * L::kCols,
                       k0 + 64 * j, h, b);
      }
    for (int it = 0; it < 2 && it < ntiles; ++it)
      load_stage<D>(p, sm, lse_s, delta_s, full, it, t_begin, h, b, bh);
  }

  // Warpgroup wgi owns keys [k0w, k0w + 64); its accumulators' element
  // 4 n + e is key row 16 ww + g + 8 (e / 2), column 8 n + 2 t4 + e % 2 (a
  // query of the tile for s^T and dp^T, a head dimension for dk and dv).
  const int lane = threadIdx.x & 31;
  const int wgi = threadIdx.x / 128;
  const int ww = (threadIdx.x / 32) % 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0w = k0 + 64 * wgi;
  const int off = a.Sk - a.Sq;
  const bool issuer = threadIdx.x % 128 == 0;

  // Per query tile t a warpgroup waits for all its products, adds the dq
  // part of t - 1 into the workspace, computes p^T and ds^T, issues
  // dv/dk(t) and, once both warpgroups have stored ds^T(t), s/dp(t + 1)
  // and the dq product of t: the three run together. No other instruction
  // writes a product's registers while any product is in flight (ptxas
  // would serialize them), and every product is issued on every tile (the
  // last recomputes its own s/dp). At D = 96 dk(t) takes T(ds^T) from
  // shared memory, so it is issued with dq(t).
  float st[32], dpt[32], dk[D / 2], dv[D / 2], dq[L::kDq];
  uint32_t pa[4][4], da[4][4];  // live until the products that read them are done
  uint32_t kf[4][4], vf[4][4];  // D = 64: the warpgroup's K and V as A fragments
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
#pragma unroll
  for (int x = 0; x < L::kDq; ++x) dq[x] = 0.f;
  // the zeros are written here, not sunk into the first products' flight
  wg::fence_acc(dk);
  wg::fence_acc(dv);
  wg::fence_acc(dq);
  wg::bar_wait(kv_bar, 0);
  if constexpr (D == 64) {
    load_a_frags(kf, sm + (L::kBoxK + wgi) * L::kUnit);
    load_a_frags(vf, sm + (L::kBoxV + wgi) * L::kUnit);
  }
  issue_sdp<D>(st, dpt, sm, full, 0, kf, vf);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % L::kStages;
    const int q0 = (t_begin + it) * kWgTile;
    const uint32_t q_box = wg::smem_u32(sm + (L::kBoxQ + s * L::kChunks) * L::kUnit);
    const uint32_t do_box = wg::smem_u32(sm + (L::kBoxDo + s * L::kChunks) * L::kUnit);
    // 128 keys x 64 queries
    uint8_t* ds_buf = sm + (L::kBoxDs + 2 * (it & 1) * L::kPerBox) * L::kUnit;
    wg::wgmma_wait<0>();  // s/dp(t), dv/dk(t - 1) and dq(t - 1)
    wg::fence_acc(st);
    wg::fence_acc(dpt);
    wg::fence_acc(dk);
    wg::fence_acc(dv);
    wg::fence_acc(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg::fence_regs(pa[kk]);
      if constexpr (D == 64) wg::fence_regs(da[kk]);
    }
    if (it > 0) {
      if constexpr (D == 64)
        add_dq_part(dq, sm + (L::kBoxDq + 2 * wgi + ((it + 1) & 1)) * L::kUnit, &p.dq_acc,
                    wgi, q0 - kWgTile, (int)bh, issuer);
      else
        add_dq_part_96(dq, sm + (L::kBoxDq + ((it + 1) & 1) * L::kPerBox) * L::kUnit,
                       &p.dq_acc, wgi, q0 - kWgTile, (int)bh, issuer);
    }

    // s2 = s * scale * log2(e) in place, the masks and the bias only on
    // tiles that cross the diagonal or an edge or carry a bias or segments;
    // then p^T and ds^T in fp32 in one straight pass, rounded and packed as
    // A fragments: pa[kk] and da[kk] are the queries [16 kk, 16 kk + 16).
    const bool whole = !a.bias && !a.qseg && q0 + kWgTile <= a.Sq && k0w + 64 <= a.Sk &&
                       (!a.causal || k0w + 63 <= q0 + off);
    if (whole) {
#pragma unroll
      for (int x = 0; x < 32; ++x) st[x] *= a.scale_log2;
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + 8 * n + 2 * t4 + (e & 1);
          const int j = k0w + 16 * ww + g + 8 * (e >> 1);
          float s2 = st[4 * n + e] * a.scale_log2;
          if (i < a.Sq && j < a.Sk && visible(a, b, i, j)) {
            if (a.bias) s2 += bias_at(a, b, h, i, j);
          } else {
            s2 = -INFINITY;
          }
          st[4 * n + e] = s2;
        }
    }
    const float* ls = lse_s + s * kWgTile;
    const float* dls = delta_s + s * kWgTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t4);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(st[4 * n + e] - ((e & 1) ? l2.y : l2.x));
        st[4 * n + e] = pe;
        dpt[4 * n + e] = pe * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = mm::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = mm::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }

    // T(ds^T) into this warpgroup's 64 rows of the buffer, 128-byte rows
    // in the swizzle the descriptors read: query chunk n of key row r at
    // 16-byte chunk n ^ (r % 8).
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 64 * wgi + 16 * ww + g + 8 * hh;
        *reinterpret_cast<uint32_t*>(ds_buf + r * 128 + ((n ^ g) << 4) + 4 * t4) =
            da[n >> 1][(n & 1) * 2 + hh];
      }
    wg::fence_async_smem();

    // 3, 4: dv += T(p^T) do, dk += T(ds^T) q (B MN-major; at D = 96 dk
    // after the barrier below, A from the buffer).
    wg::wgmma_fence();
    if constexpr (D == 64) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n64k16_rs<wg::MN>(dv, pa[kk], desc_mn(do_box, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n64k16_rs<wg::MN>(dk, da[kk], desc_mn(q_box, kk), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n96k16_rs<wg::MN>(dv, pa[kk], desc_mn96(do_box, kWgTile, kk), 1);
    }
    wg::wgmma_commit();

    // Both warpgroups have stored T(ds^T)(t) and are done with the stage of
    // t - 1, which takes tile t + 2; the dq boxes of t have been read by
    // their last reduction.
    if (issuer) wg::bulk_wait_read<1>();
    wg::named_sync(1, kWgThreads);
    if (threadIdx.x == 0 && it + 2 < ntiles)
      load_stage<D>(p, sm, lse_s, delta_s, full, it + 2, t_begin, h, b, bh);
    __syncwarp();
    issue_sdp<D>(st, dpt, sm, full, it + 1 < ntiles ? it + 1 : it, kf, vf);

    // 5: dq part = T(ds) K over both warpgroups' keys: at D = 64 64 queries
    // x this warpgroup's 32 columns; at D = 96 64 queries x 64 columns from
    // column 64 wgi (warpgroup 1's last 32 read V's first chunk, which
    // follows K's last, and are never stored).
    const uint32_t ds_box = wg::smem_u32(ds_buf);
    wg::wgmma_fence();
    if constexpr (D == 64) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wg::mma_m64n32k16<wg::MN, wg::MN>(
            dq, desc_mn(ds_box, kk),
            desc_mn(wg::smem_u32(sm + L::kBoxK * L::kUnit) + 64 * wgi, kk), kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n96k16<wg::K, wg::MN>(dk, desc_k(ds_box + wgi * kBox, kk),
                                         desc_mn96(q_box, kWgTile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wg::mma_m64n64k16<wg::MN, wg::MN>(
            dq, desc_mn(ds_box, kk),
            desc_mn96(wg::smem_u32(sm + (L::kBoxK + 4 * wgi) * L::kUnit), kWgKeys, kk), kk);
    }
    wg::wgmma_commit();
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(st);
  wg::fence_acc(dpt);
  wg::fence_acc(dk);
  wg::fence_acc(dv);
  wg::fence_acc(dq);
  const int last = ntiles - 1;
  if constexpr (D == 64)
    add_dq_part(dq, sm + (L::kBoxDq + 2 * wgi + (last & 1)) * L::kUnit, &p.dq_acc, wgi,
                (t_begin + last) * kWgTile, (int)bh, issuer);
  else
    add_dq_part_96(dq, sm + (L::kBoxDq + (last & 1) * L::kPerBox) * L::kUnit, &p.dq_acc, wgi,
                   (t_begin + last) * kWgTile, (int)bh, issuer);
  if (issuer) wg::bulk_wait_all();

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.out0) + b * a.o0s[0] + h * a.o0s[1];
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.out1) + b * a.o1s[0] + h * a.o1s[1];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0w + 16 * ww + g + 8 * hh;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dkg + key * a.o0s[2] + c) = __floats2bfloat162_rn(
          dk[4 * n + 2 * hh] * a.scale, dk[4 * n + 2 * hh + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + key * a.o1s[2] + c) =
          __floats2bfloat162_rn(dv[4 * n + 2 * hh], dv[4 * n + 2 * hh + 1]);
    }
  }
}

// The rows of lse and delta that the one-pass kernel copies a tile at a
// time: row_lse (a row that sees no key, or past Sq, made +inf) and
// row_delta (0 past Sq), each (B H, sq_pad).
__global__ void flash_bwd_wgmma_rows_kernel(const Args a, float* lse_pad, float* delta_pad,
                                            int sq_pad, long long n) {
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x; x < n;
       x += (long long)gridDim.x * blockDim.x) {
    const long long bh = x / sq_pad;
    const int i = (int)(x - bh * sq_pad);
    lse_pad[x] = row_lse(a, bh, i);
    delta_pad[x] = row_delta(a, bh, i);
  }
}

// dq = T(scale * workspace): the fp32 (B H, Sq, D) sum into dq's strides,
// four columns a thread.
template <int D>
__global__ void flash_bwd_wgmma_dq_kernel(const float4* __restrict__ acc, __nv_bfloat16* dq,
                                          long long s0, long long s1, long long s2, int H,
                                          int Sq, float scale, long long n4) {
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x; x < n4;
       x += (long long)gridDim.x * blockDim.x) {
    const long long row = x / (D / 4);
    const int c = (int)(x % (D / 4)) * 4;
    const long long bh = row / Sq;
    const int i = (int)(row - bh * Sq);
    const float4 f = acc[x];
    __nv_bfloat162 lo = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    __nv_bfloat162 hi = __floats2bfloat162_rn(f.z * scale, f.w * scale);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dq + (bh / H) * s0 + (bh % H) * s1 + i * s2 + c) = w;
  }
}

unsigned grid_of(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 65536 ? blocks : 65536);
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

// The zero-fill of dq's sum, the rows of lse and delta, the one-pass kernel
// and dq's conversion, on `stream` in that order. ws: the (B H, Sq, D) sum,
// then the two (B H, sq_pad) rows.
template <int D>
cudaError_t launch_wgmma(const Args& a, void* dq, const long long* dqs, void* ws,
                         cudaStream_t st) {
  static const cudaError_t smem_err = wg::allow_smem(flash_bwd_wgmma_kernel<D>, Wg<D>::kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  WgParams p;
  p.a = a;
  cudaError_t err;
  if ((err = map_bhsd<D>(&p.q, a.q, a.B, a.H, a.Sq, a.qs)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.k, a.k, a.B, a.H, a.Sk, a.ks)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.v, a.v, a.B, a.H, a.Sk, a.vs)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.dout, a.dout, a.B, a.H, a.Sq, a.dos)) != cudaSuccess) return err;
  const long long rows = (long long)a.B * a.H * a.Sq;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)a.Sq, (cuuint64_t)a.B * a.H};
  const cuuint64_t strides[2] = {D * sizeof(float), (cuuint64_t)a.Sq * D * sizeof(float)};
  const cuuint32_t box[3] = {32, 64, 1};
  if ((err = wg::make_map_nd<3>(&p.dq_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, dims, strides,
                                box)) != cudaSuccess)
    return err;
  p.sq_pad = (a.Sq + kWgTile - 1) / kWgTile * kWgTile;
  const long long pad_rows = (long long)a.B * a.H * p.sq_pad;
  float* lse_pad = static_cast<float*>(ws) + rows * D;
  p.lse_pad = lse_pad;
  p.delta_pad = lse_pad + pad_rows;
  const size_t bytes = (size_t)rows * D * sizeof(float);
  if ((err = cudaMemsetAsync(ws, 0, bytes, st)) != cudaSuccess) return err;
  flash_bwd_wgmma_rows_kernel<<<grid_of(pad_rows), 256, 0, st>>>(a, lse_pad, lse_pad + pad_rows,
                                                                 p.sq_pad, pad_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_wgmma_kernel<D><<<dim3((a.Sk + kWgKeys - 1) / kWgKeys, a.H, a.B), kWgThreads,
                              Wg<D>::kSmem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_wgmma_dq_kernel<D><<<grid_of(rows * D / 4), 256, 0, st>>>(
      static_cast<const float4*>(ws), static_cast<__nv_bfloat16*>(dq), dqs[0], dqs[1], dqs[2],
      a.H, a.Sq, a.scale, rows * D / 4);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// #9 in bf16 at head width 32, 64 or 96: `wgmma` + TMA stores.
// ---------------------------------------------------------------------------

constexpr int kDbKeys = 64;   // keys a tile holds
constexpr int kDbRows = 128;  // query rows a block owns: 64 a warpgroup
constexpr int kDbOutBox = 64 * 32 * 4;  // a 64-row x 32-key fp32 box of ds

// Shared memory, from a 1024-byte aligned base: Q's and dO's 128 rows, the
// ring of K and V tiles (64 keys each), each warpgroup's two staging
// buffers of ds (two boxes each), a zero box, the barriers and the ring's
// counts of warps done with a stage. Tiles in head width D's chunk layout
// (Wg<D>: 32-column chunks of 64-byte rows in the 64-byte swizzle at D = 32
// and 96, one 128-byte chunk at 64).
template <int D>
struct Db {
  static constexpr int kStages = D == 96 ? 3 : 4;
  static constexpr int kUnit = Wg<D>::kUnit;  // 64 rows of a chunk
  static constexpr int kQTile = 2 * Wg<D>::kChunks * kUnit;
  static constexpr int kKvTile = Wg<D>::kChunks * kUnit;
  static constexpr int kStage = 2 * kKvTile;  // K's tile, then V's
  static constexpr int kRing = 2 * kQTile;
  static constexpr int kStaging = kRing + kStages * kStage;
  static constexpr int kZero = kStaging + 8 * kDbOutBox;
  static constexpr int kBars = kZero + kDbOutBox;
  static constexpr size_t kSmem = 1024 + (size_t)kBars + (kStages + 1) * sizeof(uint64_t) +
                                  kStages * sizeof(int);
};
static_assert(Db<96>::kSmem <= 232448, "a block's shared memory");

struct DbParams {
  CUtensorMap q, k, v, dout;  // (B, H, S, D) bf16, 64-row boxes of a chunk's columns
  CUtensorMap ds;             // (B H, Sq, Sk) fp32 at row pitch ds_pitch, 64 x 32 boxes
  Args a;
};

// K-major descriptor of k-step kk (16 columns) of the rows at `tile` of a
// tile whose chunks hold `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t db_desc(uint32_t tile, int rows, int kk) {
  constexpr int per = Wg<D>::kCols / 16;
  const uint32_t addr = tile + (kk / per) * rows * Wg<D>::kRowBytes + (kk % per) * 32;
  if constexpr (D == 64) return wg::desc(addr, 16, 1024);
  return desc64(addr, 16);
}

// The boxes of 64 R rows of a (B, H, S, D) tensor from row r0 into a tile.
template <int D, int R>
__device__ __forceinline__ void db_load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                        int r0, int h, int b) {
#pragma unroll
  for (int c = 0; c < Wg<D>::kChunks; ++c)
#pragma unroll
    for (int j = 0; j < R; ++j)
      wg::tma_box_4d(dst + (R * c + j) * Wg<D>::kUnit, map, bar, c * Wg<D>::kCols, r0 + 64 * j,
                     h, b);
}

// The copies of key tile t (K and V, 64 keys each) into its stage.
template <int D>
__device__ __forceinline__ void db_load_kv(const DbParams& p, uint8_t* ring, uint64_t* full,
                                           int t, int h, int b) {
  const int s = t % Db<D>::kStages;
  uint8_t* dst = ring + s * Db<D>::kStage;
  wg::bar_expect_tx(&full[s], Db<D>::kStage);
  db_load<D, 1>(dst, &p.k, &full[s], t * kDbKeys, h, b);
  db_load<D, 1>(dst + Db<D>::kKvTile, &p.v, &full[s], t * kDbKeys, h, b);
}

// One key tile t of a warpgroup's 64 query rows: S = Q K^T and dP = dO V^T
// (`wgmma` m64n64k16, D / 16 k-steps each, fp32), the stage released (the
// last of the block's eight warps refills it with tile t + kStages), then
// ds = p (dp - delta), p = exp2(s2 - lse), in registers, into staging
// buffer t % 2 in the 128-byte swizzle of the store's boxes, and out by
// two TMA stores (keys and rows past Sk and Sq are clipped by the map).
// With MASK the per-element masks (causal, segments) apply; with BIAS the
// bias, read through its strides before the products are issued.
template <int D, bool MASK, bool BIAS>
__device__ __forceinline__ void dbias_tile(const DbParams& p, uint8_t* sm, uint64_t* full,
                                           int* released, int t, int n, int h, int b, int bh,
                                           int r0, int q_row, const int (&qid)[2],
                                           const float (&lse)[2], const float (&delta)[2],
                                           bool issuer) {
  using L = Db<D>;
  const Args& a = p.a;
  const int lane = threadIdx.x & 31;
  const int wgi = threadIdx.x / 128;
  const int t4 = lane & 3;
  const int st = t % L::kStages;
  const int k0 = t * kDbKeys;
  float bv[32];
  if (BIAS) {
    const float* base = a.bias + b * a.bs[0] + h * a.bs[1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* row = base + min(r0 + 8 * hh, a.Sq - 1) * a.bs[2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          bv[4 * j + 2 * hh + c] = row[min(k0 + 8 * j + 2 * t4 + c, a.Sk - 1) * a.bs[3]];
    }
  }
  uint32_t seg = ~0u;  // bit 4 j + 2 hh + c: row r0 + 8 hh, key k0 + 8 j + 2 t4 + c
  if (MASK && a.qseg) {
    seg = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t4 + c;
        const int kid = key < a.Sk ? a.kvseg[b * a.kvseg_b + key] : 0;  // clipped anyway
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) seg |= (uint32_t)(kid == qid[hh]) << (4 * j + 2 * hh + c);
      }
  }
  wg::bar_wait(&full[st], (t / L::kStages) & 1);
  __syncwarp();  // the warp leaves the poll together: `wgmma` is .aligned
  const uint32_t q_tile = wg::smem_u32(sm) + q_row;
  const uint32_t do_tile = wg::smem_u32(sm + L::kQTile) + q_row;
  const uint32_t k_tile = wg::smem_u32(sm + L::kRing + st * L::kStage);
  const uint32_t v_tile = k_tile + L::kKvTile;
  float s[32], dp[32];
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_m64n64k16<wg::K, wg::K>(s, db_desc<D>(q_tile, kDbRows, kk),
                                    db_desc<D>(k_tile, kDbKeys, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg::mma_m64n64k16<wg::K, wg::K>(dp, db_desc<D>(do_tile, kDbRows, kk),
                                    db_desc<D>(v_tile, kDbKeys, kk), kk);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_acc(s);
  wg::fence_acc(dp);
  if (lane == 0) {
    __threadfence_block();
    if (atomicAdd(&released[st], 1) == 7) {
      released[st] = 0;
      __threadfence_block();
      wg::fence_async_smem();
      if (t + L::kStages < n) db_load_kv<D>(p, sm + L::kRing, full, t + L::kStages, h, b);
    }
  }
  __syncwarp();

  // the last key each of the thread's two rows sees (keys past Sk are
  // clipped by the store, not masked)
  const int off = a.Sk - a.Sq;
  const int last[2] = {a.causal ? r0 + off : 0x7fffffff, a.causal ? r0 + 8 + off : 0x7fffffff};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t4 + c;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh + c;
        float s2 = BIAS ? fmaf(s[x], a.scale_log2, bv[x] * kLog2e) : s[x] * a.scale_log2;
        if (MASK) s2 = (key <= last[hh]) & (((seg >> x) & 1) != 0) ? s2 : -INFINITY;
        s[x] = mm::ex2(s2 - lse[hh]) * (dp[x] - delta[hh]);
      }
    }

  // Staging buffer t % 2 of this warpgroup: free once the stores of tile
  // t - 2 have read it (this thread's bulk groups but the newest).
  uint8_t* buf = sm + L::kStaging + (4 * wgi + 2 * (t & 1)) * kDbOutBox;
  if (issuer) wg::bulk_wait_read<1>();
  wg::named_sync(1 + wgi, 128);
  dq_box(s, buf, 0);
  dq_box(s, buf + kDbOutBox, 1);
  wg::fence_async_smem();
  wg::named_sync(1 + wgi, 128);
  if (issuer) {
    wg::tma_store_3d(&p.ds, buf, k0, r0 - r0 % 64, bh);
    wg::tma_store_3d(&p.ds, buf + kDbOutBox, k0 + 32, r0 - r0 % 64, bh);
    wg::bulk_commit();
  }
}

// #9: one block of two warpgroups per (128-query tile, head, batch); it
// walks the key tiles that any of its rows sees, [0, n), then stores zeros
// from a zeroed box over the tiles the causal mask leaves out, [n, nk).
template <int D, bool BIAS>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dbias_kernel(const __grid_constant__ DbParams p) {
  using L = Db<D>;
  const Args& a = p.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* q_bar = full + L::kStages;
  int* released = reinterpret_cast<int*>(q_bar + 1);

  const int q0 = blockIdx.x * kDbRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * a.H + h;
  const int nk = (a.Sk + kDbKeys - 1) / kDbKeys;
  const int n = key_tiles(a, q0, kDbRows, kDbKeys);

  float4* zero = reinterpret_cast<float4*>(sm + L::kZero);
  for (int x = threadIdx.x; x < kDbOutBox / 16; x += 256) zero[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  wg::fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      wg::bar_init(&full[s], 1);
      released[s] = 0;
    }
    wg::bar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    wg::bar_expect_tx(q_bar, 2 * L::kQTile);
    db_load<D, 2>(sm, &p.q, q_bar, q0, h, b);
    db_load<D, 2>(sm + L::kQTile, &p.dout, q_bar, q0, h, b);
    for (int t = 0; t < L::kStages && t < n; ++t) db_load_kv<D>(p, sm + L::kRing, full, t, h, b);
  }

  // Warpgroup wgi owns rows [q0 + 64 wgi, + 64); a thread rows r0 and
  // r0 + 8, keys 8 j + 2 t4 and + 1 of a tile (s[4 j + 2 hh + c]).
  const int lane = threadIdx.x & 31;
  const int wgi = threadIdx.x / 128;
  const int r0 = q0 + 64 * wgi + 16 * ((threadIdx.x / 32) % 4) + (lane >> 2);
  const bool issuer = threadIdx.x % 128 == 0;
  int qid[2] = {0, 0};
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + 8 * hh;
    if (a.qseg && i < a.Sq) qid[hh] = a.qseg[b * a.qseg_b + i];
    lse[hh] = row_lse(a, bh, i);
    delta[hh] = row_delta(a, bh, i);
  }
  // Tiles [0, n_whole) need no per-element mask: every row of the
  // warpgroup sees each of their keys below Sk.
  int n_whole = a.qseg ? 0 : n;
  if (a.causal) {
    const int first = q0 + 64 * wgi + a.Sk - a.Sq;  // the warpgroup's first row's last key
    n_whole = min(n_whole, first + 1 > 0 ? (first + 1) / kDbKeys : 0);
  }
  if (n > 0) {
    wg::bar_wait(q_bar, 0);
    const int q_row = wgi * 64 * Wg<D>::kRowBytes;
    for (int t = 0; t < n_whole; ++t)
      dbias_tile<D, false, BIAS>(p, sm, full, released, t, n, h, b, bh, r0, q_row, qid, lse,
                                 delta, issuer);
    for (int t = n_whole; t < n; ++t)
      dbias_tile<D, true, BIAS>(p, sm, full, released, t, n, h, b, bh, r0, q_row, qid, lse,
                                delta, issuer);
  }
  // the tiles above the causal diagonal: zeros
  if (issuer) {
    for (int t = n; t < nk; ++t) {
      wg::tma_store_3d(&p.ds, zero, t * kDbKeys, q0 + 64 * wgi, bh);
      wg::tma_store_3d(&p.ds, zero, t * kDbKeys + 32, q0 + 64 * wgi, bh);
    }
    wg::bulk_commit();
    wg::bulk_wait_read<0>();  // the block's shared memory outlives its stores' reads
  }
}

// The maps of q, k, v and do and of ds ((B H, Sq, Sk) fp32, rows a.o0s[2]
// floats apart: 16-byte aligned), and #9's kernel.
template <int D, bool BIAS>
cudaError_t launch_dbias(const Args& a, cudaStream_t st) {
  static const cudaError_t smem_err =
      wg::allow_smem(flash_bwd_dbias_kernel<D, BIAS>, Db<D>::kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  DbParams p;
  p.a = a;
  cudaError_t err;
  if ((err = map_bhsd<D>(&p.q, a.q, a.B, a.H, a.Sq, a.qs)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.k, a.k, a.B, a.H, a.Sk, a.ks)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.v, a.v, a.B, a.H, a.Sk, a.vs)) != cudaSuccess) return err;
  if ((err = map_bhsd<D>(&p.dout, a.dout, a.B, a.H, a.Sq, a.dos)) != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)a.Sk, (cuuint64_t)a.Sq, (cuuint64_t)a.B * a.H};
  const cuuint64_t strides[2] = {(cuuint64_t)a.o0s[2] * sizeof(float),
                                 (cuuint64_t)a.o0s[1] * sizeof(float)};
  const cuuint32_t box[3] = {32, 64, 1};
  if ((err = wg::make_map_nd<3>(&p.ds, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.out0, dims, strides,
                                box)) != cudaSuccess)
    return err;
  flash_bwd_dbias_kernel<D, BIAS><<<dim3((a.Sq + kDbRows - 1) / kDbRows, a.H, a.B), 256,
                                    Db<D>::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dbias(const Args& a, cudaStream_t st) {
  return a.bias ? launch_dbias<D, true>(a, st) : launch_dbias<D, false>(a, st);
}

// ---------------------------------------------------------------------------
// `mma.sync` path: #7 and #8 in bf16 at head width 32 or 128, #9 in bf16 at
// 128.
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
      float* dst = static_cast<float*>(a.out0) + bh * a.o0s[1];
      for (int idx = threadIdx.x; idx < kBQ * kBK; idx += kWarps * 32) {
        const int i = q0 + idx / kBK, j = kt * kBK + idx % kBK;
        if (i < a.Sq && j < a.Sk) dst[i * a.o0s[2] + j] = 0.f;
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
      float* dst = static_cast<float*>(a.out0) + bh * a.o0s[1];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = rows[e >> 1];
          const int j = k0 + 8 * nt + 2 * t4 + (e & 1);
          if (i < a.Sq && j < a.Sk) dst[i * a.o0s[2] + j] = sc[nt][e];
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
// held in registers at a time. minBlocks: 3 at D = 32 (12 warps an SM, at
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

template <int D, bool kDbias>
cudaError_t launch_mma_dq(const Args& a, cudaStream_t stream) {
  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int nk = (a.Sk + kBK - 1) / kBK;
  auto kernel = flash_bwd_dq_mma_kernel<D, kDbias>;
  const size_t smem = dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kDbias ? nq * nk : nq, a.H, a.B), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_dkv(const Args& a, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_mma_kernel<D, 64, 32>;
  const size_t smem = dkv_smem<D, 64>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.Sk + kBQ - 1) / kBQ, a.H, a.B), kWarps * 32, smem, stream>>>(a);
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
      float* dst = static_cast<float*>(a.out0) + bh * a.o0s[1];
      const int j = ktile * kFT + lane;
      for (int r = 0; r < kFRows; ++r)
        if (i0 + r < a.Sq && j < a.Sk) dst[(i0 + r) * a.o0s[2] + j] = 0.f;
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
      float* dst = static_cast<float*>(a.out0) + bh * a.o0s[1];
#pragma unroll
      for (int r = 0; r < kFRows; ++r)
        if (i0 + r < a.Sq && j < a.Sk) dst[(i0 + r) * a.o0s[2] + j] = ds[r];
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

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const long long* in_strides, const void* bias, const long long* bias_strides,
               const void* qseg, long long qseg_b, const void* kvseg, long long kvseg_b,
               const void* lse, const void* delta, int B, int H, int Sq, int Sk, float sm_scale,
               int causal) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out0 = a.out1 = nullptr;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = in_strides[i];
    a.ks[i] = in_strides[3 + i];
    a.vs[i] = in_strides[6 + i];
    a.dos[i] = in_strides[9 + i];
    a.o0s[i] = a.o1s[i] = 0;
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
  return a;
}

bool shape_ok(int B, int H, int Sq, int Sk, int D, int dtype, const void* qseg,
              const void* kvseg) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && D > 0 && D % 8 == 0 && D <= 128 &&
         (dtype == 0 || dtype == 1) && (qseg == nullptr) == (kvseg == nullptr);
}

}  // namespace

extern "C" {

// The kernels of mm_flash_attention_bwd for dq, dk and dv at head width D
// in `dtype`: 2 the one-pass `wgmma` kernel (bf16 at 64 and 96; it takes
// dq_acc), 1 `mma.sync` (bf16 at 32 and 128), 0 the FP32 pipes.
int mm_flash_attention_bwd_route(int D, int dtype) {
  if (dtype == 1 && (D == 64 || D == 96)) return 2;
  return dtype == 1 && (D == 32 || D == 128) ? 1 : 0;
}

// q, do (B, H, Sq, D), k, v (B, H, Sk, D), all of `dtype` (0 = fp32, 1 =
// bf16) with the last dimension contiguous; in_strides holds the batch, head
// and row strides (in elements, 16-byte aligned rows) of q, k, v and do.
// bias: fp32 with strides bias_strides (0 on broadcast dims) or null. qseg
// (B, Sq) / kvseg (B, Sk) int32 with batch strides, both or neither. lse
// (log2 space) and delta: (B, H, Sq) fp32 contiguous. Each entry launches
// on `stream`, allocates nothing and returns the first launch error.
//
// dq (#7), dk and dv (#8) of `dtype`, in the layouts of q, k and v with the
// batch, head and row strides out_strides (dq's, dk's, dv's). bf16 at D = 64
// and 96 takes dq_acc, a contiguous fp32 workspace, 16-byte aligned, of B H
// (D Sq + 2 sq_pad) floats (sq_pad: Sq rounded up to a multiple of 64): dq's
// sum over key blocks, which this entry zero-fills first, and the rows of
// lse and delta that the kernel copies; the other routes ignore it.
int mm_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                           void* dq, void* dk, void* dv, void* dq_acc,
                           const long long* in_strides, const long long* out_strides,
                           const void* bias, const long long* bias_strides, const void* qseg,
                           long long qseg_b, const void* kvseg, long long kvseg_b,
                           const void* lse, const void* delta, int B, int H, int Sq, int Sk,
                           int D, float sm_scale, int causal, int dtype, void* stream) {
  const int route = mm_flash_attention_bwd_route(D, dtype);
  if (!shape_ok(B, H, Sq, Sk, D, dtype, qseg, kvseg) || (route == 2 && dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, dout, in_strides, bias, bias_strides, qseg, qseg_b, kvseg,
                     kvseg_b, lse, delta, B, H, Sq, Sk, sm_scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  a.out0 = dk;
  a.out1 = dv;
  for (int i = 0; i < 3; ++i) {
    a.o0s[i] = out_strides[3 + i];
    a.o1s[i] = out_strides[6 + i];
  }
  if (route == 2)
    return (int)(D == 64 ? launch_wgmma<64>(a, dq, out_strides, dq_acc, st)
                         : launch_wgmma<96>(a, dq, out_strides, dq_acc, st));
  cudaError_t err;
  if (route == 1)
    err = D == 32 ? launch_mma_dkv<32>(a, st) : launch_mma_dkv<128>(a, st);
  else if (dtype == 0)
    err = dispatch_fp32<float>(1, a, D, st);
  else
    err = dispatch_fp32<__nv_bfloat16>(1, a, D, st);
  if (err != cudaSuccess) return (int)err;
  a.out0 = dq;
  a.out1 = nullptr;
  for (int i = 0; i < 3; ++i) a.o0s[i] = out_strides[i];
  if (route == 1)
    return (int)(D == 32 ? launch_mma_dq<32, false>(a, st) : launch_mma_dq<128, false>(a, st));
  if (dtype == 0) return (int)dispatch_fp32<float>(0, a, D, st);
  return (int)dispatch_fp32<__nv_bfloat16>(0, a, D, st);
}

// #9: ds, the full fp32 (B, H, Sq, Sk) bias gradient, its rows ds_pitch
// floats apart (ds_pitch >= Sk, a multiple of 4; heads and batches packed:
// the columns past Sk are never written). bf16 at head width 32, 64 and 96
// runs the `wgmma` kernel, 128 `mma.sync`, fp32 and other widths the FP32
// pipes.
int mm_flash_attention_bwd_dbias(const void* q, const void* k, const void* v, const void* dout,
                                 void* ds, long long ds_pitch, const long long* in_strides,
                                 const void* bias, const long long* bias_strides,
                                 const void* qseg, long long qseg_b, const void* kvseg,
                                 long long kvseg_b, const void* lse, const void* delta, int B,
                                 int H, int Sq, int Sk, int D, float sm_scale, int causal,
                                 int dtype, void* stream) {
  if (!shape_ok(B, H, Sq, Sk, D, dtype, qseg, kvseg) || ds_pitch < Sk || ds_pitch % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, dout, in_strides, bias, bias_strides, qseg, qseg_b, kvseg,
                     kvseg_b, lse, delta, B, H, Sq, Sk, sm_scale, causal);
  a.out0 = ds;
  a.o0s[0] = (long long)H * Sq * ds_pitch;
  a.o0s[1] = (long long)Sq * ds_pitch;  // a (batch, head)'s rows
  a.o0s[2] = ds_pitch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_fp32<float>(2, a, D, st);
  if (D == 32) return (int)dispatch_dbias<32>(a, st);
  if (D == 64) return (int)dispatch_dbias<64>(a, st);
  if (D == 96) return (int)dispatch_dbias<96>(a, st);
  if (D == 128) return (int)launch_mma_dq<128, true>(a, st);
  return (int)dispatch_fp32<__nv_bfloat16>(2, a, D, st);
}

}  // extern "C"
