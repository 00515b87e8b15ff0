// The GEMM core of the port's Hopper kernels: bf16 tiles copied by the
// Tensor Memory Accelerator (TMA) into a ring of shared-memory stages, each
// stage guarded by a pair of mbarriers, and multiplied by warpgroup
// products (`wgmma`) with fp32 accumulators in registers.
//
// A block is two consumer warpgroups (256 threads) and one producer warp:
// kThreads = 288. It is persistent: it walks a list of work items, each a
// BM x BN = 128 x 128 output tile (warpgroup w its rows [64 w, 64 w + 64))
// reduced over some k-blocks of BK = 64. For each k-block the producer's
// first lane copies A's 128 x 64 and B's 64 x 128 slices into a stage as
// four 64 x 64 TMA boxes (8 KB each, rows of 128 bytes in the 128-byte
// swizzle `wgmma` reads), and each consumer warpgroup issues four
// m64n128k16 products on the stage once its `full` barrier has seen the
// bytes land. A stage is refilled only after all 256 consumer threads have
// arrived on its `empty` barrier, which they do when the products that read
// it have completed (`wgmma.wait_group 1` one k-block later). So the
// producer runs up to STAGES k-blocks ahead, across the end of an item: the
// next item's first stages land while the consumers run this one's
// epilogue. A kernel supplies the k-block count of an item, the copies of
// a k-block and the products of a stage, and the epilogue that writes an
// item's tile from the accumulators (the `nk`, `load`, `mma` and `epi`
// hooks of `run`).
//
// Operand layouts (`Major`): an operand is K-major when its reduction axis
// is contiguous in memory (x, g and W1^T read as A or B of x . W1), and
// MN-major when its row or column axis is (W2^T as B of g . W2^T, and both
// operands of the weight gradients, which reduce over rows). `wgmma` takes
// either for 16-bit types; the shared-memory descriptor and the transpose
// bit say which.
//
// The header also carries what the flash attention kernels
// (csrc/flash_attention_{fwd,bwd}.cu) need beside the ring's barriers and
// descriptors: maps of strided tensors of up to five dimensions (in the
// 64-byte swizzle too), m64n64k16, m64n96k16 and m64n32k16 products, the
// form with A in registers, bulk copies, TMA reductions into global fp32,
// TMA stores, and named barriers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBoxBytes = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box
constexpr int kStageBytes = 4 * kBoxBytes;  // A's two boxes, then B's two

enum Major { K = 0, MN = 1 };

// Dynamic shared memory of a kernel with STAGES stages and `extra` bytes of
// its own: room to align the ring to the swizzle's 1024 bytes, the stages,
// their barriers, then the extra bytes.
template <int STAGES>
constexpr size_t smem_bytes(size_t extra) {
  return 1024 + (size_t)STAGES * kStageBytes + 16 * STAGES + extra;
}

// ---------------------------------------------------------------------------
// Host: TMA descriptors
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so that
// the library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of a strided tensor of R dimensions, dims[0] the contiguous one:
// `strides` are the other dimensions' strides in bytes (multiples of 16, in
// any order), `box` the box's extent in each dimension, 128-byte swizzle
// (box[0] times the element size at most 128 bytes) unless `swizzle` names
// another. Boxes that reach past a dimension read zeros there, and a
// reduction into the map skips those elements.
template <int R>
inline cudaError_t make_map_nd(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                               const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                               const cuuint32_t (&box)[R],
                               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  cuuint32_t elem[R];
  for (int i = 0; i < R; ++i) elem[i] = 1;
  const CUresult r = enc(map, type, R, const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A TMA map of the row-major bf16 matrix (rows, cols) at `base` (16-byte
// aligned, cols a multiple of 8), cut into 64 x 64 boxes with the 128-byte
// swizzle. Boxes that reach past the matrix read zeros there. The same map
// serves the matrix as a K-major or an MN-major operand.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  return make_map_nd<2>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

// ---------------------------------------------------------------------------
// Host: launch helpers
// ---------------------------------------------------------------------------

// A TMA map of a bf16 (B, H, S, 64) tensor at `base` with element strides
// st (batch, head, row), 64 x 64 boxes (rows x head dimension). Rows past S
// read zeros.
inline cudaError_t map_bhsd(CUtensorMap* map, const void* base, int B, int H, int S,
                            const long long (&st)[3]) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return make_map_nd<4>(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only so).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks of a persistent launch: `per_sm` a multiprocessor, no more than
// there are items.
inline int persistent_grid(int items, int per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return items < per_sm * sms ? items : per_sm * sms;
}

// ---------------------------------------------------------------------------
// Device: barriers, copies, products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Until the barrier's phase of parity `parity` has completed. A wait that
// has not completed after 2^30 polls (many seconds) traps, so a fault in the
// ring's protocol ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 box of `map` at element coordinates (c0 along the contiguous
// axis, c1 along the other) into `dst`, reported to `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// An operand's two boxes of one k-block: rows or columns [mn0, mn0 + 128)
// of the tile, reduction indices [k0, k0 + 64). A K-major matrix is stored
// (MN, K); an MN-major one (K, MN).
template <int MAJOR>
__device__ __forceinline__ void load_operand(uint8_t* dst, const CUtensorMap* map,
                                             uint64_t* bar, int mn0, int k0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (MAJOR == K)
      tma_box(dst + j * kBoxBytes, map, bar, k0, mn0 + 64 * j);
    else
      tma_box(dst + j * kBoxBytes, map, bar, mn0 + 64 * j, k0);
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of k-step kk (16 reduction indices) of an operand's stage at
// `base`, rows [64 half, 64 half + 64) for A (half = the warpgroup) or all
// 128 columns for B (half = 0). K-major: 8-row groups of 128-byte rows
// 1024 bytes apart, the k-step 32 bytes into the swizzled row. MN-major:
// 8-index groups of k 1024 bytes apart, the 64-wide halves of the tile one
// box (8 KB) apart.
template <int MAJOR>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int half, int kk) {
  if (MAJOR == K) return desc(base + half * kBoxBytes + kk * 32, 16, 1024);
  return desc(base + half * kBoxBytes + kk * 2048, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for registers that asynchronous products read as their A
// operand: they stay live, unchanged, until the fence after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, fp32) (+)= A (64 x 16) . B (16 x 128), both from shared
// memory; `acc` = 0 overwrites d instead of adding to it. The accumulator
// layout: with w = warp % 4 and l = lane, d[4 j + e] is row 16 w + l / 4 +
// 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.
template <int MA, int MB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                               int acc = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(MA), "n"(MB), "r"(acc));
}

// The flash attention backward's products. Each has the accumulator layout
// above (d[4 j + e] at row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4)
// + e % 2); `acc` = 0 overwrites d instead of adding to it.
//
// d (64 x 64) (+)= A (64 x 16) . B (16 x 64), both from shared memory.
template <int MA, int MB>
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(MA), "n"(MB));
}

// d (64 x 64) (+)= A (64 x 16) . B (16 x 64), A from registers: the A
// fragment of a warp's 16 rows is mma.sync m16n8k16's (a[0] rows l / 4,
// columns 2 (l % 4) and + 1, a[1] the rows 8 further, a[2] and a[3] the
// columns 8 further), so an accumulator of this layout, rounded and packed
// two columns a register, is the A operand of the next product.
template <int MB>
__device__ __forceinline__ void mma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(MB));
}

// d (64 x 96) (+)= A (64 x 16) . B (16 x 96), A from registers as in
// mma_m64n64k16_rs: the output product of attention at head width 96.
template <int MB>
__device__ __forceinline__ void mma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(MB));
}

// d (64 x 96) (+)= A (64 x 16) . B (16 x 96), both from shared memory: the
// flash backward's dk at head width 96.
template <int MA, int MB>
__device__ __forceinline__ void mma_m64n96k16(float (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc), "n"(MA), "n"(MB));
}

// d (64 x 32) (+)= A (64 x 16) . B (16 x 32), both from shared memory.
template <int MA, int MB>
__device__ __forceinline__ void mma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(MA), "n"(MB));
}

// d (64 x 32) (+)= A (64 x 16) . B (16 x 32), A from registers as in
// mma_m64n64k16_rs: the output product of attention at head width 32.
template <int MB>
__device__ __forceinline__ void mma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(MB));
}

// One box of a 4-d map at coordinates (c0 along the contiguous axis, ...)
// into `dst`, reported to `bar`.
__device__ __forceinline__ void tma_box_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Adds the box at `src` (shared memory, written in the map's swizzled
// layout and made visible by fence_async_smem) element by element into the
// fp32 tensor of a 3-d map, as one bulk group of the calling thread.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The reduction of tma_reduce_add_3d without its commit, so that several
// go into one bulk group; bulk_commit closes it.
__device__ __forceinline__ void tma_reduce_add_3d_part(const CUtensorMap* map, const void* src,
                                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Stores the box at `src` (shared memory, in the map's layout and made
// visible by fence_async_smem) into the tensor of a 3-d map; elements past
// the map's extents are not written. Part of the calling thread's open bulk
// group, which bulk_commit closes.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk groups have read their shared memory (all but
// the newest N).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Until this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's ordinary shared-memory stores visible to `wgmma` and
// TMA (the async proxy); a barrier then orders them for the other threads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15) of `count` threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Arrives at named barrier `id` without waiting for it.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// k-step kk of the warpgroup's product on the stage whose A and B start at
// shared addresses a and b.
template <int MA, int MB>
__device__ __forceinline__ void mma_step(float (&d)[64], uint32_t a, uint32_t b, int kk) {
  mma_m64n128k16<MA, MB>(d, operand_desc<MA>(a, threadIdx.x / 128, kk),
                         operand_desc<MB>(b, 0, kk));
}

// ---------------------------------------------------------------------------
// The ring and the mainloop
// ---------------------------------------------------------------------------

template <int STAGES>
struct Ring {
  uint8_t* stages;  // STAGES x kStageBytes, 1024-byte aligned
  uint64_t* full;   // a stage's bytes have landed (count 1 + the copies' bytes)
  uint64_t* empty;  // all kConsumers threads are done with a stage
  uint8_t* extra;   // the kernel's own bytes after the barriers

  // Lays the ring out in dynamic shared memory and initialises the
  // barriers; every thread of the block calls it.
  __device__ __forceinline__ explicit Ring(uint8_t* smem_raw) {
    stages = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                        ~uintptr_t(1023));
    full = reinterpret_cast<uint64_t*>(stages + STAGES * kStageBytes);
    empty = full + STAGES;
    extra = reinterpret_cast<uint8_t*>(empty + STAGES);
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        bar_init(&full[s], 1);
        bar_init(&empty[s], kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  __device__ __forceinline__ uint8_t* a(int s) const { return stages + s * kStageBytes; }
  __device__ __forceinline__ uint8_t* b(int s) const { return a(s) + 2 * kBoxBytes; }
};

// Named barrier of the consumer warpgroups alone, for epilogues.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The number of work items of this block when `total` items are dealt to
// the grid's blocks in turn: block b takes items b, b + grid, ...
__device__ __forceinline__ int items_of_block(int total) {
  return total > (int)blockIdx.x ? (total - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

// Runs this block's `items` work items through the ring. nk(i) is item
// i's count of k-blocks; load(i, kb, a, b, bar), called by the producer's
// first lane, issues the copies of its k-block kb into a stage's A and B
// halves (kStageBytes in all, reported to bar); mma(kb, a, b), called by
// every consumer thread once the stage has landed, issues the warpgroup's
// products on it from the shared addresses of its halves; epi(i), called
// by every consumer thread with item i's products complete, writes its
// tile and clears the accumulators. The producer warp returns at once, so
// nothing may follow `run` in a kernel but the end.
//
// run2 is the same with an item's k-blocks in two runs, [0, nk1(i)) through
// mma1 and [nk1(i), nk1(i) + nk2(i)) through mma2, each in a loop of its
// own: products that a branch inside one hook would choose between (two
// accumulators) are then never issued under a condition, which would make
// ptxas serialize them (C7520).
template <int STAGES, class NK1, class NK2, class Load, class Mma1, class Mma2, class Epi>
__device__ __forceinline__ void run2(const Ring<STAGES>& r, int items, NK1&& nk1, NK2&& nk2,
                                     Load&& load, Mma1&& mma1, Mma2&& mma2, Epi&& epi) {
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int g = 0;  // k-blocks issued so far
      for (int i = 0; i < items; ++i) {
        const int n = nk1(i) + nk2(i);
        for (int kb = 0; kb < n; ++kb, ++g) {
          const int s = g % STAGES;
          if (g >= STAGES) bar_wait(&r.empty[s], (g / STAGES - 1) & 1);
          bar_expect_tx(&r.full[s], kStageBytes);
          load(i, kb, r.a(s), r.b(s), &r.full[s]);
        }
      }
    }
    return;
  }
  int g = 0;  // k-blocks consumed so far
  // k-block kb of the item, through `mma`
  auto consume = [&](int kb, auto&& mma) {
    const int s = g % STAGES;
    bar_wait(&r.full[s], (g / STAGES) & 1);
    wgmma_fence();
    mma(kb, smem_u32(r.a(s)), smem_u32(r.b(s)));
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-block's products are done: free its stage
    if (kb > 0) bar_arrive(&r.empty[(g - 1) % STAGES]);
    ++g;
  };
  for (int i = 0; i < items; ++i) {
    const int n1 = nk1(i);
    const int n = n1 + nk2(i);
    int kb = 0;
    for (; kb < n1; ++kb) consume(kb, mma1);
    for (; kb < n; ++kb) consume(kb, mma2);
    wgmma_wait<0>();
    if (n > 0) bar_arrive(&r.empty[(g - 1) % STAGES]);
    epi(i);
  }
}

template <int STAGES, class NK, class Load, class Mma, class Epi>
__device__ __forceinline__ void run(const Ring<STAGES>& r, int items, NK&& nk, Load&& load,
                                    Mma&& mma, Epi&& epi) {
  run2(r, items, nk, [](int) { return 0; }, load, mma, mma, epi);
}

}  // namespace wg
