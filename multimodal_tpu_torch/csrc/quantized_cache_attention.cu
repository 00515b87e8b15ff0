// Decode attention of a few query rows against an int8 KV cache, for Hopper.
//
// Replaces: multimodal_tpu/ops/quantized_attention.py,
// `quantized_cache_attention` (kernel body `_kernel`).
//
// What it computes, per batch row b and kv head h, for the R = group * S
// query rows that share the head (a GQA group's heads stacked, each with its
// S rows), over L cache positions:
//   q'   = bf16(q)                                  (also for fp32 inputs)
//   s_j  = (q' . kq_j) * (k_scale_j * sm_scale)     fp32, kq_j int8 -> exact
//   s_j  = mask[b, s, j] ? s_j : -1e30
//   p_j  = exp(s_j - max s) / sum exp(s - max s)
//   p'_j = bf16(p_j * v_scale_j)
//   o    = sum_j p'_j vq_j                          fp32, then the output type
// The per-position scales ride the score and probability rows after the
// products (q . (k s) = (q . k) s, p . (v s) = (p s) . v), so the dense cache
// never exists anywhere: the int8 rows are read with 16-byte vector loads and
// converted in registers.
//
// What bounds it on this card: bytes. A decode tick reads the int8 K and V,
// 2 * b * h * L * d bytes, and 8 * b * h * L bytes of scales, for 4 FLOPs per
// cache byte. Only the positions it needs are read: a K or V row only where
// the mask lets some query row of the (kv head, batch row) see it (every V
// row for a row that sees nothing, whose p is 1 / L everywhere). So a slot
// at position 600 of a 4096-long cache reads 601 rows of K and V, not 4096.
//
// Design: flash-decoding that keeps the body's rounding point. The old
// kernel was one block per (kv head, batch row), a group, holding the whole
// score row in shared memory: at the LM's decode tick (33 slots x 12 heads,
// positions 600-3200 of 4096) the SMs that drew long slots set the pace while
// the rest idled, and shared memory capped the cache at about 6,700
// positions for 8 rows. Here the positions of a group are cut into runs of
// kRun = 256, and each run is a block of each of two kernels, so the total
// work and not the longest slot sets the pace:
//   the scores kernel (group, run): the run's scores of the positions some
//     row sees, into the fp32 score scratch (4 bytes a position and row
//     against the cache's 2 d + 8), and per row the run's max and sum of
//     exp(s - max) over all its positions (masked ones as -1e30, so a row
//     that sees none of the run gets -1e30 and the run's length, what the
//     whole-row softmax gives);
//   the values kernel (group, run): the row's max and sum from all runs'
//     pairs, in run order (every block of the group gets the same), p and
//     p' = bf16(p * v_scale) formed exactly as the body forms them (p
//     normalised by the row's max and sum before the rounding: a one-pass
//     merge of exp(s - run max) would round p' elsewhere), the run's fp32
//     partial output; the group's last block (a counter and __threadfence)
//     sums the runs' partials in run order and writes the output. No float
//     atomics: two calls are bitwise equal.
// The second kernel waits for the first by stream order, so no block ever
// waits for another (blocks that spun on a counter for their group's scores
// held their SM slots through the slowest run: 2x slower at the decode
// tick). The scores kernel zeroes the counters. What held the first
// versions was each block's chain of dependent round trips, the mask's
// above all (PERF.md), not the bytes: so a block stages its run's
// mask in one round trip, puts every copy it needs in flight at once by
// cp.async (K rows and scales; V rows and the scores the mask lets through,
// the run statistics read under them), and a run no row sees costs that
// round trip alone. Persistent blocks walking the runs two deep measured
// slower (0.104 against 0.074 ms at the decode tick). d / 16 lanes share a
// cache row (16 bytes each), a block covers 2048 / d positions a pass, and
// int8 becomes fp32 by a byte permute and an add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 256;      // cache positions of a run, a block's item
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;

struct QArgs {
  const void* q;
  long long qs[3];  // batch, head, row strides of q in elements (last dim contiguous)
  const int8_t* kq;
  const float* kscale;
  const int8_t* vq;
  const float* vscale;
  const uint8_t* mask;
  long long ms[3];  // batch, row, position strides of the bool mask (0 = broadcast)
  void* o;
  long long os[3];
  unsigned* done;  // [G] value blocks of group g finished
  float* scores;   // [G][rows][L]
  float* stats;    // [G][runs][rows][2]: a run's max and sum of exp(s - max)
  float* part;     // [G][runs][rows][D]: a run's partial output
  int Hkv, S, L, group, rows, runs, groups, bf16;
  float sm_scale;
};

// 16 int8 -> fp32, exactly: each byte, offset by 128, becomes the low
// mantissa byte of 2^23, and 2^23 + 128 comes off (a byte permute and an add
// each, where a conversion instruction runs at a quarter of their rate).
__device__ __forceinline__ void to_floats(const int4& raw, float (&x)[16]) {
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z, (uint32_t)raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[4 * i + k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
  }
}

// (m, l) of two parts of a row merged: the larger max, each sum rescaled to it.
__device__ __forceinline__ void merge_ml(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// The mask's bits of position j (bit s: mask row s sees it).
__device__ __forceinline__ unsigned mask_bits(const QArgs& a, const uint8_t* mrow, int j) {
  unsigned bits = 0;
  for (int s = 0; s < a.S; ++s) bits |= (unsigned)(mrow[s * a.ms[1] + j * a.ms[2]] != 0) << s;
  return bits;
}

// msk[j] <- the mask's bits of position j0 + j for j < n, 0 up to kRun;
// true when some row sees some position (the call is a block barrier).
__device__ __forceinline__ bool stage_mask(const QArgs& a, const uint8_t* mrow, int j0, int n,
                                           uint8_t* msk) {
  unsigned any = 0;
#pragma unroll
  for (int j = threadIdx.x; j < kRun; j += kThreads) {
    const unsigned bits = j < n ? mask_bits(a, mrow, j0 + j) : 0u;
    msk[j] = (uint8_t)bits;
    any |= bits;
  }
  return __syncthreads_or(any);
}

// 16 or 4 bytes global -> shared, asynchronously (no register holds them).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads) quantized_cache_attention_scores_kernel(QArgs a) {
  constexpr int TPK = D / 16;           // lanes sharing a cache row
  constexpr int PPB = kThreads / TPK;   // positions a pass covers
  constexpr int NP = kRun / PPB;        // passes of a run
  constexpr int U0 = R <= 2 ? 8 : R <= 4 ? 4 : 2;
  constexpr int U = U0 < NP ? U0 : NP;  // passes whose scores are merged together
  __shared__ __align__(16) int8_t k_s[kRun * D];
  __shared__ float ks_s[kRun];
  __shared__ uint8_t msk[kRun];
  __shared__ __align__(16) float q_s[R][D];
  __shared__ float ml_s[kWarps][R][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid / TPK;   // which position of a pass this thread reads
  const int part = tid % TPK;  // which 16 columns
  const int g = blockIdx.x / a.runs;
  const int run = blockIdx.x - g * a.runs;
  const int b = g / a.Hkv;
  const int h = g - b * a.Hkv;
  const int rows = a.rows;
  const int L = a.L;
  const int j0 = run * kRun;
  const int n = min(kRun, L - j0);  // the run's positions in the cache
  const uint8_t* mrow = a.mask + b * a.ms[0];
  if (run == 0 && tid == 0) a.done[g] = 0u;  // the values kernel's counter, by stream order
  // q's elements of this thread, loaded with the mask
  constexpr int QE = (R * D + kThreads - 1) / kThreads;
  float qx[QE];
#pragma unroll
  for (int e = 0; e < QE; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / D;
    qx[e] = 0.f;
    if (idx < R * D && r < rows) {
      const long long off = b * a.qs[0] + (h * a.group + r / a.S) * a.qs[1] +
                            (r % a.S) * a.qs[2] + (idx - r * D);
      qx[e] = a.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
                     : static_cast<const float*>(a.q)[off];
    }
  }
  float* st = a.stats + ((size_t)g * a.runs + run) * rows * 2;
  if (!stage_mask(a, mrow, j0, n, msk)) {
    // No row sees the run: n scores of -1e30 in every row, nothing read.
    if (tid < rows) {
      st[2 * tid] = kMasked;
      st[2 * tid + 1] = (float)n;
    }
    return;
  }
  int sh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sh[r] = r % a.S;
  const size_t row0 = (size_t)g * L + j0;  // = (b * Hkv + h) * L + j0
  float* sc = a.scores + (size_t)g * rows * L + j0;
  // The run's K rows some row may see and their scales, every copy in flight
  // at once.
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int jj = p * PPB + sub;
    if (msk[jj]) {
      cp_async16(k_s + jj * D + part * 16, a.kq + (row0 + jj) * D + part * 16);
      if (part == 0) cp_async4(ks_s + jj, a.kscale + row0 + jj);
    }
  }
  cp_async_commit();
  // q rounded to bf16, under the copies (the barrier below orders it)
#pragma unroll
  for (int e = 0; e < QE; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < R * D) (&q_s[0][0])[idx] = __bfloat162float(__float2bfloat16_rn(qx[e]));
  }
  float mx[R], sm[R];  // this thread's running max and sum of exp(s - max) per row
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mx[r] = -INFINITY;
    sm[r] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // the K scales, copied by another lane; q
#pragma unroll
  for (int p0 = 0; p0 < NP; p0 += U) {
    float s[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jj = (p0 + u) * PPB + sub;
      const unsigned bt = msk[jj];
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
      if (bt) {
        float kv[16];
        to_floats(*reinterpret_cast<const int4*>(k_s + jj * D + part * 16), kv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(&q_s[r][part * 16]);
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float4 x = qv[c4];
            dot[r] = fmaf(x.x, kv[4 * c4], dot[r]);
            dot[r] = fmaf(x.y, kv[4 * c4 + 1], dot[r]);
            dot[r] = fmaf(x.z, kv[4 * c4 + 2], dot[r]);
            dot[r] = fmaf(x.w, kv[4 * c4 + 3], dot[r]);
          }
        }
      }
      // every lane shuffles; the TPK lanes of a position agree on its bits
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1) dot[r] += __shfl_xor_sync(kFull, dot[r], o);
      const float f = bt ? ks_s[jj] * a.sm_scale : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool seen = (bt >> sh[r]) & 1u;
        s[u][r] = jj >= n ? -INFINITY : seen ? dot[r] * f : kMasked;
        if (seen && part == 0 && r < rows) sc[(size_t)r * L + jj] = s[u][r];
      }
    }
    // the passes' scores into the thread's (max, sum), once per row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float cm = mx[r];
#pragma unroll
      for (int u = 0; u < U; ++u) cm = fmaxf(cm, s[u][r]);
      if (cm == -INFINITY) continue;
      float l = sm[r] * expf(mx[r] - cm);
#pragma unroll
      for (int u = 0; u < U; ++u) l += expf(s[u][r] - cm);
      mx[r] = cm;
      sm[r] = l;
    }
  }
  // The run's (max, sum) per row: over the warp's positions (the TPK lanes of
  // a position hold the same pair), then over the warps in order.
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = TPK; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(kFull, mx[r], o);
      const float l2 = __shfl_xor_sync(kFull, sm[r], o);
      merge_ml(mx[r], sm[r], m2, l2);
    }
    if (lane == 0) {
      ml_s[warp][r][0] = mx[r];
      ml_s[warp][r][1] = sm[r];
    }
  }
  __syncthreads();
  if (tid < rows) {
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < kWarps; ++w) merge_ml(m, l, ml_s[w][tid][0], ml_s[w][tid][1]);
    st[2 * tid] = m;
    st[2 * tid + 1] = l;
  }
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads) quantized_cache_attention_values_kernel(QArgs a) {
  constexpr int TPK = D / 16;
  constexpr int PPB = kThreads / TPK;
  constexpr int NP = kRun / PPB;
  // the run's V rows (then each warp's partial output), p', V scales, mask
  __shared__ __align__(16) int8_t v_s[kRun * D];
  __shared__ float pv[R * kRun];
  __shared__ float vs_s[kRun];
  __shared__ uint8_t msk[kRun];
  static_assert(sizeof(float) * kWarps * R * D <= kRun * D, "the partials fit v_s");
  __shared__ float row_m[R], row_l[R];
  __shared__ unsigned last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid / TPK;
  const int part = tid % TPK;
  const int g = blockIdx.x / a.runs;
  const int run = blockIdx.x - g * a.runs;
  const int b = g / a.Hkv;
  const int h = g - b * a.Hkv;
  const int rows = a.rows;
  const int L = a.L;
  const int j0 = run * kRun;
  const int n = min(kRun, L - j0);
  const uint8_t* mrow = a.mask + b * a.ms[0];
  const size_t row0 = (size_t)g * L + j0;
  const float* sc = a.scores + (size_t)g * rows * L + j0;
  int sh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sh[r] = r % a.S;

  // The V scales (a row that sees nothing needs them all), the mask and the
  // first 32 runs' pairs of this warp's rows in flight together; then the V
  // rows some row may see and the scores the mask lets through, all in
  // flight at once (a score the mask hides was never written and is not
  // read); under them the row's max and sum from the runs' pairs.
  for (int j = tid; j < n; j += kThreads) cp_async4(vs_s + j, a.vscale + row0 + j);
  constexpr int RW = (R + kWarps - 1) / kWarps;  // rows of a warp
  const float* st = a.stats + (size_t)g * a.runs * rows * 2;
  float m0[RW], l0[RW];  // lane k's pair of run k
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * kWarps;
    const bool has = r < rows && lane < a.runs;
    m0[i] = has ? st[((size_t)lane * rows + r) * 2] : -INFINITY;
    l0[i] = has ? st[((size_t)lane * rows + r) * 2 + 1] : 0.f;
  }
  const bool seen_any = stage_mask(a, mrow, j0, n, msk);
  if (seen_any) {
    for (int p = 0; p < NP; ++p) {
      const int jj = p * PPB + sub;
      if (msk[jj]) cp_async16(v_s + jj * D + part * 16, a.vq + (row0 + jj) * D + part * 16);
    }
    for (int idx = tid; idx < rows * kRun; idx += kThreads) {
      const int r = idx / kRun;
      const int j = idx - r * kRun;
      if ((msk[j] >> (r % a.S)) & 1u)
        cp_async4(pv + idx, sc + (size_t)r * L + j);
      else
        pv[idx] = kMasked;
    }
  }
  cp_async_commit();
  // The max, then each lane's runs in order and the lanes in a fixed tree
  // (every block of the group gets the same).
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * kWarps;
    if (r >= rows) break;
    float m = m0[i];
    for (int k = lane + 32; k < a.runs; k += 32) m = fmaxf(m, st[((size_t)k * rows + r) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float l = lane < a.runs ? l0[i] * expf(m0[i] - m) : 0.f;
    for (int k = lane + 32; k < a.runs; k += 32) {
      const float* pk = st + ((size_t)k * rows + r) * 2;
      l += pk[1] * expf(pk[0] - m);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    if (lane == 0) {
      row_m[r] = m;
      row_l[r] = l;
    }
  }
  __syncthreads();  // row_m / row_l
  bool blind = false;  // a row that sees no position: p = 1 / L everywhere
#pragma unroll
  for (int r = 0; r < R; ++r) blind |= r < rows && row_m[r] == kMasked;

  float acc[R][16];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
  if (seen_any || blind) {  // else p' = 0 at every position: nothing to add
    if (blind) {  // every V row of the run, then
      for (int p = 0; p < NP; ++p) {
        const int jj = p * PPB + sub;
        if (jj < n && !msk[jj])
          cp_async16(v_s + jj * D + part * 16, a.vq + (row0 + jj) * D + part * 16);
      }
      if (!seen_any)
        for (int idx = tid; idx < rows * kRun; idx += kThreads) pv[idx] = kMasked;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // p and p' as the whole-row body forms them, in place
    for (int idx = tid; idx < rows * kRun; idx += kThreads) {
      const int r = idx / kRun;
      const int j = idx - r * kRun;
      float pq = 0.f;
      if (j < n) {
        const float p = expf(pv[idx] - row_m[r]) / row_l[r];
        pq = __bfloat162float(__float2bfloat16_rn(p * vs_s[j]));
      }
      pv[idx] = pq;
    }
    __syncthreads();
    // acc += p' . v over the rows some row may see
    for (int p = 0; p < NP; ++p) {
      const int jj = p * PPB + sub;
      if (jj >= n || !(msk[jj] || blind)) continue;
      float vv[16];
      to_floats(*reinterpret_cast<const int4*>(v_s + jj * D + part * 16), vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float w = r < rows ? pv[r * kRun + jj] : 0.f;
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(w, vv[c], acc[r][c]);
      }
    }
  } else {
    cp_async_wait<0>();
  }
  // The run's partial output: over the warp's position slots (lanes with the
  // same 16 columns), then over the warps in order.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int o = TPK; o < 32; o <<= 1) acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], o);
  float(*red)[R][D] = reinterpret_cast<float(*)[R][D]>(v_s);
  __syncthreads();  // every thread's V rows read
  if (lane < TPK) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) red[warp][r][part * 16 + c] = acc[r][c];
  }
  __syncthreads();
  float* part_out = a.part + ((size_t)g * a.runs + run) * rows * D;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[w][r][c];
    part_out[idx] = o;
  }
  // The run counts in: the block's stores, ordered by the barrier, then
  // released at the card's scope by the counting thread's fence.
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    last = atomicAdd(&a.done[g], 1u) == (unsigned)(a.runs - 1);
  }
  __syncthreads();
  if (!last) return;
  // The group's last block: the runs' partials summed in run order.
  __threadfence();
  const float* parts = a.part + (size_t)g * a.runs * rows * D;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    float o = 0.f;
    for (int k = 0; k < a.runs; ++k) o += __ldcg(parts + (size_t)k * rows * D + idx);
    const int r = idx / D;
    const int c = idx - r * D;
    const long long off =
        b * a.os[0] + (h * a.group + r / a.S) * a.os[1] + (r % a.S) * a.os[2] + c;
    if (a.bf16)
      static_cast<__nv_bfloat16*>(a.o)[off] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(a.o)[off] = o;
  }
}

template <int D, int R>
cudaError_t launch(const QArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long long)a.groups * a.runs);
  quantized_cache_attention_scores_kernel<D, R><<<blocks, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantized_cache_attention_values_kernel<D, R><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_rows(const QArgs& a, cudaStream_t stream) {
  if (a.rows <= 1) return launch<D, 1>(a, stream);
  if (a.rows <= 2) return launch<D, 2>(a, stream);
  if (a.rows <= 4) return launch<D, 4>(a, stream);
  return launch<D, 8>(a, stream);
}

}  // namespace

extern "C" {

// q (B, Hq, S, D) of `dtype` (0 = fp32, 1 = bf16), last dimension contiguous,
// other strides in elements; k_q / v_q (B, Hkv, L, D) int8 and k_scale /
// v_scale (B, Hkv, L) fp32, contiguous; mask: bool bytes with strides (batch,
// row, position), 0 on broadcast dimensions; out like q. Hq = group * Hkv,
// group * S <= 8, D in {32, 64, 128}. Positions are cut into runs of 256
// (kRun); `scratch` (16-byte aligned) holds, in order, the counters (G
// unsigned ints, G = B * Hkv, padded to 16 bytes), the scores (G * rows * L
// floats), the runs' statistics (G * runs * rows * 2) and partial outputs
// (G * runs * rows * D), rows = group * S, runs = ceil(L / 256):
// ops/quantized_attention.py:_workspace_bytes. Nothing of it needs
// initialising. Launches the two kernels on `stream`, allocates nothing,
// returns cudaGetLastError().
int mm_quantized_cache_attention(const void* q, const long long* q_strides, const void* k_q,
                                 const void* k_scale, const void* v_q, const void* v_scale,
                                 const void* mask, const long long* mask_strides, void* out,
                                 const long long* out_strides, void* scratch, int B, int Hq,
                                 int Hkv, int S, int L, int D, float sm_scale, int dtype,
                                 void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || L <= 0 || (Hq / Hkv) * S > 8 ||
      (D != 32 && D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.q = q;
  a.kq = static_cast<const int8_t*>(k_q);
  a.kscale = static_cast<const float*>(k_scale);
  a.vq = static_cast<const int8_t*>(v_q);
  a.vscale = static_cast<const float*>(v_scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i];
    a.ms[i] = mask_strides[i];
    a.os[i] = out_strides[i];
  }
  a.Hkv = Hkv;
  a.S = S;
  a.L = L;
  a.group = Hq / Hkv;
  a.rows = a.group * S;
  a.runs = (L + kRun - 1) / kRun;
  a.groups = B * Hkv;
  a.bf16 = dtype;
  a.sm_scale = sm_scale;
  const size_t counter_bytes = ((size_t)a.groups * sizeof(unsigned) + 15) / 16 * 16;
  a.done = static_cast<unsigned*>(scratch);
  a.scores = reinterpret_cast<float*>(static_cast<char*>(scratch) + counter_bytes);
  a.stats = a.scores + (size_t)a.groups * a.rows * L;
  a.part = a.stats + (size_t)a.groups * a.runs * a.rows * 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32) return (int)dispatch_rows<32>(a, st);
  if (D == 64) return (int)dispatch_rows<64>(a, st);
  return (int)dispatch_rows<128>(a, st);
}

}  // extern "C"
