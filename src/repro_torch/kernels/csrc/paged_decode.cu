// paged_decode / paged_decode_quant: single-token GQA attention over a
// block-table-indirected KV page pool, with bf16, fp32 or int8 pages, q
// and the output bf16 or fp32 (fp32 pages with fp32 q), fp32 softmax.
//
// Replaces src/repro/kernels/paged_decode.py::paged_decode (Pallas _kernel
// at :28, pallas_call at :161) and ::paged_decode_quant (_kernel_quant at
// :68, pallas_call at :112). The Pallas kernels run a grid (B, H, NP)
// whose page axis is walked in order on one TPU core, with the
// online-softmax state in VMEM scratch, the block table and the per-slot
// positions prefetched as scalars, and the pages past pos[b] skipped.
// Here a slot's pages are split across blocks instead: each (slot b, KV
// head, split) gets one block of four warps, where a split is a run of
// whole pages (at least 128 rows; more where the table needs more than
// 8 splits). The block serves all G <= 8 query heads that read that KV
// head, reads its split's page ids from
// tables[b, .] and pos[b] from device memory (the host reads neither, so
// a call never waits on it), and walks its rows up to pos[b] in tiles of
// 64, 16 rows per warp, each warp with its own online softmax; the warps
// merge in shared memory into the block's unnormalised partial state
// (running max, denominator, G x hd accumulator). The splits of one
// (b, KV head) form a thread block cluster (at most 8 blocks), and after
// a cluster barrier each block merges one slice of the outputs from all
// the splits' partial states, read from their shared memory (distributed
// shared memory), in split order. One launch, no scratch in device
// memory, no atomics: the same inputs give the same bits. The host knows
// no position, so every (slot, KV head) gets as many splits as its table
// could need (8 for a 1,024-row table); a block whose split lies wholly
// past pos[b] reads no page and exits at once (the cluster's barriers
// wait only for threads that have not exited), so a short slot costs
// little more than its rows and an idle block holds no SM while its
// cluster works. Split 0 always stays and writes the exactly-zero row of
// pos[b] < 0.
//
// What bounds it on the H100: bytes. Decode reads every KV row a slot has
// written once for its G query heads and does 4*G flops per element read,
// far below the card's ridge point; at the serve path's B = 8, 8 KV heads
// of 128, pages of 16, positions 1023/600/384/200/15/0 and two inactive
// slots that is 9.1 MB in bf16, 2.7 us. So the design keeps the rows in
// flight and little else in the way:
//   - Page-indirected asynchronous copies: a (page, KV head) is `page`
//     rows of hd contiguous elements, K*hd apart; 16-byte cp.async per
//     row chunk, the page id from shared memory, two 64-row tiles of K
//     and V in flight from the start (a 128-row split is wholly in
//     flight), double-buffered beyond. Rows past pos[b] are zero-filled
//     (src-size 0) and never read, so a recycled page's stale rows, NaN
//     among them, cannot reach the output.
//   - bf16 pages stay bf16 in shared memory, rows padded by 16 bytes
//     against bank conflicts (70 KB a block at hd 128). int8 pages are
//     copied as int8, half the bytes, and each warp widens its own 16
//     rows to bf16 (exactly: every |value| <= 127 is a bf16) in a
//     per-warp buffer just before the products; their fp32 (row, head)
//     scales come along by 4-byte cp.async.
//   - Both products on the tensor cores, mma.sync.m16n8k16 bf16 with fp32
//     accumulation, as in flash_decode.cu. Scores: S^T = K Q^T with 16
//     cache rows as M and the G query heads of a KV head as N (K by
//     ldmatrix, q held in registers). P V as O^T = V^T P^T: V^T by
//     ldmatrix.trans is the A operand, and P^T, the B operand, is the
//     score tile's C fragment transposed in registers by movmatrix.
//
// Numerics: q and k stay bf16 (int8 k widened exactly), the scores are
// exact products summed in fp32, scaled in fp32 by 1/sqrt(hd) (times the
// row's k scale for int8 pages: s_r = ks[r] * (q . kq_r)) in the exp2
// domain; the softmax is fp32 (2^x by ex2.approx); P enters P V as a bf16
// pair P_hi + P_lo (two mma), which holds it to about 2^-16 of its value,
// after the row's v scale is folded in (p_r * vs[r], int8 pages); the
// denominator sums P itself. A bf16 P alone would read 6-10 times the
// elementwise limit at the serve shapes, the pair 0.36-0.46 of it
// (tests/test_torch_kernels.py).
// Output acc / max(l, 1e-30) in bf16.
//
// fp32 q (a model at fp32 compute), over fp32 pages or int8 pages, takes
// the same blocks, splits, cluster and merges with every product an fp32
// FMA on the CUDA cores (DecF32 in common.cuh): fp32 pages in tiles of 32
// rows (8 per warp, 34 KB a stage at hd 128), int8 pages in the int8
// tiles above, each value converted to fp32 as it is read, the scales in
// fp32 as above. Output in fp32. At G <= 8 that is 2 G flops per fp32
// element read, at most 4 flops a byte, below the card's 20 (67 TFLOP/s
// fp32 over 3.35 TB/s): the bytes still bound it. A bf16 pair of each
// fp32 operand (2^-16 of its value) on the tensor cores would use 0.7-1.0
// of the fp32 limit 2e-5 + 2e-5 |plain| (tests/test_torch_fp32.py).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = kDecThreads;  // four warps
constexpr int kWarps = kDecWarps;
constexpr int kMaxG = kDecMaxG;        // query heads per KV head: the mma's N
constexpr int kMaxHd = 256;
constexpr int kMaxSplits = kDecMaxSplits;  // blocks of a cluster
constexpr int kSplitRows = 128;  // rows of a split, at least: two tiles

// Shared memory of a block, bytes: two stages of K and V tiles as the
// pages hold them (rows padded by 16 bytes), then for int8 pages under
// bf16 q each warp's bf16 rows, for int8 pages two stages of k and v
// scales, for fp32 q the heads' q and each warp's scratch, then the
// split's page ids. The merges reuse the tiles. Q: q's and the output's
// type; T: the pages'.
template <typename Q, typename T, int HDP>
struct Layout {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr bool kF32 = sizeof(Q) == 4;
  static constexpr int kRows = sizeof(T) == 4 ? 32 : 64;  // rows per tile
  static constexpr int kWarpRows = kRows / kWarps;
  static constexpr int kVals = 16 / sizeof(T);          // values per chunk
  static constexpr int kChunks = HDP / kVals;           // chunks per row
  static constexpr int kStride = HDP * sizeof(T) + 16;  // bytes per row
  static constexpr int kTileBytes = kRows * kStride;
  static constexpr int kStageBytes = 4 * kTileBytes;
  static constexpr int kBStride = HDP + 8;  // bf16 elements per row
  static constexpr int kWideBytes =
      kQuant && !kF32 ? kWarps * 16 * kBStride * 2 : 0;
  static constexpr int kScaleBytes = kQuant ? 2 * 2 * kRows * 4 : 0;
  using F32 = DecF32<HDP, kWarpRows>;
  static constexpr int kF32Bytes =
      kF32 ? (kMaxG * HDP + kWarps * F32::kScratch) * 4 : 0;
  static constexpr int kFixedBytes =
      kStageBytes + kWideBytes + kScaleBytes + kF32Bytes;
  static_assert(DecMerge<HDP>::kFloats * 4 <= kStageBytes,
                "merges fit the tiles");
  static_assert(sizeof(T) != 2 || kBStride * 2 == kStride,
                "bf16 rows as ldmatrix's");
  static_assert(kThreads % kChunks == 0 && (!kQuant || 2 * kRows == kThreads),
                "a thread copies one column of chunks and one scale");
};

// 4 bytes from global to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// four int8 (one word) as two bf16 pairs, exactly: byte x + 128 (0..255)
// as the low mantissa bits of 2^23, less 2^23 + 128, in fp32; the fp32
// result has at most 8 significant bits, so its upper half is the bf16.
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// A warp's 16 int8 rows (row stride `stride` bytes) as bf16 rows of
// HDP + 8 elements in dst.
template <int HDP>
__device__ __forceinline__ void widen_rows(const unsigned char* src,
                                           int stride, __nv_bfloat16* dst,
                                           int lane) {
  constexpr int kChunks = HDP / 16;  // 16 bytes in, 32 out
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / kChunks, c = i % kChunks;
    const uint4 x = *reinterpret_cast<const uint4*>(src + r * stride + c * 16);
    uint4 lo, hi;
    widen4(x.x, lo.x, lo.y);
    widen4(x.y, lo.z, lo.w);
    widen4(x.z, hi.x, hi.y);
    widen4(x.w, hi.z, hi.w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * (HDP + 8) + c * 16);
    // a quarter-warp's eight chunks of a row land on all 32 banks
    const int h = (c >> 2) & 1;
    d[h] = h ? hi : lo;
    d[h ^ 1] = h ? lo : hi;
  }
}

// q: (B,1,H,hd) Q; kp/vp: (P,page,K,hd) T; ks/vs: (P,page,K) fp32 (int8
// pages); tables: (B,NP) int32; pos: (B,) int32; out: (B,1,H,hd) Q.
// hd <= HDP; columns hd..HDP are zero in shared memory and in q's
// fragments (or q's fp32 rows). Block (bk = b*K + kh, split); the
// gridDim.y splits of a bk are one cluster.
template <typename Q, typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Q* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, Q* __restrict__ out, int NP,
                    int page, int K, int hd, int G, int split_pages,
                    float scale_log2) {
  using L = Layout<Q, T, HDP>;
  constexpr int kKSteps = HDP / 16;  // k-steps of the scores, m-tiles of O^T
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kh = bk % K, H = G * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kst = smem;                       // two stages of K
  unsigned char* vst = smem + 2 * L::kTileBytes;   // two stages of V
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(
      smem + L::kStageBytes) + warp * 16 * L::kBStride;  // int8: this warp's
  float* ksc = reinterpret_cast<float*>(smem + L::kStageBytes +
                                        L::kWideBytes);   // [2][kRows]
  float* vsc = ksc + 2 * L::kRows;                        // [2][kRows]
  // fp32 q: the heads' q rows, then the warps' scratch
  float* qs = reinterpret_cast<float*>(smem + L::kStageBytes +
                                       L::kWideBytes + L::kScaleBytes);
  int* pid = reinterpret_cast<int*>(smem + L::kFixedBytes);  // split_pages
  float* smem_f = reinterpret_cast<float*>(smem);

  // q as the B operand of S^T = K Q^T: head g, columns 2t.. of each step;
  // its loads, pos[b]'s and the split's first page ids' in flight at once
  // (fp32 q: the heads' rows go to shared memory below)
  uint32_t qf[L::kF32 ? 1 : kKSteps][2];
  if constexpr (!L::kF32) {
    const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(q) +
                              (static_cast<size_t>(b) * H + kh * G + g) * hd;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kk * 16 + half * 8 + 2 * t;
        qf[kk][half] = g < G && d < hd
                           ? *reinterpret_cast<const uint32_t*>(qh + d)
                           : 0u;
      }
  }

  const int p0 = split * split_pages;
  const int* tb = tables + static_cast<size_t>(b) * NP + p0;
  const int pb = pos[b];
  const int i0 = threadIdx.x;
  const int id0 = i0 < split_pages && p0 + i0 < NP ? tb[i0] : 0;
  const int last = min(pb, NP * page - 1);  // < 0: no row
  // The splits that hold rows <= pos[b] stay, and split 0 always (it
  // writes the zero row of pos[b] < 0); the others leave before any
  // barrier: a cluster barrier waits for the threads that have not exited,
  // and the merge reads only the splits that stay.
  const int nkeep = last < 0 ? 1 : min(static_cast<int>(gridDim.y),
                                       last / (split_pages * page) + 1);
  if (split >= nkeep) return;
  if (i0 < split_pages) pid[i0] = id0;
  for (int i = i0 + kThreads; i < split_pages; i += kThreads)
    pid[i] = p0 + i < NP ? tb[i] : 0;
  const int r_begin = p0 * page;
  const int r_end = min(r_begin + split_pages * page, last + 1);  // exclusive
  const int ntiles = r_end > r_begin ? (r_end - r_begin + L::kRows - 1) /
                                           L::kRows
                                     : 0;
  if constexpr (L::kF32) {
    const float* qb = reinterpret_cast<const float*>(q) +
                      (static_cast<size_t>(b) * H + kh * G) * hd;
    for (int i = threadIdx.x; i < kMaxG * HDP; i += kThreads) {
      const int hq = i / HDP, d = i % HDP;
      qs[i] = hq < G && d < hd ? qb[hq * hd + d] : 0.f;
    }
  }
  __syncthreads();  // pid, qs

  // the (page, head) row of logical row r0 + r of this split, r < r_end:
  // pid[lp] * page + rip, with lp, rip = divmod(r0 + r - r_begin, page)
  auto row_of = [&](int lp, int rip) {
    return (static_cast<size_t>(pid[lp]) * page + rip) * K + kh;
  };
  auto stage = [&](int st, int r0) {
    unsigned char* kd = kst + st * L::kTileBytes;
    unsigned char* vd = vst + st * L::kTileBytes;
    // thread: chunk c of rows r, r + kStep, ...; the page walked, not
    // divided, from one row to the next
    constexpr int kStep = kThreads / L::kChunks;
    const int c = threadIdx.x % L::kChunks;
    int r = threadIdx.x / L::kChunks;
    int lp = (r0 + r - r_begin) / page, rip = r0 + r - r_begin - lp * page;
#pragma unroll 4
    for (; r < L::kRows; r += kStep) {
      const bool ok = r0 + r < r_end && c * L::kVals < hd;
      const size_t off = ok ? row_of(lp, rip) * hd + c * L::kVals : 0;
      cp_async16(kd + r * L::kStride + c * 16, kp + off, ok ? 16 : 0);
      cp_async16(vd + r * L::kStride + c * 16, vp + off, ok ? 16 : 0);
      for (rip += kStep; rip >= page; rip -= page) ++lp;
    }
    if constexpr (L::kQuant) {
      // k scales by threads 0..63, v scales by 64..127
      const int rs = threadIdx.x % L::kRows;
      const bool ok = r0 + rs < r_end;
      const int lps = (r0 + rs - r_begin) / page;
      const size_t off =
          ok ? row_of(lps, r0 + rs - r_begin - lps * page) : 0;
      float* dst = (threadIdx.x < L::kRows ? ksc : vsc) + st * L::kRows + rs;
      cp_async4(dst, (threadIdx.x < L::kRows ? ks : vs) + off, ok ? 4 : 0);
    }
  };

  // split 0 of a slot with no row has no tiles, but stays for the merge
  if (ntiles > 0) stage(0, r_begin);
  cp_async_commit();
  if (ntiles > 1) stage(1, r_begin + L::kRows);
  cp_async_commit();

  if constexpr (L::kF32) {
    float* scratch = qs + kMaxG * HDP + warp * L::F32::kScratch;
    typename L::F32 st;
    st.init();
    for (int j = 0; j < ntiles; ++j) {
      cp_async_wait<1>();  // tile j has landed; tile j + 1 may still fly
      __syncthreads();
      const int r0 = r_begin + j * L::kRows + warp * L::kWarpRows;
      if (r0 < r_end) {
        const int wrow = (j & 1) * L::kRows + warp * L::kWarpRows;
        const int off = (j & 1) * L::kTileBytes +
                        warp * L::kWarpRows * L::kStride;
        st.template tile<T>(reinterpret_cast<const T*>(kst + off),
                            reinterpret_cast<const T*>(vst + off),
                            L::kStride / static_cast<int>(sizeof(T)), qs,
                            scratch, r_end - r0,
                            L::kQuant ? ksc + wrow : nullptr,
                            L::kQuant ? vsc + wrow : nullptr, scale_log2, G,
                            lane);
      }
      __syncthreads();  // stage j & 1 is consumed before it is refilled
      if (j + 2 < ntiles) stage(j & 1, r_begin + (j + 2) * L::kRows);
      cp_async_commit();
    }
    cp_async_wait<0>();
    st.publish(smem_f, warp, lane);
  } else {
    // acc[mt]: O^T rows (columns of the output) mt*16 + g and + 8, heads
    // 2t and 2t + 1; m and l of heads 2t, 2t + 1 (l: this thread's rows)
    float acc[kKSteps][4];
#pragma unroll
    for (int mt = 0; mt < kKSteps; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int j = 0; j < ntiles; ++j) {
      const int st = j & 1;
      cp_async_wait<1>();  // tile j has landed; tile j + 1 may still fly
      __syncthreads();
      const int r0 = r_begin + j * L::kRows + warp * 16;  // warp's first row
      if (r0 < r_end) {
        const int wrow = st * L::kRows + warp * 16;  // the warp's tile rows
        const unsigned char* kt = kst + st * L::kTileBytes +
                                  warp * 16 * L::kStride;
        const unsigned char* vt = vst + st * L::kTileBytes +
                                  warp * 16 * L::kStride;
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(kt);
        if constexpr (L::kQuant) {
          widen_rows<HDP>(kt, L::kStride, wide, lane);
          __syncwarp();
          kb = wide;
        }
        // s: rows g, g + 8 (of the warp's 16) x heads 2t, 2t + 1
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, kb + (lane & 15) * L::kBStride + kk * 16 +
                             (lane >> 4) * 8);
          mma_bf16(s, a, qf[kk][0], qf[kk][1]);
        }
        const bool ok_a = r0 + g < r_end, ok_b = r0 + g + 8 < r_end;
        float sa = scale_log2, sb = scale_log2;
        if constexpr (L::kQuant) {
          sa *= ksc[wrow + g];
          sb *= ksc[wrow + g + 8];
        }
        s[0] = ok_a ? s[0] * sa : -INFINITY;
        s[1] = ok_a ? s[1] * sa : -INFINITY;
        s[2] = ok_b ? s[2] * sb : -INFINITY;
        s[3] = ok_b ? s[3] * sb : -INFINITY;
        // max over the 16 rows: the eight lanes sharing t
        float mx0 = fmaxf(m0, fmaxf(s[0], s[2]));
        float mx1 = fmaxf(m1, fmaxf(s[1], s[3]));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // row r0 is valid, so both maxima are finite
        const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        s[0] = fast_exp2(s[0] - mx0);
        s[1] = fast_exp2(s[1] - mx1);
        s[2] = fast_exp2(s[2] - mx0);
        s[3] = fast_exp2(s[3] - mx1);
        l0 = l0 * alpha0 + s[0] + s[2];
        l1 = l1 * alpha1 + s[1] + s[3];
#pragma unroll
        for (int mt = 0; mt < kKSteps; ++mt) {
          acc[mt][0] *= alpha0;
          acc[mt][1] *= alpha1;
          acc[mt][2] *= alpha0;
          acc[mt][3] *= alpha1;
        }
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(vt);
        if constexpr (L::kQuant) {
          // the v scale rides on P: sum_r p_r vs_r vq_r
          const float va = vsc[wrow + g], vb8 = vsc[wrow + g + 8];
          s[0] *= va;
          s[1] *= va;
          s[2] *= vb8;
          s[3] *= vb8;
          __syncwarp();  // K's rows are read
          widen_rows<HDP>(vt, L::kStride, wide, lane);
          __syncwarp();
          vb = wide;
        }
        // P^T as the B operand: rows 2t, 2t + 1 (and + 8) of head g
        uint32_t hi_a, lo_a, hi_b, lo_b;
        split_bf16x2(s[0], s[1], hi_a, lo_a);
        split_bf16x2(s[2], s[3], hi_b, lo_b);
        const uint32_t bh0 = movmatrix_trans(hi_a), bh1 = movmatrix_trans(hi_b);
        const uint32_t bl0 = movmatrix_trans(lo_a), bl1 = movmatrix_trans(lo_b);
#pragma unroll
        for (int mt = 0; mt < kKSteps; ++mt) {
          uint32_t a[4];  // V^T rows mt*16.., the warp's 16 cache rows
          ldmatrix_x4_trans(a, vb + ((lane & 7) + (lane >> 4) * 8) * L::kBStride +
                                   mt * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[mt], a, bh0, bh1);
          mma_bf16(acc[mt], a, bl0, bl1);
        }
      }
      __syncthreads();  // stage st is consumed before it is refilled
      if (j + 2 < ntiles) stage(st, r_begin + (j + 2) * L::kRows);
      cp_async_commit();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // this warp's state for the merges (the tiles are consumed)
    float* wm = DecMerge<HDP>::wm(smem_f);
    float* wl = DecMerge<HDP>::wl(smem_f);
    if (g == 0) {
      wm[warp * kMaxG + 2 * t] = m0;
      wm[warp * kMaxG + 2 * t + 1] = m1;
      wl[warp * kMaxG + 2 * t] = l0;
      wl[warp * kMaxG + 2 * t + 1] = l1;
    }
    float* wa = DecMerge<HDP>::wacc(smem_f) + warp * kMaxG * HDP;
#pragma unroll
    for (int mt = 0; mt < kKSteps; ++mt) {
      const int d = mt * 16 + g;
      wa[(2 * t) * HDP + d] = acc[mt][0];
      wa[(2 * t + 1) * HDP + d] = acc[mt][1];
      wa[(2 * t) * HDP + d + 8] = acc[mt][2];
      wa[(2 * t + 1) * HDP + d + 8] = acc[mt][3];
    }
  }
  decode_merge<HDP>(smem_f, G, hd, split, nkeep,
                    out + (static_cast<size_t>(b) * H + kh * G) * hd);
}

template <typename Q, typename T, int HDP>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* pos, void* out,
           int B, int NP, int page, int K, int hd, int G, int split_pages,
           int nsplit, cudaStream_t st) {
  using L = Layout<Q, T, HDP>;
  const int smem = L::kFixedBytes + (split_pages * 4 + 15) / 16 * 16;
  auto kernel = paged_decode_kernel<Q, T, HDP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K, nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Q*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<Q*>(out), NP, page, K, hd, G,
      split_pages, scale_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q, typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* tables, const void* pos, void* out,
             int B, int NP, int page, int K, int hd, int G, void* stream) {
  constexpr int kVals = 16 / sizeof(T);
  if (G < 1 || G > kMaxG || hd < kVals || hd > kMaxHd || hd % kVals != 0 ||
      page < 1 || NP < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // runs of whole pages, at least kSplitRows rows, at most kMaxSplits
  const int by_rows = (kSplitRows + page - 1) / page;
  const int by_count = (NP + kMaxSplits - 1) / kMaxSplits;
  const int split_pages = by_rows > by_count ? by_rows : by_count;
  const int nsplit = (NP + split_pages - 1) / split_pages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_DECODE_LAUNCH(HDP)                                            \
  launch<Q, T, HDP>(q, kp, vp, ks, vs, tables, pos, out, B, NP, page, K, hd, \
                    G, split_pages, nsplit, st)
  if (hd <= 32) return PAGED_DECODE_LAUNCH(32);
  if (hd <= 64) return PAGED_DECODE_LAUNCH(64);
  if (hd <= 128) return PAGED_DECODE_LAUNCH(128);
  return PAGED_DECODE_LAUNCH(256);
#undef PAGED_DECODE_LAUNCH
}

}  // namespace

// A slot's NP table entries split into at most 8 runs of whole pages, one
// block each, one cluster per (slot, KV head). f32: q, the pages and the
// output are fp32 (else bf16).
extern "C" int launch_paged_decode(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* pos, void* out,
                                   int B, int NP, int page, int K, int hd, int G,
                                   int f32, void* stream) {
  if (f32)
    return dispatch<float, float>(q, kp, vp, nullptr, nullptr, tables, pos,
                                  out, B, NP, page, K, hd, G, stream);
  return dispatch<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, nullptr, nullptr,
                                                tables, pos, out, B, NP, page,
                                                K, hd, G, stream);
}

// f32: q and the output are fp32 (else bf16); the pages are int8
extern "C" int launch_paged_decode_quant(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* tables,
                                         const void* pos, void* out, int B,
                                         int NP, int page, int K, int hd,
                                         int G, int f32, void* stream) {
  if (f32)
    return dispatch<float, int8_t>(q, kp, vp, ks, vs, tables, pos, out, B, NP,
                                   page, K, hd, G, stream);
  return dispatch<__nv_bfloat16, int8_t>(q, kp, vp, ks, vs, tables, pos, out,
                                         B, NP, page, K, hd, G, stream);
}
