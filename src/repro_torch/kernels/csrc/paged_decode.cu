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
// 64 (fp32 pages: 32, below), 16 rows per warp, each warp with its own
// online softmax; the warps
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
// the same blocks, splits, cluster and merges, both products on the tensor
// cores too, with every fp32 operand in pieces that together carry fp32's
// precision. A bf16 pair of each fp32 operand (2^-16 of its value) would
// use 0.17-0.53 of JAX's fp32 limit 2e-5 + 2e-5 |plain| at the serve pool
// before the tensor core's truncating sums, these pieces 0.013-0.027
// (emulated, tests/test_torch_fp32.py; 0.012-0.015 on the card):
//   - int8 pages (paged_decode_bf16x3_kernel): the int8 tiles, their
//     scales and the widening to bf16 as above, exact. q is split once per
//     block into three bf16 pieces q1 + q2 + q3 (8 + 8 + 8 significant
//     bits, about 2^-27 of q), and P^T into three the same way; each
//     product is three mma.m16n8k16 of exact bf16 products: S^T = K q1^T
//     in one sum and K q2^T + K q3^T in another, added in fp32 after the
//     row's last k-step; O^T = V^T P1^T from zero and V^T P2^T + V^T P3^T
//     from zero for each 16-row tile, added in fp32 and folded into the
//     accumulator in the rescale's fma. Six bf16 products per 16 rows
//     where the bf16 path issues three.
//   - fp32 pages (paged_decode_tf32x3_kernel): 3xTF32 on
//     mma.sync.m16n8k8.tf32 as fp32 flash_attention (tf32_round,
//     split_tf32, mma_tf32 in common.cuh), through the tile that fp32
//     flash_decode shares (DecTf32 in common.cuh): raw fp32 tiles of 32
//     rows in shared memory, two stages (67 KB a block at hd 128, three
//     blocks an SM), split hi/lo in registers; q split once per block; two
//     warps on each 16 rows, each with half the scores' k-steps (the two
//     partial sums added through shared memory, the same sum in both) and
//     half of O^T's m-tiles, both keeping the same softmax. At G = 2 the
//     products no longer hide behind the bytes (three TF32 mma for each,
//     2 of their 8 columns used). Tiles of 64 rows, a 128-row split wholly
//     in flight, take 135 KB and one block an SM: the serve pool's call
//     then took 0.0310 ms where 32-row tiles took 0.0244 (one call, NVIDIA
//     H100 80GB HBM3 at 700 W; PERF.md §6).
// The tensor core's fp32 accumulate aligns a step's addends to the largest
// and truncates, so a leading product and its corrections never share a
// running sum (PERF.md §6). q is loaded with pos[b] and the page ids and
// split while the first pages fly; over int8 pages its pieces sit in
// registers up to HDP 128 and in shared memory, in fragment order, at HDP
// 256. Output in fp32.
// At G <= 8 these paths do 2 G flops per element read: the bytes still
// bound them.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = kDecThreads;  // four warps
constexpr int kWarps = kDecWarps;
constexpr int kMaxG = kDecMaxG;        // query heads per KV head: the mma's N
constexpr int kMaxHd = 256;
constexpr int kMaxSplits = kDecMaxSplits;  // blocks of a cluster
constexpr int kSplitRows = 128;  // rows of a split, at least: two 64-row tiles

// Shared memory of a block, bytes: two stages of K and V tiles as the
// pages hold them (rows padded by 16 bytes), then for int8 pages each
// warp's bf16 rows and two stages of k and v scales, for fp32 q over int8
// pages at HDP 256 q's pieces, for fp32 pages the warps' partial scores,
// then the split's page ids. The merges reuse the tiles. Q: q's and the
// output's type; T: the pages'.
template <typename Q, typename T, int HDP>
struct Layout {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr bool kF32 = sizeof(Q) == 4;
  static constexpr bool kTf32 = sizeof(T) == 4;  // fp32 pages: 3xTF32
  // rows per tile: 64, 16 a warp; fp32 pages 32, 16 a pair of warps that
  // split each product's work (at the same 67 KB a block at hd 128, three
  // blocks an SM)
  static constexpr int kRows = kTf32 ? 32 : 64;
  static constexpr int kVals = 16 / sizeof(T);          // values per chunk
  static constexpr int kChunks = HDP / kVals;           // chunks per row
  static constexpr int kStride = HDP * sizeof(T) + 16;  // bytes per row
  static constexpr int kTileBytes = kRows * kStride;
  static constexpr int kStageBytes = 4 * kTileBytes;
  static constexpr int kBStride = HDP + 8;  // bf16 elements per row
  static constexpr int kWideBytes = kQuant ? kWarps * 16 * kBStride * 2 : 0;
  static constexpr int kScaleBytes = kQuant ? 2 * 2 * kRows * 4 : 0;
  // fp32 q: a lane's words of q's pieces as B fragments, three bf16 pieces
  // of each pair over int8 pages (in registers up to HDP 128, else in
  // shared memory), a TF32 hi and lo of each value over fp32 pages (the
  // warp's half of the columns, in registers)
  static constexpr int kQWords =
      !kF32 ? 0 : kQuant ? 6 * (HDP / 16) : 4 * (HDP / 16);
  static constexpr bool kQRegs = kTf32 || HDP <= 128;
  static constexpr int kQBytes = kQRegs ? 0 : kQWords * 32 * 4;
  static constexpr int kXBytes = kTf32 ? DecTf32<HDP>::kXBytes : 0;
  static constexpr int kFixedBytes =
      kStageBytes + kWideBytes + kScaleBytes + kQBytes + kXBytes;
  static_assert(DecMerge<HDP>::kFloats * 4 <= kStageBytes,
                "merges fit the tiles");
  static_assert(sizeof(T) != 2 || kBStride * 2 == kStride,
                "bf16 rows as ldmatrix's");
  static_assert(kThreads % kChunks == 0 && (!kQuant || 2 * kRows == kThreads),
                "a thread copies one column of chunks and one scale");
  static_assert(kF32 || !kTf32, "fp32 pages take fp32 q");
  static_assert(!kTf32 || (kRows == DecTf32<HDP>::kRows &&
                           kStride == DecTf32<HDP>::kStride * 4),
                "fp32 tiles as DecTf32's");
};

// A lane's fragment words of fp32 q's pieces: registers, or a warp's 32
// words of each side by side in shared memory (no bank conflict)
template <int N, bool kRegs>
struct QPieces {
  uint32_t r[kRegs && N > 0 ? N : 1];
  uint32_t* s;
  __device__ __forceinline__ void put(int i, uint32_t w, int lane) {
    if constexpr (kRegs)
      r[i] = w;
    else
      s[i * 32 + lane] = w;
  }
  __device__ __forceinline__ uint32_t operator()(int i, int lane) const {
    if constexpr (kRegs)
      return r[i];
    else
      return s[i * 32 + lane];
  }
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
// fragments. Block (bk = b*K + kh, split); the gridDim.y splits of a bk
// are one cluster.
template <typename Q, typename T, int HDP>
__device__ __forceinline__ void paged_decode_block(
    const Q* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    const int* __restrict__ pos, Q* __restrict__ out, int NP, int page, int K,
    int hd, int G, int split_pages, float scale_log2) {
  using L = Layout<Q, T, HDP>;
  constexpr int kKSteps = HDP / 16;  // k-steps of the scores, m-tiles of O^T
  constexpr bool kTf32 = L::kTf32;
  // fp32 pages: warps w and w + 2 take the same 16 rows, each half h = w /
  // 2 of the scores' k-steps and of O^T's m-tiles (DecTf32)
  constexpr int kMT = kTf32 ? DecTf32<HDP>::kMT : kKSteps;  // a warp's m-tiles
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kh = bk % K, H = G * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = kTf32 ? (warp & 1) * 16 : warp * 16;  // the warp's rows
  const int half = kTf32 ? warp >> 1 : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kst = smem;                       // two stages of K
  unsigned char* vst = smem + 2 * L::kTileBytes;   // two stages of V
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(
      smem + L::kStageBytes) + warp * 16 * L::kBStride;  // int8: this warp's
  float* ksc = reinterpret_cast<float*>(smem + L::kStageBytes +
                                        L::kWideBytes);   // [2][kRows]
  float* vsc = ksc + 2 * L::kRows;                        // [2][kRows]
  unsigned char* qsm = smem + L::kStageBytes + L::kWideBytes + L::kScaleBytes;
  float4* xch = reinterpret_cast<float4*>(qsm + L::kQBytes);  // fp32 pages
  int* pid = reinterpret_cast<int*>(smem + L::kFixedBytes);  // split_pages
  float* smem_f = reinterpret_cast<float*>(smem);

  // q as the B operand of S^T = K Q^T: head g, columns 2t.. of each step;
  // its loads, pos[b]'s and the split's first page ids' in flight at once
  uint32_t qf[L::kF32 ? 1 : kKSteps][2];
  if constexpr (!L::kF32) {
    const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(q) +
                              (static_cast<size_t>(b) * H + kh * G + g) * hd;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = kk * 16 + hf * 8 + 2 * t;
        qf[kk][hf] = g < G && d < hd
                         ? *reinterpret_cast<const uint32_t*>(qh + d)
                         : 0u;
      }
  }
  // fp32 q, loaded here and split once the pages are in flight: int8
  // pages, columns kk*16 + hf*8 + 2t, + 1 (m16n8k16's b0, b1); fp32 pages,
  // columns 8 kk + t and + 4 of the warp's k-steps (m16n8k8's b0, b1)
  constexpr int kQRaw =
      !L::kF32 ? 1 : L::kQuant ? 4 * kKSteps : 2 * DecTf32<HDP>::kSK;
  float qv[kQRaw];
  if constexpr (L::kF32) {
    if (L::kQRegs || warp == 0) {
      const float* qh = reinterpret_cast<const float*>(q) +
                        (static_cast<size_t>(b) * H + kh * G + g) * hd;
      if constexpr (L::kQuant) {
#pragma unroll
        for (int i = 0; i < 2 * kKSteps; ++i) {
          const int d = i * 8 + 2 * t;  // k-step i / 2, half i % 2
          const float2 x = g < G && d < hd
                               ? *reinterpret_cast<const float2*>(qh + d)
                               : make_float2(0.f, 0.f);
          qv[2 * i] = x.x;
          qv[2 * i + 1] = x.y;
        }
      } else {
        DecTf32<HDP>::load_q(qh, g < G, hd, half, t, qv);
      }
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
  __syncthreads();  // pid

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

  // fp32 q's pieces, while the pages fly: int8 pages, word 6 kk + 3 hf + i
  // is piece i of k-step kk's b0 (hf 0) or b1 (hf 1); fp32 pages, words
  // 4 kk .. 4 kk + 3 are the hi of the warp's k-step kk's b0, b1, then
  // their lo. In shared memory (int8 pages at HDP 256) warp 0 writes them
  // before the loop's first barrier.
  QPieces<L::kQWords, L::kQRegs> qp;
  qp.s = reinterpret_cast<uint32_t*>(qsm);
  if constexpr (L::kF32) {
    if (L::kQRegs || warp == 0) {
      if constexpr (L::kQuant) {
#pragma unroll
        for (int i = 0; i < 2 * kKSteps; ++i) {
          uint32_t w[3];
          split_bf16x3(qv[2 * i], qv[2 * i + 1], w[0], w[1], w[2]);
#pragma unroll
          for (int p = 0; p < 3; ++p) qp.put(3 * i + p, w[p], lane);
        }
      } else {
        DecTf32<HDP>::split_q(qv, qp.r);
      }
    }
  }

  // acc[mt]: O^T rows (columns of the output) mt*16 + g and + 8 (fp32
  // pages: DecTf32's), heads 2t and 2t + 1; m and l of heads 2t, 2t + 1
  // (l: this thread's rows)
  float acc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    cp_async_wait<1>();  // tile j has landed; tile j + 1 may still fly
    __syncthreads();
    const int r0 = r_begin + j * L::kRows + wr;  // warp's first row
    if (r0 < r_end) {
      const unsigned char* kt = kst + st * L::kTileBytes + wr * L::kStride;
      const unsigned char* vt = vst + st * L::kTileBytes + wr * L::kStride;
      if constexpr (kTf32) {
        DecTf32<HDP>::tile(reinterpret_cast<const float*>(kt),
                           reinterpret_cast<const float*>(vt), qp.r, xch,
                           r_end - r0, scale_log2, acc, m0, m1, l0, l1, warp,
                           lane);
      } else {
        const int wrow = st * L::kRows + wr;  // the warp's tile rows
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(kt);
        if constexpr (L::kQuant) {
          widen_rows<HDP>(kt, L::kStride, wide, lane);
          __syncwarp();
          kb = wide;
        }
        // s: rows g, g + 8 (of the warp's 16) x heads 2t, 2t + 1
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (!L::kF32) {
#pragma unroll
          for (int kk = 0; kk < kKSteps; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, kb + (lane & 15) * L::kBStride + kk * 16 +
                               (lane >> 4) * 8);
            mma_bf16(s, a, qf[kk][0], qf[kk][1]);
          }
        } else {
          // q1 k in s, q2 k + q3 k in sx
          float sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kKSteps; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, kb + (lane & 15) * L::kBStride + kk * 16 +
                               (lane >> 4) * 8);
            mma_bf16(s, a, qp(6 * kk, lane), qp(6 * kk + 3, lane));
            mma_bf16(sx, a, qp(6 * kk + 1, lane), qp(6 * kk + 4, lane));
            mma_bf16(sx, a, qp(6 * kk + 2, lane), qp(6 * kk + 5, lane));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[e] += sx[e];
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
        if constexpr (!L::kF32) {
#pragma unroll
          for (int mt = 0; mt < kKSteps; ++mt) {
            acc[mt][0] *= alpha0;
            acc[mt][1] *= alpha1;
            acc[mt][2] *= alpha0;
            acc[mt][3] *= alpha1;
          }
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
        if constexpr (!L::kF32) {
          // P^T as the B operand: rows 2t, 2t + 1 (and + 8) of head g
          uint32_t hi_a, lo_a, hi_b, lo_b;
          split_bf16x2(s[0], s[1], hi_a, lo_a);
          split_bf16x2(s[2], s[3], hi_b, lo_b);
          const uint32_t bh0 = movmatrix_trans(hi_a),
                         bh1 = movmatrix_trans(hi_b);
          const uint32_t bl0 = movmatrix_trans(lo_a),
                         bl1 = movmatrix_trans(lo_b);
#pragma unroll
          for (int mt = 0; mt < kKSteps; ++mt) {
            uint32_t a[4];  // V^T rows mt*16.., the warp's 16 cache rows
            ldmatrix_x4_trans(a, vb +
                                     ((lane & 7) + (lane >> 4) * 8) *
                                         L::kBStride +
                                     mt * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(acc[mt], a, bh0, bh1);
            mma_bf16(acc[mt], a, bl0, bl1);
          }
        } else {
          // P^T in three bf16 pieces, each transposed as above: piece i of
          // rows 2t, 2t + 1 (b0) and + 8 (b1) of head g
          uint32_t pa[3], pb[3];
          split_bf16x3(s[0], s[1], pa[0], pa[1], pa[2]);
          split_bf16x3(s[2], s[3], pb[0], pb[1], pb[2]);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            pa[i] = movmatrix_trans(pa[i]);
            pb[i] = movmatrix_trans(pb[i]);
          }
#pragma unroll
          for (int mt = 0; mt < kKSteps; ++mt) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, vb +
                                     ((lane & 7) + (lane >> 4) * 8) *
                                         L::kBStride +
                                     mt * 16 + ((lane >> 3) & 1) * 8);
            float h[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(h, a, pa[0], pb[0]);
            mma_bf16(x, a, pa[1], pb[1]);
            mma_bf16(x, a, pa[2], pb[2]);
            acc[mt][0] = fmaf(acc[mt][0], alpha0, h[0] + x[0]);
            acc[mt][1] = fmaf(acc[mt][1], alpha1, h[1] + x[1]);
            acc[mt][2] = fmaf(acc[mt][2], alpha0, h[2] + x[2]);
            acc[mt][3] = fmaf(acc[mt][3], alpha1, h[3] + x[3]);
          }
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
    if (j + 2 < ntiles) stage(st, r_begin + (j + 2) * L::kRows);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this warp's state for the merges (the tiles are consumed)
  decode_publish<HDP, kMT>(smem_f, acc, m0, m1, l0, l1, warp, lane, half);
  decode_merge<HDP>(smem_f, G, hd, split, nkeep,
                    out + (static_cast<size_t>(b) * H + kh * G) * hd);
}

// bf16 q over bf16 or int8 pages
template <typename Q, typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Q* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, Q* __restrict__ out, int NP,
                    int page, int K, int hd, int G, int split_pages,
                    float scale_log2) {
  paged_decode_block<Q, T, HDP>(q, kp, vp, ks, vs, tables, pos, out, NP, page,
                                K, hd, G, split_pages, scale_log2);
}

// fp32 q over fp32 pages: 3xTF32 products
template <int HDP>
__global__ void __launch_bounds__(kThreads)
paged_decode_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ kp,
                           const float* __restrict__ vp,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ tables,
                           const int* __restrict__ pos,
                           float* __restrict__ out, int NP, int page, int K,
                           int hd, int G, int split_pages, float scale_log2) {
  paged_decode_block<float, float, HDP>(q, kp, vp, ks, vs, tables, pos, out,
                                        NP, page, K, hd, G, split_pages,
                                        scale_log2);
}

// fp32 q over int8 pages: three bf16 pieces of q and of P
template <int HDP>
__global__ void __launch_bounds__(kThreads)
paged_decode_bf16x3_kernel(const float* __restrict__ q,
                           const int8_t* __restrict__ kp,
                           const int8_t* __restrict__ vp,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ tables,
                           const int* __restrict__ pos,
                           float* __restrict__ out, int NP, int page, int K,
                           int hd, int G, int split_pages, float scale_log2) {
  paged_decode_block<float, int8_t, HDP>(q, kp, vp, ks, vs, tables, pos, out,
                                         NP, page, K, hd, G, split_pages,
                                         scale_log2);
}

// the kernel of (q's type, the pages' type)
template <typename Q, typename T, int HDP>
static auto kernel_of() {
  if constexpr (sizeof(Q) == 2)
    return paged_decode_kernel<Q, T, HDP>;
  else if constexpr (sizeof(T) == 4)
    return paged_decode_tf32x3_kernel<HDP>;
  else
    return paged_decode_bf16x3_kernel<HDP>;
}

template <typename Q, typename T, int HDP>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* pos, void* out,
           int B, int NP, int page, int K, int hd, int G, int split_pages,
           int nsplit, cudaStream_t st) {
  using L = Layout<Q, T, HDP>;
  const int smem = L::kFixedBytes + (split_pages * 4 + 15) / 16 * 16;
  auto kernel = kernel_of<Q, T, HDP>();
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
