// flash_decode: single-token GQA attention over a dense KV cache at one
// position shared by the whole batch, bf16 or fp32 in and out (q's dtype),
// fp32 softmax.
//
// Replaces src/repro/kernels/flash_decode.py::flash_decode (Pallas _kernel
// at :22, pallas_call at :72). The Pallas kernel runs a grid (B, H, T /
// block_k) whose cache axis is walked in order on one TPU core, with the
// online-softmax state in VMEM scratch, the position prefetched as a
// scalar and the tiles past it skipped. Here the cache axis is split
// across blocks instead: each (slot b, KV head, split of split_rows rows)
// gets one block of four warps, which serves all G <= 8 query heads that
// read that KV head and walks its rows up to pos in tiles of 64, 16 rows
// per warp, each warp with its own online softmax; the warps merge in
// shared memory into the block's unnormalised partial state (running max,
// denominator, G x hd accumulator). The splits of one (b, KV head) form a
// thread block cluster (at most 8 blocks), and after a cluster barrier
// each block merges one slice of the outputs from all the splits' partial
// states, read from their shared memory (distributed shared memory), in
// split order. One launch, no scratch in device memory, no atomics: the
// same inputs give the same bits. Blocks whose rows all lie past pos read
// nothing and add nothing (for an int position they are not launched);
// rows past pos are never read.
//
// What bounds it on the H100: bytes. Decode reads every cache row up to
// pos once for its G query heads and does 4*G flops per element read, far
// below the card's ridge point; at B = 4, T = 1,024, pos = 511 that is
// 8.4 MB, 2.5 us. So the design keeps enough rows in flight and little
// else in the way:
//   - Splits of 128 rows (two tiles, both in flight from the start by
//     cp.async, double-buffered beyond that; longer caches get longer
//     splits, at most 8 a cluster): 128 blocks at pos 511 for 132 SMs,
//     256 at pos 1023. K and V stay bf16 in shared memory, rows padded by
//     16 bytes against bank conflicts: 68 KB per block at hd 128, so three
//     blocks fit on an SM.
//   - Both products on the tensor cores, mma.sync.m16n8k16 bf16 with fp32
//     accumulation. Scores: S^T = K Q^T with 16 cache rows as M and the 8
//     query heads of a KV head as N (K by ldmatrix, q held in registers).
//     P V as O^T = V^T P^T: V^T by ldmatrix.trans is the A operand, and
//     P^T, the B operand, is the score tile's C fragment transposed in
//     registers by movmatrix. The softmax runs over M, so its max and sum
//     reduce across the eight lanes of a column with shuffles.
//   - One launch a call: the splits merge through distributed shared
//     memory, not through device memory and a second kernel. The position
//     is an int argument, or read from a 32- or 64-bit integer in device
//     memory, so a step never waits on the host and nothing is launched
//     for it.
//
// Numerics: q and k stay bf16, the scores are exact products summed in
// fp32 and scaled by 1/sqrt(hd) in fp32 (in the exp2 domain), the softmax
// is fp32 (2^x by ex2.approx), and P enters P V as a bf16 pair P_hi + P_lo
// (two mma), which
// holds it to about 2^-16 of its value; bf16 P alone would read 3-6 times
// the elementwise limit (tests/test_torch_kernels.py). Output acc /
// max(l, 1e-30) in bf16; no valid row (pos < 0) gives zeros.
//
// fp32 inputs (a model at fp32 compute) take their own kernel,
// flash_decode_tf32x3_kernel, with the same blocks, splits, cluster and
// merges and both products on the tensor cores as 3xTF32 on
// mma.sync.m16n8k8.tf32 (each fp32 operand a TF32 pair hi + lo, a product
// as hi hi + hi lo + lo hi), through the tile the paged decode over fp32
// pages shares (DecTf32 in common.cuh): raw fp32 tiles of 32 rows, two
// stages by cp.async, rows padded by 16 bytes (68 KB a block at hd 128,
// three blocks an SM; 132 KB and one block at hd 256), split hi/lo in
// registers; q split once per block, its pieces in registers; two warps
// on each 16 rows, each with half the scores' k-steps (their partial sums
// added through shared memory in one order, so both keep the same
// softmax) and half of O^T's m-tiles, since at G = 2 three TF32 products
// fill 2 of an mma's 8 columns and would otherwise set the busiest warp's
// time. At G <= 8 a decode does 2 G flops per 4-byte element read: the
// bytes still bound it. A bf16 pair of each fp32 operand (2^-16 of its
// value) would use 0.7-1.0 of JAX's fp32 limit 2e-5 + 2e-5 |plain|; the
// TF32 pairs, with the leading products and the corrections in separate
// sums (the tensor core's fp32 accumulate truncates), hold a value to
// about 2^-22 (tests/test_torch_fp32.py emulates both).
#include "common.cuh"

namespace {

constexpr int kThreads = kDecThreads;  // four warps
constexpr int kMaxG = kDecMaxG;        // query heads per KV head: the mma's N
constexpr int kMaxHd = 256;
constexpr int kMaxSplits = kDecMaxSplits;  // blocks of a cluster

// E: the element type of q, k, v and the output (bf16 or fp32)
template <typename E, int HDP>
struct Tile {
  static constexpr bool kF32 = sizeof(E) == 4;
  static constexpr int kRows = kF32 ? 32 : 64;  // cache rows per tile
  static constexpr int kVals = 16 / sizeof(E);  // values per 16-byte chunk
  static constexpr int kStride = HDP + kVals;   // padded row, elements
  static constexpr int kElems = kRows * kStride;
  // two stages of K and V; the merges reuse them
  static constexpr int kTileBytes = 4 * kElems * static_cast<int>(sizeof(E));
  // fp32: the warp pairs' partial scores after the tiles
  static constexpr int kSmemBytes =
      kTileBytes + (kF32 ? DecTf32<HDP>::kXBytes : 0);
  static_assert(DecMerge<HDP>::kFloats * 4 <= kTileBytes,
                "merges fit the tiles");
  static_assert(!kF32 || (kRows == DecTf32<HDP>::kRows &&
                          kStride == DecTf32<HDP>::kStride),
                "fp32 tiles as DecTf32's");
};

__device__ __forceinline__ int last_row(const void* pos_ptr, int pos_is64,
                                        int pos_val, int T) {
  long long p = pos_val;
  if (pos_ptr != nullptr)
    p = pos_is64 ? *static_cast<const long long*>(pos_ptr)
                 : *static_cast<const int*>(pos_ptr);
  return static_cast<int>(p < -1 ? -1 : (p > T - 1 ? T - 1 : p));
}

// q: (B,1,H,hd); k, v: (B,T,K,hd), all E; hd <= HDP, columns hd..HDP are
// zero in shared memory and in q's fragments. Block (bk = b*K + kh,
// split); the gridDim.y splits of a bk are one cluster.
template <typename E, int HDP>
__device__ __forceinline__ void flash_decode_block(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const void* __restrict__ pos_ptr, int pos_is64,
    int pos_val, E* __restrict__ out, int T, int K, int hd, int G,
    int split_rows, float scale_log2) {
  using Tl = Tile<E, HDP>;
  using X = DecTf32<HDP>;
  constexpr bool kF32 = Tl::kF32;
  constexpr int kStride = Tl::kStride;
  constexpr int kKSteps = HDP / 16;  // k-steps of the scores, m-tiles of O^T
  constexpr int kMT = kF32 ? X::kMT : kKSteps;  // a warp's m-tiles
  constexpr int kChunks = HDP / Tl::kVals;  // 16-byte chunks of a row
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kh = bk % K, H = G * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // fp32: warps w and w + 2 take the same 16 rows of a tile (DecTf32)
  const int wr = kF32 ? (warp & 1) * 16 : warp * 16;  // the warp's rows

  // fp32 q's values, in flight with the position's read
  float qv[kF32 ? 2 * X::kSK : 1];
  if constexpr (kF32)
    X::load_q(q + (static_cast<size_t>(b) * H + kh * G + g) * hd, g < G, hd,
              warp >> 1, t, qv);

  const int last = last_row(pos_ptr, pos_is64, pos_val, T);
  const int r_begin = split * split_rows;
  const int r_end = min(r_begin + split_rows, last + 1);  // exclusive

  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ks = reinterpret_cast<E*>(smem_raw);  // two stages
  E* vs = ks + 2 * Tl::kElems;             // two stages
  float* smem_f = reinterpret_cast<float*>(smem_raw);
  float4* xch = reinterpret_cast<float4*>(smem_raw + Tl::kTileBytes);

  auto stage = [&](int st, int r0) {
    E* kd = ks + st * Tl::kElems;
    E* vd = vs + st * Tl::kElems;
    for (int i = threadIdx.x; i < Tl::kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = r0 + r < r_end && c * Tl::kVals < hd;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * T + r0 + r) * K + kh) * hd +
                   c * Tl::kVals
             : 0;
      cp_async16(kd + r * kStride + c * Tl::kVals, k + off, ok ? 16 : 0);
      cp_async16(vd + r * kStride + c * Tl::kVals, v + off, ok ? 16 : 0);
    }
  };

  // a block past pos has no tiles, but stays for the cluster's merge
  const int ntiles =
      max(0, (r_end - r_begin + Tl::kRows - 1) / Tl::kRows);
  if (ntiles > 0) stage(0, r_begin);
  cp_async_commit();
  if (ntiles > 1) stage(1, r_begin + Tl::kRows);
  cp_async_commit();

  // q as the B operand of S^T = K Q^T: bf16, head g, columns 2t.. of each
  // step; fp32, its TF32 pieces (DecTf32::split_q)
  uint32_t qf[kF32 ? 1 : kKSteps][2];
  uint32_t qw[kF32 ? X::kQWords : 1];
  if constexpr (kF32) {
    X::split_q(qv, qw);
  } else {
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

  // acc[mt]: O^T rows (columns of the output) mt*16 + g and + 8 (fp32:
  // DecTf32's), heads 2t and 2t + 1; m and l of heads 2t, 2t + 1 (l: this
  // thread's rows)
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
    const int r0 = r_begin + j * Tl::kRows + wr;  // warp's first row
    if (r0 < r_end) {
      if constexpr (kF32) {
        const int off = st * Tl::kElems + wr * kStride;
        X::tile(reinterpret_cast<const float*>(ks) + off,
                reinterpret_cast<const float*>(vs) + off, qw, xch,
                r_end - r0, scale_log2, acc, m0, m1, l0, l1, warp, lane);
      } else {
        const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(
            ks + st * Tl::kElems + wr * kStride);
        const __nv_bfloat16* vt = reinterpret_cast<const __nv_bfloat16*>(
            vs + st * Tl::kElems + wr * kStride);
        // s: rows g, g + 8 (of the warp's 16) x heads 2t, 2t + 1
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, kt + (lane & 15) * kStride + kk * 16 +
                             (lane >> 4) * 8);
          mma_bf16(s, a, qf[kk][0], qf[kk][1]);
        }
        const bool ok_a = r0 + g < r_end, ok_b = r0 + g + 8 < r_end;
        s[0] = ok_a ? s[0] * scale_log2 : -INFINITY;
        s[1] = ok_a ? s[1] * scale_log2 : -INFINITY;
        s[2] = ok_b ? s[2] * scale_log2 : -INFINITY;
        s[3] = ok_b ? s[3] * scale_log2 : -INFINITY;
        // max over the 16 rows: the eight lanes sharing t
        float mx0 = fmaxf(m0, fmaxf(s[0], s[2]));
        float mx1 = fmaxf(m1, fmaxf(s[1], s[3]));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // row r0 is valid, so both maxima are finite
        const float alpha0 = fast_exp2(m0 - mx0),
                    alpha1 = fast_exp2(m1 - mx1);
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
          ldmatrix_x4_trans(a, vt + ((lane & 7) + (lane >> 4) * 8) * kStride +
                                   mt * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[mt], a, bh0, bh1);
          mma_bf16(acc[mt], a, bl0, bl1);
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
    if (j + 2 < ntiles) stage(st, r_begin + (j + 2) * Tl::kRows);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this warp's state for the merges (the tiles are consumed)
  decode_publish<HDP, kMT>(smem_f, acc, m0, m1, l0, l1, warp, lane,
                           kF32 ? warp >> 1 : 0);
  decode_merge<HDP>(smem_f, G, hd, split, static_cast<int>(gridDim.y),
                    out + (static_cast<size_t>(b) * H + kh * G) * hd);
}

// bf16 q, k, v and output
template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const void* __restrict__ pos_ptr, int pos_is64,
                    int pos_val, __nv_bfloat16* __restrict__ out, int T,
                    int K, int hd, int G, int split_rows, float scale_log2) {
  flash_decode_block<__nv_bfloat16, HDP>(q, k, v, pos_ptr, pos_is64, pos_val,
                                         out, T, K, hd, G, split_rows,
                                         scale_log2);
}

// fp32 q, k, v and output: 3xTF32 products
template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_decode_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const void* __restrict__ pos_ptr, int pos_is64,
                           int pos_val, float* __restrict__ out, int T,
                           int K, int hd, int G, int split_rows,
                           float scale_log2) {
  flash_decode_block<float, HDP>(q, k, v, pos_ptr, pos_is64, pos_val, out, T,
                                 K, hd, G, split_rows, scale_log2);
}

// the kernel of the element type
template <typename E, int HDP>
static auto kernel_of() {
  if constexpr (sizeof(E) == 4)
    return flash_decode_tf32x3_kernel<HDP>;
  else
    return flash_decode_kernel<HDP>;
}

template <typename E, int HDP>
int launch(const void* q, const void* k, const void* v, const void* pos_ptr,
           int pos_is64, int pos_val, void* out, int B, int T, int K, int hd,
           int G, int split_rows, int nsplit, cudaStream_t st) {
  constexpr int smem = Tile<E, HDP>::kSmemBytes;
  auto kernel = kernel_of<E, HDP>();
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const E*>(q),
                           static_cast<const E*>(k), static_cast<const E*>(v),
                           pos_ptr, pos_is64, pos_val, static_cast<E*>(out),
                           T, K, hd, G, split_rows, scale_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dispatch(const void* q, const void* k, const void* v, const void* pos_ptr,
             int pos_is64, int pos_val, void* out, int B, int T, int K,
             int hd, int G, int split_rows, int nsplit, cudaStream_t st) {
#define FLASH_DECODE_LAUNCH(HDP)                                             \
  launch<E, HDP>(q, k, v, pos_ptr, pos_is64, pos_val, out, B, T, K, hd, G,  \
                 split_rows, nsplit, st)
  if (hd <= 32) return FLASH_DECODE_LAUNCH(32);
  if (hd <= 64) return FLASH_DECODE_LAUNCH(64);
  if (hd <= 128) return FLASH_DECODE_LAUNCH(128);
  return FLASH_DECODE_LAUNCH(256);
#undef FLASH_DECODE_LAUNCH
}

}  // namespace

// pos: pos_ptr, a 32-bit (pos_is64 = 0) or 64-bit integer in device
// memory, or pos_val when pos_ptr is null. The cache splits into
// ceil(T / split_rows) <= 8 blocks per (slot, KV head), one cluster; for
// an int position only the blocks with rows <= pos are launched. f32: q,
// k, v and out are fp32 (else bf16).
extern "C" int launch_flash_decode(const void* q, const void* k, const void* v,
                                   const void* pos_ptr, void* out,
                                   int pos_val, int pos_is64, int B, int T,
                                   int K, int hd, int G, int split_rows,
                                   int f32, void* stream) {
  if (G < 1 || G > kMaxG || hd < 8 || hd > kMaxHd || hd % 8 != 0 || T < 1 ||
      K < 1 || split_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int nsplit = (T + split_rows - 1) / split_rows;
  if (nsplit > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  // an int position: only the splits that hold rows <= pos
  if (pos_ptr == nullptr)
    nsplit = pos_val < 0 ? 1 : min(nsplit, pos_val / split_rows + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return dispatch<float>(q, k, v, pos_ptr, pos_is64, pos_val, out, B, T, K,
                           hd, G, split_rows, nsplit, st);
  return dispatch<__nv_bfloat16>(q, k, v, pos_ptr, pos_is64, pos_val, out, B,
                                 T, K, hd, G, split_rows, nsplit, st);
}
