// flash_attention: blocked GQA attention forward, causal or not, with an
// fp32 online softmax; bf16 or fp32 in and out (q's dtype).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// _kernel at :25, pallas_call at :91). The Pallas kernel runs a grid (B,
// H, nq, nk) whose kv axis is walked in order on one TPU core, keeping
// (m, l, acc) in VMEM scratch across it, with 128x128 tiles for the MXU.
// Here one block owns one 64-row query tile of one or two query heads of
// a KV group (one warpgroup of four warps per head) and loops over the
// 64-row KV tiles itself, up to the diagonal when causal; query head h
// reads KV head h / G. Ragged S and T are masked in the kernel, so both
// may be any length (the Pallas wrapper needs S % min(128, S) == 0).
//
// What bounds it on the H100: at the serve path's prompt lengths (a few
// hundred tokens) neither the bytes (q, k, v, o once: 1.4 us at qwen's
// S=384) nor the tensor-core operations (1.5x 0.6 us, see Numerics) but
// latency: a query tile walks up to S/64 KV tiles one after another, the
// first of them from cold memory, and at S=384 the grid is 96 blocks for
// 132 SMs. At the hybrid's 64 query heads the block count is no longer
// short, and the K and V tiles that eight heads read from L2 are. So:
//   - Q K^T and P V run on wgmma (sm_90a), one warpgroup per 64 query
//     rows: m64n64k16 for the scores and m64n128k16 for P V, A (q, then
//     P) from registers in the mma.m16n8k16 fragment layout, B (K, then V
//     as an N-major operand) from shared memory through descriptors, fp32
//     accumulators in registers. Scores, running max and sum stay in
//     registers; the row softmax reduces over the four lanes of a quad
//     with shuffles, and the scores' fragments are P's A fragments.
//   - K and V tiles stay bf16 in shared memory in the 128-byte swizzle
//     layout wgmma reads without bank conflicts, copied by cp.async into
//     a ring of four stages (three with two heads); the next stages'
//     copies are issued while the tensor cores run Q K^T. Shared memory
//     per block: 146 KB with one head, 131 KB with two, one block per SM.
//   - Two heads of a KV group share a block (each K and V tile read once
//     for both) when that still leaves a block for every SM; else one.
//   - Causal: tiles above the diagonal are skipped, only the diagonal and
//     the ragged last tile are masked, and the grid puts the heaviest
//     query tiles (the last ones) first. A head dim below 128 is
//     zero-filled to 128 in shared memory.
//
// Numerics: q and k stay bf16; the scores are exact products summed in
// fp32, scaled by 1/sqrt(hd) as fp32 values in the exponent's fma (exp2
// domain, ex2.approx), masked logits are -inf, and the softmax is fp32. P
// enters P V as a bf16 pair P_hi + P_lo (two wgmma per step), which holds
// it to about 2^-16 of its value. A bf16 P alone would round it by up to
// 2^-9, which outputs near zero cannot absorb (it reads 11-21 times the
// elementwise limit at the main shapes; tests/test_torch_kernels.py).
// The output is acc / max(l, 1e-30) cast to bf16. Causal masking is
// top-left aligned (query i sees keys j <= i), which equals the plain
// version's for the serve path's S == T. No atomics: the same inputs give
// the same bits.
//
// fp32 inputs (a model at fp32 compute) take a second kernel, on the tensor
// cores as 3xTF32 products (CUTLASS's mma_tensor_op_fast_f32.h): each fp32
// operand x enters as hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (ties away, as cvt.rna; the tensor core would truncate), and a
// product a b as a_lo b_hi + a_hi b_lo + a_hi b_hi, in Q K^T and in P V alike
// (P split in registers; the denominator sums P itself in fp32). A pair holds
// a value to about 2^-22, so the outputs keep JAX's fp32 limit 2e-5 + 2e-5
// |plain| (tests/test_kernels.py) with a wide margin: 0.03-0.06 of it on the
// card at qwen's, phi3's and internvl2's prompts (0.03-0.06 emulated), where
// TF32 alone reads 41-70 times it and bf16 pairs 0.66-1.02
// (tests/test_torch_fp32.py). The tensor core aligns the addends of a sum to
// the largest and truncates, so a product added into a long running sum loses
// up to 2^-23 of that sum, always toward zero: one sum of all three products
// over a tile read 0.11-0.15 of the limit. So the hi hi products and the cross
// terms go to separate sums, added in fp32 (see the kernel).
//
// The route is mma.sync.m16n8k8.tf32 from raw fp32 tiles, split in registers.
// wgmma (m64nNk8 .tf32, 32-bit operands K-major only) was tried: 32-key tiles
// split once into hi and lo K and a transposed V^T in shared memory (q hi/lo,
// the raw ring and the splits: 193 KB at hd 128), one warpgroup; it read
// 0.0499 ms against 0.0445 for this kernel's 64-row grid at qwen's S=384, its
// splits in series with the tensor work (overlapping them needs producer warps
// and a second split stage, which do not fit beside q's hi and lo). Here, one
// block of eight warps per 32 or 64 query rows of one head: two (four) warps
// of 16 rows, each against one of four (two) key groups of every 64-key tile,
// with an online softmax of its own; the groups merge at the end (two warps on
// each of the SM's schedulers). 32 rows halve the longest query tile's walk
// and double the grid, but split every K and V tile twice as often: the
// launcher takes the grid whose estimated span (longest walk, or all tiles
// over the SMs) is shorter: at S=384 qwen's 16 heads take 32 rows (0.0323 ms
// against 0.0452), phi3's 32 heads 64 (0.0363 against 0.0452). q and two
// cp.async stages of K and V stay raw fp32 (rows padded against bank
// conflicts: 156 or 172 KB at hd 128, one block an SM); hd 96 runs 96 columns,
// hd <= 32 and <= 64 their own widths. The contraction axes are walked in an
// order both operands share, so q and K fragments are float2 loads and the
// scores' C fragments are P's A fragments without a shuffle. The same causal
// tiling, masks, order of the grid (heaviest query tiles first) and
// exp2-domain softmax as above; the output is fp32. What bounds it: three TF32
// products per product. At the data sheet's 495 TFLOP/s that is 0.0037 ms at
// qwen's S=384 (the bytes 0.0028 ms), but what holds this kernel is the
// mma.sync issue of those products: cutting the splits' ALU work or their
// registers moved its time by under 1%, one product in place of three ran 1.7x
// faster (the same kernel at four warps), and the longest query tile walks its
// KV tiles one by one.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per head of a block: one warpgroup
constexpr int kBK = 64;  // kv rows per tile
constexpr int kRowBytes = 128;  // a 128-byte swizzle atom's row: 64 bf16

// ---------------------------------------------------------------------------
// wgmma (sm_90a): one warpgroup multiplies a 64-row A held in registers (the
// same per-warp fragments as mma.m16n8k16's A) by a B read from shared
// memory through a descriptor; D's registers have the layout of N/8
// m16n8 C fragments per warp.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler sees
// the wgmma's asm as done when issued, and without these it may move other
// work on the accumulators above the wait, or reuse an A fragment's
// registers before the wgmma has read them.
template <int R, int C>
__device__ __forceinline__ void fence_regs(float (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// make this thread's generic-proxy writes to shared memory (cp.async)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a shared-memory operand in the 128-byte swizzle layout:
// rows of 128 bytes, the 16-byte chunk c of row r stored at chunk c ^ (r %
// 8), atoms of 8 rows (1,024 bytes, 1,024-aligned). lbo and sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// D (64 x 64, fp32, the C fragments of 8 n-tiles) += A (64 x 16,
// bf16, each warp's A fragment in registers) B (16 x 64, the shared
// memory the descriptor names); TRANS_B 1 for an N-major B
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

// D (64 x 128, fp32, the C fragments of 16 n-tiles) += A (64 x 16,
// bf16, each warp's A fragment in registers) B (16 x 128, the shared
// memory the descriptor names); TRANS_B 1 for an N-major B
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  if constexpr (N == 64)
    wgmma_m64n64k16<TRANS_B>(d, a, desc);
  else
    wgmma_m64n128k16<TRANS_B>(d, a, desc);
}

// Tiles are kHD = 128 columns wide; a head dim hd < 128 is zero-filled to
// 128 in shared memory (its pad columns add 0 to every product).
constexpr int kHD = 128;

// HPB query heads of one KV group per block (one warpgroup each), a
// kStages ring of K and V tiles in the 128-byte swizzle layout (a tile is
// two column halves of 64 rows x 128 bytes), then q padded for ldmatrix
template <int HPB>
struct Tile {
  static constexpr int kStages = HPB == 1 ? 4 : 3;
  static constexpr int kThreads = 128 * HPB;
  static constexpr int kTileBytes = kBK * kHD * 2;
  static constexpr int kHalfBytes = kBK * kRowBytes;  // 64 columns
  static constexpr int kQStride = kHD + 8;  // padded q row, bf16 elements
  static constexpr int kSmemBytes =
      1024 + 2 * kStages * kTileBytes + HPB * kBQ * kQStride * 2;
};

// Stage rows [r0, r0 + 64) of a (rows, stride)-strided bf16 matrix of hd
// columns into a swizzled tile; rows >= n and columns >= hd are
// zero-filled and not read.
template <int NT>
__device__ __forceinline__ void stage_tile(char* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int n,
                                           int hd) {
  constexpr int kChunks = kHD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBK * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n && c * 8 < hd;
    const __nv_bfloat16* g = src + (ok ? r0 + r : 0) * stride + c * 8;
    cp_async16(dst + (c >> 3) * (kBK * kRowBytes) + r * kRowBytes +
                   (((c & 7) ^ (r & 7)) << 4),
               g, ok ? 16 : 0);
  }
}

// Stage the 64 q rows [q0, q0 + 64) of one head, padded for ldmatrix.
template <int NT>
__device__ __forceinline__ void stage_q(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        size_t stride, int r0, int n,
                                        int hd) {
  constexpr int kChunks = kHD / 8;
  for (int i = threadIdx.x; i < kBQ * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n && c * 8 < hd;
    const __nv_bfloat16* g = src + (ok ? r0 + r : 0) * stride + c * 8;
    cp_async16(dst + r * (kHD + 8) + c * 8, g, ok ? 16 : 0);
  }
}

// q: (B,S,H,hd); k, v: (B,T,K,hd); o: (B,S,H,hd); all bf16, contiguous;
// hd % 8 == 0, hd <= 128.
// Block i: query tile nq - 1 - i / (H/HPB * B) (the heaviest first), then
// head group and batch. Warpgroup w serves query head h0 + w (warp w*4+j
// rows 16 j .. + 15 of the tile); all of the block's heads read the same
// KV head, so each K and V tile is loaded once for them.
template <int HPB>
__global__ void __launch_bounds__(128 * HPB, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int B, int S, int T,
                       int H, int K, int hd, float scale_log2, int causal) {
  using Tl = Tile<HPB>;
  constexpr int kThreads = Tl::kThreads, kStages = Tl::kStages;
  constexpr int kQStride = Tl::kQStride;
  constexpr int kKSteps = kHD / 16;  // k-steps of Q K^T
  constexpr int kDTiles = kHD / 8;   // n-tiles of the output
  constexpr int kNTiles = kBK / 8;  // n-tiles of the scores
  const int nq = (S + kBQ - 1) / kBQ;
  const int hb = H / HPB * B;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / hb) * kBQ;
  const int h0 = static_cast<int>(blockIdx.x) % hb % (H / HPB) * HPB;
  const int b = static_cast<int>(blockIdx.x) % hb / (H / HPB);
  const int kh = h0 / (H / K);
  const int warp = threadIdx.x / 32 % 4, hh = threadIdx.x / 128;
  const int h = h0 + hh;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) char smem_raw[];
  // the swizzle atoms must be 1,024-byte aligned
  char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* vs = ks + kStages * Tl::kTileBytes;
  __nv_bfloat16* qs =
      reinterpret_cast<__nv_bfloat16*>(vs + kStages * Tl::kTileBytes);

  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(K) * hd;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h0) * hd;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * T * K + kh) * hd;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * T * K + kh) * hd;

  const int kv_end = causal ? min(T, q0 + kBQ) : T;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  // q and tile 0 in copy group 0, tiles 1 .. kStages-2 in the next groups
#pragma unroll
  for (int i = 0; i < HPB; ++i)
    stage_q<kThreads>(qs + i * kBQ * kQStride, qb + i * hd, q_stride, q0, S,
                      hd);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) {
      stage_tile<kThreads>(ks + st * Tl::kTileBytes, kb, kv_stride, st * kBK,
                           T, hd);
      stage_tile<kThreads>(vs + st * Tl::kTileBytes, vb, kv_stride, st * kBK,
                           T, hd);
    }
    cp_async_commit();
  }

  // this thread's rows of the warp's 16: g and g + 8
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 domain
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j (and q) has landed
    fence_async_shared();          // for wgmma's reads
    __syncthreads();               // and every warp is done with tile j-1
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + (hh * kBQ + warp * 16 + (lane & 15)) *
                                     kQStride +
                                kk * 16 + (lane >> 4) * 8);
    }
    const char* kt = ks + j % kStages * Tl::kTileBytes;
    const char* vt = vs + j % kStages * Tl::kTileBytes;

    // scores: s[n] holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8. K is
    // B in K-major form: k-step kk reads bytes 32 (kk % 4) of its rows in
    // column half kk / 4; 8-row groups 1,024 bytes apart
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    fence_regs(s);
    fence_regs(qf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      wgmma_k16<kBK, 0>(s, qf[kk],
                        sw128_desc(kt + kk / 4 * Tl::kHalfBytes + kk % 4 * 32,
                                   16, 1024));
    wgmma_commit();
    {  // while the tensor cores run, refill tile j-1's stage with tile
       // j + kStages - 1 (issuing the copies takes about as long as Q K^T)
      const int nj = j + kStages - 1;
      if (nj < ntiles) {
        stage_tile<kThreads>(ks + nj % kStages * Tl::kTileBytes, kb,
                             kv_stride, nj * kBK, T, hd);
        stage_tile<kThreads>(vs + nj % kStages * Tl::kTileBytes, vb,
                             kv_stride, nj * kBK, T, hd);
      }
      cp_async_commit();
    }
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(qf);

    // mask the diagonal and the ragged tile
    const int k0 = j * kBK;
    if ((causal && k0 + kBK - 1 > q0) || k0 + kBK > T) {
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= T || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }

    // online softmax over the quad's 64 columns of each row, in the exp2
    // domain: the scale rides in the exponent's fma
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    mx_a = fmaxf(m_a, mx_a * scale_log2);
    mx_b = fmaxf(m_b, mx_b * scale_log2);
    // a row with no valid column yet keeps 2^(-inf - 0) = 0
    const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
    const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
    const float alpha_a = fast_exp2(m_a - base_a);
    const float alpha_b = fast_exp2(m_b - base_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      s[n][0] = fast_exp2(fmaf(s[n][0], scale_log2, -base_a));
      s[n][1] = fast_exp2(fmaf(s[n][1], scale_log2, -base_a));
      s[n][2] = fast_exp2(fmaf(s[n][2], scale_log2, -base_b));
      s[n][3] = fast_exp2(fmaf(s[n][3], scale_log2, -base_b));
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) {
      acc[d][0] *= alpha_a;
      acc[d][1] *= alpha_a;
      acc[d][2] *= alpha_b;
      acc[d][3] *= alpha_b;
    }

    // acc += P V: the score n-tiles 2kk, 2kk + 1 are the A fragment of
    // key step kk, split into a bf16 pair. V is B in N-major form: key
    // step kk reads rows 16 kk .. + 15; 8-row groups 1,024 bytes apart,
    // column halves kHalfBytes apart
    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t vd =
          sw128_desc(vt + kk * 16 * kRowBytes, Tl::kHalfBytes, 1024);
      wgmma_k16<kHD, 1>(acc, ph[kk], vd);
      wgmma_k16<kHD, 1>(acc, pl[kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int d = 0; d < kDTiles; ++d) {
    const int col = d * 8 + 2 * t;
    if (col >= hd) break;  // hd % 8 == 0: the n-tile is wholly inside or out
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (static_cast<size_t>(b) * S + row_a) * q_stride + h * hd + col) =
          __floats2bfloat162_rn(acc[d][0] * inv_a, acc[d][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (static_cast<size_t>(b) * S + row_b) * q_stride + h * hd + col) =
          __floats2bfloat162_rn(acc[d][2] * inv_b, acc[d][3] * inv_b);
  }
}

template <int HPB>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T, int H, int K, int hd, int causal, cudaStream_t stream) {
  constexpr int smem = Tile<HPB>::kSmemBytes;
  auto kernel = flash_attention_kernel<HPB>;
  const long long blocks =
      static_cast<long long>((S + kBQ - 1) / kBQ) * (H / HPB) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  kernel<<<static_cast<unsigned>(blocks), Tile<HPB>::kThreads, smem,
           stream>>>(static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v),
                     static_cast<__nv_bfloat16*>(o), B, S, T, H, K, hd,
                     scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: the same attention on the tensor cores as 3xTF32 products (see the
// note at the top): mma.sync.m16n8k8 on TF32 pairs split in registers
// (tf32_round, split_tf32 and mma_tf32 in common.cuh)
// ---------------------------------------------------------------------------
namespace tf32x3 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// a block's time per 64-key tile with 32 query rows (2 row warps x 4 key
// groups), relative to 64 rows (4 x 2): qwen3-0.6b's S=384, whose grids
// are both held by the longest query tile's 6 tiles, read 0.0323 against
// 0.0452 ms (NVIDIA H100 80GB HBM3, 700 W)
constexpr double kRows32Cost = 0.7;

// RW row warps of 16 query rows each, 8 / RW key groups
template <int RW>
struct Warps {
  static constexpr int kRows = 16 * RW;           // query rows a block
  static constexpr int kGroups = kWarps / RW;     // key groups
  static constexpr int kGroupKeys = kBK / kGroups;  // a group's keys a tile
};

// Tiles hold raw fp32 rows of HDP columns, padded so that the fragment
// loads meet no bank conflict: q and K rows by 8 floats (a half warp's
// float2 loads, rows g < 4 at columns 2t, land on 8 g + 2t), V rows by 4
// (a warp's scalar loads, rows 2t at column g, land on 8 t + g)
template <int HDP, int RW>
struct Smem {
  static constexpr int kRows = Warps<RW>::kRows;
  static constexpr int kGroups = Warps<RW>::kGroups;
  static constexpr int kQKRow = HDP + 8;
  static constexpr int kVRow = HDP + 4;
  static constexpr int kKTile = kBK * kQKRow;
  static constexpr int kVTile = kBK * kVRow;
  // q, two stages of K, two of V; after the loop the K stages hold the
  // (acc, m, l) of key groups 1 and up for the merge
  static constexpr int kBytes = (kRows * kQKRow + 2 * kKTile + 2 * kVTile) * 4;
  static_assert((kGroups - 1) * kRows * (kVRow + 2) <= 2 * kKTile,
                "the merge fits");
};

// Stage rows [r0, r0 + R) of a (rows, stride)-strided fp32 matrix of hd
// columns into a tile of ROW-float rows; rows >= n and columns >= hd are
// zero-filled and not read.
template <int HDP, int ROW, int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int r0, int n,
                                           int hd) {
  constexpr int kChunks = HDP / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n && c * 4 < hd;
    const float* g =
        src + (ok ? static_cast<size_t>(r0 + r) * stride + c * 4 : 0);
    cp_async16(dst + r * ROW + c * 4, g, ok ? 16 : 0);
  }
}

// q: (B,S,H,hd); k, v: (B,T,K,hd); o: (B,S,H,hd); all fp32, contiguous;
// hd % 8 == 0, hd <= HDP. Block i: query tile nq - 1 - i / (H * B) of
// kRows rows (the heaviest first), then head and batch. Warp w: query
// rows 16 (w % kRowWarps) .. + 15 against key group w / kRowWarps (keys
// kGroupKeys (w / kRowWarps) .. of every 64-key tile), with an online
// softmax of its own; the groups merge at the end.
// The contraction axes are walked in a permuted order that both operands
// share: in Q K^T, the mma's k index t (t + 4) of k-step kk is head dim
// 8 kk + 2 t (+ 1), so q and K fragments are float2 loads; in P V it is
// key 8 kk + 2 t (+ 1), so the scores' C fragments are P's A fragments.
// Sums: the tensor core aligns each addend to the largest and truncates,
// so every mma into a running sum loses up to 2^-23 of it, toward zero.
// The hi hi products therefore go to two sums of alternate k-steps and
// the cross terms to a third, added in fp32 at the end of the tile; P V
// sums a tile in two such sums from zero and adds them to acc (rescaled)
// in fp32. One sum of all three products read 0.11-0.15 of the fp32
// limit at the main shapes, these sums 0.03-0.05.
template <int HDP, int RW>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32x3_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              float* __restrict__ o, int B, int S, int T,
                              int H, int K, int hd, float scale_log2,
                              int causal) {
  using Sm = Smem<HDP, RW>;
  constexpr int kRowWarps = RW, kRows = Warps<RW>::kRows;
  constexpr int kGroups = Warps<RW>::kGroups;
  constexpr int kGroupKeys = Warps<RW>::kGroupKeys;
  constexpr int kQK = Sm::kQKRow, kVR = Sm::kVRow;
  constexpr int kKSteps = HDP / 8;       // k-steps of Q K^T, n-tiles of P V
  constexpr int kNT = kGroupKeys / 8;    // a group's score n-tiles, P V k-steps
  constexpr int kDG = 4;                 // P V n-tiles a group
  static_assert(kKSteps % kDG == 0, "whole groups");
  const int nq = (S + kRows - 1) / kRows;
  const int hb = H * B;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / hb) * kRows;
  const int h = static_cast<int>(blockIdx.x) % hb % H;
  const int b = static_cast<int>(blockIdx.x) % hb / H;
  const int kh = h / (H / K);
  const int warp = threadIdx.x / 32 % kRowWarps;
  const int grp = threadIdx.x / 32 / kRowWarps;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + kRows * kQK;     // two stages
  float* vs = ks + 2 * Sm::kKTile;  // two stages

  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(K) * hd;
  const float* qb = q + (static_cast<size_t>(b) * S * H + h) * hd;
  const float* kb = k + (static_cast<size_t>(b) * T * K + kh) * hd;
  const float* vb = v + (static_cast<size_t>(b) * T * K + kh) * hd;

  const int kv_end = causal ? min(T, q0 + kRows) : T;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  // q and tile 0 in copy group 0, tile 1 in group 1
  stage_rows<HDP, kQK, kRows>(qs, qb, q_stride, q0, S, hd);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    if (st < ntiles) {
      stage_rows<HDP, kQK, kBK>(ks + st * Sm::kKTile, kb, kv_stride,
                                st * kBK, T, hd);
      stage_rows<HDP, kVR, kBK>(vs + st * Sm::kVTile, vb, kv_stride,
                                st * kBK, T, hd);
    }
    cp_async_commit();
  }

  // this thread's rows of the warp's 16: g and g + 8
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* qa = qs + (warp * 16 + g) * kQK + 2 * t;
  float acc[kKSteps][4];
#pragma unroll
  for (int d = 0; d < kKSteps; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 domain
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<1>();  // tile j (and q) has landed
    __syncthreads();
    const float* kt = ks + (j & 1) * Sm::kKTile + grp * kGroupKeys * kQK;
    const float* vt = vs + (j & 1) * Sm::kVTile + grp * kGroupKeys * kVR;

    // scores: s[n] holds the group's keys 8n + 2t, 8n + 2t + 1 of rows g,
    // g + 8; the hi hi products of even and odd k-steps in s and s1, the
    // cross terms in s2
    float s[kNT][4], s1[kNT][4], s2[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s1[n][e] = s2[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const float2 xa = *reinterpret_cast<const float2*>(qa + 8 * kk);
      const float2 xb =
          *reinterpret_cast<const float2*>(qa + 8 * kQK + 8 * kk);
      uint32_t ah[4], al[4];
      split_tf32(xa.x, ah[0], al[0]);
      split_tf32(xb.x, ah[1], al[1]);
      split_tf32(xa.y, ah[2], al[2]);
      split_tf32(xb.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(
            kt + (8 * n + g) * kQK + 8 * kk + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x.x, bh0, bl0);
        split_tf32(x.y, bh1, bl1);
        mma_tf32(s2[n], al, bh0, bh1);
        mma_tf32(s2[n], ah, bl0, bl1);
        mma_tf32(kk % 2 ? s1[n] : s[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s1[n][e] + s2[n][e];

    // mask the diagonal and the ragged tile
    const int k0 = j * kBK + grp * kGroupKeys;
    if ((causal && k0 + kGroupKeys - 1 > q0) || k0 + kGroupKeys > T) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= T || (causal && col > row)) s[n][e] = -INFINITY;
        }
    }

    // online softmax over the quad's columns of each row, in the exp2
    // domain: the scale rides in the exponent's fma
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    mx_a = fmaxf(m_a, mx_a * scale_log2);
    mx_b = fmaxf(m_b, mx_b * scale_log2);
    // a row with no valid column yet keeps 2^(-inf - 0) = 0
    const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
    const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
    const float alpha_a = fast_exp2(m_a - base_a);
    const float alpha_b = fast_exp2(m_b - base_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = fast_exp2(fmaf(s[n][0], scale_log2, -base_a));
      s[n][1] = fast_exp2(fmaf(s[n][1], scale_log2, -base_a));
      s[n][2] = fast_exp2(fmaf(s[n][2], scale_log2, -base_b));
      s[n][3] = fast_exp2(fmaf(s[n][3], scale_log2, -base_b));
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;

    // acc = alpha acc + P V: key step kk's A fragment is the score n-tile
    // kk, split; its B fragments are V rows 8 kk + 2t and + 1 at column
    // 8 d + g. A group of kDG output n-tiles sums the tile's hi hi
    // products in pb and the cross terms in px, from zero.
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      split_tf32(s[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(s[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(s[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(s[kk][3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int d0 = 0; d0 < kKSteps; d0 += kDG) {
      float pb[kDG][4], px[kDG][4];
#pragma unroll
      for (int d = 0; d < kDG; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) pb[d][e] = px[d][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        const float* v0 = vt + (8 * kk + 2 * t) * kVR + 8 * d0 + g;
#pragma unroll
        for (int d = 0; d < kDG; ++d) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[8 * d], bh0, bl0);
          split_tf32(v0[kVR + 8 * d], bh1, bl1);
          mma_tf32(px[d], pl[kk], bh0, bh1);
          mma_tf32(px[d], ph[kk], bl0, bl1);
          mma_tf32(pb[d], ph[kk], bh0, bh1);
        }
      }
#pragma unroll
      for (int d = 0; d < kDG; ++d) {
        acc[d0 + d][0] = fmaf(acc[d0 + d][0], alpha_a, pb[d][0] + px[d][0]);
        acc[d0 + d][1] = fmaf(acc[d0 + d][1], alpha_a, pb[d][1] + px[d][1]);
        acc[d0 + d][2] = fmaf(acc[d0 + d][2], alpha_b, pb[d][2] + px[d][2]);
        acc[d0 + d][3] = fmaf(acc[d0 + d][3], alpha_b, pb[d][3] + px[d][3]);
      }
    }
    __syncthreads();  // the stage is consumed
    if (j + 2 < ntiles) {
      stage_rows<HDP, kQK, kBK>(ks + (j & 1) * Sm::kKTile, kb, kv_stride,
                                (j + 2) * kBK, T, hd);
      stage_rows<HDP, kVR, kBK>(vs + (j & 1) * Sm::kVTile, vb, kv_stride,
                                (j + 2) * kBK, T, hd);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // merge: key groups 1.. leave (acc, m, l) of their rows in the K stages,
  // group i - 1's at slot i - 1: kRows rows x kVR, then kRows x (m, l)
  constexpr int kSlot = kRows * (kVR + 2);
  const int ra = warp * 16 + g, rb = ra + 8;  // the block's rows
  __syncthreads();  // every warp is done with the stages
  if (grp > 0) {
    float* macc = ks + (grp - 1) * kSlot;
    float* mml = macc + kRows * kVR;
#pragma unroll
    for (int d = 0; d < kKSteps; ++d) {
      *reinterpret_cast<float2*>(macc + ra * kVR + 8 * d + 2 * t) =
          make_float2(acc[d][0], acc[d][1]);
      *reinterpret_cast<float2*>(macc + rb * kVR + 8 * d + 2 * t) =
          make_float2(acc[d][2], acc[d][3]);
    }
    if (t == 0) {
      mml[2 * ra] = m_a, mml[2 * ra + 1] = l_a;
      mml[2 * rb] = m_b, mml[2 * rb + 1] = l_b;
    }
  }
  __syncthreads();
  if (grp > 0) return;
  // o = sum_i e_i acc_i / max(sum_i e_i l_i, 1e-30), e_i = 2^(m_i - M), M
  // = max_i m_i; a group with no valid key weighs 0
  float mm_a = m_a, mm_b = m_b;
#pragma unroll
  for (int i = 1; i < kGroups; ++i) {
    const float* mml = ks + (i - 1) * kSlot + kRows * kVR;
    mm_a = fmaxf(mm_a, mml[2 * ra]);
    mm_b = fmaxf(mm_b, mml[2 * rb]);
  }
  const float base_a = mm_a == -INFINITY ? 0.f : mm_a;
  const float base_b = mm_b == -INFINITY ? 0.f : mm_b;
  float e_a[kGroups], e_b[kGroups];
  e_a[0] = fast_exp2(m_a - base_a);
  e_b[0] = fast_exp2(m_b - base_b);
  float den_a = e_a[0] * l_a, den_b = e_b[0] * l_b;
#pragma unroll
  for (int i = 1; i < kGroups; ++i) {
    const float* mml = ks + (i - 1) * kSlot + kRows * kVR;
    e_a[i] = fast_exp2(mml[2 * ra] - base_a);
    e_b[i] = fast_exp2(mml[2 * rb] - base_b);
    den_a += e_a[i] * mml[2 * ra + 1];
    den_b += e_b[i] * mml[2 * rb + 1];
  }
  const float inv_a = 1.f / fmaxf(den_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(den_b, 1e-30f);
#pragma unroll
  for (int d = 0; d < kKSteps; ++d) {
    const int col = d * 8 + 2 * t;
    if (col >= hd) break;  // hd % 8 == 0: the n-tile is wholly inside or out
    float2 xa = make_float2(e_a[0] * acc[d][0], e_a[0] * acc[d][1]);
    float2 xb = make_float2(e_b[0] * acc[d][2], e_b[0] * acc[d][3]);
#pragma unroll
    for (int i = 1; i < kGroups; ++i) {
      const float* macc = ks + (i - 1) * kSlot;
      const float2 ya = *reinterpret_cast<const float2*>(macc + ra * kVR + col);
      const float2 yb = *reinterpret_cast<const float2*>(macc + rb * kVR + col);
      xa.x = fmaf(e_a[i], ya.x, xa.x);
      xa.y = fmaf(e_a[i], ya.y, xa.y);
      xb.x = fmaf(e_b[i], yb.x, xb.x);
      xb.y = fmaf(e_b[i], yb.y, xb.y);
    }
    if (row_a < S)
      *reinterpret_cast<float2*>(
          o + (static_cast<size_t>(b) * S + row_a) * q_stride + h * hd + col) =
          make_float2(xa.x * inv_a, xa.y * inv_a);
    if (row_b < S)
      *reinterpret_cast<float2*>(
          o + (static_cast<size_t>(b) * S + row_b) * q_stride + h * hd + col) =
          make_float2(xb.x * inv_b, xb.y * inv_b);
  }
}

// The grid's time in 64-key tiles of a 64-row block, with blocks of rows
// query rows: the longest query tile's walk, or the tiles of the whole
// grid over the SMs, whichever is longer (blocks run heaviest first)
static double grid_span(int rows, int S, int T, int H, int B, int causal,
                        int sms) {
  long long total = 0;
  int most = 0;
  for (int q0 = 0; q0 < S; q0 += rows) {
    const int end = causal && q0 + rows < T ? q0 + rows : T;
    const int n = (end + kBK - 1) / kBK;
    total += n;
    most = n > most ? n : most;
  }
  const double span = fmax(most, static_cast<double>(total) * H * B / sms);
  return rows == 32 ? kRows32Cost * span : span;
}

template <int HDP, int RW>
int launch_grid(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T, int H, int K, int hd, int causal,
                cudaStream_t stream) {
  constexpr int smem = Smem<HDP, RW>::kBytes;
  constexpr int rows = Warps<RW>::kRows;
  auto kernel = flash_attention_tf32x3_kernel<HDP, RW>;
  const long long blocks =
      static_cast<long long>((S + rows - 1) / rows) * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, S, T, H, K, hd,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

// rows: query rows a block, 32 or 64
template <int HDP>
int launch(int rows, const void* q, const void* k, const void* v, void* o,
           int B, int S, int T, int H, int K, int hd, int causal,
           cudaStream_t stream) {
  if (rows == 32)
    return launch_grid<HDP, 2>(q, k, v, o, B, S, T, H, K, hd, causal, stream);
  return launch_grid<HDP, 4>(q, k, v, o, B, S, T, H, K, hd, causal, stream);
}

}  // namespace tf32x3

}  // namespace

// the card's SM count, read once
static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// hd % 8 == 0 and hd <= 128; f32: q, k, v and o are fp32, else bf16.
// block, 0 to choose (ops.FLASH_ATTENTION_AUTO): bf16, query heads per
// block, 1 or 2 of one KV group (ops.FLASH_ATTENTION_BF16_HEADS); fp32,
// query rows per block, 32 or 64 (ops.FLASH_ATTENTION_FP32_ROWS)
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int K, int hd, int causal,
                                      int block, int f32, void* stream) {
  if (K < 1 || H % K != 0 || hd < 8 || hd > kHD || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    if (block == 0)  // the shorter estimated span (tf32x3::grid_span)
      block = tf32x3::grid_span(32, S, T, H, B, causal, sm_count()) <
                      tf32x3::grid_span(64, S, T, H, B, causal, sm_count())
                  ? 32
                  : 64;
    if (block != 32 && block != 64)
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd <= 32)
      return tf32x3::launch<32>(block, q, k, v, o, B, S, T, H, K, hd, causal,
                                st);
    if (hd <= 64)
      return tf32x3::launch<64>(block, q, k, v, o, B, S, T, H, K, hd, causal,
                                st);
    if (hd <= 96)
      return tf32x3::launch<96>(block, q, k, v, o, B, S, T, H, K, hd, causal,
                                st);
    return tf32x3::launch<128>(block, q, k, v, o, B, S, T, H, K, hd, causal,
                               st);
  }
  if (block == 0) {
    // two heads a block (each K and V tile read once for both) while
    // that still gives every SM a block
    const long long pairs =
        static_cast<long long>((S + kBQ - 1) / kBQ) * (H / 2) * B;
    block = (H / K) % 2 == 0 && pairs >= sm_count() ? 2 : 1;
  }
  if (block == 2 && (H / K) % 2 == 0)
    return launch<2>(q, k, v, o, B, S, T, H, K, hd, causal, st);
  if (block == 1) return launch<1>(q, k, v, o, B, S, T, H, K, hd, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
