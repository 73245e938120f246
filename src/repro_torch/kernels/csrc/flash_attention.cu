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
// fp32 inputs (a model at fp32 compute) take a second kernel on the CUDA
// cores, every product an fp32 FMA: the tensor cores' fp32 routes miss
// the fp32 limit 2e-5 + 2e-5 |plain| (JAX's, tests/test_kernels.py). Each
// operand as a bf16 pair with three products a step reads 0.66-1.02 of
// it at qwen's, phi3's and internvl2's shapes, four products 0.42, since
// a pair holds a value to 2^-16 of it (tests/test_torch_fp32.py emulates
// them); three bf16 pieces would need six products and three K and V
// tiles a stage. So: one block of 128 threads (16 x 8) per 64 query rows
// of one head; thread (ty, tx) holds the scores of rows ty + 16 i (i < 4)
// and keys tx + 8 j (j < 8) of a 64-key tile (128 FMA per 12 16-byte
// shared-memory reads), and the outputs of rows ty + 16 i, columns
// 4 tx + 32 c .. + 3 (64 FMA per 8 reads a key at hd 128). q, two cp.async stages of K and V (rows padded by
// 16 bytes: a quarter warp's eight rows land on eight bank quads) and P^T
// (scores to P V through shared memory) take 182 KB at hd 128, one block
// an SM. The same tiling of the causal loop, masks, order of the grid and
// exp2-domain softmax as above; the output is fp32. What bounds it: the
// operations, at the CUDA cores' 67 TFLOP/s (0.009 ms at qwen's S=384
// against 0.0028 for the bytes); one block of four warps an SM hides
// little of the shared-memory latency, and S=384 fills 96 of 132 SMs.
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
// fp32: the same attention on the CUDA cores (see the note at the top)
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kThreads = 128;  // 16 (ty) x 8 (tx)

template <int HDP>
struct Smem {
  static constexpr int kRow = HDP + 4;   // padded q, K, V row, floats
  static constexpr int kPRow = kBQ + 4;  // padded P^T row (one key), floats
  static constexpr int kTile = kBK * kRow;
  // q, two stages of K, two of V, P^T
  static constexpr int kBytes = (kBQ * kRow + 4 * kTile + kBK * kPRow) * 4;
};

// Stage rows [r0, r0 + 64) of a (rows, stride)-strided fp32 matrix of hd
// columns into a padded tile; rows >= n and columns >= hd are zero-filled
// and not read.
template <int HDP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int r0, int n,
                                           int hd) {
  constexpr int kChunks = HDP / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n && c * 4 < hd;
    const float* g =
        src + (ok ? static_cast<size_t>(r0 + r) * stride + c * 4 : 0);
    cp_async16(dst + r * Smem<HDP>::kRow + c * 4, g, ok ? 16 : 0);
  }
}

// q: (B,S,H,hd); k, v: (B,T,K,hd); o: (B,S,H,hd); all fp32, contiguous;
// hd % 8 == 0, hd <= HDP. Block i: query tile nq - 1 - i / (H * B) (the
// heaviest first), then head and batch.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int B, int S, int T, int H,
                           int K, int hd, float scale_log2, int causal) {
  using Sm = Smem<HDP>;
  constexpr int kRow = Sm::kRow, kPRow = Sm::kPRow;
  constexpr int kC = HDP / 32;  // 4-column groups of a thread's outputs
  const int nq = (S + kBQ - 1) / kBQ;
  const int hb = H * B;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / hb) * kBQ;
  const int h = static_cast<int>(blockIdx.x) % hb % H;
  const int b = static_cast<int>(blockIdx.x) % hb / H;
  const int kh = h / (H / K);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + kBQ * kRow;     // two stages
  float* vs = ks + 2 * Sm::kTile;  // two stages
  float* ps = vs + 2 * Sm::kTile;  // P^T: ps[key * kPRow + query row]

  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(K) * hd;
  const float* qb = q + (static_cast<size_t>(b) * S * H + h) * hd;
  const float* kb = k + (static_cast<size_t>(b) * T * K + kh) * hd;
  const float* vb = v + (static_cast<size_t>(b) * T * K + kh) * hd;

  const int kv_end = causal ? min(T, q0 + kBQ) : T;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  // q and tile 0 in copy group 0, tile 1 in group 1
  stage_rows<HDP>(qs, qb, q_stride, q0, S, hd);
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    if (st < ntiles) {
      stage_rows<HDP>(ks + st * Sm::kTile, kb, kv_stride, st * kBK, T, hd);
      stage_rows<HDP>(vs + st * Sm::kTile, vb, kv_stride, st * kBK, T, hd);
    }
    cp_async_commit();
  }

  float acc[4][4 * kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kC; ++c) acc[i][c] = 0.f;
  float m[4], l[4];  // running max (log2 domain), this thread's part of
                     // the sum, of rows ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<1>();  // tile j (and q) has landed
    __syncthreads();
    const float* kt = ks + (j & 1) * Sm::kTile;
    const float* vt = vs + (j & 1) * Sm::kTile;

    // scores of rows ty + 16 i and keys tx + 8 jj
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kRow +
                                                 d);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(kt + (tx + 8 * jj) * kRow +
                                                  d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }

    // mask the diagonal and the ragged tile
    const int k0 = j * kBK;
    if ((causal && k0 + kBK - 1 > q0) || k0 + kBK > T) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = k0 + tx + 8 * jj, row = q0 + ty + 16 * i;
          if (col >= T || (causal && col > row)) s[i][jj] = -INFINITY;
        }
    }

    // online softmax of each row over the eight lanes that share it, in
    // the exp2 domain; P^T to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, s[i][jj]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(m[i], mx * scale_log2);
      // a row with no valid column yet keeps 2^(-inf - 0) = 0
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = fast_exp2(m[i] - base);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = fast_exp2(fmaf(s[i][jj], scale_log2, -base));
        ps[(tx + 8 * jj) * kPRow + ty + 16 * i] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * kC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P^T is written

    // acc += P V over the tile's 64 keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[c * kPRow + ty + 16 * i];
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vt + c * kRow + 4 * tx + 32 * cc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * cc] = fmaf(p[i], vv.x, acc[i][4 * cc]);
          acc[i][4 * cc + 1] = fmaf(p[i], vv.y, acc[i][4 * cc + 1]);
          acc[i][4 * cc + 2] = fmaf(p[i], vv.z, acc[i][4 * cc + 2]);
          acc[i][4 * cc + 3] = fmaf(p[i], vv.w, acc[i][4 * cc + 3]);
        }
      }
    }
    __syncthreads();  // the stage and P^T are consumed
    if (j + 2 < ntiles) {
      stage_rows<HDP>(ks + (j & 1) * Sm::kTile, kb, kv_stride,
                      (j + 2) * kBK, T, hd);
      stage_rows<HDP>(vs + (j & 1) * Sm::kTile, vb, kv_stride,
                      (j + 2) * kBK, T, hd);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * S + row) * q_stride + h * hd;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const int col = 4 * tx + 32 * cc;
      if (col < hd)  // hd % 4 == 0: the group is wholly inside or out
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * cc] * inv, acc[i][4 * cc + 1] * inv,
                        acc[i][4 * cc + 2] * inv, acc[i][4 * cc + 3] * inv);
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T, int H, int K, int hd, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<HDP>::kBytes;
  auto kernel = flash_attention_f32_kernel<HDP>;
  const long long blocks =
      static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
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

}  // namespace fp32

}  // namespace

// hd % 8 == 0 and hd <= 128; heads: query heads per block, 1 or 2 (of
// one KV group), 0 to choose (bf16); f32: q, k, v and o are fp32 (one
// head a block; heads 0 or 1), else bf16
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int K, int hd, int causal,
                                      int heads, int f32, void* stream) {
  if (K < 1 || H % K != 0 || hd < 8 || hd > kHD || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    if (heads > 1) return static_cast<int>(cudaErrorInvalidValue);
    if (hd <= 32) return fp32::launch<32>(q, k, v, o, B, S, T, H, K, hd,
                                         causal, st);
    if (hd <= 64) return fp32::launch<64>(q, k, v, o, B, S, T, H, K, hd,
                                         causal, st);
    return fp32::launch<128>(q, k, v, o, B, S, T, H, K, hd, causal, st);
  }
  if (heads == 0) {
    // two heads a block (each K and V tile read once for both) while
    // that still gives every SM a block
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long long pairs =
        static_cast<long long>((S + kBQ - 1) / kBQ) * (H / 2) * B;
    heads = (H / K) % 2 == 0 && pairs >= sms ? 2 : 1;
  }
  if (heads == 2 && (H / K) % 2 == 0)
    return launch<2>(q, k, v, o, B, S, T, H, K, hd, causal, st);
  if (heads == 1) return launch<1>(q, k, v, o, B, S, T, H, K, hd, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
