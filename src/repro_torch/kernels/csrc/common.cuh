// Shared by the port's kernel sources. Each source is built on its own
// into a shared library with a plain C interface (see kernels/build.py)
// and bound with ctypes, so every library exports its own copy of
// kernel_error_string.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Let a kernel use more than the default 48 KB of dynamic shared memory;
// returns the attribute call's error, if any.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks of the attention kernels (sm_80 and later):
// cp.async copies into shared memory, ldmatrix fragment loads, movmatrix
// transposes and the bf16 mma.sync.m16n8k16 with fp32 accumulation; the
// TF32 mma.sync.m16n8k8 below.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for
// lane = 4 * g + t: A (16x16) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
// a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16x8, k x n) b0 = (2t..2t+1, g),
// b1 = (2t+8.., g); C (16x8) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, which lands in r[i] (thread 4g + t: row g, columns 2t and 2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// the same, each matrix transposed (thread 4g + t: rows 2t and 2t+1 of
// column g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// transpose one 8x8 b16 matrix held one row pair per thread, in registers
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// An 8x8 fp32 matrix held as (row g, columns 2t and 2t + 1) by lane 4 g +
// t, transposed: x0, x1 become (row 2t, column g) and (row 2t + 1, column
// g), by movmatrix on the values' high and low 16-bit halves (bits kept)
__device__ __forceinline__ void movmatrix_trans_f32(float& x0, float& x1) {
  const uint32_t a = __float_as_uint(x0), b = __float_as_uint(x1);
  const uint32_t hi = movmatrix_trans(__byte_perm(a, b, 0x7632));
  const uint32_t lo = movmatrix_trans(__byte_perm(a, b, 0x5410));
  x0 = __uint_as_float(__byte_perm(lo, hi, 0x5410));
  x1 = __uint_as_float(__byte_perm(lo, hi, 0x7632));
}

// 2^x by the special-function unit (relative error about 2^-22; 2^-inf =
// 0): the attention kernels' softmax
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a * b, bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as a bf16 pair hi (rounded to nearest) and the bf16 pair lo of
// what hi leaves over: hi + lo holds x to about 2^-16 of its value, so a
// product through both is fp32-accurate. x0 goes to the low half.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// (x0, x1) as three bf16 pairs p1 + p2 + p3, each rounded to nearest from
// what the pieces before it leave over (every remainder is exact in fp32):
// together they hold x to about 2^-27 of its value, so products of the
// pieces with exact bf16 values (int8 widened) carry fp32's precision. x0
// goes to the low halves.
__device__ __forceinline__ void split_bf16x3(float x0, float x1,
                                             uint32_t& p1, uint32_t& p2,
                                             uint32_t& p3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
  const float2 af = __bfloat1622float2(a);
  const float r0 = x0 - af.x, r1 = x1 - af.y;
  const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 c = __floats2bfloat162_rn(r0 - bf.x, r1 - bf.y);
  p1 = *reinterpret_cast<const uint32_t*>(&a);
  p2 = *reinterpret_cast<const uint32_t*>(&b);
  p3 = *reinterpret_cast<const uint32_t*>(&c);
}

// ---------------------------------------------------------------------------
// TF32 on the tensor cores (fp32 flash_attention, fp32 flash_decode, the
// paged decode over fp32 pages): 3xTF32 products, each fp32 operand as a
// TF32 pair hi + lo and a product as lo hi + hi lo + hi hi (CUTLASS's
// mma_tensor_op_fast_f32.h)
// ---------------------------------------------------------------------------
// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding, as an integer add and mask (cvt.rna
// compiles to a longer sequence with NaN and infinity checks). The tensor
// core itself would ignore the low 13 bits, which truncates.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as hi + lo, both TF32: x - hi is exact in fp32, and hi + lo holds x
// to about 2^-22 of its value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// c += a b, TF32 inputs, fp32 accumulator. Fragments (PTX ISA, mma.m16n8k8
// .tf32), lane = 4 g + t: A (16 x 8) a0 = (g, t), a1 = (g + 8, t), a2 =
// (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k x n) b0 = (t, g), b1 = (t +
// 4, g); C as mma.m16n8k16's
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The decode kernels' shared parts (flash_decode.cu, paged_decode.cu): a
// block of kDecWarps warps serves the G <= kDecMaxG query heads of one KV
// head over one split of the cache rows; the splits of a (slot, KV head)
// are one thread block cluster of at most kDecMaxSplits blocks.
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxG = 8;
constexpr int kDecMaxSplits = 8;

// floats of the merges in a block's shared memory: the warps' (m, l, acc),
// their weights, then the block's (m, l, acc)
template <int HDP>
struct DecMerge {
  static constexpr int kFloats =
      (kDecWarps + 1) * kDecMaxG * HDP + (3 * kDecWarps + 2) * kDecMaxG;
  // where each warp writes its state: wm, wl (kDecWarps x kDecMaxG), then
  // wacc (kDecWarps x kDecMaxG x HDP), the pad columns zero
  __device__ static float* wm(float* s) { return s; }
  __device__ static float* wl(float* s) { return s + kDecWarps * kDecMaxG; }
  __device__ static float* wacc(float* s) {
    return s + 2 * kDecWarps * kDecMaxG;
  }
};

// A warp's state into DecMerge's wm, wl, wacc (the tiles consumed): m and
// l of heads 2t and 2t + 1 (l: this thread's rows, summed here over the
// eight lanes of a column), acc[mt] the O^T rows (columns of the output)
// (half kMT + mt) 16 + g and + 8 of those heads. kMT = HDP / 16: the warp
// holds every column (half 0). kMT = HDP / 32: a pair of warps shares the
// rows and their m and l (DecTf32); each writes its half of the columns
// and zeros in the other, and the second (half 1) l 0.
template <int HDP, int kMT>
__device__ __forceinline__ void decode_publish(float* smem,
                                               const float (&acc)[kMT][4],
                                               float m0, float m1, float l0,
                                               float l1, int warp, int lane,
                                               int half) {
  static_assert(kMT * 16 == HDP || kMT * 32 == HDP,
                "all or half the columns");
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* wm = DecMerge<HDP>::wm(smem);
  float* wl = DecMerge<HDP>::wl(smem);
  if (g == 0) {
    wm[warp * kDecMaxG + 2 * t] = m0;
    wm[warp * kDecMaxG + 2 * t + 1] = m1;
    wl[warp * kDecMaxG + 2 * t] = half ? 0.f : l0;
    wl[warp * kDecMaxG + 2 * t + 1] = half ? 0.f : l1;
  }
  float* wa = DecMerge<HDP>::wacc(smem) + warp * kDecMaxG * HDP;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int d = (half * kMT + mt) * 16 + g;
    wa[(2 * t) * HDP + d] = acc[mt][0];
    wa[(2 * t + 1) * HDP + d] = acc[mt][1];
    wa[(2 * t) * HDP + d + 8] = acc[mt][2];
    wa[(2 * t + 1) * HDP + d + 8] = acc[mt][3];
  }
  if constexpr (kMT * 32 == HDP) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int d = ((1 - half) * kMT + mt) * 16 + g;
      wa[(2 * t) * HDP + d] = 0.f;
      wa[(2 * t + 1) * HDP + d] = 0.f;
      wa[(2 * t) * HDP + d + 8] = 0.f;
      wa[(2 * t + 1) * HDP + d + 8] = 0.f;
    }
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// Merge the warps' states (written to DecMerge's wm, wl, wacc) into the
// block's partial state, then, after a cluster barrier, merge a slice of
// the G*hd outputs from the `nsplit` blocks' states (distributed shared
// memory), in split order: out = sum_s e^(m_s - M) acc_s / max(sum_s
// e^(m_s - M) l_s, 1e-30), M = max_s m_s; no valid row at all gives zeros.
// `out` is this (slot, KV head)'s G x hd outputs. Every block of the
// cluster that has not exited calls it.
template <int HDP, typename OutT>
__device__ __forceinline__ void decode_merge(float* smem, int G, int hd,
                                             int split, int nsplit,
                                             OutT* out) {
  namespace cg = cooperative_groups;
  __syncthreads();  // every warp's state is written
  float* wm = DecMerge<HDP>::wm(smem);
  float* wl = DecMerge<HDP>::wl(smem);
  float* wacc = DecMerge<HDP>::wacc(smem);
  // the block's partial state: per head the warps' weights e^(m_w - M),
  // M (bm) and the denominator (bl), then bacc (kDecMaxG x HDP)
  float* we = wacc + kDecWarps * kDecMaxG * HDP;  // kDecWarps x kDecMaxG
  float* bm = we + kDecWarps * kDecMaxG;
  float* bl = bm + kDecMaxG;
  float* bacc = bl + kDecMaxG;
  if (threadIdx.x < G) {
    const int hq = threadIdx.x;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, wm[w * kDecMaxG + hq]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float mw = wm[w * kDecMaxG + hq];
      // a warp with no rows (m = -inf) adds nothing
      const float e = mw > -INFINITY ? fast_exp2(mw - M) : 0.f;
      we[w * kDecMaxG + hq] = e;
      L += e * wl[w * kDecMaxG + hq];
    }
    bm[hq] = M;
    bl[hq] = L;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < G * HDP; o += kDecThreads) {
    const int hq = o / HDP;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      A += we[w * kDecMaxG + hq] * wacc[w * kDecMaxG * HDP + o];
    bacc[o] = A;
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's state is written
  const int per = (G * HDP + nsplit - 1) / nsplit;
  const int o_end = min(G * HDP, (split + 1) * per);
  for (int o = split * per + static_cast<int>(threadIdx.x); o < o_end;
       o += kDecThreads) {
    const int hq = o / HDP, d = o % HDP;
    if (d >= hd) continue;  // a pad column
    float ms[kDecMaxSplits], ls[kDecMaxSplits], as[kDecMaxSplits];
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kDecMaxSplits; ++r) {
      ms[r] = -INFINITY;
      if (r < nsplit) {
        const float* rm = cluster.map_shared_rank(bm, r);
        ms[r] = rm[hq];
        ls[r] = rm[kDecMaxG + hq];      // bl
        as[r] = rm[2 * kDecMaxG + o];   // bacc
        M = fmaxf(M, ms[r]);
      }
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < kDecMaxSplits; ++r) {
      if (ms[r] > -INFINITY) {
        const float e = fast_exp2(ms[r] - M);
        L += e * ls[r];
        A += e * as[r];
      }
    }
    store_out(out + hq * hd + d, A / fmaxf(L, 1e-30f));
  }
  cluster.sync();  // the other blocks have read this block's state
}


// ---------------------------------------------------------------------------
// The decodes' 3xTF32 tile (fp32 flash_decode, the paged decode over fp32
// pages): a tile of 32 fp32 cache rows in shared memory as the cache holds
// them (rows padded by 16 bytes, zero past hd), and the block's four warps
// as two pairs, warps w and w + 2 on the same 16 rows, each with half h =
// w / 2 of the scores' k-steps and of O^T's m-tiles. At G = 2 three TF32
// products fill 2 of an mma's 8 columns, so the products, not the bytes,
// set the busiest warp's time: a pair halves it (PERF.md §6).
//   - S^T = K Q^T on mma.m16n8k8.tf32, the 16 rows as M and the G <= 8
//     query heads as N: K by 32-bit loads (the row pad puts lane (g, t) on
//     bank 4 g + t), split hi/lo in registers; q split once per block; hi
//     hi of even and odd k-steps in two sums and the cross terms in a
//     third; then the pair's two partial sums added through shared memory,
//     the same sum in both warps, so both keep the same softmax.
//   - The softmax in fp32 and exp2, its max and sum over the eight lanes
//     of a column by shuffles.
//   - P V as O^T = V^T P^T: V^T, the A operand, by 32-bit loads of rows 2t
//     and 2t + 1 at column g (bank 8 t + g), its k order matching P^T's:
//     the score tile's fp32 C fragment transposed by movmatrix on its
//     16-bit halves (bits kept), then split hi/lo. The leading products
//     and the corrections summed apart from zero for each tile, added in
//     fp32 and folded into the accumulator in the rescale's fma.
// The tensor core's fp32 accumulate aligns a step's addends to the largest
// and truncates, so a leading product and its corrections never share a
// running sum. A warp's state: acc[mt], O^T rows (columns of the output)
// (h kMT + mt) 16 + g and + 8, heads 2t and 2t + 1; m and l of heads 2t,
// 2t + 1 (l: this thread's rows).
// ---------------------------------------------------------------------------
template <int HDP>
struct DecTf32 {
  static constexpr int kRows = 32;         // cache rows a tile
  static constexpr int kStride = HDP + 4;  // floats a padded row
  static constexpr int kSK = HDP / 16;     // a warp's k-steps of the scores
  static constexpr int kMT = HDP / 32;     // a warp's m-tiles of O^T
  static constexpr int kQWords = 4 * kSK;  // a lane's words of q's pieces
  // the pairs' partial scores, one float4 a lane
  static constexpr int kXBytes = kDecWarps * 32 * 16;

  // q's values for lane (g, t) of a warp of half h: columns 8 (h kSK + kk)
  // + t and + 4 of head g's row qh (m16n8k8's b0, b1), zero past hd and
  // for a head past G (ok false)
  __device__ static void load_q(const float* qh, bool ok, int hd, int h,
                                int t, float (&qv)[2 * kSK]) {
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      const int d = 8 * (h * kSK + kk) + t;
      qv[2 * kk] = ok && d < hd ? qh[d] : 0.f;
      qv[2 * kk + 1] = ok && d + 4 < hd ? qh[d + 4] : 0.f;
    }
  }

  // words 4 kk .. 4 kk + 3: the hi of k-step kk's b0, b1, then their lo
  __device__ static void split_q(const float (&qv)[2 * kSK],
                                 uint32_t (&qw)[kQWords]) {
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      split_tf32(qv[2 * kk], qw[4 * kk], qw[4 * kk + 2]);
      split_tf32(qv[2 * kk + 1], qw[4 * kk + 1], qw[4 * kk + 3]);
    }
  }

  // One tile of the pair's 16 rows: kt, vt their first K and V rows
  // (kStride floats apart), the first nvalid >= 1 of them valid; xch the
  // block's exchange (kXBytes); scale_log2 = log2(e) / sqrt(hd).
  __device__ static void tile(const float* kt, const float* vt,
                              const uint32_t (&qw)[kQWords], float4* xch,
                              int nvalid, float scale_log2,
                              float (&acc)[kMT][4], float& m0, float& m1,
                              float& l0, float& l1, int warp, int lane) {
    const int g = lane / 4, t = lane % 4, half = warp >> 1;
    // the warp's half of the k-steps: K rows g, g + 8 at columns 8 kk + t
    // and + 4, hi hi of even and odd k-steps in s and s1, the cross terms
    // in sx; s: rows g, g + 8 (of the 16) x heads 2t, 2t + 1
    const float* kf = kt + g * kStride + 8 * half * kSK + t;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f},
          sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      const float* kr = kf + 8 * kk;
      uint32_t ah[4], al[4];
      split_tf32(kr[0], ah[0], al[0]);
      split_tf32(kr[8 * kStride], ah[1], al[1]);
      split_tf32(kr[4], ah[2], al[2]);
      split_tf32(kr[8 * kStride + 4], ah[3], al[3]);
      const uint32_t qh0 = qw[4 * kk], qh1 = qw[4 * kk + 1];
      mma_tf32(sx, al, qh0, qh1);
      mma_tf32(sx, ah, qw[4 * kk + 2], qw[4 * kk + 3]);
      mma_tf32(kk % 2 ? s1 : s, ah, qh0, qh1);
    }
    float4 mine;
    mine.x = s[0] + (s1[0] + sx[0]);
    mine.y = s[1] + (s1[1] + sx[1]);
    mine.z = s[2] + (s1[2] + sx[2]);
    mine.w = s[3] + (s1[3] + sx[3]);
    xch[warp * 32 + lane] = mine;
    // the pair's barrier: warps w and w + 2, named barrier 1 + w % 2
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (warp & 1)) : "memory");
    const float4 other = xch[(warp ^ 2) * 32 + lane];
    s[0] = mine.x + other.x;
    s[1] = mine.y + other.y;
    s[2] = mine.z + other.z;
    s[3] = mine.w + other.w;

    const bool ok_a = g < nvalid, ok_b = g + 8 < nvalid;
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
    // the tile's first row is valid, so both maxima are finite
    const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    s[0] = fast_exp2(s[0] - mx0);
    s[1] = fast_exp2(s[1] - mx1);
    s[2] = fast_exp2(s[2] - mx0);
    s[3] = fast_exp2(s[3] - mx1);
    l0 = l0 * alpha0 + s[0] + s[2];
    l1 = l1 * alpha1 + s[1] + s[3];

    // P^T as m16n8k8's B operand in k order (rows 2t, 2t + 1 of each 8):
    // the C fragment's rows g (k-step 0) and g + 8 (k-step 1) transposed,
    // then split; V^T's A fragments of the warp's m-tiles in the same k
    // order
    movmatrix_trans_f32(s[0], s[1]);
    movmatrix_trans_f32(s[2], s[3]);
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(s[e], ph[e], pl[e]);
    const float* vf = vt + 2 * t * kStride + 16 * half * kMT + g;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float h[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k8 = 0; k8 < 2; ++k8) {
        const float* vr = vf + 8 * k8 * kStride + mt * 16;
        uint32_t ah[4], al[4];
        split_tf32(vr[0], ah[0], al[0]);
        split_tf32(vr[8], ah[1], al[1]);
        split_tf32(vr[kStride], ah[2], al[2]);
        split_tf32(vr[kStride + 8], ah[3], al[3]);
        const uint32_t bh0 = ph[2 * k8], bh1 = ph[2 * k8 + 1];
        mma_tf32(x, al, bh0, bh1);
        mma_tf32(x, ah, pl[2 * k8], pl[2 * k8 + 1]);
        mma_tf32(h, ah, bh0, bh1);
      }
      acc[mt][0] = fmaf(acc[mt][0], alpha0, h[0] + x[0]);
      acc[mt][1] = fmaf(acc[mt][1], alpha1, h[1] + x[1]);
      acc[mt][2] = fmaf(acc[mt][2], alpha0, h[2] + x[2]);
      acc[mt][3] = fmaf(acc[mt][3], alpha1, h[3] + x[3]);
    }
  }
};
