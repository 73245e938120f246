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
// TF32 on the tensor cores (fp32 flash_attention, the fp32 paged decode):
// 3xTF32 products, each fp32 operand as a TF32 pair hi + lo and a product
// as lo hi + hi lo + hi hi (CUTLASS's mma_tensor_op_fast_f32.h)
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
// fp32 decode on the CUDA cores (flash_decode's fp32 path): one warp's
// kR cache rows (in shared memory as the cache holds them: fp32, or int8
// with fp32 row scales) against the G query heads of a KV head, every
// product an fp32 FMA. Scores: lane = (row lane % kR, heads lane / kR +
// (32 / kR) j); P V: lane = columns kVec lane + 32 kVec i. Between the
// two, P and the heads' rescale factors pass through the warp's scratch.
// ---------------------------------------------------------------------------
// n values of a shared-memory row at p as floats (fp32 or int8 rows)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "vector of 1, 2 or 4");
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const int8_t* p, float (&x)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "vector of 1, 2 or 4");
  if constexpr (N == 4) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (N == 2) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int HDP, int kR>
struct DecF32 {
  static_assert(kR == 8 || kR == 16, "8 or 16 rows a warp");
  static constexpr int kPairs = kDecMaxG * kR / 32;  // score pairs a lane
  static constexpr int kHeadStep = 32 / kR;          // heads between pairs
  static constexpr int kCols = HDP / 32;             // P V columns a lane
  static constexpr int kVec = kCols < 4 ? kCols : 4;
  // the warp's scratch, floats: P (kDecMaxG x kR), then the heads' rescale
  static constexpr int kScratch = kDecMaxG * kR + kDecMaxG;

  float m[kPairs], l[kPairs];  // the pairs' heads: running max, this
                               // lane's part of the denominator
  float acc[kDecMaxG][kCols];  // O: heads x this lane's columns

  __device__ void init() {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) m[j] = -INFINITY, l[j] = 0.f;
#pragma unroll
    for (int h = 0; h < kDecMaxG; ++h)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[h][c] = 0.f;
  }

  // One tile of the warp: rows kt/vt (`stride` elements apart, zero past
  // hd), the first `nvalid` >= 1 of them valid; qs the heads' q (kDecMaxG
  // x HDP fp32, zero past hd and past G); ksc/vsc the rows' scales (int8
  // rows) or null; scale_log2 = log2(e) / sqrt(hd).
  template <typename T>
  __device__ void tile(const T* kt, const T* vt, int stride,
                       const float* qs, float* scratch, int nvalid,
                       const float* ksc, const float* vsc, float scale_log2,
                       int G, int lane) {
    constexpr int kV = 16 / sizeof(T);  // values per 16-byte chunk
    const int r = lane % kR;
    const T* kr = kt + r * stride;
    float s[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HDP / kV; ++c) {
      float kv[kV];
      if constexpr (kV == 4) {
        load_f32<4>(reinterpret_cast<const float*>(kr) + c * 4, kv);
      } else {
#pragma unroll
        for (int e = 0; e < kV; e += 4) {
          float x[4];
          load_f32<4>(reinterpret_cast<const int8_t*>(kr) + c * kV + e, x);
#pragma unroll
          for (int i = 0; i < 4; ++i) kv[e + i] = x[i];
        }
      }
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int hq = lane / kR + kHeadStep * j;
        if (hq < G) {
          const float* qh = qs + hq * HDP + c * kV;
#pragma unroll
          for (int e = 0; e < kV; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qh + e);
            s[j] = fmaf(qv.x, kv[e], s[j]);
            s[j] = fmaf(qv.y, kv[e + 1], s[j]);
            s[j] = fmaf(qv.z, kv[e + 2], s[j]);
            s[j] = fmaf(qv.w, kv[e + 3], s[j]);
          }
        }
      }
    }
    float sl = scale_log2;
    if (ksc != nullptr) sl *= ksc[r];
    const float pv = vsc != nullptr ? vsc[r] : 1.f;
    float* ps = scratch;                    // kDecMaxG x kR
    float* alpha = scratch + kDecMaxG * kR;  // kDecMaxG
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int hq = lane / kR + kHeadStep * j;
      float x = r < nvalid ? s[j] * sl : -INFINITY;
      // max over the kR rows: the lanes that share the head
      float mx = x;
#pragma unroll
      for (int off = 1; off < kR; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (hq < G) {
        mx = fmaxf(m[j], mx);  // row 0 is valid: finite
        const float a = fast_exp2(m[j] - mx);
        const float p = fast_exp2(x - mx);
        m[j] = mx;
        l[j] = l[j] * a + p;
        ps[hq * kR + r] = p * pv;  // the v scale rides on P
        if (r == 0) alpha[hq] = a;
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kDecMaxG; ++h) {
      if (h < G) {
        const float a = alpha[h];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[h][c] *= a;
      }
    }
#pragma unroll 2
    for (int rr = 0; rr < kR; ++rr) {
      const T* vr = vt + rr * stride;
      float v[kCols];
#pragma unroll
      for (int i = 0; i < kCols / kVec; ++i) {
        float x[kVec];
        load_f32<kVec>(vr + kVec * lane + 32 * kVec * i, x);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[i * kVec + e] = x[e];
      }
#pragma unroll
      for (int h = 0; h < kDecMaxG; ++h) {
        if (h < G) {
          const float p = ps[h * kR + rr];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[h][c] = fmaf(p, v[c], acc[h][c]);
        }
      }
    }
    __syncwarp();  // the scratch is read before the next tile writes it
  }

  // This warp's state into DecMerge's wm, wl, wacc.
  __device__ void publish(float* smem, int warp, int lane) {
    float* wm = DecMerge<HDP>::wm(smem);
    float* wl = DecMerge<HDP>::wl(smem);
    float* wa = DecMerge<HDP>::wacc(smem) + warp * kDecMaxG * HDP;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int hq = lane / kR + kHeadStep * j;
      float x = l[j];
#pragma unroll
      for (int off = 1; off < kR; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane % kR == 0 && hq < kDecMaxG) {
        wm[warp * kDecMaxG + hq] = m[j];
        wl[warp * kDecMaxG + hq] = x;
      }
    }
#pragma unroll
    for (int h = 0; h < kDecMaxG; ++h)
#pragma unroll
      for (int i = 0; i < kCols / kVec; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          wa[h * HDP + kVec * lane + 32 * kVec * i + e] =
              acc[h][i * kVec + e];
  }
};
