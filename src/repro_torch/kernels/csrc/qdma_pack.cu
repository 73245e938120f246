// qdma_pack: the staging engine's device kernels — blockwise int8 pack,
// its inverse, and the content digest of dirty tracking.
//
// Replaces src/repro/kernels/qdma_pack.py: qdma_pack (:53, body
// _pack_kernel :28), qdma_pack_rows (:79, the same pack on a row range),
// qdma_unpack (:142, body _unpack_kernel :40) and qdma_digest (:117, body
// _digest_kernel :92). The Pallas kernels walk (rows, L) tiles in order on
// one TPU core; here every kernel splits its work into independent
// pieces, so the 132 SMs share it in any order.
//
// Bound on the H100: bytes. Each kernel reads its input once and writes
// its output once, with a few operations per byte. To reach the memory
// rate an SM needs some 25 KB of loads in flight, so the pack and the
// unpack give every lane several independent 16-byte accesses at once,
// keep all 32 lanes of a warp busy, and spend few instructions an
// element. The grid covers the work once, one step a warp: faster, for
// all but the bf16 pack, than a grid of as many blocks as the card holds
// at once whose warps loop (PERF.md):
//   pack    a group (one block of one row) is split over lpg lanes, a
//           power of two, each holding CPL 16-byte chunks of it (CPL 1, 2
//           or 4); a warp takes 4 / CPL sets of 32 / lpg consecutive groups
//           at once, so each lane has four 16-byte loads in flight and no
//           lane idles (bf16 at block 128: two groups a set, eight a warp
//           step), and each load instruction reads 512 contiguous bytes.
//           The max |x| goes over a group's lanes by xor shuffles of the
//           bits of |x| as unsigned integers: every NaN's bits exceed
//           inf's, so a NaN in a group wins the max, as it does in jnp.max.
//           The int8 stores write 128 or 256 contiguous bytes an
//           instruction, the scales of a warp step one coalesced store.
//           Groups whose count of 16-byte chunks is not a power of two
//           (blocks the staging engine does not use) take pack_any_kernel:
//           one lane group a group, its chunks read twice (the second time
//           from cache). qdma_pack_rows is the same launch on a row range:
//           the wrapper offsets the pointer, so no slice is copied.
//   unpack  a lane turns 4 int8 (-> fp32) or 8 (-> bf16) into one 16-byte
//           streaming store, so each store instruction writes 512
//           contiguous bytes; eight such pieces a lane in flight. A lane
//           divides once for its first piece's block (its scale's index)
//           and carries it to the next by adding a quotient and a
//           remainder.
//   digest  one thread per 16-byte word of the byte view. The weighted sum
//           of a word splits as (i0*m + a) * sum(u_j) + m * sum(j*u_j)
//           with i0 the word's first byte index and j = 0..15, so two
//           __dp4a per 4 bytes replace 16 multiply-adds per weight. Two
//           wrapping uint32 sums per thread are reduced over the warp and
//           the block, then atomicAdd'ed into the (2,) result: addition
//           mod 2^32 is associative, so the result does not depend on the
//           order the blocks finish in.
//
// Bit-exact contract: each kernel equals its plain version in
// kernels/ref.py, and the JAX kernels, bit for bit. So: the scale is
// max|x| times float32(1/127) (what XLA compiles `/ 127.0` into, see
// kernels/ref.py INV127) by __fmul_rn, floored at 1e-12 (a NaN stays
// NaN); q is x / scale under IEEE division (__fdiv_rn), clipped to +-127
// and rounded half to even (by adding kMagic, see below); a group
// whose scale is NaN or inf packs to 0 throughout (x / NaN is NaN, and so
// is inf / inf, and XLA converts NaN to 0); the product q * scale is
// __fmul_rn; bf16 outputs round to nearest even, and a NaN becomes 0x7FC0
// with its sign, as XLA converts it. No fast-math flags.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;   // the digest's grid-stride beyond this
constexpr int kPackSlots = 4;          // 16-byte loads in flight a lane (pack)
constexpr int kUnpackSlots = 8;        // 16-byte stores a lane a step (unpack)
constexpr int kMaxGroupBytes = 2048;
constexpr uint32_t kInv127Bits = 0x3c010204u;   // float32(1/127)

// c + kMagic, c an fp32 value in [-127, 127], rounds c to an integer,
// ties to even (as rintf), and leaves it in the low mantissa bits: the
// low byte of its bits is the int8 (two's complement), with no float to
// integer conversion.
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23

// digest weights: word i gets (i * m + a), i the byte index mod 2^32
constexpr uint32_t kM0 = 2654435761u, kA0 = 0x9E3779B1u;
constexpr uint32_t kM1 = 0x85EBCA6Bu, kA1 = 0xC2B2AE35u;

// 16 bytes of x, streamed (read once)
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// the 4 (fp32) or 8 (bf16) values of 16 loaded bytes as floats
template <typename T>
__device__ __forceinline__ void to_float(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      f[k] = __uint_as_float(w[k]);
    } else {                                   // bf16, the low half first
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

// the group's scale from the bits of its max |x|
__device__ __forceinline__ float group_scale(uint32_t m) {
  const float s = __fmul_rn(__uint_as_float(m), __uint_as_float(kInv127Bits));
  return s < 1e-12f ? 1e-12f : s;       // NaN compares false: stays NaN
}

__device__ __forceinline__ float clip127(float c) {
  return fminf(fmaxf(c, -127.0f), 127.0f);
}

// the bits of max |x| over a 16-byte chunk of x and m, as unsigned
// integers (a NaN wins)
template <typename T>
__device__ __forceinline__ uint32_t chunk_max(uint4 v, uint32_t m) {
  constexpr int V = 16 / sizeof(T);
  float f[V];
  to_float<T>(v, f);
#pragma unroll
  for (int e = 0; e < V; ++e) m = max(m, __float_as_uint(f[e]) & 0x7FFFFFFFu);
  return m;
}

// quantize one 16-byte chunk of x by its group's scale s; store the int8
// at dst
template <typename T>
__device__ __forceinline__ void store_chunk(int8_t* dst, uint4 v, float s) {
  constexpr int V = 16 / sizeof(T);
  uint32_t w[V / 4] = {};              // a NaN or inf scale packs to 0
  if (s < INFINITY) {
    float f[V];
    uint32_t t[V];
    to_float<T>(v, f);
#pragma unroll
    for (int e = 0; e < V; ++e)
      t[e] = __float_as_uint(__fadd_rn(clip127(__fdiv_rn(f[e], s)), kMagic));
#pragma unroll
    for (int k = 0; k < V / 4; ++k)    // the low bytes, little-endian
      w[k] = __byte_perm(__byte_perm(t[4 * k], t[4 * k + 1], 0x0040),
                         __byte_perm(t[4 * k + 2], t[4 * k + 3], 0x0040),
                         0x5410);
  }
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// One warp step: 4 / CPL sets of 32 / lpg consecutive groups of lpg * CPL
// 16-byte chunks (lpg a power of two <= 32).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
            float* __restrict__ scale, long long groups, int block, int lpg) {
  constexpr int V = 16 / sizeof(T);           // elements per chunk
  constexpr int kSets = kPackSlots / CPL;
  const int lane = threadIdx.x & 31;
  const int t = lane & (lpg - 1);             // lane within its group
  const int gps = 32 / lpg;                   // groups a set
  // the lane's group in set s is base + s * gps
  const long long base = (static_cast<long long>(blockIdx.x) * kWarps +
                          threadIdx.x / 32) * kSets * gps + lane / lpg;
  uint4 v[kSets][CPL];
#pragma unroll
  for (int s = 0; s < kSets; ++s) {
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (base + s * gps < groups)
        v[s][j] = load16(x + (base + s * gps) * block + (t + j * lpg) * V);
  }
  uint32_t m[kSets];
#pragma unroll
  for (int s = 0; s < kSets; ++s) {
    m[s] = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (base + s * gps < groups) m[s] = chunk_max<T>(v[s][j], m[s]);
  }
  for (int off = lpg >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < kSets; ++s)
      m[s] = max(m[s], __shfl_xor_sync(0xffffffffu, m[s], off));
  }
  float sc[kSets];
#pragma unroll
  for (int s = 0; s < kSets; ++s) {
    sc[s] = group_scale(m[s]);
    if (base + s * gps < groups) {
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        store_chunk<T>(q + (base + s * gps) * block + (t + j * lpg) * V,
                       v[s][j], sc[s]);
    }
  }
  // lane t of each group writes the scale of set t (and t + lpg, ...):
  // the warp step's kSets * gps scales are consecutive
  for (int s0 = 0; s0 < kSets; s0 += lpg) {
    float mine = sc[0];
#pragma unroll
    for (int s = 1; s < kSets; ++s) mine = (s0 + t == s) ? sc[s] : mine;
    const long long g = base + (s0 + t) * gps;
    if (s0 + t < kSets && g < groups) scale[g] = mine;
  }
}

// One group a lane group, any group of a multiple of 16 bytes (lpg: its
// chunk count's largest power-of-two factor, at most 32): the lanes read
// the group's chunks once for the max and again to quantize them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_any_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, long long groups, int block,
                int lpg) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int t = lane & (lpg - 1);
  const int chunks = block / V;
  const long long g = (static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32) * (32 / lpg) + lane / lpg;
  const bool valid = g < groups;
  uint32_t m = 0;
  for (int c = t; valid && c < chunks; c += lpg)
    m = chunk_max<T>(load16(x + g * block + c * V), m);
  for (int off = lpg >> 1; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = group_scale(m);
  for (int c = t; valid && c < chunks; c += lpg)
    store_chunk<T>(q + g * block + c * V, load16(x + g * block + c * V), s);
  if (valid && t == 0) scale[g] = s;
}

// the 4 int8 of w as floats, exactly: byte b + 128 in the low mantissa
// bits of 2^23, less 2^23 + 128 (two full-rate operations a value)
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t b = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650 | k)),
                     8388736.0f);
}

// bf16 bits of (lo, hi), nearest even
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// XLA's bf16 NaN: 0x7FC0 with the sign of the fp32 NaN
__device__ __forceinline__ uint32_t xla_nan16(float f) {
  return 0x7FC0u | ((__float_as_uint(f) >> 16) & 0x8000u);
}

__device__ __forceinline__ void store_piece(float* out, long long p,
                                            const float* f, bool) {
  __stcs(reinterpret_cast<float4*>(out) + p,
         make_float4(f[0], f[1], f[2], f[3]));
}

__device__ __forceinline__ void store_piece(__nv_bfloat16* out, long long p,
                                            const float* f, bool finite) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = bf16x2(f[2 * k], f[2 * k + 1]);
    if (!finite) {        // only a NaN or inf scale makes a NaN
      if (f[2 * k] != f[2 * k]) w[k] = (w[k] & 0xFFFF0000u) | xla_nan16(f[2 * k]);
      if (f[2 * k + 1] != f[2 * k + 1])
        w[k] = (w[k] & 0xFFFFu) | (xla_nan16(f[2 * k + 1]) << 16);
    }
  }
  __stcs(reinterpret_cast<uint4*>(out) + p, make_uint4(w[0], w[1], w[2], w[3]));
}

// One warp step: pieces p + 32k (k < kUnpackSlots) of P = 16 / sizeof(Out)
// values each; ppb: pieces a block (one scale).
template <typename Out>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
              Out* __restrict__ out, long long pieces, int ppb) {
  constexpr int P = 16 / sizeof(Out);
  using Word = std::conditional_t<P == 4, unsigned int, uint2>;  // P int8
  const long long p = (static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32) * (32 * kUnpackSlots) +
                      (threadIdx.x & 31);
  // piece p + 32k lies in block g at its piece r: one division for the
  // first, then a quotient and a remainder added per slot
  long long g = p / ppb;
  int r = static_cast<int>(p % ppb);
  Word w[kUnpackSlots];
  float s[kUnpackSlots];
#pragma unroll
  for (int k = 0; k < kUnpackSlots; ++k) {
    if (p + 32 * k < pieces) {
      w[k] = __ldcs(reinterpret_cast<const Word*>(q) + p + 32 * k);
      s[k] = __ldg(scale + g);
    }
    g += 32 / ppb;
    r += 32 % ppb;
    if (r >= ppb) {
      r -= ppb;
      ++g;
    }
  }
#pragma unroll
  for (int k = 0; k < kUnpackSlots; ++k) {
    if (p + 32 * k < pieces) {
      float f[P];
      if constexpr (P == 4) {
        int8x4_to_float(w[k], f);
      } else {
        int8x4_to_float(w[k].x, f);
        int8x4_to_float(w[k].y, f + 4);
      }
#pragma unroll
      for (int e = 0; e < P; ++e) f[e] = __fmul_rn(f[e], s[k]);
      store_piece(out, p + 32 * k, f, fabsf(s[k]) < INFINITY);
    }
  }
}

__device__ __forceinline__ uint32_t warp_sum_u32(uint32_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
digest_kernel(const uint8_t* __restrict__ u, long long n,
              uint32_t* __restrict__ out) {
  const long long nw = n / 16;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t s0 = 0, s1 = 0;
  for (long long w = tid; w < nw; w += stride) {
    const uint4 v = reinterpret_cast<const uint4*>(u)[w];
    // a = sum of the 16 bytes, b = sum of j * byte_j (j = 0..15)
    uint32_t a = __dp4a(v.x, 0x01010101u, 0u);
    a = __dp4a(v.y, 0x01010101u, a);
    a = __dp4a(v.z, 0x01010101u, a);
    a = __dp4a(v.w, 0x01010101u, a);
    uint32_t b = __dp4a(v.x, 0x03020100u, 0u);
    b = __dp4a(v.y, 0x07060504u, b);
    b = __dp4a(v.z, 0x0B0A0908u, b);
    b = __dp4a(v.w, 0x0F0E0D0Cu, b);
    const uint32_t i0 = static_cast<uint32_t>(w * 16);   // mod 2^32
    s0 += (i0 * kM0 + kA0) * a + kM0 * b;
    s1 += (i0 * kM1 + kA1) * a + kM1 * b;
  }
  if (tid < n - nw * 16) {                  // the ragged tail, a byte each
    const long long i = nw * 16 + tid;
    const uint32_t byte = u[i], ii = static_cast<uint32_t>(i);
    s0 += byte * (ii * kM0 + kA0);
    s1 += byte * (ii * kM1 + kA1);
  }
  s0 = warp_sum_u32(s0);
  s1 = warp_sum_u32(s1);
  __shared__ uint32_t part[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = s0;
    part[1][warp] = s1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      s0 += part[0][k];
      s1 += part[1][k];
    }
    atomicAdd(out, s0);
    atomicAdd(out + 1, s1);
  }
}

int grid_for(long long items_per_block_unit, long long units) {
  const long long blocks = (units + items_per_block_unit - 1) / items_per_block_unit;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

// blocks for `warp_steps` steps, one a warp (0 if the grid would exceed
// the card's limit, which no tensor in device memory reaches)
int blocks_for(long long warp_steps) {
  const long long blocks = (warp_steps + kWarps - 1) / kWarps;
  return blocks > INT_MAX ? 0 : static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename T, int CPL>
cudaError_t pack_launch(const void* x, void* q, void* scale, long long groups,
                        int block, int lpg, cudaStream_t st) {
  const long long per_step = static_cast<long long>(kPackSlots / CPL) * (32 / lpg);
  const int grid = blocks_for((groups + per_step - 1) / per_step);
  if (!grid) return cudaErrorInvalidValue;
  pack_kernel<T, CPL><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), groups, block, lpg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pack_dispatch(const void* x, void* q, void* scale,
                          long long groups, int block, cudaStream_t st) {
  const int chunks = block * static_cast<int>(sizeof(T)) / 16;
  if (chunks & (chunks - 1)) {                 // no power of two
    const int lpg = chunks & -chunks;          // <= 32 for chunks <= 128
    const int grid = blocks_for((groups + 32 / lpg - 1) / (32 / lpg));
    if (!grid) return cudaErrorInvalidValue;
    pack_any_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), groups, block, lpg);
    return cudaGetLastError();
  }
  if (chunks <= 32) return pack_launch<T, 1>(x, q, scale, groups, block, chunks, st);
  if (chunks == 64) return pack_launch<T, 2>(x, q, scale, groups, block, 32, st);
  return pack_launch<T, 4>(x, q, scale, groups, block, 32, st);
}

template <typename Out>
cudaError_t unpack_launch(const void* q, const void* scale, void* out,
                          long long n, int block, cudaStream_t st) {
  constexpr int P = 16 / sizeof(Out);
  const long long pieces = n / P;
  const int grid = blocks_for((pieces + 32 * kUnpackSlots - 1) /
                              (32 * kUnpackSlots));
  if (!grid) return cudaErrorInvalidValue;
  unpack_kernel<Out><<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<Out*>(out), pieces, block / P);
  return cudaGetLastError();
}

}  // namespace

// x: (groups * block) fp32 or bf16 (bf16 != 0), 16-byte aligned; q: the
// same count of int8; scale: (groups,) fp32. A group (block * sizeof(x)
// bytes) must be a multiple of 16 bytes and at most kMaxGroupBytes: else
// cudaErrorInvalidValue and no launch. Returns cudaGetLastError().
extern "C" int launch_qdma_pack(const void* x, void* q, void* scale,
                                long long groups, int block, int bf16,
                                void* stream) {
  const long long group_bytes = static_cast<long long>(block) * (bf16 ? 2 : 4);
  if (block < 1 || group_bytes % 16 || group_bytes > kMaxGroupBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? pack_dispatch<__nv_bfloat16>(x, q, scale, groups, block, st)
           : pack_dispatch<float>(x, q, scale, groups, block, st));
}

// q: (n,) int8, n % 16 == 0, block % 16 == 0; scale: (n / block,) fp32;
// out: (n,) fp32 or bf16 (bf16 != 0). Returns cudaGetLastError().
extern "C" int launch_qdma_unpack(const void* q, const void* scale, void* out,
                                  long long n, int block, int bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? unpack_launch<__nv_bfloat16>(q, scale, out, n, block, st)
           : unpack_launch<float>(q, scale, out, n, block, st));
}

// u: (n,) bytes, 16-byte aligned; out: (2,) uint32, zeroed by the caller
// on the same stream. Returns cudaGetLastError().
extern "C" int launch_qdma_digest(const void* u, long long n, void* out,
                                  void* stream) {
  const int grid = grid_for(kThreads, n / 16 > 16 ? n / 16 : 16);
  digest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(u), n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
