// qdma_pack: the staging engine's device kernels — blockwise int8 pack,
// its inverse, and the content digest of dirty tracking.
//
// Replaces src/repro/kernels/qdma_pack.py: qdma_pack (:53, body
// _pack_kernel :28), qdma_pack_rows (:79, the same pack on a row range),
// qdma_unpack (:142, body _unpack_kernel :40) and qdma_digest (:117, body
// _digest_kernel :92). The Pallas kernels walk (rows, L) tiles in order on
// one TPU core; here every kernel is a grid-stride loop over independent
// pieces, so the 132 SMs share the work in any order.
//
// Bound on the H100: bytes. Each kernel reads its input once and writes
// its output once, with a few operations per byte, so the design keeps
// every access 16 bytes wide and coalesced and keeps everything else in
// registers:
//   pack    one warp per (row, block) group: the lanes load the group 16
//           bytes at a time (fp32 or bf16 -> float), take the max |x| by
//           warp shuffle, and each lane writes its own quantized bytes;
//           lane 0 writes the group's scale. qdma_pack_rows is the same
//           launch on a row range: the wrapper offsets the pointer, so no
//           slice is copied.
//   unpack  one thread per 16 int8 values (one 16-byte load); the 16 lie
//           in one block, so one scale.
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
// kernels/ref.py INV127) by __fmul_rn, floored at 1e-12; x / scale is an
// IEEE division (__fdiv_rn) rounded half to even (rintf, not roundf); the
// product q * scale is __fmul_rn; bf16 outputs round to nearest even
// (__float2bfloat16_rn). No fast-math flags. One difference is left: a
// NaN in a pack group is dropped by fmaxf where jnp.max would keep it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride beyond this
constexpr int kMaxChunks = 4;          // 16-byte chunks per lane in a group
constexpr uint32_t kInv127Bits = 0x3c010204u;   // float32(1/127)

// digest weights: word i gets (i * m + a), i the byte index mod 2^32
constexpr uint32_t kM0 = 2654435761u, kA0 = 0x9E3779B1u;
constexpr uint32_t kM1 = 0x85EBCA6Bu, kA1 = 0xC2B2AE35u;

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);             // low half first
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t quant4(const float* f, float s) {
  uint32_t r = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(f[e], s)), -127.0f), 127.0f);
    r |= (static_cast<uint32_t>(static_cast<int>(v)) & 0xFFu) << (8 * e);
  }
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
            float* __restrict__ scale, long long groups, int block) {
  constexpr int V = 16 / sizeof(T);           // elements per 16 bytes
  const int lane = threadIdx.x & 31;
  const int chunks = block / V;               // 16-byte chunks per group
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const float inv127 = __uint_as_float(kInv127Bits);
  for (long long g = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> 5;
       g < groups; g += nwarps) {
    const T* src = x + g * block;
    float v[kMaxChunks][V];
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < chunks) {
        load16(src + chunk * V, v[c]);
#pragma unroll
        for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(v[c][e]));
      }
    }
    m = warp_max(m);
    const float s = fmaxf(__fmul_rn(m, inv127), 1e-12f);
    int8_t* dst = q + g * block;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < chunks) {
        if constexpr (V == 4) {
          *reinterpret_cast<uint32_t*>(dst + chunk * V) = quant4(v[c], s);
        } else {
          *reinterpret_cast<uint2*>(dst + chunk * V) =
              make_uint2(quant4(v[c], s), quant4(v[c] + 4, s));
        }
      }
    }
    if (lane == 0) scale[g] = s;
  }
}

__device__ __forceinline__ void unpack16(uint4 w, float s, float* f) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int8_t b = static_cast<int8_t>((words[k / 4] >> (8 * (k % 4))) & 0xFFu);
    f[k] = __fmul_rn(static_cast<float>(b), s);
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_f32_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ out, long long n16, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n16; i += stride) {
    float f[16];
    unpack16(reinterpret_cast<const uint4*>(q)[i], scale[i * 16 / block], f);
    float4* dst = reinterpret_cast<float4*>(out) + 4 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__global__ void __launch_bounds__(kThreads)
unpack_bf16_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, long long n16, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n16; i += stride) {
    float f[16];
    unpack16(reinterpret_cast<const uint4*>(q)[i], scale[i * 16 / block], f);
    uint4* dst = reinterpret_cast<uint4*>(out) + 2 * i;
    dst[0] = make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                        bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
    dst[1] = make_uint4(bf16x2(f[8], f[9]), bf16x2(f[10], f[11]),
                        bf16x2(f[12], f[13]), bf16x2(f[14], f[15]));
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

}  // namespace

// x: (groups * block) fp32 or bf16 (bf16 != 0), 16-byte aligned; q: the
// same count of int8; scale: (groups,) fp32. A group (block * sizeof(x)
// bytes) must be a multiple of 16 bytes and fit the warp's registers, at
// most 32 * 16 * kMaxChunks bytes: else cudaErrorInvalidValue and no
// launch. Returns cudaGetLastError().
extern "C" int launch_qdma_pack(const void* x, void* q, void* scale,
                                long long groups, int block, int bf16,
                                void* stream) {
  const long long group_bytes = static_cast<long long>(block) * (bf16 ? 2 : 4);
  if (block < 1 || group_bytes % 16 || group_bytes > 32 * 16 * kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_for(kThreads / 32, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    pack_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), groups, block);
  } else {
    pack_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), groups, block);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n,) int8, n % 16 == 0, block % 16 == 0; scale: (n / block,) fp32;
// out: (n,) fp32 or bf16 (bf16 != 0). Returns cudaGetLastError().
extern "C" int launch_qdma_unpack(const void* q, const void* scale, void* out,
                                  long long n, int block, int bf16,
                                  void* stream) {
  const long long n16 = n / 16;
  const int grid = grid_for(kThreads, n16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    unpack_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), n16, block);
  } else {
    unpack_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), n16, block);
  }
  return static_cast<int>(cudaGetLastError());
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
