// fused_sample: counter-hash Gumbel noise plus a first-index argmax over
// the vocabulary, one block per row.
//
// Replaces src/repro/kernels/sampling.py::fused_sample (Pallas _kernel at
// :188), which walks vocab tiles in order on one TPU core and carries the
// running (max, index) in SMEM scratch. Here every row is one block: its
// threads stride over the vocabulary, each keeps its own best (value,
// index), and the block reduces the pairs with the lower index winning
// ties, which is numpy's and torch's argmax rule over the whole row.
//
// Bound on the H100: bytes. It reads B*Vp fp32 once (4.9 MB at B=8,
// Vp=151,936) and does some 40 fp32 operations per noisy element, well
// under the card's fp32 rate; so the design only keeps reads coalesced
// (neighbouring threads on neighbouring columns) and keeps everything
// else in registers. The sampler's front half (prepare_rows: vocab mask,
// temperature, top-k threshold) stays plain torch, as it stays plain XLA
// in JAX.
//
// Bit-exact contract (invariant I10): the token must equal the host
// oracle's (ServeEngine._sample, numpy). So: wrapping uint32 math and
// logical shifts; every float op is an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn), which the compiler never contracts
// into an FMA, and the source is also built with --fmad=false and
// -prec-div=true; bitcasts through __float_as_int/__int_as_float; the
// constants are given by their float32 bit patterns.
#include "common.cuh"

#include <climits>

namespace {

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kSalt = 0x5E12C0DEu;
constexpr int kThreads = 512;

__device__ __forceinline__ float bits(uint32_t b) { return __uint_as_float(b); }

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 15;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

// Portable float32 log for x > 0: exponent split plus the atanh series,
// step for step as repro_torch/kernels/sampling.py::_log32.
__device__ __forceinline__ float log32(float x) {
  const float ln2 = bits(0x3f317218u), sqrt2 = bits(0x3fb504f3u);
  const float c3 = bits(0x3eaaaaabu), c5 = bits(0x3e4ccccdu);
  const float c7 = bits(0x3e124925u), c9 = bits(0x3de38e39u);
  int b = __float_as_int(x);
  int e = ((b >> 23) & 0xFF) - 127;
  float m = __int_as_float((b & 0x007FFFFF) | 0x3F800000);
  if (m > sqrt2) {
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  float t = __fmul_rn(s, s);
  float poly = __fmul_rn(t, c9);
  poly = __fmul_rn(t, __fadd_rn(c7, poly));
  poly = __fmul_rn(t, __fadd_rn(c5, poly));
  poly = __fmul_rn(t, __fadd_rn(c3, poly));
  poly = __fadd_rn(1.0f, poly);
  return __fadd_rn(__fmul_rn(__int2float_rn(e), ln2),
                   __fmul_rn(__fmul_rn(2.0f, s), poly));
}

__device__ __forceinline__ float gumbel(uint32_t base, uint32_t idx) {
  uint32_t h = mix(base ^ idx);
  float u = __fmul_rn(__fadd_rn(__uint2float_rn(h >> 8), 0.5f),
                      bits(0x33800000u));  // 2^-24
  return -log32(-log32(u));
}

// (value, index) with the larger value winning and the lower index
// winning ties; NaN never wins.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const float* __restrict__ z, const int* __restrict__ keys,
                    int* __restrict__ out, int V) {
  const int b = blockIdx.x;
  const float* row = z + static_cast<size_t>(b) * V;
  const uint32_t seed = static_cast<uint32_t>(keys[4 * b + 0]);
  const uint32_t rid = static_cast<uint32_t>(keys[4 * b + 1]);
  const uint32_t ctr = static_cast<uint32_t>(keys[4 * b + 2]);
  const bool noisy = keys[4 * b + 3] != 0;
  uint32_t base = mix(kSalt ^ (seed * kGold));
  base = mix(base ^ rid);
  base = mix(base ^ ctr);

  float best = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    float y = row[i];
    if (noisy) y = __fadd_rn(y, gumbel(base, static_cast<uint32_t>(i)));
    take_better(best, bi, y, i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, best, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(best, bi, ov, oi);
  }
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) take_better(best, bi, sv[w], si[w]);
    out[b] = bi == INT_MAX ? 0 : bi;  // an all-NaN row: index 0
  }
}

}  // namespace

// z: (B, V) fp32 rows from prepare_rows; keys: (B, 4) int32 (seed, rid,
// counter, noisy); out: (B,) int32. Returns cudaGetLastError().
extern "C" int launch_fused_sample(const void* z, const void* keys, void* out,
                                   int B, int V, void* stream) {
  fused_sample_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(keys),
      static_cast<int*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
