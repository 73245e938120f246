// fused_sample: counter-hash Gumbel noise plus a first-index argmax over
// the vocabulary, a row's vocabulary split over a thread block cluster.
//
// Replaces src/repro/kernels/sampling.py::fused_sample (Pallas _kernel at
// :188), which walks vocab tiles in order on one TPU core and carries the
// running (max, index) in SMEM scratch.
//
// Bound on the H100: bytes. It reads B*Vp fp32 once (4.9 MB at B=8,
// Vp=151,936: 1.5 us at 3.35 TB/s) and does some 50 fp32 operations per
// noisy element, well under the card's fp32 rate once the work is spread
// over the card. So each row's vocabulary is split into up to 16
// contiguous ranges, one block each (128 blocks at B = 8), read with
// 16-byte loads; each thread keeps its best (value, index) in registers,
// the block reduces its pairs by warp shuffles, and the row's blocks, one
// thread block cluster (16 blocks: a non-portable cluster size), merge
// their pairs through distributed shared memory in range order; rank 0
// writes the token. One launch, no scratch in device memory. The
// sampler's front half (prepare_rows: vocab mask, temperature, top-k
// threshold) stays plain torch, as it stays plain XLA in JAX.
//
// Bit-exact contract (invariant I10): the token must equal the host
// oracle's (ServeEngine._sample, numpy). So: wrapping uint32 math and
// logical shifts; every float op is an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn), which the compiler never contracts
// into an FMA, and the source is also built with --fmad=false and
// -prec-div=true; bitcasts through __float_as_int/__int_as_float; the
// constants are given by their float32 bit patterns. The merge order does
// not change the token: take_better is a total order (larger value, then
// lower index; NaN never wins), so every order gives numpy's first-index
// argmax.
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr uint32_t kSalt = 0x5E12C0DEu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 16;      // blocks of a row's cluster
constexpr int kSplitMin = 4096;     // vocab entries a block at least

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

struct Row {
  const float* z;
  uint32_t base;
  bool noisy;

  __device__ __forceinline__ void take(float& v, int& bi, float zi,
                                       int i) const {
    const float y = noisy ? __fadd_rn(zi, gumbel(base, static_cast<uint32_t>(i)))
                          : zi;
    take_better(v, bi, y, i);
  }
};

// z: (B, V) fp32; keys: (B, 4) int32; out: (B,) int32. Grid (B, nsplit),
// the nsplit blocks of a row one cluster; block r covers the vector range
// [r per4, (r + 1) per4) of the row's float4 run, and rank 0 also the
// scalar entries before and after that run.
__global__ void __launch_bounds__(kThreads)
fused_sample_kernel(const float* __restrict__ z, const int* __restrict__ keys,
                    int* __restrict__ out, int V, int per4) {
  const int b = blockIdx.x, split = blockIdx.y;
  Row row;
  row.z = z + static_cast<size_t>(b) * V;
  const uint32_t seed = static_cast<uint32_t>(keys[4 * b + 0]);
  const uint32_t rid = static_cast<uint32_t>(keys[4 * b + 1]);
  const uint32_t ctr = static_cast<uint32_t>(keys[4 * b + 2]);
  row.noisy = keys[4 * b + 3] != 0;
  uint32_t base = mix(kSalt ^ (seed * kGold));
  base = mix(base ^ rid);
  row.base = mix(base ^ ctr);

  // the row's 16-byte aligned run: entries [head, head + 4 n4)
  const int head =
      static_cast<int>((4 - (reinterpret_cast<uintptr_t>(row.z) / 4) % 4) % 4);
  const int n4 = V > head ? (V - head) / 4 : 0;
  const float4* v4 = reinterpret_cast<const float4*>(row.z + head);
  float best = -INFINITY;
  int bi = INT_MAX;
  const int lo = split * per4, hi = min(n4, lo + per4);
  constexpr int kUnroll = 4;
  int q = lo + static_cast<int>(threadIdx.x);
  for (; q + (kUnroll - 1) * kThreads < hi; q += kUnroll * kThreads) {
    float4 f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f[u] = __ldg(v4 + q + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = head + 4 * (q + u * kThreads);
      row.take(best, bi, f[u].x, i);
      row.take(best, bi, f[u].y, i + 1);
      row.take(best, bi, f[u].z, i + 2);
      row.take(best, bi, f[u].w, i + 3);
    }
  }
  for (; q < hi; q += kThreads) {
    const float4 f = __ldg(v4 + q);
    const int i = head + 4 * q;
    row.take(best, bi, f.x, i);
    row.take(best, bi, f.y, i + 1);
    row.take(best, bi, f.z, i + 2);
    row.take(best, bi, f.w, i + 3);
  }
  if (split == 0) {
    // the entries outside the aligned run: before it, and the tail
    const int t = static_cast<int>(threadIdx.x);
    if (t < min(head, V)) row.take(best, bi, row.z[t], t);
    const int tail = head + 4 * n4 + t;
    if (tail < V && t < 4) row.take(best, bi, row.z[tail], tail);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(best, bi, ov, oi);
  }
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) take_better(best, bi, sv[w], si[w]);
    sv[0] = best;
    si[0] = bi;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's pair is in its shared memory
  if (split == 0 && threadIdx.x == 0) {
    const int n = static_cast<int>(gridDim.y);
    for (int r = 1; r < n; ++r)
      take_better(best, bi, *cluster.map_shared_rank(&sv[0], r),
                  *cluster.map_shared_rank(&si[0], r));
    out[b] = bi == INT_MAX ? 0 : bi;  // an all-NaN row: index 0
  }
  cluster.sync();  // rank 0 has read the other blocks' pairs
}

}  // namespace

// z: (B, V) fp32 rows from prepare_rows; keys: (B, 4) int32 (seed, rid,
// counter, noisy); out: (B,) int32. One cluster of up to 16 blocks a row,
// each at least 4,096 entries. Returns the launch's error, if any.
extern "C" int launch_fused_sample(const void* z, const void* keys, void* out,
                                   int B, int V, void* stream) {
  if (B < 1 || V < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = V / 4;  // float4s a row, within 3 of the aligned run's
  int nsplit = (V + kSplitMin - 1) / kSplitMin;
  nsplit = nsplit < 1 ? 1 : nsplit > kMaxSplits ? kMaxSplits : nsplit;
  const int per4 = (n4 + nsplit - 1) / nsplit + 1;  // covers the run
  auto kernel = fused_sample_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(z),
                           static_cast<const int*>(keys),
                           static_cast<int*>(out), V, per4);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
