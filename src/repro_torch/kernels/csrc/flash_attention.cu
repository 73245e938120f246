// flash_attention: blocked GQA attention forward, causal or not, with an
// fp32 online softmax; bf16 in and out.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas
// _kernel at :25). The Pallas kernel runs a grid (B, H, nq, nk) whose kv
// axis is walked in order on one TPU core, keeping (m, l, acc) in VMEM
// scratch across it, with 128x128 tiles for the MXU. Here one block owns
// one (query tile, query head, batch) and loops over the KV tiles itself:
// up to the diagonal when causal, with the running max, denominator and
// 64 x hd accumulator in shared memory and registers. Query head h reads
// KV head h / G. Ragged edges are masked in the kernel, so S and T may
// be any length (the Pallas wrapper needs S % min(128, S) == 0).
//
// Numerics follow the Pallas kernel: q is scaled by 1/sqrt(hd) in fp32,
// logits and probabilities stay fp32 (the PV product too), masked logits
// are -1e30, and the output is acc / max(l, 1e-30) cast to bf16. Causal
// masking is top-left aligned (query i sees keys j <= i), which equals
// the plain version's for the serve path's S == T.
//
// Bound on the H100: operations (4*S*T*hd per head, halved when causal)
// at the prompt lengths the serve path sees. This first version does
// them on the fp32 CUDA cores, not the tensor cores: 256 threads each
// own a 4x4 patch of the 64x64 score tile and a 4x(hd/16) patch of the
// output, with K padded in shared memory so the score loop is free of
// bank conflicts. Moving QK^T and PV to wgmma with TMA-fed tiles is the
// next step for speed.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // kv rows per tile
constexpr int kThreads = 256;

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1) + 3 * kBQ;
}

// q: (B,S,H,HD); k, v: (B,T,K,HD); o: (B,S,H,HD); all bf16, contiguous.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int S, int T, int H,
                       int K, float scale, int causal) {
  constexpr int NJ = HD / 16;  // output columns per thread
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  extern __shared__ float smem[];
  float* qs = smem;                   // kBQ x HD, pre-scaled
  float* ks = qs + kBQ * HD;          // kBK x (HD + 1), padded
  float* vs = ks + kBK * (HD + 1);    // kBK x HD
  float* ss = vs + kBK * HD;          // kBQ x (kBK + 1): scores, then p
  float* run_m = ss + kBQ * (kBK + 1);
  float* run_l = run_m + kBQ;
  float* alpha = run_l + kBQ;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    qs[i] = s < S ? __bfloat162float(q[((static_cast<size_t>(b) * S + s) * H + h) * HD + d]) * scale
                  : 0.f;
  }
  if (tid < kBQ) {
    run_m[tid] = -1e30f;
    run_l[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(T, q0 + kBQ) : T;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is loaded)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      const size_t off = ((static_cast<size_t>(b) * T + t) * K + kh) * HD + d;
      ks[r * (HD + 1) + d] = t < T ? __bfloat162float(k[off]) : 0.f;
      vs[r * HD + d] = t < T ? __bfloat162float(v[off]) : 0.f;
    }
    __syncthreads();
    // scores: rows ty + 16i, columns tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = kpos < T && (!causal || kpos <= q0 + r);
        ss[r * (kBK + 1) + c] = ok ? sc[i][j] : -1e30f;
      }
    __syncthreads();
    // online softmax: warp w owns rows 8w..8w+7, lanes own columns
    // lane and lane + 32
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = ss + r * (kBK + 1);
      const float a0 = row[lane], a1 = row[lane + 32];
      const float mp = run_m[r];
      const float mn = fmaxf(mp, warp_max(fmaxf(a0, a1)));
      const bool ok0 = k0 + lane < T && (!causal || k0 + lane <= q0 + r);
      const bool ok1 = k0 + lane + 32 < T && (!causal || k0 + lane + 32 <= q0 + r);
      const float p0 = ok0 ? expf(a0 - mn) : 0.f;
      const float p1 = ok1 ? expf(a1 - mn) : 0.f;
      const float ps = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(mp - mn);
        alpha[r] = a;
        run_l[r] = a * run_l[r] + ps;
        run_m[r] = mn;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();  // run_l is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s < S) {
      const float den = fmaxf(run_l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        o[((static_cast<size_t>(b) * S + s) * H + h) * HD + tx + 16 * j] =
            __float2bfloat16(acc[i][j] / den);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T, int H, int K, int causal, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<HD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T,
      H, K, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T, int H, int K, int hd, int causal,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, S, T, H, K, causal, st);
    case 128:
      return launch<128>(q, k, v, o, B, S, T, H, K, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
