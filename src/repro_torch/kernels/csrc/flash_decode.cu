// flash_decode: single-token GQA attention over a dense KV cache at one
// position shared by the whole batch, bf16 in and out, fp32 softmax.
//
// Replaces src/repro/kernels/flash_decode.py::flash_decode (Pallas _kernel
// at :22, pallas_call at :72). The Pallas kernel runs a grid (B, H, T /
// block_k) whose cache axis is walked in order on one TPU core, with the
// online-softmax state in VMEM scratch, the position prefetched as a
// scalar and the tiles past it skipped. Here the cache axis is split
// across blocks instead: a first kernel gives each (slot b, KV head, split
// of split_rows rows) one block, which serves all G query heads that read
// that KV head, walks its rows up to pos in tiles of 64 with an fp32
// online softmax, and writes its unnormalised partial state (running max,
// denominator, G x hd accumulator) to a scratch the wrapper allocates; a
// second kernel merges the splits of each (b, KV head). Blocks whose rows
// all lie past pos read nothing. No atomics: the same inputs give the same
// bits.
//
// Bound on the H100: bytes. Decode reads every cache row up to pos once
// for its G query heads and does 4*G flops per element read, far below
// the card's ridge point; at B = 4, T = 1,024, pos = 511 that is 8.4 MB,
// 2.5 us. One block per (b, KV head) would leave 32 blocks for the whole
// card; splits of 64 rows give 16 per 1,024-row slot. The position is read
// from device memory, so a step never waits on the host. The score and PV
// products run on the fp32 CUDA cores from shared memory, over the valid
// rows of a tile only; a score is one thread's dot product, read 16 bytes
// at a time from K rows padded against bank conflicts.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;   // KV rows per step of a block's loop
constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kMaxOut = kMaxG * kMaxHd / kThreads;  // outputs per thread

// q: (B,1,H,hd); k, v: (B,T,K,hd), bf16; pos: one int32 in device memory.
// Partial states of block (bk = b*K + kh, split) at index bk*nsplit+split:
// part_m, part_l (..., G), part_acc (..., G, hd), fp32.
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ pos, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int T, int K, int hd, int G, int split_rows, float scale) {
  constexpr int kVec = 8;  // bf16 values per 16-byte load
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kh = bk % K, H = G * K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = kThreads / 32, rows = kTileRows;
  const int kp = hd + 4;         // padded K row: conflict-free float4 reads
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // G * hd, pre-scaled by 1/sqrt(hd)
  float* kt = qs + G * hd;       // rows * kp
  float* vt = kt + rows * kp;    // rows * hd
  float* pr = vt + rows * hd;    // G * rows: scores, then probabilities
  float* run_m = pr + G * rows;  // G: running max
  float* run_l = run_m + G;      // G: running denominator
  float* alpha = run_l + G;      // G: this step's rescale of acc and l

  for (int i = tid; i < G * hd; i += kThreads)
    qs[i] = __bfloat162float(q[(static_cast<size_t>(b) * H + kh * G) * hd + i]) * scale;
  if (tid < G) {
    run_m[tid] = -1e30f;
    run_l[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const int p = *pos;
  const int r_begin = split * split_rows;
  const int r_end = min(min(r_begin + split_rows, T), p + 1);  // exclusive
  for (int start = r_begin; start < r_end; start += rows) {
    __syncthreads();  // the previous step's tiles are consumed (qs loaded)
    const int vecs = hd / kVec;
    for (int i = tid; i < rows * vecs; i += kThreads) {
      const int r = i / vecs, d0 = (i % vecs) * kVec;
      float kf[kVec], vf[kVec];
      if (start + r < r_end) {
        const size_t off =
            ((static_cast<size_t>(b) * T + start + r) * K + kh) * hd + d0;
        const uint4 ku = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vu = *reinterpret_cast<const uint4*>(v + off);
        const __nv_bfloat162* kh2 = reinterpret_cast<const __nv_bfloat162*>(&ku);
        const __nv_bfloat162* vh2 = reinterpret_cast<const __nv_bfloat162*>(&vu);
#pragma unroll
        for (int e = 0; e < kVec / 2; ++e) {
          const float2 a = __bfloat1622float2(kh2[e]);
          const float2 c = __bfloat1622float2(vh2[e]);
          kf[2 * e] = a.x;
          kf[2 * e + 1] = a.y;
          vf[2 * e] = c.x;
          vf[2 * e + 1] = c.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(kt + r * kp + d0);
      float4* vd = reinterpret_cast<float4*>(vt + r * hd + d0);
      kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();
    const int valid = min(rows, r_end - start);
    // scores: one thread per (g, r) pair, 16 bytes of q and of k a step;
    // a warp's lanes take consecutive rows of one head, so q is a
    // broadcast and the padded k rows fall in distinct banks
    for (int pair = tid; pair < G * rows; pair += kThreads) {
      const int g = pair / rows, r = pair % rows;
      float s = -1e30f;
      if (r < valid) {
        const float4* qq = reinterpret_cast<const float4*>(qs + g * hd);
        const float4* kk = reinterpret_cast<const float4*>(kt + r * kp);
        s = 0.f;
        for (int i = 0; i < hd / 4; ++i) {
          const float4 a = qq[i], c = kk[i];
          s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
        }
      }
      pr[pair] = s;
    }
    __syncthreads();
    // online softmax: warp g turns head g's scores into probabilities and
    // advances head g's running (max, denominator)
    for (int g = warp; g < G; g += nwarps) {
      float mc = -1e30f;
      for (int r = lane; r < rows; r += 32) mc = fmaxf(mc, pr[g * rows + r]);
      mc = warp_max(mc);
      const float mp = run_m[g], mn = fmaxf(mp, mc);
      float ps = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = r < valid ? expf(pr[g * rows + r] - mn) : 0.f;
        pr[g * rows + r] = e;
        ps += e;
      }
      ps = warp_sum(ps);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(mp - mn);
        alpha[g] = a;
        run_l[g] = a * run_l[g] + ps;
        run_m[g] = mn;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ v; thread tid owns outputs tid + j*kThreads
    // of the G*hd (head, column) pairs
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < G * hd) {
        const int g = o / hd, d = o % hd;
        float sum = 0.f;
        for (int r = 0; r < valid; ++r) sum += pr[g * rows + r] * vt[r * hd + d];
        acc[j] = acc[j] * alpha[g] + sum;
      }
    }
  }
  __syncthreads();  // run_m and run_l are final (initialised if no rows)

  const size_t idx = static_cast<size_t>(bk) * gridDim.y + split;
  if (tid < G) {
    part_m[idx * G + tid] = run_m[tid];
    part_l[idx * G + tid] = run_l[tid];
  }
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o < G * hd) part_acc[idx * G * hd + o] = acc[j];
  }
}

// One block per (b, KV head): out = sum_s e^(m_s - M) acc_s /
// max(sum_s e^(m_s - M) l_s, 1e-30), M = max_s m_s. A split that read no
// rows has m = -1e30 and l = acc = 0, and adds nothing. The splits'
// weights e^(m_s - M) and the denominators are made once in shared memory.
__global__ void __launch_bounds__(kThreads)
flash_decode_merge(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc,
                   __nv_bfloat16* __restrict__ out, int K, int hd, int G,
                   int nsplit) {
  const int bk = blockIdx.x, b = bk / K, kh = bk % K, H = G * K;
  const int tid = threadIdx.x;
  const size_t first = static_cast<size_t>(bk) * nsplit;
  extern __shared__ float msm[];
  float* w = msm;                // nsplit * G: m_s, then e^(m_s - M)
  float* lsum = w + nsplit * G;  // nsplit * G: l_s
  float* den = lsum + nsplit * G;  // G
  for (int i = tid; i < nsplit * G; i += kThreads) {
    w[i] = part_m[first * G + i];
    lsum[i] = part_l[first * G + i];
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float M = -1e30f;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, w[s * G + g]);
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float e = expf(w[s * G + g] - M);
      w[s * G + g] = e;
      L += e * lsum[s * G + g];
    }
    den[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int o = tid; o < G * hd; o += kThreads) {
    const int g = o / hd;
    float A = 0.f;
#pragma unroll 4
    for (int s = 0; s < nsplit; ++s)
      A += w[s * G + g] * part_acc[(first + s) * G * hd + o];
    out[(static_cast<size_t>(b) * H + kh * G) * hd + o] =
        __float2bfloat16(A / den[g]);
  }
}

}  // namespace

// Scratch: part_m and part_l hold B*K*nsplit*G floats, part_acc that
// times hd, nsplit = ceil(T / split_rows).
extern "C" int launch_flash_decode(const void* q, const void* k, const void* v,
                                   const void* pos, void* part_m, void* part_l,
                                   void* part_acc, void* out, int B, int T,
                                   int K, int hd, int G, int split_rows,
                                   void* stream) {
  if (G < 1 || G > kMaxG || hd > kMaxHd || hd % 8 != 0 || T < 1 ||
      split_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = (T + split_rows - 1) / split_rows;
  const int smem = (G * hd + kTileRows * (2 * hd + 4) + G * kTileRows +
                    3 * G) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(flash_decode_split, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  flash_decode_split<<<dim3(B * K, nsplit), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), T, K, hd, G, split_rows, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int merge_smem = (2 * nsplit + 1) * G * static_cast<int>(sizeof(float));
  err = allow_smem(flash_decode_merge, merge_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_merge<<<B * K, kThreads, merge_smem, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out), K,
      hd, G, nsplit);
  return static_cast<int>(cudaGetLastError());
}
