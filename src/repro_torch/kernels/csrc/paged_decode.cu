// paged_decode / paged_decode_quant: single-token GQA attention over a
// block-table-indirected KV page pool, with bf16 or int8 pages.
//
// Replaces src/repro/kernels/paged_decode.py::paged_decode (Pallas _kernel
// at :28) and ::paged_decode_quant (_kernel_quant at :68). The Pallas
// kernels run a grid (B, H, NP) whose page axis is walked in order on one
// core, with the online-softmax state in VMEM scratch and the block table
// prefetched as scalars. Here one block serves one (slot b, KV head) and
// all G query heads that read that KV head; it reads tables[b, pi] itself
// and loops over the pages up to pos[b] with an fp32 online softmax, so
// each KV page is read once for its G query heads. No atomics: the same
// inputs give the same bits.
//
// Bound on the H100: bytes. Decode reads every KV row a slot has written
// and does 4*G flops per element read, far below the card's ridge point.
// The design reads only the pages up to pos[b] (pos[b] < 0 reads nothing
// and writes an exactly-zero row); reads int8 pages at int8 width and
// dequantizes them into shared memory; loads 16 bytes a thread,
// neighbouring threads on neighbouring bytes of a page row; and takes
// several pages (64 rows) per step of its loop, so a long sequence costs
// few of the loop's barriers. One block per (slot, head) still walks a
// slot's pages in order: B*K blocks (64 at B=8) leave most of the card
// idle, and a 1,024-token slot is 16 steps of one block. Splitting a
// slot's pages across blocks, with a second pass that merges their
// partial softmax states, is the next step for speed.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;  // KV rows per step of the loop (whole pages)
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kMaxOut = kMaxG * kMaxHd / kThreads;  // outputs per thread

// One 16-byte load of page data as floats: 8 bf16 or 16 int8 values.
__device__ __forceinline__ void unpack(const uint4& u, const __nv_bfloat16*,
                                       float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, const int8_t*,
                                       float* out) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = static_cast<float>(c[e]);
}

// q: (B,1,H,hd) bf16; kp/vp: (P,page,K,hd) T; ks/vs: (P,page,K) fp32 (int8
// pages only); tables: (B,NP) int32; pos: (B,) int32; out: (B,1,H,hd) bf16.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ tables,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                    int NP, int page, int K, int hd, int G, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte load
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int H = G * K, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = kThreads / 32;
  const int tile_pages = max(1, kTileRows / page), rows = tile_pages * page;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // G * hd, pre-scaled by 1/sqrt(hd)
  float* kt = qs + G * hd;       // rows * hd
  float* vt = kt + rows * hd;    // rows * hd
  float* pr = vt + rows * hd;    // G * rows: scores, then probabilities
  float* run_m = pr + G * rows;  // G: running max
  float* run_l = run_m + G;      // G: running denominator
  float* alpha = run_l + G;      // G: this step's rescale of acc and l
  int* pid = reinterpret_cast<int*>(alpha + G);  // tile_pages page ids

  for (int i = tid; i < G * hd; i += kThreads)
    qs[i] = __bfloat162float(q[(static_cast<size_t>(b) * H + kh * G) * hd + i]) * scale;
  if (tid < G) {
    run_m[tid] = -1e30f;
    run_l[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const int p = pos[b];
  const int npages = p < 0 ? 0 : min(p / page + 1, NP);
  for (int pi0 = 0; pi0 < npages; pi0 += tile_pages) {
    const int start = pi0 * page;
    __syncthreads();  // the previous step's tiles are consumed
    if (tid < tile_pages)
      pid[tid] = pi0 + tid < npages ? tables[b * NP + pi0 + tid] : 0;
    __syncthreads();
    const int vecs = hd / kVec;
    for (int i = tid; i < rows * vecs; i += kThreads) {
      const int r = i / vecs, d0 = (i % vecs) * kVec;
      float kf[kVec], vf[kVec];
      if (start + r <= p) {
        const size_t row = static_cast<size_t>(pid[r / page]) * page + r % page;
        const size_t off = (row * K + kh) * hd + d0;
        unpack(*reinterpret_cast<const uint4*>(kp + off), kp, kf);
        unpack(*reinterpret_cast<const uint4*>(vp + off), vp, vf);
        if (kQuant) {
          const float a = ks[row * K + kh], c = vs[row * K + kh];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kf[e] *= a;
            vf[e] *= c;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(kt + r * hd + d0);
      float4* vd = reinterpret_cast<float4*>(vt + r * hd + d0);
#pragma unroll
      for (int e = 0; e < kVec / 4; ++e) {
        kd[e] = make_float4(kf[4 * e], kf[4 * e + 1], kf[4 * e + 2], kf[4 * e + 3]);
        vd[e] = make_float4(vf[4 * e], vf[4 * e + 1], vf[4 * e + 2], vf[4 * e + 3]);
      }
    }
    __syncthreads();
    // scores: one warp per (g, r) pair, lanes across hd
    for (int pair = warp; pair < G * rows; pair += nwarps) {
      const int g = pair / rows, r = pair % rows;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += qs[g * hd + d] * kt[r * hd + d];
      s = warp_sum(s);
      if (lane == 0) pr[pair] = start + r <= p ? s : -1e30f;
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
        const float e = start + r <= p ? expf(pr[g * rows + r] - mn) : 0.f;
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
        for (int r = 0; r < rows; ++r) sum += pr[g * rows + r] * vt[r * hd + d];
        acc[j] = acc[j] * alpha[g] + sum;
      }
    }
  }
  __syncthreads();  // run_l is final (and initialised when npages == 0)

#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o < G * hd)
      out[(static_cast<size_t>(b) * H + kh * G) * hd + o] =
          __float2bfloat16(acc[j] / fmaxf(run_l[o / hd], 1e-30f));
  }
}

template <typename T, bool kQuant>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* pos, void* out,
           int B, int NP, int page, int K, int hd, int G, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (G < 1 || G > kMaxG || hd > kMaxHd || hd % kVec != 0 || page < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_pages = kTileRows / page > 1 ? kTileRows / page : 1;
  const int rows = tile_pages * page;
  const int smem = (G * hd + 2 * rows * hd + G * rows + 3 * G + tile_pages) *
                   static_cast<int>(sizeof(float));
  auto kernel = paged_decode_kernel<T, kQuant>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  kernel<<<B * K, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), NP, page,
      K, hd, G, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_paged_decode(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* pos, void* out,
                                   int B, int NP, int page, int K, int hd, int G,
                                   void* stream) {
  return launch<__nv_bfloat16, false>(q, kp, vp, nullptr, nullptr, tables, pos,
                                      out, B, NP, page, K, hd, G,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int launch_paged_decode_quant(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* tables,
                                         const void* pos, void* out, int B,
                                         int NP, int page, int K, int hd, int G,
                                         void* stream) {
  return launch<int8_t, true>(q, kp, vp, ks, vs, tables, pos, out, B, NP, page,
                              K, hd, G, static_cast<cudaStream_t>(stream));
}
