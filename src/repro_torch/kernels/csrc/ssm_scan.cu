// ssm_scan: the chunked Mamba-2 SSD scan with one scalar decay per head;
// returns y and the final state, both fp32.
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan (Pallas _kernel at :25,
// pallas_call at :78). The Pallas kernel runs a grid (B, H, nc) whose chunk
// axis is walked in order on one TPU core, carrying the (hd, N) state in
// VMEM scratch, and does the chunk's work as three MXU products. Here one
// block owns one (batch, head) and walks the chunks itself, with the state
// in shared memory the whole time. Per chunk of Q tokens, all in fp32:
//
//   cum   = cumsum(log_a)                                       (Q,)
//   y     = ((exp(cum_t - cum_s) * tril) * (C B^T)) @ x + exp(cum) * (C H^T)
//   H_new = exp(cum_Q) H + (exp(cum_Q - cum) * x)^T B
//
// Shared memory: x (Q x hd), B (Q x N) and the state (hd x N) stay for the
// whole chunk; the Q x Q decay-weighted C B^T is made kTQ rows at a time,
// with the matching kTQ rows of C, so the footprint at Q = 128, hd = 64,
// N = 128 is 162 KB instead of the 256 KB that whole fp32 tiles of
// everything would take (more than the 227 KB a block may have). B, C and
// the state rows are padded to N + 1 floats, so every product's loads are
// either a broadcast or 32 distinct banks. Each thread owns a register
// tile of every product's output (4x4 of C B^T, 4x2 of y, 8x4 of the
// state), so a shared-memory load feeds two to four FMAs. The cumsum is a
// warp scan (its order differs from XLA's within fp32 rounding).
//
// Bound on the H100: operations. Per (batch, head, chunk) three products
// of 2*Q*Q*hd, 2*Q*hd*N and 2*Q*hd*N flops, at S = 512 with 256 heads of
// 64 and N = 128 about 6.5 GFLOP against 59 MB of inputs and outputs.
// This version runs them on the fp32 CUDA cores from shared memory,
// recomputes C B^T for every head (10.7 GFLOP at that shape) and skips
// the 32-column blocks of the masked upper triangle. Moving the
// products to the tensor cores (the TPU kernel computes in fp32, so tf32
// or a split-bf16 product would change the numbers) and sharing C B^T
// across heads are the next steps for speed.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 32;     // rows t of the chunk's C B^T made per pass
constexpr int kMaxQ = 128;  // chunk length: 4 column blocks of 32
constexpr int kMaxHd = 64;  // head width: the state tile's 8 rows of 8
constexpr int kMaxN = 128;  // state width: 4 column blocks of 32

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x: (B,S,H,hd) T; bv, cv: (B,S,N) T; la: (B,S,H) fp32;
// y: (B,S,H,hd) fp32; hout: (B,H,hd,N) fp32.
// Thread tid is (row group tid / 32, lane tid % 32) in every product.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ bv,
                const T* __restrict__ cv, const float* __restrict__ la,
                float* __restrict__ y, float* __restrict__ hout, int S, int H,
                int hd, int N, int Q) {
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int tid = threadIdx.x, lane = tid % 32, grp = tid / 32;
  const int NP = N + 1;            // padded row pitch of B, C and the state
  extern __shared__ float smem[];
  float* xs = smem;                // Q x hd
  float* bs = xs + Q * hd;         // Q x NP
  float* cs = bs + Q * NP;         // kTQ x NP: rows t0.. of C
  float* hs = cs + kTQ * NP;       // hd x NP: the carried state
  float* ws = hs + hd * NP;        // kTQ x Q: decay-weighted C B^T rows
  float* cum = ws + kTQ * Q;       // Q
  float* wdec = cum + Q;           // Q: exp(cum[Q-1] - cum[s])

  for (int i = tid; i < hd * NP; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const size_t row0 = static_cast<size_t>(b) * S + c0;  // first (b, t) row
    __syncthreads();  // the previous chunk's state update is done
    for (int i = tid; i < Q * hd; i += kThreads) {
      const int s = i / hd, d = i % hd;
      xs[i] = to_f(x[((row0 + s) * H + h) * hd + d]);
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int s = i / N, n = i % N;
      bs[s * NP + n] = to_f(bv[(row0 + s) * N + n]);
    }
    for (int s = tid; s < Q; s += kThreads) cum[s] = la[(row0 + s) * H + h];
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum, up to 4 consecutive values a lane
      const int per = (Q + 31) / 32;
      float v[kMaxQ / 32];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxQ / 32; ++e) {
        const int s = lane * per + e;
        if (e < per && s < Q) run += cum[s];
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += o;
      }
      const float before = tot - run;
#pragma unroll
      for (int e = 0; e < kMaxQ / 32; ++e) {
        const int s = lane * per + e;
        if (e < per && s < Q) cum[s] = before + v[e];
      }
    }
    __syncthreads();
    for (int s = tid; s < Q; s += kThreads) wdec[s] = expf(cum[Q - 1] - cum[s]);

    for (int t0 = 0; t0 < Q; t0 += kTQ) {
      const int rows = min(kTQ, Q - t0);
      const int send = t0 + rows;  // columns s < send can be unmasked
      __syncthreads();  // the previous pass's cs and ws are consumed
      for (int i = tid; i < rows * N; i += kThreads) {
        const int r = i / N, n = i % N;
        cs[r * NP + n] = to_f(cv[(row0 + t0 + r) * N + n]);
      }
      __syncthreads();
      // ws[r][s] = tril * exp(cum_t - cum_s) * <C_t, B_s>: rows grp + 8i,
      // columns lane + 32j, only the column blocks left of the diagonal
      {
        const int jn = (send + 31) / 32;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float c[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = cs[(grp + 8 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bb[j] = j < jn ? bs[min(lane + 32 * j, Q - 1) * NP + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += c[i] * bb[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = grp + 8 * i, t = t0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = lane + 32 * j;
            if (r < rows && s < Q)
              ws[r * Q + s] = s <= t ? expf(cum[t] - cum[s]) * acc[i][j] : 0.f;
          }
        }
      }
      __syncthreads();
      // y[t][d] = sum_s ws[t][s] x[s][d] + exp(cum_t) <C_t, H[d]>: rows
      // grp + 8i, columns lane + 32j
      {
        float in[4][2], it[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) in[i][j] = it[i][j] = 0.f;
        int dj[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) dj[j] = min(lane + 32 * j, hd - 1);
        for (int s = 0; s < send; ++s) {
          float w[4], xv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = ws[(grp + 8 * i) * Q + s];
#pragma unroll
          for (int j = 0; j < 2; ++j) xv[j] = xs[s * hd + dj[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) in[i][j] += w[i] * xv[j];
        }
        for (int n = 0; n < N; ++n) {
          float c[4], hv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = cs[(grp + 8 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 2; ++j) hv[j] = hs[dj[j] * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) it[i][j] += c[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = grp + 8 * i, t = t0 + r;
          if (r >= rows) continue;
          const float e = expf(cum[t]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = lane + 32 * j;
            if (d < hd)
              y[((row0 + t) * H + h) * hd + d] = in[i][j] + e * it[i][j];
          }
        }
      }
    }
    __syncthreads();  // every read of this chunk's incoming state is done
    // H[d][n] = exp(cum_Q) H[d][n] + sum_s (wdec_s x[s][d]) B[s][n]: rows
    // grp + 8i, columns lane + 32j
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      int di[8], nj[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) di[i] = min(grp + 8 * i, hd - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) nj[j] = min(lane + 32 * j, N - 1);
      for (int s = 0; s < Q; ++s) {
        const float wd = wdec[s];
        float xw[8], bb[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) xw[i] = wd * xs[s * hd + di[i]];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = bs[s * NP + nj[j]];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xw[i] * bb[j];
      }
      const float decay = expf(cum[Q - 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = grp + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          if (d < hd && n < N)
            hs[d * NP + n] = decay * hs[d * NP + n] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * N; i += kThreads) {
    const int d = i / N, n = i % N;
    hout[((static_cast<size_t>(b) * H + h) * hd + d) * N + n] = hs[d * NP + n];
  }
}

template <typename T>
int launch(const void* x, const void* bv, const void* cv, const void* la,
           void* y, void* hout, int B, int S, int H, int hd, int N, int Q,
           cudaStream_t stream) {
  if (Q < 1 || Q > kMaxQ || S % Q != 0 || hd < 1 || hd > kMaxHd || N < 1 ||
      N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (Q * hd + Q * (N + 1) + kTQ * (N + 1) + hd * (N + 1) +
                    kTQ * Q + 2 * Q) *
                   static_cast<int>(sizeof(float));
  auto kernel = ssm_scan_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bv),
      static_cast<const T*>(cv), static_cast<const float*>(la),
      static_cast<float*>(y), static_cast<float*>(hout), S, H, hd, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: x, bv and cv are bf16, else fp32. Takes Q <= 128, hd <= 64,
// N <= 128 (cudaErrorInvalidValue otherwise, with no launch).
extern "C" int launch_ssm_scan(const void* x, const void* bv, const void* cv,
                               const void* la, void* y, void* hout, int B,
                               int S, int H, int hd, int N, int Q, int bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, bv, cv, la, y, hout, B, S, H, hd, N, Q, st);
  return launch<float>(x, bv, cv, la, y, hout, B, S, H, hd, N, Q, st);
}
