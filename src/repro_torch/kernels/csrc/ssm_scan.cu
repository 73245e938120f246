// ssm_scan: the chunked Mamba-2 SSD scan with one scalar decay per head;
// returns y and the final state, both fp32.
//
// Replaces src/repro/kernels/ssm_scan.py::ssm_scan (Pallas _kernel at :25,
// pallas_call at :78). The Pallas kernel runs a grid (B, H, nc) whose chunk
// axis is walked in order on one TPU core, carrying the (hd, N) state in
// VMEM scratch, and does the chunk's work as three MXU products. Per chunk
// of Q tokens and head:
//
//   cum   = cumsum(log_a)                                       (Q,)
//   y     = ((exp(cum_t - cum_s) * tril) * (C B^T)) @ x + exp(cum) * (C H^T)
//   H_new = exp(cum_Q) H + (exp(cum_Q - cum) * x)^T B
//
// What bounds it on the H100: bytes, once the products run on the tensor
// cores. At (1,512,256,64), N 128, bf16 inputs the call moves 59.5 MB
// (x, B, C and log_a read once, y and the state written once: 17.8 us at
// 3.35 TB/s) for 4.8 GFLOP of products, 9.7 GFLOP counted as the tensor
// cores run them (a product with an fp32 operand twice, below), 9.8 us at
// 989 TFLOP/s bf16. So every product runs on the tensor cores, C B^T is
// made once for several heads, and the chunks of a sequence run side by
// side:
//
//   - One block of eight warps per (batch, chunk run, group of g heads;
//     g = 2 measured best at S 100 and 512). C B^T depends on the batch
//     row and the chunk but not on the head: each warp computes its 16
//     rows t of it (only the column tiles up to the diagonal) once a block
//     (kept in shared memory for bf16 inputs, in registers for fp32 ones),
//     and per head applies the decay mask exp(cum_t - cum_s) * tril in
//     registers, where the product's accumulator has the layout of the A
//     operand of the product with x.
//   - All four products are mma.sync.m16n8k16 bf16 with fp32 accumulation,
//     operands from XOR-swizzled shared memory by ldmatrix (.trans where
//     the operand is stored the other way round). With bf16 inputs C B^T
//     is exact up to the order of its fp32 sums. Each product with an fp32
//     operand (the decay-weighted C B^T, the incoming state H, the weighted
//     x of the state update) takes that operand as a bf16 pair hi + lo:
//     two MMAs, which hold it to about 2^-16 of its value (a single bf16
//     rounding misses the limit by 18-33x; tests/test_torch_ssm.py::
//     test_ssm_scan_numerics). fp32 inputs split x, B and C into pairs
//     too, three MMAs a product (hi hi, hi lo, lo hi). H itself stays fp32;
//     only its pair enters a product, so rounding does not compound from
//     chunk to chunk.
//   - The warps' work is evened out: the later rows of C B^T x cost more
//     (causal), so the state update's 16 x 16 units are split between
//     warps w and 7 - w in proportion (state_units).
//   - The chunks of one (batch, head group) form a thread block cluster of
//     up to 8 blocks; a sequence of more than 8 chunks gives each block a
//     run of consecutive chunks. Each block computes its run's state from
//     zero (S_r) and the run's decay d_r and publishes both in its shared
//     memory. After a cluster barrier each block takes 1/cs of the state's
//     elements through all runs in order, H_r = d_{r-1} H_{r-1} + S_{r-1},
//     reading the others' shared memory and writing each H_r into block
//     r's (distributed shared memory), and writes its slice of the final
//     state; after a second barrier each block adds exp(cum_t) C H_r^T.
//     The state-free part of y (C B^T x) runs between the first barrier's
//     arrive and its wait. Fixed order, no atomics: a second call gives the
//     same bits.
//   - One chunk (S <= Q, most prompts) needs no cluster and no incoming
//     state: the block's state is the final state.
//
// Shared memory: C and B tiles (Q x N bf16, pairs for fp32 inputs), the x
// tile (its pair for fp32), the weighted-x pair (reused for the incoming
// state's pair), the published fp32 state, C B^T (bf16 inputs) and the
// cumsums: 181 KB at bf16, N 128, hd 64, g 2 over a cluster; 225 KB for
// fp32 inputs, which take one head a block over a cluster.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // eight warps
constexpr int kMaxQ = 128;     // chunk length: 8 row tiles of 16
constexpr int kMaxHd = 64;     // head width: 4 tiles of 16
constexpr int kMaxN = 128;     // state width: 8 tiles of 16
constexpr int kMaxCluster = 8; // chunk runs of a (batch, head group)
constexpr int kMaxG = 2;       // heads a block, where they fit
constexpr int kSmemLimit = 232448;

// element counts of the shared-memory tiles; bf16 tiles have rows of
// kMaxN (C, B, the state pair) or kMaxHd (x) elements
constexpr int kTileN = kMaxQ * kMaxN;
constexpr int kTileX = kMaxQ * kMaxHd;
constexpr int kTileH = kMaxHd * kMaxN;
constexpr int kTileS = kMaxHd * kMaxN;  // fp32

// Element (row, col) of a bf16 tile with rows of `pitch` elements, its
// 16-byte chunks XOR-swizzled by the row: ldmatrix's eight row addresses
// of one column chunk then fall in eight distinct bank groups.
__device__ __forceinline__ int swz(int row, int col, int pitch) {
  return row * pitch + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// Element (d, n) of an fp32 state tile, its 16-byte runs XOR-swizzled by
// the row: a fragment's eight rows of float2 spread over the banks, and a
// warp's sixteen-byte runs along a row stay conflict-free.
__device__ __forceinline__ int sidx(int d, int n) {
  return d * kMaxN + ((((n >> 2) ^ (d & 7))) << 2) + (n & 3);
}

// ldmatrix fragments for mma.m16n8k16, lane = 8 i + r (common.cuh):
// A (16 x 16) at (m0, k0) of a tile stored [m][k] ...
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t,
                                    int pitch, int m0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, t + swz(m0 + (i & 1) * 8 + r, k0 + (i >> 1) * 8, pitch));
}
// ... or stored [k][m]
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* t,
                                      int pitch, int m0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a,
                    t + swz(k0 + (i >> 1) * 8 + r, m0 + (i & 1) * 8, pitch));
}
// B of two n8 tiles (n0.., n0 + 8..) x k16 at k0: b[0], b[1] the first,
// b[2], b[3] the second; from a tile stored [n][k] ...
__device__ __forceinline__ void ldb(uint32_t (&b)[4], const bf16* t,
                                    int pitch, int n0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, t + swz(n0 + (i >> 1) * 8 + r, k0 + (i & 1) * 8, pitch));
}
// ... or stored [k][n]
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], const bf16* t,
                                      int pitch, int n0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b,
                    t + swz(k0 + (i & 1) * 8 + r, n0 + (i >> 1) * 8, pitch));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// exp(x) by the special-function unit: 2^(x log2 e) (relative error
// about 2^-22 plus |x| 2^-24 from rounding the argument; 0 below -87)
__device__ __forceinline__ float fexp(float x) {
  return fast_exp2(x * 1.4426950408889634f);
}

// Eight consecutive elements as fp32, `valid` of them from p (the rest
// zero); 16-byte loads when `vec` and all eight are there.
__device__ __forceinline__ void load8(float (&v)[8], const float* p,
                                      int valid, bool vec) {
  if (vec && valid == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e] : 0.f;
}

// Eight consecutive bf16 elements as packed pairs, `valid` of them from p.
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, int valid,
                                            bool vec) {
  if (vec && valid == 8) return __ldg(reinterpret_cast<const uint4*>(p));
  __nv_bfloat16 e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < valid ? p[i] : __float2bfloat16(0.f);
  uint4 u;
  u.x = *reinterpret_cast<const uint32_t*>(&e[0]);
  u.y = *reinterpret_cast<const uint32_t*>(&e[2]);
  u.z = *reinterpret_cast<const uint32_t*>(&e[4]);
  u.w = *reinterpret_cast<const uint32_t*>(&e[6]);
  return u;
}

__device__ __forceinline__ void unpack8(float (&v)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// Eight fp32 values as bf16 into hi[idx..] and, when `pair`, what hi
// leaves over into lo[idx..].
__device__ __forceinline__ void store8(bf16* hi, bf16* lo, int idx,
                                       const float (&v)[8], bool pair) {
  uint4 h, l;
  split_bf16x2(v[0], v[1], h.x, l.x);
  split_bf16x2(v[2], v[3], h.y, l.y);
  split_bf16x2(v[4], v[5], h.z, l.z);
  split_bf16x2(v[6], v[7], h.w, l.w);
  *reinterpret_cast<uint4*>(hi + idx) = h;
  if (pair) *reinterpret_cast<uint4*>(lo + idx) = l;
}

// Rows 0..Q16-1 of a chunk's C or B (rows of N at src) into a tile, zero
// past Q rows and N columns. bf16 rows go by cp.async where they are
// 16-byte runs (the caller commits and waits); fp32 rows are split into
// the tile and its lo tile, four runs of eight in flight a thread.
__device__ void load_bc(bf16* t, const bf16* src, int Q, int N, int Q16,
                        int N16, bool vec) {
  const int cpr = N16 / 8, total = Q16 * cpr;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int s = i / cpr, c8 = (i % cpr) * 8;
    const int valid = s < Q ? max(0, min(8, N - c8)) : 0;
    const bf16* p = src + static_cast<size_t>(s) * N + c8;
    if (vec) {
      cp_async16(t + swz(s, c8, kMaxN), valid ? p : src, valid ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(t + swz(s, c8, kMaxN)) =
          load8_bf16(p, valid, false);
    }
  }
}

__device__ void load_bc(bf16* t, const float* src, int Q, int N, int Q16,
                        int N16, bool vec) {
  const int cpr = N16 / 8, total = Q16 * cpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kThreads) {
    float v[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, s = i / cpr, c8 = (i % cpr) * 8;
      const int valid = i < total && s < Q ? max(0, min(8, N - c8)) : 0;
      load8(v[k], src + static_cast<size_t>(s) * N + c8, valid, vec);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, s = i / cpr, c8 = (i % cpr) * 8;
      if (i < total) store8(t, t + kTileN, swz(s, c8, kMaxN), v[k], true);
    }
  }
}

// A thread's share of a chunk's x tile (rows 0..Q16-1, head width hd16),
// held in registers: up to four runs of eight elements, packed bf16 for
// bf16 inputs.
template <typename T>
struct XRegs {
  float v[4][8];
};
template <>
struct XRegs<bf16> {
  uint4 v[4];
};

__device__ __forceinline__ void xrun(int k, int hd16, int& i, int& s,
                                     int& c8) {
  const int cpr = hd16 / 8;
  i = threadIdx.x + k * kThreads;
  s = i / cpr;
  c8 = (i % cpr) * 8;
}

template <typename T>
__device__ void load_x(XRegs<T>& xr, const T* src, size_t pitch, int Q,
                       int hd, int Q16, int hd16, bool vec) {
  const int total = Q16 * (hd16 / 8);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i, s, c8;
    xrun(k, hd16, i, s, c8);
    const int valid = i < total && s < Q ? max(0, min(8, hd - c8)) : 0;
    if constexpr (std::is_same<T, bf16>::value)
      xr.v[k] = load8_bf16(src + s * pitch + c8, valid, vec);
    else
      load8(xr.v[k], src + s * pitch + c8, valid, vec);
  }
}

// The x tile (its pair for fp32 inputs) from registers, or with
// `weight` the pair of w(s) x, w(s) = exp(cum[Q-1] - cum[s]) for s < Q
// (the state update's weights).
template <typename T>
__device__ void store_x(bf16* xs, const XRegs<T>& xr, const float* cum,
                        int Q, int Q16, int hd16, bool weight) {
  const int total = Q16 * (hd16 / 8);
  const float last = cum[Q - 1];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int i, s, c8;
    xrun(k, hd16, i, s, c8);
    if (i >= total) continue;
    float v[8];
    if constexpr (std::is_same<T, bf16>::value) {
      if (!weight) {  // exact in bf16: the tile itself
        *reinterpret_cast<uint4*>(xs + swz(s, c8, kMaxHd)) = xr.v[k];
        continue;
      }
      unpack8(v, xr.v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = xr.v[k][e];
    }
    if (weight) {
      const float w = s < Q ? fexp(last - cum[s]) : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= w;
    }
    store8(xs, xs + kTileX, swz(s, c8, kMaxHd), v, true);
  }
}

// One warp: cum[s] = cumsum(log_a) of head h over the chunk's Q rows
// (rows row0.. of la), cum[Q..Q16-1] = cum[Q-1].
__device__ void chunk_cum(float* cum, const float* la, size_t row0, int H,
                          int h, int Q, int Q16, int lane) {
  const int per = (Q + 31) / 32;  // at most 4 consecutive rows a lane
  float v[kMaxQ / 32];
#pragma unroll
  for (int e = 0; e < kMaxQ / 32; ++e) {
    const int s = lane * per + e;
    v[e] = (e < per && s < Q) ? la[(row0 + s) * H + h] : 0.f;
  }
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxQ / 32; ++e) {
    run += v[e];
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
  __syncwarp();
  const float last = cum[Q - 1];
  for (int s = Q + lane; s < Q16; s += 32) cum[s] = last;
}

// G = C B^T, rows 16 warp.. of the chunk, column tiles 8j.. for j up to
// the diagonal (2 warp + 1).
template <int P>
__device__ void compute_g(float (&G)[16][4], const bf16* ct, const bf16* bt,
                          int warp, int lane, int N16) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) G[j][e] = 0.f;
#pragma unroll
  for (int kn = 0; kn < kMaxN / 16; ++kn) {
    if (16 * kn >= N16) break;
    uint32_t a[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
      lda(a[p], ct + p * kTileN, kMaxN, 16 * warp, 16 * kn, lane);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (jj <= warp) {
        uint32_t bh[4];
        ldb(bh, bt, kMaxN, 16 * jj, 16 * kn, lane);
        mma_bf16(G[2 * jj], a[0], bh[0], bh[1]);
        mma_bf16(G[2 * jj + 1], a[0], bh[2], bh[3]);
        if (P == 2) {
          uint32_t bl[4];
          ldb(bl, bt + kTileN, kMaxN, 16 * jj, 16 * kn, lane);
          mma_bf16(G[2 * jj], a[0], bl[0], bl[1]);
          mma_bf16(G[2 * jj + 1], a[0], bl[2], bl[3]);
          mma_bf16(G[2 * jj], a[P - 1], bh[0], bh[1]);
          mma_bf16(G[2 * jj + 1], a[P - 1], bh[2], bh[3]);
        }
      }
    }
  }
}

// acc += ((exp(cum_t - cum_s) * tril) * G) x for the warp's 16 rows: the
// weight as a bf16 pair, x (and its lo part for fp32 inputs) from the tile.
// Below the diagonal tile exp(cum_t - cum_s) = exp(cum_t - cum_m)
// exp(cum_m - cum_s) with m the warp's first row, both factors at most 1.
template <int P, typename GTile>
__device__ void intra(float (&acc)[8][4], GTile gtile, const float* cum,
                      const bf16* xs, int warp, int lane, int hd16) {
  const int gq = lane >> 2, tq = lane & 3;
  const int t0 = 16 * warp + gq, t1 = t0 + 8;
  const float c0 = cum[t0], c1 = cum[t1], cm = cum[16 * warp];
  const float r0 = fexp(c0 - cm), r1 = fexp(c1 - cm);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk > warp) break;
    float w[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = 16 * kk + 8 * half + 2 * tq;
      const float e0 = cum[s], e1 = cum[s + 1];
      const float4 G = gtile(2 * kk + half);
      if (kk < warp) {
        const float f0 = fexp(cm - e0), f1 = fexp(cm - e1);
        w[half][0] = r0 * f0 * G.x;
        w[half][1] = r0 * f1 * G.y;
        w[half][2] = r1 * f0 * G.z;
        w[half][3] = r1 * f1 * G.w;
      } else {
        w[half][0] = s <= t0 ? fexp(c0 - e0) * G.x : 0.f;
        w[half][1] = s + 1 <= t0 ? fexp(c0 - e1) * G.y : 0.f;
        w[half][2] = s <= t1 ? fexp(c1 - e0) * G.z : 0.f;
        w[half][3] = s + 1 <= t1 ? fexp(c1 - e1) * G.w : 0.f;
      }
    }
    uint32_t ah[4], al[4];
    split_bf16x2(w[0][0], w[0][1], ah[0], al[0]);
    split_bf16x2(w[0][2], w[0][3], ah[1], al[1]);
    split_bf16x2(w[1][0], w[1][1], ah[2], al[2]);
    split_bf16x2(w[1][2], w[1][3], ah[3], al[3]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      if (16 * dd < hd16) {
        uint32_t bh[4];
        ldb_t(bh, xs, kMaxHd, 16 * dd, 16 * kk, lane);
        mma_bf16(acc[2 * dd], ah, bh[0], bh[1]);
        mma_bf16(acc[2 * dd + 1], ah, bh[2], bh[3]);
        mma_bf16(acc[2 * dd], al, bh[0], bh[1]);
        mma_bf16(acc[2 * dd + 1], al, bh[2], bh[3]);
        if (P == 2) {
          uint32_t bl[4];
          ldb_t(bl, xs + kTileX, kMaxHd, 16 * dd, 16 * kk, lane);
          mma_bf16(acc[2 * dd], ah, bl[0], bl[1]);
          mma_bf16(acc[2 * dd + 1], ah, bl[2], bl[3]);
        }
      }
    }
  }
}

// acc = exp(cum_t) C H^T for the warp's 16 rows, H as its bf16 pair.
template <int P>
__device__ void inter(float (&acc)[8][4], const bf16* ct, const bf16* hp,
                      const float* cum, int warp, int lane, int N16,
                      int hd16) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kn = 0; kn < kMaxN / 16; ++kn) {
    if (16 * kn >= N16) break;
    uint32_t a[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
      lda(a[p], ct + p * kTileN, kMaxN, 16 * warp, 16 * kn, lane);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      if (16 * dd < hd16) {
        uint32_t bh[4], bl[4];
        ldb(bh, hp, kMaxN, 16 * dd, 16 * kn, lane);
        ldb(bl, hp + kTileH, kMaxN, 16 * dd, 16 * kn, lane);
        mma_bf16(acc[2 * dd], a[0], bh[0], bh[1]);
        mma_bf16(acc[2 * dd + 1], a[0], bh[2], bh[3]);
        mma_bf16(acc[2 * dd], a[0], bl[0], bl[1]);
        mma_bf16(acc[2 * dd + 1], a[0], bl[2], bl[3]);
        if (P == 2) {
          mma_bf16(acc[2 * dd], a[P - 1], bh[0], bh[1]);
          mma_bf16(acc[2 * dd + 1], a[P - 1], bh[2], bh[3]);
        }
      }
    }
  }
  const int t0 = 16 * warp + (lane >> 2);
  const float e0 = fexp(cum[t0]), e1 = fexp(cum[t0 + 8]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= e0;
    acc[j][1] *= e0;
    acc[j][2] *= e1;
    acc[j][3] *= e1;
  }
}

// The warp's share of the (hd x N) state: units of 16 x 16, rows d in
// 16 mt.., columns n in 16 u.. for u in [u0, u1). Warps w and 7 - w share
// m-tile mt = min(w, 7 - w) and split its N16 / 16 units so that each
// warp's products of one head even out: the warp whose rows t make more of
// the causal C B^T x (the later rows) takes fewer state units. At most
// kMaxU units a warp (so at least one for the other warp of the pair).
constexpr int kMaxU = 7;
struct Units {
  int mt, u0, u1;
};

__device__ Units state_units(int warp, int Q16, int hd16, int N16) {
  const int R = Q16 / 16, DD = hd16 / 16, nu = N16 / 16;
  const int w = warp < 4 ? warp : 7 - warp;
  if (16 * w >= hd16) return {w, 0, 0};
  // cost in mma of a state unit and of a warp's C B^T x a head; the
  // latter's mma weigh 1.5 (its weights are made from exponentials)
  const int unit = 8 * R;
  const int mine = w < R ? 12 * DD * (w + 1) : 0;
  const int other = 7 - w < R ? 12 * DD * (8 - w) : 0;
  int k = max(0, nu * unit + other - mine + unit) / (2 * unit);
  k = max(nu - kMaxU, min(min(nu, kMaxU), k));
  return warp < 4 ? Units{w, 0, k} : Units{w, k, nu};
}

// acc += XW^T B over the warp's units; XW (the weighted x) as the pair in
// xw. acc[2u], acc[2u + 1]: the two n8 tiles of unit u0 + u.
template <int P>
__device__ void state_mma(float (&acc)[2 * kMaxU][4], const bf16* xw,
                          const bf16* bt, Units us, int lane, int Q16) {
  if (us.u0 >= us.u1) return;
#pragma unroll
  for (int ks = 0; ks < kMaxQ / 16; ++ks) {
    if (16 * ks >= Q16) break;
    uint32_t ah[4], al[4];
    lda_t(ah, xw, kMaxHd, 16 * us.mt, 16 * ks, lane);
    lda_t(al, xw + kTileX, kMaxHd, 16 * us.mt, 16 * ks, lane);
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      if (us.u0 + u < us.u1) {
        const int n0 = 16 * (us.u0 + u);
        uint32_t bh[4];
        ldb_t(bh, bt, kMaxN, n0, 16 * ks, lane);
        mma_bf16(acc[2 * u], ah, bh[0], bh[1]);
        mma_bf16(acc[2 * u + 1], ah, bh[2], bh[3]);
        mma_bf16(acc[2 * u], al, bh[0], bh[1]);
        mma_bf16(acc[2 * u + 1], al, bh[2], bh[3]);
        if (P == 2) {
          uint32_t bl[4];
          ldb_t(bl, bt + kTileN, kMaxN, n0, 16 * ks, lane);
          mma_bf16(acc[2 * u], ah, bl[0], bl[1]);
          mma_bf16(acc[2 * u + 1], ah, bl[2], bl[3]);
        }
      }
    }
  }
}

// Visit the elements (d, n), (d, n + 1) of each n8 tile j of the warp's
// units: f(j, e, d, n) for e = 0 (row d) and e = 2 (row d + 8).
template <typename F>
__device__ __forceinline__ void each_pair(Units us, int lane, F f) {
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    if (us.u0 + u < us.u1) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          f(2 * u + half, e, 16 * us.mt + (lane >> 2) + 8 * (e >> 1),
            16 * (us.u0 + u) + 8 * half + 2 * (lane & 3));
    }
  }
}

using StateRegs = float[2 * kMaxU][4];

// Two fp32 values at p[0], p[1], `valid` of them (8-byte aligned pairs
// when `vec`).
__device__ __forceinline__ void store2(float* p, float a, float b, int valid,
                                       bool vec) {
  if (vec && valid >= 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (valid > 0) p[0] = a;
    if (valid > 1) p[1] = b;
  }
}

// y rows of the warp's 16 rows t (t < Q, d < hd) from the accumulator.
__device__ void write_y(float* y, const float (&acc)[8][4], size_t row0,
                        int H, int h, int hd, int Q, int warp, int lane) {
  const int t0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int t = t0 + 8 * (e >> 1), d = 8 * j + 2 * (lane & 3);
      if (t < Q && d < hd)
        store2(y + ((row0 + t) * H + h) * hd + d, acc[j][e], acc[j][e + 1],
               hd - d, hd % 2 == 0);
    }
}

// C B^T tiles kept in shared memory (bf16 inputs): warp w's 2 (w + 1)
// tiles from tile w (w + 1) on, each as 32 lanes of float4 in fragment
// order; 72 tiles.
constexpr int kGTiles = 72;

// x: (B,S,H,hd) T; bv, cv: (B,S,N) T; la: (B,S,H) fp32;
// y: (B,S,H,hd) fp32; hout: (B,H,hd,N) fp32. Grid (cs, H / g, B), the cs
// blocks of a (batch, head group) one cluster; block r owns chunks
// [r m, min(nc, (r + 1) m)). kMulti: m > 1, each block walks its chunks
// twice (its run's state, then y with the carried state).
template <typename T, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ bv,
                const T* __restrict__ cv, const float* __restrict__ la,
                float* __restrict__ y, float* __restrict__ hout, int S, int H,
                int hd, int N, int Q, int g, int m, int vec_x, int vec_bc) {
  constexpr bool kPair = std::is_same<T, float>::value;
  constexpr int P = kPair ? 2 : 1;
  const int cs = gridDim.x, rank = blockIdx.x;
  const int h0 = blockIdx.y * g, b = blockIdx.z;
  const int c_begin = rank * m, c_end = min(S / Q, c_begin + m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Q16 = (Q + 15) & ~15, N16 = (N + 15) & ~15;
  const int hd16 = (hd + 15) & ~15;
  const bool rows = 16 * warp < Q16;  // the warp has rows t
  const Units us = state_units(warp, Q16, hd16, N16);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ct = reinterpret_cast<bf16*>(smem);  // P tiles
  bf16* bt = ct + P * kTileN;                // P tiles
  bf16* xt = bt + P * kTileN;                // x: P tiles
  bf16* xw = xt + P * kTileX;                // weighted x pair, then the
  bf16* hp = xw;                             // incoming state's pair
  float* st = reinterpret_cast<float*>(xw + 2 * kTileX);
  float* gs = st + (cs > 1 ? kTileS : 0);    // C B^T (bf16 inputs)
  float* cum = gs + (kPair ? 0 : kGTiles * 128);  // g rows (1 when kMulti)
  float* dec = cum + g * kMaxQ;              // the run's decay

  const size_t xpitch = static_cast<size_t>(H) * hd;
  const auto x_at = [&](int c, int h) {
    return x + (static_cast<size_t>(b) * S + c * Q) * xpitch +
           static_cast<size_t>(h) * hd;
  };
  // B (and C) of chunk c, in flight, and cum of head h (warp 0)
  const auto load_chunk = [&](int c, int h, bool with_c) {
    const size_t row0 = static_cast<size_t>(b) * S + c * Q;
    if (with_c) load_bc(ct, cv + row0 * N, Q, N, Q16, N16, vec_bc);
    load_bc(bt, bv + row0 * N, Q, N, Q16, N16, vec_bc);
    cp_async_commit();
    if (warp == 0) chunk_cum(cum, la, row0, H, h, Q, Q16, lane);
  };
  const auto state_out = [&](int h) {
    return hout + (static_cast<size_t>(b) * H + h) * hd * N;
  };
  const auto zero = [](StateRegs& v) {
#pragma unroll
    for (int j = 0; j < 2 * kMaxU; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
  };
  const auto put_state = [&](float* dst, const StateRegs& v) {
    each_pair(us, lane, [&](int j, int e, int d, int n) {
      *reinterpret_cast<float2*>(dst + sidx(d, n)) =
          make_float2(v[j][e], v[j][e + 1]);
    });
  };
  // C B^T of the chunk in the tiles: into registers, and for bf16 inputs
  // on into shared memory
  float G[16][4];
  const auto make_g = [&]() {
    if (!rows) return;
    compute_g<P>(G, ct, bt, warp, lane, N16);
    if (!kPair) {
      float4* gw = reinterpret_cast<float4*>(gs) + warp * (warp + 1) * 32;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < 2 * (warp + 1))
          gw[j * 32 + lane] = make_float4(G[j][0], G[j][1], G[j][2], G[j][3]);
    }
  };
  const auto y_intra = [&](float (&yacc)[8][4], const float* cumh) {
    if constexpr (kPair) {
      intra<P>(yacc, [&](int j) {
        return make_float4(G[j][0], G[j][1], G[j][2], G[j][3]);
      }, cumh, xt, warp, lane, hd16);
    } else {
      const float4* gw = reinterpret_cast<const float4*>(gs) +
                         warp * (warp + 1) * 32 + lane;
      intra<P>(yacc, [&](int j) { return gw[j * 32]; }, cumh, xt, warp, lane,
               hd16);
    }
  };
  // Between the cluster's two barriers of a head: this block's slice of
  // the state tile (1 / cs of its runs of four, rows d < hd16), through
  // every block's published run state S_r and decay d_r (distributed
  // shared memory), in run order: the state entering run r is
  // H_r = d_{r-1} H_{r-1} + S_{r-1}, H_0 = 0. Each H_r (r > 0) goes into
  // block r's shared memory (its bf16 pair into hp, or fp32 in the state
  // layout into the weighted-x tiles when kMulti), and the final state
  // d H_{cs-1} + S_{cs-1} into hout.
  const auto prefix_slice = [&](int h) {
    cg::cluster_group cluster = cg::this_cluster();
    float dr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      dr[r] = r < cs ? *cluster.map_shared_rank(dec, r) : 0.f;
    float* out = state_out(h);
    const int q4 = hd16 * kMaxN / 4;
    for (int q = rank * q4 / cs + static_cast<int>(threadIdx.x);
         q < (rank + 1) * q4 / cs; q += kThreads) {
      const int d = 4 * q / kMaxN, n = 4 * q % kMaxN, at = sidx(d, n);
      float4 sv[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < cs)
          sv[r] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(st, r) + at);
      float4 H = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r >= cs) break;
        if (r > 0) {
          if (kMulti) {
            *reinterpret_cast<float4*>(
                cluster.map_shared_rank(reinterpret_cast<float*>(xw), r) +
                at) = H;
          } else {
            uint2 hi2, lo2;
            split_bf16x2(H.x, H.y, hi2.x, lo2.x);
            split_bf16x2(H.z, H.w, hi2.y, lo2.y);
            bf16* rp = cluster.map_shared_rank(hp, r);
            *reinterpret_cast<uint2*>(rp + swz(d, n, kMaxN)) = hi2;
            *reinterpret_cast<uint2*>(rp + kTileH + swz(d, n, kMaxN)) = lo2;
          }
        }
        H = make_float4(dr[r] * H.x + sv[r].x, dr[r] * H.y + sv[r].y,
                        dr[r] * H.z + sv[r].z, dr[r] * H.w + sv[r].w);
      }
      if (d >= hd || n >= N) continue;
      float* o = out + static_cast<size_t>(d) * N + n;
      if (N % 4 == 0) {
        *reinterpret_cast<float4*>(o) = H;
      } else {
        const float f[4] = {H.x, H.y, H.z, H.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) o[e] = f[e];
      }
    }
  };

  XRegs<T> xr;
  if (!kMulti) {
    // one chunk a block: C B^T and the cumsums once for the g heads
    const size_t row0 = static_cast<size_t>(b) * S + c_begin * Q;
    load_bc(ct, cv + row0 * N, Q, N, Q16, N16, vec_bc);
    load_bc(bt, bv + row0 * N, Q, N, Q16, N16, vec_bc);
    cp_async_commit();
    load_x(xr, x_at(c_begin, h0), xpitch, Q, hd, Q16, hd16, vec_x);
    if (warp < g)
      chunk_cum(cum + warp * kMaxQ, la, row0, H, h0 + warp, Q, Q16, lane);
    cp_async_wait<0>();
    __syncthreads();
    make_g();
  }

  for (int hi = 0; hi < g; ++hi) {
    const int h = h0 + hi;
    float* cumh = cum + (kMulti ? 0 : hi) * kMaxQ;
    StateRegs acc;  // the run's state from zero
    zero(acc);
    float drun = 1.f;  // and its decay
    float yacc[8][4];

    if constexpr (!kMulti) {
      const size_t row0 = static_cast<size_t>(b) * S + c_begin * Q;
      store_x(xw, xr, cumh, Q, Q16, hd16, true);
      store_x(xt, xr, cumh, Q, Q16, hd16, false);
      if (hi + 1 < g)  // the next head's x, in flight meanwhile
        load_x(xr, x_at(c_begin, h + 1), xpitch, Q, hd, Q16, hd16, vec_x);
      __syncthreads();
      state_mma<P>(acc, xw, bt, us, lane, Q16);
      drun = fexp(cumh[Q - 1]);
      if (cs > 1) {
        put_state(st, acc);
        if (threadIdx.x == 0) dec[0] = drun;
        cluster_arrive();  // this block's state and decay are published
      } else {
        // one chunk: the block's state is the final state
        float* out = state_out(h);
        each_pair(us, lane, [&](int j, int e, int d, int n) {
          if (d < hd)
            store2(out + static_cast<size_t>(d) * N + n, acc[j][e],
                   acc[j][e + 1], N - n, N % 2 == 0);
        });
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
      if (rows) y_intra(yacc, cumh);
      if (cs > 1) {
        cluster_wait();  // every block's state is published, and every
                         // block's weighted x consumed
        prefix_slice(h);
        cluster_arrive();
        cluster_wait();  // every block's incoming state pair is written
        if (rank > 0 && rows) {
          float yi[8][4];
          inter<P>(yi, ct, hp, cumh, warp, lane, N16, hd16);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) yacc[j][e] += yi[j][e];
        }
      }
      if (rows) write_y(y, yacc, row0, H, h, hd, Q, warp, lane);
      __syncthreads();  // every read of the tiles is done
    } else {
      // several chunks a block: the run's state from zero, then y chunk
      // by chunk with the carried state
      for (int c = c_begin; c < c_end; ++c) {
        __syncthreads();  // the previous chunk's tiles are consumed
        load_chunk(c, h, false);
        load_x(xr, x_at(c, h), xpitch, Q, hd, Q16, hd16, vec_x);
        cp_async_wait<0>();
        __syncthreads();
        const float dc = fexp(cumh[Q - 1]);
        store_x(xw, xr, cumh, Q, Q16, hd16, true);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2 * kMaxU; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= dc;
        state_mma<P>(acc, xw, bt, us, lane, Q16);
        drun *= dc;
      }
      put_state(st, acc);
      if (threadIdx.x == 0) dec[0] = drun;
      cluster_arrive();
      StateRegs hc;  // the state entering chunk c
      for (int c = c_begin; c < c_end; ++c) {
        const size_t row0 = static_cast<size_t>(b) * S + c * Q;
        const bool first = c == c_begin;
        __syncthreads();
        load_chunk(c, h, true);
        load_x(xr, x_at(c, h), xpitch, Q, hd, Q16, hd16, vec_x);
        cp_async_wait<0>();
        __syncthreads();
        make_g();
        store_x(xt, xr, cumh, Q, Q16, hd16, false);
        if (first) {
          // the incoming state, fp32 in the weighted-x tiles
          cluster_wait();
          prefix_slice(h);
          cluster_arrive();
          cluster_wait();
          const float* hf = reinterpret_cast<const float*>(xw);
          each_pair(us, lane, [&](int j, int e, int d, int n) {
            const float2 v = rank > 0
                ? *reinterpret_cast<const float2*>(hf + sidx(d, n))
                : make_float2(0.f, 0.f);
            hc[j][e] = v.x;
            hc[j][e + 1] = v.y;
          });
        }
        const bool has_state = !first || rank > 0;
        __syncthreads();  // the weighted x is consumed, x is written
        if (has_state)
          each_pair(us, lane, [&](int j, int e, int d, int n) {
            uint32_t hi2, lo2;
            split_bf16x2(hc[j][e], hc[j][e + 1], hi2, lo2);
            *reinterpret_cast<uint32_t*>(hp + swz(d, n, kMaxN)) = hi2;
            *reinterpret_cast<uint32_t*>(hp + kTileH + swz(d, n, kMaxN)) =
                lo2;
          });
        __syncthreads();
        if (rows) {
          if (has_state) {
            inter<P>(yacc, ct, hp, cumh, warp, lane, N16, hd16);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
          }
          y_intra(yacc, cumh);
          write_y(y, yacc, row0, H, h, hd, Q, warp, lane);
        }
        if (c + 1 < c_end) {
          // carry the state into the block's next chunk
          __syncthreads();  // every read of the state pair is done
          store_x(xw, xr, cumh, Q, Q16, hd16, true);
          __syncthreads();
          const float dc = fexp(cumh[Q - 1]);
#pragma unroll
          for (int j = 0; j < 2 * kMaxU; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) hc[j][e] *= dc;
          state_mma<P>(hc, xw, bt, us, lane, Q16);
        }
      }
    }
  }
  // no block touches another's shared memory after a head's second
  // cluster barrier: each may exit
}

// Shared memory of a launch: bf16 tiles, then fp32 states and cumsums.
int smem_bytes(bool pair, int cs, int g) {
  const int P = pair ? 2 : 1;
  const int bf = 2 * P * kTileN + P * kTileX + 2 * kTileX;
  const int gtiles = pair ? 0 : kGTiles * 128;
  return 2 * bf + 4 * ((cs > 1 ? kTileS : 0) + gtiles + g * kMaxQ + 1);
}

// The heads a block: kMaxG (C B^T shared by a pair of heads) where they
// fit in shared memory and divide H, else one.
int heads_a_block(bool pair, int cs, int H) {
  if (H % kMaxG == 0 && smem_bytes(pair, cs, kMaxG) <= kSmemLimit)
    return kMaxG;
  return 1;
}

template <typename T>
int launch(const void* x, const void* bv, const void* cv, const void* la,
           void* y, void* hout, int B, int S, int H, int hd, int N, int Q,
           cudaStream_t stream) {
  constexpr bool kPair = std::is_same<T, float>::value;
  if (Q < 1 || Q > kMaxQ || S < Q || S % Q != 0 || hd < 1 || hd > kMaxHd ||
      N < 1 || N > kMaxN || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = S / Q;
  const int m = (nc + kMaxCluster - 1) / kMaxCluster;  // chunks a block
  const int cs = (nc + m - 1) / m;                     // blocks a cluster
  const int g = heads_a_block(kPair, cs, H);
  const int smem = smem_bytes(kPair, cs, g);
  if (smem > kSmemLimit || H / g > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = hd % 8 == 0 && aligned(x);
  const int vec_bc = N % 8 == 0 && aligned(bv) && aligned(cv);
  auto kernel = m > 1 ? ssm_scan_kernel<T, true> : ssm_scan_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, H / g, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(bv),
                           static_cast<const T*>(cv),
                           static_cast<const float*>(la),
                           static_cast<float*>(y), static_cast<float*>(hout),
                           S, H, hd, N, Q, g, m, vec_x, vec_bc);
  if (err != cudaSuccess) return static_cast<int>(err);
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
    return launch<__nv_bfloat16>(x, bv, cv, la, y, hout, B, S, H, hd, N, Q,
                                 st);
  return launch<float>(x, bv, cv, la, y, hout, B, S, H, hd, N, Q, st);
}
