// Fused 1x1 combiner head, backward (K3), for Hopper (sm_90a).
//
// Replaces the TPU kernel ssdn_tpu/ops/pallas/nin_head.py :: _bwd_call
// (body `_make_bwd_kernel`, called by _head_bwd). With h1 saved by the
// forward (nin_head.cu, save_h1) and g = d out (M, Nc) fp32:
//
//   g_lp  = g rounded to x's type T
//   pre2  = h1 @ Wb + bb (fp32)         h2 = lrelu(pre2) rounded to T
//   dWc   = h2^T g_lp                   dbc = sum_rows g   (the fp32 g)
//   dpre2 = (pre2 >= 0 ? 1 : slope) * (g_lp @ Wc^T), rounded to T
//   dWb   = h1^T dpre2                  dbb = sum_rows dpre2
//   dpre1 = (h1 >= 0 ? 1 : slope) * (dpre2 @ Wb^T), rounded to T
//   dba   = sum_rows dpre1
//   dWa_i = lrelu(x_i)^T dpre1          (lrelu(x_i) rounded to T)
//   dx_i  = (x_i >= 0 ? 1 : slope) * (dpre1 @ Wa_i^T), rounded to T
//
// Every product accumulates in fp32 and every mask compares in fp32, at
// the TPU kernel's rounding points. Weight and bias grads are fp32.
//
// What changes from the TPU: its grid runs in order, and the weight grads
// accumulate in VMEM across it. CUDA blocks run concurrently, and dWa alone
// (4 x 96 x 384 fp32, 590 KB) does not fit one block's shared memory. So
// three kernels, launched back to back on the caller's stream:
//
//  (a) rows: recomputes pre2 and h2 from the h1 tile, forms dpre2 and
//      dpre1, writes dx_i, and writes h2, dpre2 and dpre1 (in T) to a
//      workspace for the weight grads.
//  (b) weight-grad partials: every weight grad is A^T B over the M rows.
//      Each block owns one output tile of one product and one of S fixed
//      row ranges (splits) and writes fp32 partial sums [S][...]. The bias
//      grads are column sums in the same pass (dbc reads the fp32 g, as the
//      TPU kernel sums it). One launch covers all products.
//  (c) reduce_splits: the sum over the S splits, in split order.
//
// No float atomics and a split count fixed by M (the caller's bwd_splits):
// two launches on the same inputs give the same bits, as the TPU kernel
// does.
//
// What bounds it on the H100: 2*(3*Na*Nb + 2*Nb*Nc + 2*k*C*Na) flops per
// row (0.81 MFLOP at the model's k 4, C 96, Na 384, Nb 96, Nc 10; 1.28
// TFLOP per batch-384 step, 1.30 ms at 989 TFLOP/s) against about 2.4 kB
// per row of compulsory traffic (x, dx, h1, g; 1.1 ms): the tensor cores
// bound it. The three launches add the workspace round trip and (b)'s
// re-read of x and h1 (about 9.7 GB per step in all, 2.9 ms).
//
// Two instantiations:
//  - bf16, the flagship's dtype, on the tensor cores (mma.sync m16n8k16,
//    bf16 in, fp32 accumulate; ldmatrix; cp.async). (a) keeps Wb (Na x Nb,
//    72 KB at the model's widths) resident in shared memory for a
//    persistent block's whole life: ldmatrix.trans reads it as the B of
//    pre2 = h1 Wb, plain ldmatrix as the B of dh1 = dpre2 Wb^T, so no
//    transposed copy is made. Wa_i, stored (C, Na), is already the
//    column-major B of dx_i = dpre1 Wa_i^T; it streams through a 4-stage
//    cp.async ring of 32-column chunks, branch after branch, three chunks
//    in flight and the first three loaded while pre2 and dh1 run. dpre1
//    overwrites h1's tile element by element once its mask is read. The
//    masks and roundings run on the mma fragments in registers; dpre2,
//    dpre1 and each dx_i leave from their shared tiles in 16-byte rows;
//    (a) also writes g rounded to bf16 for (b).
//    (b) streams 32-row stages of A and B through a 4-stage cp.async ring,
//    reads A transposed with ldmatrix.trans (lrelu and the bf16 rounding
//    of x applied on its fragments), and computes 96 x 128 output tiles
//    (dWb as dWb^T, Nb x Na, so that its tiles fit). dba and dbb are
//    products with a fragment of ones on the same tensor cores; dbc, the
//    fp32 g's column sums, has a block of its own per split.
//    Widths that are not multiples of 16, and ragged rows, are zero in
//    shared memory and masked on store.
//  - fp32, the parity path, on the FMA pipes (TF32 would break the port's
//    fp32 bars): (a) one block per 32 rows, reading transposed copies of
//    Wa_i and Wb (made by the caller) along its warps; (b) 64 x 64 tiles,
//    4 x 4 outputs per thread, the bias grads as a row of ones appended
//    to A.
//
// Left for later: wgmma and TMA, fusing (b) into (a) and dropping the
// workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_bf16.cuh"

using namespace ssdn_tc;

namespace {

constexpr int TM = 32;        // rows per block in (a)
constexpr int LD = TM + 4;    // shared tile stride: keeps float4 alignment
constexpr int THREADS = 256;
constexpr int QA = 2;         // layer-a columns per thread: Na <= QA*THREADS
constexpr int MAX_BRANCHES = 4;

constexpr int WT = 64;        // (b): output tile WT x WT
constexpr int WR = 32;        // (b): rows staged per step
constexpr int MAX_JOBS = MAX_BRANCHES + 3;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// Round an fp32 value to T and back (identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// ------------------------------ (a) rows ------------------------------

struct RowArgs {
  const void* x[MAX_BRANCHES];
  const void* wat[MAX_BRANCHES];  // Wa_i^T, (Na, C)
  const void* h1;
  const void* wb;
  const void* wbt;  // Wb^T, (Nb, Na)
  const float* bb;
  const void* wc;
  const float* g;
  void* dx[MAX_BRANCHES];
  void* h2ws;     // (M, Nb) T
  void* dpre2ws;  // (M, Nb) T
  void* dpre1ws;  // (M, Na) T
  int k, M, C, Na, Nb, Nc;
  float slope;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_rows_kernel(RowArgs a) {
  // column-major tiles ([column][row], stride LD): h1s [Na], gs [Nc] (g
  // rounded to T), d2s [Nb] (dpre2), d1s [Na] (dpre1)
  extern __shared__ float4 smem4[];
  float* h1s = reinterpret_cast<float*>(smem4);
  float* gs = h1s + LD * a.Na;
  float* d2s = gs + LD * a.Nc;
  float* d1s = d2s + LD * a.Nb;

  const long long r0 = (long long)blockIdx.x * TM;
  const int rows = (int)min((long long)TM, (long long)a.M - r0);
  const int tid = threadIdx.x;
  const T* h1 = static_cast<const T*>(a.h1);

  // consecutive threads read consecutive columns of one row
  for (int e = tid; e < TM * a.Na; e += THREADS) {
    const int r = e / a.Na;
    const int c = e - r * a.Na;
    h1s[c * LD + r] = r < rows ? to_f32(h1[(r0 + r) * a.Na + c]) : 0.f;
  }
  for (int e = tid; e < TM * a.Nc; e += THREADS) {
    const int r = e / a.Nc;
    const int c = e - r * a.Nc;
    gs[c * LD + r] = r < rows ? round_to<T>(a.g[(r0 + r) * a.Nc + c]) : 0.f;
  }
  __syncthreads();

  // pre2 / h2 (recomputed) and dpre2: one work item = 8 rows x 1 column
  const T* wb = static_cast<const T*>(a.wb);
  const T* wc = static_cast<const T*>(a.wc);
  T* h2ws = static_cast<T*>(a.h2ws);
  T* dpre2ws = static_cast<T*>(a.dpre2ws);
  for (int e = tid; e < (TM / 8) * a.Nb; e += THREADS) {
    const int rg = e / a.Nb;
    const int j = e - rg * a.Nb;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int c = 0; c < a.Na; ++c) {
      const float wv = to_f32(wb[c * a.Nb + j]);
      const float4* hc = reinterpret_cast<const float4*>(h1s + c * LD + rg * 8);
      const float4 u = hc[0], v = hc[1];
      s[0] = fmaf(u.x, wv, s[0]);
      s[1] = fmaf(u.y, wv, s[1]);
      s[2] = fmaf(u.z, wv, s[2]);
      s[3] = fmaf(u.w, wv, s[3]);
      s[4] = fmaf(v.x, wv, s[4]);
      s[5] = fmaf(v.y, wv, s[5]);
      s[6] = fmaf(v.z, wv, s[6]);
      s[7] = fmaf(v.w, wv, s[7]);
    }
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = 0.f;
    for (int n = 0; n < a.Nc; ++n) {
      const float wv = to_f32(wc[j * a.Nc + n]);
      const float4* gc = reinterpret_cast<const float4*>(gs + n * LD + rg * 8);
      const float4 u = gc[0], v = gc[1];
      d[0] = fmaf(u.x, wv, d[0]);
      d[1] = fmaf(u.y, wv, d[1]);
      d[2] = fmaf(u.z, wv, d[2]);
      d[3] = fmaf(u.w, wv, d[3]);
      d[4] = fmaf(v.x, wv, d[4]);
      d[5] = fmaf(v.y, wv, d[5]);
      d[6] = fmaf(v.z, wv, d[6]);
      d[7] = fmaf(v.w, wv, d[7]);
    }
    const float bj = a.bb[j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg * 8 + i;
      const float pre2 = s[i] + bj;
      const float dp2 = round_to<T>(pre2 >= 0.f ? d[i] : a.slope * d[i]);
      d2s[j * LD + r] = dp2;
      if (r < rows) {
        h2ws[(r0 + r) * a.Nb + j] = from_f32<T>(lrelu(pre2, a.slope));
        dpre2ws[(r0 + r) * a.Nb + j] = from_f32<T>(dp2);
      }
    }
  }
  __syncthreads();

  // dpre1: thread owns columns tid + q*THREADS for all TM rows
  const T* wbt = static_cast<const T*>(a.wbt);
  T* dpre1ws = static_cast<T*>(a.dpre1ws);
  float acc[QA][TM];
#pragma unroll
  for (int q = 0; q < QA; ++q)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[q][r] = 0.f;
  for (int j = 0; j < a.Nb; ++j) {
    const float4* dc = reinterpret_cast<const float4*>(d2s + j * LD);
#pragma unroll
    for (int q = 0; q < QA; ++q) {
      const int c = tid + q * THREADS;
      const float wv = c < a.Na ? to_f32(wbt[(long long)j * a.Na + c]) : 0.f;
#pragma unroll
      for (int r4 = 0; r4 < TM / 4; ++r4) {
        const float4 v = dc[r4];
        acc[q][4 * r4 + 0] = fmaf(v.x, wv, acc[q][4 * r4 + 0]);
        acc[q][4 * r4 + 1] = fmaf(v.y, wv, acc[q][4 * r4 + 1]);
        acc[q][4 * r4 + 2] = fmaf(v.z, wv, acc[q][4 * r4 + 2]);
        acc[q][4 * r4 + 3] = fmaf(v.w, wv, acc[q][4 * r4 + 3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    const int c = tid + q * THREADS;
    if (c < a.Na) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float d = acc[q][r];
        const float dp1 = round_to<T>(h1s[c * LD + r] >= 0.f ? d : a.slope * d);
        d1s[c * LD + r] = dp1;
        if (r < rows) dpre1ws[(r0 + r) * a.Na + c] = from_f32<T>(dp1);
      }
    }
  }
  __syncthreads();

  // dx_i: one work item = 8 rows x 1 input channel
  for (int br = 0; br < a.k; ++br) {
    const T* x = static_cast<const T*>(a.x[br]);
    const T* wat = static_cast<const T*>(a.wat[br]);
    T* dx = static_cast<T*>(a.dx[br]);
    for (int e = tid; e < (TM / 8) * a.C; e += THREADS) {
      const int rg = e / a.C;
      const int c = e - rg * a.C;
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      for (int n = 0; n < a.Na; ++n) {
        const float wv = to_f32(wat[(long long)n * a.C + c]);
        const float4* dc = reinterpret_cast<const float4*>(d1s + n * LD + rg * 8);
        const float4 u = dc[0], v = dc[1];
        s[0] = fmaf(u.x, wv, s[0]);
        s[1] = fmaf(u.y, wv, s[1]);
        s[2] = fmaf(u.z, wv, s[2]);
        s[3] = fmaf(u.w, wv, s[3]);
        s[4] = fmaf(v.x, wv, s[4]);
        s[5] = fmaf(v.y, wv, s[5]);
        s[6] = fmaf(v.z, wv, s[6]);
        s[7] = fmaf(v.w, wv, s[7]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg * 8 + i;
        if (r < rows) {
          const long long off = (r0 + r) * a.C + c;
          const float xv = to_f32(x[off]);
          dx[off] = from_f32<T>(xv >= 0.f ? s[i] : a.slope * s[i]);
        }
      }
    }
  }
}

// ------------------------- (b) weight-grad partials -------------------------

// One product out[p, q] = sum_m A[m, p] * B[m, q] over the M rows, A (M, P)
// and B (M, Q) row-major; with `ones`, row P of the output is sum_m B[m, q]
// (the bias grad).
struct Job {
  const void* a;
  const void* b;
  int P, Q;
  int ones;      // append a row of ones to A
  int a_lrelu;   // A is lrelu(x) rounded to T (the branch inputs)
  int b_f32;     // B is fp32 (g) ...
  int b_round;   // ... rounded to T (g_lp) or not (the fp32 g for dbc)
  long long out;  // offset of this product in the flat output
  int tiles_q;    // tiles along Q
  int tile0;      // first linear tile of this job
};

struct GradArgs {
  Job job[MAX_JOBS];
  int n_jobs;
  int M, S;
  long long chunk;  // rows per split
  long long total;  // elements of the flat output
  float* partial;   // [S][total]
  float slope;
};

template <typename T>
__device__ __forceinline__ float load_a(const Job& j, long long m, int p,
                                        float slope) {
  if (p == j.P) return 1.f;  // the row of ones
  const float v = to_f32(static_cast<const T*>(j.a)[m * j.P + p]);
  return j.a_lrelu ? round_to<T>(lrelu(v, slope)) : v;
}

template <typename T>
__device__ __forceinline__ float load_b(const Job& j, long long m, int q) {
  if (j.b_f32) {
    const float v = static_cast<const float*>(j.b)[m * j.Q + q];
    return j.b_round ? round_to<T>(v) : v;
  }
  return to_f32(static_cast<const T*>(j.b)[m * j.Q + q]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wgrad_partial_kernel(GradArgs g) {
  __shared__ float as[WR][WT];
  __shared__ float bs[WR][WT];
  int ji = 0;
  while (ji + 1 < g.n_jobs && (int)blockIdx.x >= g.job[ji + 1].tile0) ++ji;
  const Job& j = g.job[ji];
  const int t = blockIdx.x - j.tile0;
  const int p0 = (t / j.tiles_q) * WT;
  const int q0 = (t % j.tiles_q) * WT;
  const int split = blockIdx.y;
  const long long m_begin = split * g.chunk;
  const long long m_end = min((long long)g.M, m_begin + g.chunk);
  const int prow = j.P + j.ones;  // output rows of this product

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4 x 4 outputs per thread
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (long long mb = m_begin; mb < m_end; mb += WR) {
    // coalesced along the columns
    for (int e = tid; e < WR * WT; e += THREADS) {
      const int rr = e / WT;
      const int cc = e - rr * WT;
      const long long m = mb + rr;
      const bool in_m = m < m_end;
      as[rr][cc] = (in_m && p0 + cc < prow)
                       ? load_a<T>(j, m, p0 + cc, g.slope) : 0.f;
      bs[rr][cc] = (in_m && q0 + cc < j.Q) ? load_b<T>(j, m, q0 + cc) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < WR; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[rr][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = bs[rr][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
  float* out = g.partial + split * g.total + j.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= prow) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int q = q0 + tx + 16 * jj;
      if (q < j.Q) out[(long long)p * j.Q + q] = acc[i][jj];
    }
  }
}

// ------------------------------ (c) reduce ------------------------------

__global__ void __launch_bounds__(THREADS)
reduce_splits_kernel(const float* partial, float* out, long long total,
                     int S) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int i = 0; i < S; ++i) s += partial[i * total + e];
  out[e] = s;
}

// ------------------ bf16 on the tensor cores: constants ------------------

constexpr int SKEW = 8;          // bf16 added to every shared row: ldmatrix's
                                 // 8 row addresses fall in 8 distinct banks
constexpr int TC_ROWS = 64;      // (a) rows per tile
constexpr int TC_THREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int WA_CHUNK = 32;     // (a) Wa_i columns per ring stage
constexpr int WA_STAGES = 4;     // (a) ring stages, three loads in flight
constexpr int MAX_NT = 8;        // n-tiles (8 columns) per warp and pass
constexpr int NT1 = 4;           // the same for pre2 and dh2, held together
constexpr int TILE_P = 96, TILE_Q = 128;  // (b) output tile
constexpr int STAGE_ROWS = 32;   // (b) rows per ring stage
constexpr int WG_STAGES = 4;     // (b) ring stages, three loads in flight
constexpr int SMEM_LIMIT = 232448;

// A warp's pass over nt n-tiles: `chunks` passes of `per` tiles, the 4
// column groups interleaved, so that each warp gets about nt/4 tiles and
// holds at most MAXT at once.
template <int MAXT>
__device__ __forceinline__ int warp_per(int nt, int& chunks) {
  chunks = (nt + 4 * MAXT - 1) / (4 * MAXT);
  return (nt + 4 * chunks - 1) / (4 * chunks);
}

// (a)'s shared memory, in bf16 elements: offsets and row strides.
struct TcSmem {
  int wb, h, u, g, wc, ring;
  int ldwb, ldh, ldu, ldg, ldwc, ldring;
  int total;
};

__host__ __device__ inline TcSmem tc_smem(int Cp, int Nap, int Nbp, int Ncp) {
  TcSmem s;
  s.ldwb = Nbp + SKEW;       // Wb (Na x Nb), resident
  s.ldh = Nap + SKEW;        // h1 tile, then dpre1
  s.ldu = (Nbp > Cp ? Nbp : Cp) + SKEW;  // dpre2 tile, then each dx_i
  s.ldg = Ncp + SKEW;        // g tile, rounded to bf16
  s.ldwc = Ncp + SKEW;       // Wc (Nb x Nc), resident
  s.ldring = WA_CHUNK + SKEW;  // WA_STAGES stages of Wa_i (C x WA_CHUNK)
  s.wb = 0;
  s.h = s.wb + Nap * s.ldwb;
  s.u = s.h + TC_ROWS * s.ldh;
  s.g = s.u + TC_ROWS * s.ldu;
  s.wc = s.g + TC_ROWS * s.ldg;
  s.ring = s.wc + Nbp * s.ldwc;
  s.total = s.ring + WA_STAGES * Cp * s.ldring;
  return s;
}

// ------------------------- bf16 (a): rows on tensor cores -------------------------

struct TcRowArgs {
  const bf16* x[MAX_BRANCHES];
  const bf16* wa[MAX_BRANCHES];  // Wa_i as stored, (C, Na)
  const bf16* h1;
  const bf16* wb;
  const float* bb;
  const bf16* wc;
  const float* g;
  bf16* dx[MAX_BRANCHES];
  bf16* h2ws;     // (M, Nb)
  bf16* dpre2ws;  // (M, Nb)
  bf16* dpre1ws;  // (M, Na)
  bf16* gws;      // (M, Ncp): g rounded to bf16, zero past Nc
  int k, M, C, Na, Nb, Nc;  // C, Na, Nb multiples of 8
  int Cp, Nap, Nbp, Ncp;    // padded to 16
  float slope;
};

// Persistent: each block walks the 64-row tiles blockIdx.x, + gridDim.x, ...
// Warp w owns rows 32 (w & 1) .. +32 (two m16 tiles) and column group w >> 1.
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_rows_tc_kernel(TcRowArgs a) {
  extern __shared__ uint4 smem_tc[];
  bf16* sm = reinterpret_cast<bf16*>(smem_tc);
  const TcSmem L = tc_smem(a.Cp, a.Nap, a.Nbp, a.Ncp);
  bf16* sWb = sm + L.wb;
  bf16* sH = sm + L.h;
  bf16* sU = sm + L.u;
  bf16* sG = sm + L.g;
  bf16* sWc = sm + L.wc;
  bf16* sRing = sm + L.ring;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = (warp & 1) * 32, cg = warp >> 1;
  const int lr = lane >> 2, lc = 2 * (lane & 3);  // fragment row / column

  // every pad stays zero: rows and columns past the widths feed zeros to
  // the products
  for (int e = tid; e < L.total / 8; e += TC_THREADS)
    smem_tc[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int nb8 = a.Nb / 8, na8 = a.Na / 8;
  for (int e = tid; e < a.Na * nb8; e += TC_THREADS) {
    const int r = e / nb8, c8 = e - r * nb8;
    cp_async16(sWb + r * L.ldwb + c8 * 8, a.wb + (size_t)r * a.Nb + c8 * 8);
  }
  cp_async_commit();
  for (int e = tid; e < a.Nb * a.Nc; e += TC_THREADS) {
    const int r = e / a.Nc;
    sWc[r * L.ldwc + (e - r * a.Nc)] = a.wc[e];
  }

  const int kchunks = (a.Nap + WA_CHUNK - 1) / WA_CHUNK;
  const int steps = a.k * kchunks;
  // ring stage `stage` <- columns of Wa_i for step s (branch s / kchunks)
  auto load_wa = [&](int s, int stage) {
    const int br = s / kchunks;
    const int k0 = (s - br * kchunks) * WA_CHUNK;
    bf16* st = sRing + stage * a.Cp * L.ldring;
    const bf16* wa = a.wa[br];
    for (int e = tid; e < a.Cp * (WA_CHUNK / 8); e += TC_THREADS) {
      const int r = e / (WA_CHUNK / 8), c = k0 + (e % (WA_CHUNK / 8)) * 8;
      bf16* dst = st + r * L.ldring + (c - k0);
      if (r < a.C && c < a.Na) cp_async16(dst, wa + (size_t)r * a.Na + c);
      else zero16(dst);
    }
  };

  const int n_tiles = (a.M + TC_ROWS - 1) / TC_ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * TC_ROWS;
    const int rows = (int)min((long long)TC_ROWS, (long long)a.M - r0);
    for (int e = tid; e < TC_ROWS * na8; e += TC_THREADS) {
      const int r = e / na8, c8 = e - r * na8;
      bf16* dst = sH + r * L.ldh + c8 * 8;
      if (r < rows) cp_async16(dst, a.h1 + (r0 + r) * a.Na + c8 * 8);
      else zero16(dst);
    }
    cp_async_commit();
    for (int e = tid; e < TC_ROWS * a.Ncp; e += TC_THREADS) {
      const int r = e / a.Ncp, c = e - r * a.Ncp;
      sG[r * L.ldg + c] = __float2bfloat16_rn(
          r < rows && c < a.Nc ? a.g[(r0 + r) * a.Nc + c] : 0.f);
    }
    // the first WA_STAGES - 1 chunks of Wa_0 land during pre2 and dh1
    for (int s = 0; s < WA_STAGES - 1; ++s) {
      if (s < steps) load_wa(s, s);
      cp_async_commit();
    }
    cp_async_wait<WA_STAGES - 1>();  // Wb (first tile) and h1 have landed
    __syncthreads();
    store_rows(a.gws, a.Ncp, sG, L.ldg, rows, r0);  // g_lp, for (b)'s dWc

    // ---- pre2 = h1 Wb + bb, dh2 = g_lp Wc^T; h2, dpre2 ----
    {
      int chunks;
      const int nt = a.Nbp / 8, per = warp_per<NT1>(nt, chunks);
      for (int ch = 0; ch < chunks; ++ch) {
        const int t0 = (ch * 4 + cg) * per;
        if (t0 >= nt) break;
        float acc[2][NT1][4] = {}, dh[2][NT1][4] = {};
        for (int k0 = 0; k0 < a.Nap; k0 += 16) {
          unsigned af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(af[mt], sH + (wr0 + mt * 16 + (lane & 15)) * L.ldh + k0 +
                                (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            if (j < per && t0 + j < nt) {
              unsigned b[2];  // Wb rows k0.., columns of n-tile t0 + j
              ldsm_x2_t(b, sWb + (k0 + (lane & 15)) * L.ldwb + (t0 + j) * 8);
              mma_bf16(acc[0][j], af[0], b[0], b[1]);
              mma_bf16(acc[1][j], af[1], b[0], b[1]);
            }
          }
        }
        for (int k0 = 0; k0 < a.Ncp; k0 += 16) {
          unsigned af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(af[mt], sG + (wr0 + mt * 16 + (lane & 15)) * L.ldg + k0 +
                                (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            if (j < per && t0 + j < nt) {
              unsigned b[2];  // Wc rows of n-tile t0 + j, columns k0..
              ldsm_x2(b, sWc + ((t0 + j) * 8 + (lane & 7)) * L.ldwc + k0 +
                             ((lane >> 3) & 1) * 8);
              mma_bf16(dh[0][j], af[0], b[0], b[1]);
              mma_bf16(dh[1][j], af[1], b[0], b[1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          if (!(j < per && t0 + j < nt)) continue;
          const int c = (t0 + j) * 8 + lc;
          const float b0 = c < a.Nb ? a.bb[c] : 0.f;
          const float b1 = c < a.Nb ? a.bb[c + 1] : 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wr0 + mt * 16 + lr + 8 * h;
              const float p0 = acc[mt][j][2 * h] + b0;
              const float p1 = acc[mt][j][2 * h + 1] + b1;
              const float d0 = dh[mt][j][2 * h], d1 = dh[mt][j][2 * h + 1];
              const unsigned dp = pack_bf16(p0 >= 0.f ? d0 : a.slope * d0,
                                            p1 >= 0.f ? d1 : a.slope * d1);
              *reinterpret_cast<unsigned*>(sU + r * L.ldu + c) = dp;
              if (r < rows && c < a.Nb)
                *reinterpret_cast<unsigned*>(
                    a.h2ws + (size_t)(r0 + r) * a.Nb + c) =
                    pack_bf16(lrelu(p0, a.slope), lrelu(p1, a.slope));
            }
          }
        }
      }
    }
    __syncthreads();
    store_rows(a.dpre2ws, a.Nb, sU, L.ldu, rows, r0);

    // ---- dh1 = dpre2 Wb^T; dpre1 over h1's tile ----
    {
      int chunks;
      const int nt = a.Nap / 8, per = warp_per<MAX_NT>(nt, chunks);
      for (int ch = 0; ch < chunks; ++ch) {
        const int t0 = (ch * 4 + cg) * per;
        if (t0 >= nt) break;
        float acc[2][MAX_NT][4] = {};
        for (int k0 = 0; k0 < a.Nbp; k0 += 16) {
          unsigned af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(af[mt], sU + (wr0 + mt * 16 + (lane & 15)) * L.ldu + k0 +
                                (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < MAX_NT; ++j) {
            if (j < per && t0 + j < nt) {
              unsigned b[2];  // Wb rows of n-tile t0 + j, columns k0..
              ldsm_x2(b, sWb + ((t0 + j) * 8 + (lane & 7)) * L.ldwb + k0 +
                             ((lane >> 3) & 1) * 8);
              mma_bf16(acc[0][j], af[0], b[0], b[1]);
              mma_bf16(acc[1][j], af[1], b[0], b[1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < MAX_NT; ++j) {
          if (!(j < per && t0 + j < nt)) continue;
          const int c = (t0 + j) * 8 + lc;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wr0 + mt * 16 + lr + 8 * h;
              unsigned* hp = reinterpret_cast<unsigned*>(sH + r * L.ldh + c);
              const float2 hv = unpack_bf16(*hp);
              const float d0 = acc[mt][j][2 * h], d1 = acc[mt][j][2 * h + 1];
              const unsigned dp = pack_bf16(hv.x >= 0.f ? d0 : a.slope * d0,
                                            hv.y >= 0.f ? d1 : a.slope * d1);
              *hp = dp;  // this warp alone reads or writes these elements
            }
          }
        }
      }
    }
    __syncthreads();
    store_rows(a.dpre1ws, a.Na, sH, L.ldh, rows, r0);

    // ---- dx_i = mask(x_i) * (dpre1 Wa_i^T), Wa_i streamed ----
    {
      int chunks;
      const int nt = a.Cp / 8, per = warp_per<MAX_NT>(nt, chunks);  // chunks == 1
      const int t0 = cg * per;
      float acc[2][MAX_NT][4];
      unsigned xv[2][MAX_NT][2];  // x_i at the fragment's places
      for (int s = 0; s < steps; ++s) {
        const int br = s / kchunks, kc = s - br * kchunks;
        if (kc == 0) {
#pragma unroll
          for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                acc[mt][j][2 * h] = acc[mt][j][2 * h + 1] = 0.f;
                const int r = wr0 + mt * 16 + lr + 8 * h;
                const int c = (t0 + j) * 8 + lc;
                xv[mt][j][h] =
                    (j < per && c < a.C && r < rows)
                        ? *reinterpret_cast<const unsigned*>(
                              a.x[br] + (size_t)(r0 + r) * a.C + c)
                        : 0u;
              }
        }
        cp_async_wait<WA_STAGES - 2>();  // step s's chunk has landed
        __syncthreads();
        // the stage read at step s - 1 takes step s + WA_STAGES - 1
        if (s + WA_STAGES - 1 < steps)
          load_wa(s + WA_STAGES - 1, (s + WA_STAGES - 1) % WA_STAGES);
        cp_async_commit();
        const bf16* st = sRing + (s % WA_STAGES) * a.Cp * L.ldring;
        const int k0 = kc * WA_CHUNK;
        const int kend = min(WA_CHUNK, a.Nap - k0);
        for (int kk = 0; kk < kend; kk += 16) {
          unsigned af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(af[mt], sH + (wr0 + mt * 16 + (lane & 15)) * L.ldh + k0 +
                                kk + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < MAX_NT; ++j) {
            if (j < per && t0 + j < nt) {
              unsigned b[2];  // Wa_i rows of n-tile t0 + j, columns kk..
              ldsm_x2(b, st + ((t0 + j) * 8 + (lane & 7)) * L.ldring + kk +
                             ((lane >> 3) & 1) * 8);
              mma_bf16(acc[0][j], af[0], b[0], b[1]);
              mma_bf16(acc[1][j], af[1], b[0], b[1]);
            }
          }
        }
        if (kc == kchunks - 1) {
#pragma unroll
          for (int j = 0; j < MAX_NT; ++j) {
            const int c = (t0 + j) * 8 + lc;
            if (!(j < per && c < a.C)) continue;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = wr0 + mt * 16 + lr + 8 * h;
                const float2 x = unpack_bf16(xv[mt][j][h]);
                const float d0 = acc[mt][j][2 * h], d1 = acc[mt][j][2 * h + 1];
                *reinterpret_cast<unsigned*>(sU + r * L.ldu + c) =
                    pack_bf16(x.x >= 0.f ? d0 : a.slope * d0,
                              x.y >= 0.f ? d1 : a.slope * d1);
              }
          }
          __syncthreads();  // dx_i's tile is whole in sU
          store_rows(a.dx[br], a.C, sU, L.ldu, rows, r0);
        }
      }
      __syncthreads();  // the ring and h1's tile are refilled next tile
    }
  }
}

// -------------------- bf16 (b): weight-grad partials on tensor cores --------------------

// One product out[p, q] = sum_m A[m, p] B[m, q] over the M rows, A and B
// bf16 with row strides lda, ldb (multiples of 8); p < P and q < Q are
// stored. Or (colsum_f32) the column sums of the fp32 B (g, for dbc).
enum { BIAS_NONE = 0, BIAS_OF_B = 1, BIAS_OF_A = 2 };

struct TcJob {
  const bf16* a;
  const void* b;
  int lda, ldb, P, Q;
  int a_lrelu;     // A is lrelu(x), rounded to bf16 (the branch inputs)
  int bias;        // column sums to bias_out: of B (blocks of p-tile 0) or
                   // of A (blocks of q-tile 0)
  int transpose;   // store out[q, p] (dWb computed as dWb^T)
  int colsum_f32;  // no product: bias_out <- column sums of the fp32 B
  long long out, bias_out;  // offsets in the flat output
  int tiles_q, tile0;
};

struct TcGradArgs {
  TcJob job[MAX_JOBS];
  int n_jobs;
  int M;
  long long chunk;  // rows per split (blockIdx.y)
  long long total;  // elements of the flat output
  float* partial;   // [S][total]
  float slope;
};

constexpr int WG_LDA = TILE_P + SKEW, WG_LDB = TILE_Q + SKEW;
constexpr int WG_STAGE = STAGE_ROWS * (WG_LDA + WG_LDB);  // bf16 per stage
constexpr unsigned BF16_ONES = 0x3F803F80u;  // two bf16 1.0

// The column sums of the fp32 B over this split's rows: 16 row lanes x 16
// columns, the lanes' sums added in lane order.
__device__ void colsum_f32(const TcJob& j, long long m_begin, long long m_end,
                           float* out) {
  __shared__ float red[16][16];
  const int tid = threadIdx.x, rl = tid >> 4, cq = tid & 15;
  const float* b = static_cast<const float*>(j.b);
  for (int q0 = 0; q0 < j.Q; q0 += 16) {
    const int q = q0 + cq;
    float s = 0.f;
    if (q < j.Q) {
#pragma unroll 8
      for (long long m = m_begin + rl; m < m_end; m += 16) s += b[m * j.Q + q];
    }
    red[rl][cq] = s;
    __syncthreads();
    if (tid < 16 && q0 + tid < j.Q) {
      float t = 0.f;
      for (int r = 0; r < 16; ++r) t += red[r][tid];
      out[j.bias_out + q0 + tid] = t;
    }
    __syncthreads();
  }
}

// 8 warps: warp w computes rows 48 (w & 1) .. +48 (three m16 tiles) and
// columns 32 (w >> 1) .. +32 (four n8 tiles) of the 96 x 128 tile, from a
// WG_STAGES-deep cp.async ring of 32-row stages.
__global__ void __launch_bounds__(TC_THREADS, 2)
wgrad_tc_kernel(TcGradArgs g) {
  extern __shared__ uint4 smem_wg[];
  bf16* ring = reinterpret_cast<bf16*>(smem_wg);
  int ji = 0;
  while (ji + 1 < g.n_jobs && (int)blockIdx.x >= g.job[ji + 1].tile0) ++ji;
  const TcJob& j = g.job[ji];
  const long long m_begin = (long long)blockIdx.y * g.chunk;
  const long long m_end = min((long long)g.M, m_begin + g.chunk);
  float* out = g.partial + blockIdx.y * g.total;
  if (j.colsum_f32) {
    colsum_f32(j, m_begin, m_end, out);
    return;
  }
  const int t = blockIdx.x - j.tile0;
  const int pt = t / j.tiles_q, qt = t % j.tiles_q;
  const int p0 = pt * TILE_P, q0 = qt * TILE_Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = (warp & 1) * 48, wq = (warp >> 1) * 32;
  const bf16* bsrc = static_cast<const bf16*>(j.b);

  // rows mb.. of the A and B tiles into stage st (zero past m_end and
  // past the operands' widths)
  auto load = [&](long long mb, int st) {
    bf16* sa = ring + st * WG_STAGE;
    bf16* sb = sa + STAGE_ROWS * WG_LDA;
    for (int e = tid; e < STAGE_ROWS * (TILE_P / 8); e += TC_THREADS) {
      const int r = e / (TILE_P / 8), p = (e % (TILE_P / 8)) * 8;
      bf16* dst = sa + r * WG_LDA + p;
      if (mb + r < m_end && p0 + p < j.lda)
        cp_async16(dst, j.a + (mb + r) * j.lda + p0 + p);
      else
        zero16(dst);
    }
    for (int e = tid; e < STAGE_ROWS * (TILE_Q / 8); e += TC_THREADS) {
      const int r = e / (TILE_Q / 8), q = (e % (TILE_Q / 8)) * 8;
      bf16* dst = sb + r * WG_LDB + q;
      if (mb + r < m_end && q0 + q < j.ldb)
        cp_async16(dst, bsrc + (mb + r) * j.ldb + q0 + q);
      else
        zero16(dst);
    }
  };

  // column sums ride on the tensor cores: ones^T B (warps of the first p
  // half) or A^T ones (warps of the first q quarter)
  const bool bias_b = j.bias == BIAS_OF_B && pt == 0 && wp == 0;
  const bool bias_a = j.bias == BIAS_OF_A && qt == 0 && wq == 0;
  const unsigned ones[4] = {BF16_ONES, BF16_ONES, BF16_ONES, BF16_ONES};
  float acc[3][4][4] = {}, bacc[4][4] = {};
  const int n_st = (int)((m_end - m_begin + STAGE_ROWS - 1) / STAGE_ROWS);
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < n_st) load(m_begin + (long long)s * STAGE_ROWS, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_st; ++it) {
    cp_async_wait<WG_STAGES - 2>();  // stage it has landed
    __syncthreads();
    // the stage read at it - 1 takes stage it + WG_STAGES - 1
    const int nx = it + WG_STAGES - 1;
    if (nx < n_st) load(m_begin + (long long)nx * STAGE_ROWS, nx % WG_STAGES);
    cp_async_commit();
    const bf16* sa = ring + (it % WG_STAGES) * WG_STAGE;
    const bf16* sb = sa + STAGE_ROWS * WG_LDA;
#pragma unroll
    for (int kk = 0; kk < STAGE_ROWS; kk += 16) {
      unsigned af[3][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
        if (p0 + wp + mt * 16 >= j.P) continue;
        ldsm_x4_t(af[mt], sa + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * WG_LDA +
                              wp + mt * 16 + ((lane >> 3) & 1) * 8);
        if (j.a_lrelu) {
          const float sl = g.slope;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = unpack_bf16(af[mt][i]);
            af[mt][i] = pack_bf16(lrelu(f.x, sl), lrelu(f.y, sl));
          }
        }
        if (bias_a) mma_bf16(bacc[mt], af[mt], ones[0], ones[1]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np)
        if (q0 + wq + np * 16 < j.Q)
          ldsm_x4_t(bf[np], sb + (kk + (lane & 15)) * WG_LDB + wq + np * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (q0 + wq + nt * 8 >= j.Q) continue;
        const unsigned* b = bf[nt >> 1] + 2 * (nt & 1);
        if (bias_b) mma_bf16(bacc[nt], ones, b[0], b[1]);
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
          if (p0 + wp + mt * 16 < j.P) mma_bf16(acc[mt][nt], af[mt], b[0], b[1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 3; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + wp + mt * 16 + (lane >> 2) + 8 * (i >> 1);
        const int q = q0 + wq + nt * 8 + 2 * (lane & 3) + (i & 1);
        if (p < j.P && q < j.Q)
          out[j.out + (j.transpose ? (long long)q * j.P + p
                                   : (long long)p * j.Q + q)] = acc[mt][nt][i];
      }
  // every row of ones^T B holds the column sums: row 0 (lanes 0-3); every
  // column of A^T ones holds them: column 0 (lanes 4r)
  if (bias_b && lane < 4) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + wq + nt * 8 + 2 * lane + e;
        if (q < j.Q) out[j.bias_out + q] = bacc[nt][e];
      }
  }
  if (bias_a && (lane & 3) == 0) {
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wp + mt * 16 + (lane >> 2) + 8 * h;
        if (p < j.P) out[j.bias_out + p] = bacc[mt][2 * h];
      }
  }
}

template <typename T>
int launch(const RowArgs& ra, GradArgs& ga, float* dw, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * LD * (size_t)(2 * ra.Na + ra.Nb + ra.Nc);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_rows_kernel<T><<<(unsigned)((ra.M + TM - 1) / TM), THREADS, smem,
                       stream>>>(ra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Job& last = ga.job[ga.n_jobs - 1];
  const int tiles = last.tile0 + ((last.P + last.ones + WT - 1) / WT) * last.tiles_q;
  wgrad_partial_kernel<T><<<dim3(tiles, ga.S), THREADS, 0, stream>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_splits_kernel<<<(unsigned)((ga.total + THREADS - 1) / THREADS),
                         THREADS, 0, stream>>>(ga.partial, dw, ga.total,
                                               ga.S);
  return (int)cudaGetLastError();
}

void add_job(GradArgs& ga, long long& out, int& tile, const void* a,
             const void* b, int P, int Q, int ones, int a_lrelu, int b_f32,
             int b_round) {
  Job& j = ga.job[ga.n_jobs++];
  j.a = a; j.b = b; j.P = P; j.Q = Q; j.ones = ones; j.a_lrelu = a_lrelu;
  j.b_f32 = b_f32; j.b_round = b_round; j.out = out;
  j.tiles_q = (Q + WT - 1) / WT;
  j.tile0 = tile;
  tile += ((P + ones + WT - 1) / WT) * j.tiles_q;
  out += (long long)(P + ones) * Q;
}

int launch_tc(const TcRowArgs& ra, TcGradArgs& ga, int S, float* dw,
              cudaStream_t stream) {
  const TcSmem L = tc_smem(ra.Cp, ra.Nap, ra.Nbp, ra.Ncp);
  const size_t smem = sizeof(bf16) * (size_t)L.total;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (ra.M + TC_ROWS - 1) / TC_ROWS;
  const int grid = tiles < sms ? tiles : sms;  // persistent blocks
  bwd_rows_tc_kernel<<<grid, TC_THREADS, smem, stream>>>(ra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const TcJob& last = ga.job[ga.n_jobs - 1];
  const int wtiles = last.tile0 + 1;  // the last job is dbc's, one tile
  const int wsmem = (int)(sizeof(bf16) * WG_STAGES * WG_STAGE);
  err = cudaFuncSetAttribute(
      wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wsmem);
  if (err != cudaSuccess) return (int)err;
  wgrad_tc_kernel<<<dim3(wtiles, S), TC_THREADS, wsmem, stream>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_splits_kernel<<<(unsigned)((ga.total + THREADS - 1) / THREADS),
                         THREADS, 0, stream>>>(ga.partial, dw, ga.total, S);
  return (int)cudaGetLastError();
}

void add_tc_job(TcGradArgs& ga, int& tile, const void* a, const void* b,
                int lda, int ldb, int P, int Q, int a_lrelu, int bias,
                int transpose, long long out, long long bias_out) {
  TcJob& j = ga.job[ga.n_jobs++];
  j.a = static_cast<const bf16*>(a); j.b = b;
  j.lda = lda; j.ldb = ldb; j.P = P; j.Q = Q;
  j.a_lrelu = a_lrelu; j.bias = bias; j.transpose = transpose;
  j.colsum_f32 = a == nullptr;
  j.out = out; j.bias_out = bias_out;
  j.tiles_q = j.colsum_f32 ? 1 : (Q + TILE_Q - 1) / TILE_Q;
  j.tile0 = tile;
  tile += j.colsum_f32 ? 1 : ((P + TILE_P - 1) / TILE_P) * j.tiles_q;
}

}  // namespace

// The whole head backward. dw is the flat fp32 output, in this order:
// [dWa_0 (C, Na) | dba (Na) | dWa_1 .. dWa_{k-1} | dWb (Na, Nb) | dbb (Nb) |
//  dWc (Nb, Nc) | dbc (Nc)]. ws is a workspace of M * (2 Nb + Na) elements
// of x's type, in bf16 M * (2 Nb + Na + Nc rounded up to 16); partial one
// of S * (number of dw elements) floats. S >= 1
// splits of the rows (a function of M alone, chosen by the caller).
// fp32 (is_bf16 0): wa_i are the transposed Wa_i, (Na, C), and wbt the
// transposed Wb, (Nb, Na), beside wb itself. bf16: wa_i are the Wa_i as
// stored, (C, Na), wbt is unused, C, Na and Nb are multiples of 8 and every
// operand starts on a 16-byte boundary. Unused branch pointers (index >= k)
// may be null. Returns the cudaError_t of the launches (0 on success).
// Launches on `stream`, no synchronise.
extern "C" int nin_head_bwd(
    const void* x0, const void* x1, const void* x2, const void* x3,
    const void* wa0, const void* wa1, const void* wa2, const void* wa3,
    const void* h1, const void* wb, const void* wbt, const void* bb,
    const void* wc,
    const void* g, void* dx0, void* dx1, void* dx2, void* dx3, void* dw,
    void* ws, void* partial, int k, int M, int C, int Na, int Nb, int Nc,
    int S, float slope, int is_bf16, void* stream) {
  if (k < 1 || k > MAX_BRANCHES || M < 1 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* xs[MAX_BRANCHES] = {x0, x1, x2, x3};
  const void* was[MAX_BRANCHES] = {wa0, wa1, wa2, wa3};
  void* dxs[MAX_BRANCHES] = {dx0, dx1, dx2, dx3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  // offsets in the flat output
  const long long dba = (long long)C * Na, dwb = (long long)k * C * Na + Na;
  const long long dbb = dwb + (long long)Na * Nb, dwc = dbb + Nb;
  const long long dbc = dwc + (long long)Nb * Nc;

  if (is_bf16) {
    if (C % 8 || Na % 8 || Nb % 8) return (int)cudaErrorInvalidValue;
    bf16* w = static_cast<bf16*>(ws);
    TcRowArgs ra;
    for (int i = 0; i < MAX_BRANCHES; ++i) {
      ra.x[i] = static_cast<const bf16*>(xs[i]);
      ra.wa[i] = static_cast<const bf16*>(was[i]);
      ra.dx[i] = static_cast<bf16*>(dxs[i]);
    }
    ra.h1 = static_cast<const bf16*>(h1);
    ra.wb = static_cast<const bf16*>(wb);
    ra.bb = static_cast<const float*>(bb);
    ra.wc = static_cast<const bf16*>(wc);
    ra.g = static_cast<const float*>(g);
    ra.h2ws = w;
    ra.dpre2ws = w + (size_t)M * Nb;
    ra.dpre1ws = w + (size_t)M * 2 * Nb;
    ra.gws = w + (size_t)M * (2 * Nb + Na);
    ra.k = k; ra.M = M; ra.C = C; ra.Na = Na; ra.Nb = Nb; ra.Nc = Nc;
    auto p16 = [](int v) { return (v + 15) / 16 * 16; };
    ra.Cp = p16(C); ra.Nap = p16(Na); ra.Nbp = p16(Nb); ra.Ncp = p16(Nc);
    ra.slope = slope;
    if (ra.Cp > 4 * MAX_NT * 8) return (int)cudaErrorInvalidValue;

    TcGradArgs ga;
    ga.n_jobs = 0;
    int tile = 0;
    for (int i = 0; i < k; ++i)  // dWa_i = lrelu(x_i)^T dpre1; dba with dWa_0
      add_tc_job(ga, tile, xs[i], ra.dpre1ws, C, Na, C, Na, 1,
                 i == 0 ? BIAS_OF_B : BIAS_NONE, 0,
                 i == 0 ? 0 : dba + Na + (long long)(i - 1) * C * Na, dba);
    // dWb^T = dpre2^T h1, stored transposed; dbb = sum of dpre2
    add_tc_job(ga, tile, ra.dpre2ws, h1, Nb, Na, Nb, Na, 0, BIAS_OF_A, 1,
               dwb, dbb);
    // dWc = h2^T g_lp (g rounded by (a)); then dbc = sum of the fp32 g
    add_tc_job(ga, tile, ra.h2ws, ra.gws, Nb, ra.Ncp, Nb, Nc, 0, BIAS_NONE,
               0, dwc, 0);
    add_tc_job(ga, tile, nullptr, g, 0, 0, 0, Nc, 0, BIAS_NONE, 0, 0, dbc);
    ga.M = M;
    ga.chunk = ((long long)M + S - 1) / S;
    ga.total = dbc + Nc;
    ga.partial = static_cast<float*>(partial);
    ga.slope = slope;
    return launch_tc(ra, ga, S, dwf, s);
  }

  if (Na > QA * THREADS) return (int)cudaErrorInvalidValue;
  char* wsb = static_cast<char*>(ws);
  RowArgs ra;
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    ra.x[i] = xs[i]; ra.wat[i] = was[i]; ra.dx[i] = dxs[i];
  }
  ra.h1 = h1; ra.wb = wb; ra.wbt = wbt; ra.bb = static_cast<const float*>(bb); ra.wc = wc;
  ra.g = static_cast<const float*>(g);
  ra.h2ws = wsb;
  ra.dpre2ws = wsb + sizeof(float) * (size_t)M * Nb;
  ra.dpre1ws = wsb + sizeof(float) * (size_t)M * 2 * Nb;
  ra.k = k; ra.M = M; ra.C = C; ra.Na = Na; ra.Nb = Nb; ra.Nc = Nc;
  ra.slope = slope;

  GradArgs ga;
  ga.n_jobs = 0;
  long long out = 0;
  int tile = 0;
  // dWa_0 with dba as its ones row, then the other branches
  add_job(ga, out, tile, x0, ra.dpre1ws, C, Na, 1, 1, 0, 0);
  for (int i = 1; i < k; ++i)
    add_job(ga, out, tile, xs[i], ra.dpre1ws, C, Na, 0, 1, 0, 0);
  add_job(ga, out, tile, h1, ra.dpre2ws, Na, Nb, 1, 0, 0, 0);  // dWb, dbb
  add_job(ga, out, tile, ra.h2ws, g, Nb, Nc, 0, 0, 1, 1);      // dWc (g_lp)
  add_job(ga, out, tile, nullptr, g, 0, Nc, 1, 0, 1, 0);       // dbc (fp32 g)
  ga.M = M;
  ga.S = S;
  ga.chunk = ((long long)M + S - 1) / S;
  ga.total = out;
  ga.partial = static_cast<float*>(partial);
  ga.slope = slope;
  return launch<float>(ra, ga, dwf, s);
}
