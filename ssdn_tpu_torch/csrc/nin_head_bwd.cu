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
//  (a) bwd_rows: one block per TM = 32 rows, as the forward. It recomputes
//      pre2 and h2 from the h1 tile, forms dpre2 and dpre1 in shared
//      memory and writes dx_i; it also writes h2, dpre2 and dpre1 (in T)
//      to a workspace for the weight grads. The products with Wb^T and
//      Wa_i^T read transposed copies (made by the caller), so that the
//      threads of a warp, which own consecutive columns, read consecutive
//      weights.
//  (b) wgrad_partial: every weight grad is A^T B over the M rows. Each
//      block owns a 64 x 64 output tile of one product and one of S fixed
//      row ranges (splits) and writes fp32 partial sums [S][...]. The bias
//      grads ride along as a row of ones appended to A (dbc reads the fp32
//      g, as the TPU kernel sums it). One launch covers all products.
//  (c) reduce_splits: the sum over the S splits, in split order.
//
// No float atomics and a split count fixed by M: two launches on the same
// inputs give the same bits, as the TPU kernel does.
//
// What bounds it on the H100: ~2*(2*C*Na*k + 2*Na*Nb + 2*Nb*Nc + Na*Nb)
// flops per row (about 0.8 MFLOP at the model's k 4, C 96, Na 384, Nb 96)
// against about 2.4 kB per row moved (inputs, dx, and the workspace): the
// tensor-core rate bounds it. This simple version runs on the fp32 FMA
// pipes, reads the weights from L1/L2 in (a), and round-trips h2/dpre2/
// dpre1 through device memory. Left for later: tensor-core products
// (mma.sync / wgmma), fusing (b) into (a), dropping the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

}  // namespace

// The whole head backward. wat_i are the transposed Wa_i, (Na, C), and wbt
// the transposed Wb, (Nb, Na), beside wb itself. dw is the flat fp32
// output, in this order:
// [dWa_0 (C, Na) | dba (Na) | dWa_1 .. dWa_{k-1} | dWb (Na, Nb) | dbb (Nb) |
//  dWc (Nb, Nc) | dbc (Nc)]. ws is a workspace of M * (2 Nb + Na) elements
// of T; partial one of S * (number of dw elements) floats. S >= 1 splits of
// the rows (a function of M alone, chosen by the caller). Unused branch
// pointers (index >= k) may be null. Returns the cudaError_t of the
// launches (0 on success). Launches on `stream`, no synchronise.
extern "C" int nin_head_bwd(
    const void* x0, const void* x1, const void* x2, const void* x3,
    const void* wat0, const void* wat1, const void* wat2, const void* wat3,
    const void* h1, const void* wb, const void* wbt, const void* bb,
    const void* wc,
    const void* g, void* dx0, void* dx1, void* dx2, void* dx3, void* dw,
    void* ws, void* partial, int k, int M, int C, int Na, int Nb, int Nc,
    int S, float slope, int is_bf16, void* stream) {
  if (k < 1 || k > MAX_BRANCHES || Na > QA * THREADS || M < 1 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* xs[MAX_BRANCHES] = {x0, x1, x2, x3};
  const void* wats[MAX_BRANCHES] = {wat0, wat1, wat2, wat3};
  void* dxs[MAX_BRANCHES] = {dx0, dx1, dx2, dx3};
  const size_t es = is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  char* wsb = static_cast<char*>(ws);
  RowArgs ra;
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    ra.x[i] = xs[i]; ra.wat[i] = wats[i]; ra.dx[i] = dxs[i];
  }
  ra.h1 = h1; ra.wb = wb; ra.wbt = wbt; ra.bb = static_cast<const float*>(bb); ra.wc = wc;
  ra.g = static_cast<const float*>(g);
  ra.h2ws = wsb;
  ra.dpre2ws = wsb + es * (size_t)M * Nb;
  ra.dpre1ws = wsb + es * (size_t)M * 2 * Nb;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  return is_bf16 ? launch<__nv_bfloat16>(ra, ga, dwf, s)
                 : launch<float>(ra, ga, dwf, s);
}
