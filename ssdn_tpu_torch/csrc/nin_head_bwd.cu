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
// the launches below run back to back on the caller's stream:
//
//  (a) rows: recomputes pre2 and h2 from the h1 tile, forms dpre2 and
//      dpre1, writes dx_i, and writes h2, dpre2 and dpre1 (in T) to a
//      workspace for the weight grads (fp32: two launches, (a1) and (a2)).
//  (b) weight-grad partials: every weight grad is A^T B over the M rows.
//      Each block (fp32: each work item a persistent block takes) owns one
//      output tile of one product and one of S fixed row ranges (splits)
//      and writes fp32 partial sums [S][...]. The bias grads are column
//      sums in the same pass (dbc reads the fp32 g, as the TPU kernel sums
//      it). One launch covers all products.
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
//  - fp32, the parity path and the reference objective's training path,
//    on the FMA pipes (TF32 would break the port's fp32 bars). (a) is
//    0.70 TFLOP per batch-384 step, 10.4 ms at 67 TFLOP/s, against about
//    13 GB of rows in and out (4.0 ms): operations bound it. It follows
//    K2 fp32's design (nin_head.cu) run in reverse, in two launches cut at
//    dpre1, which the workspace holds for (b) anyway: dx's N is k C (384),
//    and its 128 x 384 accumulator fits neither the registers nor, beside
//    a ring, shared memory. Both launches: persistent blocks (one per SM,
//    256 threads) over 128-row tiles; K in slices of 32 through a ring of
//    shared memory, the weight slice by cp.async; register micro-tiles (8 x
//    8, or 8 x 6 on 96 columns) fed by LDS.128, no FMA reading global
//    memory.
//      (a1) bwd_rows_fma_kernel, per tile and pass of 96 columns of Nb:
//           pre2 = h1 Wb[:, pass] (8 x 6), h1's slice by cp.async as it
//           lies ([row][k]) through a 3-stage ring, its signs kept as bits
//           for dpre1's mask; dh2 = g Wc^T over Nc in groups of 16 (g's
//           tile and Wc^T in shared memory); h2 and dpre2 to the workspace
//           and dpre2 to shared memory ([j][row]); then per chunk of 128
//           columns of Na, dh1 = dpre2 Wb^T[pass, chunk] (8 x 8, Wb^T's rows
//           through the ring), masked by h1's signs into dpre1 on the last
//           pass. A pass after the first continues dh1's sum from the
//           workspace.
//      (a2) bwd_dx_fma_kernel: dx_cat = dpre1 [Wa_0^T | .. | Wa_{k-1}^T],
//           (M x Na)(Na x k C), in chunks of 128 columns of k C that may
//           straddle branches (a column's branch is three compares): the k
//           branches share dpre1 as A, so each chunk is one 8 x 8 product,
//           re-staging the tile's dpre1 (an L2 hit after the first chunk)
//           through registers into [k][row] slices of a 2-stage ring; the
//           epilogue masks by x_i's sign. One branch per chunk (96 columns,
//           8 x 6) ran 2-3% slower.
//    The weights cross L2 once per 128 rows (10.9 GB per step, from 43.5
//    for 32-row blocks). Widths are run-time and none is refused (Na <=
//    512, as the caller's MAX_NA): ragged M, C, Na, Nb and Nc are zero in
//    shared memory and masked on store; rows off 16-byte boundaries move in
//    4-byte pieces. Every sum runs in the first fp32 kernel's order (pre2
//    over Na, dh2 over Nc, dh1 over Nb, dx over Na, each one ascending fmaf
//    chain), so the bits match it. The rings' depths, the A layouts and the
//    unrolls were settled on the H100 by k3_probe.py (PERF.md section 6).
//    (b) wgrad_fma_kernel: 0.583 TFLOP per batch-384 step, 8.70 ms at 67
//    TFLOP/s, against about 8.5 GB of operands (2.5 ms): operations bound
//    it. A [m][p] and B [m][q] are staged as they lie, so nothing is
//    transposed. The k branches' dWa_i are one product, [lrelu x_0 | .. |
//    lrelu x_{k-1}]^T dpre1 (k C x Na: 9 tiles of 128 x 128 at the model's
//    widths, straddling branches; a column's branch is three compares);
//    dWb = h1^T dpre2 in 128 x 96 tiles (8 x 6 per thread); dWc = h2^T g in
//    128 x 16 (a column per thread). A product's bias sums (dba, dbb, dbc:
//    B's column sums, g_lp being g in fp32) are one more output row, one
//    thread per column of the tile that holds row 0, and the rows at and
//    past it move down one: the flat layout, with no padded tile. Two
//    persistent blocks per SM (256 threads, 128 registers each) take the
//    (tile, split) work items in order, dWa's first (the longest), each
//    claiming its next item from a counter the launcher zeroes, so that
//    the short items fill the tail; an item's 32-row stages of A and B go
//    through a 2-stage cp.async ring; lrelu(x) is applied once per stage in
//    shared memory, each thread on the pieces it staged; 8 x 8 register
//    micro-tiles are fed by LDS.128. L2 streams 19.4 GB per step, from 43.7
//    in the first kernel's 64 x 64 tiles. Every output is one ascending
//    fmaf chain over its split's rows from +0.0 (a bias sum adds b, which
//    is fmaf(1, b, acc)) and the zero rows past a split's end add exact
//    zeros: the first kernel's bits.
//
// Left for later: wgmma and TMA, fusing (b) into (a) and dropping the
// workspace. The ring depth, unroll, blocks per SM and the branch tiling of
// (b) were measured on the H100 by k3_probe.py (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "tc_bf16.cuh"

using namespace ssdn_tc;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BRANCHES = 4;
constexpr int MAX_DEVICES = 64;

constexpr int MAX_JOBS = MAX_BRANCHES + 3;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// --------------------------- fp32 (a) on the FMA pipes ---------------------------

// Geometry (kernels/nin_head.py's k3_plan has the same numbers): R_TM rows
// per tile, K in slices of R_KS through a ring of R_STAGES (a1) or
// DX_STAGES (a2), R_THREADS threads, one block per SM. (a1): pre2 in passes
// of R_NBP columns of Nb, dh2's K (Nc) in groups of R_NCG, dh1 in chunks of
// R_NCH columns of Na. (a2): dx in chunks of DX_NCH columns of k C.
constexpr int R_TM = 128;
constexpr int R_KS = 32;
constexpr int R_STAGES = 3;
constexpr int DX_STAGES = 2;
constexpr int R_NBP = 96;
constexpr int R_NCG = 16;
constexpr int R_NCH = 128;
constexpr int DX_NCH = 128;
constexpr int R_THREADS = 256;
// the FMA loops' K unrolled by (a1), in both of its products, and (a2)
constexpr int ROWS_UNROLL = 8;
constexpr int DX_UNROLL = 32;
constexpr int R_MAX_KS = 16;  // pre2's slices: Na <= 512 (MAX_NA)
// Strides, in floats: [row][k] slices (rows of the row-major operands as
// they are, by cp.async: a warp's 4 rows fall in distinct banks) and [k][row]
// tiles and slices (a warp's column stores hit 32 banks)
constexpr int R_LDA = R_KS + 4;
constexpr int R_LDG = R_NCG + 4;
constexpr int R_LDT = R_TM + 4;
constexpr int R_AS = R_TM * R_LDA;  // floats in an (a1) stage's A slice
constexpr int DX_AS = R_KS * R_LDT;  // floats in an (a2) stage's A slice
constexpr int R_BS = R_KS * R_NCH;  // floats in a stage's B slice (the widest)
static_assert(DX_NCH <= R_NCH && R_NBP <= R_NCH, "a B slice outgrows its stage");
// Shared memory, in floats. (a2): the ring (A: dpre1 slices, [k][row]; B:
// Wa^T slices). (a1): the ring (A: h1 slices, [row][k]; B: Wb or Wb^T
// slices), the pass's dpre2 (R_NBP x R_LDT, [j][row]), g's group (two
// buffers, [row][n]), Wc^T's group ([n][j]), and h1's signs for dpre1's mask
// (bits, two buffers of R_TM rows x R_MAX_KS slices, a word each).
constexpr int DX_SMEM = 4 * DX_STAGES * (DX_AS + R_BS);  // bytes
constexpr int RW_OFF_B = R_STAGES * R_AS;
constexpr int RW_OFF_D = RW_OFF_B + R_STAGES * R_BS;
constexpr int RW_OFF_G = RW_OFF_D + R_NBP * R_LDT;
constexpr int RW_OFF_C = RW_OFF_G + 2 * R_TM * R_LDG;
constexpr int RW_OFF_M = RW_OFF_C + R_NCG * R_NBP;
constexpr int RW_MASK = R_TM * R_MAX_KS;  // words in a buffer of signs
constexpr int RW_SMEM = 4 * (RW_OFF_M + 2 * RW_MASK);  // bytes

// dst <- 16 (4) bytes at src, or zeros where `in` is false (nothing read)
__device__ __forceinline__ void cp_async16_or_zero(float* dst, const float* src,
                                                   bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src,
                                                  bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// An A slice by cp.async: rows r0.. (R_TM) and columns k0.. (R_KS) of a
// row-major (M x K) matrix into a stage's [row][k] slice (eight threads per
// row, 128 contiguous bytes); zero past M and K. vec: 16-byte pieces.
__device__ __forceinline__ void stage_a(float* dst, const float* m, int M,
                                        int K, long long r0, int k0, bool vec) {
  constexpr int Q = R_KS / 4;
#pragma unroll
  for (int i = 0; i < R_TM * Q / R_THREADS; ++i) {
    const int e = threadIdx.x + i * R_THREADS, r = e / Q, c = k0 + (e - r * Q) * 4;
    const long long row = r0 + r;
    const bool rin = row < M;
    const float* src = m + (rin ? row * K + c : 0);
    float* d = dst + r * R_LDA + (c - k0);
    if (vec) {
      const bool in = rin && c < K;
      cp_async16_or_zero(d, in ? src : m, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = rin && c + j < K;
        cp_async4_or_zero(d + j, in ? src + j : m, in);
      }
    }
  }
}

// An A slice through registers: columns k0 + 4 (tid % 2) + 8i .. + 3 (i <
// 4) of row r of a row-major (M x K) matrix (a warp reads 16 rows x 32
// bytes); zero past M and K. vec: 16-byte loads.
__device__ __forceinline__ void load_a(float4 (&v)[4], const float* m, int M,
                                       int K, long long r, int k0, bool vec) {
  const bool rin = r < M;
  const int kc = k0 + (threadIdx.x & 1) * 4;
  const float* src = m + (rin ? r * K + kc : 0);
  if (vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = rin && kc + 8 * i < K
                 ? __ldg(reinterpret_cast<const float4*>(src + 8 * i))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = rin && kc + 8 * i + j < K ? __ldg(src + 8 * i + j) : 0.f;
      v[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}
// ... stored transposed into a stage's [k][row] slice: for each store a
// warp's 32 lanes hit 32 distinct banks (16 rows; columns 4 apart, 16 banks
// apart at a stride of R_LDT)
__device__ __forceinline__ void store_a(float* dst, const float4 (&v)[4]) {
  float* d = dst + (threadIdx.x & 1) * 4 * R_LDT + (threadIdx.x >> 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[8 * i * R_LDT] = v[i].x;
    d[(8 * i + 1) * R_LDT] = v[i].y;
    d[(8 * i + 2) * R_LDT] = v[i].z;
    d[(8 * i + 3) * R_LDT] = v[i].w;
  }
}

// A B slice by cp.async: rows k0.. (R_KS) and W columns of a row-major
// matrix into a stage's [k][column] slice of row stride W; `src(k, col)`
// gives column col's address in row k (col < ncols), zero past kend and
// ncols. vec: 16-byte pieces (every 4 columns contiguous and on a 16-byte
// boundary).
template <int W, typename Src>
__device__ __forceinline__ void stage_b(float* dst, int k0, int kend,
                                        int ncols, bool vec, const float* any,
                                        Src src) {
  constexpr int Q = W / 4;
#pragma unroll
  for (int i = 0; i < R_KS * Q / R_THREADS; ++i) {
    const int e = threadIdx.x + i * R_THREADS, r = e / Q, c = (e - r * Q) * 4;
    const bool rin = k0 + r < kend;
    float* d = dst + r * W + c;
    if (vec) {
      const bool in = rin && c < ncols;
      cp_async16_or_zero(d, in ? src(k0 + r, c) : any, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = rin && c + j < ncols;
        cp_async4_or_zero(d + j, in ? src(k0 + r, c + j) : any, in);
      }
    }
  }
}

// Thread (ty, tx) owns columns 4tx.. and 64 + J2 tx.. of a W-wide N block (4
// + J2, J2 = (W - 64) / 16: 8 of 128, 6 of 96) and 8 rows of its tile: rows
// ty + 16i where A is [row][k] (rk), rows 4ty.. and 64 + 4ty.. where A is
// [k][row] (kr). A quarter-warp shares ty and holds 8 consecutive tx, so
// every shared read is a broadcast or contiguous.
__device__ __forceinline__ int rk_row(int ty, int i) { return ty + 16 * i; }
__device__ __forceinline__ int kr_row(int ty, int i) {
  return (i < 4 ? 0 : 60) + ty * 4 + i;
}
template <int W>
__device__ __forceinline__ int mt_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + (W - 64) / 16 * tx + (j - 4);
}

// B[kk] at this thread's columns: an LDS.128 and an LDS.128 / .64
template <int W>
__device__ __forceinline__ void load_bv(float (&bv)[4 + (W - 64) / 16],
                                        const float* b, const float* b2) {
  const float4 b0 = *reinterpret_cast<const float4*>(b);
  bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
  if constexpr (W == 128) {
    const float4 b1 = *reinterpret_cast<const float4*>(b2);
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
  } else {
    static_assert(W == 96, "micro-tiles are 8 x 6 or 8 x 8");
    const float2 b1 = *reinterpret_cast<const float2*>(b2);
    bv[4] = b1.x; bv[5] = b1.y;
  }
}

// acc[i][j] += sum_kk A[row i][kk] B[kk][column j] over K steps: A [row][k]
// at a stride of LDA (rows rk_row), B [k][column] at a stride of W. Every
// four K steps read the 8 rows' A with eight LDS.128 and B with two reads per
// step. Each acc[i][j] is one fmaf chain in ascending k. Unrolled by U
// (min(U, K) steps per trip).
template <int W, int K, int U, int LDA>
__device__ __forceinline__ void fma_rk(float (&acc)[8][4 + (W - 64) / 16],
                                       const float* A, const float* B, int ty,
                                       int tx) {
  constexpr int NJ = 4 + (W - 64) / 16, UK = U < K ? U : K;
  static_assert(K % UK == 0 && UK % 4 == 0, "the unroll divides K by fours");
  const float* a = A + ty * LDA;
  const float* b = B + tx * 4;
  const float* b2 = B + 64 + tx * ((W - 64) / 16);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += UK)
#pragma unroll
  for (int kq = k0; kq < k0 + UK; kq += 4) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a4[i] = *reinterpret_cast<const float4*>(a + 16 * i * LDA + kq);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bv[NJ];
      load_bv<W>(bv, b + (kq + u) * W, b2 + (kq + u) * W);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = u == 0 ? a4[i].x : u == 1 ? a4[i].y : u == 2 ? a4[i].z
                                                                     : a4[i].w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// The same with A [k][row] at a stride of R_LDT (rows kr_row): one outer
// product per K step from two LDS.128 of A and two reads of B.
template <int W, int K, int U>
__device__ __forceinline__ void fma_kr(float (&acc)[8][4 + (W - 64) / 16],
                                       const float* A, const float* B, int ty,
                                       int tx) {
  constexpr int NJ = 4 + (W - 64) / 16, UK = U < K ? U : K;
  static_assert(K % UK == 0, "the unroll divides K");
  const float* a = A + ty * 4;
  const float* b = B + tx * 4;
  const float* b2 = B + 64 + tx * ((W - 64) / 16);
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += UK)
#pragma unroll
  for (int kk = k0; kk < k0 + UK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * R_LDT);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * R_LDT + 64);
    float bv[NJ];
    load_bv<W>(bv, b + kk * W, b2 + kk * W);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// N contiguous floats of a row at column col (< width) <- v[0..N), in one
// 8- or 16-byte store (vec) or 4-byte stores masked past width
template <int N>
__device__ __forceinline__ void store_piece(float* row, int col, int width,
                                            const float* v, bool vec) {
  if (vec) {
    if (col >= width) return;
    if constexpr (N == 4)
      *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(row + col) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (col + e < width) row[col + e] = v[e];
  }
}
// ... and its load (zero past width). Plain loads: (a1) reads back the
// workspace it writes.
template <int N>
__device__ __forceinline__ void load_piece(float (&v)[N], const float* row,
                                           int col, int width, bool vec) {
  if (vec) {
    if constexpr (N == 4) {
      const float4 t = col < width ? *reinterpret_cast<const float4*>(row + col)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const float2 t = col < width ? *reinterpret_cast<const float2*>(row + col)
                                   : make_float2(0.f, 0.f);
      v[0] = t.x; v[1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = col + e < width ? row[col + e] : 0.f;
  }
}

struct RowsArgs {
  const float* h1;   // (M, Na)
  const float* wb;   // (Na, Nb)
  const float* wbt;  // Wb^T, (Nb, Na)
  const float* bb;
  const float* wc;   // (Nb, Nc)
  const float* g;    // (M, Nc)
  float* h2ws;       // (M, Nb)
  float* dpre2ws;    // (M, Nb)
  float* dpre1ws;    // (M, Na); a pass before the last holds dh1's partial sum
  int M, Na, Nb, Nc;
  float slope;
  // 16-byte pieces: the width a multiple of 4 and the operand on a 16-byte
  // boundary (else 4-byte pieces)
  bool vec_h1, vec_wb, vec_wbt, vec_h2, vec_d1;
};

// (a1): per tile, per pass of R_NBP columns of Nb: pre2, dh2, h2 and dpre2;
// then per chunk of R_NCH columns of Na: dh1 and (last pass) dpre1.
// Persistent: block b walks tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(R_THREADS, 1)
bwd_rows_fma_kernel(RowsArgs a) {
  extern __shared__ float4 smem_rows[];
  float* sm = reinterpret_cast<float*>(smem_rows);
  float* sA = sm;
  float* sB = sm + RW_OFF_B;
  float* sD = sm + RW_OFF_D;
  float* sG = sm + RW_OFF_G;
  float* sC = sm + RW_OFF_C;
  unsigned* sM = reinterpret_cast<unsigned*>(sm + RW_OFF_M);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int M = a.M, Na = a.Na, Nb = a.Nb, Nc = a.Nc;
  const int ksa = (Na + R_KS - 1) / R_KS;  // pre2's slices
  const int nch = (Na + R_NCH - 1) / R_NCH;
  const int npass = (Nb + R_NBP - 1) / R_NBP;
  const int ngrp = (Nc + R_NCG - 1) / R_NCG;
  const bool g_resident = ngrp == 1;  // g's tile prefetched with its first slice
  const bool wc_resident = g_resident && npass == 1;  // Wc^T loaded once
  const int n_tiles = (M + R_TM - 1) / R_TM;
  // dh1's slices in a pass (the last pass may be part-filled)
  auto ksb = [&](int pass) {
    return (min(R_NBP, Nb - pass * R_NBP) + R_KS - 1) / R_KS;
  };

  // g's rows of a tile, columns grp R_NCG.., into buffer buf of sG
  // ([row][n]) by cp.async
  auto load_g = [&](int tile, int grp, int buf) {
#pragma unroll
    for (int i = 0; i < R_NCG * R_TM / R_THREADS; ++i) {
      const int e = tid + i * R_THREADS, r = e / R_NCG, n = e % R_NCG;
      const long long row = (long long)tile * R_TM + r;
      const int col = grp * R_NCG + n;
      const bool in = row < M && col < Nc;
      cp_async4_or_zero(sG + (buf * R_TM + r) * R_LDG + n,
                        in ? a.g + row * Nc + col : a.g, in);
    }
  };
  // Wc^T rows grp R_NCG.. (Nc), columns of the pass (Nb) into sC ([n][j])
  auto load_wc = [&](int pass, int grp) {
    for (int e = tid; e < R_NCG * R_NBP; e += R_THREADS) {
      const int n = grp * R_NCG + e / R_NBP, j = pass * R_NBP + e % R_NBP;
      sC[e] = n < Nc && j < Nb ? a.wc[(size_t)j * Nc + n] : 0.f;
    }
  };

  // The next step to stage: the block's ni-th tile nt, pass np, chunk nc
  // (-1: pre2's slices), slice nk; advanced in the order of the loops below
  int nt = blockIdx.x, ni = 0, np = 0, nc = -1, nk = 0;
  auto stage = [&](int st) {
    float* dst = sB + st * R_BS;
    if (nc < 0) {  // pre2: h1 slice, Wb[slice, pass]
      stage_a(sA + st * R_AS, a.h1, M, Na, (long long)nt * R_TM, nk * R_KS,
              a.vec_h1);
      const int n0 = np * R_NBP;
      stage_b<R_NBP>(dst, nk * R_KS, Na, Nb - n0, a.vec_wb, a.wb,
                     [&](int k, int c) { return a.wb + (size_t)k * Nb + n0 + c; });
      // g lands two steps before its tile: a buffer per tile parity
      if (g_resident && np == 0 && nk == 0) load_g(nt, 0, ni & 1);
      if (++nk == ksa) nk = 0, nc = 0;
    } else {  // dh1: Wb^T[pass slice, chunk]
      const int c0 = nc * R_NCH;
      stage_b<R_NCH>(dst, np * R_NBP + nk * R_KS, Nb, Na - c0, a.vec_wbt, a.wbt,
                     [&](int k, int c) { return a.wbt + (size_t)k * Na + c0 + c; });
      if (++nk == ksb(np)) {
        nk = 0;
        if (++nc == nch) {
          nc = -1;
          if (++np == npass) np = 0, nt += gridDim.x, ++ni;
        }
      }
    }
  };
  int s = 0;  // the step whose slices are in stage s % R_STAGES
  // one step: the slices of step s + 2 load while this one's compute runs
  auto step = [&](auto&& compute) {
    if (nt < n_tiles) stage((s + 2) % R_STAGES);
    cp_async_commit();
    compute(sA + (s % R_STAGES) * R_AS, sB + (s % R_STAGES) * R_BS);
    cp_async_wait<1>();
    __syncthreads();  // stage s is free; stage s + 1 landed
    ++s;
  };

  if (wc_resident) load_wc(0, 0);
  for (int i = 0; i < R_STAGES - 1; ++i) {  // steps 0 and 1
    if (nt < n_tiles) stage(i);
    cp_async_commit();
  }
  cp_async_wait<1>();
  __syncthreads();

  int pi = 0, ti = 0;  // (tile, pass) iterations and tiles before this one
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++ti) {
    const long long r0 = (long long)tile * R_TM;
    const float* g_tile = sG + (ti & 1) * R_TM * R_LDG;
    for (int pass = 0; pass < npass; ++pass, ++pi) {
      // ---- pre2 = h1 Wb[:, pass], and h1's signs for dpre1's mask ----
      unsigned* signs = sM + (pi & 1) * RW_MASK;
      float pre[8][6] = {};
      for (int q = 0; q < ksa; ++q)
        step([&](const float* A, const float* B) {
          // this thread's half row of the slice: bit o for column o
          const float* hr = A + (tid >> 1) * R_LDA + (tid & 1) * 16;
          unsigned bits = 0;
#pragma unroll
          for (int c = 0; c < 16; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(hr + c);
            bits |= (unsigned)(v.x >= 0.f) << c | (unsigned)(v.y >= 0.f) << (c + 1) |
                    (unsigned)(v.z >= 0.f) << (c + 2) |
                    (unsigned)(v.w >= 0.f) << (c + 3);
          }
          bits <<= (tid & 1) * 16;
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          if ((tid & 1) == 0) signs[(tid >> 1) * R_MAX_KS + q] = bits;
          fma_rk<R_NBP, R_KS, ROWS_UNROLL, R_LDA>(pre, A, B, ty, tx);
        });

      // ---- dh2 = g Wc^T[:, pass], Nc in groups ----
      float d[8][6] = {};
      for (int grp = 0; grp < ngrp; ++grp) {
        if (!wc_resident) {
          if (grp > 0) __syncthreads();  // the last group is read
          if (!g_resident) {
            load_g(tile, grp, ti & 1);
            cp_async_commit();
          }
          load_wc(pass, grp);
          cp_async_wait<0>();
          __syncthreads();
        }
        fma_rk<R_NBP, R_NCG, R_NCG, R_LDG>(d, g_tile, sC, ty, tx);
      }

      // ---- h2 = lrelu(pre2 + bb), dpre2 = mask(pre2) dh2 ----
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int cj = mt_col<R_NBP>(tx, j), n = pass * R_NBP + cj;
        const float bj = n < Nb ? a.bb[n] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = pre[i][j] + bj;
          d[i][j] = p >= 0.f ? d[i][j] : a.slope * d[i][j];
          pre[i][j] = lrelu(p, a.slope);
          sD[cj * R_LDT + rk_row(ty, i)] = d[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = r0 + rk_row(ty, i);
        if (r >= M) continue;
        const int c0 = pass * R_NBP + mt_col<R_NBP>(tx, 0);
        const int c1 = pass * R_NBP + mt_col<R_NBP>(tx, 4);
        store_piece<4>(a.h2ws + r * Nb, c0, Nb, pre[i], a.vec_h2);
        store_piece<2>(a.h2ws + r * Nb, c1, Nb, pre[i] + 4, a.vec_h2);
        store_piece<4>(a.dpre2ws + r * Nb, c0, Nb, d[i], a.vec_h2);
        store_piece<2>(a.dpre2ws + r * Nb, c1, Nb, d[i] + 4, a.vec_h2);
      }
      __syncthreads();  // the pass's dpre2 tile and h1's signs are whole

      // ---- per chunk of Na: dh1 = dpre2 Wb^T[pass, chunk]; dpre1 ----
      const bool last = pass == npass - 1;
      for (int chunk = 0; chunk < nch; ++chunk) {
        const int c0 = chunk * R_NCH;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // a pass after the first continues the sum
          const long long r = r0 + kr_row(ty, i);
          const float* row = a.dpre1ws + (r < M ? r : 0) * Na;
          float v[4], w[4];
          if (pass > 0 && r < M) {
            load_piece<4>(v, row, c0 + mt_col<R_NCH>(tx, 0), Na, a.vec_d1);
            load_piece<4>(w, row, c0 + mt_col<R_NCH>(tx, 4), Na, a.vec_d1);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = w[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = v[e], acc[i][4 + e] = w[e];
        }
        for (int q = 0; q < ksb(pass); ++q)
          step([&](const float*, const float* B) {
            fma_kr<R_NCH, R_KS, ROWS_UNROLL>(acc, sD + q * R_KS * R_LDT, B, ty,
                                             tx);
          });
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long r = r0 + kr_row(ty, i);
          if (r >= M) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + mt_col<R_NCH>(tx, 4 * h);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * h + e];
            if (last) {  // the mask: h1's signs, taken from pre2's slices
              const unsigned w = signs[kr_row(ty, i) * R_MAX_KS + (c >> 5)];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = w >> ((c & 31) + e) & 1u ? v[e] : a.slope * v[e];
            }
            store_piece<4>(a.dpre1ws + r * Na, c, Na, v, a.vec_d1);
          }
        }
      }
    }
  }
}

struct DxArgs {
  const float* x[MAX_BRANCHES];
  const float* wat[MAX_BRANCHES];  // Wa_i^T, (Na, C)
  float* dx[MAX_BRANCHES];
  const float* dpre1;  // (M, Na), from (a1)
  int k, M, C, Na;
  float slope;
  bool vec_d1, vec_wa, vec_x;  // 16-byte pieces, as RowsArgs
};

// Column col of Wa_cat^T / dx_cat (k <= 4 branches of C) is channel col - br
// C of branch br.
__device__ __forceinline__ int branch_of(int col, int C) {
  return (col >= C) + (col >= 2 * C) + (col >= 3 * C);
}
// p[i] by selects: an argument array indexed at run time would be copied to
// the stack
template <typename T>
__device__ __forceinline__ T pick(T const (&p)[MAX_BRANCHES], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// dx_i = mask(x_i) dx_cat on P columns col.. of the thread's 8 rows
// (kr_row) of the tile at r0, dx_cat's values in acc[i][j0..]. vec: the
// piece lies in one branch (C a multiple of 4) and moves in one load and one
// store; else each column finds its own branch, 4-byte pieces.
template <int P, int NJ>
__device__ __forceinline__ void store_dx(const DxArgs& a, long long r0, int ty,
                                         int col, const float (&acc)[8][NJ],
                                         int j0) {
  const int C = a.C, N = a.k * C;
  if (col >= N) return;
  if (a.vec_x) {
    const int br = branch_of(col, C), c = col - br * C;
    const float* x = pick(a.x, br);
    float* dx = pick(a.dx, br);
    float xv[8][P];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // every load first: they overlap
      const long long r = r0 + kr_row(ty, i);
      load_piece<P>(xv[i], x + (r < a.M ? r : 0) * C, c, C, true);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = r0 + kr_row(ty, i);
      if (r >= a.M) continue;
      float v[P];
#pragma unroll
      for (int e = 0; e < P; ++e)
        v[e] = xv[i][e] >= 0.f ? acc[i][j0 + e] : a.slope * acc[i][j0 + e];
      store_piece<P>(dx + r * C, c, C, v, true);
    }
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e) {
      if (col + e >= N) break;
      const int br = branch_of(col + e, C), c = col + e - br * C;
      const float* x = pick(a.x, br);
      float* dx = pick(a.dx, br);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = r0 + kr_row(ty, i);
        if (r >= a.M) continue;
        const float v = acc[i][j0 + e];
        dx[r * C + c] = x[r * C + c] >= 0.f ? v : a.slope * v;
      }
    }
  }
}

// (a2): per tile and chunk of DX_NCH columns of k C, dx_cat = dpre1 Wa_cat^T
// over Na's slices, masked by x_i's sign. Persistent, as (a1); its A (dpre1)
// comes through registers into [k][row] slices.
__global__ void __launch_bounds__(R_THREADS, 1)
bwd_dx_fma_kernel(DxArgs a) {
  constexpr int J2 = (DX_NCH - 64) / 16;
  extern __shared__ float4 smem_dx[];
  float* sA = reinterpret_cast<float*>(smem_dx);
  float* sB = sA + DX_STAGES * DX_AS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int M = a.M, C = a.C, Na = a.Na, N = a.k * C;
  const int ks = (Na + R_KS - 1) / R_KS;
  const int nch = (N + DX_NCH - 1) / DX_NCH;
  const int n_tiles = (M + R_TM - 1) / R_TM;

  int nt = blockIdx.x, nc = 0, nk = 0;  // the next step: tile, chunk, slice
  float4 av[4];
  auto stage = [&](int st) {
    load_a(av, a.dpre1, M, Na, (long long)nt * R_TM + (tid >> 1), nk * R_KS,
           a.vec_d1);
    const int c0 = nc * DX_NCH;
    stage_b<DX_NCH>(sB + st * R_BS, nk * R_KS, Na, N - c0, a.vec_wa, a.wat[0],
                    [&](int k, int c) {
                      const int col = c0 + c, br = branch_of(col, C);
                      return pick(a.wat, br) + (size_t)k * C + (col - br * C);
                    });
    if (++nk == ks) {
      nk = 0;
      if (++nc == nch) nc = 0, nt += gridDim.x;
    }
  };

  stage(0);
  cp_async_commit();
  store_a(sA, av);
  cp_async_wait<0>();
  __syncthreads();

  int s = 0;  // the step whose slices are in stage s % 2
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * R_TM;
    for (int chunk = 0; chunk < nch; ++chunk) {
      float acc[8][4 + J2] = {};
      for (int q = 0; q < ks; ++q, ++s) {
        const int cur = s & 1;
        const bool more = nt < n_tiles;
        if (more) stage(cur ^ 1);  // step s + 1's slices
        cp_async_commit();
        fma_kr<DX_NCH, R_KS, DX_UNROLL>(acc, sA + cur * DX_AS, sB + cur * R_BS,
                                        ty, tx);
        if (more) store_a(sA + (cur ^ 1) * DX_AS, av);
        cp_async_wait<0>();
        __syncthreads();  // stage s is free; stage s + 1 landed
      }

      // ---- dx_i = mask(x_i) dx_cat, two column pieces per row ----
      const int col = chunk * DX_NCH;
      store_dx<4>(a, r0, ty, col + mt_col<DX_NCH>(tx, 0), acc, 0);
      store_dx<J2>(a, r0, ty, col + mt_col<DX_NCH>(tx, 4), acc, 4);
    }
  }
}

// ------------------ fp32 (b): weight-grad partials on the FMA pipes ------------------

// Geometry (kernels/nin_head.py's k3_plan has the same numbers): output
// tiles of 128 rows (p) by 128, 96 or 16 columns (q), by the product's Q;
// a split's rows in (a)'s slices of R_KS, staged by (a)'s stage_b through
// a ring of WF_STAGES, A [m][p] and B [m][q] as they lie in memory, both
// rows WF_LD floats; R_THREADS threads, WF_BLOCKS blocks per SM. The k
// branches' dWa_i are one product, [lrelu x_0 | .. | lrelu x_{k-1}]^T
// dpre1, whose row tiles straddle branches.
constexpr int WF_STAGES = 2;
constexpr int WF_BLOCKS = 2;
constexpr int WF_UNROLL = 16;  // the FMA loop's K unroll
constexpr int WF_TP = 128;  // tile rows
constexpr int WF_LD = 128;
constexpr int WF_STAGE = 2 * R_KS * WF_LD;         // floats: A, then B
// bytes: the ring and two claimed item numbers
constexpr int WF_SMEM = 4 * WF_STAGES * WF_STAGE + 16;
constexpr int WF_MAX_JOBS = MAX_BRANCHES + 2;

// One product out[p, q] = sum_m A[m, p] B[m, q] over a split's rows, with
// the column sums of B as output row `bias` (rows at and past it move down
// one; -1: no sums). A (M x P) is P / lda blocks of lda columns side by
// side (the branches), each row-major; B (M x Q) row-major.
struct WfJob {
  const float* a[MAX_BRANCHES];
  const float* b;
  int lda, P, Q;
  int w;  // tile columns
  int tiles_p, tiles_q;
  int bias;
  int lrelu;         // A is lrelu(x), applied once per stage
  int vec_a, vec_b;  // 16-byte pieces (width a multiple of 4, 16-byte
                     // boundaries), else 4-byte pieces
  long long out;     // offset of the product in the flat output
  int item0;         // first work item; items run split-major, tile-minor
};

struct WfArgs {
  WfJob job[WF_MAX_JOBS];
  int n_jobs, n_items, M;
  long long chunk;  // rows per split
  long long total;  // elements of the flat output
  float* partial;   // [S][total]
  int* next;        // items claimed after the first gridDim.x, zeroed
  float slope;
};

// A work item: tile (pt, q0) of one product over one split's rows [m0, m1)
struct WfItem {
  int job, split, pt, p0, pn, q0, qn, m0, m1;
};

__device__ __forceinline__ WfItem wf_item(const WfArgs& g, int item) {
  WfItem it;
  int ji = 0;
  while (ji + 1 < g.n_jobs && item >= g.job[ji + 1].item0) ++ji;
  const WfJob& j = g.job[ji];
  const int per = j.tiles_p * j.tiles_q, t = item - j.item0;
  it.job = ji;
  it.split = t / per;
  const int r = t - it.split * per;
  it.pt = r / j.tiles_q;
  it.p0 = it.pt * WF_TP;
  it.pn = min(WF_TP, j.P - it.p0);
  it.q0 = (r - it.pt * j.tiles_q) * j.w;
  it.qn = min(j.w, j.Q - it.q0);
  it.m0 = (int)min((long long)g.M, it.split * g.chunk);
  it.m1 = (int)min((long long)g.M, it.split * g.chunk + g.chunk);
  return it;
}

// stage_b<WF_LD>'s pieces per thread: e = t + i R_THREADS, row e / 32,
// columns 4 (e % 32)..
constexpr int WF_PIECES = R_KS * (WF_LD / 4) / R_THREADS;

// lrelu over the pieces of an A slice this thread staged (its own copies
// have landed; the barrier after it publishes them)
__device__ __forceinline__ void wf_lrelu(float* sa, float slope) {
  constexpr int Q = WF_LD / 4;
#pragma unroll
  for (int i = 0; i < WF_PIECES; ++i) {
    const int e = threadIdx.x + i * R_THREADS, r = e / Q;
    float4* p = reinterpret_cast<float4*>(sa + r * WF_LD + (e - r * Q) * 4);
    float4 v = *p;
    v.x = lrelu(v.x, slope);
    v.y = lrelu(v.y, slope);
    v.z = lrelu(v.z, slope);
    v.w = lrelu(v.w, slope);
    *p = v;
  }
}

// Thread (ty, tx) holds rows wf_row(ty, i) (8 of the 128-row tile) and
// columns wf_col(tx, j) (8 of 128, 6 of 96, 1 of 16) of its tile. A
// quarter-warp shares ty and holds 8 consecutive tx, so every shared read
// is a broadcast or contiguous.
constexpr int WF_NI = 8;
template <int W>
constexpr int wf_nj = W == 16 ? 1 : 4 + (W - 64) / 16;
__device__ __forceinline__ int wf_row(int ty, int i) {
  return i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4);
}
template <int W>
__device__ __forceinline__ int wf_col(int tx, int j) {
  if constexpr (W == 16) return tx;
  return j < 4 ? 4 * tx + j : 64 + (W - 64) / 16 * tx + (j - 4);
}

// N consecutive floats (an LDS.128, .64 or .32)
template <int N>
__device__ __forceinline__ void wf_lds(float* v, const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// acc[i][j] += sum_kk A[kk][row i] B[kk][column j] over a stage's R_KS
// rows: per row kk, this thread's A values and B values in two reads each
// (W 16: one of B), then NI x NJ FMAs. Each acc[i][j] is one fmaf chain in
// ascending m. Unrolled by U.
template <int W, int U>
__device__ __forceinline__ void wf_fma(float (&acc)[WF_NI][wf_nj<W>],
                                       const float* A, const float* B, int ty,
                                       int tx) {
  constexpr int NI = WF_NI, NJ = wf_nj<W>;
  static_assert(R_KS % U == 0, "the unroll divides a stage");
  const float* a = A + 4 * ty;
  const float* a2 = A + 64 + 4 * ty;
  const float* b = B + (W == 16 ? tx : 4 * tx);
  const float* b2 = B + (W == 16 ? 0 : 64 + (W - 64) / 16 * tx);
#pragma unroll 1
  for (int k0 = 0; k0 < R_KS; k0 += U)
#pragma unroll
    for (int kk = k0; kk < k0 + U; ++kk) {
      float av[NI], bv[NJ];
      wf_lds<4>(av, a + kk * WF_LD);
      wf_lds<NI - 4>(av + 4, a2 + kk * WF_LD);
      if constexpr (W == 16) {
        wf_lds<1>(bv, b + kk * WF_LD);
      } else {
        wf_lds<4>(bv, b + kk * WF_LD);
        wf_lds<NJ - 4>(bv + 4, b2 + kk * WF_LD);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// (b): persistent blocks take the work items in order: block b first item
// b, then the next unclaimed one (a counter in device memory, zeroed before
// the launch), so the longest items go first and the short ones fill the
// tail. Each item runs its own ring: first stages, then per step the wait,
// the barrier, the next stage's loads and the FMAs.
__global__ void __launch_bounds__(R_THREADS, WF_BLOCKS)
wgrad_fma_kernel(const __grid_constant__ WfArgs g) {
  extern __shared__ float4 smem_wf[];
  float* sm = reinterpret_cast<float*>(smem_wf);
  int* claimed = reinterpret_cast<int*>(sm + WF_STAGES * WF_STAGE);  // [2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);

  int item = blockIdx.x;
  for (int round = 0; item < g.n_items; ++round) {
    const WfItem it = wf_item(g, item);
    const WfJob& j = g.job[it.job];
    const int steps = it.m0 < it.m1 ? (it.m1 - it.m0 + R_KS - 1) / R_KS : 0;
    // B's column sums: one thread per column of the tile that holds row 0
    const bool bias = j.bias >= 0 && it.pt == 0 && tid < j.w;
    // step q's rows of A and B into stage q % WF_STAGES
    auto stage = [&](int q) {
      float* sa = sm + (q % WF_STAGES) * WF_STAGE;
      const int mb = it.m0 + q * R_KS;
      stage_b<WF_LD>(sa, mb, it.m1, it.pn, j.vec_a, j.a[0], [&](int m, int c) {
        const int p = it.p0 + c, br = branch_of(p, j.lda);
        return pick(j.a, br) + (size_t)m * j.lda + (p - br * j.lda);
      });
      stage_b<WF_LD>(sa + R_KS * WF_LD, mb, it.m1, it.qn, j.vec_b, j.b,
                     [&](int m, int c) {
                       return j.b + (size_t)m * j.Q + it.q0 + c;
                     });
    };
    auto tile = [&](auto w) {
      constexpr int W = decltype(w)::value;
      float acc[WF_NI][wf_nj<W>] = {};
      float bsum = 0.f;
      for (int q = 0; q < WF_STAGES - 1; ++q) {
        if (q < steps) stage(q);
        cp_async_commit();
      }
      for (int q = 0; q < steps; ++q) {
        float* sa = sm + (q % WF_STAGES) * WF_STAGE;
        const float* sb = sa + R_KS * WF_LD;
        cp_async_wait<WF_STAGES - 2>();  // this thread's pieces of step q
        if (j.lrelu) wf_lrelu(sa, g.slope);
        __syncthreads();  // step q is whole; step q - 1's stage is free
        if (q + WF_STAGES - 1 < steps) stage(q + WF_STAGES - 1);
        cp_async_commit();
        wf_fma<W, WF_UNROLL>(acc, sa, sb, ty, tx);
        if (bias) {
#pragma unroll 8
          for (int kk = 0; kk < R_KS; ++kk) bsum += sb[kk * WF_LD + tid];
        }
      }
      float* out = g.partial + it.split * g.total + j.out;
#pragma unroll
      for (int i = 0; i < WF_NI; ++i) {
        const int r = wf_row(ty, i);
        if (r >= it.pn) continue;
        const int p = it.p0 + r;
        float* row = out + (long long)(p + (j.bias >= 0 && p >= j.bias)) * j.Q;
#pragma unroll
        for (int jj = 0; jj < wf_nj<W>; ++jj) {
          const int c = wf_col<W>(tx, jj);
          if (c < it.qn) row[it.q0 + c] = acc[i][jj];
        }
      }
      if (bias && tid < it.qn) out[(long long)j.bias * j.Q + it.q0 + tid] = bsum;
    };
    using std::integral_constant;
    if (j.w == 16)
      tile(integral_constant<int, 16>{});
    else if (j.w == 96)
      tile(integral_constant<int, 96>{});
    else
      tile(integral_constant<int, 128>{});
    // the next item, published by the barrier, which also frees the ring;
    // two slots, so a claim never overwrites one still being read
    if (tid == 0) claimed[round & 1] = gridDim.x + atomicAdd(g.next, 1);
    __syncthreads();
    item = claimed[round & 1];
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

// fp32: (a1), (a2), (b), (c). As nin_head.cu's launchers, the FMA
// kernels' attributes are set, and the device's SM count read, on a
// device's first launch; their grids are min(tiles, SMs) and min(work items,
// WF_BLOCKS x SMs), persistent blocks.
int launch_f32(const RowsArgs& ra, const DxArgs& da, const WfArgs& ga, int S,
               float* dw, cudaStream_t stream) {
  static_assert(RW_SMEM <= SMEM_LIMIT && DX_SMEM <= SMEM_LIMIT,
                "fp32 K3 (a) exceeds a block's shared memory");
  static_assert(WF_BLOCKS * (WF_SMEM + 1024) <= 228 * 1024,
                "fp32 K3 (b)'s blocks exceed an SM's shared memory");
  static std::atomic<int> sms_of[MAX_DEVICES];  // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    const void* kernels[3] = {(const void*)bwd_rows_fma_kernel,
                              (const void*)bwd_dx_fma_kernel,
                              (const void*)wgrad_fma_kernel};
    const int smem[3] = {RW_SMEM, DX_SMEM, WF_SMEM};
    for (int i = 0; i < 3; ++i) {
      err = cudaFuncSetAttribute(kernels[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem[i]);
      if (err != cudaSuccess) return (int)err;
      err = cudaFuncSetAttribute(kernels[i],
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const int tiles = (int)(((long long)ra.M + R_TM - 1) / R_TM);
  const int grid = tiles < sms ? tiles : sms;
  bwd_rows_fma_kernel<<<grid, R_THREADS, RW_SMEM, stream>>>(ra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dx_fma_kernel<<<grid, R_THREADS, DX_SMEM, stream>>>(da);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int wgrid = ga.n_items < WF_BLOCKS * sms ? ga.n_items : WF_BLOCKS * sms;
  err = cudaMemsetAsync(ga.next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  wgrad_fma_kernel<<<wgrid, R_THREADS, WF_SMEM, stream>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_splits_kernel<<<(unsigned)((ga.total + THREADS - 1) / THREADS),
                         THREADS, 0, stream>>>(ga.partial, dw, ga.total, S);
  return (int)cudaGetLastError();
}

// Appends fp32 (b)'s product of A's `blocks` blocks of lda columns (a[i])
// and B (M x Q) to ga, out at `out` with B's column sums as row `bias` (or
// -1); its S x tiles work items follow the earlier products'.
void add_wf_job(WfArgs& ga, int S, const void* const* a, int blocks, int lda,
                const void* b, int Q, int lrelu, int bias, long long out) {
  auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  WfJob& j = ga.job[ga.n_jobs++];
  j.vec_a = lda % 4 == 0;
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    j.a[i] = static_cast<const float*>(a[i < blocks ? i : 0]);
    if (i < blocks) j.vec_a = j.vec_a && on16(a[i]);
  }
  j.b = static_cast<const float*>(b);
  j.lda = lda;
  j.P = blocks * lda;
  j.Q = Q;
  j.w = Q <= 16 ? 16 : Q <= 96 ? 96 : 128;
  j.tiles_p = (j.P + WF_TP - 1) / WF_TP;
  j.tiles_q = (Q + j.w - 1) / j.w;
  j.bias = bias;
  j.lrelu = lrelu;
  j.vec_b = Q % 4 == 0 && on16(b);
  j.out = out;
  j.item0 = ga.n_items;
  ga.n_items += S * j.tiles_p * j.tiles_q;
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
// of S * (number of dw elements) floats, in fp32 one more (a counter for
// (b)'s work items). S >= 1
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

  if (Na > R_MAX_KS * R_KS) return (int)cudaErrorInvalidValue;
  auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  float* wsf = static_cast<float*>(ws);
  RowsArgs ra;
  ra.h1 = static_cast<const float*>(h1);
  ra.wb = static_cast<const float*>(wb);
  ra.wbt = static_cast<const float*>(wbt);
  ra.bb = static_cast<const float*>(bb);
  ra.wc = static_cast<const float*>(wc);
  ra.g = static_cast<const float*>(g);
  ra.h2ws = wsf;
  ra.dpre2ws = wsf + (size_t)M * Nb;
  ra.dpre1ws = wsf + (size_t)M * 2 * Nb;
  ra.M = M; ra.Na = Na; ra.Nb = Nb; ra.Nc = Nc;
  ra.slope = slope;
  ra.vec_h1 = Na % 4 == 0 && on16(h1);
  ra.vec_wb = Nb % 4 == 0 && on16(wb);
  ra.vec_wbt = Na % 4 == 0 && on16(wbt);
  ra.vec_h2 = Nb % 4 == 0 && on16(ra.h2ws) && on16(ra.dpre2ws);
  ra.vec_d1 = Na % 4 == 0 && on16(ra.dpre1ws);
  DxArgs da;
  da.vec_wa = da.vec_x = C % 4 == 0;
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    da.x[i] = static_cast<const float*>(xs[i]);
    da.wat[i] = static_cast<const float*>(was[i]);
    da.dx[i] = static_cast<float*>(dxs[i]);
    if (i < k) {
      da.vec_wa = da.vec_wa && on16(was[i]);
      da.vec_x = da.vec_x && on16(xs[i]) && on16(dxs[i]);
    }
  }
  da.dpre1 = ra.dpre1ws;
  da.k = k; da.M = M; da.C = C; da.Na = Na;
  da.slope = slope;
  da.vec_d1 = ra.vec_d1;

  // (b): dWa_i = lrelu(x_i)^T dpre1 with dba, dWb = h1^T dpre2 with dbb,
  // dWc = h2^T g with dbc (g_lp is g itself in fp32)
  WfArgs ga;
  ga.n_jobs = ga.n_items = 0;
  // [dWa_0 | dba | dWa_1 ..]: dba is the row after C
  add_wf_job(ga, S, xs, k, C, ra.dpre1ws, Na, 1, C, 0);
  const void* h1s[1] = {h1};
  const void* h2s[1] = {ra.h2ws};
  add_wf_job(ga, S, h1s, 1, Na, ra.dpre2ws, Nb, 0, Na, dwb);
  add_wf_job(ga, S, h2s, 1, Nb, g, Nc, 0, Nb, dwc);
  ga.M = M;
  ga.chunk = ((long long)M + S - 1) / S;
  ga.total = dbc + Nc;
  ga.partial = static_cast<float*>(partial);
  ga.next = reinterpret_cast<int*>(ga.partial + S * ga.total);
  ga.slope = slope;
  return launch_f32(ra, da, ga, S, dwf, s);
}
