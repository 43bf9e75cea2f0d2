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
//  - bf16, the flagship's dtype, on Hopper's warpgroup MMA (wgmma, bf16 in,
//    fp32 accumulate) fed by the Tensor Memory Accelerator (TMA) through
//    mbarriers (hopper_sm90.cuh). Both launches run one persistent block
//    per SM and are warp-specialised: one warp keeps TMA loads in flight,
//    two consumer warpgroups of 64 rows each run wgmma and the epilogues.
//    (a) bwd_rows_tc_kernel, per tile of 128 rows (one warpgroup where two
//      do not fit shared memory: Na 512):
//      - per pass of 96 columns of Nb (one at the model's Nb 96): pre2 = h1
//        Wb: A h1's TMA boxes (128-byte swizzle), B Wb's 64-row chunks from
//        the ring, read MN-major; dh2 = g_lp Wc^T with g rounded to bf16
//        straight into A registers (the next tile's g loads during this
//        tile's dx_i) and B a window of Wc^T in 8 x 8 core matrices (96 x up
//        to 64 columns of Nc: all of it, written once, at the model's
//        widths; else rewritten per pass and per 64 columns of Nc);
//      - h2 and dpre2 from the accumulators; dpre2 stays in registers as
//        the A fragments of dh1 (an accumulator's n8 tiles 2i, 2i + 1 are
//        the A fragment of k16 step i); past one pass, dh1 reads each
//        pass's fragments back from this thread's own workspace stores;
//      - dh1 = dpre2 Wb^T per 64 columns of Na, K over Nb pass by pass, B
//        the same Wb chunks read K-major; dpre1 = mask(h1) dh1 stays in
//        registers as dx_i's A (96 registers at Na 384) and is written over
//        h1's boxes, which a second copying warp stores to the workspace
//        (TMA) and refills with the next tile's h1 while this tile's dx_i
//        run;
//      - dx_i = dpre1 Wa_i^T, B Wa_i's 96 x 64 chunks from the ring, the
//        branches in an order rotated by the block (the blocks read four
//        different chunks from L2 at a time, not one: 3.0 -> 2.3 ms), masked
//        by x_i and stored.
//      One ring of 10 slots of 12 KB carries Wb (twice) and the Wa_i; a
//      slot is released once the wgmma that read it is known complete. The
//      rows of h2, dpre2, x_i and dx_i move as 16-byte pieces after a
//      transpose within each quad of lanes (quad_t).
//    (b) wgrad_tc_kernel: items of 128 x 192, two warpgroups of m64 x n192
//      over a split's rows in 64-row stages through a 5-stage ring: dWa_i =
//      lrelu(x_i)^T dpre1 (A^T's fragments by ldmatrix.trans from x's
//      MN-major box, lrelu'd and rounded in registers; B dpre1's MN-major
//      box) and dWb^T = dpre2^T h1 (so dWb's items are dpre2's 96 columns
//      deep, not Na's 384), both per 128 rows of C or Nb; the small items:
//      dWc = h2^T g_lp per 128 rows of Nb, and dbc. Three warps sum dba's
//      and dbb's columns from the staged B and A. 130 blocks (a multiple of
//      the 10 items of one shape per split) take those items, each keeping
//      one place in every split, so that a split's items run side by side
//      and read their shared rows from L2 once (3.0 -> 2.7 ms at a step's
//      M, from items dealt round robin); the small ones follow on every
//      block. Rows per split are whole stages.
//    Masks and roundings run on the accumulator fragments; widths past C,
//    Na, Nb and Nc and rows past M are zeros (TMA fills them) and are
//    masked on store (TMA clips).
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
// Left for later: fusing (b)'s products into (a) and dropping the
// workspace; a ring per warpgroup, so that one's epilogues overlap the
// other's products. Sharing (a)'s weight chunks across a cluster of two
// blocks (TMA multicast) was measured and did not pay: halving their L2
// traffic left (a) at 2.21 ms. The ring depths, the branch rotation and the
// swizzles were measured on the H100 by k3_probe.py and edited copies of
// this file (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "hopper_sm90.cuh"
#include "tc_bf16.cuh"

using namespace ssdn_sm90;
using namespace ssdn_tc;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BRANCHES = 4;
constexpr int MAX_DEVICES = 64;


__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// --------------------------- fp32 (a) on the FMA pipes ---------------------------

// Geometry (this launcher's alone; the wrapper sizes buffers only): R_TM rows
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

// Geometry (this launcher's alone; the wrapper sizes buffers only): output
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

// ------------------ bf16 on the tensor cores: wgmma and TMA ------------------

// Geometry (this launcher's alone; the wrapper sizes buffers only). (a):
// a warpgroup's 64 rows per wgmma; pre2, dh2 and dpre2 in passes of TC_NB
// columns of Nb, one wgmma each; dx_i in passes of TC_CB columns of C; h1 /
// dpre1 in TMA boxes of 64 rows x TC_KB columns; one ring of RING_STAGES
// slots of RING_SLOT bytes carries, per tile, Wb in chunks of TC_KB rows x a
// pass's columns for pre2, again for dh1 (its chunks of TC_KB columns of Na,
// a chunk per pass), then the Wa_i in chunks of TC_CB rows x TC_KB columns.
// (b): items of WG_P rows (two warpgroups) x a product's columns, WG_KR rows
// of M per stage through a ring of WG_STAGES.
constexpr int TC_ROWS = 64;
constexpr int TC_NB = 96;
constexpr int TC_CB = 96;
constexpr int TC_KB = 64;
constexpr int TC_NCW = 64;  // columns of Nc in (a)'s window of Wc^T
constexpr int TC_BOX = TC_ROWS * TC_KB * 2;   // bytes of an h1 box: 8 KB
constexpr int WB_BOX = TC_KB * 32 * 2;        // bytes of a Wb box (64 x 32)
constexpr int RING_STAGES = 10;
constexpr int RING_SLOT = TC_CB * TC_KB * 2;  // bytes: a Wa_i chunk, 3 Wb boxes
constexpr int WG_KR = 64;
constexpr int WG_STAGES = 5;
constexpr int WG_P = 128;
constexpr int WG_A = WG_KR * 64 * 2;          // bytes of an A box (64 columns)
constexpr int WG_BC = 64;                     // columns of a B box (128-byte swizzle)
constexpr int WG_B = WG_KR * WG_BC * 2;       // bytes of a B box
constexpr int WG_QMAX = 192;                  // the widest product's columns
constexpr int WG_SLOT = 2 * WG_A + WG_QMAX / WG_BC * WG_B;  // 40 KB
constexpr int WG_THREADS = 384;  // (b): 2 warpgroups, a producer warp, 3 summing
constexpr int SMEM_LIMIT = 232448;

// (a)'s shared memory, in bytes from a 1024-byte boundary: the tile's h1 /
// dpre1 boxes (K block kb of warpgroup w at box kb nwg + w), the ring, a
// window of Wc^T in 8 x 8 core matrices (a pass's TC_NB rows x up to TC_NCW
// columns of Ncp: all of Wc^T at the model's widths), bb (Nb rounded up to
// whole passes), the mbarriers (h1, dpre1, and a full and an empty one per
// ring slot); `total` adds the 1024 bytes of alignment slack.
struct TcLayout {
  int h1, ring, wc, bb, bar, total;
};

__host__ __device__ inline TcLayout tc_layout(int Na, int Nb, int Ncp,
                                              int nwg) {
  const int nkb = (Na + TC_KB - 1) / TC_KB;
  const int nbp = (Nb + TC_NB - 1) / TC_NB * TC_NB;
  TcLayout L;
  L.h1 = 0;
  L.ring = L.h1 + nkb * nwg * TC_BOX;
  L.wc = L.ring + RING_STAGES * RING_SLOT;
  L.bb = L.wc + TC_NB * (Ncp < TC_NCW ? Ncp : TC_NCW) * 2;
  L.bar = L.bb + nbp * 4;
  L.total = L.bar + (2 + 2 * RING_STAGES) * 8 + 1024;
  return L;
}

// ------------------------- bf16 (a): rows on tensor cores -------------------------

struct TcRowArgs {
  CUtensorMap h1;              // load: (M, Na), boxes 64 x 64, 128-byte swizzle
  CUtensorMap dpre1;           // store: the workspace's dpre1, as h1
  CUtensorMap wb;              // load: (Na, Nb), boxes 64 x 32, 64-byte swizzle
  CUtensorMap wa[MAX_BRANCHES];  // load: (C, Na), boxes 96 x 64, 128-byte
  const bf16* x[MAX_BRANCHES];
  bf16* dx[MAX_BRANCHES];
  const float* g;
  const float* bb;
  const bf16* wc;
  bf16* h2ws;     // (M, Nb)
  bf16* dpre2ws;  // (M, Nb)
  bf16* gws;      // (M, Ncp): g rounded to bf16, zero past Nc
  int k, M, C, Na, Nb, Nc, Ncp;
  float slope;
};

// The quad's transpose: lane p of a quad holds v[t], the bf16 pair at
// columns 8 (j0 + t) + 2p of a row (t < 4, an accumulator's n8 tiles j0..);
// returns the 16 bytes of columns 8 (j0 + p) .. + 7, so that a row's 64
// bytes move in one 16-byte access per lane. Two exchanges, with the lanes
// 2 and then 1 apart. Its own inverse.
__device__ __forceinline__ uint4 quad_t(const unsigned (&v)[4]) {
  const int p = threadIdx.x & 3;
  const bool hi = p & 2, lo = p & 1;
  // 2 x 2 blocks of 2 x 2: the off-diagonal blocks swap with lane p ^ 2
  const unsigned a0 = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  const unsigned a1 = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  // this lane's words of tiles 2 hi, 2 hi + 1 at its columns (u*) and at
  // lane p ^ 2's (a*); within the blocks, swap with lane p ^ 1
  const unsigned u0 = hi ? v[2] : v[0], u1 = hi ? v[3] : v[1];
  const unsigned d0 = __shfl_xor_sync(0xffffffffu, lo ? u0 : u1, 1);
  const unsigned d1 = __shfl_xor_sync(0xffffffffu, lo ? a0 : a1, 1);
  const unsigned e0 = lo ? u1 : u0, e1 = lo ? a1 : a0;
  // word i is column pair i of tile p: own pairs p (e0), p ^ 2 (e1); lane
  // p ^ 1's pairs p ^ 1 (d0), p ^ 3 (d1)
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool own = (i & 1) == lo, near = ((i >> 1) & 1) == hi;
    w[i] = own ? (near ? e0 : e1) : (near ? d0 : d1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void quad_t(unsigned (&v)[4], uint4 u) {
  const unsigned in[4] = {u.x, u.y, u.z, u.w};
  const uint4 t = quad_t(in);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// Warp-specialised and persistent: block b walks the tiles b, b +
// gridDim.x, ... The NWG consumer warpgroups compute (warpgroup w: the
// tile's rows 64 w ..); the last warpgroup copies: its warp 0 keeps the
// ring full, its warp 1 stores each tile's dpre1 and then loads the next
// tile's h1 into the same boxes. MAXKB: h1's K blocks at most (Na <= 64
// MAXKB), the size of dpre1's A fragments, which dx_i reads from registers.
// WIDE: Wc^T is more than one window (Nb > TC_NB or Ncp > TC_NCW), so pre2,
// dh2 and dpre2 run in passes over Nb and the window is rewritten; without
// it, one pass and one window, fixed at compile time.
template <int MAXKB, int NWG, bool WIDE>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
bwd_rows_tc_kernel(const __grid_constant__ TcRowArgs a) {
  extern __shared__ unsigned char smem_rows_tc[];
  unsigned char* sm =
      smem_rows_tc + ((1024 - (smem_addr(smem_rows_tc) & 1023)) & 1023);
  const TcLayout L = tc_layout(a.Na, a.Nb, a.Ncp, NWG);
  unsigned char* sH = sm + L.h1;
  unsigned char* sRing = sm + L.ring;
  unsigned char* sWc = sm + L.wc;
  float* sBb = reinterpret_cast<float*>(sm + L.bb);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* bar_h1 = bar;           // the tile's h1 has landed
  uint64_t* bar_d1 = bar + 1;       // the tile's dpre1 is in sH (4 NWG warps)
  uint64_t* full = bar + 2;         // ring slot landed
  uint64_t* empty = full + RING_STAGES;  // ring slot read (4 NWG warps)
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int M = a.M, C = a.C, Na = a.Na, Nb = a.Nb, Nc = a.Nc;
  const int Ncp = a.Ncp;
  const int nkb = (Na + TC_KB - 1) / TC_KB, ncb = (C + TC_CB - 1) / TC_CB;
  const int npass = WIDE ? (Nb + TC_NB - 1) / TC_NB : 1;
  const int nbp = npass * TC_NB;
  constexpr int trows = TC_ROWS * NWG;
  const int tiles = (M + trows - 1) / trows;
  const float slope = a.slope;

  // The window of Wc^T: rows TC_NB pass .. and ncw columns from TC_NCW
  // chunk in core matrices, zero past Nb and Nc, written by threads t0, t0
  // + step, ... Where Wc^T is one window it is written once, here; else
  // (WIDE) the consumers rewrite it as dh2 moves on.
  const int ncw = WIDE ? min(Ncp, TC_NCW) : Ncp;
  auto fill_wc = [&](int pass, int chunk, int t0, int step) {
    for (int e = t0; e < TC_NB * ncw; e += step) {
      const int j = e / ncw, n = e - j * ncw;
      const int jb = TC_NB * pass + j, nc = TC_NCW * chunk + n;
      *reinterpret_cast<bf16*>(sWc + ((j >> 3) * (ncw >> 3) + (n >> 3)) * 128 +
                               (j & 7) * 16 + (n & 7) * 2) =
          jb < Nb && nc < Nc ? a.wc[jb * Nc + nc] : __float2bfloat16_rn(0.f);
    }
  };
  if (!WIDE) fill_wc(0, 0, tid, blockDim.x);
  // bb, and the ring zeroed (Wb's boxes past Nb are never loaded; dpre2's
  // columns there are zeros, and zeros times what a slot held before stay
  // zeros)
  for (int e = tid; e < nbp; e += blockDim.x) sBb[e] = e < Nb ? a.bb[e] : 0.f;
  for (int e = tid; e < RING_STAGES * RING_SLOT / 16; e += blockDim.x)
    zero16(sRing + e * 16);
  fence_async_shared();
  if (tid == 0) {
    mbar_init(bar_h1, 1);
    mbar_init(bar_d1, 4 * NWG);
    for (int i = 0; i < RING_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the copying warpgroup
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (l != 0 || warp > 4 * NWG + 1) return;
    auto load_h1 = [&](int tile) {
      mbar_expect(bar_h1, nkb * NWG * TC_BOX);
      for (int kb = 0; kb < nkb; ++kb)
        for (int g = 0; g < NWG; ++g)
          tma_load(sH + (kb * NWG + g) * TC_BOX, &a.h1, bar_h1, TC_KB * kb,
                   tile * trows + TC_ROWS * g);
    };
    if (warp == 4 * NWG) {  // the ring, per tile: Wb twice, then the Wa_i
      int q = 0;
      auto slot_for = [&](unsigned bytes) {  // the next slot, once it is free
        const int slot = q % RING_STAGES, n = q / RING_STAGES;
        if (n > 0) mbar_wait(&empty[slot], (n - 1) & 1);
        mbar_expect(&full[slot], bytes);
        ++q;
        return slot;
      };
      // Wb's rows TC_KB kc .. and pass p's columns (its 32-column boxes)
      auto load_wb = [&](int p, int kc) {
        const int njb = min(TC_NB, Nb - TC_NB * p + 31) / 32;
        const int slot = slot_for(njb * WB_BOX);
        for (int jb = 0; jb < njb; ++jb)
          tma_load(sRing + slot * RING_SLOT + jb * WB_BOX, &a.wb, &full[slot],
                   TC_NB * p + 32 * jb, TC_KB * kc);
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int p = 0; p < npass; ++p)  // pre2, pass by pass
          for (int kc = 0; kc < nkb; ++kc) load_wb(p, kc);
        for (int kc = 0; kc < nkb; ++kc)  // dh1, chunk by chunk
          for (int p = 0; p < npass; ++p) load_wb(p, kc);
        for (int br = 0; br < a.k; ++br)
          for (int cb = 0; cb < ncb; ++cb)
            for (int kc = 0; kc < nkb; ++kc) {
              const int slot = slot_for(RING_SLOT);
              tma_load(sRing + slot * RING_SLOT, &a.wa[(br + blockIdx.x) % a.k],
                       &full[slot], TC_KB * kc, TC_CB * cb);
            }
      }
    } else {  // h1 in, dpre1 out
      if ((int)blockIdx.x < tiles) load_h1(blockIdx.x);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        mbar_wait(bar_d1, it & 1);
        for (int kb = 0; kb < nkb; ++kb)
          for (int g = 0; g < NWG; ++g)
            if ((long long)tile * trows + TC_ROWS * g < M)
              tma_store(&a.dpre1, sH + (kb * NWG + g) * TC_BOX, TC_KB * kb,
                        tile * trows + TC_ROWS * g);
        tma_store_commit();
        tma_store_wait_read();
        if (tile + (int)gridDim.x < tiles) load_h1(tile + gridDim.x);
      }
    }
    return;
  }
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // the consumers: warpgroup wg; this thread's accumulator places: rows rw
  // and rw + 8 of the warpgroup's 64, columns 8 j + cl and + 1 of each n8
  // tile j
  const int wg = warp >> 2, w = warp & 3;
  const int rw = 16 * w + (l >> 2), cl = 2 * (l & 3), p4 = 8 * (l & 3);
  // g rounded to bf16 at the A fragment's places, K step s of a tile (the
  // first step of the next tile loads while this one's dx_i run)
  auto load_g = [&](unsigned (&gf)[4], int tile, int s) {
    const long long r0 = (long long)tile * trows + TC_ROWS * wg;
#pragma unroll
    for (int qh = 0; qh < 2; ++qh)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rw + 8 * h;
        const int n = 16 * s + 8 * qh + cl;
        const float* gp = a.g + row * Nc + n;
        const bool in = row < M;
        gf[2 * qh + h] = pack_bf16(in && n < Nc ? gp[0] : 0.f,
                                   in && n + 1 < Nc ? gp[1] : 0.f);
      }
  };
  unsigned gnext[4] = {0u, 0u, 0u, 0u};
  if ((int)blockIdx.x < tiles) load_g(gnext, blockIdx.x, 0);

  unsigned char* myH = sH + wg * TC_BOX;  // + kb NWG TC_BOX: K block kb
  int q = 0;                              // the next ring slot to read
  // a slot is released once the wgmma that read it is known complete
  auto release = [&](int slot_q) {
    __syncwarp();
    if (l == 0) mbar_arrive(&empty[slot_q % RING_STAGES]);
  };
  auto take = [&]() {  // the next slot, landed
    const int slot = q % RING_STAGES;
    mbar_wait(&full[slot], (q / RING_STAGES) & 1);
    return sRing + slot * RING_SLOT;
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const long long r0 = (long long)tile * trows + TC_ROWS * wg;
    const int next = tile + (int)gridDim.x;

    // ---- per pass of TC_NB columns of Nb: pre2 = h1 Wb (+ bb in the
    // epilogue), Wb's chunks from the ring; dh2 = g_lp Wc^T ----
    unsigned dfr[TC_NB / 16][4];
    mbar_wait(bar_h1, it & 1);
    for (int pass = 0; pass < npass; ++pass) {
      const int nb0 = TC_NB * pass;
      float P[TC_NB / 2], D[TC_NB / 2];
#pragma unroll
      for (int i = 0; i < TC_NB / 2; ++i) P[i] = D[i] = 0.f;
      fence_regs(P);
      for (int kc = 0; kc < nkb; ++kc, ++q) {
        const unsigned char* st = take();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_KB / 16; ++kk)
          wgmma_ss_n96<0, 1>(
              P, gmma_desc(myH + kc * NWG * TC_BOX + kk * 32, 16, 1024, SWZ_128),
              gmma_desc(st + kk * 1024, WB_BOX, 512, SWZ_64), 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (kc > 0) release(q - 1);
      }
      for (int s = 0; s < Ncp / 16; ++s) {
        if (WIDE && s % (TC_NCW / 16) == 0) {
          // every consumer's wgmma on the last window is complete
          named_sync(1, 128 * NWG);
          fill_wc(pass, s / (TC_NCW / 16), tid, 128 * NWG);
          fence_async_shared();
          named_sync(1, 128 * NWG);
        }
        unsigned gf[4];
        if (s == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) gf[i] = gnext[i];
        } else {
          load_g(gf, tile, s);
        }
        if (pass == 0) {
#pragma unroll
          for (int qh = 0; qh < 2; ++qh)
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // g_lp for (b)'s dWc
              const long long row = r0 + rw + 8 * h;
              if (row < M)
                *reinterpret_cast<unsigned*>(a.gws + row * Ncp + 16 * s +
                                             8 * qh + cl) = gf[2 * qh + h];
            }
        }
        fence_regs(gf);
        fence_regs(D);
        wgmma_fence();
        wgmma_rs_n96<0>(D, gf,
                        gmma_desc(sWc + s % (TC_NCW / 16) * 256, 128,
                                  ncw / 8 * 128, SWZ_NONE), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(D);
      }
      release(q - 1);  // pre2's last chunk
      fence_regs(P);

      // ---- h2 = lrelu(pre2), dpre2 = mask(pre2) dh2: stored, and kept as
      // the A fragments of dh1 (n8 tiles 2i, 2i + 1 are k16 step i) ----
#pragma unroll
      for (int j0 = 0; j0 < TC_NB / 8; j0 += 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned hw[4], dw[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = j0 + t, c = nb0 + 8 * j + cl;
            const float p0 = P[4 * j + 2 * h] + sBb[c];
            const float p1 = P[4 * j + 2 * h + 1] + sBb[c + 1];
            const float d0 = D[4 * j + 2 * h], d1 = D[4 * j + 2 * h + 1];
            dw[t] = pack_bf16(p0 >= 0.f ? d0 : slope * d0,
                              p1 >= 0.f ? d1 : slope * d1);
            hw[t] = pack_bf16(lrelu(p0, slope), lrelu(p1, slope));
            dfr[j >> 1][2 * (j & 1) + h] = dw[t];
          }
          const uint4 hq = quad_t(hw), dq = quad_t(dw);
          const long long row = r0 + rw + 8 * h;
          const int c = nb0 + 8 * j0 + p4;
          if (row < M && c < Nb) {
            *reinterpret_cast<uint4*>(a.h2ws + row * Nb + c) = hq;
            *reinterpret_cast<uint4*>(a.dpre2ws + row * Nb + c) = dq;
          }
        }
      }
    }

    // ---- dh1 = dpre2 Wb^T per chunk of TC_KB columns of Na, K over Nb
    // pass by pass (Wb's rows from the ring); dpre1 = mask(h1) dh1, kept as
    // dx_i's A fragments (K steps 4 c ..) and written over h1. WIDE: a
    // pass's dpre2 fragments come back from this thread's own stores above
    // (zero where it stored none), through the same transpose ----
    unsigned d1f[4 * MAXKB][4];
#pragma unroll
    for (int c = 0; c < MAXKB; ++c) {
      if (c >= nkb) break;
      float H[TC_KB / 2];
#pragma unroll
      for (int i = 0; i < TC_KB / 2; ++i) H[i] = 0.f;
      fence_regs(H);
      for (int pass = 0; pass < npass; ++pass) {
        if (WIDE) {
#pragma unroll
          for (int j0 = 0; j0 < TC_NB / 8; j0 += 4)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long row = r0 + rw + 8 * h;
              const int cb = TC_NB * pass + 8 * j0 + p4;
              unsigned dw[4];
              quad_t(dw, row < M && cb < Nb
                             ? *reinterpret_cast<const uint4*>(
                                   a.dpre2ws + row * Nb + cb)
                             : make_uint4(0u, 0u, 0u, 0u));
#pragma unroll
              for (int t = 0; t < 4; ++t)
                dfr[(j0 + t) >> 1][2 * ((j0 + t) & 1) + h] = dw[t];
            }
        }
        const unsigned char* st = take();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_NB / 16; ++kk)
          wgmma_rs_n64<0>(H, dfr[kk],
                          gmma_desc(st + (kk >> 1) * WB_BOX + (kk & 1) * 32,
                                    16, 512, SWZ_64), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(H);
        release(q++);
      }
      unsigned char* box = myH + c * NWG * TC_BOX;
#pragma unroll
      for (int j = 0; j < TC_KB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = H[4 * j + 2 * h], d1 = H[4 * j + 2 * h + 1];
          unsigned* hp = reinterpret_cast<unsigned*>(
              box + swz<128>(rw + 8 * h, 2 * (8 * j + cl)));
          const float2 hv = unpack_bf16(*hp);
          const unsigned v = pack_bf16(hv.x >= 0.f ? d0 : slope * d0,
                                       hv.y >= 0.f ? d1 : slope * d1);
          *hp = v;
          d1f[4 * c + (j >> 1)][2 * (j & 1) + h] = v;
        }
    }
    fence_async_shared();  // dpre1 -> the TMA store
    __syncwarp();
    if (l == 0) mbar_arrive(bar_d1);
    if (next < tiles) load_g(gnext, next, 0);

    // ---- dx_i = mask(x_i) (dpre1 Wa_i^T), per pass of TC_CB columns ----
    for (int br = 0; br < a.k; ++br) {
      // the branches in an order rotated by the block, so that the blocks
      // read four different Wa_i chunks from L2 at a time, not one
      const bf16* x = a.x[(br + blockIdx.x) % a.k];
      bf16* dx = a.dx[(br + blockIdx.x) % a.k];
      for (int cb = 0; cb < ncb; ++cb) {
        // x_i's 16-byte pieces, transposed in the quad at the epilogue
        uint4 xr[TC_CB / 32][2];
#pragma unroll
        for (int g4 = 0; g4 < TC_CB / 32; ++g4)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = r0 + rw + 8 * h;
            const int c = TC_CB * cb + 32 * g4 + p4;
            xr[g4][h] = row < M && c < C
                            ? *reinterpret_cast<const uint4*>(x + row * C + c)
                            : make_uint4(0u, 0u, 0u, 0u);
          }
        float X[TC_CB / 2];
#pragma unroll
        for (int i = 0; i < TC_CB / 2; ++i) X[i] = 0.f;
        fence_regs(X);
#pragma unroll
        for (int kc = 0; kc < MAXKB; ++kc) {
          if (kc >= nkb) break;
          const unsigned char* st = take();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TC_KB / 16; ++kk)
            wgmma_rs_n96<0>(X, d1f[4 * kc + kk],
                            gmma_desc(st + kk * 32, 16, 1024, SWZ_128), 1);
          wgmma_commit();
          wgmma_wait<1>();
          if (kc > 0) release(q - 1);
          ++q;
        }
        wgmma_wait<0>();
        fence_regs(X);
        release(q - 1);
#pragma unroll
        for (int g4 = 0; g4 < TC_CB / 32; ++g4)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned xv[4], v[4];
            quad_t(xv, xr[g4][h]);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int j = 4 * g4 + t;
              const float2 xf = unpack_bf16(xv[t]);
              const float d0 = X[4 * j + 2 * h], d1 = X[4 * j + 2 * h + 1];
              v[t] = pack_bf16(xf.x >= 0.f ? d0 : slope * d0,
                               xf.y >= 0.f ? d1 : slope * d1);
            }
            const uint4 u = quad_t(v);
            const long long row = r0 + rw + 8 * h;
            const int c = TC_CB * cb + 32 * g4 + p4;
            if (row < M && c < C)
              *reinterpret_cast<uint4*>(dx + row * C + c) = u;
          }
      }
    }
  }
}

// -------------------- bf16 (b): weight-grad partials on tensor cores --------------------

// Work items. Per split, E items of one shape (two warpgroups' 128 rows x
// 192 columns): the k products dWa_i = lrelu(x_i)^T dpre1 (row tiles of C,
// column tiles of Na) and dWb^T = dpre2^T h1 (row tiles of Nb, column tiles
// of Na); and the small ones: dWc = h2^T g_lp (row tiles of Nb, column tiles
// of 32 of Ncp) and dbc, the fp32 g's column sums. dba (dpre1's column
// sums: B's) rides on the items of dWa_0's row tile 0, dbb (dpre2's: A's)
// on dWb^T's items of column tile 0.
struct TcGradArgs {
  CUtensorMap x[MAX_BRANCHES];  // A: (M, C), boxes 64 x 64, 128-byte swizzle
  CUtensorMap dpre2, h2;        // A: (M, Nb), as x
  CUtensorMap dpre1, h1, glp;   // B: (M, Na), (M, Na), g_lp (M, Ncp), as x
  const float* gf;              // the fp32 g, (M, Nc)
  float* partial;               // [S][total]
  int k, M, C, Na, Nb, Nc, Ncp, S;
  int ge;                       // blocks that take the E items (the others,
                                // if any, take the small ones)
  long long chunk;              // rows per split: a multiple of WG_KR
  long long total;
  long long dba, dwb, dbb, dwc, dbc;  // offsets in the flat output
  float slope;
};

enum { JOB_DWA = 0, JOB_DWB = 1, JOB_DWC = 2, JOB_DBC = 3 };

struct TcItem {
  int job, br, pt, qt, split;
  int P, Q, QT;      // the product's rows and columns, the item's columns
  long long m0;      // the split's first row
  int nst;           // stages (WG_KR rows each)
  int bias;          // column sums riding on the item: 0, 1 of B, 2 of A
};

// E items per split, and the small ones
__host__ __device__ __forceinline__ int tc_e(const TcGradArgs& g) {
  const int qa = (g.Na + WG_QMAX - 1) / WG_QMAX;
  return (g.k * ((g.C + WG_P - 1) / WG_P) + (g.Nb + WG_P - 1) / WG_P) * qa;
}
__host__ __device__ __forceinline__ int tc_small(const TcGradArgs& g) {
  return (g.Ncp + 31) / 32 * ((g.Nb + WG_P - 1) / WG_P) + 1;
}

// item i of the E items (small: false) or of the small ones
__device__ __forceinline__ TcItem tc_item(const TcGradArgs& g, int i,
                                          bool small) {
  const int qa = (g.Na + WG_QMAX - 1) / WG_QMAX, pa = (g.C + WG_P - 1) / WG_P;
  const int per = small ? tc_small(g) : tc_e(g);
  TcItem it;
  it.split = i / per;
  int t = i - it.split * per;
  it.br = it.pt = it.qt = it.bias = 0;
  if (!small && t < g.k * pa * qa) {
    it.job = JOB_DWA;
    it.br = t / (pa * qa);
    t -= it.br * pa * qa;
    it.pt = t / qa;
    it.qt = t - it.pt * qa;
    it.P = g.C; it.Q = g.Na; it.QT = WG_QMAX;
    it.bias = it.br == 0 && it.pt == 0 ? 1 : 0;
  } else if (!small) {
    t -= g.k * pa * qa;
    it.job = JOB_DWB;
    it.pt = t / qa;
    it.qt = t - it.pt * qa;
    it.P = g.Nb; it.Q = g.Na; it.QT = WG_QMAX;
    it.bias = it.qt == 0 ? 2 : 0;
  } else if (t < per - 1) {
    const int qc = (g.Ncp + 31) / 32;
    it.job = JOB_DWC;
    it.pt = t / qc;
    it.qt = t - it.pt * qc;
    it.P = g.Nb; it.Q = g.Nc; it.QT = 32;
  } else {
    it.job = JOB_DBC;
    it.P = 0; it.Q = g.Nc; it.QT = 0;
  }
  it.m0 = it.split * g.chunk;
  const long long m1 = min((long long)g.M, it.m0 + g.chunk);
  it.nst = it.job == JOB_DBC || m1 <= it.m0
               ? 0 : (int)((m1 - it.m0 + WG_KR - 1) / WG_KR);
  return it;
}

// A block's items, in order: blocks b < g.ge take the E items b, b + g.ge,
// ... (E divides g.ge where a block is left over, so that a block keeps one
// place in every split and the items of a split run side by side, in step,
// reading their shared rows of A and B from L2 together); then every block
// takes the small items b, b + gridDim.x, ...
struct TcWalk {
  int i, small, n_e, n_s;
  __device__ TcWalk(const TcGradArgs& g) {
    n_e = tc_e(g) * g.S;
    n_s = tc_small(g) * g.S;
    small = (int)blockIdx.x >= g.ge;
    i = blockIdx.x;
    settle();
  }
  __device__ void settle() {
    if (!small && i >= n_e) {
      small = 1;
      i = blockIdx.x;
    }
  }
  __device__ bool valid() const { return small ? i < n_s : i < n_e; }
  __device__ void next(const TcGradArgs& g) {
    i += small ? (int)gridDim.x : g.ge;
    settle();
  }
};

// The column sums of the fp32 g over rows [m0, m1), by the 256 consumer
// threads: 16 row lanes x 16 columns, the lanes' sums added in lane order.
__device__ void colsum_g(const TcGradArgs& g, long long m0, long long m1,
                         float* out) {
  __shared__ float red[16][16];
  const int tid = threadIdx.x, rl = tid >> 4, cq = tid & 15;
  for (int q0 = 0; q0 < g.Nc; q0 += 16) {
    const int q = q0 + cq;
    float s = 0.f;
    if (q < g.Nc) {
#pragma unroll 8
      for (long long m = m0 + rl; m < m1; m += 16) s += g.gf[m * g.Nc + q];
    }
    red[rl][cq] = s;
    named_sync(1, 2 * 128);
    if (tid < 16 && q0 + tid < g.Nc) {
      float t = 0.f;
      for (int r = 0; r < 16; ++r) t += red[r][tid];
      out[q0 + tid] = t;
    }
    named_sync(1, 2 * 128);
  }
}

// Warp-specialised and persistent: each block walks its items (TcWalk).
// Warpgroups 0 and 1 compute an item's rows 64 w .. (A box w) against all
// its columns; warp 8's lane 0 keeps the ring full (TMA); warps 9-11 take
// the column sums that ride on the item. A stage is free once the 8
// consumer warps and the 3 summing warps have arrived on its `empty`
// barrier.
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tc_kernel(const __grid_constant__ TcGradArgs g) {
  extern __shared__ unsigned char smem_wgrad_tc[];
  unsigned char* sm =
      smem_wgrad_tc + ((1024 - (smem_addr(smem_wgrad_tc) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WG_STAGES * WG_SLOT);
  uint64_t* empty = full + WG_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < WG_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8 + 3);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (l != 0) return;
    long long q = 0;
    for (TcWalk wk(g); wk.valid(); wk.next(g)) {
      const TcItem it = tc_item(g, wk.i, wk.small);
      const CUtensorMap* ma = it.job == JOB_DWA ? &g.x[it.br]
                              : it.job == JOB_DWB ? &g.dpre2 : &g.h2;
      const CUtensorMap* mb = it.job == JOB_DWA ? &g.dpre1
                              : it.job == JOB_DWB ? &g.h1 : &g.glp;
      const int qend = it.job == JOB_DWC ? g.Ncp : it.Q;
      unsigned bytes = 0;
      for (int b = 0; b < 2; ++b)
        if (it.pt * WG_P + 64 * b < it.P) bytes += WG_A;
      for (int b = 0; b * WG_BC < it.QT; ++b)
        if (it.qt * it.QT + WG_BC * b < qend) bytes += WG_B;
      for (int s = 0; s < it.nst; ++s, ++q) {
        const int slot = (int)(q % WG_STAGES);
        const long long n = q / WG_STAGES;
        if (n > 0) mbar_wait(&empty[slot], (unsigned)((n - 1) & 1));
        unsigned char* st = sm + slot * WG_SLOT;
        const int m = (int)(it.m0 + (long long)s * WG_KR);
        mbar_expect(&full[slot], bytes);
        for (int b = 0; b < 2; ++b)
          if (it.pt * WG_P + 64 * b < it.P)
            tma_load(st + b * WG_A, ma, &full[slot], it.pt * WG_P + 64 * b, m);
        for (int b = 0; b * WG_BC < it.QT; ++b)
          if (it.qt * it.QT + WG_BC * b < qend)
            tma_load(st + 2 * WG_A + b * WG_B, mb, &full[slot],
                     it.qt * it.QT + WG_BC * b, m);
      }
    }
    return;
  }

  if (warp > 8) {  // column sums: columns 2c, 2c + 1 of the item's B (dba)
                   // or A (dbb: its row tile's), each in four partial sums
                   // (rows r % 4) added in order
    const int c = tid - 9 * 32, col = 2 * c;
    long long q = 0;
    for (TcWalk wk(g); wk.valid(); wk.next(g)) {
      const TcItem it = tc_item(g, wk.i, wk.small);
      float sum[2][4] = {};
      const int q0 = it.bias == 1 ? it.qt * it.QT : it.pt * WG_P;
      const bool on = it.bias == 1   ? col < it.QT && q0 + col < it.Q
                      : it.bias == 2 ? col < WG_P && q0 + col < it.P
                                     : false;
      for (int s = 0; s < it.nst; ++s, ++q) {
        const int slot = (int)(q % WG_STAGES);
        mbar_wait(&full[slot], (unsigned)((q / WG_STAGES) & 1));
        if (on) {
          const unsigned char* st = sm + slot * WG_SLOT;
#pragma unroll 4
          for (int r = 0; r < WG_KR; r += 4)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned off =
                  it.bias == 1
                      ? 2 * WG_A + col / WG_BC * WG_B +
                            swz<128>(r + i, 2 * (col % WG_BC))
                      : (col >> 6) * WG_A + swz<128>(r + i, 2 * (col & 63));
              const float2 v =
                  unpack_bf16(*reinterpret_cast<const unsigned*>(st + off));
              sum[0][i] += v.x;
              sum[1][i] += v.y;
            }
        }
        __syncwarp();
        if (l == 0) mbar_arrive(&empty[slot]);
      }
      if (on) {
        float* out = g.partial + it.split * g.total +
                     (it.bias == 1 ? g.dba : g.dbb) + q0 + col;
        out[0] = ((sum[0][0] + sum[0][1]) + sum[0][2]) + sum[0][3];
        out[1] = ((sum[1][0] + sum[1][1]) + sum[1][2]) + sum[1][3];
      }
    }
    return;
  }

  // the consumers: warpgroup wg, warp w of it
  const int wg = warp >> 2, w = warp & 3;
  long long q = 0;  // stages consumed
  for (TcWalk wk(g); wk.valid(); wk.next(g)) {
    const TcItem it = tc_item(g, wk.i, wk.small);
    float* out = g.partial + it.split * g.total;
    if (it.job == JOB_DBC) {
      colsum_g(g, it.m0, min((long long)g.M, it.m0 + g.chunk), out + g.dbc);
      continue;
    }
    const int p_base = it.pt * WG_P + 64 * wg;
    const bool on = p_base < it.P;  // this warpgroup's rows exist

    auto run = [&](auto nq) {
      constexpr int N = decltype(nq)::value;
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      // E items: A^T's fragments by ldmatrix.trans from the [m][p] box
      // (lrelu'd for dWa), two stages' worth
      unsigned af[2][WG_KR / 16][4];
      long long pending = -1;  // the stage whose slot is released next
      auto stage = [&](auto bufc) {
        constexpr int buf = decltype(bufc)::value;
        const int slot = (int)(q % WG_STAGES);
        const unsigned char* st = sm + slot * WG_SLOT;
        mbar_wait(&full[slot], (unsigned)((q / WG_STAGES) & 1));
        if (on) {
          if constexpr (N == WG_QMAX) {
            const unsigned char* box = st + wg * WG_A;
            const int mi = (l & 7) + ((l >> 4) & 1) * 8;
            const int pc = 16 * w + ((l >> 3) & 1) * 8;
#pragma unroll
            for (int kk = 0; kk < WG_KR / 16; ++kk) {
              ldsm_x4_t(af[buf][kk], reinterpret_cast<const bf16*>(
                                         box + swz<128>(16 * kk + mi, 2 * pc)));
              if (it.job == JOB_DWA) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float2 f = unpack_bf16(af[buf][kk][i]);
                  af[buf][kk][i] =
                      pack_bf16(lrelu(f.x, g.slope), lrelu(f.y, g.slope));
                }
              }
              fence_regs(af[buf][kk]);
            }
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WG_KR / 16; ++kk) {
            const uint64_t db =
                gmma_desc(st + 2 * WG_A + kk * 2048, WG_B, 1024, SWZ_128);
            if constexpr (N == WG_QMAX) {
              wgmma_rs_n192<1>(acc, af[buf][kk], db, 1);
            } else {
              const uint64_t da =
                  gmma_desc(st + wg * WG_A + kk * 2048, WG_A, 1024, SWZ_128);
              wgmma_ss_n32<1, 1>(acc, da, db, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage is read
        }
        if (pending >= 0) {
          __syncwarp();
          if (l == 0) mbar_arrive(&empty[pending % WG_STAGES]);
        }
        pending = q++;
      };
      using std::integral_constant;
      for (int s = 0; s < it.nst; s += 2) {
        stage(integral_constant<int, 0>{});
        if (s + 1 < it.nst) stage(integral_constant<int, 1>{});
      }
      if (on) wgmma_wait<0>();
      fence_regs(acc);
      if (pending >= 0) {
        __syncwarp();
        if (l == 0) mbar_arrive(&empty[pending % WG_STAGES]);
      }
      if (!on) return;
      // the item's rows p and columns qc: dWa_i at (p, qc) of its block,
      // dWb at (qc, p) (computed as dWb^T), dWc at (p, qc)
      const long long base =
          it.job == JOB_DWA
              ? (it.br == 0 ? 0 : g.dba + g.Na + (long long)(it.br - 1) * g.C * g.Na)
              : it.job == JOB_DWB ? g.dwb : g.dwc;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = p_base + 16 * w + (l >> 2) + 8 * h;
            const int qc = it.qt * it.QT + 8 * j + 2 * (l & 3) + e;
            if (p < it.P && qc < it.Q)
              out[base + (it.job == JOB_DWB ? (long long)qc * it.P + p
                                            : (long long)p * it.Q + qc)] =
                  acc[4 * j + 2 * h + e];
          }
    };
    if (it.job == JOB_DWC) run(std::integral_constant<int, 32>{});
    else run(std::integral_constant<int, WG_QMAX>{});
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

// bf16: (a), (b), (c). The TMA maps hold the operands' addresses; make_map
// keeps the maps it encoded, so a call on the buffers of an earlier call
// (a training step's, which the caching allocator hands out again) encodes
// none. As launch_f32, the kernels' attributes are set, and the device's SM
// count read, on a device's first launch. Grids: (a) min(tiles, SMs), (b)
// min(work items, SMs), persistent blocks.
int launch_tc(const void* const* xs, const void* const* was, const void* h1,
              const void* wb, const void* bb, const void* wc, const void* g,
              void* const* dxs, void* dw, void* ws, void* partial, int k,
              int M, int C, int Na, int Nb, int Nc, int S, float slope,
              cudaStream_t stream) {
  const int Ncp = (Nc + 15) / 16 * 16;
  bf16* w = static_cast<bf16*>(ws);
  bf16* h2ws = w;
  bf16* dpre2ws = w + (size_t)M * Nb;
  bf16* dpre1ws = w + (size_t)M * 2 * Nb;
  bf16* gws = w + (size_t)M * (2 * Nb + Na);
  const int nkb = (Na + TC_KB - 1) / TC_KB;
  const bool wide = Nb > TC_NB || Ncp > TC_NCW;
  const int nwg =
      !wide && nkb <= 6 && tc_layout(Na, Nb, Ncp, 2).total <= SMEM_LIMIT ? 2 : 1;
  const int smem_a = tc_layout(Na, Nb, Ncp, nwg).total;
  constexpr int smem_b = WG_STAGES * (WG_SLOT + 16) + 1024;
  static_assert(smem_b <= SMEM_LIMIT, "bf16 K3 (b) exceeds a block's shared memory");
  if (smem_a > SMEM_LIMIT || nkb > 8) return (int)cudaErrorInvalidValue;

  const CUtensorMapSwizzle s128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle s64 = CU_TENSOR_MAP_SWIZZLE_64B;
  TcRowArgs ra;
  TcGradArgs ga;
  bool ok = make_map(&ra.h1, h1, Na, M, 2 * Na, TC_KB, TC_ROWS, s128) &&
            make_map(&ra.dpre1, dpre1ws, Na, M, 2 * Na, TC_KB, TC_ROWS, s128) &&
            make_map(&ra.wb, wb, Nb, Na, 2 * Nb, 32, TC_KB, s64) &&
            make_map(&ga.dpre2, dpre2ws, Nb, M, 2 * Nb, 64, WG_KR, s128) &&
            make_map(&ga.h2, h2ws, Nb, M, 2 * Nb, 64, WG_KR, s128) &&
            make_map(&ga.dpre1, dpre1ws, Na, M, 2 * Na, WG_BC, WG_KR, s128) &&
            make_map(&ga.h1, h1, Na, M, 2 * Na, WG_BC, WG_KR, s128) &&
            make_map(&ga.glp, gws, Ncp, M, 2 * Ncp, WG_BC, WG_KR, s128);
  for (int i = 0; i < k && ok; ++i)
    ok = make_map(&ra.wa[i], was[i], Na, C, 2 * Na, TC_KB, TC_CB, s128) &&
         make_map(&ga.x[i], xs[i], C, M, 2 * C, 64, WG_KR, s128);
  if (!ok) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    ra.x[i] = static_cast<const bf16*>(xs[i]);
    ra.dx[i] = static_cast<bf16*>(dxs[i]);
  }
  ra.g = static_cast<const float*>(g);
  ra.bb = static_cast<const float*>(bb);
  ra.wc = static_cast<const bf16*>(wc);
  ra.h2ws = h2ws;
  ra.dpre2ws = dpre2ws;
  ra.gws = gws;
  ra.k = k; ra.M = M; ra.C = C; ra.Na = Na; ra.Nb = Nb; ra.Nc = Nc;
  ra.Ncp = Ncp;
  ra.slope = slope;

  // offsets in the flat output
  const long long dba = (long long)C * Na, dwb = (long long)k * C * Na + Na;
  const long long dbb = dwb + (long long)Na * Nb, dwc = dbb + Nb;
  const long long dbc = dwc + (long long)Nb * Nc;
  ga.gf = static_cast<const float*>(g);
  ga.partial = static_cast<float*>(partial);
  ga.k = k; ga.M = M; ga.C = C; ga.Na = Na; ga.Nb = Nb; ga.Nc = Nc;
  ga.Ncp = Ncp; ga.S = S;
  ga.chunk = ((long long)M + S - 1) / S;
  ga.chunk = (ga.chunk + WG_KR - 1) / WG_KR * WG_KR;
  ga.total = dbc + Nc;
  ga.dba = dba; ga.dwb = dwb; ga.dbb = dbb; ga.dwc = dwc; ga.dbc = dbc;
  ga.slope = slope;

  static std::atomic<int> sms_of[MAX_DEVICES];  // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    const void* kernels[4] = {(const void*)bwd_rows_tc_kernel<6, 2, false>,
                              (const void*)bwd_rows_tc_kernel<8, 1, false>,
                              (const void*)bwd_rows_tc_kernel<8, 1, true>,
                              (const void*)wgrad_tc_kernel};
    for (int i = 0; i < 4; ++i) {
      err = cudaFuncSetAttribute(kernels[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 i < 3 ? SMEM_LIMIT : smem_b);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  // two warpgroups at the model's widths; one, with every K block of h1
  // in registers (Na <= 512), elsewhere
  void (*rows)(TcRowArgs) = wide       ? bwd_rows_tc_kernel<8, 1, true>
                            : nwg == 2 ? bwd_rows_tc_kernel<6, 2, false>
                                       : bwd_rows_tc_kernel<8, 1, false>;
  const int tiles = (M + TC_ROWS * nwg - 1) / (TC_ROWS * nwg);
  rows<<<tiles < sms ? tiles : sms, 128 * (nwg + 1), smem_a, stream>>>(ra);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (b)'s items: E of one shape per split, and the small ones; the blocks
  // that take the E items are a multiple of E where a block is left over
  const int e_items = tc_e(ga);
  const int items = (e_items + tc_small(ga)) * S;
  const int wgrid = items < sms ? items : sms;
  ga.ge = wgrid > e_items ? (wgrid - 1) / e_items * e_items : wgrid;
  if (ga.ge > e_items * S) ga.ge = wgrid;
  wgrad_tc_kernel<<<wgrid, WG_THREADS, smem_b, stream>>>(ga);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_splits_kernel<<<(unsigned)((ga.total + THREADS - 1) / THREADS),
                         THREADS, 0, stream>>>(ga.partial,
                                               static_cast<float*>(dw),
                                               ga.total, S);
  return (int)cudaGetLastError();
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
    return launch_tc(xs, was, h1, wb, bb, wc, g, dxs, dw, ws, partial, k, M, C,
                     Na, Nb, Nc, S, slope, s);
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
