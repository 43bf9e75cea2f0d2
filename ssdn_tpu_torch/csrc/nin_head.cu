// Fused 1x1 combiner head, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ssdn_tpu/ops/pallas/nin_head.py :: _fwd_call
// (body `_make_fwd_kernel`), both variants: save_h1=False as called by
// fused_nin_head (inference: h1out is null and nothing extra is written)
// and save_h1=True as called by _head_fwd (training: the rounded h1 is
// also written to h1out, (M, Na) in x's type, for the backward kernel
// nin_head_bwd.cu). One kernel, one launch: only the h1 stores differ, so
// the two variants give the same `out` bits.
//
//   h1  = lrelu(sum_i lrelu(x_i) @ Wa_i + ba)   (M, Na)   rounded to x's type
//   h2  = lrelu(h1 @ Wb + bb)                   (M, Nb)   rounded to x's type
//   out = h2 @ Wc + bc                          (M, Nc)   fp32
//
// x_i are k <= 4 branch tensors (M, C) of dec1b PRE-activations (their
// LeakyReLU is applied here and rounded to x's type, as the TPU kernel
// does); the channel concat is never built: Wa is split into per-branch row
// blocks and the concat+matmul becomes a sum of matmuls. All products
// accumulate in fp32 and every LeakyReLU compares in fp32. Biases are fp32.
//
// What bounds it on the H100: 2*(k*C*Na + Na*Nb + Nb*Nc) flops per row
// (0.37 MFLOP at the model's k 4, C 96, Na 384, Nb 96, Nc 10: 0.58 TFLOP,
// 0.59 ms at 989 TFLOP/s, per batch-384 step) against k*C*2 + Nc*4 bytes
// in and, with save_h1, Na*2 bytes out per row in bf16 (2.48 GB per step,
// 0.74 ms at 3.35 TB/s): the h1 write makes the training variant
// bytes-bound, the inference variant is operations-bound.
//
// Two instantiations:
//  - bf16, the flagship's dtype, on the tensor cores (mma.sync m16n8k16,
//    bf16 in, fp32 accumulate; ldmatrix; cp.async; building blocks in
//    tc_bf16.cuh). Persistent blocks walk tiles of 16 rows per warp. Each
//    warp owns its 16 rows for the whole pipeline: it loads its rows of the
//    k branch tiles once (cp.async, LeakyReLU and the bf16 rounding applied
//    in shared memory), and for each chunk of NCH columns of Na
//      1. accumulates lrelu(x_i) @ Wa_i[:, chunk] over the k branches in
//         registers,
//      2. adds ba, applies LeakyReLU and rounds into its rows of a shared
//         h1 chunk (and writes them to h1out in 16-byte rows, training),
//      3. accumulates pre2 += h1_chunk @ Wb[chunk, :] into fp32 registers
//         that persist across chunks (Nb columns),
//    then forms h2 in its rows of shared memory and computes out = h2 Wc +
//    bc (Nc padded to 16). The full h1 tile is never resident and h2 never
//    leaves the warp. Only the weights are shared by the block: each
//    chunk's Wa_i[:, chunk] (all branches) and Wb[chunk, :] stream from L2
//    through a 2-stage cp.async ring, so one barrier per chunk is all the
//    block needs (the ring's); a warp's own rows need only __syncwarp.
//    The next tile's x rows are loaded while the last chunk's layers b
//    and c run. Widths are fixed at compile time for the model's 4 x 96 /
//    384 / 96 (the mma stream unrolls with no run-time guards); a generic
//    instantiation takes the other widths: C, Na, Nb multiples of 8, C <=
//    MAX_C_TC, Nb <= MAX_NB_TC, Nc <= 16, operands on 16-byte boundaries,
//    within one block's shared memory. Widths that are not multiples of 16
//    and ragged rows are zero in shared memory and masked on store.
//    Geometry: 8 warps (128-row tiles), 32-column chunks, a 2-stage ring,
//    one block per SM. The design's A/B (k2_probe.py rebuilds edited
//    copies: generic widths, a second barrier per chunk, two 4-warp blocks
//    per SM) lost on the H100 in every case (PERF.md section 6); what
//    bounds it is in section 7.
//  - fp32, the parity path, on the FMA pipes (TF32 would break the port's
//    fp32 bars): each block owns TM = 32 rows. It stages each branch's x
//    tile (after LeakyReLU) in shared memory, accumulates h1 in fp32
//    registers (each of 256 threads owns up to 2 of the Na columns for all
//    32 rows), writes the h1 tile to shared memory, computes h2
//    from it into shared memory (8 rows x 1 column per work item), and
//    writes only the fp32 output. Shared memory is TM*(C+Na+Nb) floats
//    (72 KB at the model's widths). A ragged last tile is masked.
//
// Left for later: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "tc_bf16.cuh"

using namespace ssdn_tc;

namespace {

constexpr int TM = 32;       // rows per block
constexpr int THREADS = 256;
constexpr int QA = 2;        // layer-a columns per thread: Na <= QA*THREADS
constexpr int MAX_BRANCHES = 4;

struct HeadArgs {
  const float* x[MAX_BRANCHES];
  const float* wa[MAX_BRANCHES];
  const float* ba;
  const float* wb;
  const float* bb;
  const float* wc;
  const float* bc;
  float* out;
  float* h1out;  // (M, Na), or null (inference)
  int k, M, C, Na, Nb, Nc;
  float slope;
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__global__ void __launch_bounds__(THREADS) nin_head_fwd_kernel(HeadArgs a) {
  // Tiles are stored column-major ([column][row]) so that one float4 read
  // gives four rows of a column: xs [C][TM], h1 [Na][TM], h2 [Nb][TM].
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // lrelu(x_i)
  float* h1 = xs + TM * a.C;
  float* h2 = h1 + TM * a.Na;

  const long long r0 = (long long)blockIdx.x * TM;
  const int rows = (int)min((long long)TM, (long long)a.M - r0);
  const int tid = threadIdx.x;

  // layer a: thread owns columns tid + q*THREADS for all TM rows
  float acc[QA][TM];
#pragma unroll
  for (int q = 0; q < QA; ++q)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[q][r] = 0.f;

  for (int br = 0; br < a.k; ++br) {
    const float* x = a.x[br];
    const float* wa = a.wa[br];
    __syncthreads();  // the previous branch's tile is no longer read
    for (int e = tid; e < TM * a.C; e += THREADS) {
      const int c = e / TM;
      const int r = e - c * TM;
      const float v = r < rows ? x[(r0 + r) * a.C + c] : 0.f;
      xs[e] = lrelu(v, a.slope);
    }
    __syncthreads();
    for (int c = 0; c < a.C; ++c) {
      const float4* xc = reinterpret_cast<const float4*>(xs + c * TM);
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        const int j = tid + q * THREADS;
        const float wv = j < a.Na ? wa[(long long)c * a.Na + j] : 0.f;
#pragma unroll
        for (int r4 = 0; r4 < TM / 4; ++r4) {
          const float4 v = xc[r4];
          acc[q][4 * r4 + 0] = fmaf(v.x, wv, acc[q][4 * r4 + 0]);
          acc[q][4 * r4 + 1] = fmaf(v.y, wv, acc[q][4 * r4 + 1]);
          acc[q][4 * r4 + 2] = fmaf(v.z, wv, acc[q][4 * r4 + 2]);
          acc[q][4 * r4 + 3] = fmaf(v.w, wv, acc[q][4 * r4 + 3]);
        }
      }
    }
  }
  float* h1out = a.h1out;
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    const int j = tid + q * THREADS;
    if (j < a.Na) {
      const float bj = a.ba[j];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float v = lrelu(acc[q][r] + bj, a.slope);
        h1[j * TM + r] = v;
        // consecutive threads write consecutive columns of one row
        if (h1out != nullptr && r < rows)
          h1out[(r0 + r) * a.Na + j] = v;
      }
    }
  }
  __syncthreads();

  // layer b: one work item = 8 rows x 1 column
  const float* wb = a.wb;
  for (int e = tid; e < (TM / 8) * a.Nb; e += THREADS) {
    const int rg = e / a.Nb;
    const int j = e - rg * a.Nb;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int c = 0; c < a.Na; ++c) {
      const float wv = wb[c * a.Nb + j];
      const float4* hc = reinterpret_cast<const float4*>(h1 + c * TM + rg * 8);
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
    const float bj = a.bb[j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h2[j * TM + rg * 8 + i] = lrelu(s[i] + bj, a.slope);
  }
  __syncthreads();

  // layer c: fp32 output, ragged rows masked
  const float* wc = a.wc;
  for (int e = tid; e < TM * a.Nc; e += THREADS) {
    const int j = e / TM;
    const int r = e - j * TM;
    if (r >= rows) continue;
    float s = 0.f;
    for (int c = 0; c < a.Nb; ++c)
      s = fmaf(h2[c * TM + r], wc[c * a.Nc + j], s);
    a.out[(r0 + r) * a.Nc + j] = s + a.bc[j];
  }
}

int launch_f32(const HeadArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * TM * (size_t)(a.C + a.Na + a.Nb);
  cudaError_t err = cudaFuncSetAttribute(
      nin_head_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a.M + TM - 1) / TM);
  nin_head_fwd_kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------- bf16 on the tensor cores ---------------------------

constexpr int SKEW = 8;          // bf16 added to every shared row (tc_bf16.cuh)
constexpr int MAX_C_TC = 256;    // input channels
constexpr int MAX_NB_TC = 128;   // pre2's columns, held in registers
constexpr int NC_TC = 16;        // out's columns, padded
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_DEVICES = 64;

// Block geometry (kernels/nin_head.py's k2_plan has the same numbers):
// TC_WARPS warps of RW rows each, TC_TM rows per tile, Na in chunks of NCH
// columns through a STAGES-deep weight ring, TC_MINB blocks per SM.
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int RW = 16;
constexpr int TC_TM = RW * TC_WARPS;
constexpr int NCH = 32;
constexpr int STAGES = 2;
constexpr int TC_MINB = 1;

// Shared memory, in bf16 elements: the x tiles (k x TC_TM rows, after
// LeakyReLU), the ring (STAGES x [Wa_i chunks, k x Cp rows | Wb chunk,
// NCH rows]), the warps' h1 chunk / h2 rows, and Wc (Nbp x 16), resident.
struct TcLayout {
  int x, ring, h, wc, stage, total;
  int ldx, ldw, ldb, ldh, ldc;
};

__host__ __device__ inline TcLayout tc_layout(int k, int Cp, int Nbp) {
  TcLayout s;
  s.ldx = Cp + SKEW;
  s.ldw = NCH + SKEW;
  s.ldb = Nbp + SKEW;
  s.ldh = (NCH > Nbp ? NCH : Nbp) + SKEW;
  s.ldc = NC_TC + SKEW;
  s.stage = k * Cp * s.ldw + NCH * s.ldb;
  s.x = 0;
  s.ring = s.x + k * TC_TM * s.ldx;
  s.h = s.ring + STAGES * s.stage;
  s.wc = s.h + TC_TM * s.ldh;
  s.total = s.wc + Nbp * s.ldc;
  return s;
}

__host__ __device__ constexpr int pad16(int v) { return (v + 15) / 16 * 16; }

struct TcArgs {
  const bf16* x[MAX_BRANCHES];
  const bf16* wa[MAX_BRANCHES];  // Wa_i as stored, (C, Na)
  const float* ba;
  const bf16* wb;
  const float* bb;
  const bf16* wc;
  const float* bc;
  float* out;
  bf16* h1out;  // (M, Na), or null (inference)
  int k, M, C, Na, Nb, Nc;
  float slope;
};

__device__ __forceinline__ unsigned lrelu_bf16x2(unsigned v, float slope) {
  const float2 f = unpack_bf16(v);
  return pack_bf16(lrelu(f.x, slope), lrelu(f.y, slope));
}

// FK, FC, FNA, FNB: the widths fixed at compile time, or 0 (read from the
// arguments). Persistent: block b walks tiles b, b + gridDim.x, ...
template <int FK, int FC, int FNA, int FNB>
__global__ void __launch_bounds__(TC_THREADS, TC_MINB)
head_fwd_tc_kernel(TcArgs a) {
  constexpr int NT1 = NCH / 8;                                 // layer a n-tiles
  constexpr int NT3 = (FNB ? pad16(FNB) : MAX_NB_TC) / 8;      // pre2 n-tiles
  constexpr bool FULL = FNA && FNA % NCH == 0;  // every chunk is whole
  extern __shared__ uint4 smem_tc[];
  bf16* sm = reinterpret_cast<bf16*>(smem_tc);
  const int k = FK ? FK : a.k, C = FC ? FC : a.C;
  const int Na = FNA ? FNA : a.Na, Nb = FNB ? FNB : a.Nb;
  const int Cp = pad16(C), Nap = pad16(Na), Nbp = pad16(Nb);
  const int cp8 = Cp / 8, nb8 = Nbp / 8;
  const TcLayout L = tc_layout(k, Cp, Nbp);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * RW;
  const int lr = lane >> 2, lc = 2 * (lane & 3);  // fragment row / column
  bf16* sX = sm + L.x;
  bf16* sRing = sm + L.ring;
  bf16* sH = sm + L.h + wr * L.ldh;  // this warp's RW rows
  bf16* sWc = sm + L.wc;
  const int nch = (Na + NCH - 1) / NCH;
  const int n_tiles = (a.M + TC_TM - 1) / TC_TM;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int steps = my_tiles * nch;

  // ring stage `stg` <- the weights of step s (chunk s % nch): Wa_i[:,
  // chunk] for every branch, then Wb[chunk, :]; zero past the widths
  auto load_stage = [&](int s, int stg) {
    const int j0 = (s % nch) * NCH;
    bf16* st = sRing + stg * L.stage;
    for (int e = tid; e < k * Cp * NT1; e += TC_THREADS) {
      const int row = e / NT1, c = (e - row * NT1) * 8;  // row = br Cp + r
      const int br = row / Cp, r = row - br * Cp;
      bf16* dst = st + row * L.ldw + c;
      if (r < C && j0 + c < Na)
        cp_async16(dst, a.wa[br] + (size_t)r * Na + j0 + c);
      else
        zero16(dst);
    }
    bf16* sb = st + k * Cp * L.ldw;
    for (int e = tid; e < NCH * nb8; e += TC_THREADS) {
      const int r = e / nb8, c = (e - r * nb8) * 8;
      bf16* dst = sb + r * L.ldb + c;
      if (j0 + r < Na && c < Nb)
        cp_async16(dst, a.wb + (size_t)(j0 + r) * Nb + c);
      else
        zero16(dst);
    }
  };
  // this warp's rows of the k branch tiles of `tile` (zero past M and C)
  auto load_x = [&](int tile) {
    const long long r0 = (long long)tile * TC_TM + wr;
    for (int e = lane; e < k * RW * cp8; e += 32) {
      const int row = e / cp8, c = (e - row * cp8) * 8;  // row = br RW + r
      const int br = row / RW, r = row - br * RW;
      bf16* dst = sX + (br * TC_TM + wr + r) * L.ldx + c;
      if (r0 + r < a.M && c < C)
        cp_async16(dst, a.x[br] + (size_t)(r0 + r) * C + c);
      else
        zero16(dst);
    }
  };

  for (int e = tid; e < Nbp * NC_TC; e += TC_THREADS) {
    const int r = e / NC_TC, c = e - r * NC_TC;
    sWc[r * L.ldc + c] = (r < Nb && c < a.Nc) ? a.wc[r * a.Nc + c]
                                              : __float2bfloat16_rn(0.f);
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  load_x(blockIdx.x);
  cp_async_commit();

  for (int it = 0; it < my_tiles; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const long long r0 = (long long)tile * TC_TM + wr;  // this warp's first row
    float pre[NT3][4] = {};
    for (int j = 0; j < nch; ++j) {
      const int s = it * nch + j;
      cp_async_wait<0>();  // step s's weights (at j 0 also the x rows)
      __syncthreads();     // ... for every thread; stage (s - 1) is free
      if (s + STAGES - 1 < steps)
        load_stage(s + STAGES - 1, (s + STAGES - 1) % STAGES);
      cp_async_commit();
      if (j == 0) {  // LeakyReLU and the bf16 rounding, in place
        for (int e = lane; e < k * RW * cp8; e += 32) {
          const int row = e / cp8, c = (e - row * cp8) * 8;
          uint4* p = reinterpret_cast<uint4*>(
              sX + ((row / RW) * TC_TM + wr + row % RW) * L.ldx + c);
          uint4 v = *p;
          v.x = lrelu_bf16x2(v.x, a.slope);
          v.y = lrelu_bf16x2(v.y, a.slope);
          v.z = lrelu_bf16x2(v.z, a.slope);
          v.w = lrelu_bf16x2(v.w, a.slope);
          *p = v;
        }
        __syncwarp();
      }
      const bf16* st = sRing + (s % STAGES) * L.stage;
      const int j0 = j * NCH;

      // ---- layer a: acc = sum_i lrelu(x_i) Wa_i[:, chunk] ----
      float acc[NT1][4] = {};
      for (int br = 0; br < k; ++br) {
        const bf16* xa = sX + (br * TC_TM + wr) * L.ldx;
        const bf16* wa = st + br * Cp * L.ldw;
#pragma unroll
        for (int kk = 0; kk < Cp; kk += 16) {
          unsigned af[4];
          ldsm_x4(af, xa + (lane & 15) * L.ldx + kk + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NT1 / 2; ++np) {
            unsigned b[4];  // Wa_i rows kk.., two n-tiles
            ldsm_x4_t(b, wa + (kk + (lane & 15)) * L.ldw + np * 16 +
                             (lane >> 4) * 8);
            mma_bf16(acc[2 * np], af, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
          }
        }
      }
      if (j == nch - 1) {  // the x rows are read: load the next tile's
        __syncwarp();
        if (it + 1 < my_tiles) load_x(tile + gridDim.x);
        cp_async_commit();
      }
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const int c = nt * 8 + lc;
        const bool in = FULL || j0 + c < Na;  // Na is a multiple of 8
        const float b0 = in ? a.ba[j0 + c] : 0.f;
        const float b1 = in ? a.ba[j0 + c + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<unsigned*>(sH + (lr + 8 * h) * L.ldh + c) =
              pack_bf16(lrelu(acc[nt][2 * h] + b0, a.slope),
                        lrelu(acc[nt][2 * h + 1] + b1, a.slope));
      }
      __syncwarp();  // this warp's h1 chunk is whole
      if (a.h1out != nullptr) {  // training: the rounded h1, 16-byte rows
        for (int e = lane; e < RW * NT1; e += 32) {
          const int r = e / NT1, c = (e - r * NT1) * 8;
          if (r0 + r < a.M && (FULL || j0 + c < Na))
            *reinterpret_cast<uint4*>(a.h1out + (size_t)(r0 + r) * Na + j0 +
                                      c) =
                *reinterpret_cast<const uint4*>(sH + r * L.ldh + c);
        }
      }

      // ---- layer b: pre2 += h1_chunk Wb[chunk, :] ----
      const bf16* wbc = st + k * Cp * L.ldw;
      const int kend = FULL ? NCH : min(NCH, Nap - j0);
#pragma unroll
      for (int kk = 0; kk < NCH; kk += 16) {
        if (kk >= kend) break;
        unsigned af[4];
        ldsm_x4(af, sH + (lane & 15) * L.ldh + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT3 / 2; ++np) {
          if (2 * np >= nb8) break;
          unsigned b[4];  // Wb rows j0 + kk.., two n-tiles
          ldsm_x4_t(b, wbc + (kk + (lane & 15)) * L.ldb + np * 16 +
                           (lane >> 4) * 8);
          mma_bf16(pre[2 * np], af, b[0], b[1]);
          mma_bf16(pre[2 * np + 1], af, b[2], b[3]);
        }
      }
      __syncwarp();  // the next chunk rewrites sH
    }

    // ---- h2 = lrelu(pre2 + bb), rounded, into this warp's rows ----
#pragma unroll
    for (int nt = 0; nt < NT3; ++nt) {
      if (nt >= nb8) break;
      const int c = nt * 8 + lc;
      const float b0 = c < Nb ? a.bb[c] : 0.f, b1 = c < Nb ? a.bb[c + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(sH + (lr + 8 * h) * L.ldh + c) =
            pack_bf16(lrelu(pre[nt][2 * h] + b0, a.slope),
                      lrelu(pre[nt][2 * h + 1] + b1, a.slope));
    }
    __syncwarp();

    // ---- out = h2 Wc + bc, fp32, ragged rows and columns masked ----
    float o[2][4] = {};
    for (int kk = 0; kk < Nbp; kk += 16) {
      unsigned af[4], b[4];
      ldsm_x4(af, sH + (lane & 15) * L.ldh + kk + (lane >> 4) * 8);
      ldsm_x4_t(b, sWc + (kk + (lane & 15)) * L.ldc + (lane >> 4) * 8);
      mma_bf16(o[0], af, b[0], b[1]);
      mma_bf16(o[1], af, b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lr + 8 * (i >> 1), c = nt * 8 + lc + (i & 1);
        if (r0 + r < a.M && c < a.Nc)
          a.out[(r0 + r) * a.Nc + c] = o[nt][i] + a.bc[c];
      }
    __syncwarp();  // the next tile's first chunk rewrites sH
  }
}

// The kernel's attributes are set, and the device's SM count read, on the
// first launch of an instantiation on a device; later launches reuse them.
template <int FK, int FC, int FNA, int FNB>
int launch_tc(const TcArgs& a, cudaStream_t stream) {
  const TcLayout L = tc_layout(a.k, pad16(a.C), pad16(a.Nb));
  const size_t smem = sizeof(bf16) * (size_t)L.total;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = head_fwd_tc_kernel<FK, FC, FNA, FNB>;
  static std::atomic<int> sms_of[MAX_DEVICES];  // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const int tiles = (a.M + TC_TM - 1) / TC_TM;
  const int grid = tiles < sms * TC_MINB ? tiles : sms * TC_MINB;
  kern<<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The model's widths run an instantiation with them fixed at compile time
// (the mma stream unrolls with no run-time guards); every other width runs
// the generic one.
int launch_bf16(const TcArgs& a, cudaStream_t stream) {
  if (a.C % 8 || a.Na % 8 || a.Nb % 8 || a.C > MAX_C_TC ||
      a.Nb > MAX_NB_TC || a.Nc > NC_TC)
    return (int)cudaErrorInvalidValue;
  const bool model = a.k == 4 && a.C == 96 && a.Na == 384 && a.Nb == 96;
  if (model) return launch_tc<4, 96, 384, 96>(a, stream);
  return launch_tc<0, 0, 0, 0>(a, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Unused branch
// pointers (index >= k) may be null, and so may h1 (inference: h1 is not
// written). bf16 (is_bf16 1): C, Na, Nb multiples of 8, C <= 256, Nb <=
// 128, Nc <= 16, x_i, Wa_i and Wb on 16-byte boundaries. fp32: Na <= 512.
// Launches on `stream`, no synchronise.
extern "C" int nin_head_fwd(const void* x0, const void* x1, const void* x2,
                            const void* x3, const void* wa0, const void* wa1,
                            const void* wa2, const void* wa3, const void* ba,
                            const void* wb, const void* bb, const void* wc,
                            const void* bc, void* out, void* h1, int k,
                            int M, int C,
                            int Na, int Nb, int Nc, float slope, int is_bf16,
                            void* stream) {
  if (k < 1 || k > MAX_BRANCHES || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* xs[MAX_BRANCHES] = {x0, x1, x2, x3};
  const void* was[MAX_BRANCHES] = {wa0, wa1, wa2, wa3};
  if (is_bf16) {
    TcArgs a;
    for (int i = 0; i < MAX_BRANCHES; ++i) {
      a.x[i] = static_cast<const bf16*>(xs[i]);
      a.wa[i] = static_cast<const bf16*>(was[i]);
    }
    a.ba = static_cast<const float*>(ba);
    a.wb = static_cast<const bf16*>(wb);
    a.bb = static_cast<const float*>(bb);
    a.wc = static_cast<const bf16*>(wc);
    a.bc = static_cast<const float*>(bc);
    a.out = static_cast<float*>(out);
    a.h1out = static_cast<bf16*>(h1);
    a.k = k; a.M = M; a.C = C; a.Na = Na; a.Nb = Nb; a.Nc = Nc;
    a.slope = slope;
    return launch_bf16(a, s);
  }
  if (Na > QA * THREADS) return (int)cudaErrorInvalidValue;
  HeadArgs a;
  for (int i = 0; i < MAX_BRANCHES; ++i) {
    a.x[i] = static_cast<const float*>(xs[i]);
    a.wa[i] = static_cast<const float*>(was[i]);
  }
  a.ba = static_cast<const float*>(ba);
  a.wb = static_cast<const float*>(wb);
  a.bb = static_cast<const float*>(bb);
  a.wc = static_cast<const float*>(wc);
  a.bc = static_cast<const float*>(bc);
  a.out = static_cast<float*>(out);
  a.h1out = static_cast<float*>(h1);
  a.k = k; a.M = M; a.C = C; a.Na = Na; a.Nb = Nb; a.Nc = Nc;
  a.slope = slope;
  return launch_f32(a, s);
}
