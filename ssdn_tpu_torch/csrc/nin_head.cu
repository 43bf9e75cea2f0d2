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
//  - fp32, the parity path and the fp32 zoo's serving path, on the FMA
//    pipes: true fp32 (a TF32 or 3xTF32 mma would break the port's fp32
//    bars). What bounds it: operations, 0.58 TFLOP per batch-384 step at
//    67 TFLOP/s, 8.7 ms (its bytes, 2.4 GB of x in and, training, 2.4 GB of
//    h1 out, take 1.4 ms). The design follows the bf16 one: persistent
//    blocks (one per SM, 256 threads) walk tiles of 128 rows; Na runs in
//    chunks of 128 columns and pre2 (128 x 96 per tile) stays in registers
//    across the chunks, so the full h1 tile is never resident. Per chunk:
//      1. layer a's K runs in slices of 32 input channels through a 2-stage
//         ring in shared memory (Wa_i[slice, chunk] by cp.async; the x
//         slice through registers, where its LeakyReLU and the transpose
//         to [channel][row] happen); the next step's slices load while this
//         one computes, one barrier per slice; Wb[chunk, :] lands beside
//         the first;
//      2. h1 = lrelu(acc + ba) into shared memory ([column][row]), and in
//         training to h1out in 16-byte row pieces;
//      3. pre2 += h1_chunk Wb[chunk, :];
//    then h2 = lrelu(pre2 + bb) into shared memory and out = h2 Wc + bc.
//    The weights cross L2 once per 128 rows: 9.1 GB per step, where the
//    first fp32 kernel's 32-row tiles, reading them inside the FMA loop,
//    took 36 GB. No FMA reads global memory: each thread holds register
//    micro-tiles (8 x 8 of the h1 chunk, 8 x 6 of pre2) and per K step
//    loads 4 floats of each operand with LDS.128 (h1: 64 FMAs per 16
//    floats read; pre2: 48 per 14). Widths are run-time and none is
//    refused: ragged M, C, Na, Nb and Nc are zero in shared memory and
//    masked on store; rows off 16-byte boundaries (C or Na not a multiple
//    of 4) move in 4-byte pieces; Nb over 96 runs in passes (layer a
//    recomputed per pass, out's partial sum carried in `out`), Nc over 16
//    in groups of 16. Every sum runs in the order of the first fp32
//    kernel (branches, then channels; then Na; then Nb), so the bits match
//    it.
//
// Left for later: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tc_bf16.cuh"

using namespace ssdn_tc;

namespace {

constexpr int MAX_BRANCHES = 4;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// --------------------------- bf16 on the tensor cores ---------------------------

constexpr int SKEW = 8;          // bf16 added to every shared row (tc_bf16.cuh)
constexpr int MAX_C_TC = 256;    // input channels
constexpr int MAX_NB_TC = 128;   // pre2's columns, held in registers
constexpr int NC_TC = 16;        // out's columns, padded
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_DEVICES = 64;

// Block geometry (this launcher's alone; the wrapper checks widths only):
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

// ----------------------------- fp32 on the FMA pipes -----------------------------

// Block geometry (this launcher's alone; the wrapper checks widths only): F_TM
// rows per tile, Na in chunks of F_NCH columns, the K of layer a in slices of
// F_KS input channels through a 2-stage ring, pre2 in passes of F_NBP
// columns, out in groups of F_NCG columns, one block per SM.
constexpr int F_TM = 128;
constexpr int F_NCH = 128;
constexpr int F_KS = 32;
constexpr int F_NBP = 96;
constexpr int F_NCG = 16;
constexpr int F_THREADS = 256;
constexpr int F_MINB = 1;
constexpr int F_LDT = F_TM + 4;  // [column][row] tiles: x slices, h1, h2
// Shared memory, in floats: the x slices (2 x F_KS x F_LDT, after
// LeakyReLU, [channel][row]), the Wa_i slices (2 x F_KS x F_NCH), the h1
// chunk, then h2 (F_NCH x F_LDT, [column][row]), Wb[chunk, pass] (F_NCH x
// F_NBP) and Wc[pass, group] (F_NBP x F_NCG).
constexpr int F_XS = F_KS * F_LDT;
constexpr int F_WS = F_KS * F_NCH;
constexpr int F_OFF_W = 2 * F_XS;
constexpr int F_OFF_H = F_OFF_W + 2 * F_WS;
constexpr int F_OFF_B = F_OFF_H + F_NCH * F_LDT;
constexpr int F_OFF_C = F_OFF_B + F_NCH * F_NBP;
constexpr int F_SMEM = 4 * (F_OFF_C + F_NBP * F_NCG);  // bytes
static_assert(F_SMEM <= SMEM_LIMIT, "fp32 K2 exceeds a block's shared memory");

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
  // 16-byte pieces: the width a multiple of 4 and the operands on 16-byte
  // boundaries (else 4-byte pieces)
  bool vec_x, vec_wa, vec_wb, vec_h1;
};

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

// A step of a block's walk: one slice of layer a's K (branch br, channels
// c0..) for one chunk of Na in one pass over Nb of one tile.
struct FmaStep {
  int tile, pass, chunk, br, c0;
};

// Thread (ty, tx) owns rows 4ty.. and 64 + 4ty.. of its tile (8) and, in
// layer a, columns 4tx.. and 64 + 4tx.. of the chunk (8), in layer b
// columns 4tx.. and 64 + 2tx.. of the pass (6): register micro-tiles, one
// outer product per K step from two LDS.128 of each operand (one LDS.128 and
// one LDS.64 of Wb). A quarter-warp shares ty and holds 8 consecutive tx, so
// every shared read is a broadcast or 128 contiguous bytes.
__global__ void __launch_bounds__(F_THREADS, F_MINB)
head_fwd_fma_kernel(HeadArgs a) {
  extern __shared__ float4 smem_f[];
  float* sm = reinterpret_cast<float*>(smem_f);
  float* sX = sm;
  float* sW = sm + F_OFF_W;
  float* sH = sm + F_OFF_H;
  float* sB = sm + F_OFF_B;
  float* sC = sm + F_OFF_C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int C = a.C, Na = a.Na, Nb = a.Nb, Nc = a.Nc;
  const int ks = a.k * ((C + F_KS - 1) / F_KS);  // slices per chunk
  const int nch = (Na + F_NCH - 1) / F_NCH;
  const int npass = (Nb + F_NBP - 1) / F_NBP;
  const int ngrp = (Nc + F_NCG - 1) / F_NCG;
  const bool wc_resident = npass == 1 && ngrp == 1;
  const int n_tiles = (a.M + F_TM - 1) / F_TM;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int steps = my_tiles * npass * nch * ks;

  // the step after st, in the order of the loops below (no divisions)
  auto advance = [&](FmaStep& st) {
    st.c0 += F_KS;
    if (st.c0 < C) return;
    st.c0 = 0;
    if (++st.br < a.k) return;
    st.br = 0;
    if (++st.chunk < nch) return;
    st.chunk = 0;
    if (++st.pass < npass) return;
    st.pass = 0;
    st.tile += gridDim.x;
  };
  // the x rows of a step, in registers: row tid / 2 of the tile, channels
  // c0 + 4 (tid % 2) + 8i .. + 3 of the slice's branch (a warp reads 16
  // rows x 32 bytes); zero past M and C
  float4 xv[4];
  auto load_x = [&](const FmaStep& st) {
    const long long r = (long long)st.tile * F_TM + (tid >> 1);
    const bool rin = r < a.M;
    const int cc = st.c0 + (tid & 1) * 4;
    const float* src = a.x[st.br] + (rin ? r * C + cc : 0);
    if (a.vec_x) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = rin && cc + 8 * i < C
                    ? __ldg(reinterpret_cast<const float4*>(src + 8 * i))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = rin && cc + 8 * i + e < C ? __ldg(src + 8 * i + e) : 0.f;
        xv[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // ... LeakyReLU, transposed into a [channel][row] slice: for each store a
  // warp's 32 lanes hit 32 distinct banks (16 rows; channels 4 apart, 16
  // banks apart at a stride of F_LDT)
  auto store_x = [&](float* dst) {
    float* d = dst + (tid & 1) * 4 * F_LDT + (tid >> 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[8 * i * F_LDT] = lrelu(xv[i].x, a.slope);
      d[(8 * i + 1) * F_LDT] = lrelu(xv[i].y, a.slope);
      d[(8 * i + 2) * F_LDT] = lrelu(xv[i].z, a.slope);
      d[(8 * i + 3) * F_LDT] = lrelu(xv[i].w, a.slope);
    }
  };
  // Wa_i rows c0 + tid / 32 + 8i (the slice), columns j0 + 4 (tid % 32)..
  // (the chunk); zero past C and Na
  auto load_wa = [&](const FmaStep& st, float* dst) {
    const int r = st.c0 + (tid >> 5), c = st.chunk * F_NCH + (tid & 31) * 4;
    const float* base = a.wa[st.br];
    const float* src = base + (r < C ? (size_t)r * Na + c : 0);
    const size_t step = 8 * (size_t)Na;
    float* d = dst + (tid >> 5) * F_NCH + (tid & 31) * 4;
    if (a.vec_wa) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = r + 8 * i < C && c < Na;
        cp_async16_or_zero(d + 8 * i * F_NCH, in ? src + i * step : base, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = r + 8 * i < C && c + e < Na;
          cp_async4_or_zero(d + 8 * i * F_NCH + e, in ? src + i * step + e : base,
                            in);
        }
    }
  };
  // Wb rows j0.. (the chunk), columns nb0.. (the pass); zero past Na, Nb
  auto load_wb = [&](int pass, int chunk) {
    const int j0 = chunk * F_NCH, nb0 = pass * F_NBP;
#pragma unroll
    for (int i = 0; i < F_NCH * F_NBP / 4 / F_THREADS; ++i) {
      const int e = tid + i * F_THREADS, r = e / (F_NBP / 4);
      const int c = (e - r * (F_NBP / 4)) * 4;
      const bool rin = j0 + r < Na;
      const float* src = a.wb + (rin ? (size_t)(j0 + r) * Nb + nb0 + c : 0);
      float* d = sB + r * F_NBP + c;
      if (a.vec_wb) {
        const bool in = rin && nb0 + c < Nb;
        cp_async16_or_zero(d, in ? src : a.wb, in);
      } else {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const bool in = rin && nb0 + c + e4 < Nb;
          cp_async4_or_zero(d + e4, in ? src + e4 : a.wb, in);
        }
      }
    }
  };
  // Wc rows nb0.. (the pass), columns n0.. (the group); zero past Nb, Nc
  auto load_wc = [&](int pass, int grp) {
    for (int e = tid; e < F_NBP * F_NCG; e += F_THREADS) {
      const int r = pass * F_NBP + e / F_NCG, c = grp * F_NCG + e % F_NCG;
      sC[e] = r < Nb && c < Nc ? a.wc[(size_t)r * Nc + c] : 0.f;
    }
  };

  if (wc_resident) load_wc(0, 0);
  FmaStep next = {(int)blockIdx.x, 0, 0, 0, 0};  // step 0, then s + 1
  load_x(next);
  load_wa(next, sW);
  advance(next);
  cp_async_commit();
  store_x(sX);
  cp_async_wait<0>();
  __syncthreads();

  int s = 0;  // the step whose x and Wa slices are in stage s % 2
  for (int it = 0; it < my_tiles; ++it) {
    const long long r0 = (long long)(blockIdx.x + it * gridDim.x) * F_TM;
    for (int pass = 0; pass < npass; ++pass) {
      float pre[8][6] = {};
      for (int chunk = 0; chunk < nch; ++chunk) {
        // ---- layer a: acc = sum_i lrelu(x_i) Wa_i[:, chunk] ----
        float acc[8][8] = {};
        load_wb(pass, chunk);  // waited for at the end of the first step
        for (int q = 0; q < ks; ++q, ++s) {
          const int cur = s & 1;
          const bool more = s + 1 < steps;
          if (more) {  // the next step's slices: x to registers, Wa async
            load_x(next);
            load_wa(next, sW + (cur ^ 1) * F_WS);
            advance(next);
          }
          cp_async_commit();
          const float* xa = sX + cur * F_XS + ty * 4;
          const float* wa = sW + cur * F_WS + tx * 4;
#pragma unroll 16
          for (int kk = 0; kk < F_KS; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(xa + kk * F_LDT);
            const float4 a1 =
                *reinterpret_cast<const float4*>(xa + kk * F_LDT + 64);
            const float4 b0 = *reinterpret_cast<const float4*>(wa + kk * F_NCH);
            const float4 b1 =
                *reinterpret_cast<const float4*>(wa + kk * F_NCH + 64);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
          if (more) store_x(sX + (cur ^ 1) * F_XS);
          cp_async_wait<0>();
          __syncthreads();  // stage s is free; stage s + 1 (and Wb) landed
        }

        // ---- h1 = lrelu(acc + ba) into sH, [column][row] ----
        const int j0 = chunk * F_NCH;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = (j < 4 ? 0 : 60) + tx * 4 + j;
          const float bj = j0 + c < Na ? a.ba[j0 + c] : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = lrelu(acc[i][j] + bj, a.slope);
          *reinterpret_cast<float4*>(sH + c * F_LDT + ty * 4) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          *reinterpret_cast<float4*>(sH + c * F_LDT + 64 + ty * 4) =
              make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
        }
        if (a.h1out != nullptr && pass == 0) {  // training: h1, row pieces
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const long long r = r0 + (i < 4 ? 0 : 60) + ty * 4 + i;
            if (r >= a.M) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = j0 + h * 64 + tx * 4;
              float* d = a.h1out + r * Na + c;
              if (a.vec_h1) {
                if (c < Na)
                  *reinterpret_cast<float4*>(d) =
                      make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                  acc[i][4 * h + 2], acc[i][4 * h + 3]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (c + e < Na) d[e] = acc[i][4 * h + e];
              }
            }
          }
        }
        __syncthreads();  // the h1 chunk is whole

        // ---- layer b: pre2 += h1_chunk Wb[chunk, pass] ----
        const float* ha = sH + ty * 4;
#pragma unroll 4
        for (int kk = 0; kk < F_NCH; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(ha + kk * F_LDT);
          const float4 a1 = *reinterpret_cast<const float4*>(ha + kk * F_LDT + 64);
          const float4 b0 =
              *reinterpret_cast<const float4*>(sB + kk * F_NBP + tx * 4);
          const float2 b1 =
              *reinterpret_cast<const float2*>(sB + kk * F_NBP + 64 + tx * 2);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[6] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) pre[i][j] = fmaf(av[i], bv[j], pre[i][j]);
        }
        __syncthreads();  // sH and sB are free
      }

      // ---- h2 = lrelu(pre2 + bb) into sH, [column][row] ----
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int c = j < 4 ? tx * 4 + j : 60 + tx * 2 + j;
        const int n = pass * F_NBP + c;
        const float bj = n < Nb ? a.bb[n] : 0.f;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = lrelu(pre[i][j] + bj, a.slope);
        *reinterpret_cast<float4*>(sH + c * F_LDT + ty * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(sH + c * F_LDT + 64 + ty * 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }

      // ---- out = h2 Wc + bc: lane's 4 rows x warp's 2 columns per group;
      // a pass after the first continues the sum it stored ----
      const long long rr = r0 + lane * 4;
      for (int grp = 0; grp < ngrp; ++grp) {
        if (!wc_resident) {
          if (grp > 0) __syncthreads();  // the last group's Wc is read
          load_wc(pass, grp);
        }
        __syncthreads();  // h2 (and Wc) in place
        const int c0 = grp * F_NCG + warp * 2;
        float o[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            o[i][c] = pass > 0 && rr + i < a.M && c0 + c < Nc
                          ? a.out[(rr + i) * Nc + c0 + c] : 0.f;
#pragma unroll 8
        for (int kk = 0; kk < F_NBP; ++kk) {
          const float4 h = *reinterpret_cast<const float4*>(sH + kk * F_LDT +
                                                            lane * 4);
          const float2 w =
              *reinterpret_cast<const float2*>(sC + kk * F_NCG + warp * 2);
          const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[i][0] = fmaf(hv[i], w.x, o[i][0]);
            o[i][1] = fmaf(hv[i], w.y, o[i][1]);
          }
        }
        const bool last = pass == npass - 1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (rr + i < a.M && c0 + c < Nc)
              a.out[(rr + i) * Nc + c0 + c] =
                  last ? o[i][c] + a.bc[c0 + c] : o[i][c];
      }
    }
  }
}

// As launch_tc: attributes set and the SM count read on a device's first
// launch; the grid is min(tiles, SMs x F_MINB), persistent blocks.
int launch_f32(const HeadArgs& a, cudaStream_t stream) {
  static std::atomic<int> sms_of[MAX_DEVICES];  // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaFuncSetAttribute(head_fwd_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(head_fwd_fma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const int tiles = (int)(((long long)a.M + F_TM - 1) / F_TM);
  const int grid = tiles < sms * F_MINB ? tiles : sms * F_MINB;
  head_fwd_fma_kernel<<<grid, F_THREADS, F_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Unused branch
// pointers (index >= k) may be null, and so may h1 (inference: h1 is not
// written). bf16 (is_bf16 1): C, Na, Nb multiples of 8, C <= 256, Nb <=
// 128, Nc <= 16, x_i, Wa_i and Wb on 16-byte boundaries. fp32: any widths.
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
  auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_x = C % 4 == 0;
  a.vec_wa = Na % 4 == 0;
  for (int i = 0; i < k; ++i) {
    a.vec_x = a.vec_x && on16(xs[i]);
    a.vec_wa = a.vec_wa && on16(was[i]);
  }
  a.vec_wb = Nb % 4 == 0 && on16(wb);
  a.vec_h1 = Na % 4 == 0 && on16(h1);
  return launch_f32(a, s);
}
