// Fused causal-up ("shifted") 3x3 conv + bias + LeakyReLU for Hopper (sm_90a).
//
// Replaces the TPU kernel ssdn_tpu/ops/pallas/shifted_conv.py ::
// shifted_conv3x3_bias_act (body `_kernel`): out = lrelu(conv3x3(x) + b) in
// the causal-up geometry (2 zero rows on top, none at the bottom, 1 zero
// column on each side), nine (pixels, Cin) x (Cin, Cout) tap products summed
// in fp32, bias and LeakyReLU applied in fp32, the result rounded ONCE to the
// output type.
//
// Layout: x is NHWC (N, H, W, Cin), bf16 or fp32; b is (Cout,) fp32; y is
// NHWC (N, H, W, Cout) in x's type. There is no size-based fallback: every
// shape the model produces, up to 768x512x144, runs here. Two kernels:
//
// fp32, the parity path (shifted_conv3x3_f32_halo, conv_fma_kernel), on the
// FMA pipes: true fp32 (a TF32 mma would break the port's fp32 bars). What
// bounds it on the H100: operations. At the model's widths the work is
// 2*9*Cin*Cout flops per pixel against 4*(Cin+Cout) bytes, far above the
// 20 flop/byte ridge of the 67 TFLOP/s FMA peak: 1.76 TFLOP per batch-384
// step (26.3 ms), 0.44 per 768x512 request (6.6 ms). So the design keeps
// the FMA pipes fed from registers and spends as few issue slots as it can
// on anything else:
//  - One block covers up to 96 output channels (256 threads of 8 pixels x
//    6 channels: 128 pixels x 96 for Cout > 48, 256 x 48 else), so the
//    input is read once per block, not once per 48-column block.
//  - A halo'd input tile is staged once for all nine taps by cp.async (16
//    bytes where Cin % 4 == 0 and x is aligned, else 4; channels padded
//    with zeros to cin4, a multiple of 4): an output tile of th rows x tw
//    columns (tw = min(W, 16), th = pixels / tw, nearly square, so the halo
//    costs 1.4x the tile at 8 x 16) takes rows r0-2 .. r0+th-1 and columns
//    c0-1 .. c0+tw. Rows count over the whole batch (global row = n*H + r),
//    so a tile may span images. Each pixel's slot holds its channels
//    contiguous, so one LDS.128 gives four k' rows of one pixel and the
//    tap's shift is a whole-slot offset: never misaligned, whatever dw.
//  - Each thread computes an 8 x 6 register micro-tile: per four k' rows 8
//    LDS.128 of pixels (broadcast within a quarter-warp) and 4 x (LDS.128 +
//    LDS.64) of weights feed 192 FMAs. A source outside its image (the
//    causal top rows, the edges, another image above) points at a zero row.
//  - The weights, packed by the wrapper into (column blocks, 9*cin4, cols)
//    zero-padded rows, stream in k' order through a 3-stage cp.async ring
//    of kr rows (one barrier per stage). Two blocks share an SM where the
//    tile allows (dec1b: 109,264 bytes), so one block's staging overlaps
//    the other's products.
//  - Every output is one ascending fmaf chain over k = (dh*3+dw)*Cin+ci
//    from +0.0, then + bias and LeakyReLU: the first fp32 kernel's order,
//    so the same bits (a padded channel adds fmaf(0, 0, acc) = acc; an
//    out-of-image tap fmaf(+0, w, acc) = acc, as its zero fill did).
//  - A Cin whose tile does not fit one block (Cin 256 and up; Cin 96-144
//    at W 1-5) is staged in passes of cc channels, re-staged per tap, tap
//    outer, so the chain keeps its order.
// Left for later: a persistent schedule that prefetches the next tile.
//
// bf16, on the tensor cores (shifted_conv3x3_bf16): mma.sync m16n8k16 (bf16
// in, fp32 accumulate), ldmatrix and cp.async (tc_bf16.cuh). What bounds it
// on the H100: at the model's widths (Cin, Cout 48..96) the work is
// 2*9*Cin*Cout flops per pixel against 2*(Cin+Cout) bytes, far above the
// ~295 flop/byte ridge, so the bound is the tensor-core rate (989 TFLOP/s);
// what the design does about it:
//  - One block covers up to 96 output channels (8 warps of 32 pixels x 48
//    channels: 4 x 2 warps and 128 pixels for Cout > 48, 8 x 1 and 256
//    pixels for Cout <= 48), so the input is read once per block, not once
//    per 48-column block.
//  - A halo'd input tile is staged once for all nine taps: for an output
//    tile of TH rows x TW columns (TW = min(W, 64), TH = pixels / TW),
//    rows r0-2 .. r0+TH-1 and columns c0-1 .. c0+TW, each pixel's channel
//    row padded to 16n+8 bf16 (ldmatrix rows 16-byte aligned, free of bank
//    conflicts). Rows count over the whole batch (global row = n*H + r), so
//    a tile may span images: small images fill a tile together.
//  - Each tap's A fragment is a shifted view of that tile: ldmatrix takes
//    one row address per lane, so each lane points at its pixel's source
//    for tap (dh, dw). A source outside its image (the causal top rows, the
//    left and right edges, another image above) or a pixel past the tile,
//    the rows or the width points at a shared zero row: the padding costs
//    no copy and the mma loop no branch.
//  - The weights, packed by the wrapper into (column blocks, passes, 9,
//    CC, COLS) zero-padded slices, stream tap by tap through a 2-stage
//    cp.async ring (one barrier per tap); the next tap's slice loads while
//    this one's products run. Two blocks share an SM, so one block's tile
//    staging overlaps the other's products.
//  - Cin is staged CC channels per pass: CC = Cin for the model's (Cin,
//    Cout) pairs (48, 48), (96, 96) and (48, 96) (one pass, every loop
//    bound a compile-time constant), else 16 (Cin <= 16), 48 (Cin a
//    multiple of 48) or 32, zero-padded in shared memory. Rows of Cin % 8
//    != 0 channels (enc0's 3, the gray models' 1, the naive decoder's 97
//    and 99) are staged with scalar loads, the others in 16-byte copies.
//  - Epilogue: bias + LeakyReLU on the fp32 fragments, one rounding to
//    bf16 (a negative value keeps its sign, -0.0 included: the backward's
//    mask is signbit(out)), rows staged in shared memory and written in
//    16-byte pieces. No atomics: the result is bitwise repeatable.
// The launch plan (instantiation, tile, passes, shared bytes) is chosen by
// kernels/shifted_conv.py :: k1_plan and passed in; the launch checks it
// and computes the shared bytes the same way. Left for later: wgmma/TMA, a
// persistent schedule, folding the nine taps into K for Cin <= 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tc_bf16.cuh"

namespace {

// --------------------------- bf16 on the tensor cores ---------------------------

using ssdn_tc::bf16;

// Block geometry (kernels/shifted_conv.py's k1_plan has the same numbers):
// TC_WARPS warps, each owning WARP_PX pixels (2 m16 tiles) x WARP_COLS
// output channels (6 n8 tiles); WN warps along the channels.
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int WARP_PX = 32;
constexpr int WARP_COLS = 48;
constexpr int MAX_TW = 64;
constexpr int SKEW = 8;            // bf16 added to every shared row
constexpr int STAGES = 2;          // the weight ring
constexpr int TC_MINB = 2;         // blocks per SM
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_DEVICES = 64;

struct ConvArgs {
  const bf16* x;   // (N*H*W, Cin)
  const bf16* w;   // (col_blocks, passes, 9, CC, COLS), zero-padded
  const float* b;  // (Cout,)
  bf16* y;         // (N*H*W, Cout)
  int NH, H, W, Cin, Cout;
  int tw, th, col_tiles, passes;
  int vec;         // x rows move in 16-byte copies
  float slope;
};

// Shared memory, in bf16 elements: the halo'd input tile ((th+2) x (tw+2)
// slots of CC channels; the epilogue's output rows, px x COLS, reuse it),
// the weight ring (STAGES x CC x COLS) and the zero row.
struct ConvLayout {
  int lda, ldb, ring, zero, total;
};

__host__ __device__ inline ConvLayout conv_layout(int cc, int cols, int px,
                                                  int tw, int th) {
  ConvLayout L;
  L.lda = cc + SKEW;
  L.ldb = cols + SKEW;
  const int tile = (th + 2) * (tw + 2) * L.lda, out = px * L.ldb;
  L.ring = tile > out ? tile : out;
  L.zero = L.ring + STAGES * cc * L.ldb;
  L.total = L.zero + L.lda;
  return L;
}

// CC: input channels per pass; WN: warps along the output channels (1: 48
// channels and 256 pixels per block, 2: 96 and 128).
template <int CC, int WN>
__global__ void __launch_bounds__(TC_THREADS, TC_MINB)
conv_tc_kernel(ConvArgs a) {
  using namespace ssdn_tc;
  constexpr int WM = TC_WARPS / WN;
  constexpr int PX = WM * WARP_PX;
  constexpr int COLS = WN * WARP_COLS;
  constexpr int G8 = CC / 8, N8 = COLS / 8;
  extern __shared__ uint4 smem_k1[];
  bf16* sm = reinterpret_cast<bf16*>(smem_k1);
  const int tw = a.tw, th = a.th, tw2 = tw + 2;
  const ConvLayout L = conv_layout(CC, COLS, PX, tw, th);
  bf16* sT = sm;
  bf16* sRing = sm + L.ring;
  bf16* sZero = sm + L.zero;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int rt = (int)blockIdx.x / a.col_tiles;
  const int R0 = rt * th, c0 = ((int)blockIdx.x - rt * a.col_tiles) * tw;
  const int n0 = (int)blockIdx.y * COLS;
  const bf16* wblk = a.w + (size_t)blockIdx.y * a.passes * 9 * CC * COLS;

  for (int e = tid; e < L.lda / 8; e += TC_THREADS) zero16(sZero + e * 8);

  // This lane's ldmatrix row in each of its 2 m16 tiles is pixel p of the
  // tile: the slot of its tap (0, 0) source, and a bit per tap (dh*3 + dw)
  // whose source lies in its image. A pixel past the tile, the rows or the
  // width has no bits: it reads the zero row.
  int a_slot[2];
  unsigned a_taps[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = wm * WARP_PX + mt * 16 + (lane & 15);
    const int pr = p / tw, pc = p - pr * tw;
    const int R = R0 + pr, c = c0 + pc;
    unsigned taps = 0;
    if (pr < th && R < a.NH && c < a.W) {
      const int r = R % a.H;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
          if (r - 2 + dh >= 0 && c - 1 + dw >= 0 && c - 1 + dw < a.W)
            taps |= 1u << (dh * 3 + dw);
    }
    a_slot[mt] = pr * tw2 + pc;
    a_taps[mt] = taps;
  }

  // the tile's channels [pass*CC, pass*CC + CC), zero past Cin; slots
  // outside the batch's rows or the width are never read and stay unset
  auto load_tile = [&](int pass) {
    const int slots = (th + 2) * tw2, ch0 = pass * CC;
    if (a.vec) {
      for (int e = tid; e < slots * G8; e += TC_THREADS) {
        const int s = e / G8, g = e - s * G8;
        const int sr = s / tw2, sc = s - sr * tw2;
        const int R = R0 - 2 + sr, c = c0 - 1 + sc;
        if (R < 0 || R >= a.NH || c < 0 || c >= a.W) continue;
        bf16* dst = sT + s * L.lda + g * 8;
        const int ch = ch0 + g * 8;  // Cin is a multiple of 8
        if (ch < a.Cin)
          cp_async16(dst, a.x + ((long long)R * a.W + c) * a.Cin + ch);
        else
          zero16(dst);
      }
    } else {
      for (int e = tid; e < slots * CC; e += TC_THREADS) {
        const int s = e / CC, k = e - s * CC;
        const int sr = s / tw2, sc = s - sr * tw2;
        const int R = R0 - 2 + sr, c = c0 - 1 + sc;
        if (R < 0 || R >= a.NH || c < 0 || c >= a.W) continue;
        const int ch = ch0 + k;
        sT[s * L.lda + k] =
            ch < a.Cin ? a.x[((long long)R * a.W + c) * a.Cin + ch]
                       : __float2bfloat16_rn(0.f);
      }
    }
  };
  // ring stage `stg` <- the packed (CC, COLS) weight slice of (pass, tap)
  auto load_w = [&](int pass, int tap, int stg) {
    const bf16* src = wblk + ((size_t)pass * 9 + tap) * CC * COLS;
    bf16* dst = sRing + stg * CC * L.ldb;
    for (int e = tid; e < CC * N8; e += TC_THREADS) {
      const int r = e / N8, c = (e - r * N8) * 8;
      cp_async16(dst + r * L.ldb + c, src + r * COLS + c);
    }
  };

  float acc[2][6][4] = {};
  for (int pass = 0; pass < a.passes; ++pass) {
    if (pass) __syncthreads();  // the last pass is done with tile and ring
    load_tile(pass);
    load_w(pass, 0, 0);
    cp_async_commit();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait<0>();  // this tap's weights (at tap 0 also the tile)
      __syncthreads();     // ... for every thread; the other stage is free
      if (tap < 8) load_w(pass, tap + 1, (tap + 1) % STAGES);
      cp_async_commit();
      const int dh = tap / 3, dw = tap % 3;
      const bf16* ap[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ap[mt] = ((a_taps[mt] >> tap) & 1u
                      ? sT + (a_slot[mt] + dh * tw2 + dw) * L.lda
                      : sZero) +
                 (lane >> 4) * 8;
      const bf16* bp = sRing + (tap % STAGES) * CC * L.ldb +
                       (lane & 15) * L.ldb + wn * WARP_COLS + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < CC / 16; ++ks) {
        unsigned af[2][4];
        ldsm_x4(af[0], ap[0] + ks * 16);
        ldsm_x4(af[1], ap[1] + ks * 16);
#pragma unroll
        for (int np = 0; np < 3; ++np) {
          unsigned b[4];  // weight rows ks*16.., two n-tiles
          ldsm_x4_t(b, bp + ks * 16 * L.ldb + np * 16);
          mma_bf16(acc[0][2 * np], af[0], b[0], b[1]);
          mma_bf16(acc[0][2 * np + 1], af[0], b[2], b[3]);
          mma_bf16(acc[1][2 * np], af[1], b[0], b[1]);
          mma_bf16(acc[1][2 * np + 1], af[1], b[2], b[3]);
        }
      }
    }
  }

  // epilogue: bias + LeakyReLU in fp32, one rounding, rows staged over the
  // tile, then written to y in 16-byte pieces
  __syncthreads();  // every warp is done with the tile
  bf16* sOut = sm;
  const int lr = lane >> 2, lc = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int col = wn * WARP_COLS + nt * 8 + lc;
    const float b0 = n0 + col < a.Cout ? a.b[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < a.Cout ? a.b[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = wm * WARP_PX + mt * 16 + lr + 8 * hh;
        float v0 = acc[mt][nt][2 * hh] + b0, v1 = acc[mt][nt][2 * hh + 1] + b1;
        v0 = v0 >= 0.f ? v0 : a.slope * v0;
        v1 = v1 >= 0.f ? v1 : a.slope * v1;
        *reinterpret_cast<unsigned*>(sOut + p * L.ldb + col) =
            pack_bf16(v0, v1);
      }
  }
  __syncthreads();
  const bool vec_out = a.Cout % 8 == 0;
  for (int e = tid; e < PX * N8; e += TC_THREADS) {
    const int p = e / N8, c8 = (e - p * N8) * 8;
    const int pr = p / tw, pc = p - pr * tw;
    const int R = R0 + pr, c = c0 + pc;
    if (pr >= th || R >= a.NH || c >= a.W || n0 + c8 >= a.Cout) continue;
    bf16* dst = a.y + ((long long)R * a.W + c) * a.Cout + n0 + c8;
    const bf16* src = sOut + p * L.ldb + c8;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && n0 + c8 + k < a.Cout; ++k) dst[k] = src[k];
    }
  }
}

template <int CC, int WN>
int launch_tc(const ConvArgs& a, int col_blocks, cudaStream_t stream) {
  constexpr int PX = TC_WARPS / WN * WARP_PX;
  const ConvLayout L = conv_layout(CC, WN * WARP_COLS, PX, a.tw, a.th);
  const size_t smem = (size_t)L.total * sizeof(bf16);
  if (a.tw < 1 || a.tw > MAX_TW || a.th < 1 || a.tw * a.th > PX ||
      smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = ((long long)a.NH + a.th - 1) / a.th;
  const long long tiles = row_tiles * a.col_tiles;
  if (tiles > 0x7fffffffLL || col_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  auto kern = conv_tc_kernel<CC, WN>;
  static std::atomic<int> ready[MAX_DEVICES];  // attributes set per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready[dev].store(1, std::memory_order_relaxed);
  }
  const dim3 grid((unsigned)tiles, (unsigned)col_blocks);
  kern<<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------- fp32 on the FMA pipes ---------------------------

// Block geometry (kernels/shifted_conv.py's k1_plan has the same numbers):
// F_THREADS threads, each owning F_PIX pixels x F_CH output channels; COLS
// (48 or 96) output channels per block, so COLS / F_CH threads along the
// channels and 8 * F_THREADS / (COLS / F_CH) pixels per block (256 or 128).
constexpr int F_THREADS = 256;
constexpr int F_MINB = 2;       // blocks per SM the registers are capped for
constexpr int F_PIX = 8;
constexpr int F_CH = 6;
constexpr int F_STAGES = 3;     // the weight ring
constexpr int F_MAX_TW = 16;    // tile columns

// 4-byte cp.async (rows of Cin % 4 != 0 floats, or x off 16 bytes)
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(ssdn_tc::smem_u32(smem)), "l"(gmem) : "memory");
}

struct F32Args {
  const float* x;  // (N*H*W, Cin)
  const float* w;  // (col_blocks, 9 * cin4, COLS), zero past Cin and Cout
  const float* b;  // (Cout,)
  float* y;        // (N*H*W, Cout)
  int NH, H, W, Cin, Cout;
  int cin4;        // Cin rounded up to 4: the k' rows of a tap
  int cc, passes;  // channels of the halo'd tile per pass, passes over cin4
  int ldc;         // floats per tile slot
  int kr, chunks;  // weight rows per ring stage; chunks of them per tile
  int tw, th, col_tiles;
  int vec_x, vec_y;  // x rows / y rows move in 16-byte pieces
  float slope;
};

// floats per tile slot: cc, made an odd multiple of 4 so that the eight
// slots a quarter-warp's LDS.128 can touch fall in distinct banks
__host__ __device__ inline int f32_ldc(int cc) {
  return cc % 8 == 0 ? cc + 4 : cc;
}

// Shared memory, in floats: the halo'd input tile ((th+2) x (tw+2) slots
// of ldc), the weight ring (F_STAGES x kr x cols) and the zero row (ldc).
struct F32Layout {
  int ring, zero, total;
};
__host__ __device__ inline F32Layout f32_layout(int cols, int tw, int th,
                                                int ldc, int kr) {
  F32Layout L;
  L.ring = (th + 2) * (tw + 2) * ldc;
  L.zero = L.ring + F_STAGES * kr * cols;
  L.total = L.zero + ldc;
  return L;
}

// The k' rows (k' = tap * cin4 + ci) over which the staged tile is fixed:
// with one pass, the single segment [0, 9 cin4); else segment s is
// (tap s / passes, pass s % passes): one pass's channels of one tap.
__host__ __device__ inline void f32_segment(const F32Args& a, int s,
                                            int& start, int& len) {
  if (a.passes == 1) {
    start = 0;
    len = 9 * a.cin4;
    return;
  }
  const int tap = s / a.passes, p = s - tap * a.passes;
  const int c = p * a.cc;
  start = tap * a.cin4 + c;
  len = a.cin4 - c < a.cc ? a.cin4 - c : a.cc;
}

// A ring stage: rows [row, row + kr) of segment seg (fewer at its end).
struct F32Chunk {
  int seg, row;
};

__device__ inline void f32_advance(const F32Args& a, F32Chunk& ck) {
  int start, len;
  f32_segment(a, ck.seg, start, len);
  ck.row += a.kr;
  if (ck.row >= len) {
    ++ck.seg;
    ck.row = 0;
  }
}

// Thread (ty, tx) owns pixels ty + TY i of the tile (i < 8) and output
// channels 4 tx .. 4 tx + 3 and C4 + 2 tx, C4 + 2 tx + 1 of the block's
// COLS (C4 = 4 TX): one outer product per k' row from the pixels' values
// (one LDS.128 of the tile gives a pixel's four k' rows) and two loads of
// the weight row (LDS.128 + LDS.64). A quarter-warp shares ty and
// holds 8 consecutive tx, so every shared read is a broadcast or 64-128
// contiguous bytes.
template <int COLS>
__global__ void __launch_bounds__(F_THREADS, F_MINB)
conv_fma_kernel(F32Args a) {
  constexpr int TX = COLS / F_CH;     // 8 or 16
  constexpr int TY = F_THREADS / TX;  // 32 or 16
  constexpr int C4 = 4 * TX;
  extern __shared__ float4 smem_f1[];
  float* sm = reinterpret_cast<float*>(smem_f1);
  const int tw = a.tw, th = a.th, tw2 = tw + 2, ldc = a.ldc;
  const F32Layout L = f32_layout(COLS, tw, th, ldc, a.kr);
  float* sT = sm;
  float* sRing = sm + L.ring;
  float* sZero = sm + L.zero;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane % TX, ty = warp * (32 / TX) + lane / TX;
  const int rt = (int)blockIdx.x / a.col_tiles;
  const int R0 = rt * th, c0 = ((int)blockIdx.x - rt * a.col_tiles) * tw;
  const int n0 = (int)blockIdx.y * COLS;
  const float* wblk = a.w + (size_t)blockIdx.y * 9 * a.cin4 * COLS;

  for (int e = tid; e < ldc; e += F_THREADS) sZero[e] = 0.f;

  // Pixel i: the slot of its tap (0, 0) source (low 16 bits) and a bit per
  // tap (dh*3 + dw, from bit 16) whose source lies in its image. A source
  // outside it (the causal top rows, the left and right edges, another
  // image above) or a pixel past the tile, the rows or the width reads the
  // zero row: an exact +0 product, as the first fp32 kernel's zero fill.
  unsigned pix[F_PIX];
#pragma unroll
  for (int i = 0; i < F_PIX; ++i) {
    const int p = ty + TY * i;
    const int pr = p / tw, pc = p - pr * tw;
    const int R = R0 + pr, c = c0 + pc;
    unsigned taps = 0;
    if (pr < th && R < a.NH && c < a.W) {
      const int r = R % a.H;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw)
          if (r - 2 + dh >= 0 && c - 1 + dw >= 0 && c - 1 + dw < a.W)
            taps |= 1u << (dh * 3 + dw);
    }
    pix[i] = (unsigned)(pr * tw2 + pc) | taps << 16;
  }

  // the tile's channels [pass cc, pass cc + cc) of rows R0-2 .. R0+th-1 and
  // columns c0-1 .. c0+tw, one warp per slot; channels past Cin (up to
  // cin4) are zero; slots outside the batch's rows or the width are never
  // read and stay unset
  auto stage_tile = [&](int pass) {
    const int ch0 = pass * a.cc;
    const int ccp = a.cin4 - ch0 < a.cc ? a.cin4 - ch0 : a.cc;
    const int slots = (th + 2) * tw2;
    for (int s = warp; s < slots; s += F_THREADS / 32) {
      const int sr = s / tw2, sc = s - sr * tw2;
      const int R = R0 - 2 + sr, c = c0 - 1 + sc;
      if (R < 0 || R >= a.NH || c < 0 || c >= a.W) continue;
      const float* src = a.x + ((long long)R * a.W + c) * a.Cin + ch0;
      float* dst = sT + s * ldc;
      if (a.vec_x) {
        for (int g = lane; g < ccp / 4; g += 32)
          ssdn_tc::cp_async16(dst + 4 * g, src + 4 * g);
      } else {
        for (int k = lane; k < ccp; k += 32) {
          if (ch0 + k < a.Cin)
            cp_async4(dst + k, src + k);
          else
            dst[k] = 0.f;
        }
      }
    }
  };
  // ring stage `stg` <- the chunk's weight rows, contiguous in the packed
  // (9 cin4, COLS) matrix of this column block
  auto load_w = [&](const F32Chunk& ck, int stg) {
    int start, len;
    f32_segment(a, ck.seg, start, len);
    const int rows = len - ck.row < a.kr ? len - ck.row : a.kr;
    const float* src = wblk + (size_t)(start + ck.row) * COLS;
    float* dst = sRing + stg * a.kr * COLS;
    for (int e = tid; e < rows * (COLS / 4); e += F_THREADS)
      ssdn_tc::cp_async16(dst + 4 * e, src + 4 * e);
  };

  float acc[F_PIX][F_CH];
#pragma unroll
  for (int i = 0; i < F_PIX; ++i)
#pragma unroll
    for (int j = 0; j < F_CH; ++j) acc[i][j] = 0.f;

  F32Chunk ld = {0, 0}, cur = {0, 0};
  if (a.passes == 1) stage_tile(0);
#pragma unroll
  for (int j = 0; j < F_STAGES - 1; ++j) {
    if (j < a.chunks) {
      load_w(ld, j);
      f32_advance(a, ld);
    }
    ssdn_tc::cp_async_commit();  // group j: chunk j (group 0: the tile too)
  }
  for (int q = 0; q < a.chunks; ++q) {
    ssdn_tc::cp_async_wait<F_STAGES - 2>();  // chunk q (and the tile)
    __syncthreads();  // ... for every thread; chunk q - 1's stage is free
    if (q + F_STAGES - 1 < a.chunks) {
      load_w(ld, (q + F_STAGES - 1) % F_STAGES);
      f32_advance(a, ld);
    }
    ssdn_tc::cp_async_commit();
    int start, len;
    f32_segment(a, cur.seg, start, len);
    const int ch0 = a.passes == 1 ? 0 : (cur.seg % a.passes) * a.cc;
    if (a.passes > 1 && cur.row == 0) {  // a new segment: its pass's tile
      stage_tile(cur.seg % a.passes);
      ssdn_tc::cp_async_commit();
      ssdn_tc::cp_async_wait<0>();
      __syncthreads();
    }
    int k = start + cur.row;
    const int kend = k + (len - cur.row < a.kr ? len - cur.row : a.kr);
    const float* wp = sRing + (q % F_STAGES) * a.kr * COLS;
    while (k < kend) {  // one tap at a time: rows k .. stop
      const int tap = k / a.cin4;
      const int stop = (tap + 1) * a.cin4 < kend ? (tap + 1) * a.cin4 : kend;
      const int dh = tap / 3, off = dh * tw2 + tap - dh * 3;
      const int ci = k - tap * a.cin4 - ch0;
      const float* ap[F_PIX];
#pragma unroll
      for (int i = 0; i < F_PIX; ++i)
        ap[i] = ((pix[i] >> (16 + tap)) & 1u
                     ? sT + ((int)(pix[i] & 0xffffu) + off) * ldc
                     : sZero) + ci;
#pragma unroll 2
      for (; k < stop; k += 4) {
        float4 av[F_PIX];
#pragma unroll
        for (int i = 0; i < F_PIX; ++i) {
          av[i] = *reinterpret_cast<const float4*>(ap[i]);
          ap[i] += 4;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(wp + kk * COLS + 4 * tx);
          const float2 b2 =
              *reinterpret_cast<const float2*>(wp + kk * COLS + C4 + 2 * tx);
          const float bv[F_CH] = {b4.x, b4.y, b4.z, b4.w, b2.x, b2.y};
#pragma unroll
          for (int i = 0; i < F_PIX; ++i) {
            const float xv = kk == 0   ? av[i].x
                             : kk == 1 ? av[i].y
                             : kk == 2 ? av[i].z
                                       : av[i].w;
#pragma unroll
            for (int j = 0; j < F_CH; ++j)
              acc[i][j] = fmaf(xv, bv[j], acc[i][j]);
          }
        }
        wp += 4 * COLS;
      }
    }
    f32_advance(a, cur);
  }

  // epilogue: bias + LeakyReLU, written straight from the registers (a
  // warp's store covers two pixels' 256 or 128 contiguous bytes)
  float bias[F_CH];
#pragma unroll
  for (int j = 0; j < F_CH; ++j) {
    const int co = n0 + (j < 4 ? 4 * tx + j : C4 + 2 * tx + j - 4);
    bias[j] = co < a.Cout ? a.b[co] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < F_PIX; ++i) {
    const int p = ty + TY * i;
    const int pr = p / tw, pc = p - pr * tw;
    const int R = R0 + pr, c = c0 + pc;
    if (pr >= th || R >= a.NH || c >= a.W) continue;
    float v[F_CH];
#pragma unroll
    for (int j = 0; j < F_CH; ++j) {
      const float t = acc[i][j] + bias[j];
      v[j] = t >= 0.f ? t : a.slope * t;
    }
    float* dst = a.y + ((long long)R * a.W + c) * a.Cout + n0;
    if (a.vec_y) {  // Cout % 4 == 0: each piece is in or out whole
      if (n0 + 4 * tx < a.Cout)
        *reinterpret_cast<float4*>(dst + 4 * tx) =
            make_float4(v[0], v[1], v[2], v[3]);
      if (n0 + C4 + 2 * tx < a.Cout)
        *reinterpret_cast<float2*>(dst + C4 + 2 * tx) = make_float2(v[4], v[5]);
    } else {
#pragma unroll
      for (int j = 0; j < F_CH; ++j) {
        const int co = j < 4 ? 4 * tx + j : C4 + 2 * tx + j - 4;
        if (n0 + co < a.Cout) dst[co] = v[j];
      }
    }
  }
}

// The launch's arguments from the plan, checked and completed as k1_plan
// computes them; false if the plan is not one the kernel takes. smem: the
// bytes of shared memory per block.
__host__ inline bool f32_args(F32Args& a, int n, int h, int w_, int cin,
                              int cout, int cols, int tw, int th, int cc,
                              int kr, size_t& smem) {
  const int px = F_PIX * F_THREADS / (cols / F_CH);
  if (n < 1 || h < 1 || w_ < 1 || cin < 1 || cout < 1 ||
      (cols != 48 && cols != 96) || tw < 1 || tw > F_MAX_TW || tw > w_ ||
      th < 1 || tw * th > px || kr < 4 || kr % 4 || cc < 4 || cc % 4)
    return false;
  a.NH = n * h; a.H = h; a.W = w_; a.Cin = cin; a.Cout = cout;
  a.cin4 = (cin + 3) / 4 * 4;
  if (cc > a.cin4) return false;
  a.cc = cc;
  a.passes = (a.cin4 + cc - 1) / cc;
  a.ldc = f32_ldc(cc);
  a.kr = kr;
  a.chunks = 0;  // per segment, ceil(its rows / kr)
  for (int sg = 0; sg < (a.passes == 1 ? 1 : 9 * a.passes); ++sg) {
    int start, len;
    f32_segment(a, sg, start, len);
    a.chunks += (len + kr - 1) / kr;
  }
  a.tw = tw; a.th = th;
  a.col_tiles = (w_ + tw - 1) / tw;
  smem = (size_t)f32_layout(cols, tw, th, a.ldc, kr).total * sizeof(float);
  return smem <= (size_t)SMEM_LIMIT;
}

template <int COLS>
int launch_f32(const F32Args& a, size_t smem, int col_blocks,
               cudaStream_t stream) {
  const long long row_tiles = ((long long)a.NH + a.th - 1) / a.th;
  const long long tiles = row_tiles * a.col_tiles;
  if (tiles > 0x7fffffffLL || col_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  auto kern = conv_fma_kernel<COLS>;
  static std::atomic<int> ready[MAX_DEVICES];  // attributes set per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready[dev].store(1, std::memory_order_relaxed);
  }
  const dim3 grid((unsigned)tiles, (unsigned)col_blocks);
  kern<<<grid, F_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 on the FMA pipes, with the plan of k1_plan: cols output channels
// per block (48 or 96), a tile of th x tw pixels, cc channels of the
// halo'd tile per pass, kr weight rows per ring stage. w: the packed
// (ceil(cout / cols), 9 * cin4, cols) weights (cin4: Cin rounded up to 4),
// zero past Cin in each tap and past Cout, on a 16-byte boundary. Returns
// the cudaError_t of the launch (0 on success); launches on `stream` and
// does not synchronise.
extern "C" int shifted_conv3x3_f32_halo(const void* x, const void* w,
                                        const void* b, void* y, int n, int h,
                                        int w_, int cin, int cout, int cols,
                                        int tw, int th, int cc, int kr,
                                        float slope, void* stream) {
  F32Args a;
  size_t smem = 0;
  if (!f32_args(a, n, h, w_, cin, cout, cols, tw, th, cc, kr, smem) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.y = static_cast<float*>(y);
  a.vec_x = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_y = cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  a.slope = slope;
  const int col_blocks = (cout + cols - 1) / cols;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cols == 48 ? launch_f32<48>(a, smem, col_blocks, s)
                    : launch_f32<96>(a, smem, col_blocks, s);
}

// bf16 on the tensor cores, with the plan of k1_plan: cc input channels per
// pass (16, 32, 48 or 96), wn warps along the output channels (1 or 2), a
// tile of th x tw pixels. w: the packed (ceil(cout / (48 wn)), ceil(cin /
// cc), 9, cc, 48 wn) weights, zero-padded, on a 16-byte boundary; y on a
// 16-byte boundary. Returns the cudaError_t of the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int shifted_conv3x3_bf16(const void* x, const void* w,
                                    const void* b, void* y, int n, int h,
                                    int w_, int cin, int cout, int cc, int wn,
                                    int tw, int th, float slope,
                                    void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || cin < 1 || cout < 1 || tw < 1 ||
      (wn != 1 && wn != 2) || (cc != 16 && cc != 32 && cc != 48 && cc != 96))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const float*>(b);
  a.y = static_cast<bf16*>(y);
  a.NH = n * h; a.H = h; a.W = w_; a.Cin = cin; a.Cout = cout;
  a.tw = tw; a.th = th;
  a.col_tiles = (w_ + tw - 1) / tw;
  a.passes = (cin + cc - 1) / cc;
  a.vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.slope = slope;
  const int col_blocks = (cout + 48 * wn - 1) / (48 * wn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cc * 10 + wn) {
    case 161: return launch_tc<16, 1>(a, col_blocks, s);
    case 162: return launch_tc<16, 2>(a, col_blocks, s);
    case 321: return launch_tc<32, 1>(a, col_blocks, s);
    case 322: return launch_tc<32, 2>(a, col_blocks, s);
    case 481: return launch_tc<48, 1>(a, col_blocks, s);
    case 482: return launch_tc<48, 2>(a, col_blocks, s);
    case 962: return launch_tc<96, 2>(a, col_blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
