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
// fp32, the parity path (shifted_conv3x3_f32): w is (3, 3, Cin, Cout)
// flattened to a (9*Cin, Cout) matrix, row k = (dh*3+dw)*Cin+ci. An
// implicit GEMM with M = N*H*W output pixels, N = Cout and K = 9*Cin. Each
// block owns a tile of 64 pixels x 48 output channels; it walks K in slices
// of 32, gathering the input window into shared memory with the causal
// padding taken by bounds checks (no padded copy exists) and the channel
// loop bounds-checked (Cin may be 1 or 3), staging the matching weight
// slice beside it, and accumulating in fp32 registers with plain FMAs (8
// pixels x 3 channels per thread). The epilogue adds the bias, applies
// LeakyReLU and rounds once. It runs on the fp32 FMA pipes (67 TFLOP/s
// peak; TF32 would break the port's fp32 bars) and re-reads the input
// window once per tap from L1/L2.
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

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 48;   // output channels per block
constexpr int BK = 32;   // reduction slice of 9*Cin
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    shifted_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const float* __restrict__ bias, T* __restrict__ y,
                           int n_img, int H, int W, int Cin, int Cout,
                           float slope) {
  __shared__ float As[BK][BM + 1];  // +1: conflict-free column writes
  __shared__ float Bs[BK][BN];
  __shared__ int s_r[BM];
  __shared__ int s_c[BM];

  const long long M = (long long)n_img * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < M) {
      const int rc = (int)(m % ((long long)H * W));
      s_r[tid] = rc / W;
      s_c[tid] = rc % W;
    } else {
      s_r[tid] = -4;  // every tap row falls above the image: zeros
      s_c[tid] = 0;
    }
  }
  __syncthreads();

  const int K = 9 * Cin;
  const int tm = tid / 16;  // compute: pixels tm + 8*i
  const int tn = tid % 16;  // compute: channels tn + 16*j
  const int lk = tid % BK;  // gather: this thread's k within the slice
  const int lm = tid / BK;  // gather: pixels lm + 4*i

  float acc[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + lk;
    const bool kvalid = k < K;
    int dh = 0, dw = 0, ci = 0;
    if (kvalid) {
      const int tap = k / Cin;
      ci = k - tap * Cin;
      dh = tap / 3;
      dw = tap - dh * 3;
    }
#pragma unroll 4
    for (int i = 0; i < BM / 4; ++i) {
      const int p = lm + 4 * i;
      const int rr = s_r[p] - 2 + dh;  // rows r-2 .. r: never below the image
      const int cc = s_c[p] - 1 + dw;
      float v = 0.f;
      if (kvalid && rr >= 0 && cc >= 0 && cc < W) {
        const long long src = m0 + p + (long long)(dh - 2) * W + (dw - 1);
        v = to_f32(x[src * Cin + ci]);
      }
      As[lk][p] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int nn = e - kk * BN;
      const int kg = k0 + kk;
      const int co = n0 + nn;
      Bs[kk][nn] =
          (kg < K && co < Cout) ? to_f32(w[(long long)kg * Cout + co]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[3];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][tm + 8 * i];
#pragma unroll
      for (int j = 0; j < 3; ++j) b[j] = Bs[kk][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + tm + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int co = n0 + tn + 16 * j;
      if (co >= Cout) continue;
      float v = acc[i][j] + bias[co];
      v = v >= 0.f ? v : slope * v;
      y[m * Cout + co] = from_f32<T>(v);
    }
  }
}

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

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise. w: the (9*Cin, Cout) fp32 matrix.
extern "C" int shifted_conv3x3_f32(const void* x, const void* w, const void* b,
                                   void* y, int n, int h, int w_, int cin,
                                   int cout, float slope, void* stream) {
  const long long M = (long long)n * h * w_;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  shifted_conv3x3_kernel<float><<<grid, THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), n, h, w_, cin,
      cout, slope);
  return (int)cudaGetLastError();
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
