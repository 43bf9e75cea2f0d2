// Fused causal-up ("shifted") 3x3 conv + bias + LeakyReLU for Hopper (sm_90a).
//
// Replaces the TPU kernel ssdn_tpu/ops/pallas/shifted_conv.py ::
// shifted_conv3x3_bias_act (body `_kernel`): out = lrelu(conv3x3(x) + b) in
// the causal-up geometry (2 zero rows on top, none at the bottom, 1 zero
// column on each side), nine (pixels, Cin) x (Cin, Cout) tap products summed
// in fp32, bias and LeakyReLU applied in fp32, the result rounded ONCE to the
// output type.
//
// Layout: x is NHWC (N, H, W, Cin), bf16 or fp32; w is (3, 3, Cin, Cout)
// flattened to a (9*Cin, Cout) matrix in x's type, row k = (dh*3+dw)*Cin+ci;
// b is (Cout,) fp32; y is NHWC (N, H, W, Cout) in x's type.
//
// Design: an implicit GEMM with M = N*H*W output pixels, N = Cout and
// K = 9*Cin. Each block owns a tile of 64 pixels x 48 output channels; it
// walks K in slices of 32, gathering the input window into shared memory
// with the causal padding taken by bounds checks (no padded copy exists) and
// the channel loop bounds-checked (Cin may be 1 or 3), staging the matching
// weight slice beside it, and accumulating in fp32 registers with plain FMAs
// (8 pixels x 3 channels per thread). The epilogue adds the bias, applies
// LeakyReLU and rounds once. There is no size-based fallback: every shape
// the model produces, up to 768x512x96, runs here.
//
// What bounds it on the H100: at the model's shapes (Cin, Cout in 48..96)
// the work is ~2*9*Cin*Cout flops per pixel against 2*(Cin+Cout) bytes, far
// above the ~295 flop/byte ridge, so the bound is the tensor-core rate. This
// simple version does not reach it: it runs on the fp32 FMA pipes (67 TFLOP/s
// peak) and re-reads the input window once per tap from L1/L2. Left for
// later: bf16 tensor-core products (mma.sync / wgmma), TMA staging of a
// halo'd input tile that is reused by all nine taps, and a persistent,
// pipelined schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 48;   // output channels per block
constexpr int BK = 32;   // reduction slice of 9*Cin
constexpr int THREADS = 128;

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

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronise.
extern "C" int shifted_conv3x3_bias_act(const void* x, const void* w,
                                        const void* b, void* y, int n, int h,
                                        int w_, int cin, int cout, float slope,
                                        int is_bf16, void* stream) {
  const long long M = (long long)n * h * w_;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    shifted_conv3x3_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
        static_cast<__nv_bfloat16*>(y), n, h, w_, cin, cout, slope);
  } else {
    shifted_conv3x3_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), n, h, w_, cin,
        cout, slope);
  }
  return (int)cudaGetLastError();
}
