// Fused 1x1 combiner head, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel ssdn_tpu/ops/pallas/nin_head.py :: _fwd_call
// (body `_make_fwd_kernel`), both variants: save_h1=False as called by
// fused_nin_head (inference: h1out is null and nothing extra is written)
// and save_h1=True as called by _head_fwd (training: the rounded h1 tile,
// already formed in shared memory, is also written to h1out, (M, Na) in
// x's type, for the backward kernel nin_head_bwd.cu):
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
// Design: each block owns TM = 32 rows. It stages each branch's x tile
// (after LeakyReLU) in shared memory, accumulates h1 in fp32 registers
// (each of 256 threads owns up to 2 of the Na columns for all 32 rows),
// writes the rounded h1 tile to shared memory, computes h2 from it into
// shared memory (8 rows x 1 column per work item), and writes only the
// fp32 output: h2 never reaches device memory, h1 only when the caller
// asks for it (training). Shared memory is
// TM*(C+Na+Nb) floats (72 KB at the model's 96/384/96), above 48 KB, so the
// launch raises the dynamic shared-memory limit. A ragged last tile (M not
// a multiple of TM) is masked.
//
// What bounds it on the H100: ~2*(4*96*384 + 384*96 + 96*n_out) flops per
// row against 4*96*2 + 4*n_out bytes in bf16: far above the ridge, so the
// bound is the tensor-core rate. This simple version runs on the fp32 FMA
// pipes and reads the weights from L1/L2 once per 32-row tile. Left for
// later: tensor-core products (mma.sync / wgmma) with the weights resident
// in shared memory across a persistent block, and larger row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;       // rows per block
constexpr int THREADS = 256;
constexpr int QA = 2;        // layer-a columns per thread: Na <= QA*THREADS
constexpr int MAX_BRANCHES = 4;

struct HeadArgs {
  const void* x[MAX_BRANCHES];
  const void* wa[MAX_BRANCHES];
  const float* ba;
  const void* wb;
  const float* bb;
  const void* wc;
  const float* bc;
  float* out;
  void* h1out;  // (M, Na) in T, or null (inference)
  int k, M, C, Na, Nb, Nc;
  float slope;
};

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
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) nin_head_fwd_kernel(HeadArgs a) {
  // Tiles are stored column-major ([column][row]) so that one float4 read
  // gives four rows of a column: xs [C][TM], h1 [Na][TM], h2 [Nb][TM].
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // lrelu(x_i), rounded to T
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
    const T* x = static_cast<const T*>(a.x[br]);
    const T* wa = static_cast<const T*>(a.wa[br]);
    __syncthreads();  // the previous branch's tile is no longer read
    for (int e = tid; e < TM * a.C; e += THREADS) {
      const int c = e / TM;
      const int r = e - c * TM;
      const float v = r < rows ? to_f32(x[(r0 + r) * a.C + c]) : 0.f;
      xs[e] = round_to<T>(lrelu(v, a.slope));
    }
    __syncthreads();
    for (int c = 0; c < a.C; ++c) {
      const float4* xc = reinterpret_cast<const float4*>(xs + c * TM);
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        const int j = tid + q * THREADS;
        const float wv = j < a.Na ? to_f32(wa[(long long)c * a.Na + j]) : 0.f;
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
  T* h1out = static_cast<T*>(a.h1out);
#pragma unroll
  for (int q = 0; q < QA; ++q) {
    const int j = tid + q * THREADS;
    if (j < a.Na) {
      const float bj = a.ba[j];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float v = round_to<T>(lrelu(acc[q][r] + bj, a.slope));
        h1[j * TM + r] = v;
        // consecutive threads write consecutive columns of one row
        if (h1out != nullptr && r < rows)
          h1out[(r0 + r) * a.Na + j] = from_f32<T>(v);
      }
    }
  }
  __syncthreads();

  // layer b: one work item = 8 rows x 1 column
  const T* wb = static_cast<const T*>(a.wb);
  for (int e = tid; e < (TM / 8) * a.Nb; e += THREADS) {
    const int rg = e / a.Nb;
    const int j = e - rg * a.Nb;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int c = 0; c < a.Na; ++c) {
      const float wv = to_f32(wb[c * a.Nb + j]);
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
      h2[j * TM + rg * 8 + i] = round_to<T>(lrelu(s[i] + bj, a.slope));
  }
  __syncthreads();

  // layer c: fp32 output, ragged rows masked
  const T* wc = static_cast<const T*>(a.wc);
  for (int e = tid; e < TM * a.Nc; e += THREADS) {
    const int j = e / TM;
    const int r = e - j * TM;
    if (r >= rows) continue;
    float s = 0.f;
    for (int c = 0; c < a.Nb; ++c)
      s = fmaf(h2[c * TM + r], to_f32(wc[c * a.Nc + j]), s);
    a.out[(r0 + r) * a.Nc + j] = s + a.bc[j];
  }
}

template <typename T>
int launch(const HeadArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * TM * (size_t)(a.C + a.Na + a.Nb);
  cudaError_t err = cudaFuncSetAttribute(
      nin_head_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((a.M + TM - 1) / TM);
  nin_head_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Unused branch
// pointers (index >= k) may be null, and so may h1 (inference: h1 is not
// written). Launches on `stream`, no synchronise.
extern "C" int nin_head_fwd(const void* x0, const void* x1, const void* x2,
                            const void* x3, const void* wa0, const void* wa1,
                            const void* wa2, const void* wa3, const void* ba,
                            const void* wb, const void* bb, const void* wc,
                            const void* bc, void* out, void* h1, int k,
                            int M, int C,
                            int Na, int Nb, int Nc, float slope, int is_bf16,
                            void* stream) {
  if (k < 1 || k > MAX_BRANCHES || Na > QA * THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  HeadArgs a;
  a.x[0] = x0; a.x[1] = x1; a.x[2] = x2; a.x[3] = x3;
  a.wa[0] = wa0; a.wa[1] = wa1; a.wa[2] = wa2; a.wa[3] = wa3;
  a.ba = static_cast<const float*>(ba);
  a.wb = wb;
  a.bb = static_cast<const float*>(bb);
  a.wc = wc;
  a.bc = static_cast<const float*>(bc);
  a.out = static_cast<float*>(out);
  a.h1out = h1;
  a.k = k; a.M = M; a.C = C; a.Na = Na; a.Nb = Nb; a.Nc = Nc;
  a.slope = slope;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
