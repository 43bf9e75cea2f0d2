// The epilogue of a bf16 trunk conv, forward and backward, for Hopper
// (sm_90a): bias + LeakyReLU, the row crop of a conv run with cuDNN's own
// symmetric padding, and dec1b's blind-spot shift, in one pass each way.
//
// Replaces no TPU kernel. The JAX package leaves this to XLA, which fuses
// the bias add, the row mask and LeakyReLU into the conv's output. Eager
// PyTorch ran each as a pass of its own over a full activation (the pad's
// copy, the bias add, the mask multiply, LeakyReLU's compare, multiply and
// select; autograd as many again), which made them the largest share of a
// bf16 training step's device time. Called by
// kernels/conv_epilogue.py, for the convs of ops.shifted.conv2d that end in
// an activation or the shift, and for the fused decoder's up + skip sum.
//
// Layout: channels_last, (N, rows, W, C) bf16, so each image is one block
// of rows * W * C contiguous elements. c has Hc rows an image, out and g H.
//
//   forward   out[n, r] = act(bf16(c[n, r - shift] + bf16(b)))   r >= shift
//             out[n, r] = act(bf16(bf16(0 + bf16(b)) * 0))         r <  shift
//   backward  dpre[n, r - shift] = act'(out[n, r], g[n, r])        r >= shift
//             dpre[n, r] = 0                                       r >= H - shift
//
//   act(y)       = y >= 0 ? y : bf16(y * slope)
//   act'(o, g)   = o >= 0 ? g : bf16(g * slope)
//
// Rows [H - shift, Hc) of c are not read: that is the crop. The sums and
// products are the torch ops' (ops.shifted.conv2d's bias add and row mask,
// ops.leaky_relu), in fp32 and rounded to bf16 where they round, so the
// output has their bits given the same c. The backward reads out, not a
// saved mask: for a positive slope out >= 0 exactly where the forward's
// input was, except where y * slope of a negative y below 2^-130 rounds
// to -0 (there act' takes g where autograd's where takes bf16(g * slope)).
//
// What bounds it on the H100: bytes. The forward reads H - shift rows of c
// and writes H rows of out; the backward reads H - shift rows of g and out
// and writes Hc rows of dpre: 2 bytes an element each, nothing else (at a
// batch-384 step, 12 convs of 1536 images, 18.0 GB both ways: 5.4 ms at
// 3.35 TB/s). So the design spends nothing but the stream:
//  - 16-byte accesses: 8 channels a thread (VEC). The launcher refuses
//    C % 8 != 0 and operands off a 16-byte boundary, so no narrower path
//    can run unseen; the callers keep the torch ops for such widths.
//  - blockDim is a multiple of C / VEC, and a thread's vectors lie
//    blockDim apart, so each thread keeps one channel group and loads its
//    bias values once, into registers.
//  - blockIdx.y walks the images, so the crop and the shift are a row
//    offset into each image's contiguous block: 32-bit indices within an
//    image, no division per element.
//  - UNROLL independent vectors a thread are loaded before any is stored.
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int VEC = 8;  // bf16 channels a 16-byte access
constexpr int UNROLL = 4;
constexpr int MAX_THREADS = 512;
constexpr int TARGET_THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr long long MAX_IMAGE = 0x7fffffffLL;  // vectors an image: 32-bit

struct alignas(2 * VEC) Pack {
  bf16 v[VEC];
};

struct EpiArgs {
  const bf16* src;    // forward: c; backward: g
  const bf16* out;    // backward with act: out (g's layout)
  const float* bias;  // forward: (C,) fp32
  bf16* dst;          // forward: out; backward: dpre
  int images;
  unsigned dst_img;   // vectors an image of dst
  unsigned src_img;   // vectors an image of src (and of out)
  unsigned dst_off;   // first vector of an image of dst read from src
  unsigned src_off;   // its source, in an image of src
  unsigned live;      // vectors an image of dst read from src
  int cvec;           // vectors a pixel: C / VEC
  int act;
  float slope;
};

__device__ __forceinline__ bf16 act_fwd(bf16 y, int act, float slope) {
  const float f = __bfloat162float(y);
  return (!act || f >= 0.f) ? y : __float2bfloat16_rn(f * slope);
}

// A block covers UNROLL * blockDim.x vectors of one image (blockIdx.y) of
// dst, thread t the vectors base + u * blockDim.x + t: blockDim.x is a
// multiple of cvec, so they share one channel group. The UNROLL loads are
// issued before any store.

// forward: dst = out (H rows), src = c (Hc rows)
__global__ void __launch_bounds__(MAX_THREADS)
epilogue_fwd_kernel(const EpiArgs a) {
  const int grp = threadIdx.x % a.cvec;
  float bias[VEC];
  Pack fill;  // the masked row(s) above the shift
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    bias[k] = __bfloat162float(__float2bfloat16_rn(a.bias[grp * VEC + k]));
    const bf16 y0 = __float2bfloat16_rn(0.f + bias[k]);
    fill.v[k] = act_fwd(
        __float2bfloat16_rn(__bfloat162float(y0) * 0.f), a.act, a.slope);
  }
  const unsigned base = blockIdx.x * (UNROLL * blockDim.x) + threadIdx.x;
  for (int n = blockIdx.y; n < a.images; n += gridDim.y) {
    const Pack* src = reinterpret_cast<const Pack*>(a.src) +
                           (size_t)n * a.src_img + a.src_off;
    Pack* dst = reinterpret_cast<Pack*>(a.dst) +
                     (size_t)n * a.dst_img;
    Pack x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned k = base + u * blockDim.x - a.dst_off;  // wraps below
      if (k < a.live) x[u] = src[k];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = base + u * blockDim.x;
      if (e >= a.dst_img) break;
      const unsigned k = e - a.dst_off;
      Pack o = fill;
      if (k < a.live) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = act_fwd(
              __float2bfloat16_rn(__bfloat162float(x[u].v[j]) + bias[j]),
              a.act, a.slope);
      }
      dst[e] = o;
    }
  }
}

// backward: dst = dpre (Hc rows), src = g and out (H rows)
__global__ void __launch_bounds__(MAX_THREADS)
epilogue_bwd_kernel(const EpiArgs a) {
  Pack zero;
#pragma unroll
  for (int k = 0; k < VEC; ++k) zero.v[k] = __float2bfloat16_rn(0.f);
  const unsigned base = blockIdx.x * (UNROLL * blockDim.x) + threadIdx.x;
  for (int n = blockIdx.y; n < a.images; n += gridDim.y) {
    const size_t at = (size_t)n * a.src_img + a.src_off;
    const Pack* g = reinterpret_cast<const Pack*>(a.src) + at;
    const Pack* o = reinterpret_cast<const Pack*>(a.out) + at;
    Pack* dst = reinterpret_cast<Pack*>(a.dst) +
                     (size_t)n * a.dst_img;
    Pack gv[UNROLL], ov[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned k = base + u * blockDim.x - a.dst_off;
      if (k < a.live) {
        gv[u] = g[k];
        if (a.act) ov[u] = o[k];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = base + u * blockDim.x;
      if (e >= a.dst_img) break;
      const unsigned k = e - a.dst_off;
      Pack d = zero;
      if (k < a.live) {
        d = gv[u];
        if (a.act) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            if (!(__bfloat162float(ov[u].v[j]) >= 0.f))
              d.v[j] = __float2bfloat16_rn(
                  __bfloat162float(gv[u].v[j]) * a.slope);
        }
      }
      dst[e] = d;
    }
  }
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// Threads a block: a multiple of cvec (the fixed channel group), of a
// warp where that fits in MAX_THREADS, at least TARGET_THREADS where an
// image has that many vectors; 0 if cvec itself exceeds MAX_THREADS.
int block_threads(int cvec, long long per_image) {
  if (cvec > MAX_THREADS) return 0;
  const int lcm = cvec / gcd(cvec, 32) * 32;
  const long long t = lcm <= MAX_THREADS
                          ? lcm * ((TARGET_THREADS + lcm - 1) / lcm)
                          : cvec * (MAX_THREADS / cvec);
  return (int)(t < per_image ? t : per_image);  // per_image: cvec's multiple
}

template <bool BWD>
int launch(const void* src, const void* out, const void* bias, void* dst,
           int n, int hc, int h, int w, int c, int shift, int act,
           float slope, void* stream) {
  if (n < 1 || h < 1 || hc < 1 || w < 1 || c < 1 || shift < 0 || shift > h ||
      hc < h - shift || !src || !dst || (BWD && act && !out) ||
      (!BWD && !bias))
    return (int)cudaErrorInvalidValue;
  auto on16 = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (c % VEC || !on16(src) || !on16(dst) || !on16(out))
    return (int)cudaErrorInvalidValue;
  const int cvec = c / VEC;
  const long long row = (long long)w * cvec;
  const long long rows_dst = BWD ? hc : h, rows_src = BWD ? h : hc;
  if (rows_dst * row > MAX_IMAGE || rows_src * row > MAX_IMAGE)
    return (int)cudaErrorInvalidValue;
  EpiArgs a;
  a.src = static_cast<const bf16*>(src);
  a.out = static_cast<const bf16*>(out);
  a.bias = static_cast<const float*>(bias);
  a.dst = static_cast<bf16*>(dst);
  a.images = n;
  a.cvec = cvec;
  a.dst_img = (unsigned)(rows_dst * row);
  a.src_img = (unsigned)(rows_src * row);
  a.live = (unsigned)((h - shift) * row);
  // forward: out rows [shift, H) from c rows [0, H - shift);
  // backward: dpre rows [0, H - shift) from g rows [shift, H)
  a.dst_off = BWD ? 0u : (unsigned)(shift * row);
  a.src_off = BWD ? (unsigned)(shift * row) : 0u;
  a.act = act;
  a.slope = slope;
  const int threads = block_threads(cvec, a.dst_img);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const long long per = (long long)threads * UNROLL;
  const dim3 grid((unsigned)((a.dst_img + per - 1) / per),
                  n < MAX_GRID_Y ? n : MAX_GRID_Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BWD) epilogue_bwd_kernel<<<grid, threads, 0, s>>>(a);
  else epilogue_fwd_kernel<<<grid, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success); cudaErrorInvalidValue
// (1), before launching, for sizes it does not take (C % 8 != 0 among
// them) and operands off a 16-byte boundary. c: (n, hc, w, C) bf16
// channels_last; bias: (C,) fp32; out: (n, h, w, C) bf16, written.
// act 0: no activation. Launches on `stream`, no synchronise.
extern "C" int conv_epilogue_fwd(const void* c, const void* bias, void* out,
                                 int n, int hc, int h, int w, int C,
                                 int shift, int act, float slope,
                                 void* stream) {
  return launch<false>(c, nullptr, bias, out, n, hc, h, w, C, shift, act,
                       slope, stream);
}

// g, out: (n, h, w, C) bf16 channels_last (out may be null when act is 0);
// dpre: (n, hc, w, C) bf16, written whole.
extern "C" int conv_epilogue_bwd(const void* g, const void* out, void* dpre,
                                 int n, int hc, int h, int w, int C,
                                 int shift, int act, float slope,
                                 void* stream) {
  return launch<true>(g, out, nullptr, dpre, n, hc, h, w, C, shift, act,
                      slope, stream);
}
