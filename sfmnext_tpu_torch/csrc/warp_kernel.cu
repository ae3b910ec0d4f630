// Hopper (sm_90a) kernels for the bilinear warp: a sample of an NHWC float32
// image at per-pixel coordinates, in border or zeros padding, and both
// gradients of that sample.
//
//   warp_fwd replaces _call_fwd / _fwd_kernel
//     (sfmnext_tpu/ops/pallas/warp_kernel.py, entries warp_border_pallas and
//     warp_sample_pallas):
//       out[b,y,x,:] = bilinear(img[b], fy[b,y,x], fx[b,y,x])
//   warp_bwd replaces _call_bwd_coords / _bwd_kernel (same file):
//       dfy, dfx = d(sum_c g[b,y,x,c] * out[b,y,x,c]) / d(fy, fx)
//     in border mode zero where a coordinate was clamped to the border
//     (fy <= 0, fy >= H-1; likewise fx); in zeros mode unmasked
//     (warp_kernel.py:246-253 masks border only).
//   warp_bwd_img replaces _call_bwd_img / _bwd_img_kernel (same file):
//       dimg[b,y,x,c] = sum over the output pixels p whose sample touches
//                       (y,x) of g[b,p,c] * that corner's bilinear weight
//     the image cotangent where the sampled tensor carries gradients (the
//     indoor warps of rectified frames and of per-frame depth maps).
//
// Semantics are torch's grid_sample(align_corners=...) after unnormalising,
// as the JAX package's plain version (ops/warp.py:92-142):
//   border: clamp the coordinate into the image, y0 = clamp(floor(y), 0,
//     H-2), wy = y - y0 (likewise x), lerp the 2x2 window;
//   zeros: y0 = floor(y), wy = y - y0 from the unclamped coordinate; each
//     of the four corners contributes only where it lies in the image.
// The TPU kernels' BAND/XWIN windows (a vertical band of rows and a static
// horizontal window per 128-lane slab; samples outside are clamped in the
// forward and dropped in the image cotangent) are a limit of the TPU's lane
// gathers and one-hot scatters; a GPU thread reads and adds at any address,
// so nothing is clamped here but the image border.
//
// What bounds them on an H100 (float32; each input read once, each output
// written once):
//   warp_fwd: the image, fy, fx and the output, 4*B*H*W*(C+2+C) bytes
//     (84 MB at 8x320x1024x3 -> 25 us at 3.35 TB/s); ~30 flops a pixel, so
//     memory-bound. One thread per output pixel, consecutive threads on
//     consecutive pixels of a row: the fy/fx loads and the output stores
//     coalesce, and the four corner reads of a warp hit a few cache lines of
//     one or two image rows (view-synthesis warps are near-identity), so
//     the image comes from DRAM about once through L1/L2.
//   warp_bwd: reads the image, fy, fx and g, writes dfy, dfx. Same layout.
//   warp_bwd_img: reads fy, fx and g, writes dimg: 4*B*H*W*(2+2C) bytes
//     (28.3 MB at 8x288x384x3 -> 8.5 us). The scatter is the transpose of
//     the forward's gather: one thread per output pixel recomputes its four
//     corners and weights exactly as the forward and adds g*w into dimg with
//     float32 atomicAdd (fire-and-forget reductions in L2). A near-identity
//     warp sends each image pixel about four adds, from neighbouring
//     threads, so contention is low. The sums land in a different order
//     on every run: the result is not bit-reproducible, and its error
//     against a sequential sum is a few float32 roundings of the largest
//     partial sum. dimg is zeroed on the stream first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The four corners of one sample: their offsets into the image plane (in
// elements of one channel row, i.e. pixel index * C), their weights, and
// which lie in the image (all four in border mode).
struct Corners {
  long long off[4];  // (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1)
  float w[4];
  bool in[4];
  float wy, wx;
};

template <bool kZeros>
__device__ __forceinline__ Corners corners(float fy, float fx, int H, int W, int C) {
  Corners k;
  float y0, x0, wy, wx;
  if (kZeros) {
    y0 = floorf(fy);
    x0 = floorf(fx);
    wy = fy - y0;
    wx = fx - x0;
  } else {
    const float yc = fminf(fmaxf(fy, 0.f), (float)(H - 1));
    const float xc = fminf(fmaxf(fx, 0.f), (float)(W - 1));
    y0 = fminf(fmaxf(floorf(yc), 0.f), (float)(H - 2));
    x0 = fminf(fmaxf(floorf(xc), 0.f), (float)(W - 2));
    wy = yc - y0;
    wx = xc - x0;
  }
  k.wy = wy;
  k.wx = wx;
  k.w[0] = (1.f - wy) * (1.f - wx);
  k.w[1] = (1.f - wy) * wx;
  k.w[2] = wy * (1.f - wx);
  k.w[3] = wy * wx;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // the range test runs on floats, so a coordinate far outside (or NaN)
    // is never converted to an int that overflows
    const float yy = y0 + (float)(j >> 1), xx = x0 + (float)(j & 1);
    k.in[j] = !kZeros || (yy >= 0.f && yy <= (float)(H - 1) && xx >= 0.f &&
                          xx <= (float)(W - 1));
    k.off[j] = k.in[j] ? ((long long)yy * W + (long long)xx) * C : 0;
  }
  return k;
}

// One thread per output pixel of [B, Ho, Wo]; img [B,H,W,C], out [B,Ho,Wo,C].
template <bool kZeros>
__global__ void __launch_bounds__(kThreads) warp_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ fy,
    const float* __restrict__ fx, float* __restrict__ out, int H, int W, int C,
    long long per_batch, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* im = img + (i / per_batch) * (long long)H * W * C;
  const Corners k = corners<kZeros>(__ldg(fy + i), __ldg(fx + i), H, W, C);
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = k.in[j] ? __ldg(im + k.off[j] + c) : 0.f;
    if (kZeros) {
      o[c] = v[0] * k.w[0] + v[1] * k.w[1] + v[2] * k.w[2] + v[3] * k.w[3];
    } else {
      const float top = v[0] * (1.f - k.wx) + v[1] * k.wx;
      const float bot = v[2] * (1.f - k.wx) + v[3] * k.wx;
      o[c] = top * (1.f - k.wy) + bot * k.wy;
    }
  }
}

template <bool kZeros>
__global__ void __launch_bounds__(kThreads) warp_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ fy,
    const float* __restrict__ fx, const float* __restrict__ g,
    float* __restrict__ dfy, float* __restrict__ dfx, int H, int W, int C,
    long long per_batch, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* im = img + (i / per_batch) * (long long)H * W * C;
  const float y = __ldg(fy + i), x = __ldg(fx + i);
  const Corners k = corners<kZeros>(y, x, H, W, C);
  const float* gi = g + i * C;
  float gy = 0.f, gx = 0.f;
  for (int c = 0; c < C; ++c) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = k.in[j] ? __ldg(im + k.off[j] + c) : 0.f;
    const float gc = __ldg(gi + c);
    gy += gc * ((v[2] - v[0]) * (1.f - k.wx) + (v[3] - v[1]) * k.wx);
    gx += gc * ((v[1] - v[0]) * (1.f - k.wy) + (v[3] - v[2]) * k.wy);
  }
  if (!kZeros) {
    // a clamped (border) coordinate has no gradient, as torch and
    // warp_kernel.py:246-253 have it
    gy = (y > 0.f && y < (float)(H - 1)) ? gy : 0.f;
    gx = (x > 0.f && x < (float)(W - 1)) ? gx : 0.f;
  }
  dfy[i] = gy;
  dfx[i] = gx;
}

// One thread per output pixel; dimg [B,H,W,C] zeroed before the launch.
template <bool kZeros>
__global__ void __launch_bounds__(kThreads) warp_bwd_img_kernel(
    const float* __restrict__ fy, const float* __restrict__ fx,
    const float* __restrict__ g, float* __restrict__ dimg, int H, int W, int C,
    long long per_batch, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float* di = dimg + (i / per_batch) * (long long)H * W * C;
  const Corners k = corners<kZeros>(__ldg(fy + i), __ldg(fx + i), H, W, C);
  const float* gi = g + i * C;
  for (int c = 0; c < C; ++c) {
    const float gc = __ldg(gi + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k.in[j]) atomicAdd(di + k.off[j] + c, gc * k.w[j]);
    }
  }
}

bool shapes_ok(int B, int H, int W, int C, int Ho, int Wo) {
  return B > 0 && H >= 2 && W >= 2 && C > 0 && Ho > 0 && Wo > 0;
}

unsigned n_blocks(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int warp_fwd(const void* img, const void* fy, const void* fx, void* out, int B, int H, int W,
             int C, int Ho, int Wo, int zeros, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  const long long per_batch = (long long)Ho * Wo, total = per_batch * B;
  auto kernel = zeros ? &warp_fwd_kernel<true> : &warp_fwd_kernel<false>;
  kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(fy),
      static_cast<const float*>(fx), static_cast<float*>(out), H, W, C, per_batch, total);
  return (int)cudaGetLastError();
}

int warp_bwd(const void* img, const void* fy, const void* fx, const void* g, void* dfy,
             void* dfx, int B, int H, int W, int C, int Ho, int Wo, int zeros, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  const long long per_batch = (long long)Ho * Wo, total = per_batch * B;
  auto kernel = zeros ? &warp_bwd_kernel<true> : &warp_bwd_kernel<false>;
  kernel<<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(fy),
      static_cast<const float*>(fx), static_cast<const float*>(g), static_cast<float*>(dfy),
      static_cast<float*>(dfx), H, W, C, per_batch, total);
  return (int)cudaGetLastError();
}

int warp_bwd_img(const void* fy, const void* fx, const void* g, void* dimg, int B, int H, int W,
                 int C, int Ho, int Wo, int zeros, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dimg, 0, sizeof(float) * (size_t)B * H * W * C, s);
  if (err != cudaSuccess) return (int)err;
  const long long per_batch = (long long)Ho * Wo, total = per_batch * B;
  auto kernel = zeros ? &warp_bwd_img_kernel<true> : &warp_bwd_img_kernel<false>;
  kernel<<<n_blocks(total), kThreads, 0, s>>>(
      static_cast<const float*>(fy), static_cast<const float*>(fx),
      static_cast<const float*>(g), static_cast<float*>(dimg), H, W, C, per_batch, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
