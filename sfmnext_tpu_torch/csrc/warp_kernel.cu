// Hopper (sm_90a) kernels for the view-synthesis warp: a bilinear,
// border-mode sample of an NHWC float32 image at per-pixel coordinates, and
// the gradient of that sample with respect to the coordinates.
//
//   warp_border_fwd replaces _call_fwd / _fwd_kernel
//     (sfmnext_tpu/ops/pallas/warp_kernel.py, public entry warp_border_pallas):
//       out[b,y,x,:] = bilinear(img[b], fy[b,y,x], fx[b,y,x])
//   warp_border_bwd replaces _call_bwd_coords / _bwd_kernel (same file):
//       dfy, dfx = d(sum_c g[b,y,x,c] * out[b,y,x,c]) / d(fy, fx)
//     with zero gradient where a coordinate was clamped to the border
//     (fy <= 0, fy >= H-1; likewise fx). The image gets no cotangent: the
//     source frame is training data (warp_kernel.py:467-472).
//
// Semantics are torch's grid_sample(padding_mode="border",
// align_corners=True) after unnormalising, exactly as the JAX package's
// plain version (ops/warp.py:92-107): clamp the coordinate into the image,
// y0 = clamp(floor(y), 0, H-2), wy = y - y0 (likewise x), then lerp the
// 2x2 window. The TPU kernel's BAND/XWIN windows (a vertical band of rows
// and a static horizontal window per 128-lane slab, clamping samples that
// fall outside) are a limit of the TPU's lane gathers; a GPU thread reads
// any address, so nothing is clamped here but the image border.
//
// What bounds them on an H100 at the slice's shape (B=8, 320x1024, C=3):
//   forward: read the image, fy, fx once and write the output:
//     4*B*H*W*(3+2+3) = 84 MB -> 25 us at 3.35 TB/s; ~30 flops a pixel, so
//     memory-bound. One thread per output pixel, consecutive threads on
//     consecutive pixels of a row: the fy/fx loads and the output stores are
//     coalesced, and the four corner reads of a warp hit a few cache lines
//     of one or two image rows (view-synthesis warps are near-identity), so
//     the image is read about once from DRAM through L1/L2.
//   backward: reads the image, fy, fx and g, writes dfy, dfx:
//     4*B*H*W*(3+2+3+2) = 105 MB -> 31 us. Same layout, one thread a pixel,
//     the channel loop inside.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  const float* p00;  // the 2x2 window's top-left pixel; the others follow
  int row;           // W*C: from the top row to the bottom row
  float wy, wx;      // lerp weights in [0, 1]
};

__device__ __forceinline__ Corners corners(const float* img, float fy, float fx,
                                           int H, int W, int C) {
  const float yc = fminf(fmaxf(fy, 0.f), (float)(H - 1));
  const float xc = fminf(fmaxf(fx, 0.f), (float)(W - 1));
  const float y0 = fminf(fmaxf(floorf(yc), 0.f), (float)(H - 2));
  const float x0 = fminf(fmaxf(floorf(xc), 0.f), (float)(W - 2));
  Corners k;
  k.p00 = img + ((size_t)y0 * W + (size_t)x0) * C;
  k.row = W * C;
  k.wy = yc - y0;
  k.wx = xc - x0;
  return k;
}

// One thread per output pixel of [B, Ho, Wo]; img [B,H,W,C], out [B,Ho,Wo,C].
__global__ void __launch_bounds__(kThreads) warp_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ fy,
    const float* __restrict__ fx, float* __restrict__ out, int H, int W, int C,
    long long per_batch, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / per_batch;
  const Corners k = corners(img + b * (long long)H * W * C, __ldg(fy + i), __ldg(fx + i), H, W, C);
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(k.p00 + c), v01 = __ldg(k.p00 + C + c);
    const float v10 = __ldg(k.p00 + k.row + c), v11 = __ldg(k.p00 + k.row + C + c);
    const float top = v00 * (1.f - k.wx) + v01 * k.wx;
    const float bot = v10 * (1.f - k.wx) + v11 * k.wx;
    o[c] = top * (1.f - k.wy) + bot * k.wy;
  }
}

__global__ void __launch_bounds__(kThreads) warp_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ fy,
    const float* __restrict__ fx, const float* __restrict__ g,
    float* __restrict__ dfy, float* __restrict__ dfx, int H, int W, int C,
    long long per_batch, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long b = i / per_batch;
  const float y = __ldg(fy + i), x = __ldg(fx + i);
  const Corners k = corners(img + b * (long long)H * W * C, y, x, H, W, C);
  const float* gi = g + i * C;
  float gy = 0.f, gx = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v00 = __ldg(k.p00 + c), v01 = __ldg(k.p00 + C + c);
    const float v10 = __ldg(k.p00 + k.row + c), v11 = __ldg(k.p00 + k.row + C + c);
    const float gc = __ldg(gi + c);
    gy += gc * ((v10 - v00) * (1.f - k.wx) + (v11 - v01) * k.wx);
    gx += gc * ((v01 - v00) * (1.f - k.wy) + (v11 - v10) * k.wy);
  }
  // a clamped (border) coordinate has no gradient, as torch and
  // warp_kernel.py:246-253 have it
  dfy[i] = (y > 0.f && y < (float)(H - 1)) ? gy : 0.f;
  dfx[i] = (x > 0.f && x < (float)(W - 1)) ? gx : 0.f;
}

bool shapes_ok(int B, int H, int W, int C, int Ho, int Wo) {
  return B > 0 && H >= 2 && W >= 2 && C > 0 && Ho > 0 && Wo > 0;
}

}  // namespace

extern "C" {

int warp_border_fwd(const void* img, const void* fy, const void* fx, void* out, int B, int H,
                    int W, int C, int Ho, int Wo, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  const long long per_batch = (long long)Ho * Wo, total = per_batch * B;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  warp_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(fy),
      static_cast<const float*>(fx), static_cast<float*>(out), H, W, C, per_batch, total);
  return (int)cudaGetLastError();
}

int warp_border_bwd(const void* img, const void* fy, const void* fx, const void* g, void* dfy,
                    void* dfx, int B, int H, int W, int C, int Ho, int Wo, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  const long long per_batch = (long long)Ho * Wo, total = per_batch * B;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  warp_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(fy),
      static_cast<const float*>(fx), static_cast<const float*>(g), static_cast<float*>(dfy),
      static_cast<float*>(dfx), H, W, C, per_batch, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
