// Hopper (sm_90a) kernels for the bilinear warp: a sample of an NHWC float32
// image at per-pixel coordinates, in border or zeros padding, and both
// gradients of that sample.
//
//   warp_fwd replaces _call_fwd / _fwd_kernel
//     (sfmnext_tpu/ops/pallas/warp_kernel.py:366 and :167, entries
//     warp_border_pallas and warp_sample_pallas):
//       out[b,y,x,:] = bilinear(img[b], fy[b,y,x], fx[b,y,x])
//   warp_bwd replaces _call_bwd_coords / _bwd_kernel (same file, :403 and
//   :207):
//       dfy, dfx = d(sum_c g[b,y,x,c] * out[b,y,x,c]) / d(fy, fx)
//     in border mode zero where a coordinate was clamped to the border
//     (fy <= 0, fy >= H-1; likewise fx); in zeros mode unmasked
//     (warp_kernel.py:246-253 masks border only).
//   warp_bwd_img replaces _call_bwd_img / _bwd_img_kernel (same file, :333
//   and :258):
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
//     of the four corners contributes only where it lies in the image, its
//     range tested in float before any int conversion (a far or NaN
//     coordinate never overflows).
// The TPU kernels' BAND/XWIN windows (a vertical band of rows and a static
// horizontal window per 128-lane slab, staged in VMEM; samples outside are
// clamped in the forward and dropped in the image cotangent) are a limit of
// the TPU's lane gathers and one-hot scatters; a GPU thread reads and adds
// at any address, so nothing is clamped here but the image border.
//
// What bounds them on an H100: the bytes (float32; each input read once,
// each output written once; ~30 flops a pixel and channel):
//   warp_fwd: the image, fy, fx and the output, 4*B*H*W*(C+2+C) bytes
//     (84 MB at 8x320x1024x3 -> 25 us at 3.35 TB/s);
//   warp_bwd: the image, fy, fx and g in, dfy and dfx out,
//     4*B*H*W*(2C+4) bytes (105 MB -> 31 us);
//   warp_bwd_img: fy, fx and g in, dimg out, 4*B*H*W*(2+2C) bytes
//     (28.3 MB at 8x288x384x3 -> 8.5 us).
//
// warp_fwd and warp_bwd are gathers: every instruction in front of a load
// is latency that the kernel waits through, and every load in flight hides
// some. So:
//   - the batch is blockIdx.y: one 64-bit base pointer a thread, and 32-bit
//     offsets inside one image plane and one output plane, with no
//     division (the wrapper raises when H*W*C reaches 2^31, when
//     (Ho*Wo + 512)*C does, 512 being a block's pixels, or when B passes
//     65,535);
//   - C is a template parameter (1 and 3, what the paths use; any other C
//     takes a loop over the channels), so all 4*C corner loads of a pixel
//     are issued before any arithmetic;
//   - a thread takes kPix = 4 output pixels: 16*C gathers in flight. Which
//     four follows the padding, the one thing the kernel knows of its
//     traffic:
//       border (warp_frame's warps of the neighbouring frames, and the
//       indoor warps of rectified frames and depths): four consecutive
//       pixels. fy, fx, g, dfy, dfx and the output move as 16-byte vectors
//       (three of them for 4 pixels at C = 3) where the 4 pixels start on a
//       multiple of 4 of the flat pixel index b*Ho*Wo + p (every group when
//       Ho*Wo is a multiple of 4; at an odd Ho*Wo a batch's groups start
//       off a 16-byte boundary and move as scalars), and as scalars at a
//       plane's ragged end;
//       zeros (only the indoor RectifyNet's rotation warps of raw frames,
//       near-identity, 28 MB at 8x288x384x3, so they sit in L2): four
//       pixels 32 apart, so that one load instruction of a warp spans 32
//       consecutive samples. At C = 3 a warp's corner load then touches
//       about 3 cache lines where consecutive pixels touch about 12. On an
//       H100 this map ran the rotation warp faster than consecutive pixels
//       did, in both directions, and widely scattered samples slightly
//       slower; on the border warps its gain on warp_frame's was within the
//       spread between runs, so border keeps consecutive pixels and the
//       vectors.
// Neighbouring samples share corners through L1. A shared-memory window per
// 16x32 tile of output pixels (the tile's corner box copied with cp.async
// where it fits 16 KB, the Hopper form of the Pallas kernels' staging) was
// measured and left out: it was slower on the smooth warps the training
// steps make, whose corners are L1 hits already, as the box reduction, the
// copy and the barrier came on top.
//
// warp_bwd_img: the scatter is the transpose of the forward's gather: one
// thread per output pixel recomputes its four corners and weights exactly
// as the forward and adds g*w into dimg with float32 atomicAdd
// (fire-and-forget reductions in L2). A near-identity warp sends each
// image pixel about four adds, from neighbouring threads, so contention is
// low. The sums land in a different order on every run: the result is not
// bit-reproducible, and its error against a sequential sum is a few
// float32 roundings of the largest partial sum. dimg is zeroed on the
// stream first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // threads a block of warp_fwd / warp_bwd
constexpr int kPix = 4;           // output pixels a thread of warp_fwd / warp_bwd
constexpr int kImgThreads = 256;  // threads a block of warp_bwd_img

// The four corners of one sample: their offsets into the image plane (in
// floats, i.e. pixel index * C, below 2^31), their weights, and which lie
// in the image (all four in border mode).
struct Corners {
  int off[4];  // (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1)
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
    k.off[j] = k.in[j] ? ((int)yy * W + (int)xx) * C : 0;
  }
  return k;
}

// The bilinear value of one channel from its four corners.
template <bool kZeros>
__device__ __forceinline__ float lerp(const float* v, const Corners& k) {
  if (kZeros) return v[0] * k.w[0] + v[1] * k.w[1] + v[2] * k.w[2] + v[3] * k.w[3];
  const float top = v[0] * (1.f - k.wx) + v[1] * k.wx;
  const float bot = v[2] * (1.f - k.wx) + v[3] * k.wx;
  return top * (1.f - k.wy) + bot * k.wy;
}

// One channel's share of the coordinate gradient: gc times d(value)/d(y, x).
__device__ __forceinline__ void lerp_grad(const float* v, const Corners& k, float gc, float& gy,
                                          float& gx) {
  gy += gc * ((v[2] - v[0]) * (1.f - k.wx) + (v[3] - v[1]) * k.wx);
  gx += gc * ((v[1] - v[0]) * (1.f - k.wy) + (v[3] - v[2]) * k.wy);
}

// The kPix output pixels p[q] of this thread in its batch's plane of P
// pixels, ok[q] where pixel p[q] exists. kStrided false: kPix consecutive
// pixels from p[0]; vec where all exist and p[0] is a multiple of 4 of the
// flat index base + p[0], so that their per-pixel values move as 16-byte
// vectors. kStrided: kPix pixels 32 apart, so that at each q a warp's 32
// lanes take 32 consecutive pixels (no vectors). Every p[q] lies below
// gridDim.x * kThreads * kPix < P + kThreads * kPix.
template <bool kStrided>
__device__ __forceinline__ void thread_pixels(int P, long long base, int* p, bool* ok,
                                              bool& vec) {
  const int lane = kStrided ? (threadIdx.x & 31) : 0;
  const int p0 = (blockIdx.x * kThreads + threadIdx.x - lane) * kPix + lane;
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    p[q] = p0 + (kStrided ? 32 : 1) * q;
    ok[q] = p[q] < P;
  }
  vec = !kStrided && p0 + kPix <= P && ((base + p0) & 3) == 0;
}

// kPix * n floats a thread of a [P, n] array, at its pixels p: n 16-byte
// loads where vec, else n scalars a pixel that exists (0 past the end).
template <int n>
__device__ __forceinline__ void load_px(const float* __restrict__ src, const int* p,
                                        const bool* ok, bool vec, float* v) {
  if (vec) {
    const float4* s = reinterpret_cast<const float4*>(src + p[0] * n);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float4 a = __ldg(s + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
#pragma unroll
      for (int c = 0; c < n; ++c) v[q * n + c] = ok[q] ? __ldg(src + p[q] * n + c) : 0.f;
    }
  }
}

template <int n>
__device__ __forceinline__ void store_px(float* __restrict__ dst, const int* p, const bool* ok,
                                         bool vec, const float* v) {
  if (vec) {
    float4* d = reinterpret_cast<float4*>(dst + p[0] * n);
#pragma unroll
    for (int i = 0; i < n; ++i)
      d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if (ok[q]) {
#pragma unroll
        for (int c = 0; c < n; ++c) dst[p[q] * n + c] = v[q * n + c];
      }
    }
  }
}

// The 4 corner values of kPix samples in channel c (0 outside the image).
__device__ __forceinline__ void gather(const float* __restrict__ im, const Corners* k, int c,
                                       float (*v)[4]) {
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[q][j] = k[q].in[j] ? __ldg(im + k[q].off[j] + c) : 0.f;
  }
}

// kPix output pixels a thread, batch on blockIdx.y; img [B,H,W,C], fy/fx
// [B,P], out [B,P,C]. kC is C, or 0 for a C known only at run time. The
// pixel map follows the padding: consecutive in border mode, strided in
// zeros mode (see the header).
template <bool kZeros, int kC>
__global__ void __launch_bounds__(kThreads) warp_fwd_kernel(
    const float* __restrict__ img, const float* __restrict__ fy,
    const float* __restrict__ fx, float* __restrict__ out, int H, int W, int C, int P) {
  const long long base = (long long)blockIdx.y * P;
  int p[kPix];
  bool ok[kPix], vec;
  thread_pixels<kZeros>(P, base, p, ok, vec);
  if (!ok[0]) return;
  const float* im = img + (long long)blockIdx.y * H * W * C;
  float y[kPix], x[kPix];
  load_px<1>(fy + base, p, ok, vec, y);
  load_px<1>(fx + base, p, ok, vec, x);
  Corners k[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) k[q] = corners<kZeros>(y[q], x[q], H, W, C);
  float* o = out + base * C;
  if constexpr (kC > 0) {
    float v[kC][kPix][4], val[kPix * kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) gather(im, k, c, v[c]);
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
#pragma unroll
      for (int c = 0; c < kC; ++c) val[q * kC + c] = lerp<kZeros>(v[c][q], k[q]);
    }
    store_px<kC>(o, p, ok, vec, val);
  } else {
    for (int c = 0; c < C; ++c) {
      float v[kPix][4];
      gather(im, k, c, v);
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        if (ok[q]) o[p[q] * C + c] = lerp<kZeros>(v[q], k[q]);
      }
    }
  }
}

// The coordinate gradient, laid out as warp_fwd_kernel; g [B,P,C], dfy/dfx
// [B,P].
template <bool kZeros, int kC>
__global__ void __launch_bounds__(kThreads) warp_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ fy,
    const float* __restrict__ fx, const float* __restrict__ g,
    float* __restrict__ dfy, float* __restrict__ dfx, int H, int W, int C, int P) {
  const long long base = (long long)blockIdx.y * P;
  int p[kPix];
  bool ok[kPix], vec;
  thread_pixels<kZeros>(P, base, p, ok, vec);
  if (!ok[0]) return;
  const float* im = img + (long long)blockIdx.y * H * W * C;
  const float* gb = g + base * C;
  float y[kPix], x[kPix];
  load_px<1>(fy + base, p, ok, vec, y);
  load_px<1>(fx + base, p, ok, vec, x);
  Corners k[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) k[q] = corners<kZeros>(y[q], x[q], H, W, C);
  float gy[kPix], gx[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) gy[q] = gx[q] = 0.f;
  if constexpr (kC > 0) {
    float v[kC][kPix][4], gv[kPix * kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) gather(im, k, c, v[c]);
    load_px<kC>(gb, p, ok, vec, gv);
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
#pragma unroll
      for (int c = 0; c < kC; ++c) lerp_grad(v[c][q], k[q], gv[q * kC + c], gy[q], gx[q]);
    }
  } else {
    for (int c = 0; c < C; ++c) {
      float v[kPix][4];
      gather(im, k, c, v);
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float gc = ok[q] ? __ldg(gb + p[q] * C + c) : 0.f;
        lerp_grad(v[q], k[q], gc, gy[q], gx[q]);
      }
    }
  }
  if (!kZeros) {
    // a clamped (border) coordinate has no gradient, as torch and
    // warp_kernel.py:246-253 have it
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      gy[q] = (y[q] > 0.f && y[q] < (float)(H - 1)) ? gy[q] : 0.f;
      gx[q] = (x[q] > 0.f && x[q] < (float)(W - 1)) ? gx[q] : 0.f;
    }
  }
  store_px<1>(dfy + base, p, ok, vec, gy);
  store_px<1>(dfx + base, p, ok, vec, gx);
}

// One thread per output pixel; dimg [B,H,W,C] zeroed before the launch.
template <bool kZeros>
__global__ void __launch_bounds__(kImgThreads) warp_bwd_img_kernel(
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

// What the kernels take: H, W >= 2, the batch within gridDim.y, an image
// plane of fewer than 2^31 floats, and an output plane that stays below
// 2^31 floats when rounded up by one block's pixels (a thread's pixel index
// runs up to P + kThreads * kPix - 1 before its bounds test).
bool shapes_ok(int B, int H, int W, int C, int Ho, int Wo) {
  return B > 0 && B <= 65535 && H >= 2 && W >= 2 && C > 0 && Ho > 0 && Wo > 0 &&
         (long long)H * W * C < (1LL << 31) &&
         ((long long)Ho * Wo + kThreads * kPix) * C < (1LL << 31);
}

dim3 grid(int B, int P) {
  return dim3((unsigned)((P + kThreads * kPix - 1) / (kThreads * kPix)), (unsigned)B);
}

template <bool kZeros>
void launch_fwd(const float* img, const float* fy, const float* fx, float* out, int B, int H,
                int W, int C, int P, cudaStream_t s) {
  const dim3 blocks = grid(B, P);
  if (C == 3)
    warp_fwd_kernel<kZeros, 3><<<blocks, kThreads, 0, s>>>(img, fy, fx, out, H, W, C, P);
  else if (C == 1)
    warp_fwd_kernel<kZeros, 1><<<blocks, kThreads, 0, s>>>(img, fy, fx, out, H, W, C, P);
  else
    warp_fwd_kernel<kZeros, 0><<<blocks, kThreads, 0, s>>>(img, fy, fx, out, H, W, C, P);
}

template <bool kZeros>
void launch_bwd(const float* img, const float* fy, const float* fx, const float* g,
                float* dfy, float* dfx, int B, int H, int W, int C, int P, cudaStream_t s) {
  const dim3 blocks = grid(B, P);
  if (C == 3)
    warp_bwd_kernel<kZeros, 3><<<blocks, kThreads, 0, s>>>(img, fy, fx, g, dfy, dfx, H, W, C, P);
  else if (C == 1)
    warp_bwd_kernel<kZeros, 1><<<blocks, kThreads, 0, s>>>(img, fy, fx, g, dfy, dfx, H, W, C, P);
  else
    warp_bwd_kernel<kZeros, 0><<<blocks, kThreads, 0, s>>>(img, fy, fx, g, dfy, dfx, H, W, C, P);
}

}  // namespace

extern "C" {

int warp_fwd(const void* img, const void* fy, const void* fx, void* out, int B, int H, int W,
             int C, int Ho, int Wo, int zeros, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  auto launch = zeros ? &launch_fwd<true> : &launch_fwd<false>;
  launch(static_cast<const float*>(img), static_cast<const float*>(fy),
         static_cast<const float*>(fx), static_cast<float*>(out), B, H, W, C, Ho * Wo,
         static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

int warp_bwd(const void* img, const void* fy, const void* fx, const void* g, void* dfy,
             void* dfx, int B, int H, int W, int C, int Ho, int Wo, int zeros, void* stream) {
  if (!shapes_ok(B, H, W, C, Ho, Wo)) return (int)cudaErrorInvalidValue;
  auto launch = zeros ? &launch_bwd<true> : &launch_bwd<false>;
  launch(static_cast<const float*>(img), static_cast<const float*>(fy),
         static_cast<const float*>(fx), static_cast<const float*>(g), static_cast<float*>(dfy),
         static_cast<float*>(dfx), B, H, W, C, Ho * Wo, static_cast<cudaStream_t>(stream));
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
  kernel<<<(unsigned)((total + kImgThreads - 1) / kImgThreads), kImgThreads, 0, s>>>(
      static_cast<const float*>(fy), static_cast<const float*>(fx),
      static_cast<const float*>(g), static_cast<float*>(dimg), H, W, C, per_batch, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
