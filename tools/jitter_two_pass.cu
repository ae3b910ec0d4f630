// The ColorJitter kernel as it stood before the one-pass cluster design of
// sfmnext_tpu_torch/csrc/jitter_kernel.cu, kept so that chip_smoke.py times
// that kernel beside it by one clock (built alone into its own library;
// the package never loads it). Two launches, 4-byte accesses.
//
// Hopper (sm_90a) kernel for the training step's on-device ColorJitter:
// per sample, brightness, contrast, saturation and hue in the sample's own
// order, each clamped to [0, 1], on every frame of the sample's stack
// (torchvision ColorJitter as datasets/mono_dataset.py:177-180 uses it).
//
//   color_jitter replaces color_jitter_pallas_cf / _kernel
//     (sfmnext_tpu/ops/pallas/jitter_kernel.py): img [B,F,H,W,3] float32
//     NHWC in, the same out. ops [B,5] int32 holds the op order (0
//     brightness, 1 contrast, 2 saturation, 3 hue) and do_jit; factors
//     [B,4] float32 (fb, fc, fs, fh). Each block loads its sample's row of
//     both, in place of the Pallas kernel's scalar prefetch. A sample with
//     do_jit 0 is copied bit for bit.
//
// The formulas are data/augment.py's (the JAX package's), float32
// throughout. Hue's floor-mods, (h / 6) % 1 and (h + shift) % 1, are
// x - floorf(x), non-negative for negative x (C's fmodf truncates), and
// floor(h * 6) can reach 6, which wraps to sector 0.
//
// Contrast blends with the grayscale mean of the frame as it stands after
// the ops before it: a reduction over H x W between two pointwise
// segments. Pass 1 applies the ops before contrast and writes one partial
// sum of the gray value per block, no atomics; pass 2 sums the frame's
// partials in a fixed order (every block of a frame gets the same bits),
// recomputes the prefix, applies contrast with the mean and the ops after
// it, and writes the result. Two reads and one write of the image, no
// intermediate image; samples that skip the jitter skip pass 1.
//
// What bounds it on an H100 at the flagship step (B=8, F=3, 320x1024):
// one read and one write of 94 MB of float32 (the prefix re-read of pass 1
// costs another read of the jittered samples) -> 56 us at 3.35 TB/s for
// the one read and write; about 60 float32 operations a pixel for the
// four ops (hue's divisions most of them) take ~10 us at 67 TFLOP/s:
// bytes bound it. One thread a pixel per step of a 1024-pixel block,
// neighbouring threads on neighbouring pixels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kPixPerBlock = kThreads * kPixPerThread;  // PIXELS_PER_BLOCK in ops/jitter_kernel.py

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

__device__ __forceinline__ float gray(const Rgb& x) {
  return x.r * 0.299f + x.g * 0.587f + x.b * 0.114f;
}

__device__ __forceinline__ float floor_mod1(float x) { return x - floorf(x); }

__device__ Rgb hue_shift(const Rgb& x, float shift) {
  const float maxc = fmaxf(fmaxf(x.r, x.g), x.b);
  const float minc = fminf(fminf(x.r, x.g), x.b);
  const float v = maxc, delta = maxc - minc;
  const float s = maxc > 0.f ? delta / fmaxf(maxc, 1e-8f) : 0.f;
  const float safe = delta > 0.f ? delta : 1.f;
  const float rc = (maxc - x.r) / safe, gc = (maxc - x.g) / safe, bc = (maxc - x.b) / safe;
  float h = maxc == x.r ? bc - gc : (maxc == x.g ? 2.f + rc - bc : 4.f + gc - rc);
  h = floor_mod1(h / 6.f);
  h = delta > 0.f ? h : 0.f;
  h = floor_mod1(h + shift);
  const float i = floorf(h * 6.f);
  const float f = h * 6.f - i;
  const float p = v * (1.f - s), q = v * (1.f - f * s), t = v * (1.f - (1.f - f) * s);
  Rgb o;
  switch ((int)i % 6) {
    case 0: o = {v, t, p}; break;
    case 1: o = {q, v, p}; break;
    case 2: o = {p, v, t}; break;
    case 3: o = {p, q, v}; break;
    case 4: o = {t, p, v}; break;
    default: o = {v, p, q}; break;
  }
  return {clip01(o.r), clip01(o.g), clip01(o.b)};
}

__device__ __forceinline__ Rgb blend(const Rgb& x, float f, float other) {
  const float g = 1.f - f;
  return {clip01(f * x.r + g * other), clip01(f * x.g + g * other), clip01(f * x.b + g * other)};
}

// One op; contrast (1) blends with `mean`.
__device__ __forceinline__ Rgb apply_op(int op, const Rgb& x, const float* fac, float mean) {
  switch (op) {
    case 0: return {clip01(x.r * fac[0]), clip01(x.g * fac[0]), clip01(x.b * fac[0])};
    case 1: return blend(x, fac[1], mean);
    case 2: return blend(x, fac[2], gray(x));
    case 3: return hue_shift(x, fac[3]);
    default: return x;
  }
}

struct Sample {
  int order[4];
  int jit;
  int contrast_at;  // position of contrast in the order (4 if absent)
  float fac[4];
};

__device__ __forceinline__ Sample load_sample(const int* ops, const float* factors, int b) {
  Sample s;
  s.contrast_at = 4;
  for (int j = 0; j < 4; ++j) {
    s.order[j] = ops[b * 5 + j];
    if (s.order[j] == 1 && s.contrast_at == 4) s.contrast_at = j;
    s.fac[j] = factors[b * 4 + j];
  }
  s.jit = ops[b * 5 + 4];
  return s;
}

// A block's sum of v, the same order every time: warp shuffles, then warp
// 0 over the warp sums. The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Pass 1: grid (blocks per frame, B*F); partials [B*F, blocks per frame].
__global__ void __launch_bounds__(kThreads)
    jitter_partials_kernel(const float* __restrict__ img, const int* __restrict__ ops,
                           const float* __restrict__ factors, float* __restrict__ partials, int F,
                           long long P) {
  __shared__ float warp_sums[kThreads / 32];
  const int frame = blockIdx.y, b = frame / F;
  const Sample s = load_sample(ops, factors, b);
  if (!s.jit || s.contrast_at == 4) return;  // pass 2 reads no mean
  const float* src = img + (size_t)frame * P * 3;
  float acc = 0.f;
  for (int k = 0; k < kPixPerThread; ++k) {
    const long long i = (long long)blockIdx.x * kPixPerBlock + k * kThreads + threadIdx.x;
    if (i >= P) break;
    Rgb x = {__ldg(src + 3 * i), __ldg(src + 3 * i + 1), __ldg(src + 3 * i + 2)};
    for (int j = 0; j < s.contrast_at; ++j) x = apply_op(s.order[j], x, s.fac, 0.f);
    acc += gray(x);
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[(size_t)frame * gridDim.x + blockIdx.x] = acc;
}

// Pass 2: the same grid; writes out.
__global__ void __launch_bounds__(kThreads)
    jitter_apply_kernel(const float* __restrict__ img, const int* __restrict__ ops,
                        const float* __restrict__ factors, const float* __restrict__ partials,
                        float* __restrict__ out, int F, long long P) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float mean_s;
  const int frame = blockIdx.y, b = frame / F;
  const Sample s = load_sample(ops, factors, b);
  const float* src = img + (size_t)frame * P * 3;
  float* dst = out + (size_t)frame * P * 3;
  if (!s.jit) {  // copy through, bit for bit
    for (int k = 0; k < kPixPerThread * 3; ++k) {
      const long long i = (long long)blockIdx.x * kPixPerBlock * 3 + k * kThreads + threadIdx.x;
      if (i < 3 * P) dst[i] = __ldg(src + i);
    }
    return;
  }
  float mean = 0.f;
  if (s.contrast_at < 4) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
      acc += partials[(size_t)frame * gridDim.x + i];
    acc = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) mean_s = acc / (float)P;
    __syncthreads();
    mean = mean_s;
  }
  for (int k = 0; k < kPixPerThread; ++k) {
    const long long i = (long long)blockIdx.x * kPixPerBlock + k * kThreads + threadIdx.x;
    if (i >= P) break;
    Rgb x = {__ldg(src + 3 * i), __ldg(src + 3 * i + 1), __ldg(src + 3 * i + 2)};
    for (int j = 0; j < 4; ++j) x = apply_op(s.order[j], x, s.fac, mean);
    dst[3 * i] = x.r;
    dst[3 * i + 1] = x.g;
    dst[3 * i + 2] = x.b;
  }
}

}  // namespace

extern "C" {

int color_jitter(const void* img, const void* ops, const void* factors, void* out, void* partials,
                 int B, int F, int H, int W, int n_partials, void* stream) {
  const long long P = (long long)H * W;
  if (B <= 0 || F <= 0 || P <= 0 || (long long)B * F > 65535) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kPixPerBlock - 1) / kPixPerBlock;
  if (blocks > 0x7fffffffLL || (long long)n_partials != blocks * B * F)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(B * F));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  jitter_partials_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(img), static_cast<const int*>(ops),
      static_cast<const float*>(factors), static_cast<float*>(partials), F, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  jitter_apply_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(img), static_cast<const int*>(ops),
      static_cast<const float*>(factors), static_cast<const float*>(partials),
      static_cast<float*>(out), F, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
