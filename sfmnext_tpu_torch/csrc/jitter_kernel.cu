// Hopper (sm_90a) kernel for the training step's on-device ColorJitter:
// per sample, brightness, contrast, saturation and hue in the sample's own
// order, each clamped to [0, 1], on every frame of the sample's stack
// (torchvision ColorJitter as datasets/mono_dataset.py:177-180 uses it).
//
//   color_jitter replaces color_jitter_pallas_cf / _kernel
//     (sfmnext_tpu/ops/pallas/jitter_kernel.py): img [B,F,H,W,3] float32
//     NHWC in, the same out. ops [B,5] int32 holds the op order (0
//     brightness, 1 contrast, 2 saturation, 3 hue) and do_jit; factors
//     [B,4] float32 (fb, fc, fs, fh). A block loads its frame's row of
//     both, in place of the Pallas kernel's scalar prefetch. A sample with
//     do_jit 0 is copied bit for bit.
//
// The formulas are data/augment.py's (the JAX package's), float32
// throughout. Hue's quotients are products with the hardware's reciprocal
// (within 2 ulp of the division; the HSV round trip is continuous across
// its sectors, so an ulp that moves floor(h * 6) moves the result by about
// an ulp). Hue's floor-mods, (h / 6) % 1 and (h + shift) % 1, are
// x - floorf(x), non-negative for negative x (C's fmodf truncates), and
// floor(h * 6) can reach 6, which wraps to sector 0.
//
// Contrast blends with the grayscale mean of the frame as it stands after
// the ops before it: a reduction over H x W between two pointwise segments,
// and every order holds contrast. What bounds the kernel on an H100 at the
// flagship step (B=8, F=3, 320x1024, 6 of 8 samples jittered): one read
// and one write of 94 MB of float32, 56 us at 3.35 TB/s; the four ops
// (about 60 float32 operations a pixel) take ~10 us at 67 TFLOP/s: bytes
// bound it. The design:
//  - one launch: a persistent grid of thread-block clusters (kCluster
//    blocks on neighbouring SMs, as many clusters as the card holds at
//    once), each cluster walking whole frames; every block of a cluster
//    takes a contiguous span of the frame, each warp chunks of 32 groups of
//    4 pixels (48 bytes a lane);
//  - a jittered frame in two phases: (1) the block copies its span into
//    shared memory by cp.async, as much of it as fits (at the flagship
//    frame 151 of 160 chunks; the rest is read directly, and again in
//    phase 2), each warp all its chunks at once, then applies the ops
//    before contrast to each chunk as it arrives, keeps the result in place
//    and sums the gray values; (2) after the cluster's barrier every block
//    sums the cluster's block sums through distributed shared memory in
//    rank order, so each gets the same bits and the mean is deterministic,
//    applies contrast and the ops after it in place and writes each chunk
//    out as 16-byte vectors of consecutive lanes (evict-first);
//  - a frame without jitter is a straight copy of 16-byte vectors, eight
//    in flight a thread, with no barrier;
//  - the op order is a switch per op over a lane's 4 pixels (a uniform
//    branch; sequences fixed at compile time measured slower).
// One block of 512 threads an SM, all its shared memory keeping the span.
// An H100 holds 7 clusters of 16 (112 of its 132 SMs), 7 frames in flight.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;  // blocks a cluster: non-portable on sm_90 (the launch allows it)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkVecs = 96;  // 16-byte vectors of a chunk: 32 lanes x 4 pixels x 3 floats
constexpr int kChunkBytes = 16 * kChunkVecs;
constexpr int kCopyUnroll = 8;  // vectors a thread has in flight in a copy

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

__device__ __forceinline__ float gray(const Rgb& x) {
  return x.r * 0.299f + x.g * 0.587f + x.b * 0.114f;
}

__device__ __forceinline__ float floor_mod1(float x) { return x - floorf(x); }

__device__ __forceinline__ Rgb hue_shift(const Rgb& x, float shift) {
  const float maxc = fmaxf(fmaxf(x.r, x.g), x.b);
  const float minc = fminf(fminf(x.r, x.g), x.b);
  const float v = maxc, delta = maxc - minc;
  const float s = maxc > 0.f ? delta * __fdividef(1.f, fmaxf(maxc, 1e-8f)) : 0.f;
  const float inv = __fdividef(1.f, delta > 0.f ? delta : 1.f);
  const float rc = (maxc - x.r) * inv, gc = (maxc - x.g) * inv, bc = (maxc - x.b) * inv;
  float h = maxc == x.r ? bc - gc : (maxc == x.g ? 2.f + rc - bc : 4.f + gc - rc);
  h = floor_mod1(h * (1.f / 6.f));
  h = delta > 0.f ? h : 0.f;
  h = floor_mod1(h + shift);
  const float i = floorf(h * 6.f);
  const float f = h * 6.f - i;
  const float p = v * (1.f - s), q = v * (1.f - f * s), t = v * (1.f - (1.f - f) * s);
  // the sector: h * 6 can round up to 6, which is sector 0; the picks of
  // (r, g, b) are (v,t,p) (q,v,p) (p,v,t) (p,q,v) (t,p,v) (v,p,q)
  int k = (int)i;
  k = k >= 6 ? k - 6 : k;
  const float r = (k == 0 || k == 5) ? v : k == 1 ? q : k == 4 ? t : p;
  const float g = (k == 1 || k == 2) ? v : k == 0 ? t : k == 3 ? q : p;
  const float b = (k == 3 || k == 4) ? v : k == 2 ? t : k == 5 ? q : p;
  return {clip01(r), clip01(g), clip01(b)};
}

__device__ __forceinline__ Rgb blend(const Rgb& x, float f, float other) {
  const float g = 1.f - f;
  return {clip01(f * x.r + g * other), clip01(f * x.g + g * other), clip01(f * x.b + g * other)};
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
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.order[j] = __ldg(ops + b * 5 + j);
    if (s.order[j] == 1 && s.contrast_at == 4) s.contrast_at = j;
    s.fac[j] = __ldg(factors + b * 4 + j);
  }
  s.jit = __ldg(ops + b * 5 + 4);
  return s;
}

// Ops from .. to - 1 of the sample's order on kPix pixels; contrast blends
// with `mean`. One uniform branch an op, not a pixel.
template <int kPix>
__device__ __forceinline__ void apply_ops(const Sample& s, int from, int to, Rgb (&x)[kPix],
                                          float mean) {
  for (int j = from; j < to; ++j) {
    switch (s.order[j]) {
      case 0:
#pragma unroll
        for (int p = 0; p < kPix; ++p)
          x[p] = {clip01(x[p].r * s.fac[0]), clip01(x[p].g * s.fac[0]), clip01(x[p].b * s.fac[0])};
        break;
      case 1:
#pragma unroll
        for (int p = 0; p < kPix; ++p) x[p] = blend(x[p], s.fac[1], mean);
        break;
      case 2:
#pragma unroll
        for (int p = 0; p < kPix; ++p) x[p] = blend(x[p], s.fac[2], gray(x[p]));
        break;
      case 3:
#pragma unroll
        for (int p = 0; p < kPix; ++p) x[p] = hue_shift(x[p], s.fac[3]);
        break;
      default:
        break;
    }
  }
}

// A group: 4 pixels as 3 float4 where frames lie on 16-byte rows (P % 4 ==
// 0), else one pixel as 3 floats (and then nothing is kept).
template <int kPix>
struct Group;

template <>
struct Group<4> {
  static __device__ __forceinline__ void load(const float* base, long long g, Rgb (&x)[4]) {
    const float4* p = reinterpret_cast<const float4*>(base) + 3 * g;
    const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    x[0] = {a.x, a.y, a.z}, x[1] = {a.w, b.x, b.y}, x[2] = {b.z, b.w, c.x}, x[3] = {c.y, c.z, c.w};
  }
  static __device__ __forceinline__ void store(float* base, long long g, const Rgb (&x)[4]) {
    float4* p = reinterpret_cast<float4*>(base) + 3 * g;
    __stcs(p, make_float4(x[0].r, x[0].g, x[0].b, x[1].r));
    __stcs(p + 1, make_float4(x[1].g, x[1].b, x[2].r, x[2].g));
    __stcs(p + 2, make_float4(x[2].b, x[3].r, x[3].g, x[3].b));
  }
  // a lane's group in a kept chunk, as it lies in memory
  static __device__ __forceinline__ void take(const float4* chunk, Rgb (&x)[4]) {
    const int l = 3 * (threadIdx.x & 31);
    const float4 a = chunk[l], b = chunk[l + 1], c = chunk[l + 2];
    x[0] = {a.x, a.y, a.z}, x[1] = {a.w, b.x, b.y}, x[2] = {b.z, b.w, c.x}, x[3] = {c.y, c.z, c.w};
  }
  static __device__ __forceinline__ void keep(float4* chunk, const Rgb (&x)[4]) {
    const int l = 3 * (threadIdx.x & 31);
    chunk[l] = make_float4(x[0].r, x[0].g, x[0].b, x[1].r);
    chunk[l + 1] = make_float4(x[1].g, x[1].b, x[2].r, x[2].g);
    chunk[l + 2] = make_float4(x[2].b, x[3].r, x[3].g, x[3].b);
  }
  static __device__ __forceinline__ void copy(const float* src, float* dst, long long g0,
                                              long long g1) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
    for (long long i = 3 * g0 + threadIdx.x; i < 3 * g1; i += kCopyUnroll * kThreads) {
      float4 v[kCopyUnroll];
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k)
        if (i + k * kThreads < 3 * g1) v[k] = __ldcs(s + i + k * kThreads);
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k)
        if (i + k * kThreads < 3 * g1) __stcs(d + i + k * kThreads, v[k]);
    }
  }
};

template <>
struct Group<1> {
  static __device__ __forceinline__ void load(const float* base, long long g, Rgb (&x)[1]) {
    x[0] = {__ldg(base + 3 * g), __ldg(base + 3 * g + 1), __ldg(base + 3 * g + 2)};
  }
  static __device__ __forceinline__ void store(float* base, long long g, const Rgb (&x)[1]) {
    base[3 * g] = x[0].r, base[3 * g + 1] = x[0].g, base[3 * g + 2] = x[0].b;
  }
  static __device__ __forceinline__ void take(const float4*, Rgb (&)[1]) {}
  static __device__ __forceinline__ void keep(float4*, const Rgb (&)[1]) {}
  static __device__ __forceinline__ void copy(const float* src, float* dst, long long g0,
                                              long long g1) {
    for (long long i = 3 * g0 + threadIdx.x; i < 3 * g1; i += kThreads) dst[i] = __ldg(src + i);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are in flight (at most
// 7 for n > 7: a longer wait, never a shorter one).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A block's sum of v, the same order every time: warp shuffles, then warp
// 0 over the warp sums. The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

struct Args {
  const float* img;
  const int* ops;
  const float* factors;
  float* out;
  int B, F;
  long long P;  // pixels a frame
  int kept;     // chunks of its span a block keeps in shared memory
};

// Grid: whole clusters; cluster c walks frames c, c + clusters, ... Block
// `rank` of a cluster takes groups [g0, g1) of each frame, in chunks: warp
// w takes chunks w, w + kWarps, ...; the first `held` chunks of the span
// stay in shared memory between the two phases.
template <int kPix>
__global__ void __launch_bounds__(kThreads, 1) jitter_kernel(Args A) {
  extern __shared__ float4 kept[];  // [A.kept][kChunkVecs]
  __shared__ float warp_sums[kWarps];
  __shared__ float block_sums[2];  // this block's, by the parity of the cluster's barriers
  __shared__ float mean_s;
  using G = Group<kPix>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int clusters = gridDim.x / kCluster;
  const long long groups = A.P / kPix;
  const long long g0 = groups * rank / kCluster, g1 = groups * (rank + 1) / kCluster;
  const int chunks = (int)((g1 - g0 + 31) / 32);
  const int held = min(chunks, A.kept);  // kept chunks of this block's span
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const long long frames = (long long)A.B * A.F;
  int phase = 0;
  for (long long frame = blockIdx.x / kCluster; frame < frames; frame += clusters) {
    const Sample s = load_sample(A.ops, A.factors, (int)(frame / A.F));
    const float* src = A.img + (size_t)frame * A.P * 3;
    float* dst = A.out + (size_t)frame * A.P * 3;
    if (!s.jit) {
      G::copy(src, dst, g0, g1);
      continue;
    }
    const int c = s.contrast_at;
    float mean = 0.f;
    if (c < 4) {
      // phase 1: every kept chunk of the warp's copied in at once (a group
      // of copies a chunk), then the ops before contrast and the gray sum
      // chunk by chunk as they arrive, the result kept in place; the chunks
      // past what fits read directly
      const float4* src4 = reinterpret_cast<const float4*>(src) + 3 * g0;
      int issued = 0;
      for (int q = w; q < held; q += kWarps, ++issued) {
        const int valid = 3 * (int)min(32LL, g1 - g0 - 32LL * q);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (lane + 32 * j < valid)
            cp_async16(kept + q * kChunkVecs + lane + 32 * j, src4 + 32LL * 3 * q + lane + 32 * j);
        cp_async_commit();
      }
      float acc = 0.f;
      int done = 0;
      for (int q = w; q < chunks; q += kWarps) {
        const long long g = g0 + 32LL * q + lane;
        Rgb x[kPix];
        if (q < held) {
          cp_async_wait(issued - ++done);
          __syncwarp();
          if (g < g1) G::take(kept + q * kChunkVecs, x);
        } else if (g < g1) {
          G::load(src, g, x);
        }
        if (g < g1) {
          apply_ops(s, 0, c, x, 0.f);
#pragma unroll
          for (int p = 0; p < kPix; ++p) acc += gray(x[p]);
          if (q < held) G::keep(kept + q * kChunkVecs, x);
        }
      }
      acc = block_sum(acc, warp_sums);
      if (t == 0) block_sums[phase & 1] = acc;
      cluster.sync();  // every block's sum is in place
      if (t == 0) {
        float v[kCluster];
#pragma unroll
        for (int r = 0; r < kCluster; ++r) v[r] = *cluster.map_shared_rank(&block_sums[phase & 1], r);
        float total = 0.f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) total += v[r];
        mean_s = total / (float)A.P;
      }
      __syncthreads();
      mean = mean_s;
      ++phase;
    }
    // phase 2: contrast and the ops after it (all four where contrast is
    // absent); a kept chunk leaves as 16-byte vectors of consecutive lanes
    float4* dst4 = reinterpret_cast<float4*>(dst) + 3 * g0;
    for (int q = w; q < chunks; q += kWarps) {
      const long long g = g0 + 32LL * q + lane;
      const bool in_smem = c < 4 && q < held;
      if (g < g1) {
        Rgb x[kPix];
        if (in_smem) {
          G::take(kept + q * kChunkVecs, x);
        } else {
          G::load(src, g, x);
          apply_ops(s, 0, c, x, 0.f);
        }
        apply_ops(s, c, 4, x, mean);
        if (in_smem) G::keep(kept + q * kChunkVecs, x);
        else G::store(dst, g, x);
      }
      if (in_smem) {
        __syncwarp();
        const int valid = 3 * (int)min(32LL, g1 - g0 - 32LL * q);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (lane + 32 * j < valid)
            __stcs(dst4 + 32LL * 3 * q + lane + 32 * j, kept[q * kChunkVecs + lane + 32 * j]);
        __syncwarp();  // read out before the next frame's copies land
      }
    }
  }
  cluster.sync();  // no block leaves while another may read its sums
}

// A kernel instance's launch on a card: the clusters it holds at once and
// the chunks a block can keep.
struct Launch {
  int clusters = 0, kept = 0;
};
Launch launch_cache[2][16];  // by kernel instance and card

// The chunks of a block's span at P pixels a frame.
long long span_chunks(long long P) {
  const int pix = P % 4 == 0 ? 4 : 1;
  return ((P / pix + kCluster - 1) / kCluster + 31) / 32;
}

// The launch record of instance kPix on the current card, filled at first use.
template <int kPix>
cudaError_t launch_record(Launch*& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16) return cudaErrorInvalidDevice;
  Launch& L = launch_cache[kPix == 4][dev];
  out = &L;
  if (L.clusters > 0) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(jitter_kernel<kPix>);
  // all the SM's shared memory beside the block's static part keeps chunks
  int per_sm = 0, reserved = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const int kept = kPix == 4 ? (per_sm - reserved - (int)attr.sharedSizeBytes) / kChunkBytes : 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kept * kChunkBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = kCluster;
  dims.val.clusterDim.y = dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)kept * kChunkBytes;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  L.kept = kept;
  L.clusters = clusters;
  return cudaSuccess;
}

template <int kPix>
cudaError_t launch(Args a, cudaStream_t stream) {
  Launch* L = nullptr;
  cudaError_t err = launch_record<kPix>(L);
  if (err != cudaSuccess) return err;
  // a span's chunks past what a block keeps are read again in phase 2
  const long long chunks = span_chunks(a.P);
  a.kept = (int)(chunks < L->kept ? chunks : L->kept);
  const long long frames = (long long)a.B * a.F;
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = kCluster;
  dims.val.clusterDim.y = dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((frames < L->clusters ? frames : L->clusters) * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)a.kept * kChunkBytes;
  cfg.stream = stream;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, jitter_kernel<kPix>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

int color_jitter(const void* img, const void* ops, const void* factors, void* out, int B, int F,
                 int H, int W, void* stream) {
  const long long P = (long long)H * W;
  if (B <= 0 || F <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.img = static_cast<const float*>(img);
  a.ops = static_cast<const int*>(ops);
  a.factors = static_cast<const float*>(factors);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.F = F;
  a.P = P;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(P % 4 == 0 ? launch<4>(a, st) : launch<1>(a, st));
}

// The grid color_jitter launches on the current card for frames of H x W
// (at least as many frames as clusters): the clusters of kCluster blocks,
// one wave, as many as the card holds at once; the chunks a block keeps in
// shared memory; its span's chunks.
int color_jitter_grid(int H, int W, int* clusters, int* kept, int* chunks) {
  const long long P = (long long)H * W;
  if (P <= 0) return (int)cudaErrorInvalidValue;
  Launch* L = nullptr;
  const cudaError_t err = P % 4 == 0 ? launch_record<4>(L) : launch_record<1>(L);
  if (err != cudaSuccess) return (int)err;
  *chunks = (int)span_chunks(P);
  *clusters = L->clusters;
  *kept = *chunks < L->kept ? *chunks : L->kept;
  return 0;
}

}  // extern "C"
