// Hopper (sm_90a) kernels for the photometric loss of the training step:
// per source, 0.85 * mean_c clip((1 - SSIM_7x7(P, T)) / 2, 0, 1)
//          + 0.15 * mean_c |T - P|
// (reference trainer.py:441-453, layers.py:13-46: a 7x7 box window with
// reflection padding, the edge not repeated), with the per-pixel min over
// [identity sources..., warped sources...] and the automask.
//
//   ssim_fwd replaces _call_fwd / _fwd_kernel
//     (sfmnext_tpu/ops/pallas/ssim_kernel.py): the loss map of each warped
//     source, [B,H,W,N] float32.
//   ssim_ident_min replaces _call_ident_min / _ident_min_kernel (same
//     file): the maps of the M identity (unwarped) sources plus the
//     tie-break noise, folded with the N maps of ssim_fwd into the
//     per-pixel min and its argument, in the reference's concat order
//     [ident..., reproj...] with the first minimum winning: an identity
//     takes a tie with a reprojection (trainer.py:509-530). arg < N means
//     warped source arg won (automask 1); arg = N + m, identity m.
//   ssim_bwd replaces _call_bwd / _bwd_kernel (same file): d(loss)/d(P) of
//     each warped source for a map cotangent, either per source ([B,H,W,N])
//     or the min's cotangent [B,H,W] routed by the argument (a source gets
//     it only where it won; _min_vjp_bwd's separate masked broadcast,
//     :549-551, happens here in the kernel). The target and the identity
//     sources are data and get no gradient.
//
// All images are NHWC float32 with C = 3, as the warp kernel writes them.
// With bf16 != 0 each input is rounded to bfloat16 as it is loaded (the
// loss dtype of a bf16 step; the Pallas path casts its inputs the same
// way, ssim_kernel.py:589-593) and the backward rounds its result to
// bfloat16, as autograd's cast back does; all arithmetic is float32.
//
// The forwards. One block of 256 threads owns a 16x32 tile of output
// pixels of one (batch, source) and loops over the three channels. It
// stages the tile's halo of P and T in shared memory, with reflected
// indices at the image edge, and runs the box filter separably: 7-tap sums
// along rows, then along columns, of p, t, p*p, t*t, p*t. The Pallas
// kernels take a whole [H,W] plane per grid step and filter with band
// matmuls because VMEM is large and the MXU otherwise idle; a GPU block
// tiles instead. ssim_fwd reads 2 warped frames and the target (float32)
// and writes the maps: 4*B*H*W*(3N + 3 + N) = 115 MB at the flagship step
// (B=8, 320x1024, N=M=2), 34 us at 3.35 TB/s; its float32 work (~100
// operations a pixel, source and channel) takes ~20 us at 67 TFLOP/s:
// bytes bound it. ssim_ident_min does the same for M identity frames, plus
// noise and the N maps in, the min and the argument out.
//
// The backward recomputes the window statistics from P and T, which it
// reads anyway, rather than reading 5 residual planes written by the
// forward (the Pallas kernel stores them only because recomputing blew
// Mosaic's scoped-VMEM stack, :204-209). From the pooled-map cotangents it
// applies the transposed reflect box filter, which differs from the
// forward one at the first and last three rows and columns
// (_axis_box_reflect_t, :119-138): with G zero outside the image,
//   B^T(G)(x) = sum_{|y-x|<=3} G(y) * (1 + [x>=1 && y<=3-x]
//                                        + [x<=n-2 && y>=2n-5-x]),
// the two extra terms being the taps that the reflection folds back; for
// 4 <= x <= n-5 both vanish. It reads P (N frames), T, the cotangent and
// the argument and writes dP: 4*B*H*W*(6N + 3 + 2) = 178 MB at the
// flagship step, 53 us at 3.35 TB/s, which bounds it; its float32 work
// (~160 operations a pixel, source and channel) takes ~30 us at 67
// TFLOP/s. On this card the instructions that the card issues bound it:
// a 16x32 tile needs its statistics on a 22x38 halo and row sums on 28x38,
// some 300 instructions an output pixel and channel. The design, against
// one block per (tile, source) looping over channels, each channel's halo
// loaded again with a reflection per value:
//  - a block stages, per tile, the target's halo for all three channels
//    at once (16-byte loads split into channel planes; reflection only in
//    tiles that touch the image's edge) and the map cotangent and the
//    min's argument once, then serves every warped source of the tile;
//  - each pass gives a thread a run of 2 to 5 outputs, whose 7-tap sums
//    slide over values held in registers (one load and two adds an output
//    and statistic instead of seven of each);
//  - the SSIM terms are skipped where the routed cotangent is zero (off
//    the image, a source that lost the min), with one reciprocal for the
//    three quotients;
//  - the tap counts run only in tiles within 4 pixels of the image's edge;
//  - dP leaves once a source as 16-byte vectors of whole tile rows;
//  - a one-wave grid of blocks walks the tiles, 3 blocks an SM (74 KB of
//    shared memory and 80 registers each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;              // the window's radius (7x7)
constexpr int kTW = 32, kTH = 16;  // output tile
constexpr int kThreads = 256;
constexpr int kRows = kTH / (kThreads / kTW);  // output rows per thread: 2
constexpr int kMaxSrc = 8;
constexpr float kInvK2 = 1.f / 49.f;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

struct Srcs {
  const float* p[kMaxSrc];
};
struct Outs {
  float* p[kMaxSrc];
};

// Reflect an index into [0, n) without repeating the edge (n >= 4 covers a
// radius of 3); halo cells further out, which no output reads, are clamped.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float load(const float* p, bool bf16) {
  const float x = __ldg(p);
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Stage channel c of P and T (one image each) over rows [ya, ya+rows) and
// columns [xa, xa+cols) into shared memory, pitch `cols`.
__device__ __forceinline__ void stage(const float* __restrict__ p, const float* __restrict__ t,
                                      float* sp, float* st, int c, int ya, int xa, int rows,
                                      int cols, int H, int W, bool bf16) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int y = reflect(ya + i / cols, H), x = reflect(xa + i % cols, W);
    const size_t off = ((size_t)y * W + x) * 3 + c;
    sp[i] = load(p + off, bf16);
    st[i] = load(t + off, bf16);
  }
}

// 7-tap sums along rows of the five statistics: out[s][r][q] over taps
// sp[r][q..q+6], for r < rows, q < out_cols.
__device__ __forceinline__ void row_sums(const float* sp, const float* st, float* hs, int rows,
                                         int in_cols, int out_cols) {
  const int plane = rows * out_cols;
  for (int i = threadIdx.x; i < plane; i += kThreads) {
    const int r = i / out_cols, q = i % out_cols;
    const float* a = sp + r * in_cols + q;
    const float* b = st + r * in_cols + q;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
    for (int k = 0; k < 2 * kR + 1; ++k) {
      const float pv = a[k], tv = b[k];
      s0 += pv;
      s1 += tv;
      s2 += pv * pv;
      s3 += tv * tv;
      s4 += pv * tv;
    }
    hs[i] = s0;
    hs[plane + i] = s1;
    hs[2 * plane + i] = s2;
    hs[3 * plane + i] = s3;
    hs[4 * plane + i] = s4;
  }
}

// The pooled maps at one pixel from the row sums hs (plane pitch `cols`,
// `plane` floats a statistic): 7-tap sums down rows r..r+6 of column q.
struct Pooled {
  float mu_p, mu_t, sp, st, spt;
};

__device__ __forceinline__ Pooled pooled(const float* hs, int plane, int cols, int r, int q) {
  float s[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < 2 * kR + 1; ++k) a += hs[j * plane + (r + k) * cols + q];
    s[j] = a;
  }
  Pooled m;
  m.mu_p = s[0] * kInvK2;
  m.mu_t = s[1] * kInvK2;
  m.sp = s[2] * kInvK2 - m.mu_p * m.mu_p;
  m.st = s[3] * kInvK2 - m.mu_t * m.mu_t;
  m.spt = s[4] * kInvK2 - m.mu_p * m.mu_t;
  return m;
}

__device__ __forceinline__ void ssim_terms(const Pooled& m, float& num, float& den) {
  num = (2.f * m.mu_p * m.mu_t + kC1) * (2.f * m.spt + kC2);
  den = (m.mu_p * m.mu_p + m.mu_t * m.mu_t + kC1) * (m.sp + m.st + kC2);
}

// Forward halo: the tile plus the window's radius.
constexpr int kFH = kTH + 2 * kR, kFW = kTW + 2 * kR;  // 22 x 38

struct FwdSmem {
  float sp[kFH * kFW], st[kFH * kFW];
  float hs[5 * kFH * kTW];
};

// The loss map of one source on this block's tile: acc[j] for output row
// ty + j * (kThreads / kTW), column tx. Every thread of the block calls it.
__device__ void source_map(const float* __restrict__ p, const float* __restrict__ t,
                           FwdSmem& sm, int y0, int x0, int H, int W, float weight, bool bf16,
                           float acc[kRows]) {
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  for (int c = 0; c < 3; ++c) {
    stage(p, t, sm.sp, sm.st, c, y0 - kR, x0 - kR, kFH, kFW, H, W, bf16);
    __syncthreads();
    row_sums(sm.sp, sm.st, sm.hs, kFH, kFW, kTW);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = ty + j * (kThreads / kTW);
      float num, den;
      ssim_terms(pooled(sm.hs, kFH * kTW, kTW, r, tx), num, den);
      const float dist = fminf(fmaxf((1.f - num / den) * 0.5f, 0.f), 1.f);
      const int ci = (r + kR) * kFW + tx + kR;
      const float l1 = fabsf(sm.st[ci] - sm.sp[ci]);
      acc[j] += (weight * dist + (1.f - weight) * l1) * (1.f / 3.f);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    ssim_fwd_kernel(Srcs preds, const float* __restrict__ target, float* __restrict__ maps, int N,
                    int H, int W, float weight, int bf16) {
  __shared__ FwdSmem sm;
  const int b = blockIdx.z / N, n = blockIdx.z % N;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const size_t img = (size_t)b * H * W * 3;
  float acc[kRows];
  source_map(preds.p[n] + img, target + img, sm, y0, x0, H, W, weight, bf16 != 0, acc);
  const int x = x0 + threadIdx.x % kTW;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + threadIdx.x / kTW + j * (kThreads / kTW);
    if (y < H && x < W) maps[(((size_t)b * H + y) * W + x) * N + n] = acc[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    ssim_ident_min_kernel(Srcs idents, const float* __restrict__ target,
                          const float* __restrict__ noise, const float* __restrict__ rmaps,
                          float* __restrict__ out_min, int* __restrict__ out_arg, int M, int N,
                          int H, int W, float weight, int bf16) {
  __shared__ FwdSmem sm;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int x = x0 + threadIdx.x % kTW;
  const size_t img = (size_t)b * H * W * 3;
  float best[kRows];
  int arg[kRows];
  for (int m = 0; m < M; ++m) {
    float acc[kRows];
    source_map(idents.p[m] + img, target + img, sm, y0, x0, H, W, weight, bf16 != 0, acc);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + threadIdx.x / kTW + j * (kThreads / kTW);
      const bool in = noise != nullptr && y < H && x < W;
      const float cur = acc[j] + (in ? noise[((size_t)y * W + x) * M + m] : 0.f);
      if (m == 0 || cur < best[j]) {  // first minimum wins
        best[j] = cur;
        arg[j] = N + m;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + threadIdx.x / kTW + j * (kThreads / kTW);
    if (y >= H || x >= W) continue;
    const size_t pix = ((size_t)b * H + y) * W + x;
    for (int k = 0; k < N; ++k) {
      const float r = rmaps[pix * N + k];
      if (r < best[j]) {  // strict: a tie stays with the identity or the earlier source
        best[j] = r;
        arg[j] = k;
      }
    }
    out_min[pix] = best[j];
    out_arg[pix] = arg[j];
  }
}

// How often output y's window reads input x under reflection, for
// |y - x| <= 3 with y, x in [0, n).
__device__ __forceinline__ float tap_count(int y, int x, int n) {
  return 1.f + ((x >= 1 && y <= 3 - x) ? 1.f : 0.f) +
         ((x <= n - 2 && y >= 2 * n - 5 - x) ? 1.f : 0.f);
}

// ---------------------------------------------------------------------------
// Backward: a block takes 16x32-pixel tiles in turn (a one-wave grid
// walks them all). Per tile it stages the target's halo (all
// three channels, tile + 6 each side) and the map cotangent and argument
// (tile + 3) once, then for each warped source the source's halo, and for
// each channel runs four passes, each thread taking a short run of
// outputs so that neighbouring taps come from registers:
//  1. the 7-tap row sums of p, t, p*p, t*t, p*t    [28 rows x 38 columns]
//  2. the window statistics down the columns, and from them the pooled
//     maps' cotangents (zero where the routed cotangent is)  [22 x 38]
//  3. the transposed filter along the rows          [22 x 32]
//  4. the transposed filter down the columns, the product rules and the L1
//     term: dP of the tile                            [16 x 32]
// dP leaves once a source, all channels, as 16-byte vectors.
// ---------------------------------------------------------------------------
constexpr int kBH = kTH + 4 * kR, kBW = kTW + 4 * kR;  // P and T halo: 28 x 44
constexpr int kGH = kTH + 2 * kR, kGW = kTW + 2 * kR;  // cotangent halo: 22 x 38
constexpr int kBwdThreads = 256;

struct BwdSmem {
  float t[3][kBH][kBW];  // the target's halo, channels apart
  float p[3][kBH][kBW];  // the source's halo
  float rs[5][kBH][kGW];  // pass 1's row sums; pass 3's output [3][kGH][kTW]
  float cot[3][kGH][kGW];  // pass 2: d/d(mu_p) total, d/d(sigma_p), d/d(sigma_pt)
  float g[kGH][kGW];       // the map cotangent: the min's, or this source's
  int won[kGH][kGW];       // the min's argument (this source's index without it)
  alignas(16) float out[kTH][3 * kTW];  // dP of the tile, channels interleaved
};
static_assert(3 * kGH * kTW <= 5 * kBH * kGW, "pass 3 reuses the row sums");
constexpr size_t kBwdSmem = sizeof(BwdSmem);

struct BwdArgs {
  Srcs preds;
  Outs dps;
  const float* target;
  const float* g;
  const int* arg;
  int B, N, H, W;
  float w_ssim, w_l1;  // the SSIM and L1 weights over the channel mean: weight / 3, (1 - weight) / 3
  int bf16;
};

__device__ __forceinline__ float rounded(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// threadIdx.x, opaque to the compiler: the staging loops' and the passes'
// indices are then computed where they are used, not hoisted out of the
// tile, source and channel loops into registers that the passes need.
__device__ __forceinline__ int opaque_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// The halo of the tile at (y0, x0) of image img (float32 NHWC, 3 channels)
// into dst [3][kBH][kBW], rounded to bf16 in the bf16 loss. Inside the
// image, with rows on 16-byte boundaries (W % 4 == 0), each row's span of
// 132 floats is read as 16-byte vectors and split into channels; else each
// value is read at its reflected row and column.
__device__ __forceinline__ void stage_halo(const BwdArgs& A, const float* __restrict__ img,
                                           float (*dst)[kBH][kBW], int b, int y0, int x0,
                                           bool inside) {
  const int ya = y0 - 2 * kR, xa = x0 - 2 * kR;
  if (inside) {
    // (x0 - 6) * 3 = 2 (mod 4): the span starts 2 floats into its first
    // vector. Thread t takes vector t % 34 of rows t / 34 + 7k, so where
    // its 4 floats go is fixed.
    constexpr int kVecs = (3 * kBW + 2 + 3) / 4;  // 34 a row
    constexpr int kRowStep = kBwdThreads / kVecs;  // 7
    static_assert(kBH % kRowStep == 0, "whole rounds of rows");
    const int t = opaque_tid();
    if (t < kVecs * kRowStep) {
      const int v = t % kVecs, r0 = t / kVecs;
      int to[4];  // the float's offset in dst[0], -1 outside the span
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * v + j - 2;
        to[j] = e >= 0 && e < 3 * kBW ? (e % 3) * kBH * kBW + e / 3 : -1;
      }
      const float* src = img + (((size_t)b * A.H + ya + r0) * A.W + xa) * 3 - 2 + 4 * v;
      float4 x[kBH / kRowStep];
#pragma unroll
      for (int k = 0; k < kBH / kRowStep; ++k)
        x[k] = __ldg(reinterpret_cast<const float4*>(src + (size_t)k * kRowStep * A.W * 3));
#pragma unroll
      for (int k = 0; k < kBH / kRowStep; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (to[j] >= 0) (&dst[0][r0 + k * kRowStep][0])[to[j]] = rounded((&x[k].x)[j], A.bf16);
    }
  } else {
    for (int i = opaque_tid(); i < kBH * kBW; i += kBwdThreads) {
      const int r = i / kBW, q = i - r * kBW;
      const float* src =
          img + (((size_t)b * A.H + reflect(ya + r, A.H)) * A.W + reflect(xa + q, A.W)) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) dst[ch][r][q] = rounded(__ldg(src + ch), A.bf16);
    }
  }
}

// The map cotangent over the cotangent halo (zero off the image): the min's
// and its argument (n < 0), or source n's.
__device__ __forceinline__ void stage_cotangent(const BwdArgs& A, BwdSmem& sm, int b, int n,
                                                int y0, int x0) {
  for (int i = opaque_tid(); i < kGH * kGW; i += kBwdThreads) {
    const int r = i / kGW, q = i - r * kGW;
    const int y = y0 - kR + r, x = x0 - kR + q;
    float g = 0.f;
    int won = n;
    if (y >= 0 && y < A.H && x >= 0 && x < A.W) {
      const size_t pix = ((size_t)b * A.H + y) * A.W + x;
      if (n < 0) {
        g = __ldg(A.g + pix);
        won = __ldg(A.arg + pix);
      } else {
        g = __ldg(A.g + pix * A.N + n);
      }
    }
    sm.g[r][q] = g;
    sm.won[r][q] = won;
  }
}

// Sums of v[o .. o + 6], o < R: the first directly, the others sliding.
template <int R>
__device__ __forceinline__ void window_sums(const float (&v)[R + 2 * kR], float (&out)[R]) {
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 2 * kR + 1; ++k) a += v[k];
  out[0] = a;
#pragma unroll
  for (int o = 1; o < R; ++o) {
    a += v[o + 2 * kR] - v[o - 1];
    out[o] = a;
  }
}

// The passes of channel c of source n on the staged tile.
__device__ __forceinline__ void channel_passes(const BwdArgs& A, BwdSmem& sm, int n, int c,
                                               int y0, int x0) {
  const int tid = opaque_tid();
  // 1. row sums: row r, columns 5j .. 5j + 4, one run a thread (the last
  // run's taps past column 43 read the next row, or the next array: they
  // feed only the run's columns past 37, which are dropped)
  constexpr int kRun1 = 5, kRuns1 = (kGW + kRun1 - 1) / kRun1;  // 8 runs a row
  static_assert(kBH * kRuns1 <= kBwdThreads, "pass 1 in one round");
  if (tid < kBH * kRuns1) {
    const int r = tid / kRuns1, q0 = kRun1 * (tid - r * kRuns1);
    float pv[kRun1 + 2 * kR], tv[kRun1 + 2 * kR];
#pragma unroll
    for (int k = 0; k < kRun1 + 2 * kR; ++k) {
      pv[k] = (&sm.p[c][r][0])[q0 + k];
      tv[k] = (&sm.t[c][r][0])[q0 + k];
    }
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      float v[kRun1 + 2 * kR], w[kRun1];
#pragma unroll
      for (int k = 0; k < kRun1 + 2 * kR; ++k)
        v[k] = s == 0 ? pv[k] : s == 1 ? tv[k] : s == 2 ? pv[k] * pv[k]
             : s == 3 ? tv[k] * tv[k] : pv[k] * tv[k];
      window_sums<kRun1>(v, w);
#pragma unroll
      for (int o = 0; o < kRun1; ++o)
        if (q0 + o < kGW) sm.rs[s][r][q0 + o] = w[o];
    }
  }
  __syncthreads();
  // 2. window statistics and the pooled maps' cotangents: column q, rows
  // 4j .. 4j + 3 (the last run reads 2 rows past the row sums, for its
  // dropped rows)
  const float w_ssim = A.w_ssim;
  for (int i = tid; i < kGW * 6; i += kBwdThreads) {
    const int q = i % kGW, r0 = 4 * (i / kGW);
    float st[4][5];  // the window means of rows r0 .. r0 + 3, statistic by statistic
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      float v[10], w[4];
#pragma unroll
      for (int k = 0; k < 10; ++k) v[k] = (&sm.rs[s][0][0])[(r0 + k) * kGW + q];
      window_sums<4>(v, w);
#pragma unroll
      for (int o = 0; o < 4; ++o) st[o][s] = w[o] * kInvK2;
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int r = r0 + o;
      if (r >= kGH) break;
      float gmu = 0.f, gsp = 0.f, gspt = 0.f;
      const float gm = sm.won[r][q] == n ? sm.g[r][q] : 0.f;
      if (gm != 0.f) {
        Pooled m;
        m.mu_p = st[o][0];
        m.mu_t = st[o][1];
        m.sp = st[o][2] - m.mu_p * m.mu_p;
        m.st = st[o][3] - m.mu_t * m.mu_t;
        m.spt = st[o][4] - m.mu_p * m.mu_t;
        float num, den;
        ssim_terms(m, num, den);
        // one reciprocal for the three quotients (the hardware's, within
        // 2 ulp of the division)
        const float rden = __fdividef(1.f, den);
        const float sv = (1.f - num * rden) * 0.5f;
        // the clamp passes the gradient for 0 <= s <= 1, as torch.clamp's
        const float gss = (sv >= 0.f && sv <= 1.f) ? gm * w_ssim : 0.f;
        const float dnum = gss * (-0.5f * rden);
        const float dden = gss * (0.5f * num * rden * rden);
        const float gmu_p = dnum * 2.f * m.mu_t * (2.f * m.spt + kC2) +
                            dden * 2.f * m.mu_p * (m.sp + m.st + kC2);
        gsp = dden * (m.mu_p * m.mu_p + m.mu_t * m.mu_t + kC1);
        gspt = dnum * 2.f * (2.f * m.mu_p * m.mu_t + kC1);
        // sigma_p = E[p^2] - mu_p^2 and sigma_pt = E[pt] - mu_p mu_t
        gmu = gmu_p - 2.f * m.mu_p * gsp - m.mu_t * gspt;
      }
      sm.cot[0][r][q] = gmu;
      sm.cot[1][r][q] = gsp;
      sm.cot[2][r][q] = gspt;
    }
  }
  __syncthreads();
  // 3. the transposed filter along the rows (tap counts within 4 columns of
  // the image's left and right edge): row r, columns 4j .. 4j + 3
  float(*ht)[kGH][kTW] = reinterpret_cast<float(*)[kGH][kTW]>(&sm.rs[0][0][0]);
  const bool x_edge = x0 < 4 || x0 + kTW > A.W - 4;
  for (int i = tid; i < kGH * (kTW / 4); i += kBwdThreads) {
    const int r = i / (kTW / 4), q0 = 4 * (i - r * (kTW / 4));
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float v[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) v[k] = sm.cot[s][r][q0 + k];
      if (x_edge) {
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int x = x0 + q0 + o;
          float a = 0.f;
#pragma unroll
          for (int d = -kR; d <= kR; ++d) a += tap_count(x + d, x, A.W) * v[o + kR + d];
          ht[s][r][q0 + o] = a;
        }
      } else {  // every weight 1
        float w[4];
        window_sums<4>(v, w);
#pragma unroll
        for (int o = 0; o < 4; ++o) ht[s][r][q0 + o] = w[o];
      }
    }
  }
  __syncthreads();
  // 4. the transposed filter down the columns, the product rules and the
  // L1 term: column q, rows 2j and 2j + 1
  const float w_l1 = A.w_l1;
  const bool y_edge = y0 < 4 || y0 + kTH > A.H - 4;
  {
    const int q = tid % kTW, r0 = 2 * (tid / kTW);
    float bs[3][2];  // the transposed column pass of rows r0, r0 + 1
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = ht[s][r0 + k][q];
      if (y_edge) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int y = y0 + r0 + o;
          float a = 0.f;
#pragma unroll
          for (int d = -kR; d <= kR; ++d) a += tap_count(y + d, y, A.H) * v[o + kR + d];
          bs[s][o] = a;
        }
      } else {  // every weight 1
        float w[2];
        window_sums<2>(v, w);
        bs[s][0] = w[0];
        bs[s][1] = w[1];
      }
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int r = r0 + o;
      const float pc = sm.p[c][r + 2 * kR][q + 2 * kR], tc = sm.t[c][r + 2 * kR][q + 2 * kR];
      float val = (bs[0][o] + 2.f * pc * bs[1][o] + tc * bs[2][o]) * kInvK2;
      const float gm = sm.won[r + kR][q + kR] == n ? sm.g[r + kR][q + kR] : 0.f;
      const float diff = tc - pc;
      const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
      val -= w_l1 * gm * sgn;  // d|t - p|/dp = -sign(t - p)
      sm.out[r][3 * q + c] = rounded(val, A.bf16);
    }
  }
  __syncthreads();  // pass 1 of the next channel overwrites ht
}

// dP of the tile to source n's gradient: 16-byte vectors where whole rows
// of the tile lie on 16-byte boundaries (W % 4 == 0).
__device__ __forceinline__ void write_tile(const BwdArgs& A, const BwdSmem& sm, float* dp, int b,
                                           int y0, int x0) {
  const int rows = min(kTH, A.H - y0), cols = min(kTW, A.W - x0);
  if (cols == kTW && A.W % 4 == 0) {
    constexpr int kVecs = 3 * kTW / 4;  // 24 a row
    for (int i = opaque_tid(); i < rows * kVecs; i += kBwdThreads) {
      const int r = i / kVecs, v = i - r * kVecs;
      float4* dst = reinterpret_cast<float4*>(dp + (((size_t)b * A.H + y0 + r) * A.W + x0) * 3);
      dst[v] = reinterpret_cast<const float4*>(sm.out[r])[v];
    }
  } else {
    for (int i = opaque_tid(); i < rows * 3 * cols; i += kBwdThreads) {
      const int r = i / (3 * cols), e = i - r * 3 * cols;
      dp[(((size_t)b * A.H + y0 + r) * A.W + x0) * 3 + e] = sm.out[r][e];
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads, 3) ssim_bwd_kernel(BwdArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  for (int tile = blockIdx.x;; tile += gridDim.x) {
    // the tile grid, computed anew each tile (opaque, so not kept in
    // registers across the passes)
    const int tiles_x = (A.W + kTW - 1) / kTW, tiles_yx = (A.H + kTH - 1) / kTH * tiles_x;
    int n_tiles = A.B * tiles_yx;
    asm volatile("" : "+r"(n_tiles));
    if (tile >= n_tiles) break;
    const int b = tile / tiles_yx, rest = tile - b * tiles_yx;
    const int y0 = (rest / tiles_x) * kTH, x0 = (rest % tiles_x) * kTW;
    // (the vectors of a row's span reach 2 floats past it)
    const bool inside = A.W % 4 == 0 && y0 >= 2 * kR && y0 + kTH + 2 * kR <= A.H &&
                        x0 >= 2 * kR && x0 + kTW + 2 * kR + 1 <= A.W;
    stage_halo(A, A.target, sm.t, b, y0, x0, inside);
    if (A.arg != nullptr) stage_cotangent(A, sm, b, -1, y0, x0);
    for (int n = 0; n < A.N; ++n) {
      stage_halo(A, A.preds.p[n], sm.p, b, y0, x0, inside);
      if (A.arg == nullptr) stage_cotangent(A, sm, b, n, y0, x0);
      __syncthreads();
      for (int c = 0; c < 3; ++c) channel_passes(A, sm, n, c, y0, x0);
      write_tile(A, sm, A.dps.p[n], b, y0, x0);
      __syncthreads();  // the next source's halo and cotangent, the next tile's
    }
  }
}

bool shapes_ok(int B, int N, int H, int W) {
  return B > 0 && N > 0 && N <= kMaxSrc && H >= 4 && W >= 4 && (long long)B * N <= 65535 &&
         (H + kTH - 1) / kTH <= 65535;
}

bool fill(Srcs& dst, void* const* src, int n) {
  for (int i = 0; i < n; ++i) {
    if (src[i] == nullptr) return false;
    dst.p[i] = static_cast<const float*>(src[i]);
  }
  return true;
}

bool fill(Outs& dst, void* const* src, int n) {
  for (int i = 0; i < n; ++i) {
    if (src[i] == nullptr) return false;
    dst.p[i] = static_cast<float*>(src[i]);
  }
  return true;
}

dim3 grid(int H, int W, int z) { return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, z); }

}  // namespace

extern "C" {

int ssim_fwd(void* const* preds, const void* target, void* maps, int B, int N, int H, int W,
             int bf16, float weight, void* stream) {
  Srcs s{};
  if (!shapes_ok(B, N, H, W) || !fill(s, preds, N)) return (int)cudaErrorInvalidValue;
  ssim_fwd_kernel<<<grid(H, W, B * N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(target), static_cast<float*>(maps), N, H, W, weight, bf16);
  return (int)cudaGetLastError();
}

int ssim_ident_min(void* const* idents, const void* target, const void* noise, const void* rmaps,
                   void* out_min, void* out_arg, int B, int M, int N, int H, int W, int bf16,
                   float weight, void* stream) {
  Srcs s{};
  if (!shapes_ok(B, M, H, W) || N < 1 || N > kMaxSrc || !fill(s, idents, M))
    return (int)cudaErrorInvalidValue;
  ssim_ident_min_kernel<<<grid(H, W, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(target), static_cast<const float*>(noise),
      static_cast<const float*>(rmaps), static_cast<float*>(out_min), static_cast<int*>(out_arg),
      M, N, H, W, weight, bf16);
  return (int)cudaGetLastError();
}

int ssim_bwd(void* const* preds, void* const* dps, const void* target, const void* g,
             const void* arg, int B, int N, int H, int W, int bf16, float weight, void* stream) {
  BwdArgs a{};
  if (!shapes_ok(B, N, H, W) || !fill(a.preds, preds, N) || !fill(a.dps, dps, N))
    return (int)cudaErrorInvalidValue;
  // one wave: the blocks the current card holds at once (queried once a card)
  static int wave[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  if (wave[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(ssim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kBwdSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssim_bwd_kernel, kBwdThreads,
                                                          kBwdSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    wave[dev] = max(1, per_sm * sms);
  }
  a.target = static_cast<const float*>(target);
  a.g = static_cast<const float*>(g);
  a.arg = static_cast<const int*>(arg);
  a.B = B;
  a.N = N;
  a.H = H;
  a.W = W;
  a.w_ssim = weight / 3.f;
  a.w_l1 = (1.f - weight) / 3.f;
  a.bf16 = bf16;
  const long long tiles = (long long)B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = tiles < wave[dev] ? (int)tiles : wave[dev];
  ssim_bwd_kernel<<<blocks, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
