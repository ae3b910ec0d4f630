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
// Design. One block of 256 threads owns a 16x32 tile of output pixels of
// one (batch, source) and loops over the three channels. It stages the
// tile's halo of P and T in shared memory, with reflected indices at the
// image edge, and runs the box filter separably: 7-tap sums along rows,
// then along columns, of p, t, p*p, t*t, p*t. The Pallas kernels take a
// whole [H,W] plane per grid step and filter with band matmuls because
// VMEM is large and the MXU otherwise idle; a GPU block tiles instead.
// The backward recomputes the window statistics from P and T, which it
// reads anyway, rather than reading 5 residual planes written by the
// forward (the Pallas kernel stores them only because recomputing blew
// Mosaic's scoped-VMEM stack, :204-209): the forward writes just its maps.
// It computes the pooled-map cotangents on the tile plus a 3-pixel halo
// (so P and T over a 6-pixel halo), then applies the transposed reflect
// box filter, which differs from the forward one at the first and last
// three rows and columns (_axis_box_reflect_t, :119-138): with G zero
// outside the image,
//   B^T(G)(x) = sum_{|y-x|<=3} G(y) * (1 + [x>=1 && y<=3-x]
//                                        + [x<=n-2 && y>=2n-5-x]),
// the two extra terms being the taps that the reflection folds back.
//
// What bounds them on an H100 at the flagship step (B=8, 320x1024, N=M=2):
//   ssim_fwd reads 2 warped frames and the target (float32) and writes
//     the maps: 4*B*H*W*(3N + 3 + N) = 115 MB -> 34 us at 3.35 TB/s; its
//     float32 work (~100 operations a pixel, source and channel) takes
//     ~20 us at 67 TFLOP/s: bytes bound it. A tile's halo (22x38 loaded
//     for 16x32 outputs) overlaps its neighbours', which L1/L2 should serve.
//   ssim_ident_min: the same for M identity frames, plus noise and the N
//     maps in, the min and the argument out: 4*B*H*W*(3M + 3 + N + 2).
//   ssim_bwd reads P (N frames), T, the cotangent and the argument and
//     writes dP (N frames): 4*B*H*W*(6N + 3 + 2) = 178 MB -> 53 us; with
//     the statistics recomputed its arithmetic is ~2.5x the forward's,
//     still under the bytes.

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

// Backward regions: P and T over the tile plus 6, the pooled-map
// cotangents over the tile plus 3.
constexpr int kBH = kTH + 4 * kR, kBW = kTW + 4 * kR;  // 28 x 44
constexpr int kGH = kTH + 2 * kR, kGW = kTW + 2 * kR;  // 22 x 38

struct BwdSmem {
  float sp[kBH * kBW], st[kBH * kBW];
  float hs[5 * kBH * kGW];  // row sums; then the transposed row pass [3][kGH][kTW]
  float gs[3 * kGH * kGW];  // d/d(mu_p) total, d/d(sigma_p), d/d(sigma_pt)
};
static_assert(3 * kGH * kTW <= 5 * kBH * kGW, "the transposed pass reuses the row sums");
static_assert(sizeof(BwdSmem) <= 48 * 1024, "static shared memory");

// The cotangent of source n's map at pixel pix: per source ([.., N]) or
// the min's, routed to the source that won.
__device__ __forceinline__ float map_cotangent(const float* __restrict__ g,
                                               const int* __restrict__ arg, size_t pix, int n,
                                               int N) {
  if (arg == nullptr) return g[pix * N + n];
  return arg[pix] == n ? g[pix] : 0.f;
}

// How often output y's window reads input x under reflection, for
// |y - x| <= 3 with y, x in [0, n).
__device__ __forceinline__ float tap_count(int y, int x, int n) {
  return 1.f + ((x >= 1 && y <= 3 - x) ? 1.f : 0.f) +
         ((x <= n - 2 && y >= 2 * n - 5 - x) ? 1.f : 0.f);
}

__global__ void __launch_bounds__(kThreads)
    ssim_bwd_kernel(Srcs preds, Outs dps, const float* __restrict__ target,
                    const float* __restrict__ g, const int* __restrict__ arg, int N, int H, int W,
                    float weight, int bf16) {
  __shared__ BwdSmem sm;
  const int b = blockIdx.z / N, n = blockIdx.z % N;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int tx = threadIdx.x % kTW, ty = threadIdx.x / kTW;
  const size_t img = (size_t)b * H * W * 3;
  const float* p = preds.p[n] + img;
  const float* t = target + img;
  const bool rnd = bf16 != 0;
  const float w_ssim = weight / 3.f, w_l1 = (1.f - weight) / 3.f;
  float dp[kRows][3];

  for (int c = 0; c < 3; ++c) {
    stage(p, t, sm.sp, sm.st, c, y0 - 2 * kR, x0 - 2 * kR, kBH, kBW, H, W, rnd);
    __syncthreads();
    row_sums(sm.sp, sm.st, sm.hs, kBH, kBW, kGW);
    __syncthreads();
    // cotangents of the pooled maps at pixels (y0-3+r, x0-3+q); zero off
    // the image, where no loss is taken
    for (int i = threadIdx.x; i < kGH * kGW; i += kThreads) {
      const int r = i / kGW, q = i % kGW;
      const int y = y0 - kR + r, x = x0 - kR + q;
      float gmu = 0.f, gsp = 0.f, gspt = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const float gm = map_cotangent(g, arg, ((size_t)b * H + y) * W + x, n, N);
        const Pooled m = pooled(sm.hs, kBH * kGW, kGW, r, q);
        float num, den;
        ssim_terms(m, num, den);
        const float s = (1.f - num / den) * 0.5f;
        // the clamp passes the gradient for 0 <= s <= 1, as torch.clamp's
        const float gss = (s >= 0.f && s <= 1.f) ? gm * w_ssim : 0.f;
        const float dnum = gss * (-0.5f / den);
        const float dden = gss * (0.5f * num / (den * den));
        const float gmu_p = dnum * 2.f * m.mu_t * (2.f * m.spt + kC2) +
                            dden * 2.f * m.mu_p * (m.sp + m.st + kC2);
        gsp = dden * (m.mu_p * m.mu_p + m.mu_t * m.mu_t + kC1);
        gspt = dnum * 2.f * (2.f * m.mu_p * m.mu_t + kC1);
        // sigma_p = E[p^2] - mu_p^2 and sigma_pt = E[pt] - mu_p mu_t
        gmu = gmu_p - 2.f * m.mu_p * gsp - m.mu_t * gspt;
      }
      sm.gs[i] = gmu;
      sm.gs[kGH * kGW + i] = gsp;
      sm.gs[2 * kGH * kGW + i] = gspt;
    }
    __syncthreads();
    // transposed filter along rows: ht[s][r][q] at column x0+q
    float* ht = sm.hs;
    for (int i = threadIdx.x; i < kGH * kTW; i += kThreads) {
      const int r = i / kTW, q = i % kTW;
      const int x = x0 + q;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int d = -kR; d <= kR; ++d) {
        const float cw = tap_count(x + d, x, W);
        const int gi = r * kGW + q + kR + d;
        a0 += cw * sm.gs[gi];
        a1 += cw * sm.gs[kGH * kGW + gi];
        a2 += cw * sm.gs[2 * kGH * kGW + gi];
      }
      ht[i] = a0;
      ht[kGH * kTW + i] = a1;
      ht[2 * kGH * kTW + i] = a2;
    }
    __syncthreads();
    // transposed filter along columns, the product rules and the L1 term
    const int x = x0 + tx;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int rr = ty + j * (kThreads / kTW);
      const int y = y0 + rr;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
      for (int d = -kR; d <= kR; ++d) {
        const float cw = tap_count(y + d, y, H);
        const int hi = (rr + kR + d) * kTW + tx;
        b0 += cw * ht[hi];
        b1 += cw * ht[kGH * kTW + hi];
        b2 += cw * ht[2 * kGH * kTW + hi];
      }
      const int ci = (rr + 2 * kR) * kBW + tx + 2 * kR;
      const float pc = sm.sp[ci], tc = sm.st[ci];
      float v = (b0 + 2.f * pc * b1 + tc * b2) * kInvK2;
      if (y < H && x < W) {
        const float gm = map_cotangent(g, arg, ((size_t)b * H + y) * W + x, n, N);
        const float diff = tc - pc;
        const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
        v -= w_l1 * gm * sgn;  // d|t - p|/dp = -sign(t - p)
      }
      dp[j][c] = v;
    }
    __syncthreads();
  }
  const int x = x0 + tx;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + ty + j * (kThreads / kTW);
    if (y >= H || x >= W) continue;
    float* o = dps.p[n] + img + ((size_t)y * W + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = rnd ? __bfloat162float(__float2bfloat16_rn(dp[j][c])) : dp[j][c];
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
  Srcs s{};
  Outs o{};
  if (!shapes_ok(B, N, H, W) || !fill(s, preds, N) || !fill(o, dps, N))
    return (int)cudaErrorInvalidValue;
  ssim_bwd_kernel<<<grid(H, W, B * N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, o, static_cast<const float*>(target), static_cast<const float*>(g),
      static_cast<const int*>(arg), N, H, W, weight, bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
