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
// The forwards. The Pallas kernels take a whole [H,W] plane per grid step
// and filter with band matmuls because VMEM is large and the MXU otherwise
// idle; a GPU block tiles instead and runs the box filter separably: 7-tap
// sums along rows, then along columns, of p, t, p*p, t*t, p*t. ssim_fwd
// reads 2 warped frames and the target (float32) and writes the maps:
// 4*B*H*W*(3N + 3 + N) = 115 MB at the flagship step (B=8, 320x1024,
// N=M=2), 34 us at 3.35 TB/s; its float32 work (~100 operations a pixel,
// source and channel) takes ~23 us at 67 TFLOP/s. ssim_ident_min does the
// same for M identity frames, plus noise and the N maps in, the min and
// the argument out. On this card the instructions and the shared-memory
// traffic bind them, not the bytes: staging a channel at a time with each
// value reflected and loaded alone, all seven taps of both box passes at
// every output and the target's statistics for every source come to some
// 200 instructions an output pixel, channel and source (6x the bound). The
// design:
//  - a one-wave grid of blocks walks 32x32 tiles; a block serves every
//    source of its tile, so the target's halo is staged and its window
//    means and variances taken once a tile, kept in registers;
//  - a halo's rows arrive by cp.async as 16-byte vectors of their NHWC span
//    (the image's rows reflected; its reflected columns filled in only in
//    tiles at its left or right edge), into one of three turning buffers
//    while the block filters the halo before; no split into channels, no
//    value loaded alone where W % 4 == 0;
//  - both passes run on the NHWC floats: pass 1 sums columns of float
//    pairs, pass 2 takes a pixel's three channels from the same 16-byte
//    loads; each thread slides its 7-tap sums over a run of values held in
//    registers (one load and two adds an output and statistic, not seven);
//  - a pixel's N maps leave from one thread at the tile's end (one 8- or
//    16-byte vector where N is 2, 4 or 8); the identity min folds its M
//    maps and their noise in registers, reads the pixel's N warped maps as
//    one vector and writes the min and the argument as 16-byte vectors of
//    4 pixels.
// No one part bounds them now (PERF.md): both passes, the copies and the
// stores each take their share, and the 128 registers a thread needs fill
// the register file at 2 blocks (16 warps) an SM.
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
constexpr int kTW = 32, kTH = 16;  // output tile: columns; the backward's rows
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

// The window statistics at one pixel: the means, the variances and the
// covariance of p and t.
struct Pooled {
  float mu_p, mu_t, sp, st, spt;
};

__device__ __forceinline__ void ssim_terms(const Pooled& m, float& num, float& den) {
  num = (2.f * m.mu_p * m.mu_t + kC1) * (2.f * m.spt + kC2);
  den = (m.mu_p * m.mu_p + m.mu_t * m.mu_t + kC1) * (m.sp + m.st + kC2);
}

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

// ---------------------------------------------------------------------------
// Forwards: a block takes 32x32-pixel tiles in turn (a one-wave grid walks
// them all). Per tile it takes the target's window means and variances
// once, then for each source runs two passes, each thread taking a run of
// outputs so that neighbouring taps come from registers:
//  1. the 7-tap column sums of s, s*s, s*t        [32 rows x 38 pixels x 3]
//  2. the row sums, the SSIM and L1 terms and the channel mean: the
//     source's map at 4 pixels of a row a thread  [32 x 32]
// The halos stay as they arrive, NHWC rows of 40 pixels (slot s holds pixel
// x0 - 4 + s, halo column s - 1), and so do the column sums. Three halo
// buffers turn: the tile's target, the source being filtered, and the next
// source (or the next tile's target) arriving by cp.async. A thread keeps
// its pixels' target statistics, and the maps (ssim_fwd) or the running
// min (ssim_ident_min), in registers until the tile's end.
// ---------------------------------------------------------------------------
constexpr int kFTH = 32, kFTW = 32;                       // forward tile
constexpr int kFHH = kFTH + 2 * kR, kFHW = kFTW + 2 * kR;  // halo: 38 x 38
constexpr int kSlots = kFHW + 2;                          // pixels a halo row holds: 40
constexpr int kRawPitch = 3 * kSlots;                     // 120 floats
constexpr int kRawVecs = kRawPitch / 4;                   // 30 16-byte vectors
constexpr int kFwdThreads = 256;
constexpr int kRun1 = 4, kRuns1 = kFTH / kRun1;  // pass 1: 4 rows a thread, 8 runs a column
constexpr int kRun2 = 4, kRuns2 = kFTW / kRun2;   // pass 2: 4 columns a thread, 8 runs a row
static_assert(kFTH * kRuns2 == kFwdThreads, "pass 2 takes one round");
constexpr int kPairs = kRawPitch / 2;            // pass 1's float pairs a row: 60
// cp.async: thread t copies vector t % 30 of rows t / 30 + 8k
constexpr int kVecRowStep = kFwdThreads / kRawVecs;                  // 8
constexpr int kVecRounds = (kFHH + kVecRowStep - 1) / kVecRowStep;   // 5
// Widths off 16-byte rows (W % 4 != 0) read value by value: the cells a thread takes.
constexpr int kScalarRounds = (kFHH * kSlots + kFwdThreads - 1) / kFwdThreads;  // 6

typedef float Raw[kFHH][kRawPitch];

struct FwdSmem {
  Raw raw[3];                     // halos as they arrive
  float cs[3][kFTH][kRawPitch];  // pass 1's column sums [statistic], NHWC as the halos
};
constexpr size_t kFwdSmem = sizeof(FwdSmem);

struct FwdArgs {
  Srcs srcs;           // the sources: warped (ssim_fwd) or identity frames
  const float* target;
  float* maps;         // ssim_fwd: [B,H,W,N]
  const float* noise;  // ssim_ident_min: [1,H,W,N] or null
  const float* rmaps;  // ssim_ident_min: the warped maps [B,H,W,R]
  float* out_min;
  int* out_arg;
  int B, N, R, H, W;
  float weight;
  int bf16;
};

struct FwdTile {
  int b, y0, x0;
};

__device__ __forceinline__ int fwd_tiles(const FwdArgs& A) {
  return A.B * ((A.H + kFTH - 1) / kFTH) * ((A.W + kFTW - 1) / kFTW);
}

__device__ __forceinline__ FwdTile fwd_tile(const FwdArgs& A, int tile) {
  const int tiles_x = (A.W + kFTW - 1) / kFTW, tiles_yx = (A.H + kFTH - 1) / kFTH * tiles_x;
  FwdTile T;
  T.b = tile / tiles_yx;
  const int rest = tile - T.b * tiles_yx, ty = rest / tiles_x;
  T.y0 = ty * kFTH;
  T.x0 = (rest - ty * tiles_x) * kFTW;
  return T;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where W % 4 == 0 a halo row's pixels inside the image, [pa, pb), arrive
// as whole 16-byte vectors (x0 % kFTW == 0).
__device__ __forceinline__ int copy_begin(const FwdTile& T) { return max(T.x0 - kR - 1, 0); }
__device__ __forceinline__ int copy_end(const FwdArgs& A, const FwdTile& T) {
  return min(T.x0 - kR - 1 + kSlots, A.W);
}

// Start copying image img's halo rows for tile T into buf (rows reflected
// at the image's top and bottom).
__device__ __forceinline__ void fetch_halo(const FwdArgs& A, const float* __restrict__ img,
                                           const FwdTile& T, Raw& buf) {
  const int t = opaque_tid();
  if (A.W % 4 == 0 && t < kRawVecs * kVecRowStep) {
    const int pa = copy_begin(T), v = t % kRawVecs, r0 = t / kRawVecs;
    if (4 * v < 3 * (copy_end(A, T) - pa)) {
      float* dst = &buf[0][3 * (pa - T.x0 + kR + 1) + 4 * v];
#pragma unroll
      for (int k = 0; k < kVecRounds; ++k) {
        const int r = r0 + k * kVecRowStep;
        if (r < kFHH) {
          const int y = reflect(T.y0 - kR + r, A.H);
          cp_async16(dst + r * kRawPitch, img + (((size_t)T.b * A.H + y) * A.W + pa) * 3 + 4 * v);
        }
      }
    }
  }
  cp_async_commit();
}

// Whether a halo needs prepare_halo once it has arrived.
__device__ __forceinline__ bool needs_prepare(const FwdArgs& A, const FwdTile& T, int round) {
  return round || A.W % 4 != 0 || T.x0 < kR + 1 || T.x0 - kR - 1 + kSlots > A.W;
}

// Complete the halo that arrived in buf: the reflected columns at the
// image's left and right edge (no output reads the slots further out), and
// with `round` every value rounded to bf16 (the target's; a source's are
// rounded as the passes read them). Where W % 4 != 0 nothing arrived: every
// value is read at its reflected row and column.
__device__ __forceinline__ void prepare_halo(const FwdArgs& A, const float* __restrict__ img,
                                             const FwdTile& T, Raw& buf, int round) {
  const int t = opaque_tid();
  if (A.W % 4 != 0) {
    float x[kScalarRounds][3];  // all loads in flight before the stores
#pragma unroll
    for (int k = 0; k < kScalarRounds; ++k) {
      const int i = t + k * kFwdThreads;
      if (i < kFHH * kSlots) {
        const int r = i / kSlots, s = i - r * kSlots;
        const float* src = img + (((size_t)T.b * A.H + reflect(T.y0 - kR + r, A.H)) * A.W +
                                  reflect(T.x0 - kR - 1 + s, A.W)) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) x[k][c] = __ldg(src + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kScalarRounds; ++k) {
      const int i = t + k * kFwdThreads;
      if (i < kFHH * kSlots)
#pragma unroll
        for (int c = 0; c < 3; ++c) buf[0][i * 3 + c] = rounded(x[k][c], round);
    }
    return;
  }
  const int pa = copy_begin(T);
  if (round) {  // the vectors that arrived, in place
    const int nvec = 3 * (copy_end(A, T) - pa) / 4;
    for (int i = t; i < kFHH * nvec; i += kFwdThreads) {
      const int r = i / nvec;
      float4* p = reinterpret_cast<float4*>(&buf[r][3 * (pa - T.x0 + kR + 1)]) + (i - r * nvec);
      float4 v = *p;
      v.x = rounded(v.x, 1), v.y = rounded(v.y, 1), v.z = rounded(v.z, 1), v.w = rounded(v.w, 1);
      *p = v;
    }
  }
  // pixels -3 .. -1 and W .. W + 2 from their reflections (rounding is
  // idempotent, so a value read while another thread rounds it is the same)
  for (int i = t; i < kFHH * 18; i += kFwdThreads) {
    const int r = i / 18, k = (i - r * 18) / 3, c = i - r * 18 - 3 * k;
    const int x = k < 3 ? k - 3 : A.W + k - 3, s = x - T.x0 + kR + 1;
    if (s >= 1 && s <= kFHW)
      buf[r][3 * s + c] = rounded(buf[r][3 * (reflect(x, A.W) - T.x0 + kR + 1) + c], round);
  }
}

// Pass 1: cs[k][r][f] = the sum over d < 7 of statistic k at halo row
// r + d, float f of the row (pixel slot f / 3, channel f % 3): t, t*t (the
// target's, kSource false) or s, s*s, s*t. A thread takes a pair of floats
// of 4 rows (the source's rounded as they are read).
template <bool kSource>
__device__ __forceinline__ void column_pass(FwdSmem& sm, const Raw& tb, const Raw& sb, int bf16) {
  for (int i = opaque_tid(); i < kPairs * kRuns1; i += kFwdThreads) {  // 480: two rounds
    const int j = i / kPairs, f = 2 * (i - j * kPairs), r0 = kRun1 * j;
    float2 tv[kRun1 + 2 * kR], sv[kRun1 + 2 * kR];
#pragma unroll
    for (int k = 0; k < kRun1 + 2 * kR; ++k) {
      tv[k] = *reinterpret_cast<const float2*>(&tb[r0 + k][f]);
      if (kSource) {
        const float2 x = *reinterpret_cast<const float2*>(&sb[r0 + k][f]);
        sv[k] = make_float2(rounded(x.x, bf16), rounded(x.y, bf16));
      }
    }
#pragma unroll
    for (int st = 0; st < (kSource ? 3 : 2); ++st) {
      float w[2][kRun1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[kRun1 + 2 * kR];
#pragma unroll
        for (int k = 0; k < kRun1 + 2 * kR; ++k) {
          const float t = h ? tv[k].y : tv[k].x, p = h ? sv[k].y : sv[k].x;
          v[k] = kSource ? (st == 0 ? p : st == 1 ? p * p : p * t) : (st == 0 ? t : t * t);
        }
        window_sums<kRun1>(v, w[h]);
      }
#pragma unroll
      for (int o = 0; o < kRun1; ++o)
        *reinterpret_cast<float2*>(&sm.cs[st][r0 + o][f]) = make_float2(w[0][o], w[1][o]);
    }
  }
}

// The 7-column sums at the thread's pixels (columns q0 .. q0 + 3) of a
// column-sum row, each channel: w[c][o], from nine 16-byte loads.
__device__ __forceinline__ void row_sums(const float* row, int q0, float (&w)[3][kRun2]) {
  const float4* p = reinterpret_cast<const float4*>(row + 3 * q0);
  float f[36];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float4 x = p[k];
    f[4 * k] = x.x, f[4 * k + 1] = x.y, f[4 * k + 2] = x.z, f[4 * k + 3] = x.w;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v[kRun2 + 2 * kR];  // output q's taps: slots q + 1 .. q + 7
#pragma unroll
    for (int k = 0; k < kRun2 + 2 * kR; ++k) v[k] = f[3 + c + 3 * k];
    window_sums<kRun2>(v, w[c]);
  }
}

// A halo's values at the thread's pixels (row r, columns q0 .. q0 + 3),
// x[3 o + c]: three 16-byte loads.
__device__ __forceinline__ void centres(const Raw& buf, int r, int q0, float (&x)[3 * kRun2]) {
  const float4* p = reinterpret_cast<const float4*>(&buf[r + kR][3 * (q0 + kR + 1)]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 v = p[k];
    x[4 * k] = v.x, x[4 * k + 1] = v.y, x[4 * k + 2] = v.z, x[4 * k + 3] = v.w;
  }
}

// The target's window means and variances at a thread's pixels, by channel.
struct TargetStats {
  float mu[3][kRun2], var[3][kRun2];
};

__device__ __forceinline__ void target_stats(const FwdSmem& sm, int r, int q0, TargetStats& ts) {
  float s1[3][kRun2], s3[3][kRun2];
  row_sums(sm.cs[0][r], q0, s1);
  row_sums(sm.cs[1][r], q0, s3);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int o = 0; o < kRun2; ++o) {
      ts.mu[c][o] = s1[c][o] * kInvK2;
      ts.var[c][o] = s3[c][o] * kInvK2 - ts.mu[c][o] * ts.mu[c][o];
    }
}

// Pass 2: the source's map at the thread's pixels.
__device__ __forceinline__ void source_map(const FwdSmem& sm, const TargetStats& ts, const Raw& tb,
                                           const Raw& sb, int r, int q0, float weight, int bf16,
                                           float (&acc)[kRun2]) {
  float dist[3][kRun2];
  {
    float s0[3][kRun2], s2[3][kRun2], s4[3][kRun2];
    row_sums(sm.cs[0][r], q0, s0);
    row_sums(sm.cs[1][r], q0, s2);
    row_sums(sm.cs[2][r], q0, s4);
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int o = 0; o < kRun2; ++o) {
        Pooled m;
        m.mu_p = s0[c][o] * kInvK2;
        m.mu_t = ts.mu[c][o];
        m.sp = s2[c][o] * kInvK2 - m.mu_p * m.mu_p;
        m.st = ts.var[c][o];
        m.spt = s4[c][o] * kInvK2 - m.mu_p * m.mu_t;
        float num, den;
        ssim_terms(m, num, den);
        // the hardware's division, within 2 ulp (den >= C1 * C2)
        dist[c][o] = fminf(fmaxf((1.f - __fdividef(num, den)) * 0.5f, 0.f), 1.f);
      }
  }
  float tc[3 * kRun2], pc[3 * kRun2];
  centres(tb, r, q0, tc);
  centres(sb, r, q0, pc);
#pragma unroll
  for (int o = 0; o < kRun2; ++o) acc[o] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int o = 0; o < kRun2; ++o) {
      const float l1 = fabsf(tc[3 * o + c] - rounded(pc[3 * o + c], bf16));
      acc[o] += (weight * dist[c][o] + (1.f - weight) * l1) * (1.f / 3.f);
    }
}

// The walk over the tiles. The halos come in the order target, sources
// 0 .. N-1, the next tile's target, each copied into the free buffer while
// the block filters the one before. Out takes each source's map (source)
// and closes the tile (tile).
template <class Out>
__device__ __forceinline__ void walk_tiles(const FwdArgs& A, FwdSmem& sm, Out& out) {
  const int n_tiles = fwd_tiles(A);
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  const int r = threadIdx.x / kRuns2, q0 = kRun2 * (threadIdx.x % kRuns2);
  FwdTile T = fwd_tile(A, tile);
  int tb = 0;  // the target's buffer
  fetch_halo(A, A.target, T, sm.raw[tb]);
  cp_async_wait_all();
  __syncthreads();
  if (needs_prepare(A, T, A.bf16)) {
    prepare_halo(A, A.target, T, sm.raw[tb], A.bf16);
    __syncthreads();
  }
  for (;;) {
    // here the target's halo is complete, and the last tile's passes are done
    const int next = tile + gridDim.x;
    const FwdTile U = next < n_tiles ? fwd_tile(A, next) : T;
    int sb = tb == 2 ? 0 : tb + 1;  // the source's buffer
    fetch_halo(A, A.srcs.p[0], T, sm.raw[sb]);
    column_pass<false>(sm, sm.raw[tb], sm.raw[tb], 0);
    __syncthreads();
    TargetStats ts;
    target_stats(sm, r, q0, ts);
    cp_async_wait_all();
    __syncthreads();  // source 0 has arrived; the target's column sums are read
    if (needs_prepare(A, T, 0)) {
      prepare_halo(A, A.srcs.p[0], T, sm.raw[sb], 0);
      __syncthreads();
    }
    for (int n = 0; n < A.N; ++n) {
      const int nb = 3 - tb - sb;  // the free buffer
      const bool last = n + 1 == A.N;
      if (!last) fetch_halo(A, A.srcs.p[n + 1], T, sm.raw[nb]);
      else if (next < n_tiles) fetch_halo(A, A.target, U, sm.raw[nb]);
      column_pass<true>(sm, sm.raw[tb], sm.raw[sb], A.bf16);
      __syncthreads();
      float acc[kRun2];
      source_map(sm, ts, sm.raw[tb], sm.raw[sb], r, q0, A.weight, A.bf16, acc);
      out.source(A, T, n, r, q0, acc);
      cp_async_wait_all();
      __syncthreads();  // the passes are done; the next halo has arrived
      if (!last && needs_prepare(A, T, 0)) {
        prepare_halo(A, A.srcs.p[n + 1], T, sm.raw[nb], 0);
        __syncthreads();
      } else if (last && next < n_tiles && needs_prepare(A, U, A.bf16)) {
        prepare_halo(A, A.target, U, sm.raw[nb], A.bf16);
        __syncthreads();
      }
      sb = nb;
    }
    out.tile(A, T, r, q0);
    if (next >= n_tiles) break;
    tile = next;
    T = U;
    tb = sb;
  }
}

// ssim_fwd's pixels: the N <= kN maps of a pixel leave together.
template <int kN>
struct MapsOut {
  float m[kN][kRun2];

  __device__ __forceinline__ void source(const FwdArgs&, const FwdTile&, int n, int, int,
                                         const float (&acc)[kRun2]) {
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (k == n)
#pragma unroll
        for (int o = 0; o < kRun2; ++o) m[k][o] = acc[o];
  }

  __device__ __forceinline__ void tile(const FwdArgs& A, const FwdTile& T, int r, int q0) {
    const int y = T.y0 + r;
    if (y >= A.H) return;
#pragma unroll
    for (int o = 0; o < kRun2; ++o) {
      const int x = T.x0 + q0 + o;
      if (x >= A.W) break;
      float* dst = A.maps + (((size_t)T.b * A.H + y) * A.W + x) * A.N;
      if constexpr (kN % 4 == 0) {
        if (A.N == kN) {
#pragma unroll
          for (int k = 0; k < kN; k += 4)
            reinterpret_cast<float4*>(dst)[k / 4] =
                make_float4(m[k][o], m[k + 1][o], m[k + 2][o], m[k + 3][o]);
          continue;
        }
      }
      if constexpr (kN == 2) {
        if (A.N == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(m[0][o], m[1][o]);
          continue;
        }
      }
#pragma unroll
      for (int k = 0; k < kN; ++k)
        if (k < A.N) dst[k] = m[k][o];
    }
  }
};

// ssim_ident_min's pixels: the identity maps plus noise folded as they
// come (the first minimum wins), then the R warped maps by strict <.
struct MinOut {
  float best[kRun2];
  unsigned args;  // the argument of pixel o in byte o (R + M <= 16)

  __device__ __forceinline__ void set_arg(int o, int a) {
    args = (args & ~(0xffu << (8 * o))) | ((unsigned)a << (8 * o));
  }
  __device__ __forceinline__ int arg(int o) const { return (args >> (8 * o)) & 0xff; }

  __device__ __forceinline__ void source(const FwdArgs& A, const FwdTile& T, int m, int r, int q0,
                                         const float (&acc)[kRun2]) {
    const int y = T.y0 + r;
#pragma unroll
    for (int o = 0; o < kRun2; ++o) {
      const int x = T.x0 + q0 + o;
      const bool in = A.noise != nullptr && y < A.H && x < A.W;
      const float cur = acc[o] + (in ? __ldg(A.noise + ((size_t)y * A.W + x) * A.N + m) : 0.f);
      if (m == 0 || cur < best[o]) {
        best[o] = cur;
        set_arg(o, A.R + m);
      }
    }
  }

  __device__ __forceinline__ void tile(const FwdArgs& A, const FwdTile& T, int r, int q0) {
    const int y = T.y0 + r;
    if (y >= A.H) return;
    const size_t pix0 = ((size_t)T.b * A.H + y) * A.W + T.x0 + q0;
#pragma unroll
    for (int o = 0; o < kRun2; ++o) {
      if (T.x0 + q0 + o >= A.W) break;
      const float* src = A.rmaps + (pix0 + o) * A.R;
      float v[kMaxSrc];
      if (A.R % 4 == 0) {
#pragma unroll
        for (int k = 0; k < kMaxSrc; k += 4)
          if (k < A.R) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(src) + k / 4);
            v[k] = x.x, v[k + 1] = x.y, v[k + 2] = x.z, v[k + 3] = x.w;
          }
      } else if (A.R == 2) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(src));
        v[0] = x.x, v[1] = x.y;
      } else {
#pragma unroll
        for (int k = 0; k < kMaxSrc; ++k)
          if (k < A.R) v[k] = __ldg(src + k);
      }
#pragma unroll
      for (int k = 0; k < kMaxSrc; ++k)
        if (k < A.R && v[k] < best[o]) {  // strict: a tie stays with the identity or the earlier source
          best[o] = v[k];
          set_arg(o, k);
        }
    }
    if (A.W % 4 == 0 && T.x0 + q0 + kRun2 <= A.W) {  // 16-byte rows
      *reinterpret_cast<float4*>(A.out_min + pix0) = make_float4(best[0], best[1], best[2], best[3]);
      *reinterpret_cast<int4*>(A.out_arg + pix0) = make_int4(arg(0), arg(1), arg(2), arg(3));
    } else {
#pragma unroll
      for (int o = 0; o < kRun2; ++o)
        if (T.x0 + q0 + o < A.W) {
          A.out_min[pix0 + o] = best[o];
          A.out_arg[pix0 + o] = arg(o);
        }
    }
  }
};

// (2 blocks an SM: 100,800 bytes of shared memory and at most 128
// registers each; the 8-source instance, whose maps take 32 registers, 1)
template <int kN>
__global__ void __launch_bounds__(kFwdThreads, kN > 4 ? 1 : 2) ssim_fwd_kernel(FwdArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MapsOut<kN> out;
  walk_tiles(A, *reinterpret_cast<FwdSmem*>(smem_raw), out);
}

__global__ void __launch_bounds__(kFwdThreads, 2) ssim_ident_min_kernel(FwdArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MinOut out;
  walk_tiles(A, *reinterpret_cast<FwdSmem*>(smem_raw), out);
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
  return B > 0 && N > 0 && N <= kMaxSrc && H >= 4 && W >= 4;
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

// A kernel's occupancy on each card, queried once a card.
struct Occupancy {
  int per_sm[16], sms[16];
};

// The blocks of `kernel` (threads and dynamic shared memory as launched)
// that one SM of the current card holds at once, and the card's SMs.
cudaError_t occupancy(const void* kernel, int threads, size_t smem, Occupancy& occ, int& per_sm,
                      int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (occ.per_sm[dev] == 0) {
    int p = 0, s = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kernel, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    occ.sms[dev] = s;
    occ.per_sm[dev] = max(1, p);
  }
  per_sm = occ.per_sm[dev];
  sms = occ.sms[dev];
  return cudaSuccess;
}

// One block a tile, or one wave of blocks walking the tiles where they are
// more: the grid of a kernel that loops over tiles of th x tw pixels.
cudaError_t one_wave_grid(const void* kernel, int threads, size_t smem, Occupancy& occ, int B,
                          int H, int W, int th, int tw, int& blocks) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy(kernel, threads, smem, occ, per_sm, sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  blocks = (int)min(tiles, (long long)per_sm * sms);
  return cudaSuccess;
}

Occupancy occ_fwd[4], occ_min, occ_bwd;  // ssim_fwd_kernel<1, 2, 4, 8>, ...

// ssim_fwd_kernel's instance for N sources and its occupancy record.
void fwd_instance(int N, void (*&kernel)(FwdArgs), Occupancy*& occ) {
  if (N == 1) kernel = ssim_fwd_kernel<1>, occ = &occ_fwd[0];
  else if (N == 2) kernel = ssim_fwd_kernel<2>, occ = &occ_fwd[1];
  else if (N <= 4) kernel = ssim_fwd_kernel<4>, occ = &occ_fwd[2];
  else kernel = ssim_fwd_kernel<8>, occ = &occ_fwd[3];
}

cudaError_t launch_fwd(void (*kernel)(FwdArgs), Occupancy& occ, const FwdArgs& a,
                       cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = one_wave_grid(reinterpret_cast<const void*>(kernel), kFwdThreads,
                                        kFwdSmem, occ, a.B, a.H, a.W, kFTH, kFTW, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kFwdThreads, kFwdSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ssim_fwd(void* const* preds, const void* target, void* maps, int B, int N, int H, int W,
             int bf16, float weight, void* stream) {
  FwdArgs a{};
  if (!shapes_ok(B, N, H, W) || !fill(a.srcs, preds, N)) return (int)cudaErrorInvalidValue;
  a.target = static_cast<const float*>(target);
  a.maps = static_cast<float*>(maps);
  a.B = B;
  a.N = N;
  a.H = H;
  a.W = W;
  a.weight = weight;
  a.bf16 = bf16;
  void (*kernel)(FwdArgs) = nullptr;
  Occupancy* occ = nullptr;
  fwd_instance(N, kernel, occ);
  return (int)launch_fwd(kernel, *occ, a, static_cast<cudaStream_t>(stream));
}

int ssim_ident_min(void* const* idents, const void* target, const void* noise, const void* rmaps,
                   void* out_min, void* out_arg, int B, int M, int N, int H, int W, int bf16,
                   float weight, void* stream) {
  FwdArgs a{};
  if (!shapes_ok(B, M, H, W) || N < 1 || N > kMaxSrc || !fill(a.srcs, idents, M))
    return (int)cudaErrorInvalidValue;
  a.target = static_cast<const float*>(target);
  a.noise = static_cast<const float*>(noise);
  a.rmaps = static_cast<const float*>(rmaps);
  a.out_min = static_cast<float*>(out_min);
  a.out_arg = static_cast<int*>(out_arg);
  a.B = B;
  a.N = M;
  a.R = N;
  a.H = H;
  a.W = W;
  a.weight = weight;
  a.bf16 = bf16;
  return (int)launch_fwd(ssim_ident_min_kernel, occ_min, a, static_cast<cudaStream_t>(stream));
}

int ssim_bwd(void* const* preds, void* const* dps, const void* target, const void* g,
             const void* arg, int B, int N, int H, int W, int bf16, float weight, void* stream) {
  BwdArgs a{};
  if (!shapes_ok(B, N, H, W) || !fill(a.preds, preds, N) || !fill(a.dps, dps, N))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = one_wave_grid(reinterpret_cast<const void*>(ssim_bwd_kernel),
                                        kBwdThreads, kBwdSmem, occ_bwd, B, H, W, kTH, kTW, blocks);
  if (err != cudaSuccess) return (int)err;
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
  ssim_bwd_kernel<<<blocks, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of an SSIM kernel that one SM of the current card holds at once
// (kernel 0: ssim_fwd's instance for n sources, 1: ssim_ident_min, 2:
// ssim_bwd); negative: a CUDA error, negated. A launch's grid is this many
// blocks an SM, or one block a tile where the tiles are fewer.
int ssim_blocks_per_sm(int kernel, int n) {
  const void* fn = nullptr;
  Occupancy* occ = nullptr;
  int threads = kFwdThreads;
  size_t smem = kFwdSmem;
  if (kernel == 0 && n >= 1 && n <= kMaxSrc) {
    void (*fwd)(FwdArgs) = nullptr;
    fwd_instance(n, fwd, occ);
    fn = reinterpret_cast<const void*>(fwd);
  } else if (kernel == 1) {
    fn = reinterpret_cast<const void*>(ssim_ident_min_kernel);
    occ = &occ_min;
  } else if (kernel == 2) {
    fn = reinterpret_cast<const void*>(ssim_bwd_kernel);
    occ = &occ_bwd;
    threads = kBwdThreads;
    smem = kBwdSmem;
  } else {
    return -(int)cudaErrorInvalidValue;
  }
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy(fn, threads, smem, *occ, per_sm, sms);
  return err == cudaSuccess ? per_sm : -(int)err;
}

}  // extern "C"
