// Hopper (sm_90a) kernels for the SQL decoder's two fused ops, forward only.
//
//   sql_summary_fwd replaces _fq_fwd_kernel (sfmnext_tpu/ops/pallas/sql_kernel.py,
//     public entry flash_full_query):
//       summary[b,q,:] = sum_n softmax_n(S[b,n,:] . Qr[b,q,:]) * S[b,n,:]
//   sql_depth_fwd replaces _bins_fwd_kernel (same file, flash_bins_depth):
//       depth[b,n] = softmax_d(bf16(S[b,n,:] . Qr[b,:,:]^T) @ W + bias) . centers[b]
//
// S [B,N,E] bf16 is the conv3x3 feature map (one row of E per pixel), Qr
// [B,Q,E] bf16 the transformer's queries, W [Q,D] bf16 the prob 1x1 conv,
// bias [D] and centers [B,D] float32. Every product runs on the tensor
// cores through mma.sync m16n8k16 (bf16 operands, float32 accumulation), as
// the Pallas kernels ran bf16 dots with f32 accumulation on the MXU; softmax
// statistics stay float32. Limits (checked by the wrapper and here):
// Q <= 128, D <= 128, E <= 128 with E % 8 == 0; any N (the ragged tail is
// masked).
//
// What bounds them on an H100 at the flagship shape (B=4, N=81,920, Q=128,
// E=32, D=128), and what the design does about it:
//
//  * summary. One read of S: 2*B*N*E bytes = 21 MB, 6.3 us at 3.35 TB/s.
//    2*2*B*N*Q*E = 5.4 GFLOP of products (5.5 us at the 989 TFLOP/s dense
//    bf16 peak, which mma.sync does not reach), and B*N*Q = 42 M exps on the
//    special-function units (16 per clock per SM, about 11 us). So it is
//    bounded by the exps and the S read together, not by the products.
//    The TPU kernel walks the pixel tiles in order and carries the running
//    max, sum and accumulator from one grid step to the next. Blocks on the
//    GPU run in no order, so N is cut into chunks, one block per (chunk, b)
//    holding all Q queries (one warp per 16 queries); each block reads its
//    chunk of S once, keeps the [16,64] energy tile of each warp in
//    registers, and writes a partial (m, z, acc[Q,E]). A second small kernel
//    merges the partials by log-sum-exp and divides (flash-decoding).
//    Like the Pallas kernel, the unnormalised p is rounded to bf16 for the
//    P.S product while z sums it in float32.
//
//  * depth. 2*B*N*Q*(E+D) = 13.4 GFLOP of products, the same 21 MB read of
//    S, and B*N*D = 42 M exps. Each pixel is independent, so there is no
//    cross-block reduction. q[b] and W^T (32 KB at Q=D=128) sit in shared
//    memory for the block's life; each warp takes 16 pixels at a time. The
//    [16,Q] energy tile stays in registers: the accumulator layout of one
//    m16n8k16 product is the A-operand layout of the next once rounded to
//    bf16, which is exactly the TPU kernel's _bf16(e_t) before the W
//    product. The [16,D] logits never leave registers either; the row max
//    and the exp-weighted sums against the centers reduce across the four
//    lanes that share a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxD = 128;
constexpr int kMaxE = 128;
constexpr int kTile = 64;          // pixels per summary tile
constexpr int kDepthWarps = 4;     // warps per depth block
constexpr int kDepthTilesPerWarp = 8;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// D += A . B for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col).
// Fragments (g = lane / 4, t = lane % 4):
//   A: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B: b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   D: d0,d1 = (g, 2t..2t+1), d2,d3 = (g+8, 2t..2t+1)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + rows) of a row-major [n_rows, E] bf16 matrix into
// shared memory as [rows][ld], zero past n_rows and past E (E % 8 == 0,
// 16-byte loads; ld*2 bytes is a multiple of 16).
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* __restrict__ src,
                                          int row0, int rows, int n_rows, int E,
                                          int EP, int tid, int nthreads) {
  const int chunks = EP / 8;
  for (int i = tid; i < rows * chunks; i += nthreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < E)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * E + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// ---------------------------------------------------------------------------
// summary, pass 1: one block per (chunk of N, b); warp w owns queries
// [16w, 16w+16). Row strides of EP+8 and kTile+8 bf16 keep every fragment
// load free of bank conflicts.
// ---------------------------------------------------------------------------
template <int KE>  // EP = 16 * KE (E padded to a multiple of 16)
__global__ void __launch_bounds__(256) sql_summary_partial(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    float* __restrict__ part_m, float* __restrict__ part_z,
    float* __restrict__ part_acc, int N, int Q, int E, int chunk) {
  constexpr int EP = 16 * KE;
  constexpr int LD = EP + 8;
  constexpr int LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int QP = round_up(Q, 16);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [QP][LD]
  __nv_bfloat16* ss = qs + QP * LD;                             // [kTile][LD]
  __nv_bfloat16* st = ss + kTile * LD;                          // [EP][LDT]
  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* ss32 = reinterpret_cast<const uint32_t*>(ss);
  const uint32_t* st32 = reinterpret_cast<const uint32_t*>(st);
  uint16_t* st16 = reinterpret_cast<uint16_t*>(st);

  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* sb = s + (size_t)b * N * E;

  load_rows(qs, LD, q + (size_t)b * Q * E, 0, QP, Q, E, EP, tid, nthreads);
  __syncthreads();

  // A fragments of this warp's 16 query rows (r0 and r0 + 8), all k-steps.
  const int r0 = warp * 16 + g;
  uint32_t qa[KE][4];
#pragma unroll
  for (int kk = 0; kk < KE; ++kk) {
    qa[kk][0] = qs32[(r0 * LD) / 2 + kk * 8 + t];
    qa[kk][1] = qs32[((r0 + 8) * LD) / 2 + kk * 8 + t];
    qa[kk][2] = qs32[(r0 * LD) / 2 + kk * 8 + 4 + t];
    qa[kk][3] = qs32[((r0 + 8) * LD) / 2 + kk * 8 + 4 + t];
  }

  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows r0, r0 + 8)
  float z[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[2 * KE][4];
#pragma unroll
  for (int ne = 0; ne < 2 * KE; ++ne) acc[ne][0] = acc[ne][1] = acc[ne][2] = acc[ne][3] = 0.f;

  const int n0 = c * chunk, n1 = min(n0 + chunk, N);
  for (int t0 = n0; t0 < n1; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    {
      const int chunks = EP / 8;
      for (int i = tid; i < kTile * chunks; i += nthreads) {
        const int r = i / chunks, cc = (i - r * chunks) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t0 + r < N && cc < E)
          v = __ldg(reinterpret_cast<const uint4*>(sb + (size_t)(t0 + r) * E + cc));
        *reinterpret_cast<uint4*>(ss + r * LD + cc) = v;
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st16[(cc + 2 * j) * LDT + r] = (uint16_t)(words[j] & 0xffffu);
          st16[(cc + 2 * j + 1) * LDT + r] = (uint16_t)(words[j] >> 16);
        }
      }
    }
    __syncthreads();

    // energy tile [16 queries, kTile pixels], float32
    float e[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      e[nt][0] = e[nt][1] = e[nt][2] = e[nt][3] = 0.f;
      const int row = nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < KE; ++kk)
        mma16816(e[nt], qa[kk], ss32[(row * LD) / 2 + kk * 8 + t],
                 ss32[(row * LD) / 2 + kk * 8 + 4 + t]);
    }

    // mask the ragged tail, then the online max (the tile holds at least
    // one pixel < N, so the new max is finite)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int col = t0 + nt * 8 + 2 * t;
      if (col >= N) e[nt][0] = e[nt][2] = -INFINITY;
      if (col + 1 >= N) e[nt][1] = e[nt][3] = -INFINITY;
      mx[0] = fmaxf(mx[0], fmaxf(e[nt][0], e[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(e[nt][2], e[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = __expf(m[i] - mn);
      m[i] = mn;
    }

    float zs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      e[nt][0] = __expf(e[nt][0] - m[0]);
      e[nt][1] = __expf(e[nt][1] - m[0]);
      e[nt][2] = __expf(e[nt][2] - m[1]);
      e[nt][3] = __expf(e[nt][3] - m[1]);
      zs[0] += e[nt][0] + e[nt][1];
      zs[1] += e[nt][2] + e[nt][3];
    }
    z[0] = z[0] * alpha[0] + zs[0];
    z[1] = z[1] * alpha[1] + zs[1];

    // p (bf16) as the A operand of acc += P . S_tile
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pa[kk][0] = pack_bf16(e[2 * kk][0], e[2 * kk][1]);
      pa[kk][1] = pack_bf16(e[2 * kk][2], e[2 * kk][3]);
      pa[kk][2] = pack_bf16(e[2 * kk + 1][0], e[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(e[2 * kk + 1][2], e[2 * kk + 1][3]);
    }
#pragma unroll
    for (int ne = 0; ne < 2 * KE; ++ne) {
      acc[ne][0] *= alpha[0];
      acc[ne][1] *= alpha[0];
      acc[ne][2] *= alpha[1];
      acc[ne][3] *= alpha[1];
      const int row = ne * 8 + g;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        mma16816(acc[ne], pa[kk], st32[(row * LDT) / 2 + kk * 8 + t],
                 st32[(row * LDT) / 2 + kk * 8 + 4 + t]);
    }
  }

  z[0] = quad_sum(z[0]);
  z[1] = quad_sum(z[1]);
  const size_t base = ((size_t)b * n_chunks + c) * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Q) continue;
    if (t == 0) {
      part_m[base + row] = m[i];
      part_z[base + row] = z[i];
    }
    float* out = part_acc + (base + row) * E;
#pragma unroll
    for (int ne = 0; ne < 2 * KE; ++ne) {
      const int col = ne * 8 + 2 * t;
      if (col < E) {
        out[col] = acc[ne][2 * i];
        out[col + 1] = acc[ne][2 * i + 1];
      }
    }
  }
}

// summary, pass 2: log-sum-exp merge of the chunk partials, one thread per
// (q, e) of one batch row.
__global__ void sql_summary_merge(const float* __restrict__ part_m,
                                  const float* __restrict__ part_z,
                                  const float* __restrict__ part_acc,
                                  float* __restrict__ out, int n_chunks, int Q,
                                  int E) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q * E) return;
  const int qi = i / E;
  const float* pm = part_m + (size_t)b * n_chunks * Q + qi;
  const float* pz = part_z + (size_t)b * n_chunks * Q + qi;
  const float* pa = part_acc + (size_t)b * n_chunks * Q * E + i;
  float mx = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, pm[(size_t)c * Q]);
  float zsum = 0.f, asum = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(pm[(size_t)c * Q] - mx);
    zsum += w * pz[(size_t)c * Q];
    asum += w * pa[(size_t)c * Q * E];
  }
  out[(size_t)b * Q * E + i] = asum / zsum;
}

// ---------------------------------------------------------------------------
// depth: blocks stride over 16-pixel tiles of one batch row, one tile per
// warp at a time. Row strides are compile-time (W^T rows always hold
// kMaxQ + 8), so fragment addresses are constant offsets.
// ---------------------------------------------------------------------------
template <int KE>  // EP = 16 * KE
__global__ void __launch_bounds__(32 * kDepthWarps) sql_depth_kernel(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ centers, float* __restrict__ out, int N, int Q,
    int E, int D) {
  constexpr int EP = 16 * KE;
  constexpr int LDQ = EP + 8;         // q rows and the per-warp S tile
  constexpr int LDW = kMaxQ + 8;      // W^T rows
  const int QP = round_up(Q, 16), DP = round_up(D, 8);
  const int QK = QP / 16, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem);  // [kMaxD], -inf past D
  float* cen_s = bias_s + kMaxD;                    // [kMaxD], 0 past D
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(cen_s + kMaxD);  // [QP][LDQ]
  __nv_bfloat16* wt = qs + QP * LDQ;                                     // [DP][LDW]
  __nv_bfloat16* sw = wt + DP * LDW;  // [kDepthWarps][16][LDQ]

  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  for (int d = tid; d < DP; d += blockDim.x) {
    bias_s[d] = d < D ? bias[d] : -INFINITY;
    cen_s[d] = d < D ? centers[(size_t)b * D + d] : 0.f;
  }
  load_rows(qs, LDQ, q + (size_t)b * Q * E, 0, QP, Q, E, EP, tid, blockDim.x);
  for (int i = tid; i < QP * DP; i += blockDim.x) {
    const int qi = i / DP, d = i - qi * DP;
    wt[d * LDW + qi] = (qi < Q && d < D) ? w[(size_t)qi * D + d] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* wt32 = reinterpret_cast<const uint32_t*>(wt);
  __nv_bfloat16* swp = sw + warp * 16 * LDQ;
  const uint32_t* sw32 = reinterpret_cast<const uint32_t*>(swp);
  const __nv_bfloat16* sb = s + (size_t)b * N * E;
  const int n_tiles = (N + 15) / 16;

  for (int tile = blockIdx.x * kDepthWarps + warp; tile < n_tiles;
       tile += gridDim.x * kDepthWarps) {
    const int p0 = tile * 16;
    __syncwarp();
    load_rows(swp, LDQ, sb, p0, 16, N, E, EP, lane, 32);
    __syncwarp();

    // A fragments of the 16 pixel rows (zero past N and past E)
    uint32_t sa[KE][4];
#pragma unroll
    for (int kk = 0; kk < KE; ++kk) {
      sa[kk][0] = sw32[(g * LDQ) / 2 + kk * 8 + t];
      sa[kk][1] = sw32[((g + 8) * LDQ) / 2 + kk * 8 + t];
      sa[kk][2] = sw32[(g * LDQ) / 2 + kk * 8 + 4 + t];
      sa[kk][3] = sw32[((g + 8) * LDQ) / 2 + kk * 8 + 4 + t];
    }

    // energy [16, QP]: query n-tiles 2kq and 2kq+1 give the k-step kq of
    // the W product, rounded to bf16 on the way
    uint32_t ea[kMaxQ / 16][4];
#pragma unroll
    for (int kq = 0; kq < kMaxQ / 16; ++kq) {
      if (kq < QK) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        const int qa = kq * 16 + g, qb = qa + 8;
#pragma unroll
        for (int kk = 0; kk < KE; ++kk) {
          mma16816(c0, sa[kk], qs32[(qa * LDQ) / 2 + kk * 8 + t],
                   qs32[(qa * LDQ) / 2 + kk * 8 + 4 + t]);
          mma16816(c1, sa[kk], qs32[(qb * LDQ) / 2 + kk * 8 + t],
                   qs32[(qb * LDQ) / 2 + kk * 8 + 4 + t]);
        }
        ea[kq][0] = pack_bf16(c0[0], c0[1]);
        ea[kq][1] = pack_bf16(c0[2], c0[3]);
        ea[kq][2] = pack_bf16(c1[0], c1[1]);
        ea[kq][3] = pack_bf16(c1[2], c1[3]);
      }
    }

    // logits [16, DP] = bf16(energy) @ W + bias (-inf on padded bins)
    float lg[kMaxD / 8][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      if (dt < DT) {
        lg[dt][0] = lg[dt][1] = lg[dt][2] = lg[dt][3] = 0.f;
        const int row = dt * 8 + g;
#pragma unroll
        for (int kq = 0; kq < kMaxQ / 16; ++kq)
          if (kq < QK)
            mma16816(lg[dt], ea[kq], wt32[(row * LDW) / 2 + kq * 8 + t],
                     wt32[(row * LDW) / 2 + kq * 8 + 4 + t]);
        const int col = dt * 8 + 2 * t;
        lg[dt][0] += bias_s[col];
        lg[dt][1] += bias_s[col + 1];
        lg[dt][2] += bias_s[col];
        lg[dt][3] += bias_s[col + 1];
        mx0 = fmaxf(mx0, fmaxf(lg[dt][0], lg[dt][1]));
        mx1 = fmaxf(mx1, fmaxf(lg[dt][2], lg[dt][3]));
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);

    float num0 = 0.f, den0 = 0.f, num1 = 0.f, den1 = 0.f;
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      if (dt < DT) {
        const int col = dt * 8 + 2 * t;
        const float c0 = cen_s[col], c1 = cen_s[col + 1];
        const float e0 = __expf(lg[dt][0] - mx0), e1 = __expf(lg[dt][1] - mx0);
        const float e2 = __expf(lg[dt][2] - mx1), e3 = __expf(lg[dt][3] - mx1);
        num0 += e0 * c0 + e1 * c1;
        den0 += e0 + e1;
        num1 += e2 * c0 + e3 * c1;
        den1 += e2 + e3;
      }
    }
    num0 = quad_sum(num0);
    den0 = quad_sum(den0);
    num1 = quad_sum(num1);
    den1 = quad_sum(den1);
    if (t == 0) {
      if (p0 + g < N) out[(size_t)b * N + p0 + g] = num0 / den0;
      if (p0 + g + 8 < N) out[(size_t)b * N + p0 + g + 8] = num1 / den1;
    }
  }
}

bool shapes_ok(int B, int N, int Q, int E) {
  return B > 0 && N > 0 && Q > 0 && Q <= kMaxQ && E > 0 && E <= kMaxE && E % 8 == 0;
}

template <int KE>
cudaError_t launch_depth(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                         const __nv_bfloat16* s, const __nv_bfloat16* q, const __nv_bfloat16* w,
                         const float* bias, const float* centers, float* out, int N, int Q,
                         int E, int D) {
  cudaError_t err = cudaFuncSetAttribute(sql_depth_kernel<KE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_depth_kernel<KE><<<grid, block, smem, stream>>>(s, q, w, bias, centers, out, N, Q, E, D);
  return cudaGetLastError();
}

template <int KE>
cudaError_t launch_summary_partial(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                                   const __nv_bfloat16* s, const __nv_bfloat16* q,
                                   float* part_m, float* part_z, float* part_acc,
                                   int N, int Q, int E, int chunk) {
  cudaError_t err = cudaFuncSetAttribute(sql_summary_partial<KE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_summary_partial<KE><<<grid, block, smem, stream>>>(s, q, part_m, part_z, part_acc, N, Q,
                                                         E, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per summary block: the wrapper allocates part_m/part_z [B,C,Q] and
// part_acc [B,C,Q,E] float32 with C = ceil(N / chunk); chunk % 64 == 0.
int sql_summary_fwd(const void* s, const void* q, void* part_m, void* part_z, void* part_acc,
                    void* out, int B, int N, int Q, int E, int chunk, void* stream) {
  if (!shapes_ok(B, N, Q, E) || chunk <= 0 || chunk % kTile != 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
  const int QP = round_up(Q, 16), EP = round_up(E, 16);
  const size_t smem = ((size_t)QP * (EP + 8) + (size_t)kTile * (EP + 8) +
                       (size_t)EP * (kTile + 8)) * sizeof(__nv_bfloat16);
  const dim3 grid(n_chunks, B), block(32 * (QP / 16));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* pm = static_cast<float*>(part_m);
  auto* pz = static_cast<float*>(part_z);
  auto* pa = static_cast<float*>(part_acc);
  cudaError_t err;
  switch (EP / 16) {
#define SQL_SUMMARY_CASE(KE) \
  case KE: err = launch_summary_partial<KE>(grid, block, smem, st, sp, qp, pm, pz, pa, N, Q, E, chunk); break;
    SQL_SUMMARY_CASE(1)
    SQL_SUMMARY_CASE(2)
    SQL_SUMMARY_CASE(3)
    SQL_SUMMARY_CASE(4)
    SQL_SUMMARY_CASE(5)
    SQL_SUMMARY_CASE(6)
    SQL_SUMMARY_CASE(7)
    SQL_SUMMARY_CASE(8)
#undef SQL_SUMMARY_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  sql_summary_merge<<<dim3((Q * E + 255) / 256, B), 256, 0, st>>>(pm, pz, pa, static_cast<float*>(out),
                                                                   n_chunks, Q, E);
  return (int)cudaGetLastError();
}

int sql_depth_fwd(const void* s, const void* q, const void* w, const void* bias,
                  const void* centers, void* out, int B, int N, int Q, int E, int D,
                  void* stream) {
  if (!shapes_ok(B, N, Q, E) || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const int QP = round_up(Q, 16), EP = round_up(E, 16), DP = round_up(D, 8);
  const size_t smem = 2 * kMaxD * sizeof(float) +
                      ((size_t)QP * (EP + 8) + (size_t)DP * (kMaxQ + 8) +
                       (size_t)kDepthWarps * 16 * (EP + 8)) * sizeof(__nv_bfloat16);
  const int n_tiles = (N + 15) / 16;
  const int per_block = kDepthWarps * kDepthTilesPerWarp;
  const dim3 grid((n_tiles + per_block - 1) / per_block, B), block(32 * kDepthWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* cp = static_cast<const float*>(centers);
  auto* op = static_cast<float*>(out);
  switch (EP / 16) {
#define SQL_DEPTH_CASE(KE) \
  case KE: return (int)launch_depth<KE>(grid, block, smem, st, sp, qp, wp, bp, cp, op, N, Q, E, D);
    SQL_DEPTH_CASE(1)
    SQL_DEPTH_CASE(2)
    SQL_DEPTH_CASE(3)
    SQL_DEPTH_CASE(4)
    SQL_DEPTH_CASE(5)
    SQL_DEPTH_CASE(6)
    SQL_DEPTH_CASE(7)
    SQL_DEPTH_CASE(8)
#undef SQL_DEPTH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sql_kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
