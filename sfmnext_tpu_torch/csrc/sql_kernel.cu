// Hopper (sm_90a) kernels for the SQL decoder's two fused ops and their
// backward passes.
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
//
// The backward passes (E <= 64), at the training slice's shape (B=8,
// N=81,920, Q=128, E=32, D=128), counting each input read once and each
// output written once, products at the 989 TFLOP/s bf16 dense peak:
//
//  * sql_summary_bwd replaces _fq_bwd_kernel (_fq_call_bwd, the VJP of
//    flash_full_query): dS [B,N,E] bf16 and dQ [B,Q,E] from the cotangent
//    g [B,Q,E] and the forward's m, z and delta = sum_e g * out. Five
//    products of 2*B*N*Q*E (energy, dattn, dQ and the two halves of dS):
//    26.8 GFLOP, 27 us; reads S and writes dS, 84 MB, 25 us; 84 M exps.
//    Bounded by the products. Blocks are (chunk of N, b) as in the
//    forward, each warp holding 16 queries; the energy and dattn tiles stay
//    in registers. dS reduces over the queries, which the warps split, so
//    bf16(p) and bf16(de) go through shared memory and the warps split the
//    [64, E] dS tile instead.
//  * sql_depth_bwd replaces _bins_bwd_kernel (_bins_call_bwd, the VJP of
//    flash_bins_depth): dS, dQ, dW [Q,D], db [D] and dc [B,D]. Products:
//    2*B*N*(3*Q*E + 3*Q*D) = 80.5 GFLOP, 81 us; 87 MB moved, 26 us.
//    Bounded by the products. Each warp recomputes the energy and logits
//    of its 16 pixels in registers (as the forward), forms dl and de there
//    and writes dS; dW and dQ reduce over pixels, so bf16(e), bf16(dl) and
//    bf16(de) of the block's 64 pixels go to shared memory and the warps
//    split the [Q,D] and [Q,E] products, each owning its output tiles of a
//    float32 accumulator in shared memory.
//
// Reductions across blocks (dQ, dW, db, dc) are written as per-block
// partials and summed by a second kernel in a fixed order, not with
// atomics, so a training step gives the same gradients every run. Like the
// Pallas kernels, p, de and dl are rounded to bf16 before each product;
// sums and softmax statistics stay float32.

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
constexpr int kMaxEBwd = 64;     // the backward kernels take E <= 64

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
// (q, e) of one batch row; the threads of e == 0 also write the row's max m
// and partition z, the residuals of the backward pass.
__global__ void sql_summary_merge(const float* __restrict__ part_m,
                                  const float* __restrict__ part_z,
                                  const float* __restrict__ part_acc,
                                  float* __restrict__ out, float* __restrict__ m_out,
                                  float* __restrict__ z_out, int n_chunks, int Q, int E) {
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
  if (i - qi * E == 0) {
    m_out[(size_t)b * Q + qi] = mx;
    z_out[(size_t)b * Q + qi] = zsum;
  }
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

// ---------------------------------------------------------------------------
// Backward passes (E <= kMaxEBwd).
//
// Fragment loads from shared memory. "k-contiguous" tiles hold the
// product's reduction index in consecutive addresses and give 32-bit
// loads; the transposed forms gather two 16-bit values a register.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair16(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

// A[r][k] = M[(r0 + r) * ld + k0 + k]
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* M, int ld,
                                       int r0, int k0, int g, int t) {
  const __nv_bfloat16* p = M + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// A[r][k] = M[(k0 + k) * ld + r0 + r]
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const __nv_bfloat16* M, int ld,
                                         int r0, int k0, int g, int t) {
  const __nv_bfloat16* p = M + (k0 + 2 * t) * ld + r0 + g;
  a[0] = pair16(p, p + ld);
  a[1] = pair16(p + 8, p + ld + 8);
  a[2] = pair16(p + 8 * ld, p + 9 * ld);
  a[3] = pair16(p + 8 * ld + 8, p + 9 * ld + 8);
}

// B[k][n] = M[(n0 + n) * ld + k0 + k]
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* M,
                                       int ld, int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = M + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B[k][n] = M[(k0 + k) * ld + n0 + n]
__device__ __forceinline__ void frag_b_t(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* M,
                                         int ld, int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = M + (k0 + 2 * t) * ld + n0 + g;
  b0 = pair16(p, p + ld);
  b1 = pair16(p + 8 * ld, p + 9 * ld);
}

// Two adjacent 16x8 accumulator tiles as one 16x16 A fragment (bf16), and
// stored into a row-major bf16 tile at rows r0.., columns c0.. (16 wide).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void store_a(__nv_bfloat16* M, int ld, int r0, int c0,
                                        const uint32_t (&a)[4], int g, int t) {
  uint32_t* p = reinterpret_cast<uint32_t*>(M + (r0 + g) * ld + c0 + 2 * t);
  p[0] = a[0];
  p[4] = a[2];
  p += 4 * ld;  // eight rows down: 8 * ld bf16 = 4 * ld words
  p[0] = a[1];
  p[4] = a[3];
}

// Sum over the middle axis of partials [batch][parts][len] -> [batch][len],
// in a fixed order (the second pass of every cross-block reduction).
__global__ void sum_partials(const float* __restrict__ in, float* __restrict__ out, int parts,
                             int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  const float* p = in + (size_t)blockIdx.y * parts * len + i;
  float s = 0.f;
  for (int c = 0; c < parts; ++c) s += p[(size_t)c * len];
  out[(size_t)blockIdx.y * len + i] = s;
}

cudaError_t launch_sum(const float* in, float* out, int batch, int parts, int len,
                       cudaStream_t st) {
  sum_partials<<<dim3((len + 255) / 256, batch), 256, 0, st>>>(in, out, parts, len);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// summary backward, pass 1: one block per (chunk of N, b); warp w owns
// queries [16w, 16w+16), as in the forward. Per 64-pixel tile:
//   e  = Q . S^T, dattn = bf16(g) . S^T            [16 q, 64 px] per warp
//   p  = exp(e - m) / z, de = p * (dattn - delta)   (float32)
//   dQ += bf16(de) . S                              (registers, per warp)
//   dS  = bf16(de)^T . Q + bf16(p)^T . bf16(g)      (a reduction over q:
//         p and de go through shared memory, warps split the [64, E] tile)
// ---------------------------------------------------------------------------
template <int KE>
__global__ void __launch_bounds__(256) sql_summary_bwd_partial(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ g, const float* __restrict__ m, const float* __restrict__ z,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ ds,
    float* __restrict__ part_dq, int N, int Q, int E, int chunk) {
  constexpr int EP = 16 * KE;
  constexpr int LD = EP + 8;
  constexpr int LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int QP = round_up(Q, 16);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [QP][LD]
  __nv_bfloat16* gs = qs + QP * LD;                             // [QP][LD] bf16(g)
  __nv_bfloat16* ss = gs + QP * LD;                             // [kTile][LD]
  __nv_bfloat16* ps = ss + kTile * LD;                          // [QP][LDT] bf16(p)
  __nv_bfloat16* des = ps + QP * LDT;                           // [QP][LDT] bf16(de)

  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads / 32;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;
  const __nv_bfloat16* sb = s + (size_t)b * N * E;

  load_rows(qs, LD, q + (size_t)b * Q * E, 0, QP, Q, E, EP, tid, nthreads);
  for (int i = tid; i < QP * EP; i += nthreads) {
    const int r = i / EP, cc = i - r * EP;
    const float v = (r < Q && cc < E) ? g[((size_t)b * Q + r) * E + cc] : 0.f;
    gs[r * LD + cc] = __float2bfloat16(v);
  }
  __syncthreads();

  const int q0 = warp * 16;
  uint32_t qa[KE][4], ga[KE][4];
#pragma unroll
  for (int kk = 0; kk < KE; ++kk) {
    frag_a(qa[kk], qs, LD, q0, kk * 16, gr, t);
    frag_a(ga[kk], gs, LD, q0, kk * 16, gr, t);
  }
  float mrow[2], zrow[2], drow[2], valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + gr + 8 * i;
    const bool ok = row < Q;
    mrow[i] = ok ? m[(size_t)b * Q + row] : 0.f;
    zrow[i] = ok ? z[(size_t)b * Q + row] : 1.f;
    drow[i] = ok ? delta[(size_t)b * Q + row] : 0.f;
    valid[i] = ok ? 1.f : 0.f;
  }

  float acc[2 * KE][4];
#pragma unroll
  for (int ne = 0; ne < 2 * KE; ++ne) acc[ne][0] = acc[ne][1] = acc[ne][2] = acc[ne][3] = 0.f;

  const int n0 = c * chunk, n1 = min(n0 + chunk, N);
  for (int t0 = n0; t0 < n1; t0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows(ss, LD, sb, t0, kTile, N, E, EP, tid, nthreads);
    __syncthreads();

    float e[kTile / 8][4], da[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) e[nt][j] = da[nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KE; ++kk) {
        uint32_t b0, b1;
        frag_b(b0, b1, ss, LD, nt * 8, kk * 16, gr, t);
        mma16816(e[nt], qa[kk], b0, b1);
        mma16816(da[nt], ga[kk], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j >> 1;
        const bool in = t0 + nt * 8 + 2 * t + (j & 1) < N;
        const float p = in ? valid[i] * (__expf(e[nt][j] - mrow[i]) / zrow[i]) : 0.f;
        da[nt][j] = p * (da[nt][j] - drow[i]);
        e[nt][j] = p;
      }
    }

    // dQ += bf16(de) . S_tile, and p / de into shared memory for dS
    uint32_t dea[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(dea[kk], da[2 * kk], da[2 * kk + 1]);
      acc_to_a(pa, e[2 * kk], e[2 * kk + 1]);
      store_a(des, LDT, q0, kk * 16, dea[kk], gr, t);
      store_a(ps, LDT, q0, kk * 16, pa, gr, t);
    }
#pragma unroll
    for (int ne = 0; ne < 2 * KE; ++ne) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t b0, b1;
        frag_b_t(b0, b1, ss, LD, kk * 16, ne * 8, gr, t);
        mma16816(acc[ne], dea[kk], b0, b1);
      }
    }
    __syncthreads();

    // dS [kTile, EP]: 16x8 output tiles split over the warps
    for (int tile = warp; tile < (kTile / 16) * (EP / 8); tile += nwarps) {
      const int rt = tile / (EP / 8), ct = tile - rt * (EP / 8);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kq = 0; kq < QP / 16; ++kq) {
        uint32_t a[4], b0, b1;
        frag_a_t(a, des, LDT, rt * 16, kq * 16, gr, t);
        frag_b_t(b0, b1, qs, LD, kq * 16, ct * 8, gr, t);
        mma16816(d, a, b0, b1);
        frag_a_t(a, ps, LDT, rt * 16, kq * 16, gr, t);
        frag_b_t(b0, b1, gs, LD, kq * 16, ct * 8, gr, t);
        mma16816(d, a, b0, b1);
      }
      const int px = t0 + rt * 16 + gr, col = ct * 8 + 2 * t;
      if (col < E) {  // E % 8 == 0, so col + 1 < E too
        if (px < N)
          *reinterpret_cast<__nv_bfloat162*>(ds + ((size_t)b * N + px) * E + col) =
              __floats2bfloat162_rn(d[0], d[1]);
        if (px + 8 < N)
          *reinterpret_cast<__nv_bfloat162*>(ds + ((size_t)b * N + px + 8) * E + col) =
              __floats2bfloat162_rn(d[2], d[3]);
      }
    }
  }

  const size_t base = ((size_t)b * n_chunks + c) * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + gr + 8 * i;
    if (row >= Q) continue;
    float* out = part_dq + (base + row) * E;
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

// ---------------------------------------------------------------------------
// depth backward, pass 1: one block of kDepthWarps warps per (chunk of N,
// b), 16 pixels a warp and 64 a block per step. Per warp (registers):
//   e  = S . Q^T [16, Q] -> bf16 A fragments, also into shared memory
//   l  = bf16(e) . W + bias, pn = softmax_D(l)
//   dl = pn * (g c - sum_d pn g c);   dc += pn g,  db += dl (per-warp rows
//        of shared memory, summed across the 16 pixels with shuffles)
//   de = bf16(dl) . W^T [16, Q];      dS = bf16(de) . Q  -> global
// then per block (reductions over the 64 pixels, split over the warps,
// accumulated in float32 shared memory that each warp owns a part of):
//   dW += bf16(e)^T . bf16(dl),       dQ += bf16(de)^T . S
// ---------------------------------------------------------------------------
constexpr int kBwdTile = 16 * kDepthWarps;  // pixels per block step

template <int KE>
__global__ void __launch_bounds__(32 * kDepthWarps) sql_depth_bwd_partial(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ centers, const float* __restrict__ gd,
    __nv_bfloat16* __restrict__ ds, float* __restrict__ part_dq, float* __restrict__ part_dw,
    float* __restrict__ part_db, float* __restrict__ part_dc, int N, int Q, int E, int D,
    int chunk) {
  constexpr int EP = 16 * KE;
  constexpr int LD = EP + 8;
  const int QP = round_up(Q, 16), DP = round_up(D, 8), DP16 = round_up(D, 16);
  const int QK = QP / 16, DT = DP / 8, DK = DP16 / 16;
  const int LDQ = QP + 8, LDD = DP16 + 8, LDA = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem);    // [kMaxD], -inf past D
  float* cen_s = bias_s + kMaxD;                      // [kMaxD], 0 past D
  float* dcw = cen_s + kMaxD;                         // [kDepthWarps][kMaxD]
  float* dbw = dcw + kDepthWarps * kMaxD;             // [kDepthWarps][kMaxD]
  float* dw_acc = dbw + kDepthWarps * kMaxD;          // [QP][LDA]
  float* dq_acc = dw_acc + QP * LDA;                  // [QP][LD]
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(dq_acc + QP * LD);  // [QP][LDD]
  __nv_bfloat16* qs = ws + QP * LDD;                  // [QP][LD]
  __nv_bfloat16* ss = qs + QP * LD;                   // [kBwdTile][LD]
  __nv_bfloat16* es = ss + kBwdTile * LD;             // [kBwdTile][LDQ] bf16(e)
  __nv_bfloat16* des = es + kBwdTile * LDQ;           // [kBwdTile][LDQ] bf16(de)
  __nv_bfloat16* dls = des + kBwdTile * LDQ;          // [kBwdTile][LDD] bf16(dl)

  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;

  for (int d = tid; d < kMaxD; d += nthreads) {
    bias_s[d] = d < D ? bias[d] : -INFINITY;
    cen_s[d] = d < D ? centers[(size_t)b * D + d] : 0.f;
  }
  for (int i = tid; i < kDepthWarps * kMaxD; i += nthreads) dcw[i] = dbw[i] = 0.f;
  for (int i = tid; i < QP * LDA; i += nthreads) dw_acc[i] = 0.f;
  for (int i = tid; i < QP * LD; i += nthreads) dq_acc[i] = 0.f;
  for (int i = tid; i < QP * DP16; i += nthreads) {
    const int qi = i / DP16, d = i - qi * DP16;
    ws[qi * LDD + d] = (qi < Q && d < D) ? w[(size_t)qi * D + d] : __float2bfloat16(0.f);
  }
  load_rows(qs, LD, q + (size_t)b * Q * E, 0, QP, Q, E, EP, tid, nthreads);
  const __nv_bfloat16* sb = s + (size_t)b * N * E;
  const float* gb = gd + (size_t)b * N;
  const int pr = warp * 16;  // this warp's rows of the block's pixel tile

  const int n0 = c * chunk, n1 = min(n0 + chunk, N);
  for (int t0 = n0; t0 < n1; t0 += kBwdTile) {
    __syncthreads();  // the previous step's block products are done
    load_rows(ss, LD, sb, t0, kBwdTile, N, E, EP, tid, nthreads);
    __syncthreads();

    // energy [16, QP] as bf16 A fragments (and into es for dW)
    uint32_t sa[KE][4];
#pragma unroll
    for (int kk = 0; kk < KE; ++kk) frag_a(sa[kk], ss, LD, pr, kk * 16, gr, t);
    uint32_t ea[kMaxQ / 16][4];
#pragma unroll
    for (int kq = 0; kq < kMaxQ / 16; ++kq) {
      if (kq < QK) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KE; ++kk) {
          uint32_t b0, b1;
          frag_b(b0, b1, qs, LD, kq * 16, kk * 16, gr, t);
          mma16816(c0, sa[kk], b0, b1);
          frag_b(b0, b1, qs, LD, kq * 16 + 8, kk * 16, gr, t);
          mma16816(c1, sa[kk], b0, b1);
        }
        acc_to_a(ea[kq], c0, c1);
        store_a(es, LDQ, pr, kq * 16, ea[kq], gr, t);
      }
    }

    // logits [16, DP] = bf16(e) . W + bias, softmax over D
    float lg[kMaxD / 8][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      if (dt < DT) {
        lg[dt][0] = lg[dt][1] = lg[dt][2] = lg[dt][3] = 0.f;
#pragma unroll
        for (int kq = 0; kq < kMaxQ / 16; ++kq) {
          if (kq < QK) {
            uint32_t b0, b1;
            frag_b_t(b0, b1, ws, LDD, kq * 16, dt * 8, gr, t);
            mma16816(lg[dt], ea[kq], b0, b1);
          }
        }
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
    float den0 = 0.f, den1 = 0.f;
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      if (dt < DT) {
        lg[dt][0] = __expf(lg[dt][0] - mx0);
        lg[dt][1] = __expf(lg[dt][1] - mx0);
        lg[dt][2] = __expf(lg[dt][2] - mx1);
        lg[dt][3] = __expf(lg[dt][3] - mx1);
        den0 += lg[dt][0] + lg[dt][1];
        den1 += lg[dt][2] + lg[dt][3];
      }
    }
    den0 = quad_sum(den0);
    den1 = quad_sum(den1);
    const int p0 = t0 + pr + gr;
    const float g0 = p0 < N ? gb[p0] : 0.f, g1 = p0 + 8 < N ? gb[p0 + 8] : 0.f;

    // pn (in lg), then dot = sum_d pn * g * c per pixel
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      if (dt < DT) {
        const int col = dt * 8 + 2 * t;
        lg[dt][0] /= den0;
        lg[dt][1] /= den0;
        lg[dt][2] /= den1;
        lg[dt][3] /= den1;
        dot0 += lg[dt][0] * (g0 * cen_s[col]) + lg[dt][1] * (g0 * cen_s[col + 1]);
        dot1 += lg[dt][2] * (g1 * cen_s[col]) + lg[dt][3] * (g1 * cen_s[col + 1]);
      }
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);

    // dl (in lg); dc and db summed over the warp's 16 pixels
#pragma unroll
    for (int dt = 0; dt < kMaxD / 8; ++dt) {
      if (dt < DT) {
        const int col = dt * 8 + 2 * t;
        const float c0 = cen_s[col], c1 = cen_s[col + 1];
        float dc0 = lg[dt][0] * g0 + lg[dt][2] * g1;
        float dc1 = lg[dt][1] * g0 + lg[dt][3] * g1;
        lg[dt][0] *= g0 * c0 - dot0;
        lg[dt][1] *= g0 * c1 - dot0;
        lg[dt][2] *= g1 * c0 - dot1;
        lg[dt][3] *= g1 * c1 - dot1;
        float db0 = lg[dt][0] + lg[dt][2], db1 = lg[dt][1] + lg[dt][3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          dc0 += __shfl_xor_sync(0xffffffffu, dc0, off);
          dc1 += __shfl_xor_sync(0xffffffffu, dc1, off);
          db0 += __shfl_xor_sync(0xffffffffu, db0, off);
          db1 += __shfl_xor_sync(0xffffffffu, db1, off);
        }
        if (gr == 0) {
          dcw[warp * kMaxD + col] += dc0;
          dcw[warp * kMaxD + col + 1] += dc1;
          dbw[warp * kMaxD + col] += db0;
          dbw[warp * kMaxD + col + 1] += db1;
        }
      }
    }

    // bf16(dl) as A fragments over D (zero past DP), and into dls for dW
    uint32_t dla[kMaxD / 16][4];
#pragma unroll
    for (int kd = 0; kd < kMaxD / 16; ++kd) {
      if (kd < DK) {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        if (2 * kd + 1 < DT)
          acc_to_a(dla[kd], lg[2 * kd], lg[2 * kd + 1]);
        else
          acc_to_a(dla[kd], lg[2 * kd], zero);
        store_a(dls, LDD, pr, kd * 16, dla[kd], gr, t);
      }
    }

    // de [16, QP] = bf16(dl) . W^T, as bf16 A fragments (and into des)
    uint32_t dea[kMaxQ / 16][4];
#pragma unroll
    for (int kq = 0; kq < kMaxQ / 16; ++kq) {
      if (kq < QK) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kd = 0; kd < kMaxD / 16; ++kd) {
          if (kd < DK) {
            uint32_t b0, b1;
            frag_b(b0, b1, ws, LDD, kq * 16, kd * 16, gr, t);
            mma16816(c0, dla[kd], b0, b1);
            frag_b(b0, b1, ws, LDD, kq * 16 + 8, kd * 16, gr, t);
            mma16816(c1, dla[kd], b0, b1);
          }
        }
        acc_to_a(dea[kq], c0, c1);
        store_a(des, LDQ, pr, kq * 16, dea[kq], gr, t);
      }
    }

    // dS [16, EP] = bf16(de) . Q
#pragma unroll
    for (int ne = 0; ne < 2 * KE; ++ne) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < kMaxQ / 16; ++kq) {
        if (kq < QK) {
          uint32_t b0, b1;
          frag_b_t(b0, b1, qs, LD, kq * 16, ne * 8, gr, t);
          mma16816(d, dea[kq], b0, b1);
        }
      }
      const int col = ne * 8 + 2 * t;
      if (col < E) {
        if (p0 < N)
          *reinterpret_cast<__nv_bfloat162*>(ds + ((size_t)b * N + p0) * E + col) =
              __floats2bfloat162_rn(d[0], d[1]);
        if (p0 + 8 < N)
          *reinterpret_cast<__nv_bfloat162*>(ds + ((size_t)b * N + p0 + 8) * E + col) =
              __floats2bfloat162_rn(d[2], d[3]);
      }
    }
    __syncthreads();

    // block products over the step's kBwdTile pixels; each 16x8 output
    // tile belongs to one warp, so the float32 sums need no atomics
    for (int tile = warp; tile < QK * DT; tile += kDepthWarps) {
      const int r0 = (tile / DT) * 16, c0 = (tile % DT) * 8;
      float* acc = dw_acc + (r0 + gr) * LDA + c0 + 2 * t;
      float d[4] = {acc[0], acc[1], acc[8 * LDA], acc[8 * LDA + 1]};
#pragma unroll
      for (int kp = 0; kp < kBwdTile / 16; ++kp) {
        uint32_t a[4], b0, b1;
        frag_a_t(a, es, LDQ, r0, kp * 16, gr, t);
        frag_b_t(b0, b1, dls, LDD, kp * 16, c0, gr, t);
        mma16816(d, a, b0, b1);
      }
      acc[0] = d[0];
      acc[1] = d[1];
      acc[8 * LDA] = d[2];
      acc[8 * LDA + 1] = d[3];
    }
    for (int tile = warp; tile < QK * (EP / 8); tile += kDepthWarps) {
      const int r0 = (tile / (EP / 8)) * 16, c0 = (tile % (EP / 8)) * 8;
      float* acc = dq_acc + (r0 + gr) * LD + c0 + 2 * t;
      float d[4] = {acc[0], acc[1], acc[8 * LD], acc[8 * LD + 1]};
#pragma unroll
      for (int kp = 0; kp < kBwdTile / 16; ++kp) {
        uint32_t a[4], b0, b1;
        frag_a_t(a, des, LDQ, r0, kp * 16, gr, t);
        frag_b_t(b0, b1, ss, LD, kp * 16, c0, gr, t);
        mma16816(d, a, b0, b1);
      }
      acc[0] = d[0];
      acc[1] = d[1];
      acc[8 * LD] = d[2];
      acc[8 * LD + 1] = d[3];
    }
  }
  __syncthreads();

  const size_t blk = (size_t)b * n_chunks + c;
  for (int i = tid; i < Q * D; i += nthreads) {
    const int qi = i / D, d = i - qi * D;
    part_dw[blk * Q * D + i] = dw_acc[qi * LDA + d];
  }
  for (int i = tid; i < Q * E; i += nthreads) {
    const int qi = i / E, e = i - qi * E;
    part_dq[blk * Q * E + i] = dq_acc[qi * LD + e];
  }
  for (int d = tid; d < D; d += nthreads) {
    float sc = 0.f, sb2 = 0.f;
    for (int wi = 0; wi < kDepthWarps; ++wi) {
      sc += dcw[wi * kMaxD + d];
      sb2 += dbw[wi * kMaxD + d];
    }
    part_dc[blk * D + d] = sc;
    part_db[blk * D + d] = sb2;
  }
}

size_t summary_bwd_smem(int Q, int E) {
  const int QP = round_up(Q, 16), EP = round_up(E, 16);
  return ((size_t)2 * QP * (EP + 8) + (size_t)kTile * (EP + 8) +
          (size_t)2 * QP * (kTile + 8)) * sizeof(__nv_bfloat16);
}

size_t depth_bwd_smem(int Q, int E, int D) {
  const int QP = round_up(Q, 16), EP = round_up(E, 16), DP = round_up(D, 8),
            DP16 = round_up(D, 16);
  const size_t f32 = (size_t)2 * kMaxD + (size_t)2 * kDepthWarps * kMaxD +
                     (size_t)QP * (DP + 8) + (size_t)QP * (EP + 8);
  const size_t b16 = (size_t)QP * (DP16 + 8) + (size_t)QP * (EP + 8) +
                     (size_t)kBwdTile * (EP + 8) + (size_t)2 * kBwdTile * (QP + 8) +
                     (size_t)kBwdTile * (DP16 + 8);
  return f32 * sizeof(float) + b16 * sizeof(__nv_bfloat16);
}

template <int KE>
cudaError_t launch_summary_bwd(dim3 grid, size_t smem, cudaStream_t st, const __nv_bfloat16* s,
                               const __nv_bfloat16* q, const float* g, const float* m,
                               const float* z, const float* delta, __nv_bfloat16* ds,
                               float* part_dq, int N, int Q, int E, int chunk) {
  cudaError_t err = cudaFuncSetAttribute(sql_summary_bwd_partial<KE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_summary_bwd_partial<KE><<<grid, 32 * (round_up(Q, 16) / 16), smem, st>>>(
      s, q, g, m, z, delta, ds, part_dq, N, Q, E, chunk);
  return cudaGetLastError();
}

template <int KE>
cudaError_t launch_depth_bwd(dim3 grid, size_t smem, cudaStream_t st, const __nv_bfloat16* s,
                             const __nv_bfloat16* q, const __nv_bfloat16* w, const float* bias,
                             const float* centers, const float* g, __nv_bfloat16* ds,
                             float* part_dq, float* part_dw, float* part_db, float* part_dc,
                             int N, int Q, int E, int D, int chunk) {
  cudaError_t err = cudaFuncSetAttribute(sql_depth_bwd_partial<KE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_depth_bwd_partial<KE><<<grid, 32 * kDepthWarps, smem, st>>>(
      s, q, w, bias, centers, g, ds, part_dq, part_dw, part_db, part_dc, N, Q, E, D, chunk);
  return cudaGetLastError();
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
// out [B,Q,E], m_out and z_out [B,Q] float32.
int sql_summary_fwd(const void* s, const void* q, void* part_m, void* part_z, void* part_acc,
                    void* out, void* m_out, void* z_out, int B, int N, int Q, int E, int chunk,
                    void* stream) {
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
  sql_summary_merge<<<dim3((Q * E + 255) / 256, B), 256, 0, st>>>(
      pm, pz, pa, static_cast<float*>(out), static_cast<float*>(m_out),
      static_cast<float*>(z_out), n_chunks, Q, E);
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

// Backward of sql_summary_fwd for the cotangent g [B,Q,E] float32 of its
// output, with the forward's m, z [B,Q] and delta = sum_e g * out [B,Q]:
// ds [B,N,E] bf16 and dq [B,Q,E] float32. part_dq [B,C,Q,E] float32 with
// C = ceil(N / chunk), chunk % 64 == 0. E <= 64.
int sql_summary_bwd(const void* s, const void* q, const void* g, const void* m, const void* z,
                    const void* delta, void* ds, void* part_dq, void* dq, int B, int N, int Q,
                    int E, int chunk, void* stream) {
  if (!shapes_ok(B, N, Q, E) || E > kMaxEBwd || chunk <= 0 || chunk % kTile != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
  const size_t smem = summary_bwd_smem(Q, E);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, B);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* gp = static_cast<const float*>(g);
  const auto* mp = static_cast<const float*>(m);
  const auto* zp = static_cast<const float*>(z);
  const auto* dp = static_cast<const float*>(delta);
  auto* dsp = static_cast<__nv_bfloat16*>(ds);
  auto* pq = static_cast<float*>(part_dq);
  cudaError_t err;
  switch (round_up(E, 16) / 16) {
#define SQL_SUMMARY_BWD_CASE(KE) \
  case KE: err = launch_summary_bwd<KE>(grid, smem, st, sp, qp, gp, mp, zp, dp, dsp, pq, N, Q, E, chunk); break;
    SQL_SUMMARY_BWD_CASE(1)
    SQL_SUMMARY_BWD_CASE(2)
    SQL_SUMMARY_BWD_CASE(3)
    SQL_SUMMARY_BWD_CASE(4)
#undef SQL_SUMMARY_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum(pq, static_cast<float*>(dq), B, n_chunks, Q * E, st);
}

// Backward of sql_depth_fwd for the cotangent g [B,N] float32 of its
// output: ds [B,N,E] bf16, dq [B,Q,E], dw [Q,D], db [D] and dc [B,D]
// float32. Partials, with C = ceil(N / chunk) and chunk % 64 == 0:
// part_dq [B,C,Q,E], part_dw [B,C,Q,D], part_db and part_dc [B,C,D].
// E <= 64.
int sql_depth_bwd(const void* s, const void* q, const void* w, const void* bias,
                  const void* centers, const void* g, void* ds, void* part_dq, void* part_dw,
                  void* part_db, void* part_dc, void* dq, void* dw, void* db, void* dc, int B,
                  int N, int Q, int E, int D, int chunk, void* stream) {
  if (!shapes_ok(B, N, Q, E) || E > kMaxEBwd || D <= 0 || D > kMaxD || chunk <= 0 ||
      chunk % kBwdTile != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
  const size_t smem = depth_bwd_smem(Q, E, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, B);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* cp = static_cast<const float*>(centers);
  const auto* gp = static_cast<const float*>(g);
  auto* dsp = static_cast<__nv_bfloat16*>(ds);
  auto* pq = static_cast<float*>(part_dq);
  auto* pw = static_cast<float*>(part_dw);
  auto* pb = static_cast<float*>(part_db);
  auto* pc = static_cast<float*>(part_dc);
  cudaError_t err;
  switch (round_up(E, 16) / 16) {
#define SQL_DEPTH_BWD_CASE(KE) \
  case KE: err = launch_depth_bwd<KE>(grid, smem, st, sp, qp, wp, bp, cp, gp, dsp, pq, pw, pb, pc, N, Q, E, D, chunk); break;
    SQL_DEPTH_BWD_CASE(1)
    SQL_DEPTH_BWD_CASE(2)
    SQL_DEPTH_BWD_CASE(3)
    SQL_DEPTH_BWD_CASE(4)
#undef SQL_DEPTH_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if ((err = launch_sum(pq, static_cast<float*>(dq), B, n_chunks, Q * E, st)) != cudaSuccess)
    return (int)err;
  if ((err = launch_sum(pc, static_cast<float*>(dc), B, n_chunks, D, st)) != cudaSuccess)
    return (int)err;
  if ((err = launch_sum(pw, static_cast<float*>(dw), 1, B * n_chunks, Q * D, st)) != cudaSuccess)
    return (int)err;
  return (int)launch_sum(pb, static_cast<float*>(db), 1, B * n_chunks, D, st);
}

const char* sql_kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
