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
// cores, through wgmma in the two forwards and mma.sync m16n8k16 in the
// backwards (bf16 operands, float32 accumulation), as the Pallas kernels
// ran bf16 dots with f32 accumulation on the MXU; softmax statistics stay
// float32. Limits (checked by the wrapper and here): Q <= 128, D <= 128,
// E <= 128 with E % 8 == 0; any N (the ragged tail is masked).
//
// What bounds them on an H100 at the flagship shape (B=4, N=81,920, Q=128,
// E=32, D=128; the training step's B=8 doubles each figure), and what the
// design does about it:
//
//  * summary. One read of S: 2*B*N*E bytes = 21 MB, 6.3 us at 3.35 TB/s.
//    2*2*B*N*Q*E = 5.4 GFLOP of products (5.5 us at the 989 TFLOP/s dense
//    bf16 peak), and B*N*Q = 42 M exps on the special-function units (16
//    per clock per SM, about 10 us). So it is bounded by the exps and the
//    S read together, not by the products. The TPU kernel walks the pixel
//    tiles in order and carries the running max, sum and accumulator from
//    one grid step to the next. Blocks on the GPU run in no order, so N is
//    cut into chunks, one block per (chunk, b) holding all Q queries in one
//    warpgroup per 64 of them (two for Q > 64: both read each S tile from
//    shared memory, so S leaves device memory once). Per 64-pixel tile, on
//    wgmma: the energy [64 q, 64 px] = Q . S_tile^T with both operands
//    K-major in shared memory; an online softmax over the pixels in
//    registers; and acc [64 q, E] += bf16(p) . S_tile, p as the register A
//    operand as the energy accumulator lies (FlashAttention-3's P.V move)
//    and the S tile, stored [px][E], as the B operand read MN-major
//    through the descriptor's transpose bit, so no transposed copy is
//    built. The S tiles arrive by cp.async in a ring of three, two in
//    flight while one is multiplied. Each block writes a partial (m, z,
//    acc[Q,E]); a second kernel merges them by log-sum-exp in a fixed order
//    (flash-decoding), one block of four warps a (b, q) row, the warps
//    splitting the chunks. The wrapper sizes the grid to one wave of the
//    card's occupancy for the compiled kernel, with no more chunks a batch
//    row than keep the partials at a quarter of S's bytes (75 at serving
//    batch 1). Like the Pallas kernel, the unnormalised p is rounded to
//    bf16 for the P.S product while z sums it in float32.
//
//  * depth. 2*B*N*Q*(E+D) = 13.4 GFLOP of products (13.6 us at the bf16
//    peak), the same 21 MB read of S, and B*N*D = 42 M exps on the
//    special-function units (~10 us): the products and the exps bound it
//    together (the training batch of 8 doubles all three). Each pixel is
//    independent, so there is no cross-block reduction. One warpgroup a
//    block (128 threads) walks 64-pixel tiles with wgmma, the only way to
//    the tensor cores' full rate: the energy [64, Q] = S . Q^T is an
//    m64nQk16 chain over E with both operands in shared memory, and its
//    float32 accumulator, rounded to bf16 (the TPU kernel's _bf16(e_t)),
//    is the register A operand of the W product [64, D] as it lies
//    (FlashAttention-3's P.V move), so the energies never leave registers
//    and each warpgroup reads W once a tile. Q[b] and W^T (32 KB each at
//    most) load once a block; the next S tile arrives by cp.async into a
//    second buffer while the current one is multiplied. The [64, D]
//    logits stay in registers, issued as chains of 64 bins each at once,
//    so that the exps of one half run while the tensor cores work on the
//    next (a running max merges the halves); the row max and the
//    exp-weighted sums against the centers reduce across the four lanes
//    that share a row. With two warpgroups an SM (199 registers at Q = D =
//    128), one's exps overlap the other's products too.
//    Q and D are padded to 64 or 128 (four compiled instances, zero rows of
//    Q and W, -inf bias past D), E to a multiple of 16 at run time. The
//    grid is one wave by the card's occupancy for the compiled kernel,
//    spread over the batch rows, so batch 1 fills the card too.
//
// The backward passes, at the training slice's shape (B=8, N=81,920,
// Q=128, E=32, D=128), counting each input read once and each output
// written once, products at the 989 TFLOP/s bf16 dense peak; any E <= 128
// (E % 8 == 0), Q <= 128, D <= 128, any N:
//
//  * sql_summary_bwd replaces _fq_bwd_kernel (_fq_call_bwd, the VJP of
//    flash_full_query): dS [B,N,E] bf16 and dQ [B,Q,E] from the cotangent
//    g [B,Q,E] and the forward's m, z and delta = sum_e g * out. Five
//    products of 2*B*N*Q*E (energy, dattn, dQ and the two halves of dS):
//    26.8 GFLOP, 27 us; reads S and writes dS, 84 MB, 25 us; 84 M exps.
//  * sql_depth_bwd replaces _bins_bwd_kernel (_bins_call_bwd, the VJP of
//    flash_bins_depth): dS, dQ, dW [Q,D], db [D] and dc [B,D]. Products:
//    2*B*N*(3*Q*E + 3*Q*D) = 80.5 GFLOP, 81 us; 87 MB moved, 26 us.
//
// Both are bounded by the products, which mma.sync issues from fragments
// in registers: what holds them back is feeding the tensor cores (shared
// memory traffic, barriers, too few warps) and, in the bins backward, the
// registers of a long per-pixel chain beside the [Q,D] sum. The design:
//
//  - A block of 8 warps walks its chunk of N in steps of 128 pixels. The
//    S tile of the next step is in flight (cp.async, 16 bytes a copy)
//    while the current one is multiplied; where two tiles do not fit in
//    shared memory (the bins backward at E > 96 and D > 64) the load
//    waits instead.
//  - Phase 1, per pixel: each warp takes 16 pixels against every query,
//    so the products that reduce over the queries (dS, and in the bins
//    head the logits and dl -> de) chain in registers: the accumulator of
//    one m16n8k16 product, rounded to bf16, is the A fragment of the next
//    (the Pallas kernels' _bf16 before each product). Of the [16, D]
//    logits only one query tile of energies is live at a time.
//  - Phase 2, per query: the products that reduce over the pixels (dQ,
//    and dW) read the step's bf16 tiles (de; e, dl) that phase 1 staged in
//    shared memory with stmatrix, each warp owning 16 query rows, and keep
//    their float32 sums in registers for the block's life: dW [16, D] and
//    dQ [16, E] a warp, written once a block.
//  - Every fragment comes from shared memory through ldmatrix (.trans for
//    the transposed operands: S and Q as [k][n], e and de as [px][q] read
//    as q-major), rows padded by 16 bytes so that no load meets a bank
//    conflict.
//  - The bins backward's dc and db sums over a warp's 16 pixels are
//    reduce-scattered across the 8 lanes that share a column (each lane
//    keeps one 8-column tile) and summed over the warps once a block.
//  - Loop bounds follow the real query tiles; the D tiles (4 or 8 of 16)
//    and the E tiles (2, 4, 6 or 8) are compiled in, so the indoor D = 64
//    pays for 64 bins.
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

// ---------------------------------------------------------------------------
// Backward passes: blocks of kBwdWarps warps, kStep pixels a step (16 a
// warp), fragments from shared memory through ldmatrix and stmatrix, S
// tiles through cp.async.
// ---------------------------------------------------------------------------
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kStep = 16 * kBwdWarps;  // pixels per block step
constexpr int kLdQ = kMaxQ + 8;        // row stride of the staged [px][q] tiles
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory a block can have

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices between shared memory and registers. Lane l gives
// the address of row l % 8 of matrix l / 8; register i holds matrix i as
// an mma fragment (row lane / 4, columns 2 * (lane % 4) and the next), or
// with .trans the transposed matrix.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stsm(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.x4.m8n8.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :
               : "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// Lane offsets (elements) into a tile of row stride ld, added to the
// address of the tile's top-left element:
//   lane_x: matrices at (rows, cols) (0, 0), (8, 0), (0, 8), (8, 8): the A
//     fragment of an [m][k] tile (ldsm, and stsm back), or with ldsm_t the
//     B fragments of two n-tiles of a [k][n] tile;
//   lane_y: matrices at (0, 0), (0, 8), (8, 0), (8, 8): the B fragments of
//     two n-tiles of an [n][k] tile (ldsm), or with ldsm_t the A fragment
//     of a [k][m] tile.
// Either way registers 0, 1 are (b0, b1) of the first n-tile, 2, 3 of the
// second. Rows of 16 * odd bytes keep every ldmatrix free of bank
// conflicts.
__device__ __forceinline__ uint32_t lane_x(int lane, int ld) {
  return 2u * ((lane & 15) * ld + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t lane_y(int lane, int ld) {
  return 2u * (((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
}

// Byte offset of element (row, col) of a bf16 tile of row stride ld.
__host__ __device__ constexpr uint32_t at(int row, int col, int ld) {
  return 2u * (row * ld + col);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Two adjacent 16x8 accumulator tiles as one 16x16 A fragment (bf16).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The step's pixel rows [row0, row0 + kStep) of the row-major [n_rows, E]
// bf16 matrix src into a [kStep][ld] tile, by cp.async (not waited for);
// zero past n_rows and past E (E % 8 == 0).
template <int KE>
__device__ __forceinline__ void load_step(uint32_t dst, int ld,
                                          const __nv_bfloat16* __restrict__ src, int row0,
                                          int n_rows, int E, int tid) {
  constexpr int chunks = 2 * KE;  // 16-byte copies a row
#pragma unroll
  for (int j = 0; j < KE; ++j) {
    const int i = tid + j * kBwdThreads;
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const bool valid = row0 + r < n_rows && c < E;
    cp_async16(dst + at(r, c, ld), valid ? src + (size_t)(row0 + r) * E + c : src, valid);
  }
}

// Rows [0, rows) of the row-major [n_rows, cols] matrix src into a
// [rows][ld] bf16 tile, zero past n_rows and past cols (at block start).
template <typename T>
__device__ __forceinline__ void load_padded(__nv_bfloat16* dst, int ld, const T* __restrict__ src,
                                            int rows, int width, int n_rows, int cols,
                                            int tid) {
  for (int i = tid; i < rows * width; i += kBwdThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * ld + c] = (r < n_rows && c < cols) ? __float2bfloat16((float)src[(size_t)r * cols + c])
                                               : __float2bfloat16(0.f);
  }
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
// depth: one warpgroup a block walks 64-pixel tiles of one batch row with
// wgmma. Operand tiles in shared memory are K-major 8x8 core matrices with
// no swizzle: element (r, k) of a tile of K columns (K % 16 == 0) at byte
// core_at(r, k, K), so the 8 rows of a core matrix are 128 contiguous
// bytes and every wgmma read is free of bank conflicts.
// ---------------------------------------------------------------------------
constexpr int kDepthThreads = 128;  // one warpgroup
constexpr int kDepthPx = 64;        // pixels a tile: wgmma's M

__host__ __device__ constexpr uint32_t core_at(int r, int k, int K) {
  return (uint32_t)((r >> 3) * (K >> 3) * 128 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2);
}

// Shared-memory matrix descriptor of a tile in that layout: the two core
// matrices of a k16 step 128 bytes apart (leading byte offset), rows of
// core matrices K / 8 * 128 bytes apart (stride byte offset), no swizzle.
// The next k16 step starts 256 bytes on: + 16 in the address field.
__device__ __forceinline__ uint64_t core_desc(uint32_t addr, int K) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((K / 8 * 128) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// that is still in flight.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Writes of this thread to shared memory (st.shared, cp.async) become
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d (+)= A . B, m64n64k16, A and B from shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A . B, m64n64k16, A from registers (an mma A fragment a warp), B
// from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (+)= A . B, m64n128k16, A and B from shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A . B, m64n128k16, A from registers (an mma A fragment a warp), B
// from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


// d += A . B, m64nNk16 for N = 32, 64, 96, 128: A from registers (an mma A
// fragment a warp), B from shared memory MN-major (the descriptor's
// transpose bit, taken for bf16): B[k][n] with n contiguous, as an S tile
// [px][E] lies for the P.S product.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared-memory descriptor of an S tile [kSumPx][EP] in the core layout as
// the MN-major B operand of P.S (k = pixel, n = e): the two 8-pixel core
// matrices of a k16 step EP / 8 * 128 bytes apart (leading byte offset),
// the 8-wide e blocks 128 bytes apart (stride byte offset), no swizzle.
// The next k16 step starts 2 * EP * 16 bytes on.
__device__ __forceinline__ uint64_t core_desc_mn(uint32_t addr, int EP) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)((EP / 8 * 128) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// summary, pass 1: one block per (chunk of N, b), one warpgroup per 64
// queries (NWG = 1 for Q <= 64, 2 up to 128), 64-pixel tiles of S in a ring
// of kSumStages stages by cp.async. Per tile, warpgroup wg:
//   e   = Q[64wg..] . S_tile^T  [64 q, 64 px]  wgmma, both operands in
//                                              shared memory (K-major)
//   online softmax over the pixels (row max, rescale), p = exp(e - m)
//   acc = acc * alpha + bf16(p) . S_tile       wgmma, p as the register A
//                                              operand, S_tile as the
//                                              MN-major B operand
// then writes the chunk's partial (m, z, acc[Q,E]).
// ---------------------------------------------------------------------------
constexpr int kSumPx = 64;      // pixels a tile: the energy's N, the P.S product's K
constexpr int kSumStages = 3;   // S tiles in flight or in use
static_assert(kSumStages == 3, "the loop waits for all but one copy group");

__host__ __device__ constexpr size_t summary_smem(int NWG, int KE) {
  return ((size_t)64 * NWG + (size_t)kSumStages * kSumPx) * 16 * KE * 2;
}

template <int KE, int NWG>  // EP = 16 * KE: E padded to 32, 64, 96 or 128; QN = 64 * NWG
__global__ void __launch_bounds__(128 * NWG, KE <= 4 ? 2 : 1) sql_summary_partial(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    float* __restrict__ part_m, float* __restrict__ part_z, float* __restrict__ part_acc,
    int N, int Q, int E, int chunk) {
  constexpr int EP = 16 * KE, QN = 64 * NWG, kThreads = 128 * NWG;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;              // Q [QN][EP], core layout, zero past Q and E
  unsigned char* ss = qs + QN * EP * 2;  // kSumStages S tiles [kSumPx][EP], core layout

  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* sb = s + (size_t)b * N * E;
  const uint32_t ss_a = smem_addr(ss), tile_bytes = kSumPx * EP * 2;
  const int tile0 = c * (chunk / kSumPx);
  const int n_it = min(chunk / kSumPx, (N + kSumPx - 1) / kSumPx - tile0);

  // tile tile0 + it into stage it % kSumStages by cp.async, 16 bytes (8 e of
  // one pixel) a copy, pixels fastest: 8 neighbouring lanes fill one core
  // matrix; zero past N and past E. One commit group a call, empty past the
  // chunk's end.
  auto load_tile = [&](int it) {
    if (it < n_it) {
      const int p0 = (tile0 + it) * kSumPx;
      const uint32_t dst = ss_a + (it % kSumStages) * tile_bytes;
#pragma unroll
      for (int j = 0; j < kSumPx * EP / 8 / kThreads; ++j) {
        const int i = tid + j * kThreads, r = i % kSumPx, k = (i / kSumPx) * 8;
        const bool valid = p0 + r < N && k < E;
        cp_async16(dst + core_at(r, k, EP), valid ? sb + (size_t)(p0 + r) * E + k : sb, valid);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < QN * EP / 8; i += kThreads) {  // Q, in tile 0's group
    const int r = i % QN, k = (i / QN) * 8;
    const bool valid = r < Q && k < E;
    cp_async16(smem_addr(qs) + core_at(r, k, EP), valid ? q + ((size_t)b * Q + r) * E + k : q,
               valid);
  }
#pragma unroll
  for (int it = 0; it < kSumStages - 1; ++it) load_tile(it);

  // this warpgroup's 64 query rows; the lane holds rows 16 * warp + g and
  // + 8 of them, columns 8j + 2t (+1) of every accumulator
  const uint64_t q_desc = core_desc(smem_addr(qs) + wg * 64 * EP * 2, EP);
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float z[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[EP / 2];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_one();  // this thread's copies of tile it (and Q) landed
    fence_async_smem();
    __syncthreads();  // everyone's copies landed; everyone is done with tile it - 1
    load_tile(it + kSumStages - 1);  // into tile it - 1's stage
    const uint32_t st_a = ss_a + (it % kSumStages) * tile_bytes;

    // energy [64 q, 64 px]; the first product of the chain overwrites e
    float e[kSumPx / 2];
    fence_regs(e);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KE; ++kk)
      wgmma_ss(e, q_desc + 16 * kk, core_desc(st_a, EP) + 16 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(e);

    // the ragged tail (the tile holds at least one pixel < N, so the new
    // max is finite), then the online max
    const int p0 = (tile0 + it) * kSumPx;
    if (p0 + kSumPx > N) {
#pragma unroll
      for (int j = 0; j < kSumPx / 8; ++j) {
        const int col = p0 + 8 * j + 2 * t;
        if (col >= N) e[4 * j] = e[4 * j + 2] = -INFINITY;
        if (col + 1 >= N) e[4 * j + 1] = e[4 * j + 3] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSumPx / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(e[4 * j], e[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(e[4 * j + 2], e[4 * j + 3]));
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = ex2((m[i] - mn) * kLog2e);  // 0 on the first tile
      m[i] = mn;
      ml[i] = mn * kLog2e;
    }
    // p = exp(e - m) = 2^(e log2(e) - m log2(e)), z sums it in float32
    float zs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kSumPx / 8; ++j) {
      e[4 * j] = ex2(fmaf(e[4 * j], kLog2e, -ml[0]));
      e[4 * j + 1] = ex2(fmaf(e[4 * j + 1], kLog2e, -ml[0]));
      e[4 * j + 2] = ex2(fmaf(e[4 * j + 2], kLog2e, -ml[1]));
      e[4 * j + 3] = ex2(fmaf(e[4 * j + 3], kLog2e, -ml[1]));
      zs[0] += e[4 * j] + e[4 * j + 1];
      zs[1] += e[4 * j + 2] + e[4 * j + 3];
    }
    z[0] = z[0] * alpha[0] + zs[0];
    z[1] = z[1] * alpha[1] + zs[1];

    // bf16(p) is the A fragment of the P.S product as it lies: the
    // accumulator columns 16kk..16kk+15 are k-step kk
    uint32_t pa[kSumPx / 16][4];
#pragma unroll
    for (int kk = 0; kk < kSumPx / 16; ++kk) {
      pa[kk][0] = pack_bf16(e[8 * kk], e[8 * kk + 1]);
      pa[kk][1] = pack_bf16(e[8 * kk + 2], e[8 * kk + 3]);
      pa[kk][2] = pack_bf16(e[8 * kk + 4], e[8 * kk + 5]);
      pa[kk][3] = pack_bf16(e[8 * kk + 6], e[8 * kk + 7]);
    }
#pragma unroll
    for (int j = 0; j < EP / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSumPx / 16; ++kk)
      wgmma_rs_mn(acc, pa[kk], core_desc_mn(st_a + kk * 2 * EP * 16, EP));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  z[0] = quad_sum(z[0]);
  z[1] = quad_sum(z[1]);
  const size_t base = ((size_t)b * n_chunks + c) * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 64 * wg + 16 * warp + g + 8 * i;
    if (row >= Q) continue;
    if (t == 0) {
      part_m[base + row] = m[i];
      part_z[base + row] = z[i];
    }
    float* out = part_acc + (base + row) * E;
#pragma unroll
    for (int j = 0; j < EP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < E)  // E % 8 == 0, so col + 1 < E too
        *reinterpret_cast<float2*>(out + col) = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// summary, pass 2: the log-sum-exp merge of one batch row's chunk partials
// for one query, a block of kMergeWarps warps a (b, q) row. Every warp
// finds the row max over the chunks and the partition z; warp w sums the
// rescaled accumulators of chunks w, w + kMergeWarps, ... (lane l owns
// columns l, l + 32, ...), and the warps' sums add in warp order: a fixed
// order, no atomics, so two calls give the same bits. Thread 0 also
// writes the row's max m and partition z, the backward pass's residuals.
constexpr int kMergeWarps = 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kMergeWarps) sql_summary_merge(
    const float* __restrict__ part_m, const float* __restrict__ part_z,
    const float* __restrict__ part_acc, float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ z_out, int n_chunks, int Q, int E) {
  __shared__ float sums[kMergeWarps][kMaxE];
  const int row = blockIdx.x, b = row / Q, qi = row - b * Q;  // row = b * Q + qi
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pm = part_m + (size_t)b * n_chunks * Q + qi;  // chunk c at c * Q
  const float* pz = part_z + (size_t)b * n_chunks * Q + qi;
  const float* pa = part_acc + ((size_t)b * n_chunks * Q + qi) * E;  // chunk c at c * Q * E
  float mx = -INFINITY;
  for (int c = lane; c < n_chunks; c += 32) mx = fmaxf(mx, pm[(size_t)c * Q]);
  mx = warp_max(mx);
  float zsum = 0.f;
  for (int c = lane; c < n_chunks; c += 32) zsum += __expf(pm[(size_t)c * Q] - mx) * pz[(size_t)c * Q];
  zsum = warp_sum(zsum);
  float a[kMaxE / 32];
#pragma unroll
  for (int i = 0; i < kMaxE / 32; ++i) a[i] = 0.f;
#pragma unroll 4
  for (int c = warp; c < n_chunks; c += kMergeWarps) {
    const float w = __expf(pm[(size_t)c * Q] - mx);
    const float* pc = pa + (size_t)c * Q * E;
#pragma unroll
    for (int i = 0; i < kMaxE / 32; ++i) {
      const int col = lane + 32 * i;
      if (col < E) a[i] += w * pc[col];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxE / 32; ++i) {
    const int col = lane + 32 * i;
    if (col < E) sums[warp][col] = a[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < E; col += 32 * kMergeWarps) {
    float v = sums[0][col];
#pragma unroll
    for (int w = 1; w < kMergeWarps; ++w) v += sums[w][col];
    out[(size_t)row * E + col] = v / zsum;
  }
  if (threadIdx.x == 0) {
    m_out[row] = mx;
    z_out[row] = zsum;
  }
}

__host__ __device__ constexpr size_t depth_smem(int QN, int DN, int EP) {
  return 2 * (size_t)DN * sizeof(float) +
         ((size_t)DN * QN + (size_t)QN * EP + 2 * (size_t)kDepthPx * EP) * 2;
}

template <int QN, int DN>  // Q padded to 64 or 128, D likewise
__global__ void __launch_bounds__(kDepthThreads, 2) sql_depth_kernel(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ centers, float* __restrict__ out, int N, int Q, int E, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int EP = round_up(E, 16), KE = EP / 16;
  float* bias_s = reinterpret_cast<float*>(smem);  // [DN], -inf past D
  float* cen_s = bias_s + DN;                      // [DN], 0 past D
  unsigned char* wt = smem + 2 * DN * sizeof(float);  // W^T [DN][QN], core layout
  unsigned char* qs = wt + DN * QN * 2;               // Q [QN][EP], core layout
  unsigned char* ss = qs + QN * EP * 2;               // [2] S tiles [kDepthPx][EP]

  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* sb = s + (size_t)b * N * E;
  const int n_tiles = (N + kDepthPx - 1) / kDepthPx;
  const uint32_t ss_a = smem_addr(ss), tile_bytes = kDepthPx * EP * 2;

  // an S tile into buffer buf by cp.async, 16 bytes (8 k of one pixel) a
  // copy, rows fastest: 8 neighbouring lanes fill one core matrix; zero
  // past N and past E
  auto load_tile = [&](int tile, int buf) {
    const int p0 = tile * kDepthPx;
    for (int i = tid; i < kDepthPx * EP / 8; i += kDepthThreads) {
      const int r = i % kDepthPx, k = (i / kDepthPx) * 8;
      const bool valid = p0 + r < N && k < E;
      cp_async16(ss_a + buf * tile_bytes + core_at(r, k, EP),
                 valid ? sb + (size_t)(p0 + r) * E + k : sb, valid);
    }
    cp_async_commit();
  };

  int tile = blockIdx.x;
  if (tile < n_tiles) load_tile(tile, 0);  // in flight while the block's operands load
  for (int i = tid; i < QN * EP / 8; i += kDepthThreads) {
    const int r = i % QN, k = (i / QN) * 8;
    const bool valid = r < Q && k < E;
    cp_async16(smem_addr(qs) + core_at(r, k, EP), valid ? q + ((size_t)b * Q + r) * E + k : q,
               valid);
  }
  cp_async_commit();
  // W [Q][D] as the K-major B operand W^T, once a block; zero past Q and D.
  // Every load of a thread is issued before the first store waits on one:
  // 16-byte rows of 8 bins where D % 8 == 0, single values otherwise.
  if (D % 8 == 0) {
    constexpr int kVecs = QN * DN / 8 / kDepthThreads, kBatch = kVecs < 8 ? kVecs : 8;
    for (int j0 = 0; j0 < kVecs; j0 += kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = tid + (j0 + j) * kDepthThreads, qi = i / (DN / 8), d = (i % (DN / 8)) * 8;
        v[j] = (qi < Q && d < D) ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)qi * D + d))
                                 : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = tid + (j0 + j) * kDepthThreads, qi = i / (DN / 8), d = (i % (DN / 8)) * 8;
        const uint16_t* h = reinterpret_cast<const uint16_t*>(&v[j]);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<uint16_t*>(wt + core_at(d + k, qi, QN)) = h[k];
      }
    }
  } else {
    constexpr int kVals = 16;
    for (int i0 = tid; i0 < QN * DN; i0 += kVals * kDepthThreads) {
      __nv_bfloat16 v[kVals];
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int i = i0 + j * kDepthThreads, d = i % DN, qi = i / DN;
        v[j] = (i < QN * DN && qi < Q && d < D) ? w[(size_t)qi * D + d] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int j = 0; j < kVals; ++j) {
        const int i = i0 + j * kDepthThreads;
        if (i < QN * DN)
          *reinterpret_cast<__nv_bfloat16*>(wt + core_at(i % DN, i / DN, QN)) = v[j];
      }
    }
  }
  for (int d = tid; d < DN; d += kDepthThreads) {
    bias_s[d] = d < D ? bias[d] : -INFINITY;
    cen_s[d] = d < D ? centers[(size_t)b * D + d] : 0.f;
  }

  const uint64_t q_desc = core_desc(smem_addr(qs), EP), w_desc = core_desc(smem_addr(wt), QN);
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int buf = it & 1;
    if (tile + (int)gridDim.x < n_tiles) {
      load_tile(tile + gridDim.x, buf ^ 1);
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
    cp_async_wait_one();  // this tile (and Q) have landed
    fence_async_smem();
    __syncthreads();

    // energy [64 px, QN] = S . Q^T over E; warp w holds pixels 16w + g and
    // 16w + g + 8, columns 8j + 2t (+1) in e[4j..4j+3]
    const uint64_t s_desc = core_desc(ss_a + buf * tile_bytes, EP);
    // no initial values: the first product of each chain overwrites them
    // (scale-d 0), and an instruction of ours writing an accumulator would
    // make ptxas serialize the wgmmas
    float e[QN / 2];
    fence_regs(e);
    wgmma_fence();
    for (int kk = 0; kk < KE; ++kk) wgmma_ss(e, s_desc + 16 * kk, q_desc + 16 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(e);

    // bf16(energy) is the A fragment of the W product as it lies: the
    // accumulator columns 16kq..16kq+15 are k-step kq
    uint32_t ea[QN / 16][4];
#pragma unroll
    for (int kq = 0; kq < QN / 16; ++kq) {
      ea[kq][0] = pack_bf16(e[8 * kq], e[8 * kq + 1]);
      ea[kq][1] = pack_bf16(e[8 * kq + 2], e[8 * kq + 3]);
      ea[kq][2] = pack_bf16(e[8 * kq + 4], e[8 * kq + 5]);
      ea[kq][3] = pack_bf16(e[8 * kq + 6], e[8 * kq + 7]);
    }

    // logits [64, DN] = bf16(energy) . W in halves of 64 bins, every half's
    // chain issued at once: the softmax of one half runs while the tensor
    // cores work on the next
    constexpr int kHalves = DN / 64;
    float lg[kHalves][32];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_regs(lg[h]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int kq = 0; kq < QN / 16; ++kq)
        wgmma_rs(lg[h], ea[kq], w_desc + h * (8 * QN / 8 * 128 >> 4) + 16 * kq, kq);
      wgmma_commit();
    }

    // + bias (-inf on padded bins); a softmax over the bins against the
    // centers, merged half by half (running max, rescaled sums); a row's
    // four lanes reduce together
    float m[2] = {-INFINITY, -INFINITY}, num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      if (h + 1 < kHalves)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(lg[h]);
      float* l = lg[h];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + 64 * h + 8 * j + 2 * t);
        l[4 * j] += bb.x;
        l[4 * j + 1] += bb.y;
        l[4 * j + 2] += bb.x;
        l[4 * j + 3] += bb.y;
        mx[0] = fmaxf(mx[0], fmaxf(l[4 * j], l[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(l[4 * j + 2], l[4 * j + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the first half holds a real bin (D >= 1), so m is finite after it
        const float mn = fmaxf(m[i], quad_max(mx[i]));
        const float scale = __expf(m[i] - mn);
        num[i] *= scale;
        den[i] *= scale;
        m[i] = mn;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 cc = *reinterpret_cast<const float2*>(cen_s + 64 * h + 8 * j + 2 * t);
        const float e0 = __expf(l[4 * j] - m[0]), e1 = __expf(l[4 * j + 1] - m[0]);
        const float e2 = __expf(l[4 * j + 2] - m[1]), e3 = __expf(l[4 * j + 3] - m[1]);
        num[0] += e0 * cc.x + e1 * cc.y;
        den[0] += e0 + e1;
        num[1] += e2 * cc.x + e3 * cc.y;
        den[1] += e2 + e3;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      num[i] = quad_sum(num[i]);
      den[i] = quad_sum(den[i]);
    }
    const int px = tile * kDepthPx + 16 * warp + g;
    if (t == 0) {
      if (px < N) out[(size_t)b * N + px] = num[0] / den[0];
      if (px + 8 < N) out[(size_t)b * N + px + 8] = num[1] / den[1];
    }
    __syncthreads();  // every wgmma of this tile is done before its buffer refills
  }
}

// ---------------------------------------------------------------------------
// summary backward, pass 1: one block per (chunk of N, b). Per step:
//  phase 1, warp w on pixels [16w, 16w + 16) of the step, every query tile:
//   e  = S . Q^T, dattn = S . bf16(g)^T              [16 px, 16 q]
//   p  = exp(e - m) / z, de = p * (dattn - delta)     (float32)
//   dS += bf16(de) . Q + bf16(p) . bf16(g)            [16 px, E] -> global
//   bf16(de) -> shared memory
//  phase 2, warp w on queries [16w, 16w + 16):
//   dQ += bf16(de)^T . S                              (registers)
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t summary_bwd_smem(int KE) {
  return 2 * ((size_t)2 * kStep * (16 * KE + 8) + (size_t)2 * kMaxQ * (16 * KE + 8) +
              (size_t)kStep * kLdQ) +
         (size_t)3 * kMaxQ * sizeof(float);
}

template <int KE>  // EP = 16 * KE: E padded to 32, 64, 96 or 128
__global__ void __launch_bounds__(kBwdThreads, KE <= 2 ? 2 : 1) sql_summary_bwd_partial(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ g, const float* __restrict__ m, const float* __restrict__ z,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ ds,
    float* __restrict__ part_dq, int N, int Q, int E, int chunk) {
  constexpr int EP = 16 * KE, LD = EP + 8;
  constexpr bool kCacheS = KE <= 4;  // the warp's S fragments stay in registers
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kStep][LD] S tiles
  __nv_bfloat16* qs = ss + 2 * kStep * LD;                      // [kMaxQ][LD] Q
  __nv_bfloat16* gs = qs + kMaxQ * LD;                          // [kMaxQ][LD] bf16(g)
  __nv_bfloat16* des = gs + kMaxQ * LD;                         // [kStep][kLdQ] bf16(de)
  float* ms = reinterpret_cast<float*>(des + kStep * kLdQ);     // [kMaxQ] m
  float* rzs = ms + kMaxQ;                                      // [kMaxQ] 1 / z, 0 past Q
  float* dts = rzs + kMaxQ;                                     // [kMaxQ] delta

  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;
  const int QP = round_up(Q, 16), QK = QP / 16;
  const int pr = 16 * warp;  // the warp's pixel rows (phase 1) and query rows (phase 2)
  const __nv_bfloat16* sb = s + (size_t)b * N * E;
  const int n0 = c * chunk, n1 = min(n0 + chunk, N);
  const uint32_t ss_a = smem_addr(ss), qs_a = smem_addr(qs), gs_a = smem_addr(gs),
                 des_a = smem_addr(des);
  const uint32_t lx = lane_x(lane, LD), ly = lane_y(lane, LD);
  const uint32_t lxq = lane_x(lane, kLdQ), lyq = lane_y(lane, kLdQ);

  load_step<KE>(ss_a, LD, sb, n0, N, E, tid);  // in flight while the rest loads
  cp_async_commit();
  load_padded(qs, LD, q + (size_t)b * Q * E, QP, EP, Q, E, tid);
  load_padded(gs, LD, g + (size_t)b * Q * E, QP, EP, Q, E, tid);
  for (int r = tid; r < QP; r += kBwdThreads) {
    const bool in = r < Q;
    ms[r] = in ? m[(size_t)b * Q + r] : 0.f;
    rzs[r] = in ? 1.f / z[(size_t)b * Q + r] : 0.f;
    dts[r] = in ? delta[(size_t)b * Q + r] : 0.f;
  }

  float dq[2 * KE][4];
#pragma unroll
  for (int i = 0; i < 2 * KE; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int buf = 0;
  for (int t0 = n0; t0 < n1; t0 += kStep, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the tile has landed; every warp is done with the last step
    if (t0 + kStep < n1) {
      load_step<KE>(ss_a + at((buf ^ 1) * kStep, 0, LD), LD, sb, t0 + kStep, N, E, tid);
      cp_async_commit();
    }
    const uint32_t st_a = ss_a + at(buf * kStep, 0, LD);

    // phase 1
    uint32_t sa[kCacheS ? KE : 1][4];
    if constexpr (kCacheS) {
#pragma unroll
      for (int kk = 0; kk < KE; ++kk) ldsm(sa[kk], st_a + at(pr, 16 * kk, LD) + lx);
    }
    const int px = t0 + pr + gr;  // the lane's rows: px and px + 8
    const bool in0 = px < N, in1 = px + 8 < N;
    float dsa[2 * KE][4];
#pragma unroll
    for (int i = 0; i < 2 * KE; ++i) dsa[i][0] = dsa[i][1] = dsa[i][2] = dsa[i][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < kMaxQ / 16; ++kq) {
      if (kq < QK) {
        // e and dattn of this query tile: columns 16kq + 2t (+1) in the
        // first n-tile, + 8 in the second
        float e[2][4] = {}, da[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KE; ++kk) {
          uint32_t a[4], bq[4], bg[4];
          if constexpr (kCacheS) {
            a[0] = sa[kk][0], a[1] = sa[kk][1], a[2] = sa[kk][2], a[3] = sa[kk][3];
          } else {
            ldsm(a, st_a + at(pr, 16 * kk, LD) + lx);
          }
          ldsm(bq, qs_a + at(16 * kq, 16 * kk, LD) + ly);
          ldsm(bg, gs_a + at(16 * kq, 16 * kk, LD) + ly);
          mma16816(e[0], a, bq[0], bq[1]);
          mma16816(e[1], a, bq[2], bq[3]);
          mma16816(da[0], a, bg[0], bg[1]);
          mma16816(da[1], a, bg[2], bg[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qc = 16 * kq + 8 * h + 2 * t;
          const float2 mm = *reinterpret_cast<const float2*>(ms + qc);
          const float2 rz = *reinterpret_cast<const float2*>(rzs + qc);
          const float2 dt = *reinterpret_cast<const float2*>(dts + qc);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = j < 2 ? in0 : in1;
            const float p = in ? __expf(e[h][j] - ((j & 1) ? mm.y : mm.x)) * ((j & 1) ? rz.y : rz.x)
                               : 0.f;
            da[h][j] = p * (da[h][j] - ((j & 1) ? dt.y : dt.x));
            e[h][j] = p;
          }
        }
        uint32_t pa[4], dea[4];
        acc_to_a(pa, e[0], e[1]);
        acc_to_a(dea, da[0], da[1]);
        stsm(des_a + at(pr, 16 * kq, kLdQ) + lxq, dea);
#pragma unroll
        for (int ep = 0; ep < KE; ++ep) {
          uint32_t bq[4], bg[4];
          ldsm_t(bq, qs_a + at(16 * kq, 16 * ep, LD) + lx);
          ldsm_t(bg, gs_a + at(16 * kq, 16 * ep, LD) + lx);
          mma16816(dsa[2 * ep], dea, bq[0], bq[1]);
          mma16816(dsa[2 * ep + 1], dea, bq[2], bq[3]);
          mma16816(dsa[2 * ep], pa, bg[0], bg[1]);
          mma16816(dsa[2 * ep + 1], pa, bg[2], bg[3]);
        }
      }
    }
#pragma unroll
    for (int ne = 0; ne < 2 * KE; ++ne) {
      const int col = ne * 8 + 2 * t;
      if (col < E) {  // E % 8 == 0, so col + 1 < E too
        __nv_bfloat16* out = ds + ((size_t)b * N + px) * E + col;
        if (in0) *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(dsa[ne][0], dsa[ne][1]);
        if (in1)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * E) =
              __floats2bfloat162_rn(dsa[ne][2], dsa[ne][3]);
      }
    }
    __syncthreads();  // the step's de tile is complete

    // phase 2
    if (pr < QP) {
#pragma unroll
      for (int kp = 0; kp < kStep / 16; ++kp) {
        uint32_t a[4];
        ldsm_t(a, des_a + at(16 * kp, pr, kLdQ) + lyq);
#pragma unroll
        for (int ep = 0; ep < KE; ++ep) {
          uint32_t bs[4];
          ldsm_t(bs, st_a + at(16 * kp, 16 * ep, LD) + lx);
          mma16816(dq[2 * ep], a, bs[0], bs[1]);
          mma16816(dq[2 * ep + 1], a, bs[2], bs[3]);
        }
      }
    }
  }

  const size_t base = ((size_t)b * n_chunks + c) * Q;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = pr + gr + 8 * i;
    if (row >= Q) continue;
    float* out = part_dq + (base + row) * E;
#pragma unroll
    for (int ne = 0; ne < 2 * KE; ++ne) {
      const int col = ne * 8 + 2 * t;
      if (col < E) *reinterpret_cast<float2*>(out + col) = make_float2(dq[ne][2 * i], dq[ne][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// depth backward, pass 1: one block per (chunk of N, b). Per step:
//  phase 1, warp w on pixels [16w, 16w + 16):
//   e  = S . Q^T, one query tile at a time -> bf16 -> shared memory, and
//   l += bf16(e) . W over that tile            [16 px, D] (+ bias)
//   pn = softmax_D(l); dl = pn * (g c - sum_d pn g c)
//   dc += pn g, db += dl (summed over the warp's pixels, see below)
//   bf16(dl) -> shared memory; de = bf16(dl) . W^T -> bf16 -> shared memory
//   dS = bf16(de) . Q                           [16 px, E] -> global
//  phase 2, warp w on queries [16w, 16w + 16):
//   dW += bf16(e)^T . bf16(dl), dQ += bf16(de)^T . S   (registers)
// ---------------------------------------------------------------------------
__host__ __device__ constexpr size_t depth_bwd_smem(int KE, int KD, int stages) {
  return 2 * ((size_t)stages * kStep * (16 * KE + 8) + (size_t)kMaxQ * (16 * KE + 8) +
              (size_t)kMaxQ * (16 * KD + 8) + (size_t)2 * kStep * kLdQ +
              (size_t)kStep * (16 * KD + 8)) +
         (size_t)2 * 16 * KD * sizeof(float);
}

// S tiles in flight: two where they fit beside the rest
__host__ __device__ constexpr int depth_bwd_stages(int KE, int KD) {
  return depth_bwd_smem(KE, KD, 2) <= kMaxSmem ? 2 : 1;
}

// One stage of a reduce-scatter across the lanes lane ^ m: the lane keeps
// the half of v[0..2H) that its bit m selects, summed with the partner's.
template <int H>
__device__ __forceinline__ void reduce_half(float (&v)[32], int lane, int m) {
  const bool up = lane & m;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// Reduce-scatter of 32 values v[4j + 2 par + quantity] (n-tile j < 8,
// column 8j + 2t + par) over the 8 lanes of a column quad (lane bits 2-4):
// afterwards v[0..4) of lane (gr, t) holds the sums over those lanes of
// the entries of n-tile j = gr.
__device__ __forceinline__ void quad_column_reduce(float (&v)[32], int lane) {
  reduce_half<16>(v, lane, 16);
  reduce_half<8>(v, lane, 8);
  reduce_half<4>(v, lane, 4);
}

template <int KE, int KD>  // EP = 16 * KE, DP = 16 * KD (D padded to 64 or 128)
__global__ void __launch_bounds__(kBwdThreads, 1) sql_depth_bwd_partial(
    const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ centers, const float* __restrict__ gd,
    __nv_bfloat16* __restrict__ ds, float* __restrict__ part_dq, float* __restrict__ part_dw,
    float* __restrict__ part_db, float* __restrict__ part_dc, int N, int Q, int E, int D,
    int chunk) {
  constexpr int EP = 16 * KE, LD = EP + 8;
  constexpr int DP = 16 * KD, LDD = DP + 8;
  constexpr int NS = depth_bwd_stages(KE, KD);
  constexpr bool kCacheS = KE <= 4;
  constexpr int KEC = KE < 4 ? KE : 4;  // E tiles of 16 per dS pass
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ss = reinterpret_cast<__nv_bfloat16*>(smem);  // [NS][kStep][LD] S tiles
  __nv_bfloat16* qs = ss + NS * kStep * LD;                     // [kMaxQ][LD] Q
  __nv_bfloat16* ws = qs + kMaxQ * LD;                          // [kMaxQ][LDD] W
  __nv_bfloat16* es = ws + kMaxQ * LDD;                         // [kStep][kLdQ] bf16(e)
  __nv_bfloat16* des = es + kStep * kLdQ;                       // [kStep][kLdQ] bf16(de)
  __nv_bfloat16* dls = des + kStep * kLdQ;                      // [kStep][LDD] bf16(dl)
  float* bias_s = reinterpret_cast<float*>(dls + kStep * LDD);  // [DP], -inf past D
  float* cen_s = bias_s + DP;                                   // [DP], 0 past D

  const int b = blockIdx.y, c = blockIdx.x, n_chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;
  const int QP = round_up(Q, 16), QK = QP / 16;
  const int pr = 16 * warp;  // the warp's pixel rows (phase 1) and query rows (phase 2)
  const __nv_bfloat16* sb = s + (size_t)b * N * E;
  const float* gb = gd + (size_t)b * N;
  const int n0 = c * chunk, n1 = min(n0 + chunk, N);
  const uint32_t ss_a = smem_addr(ss), qs_a = smem_addr(qs), ws_a = smem_addr(ws),
                 es_a = smem_addr(es), des_a = smem_addr(des), dls_a = smem_addr(dls);
  const uint32_t lx = lane_x(lane, LD), ly = lane_y(lane, LD);
  const uint32_t lxq = lane_x(lane, kLdQ), lyq = lane_y(lane, kLdQ);
  const uint32_t lxd = lane_x(lane, LDD), lyd = lane_y(lane, LDD);

  load_step<KE>(ss_a, LD, sb, n0, N, E, tid);  // in flight while the rest loads
  cp_async_commit();
  load_padded(qs, LD, q + (size_t)b * Q * E, QP, EP, Q, E, tid);
  load_padded(ws, LDD, w, QP, DP, Q, D, tid);
  for (int d = tid; d < DP; d += kBwdThreads) {
    bias_s[d] = d < D ? bias[d] : -INFINITY;
    cen_s[d] = d < D ? centers[(size_t)b * D + d] : 0.f;
  }

  float dw[2 * KD][4], dq[2 * KE][4], dcb[KD];
#pragma unroll
  for (int i = 0; i < 2 * KD; ++i) dw[i][0] = dw[i][1] = dw[i][2] = dw[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * KE; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < KD; ++i) dcb[i] = 0.f;

  int buf = 0;
  for (int t0 = n0; t0 < n1; t0 += kStep) {
    cp_async_wait_all();
    __syncthreads();  // the tile has landed; every warp is done with the last step
    if constexpr (NS == 2) {
      if (t0 + kStep < n1) {
        load_step<KE>(ss_a + at((buf ^ 1) * kStep, 0, LD), LD, sb, t0 + kStep, N, E, tid);
        cp_async_commit();
      }
    }
    const uint32_t st_a = ss_a + at(buf * kStep, 0, LD);
    const int px = t0 + pr + gr;  // the lane's rows: px and px + 8
    const float g0 = px < N ? gb[px] : 0.f, g1 = px + 8 < N ? gb[px + 8] : 0.f;

    // phase 1: energies (staged) and logits
    uint32_t sa[kCacheS ? KE : 1][4];
    if constexpr (kCacheS) {
#pragma unroll
      for (int kk = 0; kk < KE; ++kk) ldsm(sa[kk], st_a + at(pr, 16 * kk, LD) + lx);
    }
    float lg[2 * KD][4];
#pragma unroll
    for (int i = 0; i < 2 * KD; ++i) lg[i][0] = lg[i][1] = lg[i][2] = lg[i][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < kMaxQ / 16; ++kq) {
      if (kq < QK) {
        float e0[4] = {}, e1[4] = {};
#pragma unroll
        for (int kk = 0; kk < KE; ++kk) {
          uint32_t a[4], bq[4];
          if constexpr (kCacheS) {
            a[0] = sa[kk][0], a[1] = sa[kk][1], a[2] = sa[kk][2], a[3] = sa[kk][3];
          } else {
            ldsm(a, st_a + at(pr, 16 * kk, LD) + lx);
          }
          ldsm(bq, qs_a + at(16 * kq, 16 * kk, LD) + ly);
          mma16816(e0, a, bq[0], bq[1]);
          mma16816(e1, a, bq[2], bq[3]);
        }
        uint32_t ea[4];
        acc_to_a(ea, e0, e1);
        stsm(es_a + at(pr, 16 * kq, kLdQ) + lxq, ea);
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t bw[4];
          ldsm_t(bw, ws_a + at(16 * kq, 16 * dp, LDD) + lxd);
          mma16816(lg[2 * dp], ea, bw[0], bw[1]);
          mma16816(lg[2 * dp + 1], ea, bw[2], bw[3]);
        }
      }
    }

    // softmax over D (rows gr and gr + 8 across the quad), then
    // dot = sum_d pn g c
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * t);
      lg[j][0] += bb.x;
      lg[j][1] += bb.y;
      lg[j][2] += bb.x;
      lg[j][3] += bb.y;
      mx0 = fmaxf(mx0, fmaxf(lg[j][0], lg[j][1]));
      mx1 = fmaxf(mx1, fmaxf(lg[j][2], lg[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float den0 = 0.f, den1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      lg[j][0] = __expf(lg[j][0] - mx0);
      lg[j][1] = __expf(lg[j][1] - mx0);
      lg[j][2] = __expf(lg[j][2] - mx1);
      lg[j][3] = __expf(lg[j][3] - mx1);
      den0 += lg[j][0] + lg[j][1];
      den1 += lg[j][2] + lg[j][3];
    }
    const float r0 = 1.f / quad_sum(den0), r1 = 1.f / quad_sum(den1);
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      const float2 cc = *reinterpret_cast<const float2*>(cen_s + 8 * j + 2 * t);
      lg[j][0] *= r0;
      lg[j][1] *= r0;
      lg[j][2] *= r1;
      lg[j][3] *= r1;
      dot0 += lg[j][0] * (g0 * cc.x) + lg[j][1] * (g0 * cc.y);
      dot1 += lg[j][2] * (g1 * cc.x) + lg[j][3] * (g1 * cc.y);
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);

    // dl, 8 n-tiles (64 bins) at a time: the lane's two-row sums of dc
    // and db, reduce-scattered over the column's lanes; bf16(dl) staged
    uint32_t dla[KD][4];
#pragma unroll
    for (int part = 0; part < KD / 4; ++part) {
      float v[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * part + jj;
        const float2 cc = *reinterpret_cast<const float2*>(cen_s + 8 * j + 2 * t);
        v[4 * jj + 0] = lg[j][0] * g0 + lg[j][2] * g1;
        v[4 * jj + 2] = lg[j][1] * g0 + lg[j][3] * g1;
        lg[j][0] *= g0 * cc.x - dot0;
        lg[j][1] *= g0 * cc.y - dot0;
        lg[j][2] *= g1 * cc.x - dot1;
        lg[j][3] *= g1 * cc.y - dot1;
        v[4 * jj + 1] = lg[j][0] + lg[j][2];
        v[4 * jj + 3] = lg[j][1] + lg[j][3];
      }
      quad_column_reduce(v, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) dcb[4 * part + i] += v[i];
#pragma unroll
      for (int kd = 4 * part; kd < 4 * part + 4; ++kd) {
        acc_to_a(dla[kd], lg[2 * kd], lg[2 * kd + 1]);
        stsm(dls_a + at(pr, 16 * kd, LDD) + lxd, dla[kd]);
      }
    }

    // de = bf16(dl) . W^T, staged
#pragma unroll
    for (int kq = 0; kq < kMaxQ / 16; ++kq) {
      if (kq < QK) {
        float c0[4] = {}, c1[4] = {};
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t bw[4];
          ldsm(bw, ws_a + at(16 * kq, 16 * kd, LDD) + lyd);
          mma16816(c0, dla[kd], bw[0], bw[1]);
          mma16816(c1, dla[kd], bw[2], bw[3]);
        }
        uint32_t dea[4];
        acc_to_a(dea, c0, c1);
        stsm(des_a + at(pr, 16 * kq, kLdQ) + lxq, dea);
      }
    }
    __syncwarp();

    // dS = bf16(de) . Q from the warp's staged rows, KEC E tiles a pass
#pragma unroll
    for (int e0 = 0; e0 < KE; e0 += KEC) {
      float acc[2 * KEC][4];
#pragma unroll
      for (int i = 0; i < 2 * KEC; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < kMaxQ / 16; ++kq) {
        if (kq < QK) {
          uint32_t a[4];
          ldsm(a, des_a + at(pr, 16 * kq, kLdQ) + lxq);
#pragma unroll
          for (int ep = 0; ep < KEC; ++ep) {
            if (e0 + ep < KE) {
              uint32_t bq[4];
              ldsm_t(bq, qs_a + at(16 * kq, 16 * (e0 + ep), LD) + lx);
              mma16816(acc[2 * ep], a, bq[0], bq[1]);
              mma16816(acc[2 * ep + 1], a, bq[2], bq[3]);
            }
          }
        }
      }
#pragma unroll
      for (int ne = 0; ne < 2 * KEC; ++ne) {
        const int col = 16 * e0 + 8 * ne + 2 * t;
        if (col < E) {
          __nv_bfloat16* out = ds + ((size_t)b * N + px) * E + col;
          if (px < N)
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc[ne][0], acc[ne][1]);
          if (px + 8 < N)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * E) =
                __floats2bfloat162_rn(acc[ne][2], acc[ne][3]);
        }
      }
    }
    __syncthreads();  // the step's e, dl and de tiles are complete

    // phase 2
    if (pr < QP) {
#pragma unroll
      for (int kp = 0; kp < kStep / 16; ++kp) {
        uint32_t a[4];
        ldsm_t(a, es_a + at(16 * kp, pr, kLdQ) + lyq);
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t bl[4];
          ldsm_t(bl, dls_a + at(16 * kp, 16 * dp, LDD) + lxd);
          mma16816(dw[2 * dp], a, bl[0], bl[1]);
          mma16816(dw[2 * dp + 1], a, bl[2], bl[3]);
        }
        ldsm_t(a, des_a + at(16 * kp, pr, kLdQ) + lyq);
#pragma unroll
        for (int ep = 0; ep < KE; ++ep) {
          uint32_t bs[4];
          ldsm_t(bs, st_a + at(16 * kp, 16 * ep, LD) + lx);
          mma16816(dq[2 * ep], a, bs[0], bs[1]);
          mma16816(dq[2 * ep + 1], a, bs[2], bs[3]);
        }
      }
    }
    if constexpr (NS == 2) {
      buf ^= 1;
    } else if (t0 + kStep < n1) {
      __syncthreads();  // every warp is done with the tile before it is refilled
      load_step<KE>(ss_a, LD, sb, t0 + kStep, N, E, tid);
      cp_async_commit();
    }
  }

  // the warps' dc and db sums, [kBwdWarps][2][DP] over the energy tile
  __syncthreads();
  float* red = reinterpret_cast<float*>(es);
#pragma unroll
  for (int i = 0; i < KD; ++i) {
    // entry i of part i / 4: n-tile 8 (i / 4) + gr, parity (i / 2) % 2, dc or db
    const int d = 8 * (8 * (i >> 2) + gr) + 2 * t + ((i >> 1) & 1);
    red[(warp * 2 + (i & 1)) * DP + d] = dcb[i];
  }
  const size_t blk = (size_t)b * n_chunks + c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = pr + gr + 8 * h;
    if (row >= Q) continue;
    float* ow = part_dw + (blk * Q + row) * D;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D) ow[col] = dw[j][2 * h];
      if (col + 1 < D) ow[col + 1] = dw[j][2 * h + 1];
    }
    float* oq = part_dq + (blk * Q + row) * E;
#pragma unroll
    for (int j = 0; j < 2 * KE; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < E) *reinterpret_cast<float2*>(oq + col) = make_float2(dq[j][2 * h], dq[j][2 * h + 1]);
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kBwdThreads) {
    float sc = 0.f, sbias = 0.f;
    for (int wi = 0; wi < kBwdWarps; ++wi) {
      sc += red[(wi * 2) * DP + d];
      sbias += red[(wi * 2 + 1) * DP + d];
    }
    part_dc[blk * D + d] = sc;
    part_db[blk * D + d] = sbias;
  }
}

template <int KE>
cudaError_t launch_summary_bwd(dim3 grid, cudaStream_t st, const __nv_bfloat16* s,
                               const __nv_bfloat16* q, const float* g, const float* m,
                               const float* z, const float* delta, __nv_bfloat16* ds,
                               float* part_dq, int N, int Q, int E, int chunk) {
  constexpr size_t smem = summary_bwd_smem(KE);
  static_assert(smem <= kMaxSmem, "summary backward: shared memory");
  cudaError_t err = cudaFuncSetAttribute(sql_summary_bwd_partial<KE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_summary_bwd_partial<KE><<<grid, kBwdThreads, smem, st>>>(s, q, g, m, z, delta, ds,
                                                               part_dq, N, Q, E, chunk);
  return cudaGetLastError();
}

template <int KE, int KD>
cudaError_t launch_depth_bwd(dim3 grid, cudaStream_t st, const __nv_bfloat16* s,
                             const __nv_bfloat16* q, const __nv_bfloat16* w, const float* bias,
                             const float* centers, const float* g, __nv_bfloat16* ds,
                             float* part_dq, float* part_dw, float* part_db, float* part_dc,
                             int N, int Q, int E, int D, int chunk) {
  constexpr size_t smem = depth_bwd_smem(KE, KD, depth_bwd_stages(KE, KD));
  static_assert(smem <= kMaxSmem, "depth backward: shared memory");
  cudaError_t err = cudaFuncSetAttribute(sql_depth_bwd_partial<KE, KD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_depth_bwd_partial<KE, KD><<<grid, kBwdThreads, smem, st>>>(
      s, q, w, bias, centers, g, ds, part_dq, part_dw, part_db, part_dc, N, Q, E, D, chunk);
  return cudaGetLastError();
}

// Blocks of a backward kernel that one SM holds at once, as the card
// reports it for the compiled kernel (registers and shared memory).
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int KE>
int summary_bwd_blocks() {
  return resident_blocks(sql_summary_bwd_partial<KE>, kBwdThreads, summary_bwd_smem(KE));
}

template <int KE, int KD>
int depth_bwd_blocks() {
  return resident_blocks(sql_depth_bwd_partial<KE, KD>, kBwdThreads,
                         depth_bwd_smem(KE, KD, depth_bwd_stages(KE, KD)));
}

bool shapes_ok(int B, int N, int Q, int E) {
  return B > 0 && N > 0 && Q > 0 && Q <= kMaxQ && E > 0 && E <= kMaxE && E % 8 == 0;
}

constexpr int kMaxDevices = 16;

// The depth kernel for Q and D padded to QN and DN, on a one-wave grid:
// the blocks one wave of the current card holds (its occupancy for the
// compiled kernel, queried once per card and E) spread over the batch.
template <int QN, int DN>
cudaError_t launch_depth(cudaStream_t st, const __nv_bfloat16* s, const __nv_bfloat16* q,
                         const __nv_bfloat16* w, const float* bias, const float* centers,
                         float* out, int B, int N, int Q, int E, int D) {
  static int wave[kMaxDevices][kMaxE / 16 + 1];  // 0 until queried
  const int EP = round_up(E, 16);
  const size_t smem = depth_smem(QN, DN, EP);
  static_assert(depth_smem(QN, DN, kMaxE) <= kMaxSmem, "depth: shared memory");
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& blocks = wave[dev][EP / 16];
  if (blocks == 0) {
    int sms = 0, per_sm = resident_blocks(sql_depth_kernel<QN, DN>, kDepthThreads, smem);
    if (per_sm <= 0) return per_sm < 0 ? (cudaError_t)-per_sm : cudaErrorInvalidConfiguration;
    // the largest E's shared memory, so that any E launches after this
    err = cudaFuncSetAttribute(sql_depth_kernel<QN, DN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)depth_smem(QN, DN, kMaxE));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    blocks = per_sm * sms;
  }
  const int n_tiles = (N + kDepthPx - 1) / kDepthPx;
  const dim3 grid(max(1, min(n_tiles, (blocks + B - 1) / B)), B);
  sql_depth_kernel<QN, DN><<<grid, kDepthThreads, smem, st>>>(s, q, w, bias, centers, out, N, Q,
                                                              E, D);
  return cudaGetLastError();
}

template <int KE, int NWG>
int summary_blocks() {
  return resident_blocks(sql_summary_partial<KE, NWG>, 128 * NWG, summary_smem(NWG, KE));
}

template <int KE, int NWG>
cudaError_t launch_summary_partial(dim3 grid, cudaStream_t stream, const __nv_bfloat16* s,
                                   const __nv_bfloat16* q, float* part_m, float* part_z,
                                   float* part_acc, int N, int Q, int E, int chunk) {
  constexpr size_t smem = summary_smem(NWG, KE);
  static_assert(smem <= kMaxSmem, "summary: shared memory");
  cudaError_t err = cudaFuncSetAttribute(sql_summary_partial<KE, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sql_summary_partial<KE, NWG><<<grid, 128 * NWG, smem, stream>>>(s, q, part_m, part_z, part_acc,
                                                                  N, Q, E, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// E tiles of 16 the summary forward and the backward kernels are compiled
// for: E padded to 32, 64, 96 or 128.
int bwd_e_tiles(int E) { return 2 * ((E + 31) / 32); }

// Pixels per summary block: the wrapper allocates part_m/part_z [B,C,Q] and
// part_acc [B,C,Q,E] float32 with C = ceil(N / chunk); chunk % 64 == 0.
// out [B,Q,E], m_out and z_out [B,Q] float32.
int sql_summary_fwd(const void* s, const void* q, void* part_m, void* part_z, void* part_acc,
                    void* out, void* m_out, void* z_out, int B, int N, int Q, int E, int chunk,
                    void* stream) {
  if (!shapes_ok(B, N, Q, E) || chunk <= 0 || chunk % kSumPx != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
  const dim3 grid(n_chunks, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* pm = static_cast<float*>(part_m);
  auto* pz = static_cast<float*>(part_z);
  auto* pa = static_cast<float*>(part_acc);
  const bool wide = Q > 64;
  cudaError_t err;
  switch (bwd_e_tiles(E)) {
#define SQL_SUMMARY_CASE(KE)                                                                \
  case KE:                                                                                  \
    err = wide ? launch_summary_partial<KE, 2>(grid, st, sp, qp, pm, pz, pa, N, Q, E, chunk) \
               : launch_summary_partial<KE, 1>(grid, st, sp, qp, pm, pz, pa, N, Q, E, chunk); \
    break;
    SQL_SUMMARY_CASE(2)
    SQL_SUMMARY_CASE(4)
    SQL_SUMMARY_CASE(6)
    SQL_SUMMARY_CASE(8)
#undef SQL_SUMMARY_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  sql_summary_merge<<<B * Q, 32 * kMergeWarps, 0, st>>>(pm, pz, pa, static_cast<float*>(out),
                                                         static_cast<float*>(m_out),
                                                         static_cast<float*>(z_out), n_chunks, Q, E);
  return (int)cudaGetLastError();
}

// Blocks of the summary forward's first pass that one SM of the current
// card holds at once for Q queries and embeddings of E; negative: a CUDA
// error, negated. The wrapper sizes its chunks (one wave) from it.
int sql_summary_blocks_per_sm(int Q, int E) {
  if (E <= 0 || E > kMaxE || E % 8 != 0 || Q <= 0 || Q > kMaxQ) return -(int)cudaErrorInvalidValue;
  const bool wide = Q > 64;
  switch (bwd_e_tiles(E)) {
#define SQL_SUMMARY_BLOCKS_CASE(KE) \
  case KE: return wide ? summary_blocks<KE, 2>() : summary_blocks<KE, 1>();
    SQL_SUMMARY_BLOCKS_CASE(2)
    SQL_SUMMARY_BLOCKS_CASE(4)
    SQL_SUMMARY_BLOCKS_CASE(6)
    SQL_SUMMARY_BLOCKS_CASE(8)
#undef SQL_SUMMARY_BLOCKS_CASE
    default: return -(int)cudaErrorInvalidValue;
  }
}

int sql_depth_fwd(const void* s, const void* q, const void* w, const void* bias,
                  const void* centers, void* out, int B, int N, int Q, int E, int D,
                  void* stream) {
  if (!shapes_ok(B, N, Q, E) || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* cp = static_cast<const float*>(centers);
  auto* op = static_cast<float*>(out);
  const bool wide_q = Q > 64, wide_d = D > 64;
  if (wide_q)
    return (int)(wide_d ? launch_depth<128, 128>(st, sp, qp, wp, bp, cp, op, B, N, Q, E, D)
                        : launch_depth<128, 64>(st, sp, qp, wp, bp, cp, op, B, N, Q, E, D));
  return (int)(wide_d ? launch_depth<64, 128>(st, sp, qp, wp, bp, cp, op, B, N, Q, E, D)
                      : launch_depth<64, 64>(st, sp, qp, wp, bp, cp, op, B, N, Q, E, D));
}

// Blocks of the summary (depth = 0) or bins (depth = 1) backward kernel
// that one SM of the current card holds at once for embeddings of E and D
// bins; negative: a CUDA error, negated. The wrapper sizes its chunks and
// partials from it.
int sql_bwd_blocks_per_sm(int depth, int E, int D) {
  if (E <= 0 || E > kMaxE || E % 8 != 0 || D <= 0 || D > kMaxD)
    return -(int)cudaErrorInvalidValue;
  const bool wide = D > 64;
  switch (bwd_e_tiles(E)) {
#define SQL_BWD_BLOCKS_CASE(KE)                                                    \
  case KE:                                                                         \
    if (!depth) return summary_bwd_blocks<KE>();                                   \
    return wide ? depth_bwd_blocks<KE, 8>() : depth_bwd_blocks<KE, 4>();
    SQL_BWD_BLOCKS_CASE(2)
    SQL_BWD_BLOCKS_CASE(4)
    SQL_BWD_BLOCKS_CASE(6)
    SQL_BWD_BLOCKS_CASE(8)
#undef SQL_BWD_BLOCKS_CASE
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Backward of sql_summary_fwd for the cotangent g [B,Q,E] float32 of its
// output, with the forward's m, z [B,Q] and delta = sum_e g * out [B,Q]:
// ds [B,N,E] bf16 and dq [B,Q,E] float32. part_dq [B,C,Q,E] float32 with
// C = ceil(N / chunk), chunk % 128 == 0.
int sql_summary_bwd(const void* s, const void* q, const void* g, const void* m, const void* z,
                    const void* delta, void* ds, void* part_dq, void* dq, int B, int N, int Q,
                    int E, int chunk, void* stream) {
  if (!shapes_ok(B, N, Q, E) || chunk <= 0 || chunk % kStep != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
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
  switch (bwd_e_tiles(E)) {
#define SQL_SUMMARY_BWD_CASE(KE) \
  case KE: err = launch_summary_bwd<KE>(grid, st, sp, qp, gp, mp, zp, dp, dsp, pq, N, Q, E, chunk); break;
    SQL_SUMMARY_BWD_CASE(2)
    SQL_SUMMARY_BWD_CASE(4)
    SQL_SUMMARY_BWD_CASE(6)
    SQL_SUMMARY_BWD_CASE(8)
#undef SQL_SUMMARY_BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum(pq, static_cast<float*>(dq), B, n_chunks, Q * E, st);
}

// Backward of sql_depth_fwd for the cotangent g [B,N] float32 of its
// output: ds [B,N,E] bf16, dq [B,Q,E], dw [Q,D], db [D] and dc [B,D]
// float32. Partials, with C = ceil(N / chunk) and chunk % 128 == 0:
// part_dq [B,C,Q,E], part_dw [B,C,Q,D], part_db and part_dc [B,C,D].
int sql_depth_bwd(const void* s, const void* q, const void* w, const void* bias,
                  const void* centers, const void* g, void* ds, void* part_dq, void* part_dw,
                  void* part_db, void* part_dc, void* dq, void* dw, void* db, void* dc, int B,
                  int N, int Q, int E, int D, int chunk, void* stream) {
  if (!shapes_ok(B, N, Q, E) || D <= 0 || D > kMaxD || chunk <= 0 || chunk % kStep != 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + chunk - 1) / chunk;
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
  const bool wide = D > 64;
  cudaError_t err;
  switch (bwd_e_tiles(E)) {
#define SQL_DEPTH_BWD_CASE(KE)                                                                   \
  case KE:                                                                                       \
    err = wide ? launch_depth_bwd<KE, 8>(grid, st, sp, qp, wp, bp, cp, gp, dsp, pq, pw, pb, pc,  \
                                         N, Q, E, D, chunk)                                      \
               : launch_depth_bwd<KE, 4>(grid, st, sp, qp, wp, bp, cp, gp, dsp, pq, pw, pb, pc,  \
                                         N, Q, E, D, chunk);                                     \
    break;
    SQL_DEPTH_BWD_CASE(2)
    SQL_DEPTH_BWD_CASE(4)
    SQL_DEPTH_BWD_CASE(6)
    SQL_DEPTH_BWD_CASE(8)
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
