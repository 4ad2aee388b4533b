// Luong global-attention head (paper eq. 1-4) for Hopper, sm_90a.
//
//   scores = (H W_a) S^T, set to -1e30 where src_mask == 0   (eq. 1)
//   alpha  = softmax over M in fp32                           (eq. 2)
//   C      = alpha S                                          (eq. 3)
//   Hc     = tanh(H W_ch + C W_cc)                            (eq. 4)
//
// Replaces repro/kernels/luong_attn/kernel.py::_luong_kernel (the Pallas
// TPU kernel).  H [B,N,h], S [B,M,h], W_a/W_ch/W_cc [h,h] in fp32 or bf16,
// mask [B,M] int32; every sum is fp32; Hc is written in H's dtype.  The
// weights are shared across the batch, so the products that read them run
// over all R = B*N rows at once.  The TPU kernel's grid re-reads all three
// weights for every (batch, n-block) step.
//
// What bounds it on an H100 (bf16, h = 1024), at the two calls of the
// seq2seq main path:
//   * a serving decode tick (R = 4 slots, N = 1, M = 64): the three weights,
//     3 h^2 x 2 B = 6.3 MB, are the whole bound (about 2 us at 3.35 TB/s);
//     the arithmetic is a few tens of MFLOP;
//   * the training step's head (B = 64, N = 32: R = 2048, M = 32): 12.9
//     GFLOP of weight products (13 us at the 989 TFLOP/s bf16 tensor-core
//     peak) against 10 MB moved: bound by operations.
// Three routes, one kernel set each; the wrapper (ops.py) names the route
// and the entry point refuses a route that does not fit:
//   * "decode" (bf16, h a multiple of 64 up to 1024, R <= 32): one
//     cooperative launch (luong_dec_kernel).  Each block owns 8 columns of
//     each weight and, at its start, puts every load of its 48 KB of them in
//     flight (cp.async), W_cc's too, so all the head's bytes stream at once;
//     four phases on fp32 FMA, separated by grid-wide barriers: Q and P
//     columns, the scores, the softmax and C's columns, then C W_cc + P and
//     tanh.  No host read-back and no reset launch (the barrier's count
//     runs on across calls), so the call can be captured in a CUDA graph;
//   * "wgmma" (bf16, h a multiple of 64 up to 2048; many rows): three
//     launches.  (a) Q = H W_a, a persistent TMA-fed wgmma GEMM, fp32 out;
//     (b) per batch element, scores, softmax and C = alpha S on FMA, S
//     streamed in chunks of positions, C written as two bf16 terms C_hi +
//     C_lo; (c) Hc = tanh([H | C_hi | C_lo] [W_ch; W_cc; W_cc]), eq. 4's own
//     W_c [H; C] at depth 3h, the same GEMM with tanh and TMA stores in its
//     epilogue: P = H W_ch never reaches memory.  Q stays fp32 (the softmax
//     would amplify a bf16 Q), and C_hi + C_lo carries C to about 2^-17 of
//     itself, so the only rounding left is the output's;
//   * "fma" (fp32, and bf16 at widths the others do not take): the first
//     kernel, five launches on fp32 FMA with split-K scratch.
// All routes sum in a fixed order, so results do not change between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "hopper.cuh"  // mbarriers, TMA copies and stores, wgmma and its descriptors, the tensor-map encoder

namespace {

// ---------------------------------------------------------------------------
// "fma": fp32 inputs, and bf16 at widths the other routes do not take (the first kernel).
//
// At decode R is a handful of rows, so what mattered was keeping enough
// independent loads in flight: the weight products split the depth h into
// 128-deep chunks (split-K), so a 1024-wide head runs 256 projection blocks
// instead of a few, and every loop over h or M issues unrolled loads whose
// addresses do not depend on the sum.  Partial sums go to fp32 scratch and
// are added in a fixed order.  Five launches on the caller's stream, all
// scratch from the wrapper:
//   (a) splitk_kernel:  partial Q = H W_a and P = H W_ch per depth chunk
//   (b) scores_kernel:  one warp per (row, m): Q . S[b, m], masked
//   (c) context_kernel: per (row, 128 columns): softmax over M, ctx = alpha S
//   (d) splitk_kernel:  partial ctx W_cc per depth chunk
//   (e) output_kernel:  Hc = tanh(sum of the P and ctx W_cc partials), in T
// ---------------------------------------------------------------------------

constexpr float kNegInf = -1e30f;  // not -inf: an all-masked row gives a uniform alpha, no NaN
constexpr int kThreads = 256;
constexpr int kCols = 64;       // split-K GEMM block: 64 columns ...
constexpr int kKChunk = 128;    // ... of one 128-deep chunk of h ...
constexpr int kRows = 8;        // ... for 8 rows
constexpr int kKPhases = kThreads / kCols;  // threads sharing a column, interleaved over k
constexpr int kScoreWarps = kThreads / 32;  // source positions per scores block
constexpr int kCtxCols = 128;   // columns per context block
constexpr int kCtxPhases = kThreads / kCtxCols;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// part[w][ks][r][c] = sum over k in chunk ks of A[r][k] * W_w[k][c], for
// A [R, K] and W_w [K, C] row-major; blockIdx = (column tile, chunk ks,
// row tile * nW + w).
template <typename TA, typename TW>
__global__ void __launch_bounds__(kThreads) splitk_kernel(const TA* __restrict__ A, const TW* __restrict__ W0,
                                                          const TW* __restrict__ W1, float* __restrict__ part, int R,
                                                          int K, int C, int nW) {
  __shared__ float xs[kRows][kKChunk];
  __shared__ float red[kKPhases][kRows][kCols];
  const int w = blockIdx.z % nW, r0 = (blockIdx.z / nW) * kRows;
  const int c0 = blockIdx.x * kCols, ks = blockIdx.y, k0 = ks * kKChunk;
  const int kn = min(kKChunk, K - k0);
  const TW* __restrict__ W = w == 0 ? W0 : W1;
  for (int i = threadIdx.x; i < kRows * kKChunk; i += kThreads) {
    const int r = i / kKChunk, k = i % kKChunk;
    xs[r][k] = (r0 + r < R && k < kn) ? to_f(A[(size_t)(r0 + r) * K + k0 + k]) : 0.f;
  }
  __syncthreads();
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int c = c0 + tx;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int k = ty; k < kn; k += kKPhases) {  // independent loads: the address does not depend on acc
      const float wv = to_f(W[(size_t)(k0 + k) * C + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += xs[r][k] * wv;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[ty][r][tx] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, cc = i % kCols;
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < kKPhases; ++p) sum += red[p][r][cc];
    if (r0 + r < R && c0 + cc < C) part[(((size_t)w * gridDim.y + ks) * R + r0 + r) * C + c0 + cc] = sum;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction through red[32]; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : (kMax ? -INFINITY : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// (b) sc[r][m] = Q[r] . S[b, m], or -1e30 where mask[b, m] == 0; Q[r] is the
// sum of its KS partials.  blockIdx = (group of kScoreWarps positions, row r);
// dynamic shared memory holds Q[r] [h].
template <typename T>
__global__ void __launch_bounds__(kThreads) scores_kernel(const float* __restrict__ partQ, int KS,
                                                          const T* __restrict__ S, const int* __restrict__ mask,
                                                          float* __restrict__ sc, int R, int N, int M, int h) {
  extern __shared__ float q[];
  const int r = blockIdx.y, b = r / N;
  for (int j = threadIdx.x; j < h; j += kThreads) {
    float v = 0.f;
    for (int ks = 0; ks < KS; ++ks) v += partQ[((size_t)ks * R + r) * h + j];
    q[j] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, m = blockIdx.x * kScoreWarps + threadIdx.x / 32;
  if (m >= M) return;  // no barrier follows
  const T* __restrict__ Sm = S + ((size_t)b * M + m) * h;
  float s = 0.f;
#pragma unroll 8
  for (int j = lane; j < h; j += 32) s += q[j] * to_f(Sm[j]);
  s = warp_sum(s);
  if (lane == 0) sc[(size_t)r * M + m] = mask[(size_t)b * M + m] != 0 ? s : kNegInf;
}

// (c) Max-subtracted softmax of sc[r] over M, then ctx[r][c] = sum_m alpha_m
// S[b, m, c] for kCtxCols columns.  blockIdx = (column tile, row r); dynamic
// shared memory holds the scores, then the exponentials [M].
template <typename T>
__global__ void __launch_bounds__(kThreads) context_kernel(const float* __restrict__ sc, const T* __restrict__ S,
                                                           float* __restrict__ ctx, int N, int M, int h) {
  extern __shared__ float p[];
  __shared__ float red[32];
  __shared__ float halves[kCtxPhases][kCtxCols];
  const int r = blockIdx.y, b = r / N;
  float mx = -INFINITY;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    p[m] = sc[(size_t)r * M + m];
    mx = fmaxf(mx, p[m]);
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const float e = expf(p[m] - mx);
    p[m] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);  // its barriers also publish p[]
  const int tx = threadIdx.x % kCtxCols, ty = threadIdx.x / kCtxCols;
  const int c = blockIdx.x * kCtxCols + tx;
  float acc = 0.f;
  if (c < h) {
    const T* __restrict__ Sb = S + (size_t)b * M * h + c;
#pragma unroll 8
    for (int m = ty; m < M; m += kCtxPhases) acc += p[m] * to_f(Sb[(size_t)m * h]);
  }
  halves[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < h) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kCtxPhases; ++i) v += halves[i][tx];
    ctx[(size_t)r * h + c] = v / sum;
  }
}

// (e) out = tanh(sum over ks of partP[ks] + partO[ks]), elementwise over [R, h].
template <typename T>
__global__ void __launch_bounds__(kThreads) output_kernel(const float* __restrict__ partP,
                                                          const float* __restrict__ partO, int KS,
                                                          T* __restrict__ out, int R, int h) {
  const size_t n = (size_t)R * h, i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int ks = 0; ks < KS; ++ks) v += partP[ks * n + i] + partO[ks * n + i];
  out[i] = from_f<T>(tanhf(v));
}

struct Scratch {  // fp32 offsets into the wrapper's scratch buffer
  size_t partQP, partO, sc, ctx, total;
};

__host__ __device__ Scratch scratch_layout(int B, int N, int M, int h) {
  const size_t R = (size_t)B * N, KS = ceil_div(h, kKChunk);
  Scratch s;
  s.partQP = 0;                      // [2][KS][R][h]: Q partials, then P partials
  s.partO = s.partQP + 2 * KS * R * h;  // [KS][R][h]
  s.sc = s.partO + KS * R * h;          // [R][M]
  s.ctx = s.sc + R * M;                 // [R][h]
  s.total = s.ctx + R * h;
  return s;
}

template <typename T>
int launch_fma(const void* H_, const void* S_, const int* mask, const void* wa_, const void* wch_, const void* wcc_,
           void* out_, float* scratch, int B, int N, int M, int h, cudaStream_t stream) {
  const T* H = static_cast<const T*>(H_);
  const T* S = static_cast<const T*>(S_);
  const T* wcc = static_cast<const T*>(wcc_);
  const int R = B * N, KS = ceil_div(h, kKChunk), row_tiles = ceil_div(R, kRows);
  const Scratch off = scratch_layout(B, N, M, h);
  float* partQ = scratch + off.partQP;
  float* partP = partQ + (size_t)KS * R * h;
  float* partO = scratch + off.partO;
  float* sc = scratch + off.sc;
  float* ctx = scratch + off.ctx;

  splitk_kernel<T, T><<<dim3(ceil_div(h, kCols), KS, row_tiles * 2), kThreads, 0, stream>>>(
      H, static_cast<const T*>(wa_), static_cast<const T*>(wch_), partQ, R, h, h, 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scores_kernel<T><<<dim3(ceil_div(M, kScoreWarps), R), kThreads, (size_t)h * sizeof(float), stream>>>(
      partQ, KS, S, mask, sc, R, N, M, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  context_kernel<T><<<dim3(ceil_div(h, kCtxCols), R), kThreads, (size_t)M * sizeof(float), stream>>>(sc, S, ctx, N,
                                                                                                       M, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  splitk_kernel<float, T><<<dim3(ceil_div(h, kCols), KS, row_tiles), kThreads, 0, stream>>>(ctx, wcc, wcc, partO,
                                                                                            R, h, h, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  output_kernel<T><<<ceil_div(R * h, kThreads), kThreads, 0, stream>>>(partP, partO, KS, static_cast<T*>(out_), R,
                                                                      h);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Shared by the "wgmma" and "decode" routes.
// ---------------------------------------------------------------------------

#ifndef LUONG_DIAG
#define LUONG_DIAG 0  // design work only (tools/luong_attn_variants.py): bits that take work out, see kDiag
#endif
// 1 no wgmma products, 2 no epilogue stores (a, c), 4 no (b), 8 no TMA copies (a, c),
// 16 no grid barriers (decode), 32 no weight loads (decode), 64 the decode kernel returns at once,
// 128 no scores products (b), 256 no context products (b), 512 no copies of S (b), 1024 no phase 2,
// 2048 no phase 3, 4096 no phase-4 product (decode); results are then wrong
constexpr int kDiag = LUONG_DIAG;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half), .y = hi
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ float2 unpack_bf16(unsigned v) {  // (low half, high half)
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
// tanh from ex2.approx and rcp.approx: within 1e-6 (absolute) of tanhf, inside the output's bf16 rounding
__device__ __forceinline__ float tanh_fast(float x) {
  const float t = 1.f - __fdividef(2.f, 1.f + __expf(2.f * fabsf(x)));
  return copysignf(t, x);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The SMs of the current device (or a negative cudaError_t), counted once per device.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    sms[dev] = n;
  }
  return sms[dev];
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes`, once per device and kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// "wgmma": many rows (the training step's 2048), bf16, h a multiple of 64.
//
// What the "fma" kernel lacked, and what this route does about it: at 2048
// rows its split-K partials were 210 MB of fp32 scratch written and read
// back, its scores kernel re-summed Q's partials in every block, and 12.9
// GFLOP ran on FMA beside idle tensor cores.  Here:
//   (a) luong_wg_kernel<false>: Q = H W_a, [R, h] x [h, h].  One block per
//       SM walks the 128 x 128 output tiles (16 x 8 = 128 at R = 2048, h =
//       1024: one wave); one producer thread keeps 3-D TMA copies (128B
//       swizzle, 64 x 64 boxes) in flight into a ring of stages of 64 along
//       the depth (full and empty mbarriers); two consumer warpgroups, 64
//       rows each, multiply with wgmma m64n128k16 from shared memory, both
//       reading one B stage (W_a keeps the JAX layout, its N index
//       contiguous: the MN-major B with the transpose flag).  The ring runs
//       on across tiles.  Q leaves in fp32 from registers.
//   (b) luong_ctx_kernel: a block per (batch element, 8 rows): the rows of
//       one batch element share S_b, so N need not divide any tile.  Q's
//       rows sit in shared memory; S_b streams through in chunks of 32
//       positions (cp.async into shared memory, every copy of a chunk in
//       flight at once): the chunk's scores (fp32 FMA, one warp per 4 positions,
//       the 32 sums per lane folded across the warp in 31 shuffles), an
//       online softmax step (running max and sum per row, the context
//       rescaled), then the context, each thread owning 4 columns.  C is
//       written as C_hi = bf16(C) and C_lo = bf16(C - C_hi) into [R, 2h],
//       lstm_cell.cu's split of h (LUONG_C_SPLIT=0 writes C once, [R, h]).
//   (c) luong_wg_kernel<true>: Hc = tanh(A W) with A = [H | C_hi | C_lo]
//       and W = [W_ch; W_cc; W_cc]: the depth's first h comes from H and
//       w_c's rows 0..h-1, the rest from the [R, 2h] buffer and w_c's rows
//       h..2h-1, twice.  tanh in the epilogue; Hc leaves by stmatrix into
//       shared memory and TMA stores, which clip the rows past R.
// (b) and (c) launch as programmatic dependents of the kernel before them
// (griddepcontrol): each one's launch and start-up overlap the last one's
// tail, and it waits for the last one's writes before it reads them.
// Rows past R: TMA zero-fills the loads, a consumer whose 64 rows are all
// past R only keeps in step with the ring, and no store reaches them.
// Scratch: Q [R, h] fp32 and C [R, 2h] bf16, 16.8 MB at R = 2048, h = 1024.
// ---------------------------------------------------------------------------

#ifndef LUONG_WG_STAGES
#define LUONG_WG_STAGES 5
#endif
#ifndef LUONG_C_SPLIT
#define LUONG_C_SPLIT 1
#endif
constexpr int kWgStages = LUONG_WG_STAGES;

// Programmatic dependent launch: the kernel after this one may be scheduled (and run up to its wait)
// once every block of this one has called launch_dependents; wait returns when the kernel before has
// finished and its writes are visible.  Both are no-ops for a kernel launched without the attribute.
__device__ __forceinline__ void pdl_launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
constexpr int kCTerms = LUONG_C_SPLIT ? 2 : 1;  // bf16 terms C is written as
constexpr int kWgThreads = 384;                   // two consumer warpgroups and the producer's
constexpr int kWgBox = 64 * 128;                  // bytes of one 64 x 64 bf16 box (8192)
constexpr int kWgStage = 4 * kWgBox;              // A's two 64-row halves, then B's two 64-column boxes
constexpr int kWgOut = 2 * kWgBox;                // a consumer's 64 x 128 bf16 output tile, as two boxes
constexpr size_t kWgSmem = 1024 + static_cast<size_t>(kWgStages) * kWgStage + 2 * kWgOut + 2 * kWgStages * 8;
static_assert(kWgSmem <= 232448, "the ring fits in a block's shared memory");

struct WgArgs {
  float* q;  // (a): Q [R, h] fp32
  int R, h;
  int kth;   // h / 64: depth steps of one h
  int KT;    // depth steps: h / 64 (a), (1 + kCTerms) h / 64 (c)
  int nt;    // column tiles of 128: h / 128, rounded up
  int work;  // row tiles of 128 x column tiles
};

// (a) Q = H W_a (OUT false) or (c) Hc = tanh([H | C] [W_ch; W_cc; ...]) (OUT true).  Maps: mh H [R, h],
// mc the C buffer [R, kCTerms h] (c only), mw W_a [h, h] or w_c [2h, h], mo Hc [R, h] (c only).
template <bool OUT>
__global__ void __launch_bounds__(kWgThreads, 1)
    luong_wg_kernel(WgArgs a, const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mc,
                    const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap mo) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outs = smem + kWgStages * kWgStage;               // each consumer's output tile
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * kWgOut);  // stage s has landed
  uint64_t* empty = full + kWgStages;                               // stage s may be refilled

  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup once per stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pdl_launch_dependents();
  if (OUT) pdl_wait();  // (c) reads the C buffer that (b) writes
  // a consumer warpgroup's release of ring stage s (its wgmma are done, so one thread speaks for it)
  const auto release = [&](int s) {
    if (tid % 128 == 0) mbar_arrive(&empty[s]);
  };

  const int wg = tid / 128;
  if (wg == 2) {  // the producer warpgroup: one thread issues every copy
    if (tid == 256) {
      int it = 0;
      for (int w = blockIdx.x; w < a.work; w += gridDim.x) {
        const int row = (w / a.nt) * 128, col = (w % a.nt) * 128;
        const bool live1 = row + 64 < a.R;
        const bool box1 = col + 64 < a.h;  // h % 64 == 0: a box is wholly in or out
        for (int kt = 0; kt < a.KT; ++kt, ++it) {
          const int s = it % kWgStages;
          if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
          unsigned char* st = smem + s * kWgStage;
          if (kDiag & 8) {
            mbar_arrive(&full[s]);
            continue;
          }
          // A: H over the first h of the depth, then the C buffer; B: W_a, or w_c's rows k for k < 2h
          // and k - h past them (W_cc once more, for C_lo)
          const CUtensorMap* ma = kt < a.kth ? &mh : &mc;
          const int ka = (kt < a.kth ? kt : kt - a.kth) * 64;
          const int kb = (OUT && kt >= 2 * a.kth ? kt - a.kth : kt) * 64;
          mbar_expect_bytes(&full[s], (2 + live1 + box1) * kWgBox);
          tensor_copy_3d(st, ma, ka, row, 0, &full[s]);
          if (live1) tensor_copy_3d(st + kWgBox, ma, ka, row + 64, 0, &full[s]);
          tensor_copy_3d(st + 2 * kWgBox, &mw, col, kb, 0, &full[s]);
          if (box1) tensor_copy_3d(st + 3 * kWgBox, &mw, col + 64, kb, 0, &full[s]);
        }
      }
    }
    __syncwarp();
  } else {  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each of this block's tiles
    const int warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
    // acc[4 j + q]: row 16 warp + g (q < 2) or + 8 (q >= 2), column 8 j + 2 t + (q & 1) of the tile
    float acc[64];
    int it = 0;
    for (int w = blockIdx.x; w < a.work; w += gridDim.x) {
      const int row0 = (w / a.nt) * 128 + wg * 64, col0 = (w % a.nt) * 128;
      if (row0 >= a.R) {  // no row of this warpgroup's 64: keep in step with the ring
        for (int kt = 0; kt < a.KT; ++kt, ++it) {
          mbar_wait(&full[it % kWgStages], (it / kWgStages) & 1);
          release(it % kWgStages);
        }
        continue;
      }
      for (int kt = 0; kt < a.KT; ++kt, ++it) {
        const int s = it % kWgStages;
        mbar_wait(&full[s], (it / kWgStages) & 1);
        const unsigned st = smem_u32(smem + s * kWgStage);
        const unsigned a_addr = st + wg * kWgBox, b_addr = st + 2 * kWgBox;
        if (!(kDiag & 1)) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // 16 columns of the A box; 16 rows of the B boxes (2048 bytes)
            wgmma_ss_n128_tb(acc, sw128_desc(a_addr + 32 * kk, 16), sw128_desc(b_addr + 2048 * kk, kWgBox),
                             kt > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: its slot is free
        }
        if (kt > 0) release((it - 1) % kWgStages);
      }
      wgmma_wait<0>();
      pin_all(acc);
      release((it - 1) % kWgStages);
      if (kDiag & 2) continue;

      if constexpr (!OUT) {  // Q in fp32, 8-byte stores of column pairs
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = col0 + 8 * j + 2 * t, r0 = row0 + 16 * warp + g;
          if (col >= a.h) continue;
          if (r0 < a.R) *reinterpret_cast<float2*>(a.q + static_cast<size_t>(r0) * a.h + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
          if (r0 + 8 < a.R)
            *reinterpret_cast<float2*>(a.q + static_cast<size_t>(r0 + 8) * a.h + col) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
        // Hc = tanh(acc) leaves through shared memory: this warpgroup's 64 rows x 128 columns as two
        // 64 x 64 boxes, 128B-swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)), written with
        // stmatrix, then stored by TMA (rows past R and columns past h are clipped) while the
        // warpgroup goes on to its next tile
        unsigned char* buf = outs + wg * kWgOut;
        if (tid % 128 == 0) bulk_wait_read<0>();  // the last tile's stores have read the buffer
        named_sync(1 + wg, 128);
        const int mi = lane / 8, rr = 16 * warp + lane % 8 + 8 * (mi & 1);  // this lane's stmatrix row address
#pragma unroll
        for (int j = 0; j < 16; j += 2) {  // n8 blocks j and j + 1: four 8 x 8 matrices
          unsigned r[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * (j + q / 2) + 2 * (q % 2);  // rows g (q even) or g + 8 (q odd) of block j + q / 2
            r[q] = pack_bf16(tanh_fast(acc[i]), tanh_fast(acc[i + 1]));
          }
          const int jj = j + mi / 2;  // the n8 block of this lane's matrix
          stmatrix_x4(smem_u32(buf) + (jj / 8) * kWgBox + rr * 128 + (((jj % 8) ^ (rr % 8)) << 4), r[0], r[1], r[2],
                      r[3]);
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (tid % 128 == 0) {
          tensor_store_3d(&mo, buf, col0, row0, 0);
          if (col0 + 64 < a.h) tensor_store_3d(&mo, buf + kWgBox, col0 + 64, row0, 0);
          bulk_commit();
        }
      }
    }
    if (OUT && tid % 128 == 0) bulk_wait<0>();  // every store has landed before the block leaves
  }
}

constexpr int kCtxRows = 8;     // rows of one batch element a block
constexpr int kCtxPos = 32;     // source positions a chunk: 4 a warp
constexpr int kCtxThreads = 256;

// Sums v[i] over the warp's 32 lanes for every i < K at once (K a power of two up to 32) in K - 1 +
// 5 - log2 K shuffles: each of the first log2 K steps keeps half of the values and adds the partner
// lane's copy of them, the rest add whole.  Lane l ends with the sum of v[l >> (5 - log2 K)].
template <int K>
__device__ __forceinline__ float fold(float (&v)[K], int lane) {
#pragma unroll
  for (int o = 16, n = K / 2; o >= 1; o /= 2, n /= 2) {
    if (n >= 1) {
      const bool upper = lane & o;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float send = upper ? v[i] : v[i + n];
        const float keep = upper ? v[i + n] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

// (b) For rows n0 .. n0 + 7 of batch element b = blockIdx.y (n0 = 8 blockIdx.x): the masked scores
// Q S_b^T, their softmax over M and C = alpha S_b, in fp32; C leaves as bf16 C_hi (columns 0..h-1 of
// cc's row) and C_lo (columns h..2h-1).  Each thread owns the columns 4 (tid + 256 i), i < GI.
// Dynamic shared memory holds Q's 8 rows [8][h] fp32, then a chunk of S_b [32][h] bf16.
template <int GI>
__global__ void __launch_bounds__(kCtxThreads) luong_ctx_kernel(const float* __restrict__ Q, const bf16* __restrict__ S,
                                                                const int* __restrict__ mask, bf16* __restrict__ cc,
                                                                int N, int M, int h) {
  extern __shared__ __align__(16) float qs[];
  bf16* ss = reinterpret_cast<bf16*>(qs + kCtxRows * h);  // rows m0 .. m0 + 31 of S_b
  __shared__ float pe[kCtxRows][kCtxPos];  // a chunk's scores, then their exponentials
  __shared__ float fac[kCtxRows], run_max[kCtxRows], run_sum[kCtxRows];
  pdl_launch_dependents();
  pdl_wait();  // Q comes from (a)
  if (kDiag & 4) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, n0 = blockIdx.x * kCtxRows, nr = min(kCtxRows, N - n0);
  const size_t row0 = static_cast<size_t>(b) * N + n0;
  const int h4 = h / 4, h8 = h / 8;
  for (int i = tid; i < kCtxRows * h4; i += kCtxThreads) {
    if (i / h4 < nr) cp_async16(qs + 4 * i, Q + row0 * h + 4 * i);
    else reinterpret_cast<float4*>(qs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < kCtxRows) {
    run_max[tid] = -INFINITY;
    run_sum[tid] = 0.f;
  }
  float acc[kCtxRows][4 * GI];
#pragma unroll
  for (int r = 0; r < kCtxRows; ++r)
#pragma unroll
    for (int c = 0; c < 4 * GI; ++c) acc[r][c] = 0.f;
  __syncthreads();

  const bf16* __restrict__ Sb = S + static_cast<size_t>(b) * M * h;
  const int* __restrict__ mb = mask + static_cast<size_t>(b) * M;
  for (int m0 = 0; m0 < M; m0 += kCtxPos) {
    const int mn = min(kCtxPos, M - m0);
    if (!(kDiag & 512))
      for (int i = tid; i < mn * h8; i += kCtxThreads) cp_async16(ss + 8 * i, Sb + static_cast<size_t>(m0) * h + 8 * i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    {  // the chunk's scores: warp w takes positions m0 + 4 w .. m0 + 4 w + 3 for every row
      float v[32];  // v[4 r + p]
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.f;
      for (int j = lane * 8; j < h && !(kDiag & 128); j += 256) {
        float s[4][8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int mm = 4 * warp + p;  // rows past the chunk's mn hold stale values; their scores are dropped
          const uint4 raw = *reinterpret_cast<const uint4*>(ss + mm * h + j);
          const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(u[e]);
            s[p][2 * e] = f.x;
            s[p][2 * e + 1] = f.y;
          }
        }
#pragma unroll
        for (int r = 0; r < kCtxRows; ++r) {
          const float4 q0 = *reinterpret_cast<const float4*>(qs + r * h + j);
          const float4 q1 = *reinterpret_cast<const float4*>(qs + r * h + j + 4);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            v[4 * r + p] += q0.x * s[p][0] + q0.y * s[p][1] + q0.z * s[p][2] + q0.w * s[p][3] + q1.x * s[p][4] +
                            q1.y * s[p][5] + q1.z * s[p][6] + q1.w * s[p][7];
        }
      }
      const float sum = fold<32>(v, lane);  // the score of row lane / 4, position m0 + 4 warp + lane % 4
      const int m = m0 + 4 * warp + lane % 4;
      pe[lane / 4][4 * warp + lane % 4] = m >= M ? -INFINITY : (mb[m] != 0 ? sum : kNegInf);
    }
    __syncthreads();
    {  // one online-softmax step a row: warp r, a position a lane
      const int r = warp;
      const float s = pe[r][lane];
      const float mold = run_max[r], mnew = fmaxf(mold, warp_max(s));
      const float e = s == -INFINITY ? 0.f : expf(s - mnew);  // past M: nothing; masked: exp(-1e30 - max)
      const float esum = warp_sum(e);
      pe[r][lane] = e;
      if (lane == 0) {
        const float f = mold == -INFINITY ? 0.f : expf(mold - mnew);
        fac[r] = f;
        run_sum[r] = run_sum[r] * f + esum;
        run_max[r] = mnew;
      }
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < GI; ++gi) {  // the context, rescaled to the new running max
      const int c = 4 * (tid + kCtxThreads * gi);
      if (c >= h) break;
#pragma unroll
      for (int r = 0; r < kCtxRows; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][4 * gi + k] *= fac[r];
      for (int mm = 0; mm < mn && !(kDiag & 256); ++mm) {
        const uint2 raw = *reinterpret_cast<const uint2*>(ss + mm * h + c);
        const float2 s01 = unpack_bf16(raw.x), s23 = unpack_bf16(raw.y);
#pragma unroll
        for (int r = 0; r < kCtxRows; ++r) {
          const float e = pe[r][mm];
          acc[r][4 * gi] += e * s01.x;
          acc[r][4 * gi + 1] += e * s01.y;
          acc[r][4 * gi + 2] += e * s23.x;
          acc[r][4 * gi + 3] += e * s23.y;
        }
      }
    }
    __syncthreads();  // pe and ss are rewritten by the next chunk
  }
  const int ldc = kCTerms * h;
#pragma unroll
  for (int gi = 0; gi < GI; ++gi) {
    const int c = 4 * (tid + kCtxThreads * gi);
    if (c >= h) break;
#pragma unroll
    for (int r = 0; r < kCtxRows; ++r) {
      if (r >= nr) break;
      const float inv = 1.f / run_sum[r];
      float v[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = acc[r][4 * gi + k] * inv;
        lo[k] = v[k] - __bfloat162float(__float2bfloat16(v[k]));
      }
      bf16* dst = cc + (row0 + r) * ldc + c;
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      if (kCTerms == 2) *reinterpret_cast<uint2*>(dst + h) = make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
    }
  }
}

// Launches `kernel` on `stream`, as a programmatic dependent of the kernel before it when `pdl`.
template <typename... P, typename... A>
cudaError_t launch_on(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream, bool pdl,
                      A&&... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, std::forward<A>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The three launches of the "wgmma" route; scratch holds Q [R, h] fp32, then C [R, kCTerms h] bf16.
cudaError_t launch_wg(const void* H, const void* S, const int* mask, const void* wa, const void* wc, void* out,
                      float* scratch, int B, int N, int M, int h, cudaStream_t stream) {
  using namespace hopper;
  static bool smem_a[64], smem_c[64], smem_ctx1[64], smem_ctx2[64];
  const int R = B * N;
  float* q = scratch;
  bf16* cbuf = reinterpret_cast<bf16*>(scratch + static_cast<size_t>(R) * h);
  CUtensorMap mh, mc, mwa, mwc, mo;
  cudaError_t err = encode_bf16_3d(&mh, H, 1, R, h, 64);
  if (err == cudaSuccess) err = encode_bf16_3d(&mc, cbuf, 1, R, kCTerms * h, 64);
  if (err == cudaSuccess) err = encode_bf16_3d(&mwa, wa, 1, h, h, 64);
  if (err == cudaSuccess) err = encode_bf16_3d(&mwc, wc, 1, 2 * h, h, 64);
  if (err == cudaSuccess) err = encode_bf16_3d(&mo, out, 1, R, h, 64);
  constexpr size_t kCtxMaxSmem = static_cast<size_t>(kCtxRows) * 2048 * 4 + kCtxPos * 2048 * 2;  // at h = 2048
  if (err == cudaSuccess) err = allow_smem(luong_wg_kernel<false>, kWgSmem, smem_a);
  if (err == cudaSuccess) err = allow_smem(luong_wg_kernel<true>, kWgSmem, smem_c);
  if (err == cudaSuccess) err = allow_smem(luong_ctx_kernel<1>, kCtxMaxSmem, smem_ctx1);
  if (err == cudaSuccess) err = allow_smem(luong_ctx_kernel<2>, kCtxMaxSmem, smem_ctx2);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 0) return static_cast<cudaError_t>(-sms);
  const int nt = (h + 127) / 128, mt = (R + 127) / 128;
  const unsigned tiles = static_cast<unsigned>(std::min(mt * nt, sms));
  WgArgs args{q, R, h, h / 64, h / 64, nt, mt * nt};
  err = launch_on(luong_wg_kernel<false>, tiles, kWgThreads, kWgSmem, stream, false, args, mh, mh, mwa, mo);  // (a)
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kCtxRows - 1) / kCtxRows, B);  // (b)
  const size_t qbytes = static_cast<size_t>(kCtxRows) * h * 4 + static_cast<size_t>(kCtxPos) * h * 2;
  const float* qc = q;
  const bf16* Sb = static_cast<const bf16*>(S);
  err = h <= 1024 ? launch_on(luong_ctx_kernel<1>, grid, kCtxThreads, qbytes, stream, true, qc, Sb, mask, cbuf, N, M, h)
                  : launch_on(luong_ctx_kernel<2>, grid, kCtxThreads, qbytes, stream, true, qc, Sb, mask, cbuf, N, M, h);
  if (err != cudaSuccess) return err;
  args.KT = (1 + kCTerms) * (h / 64);
  return launch_on(luong_wg_kernel<true>, tiles, kWgThreads, kWgSmem, stream, true, args, mh, mc, mwc, mo);  // (c)
}

// ---------------------------------------------------------------------------
// "decode": few rows (a decode tick's slots), bf16, h a multiple of 64.
//
// Bound by bytes: the 6.3 MB of weights at h = 1024.  The "fma" kernel took
// five launches on one stream, each waiting for the last to drain, and did
// not ask for W_cc's 2 MB until the first three had finished.  Here one
// cooperative launch of h / 8 blocks (128 at h = 1024, one per SM, checked
// against the occupancy times the SMs so that an over-large grid is refused
// instead of deadlocking): block i owns columns 8 i .. 8 i + 7 of W_a, W_ch
// and W_cc and, before anything else, puts the 16-byte cp.async copies of
// all three slices in flight (48 KB at h = 1024; W_a and W_ch in one commit
// group, W_cc in the next; TMA boxes of 256 rows x 16 bytes measured the
// same) and an L2 prefetch of its share of S.  Four phases on fp32 FMA,
// separated by grid-wide barriers:
//   1. its columns of Q = H W_a (to scratch) and of P = H W_ch (kept in
//      shared memory), each thread a column pair and a strided set of depth
//      pairs, summed over the block in a fixed order;
//   2. the masked scores, one warp per (row, position), spread over every
//      block;
//   3. every block recomputes each row's softmax from the R x M scores and
//      forms its own 8 columns of C = alpha S;
//   4. C (all h columns, from scratch) times its W_cc columns, + P, tanh.
// The barrier counts arrivals in a device word that the wrapper keeps per
// device and never resets; a second word holds the count at which the
// current call began, and the last block to reach the call's last barrier
// advances it.  So no reset launch is needed, no value comes back to the
// host, and the call can be captured in a CUDA graph.  A block that waits
// longer than two seconds traps (a fault, not a hang).
// ---------------------------------------------------------------------------

#ifndef LUONG_DEC_COLS
#define LUONG_DEC_COLS 8
#endif
constexpr int kDecCols = LUONG_DEC_COLS;  // columns of each weight a block owns
static_assert(kDecCols == 8 || kDecCols == 16, "a block owns one or two 16-byte pieces of each weight row");
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxRows = 32;  // C [rows][h] fp32 fits beside the weight slices
constexpr int kDecMaxH = 1024;
constexpr int kDecBarriers = 3;

struct DecArgs {
  const bf16 *H, *S, *wa, *wch, *wcc;
  const int* mask;
  bf16* out;
  float *q, *c, *sc;  // scratch: Q [R, h], C [R, h], scores [R, M]
  unsigned* bar;      // [2]: arrivals (counted on across calls), the count at which this call began
  int R, N, M, h;
};

// Shared memory of one block: its W_a, W_ch and W_cc columns [h][kDecCols] each (bf16), the rows' H
// (bf16) and later C (fp32) [RT][h], the per-warp sums and their total [9][RT][kDecCols] and P's
// columns [RT][kDecCols] (fp32).
__host__ __device__ constexpr size_t dec_smem(int RT, int h) {
  return static_cast<size_t>(h) * 3 * kDecCols * 2 + static_cast<size_t>(RT) * h * 4 +
         static_cast<size_t>(kDecWarps + 1) * RT * kDecCols * 4 + static_cast<size_t>(RT) * kDecCols * 4;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned atom_add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Barrier k of the call that began at arrival count `base` (thread 0's copy): every block of the grid
// reaches it before any leaves it, and the writes before it are seen after it (reads of them go
// through L2: __ldcg).  The block barrier orders the block's writes before thread 0's release; the
// next one orders the others' reads after its acquire.
__device__ void grid_barrier(unsigned* bar, unsigned base, int k) {
  __syncthreads();
  if (kDiag & 16) return;
  if (threadIdx.x == 0) {
    const unsigned target = base + (k + 1) * gridDim.x;
    if (k == kDecBarriers - 1) {
      if (atom_add_release(bar, 1u) == target - 1) bar[1] = target;  // where the next call begins
    } else {
      red_add_release(bar, 1u);
    }
    const unsigned long long t0 = global_ns();
    while (static_cast<int>(ld_acquire(bar) - target) < 0)  // wrap-safe: the count runs on across calls
      if (global_ns() - t0 > 2000000000ull) __trap();
  }
  __syncthreads();
}

// Adds acc over the lanes of a warp that share a column pair (lane % PAIRS) and writes the warp's sums
// to red[warp][r][2 pair + j].
template <int RT, int PAIRS>
__device__ __forceinline__ void warp_fold_cols(float (&acc)[RT][2], float* red, int warp, int lane) {
#pragma unroll
  for (int o = PAIRS; o < 32; o *= 2)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  if (lane < PAIRS)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) red[(warp * RT + r) * 2 * PAIRS + 2 * lane + j] = acc[r][j];
}

// The block's product of the rows x (X(r, p) gives x[r][2p], x[r][2p + 1] as a float2) with one weight
// slice w [h][kDecCols] (bf16), summed over the block in a fixed order: red[r][c] for r < RT, c <
// kDecCols after the call.  Each thread takes a column pair and the depth pairs p = g, g + 64, ...
template <int RT, typename X>
__device__ __forceinline__ void dec_product(const bf16* w, X x, float* red, int h) {
  constexpr int kPairs = kDecCols / 2, kGroups = kDecThreads / kPairs;
  const int tid = threadIdx.x, cp = tid % kPairs, warp = tid / 32, lane = tid % 32;
  const unsigned* w32 = reinterpret_cast<const unsigned*>(w);
  float acc[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
  for (int p = tid / kPairs; p < h / 2; p += kGroups) {
    const float2 w0 = unpack_bf16(w32[(2 * p) * kPairs + cp]), w1 = unpack_bf16(w32[(2 * p + 1) * kPairs + cp]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float2 v = x(r, p);
      acc[r][0] += v.x * w0.x + v.y * w1.x;
      acc[r][1] += v.x * w0.y + v.y * w1.y;
    }
  }
  warp_fold_cols<RT, kPairs>(acc, red, warp, lane);
  __syncthreads();
  for (int i = tid; i < RT * kDecCols; i += kDecThreads) {  // the warps' sums, in warp order, into red[0]
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kDecWarps; ++wp) v += red[wp * RT * kDecCols + i];
    red[i + kDecWarps * RT * kDecCols] = v;
  }
  __syncthreads();
}

template <int RT>
__global__ void __launch_bounds__(kDecThreads) luong_dec_kernel(DecArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (kDiag & 64) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, h = a.h, R = a.R;
  const size_t slice = static_cast<size_t>(h) * kDecCols;  // bf16 of one weight slice
  bf16* wa_s = reinterpret_cast<bf16*>(smem);                 // [h][kDecCols] each
  bf16* wch_s = wa_s + slice;
  bf16* wcc_s = wch_s + slice;
  float* xs = reinterpret_cast<float*>(wcc_s + slice);  // the rows' H (bf16), later C (fp32): [RT][h]
  float* red = xs + RT * h;                             // [warps + 1][RT][kDecCols]
  float* ps = red + (kDecWarps + 1) * RT * kDecCols;    // [RT][kDecCols]: P's columns
  const int c0 = blockIdx.x * kDecCols;
  unsigned base = 0;

  if (tid == 0) base = *reinterpret_cast<volatile unsigned*>(a.bar + 1);  // set by the last call
  // every weight byte of this block in flight at once: W_a and W_ch, then W_cc (a later commit group)
  constexpr int kPieces = kDecCols / 8;  // 16-byte pieces of a weight row's slice
  if (!(kDiag & 32))
    for (int i = tid; i < h * kPieces; i += kDecThreads) {
      const int k = i / kPieces, j = i % kPieces;
      cp_async16(wa_s + k * kDecCols + 8 * j, a.wa + static_cast<size_t>(k) * h + c0 + 8 * j);
      cp_async16(wch_s + k * kDecCols + 8 * j, a.wch + static_cast<size_t>(k) * h + c0 + 8 * j);
    }
  bf16* hs = reinterpret_cast<bf16*>(xs);
  for (int i = tid; i < RT * h / 8; i += kDecThreads) {
    if (i < R * h / 8) cp_async16(hs + 8 * i, a.H + 8 * i);
    else *reinterpret_cast<uint4*>(hs + 8 * i) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  if (!(kDiag & 32))
    for (int i = tid; i < h * kPieces; i += kDecThreads) {
      const int k = i / kPieces, j = i % kPieces;
      cp_async16(wcc_s + k * kDecCols + 8 * j, a.wcc + static_cast<size_t>(k) * h + c0 + 8 * j);
    }
  cp_async_commit();
  {  // S into L2 for phase 2: 128-byte lines spread over the grid
    const size_t lines = (static_cast<size_t>(a.R / a.N) * a.M * h * 2 + 127) / 128;
    for (size_t l = static_cast<size_t>(blockIdx.x) * kDecThreads + tid; l < lines;
         l += static_cast<size_t>(gridDim.x) * kDecThreads)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(reinterpret_cast<const char*>(a.S) + 128 * l));
  }
  cp_async_wait<1>();
  __syncthreads();

  // 1. this block's columns of Q and P
  {
    const unsigned* h32 = reinterpret_cast<const unsigned*>(hs);
    const auto hx = [&](int r, int p) { return unpack_bf16(h32[r * (h / 2) + p]); };
    float* sums = red + kDecWarps * RT * kDecCols;
    dec_product<RT>(wa_s, hx, red, h);
    for (int i = tid; i < R * kDecCols; i += kDecThreads)
      a.q[static_cast<size_t>(i / kDecCols) * h + c0 + i % kDecCols] = sums[i];
    dec_product<RT>(wch_s, hx, red, h);
    for (int i = tid; i < RT * kDecCols; i += kDecThreads) ps[i] = sums[i];
  }
  grid_barrier(a.bar, base, 0);

  // 2. the masked scores, one warp per (row, position), warp 0 of every block first
  for (int item = warp * gridDim.x + blockIdx.x; item < R * a.M && !(kDiag & 1024); item += kDecWarps * gridDim.x) {
    const int r = item / a.M, m = item % a.M, b = r / a.N;
    const float* qr = a.q + static_cast<size_t>(r) * h;
    const bf16* sm = a.S + (static_cast<size_t>(b) * a.M + m) * h;
    const bool keep = a.mask[static_cast<size_t>(b) * a.M + m] != 0;  // loaded beside the item's, not after
    float s = 0.f;
#pragma unroll 8
    for (int j = lane * 4; j < h; j += 128) {  // h <= 1024: every load of the item in flight at once
      const float4 qv = __ldcg(reinterpret_cast<const float4*>(qr + j));
      const uint2 sv = *reinterpret_cast<const uint2*>(sm + j);
      const float2 s01 = unpack_bf16(sv.x), s23 = unpack_bf16(sv.y);
      s += qv.x * s01.x + qv.y * s01.y + qv.z * s23.x + qv.w * s23.y;
    }
    s = warp_sum(s);
    if (lane == 0) a.sc[item] = keep ? s : kNegInf;
  }
  grid_barrier(a.bar, base, 1);

  // 3. each row's softmax, and this block's columns of C = alpha S: a warp a row, one pass over the
  // positions (each lane keeps its own running max, rescaling its sums when it grows; the lanes'
  // sums are brought to the row's max at the end)
  for (int r = warp; r < R && !(kDiag & 2048); r += kDecWarps) {
    const int b = r / a.N;
    const float* sr = a.sc + static_cast<size_t>(r) * a.M;
    float mx = -INFINITY, sum = 0.f, cv[kDecCols];
#pragma unroll
    for (int c = 0; c < kDecCols; ++c) cv[c] = 0.f;
    for (int m = lane; m < a.M; m += 32) {
      const float s = __ldcg(sr + m);
      const uint4* sp = reinterpret_cast<const uint4*>(a.S + (static_cast<size_t>(b) * a.M + m) * h + c0);
      if (s > mx) {  // a new running max: rescale what this lane has summed
        const float f = expf(mx - s);
        sum *= f;
#pragma unroll
        for (int c = 0; c < kDecCols; ++c) cv[c] *= f;
        mx = s;
      }
      const float e = expf(s - mx);
      sum += e;
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const uint4 raw = sp[k];
        const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack_bf16(u[i]);
          cv[8 * k + 2 * i] += e * f.x;
          cv[8 * k + 2 * i + 1] += e * f.y;
        }
      }
    }
    const float rmx = warp_max(mx);
    const float f = mx == -INFINITY ? 0.f : expf(mx - rmx);  // a lane with no position has nothing to add
    sum = warp_sum(sum * f);
#pragma unroll
    for (int c = 0; c < kDecCols; ++c) cv[c] *= f;
    constexpr int kLanes = 32 / kDecCols;  // lanes that end with each column's sum
    const float v = fold<kDecCols>(cv, lane);
    if (lane % kLanes == 0) a.c[static_cast<size_t>(r) * h + c0 + lane / kLanes] = v / sum;
  }
  grid_barrier(a.bar, base, 2);

  // 4. Hc's columns: tanh(P + C W_cc)
  for (int i = tid; i < RT * h / 4; i += kDecThreads)
    reinterpret_cast<float4*>(xs)[i] =
        i < R * h / 4 ? __ldcg(reinterpret_cast<const float4*>(a.c) + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait<0>();
  __syncthreads();
  {
    const float2* x2 = reinterpret_cast<const float2*>(xs);
    if (!(kDiag & 4096)) dec_product<RT>(wcc_s, [&](int r, int p) { return x2[r * (h / 2) + p]; }, red, h);
    const float* sums = red + kDecWarps * RT * kDecCols;
    for (int i = tid; i < R * kDecCols; i += kDecThreads)
      a.out[static_cast<size_t>(i / kDecCols) * h + c0 + i % kDecCols] = __float2bfloat16(tanhf(ps[i] + sums[i]));
  }
}

template <int RT>
cudaError_t launch_dec_rt(DecArgs& a, cudaStream_t stream) {
  static bool smem_set[64];
  const auto kernel = luong_dec_kernel<RT>;
  const size_t smem = dec_smem(RT, a.h);
  cudaError_t err = allow_smem(kernel, dec_smem(RT, kDecMaxH), smem_set);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms < 0) return static_cast<cudaError_t>(-sms);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDecThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid = a.h / kDecCols;
  if (grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;  // the blocks could not all be resident
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kDecThreads), args, smem,
                                    stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_dec(const void* H, const void* S, const int* mask, const void* wa, const void* wc,
                       const void* wcc, void* out, float* scratch, unsigned* bar, int B, int N, int M, int h,
                       cudaStream_t stream) {
  const int R = B * N;
  DecArgs a{static_cast<const bf16*>(H), static_cast<const bf16*>(S), static_cast<const bf16*>(wa),
            static_cast<const bf16*>(wc), static_cast<const bf16*>(wcc), mask, static_cast<bf16*>(out),
            scratch, scratch + static_cast<size_t>(R) * h, scratch + 2 * static_cast<size_t>(R) * h, bar, R, N, M, h};
  if (R <= 4) return launch_dec_rt<4>(a, stream);
  if (R <= 8) return launch_dec_rt<8>(a, stream);
  if (R <= 16) return launch_dec_rt<16>(a, stream);
  return launch_dec_rt<32>(a, stream);
}

}  // namespace

extern "C" {

// Routes, by the code the entry point takes.
// 0 = "fma" (fp32 or bf16, any width), 1 = "wgmma" (bf16, h a multiple of 64 up to 2048),
// 2 = "decode" (bf16, h a multiple of 64 up to 1024, B * N <= 32).

// fp32 elements of scratch that luong_attn_forward needs for these shapes on `route`.
long long luong_attn_scratch_floats(int B, int N, int M, int h, int route) {
  const long long R = static_cast<long long>(B) * N;
  if (route == 1) return R * h + R * kCTerms * h / 2;  // Q fp32, C bf16
  if (route == 2) return R * (2LL * h + M);             // Q, C, scores
  return static_cast<long long>(scratch_layout(B, N, M, h).total);
}

// H [B,N,h], S [B,M,h], mask [B,M] int32, w_alpha/w_ch/w_cc [h,h] and out [B,N,h] of dtype (0 = float32,
// 1 = bfloat16), contiguous; w_c = [w_ch; w_cc] contiguous ([2h, h]: the "wgmma" route reads it as one
// matrix); the bf16 routes need 16-byte aligned pointers.  barrier: 2 unsigned on the device, zero
// before the first "decode" call on a device and then left to the calls (null on the other routes);
// "decode" calls that share it must not run at the same time.
// A route that does not fit is refused (cudaErrorInvalidValue), never replaced.  Returns the
// cudaError_t of the launches (0 = all launched).
int luong_attn_forward(const void* H, const void* S, const int* mask, const void* w_alpha, const void* w_c,
                       const void* w_cc, void* out, float* scratch, unsigned* barrier, int B, int N, int M, int h,
                       int dtype, int route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || M < 1 || h < 1 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const bool wide = dtype == 1 && h % 64 == 0;
  switch (route) {
    case 0:
      if (dtype == 0) return launch_fma<float>(H, S, mask, w_alpha, w_c, w_cc, out, scratch, B, N, M, h, st);
      return launch_fma<__nv_bfloat16>(H, S, mask, w_alpha, w_c, w_cc, out, scratch, B, N, M, h, st);
    case 1:
      if (!wide || h > 2048 || B > 65535) return cudaErrorInvalidValue;
      return static_cast<int>(launch_wg(H, S, mask, w_alpha, w_c, out, scratch, B, N, M, h, st));
    case 2:
      if (!wide || h > kDecMaxH || B * N > kDecMaxRows || barrier == nullptr) return cudaErrorInvalidValue;
      return static_cast<int>(launch_dec(H, S, mask, w_alpha, w_c, w_cc, out, scratch, barrier, B, N, M, h, st));
    default:
      return cudaErrorInvalidValue;
  }
}

const char* luong_attn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
