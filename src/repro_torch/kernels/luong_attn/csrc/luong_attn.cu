// Luong global-attention head (paper eq. 1-4) for Hopper, sm_90a.
//
//   scores = (H W_a) S^T, set to -1e30 where src_mask == 0   (eq. 1)
//   alpha  = softmax over M in fp32                           (eq. 2)
//   C      = alpha S                                          (eq. 3)
//   Hc     = tanh(H W_ch + C W_cc)                            (eq. 4)
//
// Replaces repro/kernels/luong_attn/kernel.py::_luong_kernel (the Pallas
// TPU kernel).  H [B,N,h], S [B,M,h], W_a/W_ch/W_cc [h,h] in fp32 or bf16,
// mask [B,M] int32; every sum is fp32; Hc is written in H's dtype.
//
// What bounds it on an H100: at decode (N = 1, B = slots) the head is bound
// by device-memory bytes.  The three weights are 3*h*h*2 B = 6.3 MB in bf16
// at h = 1024, S is B*M*h*2 B (0.5 MB at B = 4, M = 64): about 2 us at
// 3.35 TB/s, while the arithmetic is a few tens of MFLOP.  The TPU kernel's
// grid re-reads all three weights for every (batch, n-block) step; here the
// weights are shared across the batch, so the products that read them run
// over all R = B*N rows at once and each weight element is read once per
// 8-row tile (once in all at decode, where R <= 8).  At decode R is a handful
// of rows, so what matters is keeping enough independent loads in flight:
// the weight products split the depth h into 128-deep chunks (split-K), so
// a 1024-wide head runs 256 projection blocks instead of a few, and every
// loop over h or M issues unrolled loads whose addresses do not depend on
// the sum.  Partial sums go to fp32 scratch and are added in a fixed order,
// so results do not change from run to run.  Five launches on the caller's
// stream, all scratch from the wrapper:
//   (a) splitk_kernel:  partial Q = H W_a and P = H W_ch per depth chunk
//   (b) scores_kernel:  one warp per (row, m): Q . S[b, m], masked
//   (c) context_kernel: per (row, 128 columns): softmax over M, ctx = alpha S
//   (d) splitk_kernel:  partial ctx W_cc per depth chunk
//   (e) output_kernel:  Hc = tanh(sum of the P and ctx W_cc partials), in T
// All products are fp32 FMA on the CUDA cores; wgmma/TMA tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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
int launch(const void* H_, const void* S_, const int* mask, const void* wa_, const void* wch_, const void* wcc_,
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

}  // namespace

extern "C" {

// fp32 elements of scratch that luong_attn_forward needs for these shapes.
long long luong_attn_scratch_floats(int B, int N, int M, int h) {
  return (long long)scratch_layout(B, N, M, h).total;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (0 = all five launched).
int luong_attn_forward(const void* H, const void* S, const int* mask, const void* w_alpha, const void* w_ch,
                       const void* w_cc, void* out, float* scratch, int B, int N, int M, int h, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(H, S, mask, w_alpha, w_ch, w_cc, out, scratch, B, N, M, h, st);
  if (dtype == 1) return launch<__nv_bfloat16>(H, S, mask, w_alpha, w_ch, w_cc, out, scratch, B, N, M, h, st);
  return cudaErrorInvalidValue;
}

const char* luong_attn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
