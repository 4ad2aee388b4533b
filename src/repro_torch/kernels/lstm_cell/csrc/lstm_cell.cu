// Fused LSTM cell for Hopper, sm_90a.
//
//   gates = x Wx + h Wh + b                       (fp32 sums)
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g)
//   h'    = sigmoid(o) tanh(c')
//
// Replaces repro/kernels/lstm_cell/kernel.py::_lstm_kernel (the Pallas TPU
// kernel).  x [B,In], h/c [B,H], Wx [In,4,H], Wh [H,4,H], b [4,H]; each of the
// six is read as fp32 or bf16 on its own (the TPU kernel's astype(float32) on
// every load); h' is written in h's dtype and c' in c's.  Any B, In, H: ragged
// tile edges are zero-filled.  The gate pre-activations [B,4,H] stay in
// registers and shared memory: the nonlinearities and the state update run in
// the same launch, which is the point of the TPU kernel.
//
// What bounds it on an H100: at the training shape (B = 64, In = H = 1024)
// one call reads the fp32 weights, 4*(In+H)*H*4 B = 33.5 MB, against 1 GFLOP
// of products: about 10 us at 3.35 TB/s, while the same products take 16 us
// at the CUDA cores' fp32 FMA rate (67 TFLOP/s).  The model feeds the fp32
// master weights, so the products are fp32 FMA here (wgmma in bf16 or TF32
// would round the weights); a wgmma/TMA design is later work.
//
// Design: one block per 8 hidden units (32 gate columns: i, f, g, o of each)
// and per 64 batch rows, so each weight element is read once per row tile,
// once in all at B <= 64, and H = 1024 gives 128 independent blocks for the
// 132 SMs.  A block walks the depth in 64-deep chunks, first over [x | Wx],
// then over [h | Wh]: each thread loads its share of the next chunk into
// registers before it multiplies the current one out of shared memory, so a
// chunk's loads are in flight while the previous chunk computes.  Each thread
// holds a 4-row x 2-column tile of the gate sums.  The epilogue stages the
// 64 x 32 gate sums in shared memory, where each thread gathers a unit's four
// gates.  Sums run in a fixed order, so results do not change between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 8;                  // hidden units per block
constexpr int kGateCols = 4 * kUnits;      // their 32 gate columns, gate-major: c = gate * kUnits + unit
constexpr int kRows = 64;                  // batch rows per block
constexpr int kChunk = 64;                 // depth of one staged chunk
constexpr int kAStride = kRows + 4;        // As[k][r]: conflict-free transposed stores, 16-byte aligned rows
constexpr int kGStride = kGateCols + 1;    // the epilogue's gate tile [r][c]
constexpr int kTM = 4, kTN = 2;            // each thread's tile of the gate sums
constexpr int kALoads = kChunk * kRows / kThreads;      // 16 activation loads per thread per chunk
constexpr int kWLoads = kChunk * kGateCols / kThreads;  // 8 weight loads per thread per chunk
static_assert((kRows / kTM) * (kGateCols / kTN) == kThreads, "one gate tile per thread");
static_assert(kRows * kGStride <= kChunk * kAStride, "the gate tile fits in the activation buffer");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float load_any(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Loads one chunk of depth [k0, k0 + 64) into registers, zero outside the
// arrays.  Activation element i = t + 256 s has depth k0 + (i / 512) * 8 + i % 8
// and row (i / 8) % 64, so a warp reads 4 rows x 8 consecutive depths and
// stores them to As[k][r] on 32 distinct banks.  Weight element i has gate
// column i % 32 and depth k0 + i / 32: a warp reads four runs of 8 units.
template <typename TA, typename TW>
__device__ __forceinline__ void load_chunk(const TA* __restrict__ A, const TW* __restrict__ W, int K, int B, int H,
                                           int r0, int j0, int k0, float (&ra)[kALoads], float (&rw)[kWLoads]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kALoads; ++s) {
    const int i = t + kThreads * s;
    const int k = k0 + (i / (8 * kRows)) * 8 + i % 8, r = r0 + (i / 8) % kRows;
    ra[s] = (r < B && k < K) ? to_f(A[(size_t)r * K + k]) : 0.f;
  }
#pragma unroll
  for (int s = 0; s < kWLoads; ++s) {
    const int i = t + kThreads * s;
    const int c = i % kGateCols, k = k0 + i / kGateCols, j = j0 + c % kUnits;
    rw[s] = (k < K && j < H) ? to_f(W[((size_t)k * 4 + c / kUnits) * H + j]) : 0.f;
  }
}

// acc += A[r0:r0+64, :K] W[:K, :, j0:j0+8], A [B,K] row-major, W [K,4,H].
template <typename TA, typename TW>
__device__ __forceinline__ void accumulate(const TA* __restrict__ A, const TW* __restrict__ W, int K, int B, int H,
                                           int r0, int j0, float (&acc)[kTM][kTN], float (*As)[kAStride],
                                           float (*Ws)[kGateCols]) {
  const int t = threadIdx.x;
  float ra[kALoads], rw[kWLoads];
  const int tr = (t / (kGateCols / kTN)) * kTM, tc = (t % (kGateCols / kTN)) * kTN;
  const int chunks = ceil_div(K, kChunk);
  load_chunk(A, W, K, B, H, r0, j0, 0, ra, rw);
  for (int n = 0; n < chunks; ++n) {
    __syncthreads();  // every thread is done reading the previous chunk
#pragma unroll
    for (int s = 0; s < kALoads; ++s) {
      const int i = t + kThreads * s;
      As[(i / (8 * kRows)) * 8 + i % 8][(i / 8) % kRows] = ra[s];
    }
#pragma unroll
    for (int s = 0; s < kWLoads; ++s) {
      const int i = t + kThreads * s;
      Ws[i / kGateCols][i % kGateCols] = rw[s];
    }
    __syncthreads();
    if (n + 1 < chunks) load_chunk(A, W, K, B, H, r0, j0, (n + 1) * kChunk, ra, rw);  // in flight during the products
#pragma unroll 16
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][tr]);
      const float2 w = *reinterpret_cast<const float2*>(&Ws[k][tc]);
      const float av[kTM] = {a.x, a.y, a.z, a.w}, wv[kTN] = {w.x, w.y};
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int q = 0; q < kTN; ++q) acc[m][q] += av[m] * wv[q];
    }
  }
}

struct Args {
  const void *x, *h, *c, *wx, *wh, *b;
  void *h_out, *c_out;
  int B, In, H;
  int c_bf16, b_bf16;
};

template <typename TX, typename TH, typename TWX, typename TWH>
__global__ void __launch_bounds__(kThreads) lstm_cell_kernel(Args a) {
  __shared__ __align__(16) float As[kChunk][kAStride];
  __shared__ __align__(16) float Ws[kChunk][kGateCols];
  const int j0 = blockIdx.x * kUnits, r0 = blockIdx.y * kRows;
  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int q = 0; q < kTN; ++q) acc[m][q] = 0.f;
  accumulate(static_cast<const TX*>(a.x), static_cast<const TWX*>(a.wx), a.In, a.B, a.H, r0, j0, acc, As, Ws);
  accumulate(static_cast<const TH*>(a.h), static_cast<const TWH*>(a.wh), a.H, a.B, a.H, r0, j0, acc, As, Ws);

  __syncthreads();  // As becomes the gate tile G[r][c]
  float* G = &As[0][0];
  const int t = threadIdx.x;
  const int tr = (t / (kGateCols / kTN)) * kTM, tc = (t % (kGateCols / kTN)) * kTN;
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int q = 0; q < kTN; ++q) G[(tr + m) * kGStride + tc + q] = acc[m][q];
  __syncthreads();
  for (int i = t; i < kRows * kUnits; i += kThreads) {
    const int rr = i / kUnits, u = i % kUnits, r = r0 + rr, j = j0 + u;
    if (r >= a.B || j >= a.H) continue;
    const float* g = G + rr * kGStride + u;
    const float gi = g[0 * kUnits] + load_any(a.b, 0 * (size_t)a.H + j, a.b_bf16);
    const float gf = g[1 * kUnits] + load_any(a.b, 1 * (size_t)a.H + j, a.b_bf16);
    const float gg = g[2 * kUnits] + load_any(a.b, 2 * (size_t)a.H + j, a.b_bf16);
    const float go = g[3 * kUnits] + load_any(a.b, 3 * (size_t)a.H + j, a.b_bf16);
    const size_t o = (size_t)r * a.H + j;
    const float c_new = sigmoid(gf) * load_any(a.c, o, a.c_bf16) + sigmoid(gi) * tanhf(gg);
    const float h_new = sigmoid(go) * tanhf(c_new);
    store_any(a.c_out, o, c_new, a.c_bf16);
    static_cast<TH*>(a.h_out)[o] = from_f<TH>(h_new);
  }
}

// Instantiate the kernel for the dtypes of x, h, Wx and Wh, one code at a time
// (0 = float32, 1 = bfloat16); b's and c's dtypes are read at run time.
template <typename... Ts>
int dispatch(const int* codes, const Args& a, cudaStream_t stream) {
  if constexpr (sizeof...(Ts) == 4) {
    const dim3 grid(ceil_div(a.H, kUnits), ceil_div(a.B, kRows));
    lstm_cell_kernel<Ts...><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  } else {
    const int code = codes[sizeof...(Ts)];
    if (code == 0) return dispatch<Ts..., float>(codes, a, stream);
    if (code == 1) return dispatch<Ts..., __nv_bfloat16>(codes, a, stream);
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtypes: codes of x, h, c, Wx, Wh, b (0 = float32, 1 = bfloat16); h_out has
// h's dtype and c_out c's.  Returns the cudaError_t of the launch (0 = launched).
int lstm_cell_forward(const void* x, const void* h, const void* c, const void* wx, const void* wh, const void* b,
                      void* h_out, void* c_out, int B, int In, int H, int x_dt, int h_dt, int c_dt, int wx_dt,
                      int wh_dt, int b_dt, void* stream) {
  if (c_dt < 0 || c_dt > 1 || b_dt < 0 || b_dt > 1) return cudaErrorInvalidValue;
  const Args a{x, h, c, wx, wh, b, h_out, c_out, B, In, H, c_dt, b_dt};
  const int codes[4] = {x_dt, h_dt, wx_dt, wh_dt};
  return dispatch<>(codes, a, static_cast<cudaStream_t>(stream));
}

const char* lstm_cell_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
