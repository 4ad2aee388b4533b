// Grouped gated expert FFN for Hopper, sm_90a.
//
//   out[e] = (silu(x[e] . W1[e]) * (x[e] . Wg[e])) . W2[e]
//
// for each expert e of the MoE dispatch buffer x [E, C, d] (C capacity slots
// per expert; an empty slot is a zero row and gives an exact zero row), with
// W1/Wg [E, d, F] and W2 [E, F, d]; out [E, C, d] takes x's dtype.  Replaces
// repro/kernels/moe_gemm/kernel.py::_moe_kernel (moe_gemm_pallas, the Pallas
// TPU kernel).  That kernel walks F in order and accumulates each F block's
// partial product into a [block_c, d] output tile that stays in VMEM across
// the F steps.  On Hopper a 64-row output tile across d = 2048 in fp32 is
// 512 KB, more than a block's 227 KB of shared memory, and blocks run in no
// order, so nothing can carry a sum from one to the next.  Hence two
// launches behind one entry:
//   1. gate-up: one block per (expert, 64-row C tile, 64-column F tile)
//      streams its x rows once against W1 and Wg with two accumulators and
//      writes silu(a) * b into an h scratch [E, C, F] that the wrapper
//      allocates;
//   2. down: one block per (expert, 64-row C tile, 64-column d tile)
//      computes h . W2 over all of F and writes out in x's dtype.
// Any C, d and F: ragged tiles are masked (C = 641 at the serving prefill is
// ten full tiles and one of one row; the decode step has C = 1).
//
// What bounds it on an H100, at the two calls of the serving path of
// qwen3-moe-30b-a3b (E = 128 experts, d = 2048, F = 768, bf16):
//   * prefill of 4 x 2048 tokens (65,536 slots, C = 641): 774 GFLOP of
//     products, 0.783 ms at the 989 TFLOP/s bf16 tensor-core peak, against
//     1.88 GB moved (x, the weights and out once each: 0.561 ms at
//     3.35 TB/s), so it is bound by operations;
//   * one decode step (32 slots, C = 1): bound by bytes.  This design
//     streams every expert's weights whether or not a slot reached it,
//     1.21 GB, 0.361 ms at 3.35 TB/s; the function needs only the weights of
//     the experts that hold a row, at most 32 of the 128 (0.30 GB, 0.09 ms),
//     so on a served step's buffer it stays about 4 times above its bound
//     until it skips the empty experts.
// Two paths:
//   * bf16 with d and F multiples of 8 (the model's path): mma.sync m16n8k16
//     on the tensor cores with fp32 accumulators (moe_mma_kernel).  A block
//     of 4 warps owns a 64 x 64 output tile, 16 rows a warp; tiles of 32
//     along the reduction are staged by cp.async in a ring of 3 so that two
//     are in flight while one is multiplied; B fragments come transposed out
//     of ldmatrix.  h is rounded to bf16 between the two products (as the
//     flash kernel rounds P), which the checks hold to a relative-L2 bound;
//   * fp32, and bf16 at other widths: fp32 FMA on the CUDA cores
//     (moe_fma_kernel), h kept in fp32, as the fp32 path must meet the
//     harness's 1e-5 tolerance (3xTF32 products missed it in the lstm_cell
//     kernel's trials).
// A simple kernel that is right comes first.  Later work: wgmma and TMA
// (mma.sync reaches a fraction of the card's tensor-core rate); at decode,
// skipping experts that no kept slot reached and 16-row tiles (a 64-row tile
// computes 63 zero rows at C = 1); fusing the dispatch gather into the
// gate-up launch and the combine into the down launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // rows and columns of each block's output tile

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// fp32 FMA: out[z] (M x N) = A[z] (M x K) . B[z] (K x N), all row-major; with
// GATED, out[z] = silu(A . B) * (A . Bg).  One block of 256 threads per 64 x 64
// output tile of expert z = blockIdx.z; each thread owns 4 rows x 4 columns
// (and a second accumulator set when gated).  Tiles of 16 along K are staged
// in shared memory as fp32, A transposed so each thread reads its 4 rows as
// one float4.
// ---------------------------------------------------------------------------

constexpr int kFmaBK = 16;
constexpr int kFmaThreads = 256;

template <typename TA, typename TB, typename TO, bool GATED>
__global__ void __launch_bounds__(kFmaThreads)
moe_fma_kernel(const TA* __restrict__ A, const TB* __restrict__ B, const TB* __restrict__ Bg, TO* __restrict__ out,
               int M, int K, int N) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int kARow = kTile + 4;  // padded, and a multiple of 4 for float4 reads
  __shared__ __align__(16) float As[kFmaBK][kARow];
  __shared__ __align__(16) float Bs[NB][kFmaBK][kTile];

  const size_t z = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  A += z * M * K;
  B += z * K * N;
  if constexpr (GATED) Bg += z * K * N;
  out += z * M * N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // columns 4 tx .. 4 tx + 3, rows 4 ty .. 4 ty + 3

  float acc[NB][4][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kTile * kFmaBK; e += kFmaThreads) {
      const int r = e / kFmaBK, ka = e % kFmaBK;  // A: 16 neighbouring k of one row
      const int m = m0 + r, k = k0 + ka;
      As[ka][r] = (m < M && k < K) ? to_f(A[static_cast<size_t>(m) * K + k]) : 0.f;
      const int kb = e / kTile, c = e % kTile;  // B: 64 neighbouring n of one k
      const int kg = k0 + kb, n = n0 + c;
      const bool in = kg < K && n < N;
      Bs[0][kb][c] = in ? to_f(B[static_cast<size_t>(kg) * N + n]) : 0.f;
      if constexpr (GATED) Bs[1][kb][c] = in ? to_f(Bg[static_cast<size_t>(kg) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[j][kk][4 * tx]);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][i][c] = fmaf(a[i], b[c], acc[j][i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n >= N) continue;
      const float v = GATED ? silu(acc[0][i][c]) * acc[NB - 1][i][c] : acc[0][i][c];
      out[static_cast<size_t>(m) * N + n] = from_f<TO>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (K and N multiples of 8, every row 16-byte
// aligned): the same products as moe_fma_kernel, mma.sync m16n8k16 with fp32
// accumulators, out in bf16.  One block of 4 warps per 64 x 64 output tile;
// warp w owns rows 16 w .. 16 w + 15 and all 64 columns (8 n-tiles, twice
// when gated).  Tiles of 32 along K: A [64][32] and B [32][64] staged by
// cp.async (16 bytes a copy, zero-filled past M, K and N) into a ring of
// kStages buffers, each row padded by 8 bf16 so fragment loads hit distinct
// banks.  A fragments are 32-bit loads; B fragments come transposed out of
// ldmatrix, two n-tiles per instruction.
// ---------------------------------------------------------------------------

constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 128;
constexpr int kStages = 3;
constexpr int kARowB = kMmaBK + 8;  // A row stride in bf16 (80 bytes)
constexpr int kBRowB = kTile + 8;   // B row stride in bf16 (144 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_bf16_16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem_row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half), .y = hi
  return *reinterpret_cast<const unsigned*>(&p);
}

// Stage the K tile k0 .. k0 + 31 of A (rows m0 ..) and of B (and Bg; columns n0 ..).
template <int NB>
__device__ __forceinline__ void stage_tile(bf16* as, bf16* bs, const bf16* A, const bf16* B, const bf16* Bg, int m0,
                                           int n0, int k0, int M, int K, int N) {
  for (int c = threadIdx.x; c < kTile * (kMmaBK / 8); c += kMmaThreads) {
    const int r = c / (kMmaBK / 8), kc = (c % (kMmaBK / 8)) * 8;
    const int m = m0 + r, k = k0 + kc;
    const bool in = m < M && k < K;  // K % 8 == 0: a chunk is wholly in or out
    cp_async16(as + r * kARowB + kc, in ? A + static_cast<size_t>(m) * K + k : A, in);
  }
  for (int c = threadIdx.x; c < kMmaBK * (kTile / 8); c += kMmaThreads) {
    const int r = c / (kTile / 8), nc = (c % (kTile / 8)) * 8;
    const int k = k0 + r, n = n0 + nc;
    const bool in = k < K && n < N;
    const size_t off = in ? static_cast<size_t>(k) * N + n : 0;
    cp_async16(bs + r * kBRowB + nc, B + off, in);
    if constexpr (NB == 2) cp_async16(bs + kMmaBK * kBRowB + r * kBRowB + nc, Bg + off, in);
  }
}

template <bool GATED>
__global__ void __launch_bounds__(kMmaThreads)
moe_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, const bf16* __restrict__ Bg,
               bf16* __restrict__ out, int M, int K, int N) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ __align__(16) bf16 As[kStages][kTile * kARowB];
  __shared__ __align__(16) bf16 Bs[kStages][NB * kMmaBK * kBRowB];

  const size_t z = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  A += z * M * K;
  B += z * K * N;
  if constexpr (GATED) Bg += z * K * N;
  out += z * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' groupID and thread-in-group
  const int KT = (K + kMmaBK - 1) / kMmaBK;

  float acc[NB][8][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) stage_tile<NB>(As[s], Bs[s], A, B, Bg, m0, n0, s * kMmaBK, M, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (for this thread's copies) ...
    __syncthreads();               // ... for every thread's, and the buffer refilled below is free
    const int next = kt + kStages - 1;
    if (next < KT) stage_tile<NB>(As[next % kStages], Bs[next % kStages], A, B, Bg, m0, n0, next * kMmaBK, M, K, N);
    cp_async_commit();
    const int s = kt % kStages;
    // A fragments: a[0] (row g, k 2t..2t+1), a[1] (row g + 8, ..), a[2] (row g, k 2t+8..), a[3] (row g + 8, ..)
    const bf16* arow = As[s] + (16 * warp + g) * kARowB + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      unsigned a[4];
      a[0] = *reinterpret_cast<const unsigned*>(arow + 16 * kk);
      a[1] = *reinterpret_cast<const unsigned*>(arow + 8 * kARowB + 16 * kk);
      a[2] = *reinterpret_cast<const unsigned*>(arow + 16 * kk + 8);
      a[3] = *reinterpret_cast<const unsigned*>(arow + 8 * kARowB + 16 * kk + 8);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // lane l addresses k row 16 kk + (l & 15), columns 8 n + 8 (l >> 4): the
        // transposed matrices are b0, b1 of n-tile n, then b0, b1 of n-tile n + 1
        const bf16* brow = Bs[s] + j * kMmaBK * kBRowB + (16 * kk + (lane & 15)) * kBRowB + 8 * (lane >> 4);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(b, brow + 8 * n);
          mma_bf16_16816(acc[j][n], a, b[0], b[1]);
          mma_bf16_16816(acc[j][n + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // c[0..1]: (row g, columns 2t, 2t + 1), c[2..3]: (row g + 8, ..); N % 8 == 0, so a pair is wholly in or out
  const int r0 = m0 + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n0 + 8 * n + 2 * t;
    if (col >= N) continue;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = GATED ? silu(acc[0][n][e]) * acc[NB - 1][n][e] : acc[0][n][e];
    if (r0 < M) *reinterpret_cast<unsigned*>(out + static_cast<size_t>(r0) * N + col) = pack_bf16(v[0], v[1]);
    if (r1 < M) *reinterpret_cast<unsigned*>(out + static_cast<size_t>(r1) * N + col) = pack_bf16(v[2], v[3]);
  }
}

template <bool GATED>
cudaError_t launch_mma(const void* A, const void* B, const void* Bg, void* out, int E, int M, int K, int N,
                       cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
  moe_mma_kernel<GATED><<<grid, kMmaThreads, 0, stream>>>(static_cast<const bf16*>(A), static_cast<const bf16*>(B),
                                                          static_cast<const bf16*>(Bg), static_cast<bf16*>(out), M,
                                                          K, N);
  return cudaGetLastError();
}

template <typename TA, typename TB, typename TO, bool GATED>
cudaError_t launch_fma(const void* A, const void* B, const void* Bg, void* out, int E, int M, int K, int N,
                       cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
  moe_fma_kernel<TA, TB, TO, GATED><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), static_cast<const TB*>(Bg), static_cast<TO*>(out), M, K,
      N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether the h scratch is bf16 (the tensor-core path: bf16 with d and F
// multiples of 8) or fp32 (every other case).  dtype 0 = float32, 1 = bfloat16.
int moe_gemm_h_is_bf16(int dtype, int d, int F) { return dtype == 1 && d % 8 == 0 && F % 8 == 0; }

// x [E,C,d], w1/wg [E,d,F], w2 [E,F,d], out [E,C,d], all of dtype, contiguous
// and 16-byte aligned; h [E,C,F] is scratch of the dtype moe_gemm_h_is_bf16
// names.  Two launches on `stream`: gate-up into h, then down into out.
// Returns the cudaError_t of the launches (0 = both launched).
int moe_gemm_forward(const void* x, const void* w1, const void* wg, const void* w2, void* h, void* out, int E, int C,
                     int d, int F, int dtype, void* stream) {
  if (E < 1 || C < 1 || d < 1 || F < 1 || E > 65535 || (C + kTile - 1) / kTile > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (moe_gemm_h_is_bf16(dtype, d, F)) {
    err = launch_mma<true>(x, w1, wg, h, E, C, d, F, st);
    if (err == cudaSuccess) err = launch_mma<false>(h, w2, nullptr, out, E, C, F, d, st);
  } else if (dtype == 0) {
    err = launch_fma<float, float, float, true>(x, w1, wg, h, E, C, d, F, st);
    if (err == cudaSuccess) err = launch_fma<float, float, float, false>(h, w2, nullptr, out, E, C, F, d, st);
  } else {
    err = launch_fma<bf16, bf16, float, true>(x, w1, wg, h, E, C, d, F, st);
    if (err == cudaSuccess) err = launch_fma<float, bf16, bf16, false>(h, w2, nullptr, out, E, C, F, d, st);
  }
  return static_cast<int>(err);
}

const char* moe_gemm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
