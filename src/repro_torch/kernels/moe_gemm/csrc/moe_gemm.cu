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
// launches behind one entry: gate-up, silu(x W1) * (x Wg) into an h scratch
// [E, C, F] that the wrapper allocates, then down, h W2 into out.
//
// Rows that hold a slot.  The dispatch places expert e's kept slots at rows
// 0 .. n_e - 1 of its group.  Given rows (int32 [E], rows[e] = min(n_e, C)),
// every kernel skips the products of the rows >= rows[e] and stores exact
// zeros there (whatever x holds in them), so the function is unchanged; h's
// rows past rows[e] hold no defined value and never reach out.  rows = null
// means every row holds a slot.
//
// What bounds it on an H100, at the two calls of the serving path of
// qwen3-moe-30b-a3b (E = 128 experts, d = 2048, F = 768, bf16):
//   * prefill of 4 x 2048 tokens (65,536 slots, C = 641): 774 GFLOP of
//     products on a full buffer, 0.78 ms at the 989 TFLOP/s bf16 tensor-core
//     peak, against 1.88 GB moved (0.56 ms at 3.35 TB/s): bound by operations;
//   * one decode step (32 slots, C = 1): bound by bytes, and only the weights
//     of the experts that hold a row count: 28-30 of 128 at a served step,
//     about 0.27 GB, 0.08 ms at 3.35 TB/s.
// Four routes, one per kernel pair; the wrapper (ops.py) names the route and
// the entry point refuses a route that does not fit:
//   * "wgmma" (bf16, d and F multiples of 64): the prefill's.  A persistent
//     block per SM walks a list of 128-row x 256-column output tiles that
//     holds only rows with a slot; one producer thread keeps 3-D TMA copies
//     (128B swizzle) in flight into a ring of full/empty mbarriers, and two
//     consumer warpgroups multiply with wgmma m64n256k16, each on 64 of the
//     tile's rows, both reading one B tile, and send their output out by
//     TMA stores; the ring runs on across tiles, so one tile's epilogue
//     overlaps the next one's loads (moe_wg_kernel);
//   * "decode" (bf16, d and F multiples of 64, C <= 16): the decode step's.
//     One block per (expert, column tile); a block whose expert holds no row
//     stores its zeros and exits without reading a weight; the others stream
//     their weight columns once through a cp.async ring on a 16-row tile
//     with mma.sync m16n8k16, eight warps splitting each stage's depth and
//     summing in a fixed order (moe_dec_kernel);
//   * "mma" (bf16, d and F multiples of 8): the first tensor-core kernel,
//     mma.sync on 64 x 64 tiles fed by a 3-deep cp.async ring;
//   * "fma" (fp32, and bf16 at any width): fp32 FMA on the CUDA cores, h kept
//     in fp32, as the fp32 path must meet the harness's 1e-5 tolerance.
// Every route but "fma" rounds h to bf16 between the two products (as the
// flash kernel rounds P), which the checks hold to a relative-L2 bound.
// All sum in a fixed order, so results do not change between runs.
// Later work: fusing the dispatch gather into the gate-up launch and the
// combine into the down launch; fewer L2 bytes a product (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"  // mbarriers, TMA copies, wgmma and its descriptors, the tensor-map encoder

namespace {

typedef __nv_bfloat16 bf16;
using namespace hopper;

constexpr int kTile = 64;  // rows and columns of each block's output tile (the "fma" and "mma" routes)

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }
// silu on the SFU (ex2.approx, rcp.approx): within a few ulp of fp32 and far inside the bf16 rounding
// of h; the prefill's epilogue computes 64 a thread per tile, where expf and the IEEE division are too slow
__device__ __forceinline__ float silu_fast(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + __expf(-a)));
  return a * r;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// The rows of expert z that hold a slot: rows[z] clamped to [0, M], or M.
__device__ __forceinline__ int live_rows(const int* rows, int z, int M) {
  return rows == nullptr ? M : min(max(rows[z], 0), M);
}

// ---------------------------------------------------------------------------
// fp32 FMA: out[z] (M x N) = A[z] (M x K) . B[z] (K x N), all row-major; with
// GATED, out[z] = silu(A . B) * (A . Bg).  One block of 256 threads per 64 x 64
// output tile of expert z = blockIdx.z; each thread owns 4 rows x 4 columns
// (and a second accumulator set when gated).  Tiles of 16 along K are staged
// in shared memory as fp32, A transposed so each thread reads its 4 rows as
// one float4.  Rows >= R = live_rows(rows, z, M): GATED stores nothing there,
// the down product stores zeros; a tile wholly past R reads nothing.
// ---------------------------------------------------------------------------

constexpr int kFmaBK = 16;
constexpr int kFmaThreads = 256;

template <typename TA, typename TB, typename TO, bool GATED>
__global__ void __launch_bounds__(kFmaThreads)
moe_fma_kernel(const TA* __restrict__ A, const TB* __restrict__ B, const TB* __restrict__ Bg, TO* __restrict__ out,
               const int* __restrict__ rows, int M, int K, int N) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int kARow = kTile + 4;  // padded, and a multiple of 4 for float4 reads
  __shared__ __align__(16) float As[kFmaBK][kARow];
  __shared__ __align__(16) float Bs[NB][kFmaBK][kTile];

  const size_t z = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int R = live_rows(rows, static_cast<int>(z), M);
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

  for (int k0 = 0; m0 < R && k0 < K; k0 += kFmaBK) {  // a tile wholly past R multiplies nothing
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
    if (m >= M || (GATED && m >= R)) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n >= N) continue;
      const float v = GATED ? silu(acc[0][i][c]) * acc[NB - 1][i][c] : acc[0][i][c];
      out[static_cast<size_t>(m) * N + n] = from_f<TO>(m < R ? v : 0.f);
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
// ldmatrix, two n-tiles per instruction.  Rows past R as in moe_fma_kernel.
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
               bf16* __restrict__ out, const int* __restrict__ rows, int M, int K, int N) {
  constexpr int NB = GATED ? 2 : 1;
  __shared__ __align__(16) bf16 As[kStages][kTile * kARowB];
  __shared__ __align__(16) bf16 Bs[kStages][NB * kMmaBK * kBRowB];

  const size_t z = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int R = live_rows(rows, static_cast<int>(z), M);
  A += z * M * K;
  B += z * K * N;
  if constexpr (GATED) Bg += z * K * N;
  out += z * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' groupID and thread-in-group
  const int KT = m0 < R ? (K + kMmaBK - 1) / kMmaBK : 0;  // a tile wholly past R multiplies nothing

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
    const bool in0 = r0 < M && (!GATED || r0 < R), in1 = r1 < M && (!GATED || r1 < R);
    if (in0) *reinterpret_cast<unsigned*>(out + static_cast<size_t>(r0) * N + col) = r0 < R ? pack_bf16(v[0], v[1]) : 0u;
    if (in1) *reinterpret_cast<unsigned*>(out + static_cast<size_t>(r1) * N + col) = r1 < R ? pack_bf16(v[2], v[3]) : 0u;
  }
}

// ---------------------------------------------------------------------------
// "wgmma": the prefill's route, bf16, K and N multiples of 64.
//
// What the mma.sync kernel above lacked, and what this one does about it:
//   * mma.sync reached 179 TFLOP/s: here two consumer warpgroups multiply
//     with wgmma m64n256k16, A K-major and B MN-major (the transpose flag:
//     the weights keep the JAX layout, their N index contiguous), both from
//     128B-swizzled shared memory; at gate-up one product covers 128
//     columns of W1 and the same 128 of Wg, laid side by side in the stage,
//     so each column and its gate land in one thread's registers;
//   * each block re-read its x panel and weight columns from L2 through
//     cp.async on 64 x 64 tiles: here a tile is 128 rows x 256 columns of B,
//     one B stage feeds both consumers' 64 rows, and one producer thread issues
//     3-D TMA copies ([E, rows, cols] maps, 64 x 64 boxes) into a ring of
//     stages of 64 along K (full and empty mbarriers).  A tile still reads
//     85 FLOP a byte from L2: the copies alone take about 1.1 ms of the
//     prefill call (PERF.md, tools/moe_gemm_variants.py's breakdown);
//   * a block per tile paid its start-up and its stores alone: here one
//     block per SM walks the tile list, and the ring runs on across tiles, so
//     the producer loads the next tile while the consumers store, and a
//     consumer's output leaves by TMA stores from shared memory (stmatrix),
//     not by 32-bit stores from registers (a third of the down kernel's time);
//   * C = 641 = 5 x 128 + 1 made the last row tile of every expert cost a
//     full tile, and empty rows were multiplied: here the tile list holds,
//     per expert, only the row tiles that reach a row with a slot, a
//     consumer whose 64 rows hold none skips its copies and products, and
//     the warps of the producer warpgroup that issue no copies store the
//     zeros of the down product's rows past the last live 64 while the
//     consumers multiply.
// Each block first reads rows[] and forms, in shared memory, every expert's
// first tile (and first zero row) by a prefix sum; a work index is then
// mapped to (expert, row tiles, column tile) by a binary search.
// setmaxnreg moves registers from the producer warpgroup (40) to the
// consumers (232).  The ring depths are the measured choice
// (tools/moe_gemm_variants.py builds copies with other values).
// ---------------------------------------------------------------------------

#ifndef MOE_WG_UP_STAGES
#define MOE_WG_UP_STAGES 4
#endif
#ifndef MOE_WG_STAGES
#define MOE_WG_STAGES 3
#endif
constexpr int kWgHalf = 64;                          // rows of a consumer warpgroup: wgmma's M
constexpr int kWgBK = 64;                            // depth of a ring stage: one 128-byte swizzle row
constexpr int kWgBoxes = 4;                          // [64 k][64 n] boxes of B a stage
constexpr int kWgThreads = 384;                      // two consumer warpgroups and the producer's
constexpr int kWgBox = kWgHalf * 128;                // bytes of one 64 x 64 bf16 box (8192)
constexpr int kWgStage = (2 + kWgBoxes) * kWgBox;    // A's two halves, then B's boxes
constexpr int kWgMaxExperts = 256;                   // the prefix sums live in shared memory

// Shared memory of each kernel: the ring (the gate-up kernel's longer K gives it a deeper one), each
// consumer's output tile on its way out as 64 x 64 boxes (h: 64 x 128, out: 64 x 256), the ring's
// barriers, then the prefix sums (the gate-up kernel needs no rows to zero)
template <bool GATED>
struct WgSmem {
  static constexpr int kStages = GATED ? MOE_WG_UP_STAGES : MOE_WG_STAGES;
  static constexpr int kOut = (GATED ? 2 : 4) * kWgBox;
  static constexpr size_t bytes(int E) {
    return 1024 + static_cast<size_t>(kStages) * kWgStage + 2 * kOut + 2 * kStages * sizeof(uint64_t) +
           (GATED ? 1 : 2) * (static_cast<size_t>(E) + 1) * sizeof(int);
  }
  static_assert(bytes(kWgMaxExperts) <= 232448, "the ring and the prefix sums fit in a block's shared memory");
};

struct WgArgs {
  bf16* out;         // h [E, C, N] (gate-up) or out [E, C, N] (down)
  const int* rows;   // [E] or null
  int E, C, K, N;
  int nt;            // column tiles per row tile: N / 128 (gate-up) or N / 256 (down), rounded up
};

// Expert of work index w: the largest e with first[e] <= w (first is non-decreasing, first[0] = 0)
__device__ __forceinline__ int wg_find(const int* first, int E, int w) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first[mid] <= w) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <bool GATED>
__global__ void __launch_bounds__(kWgThreads, 1)
    moe_wg_kernel(WgArgs a, const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const __grid_constant__ CUtensorMap mbg, const __grid_constant__ CUtensorMap mo) {
  constexpr int kStages = WgSmem<GATED>::kStages, kOut = WgSmem<GATED>::kOut;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outs = smem + kStages * kWgStage;  // each consumer's output tile, as 64 x 64 boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * kOut);  // stage s has landed
  uint64_t* empty = full + kStages;                                // stage s may be refilled
  int* s_tile0 = reinterpret_cast<int*>(empty + kStages);  // [E + 1]: each expert's first work tile; [E] the count
  int* s_zero0 = s_tile0 + a.E + 1;  // down: [E + 1], each expert's first row to zero; [E] the count

  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // each consumer warpgroup once per stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) {  // prefix sums of the tiles and the rows to zero, 32 experts a step
    int tiles = 0, zeros = 0;
    for (int base = 0; base < a.E; base += 32) {
      const int e = base + lane;
      const int r = e < a.E ? live_rows(a.rows, e, a.C) : 0;
      const int halves = (r + kWgHalf - 1) / kWgHalf, mtiles = (halves + 1) / 2;
      int t = mtiles * a.nt, z = e < a.E ? a.C - min(a.C, halves * kWgHalf) : 0;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int tu = __shfl_up_sync(0xffffffffu, t, o), zu = __shfl_up_sync(0xffffffffu, z, o);
        if (lane >= o) t += tu, z += zu;
      }
      if (e < a.E) {
        s_tile0[e + 1] = tiles + t;
        if constexpr (!GATED) s_zero0[e + 1] = zeros + z;
      }
      tiles += __shfl_sync(0xffffffffu, t, 31);
      zeros += __shfl_sync(0xffffffffu, z, 31);
    }
    if (lane == 0) {
      s_tile0[0] = 0;
      if constexpr (!GATED) s_zero0[0] = 0;
    }
  }
  __syncthreads();
  const int work = s_tile0[a.E];
  const int KT = a.K / kWgBK;

  // work index w -> expert e, its live rows R, the row tile m, the column tile n
  const auto tile = [&](int w, int& e, int& R, int& m, int& n) {
    e = wg_find(s_tile0, a.E, w);
    R = live_rows(a.rows, e, a.C);
    const int local = w - s_tile0[e];
    m = local / a.nt;
    n = local % a.nt;
  };
  // a consumer warpgroup's release of ring stage s (its wgmma are done, so one thread speaks for it)
  const auto release = [&](int s) {
    if (tid % 128 == 0) mbar_arrive(&empty[s]);
  };

  const int wg = tid / 128;
  if (wg == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {  // one thread issues every copy
      int it = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        int e, R, m, n;
        tile(w, e, R, m, n);
        const int row = m * 2 * kWgHalf;
        const bool live0 = row < R, live1 = row + kWgHalf < R;
        int cols[kWgBoxes], nbox = 0;
#pragma unroll
        for (int j = 0; j < kWgBoxes; ++j) {
          cols[j] = GATED ? n * 128 + 64 * (j % 2) : n * 256 + 64 * j;
          nbox += cols[j] < a.N;  // N % 64 == 0: a box is wholly in or out
        }
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          unsigned char* st = smem + s * kWgStage;
          // the live A halves, and the B boxes inside N
          mbar_expect_bytes(&full[s], (live0 + live1 + nbox) * kWgBox);
          if (live0) tensor_copy_3d(st, &ma, kt * kWgBK, row, e, &full[s]);
          if (live1) tensor_copy_3d(st + kWgBox, &ma, kt * kWgBK, row + kWgHalf, e, &full[s]);
#pragma unroll
          for (int j = 0; j < kWgBoxes; ++j)
            if (cols[j] < a.N)
              tensor_copy_3d(st + (2 + j) * kWgBox, GATED && j >= 2 ? &mbg : &mb, cols[j], kt * kWgBK, e, &full[s]);
        }
      }
    } else if (!GATED && tid >= 256 + 32) {
      // warps 1-3: the down product's rows past each expert's last live 64 are zeros
      const int zrows = s_zero0[a.E], wid = tid / 32 - 9;
      for (int zr = blockIdx.x * 3 + wid; zr < zrows; zr += gridDim.x * 3) {
        const int e = wg_find(s_zero0, a.E, zr);
        const int r = a.C - (s_zero0[e + 1] - s_zero0[e]) + (zr - s_zero0[e]);
        uint4* dst = reinterpret_cast<uint4*>(a.out + (static_cast<size_t>(e) * a.C + r) * a.N);
        for (int c = lane; c < a.N / 8; c += 32) dst[c] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncwarp();
  } else {  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each of this block's tiles
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
    // the tile's 256 columns (gate-up: x W1 in 0-127, x Wg in 128-255): acc[4 j + q] is row r0 (q < 2) or
    // r1 (q >= 2), column 8 j + 2 t + (q & 1), so a column of x W1 and its gate sit in one thread
    float acc[128];
    int it = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      int e, R, m, n;
      tile(w, e, R, m, n);
      const int row0 = m * 2 * kWgHalf + wg * kWgHalf;
      if (row0 >= R) {  // no row of this warpgroup's 64 holds a slot: keep in step with the ring
        for (int kt = 0; kt < KT; ++kt, ++it) {
          mbar_wait(&full[it % kStages], (it / kStages) & 1);
          release(it % kStages);
        }
        continue;
      }
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const unsigned st = smem_u32(smem + s * kWgStage);
        const unsigned a_addr = st + wg * kWgBox, b_addr = st + 2 * kWgBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          const uint64_t da = sw128_desc(a_addr + 32 * kk, 16);  // 16 columns of the 64-column A box
          // 16 rows of the B boxes (2048 bytes); the next 64 columns lie one box (8192 bytes) on
          wgmma_ss_n256_tb(acc, da, sw128_desc(b_addr + 2048 * kk, kWgBox), kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: its slot is free
        if (kt > 0) release((it - 1) % kStages);
      }
      wgmma_wait<0>();
      pin_all(acc);
      release((it - 1) % kStages);

      // The tile leaves through shared memory: this warpgroup's 64 rows x 128 (h) or 256 (out) columns
      // as 64 x 64 boxes, 128B-swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)), written with
      // stmatrix, then stored by TMA (rows past C and columns past N are clipped) while the warpgroup
      // goes on to its next tile.  h = silu(x W1) * (x Wg); out is zero in the rows past R.
      unsigned char* buf = outs + wg * kOut;
      if (tid % 128 == 0) bulk_wait_read<0>();  // the last tile's stores have read the buffer
      named_sync(1 + wg, 128);
      const int mi = lane / 8, rr = 16 * warp + lane % 8 + 8 * (mi & 1);  // this lane's stmatrix row address
      const bool z0 = !GATED && 16 * warp + g + row0 >= R, z1 = !GATED && 16 * warp + g + 8 + row0 >= R;
#pragma unroll
      for (int j = 0; j < (GATED ? 16 : 32); j += 2) {  // n8 blocks j and j + 1: four 8 x 8 matrices
        unsigned r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * (j + q / 2) + 2 * (q % 2);  // rows g (q even) or g + 8 (q odd) of block j + q / 2
          const bool zero = q % 2 ? z1 : z0;
          if constexpr (GATED) r[q] = pack_bf16(silu_fast(acc[i]) * acc[i + 64], silu_fast(acc[i + 1]) * acc[i + 65]);
          else r[q] = zero ? 0u : pack_bf16(acc[i], acc[i + 1]);
        }
        const int jj = j + mi / 2;  // the n8 block of this lane's matrix
        stmatrix_x4(smem_u32(buf) + (jj / 8) * kWgBox + rr * 128 + (((jj % 8) ^ (rr % 8)) << 4), r[0], r[1], r[2], r[3]);
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (tid % 128 == 0) {
#pragma unroll
        for (int b = 0; b < (GATED ? 2 : 4); ++b) {
          const int col = (GATED ? n * 128 : n * 256) + 64 * b;
          if (col < a.N) tensor_store_3d(&mo, buf + b * kWgBox, col, row0, e);
        }
        bulk_commit();
      }
    }
    if (tid % 128 == 0) bulk_wait<0>();  // every store has landed before the block leaves
  }
}

// The SMs of the current device (or a negative cudaError_t), counted once per device, with both
// kernels' shared-memory limit raised.
int wg_sms() {
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(moe_wg_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WgSmem<true>::bytes(kWgMaxExperts)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(moe_wg_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(WgSmem<false>::bytes(kWgMaxExperts)));
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    sms[dev] = n;
  }
  return sms[dev];
}

// One launch of the wgmma kernel: A [E, C, K], B (and Bg) [E, K, N], out [E, C, N], all bf16.
template <bool GATED>
cudaError_t launch_wg(const void* A, const void* B, const void* Bg, void* out, const int* rows, int E, int C, int K,
                      int N, cudaStream_t stream) {
  const auto kernel = moe_wg_kernel<GATED>;
  CUtensorMap ma, mb, mbg, mo;
  cudaError_t err = encode_bf16_3d(&ma, A, E, C, K, kWgHalf);
  if (err == cudaSuccess) err = encode_bf16_3d(&mb, B, E, K, N, kWgBK);
  if (err == cudaSuccess) err = encode_bf16_3d(&mbg, GATED ? Bg : B, E, K, N, kWgBK);
  if (err == cudaSuccess) err = encode_bf16_3d(&mo, out, E, C, N, kWgHalf);
  if (err != cudaSuccess) return err;
  const int sms = wg_sms();
  if (sms < 0) return static_cast<cudaError_t>(-sms);
  const int nt = GATED ? (N + 127) / 128 : (N + 255) / 256;
  const long long most = static_cast<long long>(E) * ((C + 2 * kWgHalf - 1) / (2 * kWgHalf)) * nt;  // every row live
  if (most > (1 << 30)) return cudaErrorInvalidValue;
  const WgArgs args{static_cast<bf16*>(out), rows, E, C, K, N, nt};
  kernel<<<static_cast<unsigned>(std::min<long long>(most, sms)), kWgThreads, WgSmem<GATED>::bytes(E), stream>>>(
      args, ma, mb, mbg, mo);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "decode": the decode step's route, bf16, K and N multiples of 64, C <= 16.
//
// Bound by bytes: the call needs only the weights of the experts that hold a
// row.  One block of 8 warps per (column tile, expert): 32 columns of W1 and
// of Wg (gate-up) or 64 of W2 (down).  A block whose expert holds no row
// stores its zeros (down) and exits without reading a weight; the others
// stream their columns once, in stages of 64 along K, through a 4-deep
// cp.async ring (16-byte copies, each row of a stage 64 or 128 contiguous
// bytes), beside the stage's 16 rows of A (zero past R).  Warp w multiplies
// the stage's 16-deep step w % 4 with mma.sync m16n8k16 (B through
// ldmatrix.trans) into 16 x 32 partial sums: of W1 or Wg (gate-up), or of
// one 32-column half (down).  At the end the four partial sums of each are
// added in a fixed order through shared memory.  At the served step (29
// experts with a row) that is 696 gate-up blocks and 928 down blocks, enough
// to keep all SMs' loads in flight.
// ---------------------------------------------------------------------------

constexpr int kDecRows = 16;     // rows of the row tile: mma.sync's M
constexpr int kDecBK = 64;       // depth of a stage
constexpr int kDecStages = 4;  // 3, 6 and 8 measured the same (PERF.md)
constexpr int kDecThreads = 256;
constexpr int kDecARow = kDecBK + 8;  // A row stride in bf16 (144 bytes: conflict-free fragment loads)

template <bool GATED>
struct DecLayout {
  static constexpr int kCols = GATED ? 32 : 64;        // columns of the block's output tile
  static constexpr int kBRow = kCols + 8;              // B row stride in bf16 (80 or 144 bytes)
  static constexpr int kMats = GATED ? 2 : 1;
  static constexpr int kA = kDecRows * kDecARow;       // bf16 of a stage's A
  static constexpr int kB = kDecBK * kBRow;            // bf16 of a stage's B (each matrix)
  static constexpr int kStage = kA + kMats * kB;       // bf16
  static constexpr int kSmem = kDecStages * kStage * 2;
  static_assert(kSmem >= 8 * kDecRows * 32 * 4, "the partial sums fit in the ring");
};

template <bool GATED>
__device__ __forceinline__ void dec_stage(bf16* st, const bf16* A, const bf16* B, const bf16* Bg, int R, int k0, int n0,
                                          int K, int N) {
  using L = DecLayout<GATED>;
  if (threadIdx.x < kDecRows * (kDecBK / 8)) {
    const int r = threadIdx.x / (kDecBK / 8), kc = (threadIdx.x % (kDecBK / 8)) * 8;
    const bool in = r < R;  // rows past R are zeros, and never read past the expert's C rows
    cp_async16(st + r * kDecARow + kc, in ? A + static_cast<size_t>(r) * K + k0 + kc : A, in);
  }
  constexpr int kChunks = kDecBK * (L::kCols / 8);
  for (int c = threadIdx.x; c < L::kMats * kChunks; c += kDecThreads) {
    const int j = c / kChunks, cc = c % kChunks;
    const int r = cc / (L::kCols / 8), nc = (cc % (L::kCols / 8)) * 8;
    cp_async16(st + L::kA + j * L::kB + r * L::kBRow + nc, (j ? Bg : B) + static_cast<size_t>(k0 + r) * N + n0 + nc,
               true);
  }
}

template <bool GATED>
__global__ void __launch_bounds__(kDecThreads)
moe_dec_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, const bf16* __restrict__ Bg,
               bf16* __restrict__ out, const int* __restrict__ rows, int C, int K, int N) {
  using L = DecLayout<GATED>;
  extern __shared__ __align__(16) unsigned char dec_raw[];
  bf16* ring = reinterpret_cast<bf16*>(dec_raw);
  const int e = blockIdx.y, n0 = blockIdx.x * L::kCols;
  const int R = live_rows(rows, e, C);
  out += static_cast<size_t>(e) * C * N;
  if (R == 0) {  // no row holds a slot: the down product's zeros, and no weight read
    if constexpr (!GATED)
      for (int i = threadIdx.x; i < C * (L::kCols / 8); i += kDecThreads)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(i / (L::kCols / 8)) * N + n0 + 8 * (i % (L::kCols / 8))) =
            make_uint4(0, 0, 0, 0);
    return;
  }
  A += static_cast<size_t>(e) * C * K;
  B += static_cast<size_t>(e) * K * N;
  if constexpr (GATED) Bg += static_cast<size_t>(e) * K * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int kk = warp % 4, part = warp / 4;  // the stage's 16-deep step; W1 or Wg (gate-up), column half (down)
  const int KT = K / kDecBK;

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < KT) dec_stage<GATED>(ring + s * L::kStage, A, B, Bg, R, s * kDecBK, n0, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();
    const int next = kt + kDecStages - 1;
    if (next < KT) dec_stage<GATED>(ring + (next % kDecStages) * L::kStage, A, B, Bg, R, next * kDecBK, n0, K, N);
    cp_async_commit();
    const bf16* st = ring + (kt % kDecStages) * L::kStage;
    const bf16* arow = st + g * kDecARow + 16 * kk + 2 * t;
    unsigned a[4];
    a[0] = *reinterpret_cast<const unsigned*>(arow);
    a[1] = *reinterpret_cast<const unsigned*>(arow + 8 * kDecARow);
    a[2] = *reinterpret_cast<const unsigned*>(arow + 8);
    a[3] = *reinterpret_cast<const unsigned*>(arow + 8 * kDecARow + 8);
    const bf16* brow = st + L::kA + (GATED ? part * L::kB : 32 * part) + (16 * kk + (lane & 15)) * L::kBRow +
                       8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < 4; n += 2) {
      unsigned b[4];
      ldmatrix_x4_trans(b, brow + 8 * n);
      mma_bf16_16816(acc[n], a, b[0], b[1]);
      mma_bf16_16816(acc[n + 1], a, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial sums now

  float* red = reinterpret_cast<float*>(dec_raw);  // [8 warps][16 rows][32 columns]
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float* p = red + (warp * kDecRows + g) * 32 + 8 * n + 2 * t;
    p[0] = acc[n][0];
    p[1] = acc[n][1];
    p[8 * 32] = acc[n][2];
    p[8 * 32 + 1] = acc[n][3];
  }
  __syncthreads();
  const auto sum4 = [&](int first, int r, int c) {  // the four steps' partial sums, in order
    const float* p = red + (first * kDecRows + r) * 32 + c;
    return ((p[0] + p[kDecRows * 32]) + p[2 * kDecRows * 32]) + p[3 * kDecRows * 32];
  };
  for (int i = threadIdx.x; i < kDecRows * L::kCols / 2; i += kDecThreads) {
    const int r = i / (L::kCols / 2), c = 2 * (i % (L::kCols / 2));
    unsigned v;
    if constexpr (GATED) {
      if (r >= R) continue;  // h's rows past R are never written
      v = pack_bf16(silu(sum4(0, r, c)) * sum4(4, r, c), silu(sum4(0, r, c + 1)) * sum4(4, r, c + 1));
    } else {
      if (r >= C) continue;
      const int half = c / 32, hc = c % 32;
      v = r < R ? pack_bf16(sum4(4 * half, r, hc), sum4(4 * half, r, hc + 1)) : 0u;
    }
    *reinterpret_cast<unsigned*>(out + static_cast<size_t>(r) * N + n0 + c) = v;
  }
}

template <bool GATED>
cudaError_t launch_dec(const void* A, const void* B, const void* Bg, void* out, const int* rows, int E, int C, int K,
                       int N, cudaStream_t stream) {
  using L = DecLayout<GATED>;
  const auto kernel = moe_dec_kernel<GATED>;
  static bool raised = false;  // above 48 KB of shared memory: raised once (every device takes the same)
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const dim3 grid(N / L::kCols, E);
  kernel<<<grid, kDecThreads, L::kSmem, stream>>>(static_cast<const bf16*>(A), static_cast<const bf16*>(B),
                                                  static_cast<const bf16*>(Bg), static_cast<bf16*>(out), rows, C, K, N);
  return cudaGetLastError();
}

template <bool GATED>
cudaError_t launch_mma(const void* A, const void* B, const void* Bg, void* out, const int* rows, int E, int M, int K,
                       int N, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
  moe_mma_kernel<GATED><<<grid, kMmaThreads, 0, stream>>>(static_cast<const bf16*>(A), static_cast<const bf16*>(B),
                                                          static_cast<const bf16*>(Bg), static_cast<bf16*>(out), rows,
                                                          M, K, N);
  return cudaGetLastError();
}

template <typename TA, typename TB, typename TO, bool GATED>
cudaError_t launch_fma(const void* A, const void* B, const void* Bg, void* out, const int* rows, int E, int M, int K,
                       int N, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
  moe_fma_kernel<TA, TB, TO, GATED><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), static_cast<const TB*>(Bg), static_cast<TO*>(out), rows,
      M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [E,C,d], w1/wg [E,d,F], w2 [E,F,d], out [E,C,d], all of dtype (0 =
// float32, 1 = bfloat16), contiguous and 16-byte aligned; h [E,C,F] is
// scratch, fp32 on route 0 and bf16 on the others; rows is int32 [E] on the
// device, or null (every row holds a slot).  route 0 = "fma" (any dtype and
// width), 1 = "mma" (bf16, d and F multiples of 8), 2 = "wgmma" (bf16, d and
// F multiples of 64, E <= 256), 3 = "decode" (bf16, d and F multiples of 64,
// C <= 16); a route that does not fit the inputs is refused
// (cudaErrorInvalidValue), never replaced.  Two launches on `stream`:
// gate-up into h, then down into out.  Returns the cudaError_t of the
// launches (0 = both launched).
int moe_gemm_forward(const void* x, const void* w1, const void* wg, const void* w2, void* h, void* out, const int* rows,
                     int E, int C, int d, int F, int dtype, int route, void* stream) {
  if (E < 1 || C < 1 || d < 1 || F < 1 || E > 65535 || (C + kTile - 1) / kTile > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w64 = dtype == 1 && d % 64 == 0 && F % 64 == 0;
  cudaError_t err;
  switch (route) {
    case 0:
      if (dtype == 0) {
        err = launch_fma<float, float, float, true>(x, w1, wg, h, rows, E, C, d, F, st);
        if (err == cudaSuccess) err = launch_fma<float, float, float, false>(h, w2, nullptr, out, rows, E, C, F, d, st);
      } else {
        err = launch_fma<bf16, bf16, float, true>(x, w1, wg, h, rows, E, C, d, F, st);
        if (err == cudaSuccess) err = launch_fma<float, bf16, bf16, false>(h, w2, nullptr, out, rows, E, C, F, d, st);
      }
      return static_cast<int>(err);
    case 1:
      if (dtype != 1 || d % 8 || F % 8) return cudaErrorInvalidValue;
      err = launch_mma<true>(x, w1, wg, h, rows, E, C, d, F, st);
      if (err == cudaSuccess) err = launch_mma<false>(h, w2, nullptr, out, rows, E, C, F, d, st);
      return static_cast<int>(err);
    case 2:
      if (!w64 || E > kWgMaxExperts) return cudaErrorInvalidValue;
      err = launch_wg<true>(x, w1, wg, h, rows, E, C, d, F, st);
      if (err == cudaSuccess) err = launch_wg<false>(h, w2, nullptr, out, rows, E, C, F, d, st);
      return static_cast<int>(err);
    case 3:
      if (!w64 || C > kDecRows) return cudaErrorInvalidValue;
      err = launch_dec<true>(x, w1, wg, h, rows, E, C, d, F, st);
      if (err == cudaSuccess) err = launch_dec<false>(h, w2, nullptr, out, rows, E, C, F, d, st);
      return static_cast<int>(err);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* moe_gemm_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
