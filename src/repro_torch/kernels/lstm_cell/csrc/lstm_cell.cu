// Fused LSTM cell for Hopper, sm_90a.
//
//   gates = x Wx + h Wh + b                       (fp32 sums)
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g)
//   h'    = sigmoid(o) tanh(c')
//
// Replaces repro/kernels/lstm_cell/kernel.py::_lstm_kernel (the Pallas TPU
// kernel).  x [B,In], h [B,Hin], c [B,H], Wx [In,4,H], Wh [Hin,4,H], b [4,H];
// h' [B,H] is written in h's dtype and c' in c's.  H = Hin is the whole cell;
// H < Hin is a column shard of a cell of Hin units (the tensor-parallel
// backbone's): the TPU kernel's own column tile, h read whole, the gates and
// the state of H units computed.  A shard's output equals the same columns of
// the whole cell's bit for bit: the depth [x | h] is walked in the same order.  The gate pre-activations [B,4,H] never
// reach device memory: the nonlinearities and the state update run in the
// same launch, which is the point of the TPU kernel.  Two kernels behind two
// entry points; the wrapper (ops.py) picks one and counts it.
//
// 1. Tensor cores (lstm_cell_mma_kernel), the model's feed: x bf16, the
//    weights bf16 (cast from the fp32 masters and packed once per layer
//    call, not per timestep), h and c fp32 carries; In and H multiples of 8.
//
//    What bounds it on an H100: at the training shape (B = 64, In = H =
//    1024) one call must read the bf16 weights once, 4 (In + H) H 2 B =
//    16.8 MB, plus x, h, c, b and the two outputs, 18.0 MB in all: 5.4 us at
//    3.35 TB/s.  Its 1.07 GFLOP take 1.1 us on the tensor cores, so it is
//    bound by bytes, and the design is a weight stream:
//    * a block owns 16 hidden units (64 gate columns: wgmma's N) and 64
//      batch rows (wgmma's M); a cluster of kSplit = 2 blocks splits the
//      depth [x | h] of one tile, in shares of equal bytes, so H = 1024
//      gives 128 blocks for the 132 SMs and each block reads only its share
//      of x and h (all blocks re-read the activations from L2);
//    * one thread of warp 4 feeds a ring of kStages chunks of 64 along the
//      depth through TMA: the chunk's weight tile as one 8 KB bulk copy (the
//      packing, ops.py::pack_weights, lays each tile out in global memory as
//      the kernel reads it: K-major, 128B-swizzled, zero-padded) and the
//      activation tile as 2-D tensor copies (128B-swizzled, zero past B, In
//      and H); mbarriers count the bytes in and the slots out.  The per-
//      thread cp.async of an earlier design reached about 25 GB/s per SM,
//      and one bulk copy per activation row cost about 50 ns a request;
//    * warpgroup 0 multiplies with wgmma m64n64k16, B from the swizzled
//      weight tile, A from registers: x as it is, and h, taken in fp32, split
//      into h_hi + h_lo (two bf16 terms, each multiplied against the same
//      weights).  Every product is then exact bf16 x bf16 in fp32 and h is
//      kept to about 2^-17 of itself, so the result stays within a few 1e-6
//      of the plain version on the same inputs (rounding h to bf16 alone
//      moves h' by about 3e-3).  Chunk i's wgmma run while chunk i+1's
//      fragments load;
//    * each block sends the partial gate sums of the granule (8 units) that
//      the other block of its cluster finishes through distributed shared
//      memory; the owner adds them, adds b and runs the state update, each
//      thread on the (row, unit) pairs whose four gate sums its wgmma
//      accumulators hold, with c and b loaded before the main loop.
//    What is left between it and the bound (PERF.md): a launch that does no
//    work costs about 6 us in a run of calls (the launch, the epilogue's
//    stores, the cluster exchange and the ring's per-chunk handshakes), and
//    with a cold L2 the weights stream at about 2.2-2.4 TB/s.
//
// 2. fp32 FMA (lstm_cell_kernel), every other feed: fp32 weights (the fp32
//    training feed, whose products must stay fp32 to meet the harness's
//    1e-5 tolerance), the JAX layout's bf16 weights at widths that are not
//    multiples of 8, any B, In, H, each of the six inputs fp32 or bf16 on its
//    own (the TPU kernel's astype(float32) on every load).  One block per 8
//    hidden units and 64 batch rows walks the depth in 64-deep chunks, first
//    over [x | Wx], then over [h | Wh], with one chunk's loads in flight in
//    registers; each thread holds a 4-row x 2-column tile of the gate sums.
//    With fp32 weights one call reads 33.5 MB (10 us) and its flops take
//    16 us at the 67 TFLOP/s fp32 FMA rate.
//
// Sums run in a fixed order in both kernels, so results do not change
// between runs.  kStages and kSplit are the measured choice
// (tools/lstm_cell_variants.py builds copies with other values).

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time, so nothing links the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
  int B, In, Hin, H;  // h is [B,Hin]; the cell computes H units
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
  accumulate(static_cast<const TH*>(a.h), static_cast<const TWH*>(a.wh), a.Hin, a.B, a.H, r0, j0, acc, As, Ws);

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

// ---------------------------------------------------------------------------
// Tensor-core kernel: x bf16, packed bf16 weights, h fp32 (split in two bf16
// terms) or bf16; c and b fp32 or bf16.  See the note at the top.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 128;               // warpgroup 0 multiplies: warp w owns batch rows 16 w .. 16 w + 15
constexpr int kMmaThreads = kConsumers + 32;  // warp 4 stages the chunks
constexpr int kGranUnits = 8;                 // hidden units per granule of the packed weights
constexpr int kTileGrans = 2;                 // granules per block: 16 units
constexpr int kTileCols = 4 * kGranUnits * kTileGrans;  // their 64 gate columns: wgmma's N
constexpr int kMmaRows = 64;                  // batch rows per block: wgmma's M
constexpr int kKC = 64;                       // depth of one staged chunk: a 128-byte row of bf16 weights
constexpr int kStages = 6;                    // chunks in the ring
constexpr int kSplit = 2;                     // blocks of a cluster, each on its share of the depth
constexpr int kWBytes = kTileCols * kKC * 2;  // a weight tile [64 columns][64 depth], 128B-swizzled rows
constexpr int kActBytes = kMmaRows * kKC * 4;    // room for the larger (fp32) activation tile: two of [64][32]
constexpr int kStageBytes = kWBytes + kActBytes;  // a multiple of 1024: every tile stays 1024-aligned
constexpr int kRecvFloats = 4 * 16 * 32;      // one sender's partial sums of a granule: [warp][16][lane]
constexpr size_t kMmaSmem = 1024 + static_cast<size_t>(kStages) * kStageBytes +
                            static_cast<size_t>(kSplit - 1) * kRecvFloats * 4 +
                            2 * kStages * sizeof(uint64_t);  // + 1024 to align the ring; the slots' barriers
static_assert(kStages >= 2 && (kSplit == 1 || kTileGrans <= kSplit), "a block of a cluster finishes at most one granule");
static_assert(kStageBytes % 1024 == 0 && kWBytes % 1024 == 0, "the 128B swizzle needs 1024-byte aligned tiles");
static_assert(kMmaSmem <= 232448, "the ring fits in a block's shared memory");

__device__ __forceinline__ unsigned smem_u32(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrives on `bar` and adds `bytes` to the bytes its phase waits for
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// a TMA copy of the box at (column c, row r) of a 2-D tensor map, counted off `bar`
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_u32(bar))
      : "memory");
}
// a TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) that counts them off `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// v = hi + lo, each a pair of bf16 (the low half holds v.x): hi rounds v, lo rounds what hi missed
__device__ __forceinline__ void split_bf16(float2 v, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v.x - hf.x, v.y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// wgmma's shared-memory descriptor of a K-major bf16 tile whose 128-byte rows
// are 128B-swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)), 8-row
// groups 1024 bytes apart; `addr` is the tile's first row, plus 32 bytes per
// 16-deep step along K.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Pins a register's value at this point of the program, so that the compiler
// neither moves its computation past a wgmma fence nor copies it while a
// wgmma reads it (which would make it serialise the wgmma).
__device__ __forceinline__ void pin(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// d[64 x 64] += a[64 x 16] . B[16 x 64]: a from registers (this warp's 16
// rows, as mma.sync's A fragment), B K-major from shared memory; fp32 sums.
// d[4 j + e]: e = 0, 1 (row g, columns 8 j + 2 t, + 1), e = 2, 3 (row g + 8, ..).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// the shared::cluster address of `p` (in this block's shared memory) in block `rank` of the cluster
__device__ __forceinline__ unsigned map_to_rank(const void* p, unsigned rank) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

struct MmaArgs {
  const bf16 *x, *w;      // x [B,In]; w packed [H/16][In/64 + Hin/64][64][64] (rounded up)
  const void *h, *c, *b;  // h [B,Hin] of TH; c [B,H], b [4,H] fp32 or bf16
  void *h_out, *c_out;
  int B, In, Hin, H;
  int c_bf16, b_bf16;
};

// Depth chunk q of the walk over [x | h]: chunks 0 .. nx-1 cover x's In
// columns, nx .. cover h's Hin, kKC each.  One thread stages the block's weight
// tile of the chunk (a bulk copy: the packing laid it out as the kernel reads
// it, zero past In, H and the last unit) and the activation tile of rows
// r0 .. r0 + 63 (tensor copies, 128B-swizzled, zero past B and the depth):
// x or bf16 h as one [64 rows][64] box, fp32 h as two [64 rows][32] boxes.
template <typename TH>
__device__ __forceinline__ void mma_stage(unsigned char* st, const MmaArgs& a, const CUtensorMap* tx,
                                          const CUtensorMap* th, int tile, int r0, int q, int nx, uint64_t* bar) {
  const bool is_h = q >= nx;
  const int k0 = (is_h ? q - nx : q) * kKC;
  const bool f32 = is_h && sizeof(TH) == 4;
  mbar_expect_bytes(bar, kWBytes + (f32 ? 2 : 1) * kMmaRows * kKC * 2);
  bulk_copy(st, a.w + (static_cast<size_t>(tile) * (nx + ceil_div(a.Hin, kKC)) + q) * (kWBytes / 2), kWBytes, bar);
  tensor_copy(st + kWBytes, is_h ? th : tx, k0, r0, bar);
  if (f32) tensor_copy(st + kWBytes + kMmaRows * 128, th, k0 + 32, r0, bar);
}

// The first chunk of rank r's share of the walk: the ranks get equal shares of
// the bytes staged, 2 units (8 KB of weights, 8 of x) for an x chunk and 3
// for an fp32 h chunk (16 KB of h), so the rank on h is not the straggler.
template <typename TH>
__device__ __forceinline__ int split_point(unsigned r, int nx, int nh) {
  constexpr int cx = 2, ch = sizeof(TH) == 4 ? 3 : 2;
  const int target = static_cast<int>(r) * (cx * nx + ch * nh) / kSplit;
  return target <= cx * nx ? ceil_div(target, cx) : nx + ceil_div(target - cx * nx, ch);
}

// The A fragments of a staged chunk's 4 steps of 16 along the depth: step kk
// holds [0] (row g, k 2t..2t+1), [1] (row g + 8, ..), [2] (row g, k 2t+8..),
// [3] (row g + 8, ..) of this warp's rows, read from 128-byte rows whose
// 16-byte group j lies at j ^ (row % 8) (rows g and g + 8 share the XOR).
// With SPLIT (an fp32 h tile) hi + lo is h; otherwise hi is x (or bf16 h).
template <bool SPLIT>
__device__ __forceinline__ void load_frags(const unsigned char* st, unsigned (&hi)[kKC / 16][4],
                                           unsigned (&lo)[kKC / 16][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // the fragments' groupID and thread-in-group
  const unsigned char* act = st + kWBytes;
  const int r = 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk) {
    if constexpr (SPLIT) {  // fp32 tile: [2 halves][64 rows][32], 4 values a group
      const unsigned char* half = act + (kk / 2) * kMmaRows * 128 + r * 128 + (t & 1) * 8;
      const int j = 4 * (kk & 1) + (t >> 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(half + (q & 1) * 8 * 128 + (((j + 2 * (q >> 1)) ^ (g & 7)) << 4));
        split_bf16(v, hi[kk][q], lo[kk][q]);
      }
    } else {  // bf16 tile: [64 rows][64], 8 values a group
      const unsigned char* row = act + r * 128 + 4 * t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hi[kk][q] = *reinterpret_cast<const unsigned*>(row + (q & 1) * 8 * 128 + (((2 * kk + (q >> 1)) ^ (g & 7)) << 4));
    }
  }
}

// d += a staged chunk's products, issued and committed as one wgmma group of
// 4 (or with SPLIT 8: h_hi and h_lo against the same weights), unbranched.
template <bool SPLIT>
__device__ __forceinline__ void issue_chunk(const unsigned char* st, unsigned (&hi)[kKC / 16][4],
                                            unsigned (&lo)[kKC / 16][4], float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pin(hi[kk][r]);
      if constexpr (SPLIT) pin(lo[kk][r]);
    }
#pragma unroll
  for (int i = 0; i < 32; ++i) pin(d[i]);
  wgmma_fence();
  const unsigned wtile = smem_u32(st);
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk) {
    const uint64_t desc = sw128_desc(wtile + 32 * kk);
    wgmma_64x64x16(d, hi[kk], desc);
    if constexpr (SPLIT) wgmma_64x64x16(d, lo[kk], desc);
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[32]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) pin(d[i]);
}

// The multiplying warpgroup over the chunks i0 .. i1-1 of its walk (slot
// i % kStages), all of one kind: chunk i's wgmma run while chunk i+1's
// fragments load, into the other of two register buffers; a slot is
// released once the wgmma that read it are done.
template <bool SPLIT>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty, int i0, int i1,
                                        float (&d)[32]) {
  if (i0 >= i1) return;
  unsigned hi[2][kKC / 16][4], lo[2][kKC / 16][4];
  const auto slot = [&](int i) { return smem + (i % kStages) * kStageBytes; };
  const auto ready = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  ready(i0);
  load_frags<SPLIT>(slot(i0), hi[0], lo[0]);
  for (int i = i0; i < i1; i += 2) {
    issue_chunk<SPLIT>(slot(i), hi[0], lo[0], d);
    if (i > i0) {
      wgmma_wait<1>(d);  // chunk i - 1's wgmma are done
      mbar_arrive(&empty[(i - 1) % kStages]);
    }
    if (i + 1 < i1) {
      ready(i + 1);
      load_frags<SPLIT>(slot(i + 1), hi[1], lo[1]);
      issue_chunk<SPLIT>(slot(i + 1), hi[1], lo[1], d);
      wgmma_wait<1>(d);  // chunk i's
      mbar_arrive(&empty[i % kStages]);
      if (i + 2 < i1) {
        ready(i + 2);
        load_frags<SPLIT>(slot(i + 2), hi[0], lo[0]);
      }
    }
  }
  wgmma_wait<0>(d);
  mbar_arrive(&empty[(i1 - 1) % kStages]);
}

template <typename TH>
__global__ void __launch_bounds__(kMmaThreads, 1)
    lstm_cell_mma_kernel(MmaArgs a, const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap th) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* recv = reinterpret_cast<float*>(smem + static_cast<size_t>(kStages) * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + (kSplit - 1) * kRecvFloats);  // slot s holds its chunk
  uint64_t* empty = full + kStages;                                                 // slot s may be refilled
  const unsigned rank = kSplit > 1 ? cluster_rank() : 0;
  if constexpr (kSplit > 1) cluster_arrive_relaxed();  // this block has started; waited on before any remote store
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int tile = blockIdx.x / kSplit, r0 = blockIdx.y * kMmaRows, g0 = tile * kTileGrans;
  __syncthreads();
  const int nx = ceil_div(a.In, kKC), nh = ceil_div(a.Hin, kKC);
  const int q0 = split_point<TH>(rank, nx, nh), n = split_point<TH>(rank + 1, nx, nh) - q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;

  // the state update's inputs, loaded now so that their latency hides under the products:
  // c and b of the units j, j + 1 of each granule this block finishes, rows 16 warp + g (+ 8)
  float c_prev[kTileGrans][2][2], bias[kTileGrans][4][2];
#pragma unroll
  for (int gl = 0; gl < kTileGrans; ++gl) {
    const int j = (g0 + gl) * kGranUnits + 2 * t;
    const bool mine = threadIdx.x < kConsumers && (kSplit == 1 || gl % kSplit == static_cast<int>(rank)) && j < a.H;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        bias[gl][gate][u] = mine ? load_any(a.b, static_cast<size_t>(gate) * a.H + j + u, a.b_bf16) : 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + 16 * warp + g + 8 * hr;
        c_prev[gl][hr][u] = mine && r < a.B ? load_any(a.c, static_cast<size_t>(r) * a.H + j + u, a.c_bf16) : 0.f;
      }
    }
  }

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  if (threadIdx.x >= kConsumers) {
    // one thread of warp 4: chunk i into slot i % kStages once the consumers have released it
    if (threadIdx.x == kConsumers)
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mma_stage<TH>(smem + s * kStageBytes, a, &tx, &th, tile, r0, q0 + i, nx, &full[s]);
      }
  } else {  // the x chunks of the walk, then the h chunks
    const int nxr = max(0, min(n, nx - q0));
    consume<false>(smem, full, empty, 0, nxr, d);
    consume<sizeof(TH) == 4>(smem, full, empty, nxr, n, d);
  }

  if constexpr (kSplit > 1) {
    // granule gl (d[16 gl ..]) is finished by block gl % kSplit of the cluster; every other
    // block sends it its partial sums, into slot (sender rank, skipping the owner's) of the
    // owner's buffer
    cluster_wait();  // every block of the cluster has started
#pragma unroll
    for (int gl = 0; gl < kTileGrans; ++gl) {
      const unsigned owner = gl % kSplit;
      if (owner == rank || threadIdx.x >= kConsumers) continue;
      const unsigned slot = rank < owner ? rank : rank - 1;
      const unsigned dst = map_to_rank(recv + (slot * 4 + warp) * 16 * 32 + lane, owner);
#pragma unroll
      for (int v = 0; v < 16; ++v) st_cluster(dst + 4 * 32 * v, d[16 * gl + v]);
    }
    cluster_arrive();
    cluster_wait();  // every partial sum has landed
    if (threadIdx.x >= kConsumers) return;
#pragma unroll
    for (int gl = 0; gl < kTileGrans; ++gl) {
      if (gl % kSplit != static_cast<int>(rank)) continue;
      for (int slot = 0; slot < kSplit - 1; ++slot) {
        const float* src = recv + (slot * 4 + warp) * 16 * 32 + lane;
#pragma unroll
        for (int v = 0; v < 16; ++v) d[16 * gl + v] += src[32 * v];
      }
    }
  }

  if (threadIdx.x >= kConsumers) return;
#pragma unroll
  for (int gl = 0; gl < kTileGrans; ++gl) {
    const int j = (g0 + gl) * kGranUnits + 2 * t;  // this thread's units j, j + 1
    // another block's granule, or one past H (H is a multiple of 8: granules are whole)
    if ((kSplit > 1 && gl % kSplit != static_cast<int>(rank)) || j >= a.H) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 16 * warp + g + 8 * hr;
      if (r >= a.B) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* gs = d + 16 * gl + 2 * hr + u;  // gate q's sum is gs[4 q]
        const float* bs = bias[gl][0] + u;           // gate q's bias is bs[2 q]
        const size_t o = static_cast<size_t>(r) * a.H + j + u;
        const float c_new =
            sigmoid(gs[4] + bs[2]) * c_prev[gl][hr][u] + sigmoid(gs[0] + bs[0]) * tanhf(gs[8] + bs[4]);
        const float h_new = sigmoid(gs[12] + bs[6]) * tanhf(c_new);
        store_any(a.c_out, o, c_new, a.c_bf16);
        static_cast<TH*>(a.h_out)[o] = from_f<TH>(h_new);
      }
    }
  }
}

// The launch of the tensor-core kernel for a [B, In] x [In + H, 4H] call: one
// block per 64 rows and 16 units for each of the kSplit blocks of a cluster.
template <typename TH>
cudaError_t mma_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B, int H, cudaStream_t stream) {
  const auto kernel = lstm_cell_mma_kernel<TH>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool ready[64] = {};  // the shared-memory limit is raised once per device
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMmaSmem));
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(ceil_div(H, kTileGrans * kGranUnits) * kSplit, ceil_div(B, kMmaRows));
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = kMmaSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  return cudaSuccess;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime (null if absent).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major [rows, cols] matrix (cols x esize a multiple of 16) read in
// [64 rows][128 bytes] boxes, 128B-swizzled, zero past its edges.
cudaError_t encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int esize) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize), kMmaRows}, ones[2] = {1, 1};
  const CUresult r = encode(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TH>
cudaError_t launch_mma(const MmaArgs& a, cudaStream_t stream) {
  CUtensorMap tx, th;
  cudaError_t err = encode_rows(&tx, a.x, a.B, a.In, 2);
  if (err == cudaSuccess) err = encode_rows(&th, a.h, a.B, a.Hin, sizeof(TH));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (err == cudaSuccess) err = mma_config<TH>(cfg, attr, a.B, a.H, stream);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, lstm_cell_mma_kernel<TH>, a, tx, th);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// The FMA kernel.  dtypes: codes of x, h, c, Wx, Wh, b (0 = float32,
// 1 = bfloat16); h [B,Hin], c [B,H], Wx [In,4,H] and Wh [Hin,4,H] in the JAX
// layout; h_out [B,H] has h's dtype and c_out c's.  Returns the cudaError_t of
// the launch (0 = launched).
int lstm_cell_forward(const void* x, const void* h, const void* c, const void* wx, const void* wh, const void* b,
                      void* h_out, void* c_out, int B, int In, int Hin, int H, int x_dt, int h_dt, int c_dt,
                      int wx_dt, int wh_dt, int b_dt, void* stream) {
  if (B < 1 || In < 1 || Hin < 1 || H < 1 || c_dt < 0 || c_dt > 1 || b_dt < 0 || b_dt > 1)
    return cudaErrorInvalidValue;
  const Args a{x, h, c, wx, wh, b, h_out, c_out, B, In, Hin, H, c_dt, b_dt};
  const int codes[4] = {x_dt, h_dt, wx_dt, wh_dt};
  return dispatch<>(codes, a, static_cast<cudaStream_t>(stream));
}

// The tensor-core kernel.  x [B,In] bf16; w the packed bf16 weights
// [H/16][In/64 + Hin/64][64][64]; h [B,Hin], c [B,H] and b [4,H] of the codes
// h_dt, c_dt, b_dt; In, Hin and H multiples of 8, every pointer 16-byte
// aligned.  h_out [B,H] has h's dtype and c_out c's.  Returns the cudaError_t
// of the launch (0 = launched).
int lstm_cell_forward_mma(const void* x, const void* h, const void* c, const void* w, const void* b, void* h_out,
                          void* c_out, int B, int In, int Hin, int H, int h_dt, int c_dt, int b_dt, void* stream) {
  if (B < 1 || In < 8 || Hin < 8 || H < 8 || In % 8 || Hin % 8 || H % 8 || ceil_div(B, kMmaRows) > 65535 ||
      h_dt < 0 || h_dt > 1 || c_dt < 0 || c_dt > 1 || b_dt < 0 || b_dt > 1)
    return cudaErrorInvalidValue;
  const MmaArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w), h, c, b, h_out, c_out, B, In, Hin, H,
                  c_dt, b_dt};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return h_dt == 0 ? launch_mma<float>(a, st) : launch_mma<bf16>(a, st);
}

const char* lstm_cell_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
