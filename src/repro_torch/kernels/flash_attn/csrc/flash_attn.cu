// Flash attention forward for Hopper, sm_90a.
//
//   o[bh, i] = sum_j softmax_j(scale * q[bh, i] . k[bh / group, j]) v[bh / group, j]
//
// over the keys j that row i sees: j <= i when causal, j > i - window when a
// window is set (both positions count from 0).  Replaces
// repro/kernels/flash_attn/kernel.py::_flash_kernel (the Pallas TPU kernel):
// q [BH, S, D], k/v [BH / group, T, D], o like q; q, k and v are all fp32 or
// all bf16, o takes their dtype.  Running (max, denom, acc) are fp32; a
// masked score is -1e30, as in the TPU kernel.  Any S and T (ragged tiles
// are masked here, where the TPU kernel needs S and T to divide its blocks)
// and any D up to 128.  A row that sees no key (only when S > T) gets zeros.
//
// What bounds it on an H100: at the serving prefill's per-layer call
// (B = 4, S = T = 2048, 16 q heads on 8 kv heads, D = 128, causal, bf16) the
// call moves 100.7 MB (q, k, v and o once each: 30 us at 3.35 TB/s) against
// 68.7 GFLOP of causal products (69 us at the bf16 tensor-core peak), so it
// is bound by operations.  The wgmma kernel takes about 2.4 times that
// (PERF.md, tools/flash_attn_variants.py's breakdown): its softmax (base-2
// exponentials on the SFU, 16 a clock per SM) does not fully hide under its
// products, and the k/v copies, which the call's blocks read again from L2,
// take on their own two thirds of its time.  Three kernels, one per route;
// the wrapper (ops.py) names the route and the entry point refuses a route
// that does not fit:
//   * "wgmma": bf16 at D = 64 or 128 (the model's path), Hopper's warpgroup
//     tensor cores fed by TMA (flash_fwd_wgmma_kernel, below);
//   * "mma": bf16 at any multiple of 16, mma.sync m16n8k16 on the tensor
//     cores with fp32 accumulation (flash_fwd_mma_kernel);
//   * "fma": fp32, and bf16 at any D, fp32 FMA on the CUDA cores (67 TFLOP/s
//     at best, so at least 1 ms at the shape above), as the fp32 path must
//     meet the harness's 1e-4 tolerance.
//
// All three skip kv tiles wholly above the diagonal or left of the window
// (the TPU kernel's block pruning), schedule q tiles longest first so the
// causal tail does not straggle, and sum in a fixed order, so results do not
// change between runs.
//
// Design of the FMA kernel: one block of 256 threads per (bh, 64-row q
// tile); 4 threads share a q row, each holding a quarter of the row's q
// (pre-scaled) and of its fp32 accumulator in registers, as float4 column
// chunks interleaved so the four threads read neighbouring 16 bytes of
// shared memory.  The block walks the kv sequence in 32-row tiles staged in
// shared memory as fp32: a tile's 32 scores per row stay in registers
// (partial dot products summed over the 4 threads by two shuffles), then
// one rescale of the accumulator per tile.

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time, so nothing links the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBQ = 64;                  // q rows per block
constexpr int kBKV = 32;                 // kv rows per staged tile
constexpr int kTPR = 4;                  // threads per q row
constexpr int kThreads = kBQ * kTPR;     // 256
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// NCH: 16-column chunks of the row (D padded to 16 * NCH with zeros).  Thread
// `sub` of a row owns columns 16 c + 4 sub .. 16 c + 4 sub + 3 for c < NCH.
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                 int S, int Tk, int D, int group, int causal, int window, float scale) {
  constexpr int DP = 16 * NCH;
  constexpr int kRow4 = DP / 4;  // float4s per staged kv row
  __shared__ float4 ks[kBKV * kRow4];
  __shared__ float4 vs[kBKV * kRow4];
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  const int bh = blockIdx.y;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest (causal) tiles start first
  const int row = threadIdx.x / kTPR;
  const int sub = threadIdx.x % kTPR;
  const int qpos = q_start + row;
  const bool live = qpos < S;
  const size_t kv_off = static_cast<size_t>(bh / group) * Tk * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  float qr[NCH][4], acc[NCH][4];
  const T* qrow = q + (static_cast<size_t>(bh) * S + (live ? qpos : 0)) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * c + 4 * sub + e;
      qr[c][e] = (live && col < D) ? to_f(qrow[col]) * scale : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  int hi = (Tk + kBKV - 1) / kBKV;
  if (causal) hi = min(hi, (q_start + kBQ + kBKV - 1) / kBKV);
  const int lo = window > 0 ? max(q_start + 1 - window, 0) / kBKV : 0;

  for (int j = lo; j < hi; ++j) {
    const int t0 = j * kBKV;
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kBKV * DP; e += kThreads) {
      const int r = e / DP, col = e % DP, t = t0 + r;
      const bool in = t < Tk && col < D;
      const size_t g = static_cast<size_t>(t) * D + col;
      ksf[e] = in ? to_f(kb[g]) : 0.f;
      vsf[e] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[kBKV];
    float mt = kNegInf;
#pragma unroll
    for (int r = 0; r < kBKV; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 kk = ks[r * kRow4 + 4 * c + sub];
        part = fmaf(qr[c][0], kk.x, part);
        part = fmaf(qr[c][1], kk.y, part);
        part = fmaf(qr[c][2], kk.z, part);
        part = fmaf(qr[c][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = t0 + r;
      bool keep = kpos < Tk;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      s[r] = keep ? part : kNegInf;
      mt = fmaxf(mt, s[r]);
    }

    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
    }
#pragma unroll
    for (int r = 0; r < kBKV; ++r) {
      const float p = expf(s[r] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 vv = vs[r * kRow4 + 4 * c + sub];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
    m = m_new;
  }

  if (live) {
    T* orow = o + (static_cast<size_t>(bh) * S + qpos) * D;
    const bool seen = m > kNegInf;  // a kept score is finite and far above -1e30
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * c + 4 * sub + e;
        if (col < D) orow[col] = from_f<T>(seen ? acc[c][e] / denom : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (D a multiple of 16): mma.sync m16n8k16, fp32
// accumulators.  One block of 4 warps per (bh, 64-row q tile); each warp owns
// 16 q rows, holds their q as mma A fragments for the whole kv walk, and
// keeps the scores of a 64-key tile (8 n-tiles of 8 keys) and its output
// rows (D / 8 n-tiles) in registers.  The score fragments are re-packed to
// bf16 as the A fragments of P . V without leaving registers.  K and V are
// staged as [key][d] with 16-byte loads and stores, each row padded by 8
// bf16 so fragment loads hit distinct banks; V's fragments come transposed
// out of ldmatrix.  The softmax runs in base 2 (scores scaled by log2 e).
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;  // 64 q rows per block
constexpr int kMmaBKV = 64;             // keys per staged tile
constexpr int kMmaPad = 8;              // bf16 of padding per smem row

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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int Tk, int group,
                     int causal, int window, float scale) {
  static_assert(D % 16 == 0 && D <= kMaxD, "D must be a multiple of 16, at most 128");
  constexpr int KS = D / 16;          // k-steps of q . k
  constexpr int NO = D / 8;           // n-tiles of the output
  constexpr int NS = kMmaBKV / 8;     // n-tiles of a score tile
  constexpr int KROW = D + kMmaPad;   // Ks and Vs row stride, in bf16
  static_assert(NO % 2 == 0, "ldmatrix.x4 covers two output n-tiles");
  __shared__ __align__(16) __nv_bfloat16 Ks[kMmaBKV * KROW];
  __shared__ __align__(16) __nv_bfloat16 Vs[kMmaBKV * KROW];
  const float scale2 = scale * 1.4426950408889634f;  // scores in base 2: exp(x) = exp2(x log2 e)

  const int bh = blockIdx.y;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' groupID and thread-in-group
  const int r0 = q_start + warp * 16 + g;  // this thread's two rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const size_t kv_off = static_cast<size_t>(bh / group) * Tk * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

  // q as A fragments: a[0] (r0, 2t..2t+1), a[1] (r1, ..), a[2] (r0, 2t+8..), a[3] (r1, 2t+8..)
  unsigned qa[KS][4];
  {
    const unsigned* q0 = reinterpret_cast<const unsigned*>(q + (static_cast<size_t>(bh) * S + min(r0, S - 1)) * D);
    const unsigned* q1 = reinterpret_cast<const unsigned*>(q + (static_cast<size_t>(bh) * S + min(r1, S - 1)) * D);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = r0 < S ? q0[ks * 8 + t] : 0u;
      qa[ks][1] = r1 < S ? q1[ks * 8 + t] : 0u;
      qa[ks][2] = r0 < S ? q0[ks * 8 + 4 + t] : 0u;
      qa[ks][3] = r1 < S ? q1[ks * 8 + 4 + t] : 0u;
    }
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // per-thread partial denominators

  int hi = (Tk + kMmaBKV - 1) / kMmaBKV;
  if (causal) hi = min(hi, (q_start + kMmaBQ + kMmaBKV - 1) / kMmaBKV);
  const int lo = window > 0 ? max(q_start + 1 - window, 0) / kMmaBKV : 0;

  for (int j = lo; j < hi; ++j) {
    const int t0 = j * kMmaBKV;
    __syncthreads();  // every warp is done with the previous tile
    // stage K and V [key][d]: 16-byte loads and stores, zeros past T
    for (int e = threadIdx.x; e < kMmaBKV * D / 8; e += kMmaThreads) {
      const int r = e / (D / 8), c8 = (e % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (t0 + r < Tk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(t0 + r) * D + c8);
        vv4 = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(t0 + r) * D + c8);
      }
      *reinterpret_cast<uint4*>(Ks + r * KROW + c8) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * KROW + c8) = vv4;
    }
    __syncthreads();

    // scores of this warp's 16 rows x 64 keys: c[0..1] (r0, key 8n+2t..+1), c[2..3] (r1, ..)
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (8 * n + g) * KROW + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + 16 * ks);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(krow + 16 * ks + 8);
        mma_bf16_16816(sc[n], qa[ks], b0, b1);
      }
    }
    float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = t0 + 8 * n + 2 * t + (e & 1);
        const int qpos = e < 2 ? r0 : r1;
        bool keep = kpos < Tk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        sc[n][e] = keep ? sc[n][e] * scale2 : kNegInf;
      }
      mt0 = fmaxf(mt0, fmaxf(sc[n][0], sc[n][1]));
      mt1 = fmaxf(mt1, fmaxf(sc[n][2], sc[n][3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // P . V, 16 keys per k-step: the score n-tiles 2kk and 2kk+1 are its A fragment
#pragma unroll
    for (int kk = 0; kk < kMmaBKV / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][0] = exp2f(sc[2 * kk + h][0] - mn0);
        p[h][1] = exp2f(sc[2 * kk + h][1] - mn0);
        p[h][2] = exp2f(sc[2 * kk + h][2] - mn1);
        p[h][3] = exp2f(sc[2 * kk + h][3] - mn1);
        l0 += p[h][0] + p[h][1];
        l1 += p[h][2] + p[h][3];
      }
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      // lane l addresses key 16 kk + (l & 15), columns 8 n + 8 (l >> 4): the
      // transposed matrices are b0, b1 of n-tile n, then b0, b1 of n-tile n + 1
      const __nv_bfloat16* vrow = Vs + (16 * kk + (lane & 15)) * KROW + 8 * (lane >> 4);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vrow + 8 * n);
        mma_bf16_16816(acc[n], pa, b[0], b[1]);
        mma_bf16_16816(acc[n + 1], pa, b[2], b[3]);
      }
    }
    m0 = mn0;
    m1 = mn1;
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = m0 > kNegInf ? 1.f / fmaxf(l0, 1e-30f) : 0.f;  // a row that saw no key gets zeros
  const float inv1 = m1 > kNegInf ? 1.f / fmaxf(l1, 1e-30f) : 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < S)
      *reinterpret_cast<unsigned*>(o + (static_cast<size_t>(bh) * S + r0) * D + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<unsigned*>(o + (static_cast<size_t>(bh) * S + r1) * D + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int BH, int S, int T_, int group,
                       int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, BH);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T_, group, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, int BH, int S, int T_, int D, int group,
                         int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 32: return launch_mma<32>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 48: return launch_mma<48>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 64: return launch_mma<64>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 80: return launch_mma<80>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 96: return launch_mma<96>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 112: return launch_mma<112>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    case 128: return launch_mma<128>(q, k, v, o, BH, S, T_, group, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper's warpgroup tensor cores (D = 64 or 128): the model's path.
//
// What the mma.sync kernel above lacked, and what this one does about it:
//   * no copy overlapped a product: here one thread of a producer warpgroup
//     keeps TMA copies in flight, q once and then k and v tiles into a ring
//     of kWgStages slots (full and empty mbarriers), while the consumers
//     multiply.  The tensor maps are 3-D ([rows, S or T, D]), so the copy of
//     a tile past S or T is zero-filled and never reads the next row's keys;
//     the 128-byte swizzle caps a box at 64 bf16 columns, so a D = 128 row is
//     two boxes;
//   * the products were mma.sync with each warp re-reading k from shared
//     memory: here S = q k^T is one wgmma m64n{kWgBN}k16 per 16 columns of
//     D, q and k K-major and 128B-swizzled in shared memory, and O += P v a
//     wgmma m64n{D}k16 per 16 keys with P from registers (the accumulator
//     layout of S is the register layout of wgmma's A operand, so P is
//     packed to bf16 without leaving registers) and v, stored [key][d], as
//     an MN-major B (the transpose flag);
//   * the G query heads of one kv head streamed the same k/v tiles in G
//     blocks: here a block's two consumer warpgroups take two query heads of
//     one kv head at the same 64 positions, so one k/v tile in shared memory
//     feeds both (half the k/v traffic at G = 2).  At G = 1 they take 128
//     consecutive positions of one head; at odd G the second warpgroup of
//     the last pair has no head and only keeps in step with the ring;
//   * the mask was computed on every tile: here only tiles that cross the
//     diagonal, the window's left edge or the end of the keys are masked,
//     with one select a score against per-row key limits;
//   * a block per 64 or 128 positions paid its start-up and its stores
//     alone on its SM: here one block per SM walks the work tiles, longest
//     first, and its ring runs on across them, so the producer loads the
//     next tile's q and k/v while the consumers finish and store.
// Within a consumer, tile j's q k^T and tile j-1's P v are issued behind
// one fence and in flight together (o takes tile j-1's correction first, in
// the warps where a row's max rose), and tile j's softmax (base 2, the scale
// folded into one FFMA, ex2.approx) runs under P v.  setmaxnreg moves registers from the producer (24) to the
// consumers (240).  kWgBN and kWgStages are the measured choice
// (tools/flash_attn_variants.py builds copies with other values).
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

#ifndef FLASH_WG_BN
#define FLASH_WG_BN 128
#endif
#ifndef FLASH_WG_STAGES
#define FLASH_WG_STAGES 3
#endif
constexpr int kWgRows = 64;                          // q rows of a consumer warpgroup: wgmma's M
constexpr int kWgConsumers = 2;                      // consumer warpgroups per block
constexpr int kWgThreads = 128 * (kWgConsumers + 1);  // and the producer warpgroup
constexpr int kWgBN = FLASH_WG_BN;                   // keys per k/v tile: the N of q . k^T
constexpr int kWgStages = FLASH_WG_STAGES;           // k/v tiles in the ring
static_assert(kWgBN == 64 || kWgBN == 128, "a k/v tile holds 64 or 128 keys");

// Shared memory: q of each consumer [2][D / 64][64 rows][128 B], then the
// ring's k tiles [stages][D / 64][kWgBN keys][128 B] and v tiles likewise,
// every box 1024-byte aligned (the 128B swizzle's period), then the barriers.
template <int D>
struct WgLayout {
  static constexpr int kQBytes = kWgRows * D * 2;
  static constexpr int kHalf = kWgBN * 128;  // one [kWgBN keys][64 d] box of a k or v tile
  static constexpr int kKVBytes = kWgBN * D * 2;
  static constexpr int kBarOffset = kWgConsumers * kQBytes + 2 * kWgStages * kKVBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + (2 + 3 * kWgStages) * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "the ring fits in a block's shared memory");
};

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
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a TMA copy of the box at (column c, row r, matrix z) of a 3-D tensor map, counted off `bar`
__device__ __forceinline__ void tensor_copy_3d(void* dst, const CUtensorMap* map, int c, int r, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's shared-memory descriptor of a bf16 operand stored as 128-byte rows,
// 128B-swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)), 8-row groups
// 1024 bytes apart (the stride byte offset).  K-major (q, k): a row holds 64
// values along the depth and `addr` moves 32 bytes per 16-deep step; the
// leading byte offset is unused (16).  MN-major (v): a row holds 64 values
// along N, the next 64 along N lie `lbo` bytes on, and 16 keys are 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Pins a register's value at this point of the program, so that the compiler
// neither moves its computation past a wgmma fence nor copies it while a
// wgmma reads it (which would make it serialise the wgmma).
__device__ __forceinline__ void pin(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void pin_all(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(d[i]);
}

// 2^x on the SFU alone, subnormal results flushed to 0 (exp2f adds a
// compare and two multiplies a call to keep them; P is rounded to bf16 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared memory (descriptors); d is
// overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared memory (descriptors); d is
// overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
// d[64 x 64] += a[64 x 16] . B[16 x 64]: a from registers (mma.sync's A fragment of this warp's 16
// rows), B MN-major in shared memory (its N index contiguous: the transpose flag)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// d[64 x 128] += a[64 x 16] . B[16 x 128]: a from registers (mma.sync's A fragment of this warp's 16
// rows), B MN-major in shared memory (its N index contiguous: the transpose flag)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x N] (+)= q[64 x 16] . k[N x 16]^T: both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else wgmma_ss_n128(d, desc_a, desc_b, scale_d);
}
// d[64 x N] += p[64 x 16] . v[16 x N]: p from registers, v MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const unsigned (&a)[4], uint64_t desc_b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

struct WgArgs {
  bf16* o;
  int S, T, group, causal, window;
  float scale2;  // scale * log2(e): the softmax runs in base 2
  int units, work;  // row units (see WgTile) and work tiles: units x position tiles
};

// Work tile w of the call: a unit of rows (at G >= 2 a kv row and a pair of
// its query heads, at G = 1 a query row) and a tile of positions, the tiles
// of all units in order of decreasing position (the longest causal tiles
// first).  Consumer warpgroup i takes query row bh[i] at positions
// q0[i] .. q0[i] + 63: at G >= 2 head 2 p + i of the pair p at the same 64
// positions, so both read one k/v tile; at G = 1 the i-th 64 of 128
// positions.  live[i] is false where it has none (the second head of the
// last pair at odd G, or positions past S at G = 1).  [lo[i], hi[i]) are the
// k/v tiles its rows see, [lo, hi) their union, which the block streams.
struct WgTile {
  int bkv, bh[kWgConsumers], q0[kWgConsumers], lo_w[kWgConsumers], hi_w[kWgConsumers], lo, hi;
  bool live[kWgConsumers];
};

// The k/v tiles [lo, hi) that rows q0 .. q0 + 63 see
__device__ __forceinline__ void wg_tiles(const WgArgs& a, int q0, int& lo, int& hi) {
  hi = (a.T + kWgBN - 1) / kWgBN;
  if (a.causal) hi = min(hi, (q0 + kWgRows + kWgBN - 1) / kWgBN);
  lo = a.window > 0 ? max(q0 + 1 - a.window, 0) / kWgBN : 0;
}

__device__ __forceinline__ WgTile wg_tile(const WgArgs& a, int w) {
  WgTile t;
  const int unit = w % a.units, qt = (a.work - 1 - w) / a.units;  // w = 0 is the last tile of positions
  t.lo = 1 << 30;
  t.hi = 0;
#pragma unroll
  for (int i = 0; i < kWgConsumers; ++i) {
    if (a.group >= 2) {
      const int pairs = (a.group + 1) / 2, head = 2 * (unit % pairs) + i;
      t.bkv = unit / pairs;
      t.bh[i] = t.bkv * a.group + head;
      t.q0[i] = qt * kWgRows;
      t.live[i] = head < a.group;
    } else {
      t.bkv = t.bh[i] = unit;
      t.q0[i] = (qt * kWgConsumers + i) * kWgRows;
      t.live[i] = t.q0[i] < a.S;
    }
    wg_tiles(a, t.q0[i], t.lo_w[i], t.hi_w[i]);
    if (!t.live[i]) t.lo_w[i] = t.hi_w[i] = 0;
    if (t.lo_w[i] < t.hi_w[i]) t.lo = min(t.lo, t.lo_w[i]), t.hi = max(t.hi, t.hi_w[i]);
  }
  if (t.hi <= t.lo) t.lo = t.hi = 0;  // the warpgroups' tiles overlap or touch: no gap
  return t;
}

// One consumer warpgroup's state and steps: its 64 rows' output o and running
// max and denominator (base 2), the scores of the tile in flight (then, in
// place, their exponentials: P in fp32) and, in bf16, P of the tile whose
// P . v is in flight (pa).  Each thread holds rows r0 = q0 + 16 warp + g and
// r1 = r0 + 8; sc[4 n + e] and o[4 n + e] are (row r0 for e < 2 else r1,
// column 8 n + 2 t + (e & 1)).  P is packed into pa only once the P . v that
// reads pa is done: ptxas does not see the pins, and would otherwise give the
// new P the registers of the old one (dead to it after the wgmma issued) and
// then serialise every wgmma of the kernel to stay right.
template <int D>
struct WgConsumer {
  using L = WgLayout<D>;
  float o[D / 2], sc[kWgBN / 2];
  unsigned pa[kWgBN / 16][4];
  float m0, m1, l0, l1, c0, c1;  // running max (scaled scores) and per-thread partial denominators; corrections
  WgArgs a;
  int bh, q0, r0, r1, t;
  unsigned q_addr, k_addr, v_addr;

  __device__ __forceinline__ void init(const WgArgs& args, int bh_, int q0_, unsigned q, unsigned k, unsigned v) {
    a = args;
    bh = bh_;
    q0 = q0_;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    t = lane & 3;
    r0 = q0 + 16 * warp + (lane >> 2);
    r1 = r0 + 8;
    q_addr = q;
    k_addr = k;
    v_addr = v;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
  }

  // the ring's i-th tile has landed
  __device__ __forceinline__ void wait_k(uint64_t* fullk, int i) { mbar_wait(&fullk[i % kWgStages], (i / kWgStages) & 1); }
  __device__ __forceinline__ void wait_v(uint64_t* fullv, int i) { mbar_wait(&fullv[i % kWgStages], (i / kWgStages) & 1); }

  // Behind one fence, so that no other instruction defines a register that a
  // wgmma of the two groups reads: sc = q . k^T of the ring's tile ik (D / 16
  // wgmma, one commit group) if QK, then o += pa . v of tile iv (kWgBN / 16
  // wgmma, one commit group) if PV.
  template <bool QK, bool PV>
  __device__ __forceinline__ void issue(int ik, int iv) {
    if constexpr (PV) {
      pin_p(pa);
      pin_all(o);
    }
    wgmma_fence();
    if constexpr (QK) {
      const unsigned k = k_addr + (ik % kWgStages) * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const unsigned off = 32 * (kk % 4);  // 16 columns of a 64-column box
        wgmma_qk<kWgBN>(sc, sw128_desc(q_addr + (kk / 4) * (kWgRows * 128) + off, 16),
                        sw128_desc(k + (kk / 4) * L::kHalf + off, 16), kk > 0);
      }
      wgmma_commit();
    }
    if constexpr (PV) {
      const unsigned v = v_addr + (iv % kWgStages) * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kWgBN / 16; ++kk) wgmma_pv<D>(o, pa[kk], sw128_desc(v + kk * 2048, L::kHalf));
      wgmma_commit();
    }
  }
  template <int N>
  __device__ __forceinline__ void wait_qk() {
    wgmma_wait<N>();
    pin_all(sc);
  }

  // every product issued is done: o is final for the tiles so far, and pa free
  __device__ __forceinline__ void wait_pv() {
    wgmma_wait<0>();
    pin_all(o);
    pin_p(pa);
  }
  // P (sc, fp32) into pa in bf16, as wgmma's A fragments: step kk covers keys
  // 16 kk .. 16 kk + 15, the n8 blocks 2 kk and 2 kk + 1
  __device__ __forceinline__ void pack_p() {
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
  static __device__ __forceinline__ void pin_p(unsigned (&p)[kWgBN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pin(p[kk][r]);
  }

  // The online softmax of tile j's scores (sc, unscaled): the mask where the
  // tile crosses the diagonal, the window's left edge or the end of the keys;
  // the new running max; P = exp2(scale2 sc - max) in place; the
  // denominators; the corrections c0, c1 that o still needs.
  // A masked score is -inf here, not the other kernels' -1e30: with the scale
  // folded into one FFMA, -1e30 scale2 - max would leave a rounding residual
  // of some 1e21 in the exponent while the max is still -1e30 scale2.  The
  // running max starts at -1e30, so it stays finite, a masked key's P is 0
  // (as it is wherever the other kernels' max is finite) and a row that sees
  // no key keeps its max at -1e30 and gets zeros.
  __device__ __forceinline__ void softmax(int j) {
    constexpr int NS = kWgBN / 8;
    const int k0 = j * kWgBN;
    const bool edge = k0 + kWgBN > a.T || (a.causal && k0 + kWgBN - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + kWgRows - 1 - a.window);
    if (edge) {
      // key k0 + 2 t + x is kept for row r iff lo_r < x <= hi_r: one select a score
      const int base = k0 + 2 * t, last = a.T - 1 - base;
      const int hi0 = a.causal ? min(r0 - base, last) : last, hi1 = a.causal ? min(r1 - base, last) : last;
      const int lo0 = a.window > 0 ? r0 - a.window - base : -(1 << 30);
      const int lo1 = a.window > 0 ? r1 - a.window - base : -(1 << 30);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * n + (e & 1);
          const bool keep = e < 2 ? (x <= hi0 && x > lo0) : (x <= hi1 && x > lo1);
          sc[4 * n + e] = keep ? sc[4 * n + e] : -INFINITY;
        }
      }
    }
    float mt0 = kNegInf, mt1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mt0 = fmaxf(mt0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mt1 = fmaxf(mt1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0 * a.scale2), mn1 = fmaxf(m1, mt1 * a.scale2);
    c0 = fast_exp2(m0 - mn0);
    c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sc[4 * n] = fast_exp2(fmaf(sc[4 * n], a.scale2, -mn0));
      sc[4 * n + 1] = fast_exp2(fmaf(sc[4 * n + 1], a.scale2, -mn0));
      sc[4 * n + 2] = fast_exp2(fmaf(sc[4 * n + 2], a.scale2, -mn1));
      sc[4 * n + 3] = fast_exp2(fmaf(sc[4 * n + 3], a.scale2, -mn1));
      s0 += sc[4 * n] + sc[4 * n + 1];
      s1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
  }

  // o takes the corrections of the last softmax (once its P . v are done);
  // a warp none of whose rows raised its max skips it
  __device__ __forceinline__ void rescale() {
    if (!__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) return;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= c0;
      o[4 * n + 1] *= c0;
      o[4 * n + 2] *= c1;
      o[4 * n + 3] *= c1;
    }
  }

  __device__ __forceinline__ void store() {
    float d0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 1), d1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    const float inv0 = m0 > kNegInf ? 1.f / fmaxf(d0, 1e-30f) : 0.f;  // a row that saw no key gets zeros
    const float inv1 = m1 > kNegInf ? 1.f / fmaxf(d1, 1e-30f) : 0.f;
    bf16* ob = a.o + static_cast<size_t>(bh) * a.S * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (r0 < a.S)
        *reinterpret_cast<unsigned*>(ob + static_cast<size_t>(r0) * D + col) = pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < a.S)
        *reinterpret_cast<unsigned*>(ob + static_cast<size_t>(r1) * D + col) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
};

// Persistent: block b takes work tiles b, b + gridDim.x, ...; the ring and
// its phases run on across them, so the producer loads the next tile's q and
// k/v while the consumers finish and store the current one.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(WgArgs a, const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv) {
  static_assert(D == 64 || D == 128, "the wgmma kernel takes D = 64 or 128");
  using L = WgLayout<D>;
  constexpr int kBoxes = D / 64;  // 128-byte boxes across a row of D
  constexpr unsigned kConsumerThreads = 128 * kWgConsumers;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ks = smem + kWgConsumers * L::kQBytes;
  unsigned char* vs = ks + kWgStages * L::kKVBytes;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);  // the tile's q has landed
  uint64_t* qempty = qfull + 1;                                          // the consumers are done with q
  uint64_t* fullk = qempty + 1;                                          // slot s holds its k tile
  uint64_t* fullv = fullk + kWgStages;                                   // .. its v tile
  uint64_t* empty = fullv + kWgStages;                                   // slot s may be refilled

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, kConsumerThreads);  // every consumer thread once per work tile, live or not
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&fullk[s], 1);
      mbar_init(&fullv[s], 1);
      mbar_init(&empty[s], kConsumerThreads);  // .. once per k/v tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWgConsumers) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != kWgConsumers * 128) return;
    int it = 0, n = 0;  // k/v tiles and work tiles so far
    for (int w = blockIdx.x; w < a.work; w += gridDim.x, ++n) {
      const WgTile t = wg_tile(a, w);
      if (n > 0) mbar_wait(qempty, (n - 1) & 1);
      mbar_expect_bytes(qfull, (t.live[0] + t.live[1]) * L::kQBytes);
#pragma unroll
      for (int i = 0; i < kWgConsumers; ++i)
        if (t.live[i])
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            tensor_copy_3d(qs + i * L::kQBytes + b * (kWgRows * 128), &mq, 64 * b, t.q0[i], t.bh[i], qfull);
      for (int j = t.lo; j < t.hi; ++j, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        mbar_expect_bytes(&fullk[s], L::kKVBytes);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tensor_copy_3d(ks + s * L::kKVBytes + b * L::kHalf, &mk, 64 * b, j * kWgBN, t.bkv, &fullk[s]);
        mbar_expect_bytes(&fullv[s], L::kKVBytes);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tensor_copy_3d(vs + s * L::kKVBytes + b * L::kHalf, &mv, 64 * b, j * kWgBN, t.bkv, &fullv[s]);
      }
    }
  } else {  // a consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    WgConsumer<D> c;
    int it = 0, n = 0;
    for (int w = blockIdx.x; w < a.work; w += gridDim.x, ++n) {
      const WgTile t = wg_tile(a, w);
      const bool live = wg == 0 ? t.live[0] : t.live[1];
      const int lo = t.lo, hi = t.hi;
      const int my_lo = wg == 0 ? t.lo_w[0] : t.lo_w[1], my_hi = wg == 0 ? t.hi_w[0] : t.hi_w[1];
      c.init(a, wg == 0 ? t.bh[0] : t.bh[1], wg == 0 ? t.q0[0] : t.q0[1], smem_u32(qs + wg * L::kQBytes),
             smem_u32(ks), smem_u32(vs));
      const auto slot = [&](int j) { return it + j - lo; };  // the ring's count of tile j
      mbar_wait(qfull, n & 1);
      // a tile outside this warpgroup's rows: keep in step with the ring
      const auto skip = [&](int j) {
        mbar_wait(&fullk[slot(j) % kWgStages], (slot(j) / kWgStages) & 1);
        mbar_arrive(&empty[slot(j) % kWgStages]);
      };
      int j = lo;
      for (; j < min(my_lo, hi); ++j) skip(j);
      if (my_lo < my_hi) {
        // the first tile: q . k^T and its softmax
        c.wait_k(fullk, slot(j));
        c.template issue<true, false>(slot(j), 0);
        c.template wait_qk<0>();
        c.softmax(j);
        c.pack_p();
        for (++j; j < my_hi; ++j) {
          // o takes tile j-1's correction; then tile j's q . k^T and tile j-1's P . v, in
          // flight together behind one fence; tile j's softmax runs under the second
          c.rescale();
          c.wait_k(fullk, slot(j));
          c.wait_v(fullv, slot(j - 1));
          c.template issue<true, true>(slot(j), slot(j - 1));
          c.template wait_qk<1>();
          c.softmax(j);
          c.wait_pv();  // tile j-1's P . v is done: its slot and pa are free
          mbar_arrive(&empty[slot(j - 1) % kWgStages]);
          c.pack_p();
        }
        mbar_arrive(qempty);  // every q . k^T of the tile is done
        // the last tile's P . v
        c.rescale();
        c.wait_v(fullv, slot(j - 1));
        c.template issue<false, true>(0, slot(j - 1));
        c.wait_pv();
        mbar_arrive(&empty[slot(j - 1) % kWgStages]);
      } else {
        mbar_arrive(qempty);
      }
      for (; j < hi; ++j) skip(j);
      if (live) c.store();
      it += hi - lo;
    }
  }
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

// The tensor map of bf16 [n, rows, D] read in [box_rows][64] boxes, 128B-swizzled;
// a box past `rows` is zero-filled and never reaches the next matrix.
cudaError_t encode_heads(CUtensorMap* map, const void* base, int n, int rows, int D, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1}, ones[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One block per SM (persistent), over units x position tiles of work: a unit
// is (kv row, pair of its query heads) with 64 positions a tile at G >= 2, a
// query row with 128 positions a tile at G = 1.
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH, int S, int T_, int group,
                         int causal, int window, float scale, cudaStream_t stream) {
  using L = WgLayout<D>;
  const auto kernel = flash_fwd_wgmma_kernel<D>;
  CUtensorMap mq, mk, mv;
  const int BKV = BH / group;
  cudaError_t err = encode_heads(&mq, q, BH, S, D, kWgRows);
  if (err == cudaSuccess) err = encode_heads(&mk, k, BKV, T_, D, kWgBN);
  if (err == cudaSuccess) err = encode_heads(&mv, v, BKV, T_, D, kWgBN);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int sms[64] = {};  // the shared-memory limit is raised, and the SMs counted, once per device
  if (dev >= 64 || sms[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kSmem));
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    sms[dev] = n;
  }
  const int rows = group >= 2 ? kWgRows : kWgConsumers * kWgRows;  // positions per work tile
  const long long units = group >= 2 ? static_cast<long long>(BKV) * ((group + 1) / 2) : BH;
  const long long work = units * ((S + rows - 1) / rows);
  if (work > (1 << 30)) return cudaErrorInvalidValue;
  const WgArgs args{static_cast<bf16*>(o), S,          T_, group, causal, window, scale * 1.4426950408889634f,
                    static_cast<int>(units), static_cast<int>(work)};
  kernel<<<static_cast<unsigned>(std::min<long long>(work, sms[dev])), kWgThreads, L::kSmem, stream>>>(args, mq, mk,
                                                                                                        mv);
  return cudaGetLastError();
}

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int T_, int D, int group,
                   int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, NCH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), S, T_, D,
      group, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nch, const void* q, const void* k, const void* v, void* o, int BH, int S, int T_, int D,
                     int group, int causal, int window, float scale, cudaStream_t stream) {
  switch (nch) {
    case 1: return launch<T, 1>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 4: return launch<T, 4>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 5: return launch<T, 5>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 6: return launch<T, 6>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 7: return launch<T, 7>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    case 8: return launch<T, 8>(q, k, v, o, BH, S, T_, D, group, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [BH,S,D], k/v [BH/group,T,D], o [BH,S,D], all contiguous and 16-byte
// aligned; dtype 0 = float32, 1 = bfloat16; window 0 = none; scale
// multiplies q . k.  route 0 = "fma" (any dtype and D), 1 = "mma" (bf16, D a
// multiple of 16), 2 = "wgmma" (bf16, D = 64 or 128); a route that does not
// fit the inputs is refused (cudaErrorInvalidValue), never replaced.  Returns
// the cudaError_t of the launch (0 = launched).
int flash_attn_forward(const void* q, const void* k, const void* v, void* o, int BH, int S, int T, int D, int group,
                       int causal, int window, int dtype, int route, float scale, void* stream) {
  if (BH < 1 || S < 1 || T < 1 || D < 1 || D > kMaxD || group < 1 || BH % group || window < 0 || BH > 65535 ||
      dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return dtype == 0 ? dispatch<float>((D + 15) / 16, q, k, v, o, BH, S, T, D, group, causal, window, scale, st)
                        : dispatch<__nv_bfloat16>((D + 15) / 16, q, k, v, o, BH, S, T, D, group, causal, window,
                                                  scale, st);
    case 1:
      if (dtype != 1 || D % 16) return cudaErrorInvalidValue;
      return dispatch_mma(q, k, v, o, BH, S, T, D, group, causal, window, scale, st);
    case 2:
      if (dtype != 1) return cudaErrorInvalidValue;
      if (D == 64) return launch_wgmma<64>(q, k, v, o, BH, S, T, group, causal, window, scale, st);
      if (D == 128) return launch_wgmma<128>(q, k, v, o, BH, S, T, group, causal, window, scale, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
