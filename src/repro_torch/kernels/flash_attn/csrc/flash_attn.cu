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
// is bound by operations.  Two kernels:
//   * bf16 with D a multiple of 16 (the model's path): mma.sync m16n8k16 on
//     the tensor cores with fp32 accumulation (flash_fwd_mma_kernel below);
//     wgmma, TMA and warp specialisation are later work;
//   * fp32, and bf16 at other D: fp32 FMA on the CUDA cores (67 TFLOP/s at
//     best, so at least 1 ms at the shape above), as the fp32 path must meet
//     the harness's 1e-4 tolerance.
//
// Both kernels skip kv tiles wholly above the diagonal or left of the window
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
// multiplies q . k.  bf16 with D a multiple of 16 runs on the tensor cores;
// everything else on the fp32 FMA kernel.  Returns the cudaError_t of the
// launch (0 = launched).
int flash_attn_forward(const void* q, const void* k, const void* v, void* o, int BH, int S, int T, int D, int group,
                       int causal, int window, int dtype, float scale, void* stream) {
  if (BH < 1 || S < 1 || T < 1 || D < 1 || D > kMaxD || group < 1 || BH % group || window < 0 || BH > 65535)
    return cudaErrorInvalidValue;
  const int nch = (D + 15) / 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D % 16 == 0)
    return dispatch_mma(q, k, v, o, BH, S, T, D, group, causal, window, scale, st);
  if (dtype == 0) return dispatch<float>(nch, q, k, v, o, BH, S, T, D, group, causal, window, scale, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(nch, q, k, v, o, BH, S, T, D, group, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* flash_attn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
