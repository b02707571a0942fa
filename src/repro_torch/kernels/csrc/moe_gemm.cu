// Ragged grouped GEMM for the MoE expert products: for the rows r that
// expert e owns, [offsets[e], offsets[e+1]), y[r] = x[r] @ w[e].
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm.py::_moe_kernel.
// Contract: repro_torch/kernels/ref.py::ref_moe_gemm on rows that some
// expert owns, up to the order of the f32 sum: products summed over D in
// f32, one rounding to the input type at the end.  A row before
// offsets[0] or from offsets[E] on comes out as zero, as _moe_kernel
// gives it (ref_moe_gemm clips such a row to expert 0 or E-1 instead).
// offsets must be nondecreasing; values outside [0, T] are clipped.
//
// Layout: x (T, D), w (E, D, F), y (T, F), contiguous but for w's expert
// stride (w_expert_stride >= D·F elements; a split of a split-expert
// weight is a strided view with the (D, F) blocks whole); offsets
// (E+1,) int32 on the device (read there: no host sync).  x, w and y
// share one type, f32 or bf16.  Any T, D, F and E, empty experts too.
//
// Bound: bytes, on the model's path.  Each call reads every expert's
// (D, F) matrix once: qwen3-moe's (128, 2048, 768) bf16 tensor is
// 402.7 MB, about 120 us at 3.35 TB/s.  At serve and decode (1 to 6 rows
// an expert) the tensor-core FLOPs are a few us; at prefill (81 rows an
// expert, 32.6 GFLOP) about 33 us at the bf16 peak, still below the
// bytes' 138 us, but f32 FMAs on the CUDA cores take 1.9 ms there.
//
// Grid (both bodies): the TPU walks a (row tile, expert) grid in order
// and skips the experts that miss the tile.  Here the grid is
// expert-major instead: one block per (column tile of F, expert e,
// row-tile slot z), and the block walks expert e's own rows in tiles z,
// z+Z, ...  Every tile holds rows of one expert only, so each weight
// tile is read once per row tile of its expert, and at decode (one row
// an expert) every SM streams weights.  Z is the mean number of row
// tiles an expert has, so uniform offsets (the model's) give one tile a
// block.  The block row E (one extra grid row) writes the zeros of the
// rows that no expert owns.  Two bodies, chosen by the launcher's
// `route`:
//
// route 0, moe_gemm_kernel (f32; bf16 with D or F off the 16-byte
// vector width, or when asked for): 64 x 64 output tiles, x's rows
// (transposed) and w[e]'s (64, 64) tile staged in shared memory as f32,
// 256 threads each owning a 4 x 4 set of outputs with f32 FMAs on the
// CUDA cores; threads whose rows lie past the tile's last row skip the
// FMAs.  The f32 goldens need this body.
//
// route 1, moe_gemm_tc_kernel<MT> (bf16, D and F multiples of 8,
// 16-byte aligned x and w): mma.sync.m16n8k16 on the tensor cores over
// a deep cp.async ring.  The load-barrier-FMA rhythm of route 0 kept one
// 8 KB weight tile in flight a block (0.9-1.3 TB/s); here a block owns
// MT m16 row tiles (the wrapper picks MT from the mean rows an expert:
// 1 at serve, decode and the compacted pairs, 8 at prefill, so each
// weight tile is read once) by 128 columns, and 64-deep slices of w[e]
// (64 x 128 bf16, 16 KB) and x run through a 3-stage cp.async.cg ring in
// dynamic shared memory, two slices in flight while one computes, with
// rows padded by 16 B so ldmatrix is conflict-free.  A fragments come
// from ldmatrix on x, B fragments from ldmatrix.trans on w (F is
// contiguous), f32 accumulators, one rounding at the store.  x rows past
// the expert's last row are zero-filled (cp.async src-size 0), their m16
// tiles skip the products, and they are never stored.  wgmma, TMA and
// compacted dispatch are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

namespace {

constexpr int kBM = 64;                 // rows of a tile
constexpr int kBN = 64;                 // columns of a tile
constexpr int kBK = 64;                 // depth of a D slice
constexpr int kThreads = 256;
constexpr int kTX = kBN / 4;            // threads along the columns
constexpr int kTY = kThreads / kTX;     // threads along the rows
constexpr int kRM = kBM / kTY;          // rows a thread owns
constexpr int kRN = kBN / kTX;          // columns a thread owns

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);               // round to nearest even
}

// one 16-byte chunk: 4 f32 or 8 bf16 values, widened to f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* pairs =
        reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(pairs[t]);
      out[2 * t] = f.x;
      out[2 * t + 1] = f.y;
    }
  }
};

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The extra grid row E: zeros into columns [n0, n0 + BN) of the rows
// that no expert owns, [0, offsets[0]) and [offsets[E], T).
template <typename T, int BN, int kBlock>
__device__ __forceinline__ void zero_uncovered(
    const int* __restrict__ offsets, T* __restrict__ y, int T_, int F, int E,
    int n0) {
  if (blockIdx.z != 0) return;
  const int a = clip(offsets[0], 0, T_);
  const int b = clip(offsets[E], a, T_);
  const int n = a + (T_ - b);
  for (int v = threadIdx.x; v < n * BN; v += kBlock) {
    const int i = v / BN, c = n0 + v % BN;
    const int r = i < a ? i : b + (i - a);
    if (c < F) y[static_cast<int64_t>(r) * F + c] = from_f<T>(0.f);
  }
}

// Stage x[r0 : r0 + rows, k0 : k0 + kBK) transposed into xs (rows past
// `rows` are left as they are: no thread reads them) and
// w[k0 : k0 + kBK, n0 : n0 + kBN) into ws (zeros past D or F).
template <typename T, bool kVec>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ we,
                                      float (*xs)[kBM + 1],
                                      float (*ws)[kBN], int64_t r0, int rows,
                                      int k0, int n0, int D, int F) {
  const int tid = threadIdx.x;
  if (kVec) {
    constexpr int kN = Vec<T>::kN;
    constexpr int kXV = kBK / kN;          // vectors along a row of x
    for (int v = tid; v < rows * kXV; v += kThreads) {
      const int r = v / kXV, kk = (v % kXV) * kN;
      float vals[kN];
      if (k0 + kk < D) {
        Vec<T>::load(x + (r0 + r) * D + k0 + kk, vals);
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) xs[kk + i][r] = vals[i];
    }
    constexpr int kWV = kBN / kN;          // vectors along a row of w
    for (int v = tid; v < kBK * kWV; v += kThreads) {
      const int kk = v / kWV, nn = (v % kWV) * kN;
      float vals[kN];
      if (k0 + kk < D && n0 + nn < F) {
        Vec<T>::load(we + static_cast<int64_t>(k0 + kk) * F + n0 + nn,
                     vals);
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kN; i += 4)       // 16-byte stores
        *reinterpret_cast<float4*>(&ws[kk][nn + i]) =
            make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
    }
  } else {
    for (int v = tid; v < rows * kBK; v += kThreads) {
      const int r = v / kBK, kk = v % kBK;
      xs[kk][r] = k0 + kk < D ? to_f(x[(r0 + r) * D + k0 + kk]) : 0.f;
    }
    for (int v = tid; v < kBK * kBN; v += kThreads) {
      const int kk = v / kBN, nn = v % kBN;
      ws[kk][nn] = (k0 + kk < D && n0 + nn < F)
                       ? to_f(we[static_cast<int64_t>(k0 + kk) * F + n0 + nn])
                       : 0.f;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ offsets, T* __restrict__ y, int T_,
                int D, int F, int E, int64_t wse) {
  __shared__ float xs[kBK][kBM + 1];      // +1: conflict-free transposes
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int n0 = blockIdx.x * kBN;
  const int e = blockIdx.y;

  if (e == E) {                           // rows that no expert owns
    zero_uncovered<T, kBN, kThreads>(offsets, y, T_, F, E, n0);
    return;
  }
  const int lo = clip(offsets[e], 0, T_);
  const int hi = clip(offsets[e + 1], lo, T_);
  const T* we = w + static_cast<int64_t>(e) * wse;

  for (int64_t r0 = lo + static_cast<int64_t>(blockIdx.z) * kBM; r0 < hi;
       r0 += static_cast<int64_t>(gridDim.z) * kBM) {
    const int rows = static_cast<int>(hi - r0 < kBM ? hi - r0 : kBM);
    float acc[kRM][kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      stage<T, kVec>(x, we, xs, ws, r0, rows, k0, n0, D, F);
      __syncthreads();
      if (ty < rows) {                    // the thread owns a live row
#pragma unroll 8
        for (int k = 0; k < kBK; ++k) {
          float b[kRN];
#pragma unroll
          for (int j = 0; j < kRN; ++j) b[j] = ws[k][tx + kTX * j];
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            if (ty + kTY * i < rows) {
              const float a = xs[k][ty + kTY * i];
#pragma unroll
              for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
            }
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = ty + kTY * i;
      if (r >= rows) continue;
      T* yr = y + (r0 + r) * F;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int c = n0 + tx + kTX * j;
        if (c < F) yr[c] = from_f<T>(acc[i][j]);
      }
    }
  }
}

// ---- route 1: bf16 on the tensor cores -------------------------------

constexpr int kTcBN = 128;              // columns of a tile
constexpr int kTcBK = 64;               // depth of a D slice
constexpr int kTcStages = 3;            // slices in the cp.async ring
constexpr int kPad = 8;                 // bf16 padding of a shared row
constexpr int kXLd = kTcBK + kPad;      // x slice pitch: 9 16-byte chunks
constexpr int kWLd = kTcBN + kPad;      // w slice pitch: 17 16-byte chunks

template <int MT>
struct Tc {                             // the shape of one instantiation
  static constexpr int kBM = 16 * MT;   // rows of a tile
  static constexpr int kWarpsM = MT >= 2 ? 2 : 1;
  static constexpr int kWarpsN = 4;     // 32 columns a warp
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  // m16 tiles a warp, interleaved (warp row wm owns tiles wm, wm +
  // kWarpsM, ...) so a part-filled tile's live m16 tiles spread evenly
  static constexpr int kWM = MT / kWarpsM;
  static constexpr int kStage = kBM * kXLd + kTcBK * kWLd;  // elements
  static constexpr int kSmem =
      kTcStages * kStage * static_cast<int>(sizeof(__nv_bfloat16));
};

// two 256-thread blocks an SM (the ring's shared memory allows it) need
// at most 128 registers a thread; MT 1 fits three 128-thread blocks
template <int MT>
__global__ void __launch_bounds__(Tc<MT>::kThreads, MT >= 2 ? 2 : 3)
moe_gemm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ offsets,
                   __nv_bfloat16* __restrict__ y, int T_, int D, int F,
                   int E, int64_t wse) {
  using bf16 = __nv_bfloat16;
  using Sh = Tc<MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / Sh::kWarpsN, wn = warp % Sh::kWarpsN;
  const int g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kTcBN;
  const int e = blockIdx.y;

  if (e == E) {                           // rows that no expert owns
    zero_uncovered<bf16, kTcBN, Sh::kThreads>(offsets, y, T_, F, E, n0);
    return;
  }
  const int lo = clip(offsets[e], 0, T_);
  const int hi = clip(offsets[e + 1], lo, T_);
  const bf16* we = w + static_cast<int64_t>(e) * wse;
  const int nk = (D + kTcBK - 1) / kTcBK;

  for (int64_t r0 = lo + static_cast<int64_t>(blockIdx.z) * Sh::kBM;
       r0 < hi; r0 += static_cast<int64_t>(gridDim.z) * Sh::kBM) {
    const int rows =
        static_cast<int>(hi - r0 < Sh::kBM ? hi - r0 : Sh::kBM);

    // slice kt of x's rows and of w[e]'s columns into ring stage st; x
    // rows past `rows` and anything past D or F arrive as zeros
    auto load = [&](int kt, int st) {
      bf16* xs = smem + st * Sh::kStage;
      bf16* ws = xs + Sh::kBM * kXLd;
      const int k0 = kt * kTcBK;
      for (int c = tid; c < Sh::kBM * (kTcBK / 8); c += Sh::kThreads) {
        const int r = c / (kTcBK / 8), col = (c % (kTcBK / 8)) * 8;
        const bool in = r < rows && k0 + col < D;
        tc::cp_async16(xs + r * kXLd + col,
                       in ? x + (r0 + r) * D + k0 + col : x, in);
      }
      for (int c = tid; c < kTcBK * (kTcBN / 8); c += Sh::kThreads) {
        const int kk = c / (kTcBN / 8), col = (c % (kTcBN / 8)) * 8;
        const bool in = k0 + kk < D && n0 + col < F;
        tc::cp_async16(
            ws + kk * kWLd + col,
            in ? we + static_cast<int64_t>(k0 + kk) * F + n0 + col : we, in);
      }
    };

    float acc[Sh::kWM][4][4];
#pragma unroll
    for (int i = 0; i < Sh::kWM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
    for (int st = 0; st < kTcStages - 1; ++st) {
      if (st < nk) load(st, st);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tc::cp_async_wait<kTcStages - 2>();  // slice kt has landed
      __syncthreads();                     // and slice kt-1 is consumed
      const int nxt = kt + kTcStages - 1;
      if (nxt < nk) load(nxt, nxt % kTcStages);
      tc::cp_async_commit();
      const bf16* xs = smem + (kt % kTcStages) * Sh::kStage;
      const bf16* ws = xs + Sh::kBM * kXLd;
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        uint32_t bfr[4][2];                // the warp's four n8 tiles
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(
              r, ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kWLd +
                     wn * 32 + p * 16 + (lane >> 4) * 8);
          bfr[2 * p][0] = r[0];
          bfr[2 * p][1] = r[1];
          bfr[2 * p + 1][0] = r[2];
          bfr[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < Sh::kWM; ++i) {
          const int mt = i * Sh::kWarpsM + wm;
          if (mt * 16 >= rows) continue;   // no live row in this m16 tile
          uint32_t a[4];
          tc::ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * kXLd + kk * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tc::mma_bf16(acc[i][j], a, bfr[j][0], bfr[j][1]);
        }
      }
    }
    tc::cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < Sh::kWM; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (i * Sh::kWarpsM + wm) * 16 + g + 8 * half;
        if (r >= rows) continue;
        bf16* yr = y + (r0 + r) * F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + wn * 32 + 8 * j + 2 * t4;
          if (c < F)                       // F is even: c + 1 < F too
            *reinterpret_cast<uint32_t*>(yr + c) = tc::pack_bf16(
                acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
      }
    }
    __syncthreads();                       // the next tile refills the ring
  }
}

template <int MT>
int launch_tc(const void* x, const void* w, const int* offsets, void* y,
              int T_, int D, int F, int E, int64_t wse,
              cudaStream_t stream) {
  using Sh = Tc<MT>;
  // above 48 KB a block's shared memory must be opted into, once per
  // instantiation, at its first launch (before any graph capture)
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_gemm_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t tiles = (static_cast<int64_t>(T_) + Sh::kBM - 1) / Sh::kBM;
  int64_t z = (tiles + E - 1) / E;
  if (z < 1) z = 1;
  if (z > 65535) z = 65535;
  const dim3 grid((F + kTcBN - 1) / kTcBN, E + 1, static_cast<unsigned>(z));
  using bf16 = __nv_bfloat16;
  moe_gemm_tc_kernel<MT><<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), offsets,
      static_cast<bf16*>(y), T_, D, F, E, wse);
  return static_cast<int>(cudaGetLastError());
}

// ---- route 0 -------------------------------------------------------------

template <typename T>
int launch(const void* x, const void* w, const int* offsets, void* y, int T_,
           int D, int F, int E, int64_t wse, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && D % kN == 0 &&
                   wse % kN == 0 &&
                   F % kN == 0;
  // row-tile slots per expert: the mean number of 64-row tiles an expert
  // owns (one a block when offsets are uniform)
  const int64_t tiles = (static_cast<int64_t>(T_) + kBM - 1) / kBM;
  int64_t z = (tiles + E - 1) / E;
  if (z < 1) z = 1;
  if (z > 65535) z = 65535;
  const dim3 grid((F + kBN - 1) / kBN, E + 1, static_cast<unsigned>(z));
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (vec)
    moe_gemm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, wt, offsets, yt, T_, D, F, E, wse);
  else
    moe_gemm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, wt, offsets, yt, T_, D, F, E, wse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, D) and y (T, F) contiguous; w (E, D, F) with each expert's (D, F)
// block contiguous and w_expert_stride elements (>= D·F) from one
// expert's block to the next (D·F for a contiguous w; s·D·F for split s
// of a split-expert weight viewed (E, s, D, F)); offsets (E+1,) int32, on
// the device.  dtype: 0 = float32, 1 = bfloat16 (all three tensors).
// route: 0 = the CUDA-core body (either dtype), 1 = the tensor-core body
// (bfloat16, D and F multiples of 8, 16-byte aligned x, w and y) with
// row tiles of mt m16 tiles, mt 1, 2, 4 or 8.  Launches on `stream`;
// returns cudaGetLastError() (0 on success) or an error for a shape,
// type or alignment the body does not take.
extern "C" int moe_gemm_launch(const void* x, const void* w,
                               const void* offsets, void* y, int T_, int D,
                               int F, int E, long long w_expert_stride,
                               int dtype, int route, int mt, void* stream) {
  if (T_ == 0 || F == 0) return 0;
  if (T_ < 0 || D < 0 || F < 0 || E <= 0 || E >= 65535 ||
      w_expert_stride < static_cast<long long>(D) * F)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t wse = static_cast<int64_t>(w_expert_stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (route == 1) {
    if (dtype != 1 || D % 8 != 0 || F % 8 != 0 || wse % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
         reinterpret_cast<uintptr_t>(y)) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (mt == 1) return launch_tc<1>(x, w, off, y, T_, D, F, E, wse, s);
    if (mt == 2) return launch_tc<2>(x, w, off, y, T_, D, F, E, wse, s);
    if (mt == 4) return launch_tc<4>(x, w, off, y, T_, D, F, E, wse, s);
    if (mt == 8) return launch_tc<8>(x, w, off, y, T_, D, F, E, wse, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w, off, y, T_, D, F, E, wse, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, off, y, T_, D, F, E, wse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
