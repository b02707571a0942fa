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
// Layout: x (T, D), w (E, D, F), y (T, F), all contiguous; offsets
// (E+1,) int32 on the device (read there: no host sync).  x, w and y
// share one type, f32 or bf16.  Any T, D, F and E, empty experts too.
//
// Bound: bytes, on the model's path.  Each call reads every expert's
// (D, F) matrix once: qwen3-moe's (128, 2048, 768) bf16 tensor is
// 402.7 MB, about 120 us at 3.35 TB/s, against a few us of tensor-core
// FLOPs at serve and decode shapes (a handful of rows an expert).
//
// Design: the TPU walks a (row tile, expert) grid in order and skips the
// experts that miss the tile.  Here the grid is expert-major instead:
// one block per (64-column tile of F, expert e, row-tile slot z), and the
// block walks expert e's own rows in 64-row tiles z, z+Z, ...  Every
// tile holds rows of one expert only, so no row mask is needed, and each
// weight tile is read once per 64 rows of its expert (a row-tile grid
// would read it again for every tile that its rows straddle, and at
// decode, one row an expert, would give 2 row tiles and a loop over 64
// experts each).  At the decode shape the grid is 12 x 129 blocks, and
// every SM streams weights.  Z is the mean number of row tiles an expert
// has, so uniform offsets (the model's) give one tile a block.  For each
// tile the block loops over D in 64-deep slices: x's rows (transposed)
// and w[e]'s (64, 64) tile are staged in shared memory as f32, with
// 16-byte loads where the rows are aligned; 256 threads each own a 4 x 4
// set of outputs (rows ty + 16i, columns tx + 16j), and threads whose
// rows lie past the tile's last row skip the FMAs, so a 1-row tile costs
// the weight reads, not 64 rows of arithmetic.  FMAs in f32 on the CUDA
// cores; the block row E (one extra grid row) writes the zeros of the
// rows that no expert owns.  Tensor cores (wgmma), TMA and compacted
// dispatch are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                int D, int F, int E) {
  __shared__ float xs[kBK][kBM + 1];      // +1: conflict-free transposes
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int n0 = blockIdx.x * kBN;
  const int e = blockIdx.y;

  if (e == E) {                           // rows that no expert owns
    if (blockIdx.z != 0) return;
    const int a = clip(offsets[0], 0, T_);
    const int b = clip(offsets[E], a, T_);
    const int n = a + (T_ - b);           // rows [0, a) and [b, T)
    for (int v = tid; v < n * kBN; v += kThreads) {
      const int i = v / kBN, c = n0 + v % kBN;
      const int r = i < a ? i : b + (i - a);
      if (c < F) y[static_cast<int64_t>(r) * F + c] = from_f<T>(0.f);
    }
    return;
  }
  const int lo = clip(offsets[e], 0, T_);
  const int hi = clip(offsets[e + 1], lo, T_);
  const T* we = w + static_cast<int64_t>(e) * D * F;

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

template <typename T>
int launch(const void* x, const void* w, const int* offsets, void* y, int T_,
           int D, int F, int E, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && D % kN == 0 &&
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
        xt, wt, offsets, yt, T_, D, F, E);
  else
    moe_gemm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, wt, offsets, yt, T_, D, F, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, D), w (E, D, F), y (T, F) contiguous; offsets (E+1,) int32, on
// the device.  dtype: 0 = float32, 1 = bfloat16 (all three tensors).
// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for a shape or type the kernel does not take.
extern "C" int moe_gemm_launch(const void* x, const void* w,
                               const void* offsets, void* y, int T_, int D,
                               int F, int E, int dtype, void* stream) {
  if (T_ == 0 || F == 0) return 0;
  if (T_ < 0 || D < 0 || F < 0 || E <= 0 || E >= 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0) return launch<float>(x, w, off, y, T_, D, F, E, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, off, y, T_, D, F, E, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
