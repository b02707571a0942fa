// Fused RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::_rmsnorm_kernel.
// Contract: repro_torch/kernels/ref.py::ref_rmsnorm, up to the order of
// the f32 sum: the mean square in f32, x * rsqrt(var + eps) * scale in
// f32, and one rounding to the input type at the end.
//
// Layout: x (rows, D) by its row stride, D contiguous; scale (D,); out
// (rows, D) contiguous.  f32 or bf16 for x and, independently, for scale.
//
// Bound: bytes.  Each row is read once and written once (2 * rows * D
// elements) for about 4 FLOPs an element, far below the card's ridge; at
// the serve path's rows (64 x 3584 bf16, 0.9 MB) the bound is a fraction
// of a microsecond and the launch itself dominates.  Design: the TPU
// streams (128, D) row tiles through VMEM once; here one block of 128
// threads owns one row.  Pass one reads the row with 16-byte loads
// (8 bf16 or 4 f32 a load) where the row and scale are aligned, sums the
// squares in f32 and reduces them with warp shuffles and one exchange
// through shared memory; pass two reads the row again (now from L1/L2,
// not device memory: a row is at most a few tens of KB) and writes the
// scaled result.  Any D is taken: an unaligned row or a D that is not a
// multiple of the vector width takes a scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

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

// one 16-byte chunk: 4 f32 or 8 bf16 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
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
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      pairs[t] = __floats2bfloat162_rn(in[2 * t], in[2 * t + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ out, int64_t row_stride, int D, float eps,
               int vec) {
  __shared__ float partial[kWarps];
  const int tid = threadIdx.x;
  const T* xr = x + blockIdx.x * row_stride;
  T* orow = out + static_cast<int64_t>(blockIdx.x) * D;

  float ss = 0.f;
  if (vec) {
    constexpr int kN = Vec<T>::kN;
    for (int c = tid * kN; c < D; c += kThreads * kN) {
      float v[kN];
      Vec<T>::load(xr + c, v);
#pragma unroll
      for (int i = 0; i < kN; ++i) ss += v[i] * v[i];
    }
  } else {
    for (int c = tid; c < D; c += kThreads) {
      const float v = to_f(xr[c]);
      ss += v * v;
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    ss += __shfl_xor_sync(kFull, ss, off);
  if (tid % kWarp == 0) partial[tid / kWarp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += partial[w];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);

  if (vec) {
    constexpr int kN = Vec<T>::kN;
    for (int c = tid * kN; c < D; c += kThreads * kN) {
      float v[kN];
      Vec<T>::load(xr + c, v);
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = v[i] * r * to_f(scale[c + i]);
      Vec<T>::store(orow + c, v);
    }
  } else {
    for (int c = tid; c < D; c += kThreads)
      orow[c] = from_f<T>(to_f(xr[c]) * r * to_f(scale[c]));
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* out, int64_t row_stride,
           int rows, int D, float eps, cudaStream_t stream) {
  const uintptr_t bytes = 16;
  const int vec =
      (reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
       reinterpret_cast<uintptr_t>(out) % bytes == 0 &&
       (row_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
       D % Vec<T>::kN == 0)
          ? 1
          : 0;
  rmsnorm_kernel<T, TS><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(out), row_stride, D, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: rows of D elements, `row_stride` elements apart; out: contiguous.
// dtype / scale_dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`;
// returns cudaGetLastError() (0 on success) or cudaErrorInvalidValue for a
// shape or type the kernel does not take.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int64_t row_stride, int rows, int D, float eps,
                              int dtype, int scale_dtype, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || D <= 0 || row_stride < D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, row_stride, rows, D, eps, s);
  if (dtype == 0 && scale_dtype == 1)
    return launch<float, bf16>(x, scale, out, row_stride, rows, D, eps, s);
  if (dtype == 1 && scale_dtype == 0)
    return launch<bf16, float>(x, scale, out, row_stride, rows, D, eps, s);
  if (dtype == 1 && scale_dtype == 1)
    return launch<bf16, bf16>(x, scale, out, row_stride, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
