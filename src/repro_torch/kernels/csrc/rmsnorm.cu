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
// of a microsecond and the launch itself dominates, at a prefill's (4096 x
// 2048 bf16, 33.6 MB) the bytes are real.  So the design moves each byte
// once and pays the device-memory latency once.  The TPU streams (128, D)
// row tiles through VMEM; here the launcher takes one of two bodies, as
// the plan of repro_torch/kernels/rmsnorm.py::norm_plan names it.
//
// REGS (rmsnorm_rows_kernel<T, TS, VPT, K>), for every view on the 16-byte
// width: a row lives in the registers of a row group of 32*K threads, each
// holding VPT 16-byte vectors of x (8 bf16 or 4 f32 values) and the scale
// values beside them, loaded as vectors of x's element count (16 bytes of
// the same type, 32 of f32 beside bf16, 8 of bf16 beside f32).  Every load
// of a thread is issued before the first use: one device-memory round trip
// a row.  The f32 sum of squares is reduced with shuffles inside a warp
// and, only where K > 1, through shared memory once.  The output is scaled
// from the registers and written with 16-byte stores; nothing is read a
// second time.  Two layouts from one kernel: few rows (serve, decode) take
// one row group a block, K warps wide so that a thread holds 1-2 vectors
// (3 at nemotron's D 18432 in bf16: 1024 threads, the last pass masked);
// many rows of at most 256 vectors (prefill) take a warp a row (K = 1),
// four rows a block, with no __syncthreads.
//
// PREVIOUS (rmsnorm_kernel<T, TS>), the body before it, for views off the
// 16-byte width (a base address or row stride off it, D not a multiple of
// the vector) and rows too wide for the register plan: one block of 128
// threads a row, one pass for the sum and a second read for the output,
// 16-byte loads where it can and an element loop where it cannot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrevious = 0;           // the launcher's routes
constexpr int kRegs = 1;
constexpr int kMaxRowsPerBlock = 4;    // of REGS's many-row layout

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
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* pairs =
        reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(pairs[t]);
      out[2 * t] = f.x;
      out[2 * t + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
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

// the scale values beside one vector of x (Vec<T>::kN of them), kept raw
// in registers until they are used: 16 bytes where the types agree, 32
// bytes of f32 beside bf16, 8 bytes of bf16 beside f32
template <typename T, typename TS>
struct ScaleVec;
template <>
struct ScaleVec<float, float> {
  using Raw = uint4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const Raw& r, float* out) {
    Vec<float>::unpack(r, out);
  }
};
template <>
struct ScaleVec<__nv_bfloat16, __nv_bfloat16> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const Raw& r, float* out) {
    Vec<__nv_bfloat16>::unpack(r, out);
  }
};
template <>
struct ScaleVec<__nv_bfloat16, float> {
  struct Raw { uint4 lo, hi; };
  __device__ static Raw load(const float* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return Raw{__ldg(q), __ldg(q + 1)};
  }
  __device__ static void unpack(const Raw& r, float* out) {
    Vec<float>::unpack(r.lo, out);
    Vec<float>::unpack(r.hi, out + 4);
  }
};
template <>
struct ScaleVec<float, __nv_bfloat16> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static void unpack(const Raw& r, float* out) {
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float2 f = __bfloat1622float2(pairs[t]);
      out[2 * t] = f.x;
      out[2 * t + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(kFull, v, off);
  return v;                 // the same in every lane (a + b == b + a)
}

// REGS: a row group of 32*K threads a row, VPT vectors a thread; the
// block holds blockDim.x / (32*K) rows (one where K > 1).
template <typename T, typename TS, int VPT, int K>
__global__ void __launch_bounds__(K == 1 ? kWarp * kMaxRowsPerBlock
                                         : kWarp * K)
rmsnorm_rows_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                    T* __restrict__ out, int64_t row_stride, int64_t rows,
                    int nvec, float eps) {
  constexpr int kG = kWarp * K;              // threads of a row group
  constexpr int kN = Vec<T>::kN;
  using SV = ScaleVec<T, TS>;
  __shared__ float partial[K];
  const int t = threadIdx.x % kG;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kG)
                      + threadIdx.x / kG;
  if (row >= rows) return;    // the many-row layout's last block (K == 1):
                              // whole warps, and no barrier follows there
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * row_stride);

  // every load first: x's vectors and the scale beside them
  uint4 xv[VPT];
  typename SV::Raw sv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * kG + t;
    if (v < nvec) {
      xv[j] = __ldg(xr + v);
      sv[j] = SV::load(scale + static_cast<int64_t>(v) * kN);
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (j * kG + t < nvec) {
      float f[kN];
      Vec<T>::unpack(xv[j], f);
#pragma unroll
      for (int i = 0; i < kN; ++i) ss += f[i] * f[i];
    }
  }
  ss = warp_sum(ss);
  if constexpr (K > 1) {
    // one exchange: each warp's sum, then the K sums reduced by shuffles
    // in the same order in every warp
    const int lane = threadIdx.x % kWarp;
    if (lane == 0) partial[threadIdx.x / kWarp] = ss;
    __syncthreads();
    ss = partial[lane % K];
#pragma unroll
    for (int off = K / 2; off > 0; off /= 2)
      ss += __shfl_xor_sync(kFull, ss, off);
  }
  const float r = rsqrtf(ss / static_cast<float>(nvec * kN) + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + row * nvec * kN);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * kG + t;
    if (v < nvec) {
      float f[kN], s[kN];
      Vec<T>::unpack(xv[j], f);
      SV::unpack(sv[j], s);
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = f[i] * r * s[i];
      Vec<T>::store(reinterpret_cast<T*>(orow + v), f);
    }
  }
}

// PREVIOUS: one block of 128 threads a row, two passes.
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
int launch_previous(const void* x, const void* scale, void* out,
                    int64_t row_stride, int rows, int D, float eps,
                    cudaStream_t stream) {
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

template <typename T, typename TS, int VPT, int K>
int launch_rows(const void* x, const void* scale, void* out,
                int64_t row_stride, int rows, int nvec, float eps,
                int rows_per_block, int threads, cudaStream_t stream) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_rows_kernel<T, TS, VPT, K><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(out), row_stride, rows, nvec, eps);
  return static_cast<int>(cudaGetLastError());
}

// The (VPT, K) plans that REGS is built for; any other is refused.  K = 1:
// VPT 1, 2 (a row of up to 64 vectors) and 4, 8 (the many-row layout);
// K = 2..16: VPT 2; K = 32: VPT 2, 3 in bf16 and 2-5 in f32 (what 64
// registers a thread hold at 1024 threads).
template <typename T, typename TS>
int launch_regs(const void* x, const void* scale, void* out,
                int64_t row_stride, int rows, int nvec, float eps, int vpt,
                int k, int rows_per_block, int threads,
                cudaStream_t stream) {
#define RMS_PLAN(V, KK)                                                   \
  if (vpt == V && k == KK)                                                \
    return launch_rows<T, TS, V, KK>(x, scale, out, row_stride, rows,     \
                                     nvec, eps, rows_per_block, threads,  \
                                     stream);
  RMS_PLAN(1, 1) RMS_PLAN(2, 1) RMS_PLAN(4, 1) RMS_PLAN(8, 1)
  RMS_PLAN(2, 2) RMS_PLAN(2, 4) RMS_PLAN(2, 8) RMS_PLAN(2, 16)
  RMS_PLAN(2, 32) RMS_PLAN(3, 32)
  if constexpr (sizeof(T) == 4) {
    RMS_PLAN(4, 32) RMS_PLAN(5, 32)
  }
#undef RMS_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

// A plan REGS takes: its (VPT, K) row group covers the row's vectors, its
// block is whole row groups (one where K > 1, at most four warps where
// K = 1), and every address it reads or writes as a vector is on the
// 16-byte width.
template <typename T>
bool regs_plan_ok(const void* x, const void* scale, const void* out,
                  int64_t row_stride, int rows, int D, int vpt, int k,
                  int rows_per_block, int threads) {
  const int kN = Vec<T>::kN;
  if (D % kN != 0 || k < 1 || vpt < 1 || rows_per_block < 1) return false;
  if (threads != kWarp * k * rows_per_block) return false;
  if (k > 1 ? rows_per_block != 1 : rows_per_block > kMaxRowsPerBlock)
    return false;
  if (static_cast<int64_t>(kWarp) * k * vpt < D / kN) return false;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(scale) |
                      reinterpret_cast<uintptr_t>(out);
  if (a % 16 != 0) return false;
  return rows == 1 ||
         (row_stride * static_cast<int64_t>(sizeof(T))) % 16 == 0;
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* out, int64_t row_stride,
           int rows, int D, float eps, int route, int vpt, int k,
           int rows_per_block, int threads, cudaStream_t stream) {
  if (route == kPrevious) {
    if (threads != kThreads || rows_per_block != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_previous<T, TS>(x, scale, out, row_stride, rows, D, eps,
                                  stream);
  }
  if (route != kRegs ||
      !regs_plan_ok<T>(x, scale, out, row_stride, rows, D, vpt, k,
                       rows_per_block, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_regs<T, TS>(x, scale, out, row_stride, rows,
                            D / Vec<T>::kN, eps, vpt, k, rows_per_block,
                            threads, stream);
}

}  // namespace

// x: rows of D elements, `row_stride` elements apart; out: contiguous.
// dtype / scale_dtype: 0 = float32, 1 = bfloat16.  route 0 = PREVIOUS
// (threads 128, rows_per_block 1; vpt and k unused), 1 = REGS with the
// plan (vpt, k = warps a row, rows_per_block, threads) of
// repro_torch/kernels/rmsnorm.py::norm_plan.  Launches on `stream`;
// returns cudaGetLastError() (0 on success) or cudaErrorInvalidValue for a
// shape, type or plan the kernel does not take.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int64_t row_stride, int rows, int D, float eps,
                              int dtype, int scale_dtype, int route, int vpt,
                              int k, int rows_per_block, int threads,
                              void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || D <= 0 || row_stride < D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define RMS_ARGS x, scale, out, row_stride, rows, D, eps, route, vpt, k, \
                 rows_per_block, threads, s
  if (dtype == 0 && scale_dtype == 0) return launch<float, float>(RMS_ARGS);
  if (dtype == 0 && scale_dtype == 1) return launch<float, bf16>(RMS_ARGS);
  if (dtype == 1 && scale_dtype == 0) return launch<bf16, float>(RMS_ARGS);
  if (dtype == 1 && scale_dtype == 1) return launch<bf16, bf16>(RMS_ARGS);
#undef RMS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
