// Selective state-space scan (the Mamba2 / SSD core), from a zero state:
//   state_t = exp(a * dt_t) * state_{t-1} + dt_t * (x_t outer B_t)
//   y_t     = state_t . C_t
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py::_ssm_kernel.
// Contract: repro_torch/kernels/ref.py::ref_selective_scan, up to the
// order of the f32 sums: the (P, N) state in f32, each y_t and the final
// state rounded once to the input type.
//
// Layout: one sequence per (b, h).  x (B,H,S,P), dt (B,H,S), a (B,H),
// B/C (B,H,S,N) and y (B,H,S,P), each given by its element strides over
// (b, h[, s]) with a contiguous last axis; the final state (B,H,P,N) is
// contiguous.  So the model's (B,S,H,P) slice of its input projection is
// read in place through a transposed view, B and C, which all H heads
// share, are read through a zero head stride (no H-fold copy), a is a
// stride-0 broadcast of the per-head decay, and y is written in the
// layout the caller allocated.  x, dt, B, C and y are f32 or bf16 (one
// type); a is f32.  P <= 128 and N <= 128.
//
// Bound: operations.  Each step updates the whole (P, N) state (about
// 3 FLOPs an entry with the y product) on the CUDA cores in f32; at the
// serve path's shapes (B*H = 112 sequences, S 64, P = N = 64) that is
// about 150 MFLOP against 2.8 MB of x, B, C, y and final state.  The
// recurrence is sequential in t, so only the (b, h) sequences and the
// state's entries run in parallel.  Design: the TPU walks time chunks on
// a sequential grid axis with the state in VMEM scratch; here one block
// owns one (b, h) and loops over time itself, with the state in
// registers for the whole sweep.  Each state row p is held by TPR
// neighbouring lanes (TPR = 1, 2, 4 or 8, the fewest that cover N with
// 16 columns a lane; column n = j * TPR + r for lane r of the group, so
// the group reads 16 * TPR consecutive B/C values without bank
// conflicts), and y_t[p] is reduced over those lanes with shuffles.  A
// chunk of 32 steps of x, B, C, dt and exp(a dt) is staged in shared
// memory with coalesced loads; B/C columns past N are staged as zeros, so
// those state columns stay 0 and add nothing.  Any S is taken: the last
// chunk may be ragged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNPT = 16;                 // state columns per lane
constexpr int kChunk = 32;               // time steps staged at once
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
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

struct Strides {                         // element strides over (b, h, s)
  int64_t b, h, s;
};

constexpr int smem_bytes(int P, int NP) {
  return kChunk * (P + 2 * NP + 2) * static_cast<int>(sizeof(float));
}

// at most 1024 threads (P 128 x TPR 8), so at most 64 registers a thread
template <typename T>
__global__ void __launch_bounds__(1024)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                T* __restrict__ fin, Strides xs, Strides ds, int64_t asb,
                int64_t ash, Strides bs, Strides cs, Strides ys, int H,
                int S, int P, int N, int tpr) {
  extern __shared__ float smem[];
  const int np = tpr * kNPT;             // padded state width
  float* x_s = smem;                      // kChunk x P
  float* b_s = x_s + kChunk * P;          // kChunk x np
  float* c_s = b_s + kChunk * np;         // kChunk x np
  float* dt_s = c_s + kChunk * np;        // kChunk
  float* dec_s = dt_s + kChunk;           // kChunk

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p = tid / tpr;                // this lane's state row
  const int r = tid % tpr;                // its place in the row's group
  const bool row_ok = p < P;
  const T* xb = x + b * xs.b + h * xs.h;
  const T* db = dt + b * ds.b + h * ds.h;
  const T* bb = bm + b * bs.b + h * bs.h;
  const T* cb = cm + b * cs.b + h * cs.h;
  T* yb = y + b * ys.b + h * ys.h;
  const float av = a[b * asb + h * ash];

  float st[kNPT];
#pragma unroll
  for (int j = 0; j < kNPT; ++j) st[j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();                     // the previous chunk is consumed
    for (int i = tid; i < len * P; i += nthreads) {
      const int t = i / P, c = i % P;
      x_s[i] = to_f(xb[(t0 + t) * xs.s + c]);
    }
    for (int i = tid; i < len * np; i += nthreads) {
      const int t = i / np, c = i % np;
      const bool in = c < N;
      b_s[i] = in ? to_f(bb[(t0 + t) * bs.s + c]) : 0.f;
      c_s[i] = in ? to_f(cb[(t0 + t) * cs.s + c]) : 0.f;
    }
    for (int t = tid; t < len; t += nthreads) {
      const float d = to_f(db[(t0 + t) * ds.s]);
      dt_s[t] = d;
      dec_s[t] = expf(av * d);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      const float dec = dec_s[t];
      const float u = dt_s[t] * (row_ok ? x_s[t * P + p] : 0.f);
      const float* brow = b_s + t * np + r;
      const float* crow = c_s + t * np + r;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kNPT; ++j) {
        st[j] = st[j] * dec + u * brow[j * tpr];
        acc += st[j] * crow[j * tpr];
      }
      for (int off = tpr / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (r == 0 && row_ok) yb[(t0 + t) * ys.s + p] = from_f<T>(acc);
    }
  }

  if (row_ok) {
    T* fb = fin + ((static_cast<int64_t>(b) * H + h) * P + p) * N;
#pragma unroll
    for (int j = 0; j < kNPT; ++j) {
      const int n = j * tpr + r;
      if (n < N) fb[n] = from_f<T>(st[j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* fin, const int64_t* st, int B,
           int H, int S, int P, int N, cudaStream_t stream) {
  // the opt-in above 48 KB, once per instantiation, for the largest P, N
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxP, kMaxN));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int tpr = 1;
  while (tpr * kNPT < N) tpr *= 2;
  const int threads = (P * tpr + kWarp - 1) / kWarp * kWarp;
  const Strides xs{st[0], st[1], st[2]}, ds{st[3], st[4], st[5]},
      bs{st[8], st[9], st[10]}, cs{st[11], st[12], st[13]},
      ys{st[14], st[15], st[16]};
  const dim3 grid(H, B);
  ssm_scan_kernel<T><<<grid, threads, smem_bytes(P, tpr * kNPT), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), static_cast<T*>(fin),
      xs, ds, st[6], st[7], bs, cs, ys, H, S, P, N, tpr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 17 element strides — x (b, h, s), dt (b, h, s), a (b, h),
// B (b, h, s), C (b, h, s), y (b, h, s).  fin is contiguous (B,H,P,N).
// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C, y, fin); a is float32.
// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* fin, const int64_t* strides, int B,
                               int H, int S, int P, int N, int dtype,
                               void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B < 0 || H < 0 || S < 0 || P <= 0 || N <= 0 || P > kMaxP ||
      N > kMaxN || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, y, fin, strides, B, H, S, P, N,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, fin, strides, B, H, S,
                                 P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
