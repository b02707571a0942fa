// Flash attention (causal and/or sliding-window band, GQA) for the
// full-sequence forward pass of the model zoo.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel.  Contract: repro_torch/kernels/ref.py::ref_attention, up
// to the order of the f32 sums: logits q.k * hd^-0.5 in f32, entries
// outside the band filled with -1e30, an online softmax whose running
// max m, sum l and accumulator stay f32, masked probabilities exactly 0,
// and out = acc / max(l, 1e-30) rounded to the input type.
//
// Layout: q (B,H,S,hd), k/v (B,KV,S,hd) and out (B,H,S,hd), each given by
// its element strides over (b, h, s) with a contiguous hd axis, so the
// model's (B,S,H,hd) activations are read and written in place through
// transposed views.  Query head h reads KV head h / (H/KV) directly: no
// repeated K/V is materialised.  hd is 64, 112 or 128; f32 or bf16.
//
// Bound: at the serve path's shapes (S = 64, hd 64/128, one sequence) the
// work is a few MFLOP per head against about 1 MB of q/k/v/out, so the
// bytes bound it; at long S the causal FLOPs, 2*B*H*S^2*hd, do.  This
// first version computes on the CUDA cores in f32 (no wgmma, no TMA).
// Design: the TPU runs the K-block grid axis in order and carries m, l,
// acc in VMEM scratch between grid steps; here one block of 8 warps owns
// 64 query rows of one (b, h) and loops over K tiles of 64 rows itself,
// so m, l and acc live in registers for the whole sweep.  Each warp owns
// 8 query rows: lane j scores keys j and j+32 of the tile (K rows padded
// by one float in shared memory, so the 32 lanes hit 32 banks), reduces
// the row max and sum with shuffles, parks its probabilities in shared
// memory, and then accumulates P.V over its ceil(hd/32) output columns
// (at hd 112 the fourth column exists only for lanes 0-15).  Whole
// K tiles outside the causal/window band are skipped (the loop ends at
// the diagonal), the fringe is masked element by element, and a ragged
// last tile (S not a multiple of 64) is masked rather than refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = kBQ / kWarps;      // query rows per warp
constexpr float kNeg = -1e30f;
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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Strides {                         // element strides over (b, h, s)
  int64_t b, h, s;
};

template <int HD>
constexpr int smem_floats() {
  return kBQ * HD + kBK * (HD + 1) + kBK * HD + kBQ * kBK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int S, int groups,
             float scale, int causal, int window) {
  constexpr int kCols = (HD + kWarp - 1) / kWarp;  // columns per lane
  // column j of this lane exists (always, unless HD is not a multiple
  // of 32, as 112 is)
  auto col_ok = [&](int j) {
    return HD % kWarp == 0 || threadIdx.x % kWarp + j * kWarp < HD;
  };
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kBQ x HD
  float* k_s = q_s + kBQ * HD;                    // kBK x (HD + 1)
  float* v_s = k_s + kBK * (HD + 1);              // kBK x HD
  float* p_s = v_s + kBK * HD;                    // kBQ x kBK

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / groups;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int qp = q0 + r;
    q_s[i] = qp < S ? to_f(qb[qp * qs.s + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int row0 = warp * kRows;         // this warp's first row in the tile
  const int q_last = q0 + kBQ - 1;
  const int nk = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (causal && k0 > q_last) break;                  // past the diagonal
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // below band
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int kp = k0 + r;
      const bool in = kp < S;
      k_s[r * (HD + 1) + d] = in ? to_f(kb[kp * ks.s + d]) : 0.f;
      v_s[i] = in ? to_f(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows row0..row0+7 against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k_lo = k_s + lane * (HD + 1);
    const float* k_hi = k_s + (lane + kWarp) * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float a0 = k_lo[d], a1 = k_lo[d + 1], a2 = k_lo[d + 2],
                  a3 = k_lo[d + 3];
      const float b0 = k_hi[d], b1 = k_hi[d + 1], b2 = k_hi[d + 2],
                  b3 = k_hi[d + 3];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (row0 + i) * HD + d);
        s[i][0] += qv.x * a0 + qv.y * a1 + qv.z * a2 + qv.w * a3;
        s[i][1] += qv.x * b0 + qv.y * b1 + qv.z * b2 + qv.w * b3;
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + row0 + i;
      float p2[2];
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + j * kWarp;
        bool in = kp < S;
        if (causal) in = in && kp <= qp;
        if (window > 0) in = in && kp > qp - window;
        ok[j] = in;
        s[i][j] = in ? s[i][j] * scale : kNeg;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
#pragma unroll
      for (int j = 0; j < 2; ++j) p2[j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p2[0] + p2[1]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
      p_s[(row0 + i) * kBK + lane] = p2[0];
      p_s[(row0 + i) * kBK + lane + kWarp] = p2[1];
    }
    __syncwarp();

    // acc[i][j] += sum_c P[row0 + i][c] * V[c][lane + 32 j]
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          vv[cc][j] = col_ok(j) ? v_s[(c + cc) * HD + lane + j * kWarp]
                                : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(p_s + (row0 + i) * kBK + c);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] += pv.x * vv[0][j] + pv.y * vv[1][j] + pv.z * vv[2][j] +
                       pv.w * vv[3][j];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col_ok(j))
        ob[qp * os.s + lane + j * kWarp] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int B, int H, int S, int groups, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  // above 48 KB a block's shared memory must be opted into, once per
  // instantiation (setting it twice is harmless)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, S,
      groups, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and out in that order.
// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns
// cudaGetLastError() (0 on success) or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int B, int H,
                                      int S, int hd, int groups, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (groups <= 0 || H % groups != 0 || window < 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DT, T, HD)                                               \
  if (dtype == DT && hd == HD)                                              \
    return launch<T, HD>(q, k, v, o, strides, B, H, S, groups, scale,       \
                         causal, window, s);
  FLASH_CASE(0, float, 64)
  FLASH_CASE(0, float, 112)
  FLASH_CASE(0, float, 128)
  FLASH_CASE(1, __nv_bfloat16, 64)
  FLASH_CASE(1, __nv_bfloat16, 112)
  FLASH_CASE(1, __nv_bfloat16, 128)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
