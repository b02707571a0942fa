// Flash decode: one query token per (batch row, head) against a KV cache
// whose first lengths[b] rows are valid.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// _decode_kernel.  Contract: repro_torch/kernels/ref.py::
// ref_decode_attention, up to the order of the f32 sums: logits
// q.k * hd^-0.5 in f32 over the valid prefix only, an online softmax in
// f32, out = acc / max(l, 1e-30) rounded to the input type (a row with
// no valid key gives 0, as the TPU kernel does).
//
// Layout: q (B,H,hd) and out (B,H,hd) by their (b, h) element strides; the
// cache k/v (B,KV,W,hd) by its (b, kv, w) element strides, hd contiguous.
// The model hands over a transposed view of its (B,W,KV,hd) per-layer
// cache, and this kernel reads it in place: a copy into (B,KV,W,hd) would
// move the whole cache every step, far more bytes than the valid prefix
// the kernel reads.  Rows of K are read with 16-byte loads, so the base
// pointers and strides must be multiples of 16 bytes (the wrapper checks).
//
// Bound: bytes.  Each step reads the valid prefix of K and V once per KV
// head (2 * B * KV * len * hd elements) for 4 * B * H * len * hd FLOPs,
// about one FLOP per byte in bf16 with GQA groups of 4 — far below the
// card's ~295 FLOP/byte ridge.  Design: the TPU walks the cache blocks of
// one (b, h) in order with m, l, acc in VMEM scratch; here one block of 4
// warps serves one (b, h) and splits the prefix into 32-row slices, dealt
// to the warps in turn.  In a slice each lane scores one cache row (a dot
// product over hd with q held in shared memory), the warp reduces the
// slice max and sum with shuffles, and each lane then accumulates P.V into
// its ceil(hd/32) output columns (hd 64, 112 or 128; at 112 the fourth
// column exists only for lanes 0-15), reading V rows coalesced.  Each
// warp keeps its own running (m, l, acc); the four are merged once at the
// end.  Query heads of one KV head sit in neighbouring blocks, so their
// second and later reads of the same cache rows are served from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
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

// q . row over hd, the row read in 16-byte chunks
template <int HD>
__device__ __forceinline__ float dot_row(const float* q_s, const float* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + d);
    acc += q_s[d] * x.x + q_s[d + 1] * x.y + q_s[d + 2] * x.z +
           q_s[d + 3] * x.w;
  }
  return acc;
}
template <int HD>
__device__ __forceinline__ float dot_row(const float* q_s,
                                         const __nv_bfloat16* row) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d);
    const __nv_bfloat162* pairs =
        reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(pairs[t]);
      acc += q_s[d + 2 * t] * f.x + q_s[d + 2 * t + 1] * f.y;
    }
  }
  return acc;
}

struct Strides3 {                        // element strides over (b, kv, w)
  int64_t b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int32_t* __restrict__ lengths,
              T* __restrict__ o, int64_t qsb, int64_t qsh, Strides3 ks,
              Strides3 vs, int64_t osb, int64_t osh, int W, int groups,
              float scale) {
  constexpr int kCols = (HD + kWarp - 1) / kWarp;
  // column j of this lane exists (always, unless HD is not a multiple
  // of 32, as 112 is)
  auto col_ok = [&](int j) {
    return HD % kWarp == 0 || threadIdx.x % kWarp + j * kWarp < HD;
  };
  __shared__ __align__(16) float q_s[HD];
  __shared__ float m_w[kWarps], l_w[kWarps];
  __shared__ float acc_w[kWarps][HD];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / groups;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int d = tid; d < HD; d += kThreads)
    q_s[d] = to_f(q[b * qsb + h * qsh + d]);
  __syncthreads();
  const int len = min(max(lengths[b], 0), W);

  float m = kNeg, l = 0.f, acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int base = warp * kWarp; base < len; base += kWarps * kWarp) {
    const int c = base + lane;
    const bool ok = c < len;
    const float s = ok ? dot_row<HD>(q_s, kb + c * ks.s) * scale : kNeg;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    const int n = min(kWarp, len - base);  // uniform across the warp
    for (int cc = 0; cc < n; ++cc) {
      const float pc = __shfl_sync(kFull, p, cc);
      const T* vrow = vb + (base + cc) * vs.s;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (col_ok(j)) acc[j] += pc * to_f(vrow[lane + j * kWarp]);
    }
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (col_ok(j)) acc_w[warp][lane + j * kWarp] = acc[j];
  __syncthreads();
  float mm = m_w[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_w[w]);
  float ll = 0.f, sc[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    sc[w] = expf(m_w[w] - mm);
    ll += l_w[w] * sc[w];
  }
  const float denom = fmaxf(ll, 1e-30f);
  for (int d = tid; d < HD; d += kThreads) {
    float od = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) od += acc_w[w][d] * sc[w];
    o[b * osb + h * osh + d] = from_f<T>(od / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, const int64_t* st, int B, int H, int W, int groups,
           float scale, cudaStream_t stream) {
  const Strides3 ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  const dim3 grid(H, B);
  decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(o), st[0], st[1], ks, vs, st[8], st[9], W, groups,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 10 element strides — q (b, h), k (b, kv, w), v (b, kv, w),
// out (b, h).  dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`;
// returns cudaGetLastError() (0 on success) or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* o, const int64_t* strides,
                                       int B, int H, int W, int hd,
                                       int groups, float scale, int dtype,
                                       void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (W <= 0 || groups <= 0 || H % groups != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_CASE(DT, T, HD)                                              \
  if (dtype == DT && hd == HD)                                              \
    return launch<T, HD>(q, k, v, lengths, o, strides, B, H, W, groups,     \
                         scale, s);
  DECODE_CASE(0, float, 64)
  DECODE_CASE(0, float, 112)
  DECODE_CASE(0, float, 128)
  DECODE_CASE(1, __nv_bfloat16, 64)
  DECODE_CASE(1, __nv_bfloat16, 112)
  DECODE_CASE(1, __nv_bfloat16, 128)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
