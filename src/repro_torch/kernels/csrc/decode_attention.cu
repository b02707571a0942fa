// Flash decode: one query token per (batch row, head) against a KV cache
// whose first lengths[b] rows are valid.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// _decode_kernel.  Contract: repro_torch/kernels/ref.py::
// ref_decode_attention, up to the order of the f32 sums: logits
// q.k * hd^-0.5 in f32 over the valid prefix only, an online softmax in
// f32, out = acc / max(l, 1e-30) rounded to the input type (a row with
// no valid key gives 0, as the TPU kernel does; the plain version
// averages V there instead).
//
// Layout: q (B,H,hd) and out (B,H,hd) by their (b, h) element strides; the
// cache k/v (B,KV,W,hd) by its (b, kv, w) element strides, hd contiguous.
// The model hands over a transposed view of its (B,W,KV,hd) per-layer
// cache, and this kernel reads it in place: a copy into (B,KV,W,hd) would
// move the whole cache every step, far more bytes than the valid prefix
// the kernel reads.  hd is 64, 112, 128 or 192; f32 or bf16.
//
// Bound: bytes.  Each step reads the valid prefix of K and V once per KV
// head (2 * B * KV * len * hd elements) for 4 * B * H * len * hd FLOPs,
// about one FLOP per byte in bf16 with GQA groups of 4 — far below the
// card's ~295 FLOP/byte ridge.  So the design aims at bytes in flight and
// at reading each cache row from HBM once.
//
// route 1, split-KV "flash decoding" (decode_split_tc_kernel for bf16,
// decode_split_kernel for f32).  Grid (splits, KV * head tiles, B): one
// block of 4 warps serves one (b, kv head, slice of the W axis) and all
// the query heads of that KV head (up to kMaxG at once; more heads take
// more head tiles), so a cache row leaves HBM once however large the GQA
// group.  The host picks `splits` from W and B * KV alone (about two
// blocks an SM, slices of whole 64-row units), never from the values of
// `lengths`, so a launch needs no host sync and a CUDA graph can hold
// it.  A block whose slice starts at or past lengths[b] writes an empty
// partial (m = -inf, l = 0).  K/V rows are staged into shared memory by
// 16-byte cp.async copies (consecutive threads on consecutive chunks of
// a row) where the base pointers and (b, kv, w) strides are 16-byte
// multiples, and by element loads otherwise; rows past the slice's valid
// end are zero-filled, and shared rows are padded by 16 bytes (an odd
// number of 16-byte chunks: no bank conflicts).
//   bf16: the group's heads are the 16 rows of mma.sync.m16n8k16; each
// warp takes every fourth 16-row tile of the slice through its own
// two-stage ring and keeps its own f32 (m, l, O), as flash attention's
// tensor-core body does, and the four warps merge through shared memory
// at the end.  P is rounded to bf16 for P.V, as the plain version
// rounds its probabilities.
//   f32 (the goldens' path): 32-row tiles through a two-stage ring shared
// by the block; threads score (head, row) pairs on the CUDA cores, one
// warp per head updates that head's (m, l), and threads accumulate P.V
// for (head, column pair) items into f32 accumulators in shared memory.
//   With one split the block writes out itself.  Otherwise it writes its
// partial (m, l, acc[hd]) in f32 to a workspace, takes a ticket from an
// atomic counter of its (b, kv head, head tile), and the last block to
// arrive merges every partial of the group: out = sum_s e^(m_s - M)
// acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), skipping empty partials,
// then resets the counter to 0 for the next launch.  So a call is one
// launch, with no second merge kernel.
//
// route 0, decode_kernel (the earlier body, kept to be timed beside the
// split kernel): grid (H, B), one block of 4 warps per (b, h); lane i of
// a warp scores cache row i of a 32-row slice from q in shared memory,
// the warp reduces the slice's max and sum with shuffles, and each lane
// accumulates P.V into its ceil(hd/32) output columns; the four warps'
// (m, l, acc) are merged at the end.  Query heads of one KV head re-read
// the same rows (from L2).  It reads K with 16-byte loads, so it needs
// 16-byte aligned pointers and strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"

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

// ---- route 1: split-KV -------------------------------------------------

constexpr int kTile = 32;                // cache rows a block tile (f32)
constexpr int kMaxG = 16;                // query heads a block at most
constexpr float kLog2e = 1.4426950408889634f;

// one 16-byte chunk of floats
__device__ __forceinline__ void chunk_to_f(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
// two neighbouring elements as floats
__device__ __forceinline__ float2 pair_to_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Rows row0.. (rows at or past r1 zero-filled) of one cache into a
// shared tile of `rows` rows with pitch ld, by the `n` threads numbered
// `i`: 16-byte cp.async copies when `vec`, element loads otherwise.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t stride, int row0, int r1,
                                          int rows, int hd, int ld, int i,
                                          int n, bool vec) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int chunks = hd / kVec;
  for (int c = i; c < rows * chunks; c += n) {
    const int r = c / chunks, col = (c % chunks) * kVec;
    const int row = row0 + r;
    const bool in = row < r1;
    const T* from = src + row * stride + col;
    if (vec) {
      tc::cp_async16(dst + r * ld + col, in ? from : src, in);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dst[r * ld + col + e] = in ? from[e] : from_f<T>(0.f);
    }
  }
}

// The block's place in the grid (splits, KV * head tiles, B) and its slice.
struct Slice {
  int split, kvh, h0, gh, b, r0, r1;
  int valid;                             // splits that hold a valid row
  int64_t part0;                         // partial of (b, h0, split)
};

__device__ __forceinline__ Slice slice_of(const int32_t* lengths, int H,
                                          int W, int groups, int gt,
                                          int splits, int chunk) {
  Slice sl;
  const int tiles_h = (groups + gt - 1) / gt;
  sl.split = blockIdx.x;
  sl.kvh = blockIdx.y / tiles_h;
  sl.h0 = sl.kvh * groups + (blockIdx.y % tiles_h) * gt;
  sl.gh = min(gt, (sl.kvh + 1) * groups - sl.h0);
  sl.b = blockIdx.z;
  const int len = min(max(lengths[sl.b], 0), W);
  sl.r0 = sl.split * chunk;
  sl.r1 = min(sl.r0 + chunk, len);
  sl.valid = min(splits, (len + chunk - 1) / chunk);
  // partial (b, h, s) sits at (b * H + h) * splits + s
  sl.part0 = (static_cast<int64_t>(sl.b) * H + sl.h0) * splits + sl.split;
  return sl;
}

// The end of a block's slice: out itself when there is one split, else
// its partial (m, l, acc[hd]) for head g of the block, an empty partial
// (m = -inf, l = 0, acc not written) where the slice held no valid row.
template <typename T>
__device__ __forceinline__ void put_result(const Slice& sl, int g, int d,
                                           float acc, float m, float l,
                                           T* o, int64_t osb, int64_t osh,
                                           float* ws_ml, float* ws_acc,
                                           int hd, int splits) {
  if (splits == 1) {
    o[sl.b * osb + (sl.h0 + g) * osh + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
    return;
  }
  const int64_t part = sl.part0 + static_cast<int64_t>(g) * splits;
  if (l > 0.f) ws_acc[part * hd + d] = acc;
  if (d == 0) {
    ws_ml[part * 2] = m;
    ws_ml[part * 2 + 1] = l;
  }
}

// After every block of one (b, kv head, head tile) has written its
// partial, the last to arrive — found by an atomic ticket, which it then
// resets to 0 for the next launch — merges them.  The slices are cut in
// order, so the partials that hold a valid row are the first sl.valid
// (none when lengths[b] is 0, which gives zeros) and only those are
// read: every (m, l) into shared memory at once, per head the weights
// w_s = e^(m_s - M), then out = sum_s w_s acc_s / max(sum_s w_s l_s,
// 1e-30), four columns a thread.  `scratch` holds 3 * gh * splits + gh
// floats.
template <typename T>
__device__ void merge_last(const Slice& sl, const float* ws_ml,
                           const float* ws_acc, int* tickets, T* o,
                           int64_t osb, int64_t osh, int hd, int splits,
                           float* scratch) {
  __shared__ int last;
  __threadfence();                       // this block's partial is out
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int gh = sl.gh, nv = sl.valid, n = gh * splits;
  // head g's partial s: p0 + g * splits + s
  const int64_t p0 = sl.part0 - sl.split;
  float2* ml_s = reinterpret_cast<float2*>(scratch);
  float* w_s = scratch + 2 * n;
  float* den_s = w_s + n;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml) + p0;
  for (int i = tid; i < gh * nv; i += kThreads)
    ml_s[i] = __ldcg(ml + (i / nv) * splits + i % nv);
  __syncthreads();
  for (int g = warp; g < gh; g += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < nv; s += kWarp) mx = fmaxf(mx, ml_s[g * nv + s].x);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < nv; s += kWarp) {
      const float2 x = ml_s[g * nv + s];
      const float w = expf(x.x - mx);
      w_s[g * nv + s] = w;
      l += w * x.y;
    }
    l = warp_sum(l);
    if (lane == 0) den_s[g] = fmaxf(l, 1e-30f);   // l = 0: lengths[b] = 0
  }
  __syncthreads();
  // four columns an item, two items a thread at once: their loads of
  // every partial are issued without a branch, so they overlap
  const int q4 = hd / 4, items = gh * q4;
  for (int i0 = tid; i0 < items; i0 += 2 * kThreads) {
    const int i1 = i0 + kThreads < items ? i0 + kThreads : i0;
    const int gg[2] = {i0 / q4, i1 / q4};
    const float* acc[2];
    float a[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = u ? i1 : i0;
      acc[u] = ws_acc + (p0 + static_cast<int64_t>(gg[u]) * splits) * hd +
               (i % q4) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) a[u][e] = 0.f;
    }
#pragma unroll 8
    for (int s = 0; s < nv; ++s) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ws = w_s[gg[u] * nv + s];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            acc[u] + static_cast<int64_t>(s) * hd));
        a[u][0] = fmaf(ws, x.x, a[u][0]);
        a[u][1] = fmaf(ws, x.y, a[u][1]);
        a[u][2] = fmaf(ws, x.z, a[u][2]);
        a[u][3] = fmaf(ws, x.w, a[u][3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = u ? i1 : i0;
      if (u && i1 == i0) break;
      T* out = o + sl.b * osb + (sl.h0 + gg[u]) * osh + (i % q4) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = from_f<T>(a[u][e] / den_s[gg[u]]);
    }
  }
  if (tid == 0) *ticket = 0;
}

// -- f32: the CUDA cores -------------------------------------------------

template <int HD>
struct SplitShape {
  static constexpr int kLd = HD + 4;     // shared row pitch: odd chunks
  // a two-stage K/V ring, then q, acc (gt x HD), p (gt x kTile), m, l,
  // alpha (gt)
  static constexpr size_t kRingBytes =
      static_cast<size_t>(2) * 2 * kTile * kLd * sizeof(float);
  static size_t smem_bytes(int gt) {
    return kRingBytes +
           static_cast<size_t>(2 * gt * HD + gt * kTile + 3 * gt) *
               sizeof(float);
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ o, float* __restrict__ ws_ml,
                    float* __restrict__ ws_acc, int* __restrict__ tickets,
                    int64_t qsb, int64_t qsh, Strides3 ks, Strides3 vs,
                    int64_t osb, int64_t osh, int H, int W, int groups,
                    int gt, int splits, int chunk, float scale, int vec) {
  using Sh = SplitShape<HD>;
  constexpr int kLd = Sh::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [stage][K, V][kTile][kLd]
  float* q_s = reinterpret_cast<float*>(smem_raw + Sh::kRingBytes);
  float* acc_s = q_s + gt * HD;
  float* p_s = acc_s + gt * HD;
  float* m_s = p_s + gt * kTile;
  float* l_s = m_s + gt;
  float* a_s = l_s + gt;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const Slice sl = slice_of(lengths, H, W, groups, gt, splits, chunk);
  const int gh = sl.gh, r0 = sl.r0, r1 = sl.r1;
  for (int i = tid; i < gh * HD; i += kThreads) acc_s[i] = 0.f;
  for (int g = tid; g < gh; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  if (r0 < r1) {                         // uniform over the block
    const float* kb = k + sl.b * ks.b + sl.kvh * ks.h;
    const float* vb = v + sl.b * vs.b + sl.kvh * vs.h;
    auto load_tile = [&](int st, int row0) {
      float* kd = ring + st * 2 * kTile * kLd;
      load_rows(kd, kb, ks.s, row0, r1, kTile, HD, kLd, tid, kThreads, vec);
      load_rows(kd + kTile * kLd, vb, vs.s, row0, r1, kTile, HD, kLd, tid,
                kThreads, vec);
    };
    const int ntiles = (r1 - r0 + kTile - 1) / kTile;
    load_tile(0, r0);
    tc::cp_async_commit();
    for (int i = tid; i < gh * HD; i += kThreads)
      q_s[i] = q[sl.b * qsb + (sl.h0 + i / HD) * qsh + i % HD];

    for (int t = 0; t < ntiles; ++t) {
      const int st = t & 1;
      if (t + 1 < ntiles) load_tile(st ^ 1, r0 + (t + 1) * kTile);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();            // tile t has landed
      __syncthreads();
      const float* kst = ring + st * 2 * kTile * kLd;
      const float* vst = kst + kTile * kLd;
      const int row0 = r0 + t * kTile;

      // scores: item i is (head i / kTile, row i % kTile), so a warp
      // scores 32 rows of one head and reads that head's q as a broadcast
      for (int i = tid; i < gh * kTile; i += kThreads) {
        const int g = i / kTile, r = i % kTile;
        float s = -INFINITY;
        if (row0 + r < r1) {
          const float* kr = kst + r * kLd;
          const float* qr = q_s + g * HD;
          float part[4] = {0.f, 0.f, 0.f, 0.f};  // four short FMA chains
#pragma unroll
          for (int c = 0; c < HD; c += 4) {
            float kf[4];
            chunk_to_f(kr + c, kf);
            const float4 qv = *reinterpret_cast<const float4*>(qr + c);
            float& a = part[(c / 4) % 4];
            a = fmaf(qv.x, kf[0], a);
            a = fmaf(qv.y, kf[1], a);
            a = fmaf(qv.z, kf[2], a);
            a = fmaf(qv.w, kf[3], a);
          }
          s = ((part[0] + part[1]) + (part[2] + part[3])) * scale;
        }
        p_s[i] = s;
      }
      __syncthreads();

      // the online softmax, one warp a head: lane j holds row j
      for (int g = warp; g < gh; g += kWarps) {
        const float s = p_s[g * kTile + lane];
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(s));  // finite: row0 < r1
        const float alpha = expf(m_old - m_new);        // 0 on the first tile
        const float p = expf(s - m_new);                // 0 past r1
        const float sum = warp_sum(p);
        p_s[g * kTile + lane] = p;
        if (lane == 0) {
          m_s[g] = m_new;
          l_s[g] = l_s[g] * alpha + sum;
          a_s[g] = alpha;
        }
      }
      __syncthreads();

      // P.V: item i is (head, column pair); each item has one owner
      // thread for the whole sweep, so acc_s needs no barrier of its own
      for (int i = tid; i < gh * (HD / 2); i += kThreads) {
        const int g = i / (HD / 2), d = 2 * (i % (HD / 2));
        const float* pr = p_s + g * kTile;
        float a[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row parity][column]
#pragma unroll
        for (int r = 0; r < kTile; r += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + r);
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float2 x = pair_to_f(vst + (r + rr) * kLd + d);
            a[rr & 1][0] = fmaf(pp[rr], x.x, a[rr & 1][0]);
            a[rr & 1][1] = fmaf(pp[rr], x.y, a[rr & 1][1]);
          }
        }
        const float alpha = a_s[g];
        float* ac = acc_s + g * HD + d;
        ac[0] = ac[0] * alpha + (a[0][0] + a[1][0]);
        ac[1] = ac[1] * alpha + (a[0][1] + a[1][1]);
      }
      __syncthreads();                   // stage st and p_s are free
    }
  }
  __syncthreads();
  for (int i = tid; i < gh * HD; i += kThreads)
    put_result(sl, i / HD, i % HD, acc_s[i], m_s[i / HD], l_s[i / HD], o,
               osb, osh, ws_ml, ws_acc, HD, splits);
  if (splits > 1)
    merge_last(sl, ws_ml, ws_acc, tickets, o, osb, osh, HD, splits, ring);
}

// -- bf16: the tensor cores ------------------------------------------------
//
// The group's query heads are the 16 rows of mma.sync.m16n8k16 (rows past
// gh are zero).  Each warp takes every fourth 16-row tile of the block's
// slice through its own two-stage cp.async ring (a __syncwarp, no block
// barrier, between tiles) and keeps its own f32 (m, l, O) as flash
// attention's tensor-core body does: S = Q.K^T with K fragments from
// ldmatrix, the scale (folded with log2 e) and the row mask on the
// fragments, the softmax over each head's 4-lane quad, P rounded to bf16
// in registers as the A operand of P.V (V by ldmatrix.trans).  The four
// warps' states are merged through shared memory at the end.

constexpr int kTcRows = 16;              // cache rows a warp tile

template <int HD>
struct TcShape {
  static constexpr int kLd = HD + 8;     // shared row pitch: odd chunks
  // stages of a warp's ring: a third or fourth (room for them at hd 64
  // to 128) timed no faster on the H100 and fits fewer blocks an SM
  static constexpr int kStages = 2;
  // elements of one warp's ring: kStages stages of K and V
  static constexpr int kWarpRing = kStages * 2 * kTcRows * kLd;
  // Q (16 rows), then the four warps' rings; the end-of-block merge
  // reuses the rings
  static constexpr size_t kBytes =
      static_cast<size_t>(kTcRows * kLd + kWarps * kWarpRing) *
      sizeof(__nv_bfloat16);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int32_t* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                       int* __restrict__ tickets, int64_t qsb, int64_t qsh,
                       Strides3 ks, Strides3 vs, int64_t osb, int64_t osh,
                       int H, int W, int groups, int gt, int splits,
                       int chunk, float scale_log2, int vec) {
  using bf16 = __nv_bfloat16;
  using Sh = TcShape<HD>;
  constexpr int kLd = Sh::kLd, kStages = Sh::kStages;
  constexpr int kKSteps = HD / 16;       // k16 steps of Q.K^T
  constexpr int kNT = HD / 8;            // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kTcRows x kLd
  bf16* rings = q_s + kTcRows * kLd;              // [warp][stage][K, V]
  float* merge_s = reinterpret_cast<float*>(rings);

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int g = lane / 4, t4 = lane % 4;
  const Slice sl = slice_of(lengths, H, W, groups, gt, splits, chunk);
  const int gh = sl.gh, r0 = sl.r0, r1 = sl.r1;
  // per warp: m (log2 units) and l of rows g, g + 8, then O
  float* mw = merge_s;                             // [kWarps][16]
  float* lw = mw + kWarps * kTcRows;               // [kWarps][16]
  float* ow = lw + kWarps * kTcRows;               // [kWarps][16][HD]

  if (r0 < r1) {                         // uniform over the block
    const bf16* kb = k + sl.b * ks.b + sl.kvh * ks.h;
    const bf16* vb = v + sl.b * vs.b + sl.kvh * vs.h;
    bf16* ring = rings + warp * Sh::kWarpRing;
    auto load_tile = [&](int st, int row0) {
      bf16* kd = ring + st * 2 * kTcRows * kLd;
      load_rows(kd, kb, ks.s, row0, r1, kTcRows, HD, kLd, lane, kWarp, vec);
      load_rows(kd + kTcRows * kLd, vb, vs.s, row0, r1, kTcRows, HD, kLd,
                lane, kWarp, vec);
    };
    // this warp's tiles: warp, warp + 4, ... of the slice's 16-row tiles
    const int nt = (r1 - r0 + kTcRows - 1) / kTcRows;
    const int mine = warp < nt ? (nt - warp + kWarps - 1) / kWarps : 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < mine) load_tile(i, r0 + (warp + i * kWarps) * kTcRows);
      tc::cp_async_commit();
    }
    for (int i = tid; i < kTcRows * HD; i += kThreads) {
      const int h = i / HD, d = i % HD;
      q_s[h * kLd + d] = h < gh ? q[sl.b * qsb + (sl.h0 + h) * qsh + d]
                                : from_f<bf16>(0.f);
    }
    __syncthreads();

    // Q's A fragments: in registers up to hd 128, else read at each k-step
    constexpr bool kQRegs = HD <= 128;
    const bf16* q_frag = q_s + (lane & 15) * kLd + (lane >> 4) * 8;
    uint32_t qf[kQRegs ? kKSteps : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        tc::ldmatrix_x4(qf[kk], q_frag + kk * 16);
    }
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int i = 0; i < mine; ++i) {
      const int st = i % kStages;
      // the stage of tile i + kStages - 1 was consumed in iteration i - 1
      const int ahead = i + kStages - 1;
      if (ahead < mine)
        load_tile(ahead % kStages, r0 + (warp + ahead * kWarps) * kTcRows);
      tc::cp_async_commit();
      tc::cp_async_wait<kStages - 1>();  // tile i has landed
      __syncwarp();
      const bf16* kst = ring + st * 2 * kTcRows * kLd;
      const bf16* vst = kst + kTcRows * kLd;
      const int k0 = r0 + (warp + i * kWarps) * kTcRows;
      // s[j]: heads g, g + 8 against keys k0 + 8j + 2 t4 (+1)
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          tc::ldmatrix_x4(qa, q_frag + kk * 16);
        }
        uint32_t r[4];
        tc::ldmatrix_x4(r, kst + ((lane & 7) + ((lane >> 4) << 3)) * kLd +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[0], qa, r[0], r[1]);
        tc::mma_bf16(s[1], qa, r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = k0 + 8 * j + 2 * t4 + (e & 1) < r1
                        ? s[j][e] * scale_log2
                        : -INFINITY;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = fmaxf(m[rr], fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                                      fmaxf(s[1][2 * rr], s[1][2 * rr + 1])));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        // finite: key k0 is valid for every head
        const float alpha = exp2f(m[rr] - mx);
        m[rr] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[j][2 * rr] = exp2f(s[j][2 * rr] - mx);
          s[j][2 * rr + 1] = exp2f(s[j][2 * rr + 1] - mx);
          sum += s[j][2 * rr] + s[j][2 * rr + 1];
        }
        l[rr] = l[rr] * alpha + sum;     // this lane's share of the row
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[n][2 * rr] *= alpha;
          acc[n][2 * rr + 1] *= alpha;
        }
      }
      // O += P.V over the tile's 16 keys
      const uint32_t a[4] = {tc::pack_bf16(s[0][0], s[0][1]),
                             tc::pack_bf16(s[0][2], s[0][3]),
                             tc::pack_bf16(s[1][0], s[1][1]),
                             tc::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(
            r, vst + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dd * 16 +
                   (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dd], a, r[0], r[1]);
        tc::mma_bf16(acc[2 * dd + 1], a, r[2], r[3]);
      }
      __syncwarp();                      // stage st is free again
    }

    __syncthreads();                     // every ring is consumed
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lt = l[rr];
      lt += __shfl_xor_sync(kFull, lt, 1);
      lt += __shfl_xor_sync(kFull, lt, 2);
      if (t4 == 0) {
        mw[warp * kTcRows + g + 8 * rr] = m[rr];
        lw[warp * kTcRows + g + 8 * rr] = lt;
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float* orow = ow + (warp * kTcRows + g + 8 * rr) * HD + 8 * n + 2 * t4;
        orow[0] = acc[n][2 * rr];
        orow[1] = acc[n][2 * rr + 1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gh * HD; i += kThreads) {
    const int h = i / HD, d = i % HD;
    float mx = -INFINITY, ll = 0.f, oo = 0.f;
    if (r0 < r1) {                       // warp 0 had a tile: mx is finite
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mw[w * kTcRows + h]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float sc = exp2f(mw[w * kTcRows + h] - mx);   // 0: no tile
        ll += sc * lw[w * kTcRows + h];
        oo += sc * ow[(w * kTcRows + h) * HD + d];
      }
      mx /= kLog2e;                      // natural-log units, as the f32 body
    }
    put_result(sl, h, d, oo, mx, ll, o, osb, osh, ws_ml, ws_acc, HD,
               splits);
  }
  if (splits > 1)
    merge_last(sl, ws_ml, ws_acc, tickets, o, osb, osh, HD, splits,
               merge_s);
}

// the end-of-block scratch (the warps' states, then the merge's 3 * 16 *
// 128 + 16 floats at most) must fit where the rings were
static_assert(TcShape<64>::kBytes - kTcRows * (64 + 8) * 2 >=
                  (2 * kWarps * kTcRows + kWarps * kTcRows * 64) * 4 &&
              TcShape<64>::kBytes - kTcRows * (64 + 8) * 2 >=
                  (3 * kMaxG * 128 + kMaxG) * 4 &&
              SplitShape<64>::kRingBytes >= (3 * kMaxG * 128 + kMaxG) * 4,
              "merge scratch");

template <int HD>
int launch_split(const void* q, const void* k, const void* v,
                 const void* lengths, void* o, void* ws, void* tickets,
                 const int64_t* st, int B, int H, int W, int groups,
                 float scale, int dtype, int splits, int chunk,
                 cudaStream_t stream) {
  const int kv = H / groups;
  const int gt = min(groups, kMaxG);
  const int tiles_h = (groups + gt - 1) / gt;
  if (static_cast<int64_t>(kv) * tiles_h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = dtype == 0 ? 4 : 2;
  // 16-byte copies where both caches' base and (b, kv, w) strides allow
  int vec = (reinterpret_cast<uintptr_t>(k) |
             reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 2; i < 8; ++i) vec = vec && (st[i] * elt) % 16 == 0;
  const Strides3 ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  // (m, l) of every partial, padded to 16 bytes, then acc[hd] of each
  float* ws_ml = static_cast<float*>(ws);
  float* ws_acc = ws_ml == nullptr
                      ? nullptr
                      : ws_ml + (static_cast<int64_t>(B) * H * splits * 2 +
                                 3) / 4 * 4;
  int* tk = static_cast<int*>(tickets);
  const dim3 grid(splits, kv * tiles_h, B);
  if (dtype == 0) {
    using Sh = SplitShape<HD>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::smem_bytes(kMaxG)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    decode_split_kernel<HD><<<grid, kThreads, Sh::smem_bytes(gt), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int32_t*>(lengths),
        static_cast<float*>(o), ws_ml, ws_acc, tk, st[0], st[1], ks, vs,
        st[8], st[9], H, W, groups, gt, splits, chunk, scale, vec);
  } else {
    using Sh = TcShape<HD>;
    using bf16 = __nv_bfloat16;
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_split_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::kBytes));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    decode_split_tc_kernel<HD><<<grid, kThreads, Sh::kBytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int32_t*>(lengths),
        static_cast<bf16*>(o), ws_ml, ws_acc, tk, st[0], st[1], ks, vs,
        st[8], st[9], H, W, groups, gt, splits, chunk, scale * kLog2e, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 10 element strides — q (b, h), k (b, kv, w), v (b, kv, w),
// out (b, h).  dtype: 0 = float32, 1 = bfloat16.  route: 1 = split-KV
// over `splits` slices of `chunk` rows (with splits > 1, ws holds
// ceil(B*H*splits*2 / 4)*4 + B*H*splits*hd floats and tickets
// B*KV*ceil(groups/16) ints, all 0 before the first launch and left 0 by
// every launch), 0 = the
// one-block-per-(b, h) body (16-byte aligned k/v only).  Launches on
// `stream`; returns cudaGetLastError() (0 on success) or an error for a
// shape, plan or alignment the body does not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* o, void* ws, void* tickets,
                                       const int64_t* strides, int B, int H,
                                       int W, int hd, int groups, float scale,
                                       int dtype, int route, int splits,
                                       int chunk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (W <= 0 || groups <= 0 || H % groups != 0 || B > 65535 ||
      (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    // the last block's merge keeps gh * splits weights where the tiles were
    if (splits < 1 || splits > 128 || chunk < 1 ||
        static_cast<int64_t>(splits) * chunk < W ||
        (splits > 1 && (ws == nullptr || tickets == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 64)
      return launch_split<64>(q, k, v, lengths, o, ws, tickets, strides, B,
                              H, W, groups, scale, dtype, splits, chunk, s);
    if (hd == 112)
      return launch_split<112>(q, k, v, lengths, o, ws, tickets, strides, B,
                               H, W, groups, scale, dtype, splits, chunk, s);
    if (hd == 128)
      return launch_split<128>(q, k, v, lengths, o, ws, tickets, strides, B,
                               H, W, groups, scale, dtype, splits, chunk, s);
    if (hd == 192)
      return launch_split<192>(q, k, v, lengths, o, ws, tickets, strides, B,
                               H, W, groups, scale, dtype, splits, chunk, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elt = dtype == 0 ? 4 : 2;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 2; i < 8; ++i)
    if ((strides[i] * elt) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
#define DECODE_CASE(DT, T, HD)                                              \
  if (dtype == DT && hd == HD)                                              \
    return launch<T, HD>(q, k, v, lengths, o, strides, B, H, W, groups,     \
                         scale, s);
  DECODE_CASE(0, float, 64)
  DECODE_CASE(0, float, 112)
  DECODE_CASE(0, float, 128)
  DECODE_CASE(0, float, 192)
  DECODE_CASE(1, __nv_bfloat16, 64)
  DECODE_CASE(1, __nv_bfloat16, 112)
  DECODE_CASE(1, __nv_bfloat16, 128)
  DECODE_CASE(1, __nv_bfloat16, 192)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
