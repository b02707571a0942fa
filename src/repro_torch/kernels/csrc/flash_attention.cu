// Flash attention (causal and/or sliding-window band, GQA) for the
// full-sequence forward pass of the model zoo.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel.  Contract: repro_torch/kernels/ref.py::ref_attention, up
// to the order of the f32 sums: logits q.k * hd^-0.5 in f32, entries
// outside the band masked, an online softmax whose running max m, sum l
// and accumulator stay f32, masked probabilities exactly 0, and out =
// acc / max(l, 1e-30) rounded to the input type.
//
// Layout: q (B,H,S,hd), k/v (B,KV,S,hd) and out (B,H,S,hd), each given by
// its element strides over (b, h, s) with a contiguous hd axis, so the
// model's (B,S,H,hd) activations are read and written in place through
// transposed views.  Query head h reads KV head h / (H/KV) directly: no
// repeated K/V is materialised.  hd is 64, 112, 128 or 192; f32 or bf16.
//
// Two bodies, chosen by the launcher's `route`:
//
// route 0, flash_kernel (f32, bf16 views whose rows are not 16-byte
// aligned, and bf16 when asked for): the CUDA cores
// in f32.  One block of 8 warps owns 64 query rows of one (b, h) and
// loops over K tiles of 64 rows, so m, l and acc live in registers for
// the whole sweep (the TPU carries them in VMEM scratch between grid
// steps instead).  Each warp owns 8 query rows: lane j scores keys j and
// j+32 of the tile (K rows padded by one float in shared memory, so the
// 32 lanes hit 32 banks), reduces the row max and sum with shuffles,
// parks its probabilities in shared memory, and accumulates P.V over its
// ceil(hd/32) output columns.  The f32 goldens need this body: a
// tensor-core product would round q and k to bf16 or TF32.
//
// route 1, flash_tc_kernel (bf16): the tensor cores, FA2-style.  Bound:
// at (B 8, H 32, S 512, hd 64) the causal work is 8.6 GFLOP, 8.7 us at
// the bf16 peak against 12.5 us of bytes, where f32 FMAs on the CUDA
// cores took 13x SDPA; at the serve shapes (S 64, one sequence) the
// bytes and the launch bound it.  Design: 4 warps a block, each owning
// 16 query rows.
// The Q tile arrives by cp.async and goes by ldmatrix into A fragments
// that stay in registers for the whole sweep (at hd 192 they are read
// from shared memory at each k-step instead: its 16 x 192 f32 O
// accumulator already takes 96 registers a thread).  K and V tiles of
// 64 rows run through a two-stage cp.async.cg ring (tile j+1 loads while
// tile j computes); shared rows are padded by 8 bf16 (16 B) so a row is an odd
// number of 16-byte chunks and ldmatrix is conflict-free at hd 64, 112,
// 128 and 192.  S = Q.K^T is mma.sync.m16n8k16 (bf16 in, f32 out) with K
// fragments from ldmatrix; the scale (folded with log2 e) and the band
// mask act on the fragments; the row max and sum are f32, reduced over
// each row's 4-lane quad.  P is rounded to bf16 in registers and used
// as the A operand of P.V directly (V fragments from ldmatrix.trans), O
// accumulates in f32 registers, and the epilogue rounds once.  hd 112 is
// 7 k-steps of 16 for Q.K^T and 14 n8 tiles for P.V.  cp.async needs
// 16-byte rows: the wrapper checks every base pointer and (b, h, s)
// stride and sends bf16 input that fails to route 0.
//
// Both bodies skip whole K tiles outside the causal/window band (the
// loop ends at the diagonal), mask the fringe element by element, and
// mask a ragged last tile (S not a multiple of 64) rather than refuse it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_bf16.cuh"

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

// ---- route 1: bf16 on the tensor cores -------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * kWarp;
constexpr int kTcRows = 16;              // query rows per warp: one m16
constexpr int kTcBQ = kTcWarps * kTcRows;  // query rows per block
constexpr int kPad = 8;                  // bf16 padding of a shared row
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr int tc_smem_bytes() {          // Q, and two stages of K and V
  return (kTcBQ + 4 * kBK) * (HD + kPad) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// at least two blocks an SM up to hd 128: ptxas then gives the hd 112
// and 128 bodies more registers, which paid at every serve shape and at
// hd 128 S 512.  At hd 192 the 128,000 B of shared memory allow one block
// an SM, and the bound lets ptxas take what it needs.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD <= 128 ? 2 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                Strides vs, Strides os, int S, int groups, float scale_log2,
                int causal, int window) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = HD + kPad;         // shared row pitch, elements
  constexpr int kChunks = HD / 8;        // 16-byte chunks of a row
  constexpr int kKSteps = HD / 16;       // k16 steps of Q.K^T
  constexpr int kNT = HD / 8;            // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // kTcBQ x kLd
  bf16* k_s = q_s + kTcBQ * kLd;                    // 2 stages, kBK x kLd
  bf16* v_s = k_s + 2 * kBK * kLd;                  // 2 stages, kBK x kLd

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * kTcBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / groups;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  // the K tiles that meet the band: [first, last]
  const int nk = (S + kBK - 1) / kBK;
  int last = nk - 1;
  if (causal) last = min(last, (q0 + kTcBQ - 1) / kBK);
  int first = 0;
  if (window > 0 && q0 - window - (kBK - 1) >= 0)
    first = (q0 - window - (kBK - 1)) / kBK + 1;

  // rows row0.. of src into dst; rows past S are zero-filled, so a ragged
  // tile feeds zeros (never stale values) to the products
  auto load_rows = [&](bf16* dst, const bf16* src, int64_t stride,
                       int row0, int rows) {
    for (int c = tid; c < rows * kChunks; c += kTcThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool in = row0 + r < S;
      tc::cp_async16(dst + r * kLd + col,
                     in ? src + (row0 + r) * stride + col : src, in);
    }
  };

  load_rows(q_s, qb, qs.s, q0, kTcBQ);
  tc::cp_async_commit();
  if (first <= last) {
    load_rows(k_s, kb, ks.s, first * kBK, kBK);
    load_rows(v_s, vb, vs.s, first * kBK, kBK);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<1>();                // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A fragments: held in registers up to
  // hd 128; at hd 192 the O accumulator alone takes 96 registers a
  // thread, so the fragments are read from shared memory at each k-step
  constexpr bool kQRegs = HD <= 128;
  const bf16* q_frag = q_s + (warp * kTcRows + (lane & 15)) * kLd +
                       (lane >> 4) * 8;
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
  // this thread's rows are qr and qr + 8; m in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qr = q0 + warp * kTcRows + g;

  for (int kt = first; kt <= last; ++kt) {
    const int st = (kt - first) & 1;
    if (kt < last) {                     // prefetch tile kt + 1
      load_rows(k_s + (st ^ 1) * kBK * kLd, kb, ks.s, (kt + 1) * kBK, kBK);
      load_rows(v_s + (st ^ 1) * kBK * kLd, vb, vs.s, (kt + 1) * kBK, kBK);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();              // tile kt has landed
    __syncthreads();
    const bf16* kst = k_s + st * kBK * kLd;
    const bf16* vst = v_s + st * kBK * kLd;
    const int k0 = kt * kBK;
    // s[j]: rows qr, qr + 8 against keys k0 + 8j + 2 t4 (+1)
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
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
#pragma unroll
      for (int jj = 0; jj < kBK / 16; ++jj) {
        uint32_t r[4];
        tc::ldmatrix_x4(
            r, kst + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                   kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * jj], qa, r[0], r[1]);
        tc::mma_bf16(s[2 * jj + 1], qa, r[2], r[3]);
      }
    }

    const bool fringe = k0 + kBK > S || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kTcBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool in = true;
        if (fringe) {
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = qr + (e >> 1) * 8;
          in = kp < S;
          if (causal) in = in && kp <= qp;
          if (window > 0) in = in && kp > qp - window;
        }
        s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      // a row with no key in the band yet keeps p = 0 and alpha = 0
      const float mu = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m[r] - mu);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - mu);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - mu);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;         // this lane's share of the row
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P.V: the probabilities of keys 16kk.. are the A fragment
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(
            r, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                   dd * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dd], a, r[0], r[1]);
        tc::mma_bf16(acc[2 * dd + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();                     // stage st is free again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float denom = fmaxf(lt, 1e-30f);
    const int qp = qr + 8 * r;
    if (qp >= S) continue;
    bf16* orow = ob + qp * os.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = tc::pack_bf16(
          acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
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

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const int64_t* st, int B, int H, int S, int groups, float scale,
              int causal, int window, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // cp.async moves 16-byte chunks: every base and (b, h, s) stride must
  // keep a row 16-byte aligned (the wrapper checks this first)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kTcBQ - 1) / kTcBQ, H, B);
  using bf16 = __nv_bfloat16;
  flash_tc_kernel<HD><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), qs, ks, vs, os, S,
      groups, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and out in that order.
// dtype: 0 = float32, 1 = bfloat16.  route: 0 = the CUDA-core body
// (either dtype), 1 = the tensor-core body (bfloat16 only, 16-byte
// aligned rows).  Launches on `stream`; returns cudaGetLastError() (0 on
// success) or an error for a shape, type or alignment the body does not
// take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int B, int H,
                                      int S, int hd, int groups, int causal,
                                      int window, float scale, int dtype,
                                      int route, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (groups <= 0 || H % groups != 0 || window < 0 || B > 65535 ||
      H > 65535 || (route != 0 && route != 1) || (route == 1 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (hd == 64)
      return launch_tc<64>(q, k, v, o, strides, B, H, S, groups, scale,
                           causal, window, s);
    if (hd == 112)
      return launch_tc<112>(q, k, v, o, strides, B, H, S, groups, scale,
                            causal, window, s);
    if (hd == 128)
      return launch_tc<128>(q, k, v, o, strides, B, H, S, groups, scale,
                            causal, window, s);
    if (hd == 192)
      return launch_tc<192>(q, k, v, o, strides, B, H, S, groups, scale,
                            causal, window, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FLASH_CASE(DT, T, HD)                                               \
  if (dtype == DT && hd == HD)                                              \
    return launch<T, HD>(q, k, v, o, strides, B, H, S, groups, scale,       \
                         causal, window, s);
  FLASH_CASE(0, float, 64)
  FLASH_CASE(0, float, 112)
  FLASH_CASE(0, float, 128)
  FLASH_CASE(0, float, 192)
  FLASH_CASE(1, __nv_bfloat16, 64)
  FLASH_CASE(1, __nv_bfloat16, 112)
  FLASH_CASE(1, __nv_bfloat16, 128)
  FLASH_CASE(1, __nv_bfloat16, 192)
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
