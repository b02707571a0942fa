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
// Two bodies, chosen by the launcher's `route`
// (repro_torch/kernels/ssm_scan.py::scan_route):
//
// route 0, ssm_scan_kernel (f32, and bf16's previous body): sequential,
// on the CUDA cores.  Bound: operations.  Each step updates the whole
// (P, N) state (about 3 FLOPs an entry with the y product) on the CUDA
// cores in f32; at the serve path's shapes (B*H = 112 sequences, S 64,
// P = N = 64) that is about 150 MFLOP against 2.8 MB of x, B, C, y and
// final state.  The recurrence is sequential in t, so only the (b, h)
// sequences and the state's entries run in parallel.  Design: the TPU
// walks time chunks on a sequential grid axis with the state in VMEM
// scratch; here one block owns one (b, h) and loops over time itself,
// with the state in registers for the whole sweep.  Each state row p is
// held by TPR neighbouring lanes (TPR = 1, 2, 4 or 8, the fewest that
// cover N with 16 columns a lane; column n = j * TPR + r for lane r of
// the group, so the group reads 16 * TPR consecutive B/C values without
// bank conflicts), and y_t[p] is reduced over those lanes with shuffles.
// A chunk of 32 steps of x, B, C, dt and exp(a dt) is staged in shared
// memory with coalesced loads; B/C columns past N are staged as zeros, so
// those state columns stay 0 and add nothing.  Any S is taken: the last
// chunk may be ragged.  At the serve shape it takes 64 dependent steps a
// block on 112 blocks, 15x its operation bound.
//
// route 1, ssm_chunk_kernel (bf16): the chunked (SSD) form on the
// tensor cores.  Time is cut into chunks of kQ = 64 steps (the serve
// path's S 64 is one chunk: no sequential step at all); within a chunk,
// with cum_t = sum_{s<=t} a dt_s in f32,
//   G  = C B^T                      (kQ x kQ; bf16 in, f32 out: exact)
//   M  = G o exp(cum_t - cum_s) dt_s  for s <= t, else 0 (f32; the
//                                   exponent of a difference, never a
//                                   ratio)
//   y  = M x + (C o exp(cum_t)) S_prev^T
//   S  = exp(cum_last) S_prev + (x o w)^T B,  w_s = exp(cum_last - cum_s) dt_s
// G takes one mma.sync m16n8k16 per tile.  Each other product has an
// f32 operand, which is split into a bf16 pair hi + lo (hi = bf16(v),
// lo = bf16(v - hi)): M x and (x o w)^T B take two (hi.x + lo.x: x and B
// are exact in bf16), (C o exp(cum_t)) S_prev^T three (hi.hi + lo.hi +
// hi.lo).  One bf16 rounding of M or dt o x would put hundreds of y
// entries outside the scan's bf16 tolerance at the zamba2 views; the
// split keeps about 16 bits of each operand, and f32 accumulators.  The
// state carries from chunk to chunk in f32 registers.  The state rows p
// are independent, so a block owns kPB = 32 of one (b, h)'s rows (224
// blocks at B 1, H 112, P 64) and computes G for its own head (once per
// chunk; heads that share B and C through a zero head stride compute
// equal G).  Four warps: warp w owns rows t in
// [16w, 16w + 16) of G, M and y (only the causal tiles s <= t are
// computed) and one 16 x NP/2 tile of the state.  N is padded with zero
// columns to NP = 32, 64 or 128.  x, B and C rows arrive in shared
// memory by 16-byte cp.async, so the route takes only views on the
// 16-byte width (the model's; bf16 views off it take route 0); rows past
// S arrive as zeros (dt too), so a ragged last chunk adds nothing to the
// state.  Every block of a batch row reads the same B and C (the heads
// share them), so they are copied through L1: the blocks that share an
// SM fetch them from L2 once.  y and the final state leave through shared
// memory in 16-byte rows.
// Bound: bytes.  At the serve shape its tensor-core work (G once a batch
// row, M x and the state's product twice each for the splits, about
// 0.18 GFLOP) takes less time at the bf16 tensor-core rate than moving
// x, y and the final state (about 2.8 MB).  What holds it above that
// bound is latency: one chunk's chain (copies in, dt's scan, G, M, y,
// the state) runs once a block, two blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_bf16.cuh"

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

// ---- routes 1 and 2: the chunked (SSD) body, bf16 on the tensor cores ----

constexpr int kQ = 64;                   // chunk length (time steps)
constexpr int kPB = 32;                  // state rows a block owns
constexpr int kCWarps = 4;
constexpr int kCThreads = kCWarps * kWarp;
constexpr int kCPad = 8;                 // row padding: conflict-free ldmatrix
constexpr int kLdP = kPB + kCPad;        // pitch of the (s, p) tiles
constexpr float kLog2e = 1.4426950408889634f;

template <int NP>
constexpr int chunk_smem_bytes() {
  // B and C (kQ x NP); x, x o w as hi and lo, and y (kQ x kPB); the
  // carried state as hi and lo (kPB x NP); dt, cum, w and exp(cum)
  return (2 * kQ * (NP + kCPad) + 4 * kQ * kLdP + 2 * kPB * (NP + kCPad)) *
             static_cast<int>(sizeof(__nv_bfloat16)) +
         4 * kQ * static_cast<int>(sizeof(float));
}

// v0, v1 as bf16 pairs hi = bf16(v), lo = bf16(v - hi), packed as the
// mma fragments want them (v0 in the low half)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tc::pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// grid (ceil(P / kPB) * H, B): block (i, b) owns rows [p0, p0 + kPB) of
// head h = i / ceil(P / kPB) of batch row b
template <int NP>
__global__ void __launch_bounds__(kCThreads)
ssm_chunk_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ dt,
                 const float* __restrict__ a,
                 const __nv_bfloat16* __restrict__ bm,
                 const __nv_bfloat16* __restrict__ cm,
                 __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ fin,
                 Strides xs, Strides ds, int64_t asb, int64_t ash, Strides bs,
                 Strides cs, Strides ys, int H, int S, int P, int N) {
  using bf16 = __nv_bfloat16;
  constexpr int kLdN = NP + kCPad;       // pitch of the (s, n), (p, n) tiles
  constexpr int kKN = NP / 16;           // k16 steps over n
  constexpr int kNS = NP / 16;           // n8 tiles of the state a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);  // kQ x kLdN
  bf16* c_s = b_s + kQ * kLdN;                     // kQ x kLdN
  bf16* x_s = c_s + kQ * kLdN;                     // x, kQ x kLdP
  bf16* w_hi = x_s + kQ * kLdP;                    // x o w, kQ x kLdP
  bf16* w_lo = w_hi + kQ * kLdP;
  bf16* y_s = w_lo + kQ * kLdP;                    // y, kQ x kLdP
  bf16* s_hi = y_s + kQ * kLdP;                    // state, kPB x kLdN
  bf16* s_lo = s_hi + kPB * kLdN;
  float* dt_s = reinterpret_cast<float*>(s_lo + kPB * kLdN);
  float* cum_s = dt_s + kQ;              // cum, in log2 units
  float* w_s = cum_s + kQ;               // exp(cum_last - cum_s) dt_s
  float* e_s = w_s + kQ;                 // exp(cum_t)

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int g = lane / 4, t4 = lane % 4;
  const int npb = (P + kPB - 1) / kPB;
  const int h = blockIdx.x / npb;
  const int p0 = (blockIdx.x % npb) * kPB;
  const int b = blockIdx.y;
  const bf16* xb = x + b * xs.b + h * xs.h + p0;
  const bf16* db = dt + b * ds.b + h * ds.h;
  const bf16* bb = bm + b * bs.b + h * bs.h;
  const bf16* cb = cm + b * cs.b + h * cs.h;
  bf16* yb = y + b * ys.b + h * ys.h + p0;
  const float a2 = a[b * asb + h * ash] * kLog2e;   // a in log2 units
  const int prow = P - p0;               // this block's valid rows

  // the state tile of this warp: rows 16 * (warp & 1) + g (+8) of the
  // block, columns 8 * (n0 + j) + 2 t4 (+1)
  const int sm = 16 * (warp & 1);
  const int n0 = (warp >> 1) * kNS;
  float st[kNS][4];
#pragma unroll
  for (int j = 0; j < kNS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
  const int r0 = 16 * warp;              // this warp's rows t of G, M, y

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int len = min(kQ, S - t0);
    const bool carry = t0 > 0;
    // warp 0 reads dt before it queues its share of the tile copies: the
    // scan over dt gates the first barrier
    float d0 = 0.f, d1 = 0.f;
    if (warp == 0) {
      const int s0 = 2 * lane;
      if (s0 < len) d0 = __bfloat162float(db[(t0 + s0) * ds.s]);
      if (s0 + 1 < len) d1 = __bfloat162float(db[(t0 + s0 + 1) * ds.s]);
    }

    // ---- stage the chunk; rows past len (and columns past N, P) as 0
    for (int c = tid; c < kQ * (NP / 8); c += kCThreads) {
      const int r = c / (NP / 8), col = (c % (NP / 8)) * 8;
      const bool in = r < len && col < N;
      tc::cp_async16_ca(b_s + r * kLdN + col,
                        in ? bb + (t0 + r) * bs.s + col : bb, in);
      tc::cp_async16_ca(c_s + r * kLdN + col,
                        in ? cb + (t0 + r) * cs.s + col : cb, in);
    }
    for (int c = tid; c < kQ * (kPB / 8); c += kCThreads) {
      const int r = c / (kPB / 8), col = (c % (kPB / 8)) * 8;
      const bool in = r < len && col < prow;
      tc::cp_async16(x_s + r * kLdP + col,
                     in ? xb + (t0 + r) * xs.s + col : xb, in);
    }
    tc::cp_async_commit();
    if (warp == 0) {
      // cum over the chunk (log2 units): lane l holds steps 2l, 2l + 1
      const int s0 = 2 * lane;
      const float v0 = a2 * d0, v1 = a2 * d1;
      float inc = v0 + v1;
#pragma unroll
      for (int off = 1; off < kWarp; off *= 2) {
        const float o = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += o;
      }
      float excl = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + v0, c1 = c0 + v1;
      const float last = __shfl_sync(kFull, c1, kWarp - 1);
      dt_s[s0] = d0;
      dt_s[s0 + 1] = d1;
      cum_s[s0] = c0;
      cum_s[s0 + 1] = c1;
      w_s[s0] = exp2f(last - c0) * d0;
      w_s[s0 + 1] = exp2f(last - c1) * d1;
      e_s[s0] = exp2f(c0);
      e_s[s0 + 1] = exp2f(c1);
    }
    if (carry) {                         // the state so far, as hi + lo
#pragma unroll
      for (int j = 0; j < kNS; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split2(st[j][2 * r], st[j][2 * r + 1], hi, lo);
          const int off = (sm + g + 8 * r) * kLdN + 8 * (n0 + j) + 2 * t4;
          *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
        }
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    // ---- x o w as hi + lo: a thread owns one column pair of rows
    // tid / 16 + 8k
    {
      constexpr int kIt = kQ * kPB / 2 / kCThreads;
      constexpr int kRows = kCThreads / (kPB / 2);
      const int col = (tid % (kPB / 2)) * 2, rb = tid / (kPB / 2);
#pragma unroll
      for (int k = 0; k < kIt; ++k) {
        const int off = (rb + k * kRows) * kLdP + col;
        const float2 xf =
            unpack2(*reinterpret_cast<const uint32_t*>(x_s + off));
        const float w = w_s[rb + k * kRows];
        uint32_t hi, lo;
        split2(xf.x * w, xf.y * w, hi, lo);
        *reinterpret_cast<uint32_t*>(w_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(w_lo + off) = lo;
      }
    }

    // ---- G = C B^T on this warp's rows, the causal tiles s < r0 + 16
    float m[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKN; ++kk) {
      uint32_t ca[4];
      tc::ldmatrix_x4(ca, c_s + (r0 + (lane & 15)) * kLdN + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj > warp) continue;
        uint32_t r[4];
        tc::ldmatrix_x4(r, b_s + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     kLdN +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(m[2 * jj], ca, r[0], r[1]);
        tc::mma_bf16(m[2 * jj + 1], ca, r[2], r[3]);
      }
    }
    // M dt = G o exp(cum_t - cum_s) dt_s, s <= t (masked in the
    // diagonal tiles)
    const float ct[2] = {cum_s[r0 + g], cum_s[r0 + g + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j / 2 > warp) continue;
      const float2 cs =
          *reinterpret_cast<const float2*>(cum_s + 8 * j + 2 * t4);
      const float2 ds2 =
          *reinterpret_cast<const float2*>(dt_s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + g + 8 * (e >> 1);
        const int s = 8 * j + 2 * t4 + (e & 1);
        const float v = m[j][e] * (e & 1 ? ds2.y : ds2.x) *
                        exp2f(ct[e >> 1] - (e & 1 ? cs.y : cs.x));
        m[j][e] = (j / 2 < warp || s <= t) ? v : 0.f;
      }
    }
    __syncthreads();                     // x o w and the state staged

    // ---- y = (M dt) x + (C o exp(cum_t)) S^T on this warp's rows
    float acc[kPB / 8][4];
#pragma unroll
    for (int j = 0; j < kPB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) continue;
      uint32_t ah[4], al[4];
      split2(m[2 * kk][0], m[2 * kk][1], ah[0], al[0]);
      split2(m[2 * kk][2], m[2 * kk][3], ah[1], al[1]);
      split2(m[2 * kk + 1][0], m[2 * kk + 1][1], ah[2], al[2]);
      split2(m[2 * kk + 1][2], m[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dd = 0; dd < kPB / 16; ++dd) {
        uint32_t r[4];                   // x is exact in bf16
        tc::ldmatrix_x4_trans(
            r, x_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdP +
                   dd * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dd], al, r[0], r[1]);
        tc::mma_bf16(acc[2 * dd], ah, r[0], r[1]);
        tc::mma_bf16(acc[2 * dd + 1], al, r[2], r[3]);
        tc::mma_bf16(acc[2 * dd + 1], ah, r[2], r[3]);
      }
    }
    if (carry) {
      const float ec[2] = {e_s[r0 + g], e_s[r0 + g + 8]};
#pragma unroll
      for (int kk = 0; kk < kKN; ++kk) {
        uint32_t ca[4], ah[4], al[4];
        tc::ldmatrix_x4(ca, c_s + (r0 + (lane & 15)) * kLdN + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {    // a0, a2: row g; a1, a3: row g + 8
          const float2 cv = unpack2(ca[e]);
          split2(cv.x * ec[e & 1], cv.y * ec[e & 1], ah[e], al[e]);
        }
#pragma unroll
        for (int dd = 0; dd < kPB / 16; ++dd) {
          const int off =
              (dd * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdN + kk * 16 +
              ((lane >> 3) & 1) * 8;
          uint32_t rh[4], rl[4];
          tc::ldmatrix_x4(rh, s_hi + off);
          tc::ldmatrix_x4(rl, s_lo + off);
          tc::mma_bf16(acc[2 * dd], al, rh[0], rh[1]);
          tc::mma_bf16(acc[2 * dd], ah, rl[0], rl[1]);
          tc::mma_bf16(acc[2 * dd], ah, rh[0], rh[1]);
          tc::mma_bf16(acc[2 * dd + 1], al, rh[2], rh[3]);
          tc::mma_bf16(acc[2 * dd + 1], ah, rl[2], rl[3]);
          tc::mma_bf16(acc[2 * dd + 1], ah, rh[2], rh[3]);
        }
      }
    }
    // y: this warp's 16 rows through shared memory (its own rows: a warp
    // barrier suffices)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < kPB / 8; ++j)
        *reinterpret_cast<uint32_t*>(y_s + (r0 + g + 8 * r) * kLdP + 8 * j +
                                     2 * t4) =
            tc::pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    __syncwarp();
#pragma unroll
    for (int c = lane; c < 16 * (kPB / 8); c += kWarp) {
      const int t = r0 + c / (kPB / 8), col = (c % (kPB / 8)) * 8;
      if (t < len && col < prow)
        *reinterpret_cast<int4*>(yb + (t0 + t) * ys.s + col) =
            *reinterpret_cast<const int4*>(y_s + t * kLdP + col);
    }

    // ---- S = exp(cum_last) S + (x o w)^T B on this warp's state tile
    const float decay = exp2f(cum_s[kQ - 1]);
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      if (16 * kk >= len) break;
      const int aoff = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdP +
                       sm + ((lane >> 3) & 1) * 8;
      uint32_t ah[4], al[4];
      tc::ldmatrix_x4_trans(ah, w_hi + aoff);
      tc::ldmatrix_x4_trans(al, w_lo + aoff);
#pragma unroll
      for (int jj = 0; jj < kNS / 2; ++jj) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(
            r, b_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdN +
                   8 * n0 + jj * 16 + (lane >> 4) * 8);
        tc::mma_bf16(st[2 * jj], al, r[0], r[1]);
        tc::mma_bf16(st[2 * jj], ah, r[0], r[1]);
        tc::mma_bf16(st[2 * jj + 1], al, r[2], r[3]);
        tc::mma_bf16(st[2 * jj + 1], ah, r[2], r[3]);
      }
    }
    __syncthreads();                     // the chunk's tiles are consumed
  }

  // the final state: this warp's tile through shared memory (the state's
  // staging tile is free after the loop's last barrier)
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kNS; ++j)
      *reinterpret_cast<uint32_t*>(s_hi + (sm + g + 8 * r) * kLdN +
                                   8 * (n0 + j) + 2 * t4) =
          tc::pack_bf16(st[j][2 * r], st[j][2 * r + 1]);
  __syncwarp();
  bf16* fb = fin + ((static_cast<int64_t>(b) * H + h) * P + p0) * N;
#pragma unroll
  for (int c = lane; c < 16 * kNS; c += kWarp) {   // N % 8 == 0
    const int r = sm + c / kNS, col = 8 * (n0 + c % kNS);
    if (r < prow && col < N)
      *reinterpret_cast<int4*>(fb + r * N + col) =
          *reinterpret_cast<const int4*>(s_hi + r * kLdN + col);
  }
}

template <int NP>
int launch_chunked(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* fin,
                   const int64_t* st, int B, int H, int S, int P, int N,
                   cudaStream_t stream) {
  constexpr int bytes = chunk_smem_bytes<NP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssm_chunk_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Strides xs{st[0], st[1], st[2]}, ds{st[3], st[4], st[5]},
      bs{st[8], st[9], st[10]}, cs{st[11], st[12], st[13]},
      ys{st[14], st[15], st[16]};
  const dim3 grid((P + kPB - 1) / kPB * H, B);
  using bf16 = __nv_bfloat16;
  ssm_chunk_kernel<NP><<<grid, kCThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<bf16*>(y),
      static_cast<bf16*>(fin), xs, ds, st[6], st[7], bs, cs, ys, H, S, P,
      N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 17 element strides — x (b, h, s), dt (b, h, s), a (b, h),
// B (b, h, s), C (b, h, s), y (b, h, s).  fin is contiguous (B,H,P,N).
// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C, y, fin); a is float32.
// route: 0 the sequential body (either dtype); 1 the chunked body (bf16;
// x, B, C and y base addresses and their (b, h, s) strides on 16 bytes,
// P and N multiples of 8).
// Launches on `stream`; returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for a shape, type or route the kernel does not
// take.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* fin, const int64_t* strides, int B,
                               int H, int S, int P, int N, int dtype,
                               int route, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (B < 0 || H < 0 || S < 0 || P <= 0 || N <= 0 || P > kMaxP ||
      N > kMaxN || B > 65535 || route < 0 || route > 1 ||
      (route != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (N <= 32)
      return launch_chunked<32>(x, dt, a, bm, cm, y, fin, strides, B, H, S,
                                P, N, s);
    if (N <= 64)
      return launch_chunked<64>(x, dt, a, bm, cm, y, fin, strides, B, H, S,
                                P, N, s);
    return launch_chunked<128>(x, dt, a, bm, cm, y, fin, strides, B, H, S, P,
                               N, s);
  }
  if (dtype == 0)
    return launch<float>(x, dt, a, bm, cm, y, fin, strides, B, H, S, P, N,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, fin, strides, B, H, S,
                                 P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
