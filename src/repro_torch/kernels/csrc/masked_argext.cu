// Masked first-occurrence arg-extremum over the rows of a (B, N) tile.
//
// Replaces the Pallas TPU kernel repro/kernels/sched_ops.py::_argext_kernel
// (tiled by _pallas_argext).  Contract (repro_torch/kernels/ref.py::
// ref_masked_argext, bit for bit): disabled entries take the fill value
// (-1e30 for max, +1e30 for min); idx is the FIRST index attaining the
// extremum of the filled row, so a masked entry can win a tie with an
// enabled score equal to the fill; a row with no enabled entry yields
// idx = -1 and the fill value.  NaN scores are outside the contract.
//
// Bound: bytes, and far below anything the card can show.  Each row is
// read once (5 bytes an entry: f32 score, bool mask) and 8 bytes a row
// are written; the fleet calls it at (E, 64), (1, 32) and (1, E), a few
// KB, so a launch is a latency floor and the design makes the work after
// the launch as short as it can be.  The launcher takes one of two bodies.
//
// KEY (masked_argext_key_kernel), the route every call takes: one warp a
// row.  A lane loads all of its entries at once (N <= 32: one; N <= 64:
// two neighbours, as one float2 and one 2-byte mask load where the row is
// aligned, else unrolled scalars; larger N loops over 64-entry chunks) and
// folds each into one 64-bit key: the filled value mapped to an
// order-preserving u32 (-0.0 first mapped to +0.0, so the two tie;
// complemented for min) in the high half, 0xFFFFFFFF - j in the low half.
// The larger key is then the better value and, on a tie, the lower index,
// which is argmax/argmin's first-occurrence rule, so the butterfly is five
// steps of one 64-bit __shfl_xor_sync and a max.  __any_sync decides idx
// -1.  The lane that holds the winning key writes its own filled value as
// it was read: the value is never decoded from the key.  Rows <= 32:
// blocks of at most four warps, so that the rows spread over SMs (on an
// H100 SXM at 700 W, one block of 28 warps at (28, 64) ran 0.26 us slower
// than seven blocks of four: its warps share one SM's four schedulers);
// more rows: blocks of eight warps.
//
// PREVIOUS (masked_argext_kernel), the body before it: one warp a row,
// eight rows a block, lanes striding over N one entry at a time and a
// butterfly that shuffles (value, index) pairs through a compare chain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;      // PREVIOUS, and KEY above 32 rows
constexpr int kFewRowsPerBlock = 4;   // KEY at 32 rows or fewer
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrevious = 0;           // the launcher's routes
constexpr int kKey = 1;

// ---- KEY ------------------------------------------------------------------

// The key of entry j with filled value v: larger is better, ties to the
// lower index.  0 is below every entry's key (its low half would be index
// 0xFFFFFFFF), so it stands for "no entry".
__device__ __forceinline__ unsigned long long entry_key(float v, int j,
                                                        bool mx) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;                        // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);      // order-preserving
  if (!mx) u = ~u;
  return (static_cast<unsigned long long>(u) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(j));
}

__global__ void masked_argext_key_kernel(const float* __restrict__ scores,
                                         const uint8_t* __restrict__ mask,
                                         int32_t* __restrict__ out_idx,
                                         float* __restrict__ out_val,
                                         int64_t rows, int n, int is_max) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp)
                      + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform across the warp
  const bool mx = is_max != 0;
  const float fill = mx ? -1e30f : 1e30f;
  const float* s = scores + row * n;
  const uint8_t* m = mask + row * n;

  unsigned long long best = 0ull;
  float bval = fill;
  bool any = false;
  if (n <= kWarp) {
    if (lane < n) {
      const float v = __ldg(s + lane);     // both loads in flight at once
      const bool on = m[lane] != 0;
      bval = on ? v : fill;
      any = on;
      best = entry_key(bval, lane, mx);
    }
  } else {
    const bool vec = (reinterpret_cast<uintptr_t>(s) % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(m) % 2 == 0);
    for (int c = 0; c < n; c += 2 * kWarp) {
      const int j = c + 2 * lane;
      float v0 = fill, v1 = fill;
      bool on0 = false, on1 = false;
      if (vec && j + 1 < n) {
        const float2 sv = __ldg(reinterpret_cast<const float2*>(s + j));
        const uint16_t mv = *reinterpret_cast<const uint16_t*>(m + j);
        on0 = (mv & 0xffu) != 0;
        on1 = (mv >> 8) != 0;
        v0 = sv.x;
        v1 = sv.y;
      } else {
        if (j < n) { on0 = m[j] != 0; v0 = __ldg(s + j); }
        if (j + 1 < n) { on1 = m[j + 1] != 0; v1 = __ldg(s + j + 1); }
      }
      v0 = on0 ? v0 : fill;
      v1 = on1 ? v1 : fill;
      any |= on0 | on1;
      if (j < n) {
        const unsigned long long k0 = entry_key(v0, j, mx);
        if (k0 > best) { best = k0; bval = v0; }
      }
      if (j + 1 < n) {
        const unsigned long long k1 = entry_key(v1, j + 1, mx);
        if (k1 > best) { best = k1; bval = v1; }
      }
    }
  }
  unsigned long long win = best;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const unsigned long long o = __shfl_xor_sync(kFull, win, off);
    win = o > win ? o : win;
  }
  any = __any_sync(kFull, any);
  if (best == win) {        // exactly one lane: the index is in the key
    out_idx[row] =
        any ? static_cast<int32_t>(0xFFFFFFFFu -
                                   static_cast<uint32_t>(win & 0xFFFFFFFFull))
            : -1;
    out_val[row] = bval;
  }
}

// ---- PREVIOUS -------------------------------------------------------------

__device__ __forceinline__ bool better(float v, int i, float bv, int bi,
                                       bool is_max) {
  if (i < 0) return false;
  if (bi < 0) return true;
  if (is_max ? (v > bv) : (v < bv)) return true;
  return v == bv && i < bi;
}

__global__ void masked_argext_kernel(const float* __restrict__ scores,
                                     const uint8_t* __restrict__ mask,
                                     int32_t* __restrict__ out_idx,
                                     float* __restrict__ out_val,
                                     int64_t rows, int n, int is_max) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform across the warp
  const bool mx = is_max != 0;
  const float fill = mx ? -1e30f : 1e30f;
  const float* s = scores + row * n;
  const uint8_t* m = mask + row * n;

  float bv = fill;
  int bi = -1;
  bool any = false;
  for (int j = lane; j < n; j += kWarp) {
    const bool on = m[j] != 0;
    const float v = on ? s[j] : fill;
    any |= on;
    if (better(v, j, bv, bi, mx)) {
      bv = v;
      bi = j;
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (better(ov, oi, bv, bi, mx)) {
      bv = ov;
      bi = oi;
    }
  }
  any = __any_sync(kFull, any);
  if (lane == 0) {
    out_idx[row] = any ? bi : -1;
    out_val[row] = bv;
  }
}

}  // namespace

// route 0 = PREVIOUS, 1 = KEY.  Launches on `stream`; returns
// cudaGetLastError() (0 on success) or cudaErrorInvalidValue for a route
// or shape the kernel does not take.
extern "C" int masked_argext_launch(const void* scores, const void* mask,
                                    void* out_idx, void* out_val,
                                    int64_t rows, int n, int is_max,
                                    int route, void* stream) {
  if (rows <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  int32_t* oi = static_cast<int32_t*>(out_idx);
  float* ov = static_cast<float*>(out_val);
  if (route == kKey) {
    const int64_t warps =
        rows <= kWarp ? (rows < kFewRowsPerBlock ? rows : kFewRowsPerBlock)
                      : kRowsPerBlock;
    const int64_t blocks = (rows + warps - 1) / warps;
    masked_argext_key_kernel<<<static_cast<unsigned>(blocks),
                               static_cast<unsigned>(warps * kWarp), 0, s>>>(
        sc, mk, oi, ov, rows, n, is_max);
  } else if (route == kPrevious) {
    const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    masked_argext_kernel<<<static_cast<unsigned>(blocks),
                           kRowsPerBlock * kWarp, 0, s>>>(
        sc, mk, oi, ov, rows, n, is_max);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
