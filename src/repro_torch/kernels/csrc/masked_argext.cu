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
// Bound: bytes.  Each row is read once (5 bytes an entry: f32 score, bool
// mask) and 8 bytes a row are written; the fleet calls it at (E, 64),
// (1, 32) and (1, E), i.e. a few KB, so one launch is a latency floor.
// Design: one warp per row, eight rows per 256-thread block.  Lanes stride
// over N with coalesced loads (any N, from 1 to far beyond the fleet's),
// each keeping its best (value, index) pair; a __shfl_xor_sync butterfly
// then merges the pairs.  The merge takes the other lane's pair when its
// value is strictly better, or equal with a lower index, which is exactly
// argmax/argmin's first-occurrence tie-break; an empty lane (index -1)
// never wins.  The butterfly leaves every lane with the same winner.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

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

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int masked_argext_launch(const void* scores, const void* mask,
                                    void* out_idx, void* out_val,
                                    int64_t rows, int n, int is_max,
                                    void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  masked_argext_kernel<<<static_cast<unsigned>(blocks),
                         kRowsPerBlock * kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(out_idx), static_cast<float*>(out_val), rows, n,
      is_max);
  return static_cast<int>(cudaGetLastError());
}
