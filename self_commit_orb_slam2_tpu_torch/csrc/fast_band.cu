// FAST-9/16 at two thresholds + 3x3 NMS + per-level border mask + 16-row
// band max/argmax, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py::
// _fast_band_kernel (called through fast_nms_bands_hi_lo).  Same function,
// same outputs: for a [G*H0p, W] slab of stacked pyramid levels it writes,
// per threshold, the column-wise max of each 16-row band of the NMS'd,
// border-masked FAST score and the first row holding that max.
//
// What bounds it on this card: operations.  Per pixel it does ~280 fp32
// compares/adds for the two thresholds (16 ring taps x 2 tests x 2 excess
// sums each, the arc tests, the NMS) against 4 bytes read and ~1 byte
// written, far past the H100's ~20 fp32 ops/byte balance point.  The design
// therefore keeps every intermediate on chip: one block per (16-row band,
// 128-column strip) stages the band plus a 4-pixel halo in shared memory,
// computes both thresholds' scores for the 18x130 positions the NMS needs
// into shared memory, and reduces each column's 16 rows in registers.  The
// full-resolution score maps never reach device memory.
//
// The staging and the scores are fast_common.cuh's, shared with fast_nms.cu,
// in the JAX arithmetic order, so the result is bitwise equal to the plain
// PyTorch version beside the wrapper (ops/orb/fast_band.py).  No wgmma/TMA:
// speed is later work.

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

using namespace fastk;

constexpr int kBand = kRows;        // rows per band (one output row)
constexpr int kMaxLevels = 32;

struct LevelDims {
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__global__ void __launch_bounds__(kStrip)
fast_band_kernel(const float* __restrict__ img, float* __restrict__ hi_max,
                 int* __restrict__ hi_arg, float* __restrict__ lo_max,
                 int* __restrict__ lo_arg, int h, int w, int wp, int H0p,
                 LevelDims dims, int n_levels, int border, float thr_hi,
                 float thr_lo) {
  __shared__ float tile[kTileH][kTileW];
  __shared__ float score[2][kScoreH][kScoreW];

  const int band = blockIdx.y;
  const int row0 = band * kBand;
  const int col0 = blockIdx.x * kStrip;
  const int tid = threadIdx.x;
  stage_scores(img, h, w, row0, col0, tile, score, thr_hi, thr_lo);

  const int c = col0 + tid;
  if (c >= wp) return;
  // H0p % 16 == 0, so the whole band lies in one slice of the slab.
  const int slc = row0 / H0p;
  const int lvl = slc % n_levels;
  const int row_in0 = row0 - slc * H0p;
  const bool col_ok = c >= border && c < dims.w[lvl] - border;
  const int out = band * wp + c;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float mx = 0.f;
    int arg = 0;
#pragma unroll
    for (int r = 0; r < kBand; ++r) {
      const int row_in = row_in0 + r;
      const bool ok = col_ok && row_in >= border && row_in < dims.h[lvl] - border &&
                      row0 + r < h;
      const float v = ok ? nms(score[t], r + 1, tid + 1) : 0.f;
      if (r == 0 || v > mx) {  // first row of the max
        mx = v;
        arg = r;
      }
    }
    if (t == 0) {
      hi_max[out] = mx;
      hi_arg[out] = arg;
    } else {
      lo_max[out] = mx;
      lo_arg[out] = arg;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dims_hw is a HOST array of
// n_levels (height, width) pairs.  Returns cudaGetLastError() after the
// launch, or -1 for arguments the kernel does not take.
extern "C" int fast_band_launch(const float* img, float* hi_max, int* hi_arg,
                                float* lo_max, int* lo_arg, int h, int w, int wp,
                                int H0p, const int* dims_hw, int n_levels,
                                int border, float thr_hi, float thr_lo,
                                void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || H0p % kBand != 0 || h % H0p != 0 ||
      wp < w || wp % kBand != 0)
    return -1;
  LevelDims dims;
  for (int l = 0; l < n_levels; ++l) {
    dims.h[l] = dims_hw[2 * l];
    dims.w[l] = dims_hw[2 * l + 1];
  }
  const dim3 grid((wp + kStrip - 1) / kStrip, h / kBand);
  fast_band_kernel<<<grid, kStrip, 0, static_cast<cudaStream_t>(stream)>>>(
      img, hi_max, hi_arg, lo_max, lo_arg, h, w, wp, H0p, dims, n_levels, border,
      thr_hi, thr_lo);
  return static_cast<int>(cudaGetLastError());
}
