// FAST-9/16 at two thresholds + 3x3 NMS over a whole image, for Hopper
// (sm_90a): both NMS'd score maps written in full.
//
// Replaces the TPU kernel self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py::
// _fast_nms_kernel (called through fast_nms_hi_lo).  Same function, same
// outputs: for an [h, w] image (a slab of stacked pyramid levels) it writes
// `hi` and `lo`, each [h, w], the FAST score at threshold thr_hi / thr_lo with
// the image's 4-pixel border zeroed, after a 3x3 non-max suppression that
// breaks ties in raster order.  The keypoint selection with cells other
// than 16x16 (ops/orb/detect.py::select_keypoints_slab) reads them.
//
// What bounds it on this card: operations.  Per pixel it does ~280 fp32
// compares/adds for the two thresholds against 4 bytes read and 8 written,
// past the H100's ~20 fp32 ops/byte balance point.  The TPU kernel's lane
// padding, lane-roll wrap and VMEM-sized row tile have no counterpart here:
// one 128-thread block per (16-row tile, 128-column strip) stages the tile
// and its 4-pixel halo in shared memory (edge-clamped reads), computes both
// thresholds' scores of the positions the NMS needs into shared memory
// (fast_common.cuh, shared with fast_band.cu), then each thread walks its
// column's 16 rows and stores both maps row by row, so neighbouring threads
// store neighbouring addresses.  No wgmma/TMA: speed is later work.

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

using namespace fastk;

__global__ void __launch_bounds__(kStrip)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ hi,
                float* __restrict__ lo, int h, int w, float thr_hi, float thr_lo) {
  __shared__ float tile[kTileH][kTileW];
  __shared__ float score[2][kScoreH][kScoreW];

  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kStrip;
  const int tid = threadIdx.x;
  stage_scores(img, h, w, row0, col0, tile, score, thr_hi, thr_lo);

  const int c = col0 + tid;
  if (c >= w) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= h) break;
    const size_t out = (size_t)row * w + c;
    hi[out] = nms(score[0], r + 1, tid + 1);
    lo[out] = nms(score[1], r + 1, tid + 1);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns cudaGetLastError() after
// the launch, or -1 for arguments the kernel does not take.
extern "C" int fast_nms_launch(const float* img, float* hi, float* lo, int h, int w,
                               float thr_hi, float thr_lo, void* stream) {
  if (h < 1 || w < 1) return -1;
  const dim3 grid((w + kStrip - 1) / kStrip, (h + kRows - 1) / kRows);
  fast_nms_kernel<<<grid, kStrip, 0, static_cast<cudaStream_t>(stream)>>>(
      img, hi, lo, h, w, thr_hi, thr_lo);
  return static_cast<int>(cudaGetLastError());
}
