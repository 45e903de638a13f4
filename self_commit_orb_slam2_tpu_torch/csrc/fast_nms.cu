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
// What bounds it on this card: bytes, 4 read and 8 written per pixel; two
// thirds of its least time is the stores.  The function has no matrix
// product, so tensor cores do not apply.  The TPU kernel's lane padding,
// lane-roll wrap and VMEM-sized row tile have no counterpart here.  One
// 256-thread block per 16x128 tile stages the tile and its 4-pixel halo in
// shared memory and scores it by fast_common.cuh's reject-first scheme
// (compass pre-test, compaction, arc test, sums and NMS only where an arc
// exists), shared with fast_band.cu.  Then each thread takes 4 neighbouring
// columns of one row and stores 16 bytes at a time where the width and the
// bases allow (a scalar path takes other widths).

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

using namespace fastk;

// The 4 NMS'd scores at row sr, columns tc .. tc + 3 (tc % 4 == 0): the
// scores that lost the NMS are negative.
__device__ __forceinline__ float4 nmsd4(const float (*sc)[kTileW], int sr, int tc) {
  const float4 v = *reinterpret_cast<const float4*>(&sc[sr][tc]);
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ out, int row, int c, int w,
                                       float4 v) {
  float* at = out + (size_t)row * w + c;
  if (kVec) {
    *reinterpret_cast<float4*>(at) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < w) at[j] = e[j];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ hi,
                float* __restrict__ lo, int h, int w, float thr_hi, float thr_lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& s = *reinterpret_cast<Tile*>(smem);

  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kStrip;
  const int tid = threadIdx.x;
  if (tid < kScoreH) {
    // scored: image rows and columns off the 4-pixel border
    const int gr = row0 - 1 + tid;
    const bool row_ok = gr >= kHalo && gr < h - kHalo;
    s.col_lo[tid] = row_ok ? 2 * kHalo - col0 : 0;
    s.col_hi[tid] = row_ok ? w - col0 : 0;
  }
  clear_scores(s);
  stage_tile<kVec>(img, h, w, row0, col0, s.px);
  __syncthreads();
  score_tile(s, thr_hi, thr_lo);

  constexpr int kGroups = kStrip / 4;
  for (int i = tid; i < kRows * kGroups; i += kThreads) {
    const int r = i / kGroups, g = i - r * kGroups;
    const int row = row0 + r, c = col0 + 4 * g;
    if (row >= h || c >= w) continue;
    store4<kVec>(hi, row, c, w, nmsd4(s.score[0], r + 1, 4 * g + kHalo));
    store4<kVec>(lo, row, c, w, nmsd4(s.score[1], r + 1, 4 * g + kHalo));
  }
}

template <bool kVec>
cudaError_t launch(const float* img, float* hi, float* lo, int h, int w, float thr_hi,
                   float thr_lo, cudaStream_t stream) {
  // more than 48 KB of shared memory a block has to be allowed, per device
  const cudaError_t allowed = cudaFuncSetAttribute(
      fast_nms_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Tile));
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((w + kStrip - 1) / kStrip, (h + kRows - 1) / kRows);
  fast_nms_kernel<kVec><<<grid, kThreads, sizeof(Tile), stream>>>(img, hi, lo, h, w,
                                                                  thr_hi, thr_lo);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the CUDA error of the
// launch (0 for none), or -1 for arguments the kernel does not take.
extern "C" int fast_nms_launch(const float* img, float* hi, float* lo, int h, int w,
                               float thr_hi, float thr_lo, void* stream) {
  if (h < 1 || w < 1 || !(thr_hi >= thr_lo)) return -1;
  const bool vec = w % 4 == 0 && aligned16(img) && aligned16(hi) && aligned16(lo);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<true>(img, hi, lo, h, w, thr_hi, thr_lo, st)
                              : launch<false>(img, hi, lo, h, w, thr_hi, thr_lo, st));
}
