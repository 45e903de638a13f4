// FAST-9/16 at two thresholds + 3x3 NMS + per-level border mask + 16-row
// band max/argmax, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py::
// _fast_band_kernel (called through fast_nms_bands_hi_lo).  Same function,
// same outputs: for a [G*H0p, W] slab of stacked pyramid levels it writes,
// per threshold, the column-wise max of each 16-row band of the NMS'd,
// border-masked FAST score and the first row holding that max.
//
// What bounds it on this card: bytes, and few of them.  Every level is padded
// to level 0's size in the slab, and only the pixels inside a level's own
// image and border can reach an output, well under half of the slab.  The
// function has no matrix product, so tensor cores do not apply.  The design:
// one 256-thread block per 16x128 tile (one band of one strip).
//   - band_box() gives each band the rows and columns its level's mask
//     leaves valid.  A tile whose band keeps no pixel of its strip writes
//     zeros and returns before it stages or scores anything.
//   - A live tile scores only the positions within 1 pixel of a valid one,
//     the ones the NMS of a valid pixel reads, by fast_common.cuh's
//     reject-first scheme (shared with fast_nms.cu).
//   - A thread then walks one column of the band over its valid rows, once
//     per threshold; the NMS is already in the scores, so it reads no
//     neighbour.
// The full-resolution score maps never reach device memory.  The result is
// bitwise equal to the plain PyTorch version beside the wrapper
// (ops/orb/fast_band.py), which mirrors band_box() as band_boxes().

#include <cuda_runtime.h>

#include "fast_common.cuh"

namespace {

using namespace fastk;

static_assert(kRows == kBand, "one band a tile");
static_assert(kThreads == 2 * kStrip, "one thread per column and threshold");
constexpr int kMaxLevels = 32;

struct LevelDims {
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// The pixels of one band that lie inside their level's mask: rows
// [r_lo, r_hi) counted from the band's first row, slab columns [c_lo, c_hi).
// Either range may be empty.  H0p % 16 == 0, so a band lies in one slice.
struct BandBox {
  int r_lo, r_hi, c_lo, c_hi;
};

__device__ __forceinline__ BandBox band_box(int band, int w, int H0p, const LevelDims& dims,
                                            int n_levels, int border) {
  const int row0 = band * kBand;
  const int slc = row0 / H0p;
  const int lvl = slc % n_levels;
  const int row_in0 = row0 - slc * H0p;
  BandBox b;
  b.r_lo = max(border - row_in0, 0);
  b.r_hi = min(dims.h[lvl] - border - row_in0, kBand);
  b.c_lo = max(border, 0);
  b.c_hi = min(dims.w[lvl] - border, w);
  return b;
}

// Does the band keep a pixel in columns [col0, col0 + kStrip)?
__device__ __forceinline__ bool box_live(const BandBox& b, int col0) {
  return b.r_lo < b.r_hi && max(b.c_lo, col0) < min(b.c_hi, col0 + kStrip);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fast_band_kernel(const float* __restrict__ img, float* __restrict__ hi_max,
                 int* __restrict__ hi_arg, float* __restrict__ lo_max,
                 int* __restrict__ lo_arg, int h, int w, int wp, int H0p,
                 const __grid_constant__ LevelDims dims, int n_levels, int border,
                 float thr_hi, float thr_lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& s = *reinterpret_cast<Tile*>(smem);

  const int band = blockIdx.y;
  const int row0 = band * kBand;
  const int col0 = blockIdx.x * kStrip;
  const int tid = threadIdx.x;
  const BandBox box = band_box(band, w, H0p, dims, n_levels, border);

  if (!box_live(box, col0)) {  // nothing of this tile is inside its level's mask
    if (tid < kStrip && col0 + tid < wp) {
      const int out = band * wp + col0 + tid;
      hi_max[out] = 0.f;
      hi_arg[out] = 0;
      lo_max[out] = 0.f;
      lo_arg[out] = 0;
    }
    return;
  }

  if (tid < kScoreH) {
    // score row `tid` is read by the NMS of the band's rows within 1 of it;
    // score it over the columns within 1 of the valid ones, off the slab's
    // 4-pixel border.
    const int gr = row0 - 1 + tid;
    const bool row_ok = gr >= kHalo && gr < h - kHalo && tid >= box.r_lo && tid < box.r_hi + 2;
    s.col_lo[tid] = row_ok ? max(box.c_lo - 1, kHalo) - col0 + kHalo : 0;
    s.col_hi[tid] = row_ok ? min(box.c_hi + 1, w - kHalo) - col0 + kHalo : 0;
  }
  clear_scores(s);
  stage_tile<kVec>(img, h, w, row0, col0, s.px);
  __syncthreads();
  score_tile(s, thr_hi, thr_lo);

  // threads 0..127 take the high threshold's columns, 128..255 the low one's
  const int t = tid / kStrip, x = tid - t * kStrip;
  const int c = col0 + x;
  if (t >= 2 || c >= wp) return;
  float mx = 0.f;
  int arg = 0;
  if (c >= box.c_lo && c < box.c_hi) {
    for (int r = box.r_lo; r < box.r_hi; ++r) {
      // a score that lost the NMS is negative and never beats mx
      const float v = s.score[t][r + 1][x + kHalo];
      if (v > mx) {  // strict: the first row of the max
        mx = v;
        arg = r;
      }
    }
  }
  const int out = band * wp + c;
  (t == 0 ? hi_max : lo_max)[out] = mx;
  (t == 0 ? hi_arg : lo_arg)[out] = arg;
}

template <bool kVec>
cudaError_t launch(const float* img, float* hi_max, int* hi_arg, float* lo_max,
                   int* lo_arg, int h, int w, int wp, int H0p, const LevelDims& dims,
                   int n_levels, int border, float thr_hi, float thr_lo,
                   cudaStream_t stream) {
  // more than 48 KB of shared memory a block has to be allowed, per device
  const cudaError_t allowed = cudaFuncSetAttribute(
      fast_band_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Tile));
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((wp + kStrip - 1) / kStrip, h / kBand);
  fast_band_kernel<kVec><<<grid, kThreads, sizeof(Tile), stream>>>(
      img, hi_max, hi_arg, lo_max, lo_arg, h, w, wp, H0p, dims, n_levels, border, thr_hi,
      thr_lo);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dims_hw is a HOST array of
// n_levels (height, width) pairs.  Returns the CUDA error of the launch (0
// for none), or -1 for arguments the kernel does not take.
extern "C" int fast_band_launch(const float* img, float* hi_max, int* hi_arg,
                                float* lo_max, int* lo_arg, int h, int w, int wp,
                                int H0p, const int* dims_hw, int n_levels,
                                int border, float thr_hi, float thr_lo,
                                void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || H0p % kBand != 0 || h % H0p != 0 ||
      wp < w || wp % kBand != 0 || !(thr_hi >= thr_lo))
    return -1;
  LevelDims dims = {};
  for (int l = 0; l < n_levels; ++l) {
    dims.h[l] = dims_hw[2 * l];
    dims.w[l] = dims_hw[2 * l + 1];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && aligned16(img);
  return static_cast<int>(
      vec ? launch<true>(img, hi_max, hi_arg, lo_max, lo_arg, h, w, wp, H0p, dims,
                         n_levels, border, thr_hi, thr_lo, st)
          : launch<false>(img, hi_max, hi_arg, lo_max, lo_arg, h, w, wp, H0p, dims,
                          n_levels, border, thr_hi, thr_lo, st));
}
