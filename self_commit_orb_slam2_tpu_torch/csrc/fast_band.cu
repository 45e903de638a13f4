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
// Arithmetic follows the JAX order exactly (ring > p + t, ring < p - t,
// acc + ((ring - p) - t), acc + ((p - t) - ring) in RING_OFFSETS order), so
// the result is bitwise equal to the plain PyTorch version beside the
// wrapper (ops/orb/fast_band.py).  No wgmma/TMA: speed is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBand = 16;           // rows per band (one output row)
constexpr int kHalo = 4;            // 3 (FAST ring) + 1 (NMS)
constexpr int kStrip = 128;         // columns per block = threads per block
constexpr int kTileH = kBand + 2 * kHalo;
constexpr int kTileW = kStrip + 2 * kHalo;
constexpr int kMaxLevels = 32;

struct LevelDims {
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Bresenham ring of radius 3, clockwise from 12 o'clock (fast.RING_OFFSETS).
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool has_arc(unsigned bits) {
  unsigned acc = bits;
#pragma unroll
  for (int k = 1; k < 9; ++k) acc &= ((bits << k) | (bits >> (16 - k))) & 0xFFFFu;
  return acc != 0u;
}

// FAST score at tile position (r, c): max of the bright and dark excess sums
// when a 9-contiguous arc exists, else 0.
__device__ __forceinline__ float fast_score(const float (*tile)[kTileW], int r, int c,
                                            float t) {
  const float p = tile[r][c];
  const float hi = p + t;
  const float lo = p - t;
  unsigned bits_b = 0u, bits_d = 0u;
  float sum_b = 0.f, sum_d = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float q = tile[r + kRingDy[k]][c + kRingDx[k]];
    if (q > hi) {
      bits_b |= 1u << k;
      sum_b = sum_b + ((q - p) - t);
    }
    if (q < lo) {
      bits_d |= 1u << k;
      sum_d = sum_d + (lo - q);
    }
  }
  return (has_arc(bits_b) || has_arc(bits_d)) ? fmaxf(sum_b, sum_d) : 0.f;
}

// 3x3 non-max suppression with raster tie-break: strict against earlier
// neighbours, >= against later ones (fast_pallas.py:172-175).
__device__ __forceinline__ float nms(const float (*s)[kStrip + 2], int r, int c) {
  const float v = s[r][c];
  const bool keep = v > s[r - 1][c - 1] && v > s[r - 1][c] && v > s[r - 1][c + 1] &&
                    v > s[r][c - 1] && v >= s[r][c + 1] && v >= s[r + 1][c - 1] &&
                    v >= s[r + 1][c] && v >= s[r + 1][c + 1];
  return keep ? v : 0.f;
}

__global__ void __launch_bounds__(kStrip)
fast_band_kernel(const float* __restrict__ img, float* __restrict__ hi_max,
                 int* __restrict__ hi_arg, float* __restrict__ lo_max,
                 int* __restrict__ lo_arg, int h, int w, int wp, int H0p,
                 LevelDims dims, int n_levels, int border, float thr_hi,
                 float thr_lo) {
  __shared__ float tile[kTileH][kTileW];
  __shared__ float score[2][kBand + 2][kStrip + 2];

  const int band = blockIdx.y;
  const int row0 = band * kBand;
  const int col0 = blockIdx.x * kStrip;
  const int tid = threadIdx.x;

  // Stage the band with its halo; rows/columns past the slab read the edge
  // pixel (jnp.pad mode="edge").
  for (int i = tid; i < kTileH * kTileW; i += kStrip) {
    const int r = i / kTileW, c = i - (i / kTileW) * kTileW;
    const int gr = min(max(row0 - kHalo + r, 0), h - 1);
    const int gc = min(max(col0 - kHalo + c, 0), w - 1);
    tile[r][c] = img[(size_t)gr * w + gc];
  }
  __syncthreads();

  // Scores of the band rows +-1 and strip columns +-1 (what the NMS reads);
  // zero on the slab's 4-pixel border, as in the TPU kernel.
  for (int i = tid; i < (kBand + 2) * (kStrip + 2); i += kStrip) {
    const int sr = i / (kStrip + 2), sc = i - (i / (kStrip + 2)) * (kStrip + 2);
    const int gr = row0 - 1 + sr, gc = col0 - 1 + sc;
    float s_hi = 0.f, s_lo = 0.f;
    if (gr >= kHalo && gr < h - kHalo && gc >= kHalo && gc < w - kHalo) {
      s_hi = fast_score(tile, sr + 3, sc + 3, thr_hi);
      s_lo = fast_score(tile, sr + 3, sc + 3, thr_lo);
    }
    score[0][sr][sc] = s_hi;
    score[1][sr][sc] = s_lo;
  }
  __syncthreads();

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
