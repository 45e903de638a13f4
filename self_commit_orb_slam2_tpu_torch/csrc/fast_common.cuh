// Device code shared by the two FAST kernels (fast_band.cu, fast_nms.cu):
// staging a 16-row tile of the image with its 4-pixel halo in shared memory,
// and computing both thresholds' FAST scores of the 18x130 positions a 3x3
// NMS over the tile's 16x128 centre needs.
//
// Arithmetic follows the JAX order exactly (ring > p + t, ring < p - t,
// acc + ((ring - p) - t), acc + ((p - t) - ring) in RING_OFFSETS order), so
// both kernels are bitwise equal to their plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>

namespace fastk {

constexpr int kRows = 16;           // rows of one tile (one output band)
constexpr int kHalo = 4;            // 3 (FAST ring) + 1 (NMS)
constexpr int kStrip = 128;         // columns per block = threads per block
constexpr int kTileH = kRows + 2 * kHalo;
constexpr int kTileW = kStrip + 2 * kHalo;
constexpr int kScoreH = kRows + 2;  // scores the NMS reads: the tile +-1
constexpr int kScoreW = kStrip + 2;

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
// neighbours, >= against later ones (fast_pallas.py:97-100, :172-175).
__device__ __forceinline__ float nms(const float (*s)[kScoreW], int r, int c) {
  const float v = s[r][c];
  const bool keep = v > s[r - 1][c - 1] && v > s[r - 1][c] && v > s[r - 1][c + 1] &&
                    v > s[r][c - 1] && v >= s[r][c + 1] && v >= s[r + 1][c - 1] &&
                    v >= s[r + 1][c] && v >= s[r + 1][c + 1];
  return keep ? v : 0.f;
}

// Stage rows [row0 - 4, row0 + 20) x columns [col0 - 4, col0 + 132) of the
// [h, w] image (past its edge: the edge pixel, jnp.pad mode="edge"), then the
// scores of rows [row0 - 1, row0 + 17) x columns [col0 - 1, col0 + 129) at
// both thresholds, zero on the image's 4-pixel border as in the TPU kernels.
// Called by all kStrip threads of the block; ends in __syncthreads().
__device__ __forceinline__ void stage_scores(const float* __restrict__ img, int h, int w,
                                             int row0, int col0, float (*tile)[kTileW],
                                             float (*score)[kScoreH][kScoreW],
                                             float thr_hi, float thr_lo) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kTileH * kTileW; i += kStrip) {
    const int r = i / kTileW, c = i - (i / kTileW) * kTileW;
    const int gr = min(max(row0 - kHalo + r, 0), h - 1);
    const int gc = min(max(col0 - kHalo + c, 0), w - 1);
    tile[r][c] = img[(size_t)gr * w + gc];
  }
  __syncthreads();
  for (int i = tid; i < kScoreH * kScoreW; i += kStrip) {
    const int sr = i / kScoreW, sc = i - (i / kScoreW) * kScoreW;
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
}

}  // namespace fastk
