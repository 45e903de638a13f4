// Device code shared by the two FAST kernels for Hopper (fast_band.cu replaces
// the TPU kernel _fast_band_kernel, fast_nms.cu replaces _fast_nms_kernel,
// both of self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py): one tile of the
// image staged in shared memory, and both thresholds' FAST-9/16 scores of the
// positions a 3x3 NMS over the tile reads.
//
// What bounds the two functions on this card: bytes.  The work is compares
// and adds on float32, a few tens of operations per pixel and threshold on
// camera frames, against 4 bytes read and up to 8 written.  There is no
// matrix product in it, so the tensor cores (wgmma) have nothing to do; the
// kernels are built from what does apply: shared memory, warp votes, 16-byte
// loads and stores, and the L2 that holds a whole slab.
//
// What the design does about it: a dense FAST costs ~450 instructions per
// pixel for the two thresholds, which holds a kernel at the card's
// instruction rate, far from the bytes' bound, so the kernels score only
// what the image needs.  A block
//   1. stages its tile with a 4-pixel halo (16-byte loads where the width and
//      the base allow; pixels outside the image are never read by a scored
//      position, so they are filled with 0);
//   2. runs the compass pre-test at the LOW threshold on every position it
//      must score: a 9-arc of the 16-tap ring always covers two neighbouring
//      compass taps (k = 0, 4, 8, 12), so a pixel with neither (N or S) and
//      (E or W) brighter, nor the same darker, scores 0 at both thresholds.
//      The survivors are compacted into a list (a warp scan, one shared
//      atomic a warp), so the next step runs with full warps whatever the
//      image looks like;
//   3. for each listed position builds the low threshold's brighter/darker
//      bit masks of the ring, from the signs of differences and no sum, and
//      tests them for a 9-arc (runs by doubling: 1, 2, 4, 8, then 9).  The high threshold's masks are
//      subsets of the low one's (thr_hi >= thr_lo, and float addition rounds
//      monotonically), so no arc means 0 at both.  The list is compacted
//      again, to the positions with an arc;
//   4. only at those takes the excess sums, both thresholds in one pass
//      over the ring, again with full warps;
//   5. and only at those runs the 3x3 NMS: a score that loses is negated in
//      place, so what follows needs no neighbour (scores are never negative,
//      and a zero stays zero whatever surrounds it).
// The sums keep the order of the plain PyTorch version (and of the JAX
// package) exactly: taps in RING_OFFSETS order, sum_b + ((q - p) - t),
// sum_d + ((p - t) - q), compares as q > p + t and q < p - t, then the max.
// No multiply enters, so no FMA can form, and no fast-math flag is used: the
// kernels are bitwise equal to their plain versions.  What is left between
// them and the bytes' bound is instruction rate still: on frames dense in
// corners the arc tests and the sums remain most of the time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fastk {

constexpr int kBand = 16;            // rows of one output band of fast_band.cu
constexpr int kRows = 16;            // rows of one tile
constexpr int kStrip = 128;          // columns of one tile
constexpr int kThreads = 256;        // threads of one block
constexpr int kHalo = 4;             // 3 (FAST ring) + 1 (NMS)
constexpr int kTileH = kRows + 2 * kHalo;
constexpr int kTileW = kStrip + 2 * kHalo;  // a multiple of 4: rows stay 16-byte aligned
constexpr int kScoreH = kRows + 2;   // rows whose scores the NMS reads: the tile +-1
constexpr int kScoreW = kStrip + 2;  // and columns
constexpr int kCand = kScoreH * kScoreW;  // positions a block scores at most
// Work on whole rows of 16-byte groups: thread t takes group t % kGroups of
// rows t / kGroups, + kRowsPerPass, ... (the last few threads take none), so
// that no index needs a division after the first.
constexpr int kGroups = kTileW / 4;
constexpr int kRowsPerPass = kThreads / kGroups;

// One block's shared memory.  Tile coordinates: px row r is image row
// row0 - 4 + r; score row sr is image row row0 - 1 + sr (px row sr + 3); px
// and score share their columns, tc = image column - col0 + 4, so that the
// tile's own columns start 16-byte aligned at tc = 4.
struct Tile {
  float px[kTileH][kTileW];
  float score[2][kScoreH][kTileW];   // [0] high threshold, [1] low threshold
  int col_lo[kScoreH];               // score row sr is scored at col_lo <= tc < col_hi
  int col_hi[kScoreH];
  int n_cand;
  unsigned short cand[kCand];        // positions that passed the pre-test
};

// Bresenham ring of radius 3, clockwise from 12 o'clock (fast.RING_OFFSETS),
// as X(k, dy, dx): the offsets are compile-time constants at every use.
#define FASTK_RING(X)                                                        \
  X(0, -3, 0) X(1, -3, 1) X(2, -2, 2) X(3, -1, 3) X(4, 0, 3) X(5, 1, 3)      \
  X(6, 2, 2) X(7, 3, 1) X(8, 3, 0) X(9, 3, -1) X(10, 2, -2) X(11, 1, -3)     \
  X(12, 0, -3) X(13, -1, -3) X(14, -2, -2) X(15, -3, -1)

// Does the 16-bit ring mask hold 9 contiguous set bits (cyclically)?  The
// mask is copied into both halves of the word, so a rotate is a shift; runs
// of 2, 4 and 8 by doubling, then 9.
__device__ __forceinline__ bool has_arc(unsigned bits) {
  const unsigned x = bits | (bits << 16);
  unsigned run = x & (x >> 1);
  run &= run >> 2;
  run &= run >> 4;
  run &= x >> 8;
  return (run & 0xFFFFu) != 0u;
}

// Append to a ring mask the bit "a < b", as the sign of a - b: the difference
// of two floats is negative exactly where a < b (it never rounds to zero
// unless a == b, a NaN comes out with its sign clear, as the compare would
// say, and stage_tile leaves no -0 among the pixels), and the subtraction
// runs beside the compares and logic, not in their pipe.  The taps enter at bit 0, so after all 16 tap k sits at bit
// 15 - k: a mirrored ring, which holds a 9-arc where the ring does.
__device__ __forceinline__ unsigned push_less(unsigned bits, float a, float b) {
  return __funnelshift_l(__float_as_uint(a - b), bits, 1);
}

// Compass pre-test at one threshold on the centre p and its north, east,
// south and west taps: false only where no 9-arc can exist.
__device__ __forceinline__ bool compass_pass(float p, float n, float e, float s, float w,
                                             float t) {
  // (n or s) and (e or w) brighter: the smaller of the two pairs' maxima is;
  // darker likewise.  No branch.  (A NaN tap can only let more pass.)
  const bool bright = fminf(fmaxf(n, s), fmaxf(e, w)) > p + t;
  const bool dark = fmaxf(fminf(n, s), fminf(e, w)) < p - t;
  return bright | dark;
}

// Do the low threshold's brighter or darker ring masks at tile position
// (r, c) hold a 9-arc?  Where they do not, both thresholds' scores are 0.
__device__ __forceinline__ bool ring_has_arc(const float (*px)[kTileW], int r, int c,
                                             float t_lo) {
  const float p = px[r][c];
  const float up = p + t_lo, dn = p - t_lo;
  unsigned bright = 0u, dark = 0u;
#define FASTK_TAP(k, dy, dx)                \
  {                                         \
    const float q = px[r + (dy)][c + (dx)]; \
    bright = push_less(bright, up, q);      \
    dark = push_less(dark, q, dn);          \
  }
  FASTK_RING(FASTK_TAP)
#undef FASTK_TAP
  return has_arc(bright) || has_arc(dark);
}

// Both thresholds' FAST scores at a tile position where ring_has_arc() holds:
// one pass over the ring, the excess sums of both thresholds side by side.
__device__ __forceinline__ void ring_scores(const float (*px)[kTileW], int r, int c,
                                            float t_hi, float t_lo, float& s_hi,
                                            float& s_lo) {
  const float p = px[r][c];
  const float up_l = p + t_lo, dn_l = p - t_lo;
  const float up_h = p + t_hi, dn_h = p - t_hi;
  float sb_l = 0.f, sd_l = 0.f, sb_h = 0.f, sd_h = 0.f;
  unsigned bright_h = 0u, dark_h = 0u;
#define FASTK_TAP(k, dy, dx)                  \
  {                                           \
    const float q = px[r + (dy)][c + (dx)];   \
    const float ex = q - p;                   \
    bright_h = push_less(bright_h, up_h, q);  \
    dark_h = push_less(dark_h, q, dn_h);      \
    if (q > up_l) sb_l = sb_l + (ex - t_lo);  \
    if (q > up_h) sb_h = sb_h + (ex - t_hi);  \
    if (q < dn_l) sd_l = sd_l + (dn_l - q);   \
    if (q < dn_h) sd_h = sd_h + (dn_h - q);   \
  }
  FASTK_RING(FASTK_TAP)
#undef FASTK_TAP
  s_lo = fmaxf(sb_l, sd_l);
  s_hi = (has_arc(bright_h) || has_arc(dark_h)) ? fmaxf(sb_h, sd_h) : 0.f;
}

// Stage image rows [row0 - 4, row0 + kRows + 4) x columns [col0 - 4,
// col0 + kStrip + 4) into px, 0 outside the [h, w] image.  Each pixel passes
// through "+ 0": a -0 becomes +0, which changes no compare and no sum, and
// without it push_less would read -0 - (+0) = -0 as "less".  kVec: w % 4 == 0
// and a 16-byte aligned base, so every group of 4 columns is one aligned
// load that lies wholly inside or outside the image.
template <bool kVec>
__device__ __forceinline__ void stage_tile(const float* __restrict__ img, int h, int w,
                                           int row0, int col0, float (*px)[kTileW]) {
  if (kVec) {
    // all of a thread's loads are in flight before its first store waits for one
    constexpr int kPasses = (kTileH + kRowsPerPass - 1) / kRowsPerPass;
    const int r0 = threadIdx.x / kGroups, g = threadIdx.x - r0 * kGroups;
    const int gc = col0 - kHalo + 4 * g;
    const bool mine = r0 < kRowsPerPass;
    float4 v[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int gr = row0 - kHalo + r0 + k * kRowsPerPass;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mine && gr >= 0 && gr < h && gc >= 0 && gc < w)
        v[k] = __ldg(reinterpret_cast<const float4*>(img + (size_t)gr * w + gc));
    }
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int r = r0 + k * kRowsPerPass;
      if (mine && r < kTileH)
        *reinterpret_cast<float4*>(&px[r][4 * g]) =
            make_float4(v[k].x + 0.f, v[k].y + 0.f, v[k].z + 0.f, v[k].w + 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int r = i / kTileW, c = i - r * kTileW;
      const int gr = row0 - kHalo + r, gc = col0 - kHalo + c;
      float v = 0.f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w) v = __ldg(img + (size_t)gr * w + gc);
      px[r][c] = v + 0.f;
    }
  }
}

// Zero both score maps and the candidate count.  The caller fills
// col_lo/col_hi and stages px beside this, then synchronises the block.
__device__ __forceinline__ void clear_scores(Tile& s) {
  float4* z = reinterpret_cast<float4*>(&s.score[0][0][0]);
  for (int i = threadIdx.x; i < 2 * kScoreH * kTileW / 4; i += kThreads)
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) s.n_cand = 0;
}

// A position of the score maps packed into 16 bits, and back.
__device__ __forceinline__ unsigned short pack_pos(int sr, int tc) {
  return (unsigned short)((sr << 8) | tc);
}
__device__ __forceinline__ void unpack_pos(int i, int& sr, int& tc) {
  sr = i >> 8;
  tc = i & 255;
}

// 3x3 non-max suppression with raster tie-break: does the score v at (r, c)
// stay?  Strict against earlier neighbours, >= against later ones
// (fast_pallas.py:97-100, :172-175).  Neighbours are read by magnitude: a
// score that lost its own test carries a minus sign (see score_tile).
__device__ __forceinline__ bool nms_keeps(const float (*sc)[kTileW], int r, int c, float v) {
  // & and not &&: eight loads and compares, no branch
  return (v > fabsf(sc[r - 1][c - 1])) & (v > fabsf(sc[r - 1][c])) &
         (v > fabsf(sc[r - 1][c + 1])) & (v > fabsf(sc[r][c - 1])) &
         (v >= fabsf(sc[r][c + 1])) & (v >= fabsf(sc[r + 1][c - 1])) &
         (v >= fabsf(sc[r + 1][c])) & (v >= fabsf(sc[r + 1][c + 1]));
}

// Both thresholds' NMS'd scores of the tile.  On return score[t][sr][tc]
// holds, for the tile's own pixels (1 <= sr <= kRows, kHalo <= tc <
// kHalo + kStrip): the FAST score where it survives the NMS, minus the score
// where it does not, and 0 where there is none; so max(score, 0) is the
// NMS'd map.  Positions outside the rows' column ranges count as 0.  Called
// by all threads of the block after px, the ranges and the cleared scores
// are visible; ends in __syncthreads().
__device__ __forceinline__ void score_tile(Tile& s, float thr_hi, float thr_lo) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  static_assert(4 * ((kScoreH + kRowsPerPass - 1) / kRowsPerPass) <= 32, "pass bits fit a word");
  constexpr int kPasses = (kScoreH + kRowsPerPass - 1) / kRowsPerPass;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;

  // 1. the compass pre-test, 4 neighbouring positions a thread from 16-byte
  // loads (independent loads, no vote between them)
  const int r0 = threadIdx.x / kGroups, g = threadIdx.x - r0 * kGroups;
  unsigned mine = 0u;  // bit 4 * k + e: position e of this thread's group in pass k passed
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int sr = r0 + k * kRowsPerPass;
    if (r0 < kRowsPerPass && sr < kScoreH) {
      // the row's range in this group's columns, as a mask of its 4 positions
      const int lo = max(s.col_lo[sr], kHalo - 1) - 4 * g;
      const int hi = min(s.col_hi[sr], kTileW - kHalo + 1) - 4 * g;
      if (lo < 4 && hi > 0) {
        const unsigned in_range = (0xFu << max(lo, 0)) & (0xFu >> max(4 - hi, 0)) & 0xFu;
        const float4* mid = reinterpret_cast<const float4*>(s.px[sr + 3]);
        const float4 m = mid[g], l = mid[max(g - 1, 0)], r = mid[min(g + 1, kGroups - 1)];
        const float4 u = reinterpret_cast<const float4*>(s.px[sr])[g];
        const float4 d = reinterpret_cast<const float4*>(s.px[sr + 6])[g];
        const unsigned pass = (compass_pass(m.x, u.x, m.w, d.x, l.y, thr_lo) ? 1u : 0u) |
                              (compass_pass(m.y, u.y, r.x, d.y, l.z, thr_lo) ? 2u : 0u) |
                              (compass_pass(m.z, u.z, r.y, d.z, l.w, thr_lo) ? 4u : 0u) |
                              (compass_pass(m.w, u.w, r.z, d.w, m.x, thr_lo) ? 8u : 0u);
        mine |= (pass & in_range) << (4 * k);
      }
    }
  }
  // one append per warp to the block's list: a thread's candidates follow
  // those of the lanes below it
  const int count = __popc(mine);
  int upto = count;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int other = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) upto += other;
  }
  const int total = __shfl_sync(kFull, upto, 31);
  if (total != 0) {  // a warp with no candidate leaves together
    int at = 0;
    if (lane == 31u) at = atomicAdd(&s.n_cand, total);
    at = __shfl_sync(kFull, at, 31) + upto - count;
    for (unsigned left = mine; left != 0u; left &= left - 1u) {
      const int bit = __ffs(left) - 1;
      s.cand[at++] = pack_pos(r0 + (bit >> 2) * kRowsPerPass, 4 * g + (bit & 3));
    }
  }
  __syncthreads();

  // 2. each warp takes an equal share of the list and keeps the positions
  // whose low-threshold masks hold a 9-arc, compacted in place: a warp
  // writes only where it has already read
  const int n = s.n_cand;
  const int share = (n + kThreads - 1) / kThreads * 32;
  const int beg = (threadIdx.x >> 5) * share;
  const int end = min(beg + share, n);
  int kept = 0;
  for (int j0 = beg; j0 < end; j0 += 32) {
    const int j = j0 + lane;
    int i = 0;
    bool arc = false;
    if (j < end) {
      i = s.cand[j];
      int sr, tc;
      unpack_pos(i, sr, tc);
      arc = ring_has_arc(s.px, sr + 3, tc, thr_lo);
    }
    const unsigned vote = __ballot_sync(kFull, arc);
    if (arc) s.cand[beg + kept + __popc(vote & below)] = (unsigned short)i;
    kept += __popc(vote);
  }
  __syncwarp();
  // 3. the sums, at the positions with an arc only
  for (int k = lane; k < kept; k += 32) {
    int sr, tc;
    unpack_pos(s.cand[beg + k], sr, tc);
    float s_hi, s_lo;
    ring_scores(s.px, sr + 3, tc, thr_hi, thr_lo, s_hi, s_lo);
    s.score[0][sr][tc] = s_hi;
    s.score[1][sr][tc] = s_lo;
  }
  __syncthreads();
  // 4. the NMS, again at those positions only: every other score is 0 and
  // stays 0.  A score that loses is negated in place; its neighbours read
  // magnitudes, so the order of the threads does not matter.
  for (int k = lane; k < kept; k += 32) {
    int sr, tc;
    unpack_pos(s.cand[beg + k], sr, tc);
    if (sr < 1 || sr > kRows || tc < kHalo || tc >= kHalo + kStrip) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float v = s.score[t][sr][tc];
      if (v > 0.f && !nms_keeps(s.score[t], sr, tc, v)) s.score[t][sr][tc] = -v;
    }
  }
  __syncthreads();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace fastk
