// Motion-only bundle adjustment, one pose a block: ops/optim/pose_opt.py's
// pose_optimize_plain (4 rounds of up to 10 Gauss-Newton iterations, Huber
// in the first two, chi2 reclassification between rounds) in one launch a
// call, for B poses at once (a grid of B blocks).
//
// Replaces no TPU kernel: the JAX package leaves pose_optimize to XLA.  It
// was added because the port's own profile asks for it (ROADMAP.md queue B):
// replayed from a CUDA graph, the plain version was ~7,900 small kernels and
// ~11.9 ms a call, three calls a tracking step.
//
// What bounds it: latency, not bytes or FLOPs.  A call reads ~32 bytes a row
// (N <= 2,048 rows, ~64 KB) and does ~150 FLOPs a row an iteration, ~10
// MFLOP in all; but its 40 iterations are dependent steps, each a block-wide
// reduction of the 27 sums of the normal equations (the 21 of the symmetric
// 6x6 H, the 6 of b) followed by a serial 6x6 solve and an SE(3) update.
// The least time of an iteration on one SM: its rows' ~150 instructions
// each issued on the SM's 128 lanes, then one dependent chain of ~1,000
// cycles (the shuffle tree and the warps' sums, two barriers, a 6x6 LU with
// partial pivoting and its back substitution and the exponential map on
// one thread).  For all 40 iterations at 1.98 GHz that is ~44 us at N =
// 1,024 and ~69 us at 2,048; the freeze rule usually runs 6 or 7 of them
// (tools/time_pose_opt.py counts them and times the kernel).  The design
// answers with one block a pose: every iteration stays inside the block,
// each thread keeps its rows in registers (read from device memory once),
// the sums stay in registers and shared memory, and nothing is launched
// between iterations.
//
// The rules kept from the plain version, and what differs:
// - float32 throughout; every round, row and reclassification; the z clamp,
//   the zeroed third row of a mono row, the sqrt(ur_weight) scale of the
//   u_right residual, Huber's 1e-12 clamp, the damping and the 1e-9 ridge,
//   the isfinite(dx) & |dx| < 1e3 guard, the small-angle branches of
//   so3_exp and the left Jacobian.
// - The freeze rule: once a step moves the pose by at most 1e-6 (squared),
//   the block leaves the round's loop.  A frozen iteration leaves the pose
//   as it is, so this is the plain version's fixed budget exactly.
// - Sums are taken in another order than torch.einsum's (each thread over
//   its rows in order, then a fixed shuffle tree within each warp, then the
//   warps in order).  No atomics in the sums: every launch repeats bit for
//   bit.
//
// The device counts the launches it runs: thread 0 of block 0 adds one to
// g_launches (an atomicAdd, since launches on two streams may overlap; no
// output reads it).  A CUDA graph replays the kernel without the wrapper,
// so this count, read back by pose_opt_device_launches, is what a caller
// reads to know how many launches a run of graphs and IF nodes made.
//
//   pose_opt_launch(Tcw0 [B,4,4], pts_w [B,N,3], obs [B,N,3], sigma2 [B,N],
//                   valid [B,N] bool, -> Tcw [B,4,4], inliers [B,N] bool,
//                   n_inliers [B] int32, chi2 [B,N], B, N, fx, fy, cx, cy,
//                   bf, sqrt(ur_weight), damping, n_rounds, n_iters, stream)
//
// Returns the cudaError_t of the launch (0 for none), or -1 for arguments the
// kernel does not take.
//
//   pose_opt_device_launches(reset) -> the launches the current device has
//   run since the library was loaded or last reset (-1 on a CUDA error);
//   synchronizes the device, zeroes the count if reset != 0.

#include <cuda_runtime.h>

__device__ unsigned long long g_launches = 0;   // launches run (see above)

namespace {

constexpr int kSums = 27;          // H's upper triangle (21) and b (6)
constexpr int kMaxRows = 4096;     // rows a block takes
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Params {
  float fx, fy, cx, cy, bf;
  float sw2;       // sqrt(ur_weight): the scale of the u_right residual
  float damping;
  int n_rounds, n_iters;
};

// One row's residual and Jacobian wrt a left se3 update (rho, phi), as
// pose_opt._residuals_jacobians computes them; the third row is zero for a
// mono row.
struct RowModel {
  float res[3];
  float J[3][6];
};

__device__ __forceinline__ void camera_point(const float* T, const float* p, float* pc) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pc[i] = p[0] * T[4 * i] + p[1] * T[4 * i + 1] + p[2] * T[4 * i + 2] + T[4 * i + 3];
  }
}

__device__ __forceinline__ void residual(const Params& q, const float* pc, const float* o,
                                         bool stereo, float* res, float* inv_z_out) {
  const float z = pc[2];
  const float z_safe = fabsf(z) < 1e-6f ? 1e-6f : z;
  const float inv_z = 1.0f / z_safe;
  const float u = q.fx * pc[0] * inv_z + q.cx;
  const float v = q.fy * pc[1] * inv_z + q.cy;
  const float ur = u - q.bf * inv_z;
  res[0] = u - o[0];
  res[1] = v - o[1];
  res[2] = stereo ? ur - o[2] : 0.0f;
  *inv_z_out = inv_z;
}

__device__ __forceinline__ RowModel row_model(const Params& q, const float* T, const float* p,
                                              const float* o, bool stereo) {
  RowModel m;
  float pc[3], inv_z;
  camera_point(T, p, pc);
  residual(q, pc, o, stereo, m.res, &inv_z);
  const float x = pc[0], y = pc[1], z = pc[2];
  const float inv_z2 = inv_z * inv_z;
  // d(u, v, u_right) / d pc
  float d[3][3];
  d[0][0] = q.fx * inv_z;
  d[0][1] = 0.0f;
  d[0][2] = -q.fx * x * inv_z2;
  d[1][0] = 0.0f;
  d[1][1] = q.fy * inv_z;
  d[1][2] = -q.fy * y * inv_z2;
  d[2][0] = d[0][0];
  d[2][1] = d[0][1];
  d[2][2] = d[0][2] + q.bf * inv_z2;
  const float row_w[3] = {1.0f, 1.0f, stereo ? 1.0f : 0.0f};
  // d pc / d xi = [I | -hat(pc)]
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    m.J[r][0] = d[r][0] * row_w[r];
    m.J[r][1] = d[r][1] * row_w[r];
    m.J[r][2] = d[r][2] * row_w[r];
    m.J[r][3] = (d[r][1] * -z + d[r][2] * y) * row_w[r];
    m.J[r][4] = (d[r][0] * z + d[r][2] * -x) * row_w[r];
    m.J[r][5] = (d[r][0] * -y + d[r][1] * x) * row_w[r];
  }
  return m;
}

// pose_opt._chi2 of a residual (unscaled, or scaled by (1, 1, sw2))
__device__ __forceinline__ float chi2_of(const float* res, float inv_sigma2, bool stereo) {
  const float e2 = (res[0] * res[0] + res[1] * res[1]) + (stereo ? res[2] * res[2] : 0.0f);
  return e2 * inv_sigma2;
}

// Solve A x = rhs (6x6, float32) by LU with partial pivoting, as getrf /
// getrs do: the first row of largest |pivot|, rows swapped, the
// multipliers divided by the pivot.  Every index is known at compile time,
// so A stays in registers.
__device__ void solve6(float A[6][6], float x[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int p = j;
    float best = fabsf(A[j][j]);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const float a = fabsf(A[i][j]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const bool s = i == p;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float t = A[j][k];
        A[j][k] = s ? A[i][k] : t;
        A[i][k] = s ? t : A[i][k];
      }
      const float t = x[j];
      x[j] = s ? x[i] : t;
      x[i] = s ? t : x[i];
    }
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      const float l = A[i][j] / A[j][j];
#pragma unroll
      for (int k = j + 1; k < 6; ++k) A[i][k] -= l * A[j][k];
      x[i] -= l * x[j];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= A[i][k] * x[k];
    x[i] = s / A[i][i];
  }
}

// exp(dx) @ T (se3.update_left) into T_new, both row-major 4x4
__device__ void update_left(const float* dx, const float* T, float* T_new) {
  const float* rho = dx;
  const float* phi = dx + 3;
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = theta2 < 1e-8f;
  const float safe_t2 = small ? 1.0f : theta2;
  const float theta = sqrtf(safe_t2);
  const float s = sinf(theta), c = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / safe_t2;
  const float cc = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - s) / (safe_t2 * theta);
  const float K[3][3] = {{0.0f, -phi[2], phi[1]}, {phi[2], 0.0f, -phi[0]}, {-phi[1], phi[0], 0.0f}};
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = eye + a * K[i][j] + b * kk;   // so3_exp
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      t += (eye + b * K[i][j] + cc * kk) * rho[j];   // the left Jacobian
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T_new[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                         E[i][3] * T[12 + j];
    }
  }
}

template <int kThreads, int kRows>
__global__ void __launch_bounds__(kThreads)
    pose_opt_kernel(const float* __restrict__ Tcw0, const float* __restrict__ pts_w,
                    const float* __restrict__ obs, const float* __restrict__ sigma2,
                    const bool* __restrict__ valid, float* __restrict__ Tcw_out,
                    bool* __restrict__ inliers, int* __restrict__ n_inliers,
                    float* __restrict__ chi2_out, int N, Params q) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float s_T[16];
  __shared__ float s_part[kWarps][kSums];
  __shared__ float s_sum[kSums];
  __shared__ int s_frozen;          // the last round whose loop froze
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t pose = blockIdx.x;
  if (pose == 0 && tid == 0) atomicAdd(&g_launches, 1ull);
  pts_w += pose * N * 3;
  obs += pose * N * 3;
  sigma2 += pose * N;
  valid += pose * N;

  // this thread's rows: tid, tid + kThreads, ... (read once)
  float P[kRows][3], O[kRows][3], inv_s2[kRows];
  unsigned stereo = 0, ok = 0, active = 0;   // one bit a row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = tid + r * kThreads;
    const bool in = n < N;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      P[r][k] = in ? pts_w[3 * n + k] : 0.0f;
      O[r][k] = in ? obs[3 * n + k] : 0.0f;
    }
    const float s2 = in ? sigma2[n] : 1.0f;
    inv_s2[r] = 1.0f / (s2 < 1e-9f ? 1e-9f : s2);
    if (in && O[r][2] >= 0.0f) stereo |= 1u << r;
    if (in && valid[n]) ok |= 1u << r;
  }
  active = ok;
  if (tid < 16) s_T[tid] = Tcw0[pose * 16 + tid];
  if (tid == 0) s_frozen = -1;
  __syncthreads();

  for (int round = 0; round < q.n_rounds; ++round) {
    const bool huber = round < 2;
    for (int it = 0; it < q.n_iters; ++it) {
      float T[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) T[k] = s_T[k];
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (tid + r * kThreads >= N) continue;
        const bool st = (stereo >> r) & 1u;
        RowModel m = row_model(q, T, P[r], O[r], st);
        m.res[2] *= q.sw2;
#pragma unroll
        for (int k = 0; k < 6; ++k) m.J[2][k] *= q.sw2;
        const float th = st ? kChi2Stereo : kChi2Mono;
        float w_rob = 1.0f;
        if (huber) {
          const float chi2 = chi2_of(m.res, inv_s2[r], st);
          w_rob = chi2 <= th ? 1.0f : sqrtf(th) / sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
        }
        const float w = inv_s2[r] * w_rob * (((active >> r) & 1u) ? 1.0f : 0.0f);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          int k = 0;
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            const float jw = m.J[i][a] * w;
#pragma unroll
            for (int c = a; c < 6; ++c) acc[k++] += jw * m.J[i][c];
            acc[21 + a] += jw * m.res[i];
          }
        }
      }
      // the block's sums, in a fixed order: a shuffle tree in each warp,
      // then the warps in order
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) s_part[warp][k] = v;
      }
      __syncthreads();
      if (warp == 0) {
        if (lane < kSums) {
          float v = s_part[0][lane];
#pragma unroll
          for (int w2 = 1; w2 < kWarps; ++w2) v += s_part[w2][lane];
          s_sum[lane] = v;
        }
        __syncwarp();
        if (lane == 0) {
          float H[6][6], x[6];
          int k = 0;
#pragma unroll
          for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int c = a; c < 6; ++c) {
              H[a][c] = H[c][a] = s_sum[k++];
            }
          }
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            H[a][a] = H[a][a] + q.damping * H[a][a] + 1e-9f;
            x[a] = -s_sum[21 + a];
          }
          solve6(H, x);
          float n2 = 0.0f;
          bool finite = true;
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            finite = finite && isfinite(x[a]);
            n2 += x[a] * x[a];
          }
          const bool step_ok = finite && sqrtf(n2) < 1e3f;
#pragma unroll
          for (int a = 0; a < 6; ++a) x[a] = step_ok ? x[a] : 0.0f;
          float T_new[16];
          update_left(x, T, T_new);
          float delta = 0.0f;
#pragma unroll
          for (int e = 0; e < 12; ++e) {
            const float dd = T_new[e] - T[e];
            delta += dd * dd;
          }
#pragma unroll
          for (int e = 0; e < 16; ++e) s_T[e] = T_new[e];
          if (delta <= 1e-6f) s_frozen = round;
        }
      }
      __syncthreads();
      if (s_frozen == round) break;
    }
    // reclassify every row at the round's pose (unscaled residuals)
    float T[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) T[k] = s_T[k];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool st = (stereo >> r) & 1u;
      float pc[3], res[3], inv_z;
      camera_point(T, P[r], pc);
      residual(q, pc, O[r], st, res, &inv_z);
      const bool in_th = chi2_of(res, inv_s2[r], st) <= (st ? kChi2Stereo : kChi2Mono);
      active = (in_th && ((ok >> r) & 1u)) ? active | (1u << r) : active & ~(1u << r);
    }
  }

  // outputs: the pose, each row's chi2 at it, the inliers and their count
  float T[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = s_T[k];
  int count = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = tid + r * kThreads;
    if (n >= N) continue;
    const bool st = (stereo >> r) & 1u;
    float pc[3], res[3], inv_z;
    camera_point(T, P[r], pc);
    residual(q, pc, O[r], st, res, &inv_z);
    chi2_out[pose * N + n] = chi2_of(res, inv_s2[r], st);
    const bool in = (active >> r) & 1u;
    inliers[pose * N + n] = in;
    count += in;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) total += s_count[w2];
    n_inliers[pose] = total;
  }
  if (tid < 16) Tcw_out[pose * 16 + tid] = T[tid];
}

template <int kThreads, int kRows>
cudaError_t launch(const float* Tcw0, const float* pts_w, const float* obs,
                   const float* sigma2, const bool* valid, float* Tcw, bool* inliers,
                   int* n_inliers, float* chi2, int B, int N, const Params& q,
                   cudaStream_t stream) {
  pose_opt_kernel<kThreads, kRows><<<B, kThreads, 0, stream>>>(
      Tcw0, pts_w, obs, sigma2, valid, Tcw, inliers, n_inliers, chi2, N, q);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The block is 256 threads for N
// <= 1,024 rows, 512 for N <= 2,048, and 256 threads of 16 rows up to
// kMaxRows: each thread holds at most 16 rows in registers.
extern "C" int pose_opt_launch(const float* Tcw0, const float* pts_w, const float* obs,
                               const float* sigma2, const bool* valid, float* Tcw,
                               bool* inliers, int* n_inliers, float* chi2, int B, int N,
                               float fx, float fy, float cx, float cy, float bf, float sw2,
                               float damping, int n_rounds, int n_iters, void* stream) {
  if (B < 0 || N < 0 || N > kMaxRows || n_rounds < 0 || n_iters < 0) return -1;
  if (B == 0) return 0;
  const Params q{fx, fy, cx, cy, bf, sw2, damping, n_rounds, n_iters};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 1024) {
    return launch<256, 4>(Tcw0, pts_w, obs, sigma2, valid, Tcw, inliers, n_inliers, chi2, B, N,
                          q, s);
  }
  if (N <= 2048) {
    return launch<512, 4>(Tcw0, pts_w, obs, sigma2, valid, Tcw, inliers, n_inliers, chi2, B, N,
                          q, s);
  }
  return launch<256, 16>(Tcw0, pts_w, obs, sigma2, valid, Tcw, inliers, n_inliers, chi2, B, N,
                         q, s);
}

extern "C" long long pose_opt_device_launches(int reset) {
  unsigned long long n = 0;
  if (cudaDeviceSynchronize() != cudaSuccess) return -1;
  if (cudaMemcpyFromSymbol(&n, g_launches, sizeof(n)) != cudaSuccess) return -1;
  if (reset) {
    const unsigned long long zero = 0;
    if (cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero)) != cudaSuccess) return -1;
  }
  return static_cast<long long>(n);
}
