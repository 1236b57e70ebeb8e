// ICP kernels for Hopper (sm_90a): the projective association of one
// pyramid level (K2), the fixed-correspondence Gauss-Newton iterations (K3)
// and the normal equations of one linearization (K6).
//
// K2 replaces instancefusion_tpu/ops/pallas/icp.py:gather_target_maps
// (_gather_kernel) together with the jnp around it in ops/icp.associate:
// the two transforms, the projection, the in-image test and the selection.
// On the TPU the nearest-pixel lookup ran as factored one-hot contractions
// on the MXU over tile-aligned windows.  Here the whole association is one
// launch, one thread per source pixel: it moves the source vertex by
// T_est_wc (read from device memory, so the pose never visits the host),
// into the prediction view by T_tgt_cw, projects it, and reads the target
// vertex, normal and validity at the nearest pixel (ceil(v - 0.5),
// ceil(u - 0.5)) of the full-resolution prediction at the level's stride
// (so no decimated copy is made) and, with the photometric planes, the
// level's intensity and gradients at the same pixel.  It writes q_w, n_t,
// the association flag and the f32 gate that K3 reads, into one buffer.
// The transforms and the projection round once per operation in the plain
// version's order (common.cuh), so every output is bit-identical to the
// plain version (ops/kernels/icp.py:associate_gather_ref).  Bound: bytes
// (13 B of source, 25 B of scattered target reads (37 with the
// planes) and 29 B (41) written a pixel); neighbouring source pixels hit
// neighbouring target pixels, so the reads stay mostly coalesced.  At the
// coarse levels the launch itself is the cost: it replaces about 29 eager
// device ops and 3 decimation copies.
//
// K3 replaces instancefusion_tpu/ops/pallas/icp.py:gn_iterations
// (_gn_kernel).  The TPU kernel walked pixel tiles in order on one core, grid
// (inner_n, tiles), and solved the 6x6 system in the last tile of each step.
// Here all inner_n steps run in ONE cooperative launch (gn_kernel): a grid
// of as many blocks as the card holds at once (at most kBlocksPerSm an SM,
// sized once per device by ifl_gn_grid), and each step is
//   reduce: each block accumulates the 29 normal-equation sums (21
//     upper-triangle J^T J, 6 J^T r, inlier count, sum |r|) of a
//     grid-stride slice of pixels in fp32 registers and, with the
//     photometric term, 27 more (21 Jr^T Jr, 6 Jr^T r) under the
//     photometric gate alone: the geometric gate does not skip them.  Sums
//     are reduced by warp shuffles and written as one row of per-block
//     partials, double-buffered by step parity;
//   one grid barrier (cooperative_groups grid sync);
//   solve, in every block: the block adds all rows in one fixed order in
//     fp64 (sum_rows: float4 column slices over groups of threads, then the
//     groups in order), joins the photometric system at the trust fraction
//     wr = rgb_weight * tr(H_geo) / tr(H_rgb), damps the diagonal by
//     damping * max(H_ii, 1), solves by a fully unrolled Cholesky in
//     registers, zeroes the increment unless inliers >= min_valid and it is
//     finite, and updates the pose by exp(xi) (Rodrigues) in shared memory.
// Every block computes the same pose bit for bit (same rows, same order,
// same code), so no second barrier is needed; the double buffer lets a fast
// block write step s+1's row while a slow one still reads step s's.  Block
// 0 writes the pose and the last step's stats (inliers, sum |r| w, wr).
// No float atomics: the pose is the same from run to run, and it never
// goes to the host.  Bound: bytes (13 floats a pixel per step, 18 with the
// photometric planes); beside them each step costs a grid barrier and a
// serial fp64 solve of a few hundred operations in one thread a block.
//
// K6 replaces instancefusion_tpu/ops/pallas/icp.py:reduce_normal_equations
// (_kernel): the same 29 sums for given world points, target points and
// normals and a float mask (w = mask x Huber weight), without the gate,
// pose or solve.  One launch (ne_kernel): each thread accumulates K3's
// per-pixel terms (accumulate_point_to_plane, shared) over a grid-stride
// slice of pixels, two pixels a turn with both pixels' loads issued first,
// the mask a factor and not a branch (a masked pixel adds zeros), and each
// block writes its 29 sums as one row of partials (block_sums_to_row).
// Then the block fences its row and draws an integer ticket from a counter;
// the block that draws the last one adds every row with K3's fixed-order
// fp64 tree (sum_rows) and writes H (6x6, symmetric), b, the inlier sum
// and sum |r| w; atomicInc wraps the counter back to 0 on that last
// ticket, for the next launch (or a CUDA-graph replay).  The ticket decides
// which block finishes, never the order of a sum, so the result repeats
// from run to run; unlike K3, no block waits for another, so the grid
// need not be resident.  The grid is 2 blocks an SM (ops/kernels/icp.py),
// several pixels a thread at level 0.  Bound: bytes (40 B a pixel read
// once).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSums = 29;     // point-to-plane sums
constexpr int kRgbSums = 27;  // photometric sums: 21 Jr^T Jr, 6 Jr^T (-r)
constexpr int kRow = 64;      // partials row stride (floats)
constexpr int kReduceThreads = 256;
// K3's blocks an SM at most: every block re-adds every row of partials in
// each step, a cost that grows with the square of the grid.
constexpr int kBlocksPerSm = 2;

// One pixel's point-to-plane terms at world point p against target point q
// with normal n: r = n.(p - q), J = [n, p x n], w = mask * min(1, delta /
// |r|) for a Huber delta > 0, else mask.  Adds the 21 upper-triangle sums
// of J^T J w, the 6 of J^T (-r) w, mask and |r| w to acc[0..28].  Shared by
// K3 (mask 1 on a gated pixel) and K6.
__device__ __forceinline__ void accumulate_point_to_plane(
    float* acc, float px, float py, float pz, float nx, float ny, float nz,
    float qx, float qy, float qz, float mask, float huber_delta) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  const float r = nx * dx + ny * dy + nz * dz;
  float w = mask;
  if (huber_delta > 0.0f) w = mask * fminf(1.0f, huber_delta / fmaxf(fabsf(r), 1e-9f));
  const float j[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz,
                      px * ny - py * nx};
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += j[a] * j[b] * w;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * (-r) * w;
  acc[27] += mask;
  acc[28] += fabsf(r) * w;
}

// One pixel's photometric terms (the reference's rgbStep) at world point p:
// the residual I_t - I_s against the target intensity gathered at
// association time, J = [g, p x g] with g = dI/dp_w = R_cw^T dI/dp_c, and
// dI/dp_c from the target gradients through the projection of the
// prediction view (C = T_pred_cw, row-major 3x4; fx, fy of the level).
// The gate is the photometric gate times (z in the prediction camera > 0).
// Adds 21 upper-triangle sums of J^T J m and 6 of J^T (-r) m to acc[0..26].
__device__ __forceinline__ void accumulate_photometric(
    float* acc, float px, float py, float pz, const float* C, float fx,
    float fy, float i_src, float i_tgt, float gx, float gy, float gate) {
  const float pcx = C[0] * px + C[1] * py + C[2] * pz + C[3];
  const float pcy = C[4] * px + C[5] * py + C[6] * pz + C[7];
  const float pcz = C[8] * px + C[9] * py + C[10] * pz + C[11];
  if (!(pcz > 0.0f)) return;
  const float zs = fmaxf(pcz, 1e-6f);
  const float gpx = gx * fx / zs;
  const float gpy = gy * fy / zs;
  const float gpz = -(gpx * pcx + gpy * pcy) / zs;
  const float gwx = C[0] * gpx + C[4] * gpy + C[8] * gpz;
  const float gwy = C[1] * gpx + C[5] * gpy + C[9] * gpz;
  const float gwz = C[2] * gpx + C[6] * gpy + C[10] * gpz;
  const float r = i_tgt - i_src;
  const float j[6] = {gwx, gwy, gwz, py * gwz - pz * gwy, pz * gwx - px * gwz,
                      px * gwy - py * gwx};
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += j[a] * j[b] * gate;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * (-r) * gate;
}

// Sums acc[0..N) over the block's threads (warp shuffles, then one value a
// warp through shared memory) and writes the N totals to row[0..N), and
// zeros up to the row's next multiple of 4 (sum_rows reads float4s).
template <int N>
__device__ __forceinline__ void block_sums_to_row(const float* acc,
                                                  float* __restrict__ row) {
  __shared__ float warp_sums[kReduceThreads / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < kReduceThreads / 32; ++w) s += warp_sums[w][threadIdx.x];
    row[threadIdx.x] = s;
  } else if (threadIdx.x < (N + 3) / 4 * 4) {
    row[threadIdx.x] = 0.0f;
  }
}

// The totals of N sums over `nrows` rows of partials, in fp64 and in one
// fixed order whatever the block: the block's threads form groups of
// (N + 3) / 4 threads, each thread one float4 column slice; group g adds
// rows g, g + G, g + 2G, ... (G groups), then thread k < N adds the groups'
// column k in group order.  The rows may have been written by other blocks
// of this launch, so they are read through L2 (__ldcg), not the
// non-coherent cache.  Ends with the block synchronized.
template <int N>
__device__ __forceinline__ void sum_rows(const float* rows, int nrows,
                                         double* __restrict__ sums) {
  constexpr int kCols = (N + 3) / 4;
  constexpr int kGroups = kReduceThreads / kCols;
  __shared__ double part[kGroups][4 * kCols];
  const int col = threadIdx.x % kCols, g = threadIdx.x / kCols;
  if (g < kGroups) {
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll 8
    for (int b = g; b < nrows; b += kGroups) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(rows + b * kRow) + col);
      s0 += (double)x.x;
      s1 += (double)x.y;
      s2 += (double)x.z;
      s3 += (double)x.w;
    }
    part[g][4 * col] = s0;
    part[g][4 * col + 1] = s1;
    part[g][4 * col + 2] = s2;
    part[g][4 * col + 3] = s3;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = 0.0;
    for (int j = 0; j < kGroups; ++j) s += part[j][threadIdx.x];
    sums[threadIdx.x] = s;
  }
  __syncthreads();
}

// One Gauss-Newton solve from the step's totals `sums` (29, or 56 with the
// photometric sums) and the pose update T <- exp(xi) T on the 3x4 pose in
// T (row-major).  stat receives the step's inliers, sum |r| w and wr.  One
// thread; every loop has a compile-time trip count and is unrolled, so H,
// L and the twist live in registers.
template <bool kRgb>
__device__ __forceinline__ void solve_step(const double* sums, float damping,
                                           float min_valid, float rgb_weight,
                                           float* T, float* stat) {
  double H[6][6], bv[6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) {
      H[a][b] = sums[k];
      H[b][a] = sums[k];
      ++k;
    }
#pragma unroll
  for (int a = 0; a < 6; ++a) bv[a] = sums[21 + a];
  double wr = 0.0;
  if constexpr (kRgb) {
    // Trust-fraction combine: the photometric system carries the share
    // rgb_weight of the joint information, whatever the resolution.
    constexpr int diag[6] = {0, 6, 11, 15, 18, 20};
    double trg = 0.0, trr = 0.0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      trg += sums[diag[a]];
      trr += sums[kSums + diag[a]];
    }
    wr = (double)rgb_weight * trg / fmax(trr, 1e-20);
    k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) {
        H[a][b] += wr * sums[kSums + k];
        H[b][a] = H[a][b];
        ++k;
      }
#pragma unroll
    for (int a = 0; a < 6; ++a) bv[a] += wr * sums[kSums + 21 + a];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) H[a][a] += (double)damping * fmax(H[a][a], 1.0);
  const double nin = sums[27];

  // Cholesky H = L L^T (L over H's lower triangle), then forward and back
  // substitution, dividing once per diagonal entry.
  double inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      double s = H[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) s -= H[i][m] * H[j][m];
      if (i == j) {
        H[i][i] = sqrt(fmax(s, 1e-20));
        inv[i] = 1.0 / H[i][i];
      } else {
        H[i][j] = s * inv[j];
      }
    }
  double y[6], xd[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double s = bv[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s -= H[i][m] * y[m];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s -= H[m][i] * xd[m];
    xd[i] = s * inv[i];
  }
  bool ok = nin >= (double)min_valid;
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(xd[i]);
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = ok ? (float)xd[i] : 0.0f;

  // exp(xi) with the blended small-angle coefficients of geometry/se3.py.
  // sin through sinpif: its argument reduction is exact and needs no local
  // memory (sinf's large-argument path keeps a stack frame).
  constexpr float kInvPi = 0.318309886183790671f;
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  const bool small = th2 < 1e-4f;
  const float tp = th * kInvPi;
  const float A = small ? 1.0f - th2 / 6.0f : sinpif(tp) / th;
  const float hs = sinpif(0.5f * tp);
  const float B = small ? 0.5f - th2 / 24.0f : 2.0f * hs * hs / th2;
  const float Cc = small ? 1.0f / 6.0f - th2 / 120.0f : (1.0f - A) / th2;
  const float K[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float K2[3][3], R[3][3], V[3][3], t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) s += K[a][c] * K[c][b];
      K2[a][b] = s;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float eye = (a == b) ? 1.0f : 0.0f;
      R[a][b] = eye + A * K[a][b] + B * K2[a][b];
      V[a][b] = eye + B * K[a][b] + Cc * K2[a][b];
    }
#pragma unroll
  for (int a = 0; a < 3; ++a) t[a] = V[a][0] * xi[0] + V[a][1] * xi[1] + V[a][2] * xi[2];

  // T <- exp(xi) @ T (the bottom row of T is [0 0 0 1]).
  float old[12];
#pragma unroll
  for (int m = 0; m < 12; ++m) old[m] = T[m];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float s = R[a][0] * old[b] + R[a][1] * old[4 + b] + R[a][2] * old[8 + b];
      if (b == 3) s += t[a];
      T[4 * a + b] = s;
    }
  stat[0] = (float)nin;
  stat[1] = (float)sums[28];
  stat[2] = (float)wr;
}

// out holds, for n source pixels: q f32[n, 3], n_t f32[n, 3], gate f32[n],
// then with the planes i_t, gx_t, gy_t f32[n] each, then ok u8[n].
__global__ void associate_kernel(
    const float* __restrict__ sv, const uint8_t* __restrict__ sval, int n,
    const float* __restrict__ T_est, const float* __restrict__ T_tgt,
    float fx, float fy, float cx, float cy, int width, int height,
    const float* __restrict__ tvert, const float* __restrict__ tnorm,
    const uint8_t* __restrict__ tvalid, const float* __restrict__ ti,
    const float* __restrict__ tgx, const float* __restrict__ tgy, int wt,
    int hl, int wl, int stride, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long nn = n;
  const float sx = sv[3 * i], sy = sv[3 * i + 1], sz = sv[3 * i + 2];
  const float wx = cam_row(sx, sy, sz, T_est);
  const float wy = cam_row(sx, sy, sz, T_est + 4);
  const float wz = cam_row(sx, sy, sz, T_est + 8);
  const float x = cam_row(wx, wy, wz, T_tgt);
  const float y = cam_row(wx, wy, wz, T_tgt + 4);
  const float z = cam_row(wx, wy, wz, T_tgt + 8);
  const float zs = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float uf = ceilf(__fsub_rn(project_coord(fx, x, zs, cx), 0.5f));
  const float vf = ceilf(__fsub_rn(project_coord(fy, y, zs, cy), 0.5f));
  const bool sel = sval[i] != 0 && uf >= 0.0f && uf < (float)width &&
                   vf >= 0.0f && vf < (float)height && z > 0.0f;
  // Round half up, clamped into the decimated target; fmaxf maps NaN to 0.
  const int ui = (int)fminf(fmaxf(uf, 0.0f), (float)(wl - 1));
  const int vi = (int)fminf(fmaxf(vf, 0.0f), (float)(hl - 1));
  const long long flat = (long long)vi * stride * wt + (long long)ui * stride;
  float* q = out;
  float* nt = out + 3 * nn;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[3 * i + c] = tvert[3 * flat + c];
    nt[3 * i + c] = tnorm[3 * flat + c];
  }
  const bool ok = sel && tvalid[flat] != 0;
  out[6 * nn + i] = ok ? 1.0f : 0.0f;
  int nf = 7;
  if (ti != nullptr) {  // the level's photometric planes, at the same pixel
    const int lflat = vi * wl + ui;
    out[7 * nn + i] = ti[lflat];
    out[8 * nn + i] = tgx[lflat];
    out[9 * nn + i] = tgy[lflat];
    nf = 10;
  }
  reinterpret_cast<uint8_t*>(out + nf * nn)[i] = ok ? 1 : 0;
}

// out: T f32[16] (the 4x4 pose; its bottom row copied from T_init), then
// the last step's inliers, sum |r| w and wr.  partials: 2 x gridDim.x rows.
template <bool kRgb>
__global__ void __launch_bounds__(kReduceThreads, kBlocksPerSm)
    gn_kernel(const float* __restrict__ sv, const float* __restrict__ sn,
              const float* __restrict__ q, const float* __restrict__ nt,
              const float* __restrict__ gate, const float* __restrict__ ris,
              const float* __restrict__ rit, const float* __restrict__ rgx,
              const float* __restrict__ rgy, const float* __restrict__ rgate,
              int n, const float* __restrict__ T_init,
              const float* __restrict__ Tpc, float fx, float fy,
              float dist_thresh, float angle_thresh, float huber_delta,
              float damping, float min_valid, float rgb_weight, int inner_n,
              float* partials, float* __restrict__ out) {
  constexpr int kAcc = kRgb ? kSums + kRgbSums : kSums;
  __shared__ float Ts[12];
  __shared__ float stat[3];
  __shared__ double sums[kAcc];
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x < 12) Ts[threadIdx.x] = T_init[threadIdx.x];
  float C[12] = {};
  if constexpr (kRgb) {
#pragma unroll
    for (int m = 0; m < 12; ++m) C[m] = Tpc[m];
  }
  __syncthreads();

  for (int step = 0; step < inner_n; ++step) {
    float* rows = partials + (step & 1) * gridDim.x * kRow;
    const float r00 = Ts[0], r01 = Ts[1], r02 = Ts[2], t0 = Ts[3];
    const float r10 = Ts[4], r11 = Ts[5], r12 = Ts[6], t1 = Ts[7];
    const float r20 = Ts[8], r21 = Ts[9], r22 = Ts[10], t2 = Ts[11];
    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
      const bool geo = gate[i] != 0.0f;
      float mrg = 0.0f;
      if constexpr (kRgb) mrg = rgate[i];
      if (!geo && mrg == 0.0f) continue;
      const float sx = sv[3 * i], sy = sv[3 * i + 1], sz = sv[3 * i + 2];
      const float px = r00 * sx + r01 * sy + r02 * sz + t0;
      const float py = r10 * sx + r11 * sy + r12 * sz + t1;
      const float pz = r20 * sx + r21 * sy + r22 * sz + t2;
      if (geo) {
        const float ax = sn[3 * i], ay = sn[3 * i + 1], az = sn[3 * i + 2];
        const float nwx = r00 * ax + r01 * ay + r02 * az;
        const float nwy = r10 * ax + r11 * ay + r12 * az;
        const float nwz = r20 * ax + r21 * ay + r22 * az;
        const float tx = nt[3 * i], ty = nt[3 * i + 1], tz = nt[3 * i + 2];
        const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
        const float dx = px - qx, dy = py - qy, dz = pz - qz;
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
        const float ndot = nwx * tx + nwy * ty + nwz * tz;
        if (dist < dist_thresh && ndot > angle_thresh)
          accumulate_point_to_plane(acc, px, py, pz, tx, ty, tz, qx, qy, qz, 1.0f,
                                    huber_delta);
      }
      if constexpr (kRgb) {
        if (mrg != 0.0f)
          accumulate_photometric(acc + kSums, px, py, pz, C, fx, fy, ris[i], rit[i],
                                 rgx[i], rgy[i], mrg);
      }
    }
    block_sums_to_row<kAcc>(acc, rows + blockIdx.x * kRow);
    grid.sync();
    sum_rows<kAcc>(rows, gridDim.x, sums);
    if (threadIdx.x == 0) solve_step<kRgb>(sums, damping, min_valid, rgb_weight, Ts, stat);
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < 12) out[threadIdx.x] = Ts[threadIdx.x];
    else if (threadIdx.x < 16) out[threadIdx.x] = T_init[threadIdx.x];
    else if (threadIdx.x < 19) out[threadIdx.x] = stat[threadIdx.x - 16];
  }
}

// The ten floats of pixel i that K6 reads: p, n, q and the mask.
__device__ __forceinline__ void load_ne_pixel(const float* __restrict__ p,
                                              const float* __restrict__ nt,
                                              const float* __restrict__ q,
                                              const float* __restrict__ mask, int i,
                                              float (&x)[10]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[c] = p[3 * i + c];
    x[3 + c] = nt[3 * i + c];
    x[6 + c] = q[3 * i + c];
  }
  x[9] = mask[i];
}

__device__ __forceinline__ void accumulate_ne_pixel(float* acc, const float (&x)[10],
                                                    float huber_delta) {
  accumulate_point_to_plane(acc, x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7],
                            x[8], x[9], huber_delta);
}

// partials holds gridDim.x rows; ticket is 0 at the launch and again after
// (atomicInc wraps it to 0 on the last ticket).
__global__ void __launch_bounds__(kReduceThreads)
    ne_kernel(const float* __restrict__ p, const float* __restrict__ nt,
              const float* __restrict__ q, const float* __restrict__ mask,
              int n, float huber_delta, float* partials,
              unsigned int* ticket, float* __restrict__ out) {
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i < n - stride; i += 2 * stride) {
    float x0[10], x1[10];
    load_ne_pixel(p, nt, q, mask, i, x0);
    load_ne_pixel(p, nt, q, mask, i + stride, x1);
    accumulate_ne_pixel(acc, x0, huber_delta);
    accumulate_ne_pixel(acc, x1, huber_delta);
  }
  if (i < n) {
    float x0[10];
    load_ne_pixel(p, nt, q, mask, i, x0);
    accumulate_ne_pixel(acc, x0, huber_delta);
  }
  block_sums_to_row<kSums>(acc, partials + blockIdx.x * kRow);

  // Publish the row, then draw a ticket: the last block sees every row.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1u) == gridDim.x - 1u;
  __syncthreads();
  if (!last) return;
  __shared__ double sums[kSums];
  sum_rows<kSums>(partials, gridDim.x, sums);
  const int k = threadIdx.x;
  if (k < 21) {  // k-th upper-triangle entry (a, b) of H and its mirror
    int a = 0, base = 0;
    while (k >= base + 6 - a) base += 6 - a++;
    const int b = a + k - base;
    out[6 * a + b] = (float)sums[k];
    out[6 * b + a] = (float)sums[k];
  } else if (k < 27) {
    out[36 + k - 21] = (float)sums[k];
  } else if (k < kSums) {
    out[42 + k - 27] = (float)sums[k];
  }
}

}  // namespace

// With ti == nullptr the photometric planes are off and tgx, tgy are not
// read.
extern "C" int ifl_associate(const float* sv, const uint8_t* sval, int n,
                             const float* T_est, const float* T_tgt, float fx,
                             float fy, float cx, float cy, int width,
                             int height, const float* tvert,
                             const float* tnorm, const uint8_t* tvalid,
                             const float* ti, const float* tgx,
                             const float* tgy, int wt, int hl, int wl,
                             int stride, float* out, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  associate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      sv, sval, n, T_est, T_tgt, fx, fy, cx, cy, width, height, tvert, tnorm,
      tvalid, ti, tgx, tgy, wt, hl, wl, stride, out);
  return (int)cudaGetLastError();
}

// K3's grid on the current device: the SM count times the blocks an SM
// holds of both gn_kernel instances at once (at most kBlocksPerSm); a
// cooperative launch needs every block resident.  Computed once a device.
extern "C" int ifl_gn_grid(int* nblocks) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cache[dev] > 0) {
    *nblocks = cache[dev];
    return 0;
  }
  int sms = 0, geo = 0, rgb = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&geo, gn_kernel<false>,
                                                        kReduceThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&rgb, gn_kernel<true>,
                                                        kReduceThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int per_sm = geo < rgb ? geo : rgb;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *nblocks = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  if (dev < 64) cache[dev] = *nblocks;
  return 0;
}

// With ris == nullptr the photometric term is off and rit, rgx, rgy,
// rgate, Tpc, fx, fy and rgb_weight are not read.  partials holds 2 x
// nblocks rows of kRow floats; nblocks comes from ifl_gn_grid.
extern "C" int ifl_gn_iterations(const float* sv, const float* sn,
                                 const float* q, const float* nt,
                                 const float* gate, const float* ris,
                                 const float* rit, const float* rgx,
                                 const float* rgy, const float* rgate,
                                 const float* Tpc, int n, const float* T_init,
                                 float* partials, int nblocks, float* out,
                                 int inner_n, float dist_thresh,
                                 float angle_thresh, float huber_delta,
                                 float damping, float min_valid, float fx,
                                 float fy, float rgb_weight, void* stream) {
  void* args[] = {&sv, &sn, &q, &nt, &gate, &ris, &rit, &rgx, &rgy, &rgate,
                  &n, &T_init, &Tpc, &fx, &fy, &dist_thresh, &angle_thresh,
                  &huber_delta, &damping, &min_valid, &rgb_weight, &inner_n,
                  &partials, &out};
  const void* fn = ris != nullptr ? (const void*)gn_kernel<true>
                                  : (const void*)gn_kernel<false>;
  cudaError_t err = cudaLaunchCooperativeKernel(fn, nblocks, kReduceThreads, args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// partials holds at least nblocks rows of kRow floats; ticket is one
// counter, 0 between launches (ne_kernel leaves it so).
extern "C" int ifl_normal_equations(const float* p, const float* nt,
                                    const float* q, const float* mask, int n,
                                    float huber_delta, float* partials,
                                    unsigned int* ticket, int nblocks,
                                    float* out, void* stream) {
  ne_kernel<<<nblocks, kReduceThreads, 0, (cudaStream_t)stream>>>(
      p, nt, q, mask, n, huber_delta, partials, ticket, out);
  return (int)cudaGetLastError();
}
