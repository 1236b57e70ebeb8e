// TSDF kernels for Hopper (sm_90a): integrate (K4) and the running-average
// update of listed rows (K8).
//
// K4 (integrate_kernel) replaces
// instancefusion_tpu/ops/pallas/tsdf.py:fused_integrate and
// fused_integrate_groups (_integrate_kernel).  The TPU kernel sampled the
// depth and color images for each voxel through one-hot matmuls over a
// tile-aligned image window, addressed the payload by groups of 8 rows and
// skipped blocks straddling the camera plane because their window was
// meaningless.  Here each voxel reads its depth (and color) pixel directly
// and its payload in place, so straddling blocks keep exact per-voxel
// semantics, as in the plain version (ops/blocks.py integrate_slots of the
// reference, jnp branch).  The design:
//
// - A persistent grid: the blocks the card holds at once (resident_grid,
//   asked once a device by the wrapper), each walking the list entries
//   congruent to its index (common.cuh walk_valid_rows).  An invalid entry
//   costs five bytes read, not a scheduled block; valid rows are unique
//   (prefix-sum compaction), so no two threads write one voxel.
// - The block forms T_cw from T_wc once (se3_inverse_entry), in shared
//   memory: the wrapper runs no op before the launch.
// - 128 threads a block; each row is walked 16 bytes a thread: a thread
//   takes 4 voxels of one z-run (block_size a multiple of 4), sharing
//   their x and y terms, and moves sdf, weight and each packed color
//   segment as one float4.  A quad is written back only where a value
//   changed bit for bit.
// - Arithmetic: one rounding per operation in the plain version's order
//   (common.cuh: the voxel center by grid_to_world, the transform by
//   cam_row, the projection by project_coord with the zsafe guard, rintf
//   half to even, __fdiv_rn for psi and the blends), so the kernel equals
//   ops/kernels/tsdf.integrate_ref bit for bit.
//
// Depth-only frames still read every voxel's sdf and weight: where a
// voxel does not observe, the plain version (and the reference) rewrites
// sdf as (s w) / w, which is not always s (s = 0.45f, w = 3 gives the
// next float below).  The quad-level write skip keeps the unchanged ones.
//
// K4's bound: bytes.  Each valid row's sdf and weight (2 KB each) and, on
// color frames, its packed color row (6 KB) are read, and the quads that
// change are written; the image reads hit L2.

// K8 (tsdf_update_kernel, below) replaces
// instancefusion_tpu/ops/pallas/tsdf.py:fused_tsdf_update (_update_kernel):
// the weighted running average of sdf, weight and packed color over rows
// whose observations (psi, w_obs, packed color obs) were computed outside
// the kernel, as the touched-block integrate of the block map does.  The
// TPU kernel took gathered rows in 64-row tiles and left the scatter back
// to XLA; here the payload rows are read and written in place.  The
// design, K4's list walk without the projection:
//
// - A persistent grid (resident_grid, asked once a device by the wrapper)
//   walks the valid list entries (common.cuh walk_valid_slots): entries
//   whose valid flag is false (their slot holds 0, a real block) cost
//   their flag and slot and are never read or written, and no thread
//   divides.
// - 128 threads a block, one float4 quad of a row each (a 512-voxel row is
//   one pass).  The observation rows are indexed by list position, the
//   payload by slot.  Every load of the quad (sdf, weight, psi, w_obs and,
//   with color, the three color and observation segments) is issued before
//   any arithmetic, and sdf, weight and each color segment are written back
//   only where a value changed bit for bit (store4_if_changed).
// - Arithmetic: one rounding per operation in tsdf_update_ref's order
//   (__fmul_rn, __fadd_rn, a correctly rounded reciprocal __frcp_rn for
//   1 / max(w, 1e-6), as PyTorch's eager reciprocal), and clamps that
//   keep a NaN as torch.clamp does, so the kernel equals the plain version
//   bit for bit.
//
// Every valid voxel is read, also where w_obs is 0: the plain version and
// the reference rewrite sdf as (s w_old) (1 / w_old) there, which is not
// always s, and each color segment likewise.  A null color pointer updates
// sdf and weight only (depth-only frames, maps without color).
//
// K8's bound: bytes.  Per voxel of a valid row psi, w_obs, sdf and weight
// are read (16 B) and, with color, the three color floats (12 B); the
// three observations only where w_obs > 0 (12 B); the floats whose value
// changed are written.  About 25 flops a voxel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kIntegrateThreads = 128;
// 8 blocks an SM caps the kernel at 64 registers (the compiler takes 92
// unasked, 5 blocks an SM), so the grid (1056 blocks on an H100) holds the
// main path's ~850 valid rows at once, a block each, and a color frame's
// rows do not queue two to a block.
constexpr int kIntegrateMinBlocks = 8;

__global__ void __launch_bounds__(kIntegrateThreads, kIntegrateMinBlocks)
    integrate_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid, int k,
    const int32_t* __restrict__ block_coords, float* __restrict__ sdf,
    float* __restrict__ weight, float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ frame_color,
    const float* __restrict__ T_wc, Pinhole cam, int b, float voxel,
    float trunc, float ox, float oy, float oz, float max_weight,
    float color_gain) {
  // T_cw; the walk's first barrier publishes it before any row is read.
  __shared__ float T[12];
  if (threadIdx.x < 12) T[threadIdx.x] = se3_inverse_entry(T_wc, threadIdx.x);
  const int b3 = b * b * b, bb = b * b;
  walk_valid_rows<kIntegrateThreads>(
      slots, valid, k, block_coords, [&](int slot, int bx, int by, int bz) {
        for (int q = threadIdx.x; q < b3 / 4; q += kIntegrateThreads) {
          const int v0 = 4 * q;
          const long long row = (long long)slot * b3 + v0;
          const long long crow = (long long)slot * 3 * b3 + v0;
          // The payload first: its loads do not wait for the projection.
          float s_old[4], w_old[4], c_old[3][4];
          load4(sdf + row, s_old);
          load4(weight + row, w_old);
          if (frame_color != nullptr) {
#pragma unroll
            for (int c = 0; c < 3; ++c) load4(color + crow + c * b3, c_old[c]);
          }
          const int lx = v0 / bb, ly = (v0 / b) % b, lz = v0 % b;
          const float px = grid_to_world((float)(bx * b + lx), 0.5f, voxel, ox);
          const float py = grid_to_world((float)(by * b + ly), 0.5f, voxel, oy);
          const float xy0 = cam_row_xy(px, py, T), xy1 = cam_row_xy(px, py, T + 4),
                      xy2 = cam_row_xy(px, py, T + 8);
          float psi[4], w_obs[4];
          int pix[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pz =
                grid_to_world((float)(bz * b + lz + j), 0.5f, voxel, oz);
            const float z = cam_row_z(xy2, pz, T + 8);
            const PixelHit h = nearest_pixel(cam_row_z(xy0, pz, T),
                                             cam_row_z(xy1, pz, T + 4), z, cam);
            const float d = depth[h.pix];
            const float sdf_obs = __fsub_rn(d, z);
            psi[j] = fminf(fmaxf(__fdiv_rn(sdf_obs, trunc), -1.0f), 1.0f);
            w_obs[j] = h.seen && d > 0.0f && sdf_obs > -trunc ? 1.0f : 0.0f;
            pix[j] = h.pix;
          }
          float s_new[4], w_new[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float w_sum = __fadd_rn(w_old[j], w_obs[j]);
            s_new[j] = w_sum > 0.0f
                           ? __fdiv_rn(__fadd_rn(__fmul_rn(s_old[j], w_old[j]),
                                                 __fmul_rn(psi[j], w_obs[j])),
                                       fmaxf(w_sum, 1e-6f))
                           : s_old[j];
            w_new[j] = fminf(w_sum, max_weight);
          }
          store4_if_changed(sdf + row, s_old, s_new);
          store4_if_changed(weight + row, w_old, w_new);
          if (frame_color == nullptr) continue;
          float wc[4], den[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wc[j] = __fmul_rn(color_gain, w_obs[j]);
            den[j] = fmaxf(__fadd_rn(w_old[j], wc[j]), 1e-6f);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float c_new[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              c_new[j] = __fdiv_rn(
                  __fadd_rn(__fmul_rn(c_old[c][j], w_old[j]),
                            __fmul_rn(frame_color[3 * pix[j] + c], wc[j])),
                  den[j]);
            store4_if_changed(color + crow + c * b3, c_old[c], c_new);
          }
        }
      });
}

constexpr int kUpdateThreads = 128;

// max(w, 1e-6) and min(w, cap) that keep a NaN, as torch.clamp does.
__device__ __forceinline__ float clamp_min(float w, float lo) { return w < lo ? lo : w; }
__device__ __forceinline__ float clamp_max(float w, float hi) { return w > hi ? hi : w; }

__global__ void __launch_bounds__(kUpdateThreads)
    tsdf_update_kernel(const int32_t* __restrict__ slots,
                       const uint8_t* __restrict__ valid, int k, int b3,
                       float* __restrict__ sdf, float* __restrict__ weight,
                       float* __restrict__ color, const float* __restrict__ psi,
                       const float* __restrict__ w_obs,
                       const float* __restrict__ obs, float max_weight,
                       float color_gain) {
  walk_valid_slots<kUpdateThreads>(slots, valid, k, [&](int e, int slot) {
    for (int q = threadIdx.x; q < b3 / 4; q += kUpdateThreads) {
      const int v0 = 4 * q;
      const long long row = (long long)slot * b3 + v0;
      const long long orow = (long long)e * b3 + v0;
      const long long crow = 3 * (long long)slot * b3 + v0;
      const long long corow = 3 * (long long)e * b3 + v0;
      float s_old[4], w_old[4], ps[4], wo[4], c_old[3][4], o[3][4];
      load4(sdf + row, s_old);
      load4(weight + row, w_old);
      load4(psi + orow, ps);
      load4(w_obs + orow, wo);
      if (color != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          load4(color + crow + c * b3, c_old[c]);
          load4(obs + corow + c * b3, o[c]);
        }
      }
      float s_new[4], w_new[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w_sum = __fadd_rn(w_old[j], wo[j]);
        const float inv = __frcp_rn(clamp_min(w_sum, 1e-6f));
        s_new[j] = w_sum > 0.0f
                       ? __fmul_rn(__fadd_rn(__fmul_rn(s_old[j], w_old[j]),
                                             __fmul_rn(ps[j], wo[j])),
                                   inv)
                       : s_old[j];
        w_new[j] = clamp_max(w_sum, max_weight);
      }
      store4_if_changed(sdf + row, s_old, s_new);
      store4_if_changed(weight + row, w_old, w_new);
      if (color == nullptr) continue;
      float wc[4], inv_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wc[j] = __fmul_rn(color_gain, wo[j]);
        inv_c[j] = __frcp_rn(clamp_min(__fadd_rn(w_old[j], wc[j]), 1e-6f));
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float c_new[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c_new[j] = __fmul_rn(__fadd_rn(__fmul_rn(c_old[c][j], w_old[j]),
                                         __fmul_rn(o[c][j], wc[j])),
                               inv_c[j]);
        store4_if_changed(color + crow + c * b3, c_old[c], c_new);
      }
    }
  });
}

}  // namespace

// K8's grid on the current device (the blocks it holds at once).
extern "C" int ifl_tsdf_update_grid(int* nblocks) {
  return resident_grid(tsdf_update_kernel, kUpdateThreads, nblocks);
}

// grid blocks walk the k list entries; b3 must be a multiple of 4 and every
// row 16-byte aligned.  A null color leaves color as it is and obs unread.
extern "C" int ifl_tsdf_update(const int32_t* slots, const uint8_t* valid,
                               int k, int grid, int b3, float* sdf,
                               float* weight, float* color, const float* psi,
                               const float* w_obs, const float* obs,
                               float max_weight, float color_gain,
                               void* stream) {
  if (k == 0) return 0;
  tsdf_update_kernel<<<grid, kUpdateThreads, 0, (cudaStream_t)stream>>>(
      slots, valid, k, b3, sdf, weight, color, psi, w_obs, obs, max_weight,
      color_gain);
  return (int)cudaGetLastError();
}

// K4's grid on the current device (the blocks it holds at once).
extern "C" int ifl_integrate_grid(int* nblocks) {
  return resident_grid(integrate_kernel, kIntegrateThreads, nblocks);
}

// grid blocks walk the k list entries; block_size must be a multiple of 4
// and the payload rows 16-byte aligned.  A null frame_color fuses depth
// only and leaves color as it is.
extern "C" int ifl_integrate(const int32_t* slots, const uint8_t* valid, int k,
                             int grid, const int32_t* block_coords, float* sdf,
                             float* weight, float* color, const float* depth,
                             const float* frame_color, const float* T_wc,
                             int width, int height, int block_size, float fx,
                             float fy, float cx, float cy, float voxel,
                             float trunc, float ox, float oy, float oz,
                             float max_weight, float color_gain,
                             void* stream) {
  if (k == 0) return 0;
  const Pinhole cam{fx, fy, cx, cy, width, height};
  integrate_kernel<<<grid, kIntegrateThreads, 0, (cudaStream_t)stream>>>(
      slots, valid, k, block_coords, sdf, weight, color, depth, frame_color,
      T_wc, cam, block_size, voxel, trunc, ox, oy, oz, max_weight,
      color_gain);
  return (int)cudaGetLastError();
}
