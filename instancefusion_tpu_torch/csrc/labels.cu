// Instance-label vote kernel for Hopper (sm_90a), K7.
//
// Replaces instancefusion_tpu/ops/pallas/tsdf.py:fused_label_vote
// (_vote_kernel) together with the projective association around it in
// ops/labels.py:fuse.  On the TPU, XLA gathered the listed vote rows and
// the observed instance ids, Pallas ran the Boyer-Moore update on whole
// (K, 512) tiles, and XLA scattered the rows back.  Here the kernel does
// all of it in place: each voxel of a valid listed slot takes its center
// (x-major within the block), moves it into the camera frame, projects it
// with the zsafe guard of geometry/camera.project, rounds half to even
// (rintf, like jnp.round / torch.round), reads the depth and instance-id
// pixels, and where the voxel lies in the band (|d - z| < trunc,
// two-sided) of a pixel that carries an id it votes:
//
//   count <= 0 -> adopt the id, count = 1
//   same id    -> count += 1
//   other id   -> count -= 1
//
// The design is K4's (tsdf.cu): a persistent grid walking the list
// (common.cuh walk_valid_rows; the list is 8192 long at 512^3, a few
// hundred of its entries valid, and an invalid one costs five bytes read),
// T_cw formed in the block from T_wc, 128 threads a block with 4 voxels of
// one z-run each, and one rounding per operation in the plain version's
// order, so the kernel equals ops/kernels/labels.label_vote_ref bit for
// bit.  A thread reads and writes its voxels' label and count as one int4
// and one float4, only where one of them votes.  Valid listed slots are
// unique (prefix-sum compaction of the touched-block directory), so no
// two threads write one voxel.
//
// Bound: bytes.  Label and count are read and written at the voting
// voxels' quads; the two image reads per voxel hit L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kVoteThreads = 128;

__global__ void __launch_bounds__(kVoteThreads) label_vote_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid, int k,
    const int32_t* __restrict__ block_coords, int32_t* __restrict__ label,
    float* __restrict__ count, const float* __restrict__ depth,
    const int32_t* __restrict__ gid_image, const float* __restrict__ T_wc,
    Pinhole cam, int b, float voxel, float trunc, float ox, float oy,
    float oz) {
  // T_cw; the walk's first barrier publishes it before any row is read.
  __shared__ float T[12];
  if (threadIdx.x < 12) T[threadIdx.x] = se3_inverse_entry(T_wc, threadIdx.x);
  const int b3 = b * b * b, bb = b * b;
  walk_valid_rows<kVoteThreads>(
      slots, valid, k, block_coords, [&](int slot, int bx, int by, int bz) {
        for (int q = threadIdx.x; q < b3 / 4; q += kVoteThreads) {
          const int v0 = 4 * q;
          const int lx = v0 / bb, ly = (v0 / b) % b, lz = v0 % b;
          const float px = grid_to_world((float)(bx * b + lx), 0.5f, voxel, ox);
          const float py = grid_to_world((float)(by * b + ly), 0.5f, voxel, oy);
          const float xy0 = cam_row_xy(px, py, T), xy1 = cam_row_xy(px, py, T + 4),
                      xy2 = cam_row_xy(px, py, T + 8);
          int g[4];
          bool any = false;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pz =
                grid_to_world((float)(bz * b + lz + j), 0.5f, voxel, oz);
            const float z = cam_row_z(xy2, pz, T + 8);
            const PixelHit h = nearest_pixel(cam_row_z(xy0, pz, T),
                                             cam_row_z(xy1, pz, T + 4), z, cam);
            const float d = depth[h.pix];
            const bool band = h.seen && d > 0.0f && fabsf(__fsub_rn(d, z)) < trunc;
            g[j] = band ? gid_image[h.pix] : -1;
            any = any || g[j] >= 0;
          }
          if (!any) continue;
          const long long row = (long long)slot * b3 + v0;
          const int4 lab4 = *reinterpret_cast<const int4*>(label + row);
          const float4 cnt4 = *reinterpret_cast<const float4*>(count + row);
          int l[4] = {lab4.x, lab4.y, lab4.z, lab4.w};
          float c[4] = {cnt4.x, cnt4.y, cnt4.z, cnt4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (g[j] < 0) continue;
            if (c[j] <= 0.0f) {
              l[j] = g[j];
              c[j] = 1.0f;
            } else if (l[j] == g[j]) {
              c[j] = __fadd_rn(c[j], 1.0f);
            } else {
              c[j] = __fsub_rn(c[j], 1.0f);
            }
          }
          *reinterpret_cast<int4*>(label + row) = make_int4(l[0], l[1], l[2], l[3]);
          *reinterpret_cast<float4*>(count + row) = make_float4(c[0], c[1], c[2], c[3]);
        }
      });
}

}  // namespace

// K7's grid on the current device (the blocks it holds at once).
extern "C" int ifl_label_vote_grid(int* nblocks) {
  return resident_grid(label_vote_kernel, kVoteThreads, nblocks);
}

// grid blocks walk the k list entries; block_size must be a multiple of 4
// and the vote rows 16-byte aligned.
extern "C" int ifl_label_vote(const int32_t* slots, const uint8_t* valid,
                              int k, int grid, const int32_t* block_coords,
                              int32_t* label, float* count, const float* depth,
                              const int32_t* gid_image, const float* T_wc,
                              int width, int height, int block_size, float fx,
                              float fy, float cx, float cy, float voxel,
                              float trunc, float ox, float oy, float oz,
                              void* stream) {
  if (k == 0) return 0;
  const Pinhole cam{fx, fy, cx, cy, width, height};
  label_vote_kernel<<<grid, kVoteThreads, 0, (cudaStream_t)stream>>>(
      slots, valid, k, block_coords, label, count, depth, gid_image, T_wc, cam,
      block_size, voxel, trunc, ox, oy, oz);
  return (int)cudaGetLastError();
}
