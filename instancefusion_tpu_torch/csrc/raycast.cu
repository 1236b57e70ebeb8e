// Splat-raycast kernel for Hopper (sm_90a), K5.
//
// Replaces instancefusion_tpu/ops/pallas/raycast.py:splat_depth and
// splat_depth_groups (_splat_kernel).  Each near-surface voxel casts a vote
// for the surface depth d = z + sdf * trunc with weight
// relu(1 - |sdf|)^2 * min(w / 4, 1), composited by softmin exp(20 (2 - d)),
// spread over the image by a separable tent of radius
// clip(0.7 fx voxel / z_center, 1, rmax) px.  The TPU kernel rasterized
// the tent as two one-hot matmuls per block over an aligned image window,
// walking blocks in order so it could accumulate into VMEM images.  GPU
// blocks run in no order: here one block of B^3 threads handles one listed
// slot, each thread loops over its voxel's tent footprint (at most
// (2 rmax + 1)^2 pixels) and adds its channels to the accumulator planes
// with atomicAdd.  Blocks straddling the camera plane are dropped whole, as
// the plain version (splat_depth_ref) does; voxels whose vote weight is 0
// (unobserved, out of band, behind the camera) return at once.
//
// The voxel's pixel position, its tent radius and its tent weights are
// computed as the plain version computes them, one rounding per operation
// in the same order (__fmul_rn and friends forbid fused multiply-adds), so
// both put each vote on the same pixels with the same tent weights: at a
// silhouette a near surface's softmin weight (up to e^39) times a tent
// edge's weight would turn a 1-ulp difference into centimeters of depth.
// Only the order of the atomic sums differs from the plain version.
//
// Bound: atomics.  The reads (2 KB sdf + 2 KB weight, +6 KB color, per
// block) are small next to ~3-6 float atomics per covered pixel per voxel
// into L2-resident accumulators.  Float atomics sum in no fixed order, so
// the result matches the plain version within tolerances, not bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ((x r0 + y r1) + z r2) + t, rounded after each operation.
__device__ __forceinline__ float cam_row(float x, float y, float z,
                                         const float* r) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, r[0]), __fmul_rn(y, r[1])),
                             __fmul_rn(z, r[2])),
                   r[3]);
}

// origin + (q + off) * step, rounded after each operation.
__device__ __forceinline__ float grid_to_world(float q, float off, float step,
                                               float origin) {
  return __fadd_rn(__fmul_rn(__fadd_rn(q, off), step), origin);
}

// max(1 - |a - p| inv_r, 0).
__device__ __forceinline__ float tent(float a, float p, float inv_r) {
  return fmaxf(__fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(a, p)), inv_r)), 0.0f);
}

__global__ void splat_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ block_coords, const float* __restrict__ sdf,
    const float* __restrict__ weight, const float* __restrict__ color,
    const float* __restrict__ T_cw, int width, int height, int b, int rmax,
    float fx, float fy, float cx, float cy, float voxel, float trunc,
    float ox, float oy, float oz, float bsz, float tent_k,
    float* __restrict__ acc) {
  const int k = blockIdx.x;
  if (!valid[k]) return;
  const long long slot = slots[k];
  const int bx = block_coords[3 * slot], by = block_coords[3 * slot + 1],
            bz = block_coords[3 * slot + 2];

  // Straddle test over the block's 8 corners (same for every thread).
  float zmin = INFINITY;
  for (int c = 0; c < 8; ++c) {
    const float qx = grid_to_world((float)bx, (float)(c >> 2), bsz, ox);
    const float qy = grid_to_world((float)by, (float)((c >> 1) & 1), bsz, oy);
    const float qz = grid_to_world((float)bz, (float)(c & 1), bsz, oz);
    zmin = fminf(zmin, cam_row(qx, qy, qz, T_cw + 8));
  }
  if (!(zmin > 1e-3f)) return;
  const float zcen = cam_row(grid_to_world((float)bx, 0.5f, bsz, ox),
                             grid_to_world((float)by, 0.5f, bsz, oy),
                             grid_to_world((float)bz, 0.5f, bsz, oz), T_cw + 8);
  const float r_t = fminf(
      fmaxf(__fmul_rn(__fdiv_rn(1.0f, fmaxf(zcen, 0.3f)), tent_k), 1.0f),
      (float)rmax);
  const float inv_r = __fdiv_rn(1.0f, r_t);

  const int b3 = b * b * b;
  const int idx = threadIdx.x;
  const long long row = slot * b3 + idx;
  const float s = sdf[row];
  float w = fmaxf(__fsub_rn(1.0f, fabsf(s)), 0.0f);
  const float conf = fminf(__fmul_rn(weight[row], 0.25f), 1.0f);
  const int lx = idx / (b * b), ly = (idx / b) % b, lz = idx % b;
  const float px = grid_to_world((float)(bx * b + lx), 0.5f, voxel, ox);
  const float py = grid_to_world((float)(by * b + ly), 0.5f, voxel, oy);
  const float pz = grid_to_world((float)(bz * b + lz), 0.5f, voxel, oz);
  const float z = cam_row(px, py, pz, T_cw + 8);
  w = __fmul_rn(__fmul_rn(__fmul_rn(w, w), conf), z > 0.05f ? 1.0f : 0.0f);
  if (!(w > 0.0f)) return;
  const float xc = cam_row(px, py, pz, T_cw);
  const float yc = cam_row(px, py, pz, T_cw + 4);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(fx, xc), z), cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(fy, yc), z), cy);
  const float d_abs = fminf(fmaxf(__fadd_rn(z, __fmul_rn(s, trunc)), 0.05f), 8.0f);
  const float wsm = __fmul_rn(w, expf(__fmul_rn(20.0f, __fsub_rn(2.0f, d_abs))));
  const int nch = color != nullptr ? 6 : 3;
  float ch[6] = {__fmul_rn(wsm, d_abs), wsm, w, 0.0f, 0.0f, 0.0f};
  if (color != nullptr) {
    for (int c = 0; c < 3; ++c)
      ch[3 + c] = __fmul_rn(wsm, color[slot * 3 * b3 + c * b3 + idx]);
  }
  const int ui = (int)rintf(u), vi = (int)rintf(v);
  const long long plane = (long long)width * height;
  for (int dy = -rmax; dy <= rmax; ++dy) {
    const int py_ = vi + dy;
    if (py_ < 0 || py_ >= height) continue;
    const float tv = tent(v, (float)py_, inv_r);
    if (!(tv > 0.0f)) continue;
    for (int dx = -rmax; dx <= rmax; ++dx) {
      const int px_ = ui + dx;
      if (px_ < 0 || px_ >= width) continue;
      const float t = __fmul_rn(tv, tent(u, (float)px_, inv_r));
      if (!(t > 0.0f)) continue;
      float* dst = acc + (long long)py_ * width + px_;
      for (int c = 0; c < nch; ++c) atomicAdd(dst + c * plane, __fmul_rn(ch[c], t));
    }
  }
}

}  // namespace

extern "C" int ifl_splat(const int32_t* slots, const uint8_t* valid, int k,
                         const int32_t* block_coords, const float* sdf,
                         const float* weight, const float* color,
                         const float* T_cw, int width, int height,
                         int block_size, int rmax, float fx, float fy,
                         float cx, float cy, float voxel, float trunc,
                         float ox, float oy, float oz, float bsz,
                         float tent_k, float* acc, void* stream) {
  if (k == 0) return 0;
  const int b3 = block_size * block_size * block_size;
  splat_kernel<<<k, b3, 0, (cudaStream_t)stream>>>(
      slots, valid, block_coords, sdf, weight, color, T_cw, width, height,
      block_size, rmax, fx, fy, cx, cy, voxel, trunc, ox, oy, oz, bsz, tent_k,
      acc);
  return (int)cudaGetLastError();
}
