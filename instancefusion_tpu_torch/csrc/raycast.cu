// Splat-raycast kernel for Hopper (sm_90a), K5.
//
// Replaces instancefusion_tpu/ops/pallas/raycast.py:splat_depth and
// splat_depth_groups (_splat_kernel).  Each near-surface voxel casts a vote
// for the surface depth d = z + sdf * trunc with weight
// relu(1 - |sdf|)^2 * min(w / 4, 1), composited by softmin exp(20 (2 - d)),
// spread over the image by a separable tent of radius
// r_t = clip(0.7 fx voxel / z_center, 1, rmax) px.  The TPU kernel
// rasterized the tent as two one-hot matmuls per block over an aligned
// image window, walking blocks in order so it could accumulate into VMEM
// images.  GPU blocks run in no order, so the sums meet in device memory
// through atomics; the design keeps most of them on chip:
//
// - One CUDA block of 512 threads per listed slot.  Blocks straddling the
//   camera plane are dropped whole, as the plain version (splat_depth_ref)
//   does.
// - Footprint box: the screen box of the block's 8 projected corners,
//   widened by ceil(r_t) + 1 px and clipped to the image.  A voxel center
//   lies inside its block, and every corner is in front of the camera, so
//   the voxel projects inside the corners' box and its taps, less than r_t
//   from it, inside the widened one.
// - Tile route: when box_w * box_h * nch * 4 B fits the tile budget that
//   the wrapper passes (SPLAT_TILE_BYTES in ops/kernels/raycast.py, 96 KB:
//   with the 16 KB voting list two blocks fit an SM's 228 KB), the taps
//   are summed into a shared-memory tile with shared-memory atomics, and
//   the tile is flushed with one global atomicAdd per non-zero pixel and
//   channel.  Blocks whose box is larger (near the camera, or with color
//   at short range) add their taps straight to the global planes: the
//   global route, a branch of the same kernel.  A tap outside the box,
//   which the construction excludes, would take the global route too.
// - Voting voxels (vote weight > 0) are compacted by a warp ballot and a
//   prefix over the warps into a shared list (u, v, channels).  Each warp
//   then takes one voting voxel at a time and spreads its taps over the
//   32 lanes, row by row, so neighbouring lanes hit neighbouring pixels.
//   The tap window is bounded by the block's radius, min(ceil(r_t) + 1,
//   rmax) (one guard pixel), not by rmax: a tap with weight > 0 lies less
//   than r_t + 0.5 from the rounded center, so the set of taps is the
//   plain version's.
//
// The voxel's pixel position, its tent radius and its tent weights are
// computed as the plain version computes them, one rounding per operation
// in the same order (common.cuh, __fmul_rn and friends), so both put each
// vote on the same pixels with the same tent weights: at a silhouette a
// near surface's softmin weight (up to e^39) times a tent edge's weight
// would turn a 1-ulp difference into centimeters of depth.  Only the order
// of the sums differs from the plain version.
//
// Bound: atomics.  The reads (2 KB sdf + 2 KB weight, +6 KB color, per
// block) are small next to the 3 (6 with color) float adds per covered
// pixel per voxel; the tile route moves them from L2 to shared memory.
// Float atomics sum in no fixed order, so the result matches the plain
// version within tolerances, not bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 6;

// max(1 - |a - p| inv_r, 0).
__device__ __forceinline__ float tent(float a, float p, float inv_r) {
  return fmaxf(__fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(a, p)), inv_r)), 0.0f);
}

// Dynamic shared memory: the voting list, u[b3], v[b3] and the channels
// ch[nch][b3], then the tile, nch planes of box_w * box_h floats.
__global__ void __launch_bounds__(kThreads, 2) splat_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ block_coords, const float* __restrict__ sdf,
    const float* __restrict__ weight, const float* __restrict__ color,
    const float* __restrict__ T_cw, int width, int height, int b, int rmax,
    float fx, float fy, float cx, float cy, float voxel, float trunc,
    float ox, float oy, float oz, float bsz, float tent_k, int tile_floats,
    float* __restrict__ acc) {
  extern __shared__ float smem[];
  __shared__ int warp_votes[kWarps];
  const int k = blockIdx.x;
  if (!valid[k]) return;
  const long long slot = slots[k];
  const int bx = block_coords[3 * slot], by = block_coords[3 * slot + 1],
            bz = block_coords[3 * slot + 2];

  // Straddle test and the corners' screen box (the same for every thread).
  float zmin = INFINITY, umin = INFINITY, umax = -INFINITY, vmin = INFINITY,
        vmax = -INFINITY;
  for (int c = 0; c < 8; ++c) {
    const float qx = grid_to_world((float)bx, (float)(c >> 2), bsz, ox);
    const float qy = grid_to_world((float)by, (float)((c >> 1) & 1), bsz, oy);
    const float qz = grid_to_world((float)bz, (float)(c & 1), bsz, oz);
    const float zc = cam_row(qx, qy, qz, T_cw + 8);
    zmin = fminf(zmin, zc);
    const float uc = project_coord(fx, cam_row(qx, qy, qz, T_cw), zc, cx);
    const float vc = project_coord(fy, cam_row(qx, qy, qz, T_cw + 4), zc, cy);
    umin = fminf(umin, uc);
    umax = fmaxf(umax, uc);
    vmin = fminf(vmin, vc);
    vmax = fmaxf(vmax, vc);
  }
  if (!(zmin > 1e-3f)) return;
  const float zcen = cam_row(grid_to_world((float)bx, 0.5f, bsz, ox),
                             grid_to_world((float)by, 0.5f, bsz, oy),
                             grid_to_world((float)bz, 0.5f, bsz, oz), T_cw + 8);
  const float r_t = fminf(
      fmaxf(__fmul_rn(__fdiv_rn(1.0f, fmaxf(zcen, 0.3f)), tent_k), 1.0f),
      (float)rmax);
  const float inv_r = __fdiv_rn(1.0f, r_t);
  const float pad = ceilf(r_t) + 1.0f;
  const float fx0 = fmaxf(floorf(umin) - pad, 0.0f);
  const float fx1 = fminf(ceilf(umax) + pad, (float)(width - 1));
  const float fy0 = fmaxf(floorf(vmin) - pad, 0.0f);
  const float fy1 = fminf(ceilf(vmax) + pad, (float)(height - 1));
  const int nch = color != nullptr ? 6 : 3;
  const bool boxed = fx0 <= fx1 && fy0 <= fy1;
  const int x0 = boxed ? (int)fx0 : 0, y0 = boxed ? (int)fy0 : 0;
  const int bw = boxed ? (int)fx1 - x0 + 1 : 0, bh = boxed ? (int)fy1 - y0 + 1 : 0;
  const int area = bw * bh;
  const bool use_tile = boxed && area * nch <= tile_floats;

  const int b3 = b * b * b;
  float* list_u = smem;
  float* list_v = smem + b3;
  float* list_ch = smem + 2 * b3;
  float* tile = smem + (2 + nch) * b3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (use_tile)
    for (int i = tid; i < nch * area; i += kThreads) tile[i] = 0.0f;

  // Compact the voting voxels into the shared list, in voxel order.
  int n_vote = 0;
  for (int base = 0; base < b3; base += kThreads) {
    const int idx = base + tid;
    bool vote = false;
    float u = 0.0f, v = 0.0f, ch[kMaxChannels] = {};
    if (idx < b3) {
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
      vote = w > 0.0f;
      if (vote) {
        u = project_coord(fx, cam_row(px, py, pz, T_cw), z, cx);
        v = project_coord(fy, cam_row(px, py, pz, T_cw + 4), z, cy);
        const float d_abs =
            fminf(fmaxf(__fadd_rn(z, __fmul_rn(s, trunc)), 0.05f), 8.0f);
        const float wsm =
            __fmul_rn(w, expf(__fmul_rn(20.0f, __fsub_rn(2.0f, d_abs))));
        ch[0] = __fmul_rn(wsm, d_abs);
        ch[1] = wsm;
        ch[2] = w;
        if (color != nullptr) {
          for (int c = 0; c < 3; ++c)
            ch[3 + c] = __fmul_rn(wsm, color[slot * 3 * b3 + c * b3 + idx]);
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, vote);
    if (lane == 0) warp_votes[warp] = __popc(ballot);
    __syncthreads();
    int pos = n_vote + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += warp_votes[w];
      n_vote += warp_votes[w];
    }
    if (vote) {
      list_u[pos] = u;
      list_v[pos] = v;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < nch) list_ch[c * b3 + pos] = ch[c];
    }
    __syncthreads();
  }

  // Each warp takes one voting voxel at a time; its lanes walk the tap
  // window row-major, so neighbouring lanes add to neighbouring pixels.
  const int R = min((int)ceilf(r_t) + 1, rmax);
  const int span = 2 * R + 1, n_taps = span * span;
  const long long plane = (long long)width * height;
  for (int j = warp; j < n_vote; j += kWarps) {
    const float u = list_u[j], v = list_v[j];
    float ch[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) ch[c] = c < nch ? list_ch[c * b3 + j] : 0.0f;
    const int ui = (int)rintf(u), vi = (int)rintf(v);
    for (int t = lane; t < n_taps; t += 32) {
      const int ry = t / span;
      const int py_ = vi + ry - R, px_ = ui + (t - ry * span) - R;
      if (py_ < 0 || py_ >= height || px_ < 0 || px_ >= width) continue;
      const float tw = __fmul_rn(tent(v, (float)py_, inv_r), tent(u, (float)px_, inv_r));
      if (!(tw > 0.0f)) continue;
      if (use_tile && px_ >= x0 && px_ < x0 + bw && py_ >= y0 && py_ < y0 + bh) {
        float* dst = tile + (py_ - y0) * bw + (px_ - x0);
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < nch) atomicAdd(dst + c * area, __fmul_rn(ch[c], tw));
      } else {
        float* dst = acc + (long long)py_ * width + px_;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < nch) atomicAdd(dst + c * plane, __fmul_rn(ch[c], tw));
      }
    }
  }
  if (!use_tile) return;

  // Flush the tile: one global add per non-zero pixel and channel.
  __syncthreads();
  for (int i = tid; i < nch * area; i += kThreads) {
    const float val = tile[i];
    if (val != 0.0f) {
      const int c = i / area, p = i - c * area;
      const int ry = p / bw;
      atomicAdd(acc + c * plane + (long long)(y0 + ry) * width + (x0 + p - ry * bw), val);
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
                         float tent_k, int tile_bytes, float* acc,
                         void* stream) {
  if (k == 0) return 0;
  const int b3 = block_size * block_size * block_size;
  const int nch = color != nullptr ? 6 : 3;
  const int smem = (2 + nch) * b3 * (int)sizeof(float) + tile_bytes;
  static int configured = 0;  // the dynamic shared memory allowed so far
  if (smem > configured) {
    int err = (int)cudaFuncSetAttribute(
        splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(splat_kernel,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      (int)cudaSharedmemCarveoutMaxShared);
    if (err != 0) return err;
    configured = smem;
  }
  splat_kernel<<<k, kThreads, smem, (cudaStream_t)stream>>>(
      slots, valid, block_coords, sdf, weight, color, T_cw, width, height,
      block_size, rmax, fx, fy, cx, cy, voxel, trunc, ox, oy, oz, bsz, tent_k,
      tile_bytes / (int)sizeof(float), acc);
  return (int)cudaGetLastError();
}
