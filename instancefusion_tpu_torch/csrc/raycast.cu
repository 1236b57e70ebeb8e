// Splat-raycast kernel for Hopper (sm_90a), K5.
//
// Replaces instancefusion_tpu/ops/pallas/raycast.py:splat_depth and
// splat_depth_groups (_splat_kernel).  Each near-surface voxel casts a vote
// for the surface depth d = z + sdf * trunc with weight
// relu(1 - |sdf|)^2 * min(w / 4, 1), composited by softmin exp(20 (2 - d)),
// spread over the image by a separable tent of radius
// r_t = clip(0.7 fx voxel / z_center, 1, rmax) px.  The TPU kernel
// rasterized the tent as two one-hot matmuls per block over an aligned
// image window, walking blocks in order and accumulating into VMEM images,
// so its sums ran in one order.  This kernel keeps a fixed order too: no
// float atomics anywhere, every pixel's sums run in one order on every
// run.  Two launches:
//
// - splat_votes_kernel: one CUDA block of 512 threads per listed slot.
//   Blocks straddling the camera plane are dropped whole, as the plain
//   version (splat_depth_ref) does.  The voting voxels (vote weight > 0)
//   are compacted by a warp ballot and a prefix over the warps, in voxel
//   order, into the slot's rows of a global vote buffer (u, v and the
//   channels).  The slot's meta row holds its vote count, its tap radius
//   R = min(ceil(r_t) + 1, rmax) (one guard pixel), 1 / r_t, and the box
//   of pixels its taps can reach: the rounded vote centers' box widened by
//   R and clipped to the image (a tap with weight > 0 lies less than
//   r_t + 0.5 from its rounded center).  Everything is written by plain
//   stores at positions fixed by the slot's index and the voxel order.
// - splat_tiles_kernel: one CUDA block per 16x16 screen tile, one thread
//   per pixel.  The block lists the slots whose box meets the tile, in
//   list order (a ballot and prefix over 256 slots at a time), then walks
//   them in that order; for each it stages the votes whose tap window
//   meets the tile, in voxel order, in shared memory, and every pixel adds
//   its taps of them in that order into registers.  A warp skips a vote
//   whose window misses both of its rows.  Each pixel's planes are then
//   written once, zeros included, so the output needs no clearing.
//
// Each pixel therefore sums its contributions in (list position, voxel)
// order; the plain version (an index_add_ per tent row) sums them row
// offset first, so the two agree within rounding, not bit for bit.
//
// The voxel's pixel position, its tent radius and its tent weights are
// computed as the plain version computes them, one rounding per operation
// in the same order (common.cuh, __fmul_rn and friends), so both put each
// vote on the same pixels with the same tent weights: at a silhouette a
// near surface's softmin weight (up to e^39) times a tent edge's weight
// would turn a 1-ulp difference into centimeters of depth.  That range is
// also why the sums stay in fp32 and not in fixed point.
//
// Bound: bytes, by the work's own count: each listed block's reads (2 KB
// sdf + 2 KB weight, +6 KB color) and the planes' writes (3 or 6 floats a
// pixel) take longer at the card's memory rate than the tent weights and
// the 3 (6 with color) multiply-adds per tap at its fp32 rate.  The
// kernel's time goes to the tiles' walk instead: each (tile, block) pair
// stages the block's votes behind two barriers, and the tiles that most
// blocks meet set the second launch's length.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kVoteThreads = 512;
constexpr int kVoteWarps = kVoteThreads / 32;
constexpr int kTile = 16;
constexpr int kTileThreads = kTile * kTile;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kRowsPerWarp = 32 / kTile;
constexpr int kMaxChannels = 6;

// max(1 - |a - p| inv_r, 0).
__device__ __forceinline__ float tent(float a, float p, float inv_r) {
  return fmaxf(__fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(a, p)), inv_r)), 0.0f);
}

// A slot's meta row: box (x0, y0, x1, y1; (INT_MAX, INT_MAX, -1, -1), which
// meets no tile, when no tap reaches the image) and (votes, R, bits of
// 1 / r_t, 0).
__device__ __forceinline__ void write_meta(int4* meta, int k, int4 box, int n_vote,
                                           int R, float inv_r) {
  meta[2 * k] = box;
  meta[2 * k + 1] = make_int4(n_vote, R, __float_as_int(inv_r), 0);
}

__global__ void __launch_bounds__(kVoteThreads) splat_votes_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ block_coords, const float* __restrict__ sdf,
    const float* __restrict__ weight, const float* __restrict__ color,
    const float* __restrict__ T_cw, int width, int height, int b, int rmax,
    float fx, float fy, float cx, float cy, float voxel, float trunc,
    float ox, float oy, float oz, float bsz, float tent_k,
    float* __restrict__ votes, int4* __restrict__ meta) {
  __shared__ int warp_votes[kVoteWarps];
  __shared__ int warp_box[4][kVoteWarps];
  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4 none = make_int4(INT_MAX, INT_MAX, -1, -1);
  if (!valid[k]) {
    if (tid == 0) write_meta(meta, k, none, 0, 0, 0.0f);
    return;
  }
  const long long slot = slots[k];
  const int bx = block_coords[3 * slot], by = block_coords[3 * slot + 1],
            bz = block_coords[3 * slot + 2];

  // Straddle test (the same for every thread).
  float zmin = INFINITY;
  for (int c = 0; c < 8; ++c) {
    const float qx = grid_to_world((float)bx, (float)(c >> 2), bsz, ox);
    const float qy = grid_to_world((float)by, (float)((c >> 1) & 1), bsz, oy);
    const float qz = grid_to_world((float)bz, (float)(c & 1), bsz, oz);
    zmin = fminf(zmin, cam_row(qx, qy, qz, T_cw + 8));
  }
  if (!(zmin > 1e-3f)) {
    if (tid == 0) write_meta(meta, k, none, 0, 0, 0.0f);
    return;
  }
  const float zcen = cam_row(grid_to_world((float)bx, 0.5f, bsz, ox),
                             grid_to_world((float)by, 0.5f, bsz, oy),
                             grid_to_world((float)bz, 0.5f, bsz, oz), T_cw + 8);
  const float r_t = fminf(
      fmaxf(__fmul_rn(__fdiv_rn(1.0f, fmaxf(zcen, 0.3f)), tent_k), 1.0f),
      (float)rmax);
  const float inv_r = __fdiv_rn(1.0f, r_t);
  const int R = min((int)ceilf(r_t) + 1, rmax);
  const int nch = color != nullptr ? 6 : 3;
  const int b3 = b * b * b;
  float* out = votes + (long long)k * (2 + nch) * b3;

  // Compact the voting voxels into the slot's rows, in voxel order, and
  // take the box of their rounded centers.
  int n_vote = 0;
  int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN;
  for (int base = 0; base < b3; base += kVoteThreads) {
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
        const int ui = (int)rintf(u), vi = (int)rintf(v);
        x0 = min(x0, ui);
        x1 = max(x1, ui);
        y0 = min(y0, vi);
        y1 = max(y1, vi);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, vote);
    if (lane == 0) warp_votes[warp] = __popc(ballot);
    __syncthreads();
    int pos = n_vote + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kVoteWarps; ++w) {
      if (w < warp) pos += warp_votes[w];
      n_vote += warp_votes[w];
    }
    if (vote) {
      out[pos] = u;
      out[b3 + pos] = v;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < nch) out[(2 + c) * b3 + pos] = ch[c];
    }
    __syncthreads();  // warp_votes is rewritten by the next round
  }

  // The box of the rounded centers over the block (min and max are exact,
  // so the order of this reduction does not matter).
  for (int off = 16; off > 0; off >>= 1) {
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, off));
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, off));
    x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, off));
  }
  if (lane == 0) {
    warp_box[0][warp] = x0;
    warp_box[1][warp] = y0;
    warp_box[2][warp] = x1;
    warp_box[3][warp] = y1;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kVoteWarps; ++w) {
    x0 = min(x0, warp_box[0][w]);
    y0 = min(y0, warp_box[1][w]);
    x1 = max(x1, warp_box[2][w]);
    y1 = max(y1, warp_box[3][w]);
  }
  int4 box = none;
  if (n_vote > 0) {
    box = make_int4(max(x0 - R, 0), max(y0 - R, 0), min(x1 + R, width - 1),
                    min(y1 + R, height - 1));
    if (box.x > box.z || box.y > box.w) box = none;
  }
  write_meta(meta, k, box, n_vote, R, inv_r);
}

// Block-wide compaction: each thread's position among the flagged threads
// before it (in thread order) and the number flagged.  Starts with a
// barrier, so the caller may reuse what the previous compaction indexed.
__device__ __forceinline__ int tile_compact(bool flag, int* warp_count, int* pos) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_count[warp] = __popc(m);
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    off += w < warp ? warp_count[w] : 0;
    n += warp_count[w];
  }
  *pos = off + __popc(m & ((1u << lane) - 1u));
  return n;
}

__global__ void __launch_bounds__(kTileThreads) splat_tiles_kernel(
    const int4* __restrict__ meta, const float* __restrict__ votes, int k, int b3,
    int nch, int width, int height, float* __restrict__ acc) {
  __shared__ int warp_count[kTileWarps];
  __shared__ int list[kTileThreads];
  __shared__ float s_u[kTileThreads], s_v[kTileThreads];
  __shared__ float s_ch[kMaxChannels][kTileThreads];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int tx1 = tx0 + kTile - 1, ty1 = ty0 + kTile - 1;
  const int px = tx0 + tid % kTile, py = ty0 + tid / kTile;
  const int wy0 = ty0 + warp * kRowsPerWarp, wy1 = wy0 + kRowsPerWarp - 1;
  const float fpx = (float)px, fpy = (float)py;
  const bool in_img = px < width && py < height;
  float sum[kMaxChannels] = {};

  for (int base = 0; base < k; base += kTileThreads) {
    // The slots whose box meets this tile, in list order.
    const int s = base + tid;
    bool hit = false;
    if (s < k) {
      const int4 box = meta[2 * s];
      hit = box.x <= tx1 && box.z >= tx0 && box.y <= ty1 && box.w >= ty0;
    }
    int pos;
    const int n_hit = tile_compact(hit, warp_count, &pos);
    if (hit) list[pos] = s;
    __syncthreads();

    for (int i = 0; i < n_hit; ++i) {
      const int slot = list[i];
      const int4 info = meta[2 * slot + 1];
      const int n_vote = info.x, R = info.y;
      const float inv_r = __int_as_float(info.z);
      const float* in = votes + (long long)slot * (2 + nch) * b3;
      for (int v0 = 0; v0 < n_vote; v0 += kTileThreads) {
        // Stage the votes whose tap window meets the tile, in voxel order.
        const int j = v0 + tid;
        bool near = false;
        float u = 0.0f, v = 0.0f;
        if (j < n_vote) {
          u = in[j];
          v = in[b3 + j];
          const int ui = (int)rintf(u), vi = (int)rintf(v);
          near = ui + R >= tx0 && ui - R <= tx1 && vi + R >= ty0 && vi - R <= ty1;
        }
        const int m = tile_compact(near, warp_count, &pos);
        if (near) {
          s_u[pos] = u;
          s_v[pos] = v;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < nch) s_ch[c][pos] = in[(2 + c) * b3 + j];
        }
        __syncthreads();
        for (int q = 0; q < m; ++q) {
          const float vq = s_v[q];
          const int vi = (int)rintf(vq);
          if (vi + R < wy0 || vi - R > wy1) continue;  // the same for the warp
          const float uq = s_u[q];
          const int ui = (int)rintf(uq);
          if (!in_img || abs(px - ui) > R || abs(py - vi) > R) continue;
          const float tw = __fmul_rn(tent(vq, fpy, inv_r), tent(uq, fpx, inv_r));
          if (!(tw > 0.0f)) continue;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < nch) sum[c] = __fadd_rn(sum[c], __fmul_rn(s_ch[c][q], tw));
        }
      }
    }
  }
  if (!in_img) return;
  const long long plane = (long long)width * height;
  const long long p = (long long)py * width + px;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < nch) acc[c * plane + p] = sum[c];
}

}  // namespace

// votes: f32[k, (2 + nch) * b^3] scratch; meta: i32[k, 8] scratch; acc:
// f32[nch, height, width], every element written.
extern "C" int ifl_splat(const int32_t* slots, const uint8_t* valid, int k,
                         const int32_t* block_coords, const float* sdf,
                         const float* weight, const float* color,
                         const float* T_cw, int width, int height,
                         int block_size, int rmax, float fx, float fy,
                         float cx, float cy, float voxel, float trunc,
                         float ox, float oy, float oz, float bsz,
                         float tent_k, float* votes, int32_t* meta, float* acc,
                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int b3 = block_size * block_size * block_size;
  const int nch = color != nullptr ? 6 : 3;
  int4* meta4 = reinterpret_cast<int4*>(meta);
  if (k > 0) {
    splat_votes_kernel<<<k, kVoteThreads, 0, s>>>(
        slots, valid, block_coords, sdf, weight, color, T_cw, width, height,
        block_size, rmax, fx, fy, cx, cy, voxel, trunc, ox, oy, oz, bsz, tent_k,
        votes, meta4);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const dim3 tiles((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  splat_tiles_kernel<<<tiles, kTileThreads, 0, s>>>(meta4, votes, k, b3, nch, width,
                                                    height, acc);
  return (int)cudaGetLastError();
}
