// Device helpers shared by the kernels of icp.cu (K2), raycast.cu (K5),
// tsdf.cu (K4, K8) and labels.cu (K7).
//
// A kernel that places a point on a pixel must round as its plain PyTorch
// version does, or a 1-ulp difference picks the neighbouring pixel at a .5
// boundary (K2, K4, K7) or turns a tent edge's weight on or off (K5).
// These helpers round after every operation (__fmul_rn and friends are
// never contracted into fused multiply-adds), in the order of the plain
// versions' ``geometry/se3.cam_row``, ``geometry/se3.se3_inverse_rows``,
// ``geometry/camera.project`` and ``ops/kernels/tsdf.voxel_centers``.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ((x r0 + y r1) + z r2) + r3: coordinate of a rigid transform whose row
// (r0, r1, r2, r3) is given, rounded after each operation.
__device__ __forceinline__ float cam_row(float x, float y, float z,
                                         const float* r) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, r[0]), __fmul_rn(y, r[1])),
                             __fmul_rn(z, r[2])),
                   r[3]);
}

// cam_row in two halves, for points that share x and y (a z-run of
// voxels): cam_row(x, y, z, r) == cam_row_z(cam_row_xy(x, y, r), z, r).
__device__ __forceinline__ float cam_row_xy(float x, float y, const float* r) {
  return __fadd_rn(__fmul_rn(x, r[0]), __fmul_rn(y, r[1]));
}

__device__ __forceinline__ float cam_row_z(float xy, float z, const float* r) {
  return __fadd_rn(__fadd_rn(xy, __fmul_rn(z, r[2])), r[3]);
}

// (f x) / z + c: the pinhole projection of one coordinate, rounded after
// each operation.
__device__ __forceinline__ float project_coord(float f, float x, float z,
                                               float c) {
  return __fadd_rn(__fdiv_rn(__fmul_rn(f, x), z), c);
}

// origin + (q + off) * step, rounded after each operation: a voxel center
// (off 0.5, step the voxel) or a block corner (step the block's edge).
__device__ __forceinline__ float grid_to_world(float q, float off, float step,
                                               float origin) {
  return __fadd_rn(__fmul_rn(__fadd_rn(q, off), step), origin);
}

// Entry e = 4 i + j (i < 3) of the inverse of the rigid transform T
// (row-major 4x4): R^T for j < 3, and for j = 3 coordinate i of
// -R^T t, summed -(((R[0,i] t0) + R[1,i] t1) + R[2,i] t2) with one
// rounding per operation (se3.se3_inverse_rows).
__device__ __forceinline__ float se3_inverse_entry(const float* T, int e) {
  const int i = e >> 2, j = e & 3;
  if (j < 3) return T[4 * j + i];
  return -__fadd_rn(__fadd_rn(__fmul_rn(T[i], T[3]), __fmul_rn(T[4 + i], T[7])),
                    __fmul_rn(T[8 + i], T[11]));
}

struct Pinhole {
  float fx, fy, cx, cy;
  int width, height;
};

// Where a camera-frame point lands (geometry/camera.project and
// nearest_pixel): the flat index of its nearest pixel, rounded half to
// even and clamped into the image, and whether that pixel lies in the
// image with z > 0.
struct PixelHit {
  int pix;
  bool seen;
};

__device__ __forceinline__ PixelHit nearest_pixel(float xc, float yc, float z,
                                                  const Pinhole& c) {
  const float zs = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float uf = rintf(project_coord(c.fx, xc, zs, c.cx));
  const float vf = rintf(project_coord(c.fy, yc, zs, c.cy));
  const bool in_img = uf >= 0.0f && uf < (float)c.width && vf >= 0.0f &&
                      vf < (float)c.height;
  // fmaxf(NaN, 0) is 0, as torch.nan_to_num then clamp.
  const int ui = (int)fminf(fmaxf(uf, 0.0f), (float)(c.width - 1));
  const int vi = (int)fminf(fmaxf(vf, 0.0f), (float)(c.height - 1));
  return {vi * c.width + ui, in_img && z > 0.0f};
}

// Four floats at p (16-byte aligned) into v as one access, and back
// where any of them changed bit for bit: an unchanged quad is not written.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store4_if_changed(float* p, const float (&old)[4],
                                                  const float (&v)[4]) {
  bool same = true;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    same = same && __float_as_uint(old[j]) == __float_as_uint(v[j]);
  if (!same) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The persistent walk over a slot list (K4, K7, K8).  Block g of a grid of
// G takes the entries g, g + G, g + 2G, ...  kThreads entries at a time it
// reads their valid flags and slots (one entry a thread; the slot loads
// beside the flag, so a cold list costs one round trip to memory, not
// two), compacts the valid ones by a warp ballot and a prefix over the
// warps into shared memory, each as the Entry that fetch(e, slot) makes of
// list position e, and then calls row(entry) once for each, in list
// order, with every thread of the block.  An invalid entry costs five
// bytes read (its flag and slot); round robin spreads a valid prefix, and a
// list with holes, evenly over the grid.
template <int kThreads, class Entry, class Fetch, class Row>
__device__ __forceinline__ void walk_valid(const int32_t* __restrict__ slots,
                                           const uint8_t* __restrict__ valid,
                                           int k, Fetch&& fetch, Row&& row) {
  static_assert(kThreads % 32 == 0, "whole warps");
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_count[kWarps];
  __shared__ Entry rows[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long base = blockIdx.x; base < k; base += step) {
    const long long e = base + (long long)gridDim.x * tid;
    bool v = false;
    int slot = 0;
    if (e < k) {
      v = valid[e];
      slot = slots[e];
    }
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_count[w] : 0;
      n += warp_count[w];
    }
    if (v) rows[off + __popc(m & ((1u << lane) - 1u))] = fetch((int)e, slot);
    __syncthreads();
    for (int r = 0; r < n; ++r) row(rows[r]);
    __syncthreads();  // rows and warp_count are rewritten by the next pass
  }
}

// The walk with each valid entry's slot and block coordinates (K4, K7):
// row(slot, bx, by, bz).
template <int kThreads, class Row>
__device__ __forceinline__ void walk_valid_rows(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid, int k,
    const int32_t* __restrict__ block_coords, Row&& row) {
  walk_valid<kThreads, int4>(
      slots, valid, k,
      [&](int, int slot) {
        const long long c = 3 * (long long)slot;
        return make_int4(slot, block_coords[c], block_coords[c + 1], block_coords[c + 2]);
      },
      [&](const int4& q) { row(q.x, q.y, q.z, q.w); });
}

// The walk with each valid entry's list position and slot (K8, whose
// observation rows are laid out by list position): row(e, slot).
template <int kThreads, class Row>
__device__ __forceinline__ void walk_valid_slots(const int32_t* __restrict__ slots,
                                                 const uint8_t* __restrict__ valid,
                                                 int k, Row&& row) {
  walk_valid<kThreads, int2>(
      slots, valid, k, [](int e, int slot) { return make_int2(e, slot); },
      [&](const int2& q) { row(q.x, q.y); });
}

// The blocks of `kernel` (kThreads threads, no dynamic shared memory) that
// the current device holds at once: its SM count times the blocks an SM
// holds.  A persistent kernel's grid; the wrappers ask once a device.
template <class Kernel>
inline int resident_grid(Kernel kernel, int threads, int* nblocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *nblocks = sms * per_sm;
  return 0;
}
