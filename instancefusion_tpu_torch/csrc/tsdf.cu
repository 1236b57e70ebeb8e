// TSDF kernels for Hopper (sm_90a): integrate (K4) and the running-average
// update of listed rows (K8).
//
// K4 (integrate_kernel) replaces
// instancefusion_tpu/ops/pallas/tsdf.py:fused_integrate and
// fused_integrate_groups (_integrate_kernel).  The TPU kernel sampled the
// depth and color images for each voxel through one-hot matmuls over a
// tile-aligned image window, addressed the payload by groups of 8 rows and
// skipped blocks straddling the camera plane because their window was
// meaningless.  Here one block of B^3 threads handles one listed slot: each
// thread projects its voxel, reads the depth (and color) pixel directly and
// updates sdf, weight and packed color in place.  Listed slots are unique
// where valid (prefix-sum compaction), so no two blocks write one row;
// invalid list entries are skipped.  Straddling blocks are kept: with a
// direct read every voxel has exact per-voxel semantics, as in the plain
// version (ops/blocks.py integrate_slots of the reference, jnp branch).
// Rounding is half to even (rintf), like jnp.round / torch.round.
//
// K4's bound: bytes.  Each listed block reads and writes its sdf and weight rows
// (2 KB each) and, on color frames, its packed color row (6 KB); the image
// reads hit L2.  Coalescing is free: thread i touches float i of each row.

// K8 (tsdf_update_kernel, below) replaces
// instancefusion_tpu/ops/pallas/tsdf.py:fused_tsdf_update (_update_kernel):
// the weighted running average of sdf, weight and packed color over rows
// whose observations (psi, w_obs, packed color obs) were computed outside
// the kernel, as the touched-block integrate of the block map does.  The
// TPU kernel took gathered rows in 64-row tiles and left the scatter back
// to XLA; here one thread per voxel of a listed slot reads the payload row
// in place and writes it back, and entries whose valid flag is false are
// never read or written (their slot holds 0, a real block).  A null color
// pointer updates sdf and weight only (depth-only frames, maps without
// color).  Arithmetic follows _update_kernel: products by the reciprocal of
// the clamped weight.
//
// K8's bound: bytes.  Per voxel of a valid row: sdf and weight read and written
// (16 B), psi and w_obs read (8 B), and with color three payload floats read
// and written and three observations read (36 B); about 25 flops.
// Consecutive threads touch consecutive floats of each row and of each
// observation row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void integrate_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ block_coords, float* __restrict__ sdf,
    float* __restrict__ weight, float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ frame_color,
    const float* __restrict__ T_cw, int width, int height, int b, float fx,
    float fy, float cx, float cy, float voxel, float trunc, float ox,
    float oy, float oz, float max_weight, float color_gain) {
  const int k = blockIdx.x;
  if (!valid[k]) return;
  const int b3 = b * b * b;
  const int idx = threadIdx.x;
  const long long slot = slots[k];
  const int bx = block_coords[3 * slot], by = block_coords[3 * slot + 1],
            bz = block_coords[3 * slot + 2];
  const int lx = idx / (b * b), ly = (idx / b) % b, lz = idx % b;
  const float px = ox + ((float)(bx * b + lx) + 0.5f) * voxel;
  const float py = oy + ((float)(by * b + ly) + 0.5f) * voxel;
  const float pz = oz + ((float)(bz * b + lz) + 0.5f) * voxel;
  const float xc = T_cw[0] * px + T_cw[1] * py + T_cw[2] * pz + T_cw[3];
  const float yc = T_cw[4] * px + T_cw[5] * py + T_cw[6] * pz + T_cw[7];
  const float z = T_cw[8] * px + T_cw[9] * py + T_cw[10] * pz + T_cw[11];
  const float zs = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float uf = rintf(fx * xc / zs + cx);
  const float vf = rintf(fy * yc / zs + cy);
  const bool in_img = uf >= 0.0f && uf < (float)width && vf >= 0.0f &&
                      vf < (float)height;
  float w_obs = 0.0f, psi = 0.0f;
  int pix = 0;
  if (in_img) {
    pix = (int)vf * width + (int)uf;
    const float d = depth[pix];
    const float sdf_obs = d - z;
    if (z > 0.0f && d > 0.0f && sdf_obs > -trunc) {
      w_obs = 1.0f;
      psi = fminf(fmaxf(sdf_obs / trunc, -1.0f), 1.0f);
    }
  }
  const long long row = slot * b3 + idx;
  const float s_old = sdf[row];
  const float w_old = weight[row];
  const float w_sum = w_old + w_obs;
  if (w_sum > 0.0f) sdf[row] = (s_old * w_old + psi * w_obs) / fmaxf(w_sum, 1e-6f);
  weight[row] = fminf(w_sum, max_weight);
  if (frame_color != nullptr) {
    const float wc = color_gain * w_obs;
    const float den = fmaxf(w_old + wc, 1e-6f);
    for (int c = 0; c < 3; ++c) {
      const long long crow = slot * 3 * b3 + c * b3 + idx;
      const float c_obs = frame_color[3 * pix + c];
      color[crow] = (color[crow] * w_old + c_obs * wc) / den;
    }
  }
}

__global__ void tsdf_update_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid,
    long long n, int b3, float* __restrict__ sdf, float* __restrict__ weight,
    float* __restrict__ color, const float* __restrict__ psi,
    const float* __restrict__ w_obs, const float* __restrict__ obs,
    float max_weight, float color_gain) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = i / b3;
  if (!valid[k]) return;
  const int v = (int)(i - k * b3);
  const long long slot = slots[k];
  const long long row = slot * b3 + v;
  const float w_old = weight[row];
  const float wo = w_obs[i];
  const float w_new = w_old + wo;
  const float inv = 1.0f / fmaxf(w_new, 1e-6f);
  if (w_new > 0.0f) sdf[row] = (sdf[row] * w_old + psi[i] * wo) * inv;
  weight[row] = fminf(w_new, max_weight);
  if (color != nullptr) {
    const float wc = color_gain * wo;
    const float inv_c = 1.0f / fmaxf(w_old + wc, 1e-6f);
    for (int c = 0; c < 3; ++c) {
      const long long crow = slot * 3 * b3 + (long long)c * b3 + v;
      const float o = obs[k * 3 * b3 + (long long)c * b3 + v];
      color[crow] = (color[crow] * w_old + o * wc) * inv_c;
    }
  }
}

}  // namespace

extern "C" int ifl_tsdf_update(const int32_t* slots, const uint8_t* valid,
                               int k, int b3, float* sdf, float* weight,
                               float* color, const float* psi,
                               const float* w_obs, const float* obs,
                               float max_weight, float color_gain,
                               void* stream) {
  if (k == 0) return 0;
  const long long n = (long long)k * b3;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  tsdf_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      slots, valid, n, b3, sdf, weight, color, psi, w_obs, obs, max_weight,
      color_gain);
  return (int)cudaGetLastError();
}

extern "C" int ifl_integrate(const int32_t* slots, const uint8_t* valid, int k,
                             const int32_t* block_coords, float* sdf,
                             float* weight, float* color, const float* depth,
                             const float* frame_color, const float* T_cw,
                             int width, int height, int block_size, float fx,
                             float fy, float cx, float cy, float voxel,
                             float trunc, float ox, float oy, float oz,
                             float max_weight, float color_gain,
                             void* stream) {
  if (k == 0) return 0;
  const int b3 = block_size * block_size * block_size;
  integrate_kernel<<<k, b3, 0, (cudaStream_t)stream>>>(
      slots, valid, block_coords, sdf, weight, color, depth, frame_color,
      T_cw, width, height, block_size, fx, fy, cx, cy, voxel, trunc, ox, oy,
      oz, max_weight, color_gain);
  return (int)cudaGetLastError();
}
