// Instance-label vote kernel for Hopper (sm_90a), K7.
//
// Replaces instancefusion_tpu/ops/pallas/tsdf.py:fused_label_vote
// (_vote_kernel) together with the projective association around it in
// ops/labels.py:fuse.  On the TPU, XLA gathered the listed vote rows and
// the observed instance ids, Pallas ran the Boyer-Moore update on whole
// (K, 512) tiles, and XLA scattered the rows back.  Here one block of B^3
// threads handles one listed slot and does all of it in place: each thread
// takes its voxel center (x-major within the block), moves it into the
// camera frame, projects it with the zsafe guard of geometry/camera.project,
// rounds half to even (rintf, like jnp.round / torch.round), reads the
// depth and instance-id pixels, and where the voxel lies in the band
// (|d - z| < trunc, two-sided) of a pixel that carries an id it votes:
//
//   count <= 0 -> adopt the id, count = 1
//   same id    -> count += 1
//   other id   -> count -= 1
//
// Valid listed slots are unique (prefix-sum compaction of the touched-block
// directory), so no two blocks write one row; invalid entries return at
// once (the list is 8192 long at 512^3, about a thousand of them valid).
//
// Bound: bytes.  Each valid slot reads and writes its label and count rows
// (2 KB each); the two image reads per voxel hit L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void label_vote_kernel(
    const int32_t* __restrict__ slots, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ block_coords, int32_t* __restrict__ label,
    float* __restrict__ count, const float* __restrict__ depth,
    const int32_t* __restrict__ gid_image, const float* __restrict__ T_cw,
    int width, int height, int b, float fx, float fy, float cx, float cy,
    float voxel, float trunc, float ox, float oy, float oz) {
  const int k = blockIdx.x;
  if (!valid[k]) return;
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
  if (!(uf >= 0.0f && uf < (float)width && vf >= 0.0f && vf < (float)height))
    return;
  if (!(z > 0.0f)) return;
  const long long pix = (long long)vf * width + (long long)uf;
  const float d = depth[pix];
  const int32_t g = gid_image[pix];
  if (!(d > 0.0f && fabsf(d - z) < trunc && g >= 0)) return;
  const long long row = slot * (long long)(b * b * b) + idx;
  const float cnt = count[row];
  if (cnt <= 0.0f) {
    label[row] = g;
    count[row] = 1.0f;
  } else if (label[row] == g) {
    count[row] = cnt + 1.0f;
  } else {
    count[row] = cnt - 1.0f;
  }
}

}  // namespace

extern "C" int ifl_label_vote(const int32_t* slots, const uint8_t* valid,
                              int k, const int32_t* block_coords,
                              int32_t* label, float* count, const float* depth,
                              const int32_t* gid_image, const float* T_cw,
                              int width, int height, int block_size, float fx,
                              float fy, float cx, float cy, float voxel,
                              float trunc, float ox, float oy, float oz,
                              void* stream) {
  if (k == 0) return 0;
  const int b3 = block_size * block_size * block_size;
  label_vote_kernel<<<k, b3, 0, (cudaStream_t)stream>>>(
      slots, valid, block_coords, label, count, depth, gid_image, T_cw, width,
      height, block_size, fx, fy, cx, cy, voxel, trunc, ox, oy, oz);
  return (int)cudaGetLastError();
}
