// Fused preprocess kernel for Hopper (sm_90a), K1.
//
// Replaces instancefusion_tpu/ops/pallas/preprocess.py:fused_preprocess
// (_kernel): depth clamp, (2r+1)^2 bilateral filter, back-projected vertex
// map, central-difference normal map and the valid mask of pyramid level 0,
// in one pass.  The TPU kernel held the whole image in VMEM and wrote
// component planes (a 3-wide minor axis pads to 128 lanes there); here one
// thread computes one pixel of a 32x8 output tile from a shared-memory tile
// of clamped raw depth with a halo of r + 1: the bilateral needs r, and the
// normals' central differences need the filtered depth one pixel further
// out, which each block computes into shared memory before the normals.
// vmap and nmap are written interleaved (H, W, 3), the layout the port's
// pyramid holds.
//
// Arithmetic follows the plain version (ops/kernels/preprocess.py
// fused_preprocess_ref) step by step: taps dy-major then dx, the spatial
// term one fp32 constant per tap, products and sums rounded one at a time
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs), IEEE
// division and sqrt; the two differ by expf rounding only.  Pixels outside
// the image read as depth 0 (no weight), and the one-pixel border is
// invalid, as in the plain version.
//
// Bound: bytes.  4 bytes read and 29 written per pixel (df, vmap, nmap,
// valid); ~300 fp32 operations per pixel stay well under the fp32 peak.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32, TY = 8;  // output tile; one thread per pixel
constexpr int MAX_R = 4;        // largest bilateral radius taken
constexpr int MAX_TAPS = (2 * MAX_R + 1) * (2 * MAX_R + 1);

struct Taps {
  float spatial[MAX_TAPS];  // -(dy^2 + dx^2) / (2 sigma_s^2), dy-major
};

__device__ __forceinline__ float vertex(int u, float c, float f, float d) {
  return __fmul_rn(((float)u - c) / f, d);
}

__global__ void preprocess_kernel(const float* __restrict__ depth,
                                  float* __restrict__ df_out,
                                  float* __restrict__ vmap,
                                  float* __restrict__ nmap,
                                  uint8_t* __restrict__ valid_out, int width,
                                  int height, int r, Taps taps, float inv2sd,
                                  float dmin, float dmax, float fx, float fy,
                                  float cx, float cy) {
  // Raw tile: outputs +- 1 (normals) +- r (bilateral).
  __shared__ float raw[(TY + 2 + 2 * MAX_R) * (TX + 2 + 2 * MAX_R)];
  // Filtered tile: outputs +- 1.
  __shared__ float filt[(TY + 2) * (TX + 2)];
  const int h = 1 + r;
  const int rw = TX + 2 * h, rh = TY + 2 * h;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int i = tid; i < rw * rh; i += TX * TY) {
    const int gx = x0 - h + i % rw, gy = y0 - h + i / rw;
    float d = 0.0f;
    if (gx >= 0 && gx < width && gy >= 0 && gy < height) {
      d = depth[(long long)gy * width + gx];
      if (!(d >= dmin && d <= dmax)) d = 0.0f;
    }
    raw[i] = d;
  }
  __syncthreads();

  const int fw = TX + 2;
  for (int i = tid; i < fw * (TY + 2); i += TX * TY) {
    const int fx_ = i % fw, fy_ = i / fw;
    const int gx = x0 - 1 + fx_, gy = y0 - 1 + fy_;
    float out = 0.0f;
    const float c = raw[(fy_ + r) * rw + fx_ + r];
    if (gx >= 0 && gx < width && gy >= 0 && gy < height && c > 0.0f) {
      float acc = 0.0f, wacc = 0.0f;
      int tap = 0;
      for (int dy = -r; dy <= r; ++dy) {
        for (int dx = -r; dx <= r; ++dx, ++tap) {
          // The plain version's roll by (dy, dx) reads pixel (y - dy, x - dx).
          const float s = raw[(fy_ + r - dy) * rw + fx_ + r - dx];
          if (s > 0.0f) {
            const float dd = s - c;
            const float a =
                taps.spatial[tap] - __fmul_rn(__fmul_rn(dd, dd), inv2sd);
            const float w = expf(a);
            acc = __fadd_rn(acc, __fmul_rn(w, s));
            wacc = __fadd_rn(wacc, w);
          }
        }
      }
      out = wacc > 1e-8f ? acc / fmaxf(wacc, 1e-8f) : 0.0f;
    }
    filt[i] = out;
  }
  __syncthreads();

  const int u = x0 + threadIdx.x, v = y0 + threadIdx.y;
  if (u >= width || v >= height) return;
  const int tx = threadIdx.x + 1, ty = threadIdx.y + 1;
  const float d = filt[ty * fw + tx];
  const float dl = filt[ty * fw + tx - 1], dr = filt[ty * fw + tx + 1];
  const float du = filt[(ty - 1) * fw + tx], dd = filt[(ty + 1) * fw + tx];
  const long long p = (long long)v * width + u;
  df_out[p] = d;
  vmap[3 * p] = vertex(u, cx, fx, d);
  vmap[3 * p + 1] = vertex(v, cy, fy, d);
  vmap[3 * p + 2] = d;

  // Central differences of the vertex map: +x minus -x, +y minus -y.
  const float ax = __fsub_rn(vertex(u + 1, cx, fx, dr), vertex(u - 1, cx, fx, dl));
  const float ay = __fsub_rn(vertex(v, cy, fy, dr), vertex(v, cy, fy, dl));
  const float az = __fsub_rn(dr, dl);
  const float bx = __fsub_rn(vertex(u, cx, fx, dd), vertex(u, cx, fx, du));
  const float by = __fsub_rn(vertex(v + 1, cy, fy, dd), vertex(v - 1, cy, fy, du));
  const float bz = __fsub_rn(dd, du);
  float nx = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
  float ny = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
  float nz = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
  const float norm = sqrtf(
      __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz)));
  const float inv = fmaxf(norm, 1e-12f);
  nx = nx / inv;
  ny = ny / inv;
  nz = nz / inv;
  if (nz > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  const bool ok = d > 0.0f && dl > 0.0f && dr > 0.0f && du > 0.0f &&
                  dd > 0.0f && norm > 1e-12f && u > 0 && u < width - 1 &&
                  v > 0 && v < height - 1;
  nmap[3 * p] = ok ? nx : 0.0f;
  nmap[3 * p + 1] = ok ? ny : 0.0f;
  nmap[3 * p + 2] = ok ? nz : 0.0f;
  valid_out[p] = ok ? 1 : 0;
}

}  // namespace

extern "C" int ifl_preprocess(const float* depth, float* df, float* vmap,
                              float* nmap, uint8_t* valid, int width,
                              int height, int radius, const float* spatial,
                              float inv2sd, float dmin, float dmax, float fx,
                              float fy, float cx, float cy, void* stream) {
  if (radius < 0 || radius > MAX_R) return (int)cudaErrorInvalidValue;
  Taps taps;
  const int n = (2 * radius + 1) * (2 * radius + 1);
  for (int i = 0; i < n; ++i) taps.spatial[i] = spatial[i];
  const dim3 block(TX, TY);
  const dim3 grid((width + TX - 1) / TX, (height + TY - 1) / TY);
  preprocess_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      depth, df, vmap, nmap, valid, width, height, radius, taps, inv2sd, dmin,
      dmax, fx, fy, cx, cy);
  return (int)cudaGetLastError();
}
