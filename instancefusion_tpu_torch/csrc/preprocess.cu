// Fused preprocess kernel for Hopper (sm_90a), K1.
//
// Replaces instancefusion_tpu/ops/pallas/preprocess.py:fused_preprocess
// (_kernel): depth clamp, (2r+1)^2 bilateral filter, back-projected vertex
// map, central-difference normal map and the valid mask of pyramid level 0,
// in one pass.  The TPU kernel held the whole image in VMEM and wrote
// component planes (a 3-wide minor axis pads to 128 lanes there); here a
// block of 256 threads computes a 32-wide tile of outputs from a
// shared-memory tile of clamped raw depth with a halo of r + 1: the
// bilateral needs r, and the normals' central differences need the
// filtered depth one pixel further out.  Three phases, split by
// __syncthreads: the raw tile; the filtered ring (the tile plus one pixel
// all round, flattened over the threads so that every lane works); the
// outputs, kTileH / 8 rows a thread.  vmap and nmap are written interleaved
// (H, W, 3), the layout the port's pyramid holds.
//
// Radii 1-4 are compile-time instances: the taps are unrolled, their
// spatial exponents are kernel parameters (the constant bank) and the tile
// is 32x16 outputs, whose ring is 1.2x the outputs; at 640x480 its 600
// blocks are all resident at once on an H100's 132 SMs.  Every other
// radius runs the runtime-radius instance: the exponents come from a
// device table, and the wrapper picks the tile height (16 while the tile
// fits 48 KB of shared memory, else 8) and the dynamic shared memory, which
// ifl_preprocess opts into above 48 KB.
//
// Arithmetic follows the plain version (ops/kernels/preprocess.py
// fused_preprocess_ref) step by step: taps dy-major then dx, the spatial
// term one fp32 constant per tap, products and sums rounded one at a time
// (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs), expf,
// IEEE division and sqrt.  An invalid tap adds +0 to both sums, which
// leaves them as they are, so the taps need no branch.  Pixels outside the
// image read as depth 0 (no weight), and the one-pixel border is invalid,
// as in the plain version.
//
// Bound: bytes at radius 2 (4 bytes read and 29 written per pixel: df,
// vmap, nmap, valid); ~20 fp32 instructions a tap (the expf among them),
// so the bilateral's (2r+1)^2 taps make larger radii bound by operations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;            // output tile width (one warp)
constexpr int kThreadsY = 8;          // 32 x 8 threads a block
constexpr int kThreads = kTileW * kThreadsY;
constexpr int kTileH = 16;            // output rows of the compile-time radii
constexpr int kFiltW = kTileW + 2;    // filtered ring: outputs +- 1
constexpr int kMaxStaticR = 4;

struct Taps {
  float spatial[(2 * kMaxStaticR + 1) * (2 * kMaxStaticR + 1)];  // dy-major
};

__device__ __forceinline__ float vertex(int u, float c, float f, float d) {
  return __fmul_rn(((float)u - c) / f, d);
}

// R > 0: radius R, kTileH output rows, spatial exponents from `taps`.
// R == 0: radius r_rt, th_rt output rows (a multiple of 8), exponents from
// the device table `spatial`.
template <int R>
__global__ void __launch_bounds__(kThreads)
    preprocess_kernel(const float* __restrict__ depth, float* __restrict__ df_out,
                      float* __restrict__ vmap, float* __restrict__ nmap,
                      uint8_t* __restrict__ valid_out, int width, int height,
                      int r_rt, int th_rt, Taps taps,
                      const float* __restrict__ spatial, float inv2sd,
                      float dmin, float dmax, float fx, float fy, float cx,
                      float cy) {
  extern __shared__ float smem[];
  const int r = R > 0 ? R : r_rt;
  const int th = R > 0 ? kTileH : th_rt;
  const int h = r + 1;
  const int rw = kTileW + 2 * h, rh = th + 2 * h;
  float* raw = smem;             // rh x rw: clamped depth, outputs +- (r + 1)
  float* filt = smem + rw * rh;  // (th + 2) x kFiltW: filtered, outputs +- 1
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * th;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < rw * rh; i += kThreads) {
    const int ry = i / rw, rx = i - ry * rw;
    const int gx = x0 - h + rx, gy = y0 - h + ry;
    float d = 0.0f;
    if (gx >= 0 && gx < width && gy >= 0 && gy < height) {
      d = depth[(long long)gy * width + gx];
      if (!(d >= dmin && d <= dmax)) d = 0.0f;
    }
    raw[i] = d;
  }
  __syncthreads();

  for (int i = tid; i < kFiltW * (th + 2); i += kThreads) {
    const int fy_ = i / kFiltW, fx_ = i - fy_ * kFiltW;
    const int gx = x0 - 1 + fx_, gy = y0 - 1 + fy_;
    // center: raw pixel (fy_ + r, fx_ + r); tap (dy, dx) reads the pixel
    // (y - dy, x - dx), as the plain version's roll by (dy, dx) does.
    const float* center = raw + (fy_ + r) * rw + fx_ + r;
    const float c = *center;
    float out = 0.0f;
    if (gx >= 0 && gx < width && gy >= 0 && gy < height && c > 0.0f) {
      float acc = 0.0f, wacc = 0.0f;
      if constexpr (R > 0) {
#pragma unroll
        for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
          for (int dx = -R; dx <= R; ++dx) {
            const float s = center[-dy * rw - dx];
            const float dd = s - c;
            const float a = taps.spatial[(dy + R) * (2 * R + 1) + dx + R] -
                            __fmul_rn(__fmul_rn(dd, dd), inv2sd);
            const float w = s > 0.0f ? expf(a) : 0.0f;
            acc = __fadd_rn(acc, __fmul_rn(w, s));
            wacc = __fadd_rn(wacc, w);
          }
        }
      } else {
        const float* tap = spatial;
        for (int dy = -r; dy <= r; ++dy) {
          const float* row = center - dy * rw;
          for (int dx = -r; dx <= r; ++dx, ++tap) {
            const float s = row[-dx];
            const float dd = s - c;
            const float a = __ldg(tap) - __fmul_rn(__fmul_rn(dd, dd), inv2sd);
            const float w = s > 0.0f ? expf(a) : 0.0f;
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

  const int u = x0 + threadIdx.x;
  const int tx = threadIdx.x + 1;
  for (int ty = threadIdx.y + 1; ty <= th; ty += kThreadsY) {
    const int v = y0 + ty - 1;
    if (u >= width || v >= height) continue;
    const float d = filt[ty * kFiltW + tx];
    const float dl = filt[ty * kFiltW + tx - 1], dr = filt[ty * kFiltW + tx + 1];
    const float du = filt[(ty - 1) * kFiltW + tx], dd = filt[(ty + 1) * kFiltW + tx];
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
}

// Shared memory of a tile of `th` output rows at radius r: the raw tile and
// the filtered ring (ops/kernels/preprocess.py smem_bytes mirrors it).
size_t smem_bytes(int r, int th) {
  const size_t h = (size_t)r + 1;
  return ((kTileW + 2 * h) * (th + 2 * h) + (size_t)kFiltW * (th + 2)) * sizeof(float);
}

template <int R>
int launch(const float* depth, float* df, float* vmap, float* nmap,
           uint8_t* valid, int width, int height, int radius, int th,
           const Taps& taps, const float* spatial, float inv2sd, float dmin,
           float dmax, float fx, float fy, float cx, float cy,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(radius, th);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        preprocess_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + th - 1) / th);
  preprocess_kernel<R><<<grid, block, smem, stream>>>(
      depth, df, vmap, nmap, valid, width, height, radius, th, taps, spatial,
      inv2sd, dmin, dmax, fx, fy, cx, cy);
  return (int)cudaGetLastError();
}

}  // namespace

// `spatial` holds the (2r+1)^2 spatial exponents, dy-major: host memory
// for radii 1-4 (copied into the launch's parameters), device memory for
// every other radius.  tile_rows: the output rows of a tile, a positive
// multiple of 8; radii 1-4 take 16.
extern "C" int ifl_preprocess(const float* depth, float* df, float* vmap,
                              float* nmap, uint8_t* valid, int width,
                              int height, int radius, int tile_rows,
                              const float* spatial, float inv2sd, float dmin,
                              float dmax, float fx, float fy, float cx,
                              float cy, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Taps taps = {};
  if (radius >= 1 && radius <= kMaxStaticR) {
    if (tile_rows != kTileH) return (int)cudaErrorInvalidValue;
    const int n = (2 * radius + 1) * (2 * radius + 1);
    for (int i = 0; i < n; ++i) taps.spatial[i] = spatial[i];
  } else if (radius < 0 || tile_rows < kThreadsY || tile_rows % kThreadsY != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (radius) {
    case 1:
      return launch<1>(depth, df, vmap, nmap, valid, width, height, 1, kTileH, taps,
                       nullptr, inv2sd, dmin, dmax, fx, fy, cx, cy, s);
    case 2:
      return launch<2>(depth, df, vmap, nmap, valid, width, height, 2, kTileH, taps,
                       nullptr, inv2sd, dmin, dmax, fx, fy, cx, cy, s);
    case 3:
      return launch<3>(depth, df, vmap, nmap, valid, width, height, 3, kTileH, taps,
                       nullptr, inv2sd, dmin, dmax, fx, fy, cx, cy, s);
    case 4:
      return launch<4>(depth, df, vmap, nmap, valid, width, height, 4, kTileH, taps,
                       nullptr, inv2sd, dmin, dmax, fx, fy, cx, cy, s);
    default:
      return launch<0>(depth, df, vmap, nmap, valid, width, height, radius, tile_rows,
                       taps, spatial, inv2sd, dmin, dmax, fx, fy, cx, cy, s);
  }
}
