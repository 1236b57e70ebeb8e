// Device helpers shared by the kernels of icp.cu (K2) and raycast.cu (K5).
//
// A kernel that places a point on a pixel must round as its plain PyTorch
// version does, or a 1-ulp difference picks the neighbouring pixel at a .5
// boundary (K2) or turns a tent edge's weight on or off (K5).  These
// helpers round after every operation (__fmul_rn and friends are never
// contracted into fused multiply-adds), in the order of the plain
// versions' ``geometry/se3.cam_row``.

#pragma once

// ((x r0 + y r1) + z r2) + r3: coordinate of a rigid transform whose row
// (r0, r1, r2, r3) is given, rounded after each operation.
__device__ __forceinline__ float cam_row(float x, float y, float z,
                                         const float* r) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, r[0]), __fmul_rn(y, r[1])),
                             __fmul_rn(z, r[2])),
                   r[3]);
}

// (f x) / z + c: the pinhole projection of one coordinate, rounded after
// each operation.
__device__ __forceinline__ float project_coord(float f, float x, float z,
                                               float c) {
  return __fadd_rn(__fdiv_rn(__fmul_rn(f, x), z), c);
}
