// Wind-field gradient stencil and its adjoint for NVIDIA Hopper (sm_90a),
// plain C ABI for ctypes.
//
// Replaces the TPU kernels gan_sr_wind_field_tpu/ops/pallas/stencil.py:
//   wind_field_gradient_pallas  -> _grad_kernel            (the forward)
//   _gradient_transpose_pallas  -> _grad_transpose_kernel  (its adjoint)
//
// What they compute. The field f is channels-last (N, X, Y, Zl, 3) float32,
// the terrain height Z is (N, X, Y, Zl) float32. Along each axis the
// derivative is the 3-term stencil f'_i = A_i f_{i+1} + B_i f_i + C_i f_{i-1}
// on a nonuniform grid, with clamped neighbours at the edges, where the
// out-of-range coefficient is zero (one-sided first-order differences).
// The coefficients come from the coordinates around each point, by one
// formula for all three axes: the x and y coordinate vectors, and per
// voxel the heights of its column (terrain-following z). The forward writes the 9
// channels [d/dx (u,v,w), d/dy (u,v,w), d/dz (u,v,w)]. The adjoint takes a
// 9-channel cotangent g and forms, on each axis,
//   (L^T g)_i = A_{i-1} g_{i-1} + B_i g_i + C_{i+1} g_{i+1}
// with zero outside the volume: exact, because the coefficients that meet
// the clamped edge terms are zero.
//
// Bound. Both move bytes, not operations: per voxel the forward reads 12 B
// of field and 4 B of height and writes 36 B; the adjoint reads 36 B and
// 4 B and writes 12 B. At the training batch of 32 (64x64x10 voxels) that
// is 68.2 MB each, 0.020 ms at 3.35 TB/s.
//
// Design of this first version: one thread per voxel, no transposes (the
// TPU's (N, Zl*C, X, Y) layout exists only for its lanes). Each thread
// computes its own x, y and z coefficients from the coordinates, so the
// wrapper launches nothing else (the TPU kernel takes x/y coefficient
// vectors made outside it; here those small host-side ops would cost more
// than the pass). Neighbours come through L1/L2: a warp covers consecutive
// voxels (z fastest), so its loads of each neighbour plane are contiguous.
// What holds it back: every neighbour value is loaded again by the threads
// that need it (up to 7 loads of each field value), and the 12- and
// 36-byte per-voxel records give loads that are not 16-byte vectors.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// (A, B, C) at point z of coordinates h[0 .. Zl): the h²-weighted
// nonuniform central difference inside, one-sided at the ends
// (stencil.py:_axis_coeffs and the z coefficients of _grad_kernel)
__device__ __forceinline__ void coeffs(const float* __restrict__ h, int z,
                                       int Zl, float& a, float& b,
                                       float& c) {
  if (z == 0) {
    const float inv = 1.f / (h[1] - h[0]);
    a = inv;
    b = -inv;
    c = 0.f;
  } else if (z == Zl - 1) {
    const float inv = 1.f / (h[Zl - 1] - h[Zl - 2]);
    a = 0.f;
    b = inv;
    c = -inv;
  } else {
    const float lo = h[z] - h[z - 1], hi = h[z + 1] - h[z];
    const float denom = lo * hi * (lo + hi);
    a = lo * lo / denom;
    b = (hi * hi - lo * lo) / denom;
    c = -(hi * hi) / denom;
  }
}

__global__ void grad_fwd(const float* __restrict__ f,
                         const float* __restrict__ hz,
                         const float* __restrict__ cxs,
                         const float* __restrict__ cys,
                         float* __restrict__ out, size_t voxels, int X,
                         int Y, int Zl) {
  const size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (v >= voxels) return;
  const int z = (int)(v % Zl);
  const int y = (int)((v / Zl) % Y);
  const int x = (int)((v / ((size_t)Zl * Y)) % X);
  const size_t sy = Zl, sx = (size_t)Zl * Y;
  // clamped neighbours
  const size_t xp = x < X - 1 ? v + sx : v, xm = x > 0 ? v - sx : v;
  const size_t yp = y < Y - 1 ? v + sy : v, ym = y > 0 ? v - sy : v;
  const size_t zp = z < Zl - 1 ? v + 1 : v, zm = z > 0 ? v - 1 : v;
  float a_x, b_x, c_x, a_y, b_y, c_y, az, bz, cz;
  coeffs(cxs, x, X, a_x, b_x, c_x);
  coeffs(cys, y, Y, a_y, b_y, c_y);
  coeffs(hz + (v - z), z, Zl, az, bz, cz);
  float* o = out + v * 9;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0 = f[v * 3 + c];
    o[c] = a_x * f[xp * 3 + c] + b_x * f0 + c_x * f[xm * 3 + c];
    o[3 + c] = a_y * f[yp * 3 + c] + b_y * f0 + c_y * f[ym * 3 + c];
    o[6 + c] = az * f[zp * 3 + c] + bz * f0 + cz * f[zm * 3 + c];
  }
}

// B at point i, A at i - 1 and C at i + 1 (zero where those leave the axis)
__device__ __forceinline__ void adj_coeffs(const float* __restrict__ h,
                                           int i, int n, float& am,
                                           float& b0, float& cp) {
  float t0, t1;
  coeffs(h, i, n, t0, b0, t1);
  am = cp = 0.f;
  if (i > 0) coeffs(h, i - 1, n, am, t0, t1);
  if (i < n - 1) coeffs(h, i + 1, n, t0, t1, cp);
}

__global__ void grad_adj(const float* __restrict__ g,
                         const float* __restrict__ hz,
                         const float* __restrict__ cxs,
                         const float* __restrict__ cys,
                         float* __restrict__ out, size_t voxels, int X,
                         int Y, int Zl) {
  const size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (v >= voxels) return;
  const int z = (int)(v % Zl);
  const int y = (int)((v / Zl) % Y);
  const int x = (int)((v / ((size_t)Zl * Y)) % X);
  const size_t sy = Zl, sx = (size_t)Zl * Y;
  float axm, bx0, cxp, aym, by0, cyp, azm, bz0, czp;
  adj_coeffs(cxs, x, X, axm, bx0, cxp);
  adj_coeffs(cys, y, Y, aym, by0, cyp);
  adj_coeffs(hz + (v - z), z, Zl, azm, bz0, czp);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // x: g channels 0..2, y: 3..5, z: 6..8
    float dx = bx0 * g[v * 9 + c];
    if (x > 0) dx = axm * g[(v - sx) * 9 + c] + dx;
    if (x < X - 1) dx = dx + cxp * g[(v + sx) * 9 + c];
    float dy = by0 * g[v * 9 + 3 + c];
    if (y > 0) dy = aym * g[(v - sy) * 9 + 3 + c] + dy;
    if (y < Y - 1) dy = dy + cyp * g[(v + sy) * 9 + 3 + c];
    float dz = bz0 * g[v * 9 + 6 + c];
    if (z > 0) dz = azm * g[(v - 1) * 9 + 6 + c] + dz;
    if (z < Zl - 1) dz = dz + czp * g[(v + 1) * 9 + 6 + c];
    out[v * 3 + c] = (dx + dy) + dz;
  }
}

}  // namespace

// f (N, X, Y, Zl, 3), hz (N, X, Y, Zl), x (X), y (Y) -> out (N, X, Y, Zl, 9)
extern "C" int windsr_wind_gradient(const void* f, const void* hz,
                                    const void* x, const void* y, void* out,
                                    int N, int X, int Y, int Zl,
                                    void* stream) {
  const size_t voxels = (size_t)N * X * Y * Zl;
  const unsigned blocks = (unsigned)((voxels + 255) / 256);
  grad_fwd<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(hz),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), voxels, X, Y, Zl);
  return (int)cudaGetLastError();
}

// g (N, X, Y, Zl, 9), hz, x, y as above -> out (N, X, Y, Zl, 3)
extern "C" int windsr_wind_gradient_adjoint(const void* g, const void* hz,
                                            const void* x, const void* y,
                                            void* out, int N, int X, int Y,
                                            int Zl, void* stream) {
  const size_t voxels = (size_t)N * X * Y * Zl;
  const unsigned blocks = (unsigned)((voxels + 255) / 256);
  grad_adj<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(hz),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), voxels, X, Y, Zl);
  return (int)cudaGetLastError();
}
