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
// voxel the heights of its column (terrain-following z). The forward writes
// the 9 channels [d/dx (u,v,w), d/dy (u,v,w), d/dz (u,v,w)]. The adjoint
// takes a 9-channel cotangent g and forms, on each axis,
//   (L^T g)_i = A_{i-1} g_{i-1} + B_i g_i + C_{i+1} g_{i+1}
// with zero outside the volume: exact, because the coefficients that meet
// the clamped edge terms are zero.
//
// Bound. Both move bytes, not operations: per voxel the forward reads 12 B
// of field and 4 B of height and writes 36 B; the adjoint reads 36 B and
// 4 B and writes 12 B. At the training batch of 32 (64x64x10 voxels) that
// is 68.2 MB each, 0.0203 ms at 3.35 TB/s; about 100 float32 operations
// per voxel are under a tenth of that at the CUDA cores' rate.
//
// Design. One block per strip: TX consecutive x rows of TY columns of one
// sample, all Zl levels of each column (Tile below). The block walks its
// strip row by row, and each row of the input is copied to shared memory
// once per strip:
//   1. stage: the contiguous run of an x row's TY columns and their y halo
//      (clamped to the volume, as the TPU kernel clamps), and its heights,
//      go into a ring of RING = AHEAD + 3 row slots with cp.async, AHEAD
//      rows ahead of the row computed (rows x - 1, x, x + 1 are read):
//      16-byte copies where source and destination align together (each
//      row sits at the float offset of its source in a 16-byte line),
//      4-byte copies at the ends. A column is Zl * 3 * 4 = 120 B, no
//      multiple of 16, so runs start anywhere in a line.
//   2. coefficients: the strip's x and y triples once per block, in shared
//      memory; z triples once per voxel from the staged heights, each with
//      one correctly rounded reciprocal for its three quotients (coeffs).
//      The adjoint computes row x + 1's z triples beside row x's sums into
//      a second buffer, so that each voxel reads its neighbours' triples
//      instead of computing them again;
//   3. one thread per voxel of the row reads its neighbours from shared
//      memory, keeps its 9 (3) outputs in registers until its loads are
//      done, and writes them into an output row (two, alternating);
//   4. the output row, a contiguous run of TY * Zl * 9 (3) floats, goes out
//      in 16-byte stores by consecutive threads while the next row is
//      computed.
// Index arithmetic is 32-bit within a sample (the sample's offset is 64-bit,
// from blockIdx), with divisions by a reciprocal multiply. The strips' end
// rows are read again by the neighbouring strips, through L2. The host
// plan (ops/stencil.py:plan_stencil) mirrors Tile and raises where a tile
// does not fit a block's shared memory: at Zl = 10 the forward's tile
// needs 45,120 B and the adjoint's 70,176 B.
//
// What is left (PERF.md): the forward runs at the card's copy rate; the
// adjoint's sums and z triples do not yet overlap its copies fully.

#include <cuda_runtime.h>

#include <cstdint>

namespace st {

constexpr int SMEM_LIMIT = 232448;  // shared memory one block may have

// The strip of one block: TX consecutive x rows of TY columns of one
// sample, all Zl levels, walked row by row by NT threads, with the input
// rows AHEAD steps ahead of the row computed. Shared memory, in floats,
// for a field of CIN channels in and COUT out (in this order; each row is
// padded so that it holds its run at any of the 4 offsets in a 16-byte
// line):
//   in    RING rows of (TY + 2) columns x Zl x CIN  (the y halo)
//   h     RING rows of TY columns x Zl              (heights)
//   out   2 rows of TY columns x Zl x COUT          (double buffer)
//   xc    TX triples, yc TY triples                 (coefficients)
//   zc    2 rows of TY x Zl triples                 (adjoint only)
template <int TX_, int TY_, int NT_, int AHEAD_>
struct Tile {
  static constexpr int TX = TX_, TY = TY_, NT = NT_, AHEAD = AHEAD_;
  // rows x - 1, x and x + 1 in use, AHEAD rows in flight
  static constexpr int RING = AHEAD + 3;
  __host__ __device__ static constexpr int pitch(int n) {
    return (n + 3 + 3) & ~3;
  }
  __host__ __device__ static constexpr int in_pitch(int zl, int cin) {
    return pitch((TY + 2) * zl * cin);
  }
  __host__ __device__ static constexpr int h_pitch(int zl) {
    return pitch(TY * zl);
  }
  __host__ __device__ static constexpr int out_pitch(int zl, int cout) {
    return pitch(TY * zl * cout);
  }
  static constexpr long long smem_bytes(int zl, int cin, int cout, bool zc) {
    return 4 * ((long long)RING * (in_pitch(zl, cin) + h_pitch(zl)) +
                2LL * out_pitch(zl, cout) + 3 * (TX + TY) +
                (zc ? 6LL * TY * zl : 0));
  }
};

// ceil(2^32 / d) for d >= 2: q = umulhi(v, m) is v / d whenever v * d
// < 2^32, which the plan's tiles keep to
__device__ __forceinline__ uint32_t magic(uint32_t d) {
  return 0xFFFFFFFFu / d + 1u;
}

__device__ __forceinline__ int fdiv(int v, uint32_t m) {
  return (int)__umulhi((uint32_t)v, m);
}

// the float offset of p in its 16-byte line
__device__ __forceinline__ int line_offset(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// src[0 .. n) into row + line_offset(src) (row 16-byte aligned), so that
// both sides of the middle part are 16-byte aligned together
template <int NT>
__device__ __forceinline__ void stage_run(float* row, const float* src,
                                          int n) {
  const int s = line_offset(src);
  const int head = min((4 - s) & 3, n);
  const int n4 = (n - head) >> 2;
  float* d = row + s;
  for (int i = threadIdx.x; i < head; i += NT) cp_async4(d + i, src + i);
  for (int i = threadIdx.x; i < n4; i += NT)
    cp_async16(d + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += NT)
    cp_async4(d + i, src + i);
}

// row + line_offset(dst), n floats, out to dst[0 .. n)
template <int NT>
__device__ __forceinline__ void store_run(float* dst, const float* row,
                                          int n) {
  const int s = line_offset(dst);
  const int head = min((4 - s) & 3, n);
  const int n4 = (n - head) >> 2;
  const float* r = row + s;
  for (int i = threadIdx.x; i < head; i += NT) dst[i] = r[i];
  for (int i = threadIdx.x; i < n4; i += NT)
    *reinterpret_cast<float4*>(dst + head + 4 * i) =
        *reinterpret_cast<const float4*>(r + head + 4 * i);
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += NT) dst[i] = r[i];
}

// n / d for one denominator and several numerators at the cost of one
// division: given y = 1/d correctly rounded (__frcp_rn), q = n y and
// q + (n - d q) y is the correctly rounded quotient, as `/` gives it
// (Markstein's theorem), wherever no step underflows or overflows.
__device__ __forceinline__ float quotient(float n, float d, float y) {
  const float q = n * y;
  return fmaf(fmaf(-d, q, n), y, q);
}

// (A, B, C) at point z of coordinates h[0 .. n): the h²-weighted
// nonuniform central difference inside, one-sided at the ends
// (stencil.py:_axis_coeffs and the z coefficients of _grad_kernel). The
// three quotients at every point share one denominator, and their operands
// are chosen without a branch, so that a warp over mixed z does not run
// three paths: at the ends (1, -1, x) / d is exactly 1/d and -1/d, and the
// end's zero is selected after its quotient. For spacings of one sign
// within 2^-40 .. 2^40 every step of `quotient` stays normal, so A, B and
// C are the plain version's to the bit.
__device__ __forceinline__ void coeffs(const float* h, int z, int n,
                                       float& a, float& b, float& c) {
  const float lo = h[z] - h[max(z - 1, 0)], hi = h[min(z + 1, n - 1)] - h[z];
  const bool bot = z == 0, top = z == n - 1, end = bot || top;
  const float denom = bot ? hi : top ? lo : lo * hi * (lo + hi);
  const float y = __frcp_rn(denom);
  const float qa = quotient(end ? 1.f : lo * lo, denom, y);
  const float qb = quotient(bot ? -1.f : top ? 1.f : hi * hi - lo * lo,
                            denom, y);
  const float qc = quotient(end ? -1.f : -(hi * hi), denom, y);
  a = top ? 0.f : qa;
  b = qb;
  c = bot ? 0.f : qc;
}

// B at point i, A at i - 1 and C at i + 1 (zero where those leave the axis)
__device__ __forceinline__ void adj_coeffs(const float* h, int i, int n,
                                           float* t) {
  float u, v;
  coeffs(h, i, n, u, t[1], v);
  t[0] = t[2] = 0.f;
  if (i > 0) coeffs(h, i - 1, n, t[0], u, v);
  if (i < n - 1) coeffs(h, i + 1, n, u, v, t[2]);
}

// The block's strip and its staged rows, shared by both kernels. Row r of
// the volume (first <= r <= last: the strip's rows and their x halo) is
// staging step r - first, in ring slot (r - first) % RING; a staged row
// sits at the float offset of its source in a 16-byte line.
template <class T, int CIN, int COUT>
struct Strip {
  int X, Y, Zl;
  int xa, xb, y0, ny, ylo, first, last;
  const float* in;  // this sample's field or cotangent
  const float* h;   // its heights
  float* out;       // its output

  __device__ Strip(const float* in_, const float* hz, float* out_, int X_,
                   int Y_, int Zl_)
      : X(X_), Y(Y_), Zl(Zl_) {
    const int tiles_y = (Y + T::TY - 1) / T::TY;
    const int tiles = ((X + T::TX - 1) / T::TX) * tiles_y;
    const int n = (int)blockIdx.x / tiles, t = (int)blockIdx.x - n * tiles;
    xa = (t / tiles_y) * T::TX;
    xb = min(xa + T::TX, X);
    y0 = (t % tiles_y) * T::TY;
    ny = min(T::TY, Y - y0);
    ylo = max(y0 - 1, 0);
    first = max(xa - 1, 0);
    last = min(xb, X - 1);
    const size_t per = (size_t)X * Y * Zl;  // voxels of a sample
    in = in_ + n * per * CIN;
    h = hz + n * per;
    out = out_ + n * per * COUT;
  }

  __device__ int slot(int r) const { return (r - first) % T::RING; }
  // the staged run of input row r, from y = ylo (the y halo)
  __device__ const float* in_row(const float* s_in, int r) const {
    return s_in + slot(r) * T::in_pitch(Zl, CIN) +
           line_offset(in + (r * Y + ylo) * Zl * CIN);
  }
  // the staged heights of row r, from y = y0
  __device__ const float* h_row(const float* s_h, int r) const {
    return s_h + slot(r) * T::h_pitch(Zl) + line_offset(h + (r * Y + y0) * Zl);
  }
  // the output of row x in shared memory, from y = y0
  __device__ float* out_row(float* s_out, int x) const {
    return s_out + (x & 1) * T::out_pitch(Zl, COUT) +
           line_offset(out + (x * Y + y0) * Zl * COUT);
  }

  // Staging step k: issue the copies of row first + k, if it is one of the
  // strip's rows or its halo, and its heights if it is the strip's; then
  // commit them as one group (an empty one past the last row, so that the
  // count of groups in flight stays AHEAD).
  __device__ void stage(float* s_in, float* s_h, int k) const {
    const int r = first + k;
    if (r <= last) {
      const int yhi = min(y0 + ny, Y - 1);
      stage_run<T::NT>(s_in + slot(r) * T::in_pitch(Zl, CIN),
                       in + (r * Y + ylo) * Zl * CIN,
                       (yhi - ylo + 1) * Zl * CIN);
      if (r < xb && r >= xa)
        stage_run<T::NT>(s_h + slot(r) * T::h_pitch(Zl),
                         h + (r * Y + y0) * Zl, ny * Zl);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // The rows up to x + 1 staged, and row x + 1 + AHEAD on its way.
  __device__ void next(float* s_in, float* s_h, int x) const {
    stage(s_in, s_h, x + 1 + T::AHEAD - first);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(T::AHEAD) : "memory");
    __syncthreads();
  }

  __device__ void prologue(float* s_in, float* s_h) const {
    for (int k = 0; k < xa + 1 + T::AHEAD - first; ++k) stage(s_in, s_h, k);
  }

  __device__ void store(const float* s_out, int x) const {
    store_run<T::NT>(out + (x * Y + y0) * Zl * COUT,
                     s_out + (x & 1) * T::out_pitch(Zl, COUT),
                     ny * Zl * COUT);
  }
};

template <class T>
__global__ void __launch_bounds__(T::NT)
    grad_fwd_tile(const float* __restrict__ f, const float* __restrict__ hz,
                  const float* __restrict__ cxs,
                  const float* __restrict__ cys, float* __restrict__ out,
                  int X, int Y, int Zl) {
  extern __shared__ __align__(16) float smem[];
  const Strip<T, 3, 9> b(f, hz, out, X, Y, Zl);
  float* s_in = smem;
  float* s_h = s_in + T::RING * T::in_pitch(Zl, 3);
  float* s_out = s_h + T::RING * T::h_pitch(Zl);
  float* s_xc = s_out + 2 * T::out_pitch(Zl, 9);
  float* s_yc = s_xc + 3 * T::TX;
  b.prologue(s_in, s_h);
  // the strip's x and y coefficients while the first copies are in flight
  const int nx = b.xb - b.xa;
  for (int i = threadIdx.x; i < nx + b.ny; i += T::NT) {
    if (i < nx) {
      float* c = s_xc + 3 * i;
      coeffs(cxs, b.xa + i, X, c[0], c[1], c[2]);
    } else {
      float* c = s_yc + 3 * (i - nx);
      coeffs(cys, b.y0 + i - nx, Y, c[0], c[1], c[2]);
    }
  }

  const int col = Zl * 3;  // floats of one column of the field
  const uint32_t m_col = magic(Zl);
  for (int x = b.xa; x < b.xb; ++x) {
    b.next(s_in, s_h, x);
    // clamped neighbours: staged rows x +- 1, offsets in a row
    const float* fc = b.in_row(s_in, x);
    const float* fxp = b.in_row(s_in, min(x + 1, X - 1));
    const float* fxm = b.in_row(s_in, max(x - 1, 0));
    const float* hr = b.h_row(s_h, x);
    const float ax = s_xc[3 * (x - b.xa)], bx = s_xc[3 * (x - b.xa) + 1],
                cx = s_xc[3 * (x - b.xa) + 2];
    float* orow = b.out_row(s_out, x);
    for (int v = threadIdx.x; v < b.ny * Zl; v += T::NT) {
      const int yl = fdiv(v, m_col), z = v - yl * Zl, y = b.y0 + yl;
      const int j = ((y - b.ylo) * Zl + z) * 3;
      const int jyp = y < Y - 1 ? j + col : j, jym = y > 0 ? j - col : j;
      const int jzp = z < Zl - 1 ? j + 3 : j, jzm = z > 0 ? j - 3 : j;
      const float ay = s_yc[3 * yl], by = s_yc[3 * yl + 1],
                  cy = s_yc[3 * yl + 2];
      float az, bz, cz;
      coeffs(hr + yl * Zl, z, Zl, az, bz, cz);
      // all nine in registers before the first store, which the compiler
      // cannot tell apart from the rows it reads
      float r[9];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float f0 = fc[j + c];
        r[c] = ax * fxp[j + c] + bx * f0 + cx * fxm[j + c];
        r[3 + c] = ay * fc[jyp + c] + by * f0 + cy * fc[jym + c];
        r[6 + c] = az * fc[jzp + c] + bz * f0 + cz * fc[jzm + c];
      }
      float* o = orow + v * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) o[k] = r[k];
    }
    __syncthreads();
    b.store(s_out, x);
  }
}

template <class T>
__global__ void __launch_bounds__(T::NT)
    grad_adj_tile(const float* __restrict__ g, const float* __restrict__ hz,
                  const float* __restrict__ cxs,
                  const float* __restrict__ cys, float* __restrict__ out,
                  int X, int Y, int Zl) {
  extern __shared__ __align__(16) float smem[];
  const Strip<T, 9, 3> b(g, hz, out, X, Y, Zl);
  float* s_in = smem;
  float* s_h = s_in + T::RING * T::in_pitch(Zl, 9);
  float* s_out = s_h + T::RING * T::h_pitch(Zl);
  float* s_xc = s_out + 2 * T::out_pitch(Zl, 3);
  float* s_yc = s_xc + 3 * T::TX;
  float* s_zc = s_yc + 3 * T::TY;
  b.prologue(s_in, s_h);
  // (A_{i-1}, B_i, C_{i+1}) of the strip's x and y while the copies fly
  const int nx = b.xb - b.xa;
  for (int i = threadIdx.x; i < nx + b.ny; i += T::NT) {
    if (i < nx)
      adj_coeffs(cxs, b.xa + i, X, s_xc + 3 * i);
    else
      adj_coeffs(cys, b.y0 + i - nx, Y, s_yc + 3 * (i - nx));
  }

  const int col = Zl * 9;  // floats of one column of the cotangent
  const int nv = b.ny * Zl;
  const uint32_t m_col = magic(Zl);
  // each voxel's own z triple, once: row x's into s_zc[(x - xa) & 1],
  // computed beside row x - 1 (the first row's once its copies land)
  const int zc_rows = 3 * T::TY * Zl;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += T::NT) {
    const int yl = fdiv(v, m_col), z = v - yl * Zl;
    coeffs(b.h_row(s_h, b.xa) + yl * Zl, z, Zl, s_zc[3 * v],
           s_zc[3 * v + 1], s_zc[3 * v + 2]);
  }
  for (int x = b.xa; x < b.xb; ++x) {
    b.next(s_in, s_h, x);
    const float* zc = s_zc + ((x - b.xa) & 1) * zc_rows;
    // the next row's triples, in the same loop as this row's sums
    const bool more = x + 1 < b.xb;
    const float* hn = b.h_row(s_h, more ? x + 1 : x);
    float* zn = s_zc + ((x + 1 - b.xa) & 1) * zc_rows;
    const float* gc = b.in_row(s_in, x);
    const float* gxp = b.in_row(s_in, min(x + 1, X - 1));
    const float* gxm = b.in_row(s_in, max(x - 1, 0));
    const float axm = s_xc[3 * (x - b.xa)], bx0 = s_xc[3 * (x - b.xa) + 1],
                cxp = s_xc[3 * (x - b.xa) + 2];
    float* orow = b.out_row(s_out, x);
    for (int v = threadIdx.x; v < nv; v += T::NT) {
      const int yl = fdiv(v, m_col), z = v - yl * Zl, y = b.y0 + yl;
      const int j = ((y - b.ylo) * Zl + z) * 9;
      const int jyp = y < Y - 1 ? j + col : j, jym = y > 0 ? j - col : j;
      const int jzp = z < Zl - 1 ? j + 9 : j, jzm = z > 0 ? j - 9 : j;
      const float aym = s_yc[3 * yl], by0 = s_yc[3 * yl + 1],
                  cyp = s_yc[3 * yl + 2];
      // A_{z-1}, B_z, C_{z+1} from the staged triples (0 past the column)
      const float azm = z > 0 ? zc[3 * (v - 1)] : 0.f;
      const float bz0 = zc[3 * v + 1];
      const float czp = z < Zl - 1 ? zc[3 * (v + 1) + 2] : 0.f;
      float r[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // x: g channels 0..2, y: 3..5, z: 6..8; a zero coefficient meets
        // the clamped neighbour at the volume's faces
        float dx = bx0 * gc[j + c];
        dx = axm * gxm[j + c] + dx;
        dx = dx + cxp * gxp[j + c];
        float dy = by0 * gc[j + 3 + c];
        dy = aym * gc[jym + 3 + c] + dy;
        dy = dy + cyp * gc[jyp + 3 + c];
        float dz = bz0 * gc[j + 6 + c];
        dz = azm * gc[jzm + 6 + c] + dz;
        dz = dz + czp * gc[jzp + 6 + c];
        r[c] = (dx + dy) + dz;
      }
      float an, bn, cn;
      coeffs(hn + yl * Zl, z, Zl, an, bn, cn);
      float* o = orow + v * 3;  // after all loads: see the forward
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = r[c];
      if (more) {
        zn[3 * v] = an;
        zn[3 * v + 1] = bn;
        zn[3 * v + 2] = cn;
      }
    }
    __syncthreads();
    b.store(s_out, x);
  }
}

// The tiles, ranked on the card (PERF.md, section 6).
using GradTile = Tile<8, 32, 128, 1>;
using AdjTile = Tile<16, 32, 320, 1>;

// The launch of one kernel; `sized` is what setting its shared-memory
// attribute returned (once per kernel, by its caller).
template <class T, class K>
int launch(K kernel, cudaError_t sized, long long smem, const float* in,
           const float* hz, const float* x, const float* y, float* out, int N,
           int X, int Y, int Zl, cudaStream_t stream) {
  if (sized != cudaSuccess) return (int)sized;
  if (N < 1 || X < 2 || Y < 2 || Zl < 2 || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)N * ((X + T::TX - 1) / T::TX) *
                          ((Y + T::TY - 1) / T::TY);
  kernel<<<blocks, T::NT, (size_t)smem, stream>>>(in, hz, x, y, out, X, Y,
                                                  Zl);
  return (int)cudaGetLastError();
}

// Lets `kernel` take up to a block's whole shared memory.
template <class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
}

}  // namespace st

// f (N, X, Y, Zl, 3), hz (N, X, Y, Zl), x (X), y (Y) -> out (N, X, Y, Zl, 9)
extern "C" int windsr_wind_gradient(const void* f, const void* hz,
                                    const void* x, const void* y, void* out,
                                    int N, int X, int Y, int Zl,
                                    void* stream) {
  using T = st::GradTile;
  static const cudaError_t sized = st::allow_smem(st::grad_fwd_tile<T>);
  return st::launch<T>(
      st::grad_fwd_tile<T>, sized, T::smem_bytes(Zl, 3, 9, false),
      static_cast<const float*>(f), static_cast<const float*>(hz),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), N, X, Y, Zl, static_cast<cudaStream_t>(stream));
}

// g (N, X, Y, Zl, 9), hz, x, y as above -> out (N, X, Y, Zl, 3)
extern "C" int windsr_wind_gradient_adjoint(const void* g, const void* hz,
                                            const void* x, const void* y,
                                            void* out, int N, int X, int Y,
                                            int Zl, void* stream) {
  using T = st::AdjTile;
  static const cudaError_t sized = st::allow_smem(st::grad_adj_tile<T>);
  return st::launch<T>(
      st::grad_adj_tile<T>, sized, T::smem_bytes(Zl, 9, 3, true),
      static_cast<const float*>(g), static_cast<const float*>(hz),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), N, X, Y, Zl, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the forward's (adjoint = 0) or the adjoint's
// (1) tile at depth Zl, as the wrapper's plan counts it.
extern "C" long long windsr_stencil_smem(int adjoint, int Zl) {
  return adjoint ? st::AdjTile::smem_bytes(Zl, 9, 3, true)
                 : st::GradTile::smem_bytes(Zl, 3, 9, false);
}
