// Implicit-GEMM tile on the CUDA cores, shared by the HR head (hr_head.cu)
// and the float32 instantiations of the RRDB trunk kernels (rdb_trunk.cu,
// the forward, and rdb_trunk_bwd.cu, the backward-dx). The bf16 trunk runs
// on the tensor cores instead (trunk_mma.cuh).
//
// A conv over channels-last rows (R = X*Y*Z rows per sample, z fastest)
// is a GEMM: rows x output channels, reduced over taps x input channels.
// A block owns a BM-row x BN-column output tile; for each tap and each
// BK-channel slice of the input it gathers the shifted input rows
// (zeros outside the volume) and the matching weight slice into shared
// memory, then each of the THREADS threads accumulates a 4x4 register tile
// with f32 FMAs on the CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace windsr {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 32;        // output channels per block
constexpr int BK = 32;        // input channels per reduction step
constexpr int THREADS = 128;  // 16 row groups x 8 channel groups, 4x4 each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the storage type, as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// Accumulates the output tile (rows row0 .. row0+BM, columns o0 .. o0+BN)
// of one conv into acc: thread (ty, tx) = (tid / 8, tid % 8) owns rows
// row0 + 4*ty .. +3 and columns o0 + 4*tx .. +3.
//   Input channel c of row r is a0[r*s0 + c] for c < n0, else
//   a1[r*s1 + c - n0] (a virtual concat of two buffers), zero where the
//   tap leaves the volume.
//   KS is the odd kernel size: w is (KS^3, cin, cout), taps x-major
//   (t = (dx+hp)*KS^2 + (dy+hp)*KS + (dz+hp), hp = (KS-1)/2, row offset
//   dx*Y*Z + dy*Z + dz); KS = 1 is a 1x1x1 conv, w (cin, cout).
// a1 may alias the buffer the caller's epilogue writes; a0 may not.
template <typename T, int KS>
__device__ __forceinline__ void conv_tile(
    const T* __restrict__ a0, int n0, int s0, const T* a1, int s1,
    const T* __restrict__ w, int cin, int cout, int X, int Y, int Z,
    int rows, int row0, int o0, float (&acc)[4][4]) {
  __shared__ float As[BM][BK + 1];            // [row][channel], padded
  __shared__ __align__(16) float Bs[BK][BN];  // [channel][out]
  __shared__ int sx[BM], sy[BM], sz[BM];      // coordinates of the rows
  static_assert(KS % 2 == 1, "odd kernel sizes only");
  constexpr int HP = (KS - 1) / 2;
  constexpr int TAPS = KS * KS * KS;

  const int tid = threadIdx.x;
  const int YZ = Y * Z;
  const int R = X * YZ;

  if (tid < BM) {
    const int r = row0 + tid;
    if (r < rows) {
      const int rem = r % R;
      sx[tid] = rem / YZ;
      sy[tid] = (rem / Z) % Y;
      sz[tid] = rem % Z;
    } else {
      sx[tid] = -KS;  // -KS + HP < 0: never inside the volume, any tap
      sy[tid] = 0;
      sz[tid] = 0;
    }
  }

  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int lane = tid & 31;
  const int warp = tid >> 5;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  __syncthreads();

  for (int t = 0; t < TAPS; ++t) {
    const int dx = t / (KS * KS) - HP;
    const int dy = (t / KS) % KS - HP;
    const int dz = t % KS - HP;
    const int shift = dx * YZ + dy * Z + dz;
    const T* wt = w + (size_t)t * cin * cout;

    for (int c0 = 0; c0 < cin; c0 += BK) {
      // A: each warp gathers whole rows, one channel per lane (coalesced)
      const int c = c0 + lane;
#pragma unroll 4
      for (int i = 0; i < BM / 4; ++i) {
        const int rl = warp + 4 * i;
        const int x = sx[rl] + dx, y = sy[rl] + dy, z = sz[rl] + dz;
        float v = 0.f;
        if (c < cin && x >= 0 && x < X && y >= 0 && y < Y && z >= 0 &&
            z < Z) {
          const size_t src = (size_t)(row0 + rl + shift);
          v = c < n0 ? to_f(a0[src * s0 + c])
                     : to_f(a1[src * s1 + (c - n0)]);
        }
        As[rl][lane] = v;
      }
      // B: the weight slice [c0, c0 + BK) x [o0, o0 + BN)
#pragma unroll
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = tid + THREADS * i;
        const int k = e / BN, o = e % BN;
        const int ck = c0 + k, oo = o0 + o;
        Bs[k][o] = (ck < cin && oo < cout) ? to_f(wt[(size_t)ck * cout + oo])
                                           : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = As[4 * ty + i][k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace windsr
