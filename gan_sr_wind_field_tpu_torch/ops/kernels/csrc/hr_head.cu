// HR head conv (hr_conv0) for NVIDIA Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel gan_sr_wind_field_tpu/ops/pallas/hr_head.py:
// hr_head_main -> _head_kernel, the forward of the custom VJP hr_head.
//
// What it computes. For the upsampled features x (N, X, Y, Z, nf) and the
// terrain features t (N, X, Y, Z, tc), channels-last, and the bias-free
// weights of hr_conv0_x and hr_conv0_t packed as one (k^3, nf + tc, C)
// tensor (taps x-major, input channels of x first):
//
//   h = dm * lrelu(conv_k(x; Wx) + conv_k(t; Wt))
//
// with zero SAME padding at all six faces. Both convs and all k^3 taps
// accumulate into one f32 sum, LeakyReLU runs in f32, the per-(sample,
// channel) dropout scale dm (N, C), in the storage type, multiplies in
// f32 and the product is rounded once to the storage type, as the TPU
// kernel does (hr_head.py:175-179). With no scale (dm == nullptr) it is 1.
// Storage is float or __nv_bfloat16.
//
// Bound. At milestone9k (k = 5, nf = 128, tc = 16, C = 144) every HR voxel
// costs 125 * 144 * 144 MACs = 5.18 MFLOP against 2 * (144 + 144) bytes
// of bf16 in and out: about 9,000 operations per byte, so the head is
// bound by operations, 6.87 ms at batch 32 at the card's dense bf16
// tensor-core peak (989 TFLOP/s).
//
// Design of this first version: one implicit GEMM (rows x C output
// channels, reduced over k^3 taps x the nf + tc channels of the virtual
// concat [x, t]) through the trunk's tile (trunk_gemm.cuh:conv_tile) on
// the CUDA cores with f32 FMAs. The grid is (row tiles, column tiles); all
// C output channels come out of one kernel, 4.5 column tiles of 32 at
// C = 144, where the TPU kernel split them into a 128-channel main slice
// and a remainder for its 128-lane matrix unit. The TPU kernel's z-im2col,
// tap lane groups and rolling x-plane accumulator served its sequential
// grid and matrix unit and have no counterpart here. Tensor cores (wgmma
// fed by TMA) are the work of a later version.

#include "trunk_gemm.cuh"

namespace {

using namespace windsr;

template <typename T, int KS>
__global__ void __launch_bounds__(THREADS)
    head_conv(const T* __restrict__ x, const T* __restrict__ t,
              const T* __restrict__ w, const T* __restrict__ dm, int nf,
              int tc, int C, int X, int Y, int Z, int rows, float slope,
              T* __restrict__ h) {
  const int row0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  float acc[4][4];
  conv_tile<T, KS>(x, nf, nf, t, tc, w, nf + tc, C, X, Y, Z, rows, row0, o0,
                   acc);

  const int R = X * Y * Z;
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= rows) continue;
    const int n = r / R;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o >= C) continue;
      float v = acc[i][j];
      v = v >= 0.f ? v : v * slope;
      if (dm != nullptr) v *= to_f(dm[(size_t)n * C + o]);
      h[(size_t)r * C + o] = from_f<T>(v);
    }
  }
}

template <typename T>
int head_forward(const T* x, const T* t, const T* w, const T* dm, T* h,
                 int N, int X, int Y, int Z, int nf, int tc, int C, int k,
                 float slope, cudaStream_t stream) {
  const int rows = N * X * Y * Z;
  const dim3 grid((rows + BM - 1) / BM, (C + BN - 1) / BN);
  const dim3 block(THREADS);
  if (k == 5) {
    head_conv<T, 5><<<grid, block, 0, stream>>>(x, t, w, dm, nf, tc, C, X, Y,
                                                Z, rows, slope, h);
  } else if (k == 3) {
    head_conv<T, 3><<<grid, block, 0, stream>>>(x, t, w, dm, nf, tc, C, X, Y,
                                                Z, rows, slope, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define WINDSR_HEAD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* x, const void* t, const void* w,           \
                      const void* dm, void* h, int N, int X, int Y, int Z,   \
                      int nf, int tc, int C, int k, float slope,             \
                      void* stream) {                                        \
    return head_forward<T>(                                                  \
        static_cast<const T*>(x), static_cast<const T*>(t),                  \
        static_cast<const T*>(w), static_cast<const T*>(dm),                 \
        static_cast<T*>(h), N, X, Y, Z, nf, tc, C, k, slope,                 \
        static_cast<cudaStream_t>(stream));                                  \
  }

WINDSR_HEAD_ENTRY(windsr_hr_head_f32, float)
WINDSR_HEAD_ENTRY(windsr_hr_head_bf16, __nv_bfloat16)
