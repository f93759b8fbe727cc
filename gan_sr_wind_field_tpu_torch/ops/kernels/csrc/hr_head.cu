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
// Design. One implicit GEMM: rows x C output channels, reduced over k^3
// taps x the nf + tc channels of the virtual concat [x, t], all C
// channels in one launch, where the TPU kernel split them into a
// 128-channel main slice and a remainder for its 128-lane matrix unit.
// The TPU kernel's z-im2col, tap lane groups and rolling x-plane
// accumulator served its sequential grid and matrix unit and have no
// counterpart here.
//
// bf16 runs on the tensor cores (head_mma.cuh:head_wgmma, on
// trunk_mma.cuh's primitives): wgmma m64n144k16 with f32 accumulation. A
// block owns 256 rows x all 144 columns, so it reads the head's 5.18 MB of
// weights once (through L2): 4 warpgroups of 64 rows, each issuing one
// wgmma per k16 step with A (64 rows) from registers and B (16 x 144) from
// shared memory. Per (32-channel slice, dx) one window of 256 + 4(Z+1)
// input rows is read by its 25 taps; the weights of one (slice, dx, dy),
// 46 KB, stream through a 3-slot cp.async ring; t's 16 channels run one
// k16 step, not two. The float32 instantiation stays on the CUDA cores
// (trunk_gemm.cuh:conv_tile, f32 FMAs): the tensor cores take f32 only as
// TF32, which would break the float32 checks. k = 3 takes the same
// tensor-core tile in bf16.

#include "head_mma.cuh"
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

// float32 on the CUDA cores
int head_forward_f32(const float* x, const float* t, const float* w,
                     const float* dm, float* h, int N, int X, int Y, int Z,
                     int nf, int tc, int C, int k, float slope,
                     cudaStream_t stream) {
  const int rows = N * X * Y * Z;
  const dim3 grid((rows + BM - 1) / BM, (C + BN - 1) / BN);
  const dim3 block(THREADS);
  if (k == 5) {
    head_conv<float, 5><<<grid, block, 0, stream>>>(x, t, w, dm, nf, tc, C,
                                                    X, Y, Z, rows, slope, h);
  } else if (k == 3) {
    head_conv<float, 3><<<grid, block, 0, stream>>>(x, t, w, dm, nf, tc, C,
                                                    X, Y, Z, rows, slope, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------- bf16, on the tensor cores
using tc::bf16;
using HeadTile5 = hd::Tile<5>;
using HeadTile3 = hd::Tile<3>;

__global__ void __launch_bounds__(HeadTile5::THREADS, 1)
    tc_head5(tc::ConvArgs p, hd::HeadEpi epi) {
  hd::head_wgmma<HeadTile5>(p, epi);
}

__global__ void __launch_bounds__(HeadTile3::THREADS, 1)
    tc_head3(tc::ConvArgs p, hd::HeadEpi epi) {
  hd::head_wgmma<HeadTile3>(p, epi);
}

int head_forward_bf16(const bf16* x, const bf16* t, const bf16* w,
                      const bf16* dm, bf16* h, int N, int X, int Y, int Z,
                      int nf, int tc, int C, int k, int vec, float slope,
                      cudaStream_t stream) {
  if (k == 5) {
    return hd::head_forward<HeadTile5>(tc_head5, x, t, w, dm, h, N, X, Y, Z,
                                       nf, tc, C, vec, slope, stream);
  }
  if (k == 3) {
    return hd::head_forward<HeadTile3>(tc_head3, x, t, w, dm, h, N, X, Y, Z,
                                       nf, tc, C, vec, slope, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// h = dm * lrelu(conv_k(x) + conv_k(t)): x (N, X, Y, Z, nf), t (..., tc),
// w (k^3, nf + tc, C), dm (N, C) or null, h (..., C). vec is the bf16
// plan's copy width in channels; float32 ignores it. Returns the launch's
// CUDA error, or 0.
extern "C" int windsr_hr_head_f32(const void* x, const void* t, const void* w,
                                  const void* dm, void* h, int N, int X,
                                  int Y, int Z, int nf, int tc, int C, int k,
                                  int vec, float slope, void* stream) {
  (void)vec;
  return head_forward_f32(
      static_cast<const float*>(x), static_cast<const float*>(t),
      static_cast<const float*>(w), static_cast<const float*>(dm),
      static_cast<float*>(h), N, X, Y, Z, nf, tc, C, k, slope,
      static_cast<cudaStream_t>(stream));
}

extern "C" int windsr_hr_head_bf16(const void* x, const void* t,
                                   const void* w, const void* dm, void* h,
                                   int N, int X, int Y, int Z, int nf, int tc,
                                   int C, int k, int vec, float slope,
                                   void* stream) {
  return head_forward_bf16(
      static_cast<const bf16*>(x), static_cast<const bf16*>(t),
      static_cast<const bf16*>(w), static_cast<const bf16*>(dm),
      static_cast<bf16*>(h), N, X, Y, Z, nf, tc, C, k, vec, slope,
      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the bf16 tile for kernel size k at depth Z, as
// the wrapper's plan counts it; -1 if there is no such tile.
extern "C" long long windsr_hr_head_tc_smem(int k, int Z) {
  if (k == 5) return (long long)HeadTile5::smem_bytes(Z);
  if (k == 3) return (long long)HeadTile3::smem_bytes(Z);
  return -1;
}
