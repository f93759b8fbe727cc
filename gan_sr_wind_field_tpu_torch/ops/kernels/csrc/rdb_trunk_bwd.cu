// RRDB trunk backward-dx for NVIDIA Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel gan_sr_wind_field_tpu/ops/pallas/rdb_trunk.py:
// fused_rrdb_trunk_bwd -> _trunk_bwd_kernel.
//
// What it computes. Given the growths g (J, rows, K*gc) that the forward
// saved (rdb_trunk.cu, residual mode) and the cotangent of the trunk
// output, it runs back over the RDBs j = J-1 .. 0 and emits the cotangent
// of the trunk input plus, per RDB, the cotangents of the growth convs'
// pre-activations dU[j] (rows, K*gc) and of the LFF output dLFF[j]
// (rows, nf), which the weight-gradient stage contracts against the saved
// states and growths. Per RDB, with ds the running cotangent:
//   (a) at an RRDB end, pend = ds and d_r = ds * rrdb_scale, else d_r = ds;
//       d_lff = d_r * rdb_scale -> dLFF[j];
//       d_catl = d_lff @ WlT (nf -> nf + K*gc);
//       ds = d_r + d_catl[:, :nf], dg = d_catl[:, nf:];
//   (b) for k = K-1 .. 0: d_u = dg[:, k] * (g_k >= 0 ? 1 : slope) -> dU[j];
//       the transposed 3x3x3 conv of d_u into nf + gc*k channels adds its
//       first nf channels into ds and the rest into dg[:, :gc*k];
//   (c) at an RRDB start, ds += pend.
// The LeakyReLU slope is recovered from the sign of the stored growth, so
// the slope must be > 0 (the wrapper checks).
//
// Rounding points follow the TPU kernel (rdb_trunk.py:438-521): products
// accumulate in f32; d_r, d_lff, ds and dg are held in the storage type;
// each conv's contribution is rounded to the storage type before it is
// added; the slope mask is formed in f32 from the stored growth and
// rounded. Storage is float or __nv_bfloat16.
//
// Bound. The same multiply-adds as the forward: at the training batch of
// 32 (LR 16x16x10, nf=128, gc=32, K=4, J=48) 81920 rows x 48 x
// (27*32*704 + 128*256) = 2.52e12 MACs = 5.04e12 FLOP, 5.10 ms at 989
// TFLOP/s dense bf16; it reads the growths (1.01 GB of bf16) and writes
// dU and dLFF (1.01 GB each), ~3.0 GB, 0.90 ms at 3.35 TB/s. Bound by
// operations.
//
// Design of this first version. The TPU kernel's lane-aligned du9 gather
// and its per-dx output rolls are layouts for the MXU and are not carried
// over. A host loop runs the RDBs in reverse on one stream. The LFF
// transpose is one implicit GEMM (reduction nf); each transposed growth
// conv is the same implicit GEMM as the forward's (trunk_gemm.cuh), over
// d_u with the taps flipped and the weight's in/out swapped (packed by the
// wrapper as (27, gc, nf + gc*k)), so its gather reads d_u at
// row - offset, with zeros outside the volume. Each output element of ds
// and dg belongs to one thread, which updates it in place. The small
// elementwise steps (a), the slope mask and (c) are kernels of their own.
// Like the forward, it runs on the CUDA cores; the tensor cores are the
// work of a later version.

#include "trunk_gemm.cuh"

namespace {

using namespace windsr;

enum Epilogue { kLffBack = 0, kConvBack = 1 };

// ds (rows, nf) += the first nf output channels, rounded; the rest go to
// dg (rows, gct): overwritten (kLffBack) or accumulated (kConvBack).
template <typename T, int KS, int MODE>
__global__ void __launch_bounds__(THREADS)
    bwd_conv(const T* __restrict__ a, int s_a, const T* __restrict__ w,
             int cin, int cout, int X, int Y, int Z, int rows, int nf,
             int gct, T* __restrict__ ds, T* __restrict__ dg) {
  const int row0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  float acc[4][4];
  conv_tile<T, KS>(a, cin, s_a, a, s_a, w, cin, cout, X, Y, Z, rows, row0,
                   o0, acc);

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o >= cout) continue;
      const float v = rnd<T>(acc[i][j]);
      if (o < nf) {
        T* p = ds + (size_t)r * nf + o;
        *p = from_f<T>(to_f(*p) + v);
      } else {
        T* p = dg + (size_t)r * gct + (o - nf);
        *p = MODE == kLffBack ? from_f<T>(v) : from_f<T>(to_f(*p) + v);
      }
    }
  }
}

// (a) before the LFF transpose: ds -> d_r (in place), d_lff -> dlff, and at
// an RRDB end the pending skip cotangent pend = ds.
template <typename T>
__global__ void bwd_prep(T* __restrict__ ds, T* __restrict__ pend,
                         T* __restrict__ dlff, size_t n, float rdb_scale,
                         float rrdb_scale, int rrdb_end) {
  const float s1 = rnd<T>(rdb_scale);
  const float s2 = rnd<T>(rrdb_scale);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float d = to_f(ds[i]);
    if (rrdb_end) {
      pend[i] = ds[i];
      d = rnd<T>(d * s2);
    }
    dlff[i] = from_f<T>(d * s1);
    ds[i] = from_f<T>(d);
  }
}

// (b) d_u = dg[:, k] * (g_k >= 0 ? 1 : slope), stored into du[:, k]
template <typename T>
__global__ void bwd_mask(const T* __restrict__ dg, const T* __restrict__ g,
                         T* __restrict__ du, int rows, int gc, int gct,
                         int k, float slope) {
  const float sl = rnd<T>(slope);
  const size_t n = (size_t)rows * gc;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t idx = (i / gc) * gct + (size_t)k * gc + i % gc;
    const float m = to_f(g[idx]) >= 0.f ? 1.f : sl;
    du[idx] = from_f<T>(to_f(dg[idx]) * m);
  }
}

// (c) ds += pend
template <typename T>
__global__ void bwd_add(T* __restrict__ ds, const T* __restrict__ pend,
                        size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    ds[i] = from_f<T>(to_f(ds[i]) + to_f(pend[i]));
  }
}

inline int ew_blocks(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 8192 ? b : 8192);
}

// The whole backward on `stream`. wconv_t holds, per RDB j and growth conv
// k, the transposed kernel (27, gc, nf + gc*k) with flipped taps; wlff_t is
// (J, nf, nf + K*gc). dx doubles as the running cotangent. scratch holds
// pend (rows x nf) then dg (rows x K*gc). Returns the first CUDA error, or 0.
template <typename T>
int trunk_backward(const T* growths, const T* dout, const T* wconv_t,
                   const T* wlff_t, T* dx, T* dU, T* dLFF, T* scratch, int N,
                   int X, int Y, int Z, int nf, int gc, int num_convs, int J,
                   int per, float rdb_scale, float rrdb_scale, float slope,
                   cudaStream_t stream) {
  const int rows = N * X * Y * Z;
  const int K = num_convs - 1;
  const int gct = gc * K;
  const size_t S = (size_t)rows * nf;
  const size_t G = (size_t)rows * gct;
  T* pend = scratch;
  T* dg = scratch + S;
  cudaError_t e = cudaMemcpyAsync(dx, dout, S * sizeof(T),
                                  cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(pend, 0, S * sizeof(T), stream);
  if (e != cudaSuccess) return (int)e;

  size_t per_rdb = 0;  // transposed conv weights of one RDB
  for (int k = 0; k < K; ++k) per_rdb += (size_t)27 * gc * (nf + gc * k);
  const dim3 block(THREADS);
  const int row_blocks = (rows + BM - 1) / BM;

  for (int j = J - 1; j >= 0; --j) {
    const int rrdb_end = (j % per) == per - 1;
    T* dlff_j = dLFF + j * S;
    T* du_j = dU + j * G;
    bwd_prep<T><<<ew_blocks(S), 256, 0, stream>>>(dx, pend, dlff_j, S,
                                                  rdb_scale, rrdb_scale,
                                                  rrdb_end);
    bwd_conv<T, 1, kLffBack>
        <<<dim3(row_blocks, (nf + gct + BN - 1) / BN), block, 0, stream>>>(
            dlff_j, nf, wlff_t + (size_t)j * nf * (nf + gct), nf, nf + gct,
            X, Y, Z, rows, nf, gct, dx, dg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int k = K - 1; k >= 0; --k) {
      size_t off = j * per_rdb;
      for (int kk = 0; kk < k; ++kk) off += (size_t)27 * gc * (nf + gc * kk);
      const int cout = nf + gc * k;
      bwd_mask<T><<<ew_blocks((size_t)rows * gc), 256, 0, stream>>>(
          dg, growths + j * G, du_j, rows, gc, gct, k, slope);
      bwd_conv<T, 3, kConvBack>
          <<<dim3(row_blocks, (cout + BN - 1) / BN), block, 0, stream>>>(
              du_j + k * gc, gct, wconv_t + off, gc, cout, X, Y, Z, rows, nf,
              gct, dx, dg);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    if (j % per == 0) {
      bwd_add<T><<<ew_blocks(S), 256, 0, stream>>>(dx, pend, S);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

}  // namespace

#define WINDSR_TRUNK_BWD_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* growths, const void* dout,                 \
                      const void* wconv_t, const void* wlff_t, void* dx,     \
                      void* dU, void* dLFF, void* scratch, int N, int X,     \
                      int Y, int Z, int nf, int gc, int num_convs, int J,    \
                      int per, float rdb_scale, float rrdb_scale,            \
                      float slope, void* stream) {                           \
    return trunk_backward<T>(                                                \
        static_cast<const T*>(growths), static_cast<const T*>(dout),         \
        static_cast<const T*>(wconv_t), static_cast<const T*>(wlff_t),       \
        static_cast<T*>(dx), static_cast<T*>(dU), static_cast<T*>(dLFF),     \
        static_cast<T*>(scratch), N, X, Y, Z, nf, gc, num_convs, J, per,     \
        rdb_scale, rrdb_scale, slope, static_cast<cudaStream_t>(stream));    \
  }

WINDSR_TRUNK_BWD_ENTRY(windsr_rrdb_trunk_bwd_f32, float)
WINDSR_TRUNK_BWD_ENTRY(windsr_rrdb_trunk_bwd_bf16, __nv_bfloat16)
