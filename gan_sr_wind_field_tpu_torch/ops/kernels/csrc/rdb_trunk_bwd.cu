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
// Design. A host loop runs the RDBs in reverse on one stream. The TPU
// kernel's lane-aligned du9 gather and its per-dx output rolls are layouts
// for the MXU and are not carried over. The LFF transpose is one implicit
// GEMM (reduction nf); each transposed growth conv is a forward 3x3x3 conv
// over d_u with the taps flipped and the weight's in/out swapped (packed
// by the wrapper as (27, gc, nf + gc*k)), so it reads d_u at row - offset,
// with zeros outside the volume. Each output element of ds and dg belongs
// to one thread, which updates it in place. The small elementwise steps
// (a), the slope mask and (c) are kernels of their own.
//
// bf16 runs on the tensor cores (trunk_mma.cuh: mma.sync m16n8k16, f32
// accumulate, ldmatrix from swizzled shared memory, a cp.async ring), with
// tiles that own all output columns of their rows, since both GEMMs are
// wide over a short reduction: they keep their input windows in shared
// memory and stream only the weights, column chunk by column chunk.
//   transposed growth conv (N = nf + gc k = 128..224, K = 27 gc = 864):
//     256 rows per block, 8 warps of 32 x 32, keeps the three dx windows
//     of the one 32-channel slice of d_u, 3-slot ring of weights, 4 to 7
//     chunks of 32 columns;
//   LFF transpose (N = nf + gc K = 256, K = nf = 128, no halo): 128 rows
//     per block, 4 warps of 32 x 64, keeps the 4 slices, 4-slot ring, 4
//     chunks of 64 columns.
// The slope mask of step (b) runs in the epilogue of the conv that
// completes dg[:, k] (the LFF transpose for k = K-1, growth conv k+1
// otherwise), on the value it has just rounded, so it is no launch of its
// own. What bounds it on this card: as for the forward, the ldmatrix and
// address work per mma.sync and the copies each thread issues, plus each
// chunk's read-modify-write of ds and dg, and the two elementwise kernels
// (a) and (c). The float32 instantiations stay on the CUDA cores
// (trunk_gemm.cuh), with the mask as a kernel of its own.

#include <type_traits>

#include "trunk_gemm.cuh"
#include "trunk_mma.cuh"

namespace {

using namespace windsr;

enum Epilogue { kLffBack = 0, kConvBack = 1 };

// ds (rows, nf) += the first nf output channels, rounded; the rest go to
// dg (rows, gct): overwritten (kLffBack) or accumulated (kConvBack). The
// float32 path, on the CUDA cores.
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

// ---------------------------------------------- bf16, on the tensor cores
using tc::bf16;
using tc::ld2;
using tc::st2;
using GrowthTile = tc::Tile<3, 256, 32, 8, 1, 3, true>;
using LffTile = tc::Tile<1, 128, 64, 4, 1, 4, true>;

// The conv's contribution rounded, then added into ds (first nf channels)
// or into dg (overwritten by the LFF transpose, accumulated by the growth
// convs). The conv that writes dg[:, lo:hi] last also applies the slope
// mask there (step (b) of the next growth conv): d_u = dg * (g >= 0 ? 1 :
// slope), rounded, into du, from the value it has just stored.
template <int MODE>
struct BwdEpi {
  bf16* ds;
  bf16* dg;
  const bf16* g;
  bf16* du;  // also read, another chunk, as the conv's input
  int nf, gct, lo, hi;
  float slope;

  __device__ float masked(float nv, float gv) const {
    return nv * (gv >= 0.f ? 1.f : rnd<bf16>(slope));
  }

  // one column at a time, for odd channel counts
  __device__ void elem(int r, int o, float acc) const {
    const float v = rnd<bf16>(acc);
    if (o < nf) {
      bf16* p = ds + (size_t)r * nf + o;
      *p = from_f<bf16>(to_f(*p) + v);
      return;
    }
    const int c = o - nf;
    const size_t i = (size_t)r * gct + c;
    const float nv = MODE == kLffBack ? v : rnd<bf16>(to_f(dg[i]) + v);
    dg[i] = from_f<bf16>(nv);
    if (c >= lo && c < hi) du[i] = from_f<bf16>(masked(nv, to_f(g[i])));
  }

  template <int NT>
  __device__ void row(int r, int ob, const float (&v)[NT][2], int cout,
                      bool pairs) const {
    if (!pairs) {  // a pair may straddle nf, lo or hi
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ob + 8 * j + e < cout) elem(r, ob + 8 * j + e, v[j][e]);
      return;
    }
    bf16* dsr = ds + (size_t)r * nf;
    const size_t g0 = (size_t)r * gct;  // row r of dg, g and du
    float2 cur[NT], gv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = ob + 8 * j, c = o - nf;
      if (o >= cout) continue;
      if (o < nf) {
        cur[j] = ld2(dsr, o, nf, true);
      } else {
        if (MODE != kLffBack) cur[j] = ld2(dg + g0, c, gct, true);
        if (c >= lo && c < hi) gv[j] = ld2(g + g0, c, gct, true);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = ob + 8 * j, c = o - nf;
      if (o >= cout) continue;
      const float a = rnd<bf16>(v[j][0]), b = rnd<bf16>(v[j][1]);
      if (o < nf) {
        st2(dsr, o, nf, true, cur[j].x + a, cur[j].y + b);
        continue;
      }
      const float na = MODE == kLffBack ? a : rnd<bf16>(cur[j].x + a);
      const float nb = MODE == kLffBack ? b : rnd<bf16>(cur[j].y + b);
      st2(dg + g0, c, gct, true, na, nb);
      if (c >= lo && c < hi) {
        st2(du + g0, c, gct, true, masked(na, gv[j].x), masked(nb, gv[j].y));
      }
    }
  }
};

__global__ void __launch_bounds__(GrowthTile::THREADS)
    tc_growth_bwd(tc::ConvArgs p, BwdEpi<kConvBack> epi) {
  tc::conv_mma<GrowthTile>(p, epi);
}

__global__ void __launch_bounds__(LffTile::THREADS)
    tc_lff_bwd(tc::ConvArgs p, BwdEpi<kLffBack> epi) {
  tc::conv_mma<LffTile>(p, epi);
}

// The launches of one backward: float32 on conv_tile with the slope mask
// as a kernel of its own, bf16 on the tensor cores with the mask in the
// epilogues (copies of vec channels).
template <typename T>
struct BackLauncher {
  int X, Y, Z, rows, nf, gc, gct, vec;
  cudaStream_t stream;

  int prepare() { return 0; }

  // LFF transpose of d (rows, nf) into ds and dg
  int lff(const T* d, const T* w, T* ds, T* dg, const T*, T*, float) {
    const dim3 grid((rows + BM - 1) / BM, (nf + gct + BN - 1) / BN);
    bwd_conv<T, 1, kLffBack><<<grid, THREADS, 0, stream>>>(
        d, nf, w, nf, nf + gct, X, Y, Z, rows, nf, gct, ds, dg);
    return (int)cudaGetLastError();
  }

  // step (b) for growth conv k: mask dg[:, k] into du[:, k], then the
  // transposed conv of du[:, k] into ds and dg[:, :gc*k]
  int growth(int k, const T* w, T* ds, T* dg, const T* g, T* du,
             float slope) {
    bwd_mask<T><<<ew_blocks((size_t)rows * gc), 256, 0, stream>>>(
        dg, g, du, rows, gc, gct, k, slope);
    const int cout = nf + gc * k;
    const dim3 grid((rows + BM - 1) / BM, (cout + BN - 1) / BN);
    bwd_conv<T, 3, kConvBack><<<grid, THREADS, 0, stream>>>(
        du + k * gc, gct, w, gc, cout, X, Y, Z, rows, nf, gct, ds, dg);
    return (int)cudaGetLastError();
  }
};

template <>
struct BackLauncher<bf16> {
  int X, Y, Z, rows, nf, gc, gct, vec;
  cudaStream_t stream;

  int prepare() {
    return tc::allow_smem(tc_growth_bwd) && tc::allow_smem(tc_lff_bwd)
               ? 0
               : (int)cudaErrorInvalidValue;
  }

  int lff(const bf16* d, const bf16* w, bf16* ds, bf16* dg, const bf16* g,
          bf16* du, float slope) {
    const tc::ConvArgs p{d, d, w, nf, nf, nf, nf, nf + gct, X, Y, Z, rows,
                         vec};
    const BwdEpi<kLffBack> epi{ds, dg, g, du, nf, gct, gct - gc, gct, slope};
    return tc::launch<LffTile>(tc_lff_bwd, p, epi, stream);
  }

  int growth(int k, const bf16* w, bf16* ds, bf16* dg, const bf16* g,
             bf16* du, float slope) {
    const tc::ConvArgs p{du + k * gc, du + k * gc, w, gc, gct, gct, gc,
                         nf + gc * k, X, Y, Z, rows, vec};
    // dg[:, k-1] is complete after this conv: mask it for conv k - 1
    const BwdEpi<kConvBack> epi{ds, dg, g, du, nf, gct, gc * (k - 1),
                                k > 0 ? gc * k : 0, slope};
    return tc::launch<GrowthTile>(tc_growth_bwd, p, epi, stream);
  }
};

// The whole backward on `stream`. wconv_t holds, per RDB j and growth conv
// k, the transposed kernel (27, gc, nf + gc*k) with flipped taps; wlff_t is
// (J, nf, nf + K*gc). dx doubles as the running cotangent. scratch holds
// pend (rows x nf) then dg (rows x K*gc). vec is the bf16 plan's copy
// width in channels; float32 ignores it. Returns the first CUDA error, or
// 0.
template <typename T>
int trunk_backward(const T* growths, const T* dout, const T* wconv_t,
                   const T* wlff_t, T* dx, T* dU, T* dLFF, T* scratch, int N,
                   int X, int Y, int Z, int nf, int gc, int num_convs, int J,
                   int per, float rdb_scale, float rrdb_scale, float slope,
                   int vec, cudaStream_t stream) {
  const int rows = N * X * Y * Z;
  const int K = num_convs - 1;
  const int gct = gc * K;
  const size_t S = (size_t)rows * nf;
  const size_t G = (size_t)rows * gct;
  T* pend = scratch;
  T* dg = scratch + S;
  if (std::is_same<T, bf16>::value) {
    const void* ptrs[] = {growths, dout, wconv_t, wlff_t, dx, dU, dLFF,
                          scratch};
    const int counts[] = {nf, gc};
    if (!tc::aligned(vec, ptrs, 8, counts, 2)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  BackLauncher<T> launch{X, Y, Z, rows, nf, gc, gct, vec, stream};
  int rc = launch.prepare();
  if (rc != 0) return rc;
  cudaError_t e = cudaMemcpyAsync(dx, dout, S * sizeof(T),
                                  cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(pend, 0, S * sizeof(T), stream);
  if (e != cudaSuccess) return (int)e;

  size_t per_rdb = 0;  // transposed conv weights of one RDB
  for (int k = 0; k < K; ++k) per_rdb += (size_t)27 * gc * (nf + gc * k);

  for (int j = J - 1; j >= 0; --j) {
    const int rrdb_end = (j % per) == per - 1;
    T* dlff_j = dLFF + j * S;
    T* du_j = dU + j * G;
    const T* g_j = growths + j * G;
    bwd_prep<T><<<ew_blocks(S), 256, 0, stream>>>(dx, pend, dlff_j, S,
                                                  rdb_scale, rrdb_scale,
                                                  rrdb_end);
    rc = launch.lff(dlff_j, wlff_t + (size_t)j * nf * (nf + gct), dx, dg,
                    g_j, du_j, slope);
    if (rc != 0) return rc;
    for (int k = K - 1; k >= 0; --k) {
      size_t off = j * per_rdb;
      for (int kk = 0; kk < k; ++kk) off += (size_t)27 * gc * (nf + gc * kk);
      rc = launch.growth(k, wconv_t + off, dx, dg, g_j, du_j, slope);
      if (rc != 0) return rc;
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
                      int per, int vec, float rdb_scale, float rrdb_scale,   \
                      float slope, void* stream) {                           \
    return trunk_backward<T>(                                                \
        static_cast<const T*>(growths), static_cast<const T*>(dout),         \
        static_cast<const T*>(wconv_t), static_cast<const T*>(wlff_t),       \
        static_cast<T*>(dx), static_cast<T*>(dU), static_cast<T*>(dLFF),     \
        static_cast<T*>(scratch), N, X, Y, Z, nf, gc, num_convs, J, per,     \
        rdb_scale, rrdb_scale, slope, vec,                                   \
        static_cast<cudaStream_t>(stream));                                  \
  }

WINDSR_TRUNK_BWD_ENTRY(windsr_rrdb_trunk_bwd_f32, float)
WINDSR_TRUNK_BWD_ENTRY(windsr_rrdb_trunk_bwd_bf16, __nv_bfloat16)

// Dynamic shared memory of a bf16 tile (conv 0: transposed growth conv,
// conv 1: LFF transpose) at depth Z for cin input channels, as the
// wrapper's plan counts it; -1 if there is no such tile.
extern "C" long long windsr_rrdb_trunk_bwd_tc_smem(int conv, int Z, int cin) {
  if (conv == 0) return (long long)GrowthTile::smem_bytes(Z, cin);
  if (conv == 1) return (long long)LffTile::smem_bytes(Z, cin);
  return -1;
}
