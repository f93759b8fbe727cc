// RRDB trunk forward for NVIDIA Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel gan_sr_wind_field_tpu/ops/pallas/rdb_trunk.py:
// fused_rrdb_trunk -> _trunk_kernel (the forward, with_residuals=False).
//
// What it computes. The state is channels-last (N, R, nf), R = X*Y*Z rows
// with z fastest. J = 3 * num_rrdb residual dense blocks (RDBs) run in
// order. Each RDB runs K = num_convs - 1 dense 3x3x3 growth convs (gc
// outputs each, no bias, zero SAME padding at all six faces) over the
// growing concat [state, g_1 .. g_k], each followed by LeakyReLU; then a
// 1x1x1 local-feature fusion (LFF, nf + K*gc -> nf, with bias) and
// new = state + rdb_scale * lff. The last RDB of every RRDB also adds the
// outer residual: new = rrdb_in + rrdb_scale * new.
//
// Rounding points follow the TPU kernel (rdb_trunk.py:215-258): products
// accumulate in f32; LeakyReLU runs in f32 and then rounds to the storage
// type; the LFF sum (+ bias, in f32) rounds to the storage type before the
// x0.2 scaling and the residual adds, which each round to the storage type.
// The scales are themselves rounded to the storage type first, as
// jnp.asarray(0.2, dtype) does. Storage is float or __nv_bfloat16.
//
// Bound. At the serving shape (LR 16x16x10, nf=128, gc=32, num_convs=5,
// 16 RRDB) one sample is 2560 rows x 48 RDBs x (27*32*(128+160+192+224)
// + 256*128) MACs = 78.8 G MACs = 157.5 GFLOP, against ~61 MB of bf16
// weights read once per call and 0.66 MB of activations per sample: the
// trunk is compute-bound, about 0.16 ms per sample at the card's dense
// bf16 tensor-core peak (989 TFLOP/s).
//
// Design of this first version: every conv is an implicit GEMM (rows x
// output channels, reduction over taps x input channels) on the CUDA cores
// with f32 FMAs. A block owns a 64-row x 32-channel output tile; for each
// tap and each 32-channel slice of the concat it gathers the shifted input
// rows (zeros outside the volume) and the matching weight slice into shared
// memory, then every thread accumulates a 4x4 register tile. The concat
// never exists: channels below nf come from the state buffer, the rest from
// the growth buffer, into which each growth conv writes its gc channels.
// The host loop launches K growth convs and one LFF per RDB on the caller's
// stream, rotating three state buffers so the RRDB input stays readable.
// The tensor cores (wgmma fed by TMA, bf16 in, f32 accumulate) are what
// the bound above assumes; they are the work of a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

enum Epilogue { kGrowth = 0, kLff = 1 };

// One conv of the trunk as an implicit GEMM over the virtual concat
// [state (nf channels), growth (first cin - nf channels)].
//   TAPS = 27: 3x3x3 growth conv; w is (27, cin, cout), taps x-major.
//   TAPS = 1 : the 1x1x1 LFF;      w is (cin, cout).
// kGrowth writes LeakyReLU(acc) into growth[:, gout_off : gout_off + cout];
// kLff writes the RDB (and, at RRDB ends, RRDB) residual update to sout.
template <typename T, int TAPS, int MODE>
__global__ void __launch_bounds__(THREADS)
    trunk_conv(const T* __restrict__ state, const T* growth,
               const T* __restrict__ w, int nf, int gct, int cin, int cout,
               int X, int Y, int Z, int rows, float slope, T* gout,
               int gout_off, const T* __restrict__ bias,
               const T* __restrict__ rres, T* __restrict__ sout,
               float rdb_scale, float rrdb_scale, int rrdb_end) {
  __shared__ float As[BM][BK + 1];              // [row][channel], padded
  __shared__ __align__(16) float Bs[BK][BN];    // [channel][out]
  __shared__ int sx[BM], sy[BM], sz[BM];        // coordinates of the rows

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
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
      sx[tid] = -4;  // never inside the volume, whatever the tap
      sy[tid] = 0;
      sz[tid] = 0;
    }
  }

  const int tx = tid & 7;   // output channels o0 + 4*tx .. +3
  const int ty = tid >> 3;  // rows row0 + 4*ty .. +3
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  __syncthreads();

  for (int t = 0; t < TAPS; ++t) {
    const int dx = TAPS == 27 ? t / 9 - 1 : 0;
    const int dy = TAPS == 27 ? (t / 3) % 3 - 1 : 0;
    const int dz = TAPS == 27 ? t % 3 - 1 : 0;
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
          v = c < nf ? to_f(state[src * nf + c])
                     : to_f(growth[src * gct + (c - nf)]);
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

  const float s1 = rnd<T>(rdb_scale);
  const float s2 = rnd<T>(rrdb_scale);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + 4 * tx + j;
      if (o >= cout) continue;
      const float v = acc[i][j];
      if (MODE == kGrowth) {
        gout[(size_t)r * gct + gout_off + o] = from_f<T>(v >= 0.f ? v : v * slope);
      } else {
        const float lff = rnd<T>(v + to_f(bias[o]));
        float nw = rnd<T>(to_f(state[(size_t)r * nf + o]) + rnd<T>(lff * s1));
        if (rrdb_end) nw = rnd<T>(to_f(rres[(size_t)r * nf + o]) + rnd<T>(nw * s2));
        sout[(size_t)r * nf + o] = from_f<T>(nw);
      }
    }
  }
}

// The whole trunk: J RDBs, K growth convs + one LFF each, on `stream`.
// scratch holds 3 state buffers (rows x nf) then the growth buffer
// (rows x K*gc). Returns the first CUDA error, or 0.
template <typename T>
int trunk_forward(const T* x, T* out, const T* wconv, const T* wlff,
                  const T* blff, T* scratch, int N, int X, int Y, int Z,
                  int nf, int gc, int num_convs, int J, int per,
                  float rdb_scale, float rrdb_scale, float slope,
                  cudaStream_t stream) {
  const int rows = N * X * Y * Z;
  const int K = num_convs - 1;
  const int gct = gc * K;
  const int cin_lff = nf + gct;
  const size_t S = (size_t)rows * nf;
  T* bufs[3] = {scratch, scratch + S, scratch + 2 * S};
  T* growth = scratch + 3 * S;
  if (J == 0) {
    return (int)cudaMemcpyAsync(out, x, S * sizeof(T),
                                cudaMemcpyDeviceToDevice, stream);
  }
  const dim3 block(THREADS);
  const dim3 grid_g((rows + BM - 1) / BM, (gc + BN - 1) / BN);
  const dim3 grid_l((rows + BM - 1) / BM, (nf + BN - 1) / BN);

  const T* cur = x;
  const T* rres = x;
  const T* wc = wconv;
  for (int j = 0; j < J; ++j) {
    if (j % per == 0) rres = cur;
    for (int k = 0; k < K; ++k) {
      const int cin = nf + gc * k;
      trunk_conv<T, 27, kGrowth><<<grid_g, block, 0, stream>>>(
          cur, growth, wc, nf, gct, cin, gc, X, Y, Z, rows, slope, growth,
          k * gc, nullptr, nullptr, nullptr, 0.f, 0.f, 0);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      wc += (size_t)27 * cin * gc;
    }
    T* nxt = out;
    if (j < J - 1) {
      for (T* b : bufs) {
        if (b != cur && b != rres) {
          nxt = b;
          break;
        }
      }
    }
    trunk_conv<T, 1, kLff><<<grid_l, block, 0, stream>>>(
        cur, growth, wlff + (size_t)j * cin_lff * nf, nf, gct, cin_lff, nf, X,
        Y, Z, rows, slope, nullptr, 0, blff + (size_t)j * nf, rres, nxt,
        rdb_scale, rrdb_scale, (j % per) == per - 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    cur = nxt;
  }
  return 0;
}

}  // namespace

#define WINDSR_TRUNK_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* x, void* out, const void* wconv,           \
                      const void* wlff, const void* blff, void* scratch,     \
                      int N, int X, int Y, int Z, int nf, int gc,            \
                      int num_convs, int J, int per, float rdb_scale,        \
                      float rrdb_scale, float slope, void* stream) {          \
    return trunk_forward<T>(                                                 \
        static_cast<const T*>(x), static_cast<T*>(out),                      \
        static_cast<const T*>(wconv), static_cast<const T*>(wlff),           \
        static_cast<const T*>(blff), static_cast<T*>(scratch), N, X, Y, Z,   \
        nf, gc, num_convs, J, per, rdb_scale, rrdb_scale, slope,             \
        static_cast<cudaStream_t>(stream));                                  \
  }

WINDSR_TRUNK_ENTRY(windsr_rrdb_trunk_f32, float)
WINDSR_TRUNK_ENTRY(windsr_rrdb_trunk_bf16, __nv_bfloat16)
