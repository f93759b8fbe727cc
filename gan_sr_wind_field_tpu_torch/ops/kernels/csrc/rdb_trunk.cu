// RRDB trunk forward for NVIDIA Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel gan_sr_wind_field_tpu/ops/pallas/rdb_trunk.py:
// fused_rrdb_trunk -> _trunk_kernel, the forward in both of its modes:
// without residuals (serving, the D step's G forward) and with residuals
// (the G step, whose backward, rdb_trunk_bwd.cu, reads them).
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
// bf16 tensor-core peak (989 TFLOP/s). The residual mode adds writes of
// J * rows * (nf + K*gc) values (2.0 GB of bf16 at the training batch of
// 32), 0.60 ms at 3.35 TB/s against the 5.10 ms of operations: still
// bound by operations.
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
// In residual mode the per-RDB input states and growth buffers are the
// J-major residual outputs themselves, so the mode costs no extra pass:
// only the copy of x into states[0].
// The tensor cores (wgmma fed by TMA, bf16 in, f32 accumulate) are what
// the bound above assumes; they are the work of a later version.

#include "trunk_gemm.cuh"

namespace {

using namespace windsr;

enum Epilogue { kGrowth = 0, kLff = 1 };

// One conv of the trunk over the virtual concat [state (nf channels),
// growth (first cin - nf channels)].
//   KS = 3: 3x3x3 growth conv; w is (27, cin, cout), taps x-major.
//   KS = 1: the 1x1x1 LFF;      w is (cin, cout).
// kGrowth writes LeakyReLU(acc) into growth[:, gout_off : gout_off + cout];
// kLff writes the RDB (and, at RRDB ends, RRDB) residual update to sout.
template <typename T, int KS, int MODE>
__global__ void __launch_bounds__(THREADS)
    trunk_conv(const T* __restrict__ state, const T* growth,
               const T* __restrict__ w, int nf, int gct, int cin, int cout,
               int X, int Y, int Z, int rows, float slope, T* gout,
               int gout_off, const T* __restrict__ bias,
               const T* __restrict__ rres, T* __restrict__ sout,
               float rdb_scale, float rrdb_scale, int rrdb_end) {
  const int row0 = blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  float acc[4][4];
  conv_tile<T, KS>(state, nf, nf, growth, gct, w, cin, cout, X, Y, Z, rows,
                   row0, o0, acc);

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
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
// Serving mode (states == nullptr): scratch holds 3 state buffers
// (rows x nf) that rotate so the RRDB input stays readable, then the
// growth buffer (rows x K*gc). Residual mode: states (J, rows, nf) holds
// each RDB's input state, so RDB j reads states[j] and its LFF writes
// states[j + 1] (out for the last RDB); growths (J, rows, K*gc) receives
// RDB j's growths straight from its growth convs; scratch is unused.
// Returns the first CUDA error, or 0.
template <typename T>
int trunk_forward(const T* x, T* out, const T* wconv, const T* wlff,
                  const T* blff, T* scratch, T* states, T* growths, int N,
                  int X, int Y, int Z, int nf, int gc, int num_convs, int J,
                  int per, float rdb_scale, float rrdb_scale, float slope,
                  cudaStream_t stream) {
  const int rows = N * X * Y * Z;
  const int K = num_convs - 1;
  const int gct = gc * K;
  const int cin_lff = nf + gct;
  const size_t S = (size_t)rows * nf;
  const size_t G = (size_t)rows * gct;
  if (J == 0) {
    return (int)cudaMemcpyAsync(out, x, S * sizeof(T),
                                cudaMemcpyDeviceToDevice, stream);
  }
  T* bufs[3] = {scratch, scratch + S, scratch + 2 * S};
  const dim3 block(THREADS);
  const dim3 grid_g((rows + BM - 1) / BM, (gc + BN - 1) / BN);
  const dim3 grid_l((rows + BM - 1) / BM, (nf + BN - 1) / BN);

  const T* cur = x;
  if (states != nullptr) {
    const cudaError_t e = cudaMemcpyAsync(
        states, x, S * sizeof(T), cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    cur = states;
  }
  const T* rres = cur;
  const T* wc = wconv;
  for (int j = 0; j < J; ++j) {
    if (j % per == 0) rres = cur;
    T* growth = states != nullptr ? growths + j * G : scratch + 3 * S;
    for (int k = 0; k < K; ++k) {
      const int cin = nf + gc * k;
      trunk_conv<T, 3, kGrowth><<<grid_g, block, 0, stream>>>(
          cur, growth, wc, nf, gct, cin, gc, X, Y, Z, rows, slope, growth,
          k * gc, nullptr, nullptr, nullptr, 0.f, 0.f, 0);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      wc += (size_t)27 * cin * gc;
    }
    T* nxt = out;
    if (j < J - 1 && states != nullptr) {
      nxt = states + (j + 1) * S;
    } else if (j < J - 1) {
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
                      void* states, void* growths, int N, int X, int Y,      \
                      int Z, int nf, int gc,                                 \
                      int num_convs, int J, int per, float rdb_scale,        \
                      float rrdb_scale, float slope, void* stream) {          \
    return trunk_forward<T>(                                                 \
        static_cast<const T*>(x), static_cast<T*>(out),                      \
        static_cast<const T*>(wconv), static_cast<const T*>(wlff),           \
        static_cast<const T*>(blff), static_cast<T*>(scratch),               \
        static_cast<T*>(states), static_cast<T*>(growths), N, X, Y, Z,       \
        nf, gc, num_convs, J, per, rdb_scale, rrdb_scale, slope,             \
        static_cast<cudaStream_t>(stream));                                  \
  }

WINDSR_TRUNK_ENTRY(windsr_rrdb_trunk_f32, float)
WINDSR_TRUNK_ENTRY(windsr_rrdb_trunk_bf16, __nv_bfloat16)
