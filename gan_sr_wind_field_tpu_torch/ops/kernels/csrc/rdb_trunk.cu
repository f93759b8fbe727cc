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
// Design. A host loop launches, per RDB, K growth convs and one LFF on the
// caller's stream, rotating three state buffers so the RRDB input stays
// readable. The concat never exists: channels below nf come from the
// state buffer, the rest from the growth buffer, into which each growth
// conv writes its gc channels. In residual mode the per-RDB input states
// and growth buffers are the J-major residual outputs themselves, so the
// mode costs no extra pass: only the copy of x into states[0].
//
// bf16 runs on the tensor cores (trunk_mma.cuh): mma.sync m16n8k16 with
// f32 accumulation, operands by ldmatrix from swizzled shared memory that
// a 3-slot cp.async ring fills. Each 32-channel slice of a growth conv's
// input is loaded as three row windows, one per dx, each read by its 9
// taps, so the input crosses L2 ~3.3 times per conv instead of 27.
// Tiles per conv shape:
//   growth conv (N = gc = 32, K = 27 (nf + gc k)): 256 rows x 32 columns
//     per block, 8 warps of 32 x 32, 2 blocks per SM;
//   LFF (N = nf = 128, K = nf + gc K = 256, no halo): 64 x 128 per block,
//     4 warps of 32 x 64.
// What bounds it on this card, short of the dense bf16 rate the bound
// assumes: per warp, every 8 mma.sync wait on 4 ldmatrix and on address
// arithmetic, and every thread also issues the cp.async copies of the
// next stages, with 16 warps per SM to hide the latencies: this work, not
// the tensor instruction's rate, sets the pace (PERF.md). The float32
// instantiations stay on the CUDA cores (trunk_gemm.cuh: f32 FMAs, 64 x 32
// tiles): the tensor cores take f32 only as TF32, which would break the
// float32 checks.

#include <type_traits>

#include "trunk_gemm.cuh"
#include "trunk_mma.cuh"

namespace {

using namespace windsr;

enum Epilogue { kGrowth = 0, kLff = 1 };

// One conv of the float32 trunk over the virtual concat [state (nf
// channels), growth (first cin - nf channels)], on the CUDA cores.
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

// ---------------------------------------------- bf16, on the tensor cores
using tc::bf16;
using tc::ld2;
using tc::st2;
using GrowthTile = tc::Tile<3, 256, 32, 8, 1, 3>;
using LffTile = tc::Tile<1, 64, 128, 2, 2, 3>;

// LeakyReLU in f32, rounded, into growth[:, off : off + gc]
struct GrowthEpi {
  bf16* gout;
  int gct, off;
  float slope;
  template <int NT>
  __device__ void row(int r, int ob, const float (&v)[NT][2], int cout,
                      bool pairs) const {
    bf16* g = gout + (size_t)r * gct + off;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = ob + 8 * j;
      if (o >= cout) continue;
      const float a = v[j][0], b = v[j][1];
      st2(g, o, cout, pairs, a >= 0.f ? a : a * slope,
          b >= 0.f ? b : b * slope);
    }
  }
};

// the LFF (+ bias) rounded, then the RDB and, at RRDB ends, the RRDB
// residual, each rounded, with the scales rounded first
struct LffEpi {
  const bf16* state;
  const bf16* bias;
  const bf16* rres;
  bf16* sout;
  int nf;
  float rdb_scale, rrdb_scale;
  int rrdb_end;
  __device__ float update(float acc, float b, float s, float q) const {
    const float lff = rnd<bf16>(acc + b);
    const float nw = rnd<bf16>(s + rnd<bf16>(lff * rnd<bf16>(rdb_scale)));
    return rrdb_end ? rnd<bf16>(q + rnd<bf16>(nw * rnd<bf16>(rrdb_scale)))
                    : nw;
  }
  template <int NT>
  __device__ void row(int r, int ob, const float (&v)[NT][2], int cout,
                      bool pairs) const {
    const size_t i0 = (size_t)r * nf;
    float2 s[NT], q[NT], b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = ob + 8 * j;
      if (o >= cout) continue;
      s[j] = ld2(state + i0, o, cout, pairs);
      b[j] = ld2(bias, o, cout, pairs);
      q[j] = rrdb_end ? ld2(rres + i0, o, cout, pairs) : make_float2(0, 0);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = ob + 8 * j;
      if (o >= cout) continue;
      st2(sout + i0, o, cout, pairs, update(v[j][0], b[j].x, s[j].x, q[j].x),
          update(v[j][1], b[j].y, s[j].y, q[j].y));
    }
  }
};

__global__ void __launch_bounds__(GrowthTile::THREADS)
    tc_growth_fwd(tc::ConvArgs p, GrowthEpi epi) {
  tc::conv_mma<GrowthTile>(p, epi);
}

__global__ void __launch_bounds__(LffTile::THREADS)
    tc_lff_fwd(tc::ConvArgs p, LffEpi epi) {
  tc::conv_mma<LffTile>(p, epi);
}

// The launches of one trunk: float32 on conv_tile, bf16 on the tensor
// cores with copies of vec channels.
template <typename T>
struct Launcher {
  int X, Y, Z, rows, nf, gct, vec;
  cudaStream_t stream;

  int prepare() { return 0; }

  int growth(const T* cur, T* growth, const T* w, int cin, int gc, int k,
             float slope) {
    const dim3 grid((rows + BM - 1) / BM, (gc + BN - 1) / BN);
    trunk_conv<T, 3, kGrowth><<<grid, THREADS, 0, stream>>>(
        cur, growth, w, nf, gct, cin, gc, X, Y, Z, rows, slope, growth,
        k * gc, nullptr, nullptr, nullptr, 0.f, 0.f, 0);
    return (int)cudaGetLastError();
  }

  int lff(const T* cur, const T* growth, const T* w, const T* bias,
          const T* rres, T* nxt, float rdb_scale, float rrdb_scale,
          int rrdb_end) {
    const dim3 grid((rows + BM - 1) / BM, (nf + BN - 1) / BN);
    trunk_conv<T, 1, kLff><<<grid, THREADS, 0, stream>>>(
        cur, growth, w, nf, gct, nf + gct, nf, X, Y, Z, rows, 0.f, nullptr,
        0, bias, rres, nxt, rdb_scale, rrdb_scale, rrdb_end);
    return (int)cudaGetLastError();
  }
};

template <>
struct Launcher<bf16> {
  int X, Y, Z, rows, nf, gct, vec;
  cudaStream_t stream;

  int prepare() {
    return tc::allow_smem(tc_growth_fwd) && tc::allow_smem(tc_lff_fwd)
               ? 0
               : (int)cudaErrorInvalidValue;
  }

  tc::ConvArgs args(const bf16* cur, const bf16* growth, const bf16* w,
                    int cin, int cout) const {
    return tc::ConvArgs{cur, growth, w, nf, nf, gct, cin, cout,
                        X, Y, Z, rows, vec};
  }

  int growth(const bf16* cur, bf16* growth, const bf16* w, int cin, int gc,
             int k, float slope) {
    const GrowthEpi epi{growth, gct, k * gc, slope};
    const tc::ConvArgs p = args(cur, growth, w, cin, gc);
    return tc::launch<GrowthTile>(tc_growth_fwd, p, epi, stream);
  }

  int lff(const bf16* cur, const bf16* growth, const bf16* w,
          const bf16* bias, const bf16* rres, bf16* nxt, float rdb_scale,
          float rrdb_scale, int rrdb_end) {
    const LffEpi epi{cur, bias, rres, nxt, nf, rdb_scale, rrdb_scale,
                     rrdb_end};
    return tc::launch<LffTile>(tc_lff_fwd, args(cur, growth, w, nf + gct, nf),
                               epi, stream);
  }
};

// The whole trunk: J RDBs, K growth convs + one LFF each, on `stream`.
// Serving mode (states == nullptr): scratch holds 3 state buffers
// (rows x nf) that rotate so the RRDB input stays readable, then the
// growth buffer (rows x K*gc). Residual mode: states (J, rows, nf) holds
// each RDB's input state, so RDB j reads states[j] and its LFF writes
// states[j + 1] (out for the last RDB); growths (J, rows, K*gc) receives
// RDB j's growths straight from its growth convs; scratch is unused.
// vec is the bf16 plan's copy width in channels; float32 ignores it.
// Returns the first CUDA error, or 0.
template <typename T>
int trunk_forward(const T* x, T* out, const T* wconv, const T* wlff,
                  const T* blff, T* scratch, T* states, T* growths, int N,
                  int X, int Y, int Z, int nf, int gc, int num_convs, int J,
                  int per, float rdb_scale, float rrdb_scale, float slope,
                  int vec, cudaStream_t stream) {
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
  if (std::is_same<T, bf16>::value) {
    const void* ptrs[] = {x, out, wconv, wlff, blff, scratch, states,
                          growths};
    const int counts[] = {nf, gc};
    if (!tc::aligned(vec, ptrs, 8, counts, 2)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  Launcher<T> launch{X, Y, Z, rows, nf, gct, vec, stream};
  int e = launch.prepare();
  if (e != 0) return e;
  T* bufs[3] = {scratch, scratch + S, scratch + 2 * S};

  const T* cur = x;
  if (states != nullptr) {
    e = (int)cudaMemcpyAsync(states, x, S * sizeof(T),
                             cudaMemcpyDeviceToDevice, stream);
    if (e != 0) return e;
    cur = states;
  }
  const T* rres = cur;
  const T* wc = wconv;
  for (int j = 0; j < J; ++j) {
    if (j % per == 0) rres = cur;
    T* growth = states != nullptr ? growths + j * G : scratch + 3 * S;
    for (int k = 0; k < K; ++k) {
      const int cin = nf + gc * k;
      e = launch.growth(cur, growth, wc, cin, gc, k, slope);
      if (e != 0) return e;
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
    e = launch.lff(cur, growth, wlff + (size_t)j * cin_lff * nf,
                   blff + (size_t)j * nf, rres, nxt, rdb_scale, rrdb_scale,
                   (j % per) == per - 1);
    if (e != 0) return e;
    cur = nxt;
  }
  return 0;
}

}  // namespace

#define WINDSR_TRUNK_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* x, void* out, const void* wconv,           \
                      const void* wlff, const void* blff, void* scratch,     \
                      void* states, void* growths, int N, int X, int Y,      \
                      int Z, int nf, int gc, int num_convs, int J, int per,  \
                      int vec, float rdb_scale, float rrdb_scale,            \
                      float slope, void* stream) {                           \
    return trunk_forward<T>(                                                 \
        static_cast<const T*>(x), static_cast<T*>(out),                      \
        static_cast<const T*>(wconv), static_cast<const T*>(wlff),           \
        static_cast<const T*>(blff), static_cast<T*>(scratch),               \
        static_cast<T*>(states), static_cast<T*>(growths), N, X, Y, Z,       \
        nf, gc, num_convs, J, per, rdb_scale, rrdb_scale, slope, vec,        \
        static_cast<cudaStream_t>(stream));                                  \
  }

WINDSR_TRUNK_ENTRY(windsr_rrdb_trunk_f32, float)
WINDSR_TRUNK_ENTRY(windsr_rrdb_trunk_bf16, __nv_bfloat16)

// Dynamic shared memory of a bf16 tile (conv 0: growth conv, conv 1:
// LFF) at depth Z for cin input channels, as the wrapper's plan counts it;
// -1 if there is no such tile.
extern "C" long long windsr_rrdb_trunk_tc_smem(int conv, int Z, int cin) {
  if (conv == 0) return (long long)GrowthTile::smem_bytes(Z, cin);
  if (conv == 1) return (long long)LffTile::smem_bytes(Z, cin);
  return -1;
}
