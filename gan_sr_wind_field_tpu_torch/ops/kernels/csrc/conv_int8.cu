// int8 x int8 -> int32 3D convolution for NVIDIA Hopper (sm_90a) on
// warpgroup MMA (wgmma m64nNk32 s8), with three epilogues; plain C ABI for
// ctypes.
//
// Replaces no Pallas kernel: the JAX package's int8 serving convs are XLA
// (gan_sr_wind_field_tpu/ops/quant.py:conv3d_int8, lax.conv_general_dilated
// on int8 with int32 accumulation, and ops/quant_trunk.py:_conv). PyTorch
// has no int8 conv3d on CUDA, and the library route (torch._int_mm over an
// im2col) would write 125 taps x 128 channels per HR voxel of the head:
// 5.24 GB of int8 per batch-8 forward.
//
// What it computes. For x (N, X, Y, Z, *) int8 channels-last (rows of ldx
// bytes, the conv reading the first ci of them) and the packed weights w
// (kx, ky, kz, co, cip) int8 (cip = ci rounded up to 32, zero-filled),
// with zero padding (px, py, pz) on both faces of each axis and an output
// of the input's extent (2p = k - 1 per axis):
//
//   acc[r, o] = sum over taps and input channels of x * w   (int32, exact)
//
// and one of three epilogues, in float32, each operation rounded once, in
// JAX's order (no FMA):
//
//   DequantEpi  float(acc) * s[o] (+ b[o]), stored as float32 or rounded to
//               bf16 (quant.py:133-163: astype(f32) * s, then + b or
//               .astype(bf16));
//   RequantEpi  int8(clamp(rint(lrelu(float(acc) * s[o]) / sc[o]), -127,
//               127)), the trunk's growth conv, LeakyReLU and quantize_act
//               in one (quant_trunk.py:179-208);
//
// each stored in rows of ldo elements (the requantized ones at column col
// + o), so a growth conv writes its 32 int8 columns into the RDB step's
// concat buffer and the head's main conv its 128 bf16 columns into the
// head's 144.
//
// Bound. The head's main conv (5x5x5, 128 -> 128) costs 125 * 128 * 128 * 2
// = 4.1 MOPs per HR voxel against 128 bytes in: it is bound by operations
// (1,979 TOPS dense int8). So are the trunk's growth convs (3x3x3,
// 128..224 -> 32); the 1x1x1 LFF (256 -> 128) is bound by bytes.
//
// Design (kernel 5's, head_mma.cuh, carried to int8). Rows are the output
// voxels (they may cross x-planes and samples: every row knows its own
// coordinates), columns the output channels; a block owns BM rows and one
// BN-column chunk (blockIdx.y), over WG warpgroups of BM / WG rows. The
// reduction runs in stages, one per (64-channel slice, dx, group of DYS
// kernel rows dy):
//
//   A  per (slice, dx), the window of the input rows its ky * kz taps (dy,
//      dz) read: BM + 2 (py Z + pz) rows of 64 bytes, zero-filled outside
//      the volume, loaded with the stage of its first dy and read by the
//      stages of that dx, so the input crosses L2 about kx times, not
//      kx ky kz; a 64-byte row is 64 int8 channels, kernel 5's 32 bf16,
//      so its swizzle and ldmatrix fragments carry over byte for byte;
//   B  the weights of the stage's taps for the slice, through a ring of
//      NSTAGE slots, K-major (the packed layout): 8 columns x 16 bytes per
//      core matrix, read by the tensor cores through a matrix descriptor.
//
// Per tap and k32 step each warpgroup issues one wgmma m64nBNk32 per m64
// tile, A from registers that ldmatrix fills at the tap's row shift of the
// window (a lane whose tap leaves the volume reads a row of zeros: x, y and
// z validity bits per row), while the previous step's wgmma runs. A
// stage's steps are unrolled for the call's kz (1, 3 or 5), so their
// offsets are constants. One __syncthreads per stage: the head's main
// conv runs 2 x 25 stages (not 500), a growth conv 224 -> 32 4 x 3 (not
// 189).
//
// Tiles. HeadTile (256 x 128, 4 warpgroups) for the head's main conv and
// RemTile (256 x 80) for its 1x1x5 remainder (400 = 5 x 80 columns) run in
// one launch (head_pair_kernel: the first column chunks are the main
// conv's, the rest the remainder's; 64 x 528 s32 accumulators per
// warpgroup would not fit one block's registers). NarrowTile (128 x 32,
// two warpgroups, a stage of all 9 (dy, dz) taps of a dx) runs the growth
// convs: 160 blocks at LR batch 8, a full RDB step's K each. WideTile (64 x
// 128, one warpgroup) runs the LFF and any other conv with co > 32.

#include <algorithm>

#include "head_mma.cuh"

namespace windsr {
namespace i8 {

using tc::smem_u32;

constexpr int SLICE = 64;       // input channels (bytes) per slice: one row
constexpr int ZERO_BYTES = 64;  // the row of zeros masked lanes read
constexpr int AXIS_BITS = 8;    // validity bits per axis
constexpr int MAX_K = 5;        // kernel extent per axis: kz of 1, 3 or 5

// A block of BM rows x BN columns over WG warpgroups, each of BM / WG rows
// (MT m64 tiles), NSTAGE weight slots of DYS kernel rows (dy) x kz taps.
// Shared memory: the ring, then the windows, then the zero row; its size
// depends on the call (Z, ky, kz, py, pz), and the host plan
// (ops/conv_int8.py) counts it the same way.
template <int BM_, int BN_, int WG_, int NSTAGE_, int DYS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WG = WG_, NSTAGE = NSTAGE_;
  static constexpr int DYS = DYS_;
  static constexpr int THREADS = WG * 128;
  static constexpr int MT = BM / (64 * WG);
  static constexpr int NG = BN / 8;    // 8-column core-matrix groups
  static constexpr int ACC = BN / 2;   // s32 accumulators per m64 tile
  static_assert(MT >= 1 && BM == 64 * WG * MT, "warpgroups of m64 tiles");
  static_assert(BN == 32 || BN == 80 || BN == 128, "an instantiated wgmma");
  static_assert(NSTAGE >= 2 && DYS >= 1, "a ring");

  static __host__ __device__ int halo_rows(int Z, int py, int pz) {
    return BM + 2 * (py * Z + pz);
  }
  static __host__ __device__ size_t window_bytes(int Z, int py, int pz) {
    return (size_t)halo_rows(Z, py, pz) * SLICE;
  }
  // kernel rows per stage, and stages per window (one slice and dx)
  static __host__ __device__ int dys(int ky) { return DYS < ky ? DYS : ky; }
  static __host__ __device__ int groups(int ky) {
    return (ky + DYS - 1) / DYS;
  }
  static __host__ __device__ size_t slot_bytes(int ky, int kz) {
    return (size_t)dys(ky) * kz * SLICE * BN;
  }
  // window w's buffer (w % nwin) is refilled by the load issued NSTAGE - 1
  // stages before its first stage, after the barrier that ends window
  // w - nwin's last: two buffers do where a window lasts NSTAGE - 1 stages
  static __host__ __device__ int nwin(int ky) {
    return NSTAGE <= groups(ky) + 1 ? 2 : NSTAGE;
  }
  static __host__ __device__ size_t smem_bytes(int Z, int ky, int kz, int py,
                                               int pz) {
    return NSTAGE * slot_bytes(ky, kz) + nwin(ky) * window_bytes(Z, py, pz) +
           ZERO_BYTES;
  }
};

using HeadTile = Tile<256, 128, 4, 3, 1>;
using RemTile = Tile<256, 80, 4, 3, 1>;
using WideTile = Tile<64, 128, 1, 3, 1>;
using NarrowTile = Tile<128, 32, 2, 3, 3>;

// The conv's geometry: x rows of ldx bytes (the conv reads channels [0,
// ci); ci a multiple of 16), w (kx, ky, kz, co, cip) with cip a multiple
// of 32.
struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  int ldx, ci, cip, co;
  int X, Y, Z, rows;
  int kx, ky, kz, px, py, pz;
};

// float(acc) * s[o] (+ b[o]) into column o of rows of ldo elements,
// float32 or rounded to bf16; `pairs`: columns o, o + 1 as one store.
struct DequantEpi {
  const float* s;
  const float* b;
  void* out;
  int ldo, co, bf16, pairs;
  __device__ __forceinline__ float value(int a, int o) const {
    float v = __fmul_rn(__int2float_rn(a), s[o]);
    return b != nullptr ? __fadd_rn(v, b[o]) : v;
  }
  __device__ __forceinline__ void pair(int r, int o, int a0, int a1) const {
    if (o >= co) return;
    const bool two = o + 1 < co;
    const float v0 = value(a0, o);
    const float v1 = two ? value(a1, o + 1) : 0.f;
    const size_t at = (size_t)r * ldo + o;
    if (bf16) {
      tc::bf16* p = static_cast<tc::bf16*>(out) + at;
      if (two && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16_rn(v0);
        if (two) p[1] = __float2bfloat16_rn(v1);
      }
    } else {
      float* p = static_cast<float*>(out) + at;
      if (two && pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (two) p[1] = v1;
      }
    }
  }
};

// int8(clamp(rint(lrelu(float(acc) * s[o]) / sc[o]), -127, 127)) into
// column col + o of int8 rows of ldo bytes: F.leaky_relu then
// quantize_act, each float operation rounded once (torch's and JAX's
// LeakyReLU keep x where x > 0, else x * slope; round half to even).
struct RequantEpi {
  const float* s;
  const float* sc;
  int8_t* out;
  int ldo, col, co, pairs;
  float slope;
  __device__ __forceinline__ int8_t value(int a, int o) const {
    float v = __fmul_rn(__int2float_rn(a), s[o]);
    v = v > 0.f ? v : __fmul_rn(v, slope);
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sc[o])), -127.f), 127.f);
    return static_cast<int8_t>(__float2int_rn(q));
  }
  __device__ __forceinline__ void pair(int r, int o, int a0, int a1) const {
    if (o >= co) return;
    const bool two = o + 1 < co;
    int8_t* p = out + (size_t)r * ldo + col + o;
    const int8_t q0 = value(a0, o);
    if (two && pairs) {
      *reinterpret_cast<char2*>(p) = make_char2(q0, value(a1, o + 1));
    } else {
      p[0] = q0;
      if (two) p[1] = value(a1, o + 1);
    }
  }
};

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

// d (64 x 128 s32, this thread's 64) += a (64 x 32 s8, this warp's
// 16 rows in registers) * B (128 x 32 s8, K-major, at desc).
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 80 s32, this thread's 40) += a (64 x 32 s8, this warp's
// 16 rows in registers) * B (80 x 32 s8, K-major, at desc).
template <>
__device__ __forceinline__ void wgmma_s8<80>(int (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 32 s32, this thread's 16) += a (64 x 32 s8, this warp's
// 16 rows in registers) * B (32 x 32 s8, K-major, at desc).
template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// The slice's bytes that are copied and multiplied: 64, or 32 for a last
// slice of cip (a multiple of 32).
__device__ __forceinline__ int slice_depth(int cip, int slice) {
  return cip - slice * SLICE >= SLICE ? SLICE : 32;
}

// Issues the copies of the input window of slice `slice` at kernel x
// offset dx into `win` (all threads): rows row0 + (dx - px) Y Z - (py Z +
// pz) on, halo_rows of them, and of each the slice's first `depth`
// channels (zero fill outside [0, rows) and past ci), 16 bytes a copy,
// rows of 64 bytes with swizzled 16-byte chunks (trunk_mma.cuh:swz).
template <class TL>
__device__ __forceinline__ void load_window(char* win, const ConvArgs& p,
                                            int row0, int slice, int dx,
                                            int depth) {
  const int hr = TL::halo_rows(p.Z, p.py, p.pz);
  const int g0 = row0 + (dx - p.px) * p.Y * p.Z - (p.py * p.Z + p.pz);
  const int c0 = slice * SLICE;
  const int lg = depth == SLICE ? 2 : 1;  // log2 of the chunks per row
  for (int e = threadIdx.x; e < (hr << lg); e += TL::THREADS) {
    const int h = e >> lg, c = e & ((1 << lg) - 1);
    const int g = g0 + h, ch = c0 + 16 * c;
    const bool ok = g >= 0 && g < p.rows && ch < p.ci;
    const int off = h * SLICE + (tc::swz<4>(h, c) << 4);
    tc::cp_async(smem_u32(win + off),
                 ok ? p.x + (size_t)g * p.ldx + ch : p.x, 16, ok);
  }
}

// Issues the copies of the weights of slice `slice`, taps tap0 .. tap0 +
// ntaps - 1 (one dx; the stage's dy, every dz), columns o0 .. o0 + BN into
// `wb` (all threads) as K-major core matrices: column n's 16-byte chunk kc
// of tap tp at ((tp * NG + n / 8) * 4 + kc) * 128 + (n % 8) * 16;
// consecutive threads read a column's contiguous bytes.
template <class TL>
__device__ __forceinline__ void load_weights(char* wb, const ConvArgs& p,
                                             int o0, int slice, int tap0,
                                             int ntaps, int depth) {
  const int c0 = slice * SLICE;
  const int lc = depth == SLICE ? 2 : 1;
  const int n = (ntaps * TL::BN) << lc;
  for (int e = threadIdx.x; e < n; e += TL::THREADS) {
    const int kc = e & ((1 << lc) - 1);
    const int rest = e >> lc;
    const int col = rest % TL::BN, tp = rest / TL::BN;
    const int o = o0 + col;
    const int off = ((tp * TL::NG + (col >> 3)) * 4 + kc) * 128 + (col & 7) * 16;
    const int8_t* src =
        p.w + ((size_t)(tap0 + tp) * p.co + o) * p.cip + c0 + 16 * kc;
    tc::cp_async(smem_u32(wb + off), o < p.co ? src : p.w, 16, o < p.co);
  }
}

// One step of a stage on the tensor cores: tap (dy, dz), the t-th of the
// slot, k32 step kk. Each warpgroup's m64 tiles take A from registers
// (ldmatrix at the tap's row shift of window As, or the zero row where the
// tap leaves the volume) and B from the slot Bs through a descriptor
// (K-major: 128 bytes between the k step's two 16-byte halves, LBO; 512
// between 8-column groups, SBO). The step loads its A buffer while the
// previous step's wgmma runs, and waits for that one before the next step
// refills the other buffer.
template <int BN, int MT>
__device__ __forceinline__ void mma_step(int (&acc)[MT][BN / 2],
                                         uint32_t (&a)[MT][4], uint32_t As,
                                         uint32_t Bs, const int (&mrow)[MT],
                                         const uint32_t (&mask)[MT],
                                         const uint32_t (&okx)[MT], int dy,
                                         int dz, int t, int kk, int Z,
                                         uint32_t zero_s, int kq) {
  const int shift = dy * Z + dz;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int h = mrow[i] + shift;
    const bool ok = okx[i] & (mask[i] >> (AXIS_BITS + dy)) &
                    (mask[i] >> (2 * AXIS_BITS + dz));
    const int c = 2 * kk + kq;
    tc::ldsm_x4(ok ? As + h * SLICE + (tc::swz<4>(h, c) << 4) : zero_s, a[i]);
  }
  const uint64_t desc =
      hd::wg_desc(Bs + (t * (BN / 8) * 4 + 2 * kk) * 128, 128, 512);
  hd::wgmma_fence();
#pragma unroll
  for (int i = 0; i < MT; ++i) wgmma_s8<BN>(acc[i], a[i], desc);
  hd::wgmma_commit();
  hd::wgmma_wait<1>();
}

// One stage (ndy <= DYS kernel rows from dy0, KZ taps each, KS k32 steps
// each), unrolled, so every step's tap, A buffer (the step's parity) and
// offsets are constants. Ends with every wgmma done: the slot is refilled
// after the next barrier.
template <int BN, int MT, int DYS, int KZ, int KS>
__device__ __forceinline__ void stage_unrolled(
    int (&acc)[MT][BN / 2], uint32_t As, uint32_t Bs, const int (&mrow)[MT],
    const uint32_t (&mask)[MT], const uint32_t (&okx)[MT], int dy0, int ndy,
    int Z, uint32_t zero_s, int kq) {
  uint32_t a[2][MT][4];
#pragma unroll
  for (int dyo = 0; dyo < DYS; ++dyo) {
    if (dyo >= ndy) break;
#pragma unroll
    for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        mma_step<BN, MT>(acc, a[((dyo * KZ + dz) * KS + kk) & 1], As, Bs,
                         mrow, mask, okx, dy0 + dyo, dz, dyo * KZ + dz, kk,
                         Z, zero_s, kq);
      }
    }
  }
  hd::wgmma_wait<0>();
}

// The stage of tile TL, unrolled for the call's kz and the slice's k32
// steps.
template <class TL>
__device__ __forceinline__ void stage(int (&acc)[TL::MT][TL::BN / 2],
                                      uint32_t As, uint32_t Bs,
                                      const int (&mrow)[TL::MT],
                                      const uint32_t (&mask)[TL::MT],
                                      int dx, int dy0, int ndy, int Z,
                                      int kz, int ksteps, uint32_t zero_s,
                                      int kq) {
  constexpr int BN = TL::BN, MT = TL::MT, DYS = TL::DYS;
  uint32_t okx[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) okx[i] = (mask[i] >> dx) & 1u;
#define WINDSR_STAGE(KZ, KS)                                               \
  stage_unrolled<BN, MT, DYS, KZ, KS>(acc, As, Bs, mrow, mask, okx, dy0, \
                                      ndy, Z, zero_s, kq)
  if (ksteps == 2) {
    if (kz == 5) {
      WINDSR_STAGE(5, 2);
    } else if (kz == 3) {
      WINDSR_STAGE(3, 2);
    } else {
      WINDSR_STAGE(1, 2);
    }
  } else {
    if (kz == 5) {
      WINDSR_STAGE(5, 1);
    } else if (kz == 3) {
      WINDSR_STAGE(3, 1);
    } else {
      WINDSR_STAGE(1, 1);
    }
  }
#undef WINDSR_STAGE
}

// The block's tile of row block blockIdx.x and column chunk `chunk`,
// accumulated in s32 registers, then handed to the epilogue a column pair
// at a time: lane (g, t) of warp w holds columns 8j + 2t, + 1 of rows
// 16 (w % 4) + g, + 8 of each m64 tile, accumulators 4j .. 4j + 3.
template <class TL, class Epi>
__device__ __forceinline__ void conv_tile(const ConvArgs& p, int chunk,
                                          char* smem, const Epi& epi) {
  constexpr int MT = TL::MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp >> 2) * (64 * MT) + 16 * (warp & 3);
  const int row0 = blockIdx.x * TL::BM;
  const int o0 = chunk * TL::BN;
  const size_t slot_bytes = TL::slot_bytes(p.ky, p.kz);
  const size_t win_bytes = TL::window_bytes(p.Z, p.py, p.pz);
  const int nwin = TL::nwin(p.ky);
  char* ring = smem;  // 128-byte multiples first
  char* wins = ring + TL::NSTAGE * slot_bytes;
  char* zero = wins + nwin * win_bytes;
  if (tid < ZERO_BYTES / 16) {
    reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  }

  // stages: per slice, per dx, per group of dys kernel rows
  const int dys = TL::dys(p.ky), groups = TL::groups(p.ky);
  const int per_slice = p.kx * groups;
  const int nst = (p.cip + SLICE - 1) / SLICE * per_slice;
  auto load = [&](int st) {
    const int slice = st / per_slice, q = st % per_slice;
    const int dx = q / groups, dy0 = q % groups * dys;
    const int depth = slice_depth(p.cip, slice);
    if (dy0 == 0) {
      load_window<TL>(wins + st / groups % nwin * win_bytes, p, row0, slice,
                      dx, depth);
    }
    load_weights<TL>(ring + st % TL::NSTAGE * slot_bytes, p, o0, slice,
                     (dx * p.ky + dy0) * p.kz, min(dys, p.ky - dy0) * p.kz,
                     depth);
  };

  // the output row whose A-row address this lane gives ldmatrix, per m64
  // tile, and per axis the kernel offsets that stay inside the volume
  const int YZ = p.Y * p.Z;
  const int R = p.X * YZ;
  int mrow[MT];
  uint32_t mask[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    mrow[i] = wm0 + 64 * i + (lane & 15);
    const int r = row0 + mrow[i];
    uint32_t m = 0;
    if (r < p.rows) {
      const int rem = r % R;
      const int x = rem / YZ, y = (rem / p.Z) % p.Y, z = rem % p.Z;
      for (int d = 0; d < p.kx; ++d) {
        m |= (uint32_t)(x + d - p.px >= 0 && x + d - p.px < p.X) << d;
      }
      for (int d = 0; d < p.ky; ++d) {
        m |= (uint32_t)(y + d - p.py >= 0 && y + d - p.py < p.Y)
             << (AXIS_BITS + d);
      }
      for (int d = 0; d < p.kz; ++d) {
        m |= (uint32_t)(z + d - p.pz >= 0 && z + d - p.pz < p.Z)
             << (2 * AXIS_BITS + d);
      }
    }
    mask[i] = m;
  }

  int acc[MT][TL::ACC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < TL::ACC; ++e) acc[i][e] = 0;

#pragma unroll
  for (int s = 0; s < TL::NSTAGE - 1; ++s) {
    if (s < nst) load(s);
    tc::cp_async_commit();
  }

  const uint32_t zero_s = smem_u32(zero);
  const int kq = lane >> 4;  // A: the 16-byte half of a k32 step
  for (int st = 0; st < nst; ++st) {
    tc::cp_async_wait<TL::NSTAGE - 2>();
    hd::fence_async_shared();  // this thread's copies, to the tensor cores
    __syncthreads();
    if (st + TL::NSTAGE - 1 < nst) load(st + TL::NSTAGE - 1);
    tc::cp_async_commit();
    const int slice = st / per_slice, q = st % per_slice;
    const int dx = q / groups, dy0 = q % groups * dys;
    stage<TL>(acc, smem_u32(wins + st / groups % nwin * win_bytes),
              smem_u32(ring + st % TL::NSTAGE * slot_bytes), mrow, mask, dx,
              dy0, min(dys, p.ky - dy0), p.Z, p.kz,
              slice_depth(p.cip, slice) / 32, zero_s, kq);
  }
  tc::cp_async_wait<0>();

  const int ob = o0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm0 + 64 * i + (lane >> 2) + 8 * h;
      if (r >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < TL::NG; ++j) {
        epi.pair(r, ob + 8 * j, acc[i][4 * j + 2 * h],
                 acc[i][4 * j + 2 * h + 1]);
      }
    }
  }
}

template <class TL, class Epi>
__global__ void __launch_bounds__(TL::THREADS) conv_kernel(ConvArgs p,
                                                           Epi epi) {
  extern __shared__ __align__(128) char smem[];
  conv_tile<TL>(p, blockIdx.y, smem, epi);
}

// The head pair in one launch over the same row blocks: column blocks
// [0, nm) are the main conv's chunks (HeadTile), the rest the remainder's
// (RemTile).
__global__ void __launch_bounds__(HeadTile::THREADS)
    head_pair_kernel(ConvArgs pm, DequantEpi em, ConvArgs pr, DequantEpi er,
                     int nm) {
  static_assert(HeadTile::THREADS == RemTile::THREADS &&
                    HeadTile::BM == RemTile::BM,
                "one block shape for both");
  extern __shared__ __align__(128) char smem[];
  if ((int)blockIdx.y < nm) {
    conv_tile<HeadTile>(pm, blockIdx.y, smem, em);
  } else {
    conv_tile<RemTile>(pr, blockIdx.y - nm, smem, er);
  }
}

inline int chunks(int co, int bn) { return (co + bn - 1) / bn; }

// Whether the geometry is one the kernel takes (the host plan refuses the
// same): odd extents up to 5 with 2p = k - 1, ci a multiple of 16 within
// the row, cip a multiple of 32 covering ci, 16-byte aligned rows.
inline bool valid(const ConvArgs& p) {
  const int k[3] = {p.kx, p.ky, p.kz}, pad[3] = {p.px, p.py, p.pz};
  for (int a = 0; a < 3; ++a) {
    if (k[a] < 1 || k[a] > MAX_K || 2 * pad[a] != k[a] - 1) {
      return false;
    }
  }
  return p.ci % 16 == 0 && p.ci >= 16 && p.ci <= p.ldx && p.ldx % 16 == 0 &&
         p.cip % 32 == 0 && p.cip >= p.ci && p.cip < p.ci + 32 &&
         p.co >= 1 && p.rows >= 1 &&
         reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
}

template <class TL, class Epi>
int launch(const ConvArgs& p, const Epi& epi, cudaStream_t stream) {
  const size_t smem = TL::smem_bytes(p.Z, p.ky, p.kz, p.py, p.pz);
  if (!valid(p) || smem > tc::SMEM_LIMIT ||
      !tc::allow_smem(conv_kernel<TL, Epi>)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((p.rows + TL::BM - 1) / TL::BM, chunks(p.co, TL::BN));
  conv_kernel<TL, Epi><<<grid, TL::THREADS, smem, stream>>>(p, epi);
  return (int)cudaGetLastError();
}

ConvArgs args(const void* x, int ldx, const void* w, int N, int X, int Y,
              int Z, int ci, int cip, int co, int kx, int ky, int kz, int px,
              int py, int pz) {
  return ConvArgs{static_cast<const int8_t*>(x),
                  static_cast<const int8_t*>(w),
                  ldx, ci, cip, co, X, Y, Z, N * X * Y * Z,
                  kx, ky, kz, px, py, pz};
}

bool even(const void* ptr, int align, int ldo, int col) {
  return reinterpret_cast<uintptr_t>(ptr) % align == 0 && ldo % 2 == 0 &&
         col % 2 == 0;
}

}  // namespace i8
}  // namespace windsr

using namespace windsr::i8;

// out = float(conv(x, w)) * s (+ b): x (N, X, Y, Z, ci) int8 with ci a
// multiple of 16 and a 16-byte aligned pointer, w (kx, ky, kz, co, cip)
// int8 with cip a multiple of 32 and >= ci, s and b (co,) float32 (b may
// be null), out (N, X, Y, Z, co) float32. wide picks the 128-column tile
// (else the 32-column one). Returns the launch's CUDA error, or 0.
extern "C" int windsr_conv_int8(const void* x, const void* w, const void* s,
                                const void* b, void* out, int N, int X, int Y,
                                int Z, int ci, int cip, int co, int kx, int ky,
                                int kz, int px, int py, int pz, int wide,
                                void* stream) {
  const ConvArgs p =
      args(x, ci, w, N, X, Y, Z, ci, cip, co, kx, ky, kz, px, py, pz);
  const DequantEpi epi{static_cast<const float*>(s),
                       static_cast<const float*>(b), out, co, co, 0,
                       even(out, 8, co, 0)};
  const auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch<WideTile>(p, epi, st) : launch<NarrowTile>(p, epi, st);
}

// The trunk's growth conv into its concat buffer: out[r, col + o] =
// int8(clamp(rint(lrelu(float(conv(x, w)) * s) / sc), -127, 127)) for x
// rows of ldx bytes whose first ci are the conv's input (ci a multiple of
// 16), out rows of ldo bytes (x and out may be one buffer where [col, col
// + co) lies past ci), s and sc (co,) float32. NarrowTile, column chunks
// of 32. Returns the launch's CUDA error, or 0.
extern "C" int windsr_conv_int8_requant(
    const void* x, int ldx, const void* w, const void* s, const void* sc,
    float slope, void* out, int ldo, int col, int N, int X, int Y, int Z,
    int ci, int cip, int co, int kx, int ky, int kz, int px, int py, int pz,
    void* stream) {
  const ConvArgs p =
      args(x, ldx, w, N, X, Y, Z, ci, cip, co, kx, ky, kz, px, py, pz);
  if (col < 0 || col + co > ldo) return (int)cudaErrorInvalidValue;
  const RequantEpi epi{static_cast<const float*>(s),
                       static_cast<const float*>(sc),
                       static_cast<int8_t*>(out), ldo, col, co,
                       even(out, 2, ldo, col), slope};
  return launch<NarrowTile>(p, epi, static_cast<cudaStream_t>(stream));
}

// The int8 head pair in one launch on one input x (N, X, Y, Z, ci): the
// main conv (kx, ky, kz) with wm (kx, ky, kz, cm, cip) writes
// float(acc) * sm into columns [0, cm) of out, rows of ldo elements,
// rounded to bf16 (out_bf16) or float32; where wr is not null, the
// remainder (1, 1, kz) with wr (1, 1, kz, cr, cip) writes the float32
// partials float(acc) * sr into partial (N, X, Y, Z, cr). Returns the
// launch's CUDA error, or 0.
extern "C" int windsr_head_pair_int8(
    const void* x, const void* wm, const void* sm, void* out, int ldo,
    int out_bf16, const void* wr, const void* sr, void* partial, int N,
    int X, int Y, int Z, int ci, int cip, int cm, int cr, int kx, int ky,
    int kz, int px, int py, int pz, void* stream) {
  const ConvArgs pm =
      args(x, ci, wm, N, X, Y, Z, ci, cip, cm, kx, ky, kz, px, py, pz);
  const ConvArgs pr =
      args(x, ci, wr == nullptr ? wm : wr, N, X, Y, Z, ci, cip,
           wr == nullptr ? 1 : cr, 1, 1, kz, 0, 0, pz);
  const DequantEpi em{static_cast<const float*>(sm), nullptr, out, ldo, cm,
                      out_bf16, even(out, out_bf16 ? 4 : 8, ldo, 0)};
  const DequantEpi er{static_cast<const float*>(sr), nullptr, partial, cr, cr,
                      0, even(partial, 8, cr, 0)};
  const size_t smem =
      std::max(HeadTile::smem_bytes(Z, ky, kz, py, pz),
               wr == nullptr ? 0 : RemTile::smem_bytes(Z, 1, kz, 0, pz));
  if (!valid(pm) || !valid(pr) || cm > ldo || smem > windsr::tc::SMEM_LIMIT ||
      !windsr::tc::allow_smem(head_pair_kernel)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nm = chunks(cm, HeadTile::BN);
  const int nr = wr == nullptr ? 0 : chunks(cr, RemTile::BN);
  const dim3 grid((pm.rows + HeadTile::BM - 1) / HeadTile::BM, nm + nr);
  head_pair_kernel<<<grid, HeadTile::THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(pm, em, pr, er, nm);
  return (int)cudaGetLastError();
}

// Shared memory of a block of tile `which` (0 narrow, 1 wide, 2 the head's
// main, 3 its remainder) for a call of depth Z and kernel (ky, kz) with
// padding (py, pz), as the wrapper's plan counts it.
extern "C" long long windsr_conv_int8_smem(int which, int Z, int ky, int kz,
                                           int py, int pz) {
  switch (which) {
    case 0: return (long long)NarrowTile::smem_bytes(Z, ky, kz, py, pz);
    case 1: return (long long)WideTile::smem_bytes(Z, ky, kz, py, pz);
    case 2: return (long long)HeadTile::smem_bytes(Z, ky, kz, py, pz);
    case 3: return (long long)RemTile::smem_bytes(Z, ky, kz, py, pz);
    default: return -1;
  }
}
