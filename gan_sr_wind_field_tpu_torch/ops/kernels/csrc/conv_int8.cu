// int8 x int8 -> int32 3D convolution for NVIDIA Hopper (sm_90a), with the
// dequantizing epilogue, plain C ABI for ctypes.
//
// Replaces no Pallas kernel: the JAX package's int8 serving convs are XLA
// (gan_sr_wind_field_tpu/ops/quant.py:conv3d_int8, lax.conv_general_dilated
// on int8 with int32 accumulation, and ops/quant_trunk.py:_conv). PyTorch
// has no int8 conv3d on CUDA, and the library route (torch._int_mm over an
// im2col) would write 125 taps x 128 channels per HR voxel of the head:
// 5.24 GB of int8 per batch-8 forward.
//
// What it computes. For x (N, X, Y, Z, ci) int8 channels-last and the
// packed weights w (kx, ky, kz, co, cip) int8 (cip = ci rounded up to 32,
// zero-filled), with zero padding (px, py, pz) on both faces of each axis
// and an output of the input's extent (2p = k - 1 per axis):
//
//   acc[r, o] = sum over taps and input channels of x * w   (int32, exact)
//   out[r, o] = float(acc) * s[o]  (+ b[o] when a bias is given)
//
// in float32, each operation rounded once, in that order (no FMA), as JAX
// does it: astype(f32) * s, then + b.
//
// Bound. The head's main conv (5x5x5, 128 -> 128) costs 125 * 128 * 128 * 2
// = 4.1 MOPs per HR voxel against 128 bytes in and 512 bytes out: it is
// bound by operations, 0.68 ms at batch 8 at the card's dense int8 peak
// (1,979 TOPS). The trunk's growth convs (3x3x3, 128..224 -> 32) are
// bound by operations too; the 1x1x1 LFF (256 -> 128) by bytes.
//
// Design. A simple implicit GEMM: rows are the output voxels, columns the
// output channels, K is taps x input channels in stages of 32 channels of
// one tap. A block owns BM rows x BN columns; per stage it copies the BM
// input rows that tap reads (cp.async, 16 bytes a copy, zero fill for a
// row outside the volume and for channels past ci) and the BN weight rows
// of 32 bytes into a ring of NSTAGE shared-memory slots, one
// __syncthreads a stage. Shared rows are 48 bytes apart, so the 8 rows an
// ldmatrix reads fall into 8 distinct bank groups. Each warp multiplies
// its (BM / WARPS_M) x (BN / WARPS_N) part with
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: an int8 m16 x k32 A
// fragment has the byte layout of a bf16 m16 x k16 one, and so has the
// k32 x n8 B fragment of weight rows stored n-major with k contiguous,
// so both load with ldmatrix.x4. Being right comes first: wgmma, TMA and
// tuning are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int SK = 32;   // input channels (bytes) per stage
constexpr int ROW = 48;  // shared-memory pitch of a 32-byte row

// BM x BN output tile over WARPS_M x WARPS_N warps, NSTAGE ring slots.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int NSTAGE_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int NSTAGE = NSTAGE_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int SLOT = (BM + BN) * ROW;
  static constexpr int SMEM = NSTAGE * SLOT;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tile of m16 x n16");
  static_assert(SMEM <= 48 * 1024, "static launch: at most 48 KB");
};

// the wide tile for co > 32 (the head's 128 and 400 columns, the LFF's
// 128), the narrow one for co <= 32 (the trunk's growth convs)
using WideTile = Tile<128, 128, 4, 2, 3>;
using NarrowTile = Tile<128, 32, 4, 1, 3>;

struct Args {
  const int8_t* x;  // (rows, ci)
  const int8_t* w;  // (kx, ky, kz, co, cip)
  const float* s;   // (co,)
  const float* b;   // (co,) or null
  float* out;       // (rows, co)
  int X, Y, Z, rows, ci, cip, co;
  int kx, ky, kz, px, py, pz;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;  // 0: fill the destination with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class T>
__global__ void __launch_bounds__(T::THREADS) conv_int8_kernel(Args p) {
  __shared__ __align__(16) uint8_t smem[T::SMEM];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int row0 = blockIdx.x * T::BM;
  const int col0 = blockIdx.y * T::BN;
  const int YZ = p.Y * p.Z;
  const int kc = p.cip / SK;  // stages per tap
  const int stages = p.kx * p.ky * p.kz * kc;

  // the A copies of this thread: chunk c is half (c & 1) of tile row c >> 1
  constexpr int A_CHUNKS = 2 * T::BM;
  constexpr int A_PER = (A_CHUNKS + T::THREADS - 1) / T::THREADS;
  int ax[A_PER], ay[A_PER], az[A_PER];
  bool arow[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int c = tid + i * T::THREADS;
    const int r = row0 + (c >> 1);
    arow[i] = c < A_CHUNKS && r < p.rows;
    const int rr = arow[i] ? r : 0;
    az[i] = rr % p.Z;
    ay[i] = (rr / p.Z) % p.Y;
    ax[i] = (rr / YZ) % p.X;
  }

  auto load = [&](int s, int slot) {
    const int tap = s / kc;
    const int c0 = (s - tap * kc) * SK;
    const int dz = tap % p.kz;
    const int dy = (tap / p.kz) % p.ky;
    const int dx = tap / (p.ky * p.kz);
    uint8_t* base = smem + slot * T::SLOT;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * T::THREADS;
      if (c >= A_CHUNKS) break;
      const int half = c & 1;
      const int ch = c0 + half * 16;
      const int xi = ax[i] + dx - p.px, yi = ay[i] + dy - p.py,
                zi = az[i] + dz - p.pz;
      const bool ok = arow[i] && ch < p.ci && xi >= 0 && xi < p.X &&
                      yi >= 0 && yi < p.Y && zi >= 0 && zi < p.Z;
      const int8_t* src = p.x;
      if (ok) {
        const int r = row0 + (c >> 1) + (dx - p.px) * YZ + (dy - p.py) * p.Z +
                      (dz - p.pz);
        src = p.x + (size_t)r * p.ci + ch;
      }
      cp_async16(smem_u32(base + (c >> 1) * ROW + half * 16), src, ok);
    }
    constexpr int B_CHUNKS = 2 * T::BN;
#pragma unroll
    for (int c = tid; c < B_CHUNKS; c += T::THREADS) {
      const int n = col0 + (c >> 1);
      const int half = c & 1;
      const bool ok = n < p.co;
      const int8_t* src =
          ok ? p.w + ((size_t)tap * p.co + n) * p.cip + c0 + half * 16 : p.w;
      cp_async16(smem_u32(base + (T::BM + (c >> 1)) * ROW + half * 16), src,
                 ok);
    }
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < T::NSTAGE - 1; ++s) {
    if (s < stages) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<T::NSTAGE - 2>();
    __syncthreads();  // stage s landed; every warp is done with s - 1
    const int next = s + T::NSTAGE - 1;
    if (next < stages) load(next, next % T::NSTAGE);
    cp_async_commit();

    const uint8_t* As = smem + (s % T::NSTAGE) * T::SLOT;
    const uint8_t* Bs = As + T::BM * ROW;
    uint32_t a[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      const int r = wm * T::WTM + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4(smem_u32(As + r * ROW + (lane >> 4) * 16), a[mt]);
    }
#pragma unroll
    for (int n2 = 0; n2 < T::NT / 2; ++n2) {
      uint32_t b[4];
      const int n = wn * T::WTN + n2 * 16 + (lane & 7) + (lane >> 4) * 8;
      ldsm_x4(smem_u32(Bs + n * ROW + ((lane >> 3) & 1) * 16), b);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        mma_s8(acc[mt][2 * n2], a[mt], b[0], b[1]);
        mma_s8(acc[mt][2 * n2 + 1], a[mt], b[2], b[3]);
      }
    }
  }

  // epilogue: thread (g, t) of a warp holds rows g and g + 8 of each m16
  // fragment, columns 2t and 2t + 1 of each n8 fragment
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * T::WTM + mt * 16 + g + 8 * h;
      if (r >= p.rows) continue;
      float* orow = p.out + (size_t)r * p.co;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = col0 + wn * T::WTN + nt * 8 + 2 * t + e;
          if (o >= p.co) continue;
          float v = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), p.s[o]);
          if (p.b != nullptr) v = __fadd_rn(v, p.b[o]);
          orow[o] = v;
        }
      }
    }
  }
}

template <class T>
int launch(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.rows + T::BM - 1) / T::BM, (p.co + T::BN - 1) / T::BN);
  conv_int8_kernel<T><<<grid, T::THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

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
  if (ci % 16 != 0 || cip % SK != 0 || cip < ci || co < 1 ||
      2 * px != kx - 1 || 2 * py != ky - 1 || 2 * pz != kz - 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args p{static_cast<const int8_t*>(x),
         static_cast<const int8_t*>(w),
         static_cast<const float*>(s),
         static_cast<const float*>(b),
         static_cast<float*>(out),
         X, Y, Z, N * X * Y * Z, ci, cip, co, kx, ky, kz, px, py, pz};
  const auto st = static_cast<cudaStream_t>(stream);
  return wide ? launch<WideTile>(p, st) : launch<NarrowTile>(p, st);
}

// Shared memory of a block of the wide (or narrow) tile, as the wrapper's
// plan counts it.
extern "C" long long windsr_conv_int8_smem(int wide) {
  return wide ? (long long)WideTile::SMEM : (long long)NarrowTile::SMEM;
}
