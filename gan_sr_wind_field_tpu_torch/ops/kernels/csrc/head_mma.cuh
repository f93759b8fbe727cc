// Tensor-core implicit-GEMM tile of the bf16 HR head (hr_head.cu), on
// Hopper's warpgroup MMA and the primitives of the trunk's tile
// (trunk_mma.cuh: cp.async with zero fill, ldmatrix, the swizzled 64-byte
// window rows, the virtual concat of two inputs, the copy width `vec`).
//
// The head is one conv of kernel size KS (5 at milestone9k, 3 in the tiny
// configs) over the virtual concat [x, t] of channels-last rows (R = X*Y*Z
// rows per sample, z fastest): a GEMM of rows x C output channels,
// reduced over KS^3 taps x (nf + tc) input channels. A block of 16
// warps, 4 warpgroups, owns BM = 256 consecutive output rows (they may
// cross x-planes and samples: every row knows its own coordinates) and
// BN = 144 output columns (all of them at milestone9k, so each block
// reads the head's weights once). The reduction runs in stages, one per
// (32-channel slice, dx, dy):
//
//   A  per (slice, dx), the window of the input rows its KS^2 taps
//      (dy, dz) read: BM + 2*HP*(Z+1) rows of 64 bytes (HP = KS/2),
//      loaded with the stage of its first dy into one of two window
//      buffers and read by the KS stages of that dx, so the input crosses
//      L2 about KS*(BM + 2*HP*(Z+1))/BM times, not KS^3;
//   B  the weights of the stage's KS taps (dz) for the slice, through a
//      ring of NSTAGE = 3 slots.
//
// Per tap and k16 step each warpgroup issues one wgmma m64n144k16: A, its
// 64 rows, from registers that ldmatrix fills at the tap's row shift of
// the window; B, 16 x 144, read by the tensor cores from the weight slot
// through a matrix descriptor. A tap that leaves the volume for a row (in
// x, y or z, or past the last row) points that lane at a row of zeros:
// per row, KS bits of x, y and z validity each, combined per stage and tap
// (KS^3 = 125 taps do not fit one mask). The last slice of [x, t] at
// milestone9k (t's 16 channels) runs only its first k16 step: channels
// past cin rounded up to 16 are neither copied nor multiplied.
//
// Shared memory grows with Z (the windows): smem_bytes(Z), which the host
// plan (ops/hr_head.py:plan_head_tc) counts the same way and refuses past
// a block's limit.

#pragma once

#include "trunk_mma.cuh"

namespace windsr {
namespace hd {

using tc::bf16;
using tc::SK;
using tc::ZERO_BYTES;

// The tile of kernel size KS (3 or 5): BM = 256 rows per block over 16
// warps, 4 warpgroups of 64 rows (one m64 tile each), BN = 144 columns
// (the wgmma's N), NSTAGE = 3 weight slots. RESIDENT false: tc::launch
// gives it one block per BM rows and 144-column chunk.
template <int KS_>
struct Tile {
  static constexpr int KS = KS_, BM = 256, BN = 144;
  static constexpr int WARPS = 16, NSTAGE = 3;
  static constexpr bool RESIDENT = false;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int WGM = BM / (WARPS / 4);  // rows per warpgroup
  static constexpr int MT = WGM / 64;           // m64 tiles per warpgroup
  static constexpr int HP = KS / 2;
  static constexpr int BCH = BN / 8;             // 16-byte column chunks
  static constexpr int B_BYTES = KS * SK * BN * 2;  // one (dx, dy): KS taps
  static_assert(KS == 3 || KS == 5, "3x3x3 or 5x5x5 heads");
  static_assert(WARPS % 4 == 0 && WGM % 64 == 0, "warpgroups of m64 tiles");
  // window w's buffer is refilled by the load issued NSTAGE - 1 stages
  // ahead of its first stage: only after the last stage of window w - 2
  static_assert(NSTAGE >= 2 && NSTAGE - 1 <= KS, "ring deeper than a dx");

  static __host__ __device__ int halo_rows(int Z) {
    return BM + 2 * HP * (Z + 1);
  }
  static __host__ __device__ size_t window_bytes(int Z) {
    return (size_t)halo_rows(Z) * SK * 2;
  }
  // (no term in cin: the windows are double-buffered, not kept per slice)
  static __host__ __device__ size_t smem_bytes(int Z, int /*cin*/ = 0) {
    return ZERO_BYTES + 2 * window_bytes(Z) + (size_t)NSTAGE * B_BYTES;
  }
};

// The slice's channels that are copied and multiplied: 32, or what is
// left of cin rounded up to a k16 step.
__device__ __forceinline__ int slice_depth(int cin, int slice) {
  const int left = cin - slice * SK;
  return left >= SK ? SK : (left + 15) & ~15;
}

// The weight slot holds 8 x 8 core matrices (no swizzle; B is N-major,
// so the instruction's transpose-B flag is set): core (tap, k / 8, column
// chunk) at ((tap * 4 + k / 8) * BCH + chunk) * 128 bytes, row k % 8 of
// 16 bytes. Copies that threads write reach the tensor cores (the async
// proxy) through fence.proxy.async before the stage's barrier.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a B operand (16 x N, N contiguous) in core matrices:
// `lbo` bytes between the two k-halves, `sbo` bytes between column chunks.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 144, f32, this thread's 72) += a (64 x 16 bf16, this warp's 16
// rows in registers, mma.sync's A layout) * B (16 x 144 bf16 at desc,
// N-major: the transpose-B flag, the last 1, is set).
__device__ __forceinline__ void wgmma_n144(float (&d)[72],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// Issues the copies of the weights of slice `slice`, taps tap0 ..
// tap0 + KS - 1 (one dx, dy; every dz), columns o0 .. o0 + BN into `wb`
// (all threads): depth channel rows per tap, as core matrices, with
// consecutive threads on consecutive 16-byte rows of one core matrix.
template <class TL>
__device__ __forceinline__ void load_weights(char* wb, const tc::ConvArgs& p,
                                             int o0, int slice, int tap0,
                                             int depth) {
  const int c0 = slice * SK;
  const int lk = depth == SK ? 5 : 4;
  for (int e = threadIdx.x; e < (TL::KS * TL::BCH) << lk;
       e += TL::THREADS) {
    const int k8 = e & 7;  // row of the core matrix, fastest
    const int rest = e >> 3;
    const int c = rest % TL::BCH;
    const int rest2 = rest / TL::BCH;
    const int kb = rest2 & ((1 << (lk - 3)) - 1);
    const int tp = rest2 >> (lk - 3);
    const int kr = kb * 8 + k8;
    const int k = c0 + kr;
    const int off = ((tp * 4 + kb) * TL::BCH + c) * 128 + k8 * 16;
    const bf16* wrow = p.w + ((size_t)(tap0 + tp) * p.cin + k) * p.cout;
    tc::copy_chunk(tc::smem_u32(wb + off), wb + off, k < p.cin, o0 + 8 * c,
                   p.cout, p.vec, p.w, [&](int col) { return wrow + col; });
  }
}

// The block's output tile, accumulated in f32 registers, then handed to
// the epilogue one row of a lane at a time, as trunk_mma.cuh:conv_mma
// does: epi.row(r, ob, v, cout, pairs) for row r < rows gets v[j][e], the
// sum for column ob + 8j + e (to be written where < cout). Per k16 step a
// warpgroup loads A (ldmatrix, two register buffers), fences, issues its
// wgmmas and waits for the step before, so the next step's ldmatrix
// overlaps this step's products; a stage ends with all its wgmmas done,
// as its slot is refilled after the next barrier.
template <class TL, class Epi>
__device__ __forceinline__ void head_wgmma(const tc::ConvArgs& p,
                                           const Epi& epi) {
  extern __shared__ __align__(128) char smem[];
  constexpr int WGM = TL::WGM, MT = TL::MT, KS = TL::KS, HP = TL::HP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp >> 2) * WGM + 16 * (warp & 3);
  const int row0 = blockIdx.x * TL::BM;
  const int o0 = blockIdx.y * TL::BN;
  const size_t win_bytes = TL::window_bytes(p.Z);
  char* ring = smem;  // 128-byte aligned slots first
  char* wins = ring + TL::NSTAGE * TL::B_BYTES;
  char* zero = wins + 2 * win_bytes;
  if (tid < ZERO_BYTES / 16) {
    reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  }

  const int nst = (p.cin + SK - 1) / SK * KS * KS;
  auto load = [&](int st) {
    const int slice = st / (KS * KS), q = st % (KS * KS);
    const int depth = slice_depth(p.cin, slice);
    if (q % KS == 0) {
      tc::load_window<TL>(wins + ((st / KS) & 1) * win_bytes, p, row0,
                          slice, q / KS - HP, depth);
    }
    load_weights<TL>(ring + (st % TL::NSTAGE) * TL::B_BYTES, p, o0, slice,
                     q * KS, depth);
  };

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
#pragma unroll
      for (int d = 0; d < KS; ++d) {
        const int o = d - HP;
        m |= (uint32_t)(x + o >= 0 && x + o < p.X) << d;
        m |= (uint32_t)(y + o >= 0 && y + o < p.Y) << (8 + d);
        m |= (uint32_t)(z + o >= 0 && z + o < p.Z) << (16 + d);
      }
    }
    mask[i] = m;
  }

  float acc[MT][72];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 72; ++e) acc[i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TL::NSTAGE - 1; ++s) {
    if (s < nst) load(s);
    tc::cp_async_commit();
  }

  constexpr uint32_t KB_BYTES = TL::BCH * 128;  // one k-block of 8 rows
  const uint32_t zero_s = tc::smem_u32(zero);
  const int kq = lane >> 4;
  for (int st = 0; st < nst; ++st) {
    tc::cp_async_wait<TL::NSTAGE - 2>();
    fence_async_shared();  // this thread's copies, to the tensor cores
    __syncthreads();
    if (st + TL::NSTAGE - 1 < nst) load(st + TL::NSTAGE - 1);
    tc::cp_async_commit();
    const int slice = st / (KS * KS), q = st % (KS * KS);
    const int ix = q / KS, iy = q % KS;
    const int ksteps = slice_depth(p.cin, slice) / 16;
    const uint32_t As = tc::smem_u32(wins + ((st / KS) & 1) * win_bytes);
    const uint32_t Bs = tc::smem_u32(ring + (st % TL::NSTAGE) * TL::B_BYTES);
    const int base = HP * (p.Z + 1) + (iy - HP) * p.Z - HP;
    uint32_t okxy[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      okxy[i] = (mask[i] >> ix) & (mask[i] >> (8 + iy)) & 1u;
    }
    uint32_t a[2][MT][4];
#pragma unroll
    for (int iz = 0; iz < KS; ++iz) {
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
        if (kk >= ksteps) break;
        const int s = iz * 2 + kk;  // a's buffer: s & 1
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int h = mrow[i] + base + iz;
          const bool ok = okxy[i] & (mask[i] >> (16 + iz));
          const int c = 2 * kk + kq;
          tc::ldsm_x4(ok ? As + h * (SK * 2) + (tc::swz<4>(h, c) << 4)
                         : zero_s,
                      a[s & 1][i]);
        }
        const uint32_t b_addr = Bs + (iz * 4 + kk * 2) * KB_BYTES;
        const uint64_t desc = wg_desc(b_addr, KB_BYTES, 128);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < MT; ++i) wgmma_n144(acc[i], a[s & 1][i], desc);
        wgmma_commit();
        // the A buffer loaded next must be free: with both k16 steps the
        // previous step's (wait for all but this one), with one (a last,
        // half slice) every step takes buffer 0 (wait for all)
        if (ksteps == 2) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
      }
    }
    wgmma_wait<0>();  // the slot is refilled after the next barrier
  }
  tc::cp_async_wait<0>();

  // lane (g, t) of warp w holds columns ob + 8j + {0, 1} of rows
  // 16(w % 4) + g, + 8 of each m64 tile, accumulators 4j .. 4j + 3
  const int ob = o0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[TL::BCH][2];
#pragma unroll
      for (int j = 0; j < TL::BCH; ++j) {
        v[j][0] = acc[i][4 * j + 2 * h];
        v[j][1] = acc[i][4 * j + 2 * h + 1];
      }
      const int r = row0 + wm0 + 64 * i + (lane >> 2) + 8 * h;
      if (r < p.rows) epi.row(r, ob, v, p.cout, p.vec >= 2);
    }
  }
}

// The head's epilogue: LeakyReLU in f32, times the dropout scale
// dm[n, o] of the row's sample n (in f32; none where dm is null), one
// rounding to bf16 into h (rows x C).
struct HeadEpi {
  const bf16* dm;
  bf16* h;
  int R, C;
  float slope;
  template <int NT>
  __device__ void row(int r, int ob, const float (&v)[NT][2], int cout,
                      bool pairs) const {
    float2 s[NT];
    if (dm != nullptr) {
      const bf16* d = dm + (size_t)(r / R) * C;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = ob + 8 * j;
        s[j] = o < cout ? tc::ld2(d, o, cout, pairs) : make_float2(0.f, 0.f);
      }
    }
    bf16* out = h + (size_t)r * C;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int o = ob + 8 * j;
      if (o >= cout) continue;
      float a = v[j][0], b = v[j][1];
      a = a >= 0.f ? a : a * slope;
      b = b >= 0.f ? b : b * slope;
      if (dm != nullptr) {
        a *= s[j].x;
        b *= s[j].y;
      }
      tc::st2(out, o, cout, pairs, a, b);
    }
  }
};

// The head on the tensor cores with tile TL through `kernel` (a
// __global__ wrapper of head_wgmma<TL, HeadEpi>): x (rows x nf) and t
// (rows x tch) channels-last, w (KS^3, nf + tch, C), dm (N, C) or null, h
// (rows x C); copies of vec channels. Returns the launch's CUDA error.
template <class TL>
inline int head_forward(void (*kernel)(tc::ConvArgs, HeadEpi), const bf16* x,
                        const bf16* t, const bf16* w, const bf16* dm, bf16* h,
                        int N, int X, int Y, int Z, int nf, int tch, int C,
                        int vec, float slope, cudaStream_t stream) {
  const void* ptrs[] = {x, t, w, dm, h};
  const int counts[] = {nf, tch, C};
  if (!tc::aligned(vec, ptrs, 5, counts, 3) || !tc::allow_smem(kernel)) {
    return (int)cudaErrorInvalidValue;
  }
  const tc::ConvArgs p{x, t, w, nf, nf, tch, nf + tch, C, X, Y, Z,
                       N * X * Y * Z, vec};
  return tc::launch<TL>(kernel, p, HeadEpi{dm, h, X * Y * Z, C, slope},
                        stream);
}

}  // namespace hd
}  // namespace windsr
