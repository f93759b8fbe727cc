// Tensor-core implicit-GEMM tile for the bf16 RRDB trunk kernels
// (rdb_trunk.cu, the forward in both modes, and rdb_trunk_bwd.cu, the
// backward-dx). The float32 instantiations stay on trunk_gemm.cuh.
//
// A conv over channels-last rows (R = X*Y*Z rows per sample, z fastest) is
// a GEMM: rows x output channels, reduced over taps x input channels. A
// block of WARPS_M x WARPS_N warps owns BM consecutive output rows x BN
// output channels (the rows may cross x-planes and samples: every row
// knows its own coordinates). The reduction runs in stages; a stage is one 32-channel
// slice of the input and, for the 3x3x3 convs, one dx of the kernel:
//
//   A  the window of input rows that the 9 taps (dy, dz) of that dx read:
//      rows row0 + dx*Y*Z - (Z+1) .. row0 + BM - 1 + dx*Y*Z + (Z+1), that
//      is BM + 2(Z+1) rows of 64 bytes, loaded once and read by all 9 taps
//      (a 1x1x1 conv reads just its BM rows). Across the three dx the
//      input crosses L2 about 3(BM + 2Z + 2)/BM times per conv, not 27.
//   B  the weights of those 9 taps for the slice, [tap][channel][column].
//
// Stages stream through a ring of NSTAGE shared-memory slots with cp.async
// (zero fill for rows outside the tensor and channels past cin), so the
// next stages land while this one is multiplied; one __syncthreads per
// stage. Each warp multiplies its (BM/WARPS_M) x (BN/WARPS_N) part with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), A fragments by ldmatrix
// at per-lane row addresses (the tap's shift of the window row), B
// fragments by ldmatrix.trans from the K-major weight rows. A tap that
// leaves the volume for a row (in x, y or z, or past the last row) points
// that lane at a row of zeros instead: a 27-bit mask per row, made once.
// Rows are XOR-swizzled in 16-byte chunks, so the 8 rows an ldmatrix
// reads at once hit 8 distinct bank groups.
//
// Copy widths follow the alignment the caller passes as `vec` (channels
// per copy: 8, 4, 2 or 1 -> cp.async of 16, 8 or 4 bytes, or plain loads),
// which must divide every channel count, stride, offset and pointer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace windsr {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int SK = 32;           // input channels per stage (64-byte rows)
constexpr int ZERO_BYTES = 64;   // the row of zeros masked lanes read
constexpr size_t SMEM_LIMIT = 232448;  // a block's shared memory on sm_90

// One tile shape: KS the odd kernel size (1 or 3), BM x BN the block's
// output tile (of one column chunk), WARPS_M x WARPS_N warps over it,
// NSTAGE ring slots. A streaming tile (RESIDENT false) owns one column
// chunk (blockIdx.y) and streams window and weights of every stage through
// the ring. A resident tile owns all cout columns of its rows: it loads
// every window of its rows once, keeps them, and streams only the weights,
// chunk by chunk, writing each chunk when its reduction ends; for wide
// outputs over a short reduction (the backward's transposed convs).
template <int KS_, int BM_, int BN_, int WARPS_M_, int WARPS_N_, int NSTAGE_,
          bool RESIDENT_ = false>
struct Tile {
  static constexpr int KS = KS_, BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int NSTAGE = NSTAGE_;
  static constexpr bool RESIDENT = RESIDENT_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int WIN = KS == 3 ? 3 : 1;   // windows (dx) per slice
  static constexpr int TAPS = KS == 3 ? 9 : 1;  // taps per window
  static constexpr int BCH = BN / 8;            // 16-byte chunks per B row
  static constexpr int B_BYTES = TAPS * SK * BN * 2;
  static_assert(KS == 1 || KS == 3, "1x1x1 or 3x3x3 convs");
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tile of m16 x n16");

  static __host__ __device__ int halo_rows(int Z) {
    return KS == 3 ? BM + 2 * (Z + 1) : BM;
  }
  static __host__ __device__ size_t window_bytes(int Z) {
    return (size_t)halo_rows(Z) * SK * 2;
  }
  static __host__ __device__ size_t slot_bytes(int Z) {
    return RESIDENT ? B_BYTES : window_bytes(Z) + B_BYTES;
  }
  static __host__ __device__ size_t resident_bytes(int Z, int cin) {
    return RESIDENT ? (size_t)((cin + SK - 1) / SK) * WIN * window_bytes(Z)
                    : 0;
  }
  static __host__ __device__ size_t smem_bytes(int Z, int cin) {
    return ZERO_BYTES + resident_bytes(Z, cin) + NSTAGE * slot_bytes(Z);
  }
};

// The conv's operands. Input channel c of row r is a0[r*s0 + c] for
// c < n0, else a1[r*s1 + c - n0] (a virtual concat of two buffers). w is
// (KS^3, cin, cout), taps x-major. a1 may alias what the epilogue writes
// (the growth buffer: read below k*gc, written from k*gc), so no
// __restrict__ on it.
struct ConvArgs {
  const bf16* a0;
  const bf16* a1;
  const bf16* w;
  int n0, s0, s1, cin, cout;
  int X, Y, Z, rows;
  int vec;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool ok) {
  const int n = ok ? bytes : 0;  // 0: fill the destination with zeros
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  }
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
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Physical 16-byte chunk of logical chunk c in row r of a buffer whose
// rows hold `chunks` chunks: 8 consecutive rows at one logical chunk land
// in 8 distinct 16-byte bank groups of a 128-byte line.
template <int CHUNKS>
__device__ __forceinline__ int swz(int r, int c) {
  if (CHUNKS >= 8) return c ^ (r & 7);
  if (CHUNKS == 4) return c ^ ((r >> 1) & 3);
  if (CHUNKS == 2) return c ^ ((r >> 2) & 1);
  return c;
}

// Copies 8 channels (one 16-byte chunk) to dst: those of ok sub-chunks
// from src_of(channel), zeros elsewhere, `vec` channels per copy.
template <class Src>
__device__ __forceinline__ void copy_chunk(uint32_t dst, char* dst_ptr,
                                           bool row_ok, int ch, int limit,
                                           int vec, const bf16* dflt,
                                           Src src_of) {
  if (vec == 8) {
    const bool ok = row_ok && ch < limit;
    cp_async(dst, ok ? src_of(ch) : dflt, 16, ok);
  } else if (vec >= 2) {
    for (int s = 0; s < 8; s += vec) {
      const bool ok = row_ok && ch + s < limit;
      cp_async(dst + 2 * s, ok ? src_of(ch + s) : dflt, 2 * vec, ok);
    }
  } else {
    bf16* d = reinterpret_cast<bf16*>(dst_ptr);
    for (int s = 0; s < 8; ++s) {
      const bool ok = row_ok && ch + s < limit;
      d[s] = ok ? *src_of(ch + s) : __float2bfloat16(0.f);
    }
  }
}

// Issues the copies of the input window of slice `slice` at kernel x
// offset dx (0 for 1x1x1) into `win` (all threads): rows row0 + dx*Y*Z -
// (KS/2)(Z+1) on, TL::halo_rows(Z) of them, and of each the slice's
// first `depth` channels (32, or 16 for a half slice the caller
// multiplies by one k16 step).
template <class TL>
__device__ __forceinline__ void load_window(char* win, const ConvArgs& p,
                                            int row0, int slice, int dx,
                                            int depth = SK) {
  const int c0 = slice * SK;
  const int hr = TL::halo_rows(p.Z);
  const int g0 = row0 + dx * p.Y * p.Z - TL::KS / 2 * (p.Z + 1);
  const int lg = depth == SK ? 2 : 1;  // log2 of the 16-byte chunks per row
  for (int e = threadIdx.x; e < (hr << lg); e += TL::THREADS) {
    const int h = e >> lg, c = e & ((1 << lg) - 1);
    const int g = g0 + h;
    const int off = h * (SK * 2) + (swz<4>(h, c) << 4);
    copy_chunk(smem_u32(win + off), win + off, g >= 0 && g < p.rows,
               c0 + 8 * c, p.cin, p.vec, p.a0, [&](int ch) {
                 return ch < p.n0 ? p.a0 + (size_t)g * p.s0 + ch
                                  : p.a1 + (size_t)g * p.s1 + (ch - p.n0);
               });
  }
}

// Issues the copies of the weights of slice `slice`, kernel x offset dx,
// columns o0 .. o0 + BN into `wb` (all threads).
template <class TL>
__device__ __forceinline__ void load_weights(char* wb, const ConvArgs& p,
                                             int o0, int slice, int dx) {
  const int c0 = slice * SK;
  const int tap0 = TL::KS == 3 ? (dx + 1) * 9 : 0;
  for (int e = threadIdx.x; e < TL::TAPS * SK * TL::BCH; e += TL::THREADS) {
    const int c = e % TL::BCH;
    const int kr = (e / TL::BCH) % SK;
    const int tp = e / (TL::BCH * SK);
    const int k = c0 + kr;
    const int brow = tp * SK + kr;
    const int off = brow * (TL::BN * 2) + (swz<TL::BCH>(brow, c) << 4);
    const bf16* wrow = p.w + ((size_t)(tap0 + tp) * p.cin + k) * p.cout;
    copy_chunk(smem_u32(wb + off), wb + off, k < p.cin, o0 + 8 * c, p.cout,
               p.vec, p.w, [&](int col) { return wrow + col; });
  }
}

// The block's output tile, accumulated in f32 registers, then handed to
// the epilogue one row of a lane at a time: epi.row(r, ob, v, cout, pairs)
// for row r < rows gets v[j][e], the sum for column ob + 8j + e (to be
// written where < cout); `pairs` says that every channel count, offset
// and pointer is even, so columns ob + 8j and ob + 8j + 1 may be loaded
// and stored as one 4-byte pair. An epilogue issues all its loads for the
// row before its first store, so they are in flight together.
template <class TL, class Epi>
__device__ __forceinline__ void conv_mma(const ConvArgs& p, const Epi& epi) {
  extern __shared__ __align__(128) char smem[];
  constexpr int MT = TL::MT, NT = TL::NT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp / TL::WARPS_N) * TL::WTM;
  const int wn0 = (warp % TL::WARPS_N) * TL::WTN;
  const int row0 = blockIdx.x * TL::BM;
  const size_t win_bytes = TL::window_bytes(p.Z);
  const size_t slot_bytes = TL::slot_bytes(p.Z);
  char* zero = smem;
  char* resident = smem + ZERO_BYTES;  // the kept windows (RESIDENT)
  char* ring = resident + TL::resident_bytes(p.Z, p.cin);
  if (tid < ZERO_BYTES / 16) {
    reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  }

  // stages: per column chunk, per slice, per window (dx)
  const int per_chunk = (p.cin + SK - 1) / SK * TL::WIN;
  const int nst = TL::RESIDENT ? (p.cout + TL::BN - 1) / TL::BN * per_chunk
                               : per_chunk;
  const int chunk0 = TL::RESIDENT ? 0 : blockIdx.y;
  auto load = [&](int st) {
    const int q = st % per_chunk;
    const int o0 = (chunk0 + st / per_chunk) * TL::BN;
    const int dx = TL::KS == 3 ? q % 3 - 1 : 0;
    char* slot = ring + (st % TL::NSTAGE) * slot_bytes;
    if (TL::RESIDENT) {
      if (st == 0) {
        for (int w = 0; w < per_chunk; ++w) {
          load_window<TL>(resident + w * win_bytes, p, row0, w / TL::WIN,
                          TL::KS == 3 ? w % 3 - 1 : 0);
        }
      }
      load_weights<TL>(slot, p, o0, q / TL::WIN, dx);
    } else {
      load_window<TL>(slot, p, row0, q / TL::WIN, dx);
      load_weights<TL>(slot + win_bytes, p, o0, q / TL::WIN, dx);
    }
  };

  // the output row whose A-row address this lane gives ldmatrix, per
  // m16 tile, and the taps that stay inside the volume for it
  const int YZ = p.Y * p.Z;
  const int R = p.X * YZ;
  int mrow[MT];
  uint32_t mask[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    mrow[i] = wm0 + 16 * i + (lane & 15);
    const int r = row0 + mrow[i];
    uint32_t m = 0;
    if (r < p.rows) {
      if (TL::KS == 1) {
        m = 1;
      } else {
        const int rem = r % R;
        const int x = rem / YZ, y = (rem / p.Z) % p.Y, z = rem % p.Z;
        for (int t = 0; t < 27; ++t) {
          const int xx = x + t / 9 - 1, yy = y + (t / 3) % 3 - 1,
                    zz = z + t % 3 - 1;
          if (xx >= 0 && xx < p.X && yy >= 0 && yy < p.Y && zz >= 0 &&
              zz < p.Z) {
            m |= 1u << t;
          }
        }
      }
    }
    mask[i] = m;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TL::NSTAGE - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }

  const uint32_t zero_s = smem_u32(zero);
  const int kq = lane >> 4;           // A: k half this lane addresses
  const int bq = lane >> 3;           // B: which of the 4 8x8 matrices
  const int br = lane & 7;            // B: row within it
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<TL::NSTAGE - 2>();
    __syncthreads();
    if (st + TL::NSTAGE - 1 < nst) load(st + TL::NSTAGE - 1);
    cp_async_commit();
    const int q = st % per_chunk;
    const char* slot = ring + (st % TL::NSTAGE) * slot_bytes;
    const uint32_t As =
        smem_u32(TL::RESIDENT ? resident + q * win_bytes : slot);
    const uint32_t Bs = smem_u32(TL::RESIDENT ? slot : slot + win_bytes);
    const int tsh = TL::KS == 3 ? (q % 3) * 9 : 0;  // the window's first tap
#pragma unroll
    for (int tp = 0; tp < TL::TAPS; ++tp) {
      const int shift =
          TL::KS == 3 ? (p.Z + 1) + (tp / 3 - 1) * p.Z + (tp % 3 - 1) : 0;
      int hrow[MT];
      bool ok[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        hrow[i] = mrow[i] + shift;
        ok[i] = (mask[i] >> (tsh + tp)) & 1u;
      }
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
        uint32_t b[NT][2];
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          const int kr = tp * SK + kk * 16 + (bq & 1) * 8 + br;
          const int c = (wn0 >> 3) + 2 * jp + (bq >> 1);
          uint32_t r[4];
          ldsm_x4_t(Bs + kr * (TL::BN * 2) + (swz<TL::BCH>(kr, c) << 4), r);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int c = 2 * kk + kq;
          const uint32_t addr =
              ok[i] ? As + hrow[i] * (SK * 2) + (swz<4>(hrow[i], c) << 4)
                    : zero_s;
          uint32_t a[4];
          ldsm_x4(addr, a);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    if (q != per_chunk - 1) continue;
    // the chunk's reduction is done: hand it over row by row, start the
    // next; lane (g, t) holds columns ob + 8j + {0, 1} of rows g, g + 8
    const int ob = (chunk0 + st / per_chunk) * TL::BN + wn0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          v[j][0] = acc[i][j][2 * h];
          v[j][1] = acc[i][j][2 * h + 1];
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
        }
        const int r = row0 + wm0 + 16 * i + (lane >> 2) + 8 * h;
        if (r < p.rows) epi.row(r, ob, v, p.cout, p.vec >= 2);
      }
    }
  }
  cp_async_wait<0>();
}

// Columns o and o + 1 of row p as floats: one 4-byte load for a pair,
// else two loads, the second only where o + 1 < end.
__device__ __forceinline__ float2 ld2(const bf16* p, int o, int end,
                                      bool pairs) {
  if (pairs) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + o));
  }
  return make_float2(__bfloat162float(p[o]),
                     o + 1 < end ? __bfloat162float(p[o + 1]) : 0.f);
}

// Rounds a and b to bf16 into columns o and o + 1 of row p (o + 1 only
// where < end).
__device__ __forceinline__ void st2(bf16* p, int o, int end, bool pairs,
                                    float a, float b) {
  if (pairs) {
    *reinterpret_cast<__nv_bfloat162*>(p + o) = __floats2bfloat162_rn(a, b);
    return;
  }
  p[o] = __float2bfloat16(a);
  if (o + 1 < end) p[o + 1] = __float2bfloat16(b);
}

// Launches `kernel` of tile TL over all rows (and, for a streaming tile,
// all column chunks) on `stream`; returns the launch's CUDA error.
template <class TL, class Epi>
inline int launch(void (*kernel)(ConvArgs, Epi), const ConvArgs& p,
                  const Epi& epi, cudaStream_t stream) {
  const dim3 grid((p.rows + TL::BM - 1) / TL::BM,
                  TL::RESIDENT ? 1 : (p.cout + TL::BN - 1) / TL::BN);
  kernel<<<grid, TL::THREADS, TL::smem_bytes(p.Z, p.cin), stream>>>(p, epi);
  return (int)cudaGetLastError();
}

// Whether the pointers and counts allow copies of vec channels: every
// channel count, stride and pointer a multiple of vec elements.
inline bool aligned(int vec, const void* const* ptrs, int nptr,
                    const int* counts, int ncount) {
  if (vec != 1 && vec != 2 && vec != 4 && vec != 8) return false;
  for (int i = 0; i < nptr; ++i) {
    if (ptrs[i] != nullptr &&
        reinterpret_cast<uintptr_t>(ptrs[i]) % (2 * (uintptr_t)vec) != 0) {
      return false;
    }
  }
  for (int i = 0; i < ncount; ++i) {
    if (counts[i] % vec != 0) return false;
  }
  return true;
}

// Lets `kernel` take up to a block's whole shared memory; false on error.
template <class K>
inline bool allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_LIMIT) == cudaSuccess;
}

}  // namespace tc
}  // namespace windsr
