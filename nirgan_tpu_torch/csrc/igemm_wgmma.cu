// Gathered implicit GEMM on Hopper's warpgroup MMA: the engine of kernel A
// (trunk 3x3 conv, reflect border), of kernel B5's input gradient (k3/s2
// transposed conv backward) and, in its s8 form, of kernel D (the int8
// trunk conv with the instance norm's moments).  Both are out[m, n] = sum_{tap, c} src[pixel(m,
// tap), c] W[tap, c, n] over 9 taps whose source pixel is index math, so one
// kernel serves both with the gather as a parameter (igemm_wgmma.h).
//
// What bounds it on an H100: the tensor cores (the trunk conv is 2300 FLOP
// for every byte it must move; the card's ridge is 295).  The design:
//   * A block owns 128 * (256 / N) output pixels x all N output channels, so
//     the source is gathered once.  Two consumer warpgroups each hold 64 *
//     (256 / N) rows as f32 accumulators in registers (128 a thread) and
//     run wgmma m64nNk16 on operands in shared memory; a third warpgroup
//     produces, with its registers handed to the consumers (setmaxnreg).
//   * K walks in slices of 64 channels of one tap: a row of a slice is one
//     128-byte line of the source pixel, laid into the 128-byte swizzle.  A
//     stage is the A slice (BM x 128 B) and the weight slice (N x 128 B), 48
//     KB; four stages form a ring guarded by mbarriers (full: the producers'
//     cp.async arrivals and the weight copy's bytes; empty: one arrival a
//     consumer warp).
//   * A block is persistent (one an SM) and walks its tiles with the ring
//     running on across them: the producer fills the next tile's stages
//     while the consumers store the last tile, which hides the ring's fill
//     and the epilogue (what a 9-slice tile of B5's dx loses most on).
//   * The source pixel of every (tap, row) is computed once a tile into a
//     shared-memory table (source_pixel: reflect, replicate, zero, valid or
//     stride-2 index math; -1 reads as zero through cp.async's zero fill):
//     no padded tensor exists.
//   * The weights arrive packed by the wrapper into per-slice images that
//     are already in the swizzled order, so one bulk copy fills a stage's B.
//   * Epilogue: bias in f32, one rounding to bf16, stored from the
//     accumulator registers (each quad of lanes writes 16 contiguous bytes);
//     rows past the last pixel are masked.
//   * The s8 form moves the same bytes: a 128-byte row is 128 int8 channels,
//     each k32 step of wgmma's s8 -> s32 product advances 32 bytes as a k16
//     bf16 step does, so the ring, the table and the swizzle are unchanged.
//     Its epilogue rounds the exact s32 sums to bf16 and adds each column's
//     Sigma a and Sigma a^2 (in integers, of the unrounded sums: exact, so
//     the sums do not depend on how the pixels are cut into tiles or into
//     the rows of H-sharded tiles) over the tile's rows of one image at a
//     time: each lane pair's sums through shared memory, 64 columns a
//     pass, then 4 threads a column and a butterfly, into a per-tile f64
//     slot of scratch that a second launch adds up in tile order (no float
//     atomics).

#include "igemm_wgmma.h"

#include "hopper.cuh"

namespace igemm {
namespace {

using namespace hopper;

constexpr int STAGES = 4;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2

// the stride a column of the s8 epilogue's sums in shared memory: the 32
// lane pairs' sums and 4 spare, so that neither a warp's stores nor its
// reads meet a bank twice (s8_epilogue)
constexpr int RED_STRIDE = 36;

template <int N, bool S8>
struct Tile {
  static constexpr int R = 256 / N;  // 64-row blocks of one consumer warpgroup
  static constexpr int BM = 128 * R;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = N * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int TAB_BYTES = 9 * BM * 4;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;
  // the s8 epilogue's sums of each lane pair of the 8 consumer warps over
  // its rows, EPI columns a pass: Sigma a int32, Sigma a^2 int64
  // (s8_epilogue)
  static constexpr int EPI = N == 256 ? 64 : 32;
  static constexpr int RED_BYTES = S8 ? EPI * RED_STRIDE * (4 + 8) : 0;
  // 1024 spare bytes: the ring is moved up to a 1024-byte boundary
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + TAB_BYTES + BAR_BYTES + RED_BYTES;
};

template <bool S8>
struct Accum {
  using type = float;
};
template <>
struct Accum<true> {
  using type = int;
};

// a barrier of the producer warpgroup alone
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// a barrier of the two consumer warpgroups alone
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// The s8 epilogue of one tile: the staged accumulator, then the moments of
// its columns over its rows of each image it touches (slot 0: the image of
// its first row, slot 1: the next).  hw >= BM, so no tile spans three.
template <int N>
__device__ __forceinline__ void s8_epilogue(
    const int (&d)[256 / N][N / 2], int tile, long long m0, long long M,
    int hw, int wg, int warp, int lane, int* red,
    __nv_bfloat16* __restrict__ out, double* __restrict__ part) {
  constexpr int R = 256 / N;
  constexpr int BM = 128 * R;
  const long long end = m0 + BM < M ? m0 + BM : M;
  const int img0 = (int)(m0 / hw), img1 = (int)((end - 1) / hw);
  // the image of each of this thread's rows, -1 past the last pixel
  int rimg[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = m0 + wg * (64 * R) + r * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rimg[r][h] = row + 8 * h < M ? (int)((row + 8 * h) / hw) : -1;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float v0 = __int2float_rn(d[r][4 * j]), v1 = __int2float_rn(d[r][4 * j + 1]);
      const float v2 = __int2float_rn(d[r][4 * j + 2]), v3 = __int2float_rn(d[r][4 * j + 3]);
      __nv_bfloat16* o0 = out + row * N + 8 * j + 2 * (lane & 3);
      if (rimg[r][0] >= 0)
        *reinterpret_cast<__nv_bfloat162*>(o0) = __floats2bfloat162_rn(v0, v1);
      if (rimg[r][1] >= 0)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * N) = __floats2bfloat162_rn(v2, v3);
    }
  }
  const int cw = wg * 4 + warp;  // consumer warp, 0 .. 7
  const int ct = wg * 128 + warp * 32 + lane;  // consumer thread, 0 .. 255
  // The sums in integers (a value is at most 127^2 9 Cin < 2^26 up to Cin
  // 256, its square < 2^52; a tile's sums fit 64 bits), so that they do not
  // depend on how the pixels are cut into tiles or shards.  EPI columns a
  // pass: each lane's sums over its own rows of a column pair, one column
  // kept and the other sent to the lane 16 away (lane bit 4), go to shared
  // memory (red: Sigma a, then Sigma a^2, [column][warp][lane / 4 % 4]);
  // then TPC threads a column each read a quarter or an eighth of its 32 in
  // 16-byte loads and meet by a butterfly: few live registers beside the
  // accumulators, and no shuffle chain a column.  The tile's sums go to
  // part in f64 (exact but for the rare sum past 2^53).
  constexpr int EPI = Tile<N, true>::EPI;
  constexpr int TPC = 256 / EPI;  // threads a column in the second stage
  constexpr int SPT = 32 / TPC;   // the sums each of them reads
  int* red1 = red;
  long long* red2 = reinterpret_cast<long long*>(red + EPI * RED_STRIDE);
  const int keep = (lane >> 4) & 1, slot = cw * 4 + ((lane >> 2) & 3);
  for (int img = img0; img <= img1; ++img) {
#pragma unroll
    for (int pass = 0; pass < N / EPI; ++pass) {
#pragma unroll
      for (int jj = 0; jj < EPI / 8; ++jj) {
        const int j = pass * (EPI / 8) + jj;
        int s1[2] = {0, 0};  // of at most 4 values, then of 8
        long long s2[2] = {0, 0};
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (rimg[r][h] != img) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = d[r][4 * j + 2 * h + e];
              s1[e] += v;
              s2[e] += (long long)v * v;
            }
          }
        }
        const int k1 = (keep ? s1[1] : s1[0]) +
                       __shfl_xor_sync(0xffffffffu, keep ? s1[0] : s1[1], 16);
        const long long k2 = (keep ? s2[1] : s2[0]) +
                             __shfl_xor_sync(0xffffffffu, keep ? s2[0] : s2[1], 16);
        const int at = (8 * jj + 2 * (lane & 3) + keep) * RED_STRIDE + slot;
        red1[at] = k1;
        red2[at] = k2;
      }
      consumer_sync();
      {
        const int col = ct / TPC, piece = ct % TPC;  // a column's threads: lanes
        const int4* p1 = reinterpret_cast<const int4*>(red1 + col * RED_STRIDE + piece * SPT);
        const longlong2* p2 =
            reinterpret_cast<const longlong2*>(red2 + col * RED_STRIDE + piece * SPT);
        long long t1 = 0, t2 = 0;
#pragma unroll
        for (int q = 0; q < SPT / 4; ++q) {
          const int4 a = p1[q];
          t1 += (long long)a.x + a.y + (long long)a.z + a.w;
        }
#pragma unroll
        for (int q = 0; q < SPT / 2; ++q) {
          // each lane starts at another 16 bytes: a quarter-warp's loads
          // meet no bank twice
          const longlong2 a = p2[(q + (piece >> 1)) % (SPT / 2)];
          t2 += a.x + a.y;
        }
#pragma unroll
        for (int off = 1; off < TPC; off <<= 1) {
          t1 += __shfl_xor_sync(0xffffffffu, t1, off);
          t2 += __shfl_xor_sync(0xffffffffu, t2, off);
        }
        if (piece == 0) {
          double* dst = part + ((long long)tile * 2 + (img - img0)) * 2 * N + pass * EPI + col;
          dst[0] = (double)t1;
          dst[N] = (double)t2;
        }
      }
      consumer_sync();  // red is free for the next pass, image or tile
    }
  }
}

template <int N, bool S8>
__global__ void __launch_bounds__(THREADS, 1)
igemm_wgmma_kernel(const __nv_bfloat16* __restrict__ src,
                   const uint8_t* __restrict__ wp,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, double* __restrict__ part,
                   Shape g) {
  using T = Tile<N, S8>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* tab = reinterpret_cast<int*>(smem_raw + (base - raw) +
                                    STAGES * T::STAGE_BYTES);
  const uint32_t bars = base + STAGES * T::STAGE_BYTES + T::TAB_BYTES;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (STAGES + s)
  int* red = reinterpret_cast<int*>(smem_raw + (base - raw) + STAGES * T::STAGE_BYTES +
                                    T::TAB_BYTES + T::BAR_BYTES);

  const int tid = threadIdx.x;
  const long long M = (long long)g.B * g.Ho * g.Wo;
  const int tiles = (int)((M + T::BM - 1) / T::BM);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128 + 1);        // producers + the weight copy
      mbar_init(bars + 8 * (STAGES + s), 8);  // one lane of a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int KS = g.Cs >> 6;  // 64-channel slices of one tap
  const int KT = 9 * KS;
  const int wg = tid >> 7;

  // The block is persistent: it walks tiles blockIdx.x, + gridDim.x, ...
  // and the ring runs on across them, so the producer fills the stages of
  // the next tile while the consumers store the last one.
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dec<56>();
    const int t = tid & 127, chunk = t & 7, r0 = t >> 3;
    int s = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long m0 = (long long)tile * T::BM;
      // source pixel of every (tap, row) of this tile, -1 where it reads
      // zero; the table is the producers' own
      for (int r = t; r < T::BM; r += 128) {
        const long long m = m0 + r;
        const bool ok = m < M;
        const int mm = ok ? (int)m : 0;
        const int hw = g.Ho * g.Wo;
        const int b = mm / hw;
        const int rem = mm - b * hw;
        const int oy = rem / g.Wo, ox = rem - (rem / g.Wo) * g.Wo;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          int sy, sx;
          const bool valid = ok && source_pixel(g.gather, oy, ox, tap / 3,
                                                tap % 3, g.Hs, g.Ws, sy, sx);
          tab[tap * T::BM + r] = valid ? (b * g.Hs + sy) * g.Ws + sx : -1;
        }
      }
      producer_sync();
      int tap = 0, ks = 0;
      for (int it = 0; it < KT; ++it) {
        mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
        const uint32_t a_s = base + s * T::STAGE_BYTES;
        const uint32_t full = bars + 8 * s;
        if (t == 0) {
          mbar_arrive_expect_tx(full, T::B_BYTES);
          bulk_copy(a_s + T::A_BYTES, wp + (size_t)it * T::B_BYTES,
                    T::B_BYTES, full);
        }
        const int* trow = tab + tap * T::BM;
        const __nv_bfloat16* col = src + ks * 64 + chunk * 8;
#pragma unroll 8
        for (int i = 0; i < T::BM / 16; ++i) {
          const int row = r0 + 16 * i;
          const int pix = trow[row];
          cp_async16(a_s + swizzled(row, chunk),
                     col + (long long)(pix < 0 ? 0 : pix) * g.Cs, pix >= 0);
        }
        cp_async_arrive(full);
        if (++ks == KS) {
          ks = 0;
          ++tap;
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      producer_sync();  // every read of the table is done
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_inc<224>();
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    typename Accum<S8>::type d[T::R][N / 2];
#pragma unroll
    for (int r = 0; r < T::R; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[r][i] = 0;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long m0 = (long long)tile * T::BM;
      for (int it = 0; it < KT; ++it) {
        mbar_wait(bars + 8 * s, phase);
        const uint32_t a_s = base + s * T::STAGE_BYTES + wg * (T::A_BYTES / 2);
        const uint32_t b_s = base + s * T::STAGE_BYTES + T::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t db = smem_desc(b_s + 32 * k, 16, 1024);
#pragma unroll
          for (int r = 0; r < T::R; ++r) {
            const uint64_t da = smem_desc(a_s + r * 8192 + 32 * k, 16, 1024);
            // the tile's first product overwrites the accumulators
            if constexpr (S8)
              wgmma_k32_s8<N>(d[r], da, db, (it | k) != 0);
            else
              wgmma_k16<N, 0, 0>(d[r], da, db, (it | k) != 0);
          }
        }
        wgmma_commit();
        if (it > 0) {
          // the slice before this one has been multiplied: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
        }
        prev = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
#pragma unroll
      for (int r = 0; r < T::R; ++r) settle(d[r]);

      // accumulator layout of m64nNk16 (and of m64nNk32's s32): lane l of
      // warp w holds rows 16 w + l / 4 and + 8, columns 8 j + 2 (l % 4) and
      // + 1 of each 8-wide block j
      if constexpr (S8) {
        s8_epilogue<N>(d, tile, m0, M, g.Ho * g.Wo, wg, warp, lane, red, out,
                       part);
        continue;
      }
#pragma unroll
      for (int r = 0; r < T::R; ++r) {
        const long long row = m0 + wg * (64 * T::R) + r * 64 + warp * 16 +
                              (lane >> 2);
        __nv_bfloat16* o0 = out + row * N + 2 * (lane & 3);
        __nv_bfloat16* o1 = o0 + 8 * N;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float2 bv = make_float2(0.f, 0.f);
          if (bias)
            bv = *reinterpret_cast<const float2*>(bias + 8 * j +
                                                  2 * (lane & 3));
          if (row < M)
            *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
                __floats2bfloat162_rn(d[r][4 * j] + bv.x,
                                      d[r][4 * j + 1] + bv.y);
          if (row + 8 < M)
            *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
                __floats2bfloat162_rn(d[r][4 * j + 2] + bv.x,
                                      d[r][4 * j + 3] + bv.y);
        }
      }
    }
  }
}

template <int N, bool S8>
cudaError_t launch_n(const void* src, const void* wp, const float* bias,
                     void* out, double* part, Shape g, cudaStream_t stream) {
  using T = Tile<N, S8>;
  auto kernel = igemm_wgmma_kernel<N, S8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long M = (long long)g.B * g.Ho * g.Wo;
  const long long tiles = (M + T::BM - 1) / T::BM;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const uint8_t*>(wp),
      bias, static_cast<__nv_bfloat16*>(out), part, g);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch(int N, const void* src, const void* wp, const float* bias,
                   void* out, Shape g, cudaStream_t stream) {
  // pixel indices are 32-bit in the table
  if (!takes(N, g.Cs) || g.B <= 0 || g.Ho <= 0 || g.Wo <= 0 ||
      (long long)g.B * g.Hs * g.Ws >= (1LL << 31) ||
      (long long)g.B * g.Ho * g.Wo >= (1LL << 31))
    return cudaErrorInvalidValue;
  return N == 256 ? launch_n<256, false>(src, wp, bias, out, nullptr, g, stream)
                  : launch_n<128, false>(src, wp, bias, out, nullptr, g, stream);
}

cudaError_t launch_s8(int N, const void* src, const void* wp, void* out,
                      double* part, Shape g, cudaStream_t stream) {
  const bool gather_ok = g.gather >= CONV_REFLECT && g.gather <= STRIDE2_VALID;
  if (!takes_s8(N, g.Cs, g.Ho * g.Wo) || g.B <= 0 || !gather_ok ||
      g.Hs < least_side(g.gather) || g.Ws < least_side(g.gather) ||
      g.Ho != out_side(g.gather, g.Hs) || g.Wo != out_side(g.gather, g.Ws) ||
      (long long)g.B * g.Hs * g.Ws >= (1LL << 31))
    return cudaErrorInvalidValue;
  // the gather moves bytes: a pixel is Cs / 2 16-bit elements
  Shape b = g;
  b.Cs = g.Cs / 2;
  return N == 256 ? launch_n<256, true>(src, wp, nullptr, out, part, b, stream)
                  : launch_n<128, true>(src, wp, nullptr, out, part, b, stream);
}

}  // namespace igemm
