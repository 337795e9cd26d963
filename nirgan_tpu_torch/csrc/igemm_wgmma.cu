// Gathered implicit GEMM on Hopper's warpgroup MMA: the engine of kernel A
// (trunk 3x3 conv, reflect border), of kernel B5's input gradient (k3/s2
// transposed conv backward) and, in its s8 form, of kernel D (the int8
// trunk conv with the instance norm's moments).  All are out[m, n] =
// sum_{tap, c} src[pixel(m, tap), c] W[tap, c, n] over 9 taps whose source
// pixel is index math, so one engine serves them with the gather as a
// parameter (igemm_wgmma.h).
//
// What bounds it on an H100: the tensor cores (the trunk conv is 2300 FLOP
// for every byte it must move; the card's ridge is 295).  The bf16 kernel:
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
//
// The s8 kernel (kernel D) moves the same bytes for twice the operations: a
// 128-byte row is 128 int8 channels and each k32 step of wgmma's s8 -> s32
// product advances 32 bytes as a k16 bf16 step does, so the gather table,
// the swizzle, the weight images and the four-stage ring are the bf16
// kernel's.  At the trunk's 18 slices a tile a stage lasts about 0.56 us at
// the int8 rate.  Measured with parts cut out (chip_smoke.py --split), its
// first form, which shared the bf16 kernel's tiles, lost about as much time
// to an epilogue that stored 4 bytes a lane and met 8 barriers a tile as its
// products and ring took together, and its moments launch read a slot of
// every tile with 8 blocks at B = 1.  Its own design:
//   * CTA i of one an SM walks a contiguous run of grains (grain_run: as
//     equal runs as the grains allow, the longer ones first).  A grain is 64
//     rows at N = 256, and where a run leaves one over it ends on a half
//     tile: both consumer
//     warpgroups on the same 64 rows, each on half the columns (m64n128).
//     So the last round is balanced to half a tile (553 tiles on 132 SMs:
//     runs of 8 or 9 grains, four tiles and a half, where whole tiles alone
//     take five).  At N = 128 a grain is a tile.
//   * The moments are integer sums of the unrounded s32 accumulator (a
//     value is at most 127^2 9 Cin < 2^26, its square < 2^52): each lane
//     adds its two rows of a column, the 8 lanes of a column pair meet by
//     shuffles that halve the columns at each step, each warp leaves one
//     partial a column in its warpgroup's shared memory, and the thread of
//     a column adds the
//     four warps' to a running int64 sum of the image it is in.  When the
//     walk enters the next image, each warpgroup writes its sums to the f64
//     slot (CTA + image) of the scratch; a second launch adds an image's
//     slots in CTA order.  Integers: the sums do not depend on the tiles,
//     the runs or the H-shard (exact in f64 below 2^53).
//   * A consumer has 168 registers, 128 of them its accumulators: what
//     lives across the ring is kept to a few (the run's bounds from the
//     host's q and r and the block index, the running sums' image in
//     shared memory between tiles), so nothing spills.
//   * The bf16 rows are staged 64 columns at a time in 16 x 128 bytes a warp
//     (stmatrix, swizzled so that no two rows meet a bank) and read back as
//     whole 128-byte lines: 4 rows a warp instruction where the registers'
//     layout would write 16 bytes of 8 rows.
//   * Clusters of 2 and 4 that walked neighbouring tiles in step, each
//     stage's weight slice read from L2 once a cluster and multicast into
//     every CTA's ring, were built and measured slower than one CTA walking
//     alone at every gather (a stage is freed only when every CTA of the
//     cluster has read it, and one CTA's stall holds them all): not kept.

#include "igemm_wgmma.h"

#include "hopper.cuh"

namespace igemm {
namespace {

using namespace hopper;

constexpr int STAGES = 4;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2

template <int N>
struct Tile {
  static constexpr int R = 256 / N;  // 64-row blocks of one consumer warpgroup
  static constexpr int BM = 128 * R;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = N * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int TAB_BYTES = 9 * BM * 4;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;
  // 1024 spare bytes: the ring is moved up to a 1024-byte boundary
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + TAB_BYTES + BAR_BYTES;
};

// a barrier of the producer warpgroup alone
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The gather table of a tile: the source pixel of each of its `rows` rows
// from m0 at each tap, -1 where it reads zero (past the last pixel, or a
// tap outside the source); `t` is the producer thread, 0 .. P - 1.
template <int BM, int P>
__device__ __forceinline__ void fill_table(int* tab, int t, int rows, long long m0,
                                           long long M, const Shape& g) {
  for (int r = t; r < rows; r += P) {
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
      tab[tap * BM + r] = valid ? (b * g.Hs + sy) * g.Ws + sx : -1;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
igemm_wgmma_kernel(const __nv_bfloat16* __restrict__ src,
                   const uint8_t* __restrict__ wp,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, Shape g) {
  using T = Tile<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* tab = reinterpret_cast<int*>(smem_raw + (base - raw) +
                                    STAGES * T::STAGE_BYTES);
  const uint32_t bars = base + STAGES * T::STAGE_BYTES + T::TAB_BYTES;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (STAGES + s)

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
      // the table is the producers' own
      fill_table<T::BM, 128>(tab, t, T::BM, m0, M, g);
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
    float d[T::R][N / 2];
#pragma unroll
    for (int r = 0; r < T::R; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[r][i] = 0.f;

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

      // accumulator layout of m64nNk16: lane l of warp w holds rows 16 w +
      // l / 4 and + 8, columns 8 j + 2 (l % 4) and + 1 of each 8-wide block j
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

template <int N>
cudaError_t launch_n(const void* src, const void* wp, const float* bias,
                     void* out, Shape g, cudaStream_t stream) {
  using T = Tile<N>;
  auto kernel = igemm_wgmma_kernel<N>;
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
      bias, static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

// ------------------------------------------------------- the s8 form (D)
template <int N>
struct S8Tile {
  static constexpr int R = 256 / N;  // 64-row units of one consumer warpgroup
  static constexpr int BM = 128 * R;
  // a grain of the walk: the 64-row unit where half tiles are taken (N =
  // 256), else the tile
  static constexpr int GRAIN = N == 256 ? 64 : BM;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = N * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // a consumer warpgroup's epilogue space: its warps' staged bf16 rows (16
  // x 128 bytes a warp), and before them its warps' column sums over a
  // unit, half the columns at a time (Sigma a int32, Sigma a^2 int64: 4
  // warps x 128 columns x 12 bytes)
  static constexpr int RED_BYTES = 4 * 16 * 128;
  static_assert(4 * 128 * 12 <= RED_BYTES, "the column sums fit");
  // then its running sums of the image it is in (Sigma a, Sigma a^2 int64)
  // and that image's index
  static constexpr int ACC_BYTES = 2 * N * 8 + 16;  // 16: the next space's alignment
  static constexpr int WG_BYTES = RED_BYTES + ACC_BYTES;
  static constexpr int TAB_BYTES = 9 * BM * 4;
  static constexpr int BAR_BYTES = 2 * STAGES * 8;
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + 2 * WG_BYTES + TAB_BYTES + BAR_BYTES;
  static_assert(SMEM_BYTES <= 232448, "over the shared memory of a block");
};

// a named barrier of one consumer warpgroup (ids 3 and 4)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_of(int a, int b) {
  // the exact sum rounded to f32, then to bf16 (as the plain version)
  const __nv_bfloat162 v = __floats2bfloat162_rn(__int2float_rn(a), __int2float_rn(b));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The CTAs' runs of grains, as equal as the grains allow: `grains` = q ctas
// + r, the first r CTAs take q + 1 grains, the others q (q >= 1: no more
// CTAs than grains, so no run is empty).  q and r come from the host, so a
// CTA's run is two multiply-adds of its index and no division.
struct Runs {
  int q, r;
};

// the grains [g0, g1) of CTA `cta`
__device__ __forceinline__ void grain_run(int cta, Runs runs, int& g0, int& g1) {
  g0 = cta * runs.q + (cta < runs.r ? cta : runs.r);
  g1 = g0 + runs.q + (cta < runs.r ? 1 : 0);
}

// this CTA's g1, read anew where it is used (the block index through a
// volatile read), so that the consumers keep one register less live
__device__ __forceinline__ int run_end(Runs runs) {
  int cta, g0, g1;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(cta));
  grain_run(cta, runs, g0, g1);
  return g1;
}

// The shared-memory space of consumer warpgroup wg's epilogue (S8Tile:
// after the ring): recomputed where it is used rather than kept in
// registers across the ring.
template <int N>
__device__ __forceinline__ uint8_t* wg_space(int wg) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  return smem_raw + (base - raw) + STAGES * S8Tile<N>::STAGE_BYTES +
         wg * S8Tile<N>::WG_BYTES;
}

// A consumer warpgroup's running column sums of image `img`, after its
// column sums' space: the thread of column c % 128 owns column c (Sigma a
// at [c], Sigma a^2 at [N + c]).
template <int N>
__device__ __forceinline__ long long* running(int wg) {
  return reinterpret_cast<long long*>(wg_space<N>(wg) + S8Tile<N>::RED_BYTES);
}

// the image the running sums are of: in shared memory between epilogues,
// where a register would be one more live across the ring
template <int N>
__device__ __forceinline__ int* running_image(int wg) {
  return reinterpret_cast<int*>(running<N>(wg) + 2 * N);
}

// The sums to come are of image b >= img: write this thread's columns of
// the images before it to their f64 slots in part, clear them, and move on.
// This CTA's slot of image b is (CTA + b) 2 + wg: the CTAs' runs and the
// images both go forward, so no two (CTA, image) pairs meet.
template <int N>
__device__ __forceinline__ void move_to(int& img, int b, int wg,
                                        double* __restrict__ part) {
  long long* acc = running<N>(wg);
  for (; img < b; ++img) {
    double* dst = part + ((long long)(blockIdx.x + img) * 2 + wg) * 2 * N;
#pragma unroll
    for (int c = threadIdx.x & 127; c < N; c += 128) {
      dst[c] = (double)acc[c];
      dst[N + c] = (double)acc[N + c];
      acc[c] = 0;
      acc[N + c] = 0;
    }
  }
}

// The epilogue of one consumer warpgroup: its U units of 64 rows (from row
// `row0` of the tile at m0) x JB blocks of 8 columns (from column `col0`),
// held as m64nNk32's accumulator: lane l of warp w holds, in d[u], rows 16
// w + l / 4 and + 8 of unit u, columns 8 j + 2 (l % 4) and + 1 of block j.
// The moments of each unit's rows of each image go into the running sums;
// then the bf16 rows are staged and stored, in the warpgroup's wg_space.
template <int N, int U, int JB>
__device__ __forceinline__ void s8_epilogue(
    const int (&d)[256 / N][N / 2], long long m0, int row0, int col0,
    long long M, int hw, int warp, int lane, int wg, double* __restrict__ part,
    __nv_bfloat16* __restrict__ out) {
  constexpr int COLS = JB * 8;
  uint8_t* red = wg_space<N>(wg);
  const int tw = threadIdx.x & 127;
  const int img_then = *running_image<N>(wg);
  int img_now = img_then;
  int* red1 = reinterpret_cast<int*>(red);  // Sigma a [4 warps][128]
  long long* red2 = reinterpret_cast<long long*>(red + 4 * 128 * 4);
  const int q = lane & 3;
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long um = m0 + row0 + 64 * u;
    const long long left = M - um;
    const int rows = left <= 0 ? 0 : (left < 64 ? (int)left : 64);
    // pixel indices are below 2^31 (launch_s8): 32-bit division
    const int img = (int)((unsigned)um / (unsigned)hw);
    const long long next = (long long)(img + 1) * hw - um;
    const int split = next < rows ? (int)next : rows;
    for (int pass = 0; pass < 2; ++pass) {
      // the rows [lo, hi) of the unit that lie in its image `pass`
      const int lo = pass == 0 ? 0 : split, hi = pass == 0 ? split : rows;
      if (lo >= hi) break;  // uniform over the warpgroup
      // this lane's rows 16 w + l / 4 (+ 8) in the image's rows
      const int lr = 16 * warp + (lane >> 2);
      const bool in0 = lr >= lo && lr < hi, in1 = lr + 8 >= lo && lr + 8 < hi;
#pragma unroll
      for (int half = 0; half < (COLS + 127) / 128; ++half) {
#pragma unroll
        for (int c = 0; c < (COLS < 128 ? COLS : 128) / 16; ++c) {
          // blocks j = 2 c + jj of this half, columns 8 j + 2 q + e: this
          // lane's sums over its rows (16 w + l / 4 + 8 h) of the image
          const int j0 = 16 * half + 2 * c;
          int s1[2][2];
          long long s2[2][2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v0 = in0 ? d[u][4 * (j0 + jj) + e] : 0;
              const int v1 = in1 ? d[u][4 * (j0 + jj) + 2 + e] : 0;
              s1[jj][e] = v0 + v1;
              s2[jj][e] = (long long)v0 * v0 + (long long)v1 * v1;
            }
          // the 8 lanes of a column pair (lane bits 2-4) meet: bit 4 keeps
          // block jj = b4, bit 3 column e = b3, bit 2 adds the last pair
          int k1[2];
          long long k2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            k1[e] = (b4 ? s1[1][e] : s1[0][e]) +
                    __shfl_xor_sync(0xffffffffu, b4 ? s1[0][e] : s1[1][e], 16);
            k2[e] = (b4 ? s2[1][e] : s2[0][e]) +
                    __shfl_xor_sync(0xffffffffu, b4 ? s2[0][e] : s2[1][e], 16);
          }
          int t1 =
              (b3 ? k1[1] : k1[0]) + __shfl_xor_sync(0xffffffffu, b3 ? k1[0] : k1[1], 8);
          long long t2 =
              (b3 ? k2[1] : k2[0]) + __shfl_xor_sync(0xffffffffu, b3 ? k2[0] : k2[1], 8);
          t1 += __shfl_xor_sync(0xffffffffu, t1, 4);
          t2 += __shfl_xor_sync(0xffffffffu, t2, 4);
          if (!(lane & 4)) {
            const int at = warp * 128 + 8 * (2 * c + b4) + 2 * q + b3;
            red1[at] = t1;
            red2[at] = t2;
          }
        }
        warpgroup_sync(wg);
        // the thread of a column adds the four warps' sums to its own
        {
          const int col = col0 + 128 * half + tw;
          long long a1 = 0, a2 = 0;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            a1 += red1[w * 128 + tw];
            a2 += red2[w * 128 + tw];
          }
          move_to<N>(img_now, img + pass, wg, part);
          long long* acc = running<N>(wg);
          acc[col] += a1;
          acc[N + col] += a2;
        }
        warpgroup_sync(wg);  // red is free
      }
    }
  }
  // every thread has read the image at the start, and the passes' last
  // barrier stands between that and this write
  if (tw == 0 && img_now != img_then) *running_image<N>(wg) = img_now;
  // the bf16 rows, 64 columns at a time: stmatrix into this warp's 16 x 128
  // bytes (16-byte piece c of row r at c ^ r % 8, so that neither the 8
  // rows of a matrix nor a row read back meet a bank twice), then read back
  // and stored 4 rows of 128 bytes a warp instruction
  const uint32_t mine = smem_u32(red) + warp * 16 * 128;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long first = m0 + row0 + 64 * u + 16 * warp;
#pragma unroll
    for (int ch = 0; ch < JB / 8; ++ch) {
      const int r = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        const int jp = 4 * ch + jq;  // blocks 2 jp and 2 jp + 1
        const int c = 2 * jq + (lane >> 4);
        stmatrix_x4(mine + r * 128 + ((c ^ (r & 7)) << 4),
                    bf16x2_of(d[u][8 * jp], d[u][8 * jp + 1]),
                    bf16x2_of(d[u][8 * jp + 2], d[u][8 * jp + 3]),
                    bf16x2_of(d[u][8 * jp + 4], d[u][8 * jp + 5]),
                    bf16x2_of(d[u][8 * jp + 6], d[u][8 * jp + 7]));
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * i + (lane >> 3), c = lane & 7;
        const uint4 v = ld_shared16(mine + row * 128 + ((c ^ (row & 7)) << 4));
        if (first + row < M)
          reinterpret_cast<uint4*>(out + (first + row) * N + col0 + 64 * ch)[c] = v;
      }
      __syncwarp();
    }
  }
}

// The producer thread's part of a stage's A slice: rows r0, r0 + 16, ...
// (COUNT of them) at 16-byte chunk `chunk` of their 128-byte row, from the
// source pixels of the table's row `trow` (-1: zeros).
template <int COUNT>
__device__ __forceinline__ void gather_rows(uint32_t a_s, const int* trow,
                                            const uint8_t* col, int r0, int chunk,
                                            int Cs) {
#pragma unroll
  for (int i = 0; i < COUNT; ++i) {
    const int row = r0 + 16 * i;
    const int pix = trow[row];
    cp_async16(a_s + swizzled(row, chunk), col + (long long)(pix < 0 ? 0 : pix) * Cs,
               pix >= 0);
  }
}

// The s8 kernel: one CTA an SM, CTA i walking its run of grains in order
// (grain_run): whole tiles of BM rows, and where the run's grains leave one
// over (N = 256), a half tile of 64 rows at its end.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
igemm_s8_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ wp,
                __nv_bfloat16* __restrict__ out, double* __restrict__ part,
                Shape g, Runs runs) {
  using T = S8Tile<N>;
  constexpr int TG = T::BM / T::GRAIN;  // grains of a whole tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // the ring, each consumer warpgroup's epilogue space (wg_space), the
  // table, the barriers
  int* tab = reinterpret_cast<int*>(smem_raw + (base - raw) + STAGES * T::STAGE_BYTES +
                                    2 * T::WG_BYTES);
  const uint32_t bars =
      base + STAGES * T::STAGE_BYTES + 2 * T::WG_BYTES + T::TAB_BYTES;
  // full[s] = bars + 8 s, empty[s] = bars + 8 (STAGES + s)

  const int tid = threadIdx.x;
  const long long M = (long long)g.B * g.Ho * g.Wo;
  int g0, g1;
  grain_run(blockIdx.x, runs, g0, g1);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128 + 1);        // producers + the weight copy
      mbar_init(bars + 8 * (STAGES + s), 8);  // one lane of a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int KS = g.Cs >> 7;  // 128-channel slices of one tap
  const int KT = 9 * KS;
  const int wg = tid >> 7;

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dec<56>();
    const int t = tid & 127, chunk = t & 7, r0 = t >> 3;
    int s = 0;
    uint32_t phase = 0;
    for (int gr = g0; gr < g1; gr += TG) {
      const long long m0 = (long long)gr * T::GRAIN;
      const int rows = gr + TG <= g1 ? T::BM : 64;  // a half tile at the end
      fill_table<T::BM, 128>(tab, t, rows, m0, M, g);
      producer_sync();
      int tap = 0, ks = 0;
      for (int it = 0; it < KT; ++it) {
        mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
        const uint32_t a_s = base + s * T::STAGE_BYTES;
        const uint32_t full = bars + 8 * s;
        if (t == 0) {
          mbar_arrive_expect_tx(full, T::B_BYTES);
          bulk_copy(a_s + T::A_BYTES, wp + (size_t)it * T::B_BYTES, T::B_BYTES, full);
        }
        const int* trow = tab + tap * T::BM;
        const uint8_t* col = src + ks * 128 + chunk * 16;
        if (rows == T::BM)
          gather_rows<T::BM / 16>(a_s, trow, col, r0, chunk, g.Cs);
        else
          gather_rows<64 / 16>(a_s, trow, col, r0, chunk, g.Cs);
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
    const int hw = g.Ho * g.Wo;
    // the image of the running sums: this CTA's first
    if ((tid & 127) == 0)
      *running_image<N>(wg) = (int)((unsigned)(g0 * T::GRAIN) / (unsigned)hw);
    for (int c = tid & 127; c < 2 * N; c += 128) running<N>(wg)[c] = 0;
    int d[T::R][N / 2];
#pragma unroll
    for (int r = 0; r < T::R; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[r][i] = 0;

    int s = 0;
    uint32_t phase = 0;
    for (int gr = g0; gr < run_end(runs); gr += TG) {
      const bool half = gr + TG > run_end(runs);
      for (int it = 0; it < KT; ++it) {
        mbar_wait(bars + 8 * s, phase);
        const uint32_t a_s = base + s * T::STAGE_BYTES;
        const uint32_t b_s = a_s + T::A_BYTES;
        wgmma_fence();
        if constexpr (N == 256) {
          if (half) {
            // both warpgroups on rows 0 .. 63, each on its half of N
            int(&dh)[64] = *reinterpret_cast<int(*)[64]>(&d[0][0]);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              wgmma_k32_s8<128>(dh, smem_desc(a_s + 32 * k, 16, 1024),
                                smem_desc(b_s + wg * 128 * 128 + 32 * k, 16, 1024),
                                (it | k) != 0);
          }
        }
        if (!half) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint64_t db = smem_desc(b_s + 32 * k, 16, 1024);
#pragma unroll
            for (int r = 0; r < T::R; ++r) {
              const uint64_t da =
                  smem_desc(a_s + wg * (T::A_BYTES / 2) + r * 8192 + 32 * k, 16, 1024);
              // the tile's first product overwrites the accumulators
              wgmma_k32_s8<N>(d[r], da, db, (it | k) != 0);
            }
          }
        }
        wgmma_commit();
        if (it > 0) {
          // the slice before this one has been multiplied: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(bars + 8 * (STAGES + (s + STAGES - 1) % STAGES));
        }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + (s + STAGES - 1) % STAGES));
#pragma unroll
      for (int r = 0; r < T::R; ++r) settle(d[r]);
      // the warpgroup's epilogue space is free once its four warps have
      // read back the last tile's rows
      warpgroup_sync(wg);
      const long long m0 = (long long)gr * T::GRAIN;
      if constexpr (N == 256) {
        if (half) {
          s8_epilogue<N, 1, 16>(d, m0, 0, 128 * wg, M, hw, warp, lane, wg, part, out);
          continue;
        }
      }
      s8_epilogue<N, T::R, N / 8>(d, m0, wg * 64 * T::R, 0, M, hw, warp, lane, wg, part,
                                  out);
    }
    // this CTA's slots of the images its run touches, to the last
    const long long end = (long long)run_end(runs) * T::GRAIN;
    warpgroup_sync(wg);
    int img = *running_image<N>(wg);
    const int last = (int)((unsigned)((end < M ? end : M) - 1) / (unsigned)hw);
    move_to<N>(img, last + 1, wg, part);
  }
}

// moments (B, 2, N) f64: each image's slots in part, CTA by CTA and then
// warpgroup by warpgroup, added in that order.  A block takes 32 channels of
// one image: each of its 16 rows of threads adds a contiguous run of the
// image's CTAs (from the owner of its first grain to the owner of its
// last), then row 0 adds the 16 runs in row order.
constexpr int RED_ROWS = 16;

// the CTA whose run holds grain x
__device__ __forceinline__ int grain_owner(int x, Runs runs) {
  const int big = runs.r * (runs.q + 1);  // the grains of the longer runs
  return x < big ? x / (runs.q + 1) : runs.r + (x - big) / runs.q;
}

template <int N>
__global__ void __launch_bounds__(32 * RED_ROWS)
s8_moments_kernel(const double* __restrict__ part, double* __restrict__ moments,
                  int hw, Runs runs) {
  using T = S8Tile<N>;
  __shared__ double red[RED_ROWS][32][2];
  const int b = blockIdx.y, lc = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lc;
  const int i0 = grain_owner((int)((unsigned)(b * hw) / T::GRAIN), runs);
  const int i1 = grain_owner((int)((unsigned)(b * hw + hw - 1) / T::GRAIN), runs) + 1;
  const int per = (i1 - i0 + RED_ROWS - 1) / RED_ROWS;
  const int first = i0 + row * per;
  const int last = first + per < i1 ? first + per : i1;
  double s1 = 0., s2 = 0.;
  for (int i = first; i < last; ++i) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const double* src = part + ((long long)(i + b) * 2 + w) * 2 * N + c;
      s1 = __dadd_rn(s1, src[0]);
      s2 = __dadd_rn(s2, src[N]);
    }
  }
  red[row][lc][0] = s1;
  red[row][lc][1] = s2;
  __syncthreads();
  if (row == 0) {
    for (int r = 1; r < RED_ROWS; ++r) {
      s1 = __dadd_rn(s1, red[r][lc][0]);
      s2 = __dadd_rn(s2, red[r][lc][1]);
    }
    moments[(long long)b * 2 * N + c] = s1;
    moments[(long long)b * 2 * N + N + c] = s2;
  }
}

template <int N>
cudaError_t launch_s8_n(const void* src, const void* wp, void* out, double* part,
                        double* moments, Shape g, int ctas, cudaStream_t stream) {
  using T = S8Tile<N>;
  auto kernel = igemm_s8_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grains = (int)s8_grains(N, (long long)g.B * g.Ho * g.Wo);
  const Runs runs{grains / ctas, grains % ctas};
  kernel<<<ctas, THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(wp),
      static_cast<__nv_bfloat16*>(out), part, g, runs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  s8_moments_kernel<N><<<dim3(N / 32, g.B), 32 * RED_ROWS, 0, stream>>>(
      part, moments, g.Ho * g.Wo, runs);
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
  return N == 256 ? launch_n<256>(src, wp, bias, out, g, stream)
                  : launch_n<128>(src, wp, bias, out, g, stream);
}

cudaError_t launch_s8(int N, const void* src, const void* wp, void* out,
                      double* part, double* moments, Shape g, int ctas,
                      cudaStream_t stream) {
  const bool gather_ok = g.gather >= CONV_REFLECT && g.gather <= STRIDE2_VALID;
  if (!takes_s8(N, g.Cs, g.Ho * g.Wo) || g.B <= 0 || !gather_ok ||
      g.Hs < least_side(g.gather) || g.Ws < least_side(g.gather) ||
      g.Ho != out_side(g.gather, g.Hs) || g.Wo != out_side(g.gather, g.Ws) ||
      (long long)g.B * g.Hs * g.Ws >= (1LL << 31) || ctas <= 0 ||
      ctas > s8_grains(N, (long long)g.B * g.Ho * g.Wo))
    return cudaErrorInvalidValue;
  return N == 256 ? launch_s8_n<256>(src, wp, out, part, moments, g, ctas, stream)
                  : launch_s8_n<128>(src, wp, out, part, moments, g, ctas, stream);
}

}  // namespace igemm
