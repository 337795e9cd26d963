// Gathered implicit GEMM on Hopper's warpgroup MMA: the engine of kernel A
// (trunk 3x3 conv, reflect border) and of kernel B5's input gradient (k3/s2
// transposed conv backward).  Both are out[m, n] = sum_{tap, c} src[pixel(m,
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
//     shared-memory table (reflect, valid or stride-2 index math; -1 reads
//     as zero through cp.async's zero fill): no padded tensor exists.
//   * The weights arrive packed by the wrapper into per-slice images that
//     are already in the swizzled order, so one bulk copy fills a stage's B.
//   * Epilogue: bias in f32, one rounding to bf16, stored from the
//     accumulator registers (each quad of lanes writes 16 contiguous bytes);
//     rows past the last pixel are masked.

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
  // 1024 spare bytes: the ring is moved up to a 1024-byte boundary
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + TAB_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ int reflect_idx(int i, int n) {
  // ReflectionPad2d for a pad smaller than n: -1 -> 1, n -> n - 2
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// a barrier of the producer warpgroup alone
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
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
          const int dy = tap / 3, dx = tap % 3;
          int sy, sx;
          if (g.gather == CONVT_BWD) {
            sy = 2 * oy - 1 + dy;
            sx = 2 * ox - 1 + dx;
          } else if (g.gather == CONV_REFLECT) {
            sy = reflect_idx(oy + dy - 1, g.Hs);
            sx = reflect_idx(ox + dx - 1, g.Ws);
          } else {
            sy = oy + dy;
            sx = ox + dx;
          }
          const bool valid = ok && sy >= 0 && sx >= 0;
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

}  // namespace igemm
