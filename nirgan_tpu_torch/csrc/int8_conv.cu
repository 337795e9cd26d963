// Kernel D: the int8 generator's 3x3 convolutions, NHWC, exact s8 x s8 ->
// s32 sums, and the instance norm's moments in the epilogue.  The border is
// index math (igemm::source_pixel), never a padded copy: at stride 1 the
// trunk's reflect, replicate or zero border, at stride 2 the zero border of
// the d1 downsample conv (k3 s2 p1, output side (n - 1) / 2 + 1; a tap
// outside the image reads 0, which is exact under symmetric quantisation).
// Without a border (CONV_VALID, STRIDE2_VALID) the source is a slab that
// carries its own border rows and columns, as the rows of one shard of an
// H-sharded tile do with their neighbours' halo rows (parallel/spatial.py):
// output side n - 2 at stride 1, (n - 3) / 2 + 1 at stride 2.
//
// Replaces _conv_moments(_pad2d(x8), w8) of nirgan_tpu/ops/int8_trunk.py
// (lines 103-108, the pads of lines 45-47) and the conv of int8_d1_forward
// (lines 130-136): XLA convolutions with preferred_element_type=int32, not
// Pallas kernels.  Outputs: the accumulator rounded to bf16 (the "staged"
// accumulator the norm reads) and, per (image, channel), Sigma a and
// Sigma a^2 in f32 of the accumulator before that rounding.
//
// What bounds it on an H100: at the serving trunk's shape (4 x 133 x 133
// pixels, 256 -> 256 channels, 9 taps) it is 83.5 G int8 operations against
// about 55 MB in and out, bound by the tensor cores: 0.042 ms at their dense
// int8 rate of 1,979 TOPS.  Stage 2's d1 (4 x 266 x 266 x 128 -> 4 x 133 x
// 133 x 256 at stride 2) is half the operations (41.7 G, 0.021 ms) against
// 72 MB (0.022 ms at 3.35 TB/s): bound by both about equally.  Two
// kernels, chosen by shape in the wrapper
// (ops/int8_trunk.py: takes_wgmma) and named by `packed`:
//   * Cin % 128 == 0, Cout 128 or 256, an image of at least a tile (the
//     generator's trunk): the s8 kernel of kernel A's wgmma engine
//     (igemm_wgmma.cu: igemm_s8_kernel; the same gather, ring and swizzle; a
//     128-byte row is 128 int8 channels; wgmma m64nNk32 s8 -> s32), one CTA
//     an SM walking an equal run of 64-row grains (half a tile where a run
//     leaves one over), whose epilogue writes the staged accumulator and
//     keeps each image's moments as running integer sums, one f64 slot a
//     (CTA, image); its own second launch adds an image's slots in CTA
//     order.  Its header has the design and what the card measured.
//   * other shapes (Cin % 32 == 0, Cout % 8 == 0): an implicit GEMM on
//     mma.sync.m16n8k32, simple rather than fast: 128 x 128 block tiles of 8
//     warps (32 x 64 each), K steps of 32 channels (32 bytes) in a
//     three-stage cp.async ring, operands read with ldmatrix from rows of 48
//     bytes (rows 8 apart fall into distinct bank groups).  Its weight is
//     K-major per output channel, (3, 3, Cout, Cin), as mma.sync's B
//     fragment reads it.  A block's 128 rows are pixels of one image only
//     (grid.z is the image), so its column sums belong to one (image,
//     channel); they go to scratch (B, tiles, 2, Cout) and
//     int8_moments_kernel adds the tiles in a fixed order.
// In the mma.sync kernel each thread sums its rows, the warp adds lanes by a
// shuffle butterfly and the warps meet in shared memory in a fixed order;
// the wgmma kernel's epilogue (igemm_wgmma.cu) adds in integers.  No float
// atomics: a batch repeats bit for bit.  The sums are exact (integers in
// the wgmma kernel's runs, f64 of integers in the mma.sync kernel's and
// across tiles and runs: a value < 2^26, its square < 2^52) and the moments
// stay f64, so they do not depend on how the pixels are cut into tiles, nor on
// how an H-sharded tile is cut into shards, whose moments are added before
// kernel E rounds them to f32 (parallel/spatial.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "igemm_wgmma.h"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // BK: int8 channels (bytes) a stage
constexpr int LD = BK + 16;                  // row pitch in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;

// D (16 x 8, s32) += A (16 x 32, s8, row-major) * B (32 x 8, s8, column-major).
// With g = lane / 4 and q = lane % 4: a0 / a1 hold bytes 4q .. 4q + 3 of rows
// g / g + 8, a2 / a3 bytes 16 + 4q ..; b0 / b1 hold k = 4q .. and 16 + 4q ..
// of column g; d holds columns 2q, 2q + 1 of row g, then of row g + 8.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 __nv_bfloat16* __restrict__ hb, double* __restrict__ part,
                 int H, int W, int Ho, int Wo, int Ci, int Co, int gather) {
  __shared__ __align__(128) int8_t As[STAGES][BM][LD];
  __shared__ __align__(128) int8_t Bs[STAGES][BN][LD];
  __shared__ double red[4][BN][2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int HW = Ho * Wo;  // output pixels of an image
  const int tile = blockIdx.x, tiles = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int p0 = tile * BM;

  // loads: A and B rows tid / 2, 16-byte chunk tid % 2 of the 32-byte step
  const int ld_row = tid >> 1, ld_chunk = (tid & 1) * 16;
  const int a_p = p0 + ld_row;
  const bool a_ok = a_p < HW;
  const int a_oy = a_ok ? a_p / Wo : 0;
  const int a_ox = a_ok ? a_p - a_oy * Wo : 0;
  const int b_n = n0 + ld_row;
  const bool b_ok = b_n < Co;
  const int8_t* xb = x + (long long)b * H * W * Ci;

  const int kc = Ci / BK;
  const int KT = 9 * kc;

  auto load = [&](int kt, int stage) {
    const int tap = kt / kc;
    const int c0 = (kt - tap * kc) * BK + ld_chunk;
    const int dy = tap / 3, dx = tap - dy * 3;
    const int8_t* src = x;
    int sy, sx;
    // a row past the image's end, or a tap outside it, reads zeros
    const bool a_in = a_ok && igemm::source_pixel(gather, a_oy, a_ox, dy, dx,
                                                   H, W, sy, sx);
    if (a_in) src = xb + ((long long)sy * W + sx) * Ci + c0;
    hopper::cp_async16(hopper::smem_u32(&As[stage][ld_row][ld_chunk]), src, a_in);
    const int8_t* wsrc = b_ok ? w + ((long long)tap * Co + b_n) * Ci + c0 : w;
    hopper::cp_async16(hopper::smem_u32(&Bs[stage][ld_row][ld_chunk]), wsrc, b_ok);
  };

  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows 32 wm, columns 64 wn
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed for all; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < KT) load(next, next % STAGES);
    hopper::cp_async_commit();
    const int s = kt % STAGES;
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hopper::ldmatrix_x4(a[i], hopper::smem_u32(
          &As[s][wm * 32 + i * 16 + (lane & 15)][(lane >> 4) * 16]));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      // matrices: (tile j, k 0-15), (j, 16-31), (j + 1, 0-15), (j + 1, 16-31)
      const int q = lane >> 3;
      uint32_t bf[4];
      hopper::ldmatrix_x4(bf, hopper::smem_u32(
          &Bs[s][wn * 64 + (j + (q >> 1)) * 8 + (lane & 7)][(q & 1) * 16]));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_s8(acc[i][j], a[i], bf[0], bf[1]);
        mma_s8(acc[i][j + 1], a[i], bf[2], bf[3]);
      }
    }
  }
  hopper::cp_async_wait<0>();

  // epilogue: the staged accumulator, and each column's sums over the rows
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = wn * 64 + j * 8 + 2 * t4;  // the block's column
    const int n = n0 + col;
    double s1[2] = {0., 0.}, s2[2] = {0., 0.};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm * 32 + i * 16 + g + 8 * h;
        const float v0 = __int2float_rn(acc[i][j][2 * h]);
        const float v1 = __int2float_rn(acc[i][j][2 * h + 1]);
        const double a0 = (double)acc[i][j][2 * h], a1 = (double)acc[i][j][2 * h + 1];
        // rows past the image's end and columns past Cout read zeros: their
        // sums add 0
        s1[0] = __dadd_rn(s1[0], a0);
        s1[1] = __dadd_rn(s1[1], a1);
        s2[0] = __dadd_rn(s2[0], __dmul_rn(a0, a0));
        s2[1] = __dadd_rn(s2[1], __dmul_rn(a1, a1));
        if (p < HW && n < Co) {
          *reinterpret_cast<__nv_bfloat162*>(hb + ((long long)b * HW + p) * Co + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    // the 8 lanes of a column pair (same t4) meet by a butterfly; a + b is
    // the same float as b + a, so every lane ends with the same sums
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s1[e] = __dadd_rn(s1[e], __shfl_xor_sync(0xffffffffu, s1[e], off));
        s2[e] = __dadd_rn(s2[e], __shfl_xor_sync(0xffffffffu, s2[e], off));
      }
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[wm][col + e][0] = s1[e];
        red[wm][col + e][1] = s2[e];
      }
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < Co) {
    // the four warps along M in order
    double t1 = red[0][tid][0], t2 = red[0][tid][1];
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      t1 = __dadd_rn(t1, red[m][tid][0]);
      t2 = __dadd_rn(t2, red[m][tid][1]);
    }
    double* dst = part + ((long long)b * tiles + tile) * 2 * Co + n0 + tid;
    dst[0] = t1;
    dst[Co] = t2;
  }
}

// moments (B, 2, Co) f64 from the mma.sync kernel's partial sums (B, tiles,
// 2, Co), added in a fixed order.  A block takes 32 channels of one image:
// each of its 16 rows of threads adds a contiguous run of the image's tiles
// in tile order, then row 0 adds the 16 runs in row order.
constexpr int RED_ROWS = 16;

__global__ void __launch_bounds__(32 * RED_ROWS)
int8_moments_kernel(const double* __restrict__ part, double* __restrict__ moments,
                    int Co, int tiles) {
  __shared__ double red[RED_ROWS][32][2];
  const int b = blockIdx.y, lc = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lc;
  const int run = (tiles + RED_ROWS - 1) / RED_ROWS;
  const int first = row * run;
  const int last = first + run < tiles ? first + run : tiles;
  double s1 = 0., s2 = 0.;
  if (c < Co) {
#pragma unroll 4
    for (int t = first; t < last; ++t) {
      const double* src = part + ((long long)b * tiles + t) * 2 * Co + c;
      s1 = __dadd_rn(s1, src[0]);
      s2 = __dadd_rn(s2, src[Co]);
    }
  }
  red[row][lc][0] = s1;
  red[row][lc][1] = s2;
  __syncthreads();
  if (row == 0 && c < Co) {
    for (int r = 1; r < RED_ROWS; ++r) {
      s1 = __dadd_rn(s1, red[r][lc][0]);
      s2 = __dadd_rn(s2, red[r][lc][1]);
    }
    moments[(long long)b * 2 * Co + c] = s1;
    moments[(long long)b * 2 * Co + Co + c] = s2;
  }
}

}  // namespace

// x8 (B, H, W, Ci) int8 is contiguous NHWC, hb (B, Ho, Wo, Co) bf16 with
// (Ho, Wo) = (igemm::out_side(gather, H), igemm::out_side(gather, W)),
// moments f64 (B, 2, Co).  gather: any igemm::Gather (H, W >=
// igemm::least_side(gather)).  packed = 1 runs the wgmma kernel on `tiles`
// CTAs (igemm::launch_s8), refused unless igemm::takes_s8(Co, Ci, Ho Wo): w
// is the int8 weight packed by ops/int8_trunk.py (pack_weight), part f64
// scratch (tiles + B - 1, 2, 2, Co).  packed = 0 runs the mma.sync kernel,
// refused for Ci % 32, Co % 8: w is (3, 3, Co, Ci), part (B, tiles, 2, Co)
// with tiles = ceil(Ho Wo / 128).  Returns a cudaError_t.
extern "C" int nirgan_int8_conv(int device, const void* x8, const void* w,
                                void* hb, void* part, void* moments, int B,
                                int H, int W, int Ci, int Co, int tiles,
                                int packed, int gather, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather < igemm::CONV_REFLECT || gather > igemm::STRIDE2_VALID || B <= 0 ||
      H < igemm::least_side(gather) || W < igemm::least_side(gather))
    return (int)cudaErrorInvalidValue;
  const int Ho = igemm::out_side(gather, H), Wo = igemm::out_side(gather, W);
  if (packed) {
    const igemm::Shape g{B, H, W, Ci, Ho, Wo, gather};
    return (int)igemm::launch_s8(Co, x8, w, hb, static_cast<double*>(part),
                                 static_cast<double*>(moments), g, tiles, s);
  }
  if (Ci <= 0 || Ci % BK || Co <= 0 || Co % 8 || tiles != (Ho * Wo + BM - 1) / BM)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)((Co + BN - 1) / BN), (unsigned)B);
  int8_conv_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(w),
      static_cast<__nv_bfloat16*>(hb), static_cast<double*>(part), H, W, Ho,
      Wo, Ci, Co, gather);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 rgrid((unsigned)((Co + 31) / 32), (unsigned)B);
  int8_moments_kernel<<<rgrid, 32 * RED_ROWS, 0, s>>>(
      static_cast<const double*>(part), static_cast<double*>(moments), Co, tiles);
  return (int)cudaGetLastError();
}
