// Generator head: valid 7x7 conv, Cin = 64 -> Cout = 1, NHWC, on the
// reflect-padded input, with bias and tanh in the epilogue.
//
// Replaces nirgan_tpu/ops/pallas_head.py: head_conv_pallas (_forward,
// _kernel, host-built _build_wblk).  Two kernels: bf16 goes to the tensor
// cores through a Toeplitz weight (head_conv_mma_kernel), f32 (the
// card-against-CPU parity path) to an f32-FMA kernel (head_conv_kernel).
//
// What bounds it on an H100: 74 MB of bf16 input for 4 x 532 x 532 outputs
// is 0.045 ms at the memory rate; the 7.1 GFLOP of the 3136-term dot
// products are far less than that on the tensor cores and twice that on
// the f32 pipes.  So the bf16 kernel must reach the tensor cores and read
// the input about once.
//
// The tensor-core form.  With one output channel a GEMM has no N, so N is
// made of 8 neighbouring output columns x0 .. x0 + 7 of one row, as the TPU
// kernel's _build_wblk does with 64:
//   out[y, x0 + p] = sum_dy sum_j sum_c x[y + dy, x0 + j, c] W[dy][(j, c), p]
// with j in 0 .. 13 and W[dy][(j, c), p] = w[dy, j - p, c] where
// 0 <= j - p < 7, else 0: K = 7 x 896, twice the real operations.  An A row
// is 896 contiguous bf16 of one input row; the rows of neighbouring groups
// overlap and lie 1024 bytes apart, which no wgmma descriptor can name (its
// 8-row core matrices are contiguous), so the operands go through ldmatrix
// with one address a row into mma.sync.m16n8k16.  Blocking 8 output rows as
// well (N = 64) would reuse each A fragment for 8 columns of N at 4x the
// operations (61 GFLOP at the train shape: 0.1 ms even at the mma.sync
// rate); the walk below reuses each A fragment 7 times at N = 8 without
// them, so N = 8 it is.
//
// A block of 8 warps owns a strip of 64 output columns (8 groups) and two
// runs of R output rows, one under the other: the 16 rows of an mma tile
// are the 8 groups of an input row of the upper run and of the lower.  It
// walks down the input rows.  A row's A fragment feeds 7 mma, one for each
// weight row dy, into 7 accumulators that belong to the output rows y = row
// - dy; the one with dy = 6 is then complete.  The warps split K: warp w
// owns 7 of the 56 16-wide chunks and keeps its 49 B fragments (W is 100 KB
// in all) in registers for the whole walk, read once a block from the image
// that ops/_pack.py lays out in fragment order, so shared memory carries
// the input only: a ring of 4 row pairs filled by cp.async three rows ahead,
// one __syncthreads a row.  A pixel's 8 16-byte chunks are stored at chunk
// c ^ (pixel / 8 % 8), so the 8 rows of an ldmatrix, 1024 bytes apart, fall
// into 8 different bank groups.  The warps' partial sums of a finished row
// meet in shared memory (double-buffered, behind the same barrier), where
// 128 threads add them, add the bias, take tanh in f32 and round once.
// Each input row is fetched once a strip; the 6-column halo (70 / 64) and
// the 6-row halo of a run ((R + 6) / R) are read twice, out of L2.
//
// The f32 kernel: a block owns a 16 x 32 output tile, keeps the 7 x 7 x 64
// weights in shared memory, and streams the input halo tile (22 x 38
// pixels) through shared memory eight channels at a time, channel-major so
// a warp's lanes read neighbouring columns without bank conflicts; each
// thread computes two vertically adjacent outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CIN = 64, K = 7, TH = 16, TW = 32, CC = 8;
constexpr int SH = TH + K - 1, SW = TW + K - 1;  // 22 x 38 halo tile

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------- f32 FMA
// grid (ceil(Wo / 32), ceil(Ho / 16), B), 256 threads: lane = output
// column, warp = pair of output rows.
template <typename T>
__global__ void __launch_bounds__(256)
head_conv_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ y, int Hp,
                 int Wp, int Ho, int Wo) {
  __shared__ float sx[CC][SH][SW];
  __shared__ float sw[K * K * CIN];  // (ky, kx, c)

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const T* xb = x + (long long)b * Hp * Wp * CIN;

  for (int i = tid; i < K * K * CIN; i += 256) sw[i] = w[i];

  float acc0 = 0.f, acc1 = 0.f;
  for (int c0 = 0; c0 < CIN; c0 += CC) {
    __syncthreads();  // the previous slice is no longer read
    for (int p = tid; p < SH * SW; p += 256) {
      const int r = p / SW, col = p - r * SW;
      const int iy = oy0 + r, ix = ox0 + col;
      float v[CC];
      if (iy < Hp && ix < Wp) {
        load8(xb + ((long long)iy * Wp + ix) * CIN + c0, v);
      } else {
#pragma unroll
        for (int e = 0; e < CC; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CC; ++e) sx[e][r][col] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CC; ++c) {
#pragma unroll
      for (int r = 0; r < K + 1; ++r) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float v = sx[c][ty * 2 + r][tx + dx];
          if (r < K) acc0 = fmaf(v, sw[(r * K + dx) * CIN + c0 + c], acc0);
          if (r >= 1)
            acc1 = fmaf(v, sw[((r - 1) * K + dx) * CIN + c0 + c], acc1);
        }
      }
    }
  }

  const float bv = bias ? bias[0] : 0.f;
  const int ox = ox0 + tx;
  const int oy = oy0 + ty * 2;
  T* yb = y + (long long)b * Ho * Wo;
  if (ox < Wo) {
    if (oy < Ho) store1(yb + (long long)oy * Wo + ox, tanhf(acc0 + bv));
    if (oy + 1 < Ho)
      store1(yb + (long long)(oy + 1) * Wo + ox, tanhf(acc1 + bv));
  }
}

// ------------------------------------------------ bf16 on the tensor cores
namespace toeplitz {

constexpr int STRIP = 64;                 // output columns a block: 8 groups
constexpr int PX = STRIP + K - 1;         // 70 input pixels a strip row
constexpr int HALF_BYTES = 72 * 128;      // one run's input row in the ring
constexpr int STAGE_BYTES = 2 * HALF_BYTES;
constexpr int STAGES = 4;
constexpr int WARPS = 8, KC = 7;          // 16-wide K chunks a warp, 56 in all
constexpr int THREADS = WARPS * 32;
constexpr int RED = WARPS * 2 * STRIP;    // a row pair's partial sums, f32
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * RED * 4;

}  // namespace toeplitz

// grid B * strips * pairs, 8 warps.  wfrag: W in the order of mma's B
// fragments, (7 dy, 56 chunks, 32 lanes) x 8 bytes.  R: output rows a run.
__global__ void __launch_bounds__(toeplitz::THREADS, 1)
head_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint2* __restrict__ wfrag,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int Hp, int Wp, int Ho,
                     int Wo, int R, int strips, int pairs) {
  using namespace toeplitz;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = hopper::smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int blk = blockIdx.x;
  const int pair = blk % pairs;
  blk /= pairs;
  const int x0 = (blk % strips) * STRIP;
  const int b = blk / strips;
  const int ybase = pair * 2 * R;  // the upper run starts here, the lower R on
  const int steps = R + K - 1;     // input rows a run walks over
  const __nv_bfloat16* xb = x + (size_t)b * Hp * Wp * CIN;

  // input rows ybase + t (upper) and ybase + R + t (lower) into slot t % 4;
  // what lies outside the image is zero-filled
  auto fetch = [&](int t) {
    if (t < steps) {
      const uint32_t dst = ring + (t % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = ybase + half * R + t;
        const bool row_ok = row < Hp;
        const __nv_bfloat16* src_row =
            xb + (size_t)(row_ok ? row : 0) * Wp * CIN;
        for (int i = tid; i < PX * 8; i += THREADS) {
          const int px = i >> 3, cc = i & 7;
          const bool ok = row_ok && x0 + px < Wp;
          const __nv_bfloat16* src =
              ok ? src_row + (size_t)(x0 + px) * CIN + cc * 8 : xb;
          hopper::cp_async16(dst + half * HALF_BYTES + px * 128 +
                                 ((cc ^ ((px >> 3) & 7)) << 4),
                             src, ok);
        }
      }
    }
    hopper::cp_async_commit();  // an empty group keeps the count in step
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) fetch(t);

  // this warp's B fragments, all 7 weight rows of its 7 chunks
  uint2 bf[K][KC];
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int i = 0; i < KC; ++i)
      bf[dy][i] = __ldg(wfrag + ((dy * (WARPS * KC) + warp * KC + i) * 32 + lane));

  // ldmatrix: lane l addresses row l % 8 (the group) of matrix l / 8, which
  // is the upper or the lower run (bit 0) and the chunk's first or second 8
  // channels (bit 1)
  uint32_t off[KC];
  {
    const int mi = lane >> 3, g = lane & 7;
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int kc = warp * KC + i;
      const int j = kc >> 2, cc = (kc & 3) * 2 + (mi >> 1);
      off[i] = (mi & 1) * HALF_BYTES + (g * 8 + j) * 128 +
               ((cc ^ ((g + (j >> 3)) & 7)) << 4);
    }
  }

  const float bv = bias ? bias[0] : 0.f;
  __nv_bfloat16* yb = y + (size_t)b * Ho * Wo;

  // adds the warps' partial sums of the rows that step t completed
  auto finish = [&](int t) {
    if (t >= K - 1 && tid < 2 * STRIP) {
      const float* part = red + (t & 1) * RED + tid;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[w * 2 * STRIP];
      const int row = ybase + (tid >> 6) * R + t - (K - 1);
      const int col = x0 + (tid & (STRIP - 1));
      if (row < Ho && col < Wo)
        yb[(size_t)row * Wo + col] = __float2bfloat16(tanhf(s + bv));
    }
  };

  float acc[K][4];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;

  // output row o (relative to its run) lives in accumulator o % 7; t0 is a
  // multiple of 7, so every index below is known at compile time
  for (int t0 = 0; t0 < steps; t0 += K) {
#pragma unroll
    for (int rr = 0; rr < K; ++rr) {
      const int t = t0 + rr;
      if (t < steps) {
        hopper::cp_async_wait<STAGES - 2>();  // this thread's part of row t
        __syncthreads();  // everyone's; and row t - 1 is read and summed up
        fetch(t + STAGES - 1);
        finish(t - 1);
        const uint32_t stage = ring + (t % STAGES) * STAGE_BYTES;
        uint32_t a[KC][4];
#pragma unroll
        for (int i = 0; i < KC; ++i) hopper::ldmatrix_x4(a[i], stage + off[i]);
#pragma unroll
        for (int i = 0; i < KC; ++i)
#pragma unroll
          for (int dy = 0; dy < K; ++dy)
            hopper::mma_m16n8k16(acc[(rr - dy + K) % K], a[i], bf[dy][i].x,
                                 bf[dy][i].y);
        // the row with dy = 6 is complete: lane holds columns 2 (l % 4) and
        // the next of group l / 4, upper run then lower
        float(&done)[4] = acc[(rr + 1) % K];
        if (t >= K - 1) {
          float* part = red + (t & 1) * RED + warp * 2 * STRIP + lane * 2;
          *reinterpret_cast<float2*>(part) = make_float2(done[0], done[1]);
          *reinterpret_cast<float2*>(part + STRIP) = make_float2(done[2], done[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) done[e] = 0.f;
      }
    }
  }
  __syncthreads();
  finish(steps - 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, Hp, Wp, 64) contiguous NHWC,
// already reflect-padded; bias f32 (1,) or null; y (B, Hp - 6, Wp - 6) in x's
// dtype.  toeplitz = 0: w (7, 7, 64) f32, the f32-FMA kernel.  toeplitz = 1
// (bf16 only): w the Toeplitz image in mma fragment order, rows = the output
// rows a run (two runs a block), as the wrapper's plan chose them.  Returns
// a cudaError_t; a combination that the chosen kernel cannot take is
// cudaErrorInvalidValue.
extern "C" int nirgan_head_conv(int device, int dtype, const void* x,
                                const void* w, const void* bias, void* y,
                                int B, int Hp, int Wp, int toeplitz, int rows,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Ho = Hp - K + 1, Wo = Wp - K + 1;
  if (B <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (toeplitz) {
    if (dtype != 1 || rows <= 0) return (int)cudaErrorInvalidValue;
    const int strips = (Wo + toeplitz::STRIP - 1) / toeplitz::STRIP;
    const int pairs = (Ho + 2 * rows - 1) / (2 * rows);
    const long long blocks = (long long)B * strips * pairs;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    static bool allowed[64] = {};  // once a device: more than 48 KB dynamic
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidValue;
    if (!allowed[device]) {
      err = cudaFuncSetAttribute(head_conv_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 toeplitz::SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
      allowed[device] = true;
    }
    head_conv_mma_kernel<<<(unsigned)blocks, toeplitz::THREADS,
                           toeplitz::SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint2*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), Hp,
        Wp, Ho, Wo, rows, strips, pairs);
    return (int)cudaGetLastError();
  }
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  if (dtype == 1) {
    head_conv_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), Hp,
        Wp, Ho, Wo);
  } else if (dtype == 0) {
    head_conv_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), Hp, Wp, Ho,
        Wo);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
