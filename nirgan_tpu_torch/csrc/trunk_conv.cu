// Trunk 3x3 convolution for the residual blocks, NHWC, stride 1, with the
// reflect border of ReflectionPad2d(1) mirrored in the index math.
//
// Replaces nirgan_tpu/ops/pallas_trunk.py: conv3x3_reflect_pallas
// (_v2_kernel, pad=1 mode) and conv3x3_pallas (_conv_kernel, pad=0 mode:
// VALID conv on an input that is already padded).
//
// What bounds it on an H100: the serving trunk conv (4 x 133 x 133 pixels,
// 256 -> 256 channels, 9 taps) is 83.5 GFLOP against 36 MB in and out, about
// 2300 FLOP/byte, far above the card's ~295 FLOP/byte ridge: it is bound by
// the tensor cores, 0.084 ms at their bf16 peak (0.091 ms at the train
// step's 16 x 69 x 69).  It is an implicit GEMM, M = output pixels, N =
// output channels, K = 9 taps x Cin, and no padded tensor exists: each A row
// reads its source pixel through reflect index math.  Three kernels, chosen
// by dtype and shape in nirgan_trunk_conv:
//   * bf16, Cin % 64 == 0, Cout == 256 (the generator's trunk): the wgmma
//     kernel of igemm_wgmma.cu (128 x 256 block tile, 64-channel K slices in
//     a four-stage mbarrier ring, weights pre-packed into swizzled images);
//     its header has the design.
//   * other bf16 shapes (Cin % 32 == 0, Cout % 128 == 0): the WMMA kernel
//     below, 128 x 128 tiles, 32-channel slices, two cp.async stages.
//   * f32: a register-tiled SIMT GEMM in full f32.
// The bias is added in f32 in the epilogue, then the result is rounded once
// to the input dtype.  IN statistics in the epilogue are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "igemm_wgmma.h"

namespace {

using namespace nvcuda;

__device__ __forceinline__ int reflect_idx(int i, int n) {
  // ReflectionPad2d for a pad smaller than n: -1 -> 1, n -> n - 2
  i = i < 0 ? -i : i;
  return i >= n ? 2 * n - 2 - i : i;
}

// source coordinate of output coordinate o at tap d (0..2)
__device__ __forceinline__ int src_coord(int o, int d, int n_in, int pad) {
  return pad ? reflect_idx(o + d - 1, n_in) : o + d;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;  // row pitch 80 B: 16-byte aligned, fewer conflicts
constexpr int B_LD = BN + 8;  // row pitch 272 B

__global__ void __launch_bounds__(256)
trunk_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int B, int Hi, int Wi,
                       int Ci, int Ho, int Wo, int Co, int pad) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][B_LD];
  __shared__ __align__(128) float Cs[8][16][16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long M = (long long)B * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A tile: 128 rows x 4 chunks of 8 channels; this thread loads rows
  // tid/4 and tid/4 + 64 at chunk tid%4
  const int a_col = (tid & 3) * 8;
  int a_b[2], a_oy[2], a_ox[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    long long m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < M;
    long long mm = a_ok[i] ? m : 0;
    a_b[i] = (int)(mm / ((long long)Ho * Wo));
    int rem = (int)(mm - (long long)a_b[i] * Ho * Wo);
    a_oy[i] = rem / Wo;
    a_ox[i] = rem - a_oy[i] * Wo;
  }
  // B tile: 32 rows x 16 chunks of 8 output channels; rows tid/16, +16
  const int b_col = (tid & 15) * 8;

  const int kc_per_tap = Ci / BK;
  const int KT = 9 * kc_per_tap;

  auto load_tile = [&](int kt, int stage) {
    const int tap = kt / kc_per_tap;
    const int c0 = (kt - tap * kc_per_tap) * BK;
    const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* src = x;
      if (a_ok[i]) {
        int sy = src_coord(a_oy[i], dy, Hi, pad);
        int sx = src_coord(a_ox[i], dx, Wi, pad);
        src = x + (((long long)a_b[i] * Hi + sy) * Wi + sx) * Ci + c0 + a_col;
      }
      cp_async16(&As[stage][(tid >> 2) + i * 64][a_col], src, a_ok[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = (tid >> 4) + i * 16;
      const __nv_bfloat16* src =
          w + ((long long)tap * Ci + c0 + kr) * Co + n0 + b_col;
      cp_async16(&Bs[stage][kr][b_col], src, true);
    }
    cp_async_commit();
  };

  // warp tile: 32 rows x 64 columns = 2 x 4 fragments
  const int wm = warp & 3, wn = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tile(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      load_tile(kt + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[s][wm * 32 + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[s][kk][wn * 64 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // stage s is overwritten by the next iteration's load
  }

  // epilogue: one 16x16 fragment at a time through the warp's staging tile;
  // each lane writes 8 channels (16 bytes) of one row
  const int r = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + cc;
      if (m < M) {
        __align__(16) __nv_bfloat16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = Cs[warp][r][cc + e];
          if (bias) v += bias[n + e];
          out[e] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(y + m * Co + n) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
trunk_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int B, int Hi, int Wi, int Ci, int Ho, int Wo, int Co,
                      int pad) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major (transposed)
  __shared__ __align__(16) float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long M = (long long)B * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  // A: row tid/4, channels (tid%4)*4 .. +4 of the 16-channel slice
  const int a_row = tid >> 2, a_col = (tid & 3) * 4;
  const long long am = m0 + a_row;
  const bool a_ok = am < M;
  const long long amm = a_ok ? am : 0;
  const int a_b = (int)(amm / ((long long)Ho * Wo));
  const int a_rem = (int)(amm - (long long)a_b * Ho * Wo);
  const int a_oy = a_rem / Wo, a_ox = a_rem - (a_rem / Wo) * Wo;
  // B: row tid/16, columns (tid%16)*4 .. +4
  const int b_row = tid >> 4, b_col = (tid & 15) * 4;

  float acc[4][4] = {};
  const int kc_per_tap = Ci / FBK;
  const int KT = 9 * kc_per_tap;
  for (int kt = 0; kt < KT; ++kt) {
    const int tap = kt / kc_per_tap;
    const int c0 = (kt - tap * kc_per_tap) * FBK;
    const int dy = tap / 3, dx = tap - dy * 3;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok) {
      int sy = src_coord(a_oy, dy, Hi, pad);
      int sx = src_coord(a_ox, dx, Wi, pad);
      av = *reinterpret_cast<const float4*>(
          x + (((long long)a_b * Hi + sy) * Wi + sx) * Ci + c0 + a_col);
    }
    const float4 bv = *reinterpret_cast<const float4*>(
        w + ((long long)tap * Ci + c0 + b_row) * Co + n0 + b_col);
    As[a_col + 0][a_row] = av.x;
    As[a_col + 1][a_row] = av.y;
    As[a_col + 2][a_row] = av.z;
    As[a_col + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w};
      const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (bias) {
      o.x += bias[n];
      o.y += bias[n + 1];
      o.z += bias[n + 2];
      o.w += bias[n + 3];
    }
    *reinterpret_cast<float4*>(y + m * Co + n) = o;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, Hi, Wi, Ci) and y (B, Ho, Wo, Co)
// are contiguous NHWC; bias is f32 (Co,) or null.  pad = 1: Ho = Hi, Wo = Wi,
// reflect border; pad = 0: VALID, Ho = Hi - 2, Wo = Wi - 2.  The caller
// chooses the kernel by shape (ops/trunk_conv.py: takes_wgmma, the one place
// that rule is written) and says so with packed: 1 runs the wgmma kernel on
// w laid out as the swizzled images of ops/_pack.py, and is refused unless
// that kernel takes the shape (bf16, igemm::takes(Co, Ci)); 0 runs the WMMA
// or SIMT kernel on w as (3, 3, Ci, Co) in x's dtype.  Returns a
// cudaError_t.
extern "C" int nirgan_trunk_conv(int device, int dtype, const void* x,
                                 const void* w, const void* bias, void* y,
                                 int B, int Hi, int Wi, int Ci, int Ho, int Wo,
                                 int Co, int pad, int packed, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    if (dtype != 1 || !igemm::takes(Co, Ci)) return (int)cudaErrorInvalidValue;
    const igemm::Shape g{B, Hi, Wi, Ci, Ho, Wo,
                         pad ? igemm::CONV_REFLECT : igemm::CONV_VALID};
    return (int)igemm::launch(Co, x, w, static_cast<const float*>(bias), y, g,
                              s);
  }
  if (dtype == 1) {
    if (Ci % BK || Co % BN) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((M + BM - 1) / BM), Co / BN);
    trunk_conv_bf16_kernel<<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), B, Hi, Wi, Ci, Ho, Wo, Co, pad);
  } else if (dtype == 0) {
    if (Ci % FBK || Co % FBN) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((M + FBM - 1) / FBM), Co / FBN);
    trunk_conv_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), B, Hi, Wi,
        Ci, Ho, Wo, Co, pad);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
