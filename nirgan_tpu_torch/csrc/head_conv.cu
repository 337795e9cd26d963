// Generator head: valid 7x7 conv, Cin = 64 -> Cout = 1, NHWC, on the
// reflect-padded input, with bias and tanh in the epilogue.
//
// Replaces nirgan_tpu/ops/pallas_head.py: head_conv_pallas (_forward,
// _kernel, host-built _build_wblk).  The TPU kernel computed a factor-8
// space-to-depth grid of 64 parity channels only to fill the MXU's output
// lanes; with one output channel there is nothing for a tensor core to fill
// here, so that layout is not carried over.
//
// What bounds it on an H100: each output pixel is a 3136-term dot product
// (7 x 7 taps x 64 channels), 7.1 GFLOP for 4 x 532 x 532 outputs against a
// 74 MB bf16 input, about 95 FLOP/byte: in f32 FMA (no tensor-core shape
// fits Cout = 1) the SMs' arithmetic and shared-memory bandwidth bound it
// before device memory does.  A block owns a 16 x 32 output tile.  It keeps
// the 7 x 7 x 64 weights in shared memory as f32, and streams the input halo
// tile (22 x 38 pixels) through shared memory eight channels at a time, laid
// out channel-major so a warp's 32 lanes read 32 neighbouring columns
// without bank conflicts.  Each thread computes two vertically adjacent
// outputs and reuses every loaded value for both.  Accumulation is f32; the
// bias is added and tanh taken in f32, then the result is rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B, Hp, Wp, 64) contiguous NHWC,
// already reflect-padded; w (7, 7, 64) f32; bias f32 (1,) or null;
// y (B, Hp - 6, Wp - 6) in x's dtype.  Returns a cudaError_t.
extern "C" int nirgan_head_conv(int device, int dtype, const void* x,
                                const void* w, const void* bias, void* y,
                                int B, int Hp, int Wp, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int Ho = Hp - K + 1, Wo = Wp - K + 1;
  if (Ho <= 0 || Wo <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
