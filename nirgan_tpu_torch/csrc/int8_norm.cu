// Kernel E: the int8 trunk's instance norm from the conv's moments, with the
// ReLU or the residual skip, and the quantisation of the next conv's input.
//
// Replaces _norm_from_moments and the _q8 that follows it in
// nirgan_tpu/ops/int8_trunk.py (lines 94-100 and 148-154; mode 3: the end of
// int8_d1_forward, lines 137-139, its cast to the stream's dtype in
// nirgan_tpu/models/generator.py:271 and the trunk's first _q8, line 147,
// which quantises the rounded stream): an elementwise
// pass over the staged bf16 accumulator of kernel D, with the mean and the
// rstd of each (image, channel) from D's f64 moments (each rounded once to
// f32 as it is read, JAX's f32 moments) and eps' = eps / k^2 of
// the channel:
//   mode 0  q = q8(x / s_in)                      the trunk's input stream
//   mode 1  q = q8(relu((h - mean) rstd) / s_mid)  after conv1
//   mode 2  x' = x + T((h - mean) rstd)            after conv2, in the stream
//           q = q8(x' / s_in_next)                 type T; q only where a
//                                                  next block exists
//   mode 3  x' = T(relu((h - mean) rstd))          after the stage-2 d1 conv:
//           q = q8(x' / s_in)                      the trunk's input stream
//                                                  and its first block's input
// with q8(v) = clip(round_half_even(v), -127, 127) as int8.  The normalised
// value stays f32 up to the division, which is a true division (x / s is one
// in JAX): never a product with a reciprocal, and every rounding is spelled
// out (__fdiv_rn, __fmul_rn, ...) so nvcc fuses nothing into an FMA.
//
// What bounds it on an H100: memory.  At the serving shape (4 x 133 x 133 x
// 256) mode 1 reads 2 bytes and writes 1 an element (54 MB, 0.016 ms at 3.35
// TB/s), mode 2 reads 4 and writes 3 (127 MB, 0.038 ms) and mode 3 reads 2
// and writes 3 with a bf16 stream (91 MB, 0.027 ms).  A block first
// computes the image's per-channel mean, rstd and scale into shared memory,
// one channel a thread (8 a thread, each thread its own, left modes 1 and 2
// at 29% and 68% of the bound: the constants cost as much as the ~8 pixels a
// thread takes).  Each thread then owns 8 channels of a pixel (16-byte
// loads, 8-byte int8 stores), keeps their constants in registers, and walks
// the image's pixels with a stride of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// v rounded to the stream's type and back
__device__ __forceinline__ float as_type(float v, float) { return v; }
__device__ __forceinline__ float as_type(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v / s rounded to nearest; 0 for v = 0 (exactly what the division gives,
// s > 0), which the division itself would take through its slow path: after
// a ReLU about half the values are 0
__device__ __forceinline__ float quotient(float v, float s) {
  return v == 0.f ? 0.f : __fdiv_rn(v, s);
}

__device__ __forceinline__ int8_t q8(float v) {
  const int r = __float2int_rn(v);  // half to even, saturating
  return (int8_t)(r < -127 ? -127 : (r > 127 ? 127 : r));
}

__device__ __forceinline__ void store_q8(int8_t* p, const float (&v)[8]) {
  uint2 u;
  int8_t* b = reinterpret_cast<int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = q8(v[e]);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(256)
int8_norm_kernel(const void* __restrict__ src_, const double* __restrict__ moments,
                 const float* __restrict__ eps, const float* __restrict__ s,
                 const T* __restrict__ x, T* __restrict__ out,
                 int8_t* __restrict__ q, int HW, int C, int count) {
  // the image's per-channel constants, each computed once a block: mean,
  // rstd and the scale of C channels
  extern __shared__ float consts[];
  float* mean_s = consts;
  float* rstd_s = consts + C;
  float* scale_s = consts + 2 * C;
  const int b = blockIdx.y;
  const float n = (float)count;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    scale_s[c] = s ? s[c] : 1.f;
    if (MODE != 0) {
      const float m1 = __double2float_rn(moments[(long long)b * 2 * C + c]);
      const float m2 = __double2float_rn(moments[(long long)b * 2 * C + C + c]);
      const float m = __fdiv_rn(m1, n);
      const float var = __fsub_rn(__fdiv_rn(m2, n), __fmul_rn(m, m));
      mean_s[c] = m;
      rstd_s[c] = __frsqrt_rn(__fadd_rn(var, eps[c]));
    }
  }
  __syncthreads();
  const int c8 = C / 8;
  const int rows = blockDim.x / c8;  // pixels a block takes at once
  const int cg = threadIdx.x % c8, r = threadIdx.x / c8;
  const int c0 = cg * 8;
  float mean[8], rstd[8], scale[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    scale[e] = scale_s[c0 + e];
    if (MODE != 0) {
      mean[e] = mean_s[c0 + e];
      rstd[e] = rstd_s[c0 + e];
    }
  }
  const long long base = (long long)b * HW * C + c0;
  for (int p = blockIdx.x * rows + r; p < HW; p += gridDim.x * rows) {
    const long long off = base + (long long)p * C;
    float v[8];
    if (MODE == 0) {
      load8(static_cast<const T*>(src_) + off, v);
    } else {
      load8(static_cast<const __nv_bfloat16*>(src_) + off, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__fsub_rn(v[e], mean[e]), rstd[e]);
    }
    if (MODE == 1 || MODE == 3) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
    }
    if (MODE == 3) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = as_type(v[e], T());
      store8(out + off, v);
    }
    if (MODE == 2) {
      float xs[8];
      load8(x + off, xs);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = as_type(__fadd_rn(xs[e], as_type(v[e], T())), T());
      store8(out + off, v);
    }
    if (MODE != 2 || q) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = quotient(v[e], scale[e]);
      store_q8(q + off, v);
    }
  }
}

template <typename T, int MODE>
cudaError_t launch(const void* src, const double* moments, const float* eps,
                   const float* s, const void* x, void* out, void* q, int B,
                   int HW, int C, int count, cudaStream_t stream) {
  const int c8 = C / 8;
  const int rows = c8 >= 256 ? 1 : 256 / c8;
  const int per_image = (HW + rows - 1) / rows;
  // about eight blocks an SM over the 132 of an H100, each thread several
  // pixels, so the per-thread constants are computed once for many
  const int target = (132 * 8 + B - 1) / B;
  dim3 grid((unsigned)(per_image < target ? per_image : target), (unsigned)B);
  int8_norm_kernel<T, MODE><<<grid, c8 * rows, 3 * C * sizeof(float), stream>>>(
      src, moments, eps, s, static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<int8_t*>(q), HW, C, count);
  return cudaGetLastError();
}

}  // namespace

// mode 0: src the stream (B, HW, C) in dtype (0 = f32, 1 = bf16), s (C,),
// q (B, HW, C) int8 out.  Modes 1 and 2: src the staged bf16 accumulator,
// moments (B, 2, C) f64, eps (C,) f32.  Mode 1: s = s_mid, q out.  Mode 2:
// x the stream in dtype, out the new stream, and s and q both given (the
// next block's scale and input) or both null.  Mode 3: s = s_in, out the
// stream in dtype and q out.  C % 8 == 0, C <= 2048.  count: the pixels
// the moments sum over, HW for a whole image; the tile's where an image is
// one shard of an H-sharded tile and the moments are the tile's
// (parallel/spatial.py).  Returns a cudaError_t.
extern "C" int nirgan_int8_norm(int device, int mode, int dtype, const void* src,
                                const void* moments, const void* eps,
                                const void* s, const void* x, void* out,
                                void* q, int B, int HW, int C, int count,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || HW <= 0 || C <= 0 || C % 8 || C > 2048 || dtype < 0 || dtype > 1 ||
      count <= 0)
    return (int)cudaErrorInvalidValue;
  if ((mode != 2 && (!s || !q)) || (mode != 0 && (!moments || !eps)) ||
      (mode == 2 && (!x || !out || (!s != !q))) || (mode == 3 && !out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* m = static_cast<const double*>(moments);
  const float* e = static_cast<const float*>(eps);
  const float* sc = static_cast<const float*>(s);
  switch (mode * 2 + dtype) {
    case 0: return (int)launch<float, 0>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    case 1: return (int)launch<__nv_bfloat16, 0>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    case 2:
    case 3: return (int)launch<__nv_bfloat16, 1>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    case 4: return (int)launch<float, 2>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    case 5: return (int)launch<__nv_bfloat16, 2>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    case 6: return (int)launch<float, 3>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    case 7: return (int)launch<__nv_bfloat16, 3>(src, m, e, sc, x, out, q, B, HW, C, count, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
