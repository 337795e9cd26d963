// Affine-free instance norm forward over NHWC, with an optional fused ReLU.
//
// Replaces nirgan_tpu/ops/pallas_kernels.py: instance_norm_pallas (forward:
// _fwd_kernel, _moments).  The statistics follow nirgan_tpu/ops/norm.py
// exactly: f32 sum and sum of squares, var = E[x^2] - E[x]^2, eps added, no
// clamp, scale = 1 / sqrt(var + eps); the normalisation then runs in the
// input dtype, (x - dtype(mean)) * dtype(scale), rounding after each op as
// the bf16 JAX graph does.
//
// What bounds it on an H100: no tensor-core work, two reads and one write of
// the activation (a 4 x 532 x 532 x 64 bf16 input is 72 MB), so it is bound
// by device memory.  The TPU kernel carried the sums across a sequential
// grid; here blocks run in no order, so the work is three launches with no
// cross-block state and no atomics: (1) each block reduces a slab of pixels
// of one image for every channel into its own partial sums, loads coalesced
// along C; (2) one thread per (image, channel) adds the partials in a fixed
// order, so the result does not change from run to run, and writes mean and
// scale; (3) an elementwise pass reads 16 bytes a thread, normalises and
// writes.  Fusing the statistics into the producing conv's epilogue is left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (S, B).  Thread t owns channel t % C for the pixels p of this slab
// with p % (256 / C) == t / C.  C divides 256.
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_partial_kernel(const T* __restrict__ x, float* __restrict__ part, int HW,
                  int C, int rows_per_split) {
  __shared__ float s_sum[THREADS];
  __shared__ float s_sq[THREADS];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x;
  const int G = THREADS / C;
  const int c = tid % C, g = tid / C;
  const int p0 = s * rows_per_split;
  const int p1 = min(HW, p0 + rows_per_split);
  const T* xb = x + (long long)b * HW * C;
  float sum = 0.f, sq = 0.f;
  for (int p = p0 + g; p < p1; p += G) {
    float v = to_f(xb[(long long)p * C + c]);
    sum += v;
    sq = fmaf(v, v, sq);
  }
  s_sum[tid] = sum;
  s_sq[tid] = sq;
  __syncthreads();
  if (tid < C) {
    float a = 0.f, q = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      a += s_sum[gg * C + tid];
      q += s_sq[gg * C + tid];
    }
    float* out = part + ((long long)b * S + s) * 2 * C;
    out[tid] = a;
    out[C + tid] = q;
  }
}

// one thread per (b, c): stats[b][0][c] = mean, stats[b][1][c] = scale
__global__ void in_finalize_kernel(const float* __restrict__ part,
                                   float* __restrict__ stats, int B, int C,
                                   int S, float count, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i - b * C;
  const float* p = part + (long long)b * S * 2 * C;
  float a = 0.f, q = 0.f;
  for (int s = 0; s < S; ++s) {
    a += p[(long long)s * 2 * C + c];
    q += p[(long long)s * 2 * C + C + c];
  }
  const float mean = a / count;
  const float var = q / count - mean * mean;
  stats[(long long)b * 2 * C + c] = mean;
  stats[(long long)b * 2 * C + C + c] = 1.0f / sqrtf(var + eps);
}

template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[e]);
  }
  __device__ __forceinline__ void set(int e, float v) {
    reinterpret_cast<__nv_bfloat16*>(&raw)[e] = __float2bfloat16(v);
  }
};
template <>
struct Vec8<float> {
  float4 raw[2];
  __device__ __forceinline__ float get(int e) const {
    return reinterpret_cast<const float*>(raw)[e];
  }
  __device__ __forceinline__ void set(int e, float v) {
    reinterpret_cast<float*>(raw)[e] = v;
  }
};

// grid (X, B), grid-stride over the 8-element vectors of image b; C % 8 == 0
// so a vector never straddles two pixels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_normalize_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                    T* __restrict__ y, int HW, int C, int relu) {
  const int b = blockIdx.y;
  const long long nvec = (long long)HW * C / 8;
  const long long base = (long long)b * HW * C;
  const float* mean = stats + (long long)b * 2 * C;
  const float* scale = mean + C;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * THREADS) {
    const long long off = base + v * 8;
    const int c0 = (int)((v * 8) % C);
    Vec8<T> in = *reinterpret_cast<const Vec8<T>*>(x + off);
    Vec8<T> out;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // round mean and scale to T, and each op's result to T
      const float m = to_f(from_f<T>(mean[c0 + e]));
      const float sc = to_f(from_f<T>(scale[c0 + e]));
      float d = to_f(from_f<T>(in.get(e) - m));
      float o = to_f(from_f<T>(d * sc));
      if (relu) o = fmaxf(o, 0.f);
      out.set(e, o);
    }
    *reinterpret_cast<Vec8<T>*>(y + off) = out;
  }
}

template <typename T>
int launch(const T* x, float* part, float* stats, T* y, int B, int HW, int C,
           int S, float eps, int relu, cudaStream_t st) {
  const int rows = (HW + S - 1) / S;
  in_partial_kernel<T><<<dim3(S, B), THREADS, 0, st>>>(x, part, HW, C, rows);
  in_finalize_kernel<<<(B * C + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, stats, B, C, S, (float)HW, eps);
  const long long nvec = (long long)HW * C / 8;
  long long blocks = (nvec + THREADS - 1) / THREADS;
  if (blocks > 1024) blocks = 1024;
  in_normalize_kernel<T>
      <<<dim3((unsigned)blocks, B), THREADS, 0, st>>>(x, stats, y, HW, C, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are contiguous (B, HW, C).
// part is f32 scratch of B * S * 2 * C, stats f32 scratch of B * 2 * C.
// C must divide 256 and be a multiple of 8.  Returns a cudaError_t.
extern "C" int nirgan_instance_norm(int device, int dtype, const void* x,
                                    void* part, void* stats, void* y, int B,
                                    int HW, int C, int S, float eps, int relu,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || C > THREADS || THREADS % C || C % 8 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x),
                  static_cast<float*>(part), static_cast<float*>(stats),
                  static_cast<__nv_bfloat16*>(y), B, HW, C, S, eps, relu, st);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), static_cast<float*>(part),
                  static_cast<float*>(stats), static_cast<float*>(y), B, HW, C,
                  S, eps, relu, st);
  return (int)cudaErrorInvalidValue;
}
