// Affine-free instance norm over NHWC: the forward with an optional fused
// ReLU (kernel B) and its backward (kernel B4).
//
// Replaces nirgan_tpu/ops/pallas_kernels.py: instance_norm_pallas, both its
// forward (_fwd_kernel, _moments) and the backward of its custom VJP
// (_bwd_kernel).  The forward's statistics follow nirgan_tpu/ops/norm.py
// exactly: f32 sum and sum of squares, var = E[x^2] - E[x]^2, eps added, no
// clamp, scale = 1 / sqrt(var + eps); the normalisation then runs in the
// input dtype, (x - dtype(mean)) * dtype(scale), rounding after each op as
// the bf16 JAX graph does.  The backward is _bwd_kernel's formula in f32,
//   dx = r * (g - mean(g) - y * mean(g * y)),   y = (x - mean) * r,
// with g first masked by out > 0 where the forward fused the ReLU.  Mean and
// r come from the forward's stats buffer, so unlike the TPU kernel the
// backward does not recompute the moments.
//
// What bounds it on an H100: no tensor-core work.  The forward reads the
// activation twice and writes it once; the backward reads x and g (and the
// saved output for the ReLU mask) twice and writes dx once.  Both are bound
// by device memory.  The TPU kernels carried their sums across a sequential
// grid; here blocks run in no order, so each direction is three launches
// with no cross-block state and no atomics: (1) each block reduces a slab
// of pixels of one image for a group of up to 256 channels into its own
// partial sums, each thread loading 8 channels (16 bytes of bf16) per pixel
// so a warp reads whole rows; (2) one thread per (image, channel) adds the
// partials in a fixed order, so the result does not change from run to run;
// (3) an elementwise pass reads 8 channels a thread and writes the result.
// Channel groups sit on the grid's third axis, so any C that is a multiple
// of 8 is taken.  Fusing the statistics into the producing conv's epilogue
// is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VECS = 32;  // 8-channel vectors per channel group

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

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p) {
  return *reinterpret_cast<const Vec8<T>*>(p);
}

// grid (S, B, groups).  A channel group is CV <= 32 vectors of 8 channels;
// thread t owns vector t % CV of the group for the pixels p of this slab
// with p % G == t / CV, G = 256 / CV.  Forward (BWD = false): sums of x and
// x^2.  Backward: sums of g and g * y, with y recomputed in f32 from x and
// the forward's stats and g masked by out > 0 when out is given.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
in_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const T* __restrict__ out, const float* __restrict__ stats,
                  float* __restrict__ part, int HW, int C, int rows_per_split,
                  int CV) {
  __shared__ float s_a[THREADS * 8];
  __shared__ float s_q[THREADS * 8];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x;
  const int NV = C / 8, G = THREADS / CV;
  const int cv = tid % CV, grp = tid / CV;
  const int v = blockIdx.z * CV + cv;
  const bool active = grp < G && v < NV;
  const int c0 = v * 8;
  float a[8], q[8], mean[8], scale[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = q[e] = mean[e] = scale[e] = 0.f;
  if (active) {
    if (BWD) {
      const float* st = stats + (long long)b * 2 * C;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mean[e] = st[c0 + e];
        scale[e] = st[C + c0 + e];
      }
    }
    const int p0 = s * rows_per_split;
    const int p1 = min(HW, p0 + rows_per_split);
    const long long base = (long long)b * HW * C + c0;
    for (int p = p0 + grp; p < p1; p += G) {
      const long long off = base + (long long)p * C;
      const Vec8<T> xv = load8(x + off);
      if (!BWD) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xe = xv.get(e);
          a[e] += xe;
          q[e] = fmaf(xe, xe, q[e]);
        }
      } else {
        const Vec8<T> gv = load8(g + off);
        Vec8<T> ov;
        if (out) ov = load8(out + off);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float ge = gv.get(e);
          if (out && !(ov.get(e) > 0.f)) ge = 0.f;
          const float y = (xv.get(e) - mean[e]) * scale[e];
          a[e] += ge;
          q[e] = fmaf(ge, y, q[e]);
        }
      }
    }
  }
  if (grp < G) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s_a[(grp * CV + cv) * 8 + e] = a[e];
      s_q[(grp * CV + cv) * 8 + e] = q[e];
    }
  }
  __syncthreads();
  const int c = blockIdx.z * CV * 8 + tid;
  if (tid < CV * 8 && c < C) {
    float sa = 0.f, sq = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      sa += s_a[gg * CV * 8 + tid];
      sq += s_q[gg * CV * 8 + tid];
    }
    float* dst = part + ((long long)b * S + s) * 2 * C;
    dst[c] = sa;
    dst[C + c] = sq;
  }
}

// one thread per (b, c), partials added in slab order.  Forward:
// stats[b][0][c] = mean, stats[b][1][c] = scale.  Backward: the same
// layout holds mean(g) and mean(g * y).
template <bool BWD>
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
  float* dst = stats + (long long)b * 2 * C;
  if (BWD) {
    dst[c] = a / count;
    dst[C + c] = q / count;
  } else {
    const float mean = a / count;
    const float var = q / count - mean * mean;
    dst[c] = mean;
    dst[C + c] = 1.0f / sqrtf(var + eps);
  }
}

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
    const Vec8<T> in = load8(x + off);
    Vec8<T> o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // round mean and scale to T, and each op's result to T
      const float m = to_f(from_f<T>(mean[c0 + e]));
      const float sc = to_f(from_f<T>(scale[c0 + e]));
      const float d = to_f(from_f<T>(in.get(e) - m));
      float r = to_f(from_f<T>(d * sc));
      if (relu) r = fmaxf(r, 0.f);
      o.set(e, r);
    }
    *reinterpret_cast<Vec8<T>*>(y + off) = o;
  }
}

// dx = r * (g - mean(g) - y * mean(g * y)) in f32, written in T
template <typename T>
__global__ void __launch_bounds__(THREADS)
in_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ out, const float* __restrict__ stats,
                   const float* __restrict__ gstats, T* __restrict__ dx,
                   int HW, int C) {
  const int b = blockIdx.y;
  const long long nvec = (long long)HW * C / 8;
  const long long base = (long long)b * HW * C;
  const float* mean = stats + (long long)b * 2 * C;
  const float* scale = mean + C;
  const float* gmean = gstats + (long long)b * 2 * C;
  const float* gymean = gmean + C;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * THREADS) {
    const long long off = base + v * 8;
    const int c0 = (int)((v * 8) % C);
    const Vec8<T> xv = load8(x + off);
    const Vec8<T> gv = load8(g + off);
    Vec8<T> ov;
    if (out) ov = load8(out + off);
    Vec8<T> o;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      float ge = gv.get(e);
      if (out && !(ov.get(e) > 0.f)) ge = 0.f;
      const float r = scale[c];
      const float y = (xv.get(e) - mean[c]) * r;
      o.set(e, r * (ge - gmean[c] - y * gymean[c]));
    }
    *reinterpret_cast<Vec8<T>*>(dx + off) = o;
  }
}

int vecs_per_group(int C) { return C / 8 < MAX_VECS ? C / 8 : MAX_VECS; }

unsigned elementwise_blocks(int HW, int C) {
  const long long nvec = (long long)HW * C / 8;
  long long blocks = (nvec + THREADS - 1) / THREADS;
  return (unsigned)(blocks > 1024 ? 1024 : blocks);
}

template <typename T>
int launch_fwd(const T* x, float* part, float* stats, T* y, int B, int HW,
               int C, int S, float eps, int relu, cudaStream_t st) {
  const int rows = (HW + S - 1) / S;
  const int CV = vecs_per_group(C);
  const int groups = (C / 8 + CV - 1) / CV;
  in_partial_kernel<T, false><<<dim3(S, B, groups), THREADS, 0, st>>>(
      x, nullptr, nullptr, nullptr, part, HW, C, rows, CV);
  in_finalize_kernel<false><<<(B * C + THREADS - 1) / THREADS, THREADS, 0,
                              st>>>(part, stats, B, C, S, (float)HW, eps);
  in_normalize_kernel<T><<<dim3(elementwise_blocks(HW, C), B), THREADS, 0,
                           st>>>(x, stats, y, HW, C, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* x, const T* g, const T* out, const float* stats,
               float* part, float* gstats, T* dx, int B, int HW, int C, int S,
               cudaStream_t st) {
  const int rows = (HW + S - 1) / S;
  const int CV = vecs_per_group(C);
  const int groups = (C / 8 + CV - 1) / CV;
  in_partial_kernel<T, true><<<dim3(S, B, groups), THREADS, 0, st>>>(
      x, g, out, stats, part, HW, C, rows, CV);
  in_finalize_kernel<true><<<(B * C + THREADS - 1) / THREADS, THREADS, 0,
                             st>>>(part, gstats, B, C, S, (float)HW, 0.f);
  in_backward_kernel<T><<<dim3(elementwise_blocks(HW, C), B), THREADS, 0,
                          st>>>(x, g, out, stats, gstats, dx, HW, C);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int HW, int C, int S) {
  return B <= 0 || HW <= 0 || C <= 0 || C % 8 || S <= 0 || S > HW;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are contiguous (B, HW, C), C a
// multiple of 8.  part is f32 scratch of B * S * 2 * C; stats (B, 2, C) f32
// receives mean and scale, which the backward takes.  Returns a cudaError_t.
extern "C" int nirgan_instance_norm(int device, int dtype, const void* x,
                                    void* part, void* stats, void* y, int B,
                                    int HW, int C, int S, float eps, int relu,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(B, HW, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fwd(static_cast<const __nv_bfloat16*>(x),
                      static_cast<float*>(part), static_cast<float*>(stats),
                      static_cast<__nv_bfloat16*>(y), B, HW, C, S, eps, relu,
                      st);
  if (dtype == 0)
    return launch_fwd(static_cast<const float*>(x), static_cast<float*>(part),
                      static_cast<float*>(stats), static_cast<float*>(y), B,
                      HW, C, S, eps, relu, st);
  return (int)cudaErrorInvalidValue;
}

// The backward.  x, g, out (the forward's output, or null when the forward
// fused no ReLU) and dx are contiguous (B, HW, C) in one dtype; stats is the
// forward's (B, 2, C); part is f32 scratch of B * S * 2 * C and gstats f32
// scratch of B * 2 * C.  Returns a cudaError_t.
extern "C" int nirgan_instance_norm_bwd(int device, int dtype, const void* x,
                                        const void* g, const void* out,
                                        const void* stats, void* part,
                                        void* gstats, void* dx, int B, int HW,
                                        int C, int S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(B, HW, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return launch_bwd(static_cast<const T*>(x), static_cast<const T*>(g),
                      static_cast<const T*>(out),
                      static_cast<const float*>(stats),
                      static_cast<float*>(part), static_cast<float*>(gstats),
                      static_cast<T*>(dx), B, HW, C, S, st);
  }
  if (dtype == 0)
    return launch_bwd(static_cast<const float*>(x),
                      static_cast<const float*>(g),
                      static_cast<const float*>(out),
                      static_cast<const float*>(stats),
                      static_cast<float*>(part), static_cast<float*>(gstats),
                      static_cast<float*>(dx), B, HW, C, S, st);
  return (int)cudaErrorInvalidValue;
}
