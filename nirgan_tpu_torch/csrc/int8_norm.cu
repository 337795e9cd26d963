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
// value stays f32 up to the quotient, which is the true division's (x / s is
// one in JAX), and every rounding is spelled out (__fmul_rn, __fsub_rn, ...)
// so nvcc fuses nothing into an FMA.
//
// The quotient without its division.  Per channel r = __frcp_rn(s), per
// element t = __fmul_rn(v, r).  With u = 2^-24, r = (1/s)(1 + e1) and t =
// (v/s)(1 + e1)(1 + e2), while the division gives fl(v/s) = (v/s)(1 + e3),
// |ei| <= u: so |t - fl(v/s)| <= (3u + u^2)|v/s| < 2^-22 |t|.  rint(t) and
// rint(fl(v/s)) differ only where a half-integer h lies between them or on
// one of them, so only where |t - h| < 2^-22 |t|.  The guard sends the
// elements where |t - h| <= 2^-21 |t| for the half-integer h nearest t
// (twice the bound: 4 to 8 ulp of t; a few elements in 10^5 at the trunk's
// scales) to q8_near, which settles them exactly from the residual v - h s
// (see there), and takes rint(t) elsewhere; a t that is NaN or infinite
// fails the test and goes there too.  v = 0 gives t = 0 and q = 0, as the
// division does; ties round half to even either way.  The bound needs r
// normal, so a block whose image has a scale outside [2^-64, 2^64] (none
// that calibrate_trunk makes; zero, infinite or NaN included) divides
// every element.  t is clipped to +-127 first, which changes no result
// (|t| > 127 puts fl(v/s) beyond 126.99997, which rounds to +-127 or past it
// and clips to +-127), so rint is one add of 1.5 * 2^23 (exact, half to
// even, for |t| <= 2^22) whose low byte is the int8: no F2I and no clip.
//
// What bounds it on an H100: memory.  At the serving shape (4 x 133 x 133 x
// 256) mode 1 reads 2 bytes and writes 1 an element (54 MB, 0.016 ms at 3.35
// TB/s), mode 2 reads 4 and writes 3 (127 MB, 0.038 ms) and mode 3 reads 2
// and writes 3 with a bf16 stream (91 MB, 0.027 ms).  The design keeps bytes
// in flight and the stream's path short.  Each thread owns 8 channels
// (16-byte loads, 8-byte int8 stores) and takes its pixels a pass at a
// time, a pass being the pixels of 64 loaded bytes (LOAD_BYTES: 4 of a bf16
// source, 2 in mode 2, ...), and the next pass's loads go out before this
// pass's arithmetic (two passes in flight).  The grid is one wave: a block
// walks a run of one image's pixels, and the blocks an image come from the
// host's plan (int8_trunk.norm_blocks: the blocks of this instance resident
// at once times the SMs, shared among the images).  The first pass goes out
// by cp.async into shared memory before the block computes its image's
// constants (mean, rstd, the scale and its reciprocal of C channels, one
// channel a thread, into shared memory), which it does not need: there it
// holds no register across the constants' calls (the slow paths of
// __fdiv_rn, __frcp_rn and __frsqrt_rn), which would make ptxas spill.  The
// loop calls no function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;     // a block's most threads: C / 8 groups x rows pixels
constexpr int LOAD_BYTES = 64;   // the bytes a thread loads for a pass of pixels
// the passes staged in shared memory during the prologue: four in mode 3,
// one elsewhere (measured, chip_smoke.py --split: in mode 2 four were no
// faster, and the conv launched after it ran 1.2-1.5 us slower)
__host__ __device__ constexpr int staged_passes(int mode) { return mode == 3 ? 4 : 1; }
constexpr float RINT_MAGIC = 12582912.f;  // 1.5 * 2^23: c + it rounds c to an integer
constexpr float GUARD = 4.76837158203125e-7f;  // 2^-21

// 8 channels of one pixel as they lie in memory: 16 bytes of bf16, 32 of f32
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load_raw(const T* p) {
  return *reinterpret_cast<const Raw8<T>*>(p);
}

__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = f[e];
}

__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
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

__device__ __forceinline__ int8_t clip127(int r) {
  return (int8_t)(r < -127 ? -127 : (r > 127 ? 127 : r));
}

// A channel's scale is nice where 2^-64 <= |s| <= 2^64: then r = 1/s is a
// normal float (the guard's bound holds) and q8_near's residual is exact.
__device__ __forceinline__ bool nice(float s) {
  return fabsf(s) >= 0x1p-64f && fabsf(s) <= 0x1p64f;
}

// q8(v / s) of an element the guard sent here, s nice, t = v r: exactly
// what clip127(__float2int_rn(__fdiv_rn(v, s))) gives, without dividing.
// t NaN (v NaN) gives 0 and |t| >= 128 (v infinite, or beyond the clip)
// +-127.  Else h, the half-integer nearest t, is also the one nearest x = v
// / s and fl(x), and e = v - h s is exact in one FMA (|x - h| < 2^-20 |x|
// leaves it a dozen significant bits, and a nice s keeps it normal); fl(x)
// = h where |x - h| <= half the spacing of floats at h, i.e. |e| <= |s|
// ulp(h) / 2 (a tie rounds to h, whose significand k + 1/2 makes even), and
// rint(h) is the even one of its two integers; elsewhere fl(x) and x lie on
// the side of h that e's sign gives.  (Below h = 1/2 the spacing halves, but
// both sides give 0 there.)
__device__ __forceinline__ int8_t q8_near(float v, float s, float t) {
  if (t != t) return 0;
  if (!(fabsf(t) < 128.f)) return t > 0.f ? 127 : -127;
  const float n = rintf(t);
  const float h = t >= n ? __fadd_rn(n, 0.5f) : __fsub_rn(n, 0.5f);
  const float e = __fmaf_rn(-h, s, v);
  const float ulp = __int_as_float((__float_as_int(fabsf(h)) & 0x7f800000) - (23 << 23));
  const int lo = (int)__fsub_rn(h, 0.5f);
  int k;
  if (fabsf(e) <= __fmul_rn(fabsf(s), __fmul_rn(0.5f, ulp))) k = lo & 1 ? lo + 1 : lo;
  else k = (e > 0.f) == (s > 0.f) ? lo + 1 : lo;
  return clip127(k);
}

// q8(v / s) of 8 channels from r = 1/s rounded (the header's guard); s is
// read only for an element the guard sends to q8_near
__device__ __forceinline__ void store_q8(int8_t* p, const float (&v)[8], const float (&r)[8],
                                         const float* s) {
  uint2 u;
  int8_t* b = reinterpret_cast<int8_t*>(&u);
  unsigned near = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fmul_rn(v[e], r[e]);
    const float c = fminf(fmaxf(t, -127.f), 127.f);
    const float m = __fadd_rn(c, RINT_MAGIC);
    const float half = __fsub_rn(0.5f, fabsf(__fsub_rn(c, __fsub_rn(m, RINT_MAGIC))));
    b[e] = (int8_t)__float_as_int(m);  // the low byte: rint(c), in [-127, 127]
    if (!(half > __fmul_rn(fabsf(t), GUARD))) near |= 1u << e;
  }
  // one element at a time, so that q8_near's code is here once (t again
  // from v and r, rather than 8 more registers live)
  while (near) {
    const int e = __ffs(near) - 1;
    near &= near - 1;
    float ve = v[0], re = r[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      ve = e == k ? v[k] : ve;
      re = e == k ? r[k] : re;
    }
    const uint32_t byte = (uint8_t)q8_near(ve, s[e], __fmul_rn(ve, re)), at = 8 * (e & 3);
    if (e < 4) u.x = (u.x & ~(0xffu << at)) | byte << at;
    else u.y = (u.y & ~(0xffu << at)) | byte << at;
  }
  *reinterpret_cast<uint2*>(p) = u;
}

// q8(v / s) of 8 channels by the true division: for a block whose image has
// a channel with a scale that is not nice
__device__ __forceinline__ void store_q8_divided(int8_t* p, const float (&v)[8],
                                                 const float* s) {
  uint2 u;
  int8_t* b = reinterpret_cast<int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    b[e] = clip127(__float2int_rn(v[e] == 0.f ? 0.f : __fdiv_rn(v[e], s[e])));
  *reinterpret_cast<uint2*>(p) = u;
}

// a block's constants of 8 channels, in registers
struct Consts {
  float mean[8], rstd[8], rcp[8];
  const float* scale;  // in shared memory
};

// one pixel's 8 channels at element offset off: the norm, the ReLU or the
// skip, the stream and the quantised output
template <typename T, int MODE, bool DIVIDED, typename S>
__device__ __forceinline__ void pixel(const Raw8<S>& a, const Raw8<T>& xs, const Consts& k,
                                      T* __restrict__ out, int8_t* __restrict__ q,
                                      long long off) {
  float v[8];
  unpack(a, v);
  if (MODE != 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__fsub_rn(v[e], k.mean[e]), k.rstd[e]);
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
  if constexpr (MODE == 2) {
    float xv[8];
    unpack(xs, xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = as_type(__fadd_rn(xv[e], as_type(v[e], T())), T());
    store8(out + off, v);
  }
  if (MODE != 2 || q) {
    if (DIVIDED) store_q8_divided(q + off, v, k.scale);
    else store_q8(q + off, v, k.rcp, k.scale);
  }
}

// the pixels of a pass: U (64 bytes loaded a thread, the stream's included)
template <typename T, int MODE>
__host__ __device__ constexpr int pass_pixels() {
  using S = typename std::conditional<MODE == 0, T, __nv_bfloat16>::type;
  constexpr int bytes = (int)sizeof(Raw8<S>) + (MODE == 2 ? (int)sizeof(Raw8<T>) : 0);
  return LOAD_BYTES / bytes > 0 ? LOAD_BYTES / bytes : 1;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
int8_norm_kernel(const void* __restrict__ src_, const double* __restrict__ moments,
                 const float* __restrict__ eps, const float* __restrict__ s,
                 const T* __restrict__ x, T* __restrict__ out,
                 int8_t* __restrict__ q, int HW, int C, int count) {
  // the source: the stream in mode 0, else the staged bf16 accumulator
  using S = typename std::conditional<MODE == 0, T, __nv_bfloat16>::type;
  constexpr int U = pass_pixels<T, MODE>();
  constexpr int W = (int)sizeof(Raw8<S>) / 16;  // 16-byte pieces of a source pixel
  constexpr int WX = MODE == 2 ? (int)sizeof(Raw8<T>) / 16 : 0;  // and of the stream's
  constexpr int PIECES = U * (W + WX);  // a pass's pieces
  constexpr int STAGED = staged_passes(MODE);
  const S* src = static_cast<const S*>(src_);
  const int b = blockIdx.y, c8 = C / 8, rows = blockDim.x / c8;
  const int c0 = threadIdx.x % c8 * 8, r = threadIdx.x / c8;
  // the block's run of the image's pixels, [p0, p1): as equal as the pixels
  // allow, the longer runs first
  const int per = HW / gridDim.x, longer = HW % gridDim.x;
  const int p0 = blockIdx.x * per + min((int)blockIdx.x, longer);
  const int p1 = p0 + per + ((int)blockIdx.x < longer ? 1 : 0);
  const long long base = (long long)b * HW * C + c0;
  const int step = U * rows;  // the pixels of a pass
  // shared memory: the constants (scale, reciprocal, mean, rstd of C
  // channels), then the first STAGED passes, piece-major
  extern __shared__ __align__(16) float consts[];
  float* scale_s = consts;
  float* rcp_s = consts + C;
  float* mean_s = consts + 2 * C;
  float* rstd_s = consts + 3 * C;
  const uint32_t staged = hopper::smem_u32(consts + 4 * C);
  auto piece = [&](int sp, int i) {
    return staged + ((sp * PIECES + i) * blockDim.x + threadIdx.x) * 16;
  };
  // the first passes go out before the constants, which they do not need,
  // by cp.async into shared memory: in flight in no register while the
  // constants' divisions and rsqrt call their slow paths
#pragma unroll
  for (int sp = 0; sp < STAGED; ++sp) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pu = p0 + r + sp * step + u * rows;
      const long long off = base + (long long)(pu < p1 ? pu : p0) * C;
#pragma unroll
      for (int w = 0; w < W; ++w)
        hopper::cp_async16(piece(sp, u * (W + WX) + w), src + off + 4 * w, pu < p1);
#pragma unroll
      for (int w = 0; w < WX; ++w)
        hopper::cp_async16(piece(sp, u * (W + WX) + W + w), x + off + 4 * w, pu < p1);
    }
  }
  hopper::cp_async_commit();
  // the image's per-channel constants, one channel a thread: the scale and
  // its reciprocal; mean and rstd in modes 1 to 3
  const float n = (float)count;
  int odd = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float sc = s ? s[c] : 1.f;
    odd |= !nice(sc);
    scale_s[c] = sc;
    rcp_s[c] = __frcp_rn(sc);
    if (MODE != 0) {
      const float m1 = __double2float_rn(moments[(long long)b * 2 * C + c]);
      const float m2 = __double2float_rn(moments[(long long)b * 2 * C + C + c]);
      const float m = __fdiv_rn(m1, n);
      const float var = __fsub_rn(__fdiv_rn(m2, n), __fmul_rn(m, m));
      mean_s[c] = m;
      rstd_s[c] = __frsqrt_rn(__fadd_rn(var, eps[c]));
    }
  }
  odd = __syncthreads_or(odd);
  Consts k;
  k.scale = scale_s + c0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    k.rcp[e] = rcp_s[c0 + e];
    if (MODE != 0) {
      k.mean[e] = mean_s[c0 + e];
      k.rstd[e] = rstd_s[c0 + e];
    }
  }
  hopper::cp_async_wait<0>();
  if (odd) {
    // a scale that is not nice: the true division, a pixel at a time
    for (int p = p0 + r; p < p1; p += rows) {
      const long long off = base + (long long)p * C;
      Raw8<T> xs;
      if constexpr (MODE == 2) xs = load_raw(x + off);
      pixel<T, MODE, true>(load_raw(src + off), xs, k, out, q, off);
    }
    return;
  }
  // then two passes in flight: the next one's loads go out before this
  // one's arithmetic
  Raw8<S> a0[U], a1[U];
  Raw8<T> x0[MODE == 2 ? U : 1], x1[MODE == 2 ? U : 1];
  auto fetch = [&](Raw8<S>(&a)[U], Raw8<T>(&xs)[MODE == 2 ? U : 1], int p) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = base + (long long)(p + u * rows) * C;
      if (p + u * rows < p1) {
        a[u] = load_raw(src + off);
        if constexpr (MODE == 2) xs[u] = load_raw(x + off);
      }
    }
  };
  auto run = [&](const Raw8<S>(&a)[U], const Raw8<T>(&xs)[MODE == 2 ? U : 1], int p) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p + u * rows < p1)
        pixel<T, MODE, false>(a[u], xs[MODE == 2 ? u : 0], k, out, q,
                              base + (long long)(p + u * rows) * C);
  };
  int p = p0 + r;
  fetch(a1, x1, p + STAGED * step);
#pragma unroll
  for (int sp = 0; sp < STAGED; ++sp) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < W; ++w) a0[u].w[w] = hopper::ld_shared16(piece(sp, u * (W + WX) + w));
      if constexpr (MODE == 2) {
#pragma unroll
        for (int w = 0; w < WX; ++w)
          x0[u].w[w] = hopper::ld_shared16(piece(sp, u * (W + WX) + W + w));
      }
    }
    run(a0, x0, p);
    p += step;
  }
  while (p < p1) {
    fetch(a0, x0, p + step);
    run(a1, x1, p);
    p += step;
    if (p >= p1) break;
    fetch(a1, x1, p + step);
    run(a0, x0, p);
    p += step;
  }
}

template <typename T, int MODE>
const void* kernel_of() {
  return reinterpret_cast<const void*>(int8_norm_kernel<T, MODE>);
}

// the kernel instance of (mode, dtype), or null
const void* instance(int mode, int dtype) {
  switch (mode * 2 + dtype) {
    case 0: return kernel_of<float, 0>();
    case 1: return kernel_of<__nv_bfloat16, 0>();
    case 2:
    case 3: return kernel_of<__nv_bfloat16, 1>();
    case 4: return kernel_of<float, 2>();
    case 5: return kernel_of<__nv_bfloat16, 2>();
    case 6: return kernel_of<float, 3>();
    case 7: return kernel_of<__nv_bfloat16, 3>();
    default: return nullptr;
  }
}

int threads_of(int C) {
  const int c8 = C / 8;
  return c8 * (c8 >= THREADS ? 1 : THREADS / c8);
}

// the constants of C channels and the staged passes
size_t smem_of(int mode, int C) {
  return 4 * (size_t)C * sizeof(float) + staged_passes(mode) * THREADS * LOAD_BYTES;
}

constexpr int MAX_DEVICES = 64;

// allows the instance of (mode, dtype) more than 48 KB of dynamic shared
// memory where C needs it: once a device, and again only for a larger C
cudaError_t allow_smem(int device, int mode, int dtype, const void* kernel, int C) {
  static size_t allowed[MAX_DEVICES][8];
  const size_t bytes = smem_of(mode, C);
  if (bytes <= 48 * 1024) return cudaSuccess;
  size_t* have = device < MAX_DEVICES ? &allowed[device][mode * 2 + dtype] : nullptr;
  if (have && *have >= bytes) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && have) *have = bytes;
  return err;
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
// (parallel/spatial.py).  blocks: the blocks of each image, 1 to HW (the
// plan, int8_trunk.norm_blocks).  Returns a cudaError_t.
extern "C" int nirgan_int8_norm(int device, int mode, int dtype, const void* src,
                                const void* moments, const void* eps,
                                const void* s, const void* x, void* out,
                                void* q, int B, int HW, int C, int count,
                                int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % 8 || C > 2048 || dtype < 0 ||
      dtype > 1 || count <= 0 || blocks <= 0 || blocks > HW)
    return (int)cudaErrorInvalidValue;
  if ((mode != 2 && (!s || !q)) || (mode != 0 && (!moments || !eps)) ||
      (mode == 2 && (!x || !out || (!s != !q))) || (mode == 3 && !out))
    return (int)cudaErrorInvalidValue;
  const void* kernel = instance(mode, dtype);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const double* m = static_cast<const double*>(moments);
  const float* e = static_cast<const float*>(eps);
  const float* sc = static_cast<const float*>(s);
  void* args[] = {&src, &m, &e, &sc, &x, &out, &q, &HW, &C, &count};
  err = allow_smem(device, mode, dtype, kernel, C);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(kernel, dim3((unsigned)blocks, (unsigned)B), dim3(threads_of(C)),
                         args, smem_of(mode, C), static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The blocks of the instance of (mode, dtype) that one SM holds at once at
// C channels (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the plan's
// device query; a negative cudaError_t on failure.
extern "C" int nirgan_int8_norm_blocks_per_sm(int device, int mode, int dtype, int C) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const void* kernel = instance(mode, dtype);
  if (!kernel || C <= 0 || C % 8 || C > 2048) return -(int)cudaErrorInvalidValue;
  err = allow_smem(device, mode, dtype, kernel, C);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads_of(C),
                                                      smem_of(mode, C));
  return err != cudaSuccess ? -(int)err : n;
}
