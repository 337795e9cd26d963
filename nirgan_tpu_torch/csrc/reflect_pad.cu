// The trunk backward's reflect pad at pad 1 and its adjoint, NHWC to NHWC,
// one pass each.
//
// Replaces no TPU kernel: the JAX package trains the trunk through XLA's
// convolutions on the padded input, and XLA fuses the pad and its
// transpose.  Kernel A's forward mirrors the border in its index math and
// saves only x, so the trunk conv's backward (ops/trunk_conv.py,
// trunk_conv_bwd) rebuilds the padded input for cuDNN's weight gradient and
// folds cuDNN's padded input gradient back onto x.  On a card the plain ops
// did that in two passes and nine launches: ATen's reflect pad on a
// channels-last view wrote NCHW, and a copy turned it back to NHWC; the
// adjoint was a clone of the interior and eight strided adds.
//
//   nirgan_reflection_pad_nhwc_kernel     xp (B, H+2, W+2, C) from x (B, H, W, C):
//                                         xp[b, h, w] = x[b, m(h-1, H), m(w-1, W)]
//                                         with m(-1, n) = 1, m(n, n) = n - 2
//   nirgan_reflection_pad_adjoint_kernel  dx (B, H, W, C) from dxp (B, H+2, W+2, C):
//                                         dx[b, i, j] gathers its own interior
//                                         cotangent and the pad cells that mirror it
//
// Element types: f32, bf16 and f16 (the compute dtypes a config can name),
// any C >= 1, H, W >= 2, fewer than 2^31 elements in the larger tensor.
//
// What bounds them on an H100: memory.  At the 532^2 step's trunk shape
// (16 x 133 x 133 x 256, bf16) each reads 144.9 or 149.3 MB and writes the
// other once: 294.2 MB, 0.088 ms at 3.35 TB/s.  A thread moves vectors
// along C, U of them a block-width apart, all U loads issued before the
// first store.  A vector is 16 bytes (8 bf16 or f16, 4 f32) where a pixel's
// C x itemsize is a multiple of 16 and both tensors are 16-byte aligned,
// so a warp's accesses are whole 512-byte runs and an SM holds 2048 x U x
// 16 bytes in flight; every trunk width takes that path.  Any other C takes
// one element a vector: the same index math, narrower accesses.  The grid
// is flat over the output's vectors (1024 a block), so the last wave is a
// few percent of the run.  The pad is a copy and ignores the element type;
// the mirrored rows 1 and H-2 are read twice, the second time from L2 (the
// blocks of padded rows 0 and 2 run side by side).
//
// The adjoint is exact: dx is, bit for bit, what the plain version
// (ops/pad.py, reflect_pad2d_adjoint at pad 1) gives.  That version clones
// the interior, then adds in place: the top and the bottom pad rows onto
// rows 1 and H-2, the left and right pad columns onto columns 1 and W-2,
// then the corners top-left, top-right, bottom-left, bottom-right.  Each
// add is PyTorch's: both operands in f32, the sum rounded to the tensor's
// dtype.  Here each element of dx takes the same terms in the same order:
// with s its cotangent in dxp (padded row i+1, column j+1), the pad cell
// that mirrors it is two rows or two columns away,
//   v = s
//   i == 1:             v = T(v + dxp[s - 2 rows])          top row
//   i == H-2:           v = T(v + dxp[s + 2 rows])          bottom row
//   j == 1:             v = T(v + dxp[s - 2 cols])          left column
//   j == W-2:           v = T(v + dxp[s + 2 cols])          right column
//   i == 1,   j == 1:   v = T(v + dxp[s - 2 rows - 2 cols]) corners, in
//   i == 1,   j == W-2: v = T(v + dxp[s - 2 rows + 2 cols]) this order
//   i == H-2, j == 1:   v = T(v + dxp[s + 2 rows - 2 cols])
//   i == H-2, j == W-2: v = T(v + dxp[s + 2 rows + 2 cols])
// where T rounds an f32 sum to the element type (__float2bfloat16_rn for
// bf16, __float2half_rn for f16, nothing for f32) and every sum is
// __fadd_rn.  At H = 3 (or W = 3) row 1 is both i == 1 and i == H-2, and
// takes the top, then the bottom term, as the plain version adds them.  An
// element with no mirror (all but rows 1, H-2 and columns 1, W-2) is copied
// as it is, as the clone copies it.  No atomics: a step's gradients repeat
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;  // vectors a thread keeps in flight
constexpr int VECTORS_A_BLOCK = THREADS * U;

// ReflectionPad2d(1)'s source of padded index o - 1 on a side of n >= 2
__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// V: a thread's vector, uint4 (16 bytes) or one element's bits.  v counts
// vectors in unsigned, so the last block's v never overflows.
template <typename V>
__global__ void __launch_bounds__(THREADS)
    nirgan_reflection_pad_nhwc_kernel(const V* __restrict__ x, V* __restrict__ xp, int H,
                                      int W, int cv, int total) {
  const int Hp = H + 2, Wp = W + 2;
  const unsigned v0 = blockIdx.x * VECTORS_A_BLOCK + threadIdx.x;
  V r[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned v = v0 + u * THREADS;
    if (v < (unsigned)total) {
      const int pix = (int)v / cv, c = (int)v - pix * cv;
      const int row = pix / Wp, ow = pix - row * Wp;
      const int b = row / Hp, oh = row - b * Hp;
      r[u] = __ldg(x + ((b * H + mirror(oh - 1, H)) * W + mirror(ow - 1, W)) * cv + c);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned v = v0 + u * THREADS;
    if (v < (unsigned)total) xp[v] = r[u];
  }
}

// an element type's bits, their value in f32, and PyTorch's add of two of
// them: both operands in f32, the sum rounded to the type
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = uint32_t;
  __device__ __forceinline__ static float value(Bits b) { return __uint_as_float(b); }
  __device__ __forceinline__ static Bits bits(float v) { return __float_as_uint(v); }
  __device__ __forceinline__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ __forceinline__ static float value(Bits b) {
    return __uint_as_float(uint32_t(b) << 16);
  }
  // v is exactly a bf16 value: its top half
  __device__ __forceinline__ static Bits bits(float v) { return Bits(__float_as_uint(v) >> 16); }
  __device__ __forceinline__ static float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
  }
};

template <>
struct Elem<__half> {
  using Bits = uint16_t;
  __device__ __forceinline__ static float value(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
  // v is exactly an f16 value: the rounding is exact
  __device__ __forceinline__ static Bits bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
  __device__ __forceinline__ static float add(float a, float b) {
    return __half2float(__float2half_rn(__fadd_rn(a, b)));
  }
};

// a vector V of elements T as f32 lanes
template <typename T, typename V>
struct Lanes {
  using E = Elem<T>;
  static constexpr int N = sizeof(V) / sizeof(typename E::Bits);
  union Raw {
    V v;
    typename E::Bits b[N];
  };
  float f[N];
  __device__ __forceinline__ explicit Lanes(V v) {
    Raw r;
    r.v = v;
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = E::value(r.b[k]);
  }
  __device__ __forceinline__ void add(V v) {
    const Lanes o(v);
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = E::add(f[k], o.f[k]);
  }
  __device__ __forceinline__ V pack() const {
    Raw r;
#pragma unroll
    for (int k = 0; k < N; ++k) r.b[k] = E::bits(f[k]);
    return r.v;
  }
};

// the mirror terms an element of dx takes: bits of its position
enum : int { TOP = 1, BOTTOM = 2, LEFT = 4, RIGHT = 8 };

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
    nirgan_reflection_pad_adjoint_kernel(const V* __restrict__ g, V* __restrict__ dx, int H,
                                         int W, int cv, int total) {
  const int Hp = H + 2, Wp = W + 2;
  const int rows2 = 2 * Wp * cv, cols2 = 2 * cv;  // two padded rows, two columns
  const unsigned v0 = blockIdx.x * VECTORS_A_BLOCK + threadIdx.x;
  V r[U];
  int src[U], edge[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned v = v0 + u * THREADS;
    edge[u] = 0;
    if (v < (unsigned)total) {
      const int pix = (int)v / cv, c = (int)v - pix * cv;
      const int row = pix / W, j = pix - row * W;
      const int b = row / H, i = row - b * H;
      src[u] = ((b * Hp + i + 1) * Wp + j + 1) * cv + c;
      edge[u] = (i == 1 ? TOP : 0) | (i == H - 2 ? BOTTOM : 0) | (j == 1 ? LEFT : 0) |
                (j == W - 2 ? RIGHT : 0);
      r[u] = __ldg(g + src[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned v = v0 + u * THREADS;
    if (v >= (unsigned)total) continue;
    const int e = edge[u];
    if (e) {
      const V* s = g + src[u];
      Lanes<T, V> a(r[u]);
      if (e & TOP) a.add(__ldg(s - rows2));
      if (e & BOTTOM) a.add(__ldg(s + rows2));
      if (e & LEFT) a.add(__ldg(s - cols2));
      if (e & RIGHT) a.add(__ldg(s + cols2));
      if ((e & TOP) && (e & LEFT)) a.add(__ldg(s - rows2 - cols2));
      if ((e & TOP) && (e & RIGHT)) a.add(__ldg(s - rows2 + cols2));
      if ((e & BOTTOM) && (e & LEFT)) a.add(__ldg(s + rows2 - cols2));
      if ((e & BOTTOM) && (e & RIGHT)) a.add(__ldg(s + rows2 + cols2));
      r[u] = a.pack();
    }
    dx[v] = r[u];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// a launch on x (B, H, W, C) and xp (B, H+2, W+2, C), in either direction:
// 16-byte vectors or single elements, vectors a pixel, vectors of the output
struct Plan {
  bool wide;
  int cv, total;
};

// the plan, or false for what the kernels do not take (the rule of
// ops/reflect_pad.py's launch_plan); dtype 0 f32, 1 bf16, 2 f16
bool plan_of(int dtype, const void* a, const void* b, int B, int H, int W, int C,
             bool adjoint, Plan* p) {
  if (dtype < 0 || dtype > 2 || B <= 0 || H < 2 || W < 2 || C <= 0) return false;
  if ((long long)B * (H + 2) * (W + 2) * C >= (1LL << 31)) return false;
  const int bytes = C * (dtype == 0 ? 4 : 2);
  p->wide = bytes % 16 == 0 && aligned16(a) && aligned16(b);
  p->cv = p->wide ? bytes / 16 : C;
  p->total = B * (adjoint ? H * W : (H + 2) * (W + 2)) * p->cv;
  return true;
}

unsigned blocks_of(int total) {
  return (unsigned)((total + VECTORS_A_BLOCK - 1) / VECTORS_A_BLOCK);
}

template <typename V>
int launch_pad(const void* x, void* xp, int H, int W, const Plan& p, cudaStream_t s) {
  nirgan_reflection_pad_nhwc_kernel<V><<<blocks_of(p.total), THREADS, 0, s>>>(
      static_cast<const V*>(x), static_cast<V*>(xp), H, W, p.cv, p.total);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_adjoint(const void* dxp, void* dx, int H, int W, const Plan& p, cudaStream_t s) {
  using Bits = typename Elem<T>::Bits;
  if (p.wide)
    nirgan_reflection_pad_adjoint_kernel<T, uint4><<<blocks_of(p.total), THREADS, 0, s>>>(
        static_cast<const uint4*>(dxp), static_cast<uint4*>(dx), H, W, p.cv, p.total);
  else
    nirgan_reflection_pad_adjoint_kernel<T, Bits><<<blocks_of(p.total), THREADS, 0, s>>>(
        static_cast<const Bits*>(dxp), static_cast<Bits*>(dx), H, W, p.cv, p.total);
  return (int)cudaGetLastError();
}

}  // namespace

// xp (B, H+2, W+2, C) from x (B, H, W, C), dtype 0 f32, 1 bf16, 2 f16
extern "C" int nirgan_reflect_pad(int device, int dtype, const void* x, void* xp, int B,
                                  int H, int W, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!plan_of(dtype, x, xp, B, H, W, C, false, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.wide) return launch_pad<uint4>(x, xp, H, W, p, s);
  return dtype == 0 ? launch_pad<uint32_t>(x, xp, H, W, p, s)
                    : launch_pad<uint16_t>(x, xp, H, W, p, s);
}

// dx (B, H, W, C) from dxp (B, H+2, W+2, C)
extern "C" int nirgan_reflect_pad_adjoint(int device, int dtype, const void* dxp, void* dx,
                                          int B, int H, int W, int C, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!plan_of(dtype, dxp, dx, B, H, W, C, true, &p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_adjoint<float>(dxp, dx, H, W, p, s);
  if (dtype == 1) return launch_adjoint<__nv_bfloat16>(dxp, dx, H, W, p, s);
  return launch_adjoint<__half>(dxp, dx, H, W, p, s);
}
