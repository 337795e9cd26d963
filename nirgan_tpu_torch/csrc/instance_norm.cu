// Affine-free instance norm over NHWC: the forward with an optional fused
// ReLU and an optional fused skip (kernel B) and its backward (kernel B4).
//
// Replaces nirgan_tpu/ops/pallas_kernels.py: instance_norm_pallas, both its
// forward (_fwd_kernel, _moments) and the backward of its custom VJP
// (_bwd_kernel).  The forward's statistics follow nirgan_tpu/ops/norm.py
// exactly: f32 sum and sum of squares, var = E[x^2] - E[x]^2, eps added, no
// clamp, scale = 1 / sqrt(var + eps); the normalisation then runs in the
// input dtype T, T(T(x - T(mean)) * T(scale)), rounding after each op as the
// bf16 JAX graph does; with a residual the result is T(residual + that).
// The backward is _bwd_kernel's formula in f32,
//   dx = r * (g - mean(g) - y * mean(g * y)),   y = (x - mean) * r,
// with g first masked where the forward fused the ReLU.  The mask is the
// sign of the forward's value, recomputed from x, mean and scale with the
// forward's own roundings, so it equals `out > 0` bit for bit and the
// forward's output is neither saved nor read.  Mean and r come from the
// forward's stats buffer.
//
// What bounds it on an H100: no tensor-core work, a handful of f32
// operations an element; the function needs the activation in once and out
// once (backward: x and g in, dx out), so device memory bounds it, and every
// further pass over the activation is the design's own cost.  The TPU kernel
// held a whole (image, channel block) slab in VMEM between the sums and the
// normalisation.  One SM's shared memory cannot, but a cluster's can, so
// there are two regimes, chosen by shape in ops/instance_norm.py:launch_plan
// (the entry points run the plan they are given and refuse one they cannot
// take):
//
//  * resident: one launch, one trip.  A cluster of 1, 2, 4 or 8 blocks owns
//    the slab of one image and one group of 32 channels (rows of 64 bytes in
//    bf16; 64 channels measured no faster), and splits its pixels by rank.
//    Each thread copies its own 16-byte pieces of the block's pixel range
//    into shared memory with cp.async, STAGES groups of UNROLL pieces in
//    flight, and adds them up as the groups land (a thread only ever reads
//    what it copied itself, so no barrier guards the data).
//    The threads' sums meet in a fixed order (shuffles, then warps, then the
//    cluster's ranks in rank order through distributed shared memory), so
//    every rank holds the same statistics and a run repeats bit for bit.
//    The block then normalises out of shared memory with the per-channel
//    constants in registers and writes 16 bytes a thread.  No scratch in
//    device memory, no second read of the activation.
//  * streaming, where no cluster can hold the slab: two launches.  The sums
//    kernel writes per-slab partial sums, four independent 16-byte loads a
//    thread in flight; the elementwise kernel first adds the partials of its
//    own channels in slab order (so no finalize launch), keeps the rounded
//    constants in registers, and walks its pixels with a fixed channel
//    vector a thread: no division and no load of a constant per element.
//    Any C that is a multiple of 8 is taken.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;      // streaming kernels
constexpr int MAX_THREADS = 512;  // resident kernel: 256 or 512
constexpr int MAX_VECS = 32;      // 16-byte vectors per streaming channel group
constexpr int GROUP = 32;         // channels of a resident slab
constexpr int STAGES = 4;         // cp.async groups in flight a thread
constexpr int UNROLL = 4;         // 16-byte pieces a group, loads a pass
// resident scratch ahead of the slab: per-warp sums, the block's sums, the
// cluster's statistics (two values a channel each)
constexpr int SCRATCH_FLOATS = 2 * (MAX_THREADS / 32) * GROUP + 4 * GROUP;
constexpr int SCRATCH_BYTES = SCRATCH_FLOATS * 4;
constexpr int MAX_SMEM = 232448;

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
__device__ __forceinline__ float rounded(float v) {
  return to_f(from_f<T>(v));
}

// 16 bytes of T: 8 bf16 or 4 f32 channels of one pixel
template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ float get(int e) const {
    return to_f(reinterpret_cast<const T*>(&raw)[e]);
  }
  __device__ __forceinline__ void set(int e, float v) {
    reinterpret_cast<T*>(&raw)[e] = from_f<T>(v);
  }
};

// a and b rounded to T and back, one conversion for the pair in bf16
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    a = __low2float(p);
    b = __high2float(p);
  }
}

// N floats rounded to T into one 16-byte piece
template <typename T>
__device__ __forceinline__ Chunk<T> pack_chunk(const float* v) {
  Chunk<T> c;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&c.raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  } else {
    c.raw = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                       __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  return c;
}

template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* p) {
  Chunk<T> c;
  c.raw = *reinterpret_cast<const uint4*>(p);
  return c;
}
template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const Chunk<T>& c) {
  *reinterpret_cast<uint4*>(p) = c.raw;
}

// a thread's per-channel constants, N channels of one 16-byte piece
template <typename T>
struct Consts {
  static constexpr int N = Chunk<T>::N;
  float mean[N], scale[N];      // f32 statistics (backward)
  float mean_t[N], scale_t[N];  // rounded to T (forward, ReLU mask)
  float gmean[N], gymean[N];    // mean(g), mean(g * y) (backward)
  __device__ __forceinline__ void set_stats(int e, float m, float s) {
    mean[e] = m;
    scale[e] = s;
    mean_t[e] = rounded<T>(m);
    scale_t[e] = rounded<T>(s);
  }
};

template <typename T>
__device__ __forceinline__ void add_moments(const Chunk<T>& xv, float* a,
                                            float* q) {
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; ++e) {
    const float xe = xv.get(e);
    a[e] += xe;
    q[e] = fmaf(xe, xe, q[e]);
  }
}

// zeroes the cotangent where the fused ReLU cut the forward: where the
// forward's value, rounded as the JAX graph rounds it, is not above zero
template <typename T>
__device__ __forceinline__ void mask_cotangent(const Chunk<T>& xv, Chunk<T>& gv,
                                               const Consts<T>& k) {
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; e += 2) {
    float d0 = xv.get(e) - k.mean_t[e], d1 = xv.get(e + 1) - k.mean_t[e + 1];
    round_pair<T>(d0, d1);
    float p0 = d0 * k.scale_t[e], p1 = d1 * k.scale_t[e + 1];
    round_pair<T>(p0, p1);
    if (!(p0 > 0.f)) gv.set(e, 0.f);
    if (!(p1 > 0.f)) gv.set(e + 1, 0.f);
  }
}

// g is already masked
template <typename T>
__device__ __forceinline__ void add_bwd_sums(const Chunk<T>& xv,
                                             const Chunk<T>& gv,
                                             const Consts<T>& k, float* a,
                                             float* q) {
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; ++e) {
    const float ge = gv.get(e);
    const float y = (xv.get(e) - k.mean[e]) * k.scale[e];
    a[e] += ge;
    q[e] = fmaf(ge, y, q[e]);
  }
}

// T(T(x - T(mean)) * T(scale)), then the ReLU, then T(residual + that).
// Where no residual follows, the ReLU is taken before the last rounding,
// which gives the same bits and saves a conversion.
template <typename T>
__device__ __forceinline__ Chunk<T> forward_chunk(const Chunk<T>& xv,
                                                  const Consts<T>& k, int relu,
                                                  const T* res) {
  Chunk<T> rv;
  if (res) rv = load_chunk(res);
  float r[Chunk<T>::N];
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; e += 2) {
    float d0 = xv.get(e) - k.mean_t[e], d1 = xv.get(e + 1) - k.mean_t[e + 1];
    round_pair<T>(d0, d1);
    // product and sum stay two roundings in f32 too: never one fused
    // multiply-add
    float p0 = __fmul_rn(d0, k.scale_t[e]), p1 = __fmul_rn(d1, k.scale_t[e + 1]);
    if (res) round_pair<T>(p0, p1);
    if (relu) {
      p0 = fmaxf(p0, 0.f);
      p1 = fmaxf(p1, 0.f);
    }
    if (res) {
      p0 = __fadd_rn(rv.get(e), p0);
      p1 = __fadd_rn(rv.get(e + 1), p1);
    }
    r[e] = p0;
    r[e + 1] = p1;
  }
  return pack_chunk<T>(r);
}

// dx = r * (g - mean(g) - y * mean(g * y)) in f32, written in T; g is
// already masked
template <typename T>
__device__ __forceinline__ Chunk<T> backward_chunk(const Chunk<T>& xv,
                                                   const Chunk<T>& gv,
                                                   const Consts<T>& k) {
  float dx[Chunk<T>::N];
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; ++e) {
    const float r = k.scale[e];
    const float y = (xv.get(e) - k.mean[e]) * r;
    dx[e] = r * (gv.get(e) - k.gmean[e] - y * k.gymean[e]);
  }
  return pack_chunk<T>(dx);
}

// sums a and q (per pixel count) -> the two values kept a channel: forward
// mean and 1 / sqrt(var + eps), backward mean(g) and mean(g * y)
template <bool BWD>
__device__ __forceinline__ void finish(float a, float q, float count, float eps,
                                       float* first, float* second) {
  if (BWD) {
    *first = a / count;
    *second = q / count;
  } else {
    const float mean = a / count;
    const float var = q / count - mean * mean;
    *first = mean;
    *second = 1.0f / sqrtf(var + eps);
  }
}

// ------------------------------------------------------------- resident
// grid (K * groups, B), clusters of K blocks along x.  The cluster owns
// channels [group * GROUP, +GROUP) of image b; rank r owns pixels [r * rows,
// +rows).  A pixel's GROUP channels are RC = GROUP / N pieces of 16 bytes; thread
// t owns piece t % RC of the pixels t / RC + i * (threads / RC), which is
// piece i * threads + t of the block's slab in shared memory.  Forward
// (BWD = false): out = y, stats written by rank 0, res the optional skip.
// Backward: g the cotangent, stats read, out = dx.
template <typename T, bool BWD>
__global__ void __launch_bounds__(MAX_THREADS)
in_resident_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ res, float* __restrict__ stats,
                   T* __restrict__ out, int HW, int C, int K, int rows,
                   float eps, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = Chunk<T>::N;
  float* s_warp = reinterpret_cast<float*>(smem);        // [2][warps][GROUP]
  float* s_block = s_warp + 2 * (MAX_THREADS / 32) * GROUP;  // [2][GROUP]
  float* s_stat = s_block + 2 * GROUP;                       // [2][GROUP]
  unsigned char* slab_x = smem + SCRATCH_BYTES;
  unsigned char* slab_g = slab_x + (size_t)rows * GROUP * sizeof(T);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int threads = blockDim.x, warps = threads / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int RC = GROUP / N;
  const int G = threads / RC;
  const int piece = tid % RC, first = tid / RC;
  const int b = blockIdx.y, c0 = (blockIdx.x / K) * GROUP + piece * N;
  const int p0 = min(HW, rank * rows), p1 = min(HW, p0 + rows);
  const int mine = first < p1 - p0 ? (p1 - p0 - first + G - 1) / G : 0;
  const long long base = ((long long)b * HW + p0 + first) * C + c0;
  const long long step = (long long)G * C;
  const uint32_t sx = hopper::smem_u32(slab_x) + tid * 16;
  const uint32_t sg = hopper::smem_u32(slab_g) + tid * 16;

  Consts<T> k;
  if (BWD) {
    const float* st = stats + (long long)b * 2 * C + c0;
#pragma unroll
    for (int e = 0; e < N; ++e) k.set_stats(e, st[e], st[C + e]);
  }

  // 1. the slab into shared memory, summed as it lands
  float a[N], q[N];
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = q[e] = 0.f;
  auto copy_group = [&](int group) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = group * UNROLL + u;
      if (i < mine) {
        hopper::cp_async16(sx + i * threads * 16, x + base + i * step, true);
        if (BWD)
          hopper::cp_async16(sg + i * threads * 16, g + base + i * step, true);
      }
    }
    hopper::cp_async_commit();
  };
  for (int j = 0; j < STAGES; ++j) copy_group(j);
  const int groups = (mine + UNROLL - 1) / UNROLL;
  for (int j = 0; j < groups; ++j) {
    hopper::cp_async_wait<STAGES - 1>();
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = j * UNROLL + u;
      if (i < mine) {
        const size_t at = ((size_t)i * threads + tid) * 16;
        const Chunk<T> xv = load_chunk(reinterpret_cast<const T*>(slab_x + at));
        if (BWD) {
          Chunk<T> gv = load_chunk(reinterpret_cast<const T*>(slab_g + at));
          if (relu) {
            // the masked cotangent goes back into the slab for phase 3
            mask_cotangent(xv, gv, k);
            store_chunk(reinterpret_cast<T*>(slab_g + at), gv);
          }
          add_bwd_sums(xv, gv, k, a, q);
        } else {
          add_moments(xv, a, q);
        }
      }
    }
    copy_group(j + STAGES);
  }
  hopper::cp_async_wait<0>();

  // 2. threads -> warp (lanes of one piece are RC apart) -> block -> cluster
#pragma unroll
  for (int off = RC; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      a[e] += __shfl_xor_sync(0xffffffffu, a[e], off);
      q[e] += __shfl_xor_sync(0xffffffffu, q[e], off);
    }
  }
  if (lane < RC) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s_warp[warp * GROUP + lane * N + e] = a[e];
      s_warp[(warps + warp) * GROUP + lane * N + e] = q[e];
    }
  }
  __syncthreads();
  if (tid < GROUP) {
    float sa = 0.f, sq = 0.f;
    for (int w = 0; w < warps; ++w) {
      sa += s_warp[w * GROUP + tid];
      sq += s_warp[(warps + w) * GROUP + tid];
    }
    s_block[tid] = sa;
    s_block[GROUP + tid] = sq;
  }
  cluster.sync();
  if (tid < GROUP) {
    float sa = 0.f, sq = 0.f;
    for (int r = 0; r < K; ++r) {
      const float* theirs = cluster.map_shared_rank(s_block, r);
      sa += theirs[tid];
      sq += theirs[GROUP + tid];
    }
    float v0, v1;
    finish<BWD>(sa, sq, (float)HW, eps, &v0, &v1);
    s_stat[tid] = v0;
    s_stat[GROUP + tid] = v1;
    if (!BWD && rank == 0) {
      float* dst = stats + (long long)b * 2 * C + (blockIdx.x / K) * GROUP;
      dst[tid] = v0;
      dst[C + tid] = v1;
    }
  }
  // every rank has read every other's sums before any may leave; the
  // barrier also publishes s_stat to the block
  cluster.sync();
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float v0 = s_stat[piece * N + e];
    const float v1 = s_stat[GROUP + piece * N + e];
    if (BWD) {
      k.gmean[e] = v0;
      k.gymean[e] = v1;
    } else {
      k.set_stats(e, v0, v1);
    }
  }

  // 3. out of shared memory, 16 bytes a thread
#pragma unroll 4
  for (int i = 0; i < mine; ++i) {
    const size_t at = ((size_t)i * threads + tid) * 16;
    const long long off = base + i * step;
    const Chunk<T> xv = load_chunk(reinterpret_cast<const T*>(slab_x + at));
    if (BWD) {
      const Chunk<T> gv = load_chunk(reinterpret_cast<const T*>(slab_g + at));
      store_chunk(out + off, backward_chunk(xv, gv, k));
    } else {
      store_chunk(out + off, forward_chunk(xv, k, relu, res ? res + off : nullptr));
    }
  }
}

// ------------------------------------------------------------ streaming
// grid (S, B, groups).  A channel group is CV <= 32 pieces of 16 bytes;
// thread t owns piece t % CV of the group for the pixels p of this slab with
// p % G == t / CV, G = 256 / CV.  Forward (BWD = false): sums of x and x^2.
// Backward: sums of g and g * y, g masked as above.  part is (B, S, 2, C).
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
in_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ stats, float* __restrict__ part,
                  int HW, int C, int rows, int CV, int relu) {
  constexpr int N = Chunk<T>::N;
  __shared__ float s_a[THREADS * N];
  __shared__ float s_q[THREADS * N];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x;
  const int NV = C / N, G = THREADS / CV;
  const int cv = tid % CV, grp = tid / CV;
  const int v = blockIdx.z * CV + cv;
  const bool active = grp < G && v < NV;
  const int c0 = v * N;
  float a[N], q[N];
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = q[e] = 0.f;
  if (active) {
    Consts<T> k;
    if (BWD) {
      const float* st = stats + (long long)b * 2 * C + c0;
#pragma unroll
      for (int e = 0; e < N; ++e) k.set_stats(e, st[e], st[C + e]);
    }
    const int p0 = s * rows, p1 = min(HW, p0 + rows);
    const long long base = (long long)b * HW * C + c0;
    for (int p = p0 + grp; p < p1; p += UNROLL * G) {
      Chunk<T> xv[UNROLL], gv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * G < p1) {
          const long long off = base + (long long)(p + u * G) * C;
          xv[u] = load_chunk(x + off);
          if (BWD) gv[u] = load_chunk(g + off);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * G < p1) {
          if (BWD) {
            if (relu) mask_cotangent(xv[u], gv[u], k);
            add_bwd_sums(xv[u], gv[u], k, a, q);
          } else {
            add_moments(xv[u], a, q);
          }
        }
      }
    }
  }
  if (grp < G) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s_a[(grp * CV + cv) * N + e] = a[e];
      s_q[(grp * CV + cv) * N + e] = q[e];
    }
  }
  __syncthreads();
  const int c = blockIdx.z * CV * N + tid;
  if (tid < CV * N && c < C) {
    float sa = 0.f, sq = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      sa += s_a[gg * CV * N + tid];
      sq += s_q[gg * CV * N + tid];
    }
    float* dst = part + ((long long)b * S + s) * 2 * C;
    dst[c] = sa;
    dst[C + c] = sq;
  }
}

// The elementwise pass, same grid and thread layout.  Each block first adds
// the S partials of its group's channels in slab order; the forward's
// slab-0 blocks write them to stats (B, 2, C), which the backward reads.
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
in_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const T* __restrict__ res, const float* __restrict__ part,
                float* __restrict__ stats, T* __restrict__ out, int HW, int C,
                int rows, int CV, float eps, int relu) {
  constexpr int N = Chunk<T>::N;
  __shared__ float s_stat[2][MAX_VECS * N];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x;
  const int NV = C / N, G = THREADS / CV;
  const int cv = tid % CV, grp = tid / CV;
  const int v = blockIdx.z * CV + cv;
  const bool active = grp < G && v < NV;
  const int c0 = v * N;
  const int c = blockIdx.z * CV * N + tid;
  if (tid < CV * N && c < C) {
    const float* src = part + (long long)b * S * 2 * C + c;
    float sa = 0.f, sq = 0.f;
    for (int j = 0; j < S; ++j) {
      sa += src[(long long)j * 2 * C];
      sq += src[(long long)j * 2 * C + C];
    }
    float v0, v1;
    finish<BWD>(sa, sq, (float)HW, eps, &v0, &v1);
    s_stat[0][tid] = v0;
    s_stat[1][tid] = v1;
    if (!BWD && s == 0) {
      stats[(long long)b * 2 * C + c] = v0;
      stats[(long long)b * 2 * C + C + c] = v1;
    }
  }
  __syncthreads();
  if (!active) return;
  Consts<T> k;
  if (BWD) {
    const float* st = stats + (long long)b * 2 * C + c0;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      k.set_stats(e, st[e], st[C + e]);
      k.gmean[e] = s_stat[0][cv * N + e];
      k.gymean[e] = s_stat[1][cv * N + e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      k.set_stats(e, s_stat[0][cv * N + e], s_stat[1][cv * N + e]);
  }
  const int p0 = s * rows, p1 = min(HW, p0 + rows);
  const long long base = (long long)b * HW * C + c0;
  for (int p = p0 + grp; p < p1; p += UNROLL * G) {
    Chunk<T> xv[UNROLL], gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * G < p1) {
        const long long off = base + (long long)(p + u * G) * C;
        xv[u] = load_chunk(x + off);
        if (BWD) gv[u] = load_chunk(g + off);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * G < p1) {
        const long long off = base + (long long)(p + u * G) * C;
        if (BWD) {
          if (relu) mask_cotangent(xv[u], gv[u], k);
          store_chunk(out + off, backward_chunk(xv[u], gv[u], k));
        } else {
          store_chunk(out + off,
                      forward_chunk(xv[u], k, relu, res ? res + off : nullptr));
        }
      }
    }
  }
}

// ------------------------------------------------------------- launches
struct Plan {
  int regime;   // 1 resident, 2 streaming
  int group;    // channels of a channel group (resident: GROUP)
  int cluster;  // blocks of a cluster (1 when streaming)
  int threads;  // threads of a block
  int slabs;    // pixel ranges an image is cut into (resident: = cluster)
  int smem;     // dynamic shared memory of a block (0 when streaming)
};

int resident_smem(int rows, int itemsize, bool bwd) {
  return SCRATCH_BYTES + rows * GROUP * itemsize * (bwd ? 2 : 1);
}

// what the kernels can take; the choice among these is the Python plan's
bool takes(const Plan& p, int B, int HW, int C, int itemsize, bool bwd) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % 8) return false;
  if (p.slabs <= 0 || p.slabs > HW) return false;
  const int rows = (HW + p.slabs - 1) / p.slabs;
  if (p.regime == 1) {
    return (p.cluster == 1 || p.cluster == 2 || p.cluster == 4 ||
            p.cluster == 8) &&
           p.slabs == p.cluster && p.group == GROUP && C % GROUP == 0 &&
           (p.threads == 256 || p.threads == 512) &&
           p.smem == resident_smem(rows, itemsize, bwd) &&
           p.smem <= MAX_SMEM;
  }
  const int n = 16 / itemsize;
  return p.regime == 2 && p.cluster == 1 && p.threads == THREADS &&
         p.smem == 0 && p.slabs <= 65535 && p.group % n == 0 &&
         p.group / n >= 1 && p.group / n <= MAX_VECS &&
         (p.group == C || p.group == MAX_VECS * n);
}

constexpr int MAX_DEVICES = 64;

// A launch with more than 48 KB of dynamic shared memory is refused until
// the kernel has been allowed it: once for each instance and device, up to
// the most a plan may ask for.
template <typename T, bool BWD>
cudaError_t allow_smem() {
  static bool allowed[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(in_resident_kernel<T, BWD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
  allowed[device] = err == cudaSuccess;
  return err;
}

template <typename T, bool BWD>
cudaError_t resident_config(const Plan& p, int B, int C,
                            cudaLaunchConfig_t* cfg,
                            cudaLaunchAttribute* attr) {
  cudaError_t err = allow_smem<T, BWD>();
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.cluster * (C / GROUP), B, 1);
  cfg->blockDim = dim3(p.threads, 1, 1);
  cfg->dynamicSmemBytes = p.smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// forward (BWD = false): io = y, res optional; backward: io = dx
template <typename T, bool BWD>
int launch(const Plan& p, const T* x, const T* g, const T* res, float* part,
           float* stats, T* io, int B, int HW, int C, float eps, int relu,
           cudaStream_t st) {
  const int rows = (HW + p.slabs - 1) / p.slabs;
  if (p.regime == 1) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = resident_config<T, BWD>(p, B, C, &cfg, &attr);
    if (err != cudaSuccess) return (int)err;
    cfg.stream = st;
    err = cudaLaunchKernelEx(&cfg, in_resident_kernel<T, BWD>, x, g, res, stats,
                             io, HW, C, p.cluster, rows, eps, relu);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  const int CV = p.group / Chunk<T>::N;
  const int groups = (C + p.group - 1) / p.group;
  const dim3 grid(p.slabs, B, groups);
  in_partial_kernel<T, BWD><<<grid, THREADS, 0, st>>>(x, g, stats, part, HW, C,
                                                      rows, CV, relu);
  in_apply_kernel<T, BWD><<<grid, THREADS, 0, st>>>(x, g, res, part, stats, io,
                                                    HW, C, rows, CV, eps, relu);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(int dtype, const Plan& p, const void* x, const void* g,
             const void* res, void* part, void* stats, void* io, int B, int HW,
             int C, float eps, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    if (!takes(p, B, HW, C, sizeof(T), BWD)) return (int)cudaErrorInvalidValue;
    return launch<T, BWD>(p, static_cast<const T*>(x), static_cast<const T*>(g),
                          static_cast<const T*>(res), static_cast<float*>(part),
                          static_cast<float*>(stats), static_cast<T*>(io), B,
                          HW, C, eps, relu, st);
  }
  if (dtype == 0) {
    using T = float;
    if (!takes(p, B, HW, C, sizeof(T), BWD)) return (int)cudaErrorInvalidValue;
    return launch<T, BWD>(p, static_cast<const T*>(x), static_cast<const T*>(g),
                          static_cast<const T*>(res), static_cast<float*>(part),
                          static_cast<float*>(stats), static_cast<T*>(io), B,
                          HW, C, eps, relu, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The forward.  dtype: 0 = float32, 1 = bfloat16.  x, y and residual (null
// for none) are contiguous (B, HW, C), C a multiple of 8.  regime, group,
// cluster, threads, slabs and smem_bytes are the launch plan (see Plan).
// part is f32 scratch of B * slabs * 2 * C, read only when streaming; stats
// (B, 2, C) f32 receives mean and scale, which the backward takes.  Returns
// a cudaError_t; cudaErrorInvalidValue for a plan the kernels cannot take.
extern "C" int nirgan_instance_norm(int device, int dtype, const void* x,
                                    const void* residual, void* part,
                                    void* stats, void* y, int B, int HW, int C,
                                    int regime, int group, int cluster,
                                    int threads, int slabs, int smem_bytes,
                                    float eps, int relu, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p{regime, group, cluster, threads, slabs, smem_bytes};
  return dispatch<false>(dtype, p, x, nullptr, residual, part, stats, y, B, HW,
                         C, eps, relu, stream);
}

// The backward.  x, g and dx are contiguous (B, HW, C) in one dtype; stats
// is the forward's (B, 2, C); relu says whether the forward fused the ReLU;
// part as above.  Returns a cudaError_t.
extern "C" int nirgan_instance_norm_bwd(int device, int dtype, const void* x,
                                        const void* g, const void* stats,
                                        void* part, void* dx, int B, int HW,
                                        int C, int regime, int group,
                                        int cluster, int threads, int slabs,
                                        int smem_bytes, int relu,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p{regime, group, cluster, threads, slabs, smem_bytes};
  return dispatch<true>(dtype, p, x, g, nullptr, part,
                        const_cast<void*>(stats), dx, B, HW, C, 0.f, relu,
                        stream);
}

// How many clusters of a resident plan the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
extern "C" int nirgan_instance_norm_max_clusters(int device, int dtype,
                                                 int backward, int B, int C,
                                                 int cluster, int threads,
                                                 int smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  if (B <= 0 || C <= 0 || C % GROUP) return -(int)cudaErrorInvalidValue;
  const Plan p{1, GROUP, cluster, threads, cluster, smem_bytes};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  if (dtype == 1 && backward) {
    err = resident_config<__nv_bfloat16, true>(p, B, C, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, in_resident_kernel<__nv_bfloat16, true>, &cfg);
  } else if (dtype == 1) {
    err = resident_config<__nv_bfloat16, false>(p, B, C, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &n, in_resident_kernel<__nv_bfloat16, false>, &cfg);
  } else if (backward) {
    err = resident_config<float, true>(p, B, C, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, in_resident_kernel<float, true>,
                                           &cfg);
  } else {
    err = resident_config<float, false>(p, B, C, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, in_resident_kernel<float, false>,
                                           &cfg);
  }
  return err != cudaSuccess ? -(int)err : n;
}
