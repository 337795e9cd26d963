// Backward of the k3/s2/p1/op1 transposed convolution (the generator's u0
// and u1 up-convs), NHWC: the input gradient dx and the weight gradient dW.
//
// Replaces nirgan_tpu/ops/pallas_convt_bwd.py: convt_k3s2_bwd
// (_fused_kernel, reached through _convt_core_k3s2_pallas in
// nirgan_tpu/ops/conv.py).  With the torch weight W[ci][co][ky][kx] and the
// cotangent ct (B, 2Hi, 2Wi, Co) of the output:
//   dx[b,i,j,ci] = sum_{ky,kx,co} ct[b, 2i-1+ky, 2j-1+kx, co] W[ci,co,ky,kx]
//   dW[ci,co,ky,kx] = sum_{b,i,j} z[b,i,j,ci] ct[b, 2i-1+ky, 2j-1+kx, co]
// where z is the forward's input and a row or column of -1 reads as zero.
//
// What bounds it on an H100: at the train shape u1 is 2 * 16 * 138^2 * 9 *
// 128 * 64 = 45 GFLOP for each gradient (nine real taps each: the zero taps
// of a stride-2 transposed conv belong to its forward) against 312 MB that
// must move (the cotangent once, z, dx), so 0.093 ms of memory time against
// 0.091 ms of tensor-core time: the two bounds meet.  The TPU kernel made
// one pass over the cotangent for both gradients with a 295 KB f32 dW
// accumulator resident in VMEM across its sequential grid; no Hopper block
// holds that (a block's registers hold 128 KB of accumulators), and blocks
// run in no order, so the two gradients are two GEMMs here and the
// cotangent is read twice.  On the generator's shapes (bf16, Ci 128 or 256,
// Co % 64 == 0) both run on wgmma:
//   * dx is the gathered implicit GEMM of igemm_wgmma.cu, M = B*Hi*Wi
//     pixels, N = Ci, K = 9*Co: a row of a tap slice is 64 contiguous
//     channels of ct[b, 2i-1+ky, 2j-1+kx, :], one 128-byte line, so the
//     stride-2 gather keeps full lines; the -1 border is a zero-filled copy.
//     The weights arrive packed per (tap, slice) as for kernel A.
//   * dW is convt_dw_wgmma_kernel below, with both operands fed as
//     they lie in memory through the transpose bits of the wgmma descriptor
//     (A = the z tile [pixel][ci], M-major; B = the gathered ct tiles
//     [pixel][co], N-major), so no transposing store into shared memory is
//     needed.  A block owns 128 ci x (one ky row: 3 taps x 64 co = 192
//     columns) of dW as f32 accumulators (96 a thread) and walks a slab of
//     pixels in slices of 64 through a four-stage mbarrier ring; the grid's
//     second axis cuts the pixels into slabs (one block an SM in all), each
//     block writes its f32 partial, and the reduce kernel adds the partials
//     in a fixed order, so the result repeats bit for bit without atomics.
// What holds both back is the L2 cache rather than the tensor cores: the
// stride-2 taps overlap, so each gradient pulls every cotangent element
// through L2 2.25 times.
// Other bf16 shapes (any Ci, Co that are multiples of 8) take the WMMA
// kernels (16x16x16, two cp.async stages, every tile edge masked), f32 a
// register-tiled SIMT GEMM in full f32; nirgan_convt_bwd chooses by shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"
#include "igemm_wgmma.h"

namespace {

using namespace nvcuda;

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

// Geometry shared by every kernel: z is (B, Hi, Wi, Ci), ct (B, 2Hi, 2Wi,
// Co).  Pixel m = (b, i, j) of z.
struct Geo {
  int B, Hi, Wi, Ci, Co;
  __device__ __forceinline__ long long M() const {
    return (long long)B * Hi * Wi;
  }
  // 32-bit division: the entry point refuses B * Hi * Wi >= 2^31
  __device__ __forceinline__ void pixel(long long m, int& b, int& i,
                                        int& j) const {
    const int hw = Hi * Wi, mm = (int)m;
    b = mm / hw;
    const int rem = mm - b * hw;
    i = rem / Wi;
    j = rem - i * Wi;
  }
  // offset of ct[b, 2i-1+ky, 2j-1+kx, co], or -1 on the zero border
  __device__ __forceinline__ long long ct_off(int b, int i, int j, int ky,
                                              int kx, int co) const {
    const int y = 2 * i - 1 + ky, x = 2 * j - 1 + kx;
    if (y < 0 || x < 0) return -1;
    return (((long long)b * 2 * Hi + y) * 2 * Wi + x) * Co + co;
  }
};

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;  // dx: A is [m][k]
constexpr int T_LD = BM + 8;  // dW: A^T is [k][ci]
constexpr int B_LD = BN + 8;

// dx tile: rows m0..m0+127 (pixels), columns n0..n0+127 (ci)
__global__ void __launch_bounds__(256)
convt_dx_bf16_kernel(const __nv_bfloat16* __restrict__ ct,
                     const __nv_bfloat16* __restrict__ w,  // (3,3,Co,Ci)
                     __nv_bfloat16* __restrict__ dx, Geo g) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][B_LD];
  __shared__ __align__(128) float Cs[8][16][16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long M = g.M();
  const int N = g.Ci, K = 9 * g.Co;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A: rows tid/4 and tid/4 + 64, 8-channel chunk tid % 4 of the slice
  const int a_col = (tid & 3) * 8;
  int a_b[2], a_i[2], a_j[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + (tid >> 2) + r * 64;
    a_ok[r] = m < M;
    g.pixel(a_ok[r] ? m : 0, a_b[r], a_i[r], a_j[r]);
  }
  // B: rows tid/16 and tid/16 + 16, chunk tid % 16
  const int b_col = (tid & 15) * 8;
  const bool b_nok = n0 + b_col < N;

  const int KT = (K + BK - 1) / BK;
  auto load_tile = [&](int kt, int stage) {
    const int k = kt * BK + a_col;
    const bool k_ok = k < K;
    const int tap = k_ok ? k / g.Co : 0;
    const int co = k - tap * g.Co;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      long long off = -1;
      if (a_ok[r] && k_ok)
        off = g.ct_off(a_b[r], a_i[r], a_j[r], tap / 3, tap % 3, co);
      cp_async16(&As[stage][(tid >> 2) + r * 64][a_col],
                 off >= 0 ? ct + off : ct, off >= 0);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = (tid >> 4) + r * 16;
      const int kk = kt * BK + kr;
      const bool ok = kk < K && b_nok;
      cp_async16(&Bs[stage][kr][b_col],
                 ok ? w + (long long)kk * N + n0 + b_col : w, ok);
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

  // epilogue: each lane rounds and writes 8 channels (16 bytes) of one row
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
      if (m < M && n < N) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(Cs[warp][r][cc + e]);
        *reinterpret_cast<uint4*>(dx + m * N + n) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

// dW partial tile of slab blockIdx.z: rows ci0..ci0+127, columns
// n0..n0+127 of n = (ky*3 + kx)*Co + co, summed over pixels [p0, p1)
__global__ void __launch_bounds__(256)
convt_dw_bf16_kernel(const __nv_bfloat16* __restrict__ ct,
                     const __nv_bfloat16* __restrict__ z,
                     float* __restrict__ part, Geo g, int slab) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BK][T_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][B_LD];
  __shared__ __align__(128) float Cs[8][16][16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long M = g.M();
  const int N = 9 * g.Co;
  const int n0 = blockIdx.x * BN, ci0 = blockIdx.y * BM;
  const long long p0 = (long long)blockIdx.z * slab;
  const long long p1 = p0 + slab < M ? p0 + slab : M;

  // both tiles: rows tid/16 and tid/16 + 16 (pixels), chunk tid % 16
  const int col = (tid & 15) * 8;
  const bool ci_ok = ci0 + col < g.Ci;
  const int n = n0 + col;
  const bool n_ok = n < N;
  const int tap = n_ok ? n / g.Co : 0;
  const int co = n - tap * g.Co, ky = tap / 3, kx = tap % 3;

  const int KT = (int)((p1 - p0 + BK - 1) / BK);
  auto load_tile = [&](int kt, int stage) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = (tid >> 4) + r * 16;
      const long long m = p0 + (long long)kt * BK + kr;
      const bool m_ok = m < p1;
      const bool za = m_ok && ci_ok;
      cp_async16(&As[stage][kr][col], za ? z + m * g.Ci + ci0 + col : z, za);
      long long off = -1;
      if (m_ok && n_ok) {
        int b, i, j;
        g.pixel(m, b, i, j);
        off = g.ct_off(b, i, j, ky, kx, co);
      }
      cp_async16(&Bs[stage][kr][col], off >= 0 ? ct + off : ct, off >= 0);
    }
    cp_async_commit();
  };

  const int wm = warp & 3, wn = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (KT > 0) load_tile(0, 0);
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
      // A = z^T, held [pixel][ci]: column-major for the (ci x pixel) operand
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[s][kk][wm * 32 + i * 16], T_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[s][kk][wn * 64 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the f32 partial tile, 8 floats a lane
  float* dst = part + (long long)blockIdx.z * g.Ci * N;
  const int r = lane >> 1, cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      const int ci = ci0 + wm * 32 + i * 16 + r;
      const int nn = n0 + wn * 64 + j * 16 + cc;
      if (ci < g.Ci && nn < N) {
        float4* o = reinterpret_cast<float4*>(dst + (long long)ci * N + nn);
        o[0] = make_float4(Cs[warp][r][cc], Cs[warp][r][cc + 1],
                           Cs[warp][r][cc + 2], Cs[warp][r][cc + 3]);
        o[1] = make_float4(Cs[warp][r][cc + 4], Cs[warp][r][cc + 5],
                           Cs[warp][r][cc + 6], Cs[warp][r][cc + 7]);
      }
      __syncwarp();
    }
  }
}

// --------------------------------------------------------------- wgmma dW
// Block (group, slab): group = ((ky * (Co / 64) + co block) * (Ci / 128) + ci
// block); the partial of part[slab][ci0 .. ci0 + 127][(ky * 3 + kx) * Co +
// co0 .. + 63] for kx = 0, 1, 2, summed over the slab's pixels.
namespace dw {

using namespace hopper;

constexpr int STAGES = 4;
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int PX = 64;        // pixels (K) of a stage
constexpr int TILE_BYTES = PX * 128;            // [64 pixels][64 channels]
constexpr int Z_BYTES = 2 * TILE_BYTES;         // ci 0..63 and 64..127
constexpr int STAGE_BYTES = Z_BYTES + 3 * TILE_BYTES;  // + one ct tile a tap
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__global__ void __launch_bounds__(THREADS, 1)
convt_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ ct,
                      const __nv_bfloat16* __restrict__ z,
                      float* __restrict__ part, Geo g, int slab) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;

  const int tid = threadIdx.x;
  const int ci_blocks = g.Ci >> 7, co_blocks = g.Co >> 6;
  int grp = blockIdx.x;
  const int ci0 = (grp % ci_blocks) * 128;
  grp /= ci_blocks;
  const int co0 = (grp % co_blocks) * 64;
  const int ky = grp / co_blocks;
  const long long M = g.M();
  const long long p0 = (long long)blockIdx.y * slab;
  const long long p1 = p0 + slab < M ? p0 + slab : M;
  const int KT = p1 > p0 ? (int)((p1 - p0 + PX - 1) / PX) : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128);           // the producers' copies
      mbar_init(bars + 8 * (STAGES + s), 8);  // one lane of a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dec<56>();
    const int t = tid & 127, chunk = t & 7, r0 = t >> 3;
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0; it < KT; ++it) {
      mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
      const uint32_t z_s = base + s * STAGE_BYTES;
      const uint32_t c_s = z_s + Z_BYTES;
#pragma unroll
      for (int i = 0; i < PX / 16; ++i) {
        const int row = r0 + 16 * i;
        const long long m = p0 + (long long)it * PX + row;
        const bool ok = m < p1;
        const uint32_t off = swizzled(row, chunk);
        const __nv_bfloat16* zp = z + (ok ? m : 0) * g.Ci + ci0 + chunk * 8;
        hopper::cp_async16(z_s + off, zp, ok);
        hopper::cp_async16(z_s + TILE_BYTES + off, zp + 64, ok);
        int b, pi, pj;
        g.pixel(ok ? m : 0, b, pi, pj);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const long long o = ok ? g.ct_off(b, pi, pj, ky, kx, co0 + chunk * 8)
                                 : -1;
          hopper::cp_async16(c_s + kx * TILE_BYTES + off, ct + (o < 0 ? 0 : o), o >= 0);
        }
      }
      cp_async_arrive(bars + 8 * s);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_inc<224>();
    const int warp = (tid & 127) >> 5, lane = tid & 31;
    float d[96];
#pragma unroll
    for (int i = 0; i < 96; ++i) d[i] = 0.f;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int it = 0; it < KT; ++it) {
      mbar_wait(bars + 8 * s, phase);
      const uint32_t z_s = base + s * STAGE_BYTES + wg * TILE_BYTES;
      const uint32_t c_s = base + s * STAGE_BYTES + Z_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < PX / 16; ++k) {
        // 16 pixels further is 16 rows = 2048 bytes in both tiles; the
        // next tap's 64 columns of B start one tile further (LBO)
        const uint64_t da = smem_desc(z_s + 2048 * k, TILE_BYTES, 1024);
        const uint64_t db = smem_desc(c_s + 2048 * k, TILE_BYTES, 1024);
        wgmma_k16<192, 1, 1>(d, da, db, (it | k) != 0);
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    settle(d);

    // lane l of warp w holds rows 16 w + l / 4 and + 8, columns 8 j + 2 (l %
    // 4) and + 1 of each 8-wide block j; 8 blocks make one tap's 64 co
    const int N = 9 * g.Co;
    const int ci = ci0 + wg * 64 + warp * 16 + (lane >> 2);
    float* o0 = part + ((long long)blockIdx.y * g.Ci + ci) * N + co0 +
                2 * (lane & 3);
    float* o1 = o0 + 8LL * N;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = (ky * 3 + (j >> 3)) * g.Co + 8 * (j & 7);
      *reinterpret_cast<float2*>(o0 + col) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(o1 + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

}  // namespace dw

// ----------------------------------------------------------------- f32 path
constexpr int FBM = 64, FBN = 64, FBK = 16;

// 4 x 4 outputs a thread from k-major tiles As[k][row], Bs[k][col]
__device__ __forceinline__ void fma_tile(const float (*As)[FBM + 4],
                                         const float (*Bs)[FBN + 4], int ty,
                                         int tx, float (&acc)[4][4]) {
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
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(256)
convt_dx_f32_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                    float* __restrict__ dx, Geo g) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // k-major (transposed)
  __shared__ __align__(16) float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long M = g.M();
  const int N = g.Ci, K = 9 * g.Co;
  const long long m0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

  // A: pixel row tid/4, 4-channel chunk tid % 4 of the 16-wide slice
  const int a_row = tid >> 2, a_col = (tid & 3) * 4;
  const long long am = m0 + a_row;
  const bool a_ok = am < M;
  int a_b, a_i, a_j;
  g.pixel(a_ok ? am : 0, a_b, a_i, a_j);
  // B: k row tid/16, columns (tid % 16) * 4
  const int b_row = tid >> 4, b_col = (tid & 15) * 4;
  const bool b_nok = n0 + b_col < N;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    const int k = k0 + a_col;
    long long off = -1;
    if (a_ok && k < K) {
      const int tap = k / g.Co;
      off = g.ct_off(a_b, a_i, a_j, tap / 3, tap % 3, k - tap * g.Co);
    }
    const float4 av = load4(ct + (off >= 0 ? off : 0), off >= 0);
    const int kb = k0 + b_row;
    const float4 bv = load4(w + (long long)kb * N + n0 + b_col, kb < K && b_nok);
    As[a_col + 0][a_row] = av.x;
    As[a_col + 1][a_row] = av.y;
    As[a_col + 2][a_row] = av.z;
    As[a_col + 3][a_row] = av.w;
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = bv;
    __syncthreads();
    fma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m < M)
      *reinterpret_cast<float4*>(dx + m * N + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(256)
convt_dw_f32_kernel(const float* __restrict__ ct, const float* __restrict__ z,
                    float* __restrict__ part, Geo g, int slab) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // [pixel][ci]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];  // [pixel][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long M = g.M();
  const int N = 9 * g.Co;
  const int n0 = blockIdx.x * FBN, ci0 = blockIdx.y * FBM;
  const long long p0 = (long long)blockIdx.z * slab;
  const long long p1 = p0 + slab < M ? p0 + slab : M;

  // both tiles: pixel row tid/16, 4-wide chunk (tid % 16) * 4
  const int row = tid >> 4, col = (tid & 15) * 4;
  const bool ci_ok = ci0 + col < g.Ci;
  const int n = n0 + col;
  const bool n_ok = n < N;
  const int tap = n_ok ? n / g.Co : 0;
  const int co = n - tap * g.Co, ky = tap / 3, kx = tap % 3;

  float acc[4][4] = {};
  for (long long k0 = p0; k0 < p1; k0 += FBK) {
    const long long m = k0 + row;
    const bool m_ok = m < p1;
    const float4 av = load4(z + (m_ok && ci_ok ? m * g.Ci + ci0 + col : 0),
                            m_ok && ci_ok);
    long long off = -1;
    if (m_ok && n_ok) {
      int b, i, j;
      g.pixel(m, b, i, j);
      off = g.ct_off(b, i, j, ky, kx, co);
    }
    const float4 bv = load4(ct + (off >= 0 ? off : 0), off >= 0);
    *reinterpret_cast<float4*>(&As[row][col]) = av;
    *reinterpret_cast<float4*>(&Bs[row][col]) = bv;
    __syncthreads();
    fma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* dst = part + (long long)blockIdx.z * g.Ci * N;
  const int nn = n0 + tx * 4;
  if (nn >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci < g.Ci)
      *reinterpret_cast<float4*>(dst + (long long)ci * N + nn) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// dW[ci][co][ky][kx] = sum over slabs, in slab order, of part[s][ci][n]
__global__ void convt_dw_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ dw, int Ci, int Co,
                                       int S) {
  const int N = 9 * Co;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Ci * N) return;
  const int ci = (int)(idx / N), n = (int)(idx - (long long)ci * N);
  float a = 0.f;
  for (int s = 0; s < S; ++s) a += part[(long long)s * Ci * N + idx];
  const int tap = n / Co, co = n - tap * Co;
  dw[((long long)ci * Co + co) * 9 + tap] = a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ct (B, 2Hi, 2Wi, Co), z (B, Hi, Wi, Ci)
// and dx (B, Hi, Wi, Ci) are contiguous NHWC in that dtype.  dw (Ci, Co, 3,
// 3) is f32, part f32 scratch of S * Ci * 9 * Co, and slab the pixels of one
// split-K slab, so that S * slab covers B * Hi * Wi.  need_dx / need_dw pick
// the gradients.  Ci and Co are multiples of 8.  The caller chooses the
// kernels by shape (ops/convt_bwd.py: takes_wgmma, the one place that rule
// is written) and says so with packed: 1 runs the wgmma kernels on w laid
// out as the swizzled images of ops/_pack.py (rows ci, 64-wide slices of
// co), and is refused unless they take the shape (bf16, igemm::takes(Ci,
// Co)); 0 runs the WMMA or SIMT kernels on w as (3, 3, Co, Ci) in that
// dtype.  Returns a cudaError_t.
extern "C" int nirgan_convt_bwd(int device, int dtype, const void* ct,
                                const void* z, const void* w, void* dx,
                                void* part, void* dw, int B, int Hi, int Wi,
                                int Ci, int Co, int S, int slab, int need_dx,
                                int need_dw, int packed, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Hi <= 0 || Wi <= 0 || Ci <= 0 || Co <= 0 || Ci % 8 ||
      Co % 8 || S <= 0 || slab <= 0 ||
      (long long)B * Hi * Wi >= (1LL << 31) ||
      (long long)S * slab < (long long)B * Hi * Wi)
    return (int)cudaErrorInvalidValue;
  const Geo g{B, Hi, Wi, Ci, Co};
  const long long M = (long long)B * Hi * Wi;
  const int N = 9 * Co;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed && (dtype != 1 || !igemm::takes(Ci, Co) || slab % 64))
    return (int)cudaErrorInvalidValue;
  if (packed) {
    using T = __nv_bfloat16;
    if (need_dx) {
      const igemm::Shape sh{B, 2 * Hi, 2 * Wi, Co, Hi, Wi, igemm::CONVT_BWD};
      err = igemm::launch(Ci, ct, w, nullptr, dx, sh, st);
      if (err != cudaSuccess) return (int)err;
    }
    if (need_dw) {
      err = cudaFuncSetAttribute(dw::convt_dw_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dw::SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
      dim3 grid(3 * (Co / 64) * (Ci / 128), S);
      dw::convt_dw_wgmma_kernel<<<grid, dw::THREADS, dw::SMEM_BYTES, st>>>(
          static_cast<const T*>(ct), static_cast<const T*>(z),
          static_cast<float*>(part), g, slab);
    }
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    if (need_dx) {
      dim3 grid((unsigned)((M + BM - 1) / BM), (Ci + BN - 1) / BN);
      convt_dx_bf16_kernel<<<grid, 256, 0, st>>>(
          static_cast<const T*>(ct), static_cast<const T*>(w),
          static_cast<T*>(dx), g);
    }
    if (need_dw) {
      dim3 grid((N + BN - 1) / BN, (Ci + BM - 1) / BM, S);
      convt_dw_bf16_kernel<<<grid, 256, 0, st>>>(
          static_cast<const T*>(ct), static_cast<const T*>(z),
          static_cast<float*>(part), g, slab);
    }
  } else if (dtype == 0) {
    if (need_dx) {
      dim3 grid((unsigned)((M + FBM - 1) / FBM), (Ci + FBN - 1) / FBN);
      convt_dx_f32_kernel<<<grid, 256, 0, st>>>(
          static_cast<const float*>(ct), static_cast<const float*>(w),
          static_cast<float*>(dx), g);
    }
    if (need_dw) {
      dim3 grid((N + FBN - 1) / FBN, (Ci + FBM - 1) / FBM, S);
      convt_dw_f32_kernel<<<grid, 256, 0, st>>>(
          static_cast<const float*>(ct), static_cast<const float*>(z),
          static_cast<float*>(part), g, slab);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (need_dw) {
    const long long total = (long long)Ci * N;
    convt_dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(dw), Ci, Co, S);
  }
  return (int)cudaGetLastError();
}
