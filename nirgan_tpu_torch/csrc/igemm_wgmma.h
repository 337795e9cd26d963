// Host interface of the gathered implicit GEMM on wgmma (igemm_wgmma.cu),
// shared by the trunk conv (kernel A), the transposed conv's input gradient
// (kernel B5, dx) and, in its s8 form, the int8 trunk conv (kernel D).

#pragma once

#include <cuda_runtime.h>

namespace igemm {

// how output pixel (b, oy, ox) and tap (dy, dx) name their source pixel; a
// tap whose source lies outside the (Hs, Ws) source reads zero
enum Gather {
  CONV_REFLECT = 0,    // (reflect(oy + dy - 1), reflect(ox + dx - 1))
  CONV_VALID = 1,      // (oy + dy, ox + dx)
  STRIDE2_ZERO = 2,    // (2 oy - 1 + dy, 2 ox - 1 + dx): the k3 s2 p1 conv
                       // and the k3 s2 transposed conv's input gradient
  CONV_REPLICATE = 3,  // (clamp(oy + dy - 1), clamp(ox + dx - 1))
  CONV_ZERO = 4,       // (oy + dy - 1, ox + dx - 1)
  STRIDE2_VALID = 5,   // (2 oy + dy, 2 ox + dx): the k3 s2 conv of a source
                       // that carries its own border rows and columns
};

// The source pixel (sy, sx) of output pixel (oy, ox) and tap (dy, dx) under
// `gather`, from a source of Hs x Ws pixels; false where the tap reads zero.
// The reflect border is ReflectionPad2d(1)'s (-1 -> 1, n -> n - 2; Hs, Ws
// >= 2), the replicate border ReplicationPad2d(1)'s.
__host__ __device__ inline bool source_pixel(int gather, int oy, int ox,
                                             int dy, int dx, int Hs, int Ws,
                                             int& sy, int& sx) {
  switch (gather) {
    case CONV_REFLECT:
      sy = oy + dy - 1;
      sx = ox + dx - 1;
      sy = sy < 0 ? -sy : (sy >= Hs ? 2 * Hs - 2 - sy : sy);
      sx = sx < 0 ? -sx : (sx >= Ws ? 2 * Ws - 2 - sx : sx);
      break;
    case CONV_VALID:
      sy = oy + dy;
      sx = ox + dx;
      break;
    case STRIDE2_ZERO:
      sy = 2 * oy - 1 + dy;
      sx = 2 * ox - 1 + dx;
      break;
    case STRIDE2_VALID:
      sy = 2 * oy + dy;
      sx = 2 * ox + dx;
      break;
    case CONV_REPLICATE:
      sy = oy + dy - 1;
      sx = ox + dx - 1;
      sy = sy < 0 ? 0 : (sy >= Hs ? Hs - 1 : sy);
      sx = sx < 0 ? 0 : (sx >= Ws ? Ws - 1 : sx);
      break;
    default:  // CONV_ZERO
      sy = oy + dy - 1;
      sx = ox + dx - 1;
  }
  return sy >= 0 && sx >= 0 && sy < Hs && sx < Ws;
}

// The output side of a source side n under `gather`: (n - 1) / 2 + 1 at
// stride 2 (the k3 s2 p1 conv), (n - 3) / 2 + 1 at stride 2 without a
// border, n - 2 at stride 1 without one, n for the borders of stride 1.
inline int out_side(int gather, int n) {
  switch (gather) {
    case STRIDE2_ZERO: return (n - 1) / 2 + 1;
    case STRIDE2_VALID: return (n - 3) / 2 + 1;
    case CONV_VALID: return n - 2;
    default: return n;
  }
}

// The least source side `gather` takes: 3 without a border (one output),
// 2 for the reflect border (ReflectionPad2d(1)), 1 for the others.
inline int least_side(int gather) {
  return gather == CONV_VALID || gather == STRIDE2_VALID ? 3
         : gather == CONV_REFLECT ? 2 : 1;
}

struct Shape {
  int B, Hs, Ws, Cs;  // the source tensor, (B, Hs, Ws, Cs) NHWC bf16
  int Ho, Wo;         // the output pixel grid; the output is (B, Ho, Wo, N)
  int gather;
};

// true where launch() has a kernel: N output channels, Cs source channels
inline bool takes(int N, int Cs) {
  return (N == 128 || N == 256) && Cs > 0 && Cs % 64 == 0;
}

// out[m, n] = sum over tap, c of src[pixel(m, tap), c] * W[tap, c, n] (+
// bias[n], f32, may be null), rounded once to bf16.  wp holds W packed by
// ops/_pack.py: pack_b128: one image of N rows x 128 bytes for each (tap,
// 64-channel slice of c), already in the shared-memory swizzle.
cudaError_t launch(int N, const void* src, const void* wp, const float* bias,
                   void* out, Shape g, cudaStream_t stream);

// the output pixels of one tile: 128 * (256 / N)
inline int tile_rows(int N) { return 128 * (256 / N); }

// true where launch_s8() has a kernel: N output channels, Cs source
// channels, hw output pixels an image (a tile may span two images, never
// three)
inline bool takes_s8(int N, int Cs, int hw) {
  return (N == 128 || N == 256) && Cs > 0 && Cs % 128 == 0 &&
         hw >= tile_rows(N);
}

// The s8 kernel walks grains of output pixels: 64-row units at N = 256
// (whole tiles of two, and a half tile where a CTA's run leaves one over),
// whole tiles at N = 128.
inline int s8_grain(int N) { return N == 256 ? 64 : tile_rows(N); }

inline long long s8_grains(int N, long long m) {
  return (m + s8_grain(N) - 1) / s8_grain(N);
}

// The s8 form, for the int8 trunk: out[m, n] = sum over tap, c of
// src[pixel(m, tap), c] * W[tap, c, n] in exact s32 sums, rounded once to
// bf16, src int8 (B, Hs, Ws, Cs) with the reflect, replicate or zero border
// at stride 1 (Ho, Wo = Hs, Ws), the zero border at stride 2, or no border
// at stride 1 or 2 (Ho, Wo = out_side), wp the int8 weight packed as for
// bf16 with two channels as one 16-bit element (one image of N rows x 128
// bytes a tap and 128 channels), and moments (B, 2, N) f64: Sigma a and
// Sigma a^2 over each image's pixels of every column, exact integer sums
// added in a fixed order.  ctas CTAs (1 <= ctas <= s8_grains(N, B Ho Wo))
// each walk an equal run of grains; part (ctas + B - 1, 2, 2, N) f64 is
// their scratch: each CTA's consumer warpgroup's sums of each image its run
// touches.  Two launches: the conv, then the sums.
cudaError_t launch_s8(int N, const void* src, const void* wp, void* out,
                      double* part, double* moments, Shape g, int ctas,
                      cudaStream_t stream);

}  // namespace igemm
