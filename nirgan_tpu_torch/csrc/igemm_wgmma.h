// Host interface of the gathered implicit GEMM on wgmma (igemm_wgmma.cu),
// shared by the trunk conv (kernel A), the transposed conv's input gradient
// (kernel B5, dx) and, in its s8 form, the int8 trunk conv (kernel D).

#pragma once

#include <cuda_runtime.h>

namespace igemm {

// how output pixel (b, oy, ox) and tap (dy, dx) name their source pixel
enum Gather {
  CONV_REFLECT = 0,  // (reflect(oy + dy - 1), reflect(ox + dx - 1))
  CONV_VALID = 1,    // (oy + dy, ox + dx)
  CONVT_BWD = 2,     // (2 oy - 1 + dy, 2 ox - 1 + dx), zero where negative
};

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
// channels, hw pixels an image (a tile may span two images, never three)
inline bool takes_s8(int N, int Cs, int hw) {
  return (N == 128 || N == 256) && Cs > 0 && Cs % 128 == 0 &&
         hw >= tile_rows(N);
}

// The s8 form, for the int8 trunk: out[m, n] = sum over tap, c of
// src[pixel(m, tap), c] * W[tap, c, n] in exact s32 sums, rounded once to
// bf16, src int8 (B, Hs, Ws, Cs) with the reflect gather (g.Cs counts int8
// channels), wp the int8 weight packed as for bf16 with two channels as one
// 16-bit element (one image of N rows x 128 bytes a tap and 128 channels).
// part (tiles, 2, 2, N) f32 receives each tile's Sigma and Sigma^2 of every
// column over its rows of its first image (slot 0) and, where it reaches
// into the next, of that one (slot 1), in a fixed order; tiles =
// ceil(B Ho Wo / tile_rows(N)).
cudaError_t launch_s8(int N, const void* src, const void* wp, void* out,
                      float* part, Shape g, cudaStream_t stream);

}  // namespace igemm
