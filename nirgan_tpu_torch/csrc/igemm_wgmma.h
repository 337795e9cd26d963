// Host interface of the gathered implicit GEMM on wgmma (igemm_wgmma.cu),
// shared by the trunk conv (kernel A) and the transposed conv's input
// gradient (kernel B5, dx).

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

}  // namespace igemm
