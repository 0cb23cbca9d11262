// B1 · fused RCS pansharpening (paper pipeline P3).
//
// Replaces src/repro/kernels/pansharpen.py::pansharpen (Pallas body
// _ps_kernel):  out_b = xs_b * pan_c / max(boxmean_{(2r+1)^2}(pan), 1e-6),
// with PAN band 0 read at stride Bp from a pan tensor pre-padded by r.
//
// What bounds it on the H100: bytes.  Per output pixel it reads B + 1 floats
// and writes B floats, and does (2r+1)^2 + B + 2 flops: at r = 2, B = 4 that
// is 36 bytes for 31 flops, far below the card's ~20 flop/byte ridge in
// float32.  One P3 stripe (1024 x 8192, B = 4) moves ~302 MB.
//
// Design: one thread per output pixel, a 32 x 8 block.  The block stages its
// haloed PAN tile (band 0 only) in shared memory once, so the (2r+1)^2 window
// reads hit shared memory and PAN comes from device memory ~once; xs and out
// stream through with neighbouring threads on neighbouring addresses.  The
// box sum is the Pallas kernel's shifted accumulation in u-then-v order (not
// a cumulative sum, which loses precision past 2^24), written with _rn
// intrinsics so nothing contracts into an FMA: the kernel is bit-identical
// to pansharpen_plain on the card.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__global__ void pansharpen_kernel(const float* __restrict__ xs,
                                  const float* __restrict__ pan,
                                  float* __restrict__ out, int H, int W, int B,
                                  int Bp, int radius) {
  extern __shared__ float tile[];  // (TY + 2r) x (TX + 2r), PAN band 0
  const int k = 2 * radius + 1;
  const int tw = TX + 2 * radius;
  const int th = TY + 2 * radius;
  const int Hp = H + 2 * radius;
  const int Wp = W + 2 * radius;
  const int r0 = blockIdx.y * TY;
  const int c0 = blockIdx.x * TX;
  for (int i = threadIdx.y * TX + threadIdx.x; i < th * tw; i += TX * TY) {
    const int gr = r0 + i / tw;
    const int gc = c0 + i % tw;
    tile[i] = (gr < Hp && gc < Wp) ? pan[((size_t)gr * Wp + gc) * Bp] : 0.0f;
  }
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (r >= H || c >= W) return;
  float acc = 0.0f;
  for (int u = 0; u < k; ++u)
    for (int v = 0; v < k; ++v)
      acc = __fadd_rn(acc, tile[(threadIdx.y + u) * tw + threadIdx.x + v]);
  const float smooth = __fdiv_rn(acc, (float)(k * k));
  const float center = tile[(threadIdx.y + radius) * tw + threadIdx.x + radius];
  const float ratio = __fdiv_rn(center, fmaxf(smooth, 1e-6f));
  const size_t o = ((size_t)r * W + c) * B;
  for (int b = 0; b < B; ++b) out[o + b] = __fmul_rn(xs[o + b], ratio);
}

}  // namespace

extern "C" int pansharpen_f32(const float* xs, const float* pan, float* out,
                              int H, int W, int B, int Bp, int radius,
                              void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  const size_t smem = (size_t)(TY + 2 * radius) * (TX + 2 * radius) * sizeof(float);
  pansharpen_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      xs, pan, out, H, W, B, Bp, radius);
  return (int)cudaGetLastError();
}
