// B1 · fused RCS pansharpening (paper pipeline P3).
//
// Replaces src/repro/kernels/pansharpen.py::pansharpen (Pallas body
// _ps_kernel):  out_b = xs_b * pan_c / max(boxmean_{(2r+1)^2}(pan), 1e-6),
// with the fused pre-stages: the plan layer's op list pre_xs on each raw XS
// pixel and pre_pan on each raw PAN pixel, then PAN's band 0 (prestage.cuh).
// Both inputs are read raw (uint8, int32 or float32); pan is pre-padded by r.
//
// What bounds it on the H100: bytes.  Per output pixel it reads B + 1 raw
// samples and writes B floats, and does (2r+1)^2 + B + 2 flops: at r = 2,
// B = 4 that is 36 bytes for 31 flops, far below the card's ~20 flop/byte
// ridge in float32.  One P3 stripe (1024 x 8192, B = 4) moves ~302 MB.
//
// Design: one thread per output pixel, a 32 x 8 block.  The block stages its
// haloed PAN tile (band 0 after pre_pan) in shared memory once, so the
// (2r+1)^2 window reads hit shared memory and PAN comes from device memory
// ~once; xs and out stream through with neighbouring threads on neighbouring
// addresses.  The box sum is the Pallas kernel's shifted accumulation in
// u-then-v order (not a cumulative sum, which loses precision past 2^24),
// written with _rn intrinsics so nothing contracts into an FMA: the kernel
// is bit-identical to pansharpen_plain after prestage.apply_plain on the
// card.
#include <cuda_runtime.h>

#include "prestage.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

// NB / NBP: registers for an XS / PAN pixel's bands: 4 and 1 in the served
// instance (XS products have 4 bands, and a chain without band selection
// reads PAN's band 0 only), MAX_BANDS for the others.  The served instance
// is held to 32 registers, so eight blocks share an SM as before the
// prologue: the kernel is bound by memory traffic, and at 64 registers
// (the MAX_BANDS paths inlined) four blocks made it ~1.6x slower on a P3
// stripe (H100 80GB HBM3, 700 W).
template <int NB, int NBP>
__global__ void __launch_bounds__(TX * TY, NB * NBP == 4 ? 8 : 1)
pansharpen_kernel(const void* __restrict__ xs, const prestage::Ops pre_xs,
                  const void* __restrict__ pan, const prestage::Ops pre_pan,
                  float* __restrict__ out, int H, int W, int B, int radius) {
  extern __shared__ float tile[];  // (TY + 2r) x (TX + 2r), PAN band 0
  const int k = 2 * radius + 1;
  const int tw = TX + 2 * radius;
  const int th = TY + 2 * radius;
  const int Hp = H + 2 * radius;
  const int Wp = W + 2 * radius;
  const int r0 = blockIdx.y * TY;
  const int c0 = blockIdx.x * TX;
  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  const bool live = r < H && c < W;
  const size_t px = (size_t)r * W + c;
  // this pixel's XS bands first: their loads are in flight while the block
  // stages its PAN tile
  float x[NB];
  if (live) prestage::sample<NB>(xs, pre_xs, px, x);
  for (int i = threadIdx.y * TX + threadIdx.x; i < th * tw; i += TX * TY) {
    const int gr = r0 + i / tw;
    const int gc = c0 + i % tw;
    float p[NBP] = {};
    if (gr < Hp && gc < Wp) prestage::sample<NBP>(pan, pre_pan, (size_t)gr * Wp + gc, p);
    tile[i] = p[0];
  }
  __syncthreads();

  if (!live) return;
  float acc = 0.0f;
  for (int u = 0; u < k; ++u)
    for (int v = 0; v < k; ++v)
      acc = __fadd_rn(acc, tile[(threadIdx.y + u) * tw + threadIdx.x + v]);
  const float smooth = __fdiv_rn(acc, (float)(k * k));
  const float center = tile[(threadIdx.y + radius) * tw + threadIdx.x + radius];
  const float ratio = __fdiv_rn(center, fmaxf(smooth, 1e-6f));
  float* o = out + px * B;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < B) o[b] = __fmul_rn(x[b], ratio);
}

}  // namespace

extern "C" int pansharpen_f32(const void* xs, const prestage::Ops* pre_xs, const void* pan,
                              const prestage::Ops* pre_pan, float* out, int H, int W, int B,
                              int radius, void* stream) {
  if (B < 1 || B > prestage::MAX_BANDS) return (int)cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  const size_t smem = (size_t)(TY + 2 * radius) * (TX + 2 * radius) * sizeof(float);
  constexpr int MB = prestage::MAX_BANDS;
  const bool narrow = B <= 4 && pre_xs->nload <= 4, pan1 = pre_pan->nload == 1;
  auto kernel = narrow ? (pan1 ? pansharpen_kernel<4, 1> : pansharpen_kernel<4, MB>)
                       : (pan1 ? pansharpen_kernel<MB, 1> : pansharpen_kernel<MB, MB>);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(xs, *pre_xs, pan, *pre_pan, out, H, W, B,
                                                      radius);
  return (int)cudaGetLastError();
}
