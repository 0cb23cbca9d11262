// B2 · per-pixel GLCM Haralick features (paper pipeline P2).
//
// Replaces src/repro/kernels/glcm.py::glcm_features (Pallas body
// _glcm_kernel): quantize one band to Q levels over [vmin, vmax], build each
// pixel's co-occurrence histogram over its (2R+1)^2 window at offset
// (dr, dc), and reduce it to energy, entropy, contrast, homogeneity and
// correlation.  The features follow the oracle
// (src/repro/filters/texture.py::features_from_glcm): variance as
// E[(i - mu)^2], and correlation 0 where var_i * var_j < 1e-4.
//
// What bounds it on the H100: bytes and operations are close.  One P2
// stripe (1024 x 8192, halo 3) reads 33.8 MB and writes 168 MB (~60 us at
// 3.35 TB/s).  Per pixel it quantizes 2 (2R+1)^2 = 50 samples (~4 flops
// each), scans Q^2 = 64 bins, and spends ~28 flops and one log on each
// nonzero bin (at most (2R+1)^2 = 25).  The TPU kernel's dense one-hot
// accumulation over all Q^2 bins per window offset is not carried over: a
// GPU thread increments one bin per pair instead.
//
// Design: one thread per output pixel, a 32 x 4 block.  Each thread keeps
// its Q^2-bin histogram in shared memory, laid out [bin][thread]: a block
// of 128 threads (a multiple of 32) puts every thread's bins in its own
// bank, so the data-dependent increments never conflict.  Q = 8 takes
// 32 KB a block.  Samples are read from the haloed band in device memory
// (L1 serves the window's reuse) and quantized on the fly.
#include <cuda_runtime.h>

namespace {

constexpr int GX = 32;
constexpr int GY = 4;
constexpr int NT = GX * GY;

__device__ __forceinline__ int quantize(float x, float vmin, float span,
                                        int levels) {
  // floor((x - vmin) / span * levels), clipped to [0, levels - 1]
  const float q = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, vmin), span), (float)levels));
  return (int)fminf(fmaxf(q, 0.0f), (float)(levels - 1));
}

__global__ void glcm_kernel(const float* __restrict__ band,
                            float* __restrict__ out, int H, int W, int radius,
                            int dr, int dc, int levels, float vmin,
                            float span) {
  extern __shared__ unsigned int hist[];  // [levels * levels][NT]
  const int t = threadIdx.y * GX + threadIdx.x;
  const int r = blockIdx.y * GY + threadIdx.y;
  const int c = blockIdx.x * GX + threadIdx.x;
  if (r >= H || c >= W) return;  // no block barrier below
  const int nb = levels * levels;
  const int halo = radius + max(abs(dr), abs(dc));
  const int Wp = W + 2 * halo;
  for (int b = 0; b < nb; ++b) hist[b * NT + t] = 0u;
  for (int u = -radius; u <= radius; ++u) {
    const float* row1 = band + (size_t)(r + halo + u) * Wp + c + halo;
    const float* row2 = band + (size_t)(r + halo + u + dr) * Wp + c + halo + dc;
    for (int v = -radius; v <= radius; ++v) {
      const int q1 = quantize(__ldg(row1 + v), vmin, span, levels);
      const int q2 = quantize(__ldg(row2 + v), vmin, span, levels);
      hist[(q1 * levels + q2) * NT + t] += 1u;
    }
  }

  // the epilogue is pinned to features_from_glcm's order and association
  // (bins i-major, _rn intrinsics so nothing contracts into an FMA): the
  // cov = E[ij] - mu_i mu_j cancellation makes correlation sensitive to
  // rounding, and the two versions then agree bit for bit.  Zero bins add
  // +-0 there and are skipped here, which changes no sum.
  float total = 0.0f;
  for (int b = 0; b < nb; ++b) total = __fadd_rn(total, (float)hist[b * NT + t]);
  total = fmaxf(total, 1e-12f);
  float energy = 0.0f, entropy = 0.0f, contrast = 0.0f, homog = 0.0f;
  float mu_i = 0.0f, mu_j = 0.0f, e_ij = 0.0f;
  for (int i = 0; i < levels; ++i) {
    for (int j = 0; j < levels; ++j) {
      const unsigned int n = hist[(i * levels + j) * NT + t];
      if (n == 0u) continue;
      const float p = __fdiv_rn((float)n, total);
      const float d2 = (float)((i - j) * (i - j));
      energy = __fadd_rn(energy, __fmul_rn(p, p));
      entropy = __fadd_rn(entropy, __fmul_rn(p, logf(__fadd_rn(p, 1e-12f))));
      contrast = __fadd_rn(contrast, __fmul_rn(p, d2));
      homog = __fadd_rn(homog, __fdiv_rn(p, __fadd_rn(1.0f, d2)));
      mu_i = __fadd_rn(mu_i, __fmul_rn(p, (float)i));
      mu_j = __fadd_rn(mu_j, __fmul_rn(p, (float)j));
      e_ij = __fadd_rn(e_ij, __fmul_rn(__fmul_rn(p, (float)i), (float)j));
    }
  }
  float var_i = 0.0f, var_j = 0.0f;
  for (int i = 0; i < levels; ++i) {
    for (int j = 0; j < levels; ++j) {
      const unsigned int n = hist[(i * levels + j) * NT + t];
      if (n == 0u) continue;
      const float p = __fdiv_rn((float)n, total);
      const float di = __fsub_rn((float)i, mu_i);
      const float dj = __fsub_rn((float)j, mu_j);
      var_i = __fadd_rn(var_i, __fmul_rn(p, __fmul_rn(di, di)));
      var_j = __fadd_rn(var_j, __fmul_rn(p, __fmul_rn(dj, dj)));
    }
  }
  const float cov = __fsub_rn(e_ij, __fmul_rn(mu_i, mu_j));
  const float denom2 = __fmul_rn(var_i, var_j);
  const float corr =
      denom2 < 1e-4f ? 0.0f : __fdiv_rn(cov, sqrtf(fmaxf(denom2, 1e-4f)));
  float* o = out + ((size_t)r * W + c) * 5;
  o[0] = energy;
  o[1] = -entropy;
  o[2] = contrast;
  o[3] = homog;
  o[4] = corr;
}

}  // namespace

extern "C" int glcm_features_f32(const float* band, float* out, int H, int W,
                                 int radius, int dr, int dc, int levels,
                                 float vmin, float span, void* stream) {
  const dim3 block(GX, GY);
  const dim3 grid((W + GX - 1) / GX, (H + GY - 1) / GY);
  const size_t smem = (size_t)levels * levels * NT * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        glcm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  glcm_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      band, out, H, W, radius, dr, dc, levels, vmin, span);
  return (int)cudaGetLastError();
}
