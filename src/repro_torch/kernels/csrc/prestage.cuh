// The fused pointwise pre-stage of B1-B3: a prologue that applies the plan
// layer's op list (kernels/prestage.py) to each raw sample as a kernel loads
// it, so a chain such as Convert -> kernel reads the raw tile once and its
// intermediates never reach device memory.  Counterpart of the Pallas
// kernels' pre_fn / pre_xs / pre_pan, which run a traced JAX function on
// the VMEM tile.
//
// The raw input is uint8, int32 (uint16 pixels widened) or float32, `stride`
// bands per pixel; a load reads the first `nload` of them and converts each
// to float32 (exact for every pixel value the repo produces, and rounded to
// nearest like torch's .to(float32) above 2^24).  The dtype is a run-time
// argument, uniform across a launch, so the kernels' instances are not
// multiplied by three.  Every arithmetic op is an _rn intrinsic, so nvcc
// contracts nothing into an FMA and each op rounds as the unfused PyTorch
// op does: a fused plan equals the unfused one bit for bit.  The op loop is
// not unrolled (its codes are read from the kernel's parameters); the band
// loops are, over NB registers that the caller sizes to the bands it needs
// (one for B2 and B1's PAN, whose elementwise chains read band 0 only), so
// a sample's bands stay in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace prestage {

constexpr int MAX_OPS = 16;    // kernels/prestage.py::MAX_OPS
constexpr int MAX_BANDS = 8;   // kernels/prestage.py::MAX_BANDS

enum : int { CAST_F32 = 0, SUB = 1, DIV = 2, MUL = 3, ADD = 4, CLIP = 5, TRUNC = 6,
             BAND = 7, NDIFF = 8 };
enum : int { U8 = 0, I32 = 1, F32 = 2 };

// kernels/prestage.py::PreOps, passed to the kernels by value
struct Ops {
  int n;       // ops
  int dtype;   // U8, I32 or F32
  int stride;  // bands per raw pixel
  int nload;   // bands a load reads
  int code[MAX_OPS];
  int i0[MAX_OPS];
  int i1[MAX_OPS];
  float a[MAX_OPS];
  float b[MAX_OPS];
};

// the first nload bands of a raw pixel, as floats; NB registers (bands past
// nload are 0)
template <int NB, typename T>
__device__ __forceinline__ void load(const T* __restrict__ p, int nload, float (&v)[NB]) {
  v[0] = (float)__ldg(p);
#pragma unroll
  for (int j = 1; j < NB; ++j) v[j] = j < nload ? (float)__ldg(p + j) : 0.0f;
}

template <int NB>
__device__ __forceinline__ void load(const void* __restrict__ raw, const Ops& ops, size_t pixel,
                                     float (&v)[NB]) {
  const size_t at = pixel * (size_t)ops.stride;
  switch (ops.dtype) {
    case U8: load<NB>(static_cast<const unsigned char*>(raw) + at, ops.nload, v); break;
    case I32: load<NB>(static_cast<const int*>(raw) + at, ops.nload, v); break;
    default: load<NB>(static_cast<const float*>(raw) + at, ops.nload, v); break;
  }
}

// v[i] for a run-time i, by selects (a dynamic index would put v in local
// memory)
template <int NB>
__device__ __forceinline__ float pick(const float (&v)[NB], int i) {
  float t = v[0];
#pragma unroll
  for (int j = 1; j < NB; ++j)
    if (j == i) t = v[j];
  return t;
}

// the op list on the NB registers of v, of which the first nb are bands;
// returns the bands left.  Elementwise ops run on all NB registers (the
// ones past nb are never read), so each op is one switch and NB
// instructions.
template <int NB>
__device__ __forceinline__ int apply(const Ops& ops, float (&v)[NB], int nb) {
#pragma unroll 1
  for (int k = 0; k < ops.n; ++k) {
    const float a = ops.a[k];
    switch (ops.code[k]) {
      case SUB:
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = __fsub_rn(v[j], a);
        break;
      case DIV:
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = __fdiv_rn(v[j], a);
        break;
      case MUL:
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = __fmul_rn(v[j], a);
        break;
      case ADD:
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = __fadd_rn(v[j], a);
        break;
      case CLIP: {  // torch.clamp: NaN stays NaN
        const float b = ops.b[k];
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = isnan(v[j]) ? v[j] : fminf(fmaxf(v[j], a), b);
        break;
      }
      case TRUNC:  // to an integer dtype, clipped into its range first
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = truncf(v[j]);
        break;
      case BAND:
        v[0] = pick(v, ops.i0[k]);
        nb = 1;
        break;
      case NDIFF: {  // (n - r) / max(n + r, eps), NaN-propagating as torch.clamp(min=)
        const float r = pick(v, ops.i0[k]), n = pick(v, ops.i1[k]);
        float s = __fadd_rn(n, r);
        s = isnan(s) ? s : fmaxf(s, a);
        v[0] = __fdiv_rn(__fsub_rn(n, r), s);
        nb = 1;
        break;
      }
      default:  // CAST_F32: a float already
        break;
    }
  }
  return nb;
}

// raw pixel `pixel` (row-major over the raw tensor's rows and columns)
// through the op list; returns the bands in v
template <int NB>
__device__ __forceinline__ int sample(const void* __restrict__ raw, const Ops& ops, size_t pixel,
                                      float (&v)[NB]) {
  load<NB>(raw, ops, pixel, v);
  return apply<NB>(ops, v, ops.nload);
}

// band 0 of the chain's output at raw pixel `pixel`: one register where the
// chain reads one band, else MAX_BANDS
__device__ __forceinline__ float first(const void* __restrict__ raw, const Ops& ops,
                                       size_t pixel) {
  if (ops.nload == 1) {
    float v[1];
    sample<1>(raw, ops, pixel, v);
    return v[0];
  }
  float v[MAX_BANDS];
  sample<MAX_BANDS>(raw, ops, pixel, v);
  return v[0];
}

}  // namespace prestage
