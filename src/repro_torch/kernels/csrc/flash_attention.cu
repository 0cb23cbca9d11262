// B4 · online-softmax (flash) attention, causal or not.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas body
// _flash_kernel): for each (batch·head) row r and query i,
//   out[r, i] = Σ_j softmax_j(q_i·k_j · scale, masked) · v_j,  scale = 1/√D,
// with j > i masked to −1e30 when causal, a float32 running max m, sum l and
// accumulator, and the output in q's dtype.  As the TPU kernel does, q is
// multiplied by the scale (passed from Python as float32(1/√D)) before q·kᵀ;
// the oracle kernels/ref.py::attention_ref divides the scores instead, which
// differs by float32 rounding only.  Grouped-query layouts need no repeat of
// k and v: query row r reads kv row r / group.
//
// What bounds it on the H100: at the served shape (olmo-1b prefill: BH = 64,
// S = 1024, D = 128, bf16, causal) the function moves 67 MB (q, k, v read
// once, out written once: 0.020 ms at 3.35 TB/s) and needs 17.2 GFLOP of
// products (0.017 ms on bf16 tensor cores), so bytes and operations are about
// even.  This first version computes in float32 on the CUDA cores (no wgmma,
// no TMA), so it runs far above that bound; making it fast is later work.
//
// Design: one 256-thread block per (64 query rows, batch·head).  The scaled
// Q tile stays in shared memory; the block walks 64-row K and V tiles
// through one shared buffer (K for the scores, then V for P·V).  Each thread
// owns a 4 x 4 patch of the 64 x 64 score tile (rows ty + 16a, columns
// tx + 16b) and 4 x D/16 of the accumulator; the online-softmax row max and
// sum are reduced over the 16 lanes that share a row with shuffles.  Rows are
// padded by one float so neither the K reads (column-strided) nor the P·V
// reads conflict on banks.  A causal block stops at its last row's tile and
// the heaviest query blocks launch first.  S need not divide by the tile:
// rows past S are computed on zeros and not stored, and columns past S get
// no weight (−inf).  Everything is float32 with expf, and the probabilities
// stay float32 through P·V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key/value rows per tile
constexpr int NT = 256;  // threads: a 16 x 16 grid of (ty, tx)
constexpr int PS = BK + 1;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows, float mul) {
  constexpr int DS = D + 1;
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * DS + c] = (row0 + r < rows) ? load_f32(src + (size_t)(row0 + r) * D + c) * mul : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int group, int Sq, int Skv, int causal, float scale) {
  constexpr int DS = D + 1;
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x DS, q · scale
  float* kv = qs + BQ * DS;  // BK x DS: the K tile, then the V tile
  float* ps = kv + BK * DS;  // BQ x PS: probabilities of the current tile

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // heaviest causal blocks first
  const int bh = blockIdx.y;
  const T* qg = q + (size_t)bh * Sq * D;
  const T* kg = k + (size_t)(bh / group) * Skv * D;
  const T* vg = v + (size_t)(bh / group) * Skv * D;
  T* og = out + (size_t)bh * Sq * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(qs, qg, q0, Sq, scale);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.0f;
  }

  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Q loaded; the previous tile's V no longer read
    load_tile<T, D>(kv, kg, k0, Skv, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * DS + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kk[b] = kv[(tx + 16 * b) * DS + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qv[a], kk[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = k0 + tx + 16 * b;
        if (col >= Skv)
          s[a][b] = -INFINITY;  // past the sequence: no weight at all
        else if (causal && col > row)
          s[a][b] = -1e30f;  // the TPU kernel's causal mask value
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], row_max16(mx));
      const float corr = expf(m[a] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        ps[(ty + 16 * a) * PS + tx + 16 * b] = p;
        rs += p;
      }
      l[a] = l[a] * corr + row_sum16(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();  // P written; K no longer read
    load_tile<T, D>(kv, vg, k0, Skv, 1.0f);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = ps[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv[j * DS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) store_as(og + (size_t)row * D + tx + 16 * c, acc[a][c] / den);
  }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, T* out, int BHq, int BHkv, int Sq,
           int Skv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(BQ + BK) * (D + 1) + (size_t)BQ * PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BHq);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(q, k, v, out, BHq / BHkv, Sq, Skv,
                                                           causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* out, int BHq, int BHkv, int Sq, int Skv,
             int D, int causal, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   int BHq, int BHkv, int Sq, int Skv, int D, int causal,
                                   float scale, void* stream) {
  return dispatch<float>(q, k, v, out, BHq, BHkv, Sq, Skv, D, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int BHq, int BHkv, int Sq, int Skv, int D, int causal,
                                    float scale, void* stream) {
  using bf = __nv_bfloat16;
  return dispatch<bf>((const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, BHq, BHkv, Sq, Skv, D,
                      causal, scale, stream);
}
