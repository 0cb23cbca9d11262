// B4 · online-softmax (flash) attention, causal or not, with or without a
// sliding window.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (Pallas body
// _flash_kernel): for each (batch·head) row r and query i,
//   out[r, i] = Σ_j softmax_j(q_i·k_j · scale, masked) · v_j,  scale = 1/√D,
// with j > i masked to −1e30 when causal (query and key indices compared
// with no offset), columns past Skv given no weight, a float32 running max
// m, sum l and accumulator, and the output in q's dtype.  Grouped-query
// layouts need no repeat of k and v: query row r reads kv row r / group.
// A window W > 0 also masks j <= i − W: the mask of the reference model's
// local layers (src/repro/models/layers.py::_mask_bias), which the TPU
// kernel does not take (the reference computes those layers in jnp).  The
// wrapper refuses a window that leaves a query row with no key.
//
// What bounds it on the H100: at the served shapes (olmo-1b prefill: BH 64,
// S 1024, D 128; gemma-2b: 32 query rows over 4 kv rows, S 1024, D 256;
// bf16, causal) the function moves 38-67 MB (0.011-0.020 ms at 3.35 TB/s)
// and needs 17.2 GFLOP of products (0.017 ms on the bf16 tensor cores), so
// bytes and operations are about even and only the tensor cores can come
// near either bound.
//
// Two designs, chosen by dtype and head dim in the dispatch at the end:
//
// * bfloat16, D = 64, 128, 256: the tensor-core kernel (namespace tc).  One
//   block of 384 threads per (128 query rows, batch·head): two consumer
//   warpgroups of 64 rows each and one producer warpgroup, which hands its
//   registers to the consumers (240 each, for D = 256's 128 float32
//   accumulators a thread; the producer keeps 24).  The producer's first
//   thread loads the Q tile once and then K and V tiles of BK rows
//   (BK = 128 for D <= 128, 64 for D = 256) into two-stage rings with TMA
//   (128-byte swizzle, rows past the end zero-filled).  Each K and each V
//   slot has a "full" and an "empty" mbarrier, so a K slot is refilled as
//   soon as its scores are done, a tile before its V slot.  Each consumer warpgroup computes S = Q·Kᵀ with wgmma on bf16 operands
//   from shared memory into float32 registers (products of bf16 values are
//   exact in float32), masks, and runs the online softmax in registers with
//   exp2, the scale folded in as fma(s, scale·log2 e, −m) on the float32
//   scores.  It adds P·V with wgmma taking P from registers and V from
//   shared memory (transposed read).  P is not rounded once to bf16: it is
//   split as P_hi = bf16(P), P_lo = bf16(P − P_hi) and both products go
//   into the same float32 accumulator (about 16 significant bits, 1.5x the
//   operations of one pass).  The two warpgroups take turns (named
//   barriers) to issue P·V of tile j together with S of tile j + 1, so one
//   warpgroup's products run while the other does its softmax.  Tiles
//   wholly above the diagonal (or below the window) are not loaded; only
//   tiles that cross the diagonal, the window's lower edge or the end of
//   the sequence are masked.  The rings count tiles from the block's first
//   loaded tile, which a window moves off 0.  Keys below a row's window get
//   −inf, not −1e30: a row's first tile may hold no key of its window, and
//   exp2(s·c − m) with m = round(s·c) of s = −1e30 is 2^(rounding error),
//   which is 0 or inf; with −inf the row keeps m = −inf and its exponents
//   are taken against 0 until its first key.  Rows past Sq are not
//   stored.
// * float32 (every D), and bfloat16 at D = 16 and 32 (too narrow for the
//   128-byte panels of the tensor-core kernel): the CUDA-core kernel
//   (namespace simt).  Float32 stays off the tensor cores: one TF32 pass
//   cannot hold the reference's 2e-4.  As the TPU kernel does, it
//   multiplies q by the scale before q·kᵀ (in float32); the oracle
//   kernels/ref.py::attention_ref divides the scores instead, which differs
//   by float32 rounding only.  One 256-thread block per (64 query rows,
//   batch·head); the scaled Q tile stays in shared memory and the block
//   walks 64-row K and V tiles through one shared buffer (K for the
//   scores, then V for P·V).  Each thread owns a 4 x 4 patch of the 64 x 64
//   score tile (rows ty + 16a, columns tx + 16b) and 4 x D/16 of the
//   accumulator; the row max and sum are reduced over the 16 lanes that
//   share a row with shuffles.  Rows are padded by one float so neither the
//   K reads nor the P·V reads conflict on banks.
//
// Both launch the heaviest causal query blocks first and stop a causal
// block at its last row's tile.  With a window, a block starts at the tile
// that holds its first row's first key: tiles wholly below every row's
// window are neither loaded nor computed.
#include <cuda_bf16.h>

#include <math.h>

#include "hopper.cuh"

namespace simt {

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
    T* __restrict__ out, int group, int Sq, int Skv, int causal, int window, float scale) {
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
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
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
        else if ((causal && col > row) || (window > 0 && col <= row - window))
          s[a][b] = -1e30f;  // the TPU kernel's causal mask value; a tile all
                             // masked for a row is erased by the next corr = 0
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
           int Skv, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(BQ + BK) * (D + 1) + (size_t)BQ * PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, BHq);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(q, k, v, out, BHq / BHkv, Sq, Skv,
                                                           causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

namespace tc {

constexpr int BQ = 128;                  // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int STAGES = 2;                 // depth of the K and V rings

template <int D>
struct Shape {
  static constexpr int BK = D <= 128 ? 128 : 64;  // kv rows per tile
  static constexpr int PANELS = D / 64;           // 64-column (128-byte) panels
  static constexpr int Q_PANEL = BQ * 128;        // bytes
  static constexpr int KV_PANEL = BK * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or one V tile
  // Q, the K and V rings, and slack to align the start to 1024 bytes:
  // 81 KB (D 64), 161 KB (D 128), 193 KB (D 256) of the 227 KB a block may use
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q·Kᵀ for one warpgroup: 64 query rows x BK keys, summed over D in
// 16-wide k steps (the first one overwrites the accumulator)
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[Shape<D>::BK / 2], const uint8_t* q_wg,
                                             const uint8_t* kt) {
  using Sh = Shape<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;  // 16 bf16 along the 128-byte row
    hopper::wgmma_ss(sc, hopper::desc_sw128(q_wg + (kk / 4) * Sh::Q_PANEL + off, 16, 1024),
                     hopper::desc_sw128(kt + (kk / 4) * Sh::KV_PANEL + off, 16, 1024), kk > 0);
  }
}

// which named barrier a consumer warpgroup waits on for its turn, which one
// it releases, and whether it is the warpgroup that goes first
struct Turn {
  int mine, other;
  bool first;
};

// One kv tile for one consumer warpgroup, whose S of the block's tile t
// (kv tile j0 + t) is in `sc`: masks, online softmax, then one turn that
// issues O += P·V of tile t and, when kNext, S of tile t + 1.  Ring slots
// and mbarrier parities count t, the tiles this block has loaded.
template <int D, bool kNext>
__device__ __forceinline__ void tile_step(int t, int j0, float (&o)[D / 2],
                                          float (&sc)[Shape<D>::BK / 2], float (&m)[2],
                                          float (&l)[2], const Turn& turn, int row_wg, int r0,
                                          int cq, int Skv, int causal, int window,
                                          float scale_log2, const uint8_t* q_wg,
                                          const uint8_t* k_s, const uint8_t* v_s,
                                          uint64_t* k_full, uint64_t* v_full,
                                          uint64_t* k_empty, uint64_t* v_empty) {
  using Sh = Shape<D>;
  constexpr int BK = Sh::BK;
  const int s = t % STAGES;
  const int k0 = (j0 + t) * BK;

  // the masks, and each row's max over its 4 lanes; the running max m is
  // kept in log2 units (score · scale · log2 e)
  const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > row_wg) ||
                    (window > 0 && k0 <= row_wg + 63 - window);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (edge) {
      const int col = k0 + 8 * (i / 4) + cq + (i % 2);
      const int row = r0 + 8 * ((i / 2) % 2);
      if (col >= Skv || (window > 0 && col <= row - window))
        sc[i] = -INFINITY;  // past the sequence or below the window: no weight
      else if (causal && col > row)
        sc[i] = -1e30f;  // the TPU kernel's causal mask value
    }
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  }
  float alpha[2], mb[2];  // mb: the exponents' base, 0 while m = −inf
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    mb[h] = m_new == -INFINITY ? 0.0f : m_new;
    alpha[h] = ex2(m[h] - mb[h]);  // 0 until the row's first key (m = −inf)
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

  // P = exp2(s·scale·log2 e − m) as the A operand of P·V: accumulator
  // pairs (i, i+1) become the bf16 pairs of k step i / 8, register
  // (i % 8) / 2, split into a high and a low part
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int h = (i / 2) % 2;
    const float p0 = ex2(fmaf(sc[i], scale_log2, -mb[h]));
    const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -mb[h]));
    l[h] += p0 + p1;
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
    const float2 hf = __bfloat1622float2(hi);
    p_hi[i / 8][(i % 8) / 2] = bits(hi);
    p_lo[i / 8][(i % 8) / 2] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
  }

  // one turn: O += P_hi·V + P_lo·V, then S of the next tile
  hopper::bar_sync(turn.mine, CONSUMERS);
  hopper::mbar_wait(v_full + s, (t / STAGES) & 1);
  hopper::fence_regs(o);
  hopper::fence_regs(sc);
  hopper::fence_regs(p_hi);
  hopper::fence_regs(p_lo);
  hopper::wgmma_fence();
  const uint8_t* vt = v_s + s * Sh::KV_BYTES;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(vt + kk * 16 * 128, Sh::KV_PANEL, 1024);
    hopper::wgmma_rs_tb(o, p_hi[kk], dv);
    hopper::wgmma_rs_tb(o, p_lo[kk], dv);
  }
  if (kNext) {  // a template argument: no branch around a wgmma
    const int s1 = (t + 1) % STAGES;
    hopper::mbar_wait(k_full + s1, ((t + 1) / STAGES) & 1);
    issue_scores<D>(sc, q_wg, k_s + s1 * Sh::KV_BYTES);
  }
  hopper::wgmma_commit();
  // warpgroup 0 has one turn after warpgroup 1's last: that one is not passed on
  if (kNext || turn.first) hopper::bar_arrive(turn.other, CONSUMERS);
  hopper::wgmma_wait_all();
  hopper::fence_regs(o);
  hopper::fence_regs(sc);
  hopper::fence_regs(p_hi);
  hopper::fence_regs(p_lo);
  if (threadIdx.x % 32 == 0) {  // this warp is done with V of tile t and K of tile t + 1
    hopper::mbar_arrive(v_empty + s);
    if (kNext) hopper::mbar_arrive(k_empty + (t + 1) % STAGES);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_tc(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int group, int Sq,
    int Skv, int causal, int window, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int BK = Sh::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];
  uint8_t* q_s = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + Sh::Q_BYTES;  // STAGES K tiles
  uint8_t* v_s = k_s + STAGES * Sh::KV_BYTES;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* k_empty = bars + 1 + 2 * STAGES;
  uint64_t* v_empty = bars + 1 + 3 * STAGES;

  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * BQ;  // heaviest causal blocks first
  const int bh = blockIdx.x;
  const int kv_end = causal ? min(Skv, min(Sq, q0 + BQ)) : Skv;
  const int j0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;  // first kv tile loaded
  const int n_tiles = (kv_end + BK - 1) / BK - j0;  // >= 1: the wrapper leaves no row keyless

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(k_empty + s, CONSUMERS / 32);  // one arrival per consumer warp
      hopper::mbar_init(v_empty + s, CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer: its first thread issues every load
    hopper::regs_release<24>();
    if (threadIdx.x == CONSUMERS) {
      const int bkv = bh / group;
      hopper::mbar_expect_tx(q_full, Sh::Q_BYTES);
      for (int p = 0; p < Sh::PANELS; ++p)
        hopper::tma_load_3d(q_s + p * Sh::Q_PANEL, &tq, q_full, 64 * p, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int k0 = (j0 + t) * BK;
        uint8_t* kt = k_s + s * Sh::KV_BYTES;
        uint8_t* vt = v_s + s * Sh::KV_BYTES;
        if (t >= STAGES) hopper::mbar_wait(k_empty + s, (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(k_full + s, Sh::KV_BYTES);
        for (int p = 0; p < Sh::PANELS; ++p)
          hopper::tma_load_3d(kt + p * Sh::KV_PANEL, &tk, k_full + s, 64 * p, k0, bkv);
        if (t >= STAGES) hopper::mbar_wait(v_empty + s, (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(v_full + s, Sh::KV_BYTES);
        for (int p = 0; p < Sh::PANELS; ++p)
          hopper::tma_load_3d(vt + p * Sh::KV_PANEL, &tv, v_full + s, 64 * p, k0, bkv);
      }
    }
    return;  // the paths never rejoin (setmaxnreg)
  }

  hopper::regs_claim<240>();  // 2 x 128 x 240 + 128 x 24 of the SM's 65,536
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row_wg = q0 + 64 * wg;              // the warpgroup's first query row
  const int r0 = row_wg + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);                // its first column in each 8-column chunk
  const uint8_t* q_wg = q_s + 64 * 128 * wg;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2: a warpgroup waits on its own, then releases the other's), so
  // one's products run on the tensor cores while the other does softmax.
  // A turn issues P·V of tile j together with S of tile j + 1.
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  if (wg == 1) hopper::bar_arrive(other_turn, CONSUMERS);  // warpgroup 0 goes first
  float sc[BK / 2];  // S of the current tile, float32
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
  hopper::mbar_wait(q_full, 0);
  hopper::bar_sync(my_turn, CONSUMERS);
  hopper::mbar_wait(k_full, 0);
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
  issue_scores<D>(sc, q_wg, k_s);
  hopper::wgmma_commit();
  hopper::bar_arrive(other_turn, CONSUMERS);
  hopper::wgmma_wait_all();
  hopper::fence_regs(sc);
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(k_empty);  // K of tile 0 is read

  const Turn turn{my_turn, other_turn, wg == 0};
  for (int t = 0; t + 1 < n_tiles; ++t)
    tile_step<D, true>(t, j0, o, sc, m, l, turn, row_wg, r0, cq, Skv, causal, window, scale_log2,
                       q_wg, k_s, v_s, k_full, v_full, k_empty, v_empty);
  tile_step<D, false>(n_tiles - 1, j0, o, sc, m, l, turn, row_wg, r0, cq, Skv, causal, window,
                      scale_log2, q_wg, k_s, v_s, k_full, v_full, k_empty, v_empty);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * Sq + row) * D + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * h] / l[h], o[4 * c + 2 * h + 1] / l[h]);
  }
}

// cuTensorMapEncodeTiled lives in libcuda; the runtime's entry-point query
// finds it, so the library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (heads, rows, D) bf16 tensor, read in boxes of 64 columns x box_rows rows
bool tile_map(CUtensorMap* map, const void* base, int D, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)D * rows * 2};  // bytes
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                   strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BHq, int BHkv, int Sq,
           int Skv, int causal, int window, float scale, cudaStream_t stream) {
  using Sh = Shape<D>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) return (int)cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv;
  if (!tile_map(&mq, q, D, Sq, BHq, BQ) || !tile_map(&mk, k, D, Skv, BHkv, Sh::BK) ||
      !tile_map(&mv, v, D, Skv, BHkv, Sh::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BHq, (Sq + BQ - 1) / BQ);
  flash_attention_tc<D><<<grid, THREADS, Sh::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, BHq / BHkv, Sq, Skv, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   int BHq, int BHkv, int Sq, int Skv, int D, int causal,
                                   int window, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return simt::launch<float, 16>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 32: return simt::launch<float, 32>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 64: return simt::launch<float, 64>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 128: return simt::launch<float, 128>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 256: return simt::launch<float, 256>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int BHq, int BHkv, int Sq, int Skv, int D, int causal,
                                    int window, float scale, void* stream) {
  using bf = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  const bf *qb = (const bf*)q, *kb = (const bf*)k, *vb = (const bf*)v;
  switch (D) {  // CUDA cores below one 64-column panel, tensor cores from there
    case 16: return simt::launch<bf, 16>(qb, kb, vb, (bf*)out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 32: return simt::launch<bf, 32>(qb, kb, vb, (bf*)out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 64: return tc::launch<64>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 128: return tc::launch<128>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    case 256: return tc::launch<256>(q, k, v, out, BHq, BHkv, Sq, Skv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
