// B5 · Mamba-2 SSD intra-chunk block and chunk states.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_intra_chunk (Pallas body
// _ssd_kernel).  For one (batch·chunk·head) cell with L steps:
//   Y[i]  = Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · dt_j · X[j]      (L x P)
//   S[n]  = Σ_j B_j[n] · exp(cum_{L−1} − cum_j) · dt_j · X[j]         (N x P)
// in float32.  B and C are shared by the `group` consecutive cells of one
// B/C group (the heads of a chunk), so cell r reads B/C row r / group: the
// caller passes them once per (batch, chunk, group), never repeated per head.
//
// What bounds it on the H100: operations.  At the served shape (mamba2-780m
// prefill: 768 cells, L = 256, P = 64, N = 128) the causal half of C·Bᵀ, the
// masked W·X and the state product need 12.9 GFLOP of float32 (0.19 ms at
// 67 TFLOP/s) against ~130 MB of traffic (0.04 ms).  This first version uses
// the CUDA cores in float32 (no TF32 tensor cores, no TMA).
//
// Design: grid (cell, row tile).  Blocks with blockIdx.y < ceil(L/64) each
// compute 64 rows of Y: for every 64-step tile j ≤ i they form the 64 x 64
// score tile C_i·B_jᵀ over 16-wide slices of N in shared memory, turn it
// into weights, and accumulate W·X_j.  The weight is selected before the
// exponential is taken: for j > i, exp(cum_i − cum_j) has a positive
// argument and can overflow to inf over a 256-step chunk, and inf · 0 is
// NaN, so masked entries are set to 0 and never multiplied.  The remaining
// ceil(N/64) blocks of a cell each compute 64 rows of the state from
// (B ⊙ w)ᵀ·X, w_j = exp(cum_{L−1} − cum_j)·dt_j.  Each thread owns a 4 x 4
// patch (rows ty + 16a, columns tx + 16c), so P is at most 64.  Shared rows
// are padded by one float to keep column-strided reads off one bank.  Any L,
// N and P ≤ 64 work: edges are masked.  Shared memory is 42 KB (static).
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int TI = 64;  // rows of Y (or of S) per block
constexpr int TJ = 64;  // steps per tile
constexpr int TN = 16;  // slice of N for C·Bᵀ
constexpr int PMAX = 64;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT) ssd_intra_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ cum,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ st, int group, int L, int P, int N, int row_tiles) {
  __shared__ float cs[TI][TN + 1];    // C rows i, one N slice
  __shared__ float bs[TJ][TN + 1];    // B rows j, one N slice
  __shared__ float ws[TJ][TJ + 1];    // weights W[i][j]; in a state block B[j][n]·w_j
  __shared__ float xs[TJ][PMAX + 1];  // X rows j
  __shared__ float cum_i[TI], cum_j[TJ], dt_j[TJ];

  const int cell = blockIdx.x;
  const size_t bc_row = (size_t)(cell / group);
  const float* xc = x + (size_t)cell * L * P;
  const float* dtc = dt + (size_t)cell * L;
  const float* cumc = cum + (size_t)cell * L;
  const float* Bc = Bm + bc_row * L * N;
  const float* Cc = Cm + bc_row * L * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  if ((int)blockIdx.y < row_tiles) {
    const int i0 = blockIdx.y * TI;
    if (tid < TI) cum_i[tid] = (i0 + tid < L) ? cumc[i0 + tid] : 0.0f;
    const int j_end = min(L, i0 + TI);
    for (int j0 = 0; j0 < j_end; j0 += TJ) {
      __syncthreads();  // the previous tile's weights and X no longer read
      if (tid < TJ) {
        cum_j[tid] = (j0 + tid < L) ? cumc[j0 + tid] : 0.0f;
        dt_j[tid] = (j0 + tid < L) ? dtc[j0 + tid] : 0.0f;
      }
      for (int e = tid; e < TJ * P; e += NT) {
        const int r = e / P, c = e % P;
        xs[r][c] = (j0 + r < L) ? xc[(size_t)(j0 + r) * P + c] : 0.0f;
      }
      float cb[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) cb[a][b] = 0.0f;
      for (int n0 = 0; n0 < N; n0 += TN) {
        __syncthreads();
        for (int e = tid; e < TI * TN; e += NT) {
          const int r = e / TN, c = e % TN;
          const bool n_ok = n0 + c < N;
          cs[r][c] = (i0 + r < L && n_ok) ? Cc[(size_t)(i0 + r) * N + n0 + c] : 0.0f;
          bs[r][c] = (j0 + r < L && n_ok) ? Bc[(size_t)(j0 + r) * N + n0 + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = cs[ty + 16 * a][c];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = bs[tx + 16 * b][c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) cb[a][b] = fmaf(cv[a], bv[b], cb[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ii = ty + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jj = tx + 16 * b;
          float w = 0.0f;  // selected, never multiplied: exp() may be inf for j > i
          if (j0 + jj <= i0 + ii && j0 + jj < L && i0 + ii < L)
            w = (cb[a][b] * expf(cum_i[ii] - cum_j[jj])) * dt_j[jj];
          ws[ii][jj] = w;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < TJ; ++jj) {
        float wv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = ws[ty + 16 * a][jj];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xs[jj][tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(wv[a], xv[c], acc[a][c]);
      }
    }
    float* yc = y + (size_t)cell * L * P;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (i < L && p < P) yc[(size_t)i * P + p] = acc[a][c];
      }
    }
  } else {
    const int nb = (blockIdx.y - row_tiles) * TI;
    const float cum_last = cumc[L - 1];
    for (int j0 = 0; j0 < L; j0 += TJ) {
      __syncthreads();  // the previous tile no longer read
      if (tid < TJ)
        dt_j[tid] = (j0 + tid < L) ? expf(cum_last - cumc[j0 + tid]) * dtc[j0 + tid] : 0.0f;
      for (int e = tid; e < TJ * P; e += NT) {
        const int r = e / P, c = e % P;
        xs[r][c] = (j0 + r < L) ? xc[(size_t)(j0 + r) * P + c] : 0.0f;
      }
      __syncthreads();
      for (int e = tid; e < TJ * TI; e += NT) {
        const int r = e / TI, c = e % TI;
        ws[r][c] = (j0 + r < L && nb + c < N) ? Bc[(size_t)(j0 + r) * N + nb + c] * dt_j[r] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < TJ; ++jj) {
        float bv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = ws[jj][ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xs[jj][tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(bv[a], xv[c], acc[a][c]);
      }
    }
    float* sc = st + (size_t)cell * N * P;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = nb + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (n < N && p < P) sc[(size_t)n * P + p] = acc[a][c];
      }
    }
  }
}

}  // namespace

extern "C" int ssd_intra_chunk_f32(const float* x, const float* dt, const float* cum,
                                   const float* Bm, const float* Cm, float* y, float* st,
                                   int cells, int group, int L, int P, int N, void* stream) {
  if (P > PMAX || L < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int row_tiles = (L + TI - 1) / TI;
  const dim3 grid(cells, row_tiles + (N + TI - 1) / TI);
  ssd_intra_chunk_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(x, dt, cum, Bm, Cm, y, st, group,
                                                                L, P, N, row_tiles);
  return (int)cudaGetLastError();
}
