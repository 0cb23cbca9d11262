// B5 · Mamba-2 SSD intra-chunk block and chunk states.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_intra_chunk (Pallas body
// _ssd_kernel).  For one (batch·chunk·head) cell with L steps:
//   Y[i]  = Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · dt_j · X[j]      (L x P)
//   S[n]  = Σ_j B_j[n] · exp(cum_{L−1} − cum_j) · dt_j · X[j]         (N x P)
// in float32.  B and C are shared by the `group` consecutive cells of one
// B/C row (the heads of a chunk), so cell r reads B/C row r / group: the
// caller passes them once per (batch, chunk, group), never repeated per head.
//
// What bounds it on the H100: at the served shape (mamba2-780m prefill: 768
// cells over 16 B/C rows, L = 256, P = 64, N = 128) the function moves
// 131.6 MB (0.039 ms at 3.35 TB/s) and, with C·Bᵀ counted once per B/C
// row, needs 6.59 GFLOP: 0.040 ms as three TF32 passes on the tensor cores
// (495 TFLOP/s), 0.098 ms in float32 on the CUDA cores.  Bytes and
// operations are about even, and only the tensor cores come near either.
//
// The products run on the tensor cores in 3xTF32: each float32 operand a is
// split as big = tf32(a) (rounded to nearest, ties away, as
// cvt.rna.tf32.f32 does, but on the integer pipe) and small = a − big, which
// the tensor cores read truncated to TF32, and small·big, big·small and then
// big·big go into one float32 accumulator.  One TF32 pass
// keeps 11 significant bits and misses the reference's 2e-4 by up to 38x
// (tests/test_torch_ssd_tf32.py); the split keeps about 22.
//
// Design: one block of four warpgroups (512 threads) per (B/C row, tile,
// group of up to 12 heads), one block per SM.
// * A Y block takes 64 rows i of Y.  It first forms the causal strip
//   C_i·B_jᵀ for all j ≤ its last row once, in shared memory (64 x 256
//   float32, mma.sync m16n8k8 in 3xTF32, C and B staged in 64-wide slices of
//   N), so C·Bᵀ is computed once per group of heads (4 times per B/C row at
//   G = 48, not 48).  A state block takes 64 rows n of S and holds B's
//   columns n for all j in the same place.  State blocks and the Y blocks
//   of the last rows (the most work) are launched first.
// * Then each warpgroup walks its share of the heads (wg, wg + 4, ...).
//   Per 32-step chunk of a head: X arrives by cp.async (double-buffered,
//   16-byte copies when P and N are multiples of 4, 4-byte ones otherwise,
//   zero-filled past the edges); the warpgroup splits it once into TF32 big
//   and small panels, transposed to K-major with the 128-byte swizzle; each
//   warp makes the weights of its 16 rows in registers,
//   W = strip · exp(c_row − cum_j) · dt_j (c_row = cum_i for Y, cum_{L−1}
//   for S), split, as the A operand; and three wgmma m64n64k8 per 8-step
//   add small·big, big·small and big·big into the head's 64 x 64
//   accumulator.  Within each 8-step the k order is permuted the same way in
//   both operands (MMA k = u at step 2u, k = u + 4 at step 2u + 1), so W
//   loads as float2.  The weight is selected before the exponential is
//   taken: for j > i, exp(cum_i − cum_j) can overflow to inf over a
//   256-step chunk, and inf · 0 is NaN; chunks that need no mask skip it.
// Strides are padded so that no shared-memory access conflicts on a bank.
// Any L (segments of 256 steps, partial sums kept in the output), any N and
// P ≤ 64 work.  Shared memory: 217 KB.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WG = 4;         // warpgroups per block
constexpr int NT = 128 * WG;  // threads per block
constexpr int T = 64;         // rows of a Y or S tile; C·Bᵀ columns per step
constexpr int TC = 32;        // steps per X chunk of a head
constexpr int SEG = 256;      // steps per segment (strip columns in shared memory)
constexpr int SS = SEG + 8;   // strip row stride (Y blocks: C·Bᵀ, rows i)
constexpr int BS = 64 + 4;    // state blocks: B rows j, 64 columns n
constexpr int NS = 64;        // slice of N per C·Bᵀ step
constexpr int CS = NS + 8;    // C/B slice row stride
constexpr int XS = 64 + 16;   // X row stride
constexpr int PMAX = 64;
constexpr int HMAX = 12;                   // heads per block
constexpr int CB_STAGE = 2 * T * CS;       // one C slice and one B slice (floats)
constexpr int X_STAGE = TC * XS + 2 * TC;  // one X chunk, its cum and dt (floats)
constexpr int STRIP = T * SS > SEG * BS ? T * SS : SEG * BS;  // floats
constexpr int PANEL_BYTES = 64 * TC * 4;  // one TF32 part of an X chunk, K-major
// a warpgroup's staging: two X stages, then the two panels at a 1024-byte
// boundary (the swizzle's period)
constexpr int PANELS_AT = (2 * X_STAGE * 4 + 1023) / 1024 * 1024;
constexpr int WG_BYTES = PANELS_AT + 2 * PANEL_BYTES;
constexpr int STAGING_AT = STRIP * 4;  // the C·Bᵀ stages and the warpgroups' staging
static_assert(STAGING_AT % 1024 == 0 && WG_BYTES % 1024 == 0, "panels must stay aligned");
static_assert(2 * CB_STAGE * 4 <= WG * WG_BYTES, "C·Bᵀ stages overflow");
constexpr int SMEM_BYTES = STAGING_AT + WG * WG_BYTES + 1024;  // + alignment slack

// ---- cp.async: `bytes` of the copy are read, the rest zero-filled ----------
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + R) x columns [c0, c0 + W) of a row-major
// (nrows x ncols) matrix into dst (row stride S), with NTH threads (this one
// is `tid`); zeros outside the matrix.
template <int R, int W, int S, bool V16, int NTH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int nrows, int c0,
                                          int ncols, int tid) {
  constexpr int V = V16 ? 4 : 1;  // floats per copy
  constexpr int PER_ROW = W / V;
  static_assert(R * PER_ROW % NTH == 0, "every thread copies as many");
#pragma unroll
  for (int k = 0; k < R * PER_ROW / NTH; ++k) {
    const int e = tid + k * NTH;
    const int r = e / PER_ROW, c = (e % PER_ROW) * V;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    const float* s = ok ? src + (size_t)(r0 + r) * ncols + c0 + c : src;
    if (V16)
      cp_async16(dst + r * S + c, s, ok ? 16 : 0);
    else
      cp_async4(dst + r * S + c, s, ok ? 4 : 0);
  }
}

// ---- 3xTF32 ------------------------------------------------------------------
// a rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), on the integer pipe: the conversion pipe does 16 a clock per
// SM, and every product here needs its operands split
__device__ __forceinline__ uint32_t tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}
// 2^a (ex2.approx: 2 ulp)
__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(a));
  return r;
}
constexpr float LOG2E = 1.4426950408889634f;

// big = tf32(a); small = a − big is exact (at most 12 significant bits) and
// is passed unrounded: the tensor cores read the top 19 bits of an operand,
// so it is truncated to TF32, within one float32 ulp of a.  The
// unrounded small part is also what carries a NaN: the carry turns a NaN's
// payload into a big part of ±0 (CUDA's 0x7FFFFFFF becomes −0), but
// NaN − big is NaN.  An inf keeps big = inf and gets small = NaN.  Rounding
// small as well would cost integer work on every split and lose that NaN
// unless a select guarded it, and the select alone slowed the kernel by
// about a quarter on the card.
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = tf32(a);
  small = __float_as_uint(a - __uint_as_float(big));
}

// d (16 x 8) += a (16 x 8) · b (8 x 8) on mma.sync.  Lane (g = lane / 4,
// t = lane % 4) holds a at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// b at (t, g), (t + 4, g); d at (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows (g, g + 8) from four values (MMA k = t, t + 4), split
__device__ __forceinline__ void a_frag(uint32_t (&ab)[4], uint32_t (&as)[4], float g_t,
                                       float g8_t, float g_t4, float g8_t4) {
  split(g_t, ab[0], as[0]);
  split(g8_t, ab[1], as[1]);
  split(g_t4, ab[2], as[2]);
  split(g8_t4, ab[3], as[3]);
}

// ---- Y blocks: the strip C_i·B_jᵀ, j in [s0, s0 + 64·nc) ---------------------
// Each 64 x 64 block of it is summed over N in slices of NS; warp w takes
// rows 16(w % 4).. and the NTW column tiles of its warpgroup.
template <bool V16>
__device__ __forceinline__ void cb_strip(float* strip, float* stage, const float* Cc,
                                         const float* Bc, int i0, int s0, int nc, int L, int N) {
  constexpr int NTW = 8 / WG;  // 8-column tiles per warp
  const int w = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int row = 16 * (w % 4) + g, col0 = 8 * NTW * (w / 4);
  const int nsl = (N + NS - 1) / NS;
  const int steps = nc * nsl;
  auto issue = [&](int s) {
    float* cs = stage + (s & 1) * CB_STAGE;
    load_tile<T, NS, CS, V16, NT>(cs, Cc, i0, L, (s % nsl) * NS, N, threadIdx.x);
    load_tile<T, NS, CS, V16, NT>(cs + T * CS, Bc, s0 + (s / nsl) * T, L, (s % nsl) * NS, N,
                                  threadIdx.x);
    cp_commit();
  };
  float acc[NTW][4];
  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int c = s / nsl, k = s % nsl;
    if (k == 0) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
    }
    const float* cs = stage + (s & 1) * CB_STAGE;
    const float* bs = cs + T * CS + col0 * CS;
#pragma unroll
    for (int k0 = 0; k0 < NS; k0 += 8) {
      const float2 lo = *reinterpret_cast<const float2*>(cs + row * CS + k0 + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(cs + (row + 8) * CS + k0 + 2 * t);
      uint32_t ab[4], as[4];
      a_frag(ab, as, lo.x, hi.x, lo.y, hi.y);
      uint32_t bb[NTW][2], bsm[NTW][2];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const float2 v = *reinterpret_cast<const float2*>(bs + (8 * nt + g) * CS + k0 + 2 * t);
        split(v.x, bb[nt][0], bsm[nt][0]);
        split(v.y, bb[nt][1], bsm[nt][1]);
      }
      // the small products first, then big·big, each pass over all tiles
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) mma(acc[nt], as, bb[nt][0], bb[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) mma(acc[nt], ab, bsm[nt][0], bsm[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) mma(acc[nt], ab, bb[nt][0], bb[nt][1]);
    }
    if (k == nsl - 1) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        float* p = strip + row * SS + c * T + col0 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(p + 8 * SS) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();  // this stage is refilled two steps on
  }
}

// The A operand of one X chunk for the rows (lr, lr + 8) of this thread:
// W = strip · exp(c_row − cum_j) · dt_j at its steps of each 8-step, split
// into TF32 parts; ca and cb are c_row · log2 e, so exp(c_row − cum_j) =
// 2^(ca − cum_j · log2 e) takes one fma.  Y: c_row = cum_i, and MASK keeps
// j ≤ i (selected before the exponential, which is inf for j > i over a
// long chunk: inf · 0 is NaN).  S: c_row = cum_{L−1}, one weight per step,
// and MASK keeps j < L.
template <bool STATE, bool MASK>
__device__ __forceinline__ void weights(uint32_t (&ab)[TC / 8][4], uint32_t (&as)[TC / 8][4],
                                        const float* strip, const float* cj, const float* dj,
                                        int c, int lr, int t, int jc, float ca, float cb, int ja,
                                        int jb) {
#pragma unroll
  for (int ks = 0; ks < TC / 8; ++ks) {
    const int kk = 8 * ks + 2 * t;
    const int j = jc + kk;
    float2 va, vb;  // rows a and b at steps j, j + 1
    if (STATE) {    // strip[j][n]: B, read down its columns
      const float* sp = strip + (c * TC + kk) * BS + lr;
      va = make_float2(sp[0], sp[BS]);
      vb = make_float2(sp[8], sp[BS + 8]);
    } else {  // strip[i][j]: C·Bᵀ
      const float* sp = strip + lr * SS + c * TC + kk;
      va = *reinterpret_cast<const float2*>(sp);
      vb = *reinterpret_cast<const float2*>(sp + 8 * SS);
    }
    const float2 cu = *reinterpret_cast<const float2*>(cj + kk);
    const float2 d = *reinterpret_cast<const float2*>(dj + kk);
    float wt[4];  // (row a, j), (row b, j), (row a, j + 1), (row b, j + 1)
    if (STATE) {
      const float e0 = !MASK || j <= ja ? ex2(fmaf(-cu.x, LOG2E, ca)) * d.x : 0.0f;
      const float e1 = !MASK || j + 1 <= ja ? ex2(fmaf(-cu.y, LOG2E, ca)) * d.y : 0.0f;
      wt[0] = va.x * e0, wt[1] = vb.x * e0, wt[2] = va.y * e1, wt[3] = vb.y * e1;
    } else {
      wt[0] = !MASK || j <= ja ? va.x * ex2(fmaf(-cu.x, LOG2E, ca)) * d.x : 0.0f;
      wt[1] = !MASK || j <= jb ? vb.x * ex2(fmaf(-cu.x, LOG2E, cb)) * d.x : 0.0f;
      wt[2] = !MASK || j + 1 <= ja ? va.y * ex2(fmaf(-cu.y, LOG2E, ca)) * d.y : 0.0f;
      wt[3] = !MASK || j + 1 <= jb ? vb.y * ex2(fmaf(-cu.y, LOG2E, cb)) * d.y : 0.0f;
    }
    a_frag(ab[ks], as[ks], wt[0], wt[1], wt[2], wt[3]);
  }
}

// ---- the heads: out tile += A·X per head, A = strip ⊙ weights ---------------
// Y (STATE false): rows i, weight exp(cum_i − cum_j)·dt_j for j ≤ i; S
// (STATE true): rows n, weight exp(cum_{L−1} − cum_j)·dt_j.  Warpgroup wg
// takes heads wg, wg + WG, ... of the block: warp w makes the weights of
// rows 16w..16w+15 (w within the warpgroup) in registers, the A operand of
// wgmma, and each head's 64 x 64 product runs as wgmma m64n64k8 with X from
// shared memory.  X arrives in 32-step chunks (cp.async, double-buffered);
// the warpgroup splits each chunk once into TF32 high and low parts,
// transposed into two K-major panels with the 128-byte swizzle, for the
// three products of every 8-step.  Warpgroups sync on their own barriers.
template <bool V16, bool STATE>
__device__ __forceinline__ void heads(const float* strip, uint8_t* staging, const float* x,
                                      const float* dt, const float* cum, float* out, int cell0,
                                      int nh, int r0, int rows, int s0, int nseg, int L, int P) {
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nc = (nseg + TC - 1) / TC;
  const int items = (nh - wg + WG - 1) / WG * nc;
  uint8_t* mine = staging + wg * WG_BYTES;
  float* stages = reinterpret_cast<float*>(mine);
  uint8_t* p_big = mine + PANELS_AT;
  auto issue = [&](int it) {
    const size_t cell = cell0 + wg + WG * (it / nc);
    const int j0 = s0 + (it % nc) * TC;
    float* xs = stages + (it & 1) * X_STAGE;
    load_tile<TC, PMAX, XS, V16, 128>(xs, x + cell * L * P, j0, L, 0, P, tid);
    if (tid < 2 * TC) {  // threads 0-31 copy cum, 32-63 dt
      const int e = tid % TC;
      const float* src = (tid < TC ? cum : dt) + cell * L;
      const bool ok = j0 + e < L;
      cp_async4(xs + TC * XS + tid, ok ? src + j0 + e : src, ok ? 4 : 0);
    }
    cp_commit();
  };
  const int lr = 16 * w + g;  // this thread's rows in the tile: lr and lr + 8
  const int ra = r0 + lr, rb = ra + 8;
  float acc[32];  // wgmma layout: register q holds row lr + 8·((q/2)%2), column 8(q/4) + 2t + q%2
  float ca = 0.0f, cb = 0.0f;  // the rows' cum (Y) or cum_{L−1} (S), times log2 e
  int ja = -1, jb = -1;        // the last step j each row weighs
  if (items > 0) issue(0);
  for (int it = 0; it < items; ++it) {
    const int c = it % nc;
    const size_t cell = cell0 + wg + WG * (it / nc);
    float* o = out + cell * rows * P;
    if (c == 0) {  // a new head: its row constants, and the sums of earlier segments
      if (STATE) {
        ca = cb = cum[cell * L + L - 1] * LOG2E;
        ja = jb = L - 1;
      } else {
        ca = ra < L ? cum[cell * L + ra] * LOG2E : 0.0f;
        cb = rb < L ? cum[cell * L + rb] * LOG2E : 0.0f;
        ja = ra < L ? ra : -1;
        jb = rb < L ? rb : -1;
      }
      if (s0 == 0) {
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
      } else {
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const int row = (q / 2) % 2 ? rb : ra, col = 8 * (q / 4) + 2 * t + q % 2;
          acc[q] = row < rows && col < P ? o[(size_t)row * P + col] : 0.0f;
        }
      }
    }
    if (it + 1 < items) {
      issue(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    hopper::bar_sync(1 + wg, 128);  // chunk `it` has landed; the panels are free
    const float* xs = stages + (it & 1) * X_STAGE;
    // split and transpose: panel row p holds the chunk's 32 steps of column p,
    // each 8-step in MMA k order (k = u at step 2u, k = u + 4 at step 2u + 1),
    // its 16-byte chunk kc at chunk kc ^ (p % 8).  A lane takes column
    // p = 16w + lane % 16 and the chunks kc of parity lane / 16: its four
    // values at steps 8 (kc / 2) + 2u + kc % 2, u = 0..3, go out as one
    // 16-byte store per panel.  X rows are 16 mod 32 floats apart, so the
    // reads do not share a bank; nor do the stores of a quarter warp.
    {
      const int p = 16 * w + lane % 16, odd = lane / 16;
      const float* src = xs + odd * XS + p;
      uint8_t* dst = p_big + 128 * p;
#pragma unroll
      for (int kb = 0; kb < 8; kb += 2) {
        const float* s = src + 8 * (kb / 2) * XS;
        uint4 big, small;
        split(s[0], big.x, small.x);
        split(s[2 * XS], big.y, small.y);
        split(s[4 * XS], big.z, small.z);
        split(s[6 * XS], big.w, small.w);
        const int off = 16 * ((kb + odd) ^ (p % 8));
        *reinterpret_cast<uint4*>(dst + off) = big;
        *reinterpret_cast<uint4*>(dst + PANEL_BYTES + off) = small;
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(1 + wg, 128);
    const float* cj = xs + TC * XS;
    const float* dj = cj + TC;
    const int jc = s0 + c * TC;  // first step of this chunk
    uint32_t ab[TC / 8][4], as[TC / 8][4];
    // a Y chunk wholly below the tile's first row, and a state chunk wholly
    // inside L, weigh every entry: no mask
    if (STATE ? jc + TC <= L : jc + TC <= r0)
      weights<STATE, false>(ab, as, strip, cj, dj, c, lr, t, jc, ca, cb, ja, jb);
    else
      weights<STATE, true>(ab, as, strip, cj, dj, c, lr, t, jc, ca, cb, ja, jb);
    hopper::fence_regs(acc);
    hopper::fence_regs(ab);
    hopper::fence_regs(as);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC / 8; ++ks) {  // small products first, then big·big
      const uint64_t db = hopper::desc_sw128(p_big + 32 * ks, 16, 1024);
      const uint64_t ds = hopper::desc_sw128(p_big + PANEL_BYTES + 32 * ks, 16, 1024);
      hopper::wgmma_tf32_rs(acc, as[ks], db);
      hopper::wgmma_tf32_rs(acc, ab[ks], ds);
      hopper::wgmma_tf32_rs(acc, ab[ks], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::fence_regs(ab);
    hopper::fence_regs(as);
    if (c == nc - 1) {
#pragma unroll
      for (int q = 0; q < 32; q += 2) {  // columns col, col + 1 of one row
        const int row = (q / 2) % 2 ? rb : ra, col = 8 * (q / 4) + 2 * t;
        if (row >= rows || col >= P) continue;
        float* dst = o + (size_t)row * P + col;
        if (P % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[q], acc[q + 1]);
        } else {
          dst[0] = acc[q];
          if (col + 1 < P) dst[1] = acc[q + 1];
        }
      }
    }
  }
}

// grid: (B/C row · head group, tile).  Tiles y < n_tiles are state tiles
// (rows n = 64y...); the rest are Y tiles, the last rows first.
template <bool V16>
__global__ void __launch_bounds__(NT, 1) ssd_intra_chunk_tc(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ cum,
    const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
    float* __restrict__ st, int group, int L, int P, int N, int groups, int hpb, int n_tiles,
    int row_tiles) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - hopper::smem_u32(smem_raw) % 1024) % 1024);
  float* strip = reinterpret_cast<float*>(base);
  uint8_t* staging = base + STAGING_AT;
  const int r = blockIdx.x / groups, hg = blockIdx.x % groups;
  const int h0 = hg * hpb, nh = min(hpb, group - h0);
  const int cell0 = r * group + h0;
  const float* Bc = Bm + (size_t)r * L * N;
  const float* Cc = Cm + (size_t)r * L * N;
  const bool state = (int)blockIdx.y < n_tiles;
  const int r0 = (state ? (int)blockIdx.y : row_tiles - 1 - ((int)blockIdx.y - n_tiles)) * T;
  const int j_end = state ? L : min(L, r0 + T);
  for (int s0 = 0; s0 < j_end; s0 += SEG) {
    const int nseg = min(SEG, j_end - s0);
    if (state) {
      load_tile<SEG, T, BS, V16, NT>(strip, Bc, s0, L, r0, N, threadIdx.x);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      heads<V16, true>(strip, staging, x, dt, cum, st, cell0, nh, r0, N, s0, nseg, L, P);
    } else {
      cb_strip<V16>(strip, reinterpret_cast<float*>(staging), Cc, Bc, r0, s0,
                    (nseg + T - 1) / T, L, N);
      heads<V16, false>(strip, staging, x, dt, cum, y, cell0, nh, r0, L, s0, nseg, L, P);
    }
    __syncthreads();  // the strip and the staging are free again
  }
}

template <bool V16>
cudaError_t launch(const float* x, const float* dt, const float* cum, const float* Bm,
                   const float* Cm, float* y, float* st, int cells, int group, int L, int P, int N,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_tc<V16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int groups = (group + HMAX - 1) / HMAX;
  const int hpb = (group + groups - 1) / groups;
  const int n_tiles = (N + T - 1) / T, row_tiles = (L + T - 1) / T;
  const dim3 grid((cells / group) * groups, n_tiles + row_tiles);
  ssd_intra_chunk_tc<V16><<<grid, NT, SMEM_BYTES, stream>>>(x, dt, cum, Bm, Cm, y, st, group, L,
                                                            P, N, groups, hpb, n_tiles, row_tiles);
  return cudaGetLastError();
}

}  // namespace

// Inputs are contiguous float32 starting on 16-byte boundaries (the wrapper
// checks); rows of x, B and C are copied 16 bytes at a time when P and N are
// multiples of 4.
extern "C" int ssd_intra_chunk_f32(const float* x, const float* dt, const float* cum,
                                   const float* Bm, const float* Cm, float* y, float* st,
                                   int cells, int group, int L, int P, int N, void* stream) {
  if (P > PMAX || P < 1 || L < 1 || N < 1 || group < 1 || cells % group)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = (P % 4 == 0 && N % 4 == 0)
                              ? launch<true>(x, dt, cum, Bm, Cm, y, st, cells, group, L, P, N, s)
                              : launch<false>(x, dt, cum, Bm, Cm, y, st, cells, group, L, P, N, s);
  return (int)err;
}
