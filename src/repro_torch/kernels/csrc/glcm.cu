// B2 · per-pixel GLCM Haralick features (paper pipeline P2).
//
// Replaces src/repro/kernels/glcm.py::glcm_features (Pallas body
// _glcm_kernel): quantize one band to Q levels over [vmin, vmax], build each
// pixel's co-occurrence histogram over its (2R+1)^2 window at offset
// (dr, dc), and reduce it to energy, entropy, contrast, homogeneity and
// correlation.  The features follow the oracle
// (src/repro/filters/texture.py::features_from_glcm): variance as
// E[(i - mu)^2], and correlation 0 where var_i * var_j < 1e-4.  The result
// equals glcm.py::glcm_features_plain bit for bit.
//
// What bounds it on the H100: bytes.  One P2 stripe (1024 x 8192, halo 3)
// reads 33.8 MB and writes 168 MB (~60 us at 3.35 TB/s); its arithmetic is
// one quantize per input sample, one bin update per window pair and a few
// dozen flops per occupied bin.  The TPU kernel's dense one-hot accumulation
// over all Q^2 bins per window offset is not carried over.
//
// Design.  A block of 32 x NY threads owns a 32-wide, 4·NY-tall output tile.
// 1. It loads the tile's haloed window of the band once, eight 4-byte
//    coalesced loads in flight per thread (a P2 stripe row is 8198 floats,
//    not 16-byte aligned), and quantizes each sample once into a shared
//    byte tile of levels.  At every window position of the tile it forms
//    the pair code b = q1·S + q2 (S = 8 for Q <= 8, else 16, so b < 256)
//    and stores where b's count lies: a 16-bit byte offset.
// 2. Each thread walks 4 consecutive rows of one column: it counts its
//    first window's pairs, then slides down, removing the row that leaves
//    and adding the row that enters (a byte load, add and store each).
//    Counts are bytes while (2R+1)^2 <= 255 (16 bits above), four bins to
//    a 32-bit shared word that only this thread touches, in its own bank.
//    A register bitmask (one 64-bit word for S = 8, four for S = 16) marks
//    the occupied bins.
// 3. The epilogue walks the set bits in ascending order (__ffsll), which is
//    features_from_glcm's i-major bin order, and skips the zero bins (each
//    adds +-0 there, which changes no sum).  Every operation is an _rn
//    intrinsic, so nothing contracts into an FMA: cov = E[ij] - mu_i mu_j
//    cancels, and 1/sqrt(var_i var_j) would amplify any other rounding.
//    The total is the constant (2R+1)^2 (each pair lands in one bin, and
//    the bin-order float sum of integer counts is exact), so p takes
//    (2R+1)^2 + 1 values: p, p·log(p + 1e-12) and p / (1 + d^2) come from
//    per-block tables indexed by the count (and |i - j|), built with the
//    same operations.  Wider counts compute them directly.  The variance
//    pass needs the same bins again: where S = 8 and R <= 3 the first pass
//    leaves a 16-bit (bin, count) slot per bin in shared memory, and the
//    second reads them in order instead of walking the mask again.
// 4. Each warp stages its row of 32 x 5 features in shared memory and
//    stores it with 16-byte vectors where the row start is aligned.
// R = 1, 2, 3 are compiled with the window unrolled.  A tile whose halo
// does not fit in shared memory (an offset or radius of ~100 or more) reads
// the band from device memory instead, with 32-bit counts and the total
// summed in bin order.
//
// The fused pre-stage (the Pallas kernel's pre_fn): given a raw tile
// (uint8, int32 or float32, any number of bands) the loads of step 1 run
// each raw pixel through the plan layer's op list and take band 0 of the
// result (prestage.cuh) before they quantize it, so a Convert feeding the
// texture filter never writes its output to device memory.  A float32 band
// takes the same path with an empty op list.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include "prestage.cuh"

namespace {

constexpr int TW = 32;   // tile width: one warp per tile row
constexpr int PPT = 4;   // consecutive output rows per thread
constexpr int LOADS = 8; // band loads in flight per thread
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename CountT>
struct Cfg {
  static constexpr int NY = 8 / (int)sizeof(CountT);  // warps per block
  static constexpr int NT = 32 * NY;                  // threads per block
  static constexpr int TH = PPT * NY;                 // tile height
  static constexpr int PER_WORD = 4 / (int)sizeof(CountT);
  static constexpr int BITS = 8 * (int)sizeof(CountT);
  static constexpr int ROW_SHIFT = NY == 8 ? 10 : NY == 4 ? 9 : 8;  // log2(NT * 4)
  static_assert((1 << ROW_SHIFT) == NT * 4, "a thread's words are NT * 4 bytes apart");
  // byte offset of bin b's count from its thread's first word, and back
  // (unsigned: the divisions are shifts)
  static __device__ __forceinline__ unsigned offset(unsigned b) {
    return ((b / PER_WORD) << ROW_SHIFT) + (b % PER_WORD) * (unsigned)sizeof(CountT);
  }
  static __device__ __forceinline__ unsigned bin(unsigned off) {
    return (off >> ROW_SHIFT) * PER_WORD + (off & 3u) / (unsigned)sizeof(CountT);
  }
};

// occupied bins, one bit each, kept in registers: MW is a compile-time
// constant and every index below unrolls, so nothing spills to local memory
template <int MW>
struct Mask {
  unsigned long long w[MW];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < MW; ++i) w[i] = 0ull;
  }
  __device__ __forceinline__ void set(unsigned b) {
    const unsigned long long bit = 1ull << (b & 63);
#pragma unroll
    for (int i = 0; i < MW; ++i)
      if (MW == 1 || i == (int)(b >> 6)) w[i] |= bit;
  }
  __device__ __forceinline__ void unset(unsigned b) {
    const unsigned long long bit = 1ull << (b & 63);
#pragma unroll
    for (int i = 0; i < MW; ++i)
      if (MW == 1 || i == (int)(b >> 6)) w[i] &= ~bit;
  }
};

// f(b) for every set bit b, in ascending order
template <int MW, typename F>
__device__ __forceinline__ void for_each_bin(const Mask<MW>& m, F&& f) {
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    unsigned long long bits = m.w[i];
    while (bits) {
      const unsigned b = i * 64u + (unsigned)__ffsll((long long)bits) - 1u;
      bits &= bits - 1ull;
      f(b);
    }
  }
}

__device__ __forceinline__ int quantize(float x, float vmin, float span,
                                        int levels) {
  // floor((x - vmin) / span * levels), clipped to [0, levels - 1]
  const float q = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(x, vmin), span), (float)levels));
  return (int)fminf(fmaxf(q, 0.0f), (float)(levels - 1));
}

__device__ __forceinline__ float plogp(float p) {
  return __fmul_rn(p, logf(__fadd_rn(p, 1e-12f)));
}

__device__ __forceinline__ float homog_term(float p, int d) {
  return __fdiv_rn(p, __fadd_rn(1.0f, (float)(d * d)));
}

// the occupied bins a window can have, for the radii compiled unrolled
// (their first pass keeps a (bin, count) slot per bin for the second).  At
// S = 16 the counts take 64 KB a block already, and slots would cost it a
// resident block.
__host__ __device__ constexpr int slots(int S, int KR) {
  return KR == 0 || S != 8 ? 0 : (2 * KR + 1) * (2 * KR + 1) < S * S ? (2 * KR + 1) * (2 * KR + 1) : S * S;
}

// dynamic shared memory of one block, in bytes (layout in glcm_kernel)
template <int S, typename CountT, bool kTiled>
size_t smem_bytes(int R, int halo, int levels, int nslot) {
  using C = Cfg<CountT>;
  const size_t nwin = (size_t)(2 * R + 1) * (2 * R + 1);
  size_t n = (size_t)S * S / C::PER_WORD * C::NT * 4  // counts
             + (size_t)nslot * C::NT * 2             // (bin, count) slots
             + (size_t)C::NY * TW * 5 * 4;            // staged features
  if (sizeof(CountT) == 1) n += (nwin + 1) * (2 + levels) * 4;  // tables
  if (kTiled)
    n += ((size_t)(C::TH + 2 * halo) * (TW + 2 * halo) + 1) / 2 * 2  // levels
         + (size_t)(C::TH + 2 * R) * (TW + 2 * R) * 2;               // pair offsets
  return n;
}

template <int S, int KR, typename CountT, bool kTiled>
__global__ void __launch_bounds__(Cfg<CountT>::NT)
glcm_kernel(const void* __restrict__ raw, const prestage::Ops pre, float* __restrict__ out,
            int H, int W, int radius, int dr, int dc, int levels, float vmin, float span) {
  using C = Cfg<CountT>;
  constexpr bool kTables = sizeof(CountT) == 1;
  constexpr int MW = S * S / 64;
  constexpr int NWORDS = S * S / C::PER_WORD;
  static_assert(!kTiled || (NWORDS << C::ROW_SHIFT) <= 65536, "offsets must fit in 16 bits");
  const int R = KR > 0 ? KR : radius;
  const int K = 2 * R + 1;
  const int nwin = K * K;
  const int NN = nwin + 1;
  const int halo = R + max(abs(dr), abs(dc));
  const int Wp = W + 2 * halo;
  const int Hp = H + 2 * halo;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int t = wy * 32 + lane;
  const int r0 = blockIdx.y * C::TH, c0 = blockIdx.x * TW;

  // [NWORDS][NT] counts | [NSLOT][NT] slots | [NY][TW * 5] features
  // | tables [2 + levels][NN] | levels [QH][QW] | pair offsets [PH][PW]
  constexpr int NSLOT = slots(S, KR);
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  uint16_t* slot = reinterpret_cast<uint16_t*>(hist + NWORDS * C::NT);
  float* stage = reinterpret_cast<float*>(slot + NSLOT * C::NT);
  float* tab = stage + C::NY * TW * 5;
  unsigned char* qt = reinterpret_cast<unsigned char*>(tab + (kTables ? NN * (2 + levels) : 0));
  const int QW = TW + 2 * halo, QH = C::TH + 2 * halo;
  const int PW = TW + 2 * R, PH = C::TH + 2 * R;
  uint16_t* pt = reinterpret_cast<uint16_t*>(qt + (kTiled ? (QH * QW + 1) / 2 * 2 : 0));

  uint32_t* hc = hist + t;  // this thread's words, hc[w * NT]
  unsigned char* hb = reinterpret_cast<unsigned char*>(hc);
#pragma unroll 4
  for (int w = 0; w < NWORDS; ++w) hc[w * C::NT] = 0u;
  const float total_c = (float)nwin;
  if constexpr (kTables) {
    for (int idx = t; idx < NN * (2 + levels); idx += C::NT) {
      const int kind = idx / NN, n = idx - kind * NN;
      const float p = __fdiv_rn((float)n, total_c);
      tab[idx] = kind == 0 ? p : kind == 1 ? plogp(p) : homog_term(p, kind - 2);
    }
  }
  if constexpr (kTiled) {
    // the haloed window, flat: LOADS loads in flight per thread, then their
    // levels (outside the band: level 0, read by no output pixel).  Row
    // y = idx / QW by a multiply-high, exact since idx·QW < 2^32 for any
    // tile that fits in shared memory.
    const int nq = QH * QW;
    const unsigned inv_qw = 0xFFFFFFFFu / QW + 1u;
    for (int base = t; base < nq; base += LOADS * C::NT) {
      // element k of this round: in the band, and its pixel index
      auto at = [&](int k, size_t& pix) -> bool {
        const int idx = base + k * C::NT;
        const int y = (int)__umulhi((unsigned)idx, inv_qw), x = idx - y * QW;
        const int gr = r0 + y, gc = c0 + x;
        pix = (size_t)gr * Wp + gc;
        return idx < nq && gr < Hp && gc < Wp;
      };
      float v[LOADS];
      if (pre.nload == 1) {
        // the raw band-0 samples, all loads in flight before the first
        // use, then the op list on each
        auto load_all = [&](const auto* p) {
#pragma unroll
          for (int k = 0; k < LOADS; ++k) {
            size_t pix;
            v[k] = at(k, pix) ? (float)__ldg(p + pix * pre.stride) : vmin;
          }
        };
        switch (pre.dtype) {
          case prestage::U8: load_all(static_cast<const unsigned char*>(raw)); break;
          case prestage::I32: load_all(static_cast<const int*>(raw)); break;
          default: load_all(static_cast<const float*>(raw)); break;
        }
        if (pre.n > 0) {
#pragma unroll
          for (int k = 0; k < LOADS; ++k) {
            float one[1] = {v[k]};
            prestage::apply<1>(pre, one, 1);
            v[k] = one[0];
          }
        }
      } else {
        // a chain that selects bands: each pixel's bands in turn, one at a
        // time (unrolled, its MAX_BANDS registers per load would raise the
        // register count of every instance, and cost resident blocks)
#pragma unroll 1
        for (int k = 0; k < LOADS; ++k) {
          size_t pix;
          const int idx = base + k * C::NT;
          const float x = at(k, pix) ? prestage::first(raw, pre, pix) : vmin;
          if (idx < nq) qt[idx] = (unsigned char)quantize(x, vmin, span, levels);
        }
        continue;
      }
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const int idx = base + k * C::NT;
        if (idx < nq) qt[idx] = (unsigned char)quantize(v[k], vmin, span, levels);
      }
    }
    __syncthreads();
    const int o = halo - R;
    const int np = PH * PW;
    const unsigned inv_pw = 0xFFFFFFFFu / PW + 1u;
    for (int idx = t; idx < np; idx += C::NT) {
      const int y = (int)__umulhi((unsigned)idx, inv_pw), x = idx - y * PW;
      pt[idx] = (uint16_t)C::offset(qt[(y + o) * QW + x + o] * S + qt[(y + o + dr) * QW + x + o + dc]);
    }
  }
  __syncthreads();

  // the count offset of the pair at window position (y, x) of the tile:
  // y in [0, PH), x in [0, PW)
  auto pair_at = [&](int y, int x) -> unsigned {
    if constexpr (kTiled) {
      return pt[y * PW + x];
    } else {
      const size_t at = (size_t)(r0 + y + halo - R) * Wp + (c0 + x + halo - R);
      return C::offset(
          quantize(prestage::first(raw, pre, at), vmin, span, levels) * S +
          quantize(prestage::first(raw, pre, at + (long long)dr * Wp + dc), vmin, span, levels));
    }
  };
  Mask<MW> mask;
  mask.clear();
  auto add = [&](unsigned off) {
    *reinterpret_cast<CountT*>(hb + off) += (CountT)1;
    mask.set(C::bin(off));
  };
  auto remove = [&](unsigned off) {
    CountT* cp = reinterpret_cast<CountT*>(hb + off);
    const CountT n = *cp - (CountT)1;
    *cp = n;
    if (n == 0) mask.unset(C::bin(off));
  };
  auto count = [&](unsigned b) -> uint32_t {
    return *reinterpret_cast<const CountT*>(hb + C::offset(b));
  };

  const int c = c0 + lane;
  const bool live = c < W;
  float* st = stage + wy * TW * 5;
  for (int k = 0; k < PPT; ++k) {
    const int y = wy * PPT + k;
    const int r = r0 + y;
    if (r >= H) break;  // the same for the whole warp
    if (live) {
      if (k == 0) {
#pragma unroll
        for (int a = 0; a < K; ++a)
#pragma unroll
          for (int b = 0; b < K; ++b) add(pair_at(y + a, lane + b));
      } else {
#pragma unroll
        for (int b = 0; b < K; ++b) {
          remove(pair_at(y - 1, lane + b));
          add(pair_at(y - 1 + K, lane + b));
        }
      }

      float total = total_c;
      if constexpr (!kTiled) {  // 32-bit counts: the bin-order sum, as the plain version
        total = 0.0f;
        for_each_bin(mask, [&](unsigned b) { total = __fadd_rn(total, (float)count(b)); });
      }
      float energy = 0.0f, entropy = 0.0f, contrast = 0.0f, homog = 0.0f;
      float mu_i = 0.0f, mu_j = 0.0f, e_ij = 0.0f;
      int nb = 0;  // bins visited, each kept in a slot where NSLOT > 0
      for_each_bin(mask, [&](unsigned b) {
        const uint32_t n = count(b);
        if constexpr (NSLOT > 0) slot[nb++ * C::NT + t] = (uint16_t)(b | (n << 8));
        const int i = (int)(b / S), j = (int)(b % S), d = abs(i - j);
        const float p = kTables ? tab[n] : __fdiv_rn((float)n, total);
        energy = __fadd_rn(energy, __fmul_rn(p, p));
        entropy = __fadd_rn(entropy, kTables ? tab[NN + n] : plogp(p));
        contrast = __fadd_rn(contrast, __fmul_rn(p, (float)(d * d)));
        homog = __fadd_rn(homog, kTables ? tab[(2 + d) * NN + n] : homog_term(p, d));
        mu_i = __fadd_rn(mu_i, __fmul_rn(p, (float)i));
        mu_j = __fadd_rn(mu_j, __fmul_rn(p, (float)j));
        e_ij = __fadd_rn(e_ij, __fmul_rn(__fmul_rn(p, (float)i), (float)j));
      });
      // the same bins in the same order: from the slots, else the mask again
      float var_i = 0.0f, var_j = 0.0f;
      auto var_add = [&](unsigned b, uint32_t n) {
        const float p = kTables ? tab[n] : __fdiv_rn((float)n, total);
        const float di = __fsub_rn((float)(b / S), mu_i);
        const float dj = __fsub_rn((float)(b % S), mu_j);
        var_i = __fadd_rn(var_i, __fmul_rn(p, __fmul_rn(di, di)));
        var_j = __fadd_rn(var_j, __fmul_rn(p, __fmul_rn(dj, dj)));
      };
      if constexpr (NSLOT > 0) {
        for (int k = 0; k < nb; ++k) {
          const uint32_t v = slot[k * C::NT + t];
          var_add(v & 0xFFu, v >> 8);
        }
      } else {
        for_each_bin(mask, [&](unsigned b) { var_add(b, count(b)); });
      }
      const float cov = __fsub_rn(e_ij, __fmul_rn(mu_i, mu_j));
      const float denom2 = __fmul_rn(var_i, var_j);
      const float corr =
          denom2 < 1e-4f ? 0.0f : __fdiv_rn(cov, sqrtf(fmaxf(denom2, 1e-4f)));
      float* f = st + lane * 5;
      f[0] = energy;
      f[1] = -entropy;
      f[2] = contrast;
      f[3] = homog;
      f[4] = corr;
    }
    __syncwarp();
    // the warp's row of features: (r, c0 .. c0 + ncol) is contiguous in out
    const int ncol = min(TW, W - c0);
    const size_t pix = (size_t)r * W + c0;
    float* dst = out + pix * 5;
    if (ncol == TW && (pix & 3) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(st);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int q = lane; q < TW * 5 / 4; q += 32) d4[q] = s4[q];
    } else {
      for (int q = lane; q < ncol * 5; q += 32) dst[q] = st[q];
    }
    __syncwarp();
  }
}

struct Args {
  const void* raw;  // the raw tile, read through pre
  const prestage::Ops* pre;
  float* out;
  int H, W, radius, dr, dc, levels;
  float vmin, span;
  cudaStream_t stream;
  int* info;  // non-null: report the instance's occupancy instead of launching
};

template <int S, int KR, typename CountT, bool kTiled>
int run(const Args& a) {
  using C = Cfg<CountT>;
  auto kernel = glcm_kernel<S, KR, CountT, kTiled>;
  const int halo = a.radius + (abs(a.dr) > abs(a.dc) ? abs(a.dr) : abs(a.dc));
  const size_t smem = smem_bytes<S, CountT, kTiled>(a.radius, halo, a.levels, slots(S, KR));
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.info != nullptr) {
    int blocks = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, C::NT, smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    a.info[0] = blocks;
    a.info[1] = C::NT;
    a.info[2] = (int)smem;
    a.info[3] = C::BITS;
    a.info[4] = kTiled ? 1 : 0;
    a.info[5] = KR;
    a.info[6] = attr.numRegs;
    a.info[7] = (int)attr.localSizeBytes;
    return 0;
  }
  const dim3 block(32, C::NY);
  const dim3 grid((a.W + TW - 1) / TW, (a.H + C::TH - 1) / C::TH);
  glcm_kernel<S, KR, CountT, kTiled><<<grid, block, smem, a.stream>>>(
      a.raw, *a.pre, a.out, a.H, a.W, a.radius, a.dr, a.dc, a.levels, a.vmin, a.span);
  return (int)cudaGetLastError();
}

// pick the instance: byte counts and the tiled loads where they fit, the
// window unrolled for R = 1, 2, 3
template <int S>
int dispatch(const Args& a) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const long long K = 2LL * a.radius + 1;
  const long long nwin = K * K;
  const int halo = a.radius + (abs(a.dr) > abs(a.dc) ? abs(a.dr) : abs(a.dc));
  const int kr = a.radius >= 1 && a.radius <= 3 ? a.radius : 0;
  const size_t s8 = smem_bytes<S, uint8_t, true>(a.radius, halo, a.levels, slots(S, kr));
  if (nwin <= 255 && s8 <= (size_t)optin) {
    switch (kr) {
      case 1: return run<S, 1, uint8_t, true>(a);
      case 2: return run<S, 2, uint8_t, true>(a);
      case 3: return run<S, 3, uint8_t, true>(a);
      default: return run<S, 0, uint8_t, true>(a);
    }
  }
  const size_t s16 = smem_bytes<S, uint16_t, true>(a.radius, halo, a.levels, 0);
  if (nwin <= 65535 && s16 <= (size_t)optin) return run<S, 0, uint16_t, true>(a);
  return run<S, 0, uint32_t, false>(a);
}

int glcm(const Args& a) {
  return a.levels <= 8 ? dispatch<8>(a) : dispatch<16>(a);
}

}  // namespace

// raw: the (H + 2 halo, W + 2 halo[, bands]) tile, read through pre (band 0
// of the op list's output)
extern "C" int glcm_features_f32(const void* raw, const prestage::Ops* pre, float* out, int H,
                                 int W, int radius, int dr, int dc, int levels, float vmin,
                                 float span, void* stream) {
  if (raw == nullptr || pre == nullptr) return (int)cudaErrorInvalidValue;
  return glcm(Args{raw, pre, out, H, W, radius, dr, dc, levels, vmin, span,
                   (cudaStream_t)stream, nullptr});
}

// The instance glcm_features_f32 takes for these arguments, without
// launching it: info[0..7] = resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads per block,
// dynamic shared memory bytes, count bits, tiled (1) or not, unrolled
// radius (0: any), registers per thread and local (stack and spill) bytes
// per thread (cudaFuncGetAttributes).
extern "C" int glcm_features_occupancy(int H, int W, int radius, int dr, int dc,
                                       int levels, int* info) {
  static const prestage::Ops none{};
  return glcm(Args{nullptr, &none, nullptr, H, W, radius, dr, dc, levels, 0.0f, 1.0f,
                   nullptr, info});
}
