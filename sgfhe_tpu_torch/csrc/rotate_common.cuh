// Device helpers shared by the blind-rotation kernels (rotate.cu, the step
// pair; rotate_resident.cu, the whole rotation in one launch): the RNS
// constants, Shoup and Barrett arithmetic, Threefry-2x32, one coefficient's
// balanced mixed-radix digits, and the register-blocked NTTs on padded
// polynomials in shared memory.
//
// Every value stays below 4p < 2^32 in the NTTs (Harvey butterflies) and the
// moduli are < 2^30 (asserted by the Python wrappers, ops/fused.py _chk).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LMAX 4
// Butterfly stages per shared-memory exchange of the NTTs (the last round
// of a transform takes what is left).
#define RADIX_LOG 4

struct RnsConsts {
  uint32_t p[LMAX];
  uint32_t offset[LMAX];
  uint32_t inv_pj[LMAX][LMAX];    // [i][j]: inv(p_j) mod p_i, j < i
  uint32_t inv_pj_s[LMAX][LMAX];
  uint32_t s_mod[LMAX][LMAX];     // [i][k]: s_i mod p_k
  uint32_t w[LMAX][LMAX];         // [i][k]: w_i mod p_k
  uint32_t w_s[LMAX][LMAX];
  uint32_t two_k[LMAX][LMAX];     // [i][k]: 2^{k_bits(p_i)} mod p_k
  uint32_t kmask[LMAX];           // 2^{k_bits(p_i) + 1} - 1
};

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t p) {
  return x >= p ? x - p : x;
}

// a * w mod p in [0, 2p) for any a < 2^32, w < p < 2^31,
// ws = floor(w * 2^32 / p).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t ws, uint32_t p) {
  return a * w - __umulhi(a, ws) * p;
}

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t ws,
                                          uint32_t p) {
  return csub(shoup_lazy(a, w, ws, p), p);
}

// x mod p for x < 2^63, mu = floor((2^64 - 1) / p), p < 2^30: the
// quotient estimate is short by at most 1, so x - q p < 2p < 2^32.
__device__ __forceinline__ uint32_t barrett(unsigned long long x, uint32_t p,
                                            unsigned long long mu) {
  const unsigned long long q = __umul64hi(x, mu);
  return csub((uint32_t)x - (uint32_t)q * p, p);
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b, uint32_t p) {
  return csub(a + b, p);
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// Reduce a value canonical mod some other prime of the set; `close` means
// every prime is within 2x of every other, so one subtract suffices.
__device__ __forceinline__ uint32_t cross(uint32_t x, uint32_t p, int close) {
  return close ? csub(x, p) : x % p;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (sgfhe_tpu_torch/ops/prg.py).
__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1,
                                                uint32_t c0, uint32_t c1,
                                                uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    x0 += x1;
    x1 = rotl32(x1, rot[i % 8]) ^ x0;
    if ((i + 1) % 4 == 0) {
      const int j = (i + 1) / 4;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + (uint32_t)j;
    }
  }
  y0 = x0;
  y1 = x1;
}

// One coefficient of one operand, y[j] its canonical residue mod p_j: the
// unsigned mixed-radix digits dig[0 .. ndig-1] of y + offset, and in
// randomized mode the masks first (rand_y = y - sum_d mask_d * w_d, digits
// below `prune` unmasked; mk[d][j] the mask of digit d mod p_j, 0 when not
// randomized). Digit d of the balanced decomposition is then, in limb j,
// dig[d] mod p_j - s_d (+ mk[d][j]). The Threefry counters are ctr0 =
// gate * m + coefficient and ctr1 = (step * 2 + operand) * NP + pair.
template <int L, bool RANDOMIZED>
__device__ __forceinline__ void coeff_digits(uint32_t (&y)[L],
                                             uint32_t (&mk)[L][L],
                                             uint32_t (&dig)[L],
                                             const RnsConsts& c, int prune,
                                             int ndig, int close,
                                             uint32_t seed_lo, uint32_t seed_hi,
                                             uint32_t ctr0, uint32_t ctr1) {
  constexpr int NP = (L + 1) / 2;
#pragma unroll
  for (int d = 0; d < L; ++d)
#pragma unroll
    for (int j = 0; j < L; ++j) mk[d][j] = 0;
  if (RANDOMIZED) {
    uint32_t words[2 * NP];
#pragma unroll
    for (int pr = 0; pr < NP; ++pr)
      threefry2x32_20(seed_lo, seed_hi, ctr0, ctr1 + pr, words[2 * pr],
                      words[2 * pr + 1]);
#pragma unroll
    for (int d = 0; d < L; ++d) {
      if (d < prune) continue;
      const uint32_t v = words[d] & c.kmask[d];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const uint32_t e = submod(v % c.p[j], c.two_k[d][j], c.p[j]);
        mk[d][j] = e;
        y[j] = submod(y[j], shoup(e, c.w[d][j], c.w_s[d][j], c.p[j]), c.p[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) y[j] = addmod(y[j], c.offset[j], c.p[j]);
#pragma unroll
  for (int d = 0; d < L; ++d) {
    dig[d] = 0;
    if (d < ndig) {
      uint32_t t = y[d];
#pragma unroll
      for (int j = 0; j < d; ++j) {
        t = submod(t, cross(dig[j], c.p[d], close), c.p[d]);
        t = shoup(t, c.inv_pj[d][j], c.inv_pj_s[d][j], c.p[d]);
      }
      dig[d] = t;
    }
  }
}

// Shared-memory word of coefficient a: one pad word per 32. Polynomials sit
// `pitch` words apart: m + m/32, and one more where a forward NTT's last
// round puts neighbouring polynomials on neighbouring threads (the odd
// pitch puts them on different banks).
__device__ __forceinline__ int pad(int a) { return a + (a >> 5); }

__device__ __forceinline__ uint4 ldg4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st4(uint32_t* p, uint32_t a, uint32_t b,
                                    uint32_t c, uint32_t d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// ---------------------------------------------------------------------------
// Register-blocked NTTs on npoly polynomials in padded shared memory
// (polynomial q at x + q * pitch, its modulus p_of[q % nl], its twiddles in
// device memory at tw + (q % nl) * tw_pitch with Shoup companions m words
// further on).
// ---------------------------------------------------------------------------

// Forward (merged Longa-Naehrig) stages s0 .. s0+R-1: group g of a thread
// holds the 2^R words base + e * stride, stride = m >> (s0 + R), and stage
// s0+st pairs e with e + 2^{R-1-st} under the block-constant twiddle
// tw[2^{s0+st} + blk]. The same butterflies as one stage at a time: inputs
// < 4p, outputs < 4p, bit-reversed hat order at the end.
template <int R>
__device__ __forceinline__ void fwd_round(uint32_t* x, int pitch, int npoly,
                                          int logm, int s0, const uint32_t* tw,
                                          int tw_pitch, int nl,
                                          const uint32_t* p_of) {
  constexpr int N = 1 << R;
  const int m = 1 << logm;
  const int lg_groups = logm - R;
  const int lg_stride = logm - s0 - R;
  const int total = npoly << lg_groups;
  // In the last round every group has twiddles of its own: neighbouring
  // threads then take the same group of different polynomials, so that
  // polynomials of one limb share each twiddle load.
  const bool poly_minor = lg_stride == 0;
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int q = poly_minor ? w % npoly : w >> lg_groups;
    const int g = poly_minor ? w / npoly : w & ((1 << lg_groups) - 1);
    const int li = nl == 1 ? 0 : q % nl;
    const uint32_t p = p_of[li], two_p = 2 * p;
    const uint32_t* t = tw + li * tw_pitch;
    uint32_t* xq = x + q * pitch;
    const int b0 = g >> lg_stride;
    const int base = (b0 << (lg_stride + R)) + (g & ((1 << lg_stride) - 1));
    uint32_t v[N];
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = xq[pad(base + (e << lg_stride))];
    // butterfly k of stage st: sub-block bl = k >> lh, pair (e, e + 2^lh);
    // one constant-trip loop per stage, so that v[] stays in registers
#pragma unroll
    for (int st = 0; st < R; ++st) {
      const int lh = R - 1 - st;
      uint32_t wv = 0, ws = 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const int bl = k >> lh, j = k & ((1 << lh) - 1);
        if (j == 0) {
          const int ti = (1 << (s0 + st)) + (b0 << st) + bl;
          wv = __ldg(t + ti);
          ws = __ldg(t + m + ti);
        }
        const int e = (bl << (lh + 1)) + j;
        const uint32_t u = csub(v[e], two_p);
        const uint32_t r = shoup_lazy(v[e + (1 << lh)], wv, ws, p);
        v[e] = u + r;
        v[e + (1 << lh)] = u + two_p - r;
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) xq[pad(base + (e << lg_stride))] = v[e];
  }
}

// Inverse (decimation in time, the JAX package's ntt_inv stage order)
// stages s0 .. s0+R-1: group g holds base + e * 2^{s0}, base = blk *
// 2^{s0+R} + j with j < 2^{s0}; stage s0+st pairs e with e + 2^{st} under
// itw[2^{s0+st} + j + (e mod 2^{st}) * 2^{s0}]. Inputs < 4p, outputs < 4p.
template <int R>
__device__ __forceinline__ void inv_round(uint32_t* x, int pitch, int npoly,
                                          int logm, int s0, const uint32_t* tw,
                                          int tw_pitch, int nl,
                                          const uint32_t* p_of) {
  constexpr int N = 1 << R;
  const int m = 1 << logm;
  const int lg_groups = logm - R;
  const int total = npoly << lg_groups;
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int q = w >> lg_groups;
    const int g = w & ((1 << lg_groups) - 1);
    const int li = nl == 1 ? 0 : q % nl;
    const uint32_t p = p_of[li], two_p = 2 * p;
    const uint32_t* t = tw + li * tw_pitch;
    const int j = g & ((1 << s0) - 1);
    const int base = ((g >> s0) << (s0 + R)) + j;
    uint32_t* xq = x + q * pitch;
    uint32_t v[N];
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = xq[pad(base + (e << s0))];
    // butterfly k of stage st: offset o = k >> lb within the half, pair
    // (e, e + 2^st); one constant-trip loop per stage (see fwd_round)
#pragma unroll
    for (int st = 0; st < R; ++st) {
      const int lb = R - 1 - st;  // log2 of the pairs sharing a twiddle
      uint32_t wv = 0, ws = 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const int o = k >> lb, bb = k & ((1 << lb) - 1);
        if (bb == 0) {
          const int ti = (1 << (s0 + st)) + j + (o << s0);
          wv = __ldg(t + ti);
          ws = __ldg(t + m + ti);
        }
        const int e = (bb << (st + 1)) + o;
        const uint32_t a = csub(v[e], two_p);
        const uint32_t r = shoup_lazy(v[e + (1 << st)], wv, ws, p);
        v[e] = a + r;
        v[e + (1 << st)] = a + two_p - r;
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) xq[pad(base + (e << s0))] = v[e];
  }
}

// Whole transforms: rounds of up to 2^RADIX_LOG words per thread, one
// __syncthreads after each. The caller synchronises before the first.
__device__ void ntt_fwd_blocked(uint32_t* x, int pitch, int npoly, int logm,
                                const uint32_t* tw, int tw_pitch, int nl,
                                const uint32_t* p_of) {
  for (int s0 = 0; s0 < logm;) {
    const int r = min(RADIX_LOG, logm - s0);
    switch (r) {
      case 4: fwd_round<4>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
      case 3: fwd_round<3>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
      case 2: fwd_round<2>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
      default: fwd_round<1>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
    }
    __syncthreads();
    s0 += r;
  }
}

__device__ void ntt_inv_blocked(uint32_t* x, int pitch, int npoly, int logm,
                                const uint32_t* tw, int tw_pitch, int nl,
                                const uint32_t* p_of) {
  for (int s0 = 0; s0 < logm;) {
    const int r = min(RADIX_LOG, logm - s0);
    switch (r) {
      case 4: inv_round<4>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
      case 3: inv_round<3>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
      case 2: inv_round<2>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
      default: inv_round<1>(x, pitch, npoly, logm, s0, tw, tw_pitch, nl, p_of); break;
    }
    __syncthreads();
    s0 += r;
  }
}
