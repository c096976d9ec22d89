// Blind-rotation step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of sgfhe_tpu/ops/fused.py that carry
// the n-step blind rotation of every gate bootstrap:
//   _rotate_kernel      (fused.py:542, key resident, T-term carried)
//   _rotate_step_kernel (fused.py:604, key streamed, T-term by w-multiplies)
// and their shared body (_flatten_k, _flatten_rand_k, _ntt_fwd_lazy,
// _rotate_body, _ntt_inv_lazy). One rotation step is two launches; the
// n-step loop runs on the host (sgfhe_tpu_torch/ops/fused.py), in place of
// the TPU grid's sequential step axis:
//
//   flatten_ntt_fwd     one block per (gate, operand, kept digit i, limb k):
//                       mixed-radix chain to digit i (Threefry-2x32 masks in
//                       randomized mode), embed into limb k, forward
//                       negacyclic NTT in shared memory -> d_hat.
//   mac_rotate_ntt_inv  one block per (gate, column c, limb k): Shoup MAC of
//                       the kept key rows, T-term (w-multiplies, or the
//                       carried canonical val), x^{u_k} by one gather of
//                       psi^{(2 br(idx)+1) u mod 2m} and one Shoup multiply,
//                       val = rot - s + t, inverse NTT + post-twist -> acc.
//
// What bounds them on this card: the forward kernel writes, and the MAC
// kernel reads, d_hat (2(l - prune) digits x L limbs x m words per gate per
// step) through device memory, and every block re-reads its step's key
// slice (from L2: 1.1 MiB at n=512). At the main path's shapes both kernels
// move more bytes than their Shoup multiplies take time, so they are bound
// by bytes. The design keeps the arithmetic simple and exact (every value
// below 4p < 2^32, canonical at every kernel boundary) and leaves fusing
// the two launches, keeping d_hat on chip and prefetching the key, to
// later work.
//
// Data are uint32 bit patterns in int32 tensors, layouts (row-major):
//   acc    (2, B, L, m)   [a; b] accumulators, canonical
//   d_hat  (B, 2lk, L, m) canonical hat digits, lk = l - prune
//   key    (2l, 2, L, m)  this step's key slice (hat) and Shoup companions
//   tables (L, 10, m)     fwd, fwd_s, inv, inv_s, post, post_s, pw (2m), pw_s (2m)
// Moduli are < 2^30 (asserted by the Python wrapper), so lazy values below
// 4p fit in 32 bits.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#define LMAX 4

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

// Merged (Longa-Naehrig) forward negacyclic NTT of x[0..m) in shared
// memory; block-constant twiddles tw[2^s + blk] = psi^{F/2}. Input < 4p,
// output < 4p in bit-reversed hat order.
__device__ void ntt_fwd_smem(uint32_t* x, const uint32_t* __restrict__ tw,
                             const uint32_t* __restrict__ tws, uint32_t p,
                             int m, int logm) {
  const uint32_t two_p = 2 * p;
  const int half_m = m >> 1;
  for (int s = 0; s < logm; ++s) {
    const int lg_len = logm - 1 - s;
    const int len = 1 << lg_len;
    for (int j = threadIdx.x; j < half_m; j += blockDim.x) {
      const int blk = j >> lg_len;
      const int i0 = (blk << (lg_len + 1)) + (j & (len - 1));
      const int i1 = i0 + len;
      const int ti = (1 << s) + blk;
      const uint32_t u = csub(x[i0], two_p);
      const uint32_t v = shoup_lazy(x[i1], tw[ti], tws[ti], p);
      x[i0] = u + v;
      x[i1] = u + two_p - v;
    }
    __syncthreads();
  }
}

// Decimation-in-time inverse NTT (the JAX package's ntt_inv stage order):
// stage s pairs (blk*2h + j, blk*2h + h + j) with twiddle itw[h + j].
// Input < 4p, output < 4p before the post-twist.
__device__ void ntt_inv_smem(uint32_t* x, const uint32_t* __restrict__ itw,
                             const uint32_t* __restrict__ itws, uint32_t p,
                             int m, int logm) {
  const uint32_t two_p = 2 * p;
  const int half_m = m >> 1;
  for (int s = 0; s < logm; ++s) {
    const int h = 1 << s;
    for (int j = threadIdx.x; j < half_m; j += blockDim.x) {
      const int off = j & (h - 1);
      const int i0 = ((j >> s) << (s + 1)) + off;
      const int i1 = i0 + h;
      const uint32_t a = csub(x[i0], two_p);
      const uint32_t t = shoup_lazy(x[i1], itw[h + off], itws[h + off], p);
      x[i0] = a + t;
      x[i1] = a + two_p - t;
    }
    __syncthreads();
  }
}

template <int L>
__global__ void flatten_ntt_fwd_kernel(
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ d_hat,
    const uint32_t* __restrict__ tables, const RnsConsts c, int B, int m,
    int logm, int prune, int close, int randomized, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t step) {
  extern __shared__ uint32_t sm[];
  const int lk = L - prune;
  int bid = blockIdx.x;
  const int k = bid % L;
  bid /= L;
  const int ik = bid % lk;
  bid /= lk;
  const int op = bid % 2;
  const int b = bid / 2;
  const int i = prune + ik;  // digit index
  const uint32_t pk = c.p[k];
  const uint32_t s_ik = c.s_mod[i][k];
  const uint32_t* x = acc + ((size_t)op * B + b) * L * m;
  constexpr int NP = (L + 1) / 2;

  for (int idx = threadIdx.x; idx < m; idx += blockDim.x) {
    uint32_t y[L];
#pragma unroll
    for (int j = 0; j < L; ++j) y[j] = x[(size_t)j * m + idx];
    uint32_t mask_ik = 0;
    if (randomized) {
      uint32_t words[2 * NP];
      const uint32_t ctr0 = (uint32_t)b * (uint32_t)m + (uint32_t)idx;
#pragma unroll
      for (int pr = 0; pr < NP; ++pr) {
        const uint32_t ctr1 = (step * 2u + (uint32_t)op) * (uint32_t)NP + pr;
        threefry2x32_20(seed_lo, seed_hi, ctr0, ctr1, words[2 * pr],
                        words[2 * pr + 1]);
      }
      // rand_x = x - sum_d mask_d * w_d; digits below `prune` are unmasked
#pragma unroll
      for (int d = 0; d < L; ++d) {
        if (d < prune) continue;
        const uint32_t v = words[d] & c.kmask[d];
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const uint32_t e = submod(v % c.p[j], c.two_k[d][j], c.p[j]);
          if (d == i && j == k) mask_ik = e;
          y[j] = submod(y[j], shoup(e, c.w[d][j], c.w_s[d][j], c.p[j]), c.p[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) y[j] = addmod(y[j], c.offset[j], c.p[j]);
    // mixed-radix chain up to digit i
    uint32_t dig[L];
    uint32_t di = 0;
#pragma unroll
    for (int d = 0; d < L; ++d) {
      if (d <= i) {
        uint32_t t = y[d];
#pragma unroll
        for (int j = 0; j < d; ++j) {
          t = submod(t, cross(dig[j], c.p[d], close), c.p[d]);
          t = shoup(t, c.inv_pj[d][j], c.inv_pj_s[d][j], c.p[d]);
        }
        dig[d] = t;
        if (d == i) di = t;
      }
    }
    uint32_t e = submod(cross(di, pk, close), s_ik, pk);
    if (randomized) e = addmod(e, mask_ik, pk);
    sm[idx] = e;
  }
  __syncthreads();
  const uint32_t* tab = tables + (size_t)k * 10 * m;
  ntt_fwd_smem(sm, tab, tab + m, pk, m, logm);
  uint32_t* out = d_hat + (((size_t)b * 2 * lk + op * lk + ik) * L + k) * m;
  for (int idx = threadIdx.x; idx < m; idx += blockDim.x) {
    out[idx] = csub(csub(sm[idx], 2 * pk), pk);
  }
}

// t_mode: 0 = T-term by w-multiplies; 1 = by w-multiplies, and write val to
// carry; 2 = read T from carry (the previous step's canonical val), write
// this step's val back.
template <int L>
__global__ void mac_rotate_ntt_inv_kernel(
    const uint32_t* __restrict__ d_hat, const uint32_t* __restrict__ key,
    const uint32_t* __restrict__ key_s, const uint32_t* __restrict__ u,
    uint32_t* __restrict__ acc_out, uint32_t* __restrict__ carry,
    const uint32_t* __restrict__ tables, const RnsConsts c, int B, int m,
    int logm, int prune, int t_mode) {
  extern __shared__ uint32_t sm[];
  const int l = L;
  const int lk = l - prune;
  int bid = blockIdx.x;
  const int k = bid % L;
  bid /= L;
  const int col = bid % 2;
  const int b = bid / 2;
  const uint32_t p = c.p[k];
  const uint32_t* tab = tables + (size_t)k * 10 * m;
  const uint32_t* pw = tab + 6 * (size_t)m;
  const uint32_t* pws = tab + 8 * (size_t)m;
  const uint32_t uk = (uint32_t)u[b];
  const uint32_t mask2m = 2u * (uint32_t)m - 1u;
  const uint32_t* dh = d_hat + (size_t)b * 2 * lk * L * m;
  const size_t krow_stride = (size_t)2 * L * m;
  const size_t kcol = ((size_t)col * L + k) * m;
  const size_t ak = (((size_t)col * B + b) * L + k) * m;
  uint32_t wv[L], wsv[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    wv[i] = i < lk ? c.w[prune + i][k] : 0u;
    wsv[i] = i < lk ? c.w_s[prune + i][k] : 0u;
  }

  for (int idx = threadIdx.x; idx < m; idx += blockDim.x) {
    uint32_t s = 0;
    for (int r = 0; r < 2 * lk; ++r) {
      const int krow = r < lk ? prune + r : l + prune + (r - lk);
      const size_t ko = krow * krow_stride + kcol + idx;
      const uint32_t d = dh[((size_t)r * L + k) * m + idx];
      s = addmod(s, shoup(d, key[ko], key_s[ko], p), p);
    }
    uint32_t t = 0;
    if (t_mode == 2) {
      t = carry[ak + idx];
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i < lk) {
          const uint32_t d = dh[((size_t)(col * lk + i) * L + k) * m + idx];
          t = addmod(t, shoup(d, wv[i], wsv[i], p), p);
        }
      }
    }
    const uint32_t ev = 2u * (__brev((uint32_t)idx) >> (32 - logm)) + 1u;
    const uint32_t e = (ev * uk) & mask2m;
    const uint32_t rot = shoup(s, pw[e], pws[e], p);
    const uint32_t val = addmod(submod(rot, s, p), t, p);
    if (t_mode != 0) carry[ak + idx] = val;
    sm[idx] = val;
  }
  __syncthreads();
  ntt_inv_smem(sm, tab + 2 * (size_t)m, tab + 3 * (size_t)m, p, m, logm);
  const uint32_t* post = tab + 4 * (size_t)m;
  const uint32_t* post_s = tab + 5 * (size_t)m;
  for (int idx = threadIdx.x; idx < m; idx += blockDim.x) {
    acc_out[ak + idx] = shoup(sm[idx], post[idx], post_s[idx], p);
  }
}

static int log2i(int m) {
  int r = 0;
  while ((1 << r) < m) ++r;
  return r;
}

template <typename K>
static cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}

template <int L>
static int launch_fwd(const uint32_t* acc, uint32_t* d_hat,
                      const uint32_t* tables, const RnsConsts& c, int B, int m,
                      int prune, int close, int randomized, uint32_t seed_lo,
                      uint32_t seed_hi, uint32_t step, cudaStream_t stream) {
  const size_t smem = (size_t)m * sizeof(uint32_t);
  cudaError_t err = prepare(flatten_ntt_fwd_kernel<L>, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = m / 2 < 256 ? m / 2 : 256;
  const unsigned grid = (unsigned)B * 2u * (unsigned)(L - prune) * (unsigned)L;
  flatten_ntt_fwd_kernel<L><<<grid, threads, smem, stream>>>(
      acc, d_hat, tables, c, B, m, log2i(m), prune, close, randomized,
      seed_lo, seed_hi, step);
  return (int)cudaGetLastError();
}

template <int L>
static int launch_mac(const uint32_t* d_hat, const uint32_t* key,
                      const uint32_t* key_s, const uint32_t* u,
                      uint32_t* acc_out, uint32_t* carry,
                      const uint32_t* tables, const RnsConsts& c, int B, int m,
                      int prune, int t_mode, cudaStream_t stream) {
  const size_t smem = (size_t)m * sizeof(uint32_t);
  cudaError_t err = prepare(mac_rotate_ntt_inv_kernel<L>, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = m / 2 < 256 ? m / 2 : 256;
  const unsigned grid = (unsigned)B * 2u * (unsigned)L;
  mac_rotate_ntt_inv_kernel<L><<<grid, threads, smem, stream>>>(
      d_hat, key, key_s, u, acc_out, carry, tables, c, B, m, log2i(m), prune,
      t_mode);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns a cudaError_t (0 on success). `consts` is a host array laid out
// as RnsConsts (sgfhe_tpu_torch/ops/fused.py builds it).
int sg_flatten_ntt_fwd(const uint32_t* acc, uint32_t* d_hat,
                       const uint32_t* tables, const uint32_t* consts, int B,
                       int L, int m, int prune, int close, int randomized,
                       uint32_t seed_lo, uint32_t seed_hi, uint32_t step,
                       void* stream) {
  RnsConsts c;
  std::memcpy(&c, consts, sizeof(c));
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 2:
      return launch_fwd<2>(acc, d_hat, tables, c, B, m, prune, close,
                           randomized, seed_lo, seed_hi, step, st);
    case 3:
      return launch_fwd<3>(acc, d_hat, tables, c, B, m, prune, close,
                           randomized, seed_lo, seed_hi, step, st);
    case 4:
      return launch_fwd<4>(acc, d_hat, tables, c, B, m, prune, close,
                           randomized, seed_lo, seed_hi, step, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int sg_mac_rotate_ntt_inv(const uint32_t* d_hat, const uint32_t* key,
                          const uint32_t* key_s, const uint32_t* u,
                          uint32_t* acc_out, uint32_t* carry,
                          const uint32_t* tables, const uint32_t* consts,
                          int B, int L, int m, int prune, int t_mode,
                          void* stream) {
  RnsConsts c;
  std::memcpy(&c, consts, sizeof(c));
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 2:
      return launch_mac<2>(d_hat, key, key_s, u, acc_out, carry, tables, c, B,
                           m, prune, t_mode, st);
    case 3:
      return launch_mac<3>(d_hat, key, key_s, u, acc_out, carry, tables, c, B,
                           m, prune, t_mode, st);
    case 4:
      return launch_mac<4>(d_hat, key, key_s, u, acc_out, carry, tables, c, B,
                           m, prune, t_mode, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int sg_consts_words(void) { return (int)(sizeof(RnsConsts) / sizeof(uint32_t)); }

}  // extern "C"
