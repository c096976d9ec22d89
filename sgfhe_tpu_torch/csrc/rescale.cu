// The exact Q->r modulus switch for NVIDIA Hopper (sm_90a): one launch for
// the whole of sgfhe_tpu_torch/ops/rns.rescale_exact on a CUDA tensor.
//
// Replaces no TPU kernel: the JAX package's rescale_exact
// (sgfhe_tpu/ops/rns.py) is jnp, which XLA fuses into a few programs. Its
// eager PyTorch counterpart, the plain version (rescale_exact_plain), is
// about 315 small int64 launches a call, and the host issuing them kept the
// card idle. This kernel is the same arithmetic in registers: one thread a
// coefficient, in a grid-stride loop over the outer x m coefficients of a
// (..., L, m) int64 tensor, whose L residues it reads at the limb stride
// (neighbouring threads read neighbouring coefficients) and whose switched
// value it writes as one int64.
//
// Per coefficient, as the plain version computes it:
//   - the unsigned mixed-radix digits d_i of x (x = sum_i d_i w_i, w_i =
//     prod_{j<i} p_j): the chain of submod and Shoup multiplies by
//     inv(p_j) mod p_i;
//   - the float32 estimate q_est = floor(max(0, sum_i d_i * f32(A w_i / C)
//     + f32(B / C))), each product and sum rounded as torch rounds it
//     (__fmul_rn, __fadd_rn: no contraction into an FMA);
//   - D = sum_i d_i (A w_i) + (B + K C) - q_est C exactly, in NL 32-bit
//     limbs wrapping mod 2^(32 NL);
//   - q = q_est - K + #{i in 1..2K : D >= i C}, masked by new_max - 1.
// (round: A = 2 new_max, B = Q, C = 2Q; floor: A = new_max, B = 0, C = Q.)
// The float32 estimate is within K of the quotient and the exact ladder
// absorbs the offset, so the output equals the plain version's bit for bit.
//
// What bounds it: device memory. A coefficient reads 8 L bytes and writes
// 8; its arithmetic is a few dozen integer operations, L (L - 1) / 2 Shoup
// multiplies and L NL 32x32 products.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "rotate_common.cuh"

#define SW_NLMAX 5  // limbs of D: 142 bits at most for L = 4, K <= 4
#define SW_KMAX 4   // the plain version's bound on the ladder
#define SW_THREADS 256
#define SW_BLOCKS_MAX 4096

// Laid out as ops/rns.SWITCH_FIELDS, uint32 words; built on the host from
// the Python-int moduli, cached per (moduli, new_max, round_result) and
// passed by value.
struct SwitchConsts {
  uint32_t p[LMAX];
  uint32_t inv_pj[LMAX][LMAX];    // [i][j]: inv(p_j) mod p_i, j < i
  uint32_t inv_pj_s[LMAX][LMAX];  // Shoup companions
  float f[LMAX];                  // f32(A w_i / C)
  float f_b;                      // f32(B / C); 0 in floor mode, exact to add
  uint32_t aw[LMAX][SW_NLMAX];    // limbs of A w_i, least significant first
  uint32_t bkc[SW_NLMAX];         // limbs of B + K C
  uint32_t ic[2 * SW_KMAX][SW_NLMAX];  // [i]: limbs of (i + 1) C
  int32_t k;                      // K, 1 to SW_KMAX
  uint32_t mask;                  // new_max - 1
};

template <int NL>
__device__ __forceinline__ void mll_mac(uint32_t (&acc)[NL], uint32_t d,
                                        const uint32_t (&k)[SW_NLMAX]) {
  // acc += d * k, wrapping mod 2^(32 NL)
  uint32_t carry = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const unsigned long long t =
        (unsigned long long)d * k[l] + acc[l] + carry;  // < 2^64
    acc[l] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
}

template <int NL>
__device__ __forceinline__ void mll_msub(uint32_t (&acc)[NL], uint32_t q,
                                         const uint32_t (&c)[SW_NLMAX]) {
  // acc -= q * c, wrapping mod 2^(32 NL)
  uint32_t carry = 0, borrow = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const unsigned long long t = (unsigned long long)q * c[l] + carry;
    carry = (uint32_t)(t >> 32);
    const unsigned long long diff =
        (unsigned long long)acc[l] - (uint32_t)t - borrow;
    acc[l] = (uint32_t)diff;
    borrow = (uint32_t)(diff >> 63);
  }
}

template <int NL>
__device__ __forceinline__ bool mll_ge(const uint32_t (&a)[NL],
                                       const uint32_t (&t)[SW_NLMAX]) {
  // a >= t, decided at the most significant limb that differs
  int cmp = 0;
#pragma unroll
  for (int l = NL - 1; l >= 0; --l)
    if (cmp == 0) cmp = a[l] > t[l] ? 1 : (a[l] < t[l] ? -1 : 0);
  return cmp >= 0;
}

template <int L, int NL>
__global__ void __launch_bounds__(SW_THREADS)
    rescale_exact_kernel(const long long* __restrict__ x,
                         long long* __restrict__ out, long long total, int m,
                         long long s_outer, long long s_limb,
                         long long s_coeff, const SwitchConsts c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long o = idx / m;
    const long long* xp = x + o * s_outer + (idx - o * m) * s_coeff;
    uint32_t d[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      uint32_t t = (uint32_t)__ldg(xp + i * s_limb);
#pragma unroll
      for (int j = 0; j < i; ++j) {
        t = submod(t, d[j] % c.p[i], c.p[i]);
        t = shoup(t, c.inv_pj[i][j], c.inv_pj_s[i][j], c.p[i]);
      }
      d[i] = t;
    }
    float est = __fmul_rn(__uint2float_rn(d[0]), c.f[0]);
#pragma unroll
    for (int i = 1; i < L; ++i)
      est = __fadd_rn(est, __fmul_rn(__uint2float_rn(d[i]), c.f[i]));
    est = fmaxf(__fadd_rn(est, c.f_b), 0.0f);
    const uint32_t q_est = (uint32_t)floorf(est);

    uint32_t acc[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) acc[l] = c.bkc[l];
#pragma unroll
    for (int i = 0; i < L; ++i) mll_mac<NL>(acc, d[i], c.aw[i]);
    mll_msub<NL>(acc, q_est, c.ic[0]);
    long long q = (long long)q_est - c.k;
#pragma unroll
    for (int i = 0; i < 2 * SW_KMAX; ++i)
      if (i < 2 * c.k) q += mll_ge<NL>(acc, c.ic[i]);
    out[idx] = q & (long long)c.mask;
  }
}

template <int L, int NL>
static int launch(const long long* x, long long* out, const SwitchConsts& c,
                  long long total, int m, long long s_outer, long long s_limb,
                  long long s_coeff, cudaStream_t stream) {
  long long blocks = (total + SW_THREADS - 1) / SW_THREADS;
  if (blocks > SW_BLOCKS_MAX) blocks = SW_BLOCKS_MAX;
  rescale_exact_kernel<L, NL><<<(int)blocks, SW_THREADS, 0, stream>>>(
      x, out, total, m, s_outer, s_limb, s_coeff, c);
  return (int)cudaGetLastError();
}

template <int L>
static int launch_l(const long long* x, long long* out, const SwitchConsts& c,
                    int nl, long long total, int m, long long s_outer,
                    long long s_limb, long long s_coeff, cudaStream_t stream) {
  switch (nl) {
    case 1: return launch<L, 1>(x, out, c, total, m, s_outer, s_limb, s_coeff, stream);
    case 2: return launch<L, 2>(x, out, c, total, m, s_outer, s_limb, s_coeff, stream);
    case 3: return launch<L, 3>(x, out, c, total, m, s_outer, s_limb, s_coeff, stream);
    case 4: return launch<L, 4>(x, out, c, total, m, s_outer, s_limb, s_coeff, stream);
    case 5: return launch<L, 5>(x, out, c, total, m, s_outer, s_limb, s_coeff, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// Returns a cudaError_t (0 on success). x: `outer` x L x m int64 residues at
// the given element strides; out: outer x m int64, contiguous. `consts` is a
// host array laid out as SwitchConsts (ops/rns.switch_consts builds it).
int sg_rescale_exact(const long long* x, long long* out,
                     const uint32_t* consts, long long outer, int L, int m,
                     int nl, long long s_outer, long long s_limb,
                     long long s_coeff, void* stream) {
  SwitchConsts c;
  std::memcpy(&c, consts, sizeof(c));
  if (c.k < 1 || c.k > SW_KMAX || m < 1) return (int)cudaErrorInvalidValue;
  const long long total = outer * m;
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch_l<1>(x, out, c, nl, total, m, s_outer, s_limb, s_coeff, st);
    case 2: return launch_l<2>(x, out, c, nl, total, m, s_outer, s_limb, s_coeff, st);
    case 3: return launch_l<3>(x, out, c, nl, total, m, s_outer, s_limb, s_coeff, st);
    case 4: return launch_l<4>(x, out, c, nl, total, m, s_outer, s_limb, s_coeff, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
