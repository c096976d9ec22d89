// The whole blind rotation in one launch, for keys that stay in L2 (NVIDIA
// Hopper, sm_90a).
//
// Replaces the resident Pallas TPU kernel of sgfhe_tpu/ops/fused.py,
//   _rotate_kernel (fused.py:542, called at :810: the key in VMEM, a
//   fori_loop over the n steps inside the kernel, the grid over batch tiles),
// where the step pair of rotate.cu would make 2n launches: one block per
// tile of G gates runs all n steps of its gates with their state in shared
// memory, and device memory sees the accumulators once in and once out.
//
//   rotate_resident   block (tile of G gates), loop k = 0 .. n-1:
//                       1. flatten both accumulators of each gate into their
//                          kept balanced digits (Threefry-masked in
//                          randomized mode, the step pair's counters);
//                       2. forward NTT of every digit polynomial;
//                       3. MAC against key_hat[k], read from device memory
//                          (L2) through __ldg: the G gates' threads of one
//                          coefficient read the same words;
//                       4. T-term: carried (prune == 0: the canonical hat
//                          of the entry accumulators, then each step's val)
//                          or by w-multiplies of the kept digits (prune > 0);
//                       5. val = x^{u_k} s - s + T, x^{u_k} by the psi-power
//                          gather of the step pair;
//                       6. inverse NTT and post-twist back into the
//                          accumulators.
//
// Shared memory of a block, padded polynomials of pitch m + m/32 + 1 words:
//   A  [gate][operand][limb]            the accumulators; also the kept
//                                       digit 0 of each operand and the val
//                                       of each column (every pass reads a
//                                       coefficient before it writes it, and
//                                       one thread owns each coefficient)
//   D  [gate][operand][digit 1..][limb] the other kept digits
//   T  [gate][column][limb]             the carried T-term (prune == 0)
// A and D are contiguous and limb-minor, so one forward NTT covers both.
// Every value kept between steps is canonical, so the outputs equal the
// plain version bit for bit.
//
// Data are uint32 bit patterns in int32 tensors, layouts (row-major):
//   acc_in, acc_out  (2, B, L, m)          [a; b], canonical
//   key              (n, 2l, 2, L, m)      the key's hat (no companions)
//   ua               (B, n)                exponents mod 2m
//   tables           (L, 10, m)            as rotate.cu's

#include <cstring>

#include "rotate_common.cuh"

// At most 64 registers a thread at 1024 threads: ops/fused.py's
// resident_plan gives a block 1024 / (blocks per SM) threads.
#define RES_THREADS_MAX 1024

// Launch plan, as ops/fused.py's ResidentPlan.words() lays it out.
struct ResidentPlan {
  int gates;    // G, gates per block
  int threads;
  int smem;     // dynamic shared memory, bytes
  int grid;
};

template <int L, bool RANDOMIZED, bool CARRY>
__global__ void __launch_bounds__(RES_THREADS_MAX) rotate_resident_kernel(
    const uint32_t* __restrict__ acc_in, uint32_t* __restrict__ acc_out,
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ ua,
    const uint32_t* __restrict__ tables, const __grid_constant__ RnsConsts c,
    const ResidentPlan pl, int B, int n, int m, int logm, int prune, int close,
    uint32_t seed_lo, uint32_t seed_hi) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int NP = (L + 1) / 2;
  const int lk = L - prune;
  const int b0 = blockIdx.x * pl.gates;
  const int G = min(pl.gates, B - b0);  // gates of a ragged last tile
  const int pitch = m + (m >> 5) + 1;
  const int quads = m >> 2;
  const int lgq = logm - 2;
  uint32_t* A = sm;
  uint32_t* D = A + (size_t)G * 2 * L * pitch;
  uint32_t* Tc = D + (size_t)G * 2 * (lk - 1) * L * pitch;
  const size_t krow_stride = (size_t)2 * L * m;
  const size_t kstep_stride = (size_t)2 * L * krow_stride;

  // smem polynomial of kept digit i (0 .. lk-1) of operand op, limb j
  auto digit_row = [&](int g, int op, int i, int j) -> uint32_t* {
    return i == 0 ? A + ((g * 2 + op) * L + j) * pitch
                  : D + (((g * 2 + op) * (lk - 1) + i - 1) * L + j) * pitch;
  };

  // the entry accumulators, 16-byte loads
  for (int w = threadIdx.x; w < G * 2 * L * quads; w += blockDim.x) {
    const int q = w >> lgq, qd = w & (quads - 1);  // q = (g * 2 + op) * L + j
    const int j = q % L, op = q / L % 2, g = q / (2 * L);
    const uint4 v = ldg4(acc_in + (((size_t)op * B + b0 + g) * L + j) * m + 4 * qd);
    uint32_t* x = A + q * pitch + pad(4 * qd);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    if (CARRY) {
      uint32_t* t = Tc + q * pitch + pad(4 * qd);
      t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
    }
  }
  __syncthreads();
  // the carried T of step 0: the hat of the entry accumulators (lazy here,
  // reduced where the MAC reads it)
  if (CARRY) ntt_fwd_blocked(Tc, pitch, G * 2 * L, logm, tables, 10 * m, L, c.p);

  for (int k = 0; k < n; ++k) {
    // 1. digits of every (gate, operand, coefficient)
    for (int w = threadIdx.x; w < G * 2 * m; w += blockDim.x) {
      const int idx = w & (m - 1), op = (w >> logm) & 1, g = w >> (logm + 1);
      uint32_t y[L];
#pragma unroll
      for (int j = 0; j < L; ++j) y[j] = A[((g * 2 + op) * L + j) * pitch + pad(idx)];
      uint32_t mk[L][L], dig[L];
      coeff_digits<L, RANDOMIZED>(y, mk, dig, c, prune, L, close, seed_lo, seed_hi,
                                  (uint32_t)(b0 + g) * (uint32_t)m + (uint32_t)idx,
                                  ((uint32_t)k * 2u + (uint32_t)op) * (uint32_t)NP);
#pragma unroll
      for (int d = 0; d < L; ++d) {
        if (d < prune) continue;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          uint32_t e = submod(cross(dig[d], c.p[j], close), c.s_mod[d][j], c.p[j]);
          if (RANDOMIZED) e = addmod(e, mk[d][j], c.p[j]);
          digit_row(g, op, d - prune, j)[pad(idx)] = e;
        }
      }
    }
    __syncthreads();
    // 2. forward NTT of A and D
    ntt_fwd_blocked(A, pitch, G * 2 * lk * L, logm, tables, 10 * m, L, c.p);

    // 3-5. one quad of one (gate, limb) a thread, both columns
    const uint32_t* kk = key + (size_t)k * kstep_stride;
    for (int w = threadIdx.x; w < G * L * quads; w += blockDim.x) {
      const int qd = w & (quads - 1), j = (w >> lgq) % L, g = (w >> lgq) / L;
      const int idx0 = 4 * qd;
      const uint32_t p = c.p[j];
      const unsigned long long mu = ~0ull / p;
      const uint32_t* tab = tables + (size_t)j * 10 * m;
      const uint32_t uk = __ldg(ua + (size_t)(b0 + g) * n + k);
      // x^u: coefficient 4q + cc has exponent e(4q) + br2(cc) (m/2) u mod
      // 2m, one gather per quad and a multiply by a power of I = psi^{m/2}
      const uint32_t e = ((2u * (__brev((uint32_t)idx0) >> (32 - logm)) + 1u) * uk) &
                         (2u * (uint32_t)m - 1u);
      const uint32_t pwv = __ldg(tab + 6 * (size_t)m + e);
      const uint32_t pwsv = __ldg(tab + 8 * (size_t)m + e);
      const uint32_t rI = __ldg(tab + 6 * (size_t)m + m / 2);
      const uint32_t rIs = __ldg(tab + 8 * (size_t)m + m / 2);
      uint32_t val[2][4];
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        // MAC and T-term as exact 64-bit sums of canonical products (at
        // most 2L below p^2 < 2^60), each reduced once
        unsigned long long s64[4] = {0, 0, 0, 0}, t64[4] = {0, 0, 0, 0};
        for (int r = 0; r < 2 * lk; ++r) {
          const int op = r / lk, i = r % lk;
          const int krow = op * L + prune + i;
          const uint32_t* dr = digit_row(g, op, i, j);
          const uint4 kv = ldg4(kk + krow * krow_stride + ((size_t)col * L + j) * m + idx0);
          const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
          const uint32_t wr = c.w[prune + i][j];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const uint32_t d = csub(csub(dr[pad(idx0 + cc)], 2 * p), p);
            s64[cc] += (unsigned long long)d * kw[cc];
            if (!CARRY && op == col) t64[cc] += (unsigned long long)d * wr;
          }
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const uint32_t s = barrett(s64[cc], p, mu);
          uint32_t t;
          if (CARRY) {
            t = Tc[((g * 2 + col) * L + j) * pitch + pad(idx0 + cc)];
            t = csub(csub(t, 2 * p), p);
          } else {
            t = barrett(t64[cc], p, mu);
          }
          const uint32_t jj = ((uint32_t)((cc & 1) * 2 + (cc >> 1)) * uk) & 3u;
          uint32_t rot = shoup(s, pwv, pwsv, p);
          if (jj & 1u) rot = shoup(rot, rI, rIs, p);
          if ((jj & 2u) && rot) rot = p - rot;
          val[col][cc] = addmod(submod(rot, s, p), t, p);
        }
      }
      // every digit row of this coefficient is read: write the vals over
      // kept digit 0 of each operand (A), and into the carried T
#pragma unroll
      for (int col = 0; col < 2; ++col) {
        const int q = (g * 2 + col) * L + j;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          A[q * pitch + pad(idx0 + cc)] = val[col][cc];
          if (CARRY) Tc[q * pitch + pad(idx0 + cc)] = val[col][cc];
        }
      }
    }
    __syncthreads();
    // 6. inverse NTT of the vals, post-twist to canonical accumulators
    ntt_inv_blocked(A, pitch, G * 2 * L, logm, tables + 2 * (size_t)m, 10 * m, L, c.p);
    for (int w = threadIdx.x; w < G * 2 * L * m; w += blockDim.x) {
      const int idx = w & (m - 1), q = w >> logm, j = q % L;
      const uint32_t* tab = tables + (size_t)j * 10 * m;
      uint32_t* x = A + q * pitch + pad(idx);
      *x = shoup(*x, __ldg(tab + 4 * (size_t)m + idx), __ldg(tab + 5 * (size_t)m + idx),
                 c.p[j]);
    }
    __syncthreads();
  }

  for (int w = threadIdx.x; w < G * 2 * L * quads; w += blockDim.x) {
    const int q = w >> lgq, qd = w & (quads - 1);
    const int j = q % L, op = q / L % 2, g = q / (2 * L);
    const uint32_t* x = A + q * pitch + pad(4 * qd);
    st4(acc_out + (((size_t)op * B + b0 + g) * L + j) * m + 4 * qd, x[0], x[1], x[2],
        x[3]);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

static int log2i(int m) {
  int r = 0;
  while ((1 << r) < m) ++r;
  return r;
}

template <int L, bool RANDOMIZED, bool CARRY>
static int launch(const uint32_t* acc_in, uint32_t* acc_out, const uint32_t* key,
                  const uint32_t* ua, const uint32_t* tables, const RnsConsts& c,
                  const ResidentPlan& pl, int B, int n, int m, int prune, int close,
                  uint32_t seed_lo, uint32_t seed_hi, cudaStream_t stream) {
  auto kernel = rotate_resident_kernel<L, RANDOMIZED, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<pl.grid, pl.threads, pl.smem, stream>>>(acc_in, acc_out, key, ua, tables, c,
                                                     pl, B, n, m, log2i(m), prune, close,
                                                     seed_lo, seed_hi);
  return (int)cudaGetLastError();
}

template <int L>
static int launch_l(const uint32_t* acc_in, uint32_t* acc_out, const uint32_t* key,
                    const uint32_t* ua, const uint32_t* tables, const RnsConsts& c,
                    const ResidentPlan& pl, int B, int n, int m, int prune, int close,
                    int randomized, uint32_t seed_lo, uint32_t seed_hi,
                    cudaStream_t st) {
  // the T-term is carried exactly when nothing is pruned, in both modes
  if (randomized) {
    return prune ? launch<L, true, false>(acc_in, acc_out, key, ua, tables, c, pl, B, n,
                                          m, prune, close, seed_lo, seed_hi, st)
                 : launch<L, true, true>(acc_in, acc_out, key, ua, tables, c, pl, B, n, m,
                                         prune, close, seed_lo, seed_hi, st);
  }
  return prune ? launch<L, false, false>(acc_in, acc_out, key, ua, tables, c, pl, B, n, m,
                                         prune, close, seed_lo, seed_hi, st)
               : launch<L, false, true>(acc_in, acc_out, key, ua, tables, c, pl, B, n, m,
                                        prune, close, seed_lo, seed_hi, st);
}

extern "C" {

// Returns a cudaError_t (0 on success). `consts` is a host array laid out as
// RnsConsts, `plan` one laid out as ResidentPlan (ops/fused.py builds both).
int sg_rotate_resident(const uint32_t* acc_in, uint32_t* acc_out, const uint32_t* key,
                       const uint32_t* ua, const uint32_t* tables,
                       const uint32_t* consts, int B, int L, int n, int m, int prune,
                       int close, int randomized, uint32_t seed_lo, uint32_t seed_hi,
                       void* stream, const int32_t* plan) {
  RnsConsts c;
  std::memcpy(&c, consts, sizeof(c));
  ResidentPlan pl;
  std::memcpy(&pl, plan, sizeof(pl));
  if (pl.threads > RES_THREADS_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 2:
      return launch_l<2>(acc_in, acc_out, key, ua, tables, c, pl, B, n, m, prune, close,
                         randomized, seed_lo, seed_hi, st);
    case 3:
      return launch_l<3>(acc_in, acc_out, key, ua, tables, c, pl, B, n, m, prune, close,
                         randomized, seed_lo, seed_hi, st);
    case 4:
      return launch_l<4>(acc_in, acc_out, key, ua, tables, c, pl, B, n, m, prune, close,
                         randomized, seed_lo, seed_hi, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
