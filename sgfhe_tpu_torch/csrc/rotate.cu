// Blind-rotation step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the streamed Pallas TPU kernel of sgfhe_tpu/ops/fused.py,
//   _rotate_step_kernel (fused.py:604, key streamed, T-term by w-multiplies)
// and its body (_flatten_k, _flatten_rand_k, _ntt_fwd_lazy, _rotate_body,
// _ntt_inv_lazy), for keys larger than 10 MiB; keys up to that take
// rotate_resident.cu, the resident kernel _rotate_kernel's counterpart.
// One rotation step is two launches; the n-step loop runs on the host
// (sgfhe_tpu_torch/ops/fused.py), in place of the TPU grid's sequential step
// axis. The helpers they share with rotate_resident.cu are in
// rotate_common.cuh.
//
//   flatten_ntt_fwd     one block per (gate, operand), or per (gate,
//                       operand, limb[, digit]) where the digits of all
//                       limbs do not fit shared memory: reads the operand's
//                       L limbs once with 16-byte loads, runs the
//                       mixed-radix chain (and in randomized mode the
//                       Threefry-2x32 masks) once per coefficient, embeds
//                       every kept digit into every limb of the block,
//                       forward negacyclic NTT of all of them -> d_hat.
//   mac_rotate_ntt_inv  one block per (column c, limb k, tile of G gates):
//                       walks the coefficients in chunks, staging each chunk
//                       of the 2(l - prune) key rows and of the G gates'
//                       d_hat rows into a double-buffered shared-memory
//                       ring by cp.async, and uses each key chunk for all G
//                       gates: MAC and T-term (w-multiplies) as exact
//                       64-bit sums reduced once,
//                       x^{u_k} by one gather of psi^{(2 br(idx)+1) u mod
//                       2m} per quad of coefficients and powers of the 4th
//                       root of unity psi^{m/2}, val = rot - s + t into
//                       shared memory; then the inverse NTT and post-twist
//                       of the G vals -> acc.
//
// What bounds them on this card. By bytes, the forward kernel reads acc and
// writes d_hat (2(l - prune) digits x L limbs x m words per gate) and the
// MAC kernel reads d_hat and writes acc; the key slice of a step is shared
// by every gate, so it comes from device memory about once and from L2
// once per tile of G gates (the launch plan picks G). In practice both are
// held up by integer issue and latency: a forward NTT butterfly is 7
// integer operations, 3 of them multiplies, and a block keeps its whole
// polynomials in shared memory, so an SM holds few blocks. What the design
// does:
//   - every accumulator word is read once per step, and the digit chain and
//     Threefry masks run once per coefficient (the first version read each
//     accumulator and redid the chain l x L times);
//   - the NTTs are register-blocked: a thread holds 2^R words of one
//     polynomial and runs R <= 4 butterfly stages on them between
//     shared-memory exchanges, and each exchange (one __syncthreads)
//     covers every polynomial of the block: 3 exchanges at m = 512 and at
//     m = 4096 instead of 9 and 12;
//   - shared memory is padded by one word per 32, so the strided groups of
//     the late stages fall on distinct banks;
//   - the key chunk in shared memory serves G gates (the first version read
//     the key once per gate), and the MAC reads only shared memory while
//     the next chunk streams in;
//   - both kernels compile to at most 64 registers a thread;
//   - twiddles, the post-twist and the x^u power table are read through
//     __ldg: staging them in shared memory cost blocks per SM and did not
//     pay at either main-path shape;
//   - global loads and stores of acc, d_hat and the key are 16 bytes.
// Every value stays below 4p < 2^32 in the NTTs (Harvey butterflies, as
// in the first version) and every kernel output is canonical, so the
// outputs equal the plain versions bit for bit.
//
// Data are uint32 bit patterns in int32 tensors, layouts (row-major):
//   acc    (2, B, L, m)   [a; b] accumulators, canonical
//   d_hat  (B, 2lk, L, m) canonical hat digits, lk = l - prune
//   key    (2l, 2, L, m)  this step's key slice (hat); the MAC sums exact
//                         64-bit products, so it needs no Shoup companions
//   tables (L, 10, m)     fwd, fwd_s, inv, inv_s, post, post_s, pw (2m), pw_s (2m)
// Moduli are < 2^30 (asserted by the Python wrapper), so lazy values below
// 4p fit in 32 bits. Each launch takes its block shape from a plan the
// wrapper computes (ops/fused.py fwd_plan, mac_plan).

#include <cstring>

#include "rotate_common.cuh"

// Both kernels are compiled for at most 64 registers a thread, so that
// registers never cap an SM below 32 resident warps (ops/fused.py assumes
// it when it plans blocks per SM).
#define FWD_THREADS_MAX 1024
#define MAC_THREADS 256
#define MAC_MIN_BLOCKS 4

// Launch plans, as ops/fused.py's FwdPlan.words() / MacPlan.words() lay
// them out.
struct FwdPlan {
  int limbs;    // limbs per block: L, or 1
  int digits;   // kept digits per block: l - prune, or 1
  int threads;
  int smem;     // dynamic shared memory, bytes
  int grid;
};

struct MacPlan {
  int gates;    // G, gates per block
  int chunk;    // coefficients per staged chunk
  int threads;
  int smem;
  int grid;
};

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* g) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// flatten_ntt_fwd
// ---------------------------------------------------------------------------

// Block (gate b, operand op, limb group, digit group): limbs k0 .. k0+KL-1,
// kept digits i0 .. i0+KD-1. Shared memory: KL*KD padded polynomials (digit
// major).
template <int L, bool RANDOMIZED>
__global__ void __launch_bounds__(FWD_THREADS_MAX) flatten_ntt_fwd_kernel(
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ d_hat,
    const uint32_t* __restrict__ tables, const __grid_constant__ RnsConsts c,
    const FwdPlan pl,
    int B, int m, int logm, int prune, int close, uint32_t seed_lo,
    uint32_t seed_hi, uint32_t step) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int lk = L - prune;
  const int KL = pl.limbs, KD = pl.digits;
  int bid = blockIdx.x;
  const int lg = bid % (L / KL);
  bid /= L / KL;
  const int dg = bid % (lk / KD);
  bid /= lk / KD;
  const int op = bid % 2;
  const int b = bid / 2;
  const int k0 = lg * KL, i0 = prune + dg * KD;
  const int pitch = m + (m >> 5) + 1;
  const int npoly = KL * KD;
  const int quads = m >> 2;

  const uint32_t* x = acc + ((size_t)op * B + b) * L * m;
  constexpr int NP = (L + 1) / 2;
  for (int qd = threadIdx.x; qd < quads; qd += blockDim.x) {
    uint32_t yq[L][4];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint4 v = ldg4(x + (size_t)j * m + 4 * qd);
      yq[j][0] = v.x; yq[j][1] = v.y; yq[j][2] = v.z; yq[j][3] = v.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int idx = 4 * qd + cc;
      uint32_t y[L];
#pragma unroll
      for (int j = 0; j < L; ++j) y[j] = yq[j][cc];
      uint32_t mk[L][L], dig[L];  // masks e of digit d in limb j; digits
      coeff_digits<L, RANDOMIZED>(y, mk, dig, c, prune, i0 + KD, close, seed_lo,
                                  seed_hi, (uint32_t)b * (uint32_t)m + (uint32_t)idx,
                                  (step * 2u + (uint32_t)op) * (uint32_t)NP);
#pragma unroll
      for (int d = 0; d < L; ++d) {
        if (d < i0 || d >= i0 + KD) continue;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          if (j < k0 || j >= k0 + KL) continue;
          uint32_t e = submod(cross(dig[d], c.p[j], close), c.s_mod[d][j], c.p[j]);
          if (RANDOMIZED) e = addmod(e, mk[d][j], c.p[j]);
          sm[((d - i0) * KL + (j - k0)) * pitch + pad(idx)] = e;
        }
      }
    }
  }
  __syncthreads();
  ntt_fwd_blocked(sm, pitch, npoly, logm, tables + (size_t)k0 * 10 * m, 10 * m,
                  KL, c.p + k0);
  for (int w = threadIdx.x; w < npoly * quads; w += blockDim.x) {
    const int q = w >> (logm - 2), qd = w & (quads - 1);
    const int ik = dg * KD + q / KL, k = k0 + q % KL;
    const uint32_t p = c.p[k];
    const uint32_t* xs = sm + q * pitch;
    uint32_t o[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) o[cc] = csub(csub(xs[pad(4 * qd + cc)], 2 * p), p);
    st4(d_hat + (((size_t)b * 2 * lk + op * lk + ik) * L + k) * m + 4 * qd,
        o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------------------
// mac_rotate_ntt_inv
// ---------------------------------------------------------------------------

// Block (column col, limb k, gates b0 .. b0+G-1). Shared memory: G padded
// vals; the ring, 2 buffers (1 if one chunk is the whole row) of 2lk (G +
// 1) rows x chunk words: the 2lk kept key rows (the MAC sums exact 64-bit
// products, so it needs no Shoup companions), then the 2lk d_hat rows of
// each gate. Chunk ch+1 streams in by cp.async
// while chunk ch is computed from shared memory, one quad
// of one gate per thread (the plan keeps G x chunk / 4 <= MAC_THREADS);
// the thread's x^u power for chunk ch+1 is loaded from device memory
// before chunk ch is computed. The T-term is computed by w-multiplies of
// the column's kept d_hat rows.
template <int L>
__global__ void __launch_bounds__(MAC_THREADS, MAC_MIN_BLOCKS) mac_rotate_ntt_inv_kernel(
    const uint32_t* __restrict__ d_hat, const uint32_t* __restrict__ key,
    const uint32_t* __restrict__ u, uint32_t* __restrict__ acc_out,
    const uint32_t* __restrict__ tables, const __grid_constant__ RnsConsts c,
    const MacPlan pl, int B, int m, int logm, int prune) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int lk = L - prune;
  const int G = pl.gates, C = pl.chunk;
  // limb-major grid: the blocks an SM holds at once mostly share a limb,
  // and with it the limb's tables in L1; the two columns of a tile are
  // neighbours, so their d_hat rows come from device memory once
  const int tiles = (B + G - 1) / G;
  const int col = blockIdx.x % 2;
  const int b0 = (blockIdx.x / 2 % tiles) * G;
  const int k = blockIdx.x / (2 * tiles);
  const int gv = min(G, B - b0);  // gates of a ragged last tile
  const int pitch = m + (m >> 5);
  const int nch = m / C;
  const int S = nch > 1 ? 2 : 1;  // ring buffers
  const int key_rows = 2 * lk;
  const int ring_words = (key_rows + 2 * lk * G) * C;
  uint32_t* vals = sm;
  uint32_t* ring = vals + G * pitch;
  const uint32_t p = c.p[k];
  const uint32_t* tab = tables + (size_t)k * 10 * m;
  const uint32_t mask2m = 2u * (uint32_t)m - 1u;
  const size_t krow_stride = (size_t)2 * L * m;
  const size_t kcol = ((size_t)col * L + k) * m;
  const int qpc = C >> 2;  // quads per chunk row

  // T-term multiplier of each d_hat row r (rows col*lk .. col*lk+lk-1)
  uint32_t wr[2 * L];
#pragma unroll
  for (int r = 0; r < 2 * L; ++r) {
    const int i = r - col * lk;
    const bool on = r < 2 * lk && i >= 0 && i < lk;
    wr[r] = on ? c.w[prune + i][k] : 0u;
  }

  // One commit group per call, empty past the last chunk, so that chunk ch
  // has landed once at most S - 1 groups are pending.
  // Thread t copies quad t % qpc of rows t / qpc, t / qpc + rstep, ...
  const int rstep = blockDim.x / qpc;
  auto stage = [&](int ch) {
    if (ch < nch) {
      uint32_t* dst = ring + (ch % S) * ring_words + 4 * (threadIdx.x % qpc);
      const size_t off = (size_t)ch * C + 4 * (threadIdx.x % qpc);
      const int rows = key_rows + 2 * lk * gv;
      for (int row = threadIdx.x / qpc; row < rows; row += rstep) {
        const uint32_t* src;
        if (row < key_rows) {
          const int krow = row < lk ? prune + row : L + prune + (row - lk);
          src = key + krow * krow_stride + kcol;
        } else {
          const int g = (row - key_rows) / (2 * lk), r = row - key_rows - g * 2 * lk;
          src = d_hat + (((size_t)(b0 + g) * 2 * lk + r) * L + k) * m;
        }
        cp_async16(dst + row * C, src + off);
      }
    }
    cp_async_commit();
  };

  for (int ch = 0; ch < S - 1; ++ch) stage(ch);
  // limb k's tables: inv | inv_s | post | post_s | pw (2m) | pw_s (2m)
  const uint32_t* T = tab + 2 * (size_t)m;
  const uint32_t* pw = T + 4 * (size_t)m;
  const uint32_t* pws = T + 6 * (size_t)m;
  // I = psi^{m/2}, a 4th root of unity: coefficient 4q + cc has exponent
  // e(4q) + br2(cc) (m/2) u mod 2m, so x^u costs one gather per quad and
  // a multiply by I^{br2(cc) u mod 4} (1, I, -1 or -I)
  const uint32_t rI = __ldg(tab + 6 * (size_t)m + m / 2);
  const uint32_t rIs = __ldg(tab + 8 * (size_t)m + m / 2);
  const unsigned long long mu = ~0ull / p;  // Barrett: floor(2^64 / p)

  // this thread's quad: gate g, quad qd of every chunk
  const int g = threadIdx.x / qpc, qd = threadIdx.x % qpc;
  const bool active = g < gv;
  const int b = b0 + (active ? g : 0);
  const uint32_t uk = __ldg(u + b);
  uint32_t nw = 0, nws = 0;
  auto prefetch = [&](int ch) {  // x^u power of chunk ch
    if (!active || ch >= nch) return;
    const int idx0 = ch * C + 4 * qd;
    const uint32_t e = ((2u * (__brev((uint32_t)idx0) >> (32 - logm)) + 1u) * uk) & mask2m;
    nw = __ldg(pw + e);
    nws = __ldg(pws + e);
  };
  prefetch(0);

  for (int ch = 0; ch < nch; ++ch) {
    stage(ch + S - 1);
    if (S == 1) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    const uint32_t pwv = nw, pwsv = nws;
    prefetch(ch + 1);
    if (active) {
      const uint32_t* kb = ring + (ch % S) * ring_words;
      const int idx0 = ch * C + 4 * qd;
      const uint32_t* dg = kb + (key_rows + 2 * lk * g) * C + 4 * qd;
      // MAC and T-term as exact 64-bit sums (at most 2L products below
      // p^2 < 2^60), each reduced once
      unsigned long long s64[4] = {0, 0, 0, 0}, t64[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < 2 * L; ++r) {
        if (r >= 2 * lk) continue;
        const uint4 dv = *reinterpret_cast<const uint4*>(dg + r * C);
        const uint4 kv = *reinterpret_cast<const uint4*>(kb + r * C + 4 * qd);
        const uint32_t d[4] = {dv.x, dv.y, dv.z, dv.w};
        const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s64[cc] += (unsigned long long)d[cc] * kw[cc];
        if (wr[r] != 0u) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) t64[cc] += (unsigned long long)d[cc] * wr[r];
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const uint32_t s = barrett(s64[cc], p, mu);
        const uint32_t t = barrett(t64[cc], p, mu);
        const uint32_t j = ((uint32_t)((cc & 1) * 2 + (cc >> 1)) * uk) & 3u;
        uint32_t rot = shoup(s, pwv, pwsv, p);
        if (j & 1u) rot = shoup(rot, rI, rIs, p);
        if ((j & 2u) && rot) rot = p - rot;
        vals[g * pitch + pad(idx0 + cc)] = addmod(submod(rot, s, p), t, p);
      }
    }
    __syncthreads();  // the next stage() overwrites buffer ch % S
  }

  ntt_inv_blocked(vals, pitch, gv, logm, T, 0, 1, c.p + k);
  const uint32_t* post = T + 2 * (size_t)m;
  const uint32_t* post_s = T + 3 * (size_t)m;
  for (int w = threadIdx.x; w < gv * (m >> 2); w += blockDim.x) {
    const int g = w >> (logm - 2);
    const int idx0 = 4 * (w & ((m >> 2) - 1));
    const uint32_t* xs = vals + g * pitch;
    const uint4 pq = ldg4(post + idx0), psq = ldg4(post_s + idx0);
    const uint32_t pv[4] = {pq.x, pq.y, pq.z, pq.w}, psv[4] = {psq.x, psq.y, psq.z, psq.w};
    uint32_t o[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) o[cc] = shoup(xs[pad(idx0 + cc)], pv[cc], psv[cc], p);
    st4(acc_out + (((size_t)col * B + b0 + g) * L + k) * m + idx0, o[0], o[1],
        o[2], o[3]);
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

template <typename K>
static cudaError_t prepare(K kernel, int smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return cudaSuccess;
}

template <int L, bool RANDOMIZED>
static int launch_fwd_mode(const uint32_t* acc, uint32_t* d_hat,
                           const uint32_t* tables, const RnsConsts& c,
                           const FwdPlan& pl, int B, int m, int prune,
                           int close, uint32_t seed_lo, uint32_t seed_hi,
                           uint32_t step, cudaStream_t stream) {
  cudaError_t err = prepare(flatten_ntt_fwd_kernel<L, RANDOMIZED>, pl.smem);
  if (err != cudaSuccess) return (int)err;
  flatten_ntt_fwd_kernel<L, RANDOMIZED><<<pl.grid, pl.threads, pl.smem, stream>>>(
      acc, d_hat, tables, c, pl, B, m, log2i(m), prune, close, seed_lo,
      seed_hi, step);
  return (int)cudaGetLastError();
}

template <int L>
static int launch_fwd(const uint32_t* acc, uint32_t* d_hat,
                      const uint32_t* tables, const RnsConsts& c,
                      const FwdPlan& pl, int B, int m, int prune, int close,
                      int randomized, uint32_t seed_lo, uint32_t seed_hi,
                      uint32_t step, cudaStream_t stream) {
  return randomized
             ? launch_fwd_mode<L, true>(acc, d_hat, tables, c, pl, B, m, prune,
                                        close, seed_lo, seed_hi, step, stream)
             : launch_fwd_mode<L, false>(acc, d_hat, tables, c, pl, B, m, prune,
                                         close, seed_lo, seed_hi, step, stream);
}

template <int L>
static int launch_mac(const uint32_t* d_hat, const uint32_t* key,
                      const uint32_t* u, uint32_t* acc_out,
                      const uint32_t* tables, const RnsConsts& c,
                      const MacPlan& pl, int B, int m, int prune,
                      cudaStream_t stream) {
  if (pl.gates * (pl.chunk / 4) > pl.threads) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(mac_rotate_ntt_inv_kernel<L>, pl.smem);
  if (err != cudaSuccess) return (int)err;
  mac_rotate_ntt_inv_kernel<L><<<pl.grid, pl.threads, pl.smem, stream>>>(
      d_hat, key, u, acc_out, tables, c, pl, B, m, log2i(m), prune);
  return (int)cudaGetLastError();
}

extern "C" {

// Each returns a cudaError_t (0 on success). `consts` is a host array laid
// out as RnsConsts, `plan` one laid out as FwdPlan / MacPlan
// (sgfhe_tpu_torch/ops/fused.py builds both). `key` is the step's key
// slice, the hat alone.
int sg_flatten_ntt_fwd(const uint32_t* acc, uint32_t* d_hat,
                       const uint32_t* tables, const uint32_t* consts, int B,
                       int L, int m, int prune, int close, int randomized,
                       uint32_t seed_lo, uint32_t seed_hi, uint32_t step,
                       void* stream, const int32_t* plan) {
  RnsConsts c;
  std::memcpy(&c, consts, sizeof(c));
  FwdPlan pl;
  std::memcpy(&pl, plan, sizeof(pl));
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 2:
      return launch_fwd<2>(acc, d_hat, tables, c, pl, B, m, prune, close,
                           randomized, seed_lo, seed_hi, step, st);
    case 3:
      return launch_fwd<3>(acc, d_hat, tables, c, pl, B, m, prune, close,
                           randomized, seed_lo, seed_hi, step, st);
    case 4:
      return launch_fwd<4>(acc, d_hat, tables, c, pl, B, m, prune, close,
                           randomized, seed_lo, seed_hi, step, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int sg_mac_rotate_ntt_inv(const uint32_t* d_hat, const uint32_t* key,
                          const uint32_t* u, uint32_t* acc_out,
                          const uint32_t* tables, const uint32_t* consts,
                          int B, int L, int m, int prune, void* stream,
                          const int32_t* plan) {
  RnsConsts c;
  std::memcpy(&c, consts, sizeof(c));
  MacPlan pl;
  std::memcpy(&pl, plan, sizeof(pl));
  cudaStream_t st = (cudaStream_t)stream;
  switch (L) {
    case 2:
      return launch_mac<2>(d_hat, key, u, acc_out, tables, c, pl, B, m,
                           prune, st);
    case 3:
      return launch_mac<3>(d_hat, key, u, acc_out, tables, c, pl, B, m,
                           prune, st);
    case 4:
      return launch_mac<4>(d_hat, key, u, acc_out, tables, c, pl, B, m,
                           prune, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int sg_consts_words(void) { return (int)(sizeof(RnsConsts) / sizeof(uint32_t)); }

}  // extern "C"
