// Kernel B: the permutation argument's Z and partial-product columns on the
// trace domain.
//
// Replaces the device work of the JAX package's
// plonk/prover_fused.py::fused (the permutation argument, lines 581-610) with
// _prefix_prod_j; the host reference is plonk/prover.py::
// compute_permutation_polys. For each challenge c and row r:
//
//   N_j = prod_{i in chunk j} (w_i + beta * id_i + gamma),
//   D_j = prod_{i in chunk j} (w_i + beta * sigma_i + gamma),
//   ratio_j = N_j * D_j^{-1}  (with 0^{-1} = 0, as goldilocks.py::inv),
//   Z(r) = prod_{u < r} prod_j ratio_j(u),   pp_j(r) = Z(r) * prod_{t <= j} ratio_t(r).
//
// Design: two launches. Phase 1 has one thread per (row, challenge): the
// chunk products in registers, one Fermat inverse per thread through
// Montgomery's batch trick (a zero denominator is replaced by 1 in the batch
// and its inverse set to 0, so inv(0) = 0 holds exactly), and the running
// ratio products. It writes prod_{t <= j} ratio_t into the pp rows of the
// output and the row's whole ratio into the Z row. Phase 2 has one block per
// challenge: each of up to 1024 threads takes a segment of at most 16 rows,
// the block scans the segment products in shared memory, and each thread
// then rewrites its rows in place: Z(r) is the exclusive prefix product and
// pp_j(r) is Z(r) times the stored partial ratio. So n is limited to
// 1024 * 16 = 2^14 rows (the wrapper refuses more on every device); a scan
// across blocks comes with aggregation.
//
// Bound on the H100: integer operations at the leaf (n = 256). The function
// needs about 350 field multiplies per (row, challenge), most of them the
// chunk factors and products, and one Fermat inverse per challenge when a
// batch inverse runs across all rows, against 3 * 80 reads. This kernel
// spends a Fermat inverse (127 multiplies) per (row, challenge) instead.
// Phase 2 is a latency-bound scan.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_NC = 4;
constexpr int MAX_CHUNKS = 16;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_SEGMENT = 16;
constexpr int THREADS = 128;

struct Challenges {
  uint64_t beta[MAX_NC];
  uint64_t gamma[MAX_NC];
};

// out rows: [Z_0 .. Z_{nc-1}, pp_{0,0} .. pp_{0,npp-1}, pp_{1,0} ..], each n long.
__global__ void __launch_bounds__(THREADS) perm_ratios_kernel(
    const uint64_t* __restrict__ wires, const uint64_t* __restrict__ ids,
    const uint64_t* __restrict__ sigmas, uint64_t* __restrict__ out, Challenges ch, int n,
    int nr, int qdf, int nchunks, int nc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (r >= n) return;
  const uint64_t beta = ch.beta[c], gamma = ch.gamma[c];
  const int npp = nchunks - 1;
  uint64_t cn[MAX_CHUNKS], cd[MAX_CHUNKS], pre[MAX_CHUNKS];
  uint64_t run = 1;  // product of the nonzero denominators so far
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    if (j < nchunks) {
      uint64_t num = 1, den = 1;
      const int end = min(nr, (j + 1) * qdf);
      for (int i = j * qdf; i < end; ++i) {
        const long long at = (long long)i * n + r;
        const uint64_t w = wires[at];
        num = gl::mul(num, gl::add(gl::add(w, gl::mul(beta, ids[at])), gamma));
        den = gl::mul(den, gl::add(gl::add(w, gl::mul(beta, sigmas[at])), gamma));
      }
      cn[j] = num;
      cd[j] = den;
      if (den != 0) run = gl::mul(run, den);
      pre[j] = run;
    }
  }
  uint64_t inv = gl::inv(run);  // inverse of the product of nonzero cd
#pragma unroll
  for (int j = MAX_CHUNKS - 1; j >= 0; --j) {
    if (j < nchunks) {
      const uint64_t before = j ? pre[j - 1] : 1;
      if (cd[j] != 0) {
        cn[j] = gl::mul(cn[j], gl::mul(inv, before));  // ratio_j
        inv = gl::mul(inv, cd[j]);
      } else {
        cn[j] = 0;
      }
    }
  }
  uint64_t q = 1;
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    if (j < nchunks) {
      q = gl::mul(q, cn[j]);
      if (j < npp) out[((long long)nc + c * npp + j) * n + r] = q;
    }
  }
  out[(long long)c * n + r] = q;
}

__global__ void __launch_bounds__(SCAN_THREADS) perm_scan_kernel(uint64_t* __restrict__ out,
                                                                  int n, int npp, int nc,
                                                                  int segment) {
  __shared__ uint64_t s[SCAN_THREADS];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  uint64_t* z = out + (long long)c * n;
  const int lo = min(n, t * segment), hi = min(n, lo + segment);
  uint64_t local = 1;
  for (int i = lo; i < hi; ++i) local = gl::mul(local, z[i]);
  s[t] = local;
  __syncthreads();
  // inclusive Hillis-Steele product scan over the segment products
  for (int d = 1; d < blockDim.x; d <<= 1) {
    uint64_t v = s[t];
    if (t >= d) v = gl::mul(s[t - d], v);
    __syncthreads();
    s[t] = v;
    __syncthreads();
  }
  uint64_t run = t ? s[t - 1] : 1;
  for (int i = lo; i < hi; ++i) {
    const uint64_t ratio = z[i];
    z[i] = run;
    for (int j = 0; j < npp; ++j) {
      uint64_t* pp = out + ((long long)nc + c * npp + j) * n + i;
      *pp = gl::mul(run, *pp);
    }
    run = gl::mul(run, ratio);
  }
}

}  // namespace

// wires, ids, sigmas: (nr, n) with row stride n; betas, gammas: nc host
// felts; out: (nc + nc * npp, n).
extern "C" int qzk_permutation(const void* wires, const void* ids, const void* sigmas,
                               const void* betas, const void* gammas, void* out, int n, int nr,
                               int qdf, int nc, void* stream) {
  const int nchunks = (nr + qdf - 1) / qdf;
  if (nc < 1 || nc > MAX_NC || qdf < 1 || nr < 1 || nchunks > MAX_CHUNKS || n < 1 ||
      n > SCAN_THREADS * MAX_SEGMENT)
    return (int)cudaErrorInvalidValue;
  Challenges ch{};
  for (int c = 0; c < nc; ++c) {
    ch.beta[c] = ((const uint64_t*)betas)[c];
    ch.gamma[c] = ((const uint64_t*)gammas)[c];
  }
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((n + THREADS - 1) / THREADS), (unsigned)nc);
  perm_ratios_kernel<<<grid, THREADS, 0, s>>>((const uint64_t*)wires, (const uint64_t*)ids,
                                              (const uint64_t*)sigmas, (uint64_t*)out, ch, n,
                                              nr, qdf, nchunks, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // one row a thread up to 1024 rows, then segments of up to 16 rows
  const int rounded = ((n + 31) / 32) * 32;
  const int threads = rounded < SCAN_THREADS ? rounded : SCAN_THREADS;
  const int segment = (n + threads - 1) / threads;
  perm_scan_kernel<<<(unsigned)nc, threads, 0, s>>>((uint64_t*)out, n, nchunks - 1, nc, segment);
  return (int)cudaGetLastError();
}
