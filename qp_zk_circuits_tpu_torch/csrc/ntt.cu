// Kernel 3: batched radix-2 NTT / inverse NTT / coset LDE over Goldilocks.
//
// Replaces the XLA-compiled jnp functions poly/ntt.py::ntt_j (with _stage_j),
// intt_j and coset_lde_j of the JAX package: a (C, N) batch, bit-reversed
// gather, log N decimation-in-time stages, natural order out, 1/N scale for
// the inverse, and for the LDE a x g^i shift plus zero-pad to N << rate. An
// optional output multiplier folds the quotient's g^-i unshift
// (plonk/prover.py::quotient_run after intt_j) into the inverse transform.
//
// Design: one block per column. The column lives in shared memory (N * 8
// bytes, dynamic, above 48 KB after cudaFuncSetAttribute), is loaded in
// bit-reversed order (with the coset shift and zero padding applied on the
// way in), and goes through log N butterfly stages separated by
// __syncthreads(). Stage twiddles come from a device table that concatenates
// the host stage_twiddles (stage s at offset 2^(s-1) - 1). N above 2^14 does
// not fit one block and is refused by the wrapper; the multi-pass NTT is
// later work.
//
// Bound on the H100: bytes for the prover's batches. Each column is read once
// and written once (16 bytes per output point at most); (N/2) log N
// multiplies per column are far below the integer rate. With one block per
// column only C blocks run (135 at the leaf), about one per SM.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

__global__ void ntt_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                           const uint64_t* __restrict__ twiddles,
                           const uint64_t* __restrict__ shift_pows,
                           const uint64_t* __restrict__ post_pows, int n_in, int log_n,
                           uint64_t scale, int do_scale) {
  extern __shared__ uint64_t x[];
  const int n = 1 << log_n;
  const uint64_t* src = in + (long long)blockIdx.x * n_in;
  uint64_t* dst = out + (long long)blockIdx.x * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int j = (int)(__brev((unsigned)i) >> (32 - log_n));
    uint64_t v = 0;
    if (j < n_in) {
      v = src[j];
      if (shift_pows != nullptr) v = gl::mul(v, shift_pows[j]);
    }
    x[i] = v;
  }
  __syncthreads();

  for (int s = 1; s <= log_n; ++s) {
    const int m = 1 << (s - 1);
    const uint64_t* tw = twiddles + (m - 1);
    for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
      int j = k & (m - 1);
      int i0 = ((k >> (s - 1)) << s) + j;
      int i1 = i0 + m;
      uint64_t u = x[i0];
      uint64_t t = gl::mul(x[i1], tw[j]);
      x[i0] = gl::add(u, t);
      x[i1] = gl::sub(u, t);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t v = do_scale ? gl::mul(x[i], scale) : x[i];
    dst[i] = post_pows != nullptr ? gl::mul(v, post_pows[i]) : v;
  }
}

}  // namespace

// in: (cols, n_in) contiguous; out: (cols, 2^log_n) contiguous, n_in <= 2^log_n.
// shift_pows: n_in felts g^j applied before the transform, or null.
// scale: applied to every output when do_scale != 0 (1/N for the inverse).
// post_pows: 2^log_n felts multiplied into output i (the coset unshift
// g^-i after an inverse transform), or null.
extern "C" int qzk_ntt(const void* in, void* out, const void* twiddles, const void* shift_pows,
                       const void* post_pows, long long cols, int n_in, int log_n, unsigned long long scale,
                       int do_scale, void* stream) {
  if (cols <= 0) return 0;
  if (log_n < 1 || log_n > 14 || n_in > (1 << log_n)) return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(uint64_t) << log_n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = (1 << log_n) / 2;
  if (threads > 512) threads = 512;
  ntt_kernel<<<(unsigned)cols, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)twiddles,
      (const uint64_t*)shift_pows, (const uint64_t*)post_pows, n_in, log_n, (uint64_t)scale, do_scale);
  return (int)cudaGetLastError();
}
