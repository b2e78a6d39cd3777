// Kernel 2: Poseidon2 over Goldilocks, width 12 (rate 8, 4-felt digest, x^7).
//
// Replaces the XLA-compiled jnp functions hash/poseidon2.py::permute_j,
// hash_no_pad_j and two_to_one_j of the JAX package (with
// hash/merkle.py::_leaf_hash_j), which carried each lane as a u32 pair and
// ran the rounds under lax.scan.
//
// Design: one thread per state, the 12 lanes in registers for the whole
// permutation (initial external matrix, 4 full rounds, 22 partial rounds,
// 4 full rounds). Round constants and the internal diagonal sit in
// __constant__ memory; they are uploaded once from the port's Grain-LFSR
// derived tables (qzk_poseidon2_set_constants), so no table is written here.
// The S-box and the linear layers live in poseidon2.cuh, shared with the
// Poseidon2 gate of kernel A (quotient.cu).
//
// Bound on the H100: operations. One permutation is about 500 field
// multiplies (118 S-boxes of 4 multiplies plus the internal diagonal), each a
// few 64-bit integer instructions, against 96 or 128 input bytes, so the
// integer pipes and not memory bound it. Rows of a leaf matrix are read with
// arbitrary strides so a column-major LDE is hashed without a transpose copy.
#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

using p2::DIGEST;
using p2::RATE;
using p2::ROUNDS_F;
using p2::ROUNDS_P;
using p2::WIDTH;
using p2::external_linear;
using p2::sbox;

__constant__ uint64_t c_ext_rc[ROUNDS_F][WIDTH];
__constant__ uint64_t c_int_rc[ROUNDS_P];
__constant__ uint64_t c_diag[WIDTH];

__device__ void permute(uint64_t* x) {
  external_linear(x);
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) x[i] = sbox(gl::add(x[i], c_ext_rc[r][i]));
    external_linear(x);
  }
  for (int r = 0; r < ROUNDS_P; ++r) {
    x[0] = sbox(gl::add(x[0], c_int_rc[r]));
    p2::internal_linear(x, c_diag);
  }
  for (int r = 4; r < ROUNDS_F; ++r) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) x[i] = sbox(gl::add(x[i], c_ext_rc[r][i]));
    external_linear(x);
  }
}

__global__ void permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                               long long batch) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) x[i] = in[b * WIDTH + i];
  permute(x);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[b * WIDTH + i] = x[i];
}

// Overwrite-mode sponge over one row (hash_no_pad); rows of <= 4 felts pass
// through zero-padded, unhashed (hash_or_noop).
__global__ void hash_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                 long long rows, int cols, long long row_stride,
                                 long long col_stride) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint64_t* row = in + r * row_stride;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) x[i] = 0;
  if (cols <= DIGEST) {
    for (int i = 0; i < cols; ++i) x[i] = row[i * col_stride];
  } else {
    for (int start = 0; start < cols; start += RATE) {
      int len = cols - start < RATE ? cols - start : RATE;
      for (int i = 0; i < len; ++i) x[i] = row[(long long)(start + i) * col_stride];
      permute(x);
    }
  }
#pragma unroll
  for (int i = 0; i < DIGEST; ++i) out[r * DIGEST + i] = x[i];
}

// state = [left(4) | right(4) | 0(4)], one permutation, digest = lanes 0..3.
__global__ void two_to_one_kernel(const uint64_t* __restrict__ left, long long left_stride,
                                  const uint64_t* __restrict__ right, long long right_stride,
                                  uint64_t* __restrict__ out, long long batch) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t x[WIDTH];
#pragma unroll
  for (int i = 0; i < DIGEST; ++i) {
    x[i] = left[b * left_stride + i];
    x[DIGEST + i] = right[b * right_stride + i];
    x[2 * DIGEST + i] = 0;
  }
  permute(x);
#pragma unroll
  for (int i = 0; i < DIGEST; ++i) out[b * DIGEST + i] = x[i];
}

constexpr int THREADS = 128;

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int qzk_poseidon2_set_constants(const void* ext_rc, const void* int_rc,
                                           const void* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(c_ext_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(c_int_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag));
  return (int)e;
}

extern "C" int qzk_poseidon2_permute(const void* in, void* out, long long batch, void* stream) {
  if (batch <= 0) return 0;
  permute_kernel<<<blocks_for(batch), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}

extern "C" int qzk_poseidon2_hash_rows(const void* in, void* out, long long rows, int cols,
                                       long long row_stride, long long col_stride,
                                       void* stream) {
  if (rows <= 0) return 0;
  hash_rows_kernel<<<blocks_for(rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, rows, cols, row_stride, col_stride);
  return (int)cudaGetLastError();
}

extern "C" int qzk_poseidon2_two_to_one(const void* left, long long left_stride,
                                        const void* right, long long right_stride, void* out,
                                        long long batch, void* stream) {
  if (batch <= 0) return 0;
  two_to_one_kernel<<<blocks_for(batch), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)left, left_stride, (const uint64_t*)right, right_stride,
      (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}
