// Kernel 2: Poseidon2 over Goldilocks, width 12 (rate 8, 4-felt digest, x^7),
// and the Merkle tree built on it.
//
// Replaces the XLA-compiled jnp functions hash/poseidon2.py::permute_j,
// hash_no_pad_j and two_to_one_j of the JAX package, with
// hash/merkle.py::_leaf_hash_j and build_levels_j (the whole tree), which
// carried each lane as a u32 pair and ran the rounds under lax.scan.
//
// Bound on the H100: operations. One permutation is about 500 field
// multiplies (118 S-boxes of 4 multiplies plus the internal diagonal), each a
// few 64-bit integer instructions, against 96 or 128 input bytes. But a leaf
// commit is small: 2048 rows, each a sponge of 17 permutations in series,
// then 7 tree levels, each one permutation deep. With one thread a state the
// whole launch is 64 warps, one on each of 64 sub-partitions of the card's
// 528, so it runs at the issue rate of one warp per state chain, far above
// the operations bound.
//
// Design: two forms of the permutation, the same arithmetic.
//  * one thread a state: the 12 lanes in registers. `permute` (the grind's
//    2^17 states, a launch that fills the card) runs it;
//  * lane-split (poseidon2.cuh): a quad of threads holds a state, one lane of
//    each M4 group a thread, so a full round is 3 S-boxes a thread instead of
//    12 and the leaf's 2048 rows run as 256 warps instead of 64. The row hash,
//    the 2-to-1 and the tree run it.
// A Merkle tree is one call (a forest of one): a first launch where each block hashes a run of
// rows and reduces its subtree in shared memory, writing every level, and a
// second launch (only if levels are left) where a block per cap node reduces
// the rest through the output buffer. Rows are read in place through
// (row_stride, col_stride), so a column-major LDE needs no transpose copy,
// and neighbouring rows' threads read neighbouring addresses.
//
// A forest is K trees of one shape in the same call and the same two
// launches (the batch of K proofs' commits, which the JAX package's
// prove_fused_batch vmaps at plonk/prover_fused.py:1007): the grid's second
// axis is the tree, tree t reads its rows at t * tree_stride and writes its
// levels at t times one tree's nodes. At the leaf a single tree's 2048 rows
// fill only 256 of the card's blocks of 8 rows; sixteen trees give the first
// launch 2048 blocks, or 512 of 64 rows with six levels each in the block.
//
// Round constants and the internal diagonal sit in __constant__ memory,
// uploaded once a device from the port's Grain-LFSR tables
// (qzk_poseidon2_set_constants); the S-box and linear layers live in
// poseidon2.cuh, shared with the Poseidon2 gate of kernel A (quotient.cu).
#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

using p2::DIGEST;
using p2::RATE;
using p2::ROUNDS_F;
using p2::ROUNDS_P;
using p2::SPLIT;
using p2::SPLIT_SLOTS;
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

// The same permutation on a split state (thread j of the quad, lanes j, 4 + j,
// 8 + j). Thread 0 holds lane 0, so its S-box is the partial rounds' one; the
// other threads compute it too and drop it, which keeps the warp converged.
__device__ void permute_split(uint64_t* x, int j) {
  uint64_t d[SPLIT_SLOTS];
#pragma unroll
  for (int s = 0; s < SPLIT_SLOTS; ++s) d[s] = c_diag[SPLIT * s + j];
  p2::external_linear_split(x, j);
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int s = 0; s < SPLIT_SLOTS; ++s) x[s] = sbox(gl::add(x[s], c_ext_rc[r][SPLIT * s + j]));
    p2::external_linear_split(x, j);
  }
  for (int r = 0; r < ROUNDS_P; ++r) {
    const uint64_t s0 = sbox(gl::add(x[0], c_int_rc[r]));
    x[0] = j == 0 ? s0 : x[0];
    p2::internal_linear_split(x, d);
  }
  for (int r = 4; r < ROUNDS_F; ++r) {
#pragma unroll
    for (int s = 0; s < SPLIT_SLOTS; ++s) x[s] = sbox(gl::add(x[s], c_ext_rc[r][SPLIT * s + j]));
    p2::external_linear_split(x, j);
  }
}

// Threads past the last state still run the permutation on zeros, so a
// quad's shuffles always see the whole warp; a warp wholly past the end exits.
__device__ __forceinline__ bool warp_past(long long gid, long long states) {
  return (gid - (threadIdx.x & 31)) / SPLIT >= states;
}

// Overwrite-mode sponge over one row (hash_no_pad) on a split state; rows of
// <= 4 felts pass through zero-padded, unhashed (hash_or_noop). The digest is
// lanes 0..3, slot 0 of the quad's four threads.
__device__ __forceinline__ void hash_row(uint64_t* x, const uint64_t* __restrict__ in,
                                         long long r, bool valid, int cols, long long row_stride,
                                         long long col_stride, int j) {
  const uint64_t* row = in + (valid ? r : 0) * row_stride;
#pragma unroll
  for (int s = 0; s < SPLIT_SLOTS; ++s) x[s] = 0;
  if (cols <= DIGEST) {
    if (valid && j < cols) x[0] = row[j * col_stride];
    return;
  }
  for (int start = 0; start < cols; start += RATE) {
    const int len = cols - start < RATE ? cols - start : RATE;
#pragma unroll
    for (int s = 0; s < SPLIT_SLOTS; ++s) {
      const int lane = SPLIT * s + j;
      if (valid && lane < len) x[s] = row[(long long)(start + lane) * col_stride];
    }
    permute_split(x, j);
  }
}

// A split 2-to-1 state from two digests: [left(4) | right(4) | 0(4)].
__device__ __forceinline__ void load_pair(uint64_t* x, const uint64_t* left, const uint64_t* right,
                                          bool valid, int j) {
  x[0] = valid ? left[j] : 0;
  x[1] = valid ? right[j] : 0;
  x[2] = 0;
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

__global__ void hash_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                 long long rows, int cols, long long row_stride,
                                 long long col_stride) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (warp_past(gid, rows)) return;
  const long long r = gid / SPLIT;
  const int j = (int)(gid % SPLIT);
  const bool valid = r < rows;
  uint64_t x[SPLIT_SLOTS];
  hash_row(x, in, r, valid, cols, row_stride, col_stride, j);
  if (valid) out[r * DIGEST + j] = x[0];
}

__global__ void two_to_one_kernel(const uint64_t* __restrict__ left, long long left_stride,
                                  const uint64_t* __restrict__ right, long long right_stride,
                                  uint64_t* __restrict__ out, long long batch) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (warp_past(gid, batch)) return;
  const long long b = gid / SPLIT;
  const int j = (int)(gid % SPLIT);
  const bool valid = b < batch;
  const long long bb = valid ? b : 0;
  uint64_t x[SPLIT_SLOTS];
  load_pair(x, left + bb * left_stride, right + bb * right_stride, valid, j);
  permute_split(x, j);
  if (valid) out[b * DIGEST + j] = x[0];
}

// The tree runs the lane-split form at every size: with one thread a state
// its blocks hold their registers through the long subtree levels, and that
// tree measured 1.4-1.8x slower than the lane-split one from 2^11 to 2^19
// rows (PERF.md).
constexpr int TREE_MAX_RUN = 64;    // rows a block of the first launch: 256 threads
constexpr int TREE_MAX_STATES = 128;  // states a block of the second launch: 512 threads

// The tree's first launch: block b hashes rows [b run, (b + 1) run), one state
// a row, writes the leaf digests, then reduces `levels` levels of its subtree
// through shared memory, writing each level's nodes after the levels below
// (level l has rows >> l nodes; out is every level, one after the other).
// Tree blockIdx.y of a forest: its rows at in + blockIdx.y * tree_stride, its
// levels at out + blockIdx.y * tree_nodes * DIGEST.
__global__ void tree_leaves_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                   long long rows, int cols, long long row_stride,
                                   long long col_stride, int run, int levels,
                                   long long tree_stride, long long tree_nodes) {
  __shared__ uint64_t sh[TREE_MAX_RUN][DIGEST];
  in += blockIdx.y * tree_stride;
  out += blockIdx.y * tree_nodes * DIGEST;
  const int q = threadIdx.x / SPLIT;
  const int j = threadIdx.x % SPLIT;
  const int warp_first = (threadIdx.x & ~31) / SPLIT;
  const long long r = (long long)blockIdx.x * run + q;
  const bool valid = q < run && r < rows;
  uint64_t x[SPLIT_SLOTS];
  hash_row(x, in, r, valid, cols, row_stride, col_stride, j);
  if (valid) {
    out[r * DIGEST + j] = x[0];
    sh[q][j] = x[0];
  }
  long long off = 0, n = rows;  // the current level's first node and size
  int active = run;             // this block's nodes on the current level
  for (int t = 1; t <= levels; ++t) {
    off += n;
    n >>= 1;
    active >>= 1;
    __syncthreads();
    const bool on = q < active;
    load_pair(x, sh[on ? 2 * q : 0], sh[on ? 2 * q + 1 : 0], on, j);
    __syncthreads();
    if (warp_first < active) {
      permute_split(x, j);
      if (on) {
        out[(off + (long long)blockIdx.x * active + q) * DIGEST + j] = x[0];
        sh[q][j] = x[0];
      }
    }
  }
}

// The tree's second launch: the level at node `off` has n nodes; block b
// reduces its 2^levels of them to one node, level by level through `buf`
// (written by this block's own threads, so no read-only cache path: the
// barrier makes one level's stores visible to the next level's loads).
__global__ void tree_levels_kernel(uint64_t* buf, long long off, long long n, int levels,
                                   long long tree_nodes) {
  buf += blockIdx.y * tree_nodes * DIGEST;
  const int q = threadIdx.x / SPLIT;
  const int j = threadIdx.x % SPLIT;
  const int states = blockDim.x / SPLIT;
  const int warp_first = (threadIdx.x & ~31) / SPLIT;
  long long active = 1ll << levels;
  for (int t = 1; t <= levels; ++t) {
    const uint64_t* src = buf + (off + (long long)blockIdx.x * active) * DIGEST;
    off += n;
    n >>= 1;
    active >>= 1;
    uint64_t* dst = buf + (off + (long long)blockIdx.x * active) * DIGEST;
    for (long long i0 = 0; i0 + warp_first < active; i0 += states) {
      const long long i = i0 + q;
      const bool on = i < active;
      uint64_t x[SPLIT_SLOTS];
      const long long ii = on ? i : 0;
      load_pair(x, src + 2 * ii * DIGEST, src + (2 * ii + 1) * DIGEST, on, j);
      permute_split(x, j);
      if (on) dst[i * DIGEST + j] = x[0];
    }
    __syncthreads();
  }
}

constexpr int THREADS = 128;

// Blocks for `threads` threads (one a state, or SPLIT).
unsigned blocks_for(long long threads) { return (unsigned)((threads + THREADS - 1) / THREADS); }

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
  hash_rows_kernel<<<blocks_for(rows * SPLIT), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, rows, cols, row_stride, col_stride);
  return (int)cudaGetLastError();
}

extern "C" int qzk_poseidon2_two_to_one(const void* left, long long left_stride,
                                        const void* right, long long right_stride, void* out,
                                        long long batch, void* stream) {
  if (batch <= 0) return 0;
  two_to_one_kernel<<<blocks_for(batch * SPLIT), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)left, left_stride, (const uint64_t*)right, right_stride,
      (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}

// A tree, or a forest of `trees` trees, in one or two launches (the second only when
// levels_left > 0): each tree's rows (a power of two) of `cols` felts read
// through the strides, tree t's first row at t * tree_stride; `run` rows a
// block of the first launch reducing `levels_in_block` levels, then one block
// a cap node reducing `levels_left` levels. `out` holds each tree's levels in
// order, one tree after the other.
extern "C" int qzk_poseidon2_merkle_forest(const void* in, void* out, long long trees,
                                           long long tree_stride, long long rows, int cols,
                                           long long row_stride, long long col_stride, int run,
                                           int levels_in_block, int levels_left, void* stream) {
  if (rows <= 0 || trees <= 0) return 0;
  if (run < 1 || run > TREE_MAX_RUN || rows % run != 0 || (1 << levels_in_block) > run ||
      levels_left < 0 || (rows >> levels_in_block) < (1ll << levels_left) || trees > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto dst = (uint64_t*)out;
  long long nodes = 0;  // one tree's nodes, every level
  for (long long n = rows; n >= (rows >> (levels_in_block + levels_left)) && n > 0; n >>= 1)
    nodes += n;
  const int leaf_states = run < 32 / SPLIT ? 32 / SPLIT : run;
  tree_leaves_kernel<<<dim3((unsigned)(rows / run), (unsigned)trees), leaf_states * SPLIT, 0, s>>>(
      (const uint64_t*)in, dst, rows, cols, row_stride, col_stride, run, levels_in_block,
      tree_stride, nodes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || levels_left == 0) return (int)e;
  long long off = 0, n = rows;  // the level the second launch starts from
  for (int t = 0; t < levels_in_block; ++t) {
    off += n;
    n >>= 1;
  }
  // as many states as the subtree's first level has nodes, one warp at least
  const long long half = 1ll << (levels_left - 1);
  const int states =
      (int)(half < 32 / SPLIT ? 32 / SPLIT : half > TREE_MAX_STATES ? TREE_MAX_STATES : half);
  tree_levels_kernel<<<dim3((unsigned)(n >> levels_left), (unsigned)trees), states * SPLIT, 0, s>>>(
      dst, off, n, levels_left, nodes);
  return (int)cudaGetLastError();
}
