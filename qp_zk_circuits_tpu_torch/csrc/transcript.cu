// Kernels I and J: the Fiat-Shamir transcript and its proof-of-work grind
// on the card, for the fused prover (plonk/prover_fused.py).
//
// Kernel I, qzk_transcript_batch for one proof (plonk/transcript.py::
//   DeviceChallenger).
//   Replaces the JAX package's plonk/prover_fused.py::DeviceChallenger
//   (:67-155), the Poseidon2 duplex sponge (overwrite mode, rate 8) that its
//   fused graph unrolls at trace time, bit-exact with the host Challenger.
//   The transcript's state lives on the card: 20 words, the 12-felt sponge
//   state and the 8-felt input buffer. How full the input and output
//   buffers are depends only on the circuit's schedule, never on a value, so
//   the host keeps those two counts and passes them by value, as the JAX
//   package keeps its buffers as trace-time lists. One launch runs one
//   segment of the schedule: observe up to MAX_SRC device ranges in order
//   (a cap straight from its tree's buffer, the openings kernel D wrote, the
//   final polynomial through its strides, the grind's witness), each copied
//   on the way into the proof's packed output where it asks; then squeeze up
//   to MAX_SQ runs of challenges into device slots (a challenge record,
//   challenges.cuh, or the packed output), a run either felts or query
//   indices lo & (2^bits - 1); then, if asked, the last extension pair
//   times a constant (zeta_next = g * zeta).
//   Bound: the dependent chain. A duplex waits on the one before, and a
//   permutation is a chain of 30 S-boxes (4 dependent multiplies each) and
//   22 internal layers (a multiply-and-reduce each): 142 dependent field
//   multiplies of about 71 SM cycles each on an NVIDIA H100 80GB HBM3,
//   700.00 W (tools/field_latency.py, PERF.md).
//   Design: one warp, kernel 2's lane-split state (a quad of threads a
//   state, poseidon2.cuh); every quad of the warp runs the same state, so
//   the shuffles see the whole warp, and lane 0 writes. A source's felts are
//   loaded 32 at a time, a lane each (the record copy is the same coalesced
//   store), and absorbed one by one from the lanes by shuffles.
//
// Kernel I over K transcripts, qzk_transcript_batch
// (plonk/transcript.py::DeviceChallengerBatch).
//   Replaces DeviceChallenger under the JAX package's jax.vmap of the fused
//   graph (prover_fused.py:67, vmapped at :1007): K proofs of one circuit
//   run one segment in one launch. The fills are the circuit's schedule, so
//   the K transcripts share them (passed once); each source, record,
//   destination, the scale's destination and the state have a proof stride
//   beside proof 0's address, proof b reading src + b * stride and writing
//   dst + b * stride (a stride of 0 reads one source for all, the circuit
//   digest). Design: a block of one warp a transcript, K blocks, each the
//   single kernel's lane-split sponge on its own state; the single proof
//   is the batch of one. Bound: the same dependent chain as one proof while K
//   is at most the SM count (the K chains run side by side).
//
// Kernel J, qzk_grind_batch for one proof (plonk/transcript.py::
//   grind_device).
//   Replaces the JAX package's plonk/prover_fused.py::_grind_j (:296-337),
//   a lax.while_loop of 2^min(16, bits) candidate sweeps from the device
//   transcript's state: the lowest w such that observing w and drawing a
//   challenge gives a value below 2^(64 - bits). It starts from kernel I's
//   state (the input buffer over the state, w in the next input slot) and
//   loops on the card until a witness is found, with no host step.
//   Lowest-index invariant: blocks claim chunks of J_THREADS candidates in
//   increasing order (an atomic counter), a passing candidate lowers `best`
//   by atomicMin, and a block stops once its claimed chunk starts at or
//   above `best`; every chunk below the final best was claimed before any
//   chunk above it and checked in full, so best is the lowest passing
//   candidate, as a sequential search gives. A grind that finds none below
//   `limit` leaves best at 2^64 - 1, which the prover refuses at the
//   download. Bound: operations, a permutation (one thread a state, in
//   registers, as kernel 2's permute) for each candidate up to the witness;
//   a chunk claimed past it is the overshoot, at most the grid's threads.
//
// Kernel J over K grinds, qzk_grind_batch (plonk/transcript.py::
//   grind_device_batch). Replaces _grind_j under the JAX package's vmap
//   (:296, vmapped at :1007), whose while_loop masks each lane once it has
//   its witness. Each proof keeps its own (next, best) word pair; a block
//   claims chunks of one proof in increasing order through that proof's
//   counter and atomicMin's that proof's best, so each proof keeps its
//   lowest passing witness by the single grind's argument. A block whose
//   claimed chunk starts at or above its proof's best (or the limit) finds
//   the proof done, which it stays (next only grows, best only falls), and
//   moves to the next proof; it ends once it has found all K done in a row.
//   The blocks start spread over the proofs (block b on proof b % K). One
//   launch for all K, each stopping at its own witness. The single proof is
//   the batch of one. Bound: operations, a permutation for each candidate
//   up to each proof's witness, summed over the K proofs.
#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

using p2::RATE;
using p2::ROUNDS_F;
using p2::ROUNDS_P;
using p2::SPLIT;
using p2::SPLIT_SLOTS;
using p2::WIDTH;
using p2::external_linear;
using p2::sbox;

constexpr int MAX_SRC = 4;  // plonk/transcript.py::MAX_SOURCES
constexpr int MAX_SQ = 4;   // plonk/transcript.py::MAX_SQUEEZES
constexpr int SEGMENT_WORDS = 5 + 6 * MAX_SRC + 3 * MAX_SQ + 2;
// the batch entry's proof strides after a segment's words: the state's,
// each source's, each record's, each squeeze's, the scale's
constexpr int STRIDE_WORDS = 2 + 2 * MAX_SRC + MAX_SQ;
constexpr int J_THREADS = 128;
constexpr int J_BLOCKS_PER_SM = 4;

__constant__ uint64_t c_ext_rc[ROUNDS_F][WIDTH];
__constant__ uint64_t c_int_rc[ROUNDS_P];
__constant__ uint64_t c_diag[WIDTH];

// one thread a state (kernel 2's permute)
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

// a split state, thread j of the quad holding lanes j, 4 + j, 8 + j (kernel
// 2's permute_split)
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

// One segment of the schedule (plonk/transcript.py::DeviceChallenger.segment
// packs it). Source s: a (rows, cols) range read at src + r s0 + c s1,
// absorbed row by row, copied to record[] when that is set.
struct Segment {
  uint64_t* ts;
  int in_len, out_len, n_src, n_sq;
  const uint64_t* src[MAX_SRC];
  long long rows[MAX_SRC], cols[MAX_SRC], s0[MAX_SRC], s1[MAX_SRC];
  uint64_t* record[MAX_SRC];
  uint64_t* dst[MAX_SQ];
  int count[MAX_SQ], bits[MAX_SQ];
  uint64_t* scale_dst;
  uint64_t scale;
  // proof b's operands at b times these element strides from proof 0's
  long long ts_stride, src_stride[MAX_SRC], record_stride[MAX_SRC], dst_stride[MAX_SQ];
  long long scale_stride;
};

// The sponge as every thread of the warp holds it: its split lanes, the
// input buffer (uniform, in registers by unrolled selects) and the counts.
struct Sponge {
  uint64_t x[SPLIT_SLOTS];
  uint64_t in[RATE];
  int in_len, out_len, j;

  __device__ __forceinline__ void duplex() {
#pragma unroll
    for (int s = 0; s < SPLIT_SLOTS; ++s) {
      const int lane = SPLIT * s + j;
#pragma unroll
      for (int t = 0; t < RATE; ++t)
        if (t == lane && t < in_len) x[s] = in[t];
    }
    permute_split(x, j);
    in_len = 0;
    out_len = RATE;
  }

  __device__ __forceinline__ void observe(uint64_t f) {
    out_len = 0;
#pragma unroll
    for (int t = 0; t < RATE; ++t)
      if (t == in_len) in[t] = f;
    if (++in_len == RATE) duplex();
  }

  // state lane `lane` (uniform across the warp), from thread lane % 4 of each quad
  __device__ __forceinline__ uint64_t lane_value(int lane) const {
    const int s = lane / SPLIT;
    const uint64_t v = s == 0 ? x[0] : (s == 1 ? x[1] : x[2]);
    return p2::quad_shfl(v, lane % SPLIT);
  }

  __device__ __forceinline__ uint64_t challenge() {
    if (in_len > 0 || out_len == 0) duplex();
    const uint64_t v = lane_value(RATE - out_len);
    --out_len;
    return v;
  }
};

__global__ void __launch_bounds__(32) transcript_kernel(const __grid_constant__ Segment g) {
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;  // the proof
  uint64_t* const ts = g.ts + b * g.ts_stride;
  Sponge sp;
  sp.j = lane % SPLIT;
  sp.in_len = g.in_len;
  sp.out_len = g.out_len;
#pragma unroll
  for (int s = 0; s < SPLIT_SLOTS; ++s) sp.x[s] = ts[SPLIT * s + sp.j];
#pragma unroll
  for (int t = 0; t < RATE; ++t) sp.in[t] = t < g.in_len ? ts[WIDTH + t] : 0;

#pragma unroll 1
  for (int si = 0; si < g.n_src; ++si) {
    const long long cols = g.cols[si], total = g.rows[si] * cols;
    const uint64_t* const src = g.src[si] + b * g.src_stride[si];
    uint64_t* const record = g.record[si] == nullptr ? nullptr : g.record[si] + b * g.record_stride[si];
#pragma unroll 1
    for (long long base = 0; base < total; base += 32) {
      const long long i = base + lane;
      uint64_t v = 0;
      if (i < total) {
        v = src[(i / cols) * g.s0[si] + (i % cols) * g.s1[si]];
        if (record != nullptr) record[i] = v;
      }
      const int n = total - base < 32 ? (int)(total - base) : 32;
#pragma unroll 1
      for (int t = 0; t < n; ++t) sp.observe((uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)v, t));
    }
  }

  uint64_t last[2] = {0, 0};
#pragma unroll 1
  for (int q = 0; q < g.n_sq; ++q) {
    const uint64_t mask = g.bits[q] ? (1ull << g.bits[q]) - 1 : ~0ull;
    uint64_t* const dst = g.dst[q] + b * g.dst_stride[q];
#pragma unroll 1
    for (int k = 0; k < g.count[q]; ++k) {
      const uint64_t v = sp.challenge();
      last[0] = last[1];
      last[1] = v;
      if (lane == 0) dst[k] = v & mask;
    }
  }
  if (g.scale_dst != nullptr && lane == 0) {
    uint64_t* const scale_dst = g.scale_dst + b * g.scale_stride;
    scale_dst[0] = gl::mul(last[0], g.scale);
    scale_dst[1] = gl::mul(last[1], g.scale);
  }
  if (lane < SPLIT) {
#pragma unroll
    for (int s = 0; s < SPLIT_SLOTS; ++s) ts[SPLIT * s + lane] = sp.x[s];
  }
  if (lane == 0) {  // the input buffer, zero past its fill
#pragma unroll
    for (int t = 0; t < RATE; ++t) ts[WIDTH + t] = t < sp.in_len ? sp.in[t] : 0;
  }
}

// Proof p's state at words + p * words_stride: [0] the next chunk's first
// candidate, [1] the best witness; its transcript at ts + p * ts_stride.
__global__ void __launch_bounds__(J_THREADS)
    grind_kernel(const uint64_t* __restrict__ ts, long long ts_stride, int in_len, int pow_bits,
                 unsigned long long* words, long long words_stride, int count,
                 unsigned long long limit) {
  __shared__ unsigned long long s_chunk;
  __shared__ int s_go;
  __shared__ uint64_t base[WIDTH];  // proof `loaded`'s input buffer over its state
  const int shift = 64 - pow_bits;
  int p = blockIdx.x % count, loaded = -1, idle = 0;
#pragma unroll 1
  while (idle < count) {  // until all `count` proofs were found done in a row
    unsigned long long* const st = words + p * words_stride;
    if (threadIdx.x == 0) {
      const unsigned long long c = atomicAdd(&st[0], (unsigned long long)J_THREADS);
      s_chunk = c;
      s_go = c < limit && c < *(volatile unsigned long long*)&st[1];
    }
    __syncthreads();
    const unsigned long long w = s_chunk + threadIdx.x;
    const int go = s_go;
    __syncthreads();  // s_chunk and s_go are read before thread 0 writes them again
    if (!go) {  // proof p is done, and stays so: the next one
      ++idle;
      p = p + 1 == count ? 0 : p + 1;
      continue;
    }
    idle = 0;
    if (loaded != p) {  // uniform: the block's threads all read base after this barrier
      const uint64_t* const t = ts + p * ts_stride;
      if (threadIdx.x < WIDTH)
        base[threadIdx.x] = threadIdx.x < in_len ? t[WIDTH + threadIdx.x] : t[threadIdx.x];
      __syncthreads();
      loaded = p;
    }
    uint64_t x[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) x[i] = i == in_len ? w : base[i];
    permute(x);
    if (w < limit && (x[0] >> shift) == 0) atomicMin(&st[1], w);
  }
}

// A segment's words (the layout qzk_transcript_batch documents) into g, proof
// strides 0; cudaErrorInvalidValue for what the kernel cannot run.
int parse_segment(const uint64_t* w, Segment& g) {
  g = Segment{};
  g.ts = (uint64_t*)w[0];
  g.in_len = (int)w[1];
  g.out_len = (int)w[2];
  g.n_src = (int)w[3];
  g.n_sq = (int)w[4];
  if (g.ts == nullptr || g.in_len < 0 || g.in_len >= RATE || g.out_len < 0 || g.out_len > RATE ||
      g.n_src < 0 || g.n_src > MAX_SRC || g.n_sq < 0 || g.n_sq > MAX_SQ)
    return (int)cudaErrorInvalidValue;
  const uint64_t* src = w + 5;
  for (int s = 0; s < MAX_SRC; ++s, src += 6) {
    g.src[s] = (const uint64_t*)src[0];
    g.rows[s] = (long long)src[1];
    g.cols[s] = (long long)src[2];
    g.s0[s] = (long long)src[3];
    g.s1[s] = (long long)src[4];
    g.record[s] = (uint64_t*)src[5];
    if (s < g.n_src && (g.src[s] == nullptr || g.rows[s] < 0 || g.cols[s] < 1))
      return (int)cudaErrorInvalidValue;
  }
  const uint64_t* sq = w + 5 + 6 * MAX_SRC;
  for (int q = 0; q < MAX_SQ; ++q, sq += 3) {
    g.dst[q] = (uint64_t*)sq[0];
    g.count[q] = (int)sq[1];
    g.bits[q] = (int)sq[2];
    if (q < g.n_sq && (g.dst[q] == nullptr || g.count[q] < 0 || g.bits[q] < 0 || g.bits[q] > 32))
      return (int)cudaErrorInvalidValue;
  }
  g.scale_dst = (uint64_t*)sq[0];
  g.scale = sq[1];
  static_assert(5 + 6 * MAX_SRC + 3 * MAX_SQ + 2 == SEGMENT_WORDS, "the host packs these words");
  return 0;
}

int launch_grind(const void* ts, long long ts_stride, int in_len, int pow_bits, void* words,
                 long long words_stride, int count, long long limit, void* stream) {
  if (ts == nullptr || words == nullptr || in_len < 0 || in_len >= RATE || pow_bits < 1 ||
      pow_bits > 32 || limit < 1 || count < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  grind_kernel<<<sms * J_BLOCKS_PER_SM, J_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)ts, ts_stride, in_len, pow_bits, (unsigned long long*)words, words_stride,
      count, (unsigned long long)limit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qzk_transcript_set_constants(const void* ext_rc, const void* int_rc,
                                            const void* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(c_ext_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(c_int_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag));
  return (int)e;
}

// `count` transcripts of one schedule (1 for the single proof's): words,
// host uint64 (SEGMENT_WORDS + STRIDE_WORDS,): proof 0's segment, that is
// its device state (20 words), the input and output buffers' fill (shared
// by all), the source and squeeze counts, MAX_SRC sources (address, rows,
// cols, row stride, col stride, record address or 0), MAX_SQ squeezes
// (address, count, index bits or 0), the scale's address (or 0) and
// factor; then the proof strides in int64 elements: the state's, each
// source's, each record's, each squeeze's, the scale's. One launch of
// `count` one-warp blocks.
extern "C" int qzk_transcript_batch(const void* words, int count, void* stream) {
  const uint64_t* w = (const uint64_t*)words;
  Segment g;
  const int err = parse_segment(w, g);
  if (err) return err;
  if (count < 1) return (int)cudaErrorInvalidValue;
  const uint64_t* st = w + SEGMENT_WORDS;
  g.ts_stride = (long long)st[0];
  for (int s = 0; s < MAX_SRC; ++s) {
    g.src_stride[s] = (long long)st[1 + s];
    g.record_stride[s] = (long long)st[1 + MAX_SRC + s];
  }
  for (int q = 0; q < MAX_SQ; ++q) g.dst_stride[q] = (long long)st[1 + 2 * MAX_SRC + q];
  g.scale_stride = (long long)st[1 + 2 * MAX_SRC + MAX_SQ];
  static_assert(2 + 2 * MAX_SRC + MAX_SQ == STRIDE_WORDS, "the host packs these words");
  transcript_kernel<<<count, 32, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// `count` grinds of one schedule (1 for the single proof's): proof p's
// transcript state (20 words) at ts + p * ts_stride, its (next candidate,
// best witness) words at words + p * words_stride (int64 elements), each
// (0, 2^64 - 1) at the start; the input buffer's fill in_len (below 8) and
// the candidate limit shared. One launch of J_BLOCKS_PER_SM blocks an SM
// for all of them, looping on the card.
extern "C" int qzk_grind_batch(const void* ts, long long ts_stride, int in_len, int pow_bits,
                               void* words, long long words_stride, int count, long long limit,
                               void* stream) {
  return launch_grind(ts, ts_stride, in_len, pow_bits, words, words_stride, count, limit, stream);
}
