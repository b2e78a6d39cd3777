// Kernel A: the fused vanishing evaluation of the PLONK quotient.
//
// Replaces the device work of the JAX package's plonk/prover.py::quotient_run
// (its `run`, the gates' eval_batched chains, the permutation transitions and
// the alpha sum) up to the iNTT. For each point x of the LDE coset and each
// challenge c it computes
//
//   out_c(x) = (1 / Z_H(x)) * sum_k alpha_c^k * C_k(x)
//
// over the canonical constraint list of plonk/vanishing.py::eval_constraints:
// every gate type's constraints masked by its selector column, then per
// challenge the boundary L1 * (Z - 1) and the chunked permutation
// transitions nxt * D_j - prev * N_j. The field is exact, so summing in any
// order gives the canonical value, and the proof bytes do not change.
//
// Design: the constraint list is cut into groups, one per row of a
// descriptor table built once per circuit (plonk/prover.py::
// quotient_descriptors): each gate type is one group, and the permutation
// part of each challenge is one. A row also gives the group's threads a
// point (1, or 4 for the Poseidon2 gate and the permutation rows) and its
// first block, so one launch covers every group with blocks of 128 threads;
// a group has at most QUOTIENT_GROUP_BLOCKS blocks, which loop over tiles of
// points past that. Each block first forms the alpha_c^k of its group's
// constraints in shared memory from the challenges, read with the betas,
// gammas and the PI hash from the proof's challenge record in device memory
// (challenges.cuh: the fused prover's transcript writes it on the card, the
// staged prover uploads its host draws into one). Its threads then evaluate
// their points in registers,
// reading the wire, constant and Z rows of the (C, m) LDE matrices in place
// (k_i * x is formed in registers), add the lanes' alpha-weighted sums with
// warp shuffles and write (G, nc, m) partial sums. A second launch adds the
// G partials and multiplies by 1/Z_H.
//
// The Poseidon2 gate runs over a quad of threads a point, in kernel 2's
// lane-split layout (thread j holds lanes j, 4 + j, 8 + j): each external
// round's constraints take the linear layer of the previous round's wires,
// so the eight external rounds are independent; the 22 internal rounds are
// the one chain, through the linear layer with lane 0 replaced by a wire, and
// their S-boxes run after it, a quarter on each thread. A permutation row
// spreads its chunks over four threads: each chunk's transition reads its
// prev and nxt columns from the Z and partial-product LDE.
//
// Bound on the H100: integer operations. The function needs about 2,600
// field multiplies and 2,200 adds a point of the leaf (Poseidon2 gate,
// permutation products, the alpha sums) against about 2 KB of reads;
// chip_smoke.py::quotient_field_ops counts both from the descriptor table.
// This kernel spends a little more: k_i * x once per challenge, the alpha
// tables and the G-partial sum. At the leaf (m = 2048) the card is far from
// that bound: each SM holds a few warps, a dependent field multiply takes
// about 71 cycles, and the code is fetched cold, so the kernel keeps its
// loops rolled, its challenge count a template parameter (an emit spends
// exactly nc multiplies) and its reads batched ahead of their use.
//
// A batch of proofs (the JAX package's vmap of the fused prover,
// plonk/prover_fused.py:1007) is the grid's second axis: proof p reads its
// wire and Z rows at p times their proof strides and writes its partials
// and output after the proofs before it; the constants, selectors, sigmas,
// domain tables and descriptors are the circuit's, read by every proof.
// Each proof's alphas, betas, gammas and PI hash are its record's first 16
// words, records `ch_stride` words apart, for at most MAX_PROOFS proofs a
// launch: the wrapper splits a larger batch into launches of at most
// MAX_PROOFS. At the leaf one proof's 2048 points fill a fraction of
// the card; sixteen fill sixteen times the blocks in one launch.
#include <cuda_runtime.h>

#include "challenges.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int MAX_NC = 4;
constexpr int DESC_W = 8;  // plonk/prover.py::DESC_WIDTH
constexpr int THREADS = 128;  // plonk/prover.py::QUOTIENT_THREADS
constexpr int MAX_SHARED = 48 * 1024;
constexpr int BATCH = 4;  // a permutation chunk's reads in flight a thread
constexpr int MAX_PROOFS = 16;  // plonk/prover.py::PROOFS_PER_LAUNCH

// descriptor columns: type, p0, p1, p2, selector row (or -1), first
// constraint index, threads a point, first block
enum : int { D_TYPE = 0, D_P0, D_P1, D_P2, D_SEL, D_FIRST, D_LANES, D_BLOCK };

// The type ids are those of plonk/gates.py::GATE_TYPE_IDS and
// PERMUTATION_TYPE_ID, the one table of them: change them there and here
// together (chip_smoke.py's op counts key on that table).
enum : int {
  T_NOOP = 0,
  T_ARITH = 1,      // p0 = num_ops
  T_CONST = 2,      // p0 = num_consts
  T_PUBLIC_INPUT = 3,
  T_POSEIDON2 = 4,  // 4 threads a point
  T_REDUCING = 5,   // p0 = num_coeffs, p1 = ext, p2 = scratch
  T_BASE_SUM = 6,   // p0 = num_bits
  T_PERMUTATION = 7 // p0 = challenge; any power of two threads a point
};

// Poseidon2Gate wire layout (plonk/gates.py) and its constraint order
constexpr int W_IN = 0, W_OUT = 12, W_EXT_A = 24, W_INT = 72, W_EXT_B = 94;
constexpr int K_INT = 48, K_EXT_B = 70, K_OUT = 106;

__constant__ uint64_t c_ext_rc[p2::ROUNDS_F][p2::WIDTH];
__constant__ uint64_t c_int_rc[p2::ROUNDS_P];
__constant__ uint64_t c_diag[p2::WIDTH];

// one proof's challenges and PI hash: the first 16 words of its record
struct Challenges {
  uint64_t alpha[MAX_NC], beta[MAX_NC], gamma[MAX_NC], pi[4];
};
static_assert(rec::ALPHA == 0 && rec::BETA == MAX_NC && rec::GAMMA == 2 * MAX_NC &&
                  rec::PI == 3 * MAX_NC && sizeof(Challenges) == 16 * sizeof(uint64_t),
              "Challenges mirrors the record's first 16 words");

struct Args {
  const uint64_t* wires;   // proof p's (num_wires, m) at p * wire_stride
  const uint64_t* consts;  // (nconst + nsel + nr, m): constants, selectors, sigmas
  const uint64_t* zpp;     // proof p's (nc + nc * npp, m): Z per challenge, then partial products
  const uint64_t* xs;      // (m,) the coset points
  const uint64_t* l1;      // (m,) L_1(x)
  const uint64_t* ks;      // (nr,) coset shifts k_i
  const int* desc;         // (G, DESC_W)
  uint64_t* partial;       // (proofs, G, nc, m)
  long long wire_stride, zpp_stride;
  int m, rate, nr, qdf, npp, nc, nconst, nsel, K, groups, blocks;
  const uint64_t* ch;      // proof p's challenge record at p * ch_stride
  long long ch_stride;
};

// One point of one group on one thread: operand reads, and the
// alpha-weighted sums of the constraints this thread evaluates, one a
// challenge (NC of them, a compile-time count, so an emit spends no
// multiply on a challenge the circuit does not have).
template <int NC>
struct Point {
  const Args& a;
  const uint64_t* wires;  // this proof's rows
  const uint64_t* zpp_rows;
  const Challenges& ch;
  int x;
  const uint64_t* apow;  // (nc, count) alpha_c^(first + i), shared memory
  int count;
  int k;  // the next constraint of `emit`, relative to the group's first
  uint64_t acc[NC];

  __device__ __forceinline__ uint64_t wire(int i) const {
    return __ldg(wires + (long long)i * a.m + x);
  }
  __device__ __forceinline__ uint64_t constant(int row) const {
    return __ldg(a.consts + (long long)row * a.m + x);
  }
  __device__ __forceinline__ uint64_t zpp(int row, int at) const {
    return __ldg(zpp_rows + (long long)row * a.m + at);
  }
  // acc_c += alpha_c^(first + i) * con
  __device__ __forceinline__ void emit_at(int i, uint64_t con) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = gl::add(acc[c], gl::mul(con, apow[c * count + i]));
  }
  __device__ __forceinline__ void emit(uint64_t con) { emit_at(k++, con); }
};

template <class P>
__device__ __forceinline__ void eval_arith(P& p, int num_ops) {
  const uint64_t c0 = p.constant(0), c1 = p.constant(1);
#pragma unroll 4
  for (int i = 0; i < num_ops; ++i) {
    uint64_t t = gl::mul(c0, gl::mul(p.wire(4 * i), p.wire(4 * i + 1)));
    t = gl::add(t, gl::mul(c1, p.wire(4 * i + 2)));
    p.emit(gl::sub(p.wire(4 * i + 3), t));
  }
}

// The first wire of external round r (0..6) of the Poseidon2 gate, or of
// its output for r = 7; the internal rounds' 22 wires and constraints sit
// between rounds 3 and 4.
__device__ __forceinline__ int poseidon2_wire(int r) {
  return r < 4 ? W_EXT_A + p2::WIDTH * r : r < 7 ? W_EXT_B + p2::WIDTH * (r - 4) : W_OUT;
}

// The internal rounds of thread j: the one chain, through the linear layer
// with lane 0 (thread 0's slot 0) replaced by the round's wire. Thread 0
// keeps each round's S-box input in shared memory; after the chain thread j
// evaluates the constraints of the rounds r = j (mod 4).
template <class P>
__device__ __forceinline__ void poseidon2_internal(P& p, uint64_t* s, int j,
                                                   uint64_t (*held)[p2::ROUNDS_P], int slot) {
  const uint64_t d[p2::SPLIT_SLOTS] = {c_diag[j], c_diag[4 + j], c_diag[8 + j]};
  uint64_t w = p.wire(W_INT);
#pragma unroll 1
  for (int r = 0; r < p2::ROUNDS_P; ++r) {
    const uint64_t nw = p.wire(W_INT + min(r + 1, p2::ROUNDS_P - 1));
    if (j == 0) {
      held[slot][r] = s[0];
      s[0] = w;
    }
    p2::internal_linear_split(s, d);
    w = nw;
  }
  __syncwarp();
  w = p.wire(W_INT + j);
#pragma unroll 1
  for (int r = j; r < p2::ROUNDS_P; r += p2::SPLIT) {
    const uint64_t nw = p.wire(W_INT + min(r + p2::SPLIT, p2::ROUNDS_P - 1));
    p.emit_at(K_INT + r, gl::sub(w, p2::sbox(gl::add(held[slot][r], c_int_rc[r]))));
    w = nw;
  }
  __syncwarp();  // held is free for the block's next tile
}

// Thread j = 0..3 of the point's quad (point `slot` of the block); every
// thread of the warp takes part (the layers shuffle across the full warp).
// One loop turn an external round, the eighth folded into the output
// constraint, the internal rounds after the fourth: at the leaf a block
// holds few warps and the kernel's time follows the code it fetches, so the
// rounds share one copy of their code. Each round's constraints take the
// linear layer of the previous round's wires; the next round's wires are
// read while this one computes.
template <class P>
__device__ __forceinline__ void eval_poseidon2(P& p, int j, uint64_t (*held)[p2::ROUNDS_P],
                                               int slot) {
  uint64_t s[p2::SPLIT_SLOTS], w[p2::SPLIT_SLOTS];
#pragma unroll
  for (int q = 0; q < p2::SPLIT_SLOTS; ++q) {
    s[q] = p.wire(W_IN + p2::SPLIT * q + j);
    w[q] = p.wire(W_EXT_A + p2::SPLIT * q + j);
  }
  p2::external_linear_split(s, j);
#pragma unroll 1
  for (int r = 0; r < p2::ROUNDS_F; ++r) {
    const int next = poseidon2_wire(min(r + 1, p2::ROUNDS_F - 1));
    const int k = r < 4 ? p2::WIDTH * r : K_EXT_B + p2::WIDTH * (r - 4);
    uint64_t nw[p2::SPLIT_SLOTS];
#pragma unroll
    for (int q = 0; q < p2::SPLIT_SLOTS; ++q) {
      const int lane = p2::SPLIT * q + j;
      nw[q] = p.wire(next + lane);
      const uint64_t t = p2::sbox(gl::add(s[q], c_ext_rc[r][lane]));
      if (r < p2::ROUNDS_F - 1) {
        p.emit_at(k + lane, gl::sub(w[q], t));
        s[q] = w[q];
      } else {
        s[q] = t;
      }
    }
    p2::external_linear_split(s, j);
#pragma unroll
    for (int q = 0; q < p2::SPLIT_SLOTS; ++q) w[q] = nw[q];
    if (r == 3) poseidon2_internal(p, s, j, held, slot);
  }
  // the output: round 8's state against the output wires
#pragma unroll
  for (int q = 0; q < p2::SPLIT_SLOTS; ++q) {
    p.emit_at(K_OUT + p2::SPLIT * q + j, gl::sub(w[q], s[q]));
  }
}

// Horner steps over F_p[X]/(X^2 - 7): acc' = acc * alpha + coeff.
template <class P>
__device__ __forceinline__ void eval_reducing(P& p, int num_coeffs, int ext, int scratch) {
  const uint64_t a0 = p.wire(0), a1 = p.wire(1);
  uint64_t p0 = p.wire(2), p1 = p.wire(3);
#pragma unroll 4
  for (int k = 0; k < num_coeffs; ++k) {
    const int cw = 6 + (ext ? 2 : 1) * k;
    const int o0 = (k == num_coeffs - 1) ? 4 : scratch + 2 * k;
    uint64_t t0 = gl::add(gl::mul(p0, a0), gl::mul(gl::mul(p1, a1), 7));
    t0 = gl::add(t0, p.wire(cw));
    uint64_t t1 = gl::add(gl::mul(p0, a1), gl::mul(p1, a0));
    if (ext) t1 = gl::add(t1, p.wire(cw + 1));
    const uint64_t w0 = p.wire(o0), w1 = p.wire(o0 + 1);
    p.emit(gl::sub(w0, t0));
    p.emit(gl::sub(w1, t1));
    p0 = w0;
    p1 = w1;
  }
}

template <class P>
__device__ __forceinline__ void eval_base_sum(P& p, int num_bits) {
  uint64_t sum = 0, pw = 1;
#pragma unroll 4
  for (int i = 0; i < num_bits; ++i) {
    const uint64_t b = p.wire(1 + i);
    p.emit(gl::mul(b, gl::sub(b, 1)));
    sum = gl::add(sum, gl::mul(b, pw));
    pw = gl::add(pw, pw);
  }
  p.emit(gl::sub(p.wire(0), sum));
}

// Challenge c's boundary (thread 0) and its chunks j = lane, lane + lanes, ..
template <class P>
__device__ __forceinline__ void eval_permutation(P& p, int c, int lane, int lanes) {
  const Args& a = p.a;
  const uint64_t beta = p.ch.beta[c], gamma = p.ch.gamma[c];
  const uint64_t x = __ldg(a.xs + p.x);
  const uint64_t z = p.zpp(c, p.x);
  if (lane == 0) p.emit_at(0, gl::mul(__ldg(a.l1 + p.x), gl::sub(z, 1)));
  const int nchunks = (a.nr + a.qdf - 1) / a.qdf;
#pragma unroll 1
  for (int j = lane; j < nchunks; j += lanes) {
    uint64_t num = 1, den = 1;
    const int end = min(a.nr, (j + 1) * a.qdf);
#pragma unroll 1
    for (int i0 = j * a.qdf; i0 < end; i0 += BATCH) {
      // a batch's reads issued together
      uint64_t w[BATCH], k[BATCH], sg[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = min(i0 + u, end - 1);
        w[u] = p.wire(i);
        k[u] = __ldg(a.ks + i);
        sg[u] = p.constant(a.nconst + a.nsel + i);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i0 + u < end) {
          num = gl::mul(num, gl::add(gl::add(w[u], gl::mul(beta, gl::mul(k[u], x))), gamma));
          den = gl::mul(den, gl::add(gl::add(w[u], gl::mul(beta, sg[u])), gamma));
        }
      }
    }
    // prev is Z or the last partial product; Z(g x) is the LDE row shifted by the rate
    const int pp = a.nc + c * a.npp + j;
    const uint64_t prev = j == 0 ? z : p.zpp(pp - 1, p.x);
    const uint64_t nxt = j == nchunks - 1 ? p.zpp(c, (p.x + a.rate) % a.m) : p.zpp(pp, p.x);
    p.emit_at(1 + j, gl::sub(gl::mul(nxt, den), gl::mul(prev, num)));
  }
}

// At least four blocks an SM: that bound keeps every NC's registers unspilled.
template <int NC>
__global__ void __launch_bounds__(THREADS, 4) quotient_partial_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint64_t apow[];
  // the Poseidon2 gate's internal S-box inputs, a row a point of the tile
  __shared__ uint64_t held[THREADS / p2::SPLIT][p2::ROUNDS_P];
  __shared__ Challenges sch;
  const int b = blockIdx.x;
  const int proof = blockIdx.y;
  if (threadIdx.x < 16)
    ((uint64_t*)&sch)[threadIdx.x] = a.ch[proof * a.ch_stride + threadIdx.x];
  __syncthreads();
  const Challenges& ch = sch;
  const uint64_t* wires = a.wires + proof * a.wire_stride;
  const uint64_t* zpp_rows = a.zpp + proof * a.zpp_stride;
  uint64_t* partial = a.partial + (long long)proof * a.groups * NC * a.m;
  int g = 0;
  while (g + 1 < a.groups && a.desc[(g + 1) * DESC_W + D_BLOCK] <= b) ++g;
  const int* d = a.desc + g * DESC_W;
  const bool last = g + 1 == a.groups;
  const int first = d[D_FIRST];
  const int count = (last ? a.K : d[DESC_W + D_FIRST]) - first;
  const int blocks = (last ? a.blocks : d[DESC_W + D_BLOCK]) - d[D_BLOCK];
  const int lanes = d[D_LANES];
  // alpha_c^(first + i) for the group's constraints
  for (int i = threadIdx.x; i < a.nc * count; i += THREADS) {
    const int c = i / count;
    apow[i] = gl::pow(ch.alpha[c], (unsigned)(first + i - c * count));
  }
  __syncthreads();
  const int type = d[D_TYPE], sel = d[D_SEL];
  const int per_tile = THREADS / lanes;
  const int lane = threadIdx.x % lanes;
  const int tiles = (a.m + per_tile - 1) / per_tile;
  for (int t = b - d[D_BLOCK]; t < tiles; t += blocks) {
    const int x = t * per_tile + threadIdx.x / lanes;
    // a point past m repeats the last one, so that every thread of a warp
    // makes the same shuffles, and writes nothing
    Point<NC> p{a, wires, zpp_rows, ch, min(x, a.m - 1), apow, count, 0, {}};
    switch (type) {
      case T_ARITH: eval_arith(p, d[D_P0]); break;
      case T_CONST:
#pragma unroll 4
        for (int i = 0; i < d[D_P0]; ++i) p.emit(gl::sub(p.wire(i), p.constant(i)));
        break;
      case T_PUBLIC_INPUT:
        for (int i = 0; i < 4; ++i) p.emit(gl::sub(p.wire(i), ch.pi[i]));
        break;
      case T_POSEIDON2: eval_poseidon2(p, lane, held, threadIdx.x / lanes); break;
      case T_REDUCING: eval_reducing(p, d[D_P0], d[D_P1], d[D_P2]); break;
      case T_BASE_SUM: eval_base_sum(p, d[D_P0]); break;
      case T_PERMUTATION: eval_permutation(p, d[D_P0], lane, lanes); break;
      default: break;  // T_NOOP: no constraints
    }
    // the lanes' sums: exact, so the same value in any order
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t o = __shfl_xor_sync(0xffffffffu, (unsigned long long)p.acc[c], off, lanes);
        p.acc[c] = gl::add(p.acc[c], o);
      }
    }
    if (x < a.m && lane == 0) {
      // sum_k alpha^k * sel * C_k = sel * sum_k alpha^k * C_k
      const uint64_t s = sel >= 0 ? p.constant(sel) : 1;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        partial[((long long)g * NC + c) * a.m + x] = sel >= 0 ? gl::mul(p.acc[c], s) : p.acc[c];
      }
    }
  }
}

// out: (proofs, nc, m); proof p's partials are (G, nc, m) after the proofs
// before it.
__global__ void __launch_bounds__(THREADS) quotient_combine_kernel(
    const uint64_t* __restrict__ partial, const uint64_t* __restrict__ inv_zh,
    uint64_t* __restrict__ out, int groups, int nc, int m, int proofs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_proof = (long long)nc * m;
  if (idx >= proofs * per_proof) return;
  const long long proof = idx / per_proof, at = idx % per_proof;
  const int x = (int)(at % m);
  const uint64_t* src = partial + proof * groups * per_proof + at;
  uint64_t s = 0;
  for (int g = 0; g < groups; ++g) s = gl::add(s, src[(long long)g * per_proof]);
  out[idx] = gl::mul(s, inv_zh[x]);
}

}  // namespace

extern "C" int qzk_quotient_set_constants(const void* ext_rc, const void* int_rc,
                                          const void* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(c_ext_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(c_int_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag, diag, sizeof(c_diag));
  return (int)e;
}

// Two launches: the partial sums of the `groups` descriptor rows over
// `blocks` blocks for each of `proofs` proofs (at most MAX_PROOFS), then
// their sum times 1/Z_H into out (proofs, nc, m). Proof p's wires and Z rows
// at p * wire_stride and p * zpp_stride; ch: device challenge records
// (challenges.cuh), proof p's at p * ch_stride words, its alphas, betas,
// gammas and PI hash read on the card; partial: (proofs, groups, nc, m);
// max_count: the most constraints of one group (its alpha table).
extern "C" int qzk_quotient(const void* wires, long long wire_stride, const void* consts,
                            const void* zpp, long long zpp_stride, const void* xs,
                            const void* l1, const void* inv_zh, const void* ks,
                            const void* desc, void* partial, void* out, const void* ch,
                            long long ch_stride, int proofs,
                            int groups, int blocks, int m, int rate, int nr, int qdf, int npp,
                            int nc, int nconst, int nsel, int num_constraints, int max_count,
                            void* stream) {
  const size_t smem = sizeof(uint64_t) * (size_t)nc * (size_t)max_count;
  if (nc < 1 || nc > MAX_NC || m < 1 || groups < 1 || blocks < groups || qdf < 1 ||
      max_count < 0 || smem > MAX_SHARED || proofs < 1 || proofs > MAX_PROOFS || ch == nullptr ||
      (proofs > 1 && ch_stride < rec::WORDS))
    return (int)cudaErrorInvalidValue;
  Args a{(const uint64_t*)wires, (const uint64_t*)consts, (const uint64_t*)zpp,
         (const uint64_t*)xs, (const uint64_t*)l1, (const uint64_t*)ks, (const int*)desc,
         (uint64_t*)partial, wire_stride, zpp_stride,
         m, rate, nr, qdf, npp, nc, nconst, nsel, num_constraints, groups, blocks,
         (const uint64_t*)ch, ch_stride};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks, (unsigned)proofs);
  // one kernel a challenge count
  switch (nc) {
    case 1: quotient_partial_kernel<1><<<grid, THREADS, smem, s>>>(a); break;
    case 2: quotient_partial_kernel<2><<<grid, THREADS, smem, s>>>(a); break;
    case 3: quotient_partial_kernel<3><<<grid, THREADS, smem, s>>>(a); break;
    default: quotient_partial_kernel<4><<<grid, THREADS, smem, s>>>(a); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)proofs * nc * m;
  quotient_combine_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const uint64_t*)partial, (const uint64_t*)inv_zh, (uint64_t*)out, groups, nc, m, proofs);
  return (int)cudaGetLastError();
}
