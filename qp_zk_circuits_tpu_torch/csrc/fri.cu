// Kernels C-F: the FRI tail of the prover, from the quotient commit to the
// proof. Each entry launches once on the caller's stream, allocates nothing and returns the launches' cudaError_t.
//
// A proof axis: each entry takes 1..MAX_PROOFS proofs of one circuit in one
// launch (a batch of proofs, fri/prover.py::fri_commit_phase_batch and
// fri_query_phase_batch; a single proof is a batch of one), replacing the
// JAX package's jax.vmap of the fused prover (plonk/prover_fused.py:1007,
// :1049) over its FRI tail (:655-790). The proofs share the circuit's shapes
// and tables; each proof's pointers ride by value in the launch's
// parameters, a __grid_constant__ struct read in place, inside the classic
// 4 KB parameter limit, and its Fiat-Shamir values (points, alpha, betas,
// query indices) are read from device memory: C, D and E from the proof's
// challenge record (challenges.cuh), F from its index vector. The fused
// prover's transcript (kernel I) writes those on the card; the staged
// prover uploads its host draws, one copy, so both run the same kernels.
// The proof is a grid axis (C and E: y, D: z, F: the block's query row).
//
// Kernel C, qzk_fri_composition (fri/prover.py::compute_composition).
//   Replaces the JAX package's fri/prover.py::compute_composition (its
//   _get_q_jit run) and plonk/prover_fused.py::fused lines 655-696:
//     Q(x_i) = sum_b (sum_{k in b} alpha^k p_k(x_i) - c_b) / (x_i - z_b)
//   over the m LDE points, c_b = sum_{k in b} alpha^k y_k from the claimed
//   openings y, so the host does no extension arithmetic. One launch. Each
//   block first stages, in shared memory, every term's column address (the
//   oracles' (C, m) LDEs read in place through a per-circuit (oracle, row)
//   table) and alpha^k, and forms the c_b; then it walks a run of
//   neighbouring tiles of 16 points (as many blocks as fit the card, so a
//   block streams through each column). In a tile, thread rows 2..15 split
//   each batch's terms and load 8 columns at a time, so 8 loads are in
//   flight a thread (128 B a row of 16 points); meanwhile warp 0 (rows 0
//   and 1) inverts the next tile's x - z_b, one batch inverse a batch:
//   Montgomery's trick on the norms by shuffle scans and one Fermat power,
//   zeros replaced by 1 so that inv(0) = 0 stays. Then row b finishes batch
//   b and row 0 adds the batches. Q is written in the leaf layout of the
//   first FRI round (see kernel E). Bound: every column read once (about
//   255 x m x 8 B: 4.2 MB at the leaf, 1.07 GB at m = 2^19) and two
//   multiplies and two adds a term and point: operations, just, with bytes
//   close behind. Any m, at most MAX_TERMS terms.
//
// Kernel D, qzk_eval_openings (fri/oracle.py::eval_openings).
//   Replaces the JAX package's fri/oracle.py::eval_openings
//   (_jitted_eval_many) and the fused prover's _eval_coeffs_at with
//   _ext_powers_j: every listed coefficient row at its point,
//     y_c = sum_i coeffs[c, i] * z^i   (z = zeta or g * zeta, extension).
//   Bound: the rows read once (0.5 MB at the leaf, 139 MB at 264 x 2^16)
//   and two multiplies and two adds a coefficient: operations and bytes
//   nearly equal. Block (row tile, chunk of D_CHUNK coefficients): lanes
//   find their rows' segments by a ballot, then two warps a point the tile
//   needs form z^l and z^(32 l) by shuffle scans over the lanes the chunk
//   uses (the first row's loads in flight meanwhile); warp w takes rw rows,
//   lane l sums c_(l + 32 k) z^(32 k) over its coefficients l + 32 k (8
//   loads in flight, z^(32 k) a shared broadcast, 192-bit lazy sums in two
//   chains a component, reduced once), multiplies the sum by z^l once, and
//   a shuffle sum ends the row. A row of one chunk is written out (one
//   launch, rw = 1: a warp a row, 33 blocks at the leaf); above, z^l is
//   times z^c0 (square and multiply, in warps 4 and 5 beside the scans),
//   the partial sums go to a scratch (rows, chunks), and a second launch
//   adds them, a warp a row. Field addition is exact: any order gives the
//   plain version's bits. Any n up to 65535 chunks, any segment layout of
//   at most MAX_SEGS.
//
// Kernel E, qzk_fri_fold (fri/prover.py::fold_round).
//   Replaces the JAX package's fri/prover.py::_fold_step applied a times and
//   _regroup_leaves (fused prover lines 698-718). A round's layer of m
//   values is held as the (m', 2^(a+1)) leaf matrix its Merkle tree hashes:
//   row q is the arity coset v[q + j m'], j < 2^a. The round's beta comes
//   from the transcript after that tree's cap, so the leaves cannot wait for
//   the fold: the layer's producer writes them (kernel C for the first
//   round, this kernel for the next), and no transpose copy is made.
//   Bound: operations, nine multiplies and eight adds for each of the m -
//   m' values the folds make, against m values read and m' written. The
//   inverse twiddles are formed on the card, no table: value q + j m' of
//   fold t has x^-1 = w^(-2^t q) c_tj, w^-q from the bits of q (a butterfly
//   across the warp for the bits above 4) and 2^a - 1 constants c_tj =
//   shift^(-2^t) w_t^(-j m') passed by value (fri/prover.py::_fold_consts),
//   times beta^(2^t) once a block. A fold is e + o + u (e - o) c beta: two
//   multiplies by u and a 192-bit lazy sum a component; the a halvings are
//   one multiply by 2^-a at the end. Up to E_SPREAD_ROWS rows (the leaf,
//   the later degree-16 rounds) a row takes 2^(a - 1) threads, each one
//   pair of the first fold, the others by shuffles; above, two threads a
//   row (one instantiation per a and spread). The value goes straight to
//   its slot in the next round's leaf layout (arity 0: natural order, for
//   the final polynomial). a = 1..4, m' up to 2^31.
//
// Kernel F, qzk_query_gather (fri/prover.py::query_gather, called by
// gather_query_rounds).
//   Replaces the JAX package's fri/oracle.py::open_rows_many
//   (_jitted_open_rows), hash/merkle.py::MerkleTree.prove on the host, and
//   the fused prover's query gathers (lines 740-779). A plan of segments
//   (source matrix, strides, width, and the row rule
//   r = ((q & (2^mask_bits - 1)) >> shift) ^ flip) says where each value of
//   a query's packed row comes from: the oracles' leaf rows, their Merkle
//   siblings ((q >> l) ^ 1), each FRI round's leaf and its siblings; a
//   tree's whole path is one segment (its levels lie one after another in
//   one buffer), so a leaf proof's plan has 10 segments, degree 16's 14.
//   Bound: bytes, the values gathered (91 KB at the leaf); the device time
//   is a launch's. What a proof pays is the call (the host packing the plan
//   was most of it), so the plan travels by value and stays short: one
//   __grid_constant__ parameter of 3,608 bytes, inside the classic 4 KB
//   kernel parameter limit (no upload, no plan tensor), holding the
//   segments' shapes (16 bytes each), then for each proof its sources'
//   addresses (8 bytes a segment) and its 32-bit query indices. The proofs
//   of a batch share the shapes, so sixteen leaf proofs (10 segments, 28
//   queries) take 3,256 bytes: one launch, where a plan of whole segments a
//   proof would need 160 segments and 448 queries, above 4 KB (CUDA 12.1's
//   larger parameter space is not needed, and no plan is uploaded). The
//   query indices are not in the plan: each proof's is a pointer to its
//   int64 index vector on the card (kernel I draws them there on the fused
//   path), so the plan carries 8 bytes a proof. A
//   block takes a query of a proof; its threads stride over the packed row,
//   each finds its segment by a binary search of the offsets in parameter
//   space, makes one load and one coalesced store. The output is pinned
//   host memory, mapped: the kernel writes across the bus, no copy launch;
//   or, on the fused path, device memory, the proof's packed output.
#include <cuda_runtime.h>
#include <string.h>

#include "challenges.cuh"
#include "extension.cuh"

namespace {

constexpr int MAX_ORACLES = 8;
constexpr int MAX_BATCHES = 4;
constexpr int MAX_ARITY_BITS = 4;
constexpr int MAX_PROOFS = 16;  // proofs a launch (fri/prover.py PROOFS_PER_LAUNCH)

// Value i of a layer held as leaf rows of arity 2^a_bits, rows = m >> a_bits:
// row i mod rows, column i / rows (a_bits = 0 is natural order).
__device__ __forceinline__ long long leaf_slot(long long i, long long rows, int a_bits) {
  return ((i & (rows - 1)) << a_bits) + (i / rows);
}

// ---------------------------------------------------------------------------
// kernel C

constexpr int C_POINTS = 16;  // points a tile, one thread row's lanes
constexpr int C_GROUPS = 16;  // thread rows
constexpr int C_INV_ROWS = 2;  // rows 0, 1 (warp 0) invert the denominators
constexpr int C_SUM_ROWS = C_GROUPS - C_INV_ROWS;  // the others sum the terms
constexpr int C_THREADS = C_POINTS * C_GROUPS;
constexpr int C_INV_WARPS = C_INV_ROWS * C_POINTS / 32;
constexpr int C_SETUP = C_THREADS - 32 * C_INV_WARPS;  // the other warps stage the scalars
constexpr int C_UNROLL = 8;  // column loads in flight a thread
constexpr int MAX_TERMS = 4096;
constexpr int C_PART = MAX_BATCHES * 2 * C_THREADS;  // the c_b shares; holds the tile's sums too
constexpr int C_DINV = 2 * MAX_BATCHES * 2 * C_POINTS;  // two tiles' 1 / (x - z_b)
constexpr int C_POW = 32 + MAX_TERMS / 32;  // alpha^j, j < 32, then alpha^(32 j)
constexpr int C_MAX_SMEM = (3 * MAX_TERMS + C_PART + C_DINV + 2 * C_POW + 2 * MAX_BATCHES) * 8;

struct Sources {
  const uint64_t* p[MAX_PROOFS][MAX_ORACLES];  // each proof's oracles' (C, m) LDEs
};

struct Batches {
  int n;
  int start[MAX_BATCHES + 1];  // batch b's terms are [start[b], start[b + 1])
  int slot[MAX_BATCHES];       // batch b's point: a record's words slot[b], slot[b] + 1
};

int c_smem_words(int terms) { return 3 * terms + C_PART + C_DINV + 2 * C_POW + 2 * MAX_BATCHES; }

// the barrier of the setup warps (1..7) alone
__device__ __forceinline__ void setup_sync() { asm volatile("bar.sync 1, %0;" ::"r"(C_SETUP)); }

// Warp 0: 1 / (x_i - z_b) for the 16 points of `tile`, every batch, into
// dinv[b][c][lane]: row g takes batches g, g + 2, one batch inverse each
// (Montgomery's trick on the norms by shuffle scans over the row's 16
// lanes and one Fermat power; a zero norm gives 0).
__device__ void invert_tile(long long tile, const uint64_t* __restrict__ xs, const Batches& b,
                            const uint64_t* __restrict__ rc, long long m, uint64_t* dinv) {
  const int tx = threadIdx.x, g = threadIdx.y;
  const long long i = tile * C_POINTS + tx;
  const bool live = i < m;
#pragma unroll 1
  for (int bp = 0; bp < b.n; bp += C_INV_ROWS) {  // the same trips for both rows
    const int bi = bp + g;
    const bool mine = bi < b.n && live;
    const int bb = bi < b.n ? bi : 0;
    const ext::E xz = {gl::sub(xs[live ? i : 0], __ldg(rc + b.slot[bb])),
                       gl::sub(0, __ldg(rc + b.slot[bb] + 1))};
    const uint64_t norm =
        mine ? gl::sub(gl::mul(xz.c0, xz.c0), gl::mul(ext::W, gl::mul(xz.c1, xz.c1))) : 1;
    const uint64_t nz = norm == 0 ? 1 : norm;  // inv(0) = 0 stays
    uint64_t pre = nz, suf = nz;  // inclusive prefix and suffix products
#pragma unroll
    for (int d = 1; d < C_POINTS; d <<= 1) {
      const uint64_t a = __shfl_up_sync(0xffffffffu, (unsigned long long)pre, d, C_POINTS);
      const uint64_t c = __shfl_down_sync(0xffffffffu, (unsigned long long)suf, d, C_POINTS);
      if (tx >= d) pre = gl::mul(pre, a);
      if (tx + d < C_POINTS) suf = gl::mul(suf, c);
    }
    uint64_t total_inv = 0;
    if (tx == C_POINTS - 1) total_inv = gl::inv(pre);
    total_inv = __shfl_sync(0xffffffffu, (unsigned long long)total_inv, C_POINTS - 1, C_POINTS);
    uint64_t before = __shfl_up_sync(0xffffffffu, (unsigned long long)pre, 1, C_POINTS);
    uint64_t after = __shfl_down_sync(0xffffffffu, (unsigned long long)suf, 1, C_POINTS);
    if (tx == 0) before = 1;
    if (tx == C_POINTS - 1) after = 1;
    const uint64_t ninv = norm == 0 ? 0 : gl::mul(total_inv, gl::mul(before, after));
    if (bi < b.n) {  // 1 / (x - z_b) = conj(x - z_b) / norm
      dinv[(2 * bi) * C_POINTS + tx] = gl::mul(xz.c0, ninv);
      dinv[(2 * bi + 1) * C_POINTS + tx] = gl::mul(gl::sub(0, xz.c1), ninv);
    }
  }
}

// Thread rows 2..15 (warps 1..7): each batch's sum_k alpha^k p_k(x_i) over
// the 16 points of `tile`, the terms split across the rows, C_UNROLL column
// loads in flight a thread; per component a 192-bit sum of the 128-bit
// products, reduced once. Row r's sums go to part[b][c][r][lane].
__device__ void accumulate(long long tile, const uint64_t* const* col, const uint64_t* apow,
                           const Batches& b, long long m, uint64_t* part) {
  const int tx = threadIdx.x, r = threadIdx.y - C_INV_ROWS;
  const long long i = tile * C_POINTS + tx;
  const long long at = i < m ? i : 0;  // dead lanes read point 0
#pragma unroll 1
  for (int bi = 0; bi < b.n; ++bi) {
    uint64_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
    unsigned top0 = 0, top1 = 0;
    const int end = b.start[bi + 1];
#pragma unroll 1
    for (int k0 = b.start[bi] + r; k0 < end; k0 += C_SUM_ROWS * C_UNROLL) {
      uint64_t v[C_UNROLL];
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u) {
        const int k = k0 + u * C_SUM_ROWS;
        v[u] = k < end ? col[k][at] : 0;
      }
#pragma unroll
      for (int u = 0; u < C_UNROLL; ++u) {
        const int k = k0 + u * C_SUM_ROWS;
        if (k < end) {
          gl::mac(lo0, hi0, top0, apow[2 * k], v[u]);
          gl::mac(lo1, hi1, top1, apow[2 * k + 1], v[u]);
        }
      }
    }
    part[((2 * bi) * C_SUM_ROWS + r) * C_POINTS + tx] = gl::reduce192(lo0, hi0, top0);
    part[((2 * bi + 1) * C_SUM_ROWS + r) * C_POINTS + tx] = gl::reduce192(lo1, hi1, top1);
  }
}

// Block (run, proof): proof blockIdx.y's terms (its ys and out a (terms, 2)
// and (m, 2) part of the stacks), its alpha and points from its record.
__global__ void __launch_bounds__(C_THREADS)
    composition_kernel(const __grid_constant__ Sources src, const int* __restrict__ terms,
                       const uint64_t* __restrict__ ys, const uint64_t* __restrict__ xs,
                       const __grid_constant__ Batches b, const uint64_t* __restrict__ ch,
                       long long ch_stride, uint64_t* __restrict__ out, long long m, int a_bits,
                       long long per_block) {
  extern __shared__ uint64_t csm[];
  const int n_terms = b.start[b.n];
  const int proof = blockIdx.y;
  ys += 2LL * proof * n_terms;
  out += 2LL * proof * m;
  const uint64_t* rc = ch + proof * ch_stride;
  const ext::E alpha = {__ldg(rc + rec::FRI_ALPHA), __ldg(rc + rec::FRI_ALPHA + 1)};
  const uint64_t** col = (const uint64_t**)csm;  // term k's column
  uint64_t* apow = csm + n_terms;                 // alpha^k as (c0, c1)
  uint64_t* part = apow + 2 * n_terms;            // [batch][c][thread], then [batch][c][row][lane]
  uint64_t* dinv = part + C_PART;                 // two tiles' [batch][c][lane]
  uint64_t* pw = dinv + C_DINV;                   // alpha^j, j < 32, then alpha^(32 j)
  uint64_t* cb = pw + 2 * C_POW;                  // c_b as (c0, c1)
  const int tx = threadIdx.x, g = threadIdx.y;
  const int tid = tx + C_POINTS * g;
  const int lane = tid & 31, warp = tid >> 5;
  // the block's run of neighbouring tiles [t0, tiles): each column is read
  // in one stream a block
  const long long t0 = blockIdx.x * per_block;
  const long long all = (m + C_POINTS - 1) / C_POINTS;
  const long long tiles = t0 + per_block < all ? t0 + per_block : all;

  // A software pipeline over the block's tiles:
  // warp 0 inverts the denominators a tile ahead of the sums, in two
  // buffers, while warps 1..7 sum the next tile's terms.
  if (warp < C_INV_WARPS) {
    // the first two tiles' denominators while the other warps stage the
    // scalars and sum the first tile
    invert_tile(t0, xs, b, rc, m, dinv);
    if (t0 + 1 < tiles) invert_tile(t0 + 1, xs, b, rc, m, dinv + C_DINV / 2);
  } else {
    const int st = tid - 32 * C_INV_WARPS, sw = warp - C_INV_WARPS;
    // the first term's reads, in flight during the scans
    int o0 = 0, r0 = 0;
    uint64_t y0 = 0, y1 = 0;
    if (st < n_terms) {
      o0 = terms[2 * st];
      r0 = terms[2 * st + 1];
      y0 = ys[2 * st];
      y1 = ys[2 * st + 1];
    }
    if (sw <= 1) {
      // setup warp 0: alpha^j by a shuffle scan; 1: alpha^(32 j), the scan
      // of alpha^32, and alpha^(32 j + 1024 i) above 32
      ext::E x = alpha;
      if (sw == 1) {
#pragma unroll 1
        for (int r = 0; r < 5; ++r) x = ext::mul(x, x);
      }
      const ext::E base = x;
      if (lane == 0) x = {1, 0};
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const ext::E o = {__shfl_up_sync(0xffffffffu, (unsigned long long)x.c0, d),
                          __shfl_up_sync(0xffffffffu, (unsigned long long)x.c1, d)};
        if (lane >= d) x = ext::mul(x, o);
      }
      const int at = sw == 0 ? lane : 32 + lane;
      pw[2 * at] = x.c0;
      pw[2 * at + 1] = x.c1;
      if (sw == 1 && n_terms > 1024) {
        // alpha^1024 = alpha^(32 * 31) alpha^32, from lane 31
        ext::E top = {__shfl_sync(0xffffffffu, (unsigned long long)x.c0, 31),
                      __shfl_sync(0xffffffffu, (unsigned long long)x.c1, 31)};
        top = ext::mul(top, base);
        ext::E y = x;
#pragma unroll 1
        for (int r = 1; 32 * r < C_POW - 32; ++r) {
          y = ext::mul(y, top);
          pw[2 * (32 + 32 * r + lane)] = y.c0;
          pw[2 * (32 + 32 * r + lane) + 1] = y.c1;
        }
      }
    }
#pragma unroll 1
    for (int k = st; k < n_terms; k += C_SETUP) {
      const bool first = k == st;
      col[k] = src.p[proof][first ? o0 : terms[2 * k]] +
               (long long)(first ? r0 : terms[2 * k + 1]) * m;
    }
    setup_sync();
    // alpha^k and each setup thread's share of every c_b
    ext::E own[MAX_BATCHES];
#pragma unroll
    for (int bi = 0; bi < MAX_BATCHES; ++bi) own[bi] = {0, 0};
#pragma unroll 1
    for (int k = st; k < n_terms; k += C_SETUP) {
      const ext::E ak = ext::mul({pw[2 * (k & 31)], pw[2 * (k & 31) + 1]},
                                 {pw[2 * (32 + (k >> 5))], pw[2 * (32 + (k >> 5)) + 1]});
      apow[2 * k] = ak.c0;
      apow[2 * k + 1] = ak.c1;
      const bool first = k == st;
      const ext::E term =
          ext::mul(ak, {first ? y0 : ys[2 * k], first ? y1 : ys[2 * k + 1]});
#pragma unroll
      for (int bi = 0; bi < MAX_BATCHES; ++bi)
        if (bi < b.n && k >= b.start[bi] && k < b.start[bi + 1]) own[bi] = ext::add(own[bi], term);
    }
#pragma unroll
    for (int bi = 0; bi < MAX_BATCHES; ++bi) {
      part[(2 * bi) * C_THREADS + st] = own[bi].c0;
      part[(2 * bi + 1) * C_THREADS + st] = own[bi].c1;
    }
    setup_sync();
    // setup warp w adds batch w's shares, 7 a lane, then a butterfly of shuffles
    const int w = sw;
    if (w < b.n) {
      ext::E s = {0, 0};
#pragma unroll 1
      for (int t = lane; t < C_SETUP; t += 32)
        s = ext::add(s, {part[(2 * w) * C_THREADS + t], part[(2 * w + 1) * C_THREADS + t]});
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const uint64_t o0 = __shfl_xor_sync(0xffffffffu, (unsigned long long)s.c0, off);
        const uint64_t o1 = __shfl_xor_sync(0xffffffffu, (unsigned long long)s.c1, off);
        s = ext::add(s, {o0, o1});
      }
      if (lane == 0) {
        cb[2 * w] = s.c0;
        cb[2 * w + 1] = s.c1;
      }
    }
    setup_sync();  // part is free again
    accumulate(t0, col, apow, b, m, part);
  }
  __syncthreads();

  int buf = 0;
#pragma unroll 1
  for (long long tile = t0; tile < tiles; ++tile, buf ^= 1) {
    // part holds this tile's sums, dinv[buf] its denominators' inverses
    const long long i = tile * C_POINTS + tx;
    const bool live = i < m;
    const uint64_t* inv = dinv + buf * (C_DINV / 2);
    if (g < b.n && live) {
      // row g finishes batch g; only this thread touches its slot
      ext::E s = {0, 0};
#pragma unroll 1
      for (int h = 0; h < C_SUM_ROWS; ++h)
        s = ext::add(s, {part[((2 * g) * C_SUM_ROWS + h) * C_POINTS + tx],
                         part[((2 * g + 1) * C_SUM_ROWS + h) * C_POINTS + tx]});
      const ext::E c = ext::mul(ext::sub(s, {cb[2 * g], cb[2 * g + 1]}),
                                {inv[(2 * g) * C_POINTS + tx], inv[(2 * g + 1) * C_POINTS + tx]});
      part[(2 * g) * C_SUM_ROWS * C_POINTS + tx] = c.c0;
      part[(2 * g + 1) * C_SUM_ROWS * C_POINTS + tx] = c.c1;
    }
    __syncthreads();
    if (g == 0 && live) {
      ext::E q = {0, 0};
      for (int bi = 0; bi < b.n; ++bi)
        q = ext::add(q, {part[(2 * bi) * C_SUM_ROWS * C_POINTS + tx],
                         part[(2 * bi + 1) * C_SUM_ROWS * C_POINTS + tx]});
      const long long slot = leaf_slot(i, m >> a_bits, a_bits);
      out[2 * slot] = q.c0;
      out[2 * slot + 1] = q.c1;
    }
    const long long next = tile + 1;
    if (next >= tiles) break;  // uniform across the block
    __syncthreads();  // part and dinv[buf] are free
    if (warp < C_INV_WARPS) {
      if (next + 1 < tiles) invert_tile(next + 1, xs, b, rc, m, dinv + buf * (C_DINV / 2));
    } else {
      accumulate(next, col, apow, b, m, part);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// kernel D

constexpr int D_WARPS = 8;
constexpr int D_THREADS = 32 * D_WARPS;
constexpr int D_CHUNK = 1024;           // coefficients a block
constexpr int D_LANE = D_CHUNK / 32;    // coefficients a lane a row
constexpr int D_LOADS = 8;              // coefficient loads in flight a lane (16 measured slower)
constexpr int D_MAX_RW = 4;             // rows a warp above one chunk (2 and 8 measured slower)
constexpr int MAX_SEGS = MAX_ORACLES + 1;

// consecutive output rows of each proof: segment s is rows start[s] ..
// start[s + 1] - 1, coefficient rows from p[proof][s] evaluated at the
// proof's point[s] (0 = zeta, 1 = g * zeta), both read from its record
struct Rows {
  const uint64_t* p[MAX_PROOFS][MAX_SEGS];
  long long start[MAX_SEGS + 1];
  int point[MAX_SEGS];
  int n;
  const uint64_t* ch;  // proof p's challenge record at p * ch_stride
  long long ch_stride;
};
static_assert(rec::ZETA_NEXT == rec::ZETA + 2, "point pt sits at ZETA + 2 pt");

__device__ __forceinline__ ext::E point_of(const Rows& rows, int pt) {
  const uint64_t* z = rows.ch + blockIdx.z * rows.ch_stride + rec::ZETA + 2 * pt;
  return {__ldg(z), __ldg(z + 1)};
}

// Row r's coefficients from c0 on and its point (-1 past the last row):
// lane s checks segment s, the warp's ballot names the one that holds r.
__device__ __forceinline__ int find_row(const Rows& rows, long long r, int n, long long c0,
                                        const uint64_t*& src) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < rows.n && r >= rows.start[lane] && r < rows.start[lane + 1];
  const unsigned owner = __ballot_sync(0xffffffffu, mine);
  if (owner == 0) return -1;
  const int s = __ffs(owner) - 1;
  src = rows.p[blockIdx.z][s] + (r - rows.start[s]) * n + c0;
  return rows.point[s];
}

// Block (tile, chunk, proof): the partial sums over coefficients [c0, c0 +
// D_CHUNK) of the proof's tile of 8 rw rows (warp w takes rows w rw .. w rw
// + rw - 1, one at a time, lane l coefficients c0 + l + 32 k), times z^c0,
// into dst[proof][row][chunk] (dst = out when the rows have one chunk). Lane
// l sums c_(l + 32 k) z^(32 k) and multiplies the sum by z^l (times z^c0)
// once a row.
__global__ void __launch_bounds__(D_THREADS)
    openings_kernel(const __grid_constant__ Rows rows, uint64_t* __restrict__ dst,
                    long long total, int n, int rw, int chunks) {
  dst += 2LL * blockIdx.z * total * chunks;
  __shared__ ulonglong2 scan[2][2][32];  // [point][z^l, z^(32 l)]
  __shared__ ulonglong2 cpow[2];         // z^c0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * D_WARPS * rw;
  const long long c0 = (long long)blockIdx.y * D_CHUNK;
  const int len = n - c0 < D_CHUNK ? (int)(n - c0) : D_CHUNK;

  // the points the tile's rows need: lane s checks segment s
  const bool meets = lane < rows.n && rows.start[lane] < rows.start[lane + 1] &&
                     rows.start[lane + 1] > r0 && rows.start[lane] < r0 + D_WARPS * rw;
  const bool need0 = __ballot_sync(0xffffffffu, meets && rows.point[lane] == 0) != 0;
  const bool need1 = __ballot_sync(0xffffffffu, meets && rows.point[lane] == 1) != 0;

  // the warp's first row's loads, in flight while the powers are formed
  const uint64_t* src = nullptr;
  int pt = find_row(rows, r0 + warp * rw, n, c0, src);
  uint64_t v[D_LOADS];
#pragma unroll
  for (int u = 0; u < D_LOADS; ++u) {
    const int j = lane + 32 * u;
    v[u] = pt >= 0 && j < len ? __ldg((const unsigned long long*)src + j) : 0;
  }

  // warps 0, 1 (zeta) and 2, 3 (g zeta): z^l and z^(32 l) by shuffle scans
  // over the lanes the chunk uses; warps 4, 5: z^c0 (square and multiply)
  // when the rows have more chunks
  if (warp < 4) {
    const int p = warp >> 1;
    if (p == 0 ? need0 : need1) {
      ext::E x = point_of(rows, p);
      if (warp & 1) {
#pragma unroll 1
        for (int r = 0; r < 5; ++r) x = ext::mul(x, x);
      }
      if (lane == 0) x = {1, 0};
      const int used = warp & 1 ? (len + 31) / 32 : (len < 32 ? len : 32);
#pragma unroll 1
      for (int d = 1; d < used; d <<= 1) {
        const ext::E o = {__shfl_up_sync(0xffffffffu, (unsigned long long)x.c0, d),
                          __shfl_up_sync(0xffffffffu, (unsigned long long)x.c1, d)};
        if (lane >= d) x = ext::mul(x, o);
      }
      scan[p][warp & 1][lane] = make_ulonglong2(x.c0, x.c1);
    }
  } else if (warp < 6 && chunks > 1) {
    const int p = warp - 4;
    if (p == 0 ? need0 : need1) {
      const ext::E x = ext::pow(point_of(rows, p), (unsigned long long)c0);
      if (lane == 0) cpow[p] = make_ulonglong2(x.c0, x.c1);
    }
  }
  __syncthreads();
  // lane l's factor z^l (times z^c0) for each point the tile needs
  ext::E fac[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    fac[p] = {1, 0};
    if (p == 0 ? need0 : need1) {
      fac[p] = {scan[p][0][lane].x, scan[p][0][lane].y};
      if (c0 > 0) fac[p] = ext::mul(fac[p], {cpow[p].x, cpow[p].y});
    }
  }

#pragma unroll 1
  for (int i = 0; i < rw; ++i) {
    if (i > 0) pt = find_row(rows, r0 + warp * rw + i, n, c0, src);
    if (pt < 0) break;  // the tile's last rows lie past the end; uniform in the warp
    const ulonglong2* hi = scan[pt][1];
    // two chains of 192-bit sums a component: even and odd steps
    uint64_t lo[4] = {0, 0, 0, 0}, hh[4] = {0, 0, 0, 0};
    unsigned top[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int k0 = 0; k0 < D_LANE && 32 * k0 < len; k0 += D_LOADS) {
      if (i > 0 || k0 > 0) {
#pragma unroll
        for (int u = 0; u < D_LOADS; ++u) {
          const int j = lane + 32 * (k0 + u);
          v[u] = j < len ? __ldg((const unsigned long long*)src + j) : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < D_LOADS; ++u) {  // past len: v = 0, whatever hi holds
        const ulonglong2 z = hi[k0 + u];
        const int c = 2 * (u & 1);
        gl::mac(lo[c], hh[c], top[c], z.x, v[u]);
        gl::mac(lo[c + 1], hh[c + 1], top[c + 1], z.y, v[u]);
      }
    }
    ext::E s = {gl::add(gl::reduce192(lo[0], hh[0], top[0]), gl::reduce192(lo[2], hh[2], top[2])),
                gl::add(gl::reduce192(lo[1], hh[1], top[1]), gl::reduce192(lo[3], hh[3], top[3]))};
    s = ext::mul(s, pt ? fac[1] : fac[0]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.c0 = gl::add(s.c0, __shfl_down_sync(0xffffffffu, (unsigned long long)s.c0, off));
      s.c1 = gl::add(s.c1, __shfl_down_sync(0xffffffffu, (unsigned long long)s.c1, off));
    }
    if (lane == 0) {
      const long long r = r0 + warp * rw + i;
      const long long at = chunks > 1 ? r * chunks + blockIdx.y : r;
      dst[2 * at] = s.c0;
      dst[2 * at + 1] = s.c1;
    }
  }
}

// The chunks' partial sums of each row, one warp a row.
__global__ void __launch_bounds__(D_THREADS)
    openings_sum_kernel(const uint64_t* __restrict__ part, uint64_t* __restrict__ out,
                        long long total, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * D_WARPS + (threadIdx.x >> 5);
  if (r >= total) return;  // the whole warp
  ext::E s = {0, 0};
  const uint64_t* p = part + 2 * r * chunks;
#pragma unroll 4
  for (int c = lane; c < chunks; c += 32) {
    const ulonglong2 x = __ldg((const ulonglong2*)p + c);
    s = ext::add(s, {x.x, x.y});
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.c0 = gl::add(s.c0, __shfl_down_sync(0xffffffffu, (unsigned long long)s.c0, off));
    s.c1 = gl::add(s.c1, __shfl_down_sync(0xffffffffu, (unsigned long long)s.c1, off));
  }
  if (lane == 0) {
    out[2 * r] = s.c0;
    out[2 * r + 1] = s.c1;
  }
}

// ---------------------------------------------------------------------------
// kernel E

constexpr int E_THREADS = 128;
// at most this many rows in a round: 2^(a - 1) threads a row, else
// 2^E_LARGE_S (at m = 2^19, a = 4: two threads a row measured faster than
// one or four)
constexpr long long E_SPREAD_ROWS = 1 << 13;
constexpr int E_LARGE_S = 1;

// A round's constants, by value: the inverse twiddle of value q + j m' in
// fold t is w^(-2^t q) c_tj with c_tj = shift^(-2^t) w_t^(-j m') (w of
// order m, w_t = w^(2^t))
struct FoldConsts {
  uint64_t wb[32];                        // w^(-2^b)
  uint64_t c[(1 << MAX_ARITY_BITS) - 1];  // c_tj at 2^a - 2^(a - t) + j
  uint64_t scale;                         // 2^-a: the a halvings, applied once
};
constexpr int FOLD_CONST_WORDS = 32 + (1 << MAX_ARITY_BITS) - 1 + 1;

// 2 x one binary fold, e + o + u (e - o) cb with cb = c_tj beta^(2^t) as
// (cb0, cb1, W cb1): two multiplies by u, then per component one 192-bit
// sum of e, o and two products, reduced once (the halving is left to the end)
__device__ __forceinline__ ext::E fold2(ext::E e, ext::E o, uint64_t u, const uint64_t* cb) {
  const uint64_t d0 = gl::mul(u, gl::sub(e.c0, o.c0)), d1 = gl::mul(u, gl::sub(e.c1, o.c1));
  uint64_t lo0 = e.c0 + o.c0, lo1 = e.c1 + o.c1;
  uint64_t hi0 = lo0 < e.c0, hi1 = lo1 < e.c1;
  unsigned top0 = 0, top1 = 0;
  gl::mac(lo0, hi0, top0, d0, cb[0]);
  gl::mac(lo0, hi0, top0, d1, cb[2]);
  gl::mac(lo1, hi1, top1, d0, cb[1]);
  gl::mac(lo1, hi1, top1, d1, cb[0]);
  return {gl::reduce192(lo0, hi0, top0), gl::reduce192(lo1, hi1, top1)};
}

// Block (rows, proof): proof blockIdx.y's layer (a (mp, 2 A) part of the
// stacked leaves) folded with its beta (words beta_slot, beta_slot + 1 of
// its record; beta^(2^t) by squaring) into its part of out.
// E_THREADS / 2^S_BITS leaf rows, 2^S_BITS threads a row, thread h
// holding the pairs h + 2^S_BITS i of the first fold; the first A_BITS -
// S_BITS folds in registers, the last S_BITS by shuffles among the row's
// threads. One thread a row (S_BITS = 0) stages the block's rows in shared
// memory by 16-byte loads; with more, the row's threads read its two halves
// as 32 B or more a row, straight from memory.
template <int A_BITS, int S_BITS>
__global__ void __launch_bounds__(E_THREADS)
    fold_kernel(const uint64_t* __restrict__ leaves, const __grid_constant__ FoldConsts k,
                const uint64_t* __restrict__ ch, long long ch_stride, int beta_slot,
                uint64_t* __restrict__ out, long long mp, int mp_bits, int next_bits) {
  constexpr int A = 1 << A_BITS, T = 1 << S_BITS, ROWS = E_THREADS / T;
  constexpr int PAIRS = A / (2 * T);        // first-fold pairs a thread
  constexpr int LOCAL = A_BITS - S_BITS;    // folds within a thread
  constexpr int STRIDE = 2 * A + 1;         // staged row: an odd stride, rows in distinct banks
  __shared__ uint64_t st[S_BITS == 0 ? ROWS * STRIDE : 1];
  __shared__ uint64_t cb[A - 1][3];         // c_tj beta^(2^t) as (c0, c1, W c1)
  const int tid = threadIdx.x, lane = tid & 31, h = tid & (T - 1);
  const int proof = blockIdx.y;
  leaves += 2LL * A * mp * proof;
  out += 2LL * mp * proof;
  const long long q0 = (long long)blockIdx.x * ROWS;
  const long long q = q0 + (tid >> S_BITS);
  const ulonglong2* src = (const ulonglong2*)leaves;  // a value a unit
  ulonglong2 ld[S_BITS == 0 ? A : 2 * PAIRS];
  const int units = (mp - q0 < ROWS ? (int)(mp - q0) : ROWS) * A;
  if (S_BITS == 0) {
#pragma unroll
    for (int p = 0; p < A; ++p) {
      const int i = tid + p * E_THREADS;
      if (i < units) ld[p] = __ldg(src + q0 * A + i);
    }
  } else if (q < mp) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      ld[i] = __ldg(src + q * A + h + T * i);
      ld[PAIRS + i] = __ldg(src + q * A + h + T * i + A / 2);
    }
  }
  if (tid < A - 1) {
    int t = 0;
    while (tid >= A - (A >> (t + 1))) ++t;  // tid's fold
    const uint64_t* bp = ch + proof * ch_stride + beta_slot;
    ext::E bt = {__ldg(bp), __ldg(bp + 1)};
    for (int u = 0; u < t; ++u) bt = ext::mul(bt, bt);  // beta^(2^t)
    const uint64_t c0 = gl::mul(k.c[tid], bt.c0);
    const uint64_t c1 = gl::mul(k.c[tid], bt.c1);
    cb[tid][0] = c0;
    cb[tid][1] = c1;
    cb[tid][2] = gl::mul(ext::W, c1);
  }

  // u = w^-q: the bits of q above 4 by a butterfly across the warp (its rows
  // lie in one aligned run of 32), the low five in the thread
  uint64_t hi = lane >= 5 && ((q >> lane) & 1) ? k.wb[lane] : 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hi = gl::mul(hi, __shfl_xor_sync(0xffffffffu, (unsigned long long)hi, off));
  const uint64_t b0 = q & 1 ? k.wb[0] : 1, b1 = q & 2 ? k.wb[1] : 1, b2 = q & 4 ? k.wb[2] : 1,
                 b3 = q & 8 ? k.wb[3] : 1, b4 = q & 16 ? k.wb[4] : 1;
  uint64_t ut = gl::mul(gl::mul(gl::mul(b0, b1), gl::mul(b2, b3)), gl::mul(b4, hi));

  ext::E f[PAIRS];
  if (S_BITS == 0) {
#pragma unroll
    for (int p = 0; p < A; ++p) {
      const int i = tid + p * E_THREADS;
      if (i < units) {
        uint64_t* at = st + (i / A) * STRIDE + 2 * (i % A);
        at[0] = ld[p].x;
        at[1] = ld[p].y;
      }
    }
  }
  __syncthreads();
  if (S_BITS == 0) {
    const uint64_t* row = st + tid * STRIDE;
#pragma unroll
    for (int j = 0; j < PAIRS; ++j)
      f[j] = fold2({row[2 * j], row[2 * j + 1]}, {row[2 * (j + A / 2)], row[2 * (j + A / 2) + 1]},
                   ut, cb[j]);
  } else {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i)
      f[i] = fold2({ld[i].x, ld[i].y}, {ld[PAIRS + i].x, ld[PAIRS + i].y}, ut, cb[h + T * i]);
  }
#pragma unroll
  for (int t = 1; t < LOCAL; ++t) {
    ut = gl::mul(ut, ut);
    const int pairs = (A >> (t + 1)) / T;
#pragma unroll
    for (int i = 0; i < pairs; ++i)
      f[i] = fold2(f[i], f[i + pairs], ut, cb[A - (A >> t) + h + T * i]);
  }
  ext::E v = f[0];
#pragma unroll
  for (int t = LOCAL; t < A_BITS; ++t) {
    ut = gl::mul(ut, ut);
    const int half = A >> (t + 1);
    const ext::E o = {__shfl_down_sync(0xffffffffu, (unsigned long long)v.c0, half, T),
                      __shfl_down_sync(0xffffffffu, (unsigned long long)v.c1, half, T)};
    v = fold2(v, o, ut, cb[A - (A >> t) + (h & (half - 1))]);
  }
  if (h == 0 && q < mp) {
    const int nb = mp_bits - next_bits;
    const long long at = ((q & ((1LL << nb) - 1)) << next_bits) + (q >> nb);
    out[2 * at] = gl::mul(v.c0, k.scale);
    out[2 * at + 1] = gl::mul(v.c1, k.scale);
  }
}

// ---------------------------------------------------------------------------
// kernel F

constexpr int F_MAX_SEGS = 128;     // a proof's segments
constexpr int F_MAX_QUERIES = 128;  // a proof's queries
constexpr int F_MAX_THREADS = 1024;
// one proof at both limits once held its 32-bit indices in the plan: the
// size stays, the indices now an 8-byte pointer a proof
constexpr int F_PLAN_BYTES = 24 + 24 * F_MAX_SEGS + 4 * F_MAX_QUERIES;

// a plan segment's shape, 16 bytes, at `offset` in the packed row. levels =
// 0: the row r of the proof's source `src` picked by the query index,
// values src[r * row_stride + j * col_stride] for j < width. levels = L > 0:
// a Merkle path, L levels of 4-value digests stored one after another from
// `src` (level l has 2^(mask_bits - l) rows, level 0 2^mask_bits), at level
// l the row ((q & mask) >> l) ^ flip; width 4 L.
struct GatherShape {
  int row_stride, col_stride;
  unsigned short offset, width;
  unsigned char mask_bits, shift, flip, levels;
};

// The header, then in `body`: the sources' addresses (proofs, segments),
// the segments' shapes (segments), each proof's query-index vector (proofs):
// a device address of `queries` int64 indices below 2^32.
struct GatherPlan {
  uint64_t* out;  // (proofs, queries, row_width), pinned host or device memory
  int queries, segments, row_width, proofs;
  unsigned char body[F_PLAN_BYTES - 24];
};
static_assert(sizeof(GatherShape) == 16, "the wrapper packs 16-byte segment shapes");
static_assert(sizeof(GatherPlan) == F_PLAN_BYTES, "the wrapper packs the plan without padding");
static_assert(sizeof(GatherPlan) <= 4096 - 64, "the plan fits the classic 4 KB parameter limit");

__device__ __forceinline__ const GatherShape* plan_shapes(const GatherPlan& p) {
  return (const GatherShape*)(p.body + 8 * p.proofs * p.segments);
}

__device__ __forceinline__ const uint64_t* const* plan_queries(const GatherPlan& p) {
  return (const uint64_t* const*)(p.body + (8 * p.proofs + 16) * p.segments);
}

// Block b: query b % queries of proof b / queries, into out row b.
__global__ void __launch_bounds__(F_MAX_THREADS) gather_kernel(const __grid_constant__ GatherPlan p) {
  const uint64_t* const* srcs =
      (const uint64_t* const*)p.body + (long long)(blockIdx.x / p.queries) * p.segments;
  const GatherShape* seg = plan_shapes(p);
  const unsigned q =
      (unsigned)__ldg(plan_queries(p)[blockIdx.x / p.queries] + blockIdx.x % p.queries);
  uint64_t* dst = p.out + (long long)blockIdx.x * p.row_width;
  int s = 0;
  for (int c = threadIdx.x; c < p.row_width; c += blockDim.x) {
    // the last segment that starts at or before c (columns only grow)
    int hi = p.segments - 1;
    while (s < hi) {
      const int mid = (s + hi + 1) >> 1;
      if (seg[mid].offset <= c)
        s = mid;
      else
        hi = mid - 1;
    }
    const GatherShape& g = seg[s];
    const unsigned mask = g.mask_bits >= 32 ? 0xFFFFFFFFu : (1u << g.mask_bits) - 1u;
    int j = c - g.offset, level = 0;
    long long base = 0;  // rows before level `level`: 2 n0 - 2 (n0 >> level)
    if (g.levels) {
      level = j >> 2;
      j &= 3;
      base = ((2LL << g.mask_bits) - ((2LL << g.mask_bits) >> level)) * g.row_stride;
    }
    const long long r = (long long)(((q & mask) >> (g.shift + level)) ^ g.flip);
    dst[c] = __ldg(srcs[s] + base + r * g.row_stride + (long long)j * g.col_stride);
  }
}

bool grid_fits(long long blocks) { return blocks >= 1 && blocks <= 0x7FFFFFFFLL; }

}  // namespace

// For `proofs` proofs of one circuit: sources: host array (proofs,
// n_sources) of device pointers (each proof's oracles' (C, m) LDEs); terms:
// device int32 (K, 2) (oracle, row), the circuit's; ys: device (proofs, K,
// 2) claimed openings; xs: device (m,) domain points; batches: host int64
// (n_batches, 2) rows (end, slot), batch b's terms [end[b - 1], end[b]),
// its point at words slot, slot + 1 of each proof's record; ch: device
// challenge records (challenges.cuh), proof p's at p * ch_stride words,
// alpha at rec::FRI_ALPHA; out: (proofs, m) extension values, each proof's
// as (m >> a_bits, 2^(a_bits + 1)) leaf rows. One launch.
extern "C" int qzk_fri_composition(const void* sources, int n_sources, const void* terms,
                                   const void* ys, const void* xs, const void* batches,
                                   int n_batches, const void* ch, long long ch_stride, void* out,
                                   long long m, int a_bits, int proofs, void* stream) {
  const long long tiles = (m + C_POINTS - 1) / C_POINTS;
  if (n_sources < 1 || n_sources > MAX_ORACLES || n_batches < 1 || n_batches > MAX_BATCHES ||
      proofs < 1 || proofs > MAX_PROOFS || !grid_fits(tiles) || a_bits < 0 ||
      a_bits > MAX_ARITY_BITS || (m & (m - 1)) || (m >> a_bits) < 1 || ch == nullptr ||
      (proofs > 1 && ch_stride < rec::WORDS))
    return (int)cudaErrorInvalidValue;
  Sources src{};
  Batches b{};
  b.n = n_batches;
  const long long* h = (const long long*)batches;
  for (int t = 0; t < n_batches; ++t) {
    b.start[t + 1] = (int)h[2 * t];
    b.slot[t] = (int)h[2 * t + 1];
    if (b.start[t + 1] <= b.start[t] || b.slot[t] < 0 || b.slot[t] + 2 > rec::WORDS)
      return (int)cudaErrorInvalidValue;
  }
  if (b.start[n_batches] > MAX_TERMS) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < proofs; ++p)
    for (int o = 0; o < n_sources; ++o)
      src.p[p][o] = ((const uint64_t* const*)sources)[p * n_sources + o];
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && !raised[dev]) {
    e = cudaFuncSetAttribute(composition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const int smem = c_smem_words(b.start[n_batches]) * 8;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, composition_kernel, C_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  // the card's resident blocks shared among the proofs, each a run of tiles
  long long blocks = ((long long)sms * (per_sm < 1 ? 1 : per_sm) + proofs - 1) / proofs;
  if (blocks > tiles) blocks = tiles;
  const long long per_block = (tiles + blocks - 1) / blocks;
  blocks = (tiles + per_block - 1) / per_block;
  composition_kernel<<<dim3((unsigned)blocks, (unsigned)proofs), dim3(C_POINTS, C_GROUPS), smem,
                       (cudaStream_t)stream>>>(src, (const int*)terms, (const uint64_t*)ys,
                                               (const uint64_t*)xs, b, (const uint64_t*)ch,
                                               ch_stride, (uint64_t*)out, m, a_bits, per_block);
  return (int)cudaGetLastError();
}

// For `proofs` proofs of one circuit: segs: host uint64 (proofs, n_segs, 3)
// rows (device address of the first row, row count, point), the counts and
// points the same for every proof; ch: device challenge records
// (challenges.cuh), proof p's at p * ch_stride words, its zeta and g * zeta
// at rec::ZETA and rec::ZETA_NEXT; out: (proofs, total rows, 2); part: device
// scratch of (proofs, total rows, chunks, 2) for n above D_CHUNK (chunks =
// ceil(n / D_CHUNK); unused, may be null, at or below). One launch at or
// below D_CHUNK, two above.
extern "C" int qzk_eval_openings(const void* segs, int n_segs, const void* ch,
                                 long long ch_stride, void* out, void* part, int n, int proofs,
                                 void* stream) {
  if (n_segs < 1 || n_segs > MAX_SEGS || n < 1 || proofs < 1 || proofs > MAX_PROOFS ||
      ch == nullptr || (proofs > 1 && ch_stride < rec::WORDS))
    return (int)cudaErrorInvalidValue;
  Rows rows{};
  rows.n = n_segs;
  rows.ch = (const uint64_t*)ch;
  rows.ch_stride = ch_stride;
  const uint64_t* h = (const uint64_t*)segs;
  for (int s = 0; s < n_segs; ++s) {
    rows.start[s + 1] = rows.start[s] + (long long)h[3 * s + 1];
    rows.point[s] = (int)h[3 * s + 2];
    if (rows.point[s] < 0 || rows.point[s] > 1) return (int)cudaErrorInvalidValue;
  }
  for (int p = 0; p < proofs; ++p) {
    for (int s = 0; s < n_segs; ++s) {
      const uint64_t* seg = h + 3 * (p * n_segs + s);
      if ((long long)seg[1] != rows.start[s + 1] - rows.start[s] || (int)seg[2] != rows.point[s])
        return (int)cudaErrorInvalidValue;
      rows.p[p][s] = (const uint64_t*)seg[0];
    }
  }
  const long long total = rows.start[n_segs];
  const int chunks = (n + D_CHUNK - 1) / D_CHUNK;
  // one chunk: a warp a row, for blocks enough; more: D_MAX_RW rows a warp
  // share the block's scans
  const int rw = chunks == 1 ? 1 : D_MAX_RW;
  const long long tiles = (total + D_WARPS * rw - 1) / (D_WARPS * rw);
  if (!grid_fits(tiles) || chunks > 65535 || (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  openings_kernel<<<dim3((unsigned)tiles, (unsigned)chunks, (unsigned)proofs), D_THREADS, 0, s>>>(
      rows, (uint64_t*)(chunks > 1 ? part : out), total, n, rw, chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  // every proof's rows one after another: (proofs x total, chunks) sums
  const long long all = proofs * total;
  openings_sum_kernel<<<(unsigned)((all + D_WARPS - 1) / D_WARPS), D_THREADS, 0, s>>>(
      (const uint64_t*)part, (uint64_t*)out, all, chunks);
  return (int)cudaGetLastError();
}

template <int A_BITS>
cudaError_t launch_fold(const uint64_t* leaves, const FoldConsts& k, const uint64_t* ch,
                        long long ch_stride, int beta_slot, uint64_t* out, long long mp,
                        int mp_bits, int next_bits, int proofs, cudaStream_t s) {
  constexpr int SMALL = A_BITS - 1;  // threads a row 2^S: small layers
  constexpr int LARGE = E_LARGE_S < SMALL ? E_LARGE_S : SMALL;
  if (mp <= E_SPREAD_ROWS) {
    const long long blocks = (mp + (E_THREADS >> SMALL) - 1) / (E_THREADS >> SMALL);
    fold_kernel<A_BITS, SMALL><<<dim3((unsigned)blocks, (unsigned)proofs), E_THREADS, 0, s>>>(
        leaves, k, ch, ch_stride, beta_slot, out, mp, mp_bits, next_bits);
  } else {
    const long long blocks = (mp + (E_THREADS >> LARGE) - 1) / (E_THREADS >> LARGE);
    fold_kernel<A_BITS, LARGE><<<dim3((unsigned)blocks, (unsigned)proofs), E_THREADS, 0, s>>>(
        leaves, k, ch, ch_stride, beta_slot, out, mp, mp_bits, next_bits);
  }
  return cudaGetLastError();
}

// For `proofs` proofs of one FRI schedule: leaves: device (proofs, mp,
// 2^(a_bits + 1)), each proof's layer of the round; consts: host uint64
// (FOLD_CONST_WORDS,): w^(-2^b) for b < 32, the fold constants
// shift^(-2^t) w_t^(-j m') (2^a - 1 used) and 2^-a (fri/prover.py::
// _fold_consts), the same for every proof; ch: device challenge records
// (challenges.cuh), proof p's at p * ch_stride words, its round beta at
// words beta_slot, beta_slot + 1; out: (proofs, mp) extension values, each
// proof's as (mp >> next_bits, 2^(next_bits + 1)) leaf rows of the next
// round.
extern "C" int qzk_fri_fold(const void* leaves, const void* consts, const void* ch,
                            long long ch_stride, int beta_slot, void* out, long long mp,
                            int a_bits, int next_bits, int proofs, void* stream) {
  if (a_bits < 1 || a_bits > MAX_ARITY_BITS || next_bits < 0 || next_bits > MAX_ARITY_BITS ||
      mp < 1 || (mp & (mp - 1)) || mp > (1LL << 31) || (mp >> next_bits) < 1 || proofs < 1 ||
      proofs > MAX_PROOFS || ch == nullptr || beta_slot < 0 || beta_slot + 2 > rec::WORDS ||
      (proofs > 1 && ch_stride < rec::WORDS))
    return (int)cudaErrorInvalidValue;
  FoldConsts k{};
  memcpy(&k, consts, FOLD_CONST_WORDS * sizeof(uint64_t));
  int mp_bits = 0;
  while ((1LL << mp_bits) < mp) ++mp_bits;
  auto lv = (const uint64_t*)leaves;
  auto c = (const uint64_t*)ch;
  auto o = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a_bits) {
    case 1: return (int)launch_fold<1>(lv, k, c, ch_stride, beta_slot, o, mp, mp_bits, next_bits,
                                       proofs, s);
    case 2: return (int)launch_fold<2>(lv, k, c, ch_stride, beta_slot, o, mp, mp_bits, next_bits,
                                       proofs, s);
    case 3: return (int)launch_fold<3>(lv, k, c, ch_stride, beta_slot, o, mp, mp_bits, next_bits,
                                       proofs, s);
    default: return (int)launch_fold<4>(lv, k, c, ch_stride, beta_slot, o, mp, mp_bits,
                                        next_bits, proofs, s);
  }
}

// plan: host bytes of a GatherPlan (fri/prover.py::pack_gather_plan): its
// out pointer (pinned host memory, translated here to its device address,
// or device memory), counts, each proof's sources in packed-row order, the
// segments' shapes and each proof's query-index vector on the card. One
// launch, a block a query of a proof, of the packed row's width rounded up
// to a warp (at most F_MAX_THREADS).
extern "C" int qzk_query_gather(const void* plan, void* stream) {
  GatherPlan p;
  memcpy(&p, plan, sizeof(GatherPlan));
  if (p.queries < 1 || p.queries > F_MAX_QUERIES || p.segments < 1 ||
      p.segments > F_MAX_SEGS || p.row_width < 1 || p.proofs < 1 || p.proofs > MAX_PROOFS ||
      24 + (8LL * p.proofs + 16) * p.segments + 8LL * p.proofs > F_PLAN_BYTES)
    return (int)cudaErrorInvalidValue;
  const uint64_t* const* srcs = (const uint64_t* const*)p.body;
  for (int i = 0; i < p.proofs * p.segments; ++i)
    if (srcs[i] == nullptr) return (int)cudaErrorInvalidValue;
  const uint64_t* const* idx = (const uint64_t* const*)(p.body + (8 * p.proofs + 16) * p.segments);
  for (int i = 0; i < p.proofs; ++i)
    if (idx[i] == nullptr) return (int)cudaErrorInvalidValue;
  const GatherShape* seg = (const GatherShape*)(p.body + 8 * p.proofs * p.segments);
  int end = 0;
  for (int s = 0; s < p.segments; ++s) {
    const GatherShape& g = seg[s];
    if (g.offset != end || g.width < 1 || g.mask_bits > 32 ||
        (g.levels && (g.width != 4 * g.levels || g.shift || g.levels > g.mask_bits)))
      return (int)cudaErrorInvalidValue;
    end += g.width;
  }
  if (end != p.row_width) return (int)cudaErrorInvalidValue;
  cudaPointerAttributes at{};
  cudaError_t e = cudaPointerGetAttributes(&at, p.out);
  if (e != cudaSuccess) return (int)e;
  if (at.type == cudaMemoryTypeHost) {  // pinned host memory: its mapped device address
    void* dev = nullptr;
    e = cudaHostGetDevicePointer(&dev, p.out, 0);
    if (e != cudaSuccess) return (int)e;
    p.out = (uint64_t*)dev;
  } else if (at.type != cudaMemoryTypeDevice) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = p.row_width >= F_MAX_THREADS ? F_MAX_THREADS : (p.row_width + 31) / 32 * 32;
  gather_kernel<<<(unsigned)(p.proofs * p.queries), threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
