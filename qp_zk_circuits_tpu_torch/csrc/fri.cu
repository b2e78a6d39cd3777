// Kernels C-F: the FRI tail of the prover, from the quotient commit to the
// proof. Each entry launches on the caller's stream (kernel C twice, the
// others once), allocates nothing and returns the launches' cudaError_t.
//
// Kernel C, qzk_fri_composition (fri/prover.py::compute_composition).
//   Replaces the JAX package's fri/prover.py::compute_composition (its
//   _get_q_jit run) and plonk/prover_fused.py::fused lines 655-696:
//     Q(x_i) = sum_b (sum_{k in b} alpha^k p_k(x_i) - c_b) / (x_i - z_b)
//   over the m LDE points. Two launches: one block forms alpha^k for every
//   term (the powers run on across the batches) and each batch's
//   c_b = sum_k alpha^k y_k from the claimed openings y, so the host does no
//   extension arithmetic; then the main launch reads the columns p_k in
//   place from the oracles' (C, m) LDEs through a per-circuit (oracle, row)
//   table. A block takes 32 points and splits each batch's column sum
//   across 8 thread rows, which reduce in shared memory; then thread row b
//   finishes batch b (one Fermat power of the norm of x - z_b, inv(0) = 0)
//   and row 0 adds the batches. Q is written in the leaf layout of the
//   first FRI round (see kernel E). Bound: every column
//   read once (about 255 x 2048 x 8 B = 4.2 MB at the leaf, 1.25 us at
//   3.35 TB/s) and two multiplies and two adds a term and point (1.35 us at
//   the card's 32-bit integer rate): operations, just. Any m.
//
// Kernel D, qzk_eval_openings (fri/oracle.py::eval_openings).
//   Replaces the JAX package's fri/oracle.py::eval_openings
//   (_jitted_eval_many) and the fused prover's _eval_coeffs_at with
//   _ext_powers_j: every listed coefficient row at its point,
//     y_c = sum_i coeffs[c, i] * z^i   (z = zeta or g * zeta, extension).
//   One warp per row: lane l forms z^l and z^32 in registers and strides the
//   n coefficients, then a shuffle reduction. Bound: the rows read once
//   (about 0.5 MB at the leaf, 0.16 us) and two multiplies and two adds a
//   coefficient, slightly more: operations. Any n.
//
// Kernel E, qzk_fri_fold (fri/prover.py::fold_round).
//   Replaces the JAX package's fri/prover.py::_fold_step applied a times and
//   _regroup_leaves (fused prover lines 698-718). A round's layer of m
//   values is held as the (m', 2^(a+1)) leaf matrix its Merkle tree hashes:
//   row q is the arity coset v[q + j m'], j < 2^a. The round's beta comes
//   from the transcript after that tree's cap, so the leaves cannot wait for
//   the fold: the layer's producer writes them (kernel C for the first
//   round, this kernel for the next), and no transpose copy is made. Thread q
//   reads leaf row q and runs the a binary folds in registers,
//     new_i = (e_i + o_i + beta^(2^t) inv_x_t[i] (e_i - o_i)) / 2,
//   with the inverse twiddles of fri/prover.py::_inv_x_table, all a tables
//   concatenated, uploaded once per device; it writes its value into the
//   next round's leaf layout (arity 0: natural order, for the final
//   polynomial). a = 1..4 (one instantiation each). Bound: operations, about
//   nine multiplies and eight adds for each of the m - m' values the folds
//   make, against m values read and m' written. Any m.
//
// Kernel F, qzk_query_gather (fri/prover.py::query_gather, called by
// gather_query_rounds).
//   Replaces the JAX package's fri/oracle.py::open_rows_many
//   (_jitted_open_rows), hash/merkle.py::MerkleTree.prove on the host, and
//   the fused prover's query gathers (lines 740-779). A plan of segments
//   (source matrix, strides, width, and the row rule
//   r = ((q & mask) >> shift) ^ flip) says where each value of a query's
//   packed row comes from: the oracles' leaf rows, their Merkle siblings
//   ((q >> l) ^ 1), each FRI round's leaf and its siblings. Block (query,
//   segment) copies one segment. Bound: bytes, the values gathered.
#include <cuda_runtime.h>

#include "extension.cuh"

namespace {

constexpr int MAX_ORACLES = 8;
constexpr int MAX_BATCHES = 4;
constexpr int MAX_ARITY_BITS = 4;
constexpr uint64_t INV2 = 0x7FFFFFFF80000001ULL;  // 1/2 = (p + 1) / 2

// Value i of a layer held as leaf rows of arity 2^a_bits, rows = m >> a_bits:
// row i mod rows, column i / rows (a_bits = 0 is natural order).
__device__ __forceinline__ long long leaf_slot(long long i, long long rows, int a_bits) {
  return ((i & (rows - 1)) << a_bits) + (i / rows);
}

// ---------------------------------------------------------------------------
// kernel C

constexpr int C_POINTS = 32;
constexpr int C_GROUPS = 8;  // >= MAX_BATCHES: thread row b finishes batch b

struct Sources {
  const uint64_t* p[MAX_ORACLES];
};

struct Batches {
  int n;
  int start[MAX_BATCHES + 1];  // batch b's terms are [start[b], start[b + 1])
  uint64_t z0[MAX_BATCHES], z1[MAX_BATCHES];  // the batch's point
};

constexpr int S_THREADS = 256;

// apows[k] = alpha^k for every term; cb[b] = sum over batch b's terms of
// alpha^k y_k. One block: thread t walks k = t, t + 256, ...
__global__ void __launch_bounds__(S_THREADS)
    composition_scalars_kernel(ext::E alpha, const uint64_t* __restrict__ ys, Batches b,
                               uint64_t* __restrict__ apows, uint64_t* __restrict__ cb) {
  __shared__ uint64_t red[MAX_BATCHES][2][S_THREADS];
  const int t = threadIdx.x;
  ext::E part[MAX_BATCHES];
#pragma unroll
  for (int bi = 0; bi < MAX_BATCHES; ++bi) part[bi] = {0, 0};
  ext::E ak = ext::pow(alpha, t);
  const ext::E step = ext::pow(alpha, S_THREADS);
  for (int k = t; k < b.start[b.n]; k += S_THREADS) {
    apows[2 * k] = ak.c0;
    apows[2 * k + 1] = ak.c1;
    const ext::E term = ext::mul(ak, {ys[2 * k], ys[2 * k + 1]});
#pragma unroll
    for (int bi = 0; bi < MAX_BATCHES; ++bi)
      if (bi < b.n && k >= b.start[bi] && k < b.start[bi + 1]) part[bi] = ext::add(part[bi], term);
    ak = ext::mul(ak, step);
  }
#pragma unroll
  for (int bi = 0; bi < MAX_BATCHES; ++bi) {
    red[bi][0][t] = part[bi].c0;
    red[bi][1][t] = part[bi].c1;
  }
  __syncthreads();
  for (int s = S_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int bi = 0; bi < MAX_BATCHES; ++bi) {
        red[bi][0][t] = gl::add(red[bi][0][t], red[bi][0][t + s]);
        red[bi][1][t] = gl::add(red[bi][1][t], red[bi][1][t + s]);
      }
    }
    __syncthreads();
  }
  if (t < b.n) {
    cb[2 * t] = red[t][0][0];
    cb[2 * t + 1] = red[t][1][0];
  }
}

__global__ void __launch_bounds__(C_POINTS* C_GROUPS)
    composition_kernel(Sources src, const int* __restrict__ terms,
                       const uint64_t* __restrict__ apows, const uint64_t* __restrict__ cb,
                       const uint64_t* __restrict__ xs, Batches b, uint64_t* __restrict__ out,
                       long long m, int a_bits) {
  __shared__ const uint64_t* base[MAX_ORACLES];
  __shared__ uint64_t part[MAX_BATCHES][2][C_GROUPS][C_POINTS];
  const int tx = threadIdx.x, g = threadIdx.y;
  if (tx == 0 && g == 0) {
#pragma unroll
    for (int o = 0; o < MAX_ORACLES; ++o) base[o] = src.p[o];
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * C_POINTS + tx;
  const bool live = i < m;
  for (int bi = 0; bi < b.n; ++bi) {
    ext::E acc = {0, 0};
    if (live) {
      for (int k = b.start[bi] + g; k < b.start[bi + 1]; k += C_GROUPS) {
        const uint64_t v = base[terms[2 * k]][(long long)terms[2 * k + 1] * m + i];
        acc = ext::add(acc, ext::scale({apows[2 * k], apows[2 * k + 1]}, v));
      }
    }
    part[bi][0][g][tx] = acc.c0;
    part[bi][1][g][tx] = acc.c1;
  }
  __syncthreads();
  if (g < b.n && live) {
    // only this thread touches part[g][*][*][tx] here
    ext::E s = {part[g][0][0][tx], part[g][1][0][tx]};
    for (int h = 1; h < C_GROUPS; ++h) s = ext::add(s, {part[g][0][h][tx], part[g][1][h][tx]});
    const ext::E xz = {gl::sub(xs[i], b.z0[g]), gl::sub(0, b.z1[g])};
    const ext::E c = ext::mul(ext::sub(s, {cb[2 * g], cb[2 * g + 1]}), ext::inv(xz));
    part[g][0][0][tx] = c.c0;
    part[g][1][0][tx] = c.c1;
  }
  __syncthreads();
  if (g == 0 && live) {
    ext::E q = {part[0][0][0][tx], part[0][1][0][tx]};
    for (int bi = 1; bi < b.n; ++bi) q = ext::add(q, {part[bi][0][0][tx], part[bi][1][0][tx]});
    const long long at = leaf_slot(i, m >> a_bits, a_bits);
    out[2 * at] = q.c0;
    out[2 * at + 1] = q.c1;
  }
}

// ---------------------------------------------------------------------------
// kernel D

constexpr int D_WARPS = 8;
constexpr int MAX_SEGS = MAX_ORACLES + 1;

// consecutive output rows: segment s is rows[s] coefficient rows from p[s],
// evaluated at point[s] (0 = zeta, 1 = g * zeta)
struct Rows {
  const uint64_t* p[MAX_SEGS];
  long long rows[MAX_SEGS];
  int point[MAX_SEGS];
  int n;
  uint64_t z0[2], z1[2];  // zeta and g * zeta
};

__global__ void __launch_bounds__(32 * D_WARPS)
    openings_kernel(Rows rows, uint64_t* __restrict__ out, long long total, int n) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * D_WARPS + (threadIdx.x >> 5);
  const uint64_t* col = nullptr;
  int pt = 0;
  long long rem = r;
#pragma unroll
  for (int s = 0; s < MAX_SEGS; ++s) {
    if (col == nullptr && s < rows.n && r < total) {
      if (rem < rows.rows[s]) {
        col = rows.p[s] + rem * n;
        pt = rows.point[s];
      } else {
        rem -= rows.rows[s];
      }
    }
  }
  ext::E acc = {0, 0};
  if (col != nullptr) {
    const ext::E z = {pt ? rows.z0[1] : rows.z0[0], pt ? rows.z1[1] : rows.z1[0]};
    const ext::E z32 = ext::pow(z, 32);
    ext::E zi = ext::pow(z, lane);  // z^i for i = lane, lane + 32, ...
    for (int i = lane; i < n; i += 32) {
      acc = ext::add(acc, ext::scale(zi, col[i]));
      zi = ext::mul(zi, z32);
    }
  }
  // every lane of the warp takes part: the warp shares one row
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc.c0 = gl::add(acc.c0, __shfl_down_sync(0xffffffffu, (unsigned long long)acc.c0, off));
    acc.c1 = gl::add(acc.c1, __shfl_down_sync(0xffffffffu, (unsigned long long)acc.c1, off));
  }
  if (lane == 0 && col != nullptr) {
    out[2 * r] = acc.c0;
    out[2 * r + 1] = acc.c1;
  }
}

// ---------------------------------------------------------------------------
// kernel E

constexpr int E_THREADS = 128;

struct Betas {
  uint64_t c0[MAX_ARITY_BITS], c1[MAX_ARITY_BITS];  // beta^(2^t)
};

template <int A_BITS>
__global__ void __launch_bounds__(E_THREADS)
    fold_kernel(const uint64_t* __restrict__ leaves, const uint64_t* __restrict__ inv_x, Betas beta,
                uint64_t* __restrict__ out, long long mp, int next_bits) {
  constexpr int A = 1 << A_BITS;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= mp) return;
  ext::E v[A];
#pragma unroll
  for (int j = 0; j < A; ++j) v[j] = {leaves[q * 2 * A + 2 * j], leaves[q * 2 * A + 2 * j + 1]};
  long long off = 0;              // fold t's table within inv_x
  long long half = mp * (A / 2);  // half the layer folded by fold t
#pragma unroll
  for (int t = 0; t < A_BITS; ++t) {
    const ext::E bt = {beta.c0[t], beta.c1[t]};
#pragma unroll
    for (int j = 0; j < (A >> (t + 1)); ++j) {
      const ext::E e = v[j], o = v[j + (A >> (t + 1))];
      const ext::E d = ext::mul(ext::scale(ext::sub(e, o), inv_x[off + q + j * mp]), bt);
      v[j] = ext::scale(ext::add(ext::add(e, o), d), INV2);
    }
    off += half;
    half >>= 1;
  }
  const long long at = leaf_slot(q, mp >> next_bits, next_bits);
  out[2 * at] = v[0].c0;
  out[2 * at + 1] = v[0].c1;
}

// ---------------------------------------------------------------------------
// kernel F

constexpr int F_THREADS = 64;
// a plan segment: source address, row stride, column stride, width, mask,
// shift, flip, offset in the packed row
constexpr int SEG_W = 8;

__global__ void __launch_bounds__(F_THREADS)
    gather_kernel(const long long* __restrict__ plan, int queries, uint64_t* __restrict__ out,
                  long long row_width) {
  const long long* seg = plan + queries + (long long)SEG_W * blockIdx.y;
  const long long q = plan[blockIdx.x];
  const uint64_t* src = (const uint64_t*)seg[0];
  const long long r = ((q & seg[4]) >> seg[5]) ^ seg[6];
  uint64_t* dst = out + (long long)blockIdx.x * row_width + seg[7];
  for (long long j = threadIdx.x; j < seg[3]; j += blockDim.x) dst[j] = src[r * seg[1] + j * seg[2]];
}

bool grid_fits(long long blocks) { return blocks >= 1 && blocks <= 0x7FFFFFFFLL; }

}  // namespace

// sources: host array of n_sources device pointers (the oracles' (C, m)
// LDEs); terms: device int32 (K, 2) (oracle, row); ys: device (K, 2) claimed
// openings; xs: device (m,) domain points; batches: host uint64
// (n_batches, 3) rows (end, z0, z1), batch b's terms [end[b - 1], end[b]);
// alpha: host uint64 (2,); apows (K, 2) and cb (n_batches, 2): device
// scratch; out: m extension values as (m >> a_bits, 2^(a_bits + 1)) leaf
// rows. Two launches.
extern "C" int qzk_fri_composition(const void* sources, int n_sources, const void* terms,
                                   const void* ys, const void* xs, const void* batches,
                                   int n_batches, const void* alpha, void* apows, void* cb,
                                   void* out, long long m, int a_bits, void* stream) {
  const long long blocks = (m + C_POINTS - 1) / C_POINTS;
  if (n_sources < 1 || n_sources > MAX_ORACLES || n_batches < 1 || n_batches > MAX_BATCHES ||
      !grid_fits(blocks) || a_bits < 0 || a_bits > MAX_ARITY_BITS || (m & (m - 1)) ||
      (m >> a_bits) < 1)
    return (int)cudaErrorInvalidValue;
  Sources src{};
  for (int o = 0; o < n_sources; ++o) src.p[o] = ((const uint64_t* const*)sources)[o];
  Batches b{};
  b.n = n_batches;
  const uint64_t* h = (const uint64_t*)batches;
  for (int t = 0; t < n_batches; ++t) {
    b.start[t + 1] = (int)h[3 * t];
    b.z0[t] = h[3 * t + 1];
    b.z1[t] = h[3 * t + 2];
    if (b.start[t + 1] < b.start[t]) return (int)cudaErrorInvalidValue;
  }
  const ext::E a = {((const uint64_t*)alpha)[0], ((const uint64_t*)alpha)[1]};
  cudaStream_t s = (cudaStream_t)stream;
  composition_scalars_kernel<<<1, S_THREADS, 0, s>>>(a, (const uint64_t*)ys, b, (uint64_t*)apows,
                                                     (uint64_t*)cb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  composition_kernel<<<(unsigned)blocks, dim3(C_POINTS, C_GROUPS), 0, s>>>(
      src, (const int*)terms, (const uint64_t*)apows, (const uint64_t*)cb, (const uint64_t*)xs, b,
      (uint64_t*)out, m, a_bits);
  return (int)cudaGetLastError();
}

// segs: host uint64 (n_segs, 3) rows (device address of the first row,
// row count, point); points: host uint64 (2, 2), zeta and g * zeta;
// out: (total rows, 2).
extern "C" int qzk_eval_openings(const void* segs, int n_segs, const void* points, void* out,
                                 int n, void* stream) {
  if (n_segs < 1 || n_segs > MAX_SEGS || n < 1) return (int)cudaErrorInvalidValue;
  Rows rows{};
  rows.n = n_segs;
  long long total = 0;
  const uint64_t* h = (const uint64_t*)segs;
  for (int s = 0; s < n_segs; ++s) {
    rows.p[s] = (const uint64_t*)h[3 * s];
    rows.rows[s] = (long long)h[3 * s + 1];
    rows.point[s] = (int)h[3 * s + 2];
    if (rows.point[s] < 0 || rows.point[s] > 1) return (int)cudaErrorInvalidValue;
    total += rows.rows[s];
  }
  const uint64_t* z = (const uint64_t*)points;
  for (int pt = 0; pt < 2; ++pt) {
    rows.z0[pt] = z[2 * pt];
    rows.z1[pt] = z[2 * pt + 1];
  }
  const long long blocks = (total + D_WARPS - 1) / D_WARPS;
  if (!grid_fits(blocks)) return (int)cudaErrorInvalidValue;
  openings_kernel<<<(unsigned)blocks, 32 * D_WARPS, 0, (cudaStream_t)stream>>>(
      rows, (uint64_t*)out, total, n);
  return (int)cudaGetLastError();
}

// leaves: device (mp, 2^(a_bits + 1)), the round's layer; inv_x: device,
// the a fold tables concatenated; betas: host uint64 (a_bits, 2)
// beta^(2^t); out: mp extension values as (mp >> next_bits,
// 2^(next_bits + 1)) leaf rows of the next round.
extern "C" int qzk_fri_fold(const void* leaves, const void* inv_x, const void* betas, void* out,
                            long long mp, int a_bits, int next_bits, void* stream) {
  const long long blocks = (mp + E_THREADS - 1) / E_THREADS;
  if (a_bits < 1 || a_bits > MAX_ARITY_BITS || next_bits < 0 || next_bits > MAX_ARITY_BITS ||
      (mp & (mp - 1)) || (mp >> next_bits) < 1 || !grid_fits(blocks))
    return (int)cudaErrorInvalidValue;
  Betas b{};
  const uint64_t* h = (const uint64_t*)betas;
  for (int t = 0; t < a_bits; ++t) {
    b.c0[t] = h[2 * t];
    b.c1[t] = h[2 * t + 1];
  }
  auto lv = (const uint64_t*)leaves;
  auto ix = (const uint64_t*)inv_x;
  auto o = (uint64_t*)out;
  const int nb = next_bits;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a_bits) {
    case 1: fold_kernel<1><<<(unsigned)blocks, E_THREADS, 0, s>>>(lv, ix, b, o, mp, nb); break;
    case 2: fold_kernel<2><<<(unsigned)blocks, E_THREADS, 0, s>>>(lv, ix, b, o, mp, nb); break;
    case 3: fold_kernel<3><<<(unsigned)blocks, E_THREADS, 0, s>>>(lv, ix, b, o, mp, nb); break;
    default: fold_kernel<4><<<(unsigned)blocks, E_THREADS, 0, s>>>(lv, ix, b, o, mp, nb); break;
  }
  return (int)cudaGetLastError();
}

// plan: device int64, the query indices then (segments, SEG_W) rows; out:
// (queries, row_width).
extern "C" int qzk_query_gather(const void* plan, int queries, int segments, void* out,
                                long long row_width, void* stream) {
  if (queries < 1 || segments < 1 || segments > 65535) return (int)cudaErrorInvalidValue;
  gather_kernel<<<dim3((unsigned)queries, (unsigned)segments), F_THREADS, 0,
                  (cudaStream_t)stream>>>((const long long*)plan, queries, (uint64_t*)out,
                                          row_width);
  return (int)cudaGetLastError();
}
