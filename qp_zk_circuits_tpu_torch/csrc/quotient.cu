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
// Design: the constraint list is cut into groups, one per entry of a gate
// descriptor table built once per circuit (plonk/gates.py::gate_descriptor):
// each gate type is one group, and the permutation part of each challenge is
// one. Block (bx, g) evaluates group g at 128 points in registers, reading
// the wire, constant and Z rows of the (C, m) LDE matrices in place (k_i * x
// is formed in registers, not read from a table), and writes its partial
// sums (G, nc, m). A second launch adds the G partials and multiplies by
// 1/Z_H. So the (K, m) constraint matrix of the torch version never exists,
// and at the leaf (m = 2048) the first launch runs 16 x G blocks instead of
// 16. The Poseidon2 gate's round constants and diagonal are this unit's own
// __constant__ copies, uploaded by qzk_quotient_set_constants from the same
// host generator as kernel 2's.
//
// Bound on the H100: integer operations. The function needs about 2,600
// field multiplies and 2,200 adds a point of the leaf (Poseidon2 gate,
// permutation products, the alpha sums) against about 2 KB of reads;
// chip_smoke.py::quotient_field_ops counts both from the descriptor table.
// This kernel spends more: k_i * x once per challenge and the G-partial sum.
// The Poseidon2 group, a serial chain of dependent multiplies on 16 blocks,
// sets the kernel's time at the leaf.
#include <cuda_runtime.h>

#include "poseidon2.cuh"

namespace {

constexpr int MAX_NC = 4;
constexpr int DESC_W = 6;  // plonk/prover.py::DESC_WIDTH
constexpr int THREADS = 128;

// descriptor row: type, p0, p1, p2, selector row (or -1), first constraint
// index. The type ids are those of plonk/gates.py::GATE_TYPE_IDS and
// PERMUTATION_TYPE_ID, the one table of them: change them there and here
// together (chip_smoke.py's op counts key on that table).
enum : int {
  T_NOOP = 0,
  T_ARITH = 1,      // p0 = num_ops
  T_CONST = 2,      // p0 = num_consts
  T_PUBLIC_INPUT = 3,
  T_POSEIDON2 = 4,
  T_REDUCING = 5,   // p0 = num_coeffs, p1 = ext, p2 = scratch
  T_BASE_SUM = 6,   // p0 = num_bits
  T_PERMUTATION = 7 // p0 = challenge
};

// Poseidon2Gate wire layout (plonk/gates.py)
constexpr int W_IN = 0, W_OUT = 12, W_EXT_A = 24, W_INT = 72, W_EXT_B = 94;

__constant__ uint64_t c_ext_rc[p2::ROUNDS_F][p2::WIDTH];
__constant__ uint64_t c_int_rc[p2::ROUNDS_P];
__constant__ uint64_t c_diag[p2::WIDTH];

struct Args {
  const uint64_t* wires;   // (num_wires, m)
  const uint64_t* consts;  // (nconst + nsel + nr, m): constants, selectors, sigmas
  const uint64_t* zpp;     // (nc + nc * npp, m): Z per challenge, then partial products
  const uint64_t* xs;      // (m,) the coset points
  const uint64_t* l1;      // (m,) L_1(x)
  const uint64_t* ks;      // (nr,) coset shifts k_i
  const uint64_t* scal;    // betas (nc), gammas (nc), pi hash (4), alpha powers (nc, K)
  const int* desc;         // (G, DESC_W)
  uint64_t* partial;       // (G, nc, m)
  int m, rate, nr, qdf, npp, nc, nconst, nsel, K;
};

// Point x of one group: operand reads and the alpha-weighted accumulators.
struct Point {
  const Args& a;
  int x;
  int k;  // index of the next constraint in the canonical list
  uint64_t acc[MAX_NC];

  __device__ __forceinline__ uint64_t wire(int i) const {
    return __ldg(a.wires + (long long)i * a.m + x);
  }
  __device__ __forceinline__ uint64_t constant(int row) const {
    return __ldg(a.consts + (long long)row * a.m + x);
  }
  __device__ __forceinline__ uint64_t zpp(int row, int at) const {
    return __ldg(a.zpp + (long long)row * a.m + at);
  }
  // acc_c += alpha_c^k * con, then k += 1
  __device__ __forceinline__ void emit(uint64_t con) {
    const uint64_t* apow = a.scal + 2 * a.nc + 4 + k;
#pragma unroll
    for (int c = 0; c < MAX_NC; ++c) {
      if (c < a.nc) acc[c] = gl::add(acc[c], gl::mul(con, __ldg(apow + (long long)c * a.K)));
    }
    ++k;
  }
};

__device__ __forceinline__ void eval_arith(Point& p, int num_ops) {
  const uint64_t c0 = p.constant(0), c1 = p.constant(1);
  for (int i = 0; i < num_ops; ++i) {
    uint64_t t = gl::mul(c0, gl::mul(p.wire(4 * i), p.wire(4 * i + 1)));
    t = gl::add(t, gl::mul(c1, p.wire(4 * i + 2)));
    p.emit(gl::sub(p.wire(4 * i + 3), t));
  }
}

__device__ __forceinline__ void eval_poseidon2(Point& p) {
  uint64_t s[p2::WIDTH];
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) s[i] = p.wire(W_IN + i);
  p2::external_linear(s);
  // external rounds 1-4: the S-box outputs are wires
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < p2::WIDTH; ++i) {
      const uint64_t w = p.wire(W_EXT_A + 12 * r + i);
      p.emit(gl::sub(w, p2::sbox(gl::add(s[i], c_ext_rc[r][i]))));
      s[i] = w;
    }
    p2::external_linear(s);
  }
  // internal rounds: the lane-0 S-box outputs are wires
  for (int r = 0; r < p2::ROUNDS_P; ++r) {
    const uint64_t w = p.wire(W_INT + r);
    p.emit(gl::sub(w, p2::sbox(gl::add(s[0], c_int_rc[r]))));
    s[0] = w;
    p2::internal_linear(s, c_diag);
  }
  // external rounds 5-7: wires
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < p2::WIDTH; ++i) {
      const uint64_t w = p.wire(W_EXT_B + 12 * r + i);
      p.emit(gl::sub(w, p2::sbox(gl::add(s[i], c_ext_rc[4 + r][i]))));
      s[i] = w;
    }
    p2::external_linear(s);
  }
  // round 8 folds into the output constraint
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) s[i] = p2::sbox(gl::add(s[i], c_ext_rc[7][i]));
  p2::external_linear(s);
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) p.emit(gl::sub(p.wire(W_OUT + i), s[i]));
}

// Horner steps over F_p[X]/(X^2 - 7): acc' = acc * alpha + coeff.
__device__ __forceinline__ void eval_reducing(Point& p, int num_coeffs, int ext, int scratch) {
  const uint64_t a0 = p.wire(0), a1 = p.wire(1);
  uint64_t p0 = p.wire(2), p1 = p.wire(3);
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

__device__ __forceinline__ void eval_base_sum(Point& p, int num_bits) {
  uint64_t sum = 0, pw = 1;
  for (int i = 0; i < num_bits; ++i) {
    const uint64_t b = p.wire(1 + i);
    p.emit(gl::mul(b, gl::sub(b, 1)));
    sum = gl::add(sum, gl::mul(b, pw));
    pw = gl::add(pw, pw);
  }
  p.emit(gl::sub(p.wire(0), sum));
}

__device__ __forceinline__ void eval_permutation(Point& p, int c) {
  const Args& a = p.a;
  const uint64_t beta = a.scal[c], gamma = a.scal[a.nc + c];
  const uint64_t x = __ldg(a.xs + p.x);
  const uint64_t z = p.zpp(c, p.x);
  p.emit(gl::mul(__ldg(a.l1 + p.x), gl::sub(z, 1)));
  const int nchunks = (a.nr + a.qdf - 1) / a.qdf;
  uint64_t prev = z;
  for (int j = 0; j < nchunks; ++j) {
    uint64_t num = 1, den = 1;
    const int end = min(a.nr, (j + 1) * a.qdf);
    for (int i = j * a.qdf; i < end; ++i) {
      const uint64_t w = p.wire(i);
      const uint64_t kx = gl::mul(__ldg(a.ks + i), x);
      num = gl::mul(num, gl::add(gl::add(w, gl::mul(beta, kx)), gamma));
      const uint64_t sigma = p.constant(a.nconst + a.nsel + i);
      den = gl::mul(den, gl::add(gl::add(w, gl::mul(beta, sigma)), gamma));
    }
    // Z(g x) is the LDE row shifted by the rate
    const uint64_t nxt = (j == nchunks - 1) ? p.zpp(c, (p.x + a.rate) % a.m)
                                             : p.zpp(a.nc + c * a.npp + j, p.x);
    p.emit(gl::sub(gl::mul(nxt, den), gl::mul(prev, num)));
    prev = nxt;
  }
}

__global__ void __launch_bounds__(THREADS) quotient_partial_kernel(Args a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= a.m) return;
  const int* d = a.desc + blockIdx.y * DESC_W;
  Point p{a, x, d[5], {0, 0, 0, 0}};
  switch (d[0]) {
    case T_ARITH: eval_arith(p, d[1]); break;
    case T_CONST:
      for (int i = 0; i < d[1]; ++i) p.emit(gl::sub(p.wire(i), p.constant(i)));
      break;
    case T_PUBLIC_INPUT:
      for (int i = 0; i < 4; ++i) p.emit(gl::sub(p.wire(i), a.scal[2 * a.nc + i]));
      break;
    case T_POSEIDON2: eval_poseidon2(p); break;
    case T_REDUCING: eval_reducing(p, d[1], d[2], d[3]); break;
    case T_BASE_SUM: eval_base_sum(p, d[1]); break;
    case T_PERMUTATION: eval_permutation(p, d[1]); break;
    default: break;  // T_NOOP: no constraints
  }
  // sum_k alpha^k * sel * C_k = sel * sum_k alpha^k * C_k
  const int sel = d[4];
  const uint64_t s = sel >= 0 ? p.constant(sel) : 1;
#pragma unroll
  for (int c = 0; c < MAX_NC; ++c) {
    if (c < a.nc) {
      a.partial[((long long)blockIdx.y * a.nc + c) * a.m + x] = sel >= 0 ? gl::mul(p.acc[c], s) : p.acc[c];
    }
  }
}

__global__ void __launch_bounds__(THREADS) quotient_combine_kernel(
    const uint64_t* __restrict__ partial, const uint64_t* __restrict__ inv_zh,
    uint64_t* __restrict__ out, int groups, int nc, int m) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nc * m) return;
  const int x = (int)(idx % m);
  uint64_t s = 0;
  for (int g = 0; g < groups; ++g) s = gl::add(s, partial[(long long)g * nc * m + idx]);
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

// Two launches: the partial sums of `groups` descriptor entries, then their
// sum times 1/Z_H into out (nc, m).
extern "C" int qzk_quotient(const void* wires, const void* consts, const void* zpp,
                            const void* xs, const void* l1, const void* inv_zh, const void* ks,
                            const void* scal, const void* desc, void* partial, void* out,
                            int groups, int m, int rate, int nr, int qdf, int npp, int nc,
                            int nconst, int nsel, int num_constraints, void* stream) {
  if (nc < 1 || nc > MAX_NC || m < 1 || groups < 1 || groups > 65535 || qdf < 1)
    return (int)cudaErrorInvalidValue;
  Args a{(const uint64_t*)wires, (const uint64_t*)consts, (const uint64_t*)zpp,
         (const uint64_t*)xs, (const uint64_t*)l1, (const uint64_t*)ks,
         (const uint64_t*)scal, (const int*)desc, (uint64_t*)partial,
         m, rate, nr, qdf, npp, nc, nconst, nsel, num_constraints};
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((m + THREADS - 1) / THREADS), (unsigned)groups);
  quotient_partial_kernel<<<grid, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)nc * m;
  quotient_combine_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const uint64_t*)partial, (const uint64_t*)inv_zh, (uint64_t*)out, groups, nc, m);
  return (int)cudaGetLastError();
}
