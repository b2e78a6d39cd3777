// Kernel 3: batched NTT / inverse NTT / coset LDE over Goldilocks.
//
// Replaces the XLA-compiled jnp functions poly/ntt.py::ntt_j (with _stage_j),
// intt_j and coset_lde_j of the JAX package: a (C, N) batch, natural order in
// and out, 1/N scale for the inverse, and for the LDE a x g^j shift plus
// zero-pad to N << rate. An optional output multiplier folds the quotient's
// g^-k unshift (plonk/prover.py::quotient_run after intt_j) into the inverse
// transform. Any N = 2^1 .. 2^24.
//
// What bounds it on the H100: at the leaf (C x 2^8 -> 2^11, one or a few
// blocks an SM) the chain of dependent field ops and barriers in a block;
// at the private batch's 2^19 the instruction rate (a butterfly is one
// 64-bit field multiply, an add and a sub: about 50 instructions).
//
// Design. One kernel, `ntt_pass`, runs T transforms of L = 2^l <= 2^12
// points a block with the tile in shared memory; a transform of N points
// is one pass (N <= 2^12) or two (the four-step split N = N1 N2: N2
// transforms of N1 points over the strided input, the twiddle w_N^(j2 k1),
// then N1 transforms of N2 points, through a scratch buffer the wrapper
// allocates). In a block:
//   * the tile is copied into shared memory with cp.async, every copy of a
//     thread in flight at once and each element straight to its
//     bit-reversed place, so the decimation-in-time stages come out in
//     natural order; neighbouring threads read neighbouring addresses
//     (along the transform when its elements are contiguous, across the T
//     transforms when they are strided: then T >= 4 makes each read 32 B or
//     more); the twiddle table w_L^e comes in the same way;
//   * the l stages run in register groups of up to three: a thread takes 8
//     values at stride 2^s0 and does the three stages' 12 butterflies, so 11
//     stages are 4 exchanges and barriers, not 11; tiles of 512 points run
//     radix-4 groups and smaller tiles radix-2 stages, so that 128 threads
//     share a tile's butterflies; only the first group has the code for the
//     input multiplier and the zero stages (runtime checks in every group
//     cost a third of the stage time at 2^19);
//   * a one-pass LDE of n = N >> r coefficients runs as 2^r transforms of n
//     points, output r' + 2^r q = NTT_n(c_k (g w_N^r')^k)[q]: no zero
//     stages, and the leaf's 135 columns make 540 blocks of two transforms
//     instead of 135 of one; elsewhere, inputs past L >> r that are zero
//     padding are never read and the first r stages are copies;
//   * the four-step twiddle, the 1/N scale and the output multiplier are
//     applied as the tile is written (the scale is folded into the
//     multiplier's table by the wrapper).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_TILE_BITS = 12;  // points of one transform in one block
constexpr int MAX_TILE = 16384;    // points of all T transforms in one block
constexpr int THREADS = 256;
constexpr int FULL_TWIDDLE_BITS = 20;  // up to 2^20 points the four-step twiddle is one table
constexpr int RADIX8_BITS = 10;  // tiles of 2^10 points and more: radix-8 groups
constexpr int RADIX4_BITS = 9;   // 2^9: radix 4; below: radix 2
constexpr int MAX_SMEM = (MAX_TILE + MAX_TILE / 16 + 4 + (1 << (MAX_TILE_BITS - 1))) * 8;

// one padding slot every 16 values: the radix-8 reads at stride 1 and 8
// fall on fewer shared banks
__host__ __device__ __forceinline__ int padded(int p) { return p + (p >> 4); }

// a transform's slots in the tile: odd, so the T transforms' elements of
// one index fall on T banks
__host__ __device__ __forceinline__ int tile_stride(int l) { return padded(1 << l) + 1; }

struct Pass {
  const uint64_t* in;
  uint64_t* out;
  const uint64_t* tw;    // w_L^e, e < L / 2 (forward or inverse roots)
  const uint64_t* pre;   // input multiplier by t * pre_ts + column-relative index, or null
  const uint64_t* post;  // output multiplier by column-relative index, or null
  // four-step twiddle w_N^e: twn[e] (h = 0), else twn[2^h + (e >> h)] twn[e & (2^h - 1)]; or null
  const uint64_t* twn;
  long long n_tr;        // transforms in all (2^pc_bits a column)
  // element (transform t of column c, index i) lies at c * cs + t * ts + i * s
  long long in_cs, in_ts, in_s, out_cs, out_ts, out_s;
  long long n_in;  // column-relative input indices >= n_in read as 0
  long long pre_ts;  // pre's stride a transform (the one-pass LDE's rows), else 0
  // group blockIdx.y's columns start at in + y * in_gs and out + y * out_gs
  // (a batch's LDEs, each followed by its salt rows); n_tr counts a group's
  long long in_gs, out_gs;
  uint64_t scale;  // multiplies every output when post is null and do_scale
  int l, t_bits, skip, h, do_scale, pc_bits;
  int radix;  // stages a register group: 1, 2 or 3
};

// An 8-byte copy from global to shared memory that does not wait (zeros when
// !valid: nothing is read), and the wait for all of a thread's copies.
__device__ __forceinline__ void copy_async8(uint64_t* dst, const uint64_t* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Stages s0 + skip + 1 .. s0 + B of every transform in the tile, B in
// registers. Item (tt, q): the 2^B values of transform tt at
// base + k 2^s0, base = q with a gap of B zero bits at s0. FIRST: the
// first group (s0 = 0), which also applies the input multiplier and the
// zero stages' copies; the other groups compile without those checks.
template <int B, bool FIRST>
__device__ void radix_group(const Pass& p, uint64_t* x, const uint64_t* tw, long long g0, int s0,
                            int skip) {
  constexpr int R = 1 << B;
  const int l = p.l;
  const int stride = tile_stride(l);
  const int items = 1 << (l - B + p.t_bits);
  const int lo_mask = (1 << s0) - 1;
  const bool pre = FIRST && p.pre != nullptr;
  if (!FIRST) skip = 0;
#pragma unroll 1
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int tt = it >> (l - B);
    const int q = it & ((1 << (l - B)) - 1);
    const int base = (q & lo_mask) | ((q >> s0) << (s0 + B));
    uint64_t* col = x + tt * stride;
    uint64_t v[R], f[R];
    // the values at positions with a low `skip` bit set are the zero
    // padding's: never stored, never read
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k & ((1 << skip) - 1)) continue;
      v[k] = col[padded(base + (k << s0))];
      f[k] = 1;
      if (pre) {
        const int i = (int)(__brev((unsigned)(base + k)) >> (32 - l));
        const long long t = (g0 + tt) & ((1LL << p.pc_bits) - 1);
        const long long j = t * p.in_ts + (long long)i * p.in_s;
        if (j < p.n_in) f[k] = p.pre[t * p.pre_ts + j];
      }
    }
    if (pre) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        if ((k & ((1 << skip) - 1)) == 0) v[k] = gl::mul(v[k], f[k]);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int half = 1 << u;
      const int shift = l - (s0 + u + 1);  // w_{2^s}^j = w_L^(j 2^(l - s))
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k & half) continue;
        if (u < skip) {  // the odd input is zero: the stage copies
          v[k + half] = v[k];
          continue;
        }
        const int j = (base & lo_mask) + ((k & (half - 1)) << s0);
        const uint64_t t = gl::mul(v[k + half], tw[j << shift]);
        v[k + half] = gl::sub(v[k], t);
        v[k] = gl::add(v[k], t);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) col[padded(base + (k << s0))] = v[k];
  }
}

__global__ void __launch_bounds__(THREADS, 3) ntt_pass(Pass p) {
  extern __shared__ uint64_t smem[];
  const uint64_t* in = p.in + blockIdx.y * p.in_gs;
  uint64_t* out = p.out + blockIdx.y * p.out_gs;
  const int l = p.l, L = 1 << l, T = 1 << p.t_bits;
  const int stride = tile_stride(l);
  uint64_t* x = smem;
  uint64_t* tw = smem + T * stride;
  const long long g0 = (long long)blockIdx.x << p.t_bits;
  const long long pc_mask = (1LL << p.pc_bits) - 1;

  // the twiddle table, then the inputs i < V of every transform (the rest
  // are zero and the first `skip` stages copy), each to its bit-reversed
  // place, all copies in flight at once
#pragma unroll 1
  for (int e = threadIdx.x; e < L / 2; e += blockDim.x) copy_async8(tw + e, p.tw + e, true);
  const int v_bits = l - p.skip;
#pragma unroll 1
  for (int d = threadIdx.x; d < T << v_bits; d += blockDim.x) {
    int tt, i;
    if (p.in_s == 1) {
      tt = d >> v_bits;
      i = d & ((1 << v_bits) - 1);
    } else {
      tt = d & (T - 1);
      i = d >> p.t_bits;
    }
    const long long g = g0 + tt;
    const long long j = (g & pc_mask) * p.in_ts + (long long)i * p.in_s;
    const bool valid = g < p.n_tr && j < p.n_in;
    copy_async8(x + tt * stride + padded((int)(__brev((unsigned)i) >> (32 - l))),
                valid ? in + (g >> p.pc_bits) * p.in_cs + j : in, valid);
  }
  copy_async_wait();
  __syncthreads();

  int s0 = 0;
  if (p.radix == 1 && p.pre == nullptr && p.skip == 0) {
    // radix 2 (tiles of 256 points and fewer): one butterfly a thread and
    // stage, the index arithmetic kept to the least
    const int half_bits = l - 1;
    const int pairs = T << half_bits;
#pragma unroll 1
    for (int s = 0; s < l; ++s) {
#pragma unroll 1
      for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
        const int kk = k & ((1 << half_bits) - 1);
        const int j = kk & ((1 << s) - 1);
        const int i0 = ((kk >> s) << (s + 1)) + j;
        uint64_t* c = x + (k >> half_bits) * stride;
        const uint64_t u = c[padded(i0)];
        const uint64_t t = gl::mul(c[padded(i0 + (1 << s))], tw[j << (half_bits - s)]);
        c[padded(i0)] = gl::add(u, t);
        c[padded(i0 + (1 << s))] = gl::sub(u, t);
      }
      __syncthreads();
    }
    s0 = l;
  }
  const bool first = p.pre != nullptr || p.skip > 0;
  while (s0 < l) {
    const int b = l - s0 < p.radix ? l - s0 : p.radix;
    if (s0 == 0 && first) {
      if (b == 3)
        radix_group<3, true>(p, x, tw, g0, s0, p.skip);  // skip <= b
      else if (b == 2)
        radix_group<2, true>(p, x, tw, g0, s0, p.skip);
      else
        radix_group<1, true>(p, x, tw, g0, s0, p.skip);
    } else {
      if (b == 3)
        radix_group<3, false>(p, x, tw, g0, s0, 0);
      else if (b == 2)
        radix_group<2, false>(p, x, tw, g0, s0, 0);
      else
        radix_group<1, false>(p, x, tw, g0, s0, 0);
    }
    s0 += b;
    __syncthreads();
  }

  const int h_mask = (1 << p.h) - 1;
#pragma unroll 1
  for (int e = threadIdx.x; e < T * L; e += blockDim.x) {
    int tt, k;
    if (p.out_s == 1) {
      tt = e >> l;
      k = e & (L - 1);
    } else {
      tt = e & (T - 1);
      k = e >> p.t_bits;
    }
    const long long g = g0 + tt;
    if (g >= p.n_tr) continue;
    const long long t = g & pc_mask;
    const long long j = t * p.out_ts + (long long)k * p.out_s;
    uint64_t v = x[tt * stride + padded(k)];
    if (p.twn != nullptr) {
      const long long ex = t * k;  // t < N2, k < N1: below N
      v = gl::mul(v, p.h == 0 ? p.twn[ex]
                              : gl::mul(p.twn[(1 << p.h) + (ex >> p.h)], p.twn[ex & h_mask]));
    }
    if (p.post != nullptr)
      v = gl::mul(v, p.post[j]);
    else if (p.do_scale)
      v = gl::mul(v, p.scale);
    out[(g >> p.pc_bits) * p.out_cs + j] = v;
  }
}

int smem_bytes(const Pass& p) {
  return ((tile_stride(p.l) << p.t_bits) + (1 << (p.l - 1))) * 8;
}

// Radix-8 groups where a tile has 1024 points or more, else radix 4 or 2,
// so that at least 128 threads (a warp a scheduler) share the butterflies.
// One row of blocks a group of columns.
cudaError_t launch(Pass p, long long groups, cudaStream_t s) {
  const int tile_bits = p.l + p.t_bits;
  p.radix = tile_bits >= RADIX8_BITS ? 3 : tile_bits >= RADIX4_BITS ? 2 : 1;
  if (p.skip > p.radix) p.skip = p.radix;
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && !raised[dev]) {
    e = cudaFuncSetAttribute(ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  const long long blocks = (p.n_tr + (1LL << p.t_bits) - 1) >> p.t_bits;
  if (blocks < 1 || blocks > 0x7FFFFFFFLL || groups < 1 || groups > 0xFFFF)
    return cudaErrorInvalidValue;
  const int threads = (1 << (p.l + p.t_bits - p.radix)) < THREADS ? 1 << (p.l + p.t_bits - p.radix)
                                                                   : THREADS;
  ntt_pass<<<dim3((unsigned)blocks, (unsigned)groups), threads, smem_bytes(p), s>>>(p);
  return cudaGetLastError();
}

// Stages that only copy in a transform of 2^l points whose inputs past
// `valid` are 0, at most the first register group's three.
int zero_stages(int l, long long valid) {
  int r = 0;
  while (r < l && r < 3 && valid <= (1LL << (l - r - 1))) ++r;
  return r;
}

}  // namespace

// in: (cols, n_in) contiguous; out: (cols, 2^log_n), column c at c * 2^log_n,
// or, for out_group > 0, at (c / out_group) * out_gs + (c % out_group) *
// 2^log_n (groups of out_group columns out_gs values apart, out_gs >=
// out_group 2^log_n, at most 65535 groups: the grid's second axis);
// 1 <= n_in <= 2^log_n.
// log_n1: the first pass's points, log_n1 == log_n for one pass, else
// log_n - log_n1 <= 12 too; scratch: (cols, 2^log_n) for two passes, else
// null. tw1, tw2: w^e for e < 2^(log_n1 - 1) and e < 2^(log_n - log_n1 - 1),
// w the pass's primitive root (inverse roots for the inverse); twn: for two
// passes, w_N^e for e < N up to 2^20 points, above w_N^e for e < 2^h then
// w_N^(2^h e') for e' < 2^(log_n - h), h = (log_n + 1) / 2. shift_pows: n_in felts multiplied into the inputs, or
// null. post_pows: 2^log_n felts multiplied into the outputs (the scale
// folded in), or null; else scale multiplies every output when do_scale.
// coset_bits = r > 0: a one-pass LDE of n_in = 2^(log_n - r) inputs taken
// as 2^r transforms of n_in points; then tw1 holds the roots of n_in
// points and shift_pows (2^r, n_in) the powers of g w_N^r'. One launch a
// pass.
extern "C" int qzk_ntt(const void* in, void* out, void* scratch, const void* tw1, const void* tw2,
                       const void* twn, const void* shift_pows, const void* post_pows,
                       long long cols, long long n_in, int log_n, int log_n1, int coset_bits,
                       unsigned long long scale, int do_scale, long long out_group,
                       long long out_gs, void* stream) {
  if (cols <= 0) return 0;
  if (out_group < 0 || (out_group > 0 && (cols % out_group || out_gs < out_group << log_n)))
    return (int)cudaErrorInvalidValue;
  const long long groups = out_group ? cols / out_group : 1;
  if (out_group) cols = out_group;  // the passes below see one group
  const int l1 = log_n1, l2 = log_n - log_n1;
  if (log_n < 1 || l1 < 1 || l1 > MAX_TILE_BITS || l2 < 0 || l2 > MAX_TILE_BITS ||
      (l2 > 0 && (scratch == nullptr || twn == nullptr || tw2 == nullptr)) || n_in < 1 ||
      n_in > (1LL << log_n) ||
      (coset_bits != 0 && (l2 != 0 || coset_bits < 1 || coset_bits >= log_n ||
                           n_in != 1LL << (log_n - coset_bits) || shift_pows == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = 1LL << log_n;
  Pass p{};
  p.pre = (const uint64_t*)shift_pows;
  p.scale = (uint64_t)scale;
  if (coset_bits != 0) {
    // the LDE as 2^r transforms of n_in points a column, r = coset_bits:
    // output r' + 2^r q is NTT_{n_in}(c_k (g w_N^r')^k)[q]; shift_pows holds
    // (g w_N^r')^k at r' n_in + k, tw1 the roots of n_in points. Tiles of
    // 512 points, so the leaf's 135 columns make 540 blocks.
    const int l = log_n - coset_bits;
    p.in = (const uint64_t*)in;
    p.out = (uint64_t*)out;
    p.tw = (const uint64_t*)tw1;
    p.n_tr = cols << coset_bits;
    p.pc_bits = coset_bits;
    p.in_cs = n_in, p.in_s = 1, p.pre_ts = n_in;
    p.out_cs = n, p.out_ts = 1, p.out_s = 1LL << coset_bits;
    p.in_gs = cols * n_in, p.out_gs = out_gs;
    p.n_in = n_in;
    p.l = l;
    p.t_bits = l < 9 ? (9 - l < coset_bits ? 9 - l : coset_bits) : 0;
    return (int)launch(p, groups, s);
  }
  if (l2 == 0) {
    // one pass: a transform a column, 2^8 points or more a block
    p.in = (const uint64_t*)in;
    p.out = (uint64_t*)out;
    p.tw = (const uint64_t*)tw1;
    p.post = (const uint64_t*)post_pows;
    p.do_scale = do_scale;
    p.n_tr = cols;
    p.pc_bits = 0;
    p.in_cs = n_in, p.in_s = 1, p.out_cs = n, p.out_s = 1;
    p.in_gs = cols * n_in, p.out_gs = out_gs;
    p.n_in = n_in;
    p.l = log_n;
    p.t_bits = log_n < 8 ? 8 - log_n : 0;
    p.skip = zero_stages(log_n, n_in);
    return (int)launch(p, groups, s);
  }
  // two passes, N = N1 N2, j = N2 j1 + j2, k = k1 + N1 k2. T transforms a
  // block with 4 <= T <= 16 and T L = 4096 where it can (T = 4 above 2^10).
  auto t_bits = [](int l, int other) {
    int t = 12 - l;
    t = t < 2 ? 2 : t > 4 ? 4 : t;
    return t < other ? t : other;
  };
  // pass 1: for each j2, the N1 points x[N2 j1 + j2] -> Y[k1][j2] w_N^(j2 k1)
  p.in = (const uint64_t*)in;
  p.out = (uint64_t*)scratch;
  p.tw = (const uint64_t*)tw1;
  p.twn = (const uint64_t*)twn;
  p.h = log_n <= FULL_TWIDDLE_BITS ? 0 : (log_n + 1) / 2;
  p.n_tr = cols << l2;
  p.pc_bits = l2;
  p.in_cs = n_in, p.in_ts = 1, p.in_s = 1LL << l2;
  p.out_cs = n, p.out_ts = 1, p.out_s = 1LL << l2;
  p.in_gs = cols * n_in, p.out_gs = cols * n;
  p.n_in = n_in;
  p.l = l1;
  p.t_bits = t_bits(l1, l2);
  p.skip = zero_stages(l1, (n_in + (1LL << l2) - 1) >> l2);
  cudaError_t e = launch(p, groups, s);
  if (e != cudaSuccess) return (int)e;
  // pass 2: for each k1, the N2 points Y[k1][j2] -> X[k1 + N1 k2]
  Pass q{};
  q.in = (const uint64_t*)scratch;
  q.out = (uint64_t*)out;
  q.tw = (const uint64_t*)tw2;
  q.post = (const uint64_t*)post_pows;
  q.scale = (uint64_t)scale;
  q.do_scale = do_scale;
  q.n_tr = cols << l1;
  q.pc_bits = l1;
  q.in_cs = n, q.in_ts = 1LL << l2, q.in_s = 1;
  q.out_cs = n, q.out_ts = 1, q.out_s = 1LL << l1;
  q.in_gs = cols * n, q.out_gs = out_gs;
  q.n_in = n;
  q.l = l2;
  q.t_bits = t_bits(l2, l1);
  q.skip = 0;
  return (int)launch(q, groups, s);
}
