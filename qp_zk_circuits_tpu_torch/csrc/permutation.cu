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
// Design: a block takes a tile of TILE rows of one challenge, a row a
// thread. Each thread forms its row's chunk products (a chunk's reads issued
// together) and the product of its nonzero denominators. Montgomery's batch
// trick then runs across the tile: a forward and a backward product scan
// over the threads (warp shuffles, then warp 0 over the warps' products) and
// one Fermat inverse of the tile's product, so a row's inverse is that
// inverse times its two scans, and a chunk's is taken out of the row's by the
// same trick (a zero denominator is left out of the products and its
// inverse set to 0, so inv(0) = 0 holds exactly). A second scan over the
// rows' ratios gives Z within the tile; the block writes Z and the partial
// products and its tile's product. A second launch, when there is more than
// one tile, gives each later tile the product of the tiles before it (a
// reduction over the tile products) and multiplies it into the tile's Z and
// partial products in place. So a call is one launch up to TILE rows (the
// leaf's 256) and two above; one Fermat inverse per (tile, challenge).
//
// Bound on the H100: integer operations at the leaf (n = 256) and at
// aggregation sizes. The function needs about 350 field multiplies per
// (row, challenge), most of them the chunk factors and products, and one
// Fermat inverse per challenge when a batch inverse runs across all rows,
// against 3 * 80 reads. At the leaf the kernel runs as two blocks, so its
// time is the latency of one thread's chain (a dependent field multiply
// takes about 71 cycles) and of fetching its code cold: the loops stay
// rolled.
//
// A batch of proofs (the JAX package's vmap of the fused prover,
// plonk/prover_fused.py:1007) is the grid's third axis: proof p reads its
// wires at p * wire_stride, writes its columns and tile products after the
// proofs before it, and reads its own betas and gammas from its challenge
// record in device memory (challenges.cuh), for up to MAX_PROOFS proofs a
// launch: the wrapper splits a larger batch into launches of at most
// MAX_PROOFS. At the
// leaf a proof is one tile on one SM, so sixteen proofs run sixteen tiles a
// challenge side by side in the time of one.
#include <cuda_runtime.h>

#include "challenges.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int MAX_NC = 4;
constexpr int MAX_CHUNKS = 16;
constexpr int TILE = 256;  // rows a tile and threads a block, plonk/prover.py::PERMUTATION_TILE
constexpr int WARPS = TILE / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BATCH = 8;  // reads in flight a thread
constexpr int MAX_PROOFS = 16;  // plonk/prover.py::PROOFS_PER_LAUNCH

// Exclusive product scans of v over the block's threads in order: `before`
// is the product over the lower threads, `after` (when AFTER) over the
// higher ones. Returns the block's product. Each warp scans its lanes with
// shuffles, warp 0 then scans the warps' products, so a thread's chain is
// 5 + log2(WARPS) multiplies deep. Every thread calls it; sh holds
// 2 * WARPS + 1 words.
template <bool AFTER>
__device__ __forceinline__ uint64_t block_scan(uint64_t v, uint64_t& before, uint64_t& after,
                                               uint64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t up = v, down = v;  // products over lanes 0..lane and lane..31
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t u = __shfl_up_sync(FULL, (unsigned long long)up, d);
    if (lane >= d) up = gl::mul(u, up);
    if (AFTER) {
      const uint64_t w = __shfl_down_sync(FULL, (unsigned long long)down, d);
      if (lane + d < 32) down = gl::mul(w, down);
    }
  }
  if (lane == 31) sh[warp] = up;
  __syncthreads();
  if (warp == 0) {
    // the same scans over the warps' products, on warp 0
    const uint64_t t = lane < WARPS ? sh[lane] : 1;
    uint64_t wup = t, wdown = t;
#pragma unroll 1
    for (int d = 1; d < WARPS; d <<= 1) {
      const uint64_t u = __shfl_up_sync(FULL, (unsigned long long)wup, d);
      if (lane >= d) wup = gl::mul(u, wup);
      if (AFTER) {
        const uint64_t w = __shfl_down_sync(FULL, (unsigned long long)wdown, d);
        if (lane + d < WARPS) wdown = gl::mul(w, wdown);
      }
    }
    const uint64_t wex = __shfl_up_sync(FULL, (unsigned long long)wup, 1);
    const uint64_t wex_down = __shfl_down_sync(FULL, (unsigned long long)wdown, 1);
    __syncwarp();
    if (lane < WARPS) {
      sh[lane] = lane ? wex : 1;
      if (AFTER) sh[WARPS + lane] = lane + 1 < WARPS ? wex_down : 1;
    }
    if (lane == WARPS - 1) sh[2 * WARPS] = wup;
  }
  __syncthreads();
  const uint64_t ex = __shfl_up_sync(FULL, (unsigned long long)up, 1);
  before = gl::mul(sh[warp], lane ? ex : 1);
  if (AFTER) {
    const uint64_t ex_down = __shfl_down_sync(FULL, (unsigned long long)down, 1);
    after = gl::mul(sh[WARPS + warp], lane < 31 ? ex_down : 1);
  }
  const uint64_t total = sh[2 * WARPS];
  __syncthreads();  // sh is free for the next scan
  return total;
}

// out rows of proof p (blockIdx.z), after the proofs before it: [Z_0 ..
// Z_{nc-1}, pp_{0,0} .. pp_{0,npp-1}, pp_{1,0} ..], each n long; tile_prod:
// (proofs, nc, tiles) the product of each tile's row ratios.
__global__ void __launch_bounds__(TILE) perm_tile_kernel(
    const uint64_t* __restrict__ wires, long long wire_stride, const uint64_t* __restrict__ ids,
    const uint64_t* __restrict__ sigmas, uint64_t* __restrict__ out,
    uint64_t* __restrict__ tile_prod, const uint64_t* __restrict__ ch, long long ch_stride, int n,
    int nr, int qdf, int nchunks, int nc) {
  __shared__ uint64_t sh[2 * WARPS + 1];
  __shared__ uint64_t tile_inv;
  const int r = blockIdx.x * TILE + threadIdx.x;
  const int c = blockIdx.y;
  const int proof = blockIdx.z;
  const bool live = r < n;  // a row past n takes part in the scans as 1
  const uint64_t beta = __ldg(ch + proof * ch_stride + rec::BETA + c);
  const uint64_t gamma = __ldg(ch + proof * ch_stride + rec::GAMMA + c);
  const int npp = nchunks - 1;
  wires += proof * wire_stride;
  out += (long long)proof * (nc + nc * npp) * n;
  tile_prod += (long long)proof * nc * gridDim.x;
  // rolled loops (the arrays live in local memory); a chunk's reads are
  // issued together, eight at a time
  uint64_t cn[MAX_CHUNKS], cd[MAX_CHUNKS], pre[MAX_CHUNKS];
  uint64_t run = 1;  // product of the row's nonzero denominators so far
#pragma unroll 1
  for (int j = 0; j < nchunks; ++j) {
    uint64_t num = 1, den = 1;
    const int end = live ? min(nr, (j + 1) * qdf) : 0;
#pragma unroll 1
    for (int i0 = j * qdf; i0 < end; i0 += BATCH) {
      uint64_t w[BATCH], id[BATCH], sg[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const long long at = (long long)min(i0 + u, end - 1) * n + r;
        w[u] = wires[at];
        id[u] = ids[at];
        sg[u] = sigmas[at];
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i0 + u < end) {
          num = gl::mul(num, gl::add(gl::add(w[u], gl::mul(beta, id[u])), gamma));
          den = gl::mul(den, gl::add(gl::add(w[u], gl::mul(beta, sg[u])), gamma));
        }
      }
    }
    cn[j] = num;
    cd[j] = den;
    if (den != 0) run = gl::mul(run, den);
    pre[j] = run;
  }
  // the tile's batch inverse: 1/run = (1/the tile's product of runs) * the
  // runs of the other rows
  uint64_t lower, higher;
  const uint64_t all = block_scan<true>(run, lower, higher, sh);
  if (threadIdx.x == 0) tile_inv = gl::inv(all);
  __syncthreads();
  uint64_t inv = gl::mul(tile_inv, gl::mul(lower, higher));
#pragma unroll 1
  for (int j = nchunks - 1; j >= 0; --j) {
    const uint64_t before = j ? pre[j - 1] : 1;
    if (cd[j] != 0) {
      cn[j] = gl::mul(cn[j], gl::mul(inv, before));  // ratio_j
      inv = gl::mul(inv, cd[j]);
    } else {
      cn[j] = 0;
    }
  }
  uint64_t q = 1;  // prod_{t <= j} ratio_t, kept in cn[j]
#pragma unroll 1
  for (int j = 0; j < nchunks; ++j) {
    q = gl::mul(q, cn[j]);
    cn[j] = q;
  }
  // Z within the tile: the exclusive product of the row ratios
  uint64_t z, unused;
  const uint64_t prod = block_scan<false>(q, z, unused, sh);
  if (live) {
    out[(long long)c * n + r] = z;
#pragma unroll 1
    for (int j = 0; j < npp; ++j) out[((long long)nc + c * npp + j) * n + r] = gl::mul(z, cn[j]);
  }
  if (threadIdx.x == 0) tile_prod[(long long)c * gridDim.x + blockIdx.x] = prod;
}

// Tile t > 0 of challenge c: its Z and partial products times the product of
// the tiles before it.
__global__ void __launch_bounds__(TILE) perm_carry_kernel(uint64_t* __restrict__ out,
                                                          const uint64_t* __restrict__ tile_prod,
                                                          int n, int npp, int nc, int tiles) {
  __shared__ uint64_t sh[2 * WARPS + 1];
  const int t = blockIdx.x + 1;
  const int c = blockIdx.y;
  out += (long long)blockIdx.z * (nc + nc * npp) * n;
  tile_prod += (long long)blockIdx.z * nc * tiles;
  uint64_t v = 1;
  for (int u = threadIdx.x; u < t; u += TILE) v = gl::mul(v, tile_prod[(long long)c * tiles + u]);
  uint64_t unused_before, unused_after;
  const uint64_t carry = block_scan<false>(v, unused_before, unused_after, sh);
  const int r = t * TILE + threadIdx.x;
  if (r >= n) return;
  uint64_t* z = out + (long long)c * n + r;
  *z = gl::mul(carry, *z);
  for (int j = 0; j < npp; ++j) {
    uint64_t* pp = out + ((long long)nc + c * npp + j) * n + r;
    *pp = gl::mul(carry, *pp);
  }
}

}  // namespace

// `proofs` proofs (at most MAX_PROOFS): proof p's wires (nr, n) with row
// stride n at wires + p * wire_stride; ids, sigmas: (nr, n), the circuit's;
// ch: device challenge records (challenges.cuh), proof p's at p *
// ch_stride words, its betas and gammas read on the card; out: (proofs, nc
// + nc * npp, n);
// tile_prod: (proofs, nc, ceil(n / TILE)) scratch.
extern "C" int qzk_permutation(const void* wires, long long wire_stride, const void* ids,
                               const void* sigmas, const void* ch, long long ch_stride,
                               void* out, void* tile_prod, int proofs, int n, int nr, int qdf,
                               int nc, void* stream) {
  const int nchunks = qdf < 1 ? 0 : (nr + qdf - 1) / qdf;
  if (nc < 1 || nc > MAX_NC || qdf < 1 || nr < 1 || nchunks > MAX_CHUNKS || n < 1 ||
      proofs < 1 || proofs > MAX_PROOFS || ch == nullptr || (proofs > 1 && ch_stride < rec::WORDS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n + TILE - 1) / TILE;
  perm_tile_kernel<<<dim3((unsigned)tiles, (unsigned)nc, (unsigned)proofs), TILE, 0, s>>>(
      (const uint64_t*)wires, wire_stride, (const uint64_t*)ids, (const uint64_t*)sigmas,
      (uint64_t*)out, (uint64_t*)tile_prod, (const uint64_t*)ch, ch_stride, n, nr, qdf, nchunks,
      nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return (int)e;
  perm_carry_kernel<<<dim3((unsigned)(tiles - 1), (unsigned)nc, (unsigned)proofs), TILE, 0, s>>>(
      (uint64_t*)out, (const uint64_t*)tile_prod, n, nchunks - 1, nc, tiles);
  return (int)cudaGetLastError();
}
