/* Poseidon2-Goldilocks permutation (width 12) on the host, in C.
 *
 * The host side of the port hashes here: the Fiat-Shamir transcript's
 * duplexes, the Poseidon2 gate's witness fill, the verifier's Merkle walks
 * and sponges. The pure-Python forms in hash/poseidon2.py stay as the tests'
 * oracles and are bit-equal to these functions.
 *
 * Round constants and the matrix diagonal are NOT baked in: the loader
 * (native/__init__.py) injects hash/poseidon2.py's `_constants()` and `_M4`
 * through p2_set_constants, so the Grain-LFSR derivation there stays the one
 * source of the instance.
 *
 * Field: p = 2^64 - 2^32 + 1.  Reduction identities used below:
 *   2^64 = 2^32 - 1 (mod p),  2^96 = -1 (mod p).
 */

#include <stddef.h>
#include <stdint.h>

#define P 0xFFFFFFFF00000001ULL
#define NEG_P 0xFFFFFFFFULL /* 2^64 - p = 2^32 - 1 */
#define WIDTH 12
#define ROUNDS_F 8
#define ROUNDS_P_MAX 64

static uint64_t EXT_RCS[ROUNDS_F][WIDTH];
static uint64_t INT_RCS[ROUNDS_P_MAX];
static uint64_t DIAG[WIDTH];
static uint64_t M4[4][4];
static int ROUNDS_P = 22;

static inline uint64_t reduce128(unsigned __int128 x) {
    uint64_t lo = (uint64_t)x;
    uint64_t hi = (uint64_t)(x >> 64);
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= NEG_P; /* borrow: wrapped value minus (2^64 mod p) */
    uint64_t t1 = hi_lo * NEG_P;
    uint64_t res = t0 + t1;
    if (res < t0) res += NEG_P; /* carry: wrapped value plus (2^64 mod p) */
    if (res >= P) res -= P;
    return res;
}

static inline uint64_t mulmod(uint64_t a, uint64_t b) {
    return reduce128((unsigned __int128)a * b);
}

static inline uint64_t addmod(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += NEG_P; /* wrapped: true sum minus p */
    else if (s >= P) s -= P;
    return s;
}

static inline uint64_t sbox7(uint64_t x) {
    uint64_t x2 = mulmod(x, x);
    uint64_t x3 = mulmod(x2, x);
    uint64_t x6 = mulmod(x3, x3);
    return mulmod(x6, x);
}

/* external linear layer: per-4-block M4 multiply, then add the column sums
 * of the three blocks (mirrors hash/poseidon2.py::_scalar_ext_linear). */
static inline void ext_linear(uint64_t *s) {
    uint64_t y[WIDTH];
    for (int g = 0; g < 3; g++) {
        const uint64_t *b = s + 4 * g;
        for (int i = 0; i < 4; i++) {
            unsigned __int128 acc = 0;
            for (int j = 0; j < 4; j++)
                acc += (unsigned __int128)M4[i][j] * b[j];
            y[4 * g + i] = reduce128(acc);
        }
    }
    for (int i = 0; i < 4; i++) {
        uint64_t t = addmod(addmod(y[i], y[4 + i]), y[8 + i]);
        s[i] = addmod(y[i], t);
        s[4 + i] = addmod(y[4 + i], t);
        s[8 + i] = addmod(y[8 + i], t);
    }
}

static void permute_one(uint64_t *x) {
    ext_linear(x);
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < WIDTH; i++)
            x[i] = sbox7(addmod(x[i], EXT_RCS[r][i]));
        ext_linear(x);
    }
    for (int k = 0; k < ROUNDS_P; k++) {
        x[0] = sbox7(addmod(x[0], INT_RCS[k]));
        unsigned __int128 acc = 0;
        for (int i = 0; i < WIDTH; i++) acc += x[i];
        uint64_t tot = reduce128(acc);
        for (int i = 0; i < WIDTH; i++)
            x[i] = addmod(mulmod(DIAG[i], x[i]), tot);
    }
    for (int r = 4; r < 8; r++) {
        for (int i = 0; i < WIDTH; i++)
            x[i] = sbox7(addmod(x[i], EXT_RCS[r][i]));
        ext_linear(x);
    }
}

/* ---- exported API (ctypes) ---- */

/* the flags that built this library, set by the loader */
#ifndef QZK_HOST_FLAGS
#define QZK_HOST_FLAGS ""
#endif
const char *qzk_host_flags(void) { return QZK_HOST_FLAGS; }

void p2_set_constants(const uint64_t *ext_rcs /* 8*12 */,
                      const uint64_t *int_rcs, int rounds_p,
                      const uint64_t *diag /* 12 */,
                      const uint64_t *m4 /* 16 */) {
    for (int r = 0; r < ROUNDS_F; r++)
        for (int i = 0; i < WIDTH; i++) EXT_RCS[r][i] = ext_rcs[r * WIDTH + i];
    ROUNDS_P = rounds_p;
    for (int k = 0; k < rounds_p; k++) INT_RCS[k] = int_rcs[k];
    for (int i = 0; i < WIDTH; i++) DIAG[i] = diag[i];
    for (int i = 0; i < 16; i++) M4[i / 4][i % 4] = m4[i];
}

/* n states of 12 lanes, permuted in place. States are independent; large
 * batches fan out across cores. The cutoff keeps the transcript's single
 * duplexes serial (a thread wake-up costs more than one permutation). */
void p2_permute_batch(uint64_t *states, size_t n) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 64)
#endif
    for (size_t k = 0; k < n; k++) permute_one(states + WIDTH * k);
}

/* Witness-trace permutation: emits the intermediate S-box outputs the
 * Poseidon2 gate's wires carry (plonk/gates.py::Poseidon2Gate.fill_row):
 *   ext_a: 4 rounds x 12 post-S-box states (before the linear layer)
 *   inter: rounds_p lane-0 post-S-box values
 *   ext_b: 3 rounds x 12 post-S-box states (rounds 4..6)
 *   out:   final 12-lane output (after round 7's S-box + linear layer)
 * in: n x 12 input states (the gate's W_IN row); all buffers caller-owned. */
void p2_permute_trace_batch(const uint64_t *in, size_t n, uint64_t *ext_a,
                            uint64_t *inter, uint64_t *ext_b, uint64_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 32)
#endif
    for (size_t kk = 0; kk < n; kk++) {
        uint64_t x[WIDTH];
        for (int i = 0; i < WIDTH; i++) x[i] = in[kk * WIDTH + i];
        ext_linear(x);
        for (int r = 0; r < 4; r++) {
            for (int i = 0; i < WIDTH; i++) {
                x[i] = sbox7(addmod(x[i], EXT_RCS[r][i]));
                ext_a[kk * 48 + r * WIDTH + i] = x[i];
            }
            ext_linear(x);
        }
        for (int k = 0; k < ROUNDS_P; k++) {
            x[0] = sbox7(addmod(x[0], INT_RCS[k]));
            inter[kk * ROUNDS_P + k] = x[0];
            unsigned __int128 acc = 0;
            for (int i = 0; i < WIDTH; i++) acc += x[i];
            uint64_t tot = reduce128(acc);
            for (int i = 0; i < WIDTH; i++)
                x[i] = addmod(mulmod(DIAG[i], x[i]), tot);
        }
        for (int r = 4; r < 7; r++) {
            for (int i = 0; i < WIDTH; i++) {
                x[i] = sbox7(addmod(x[i], EXT_RCS[r][i]));
                ext_b[kk * 36 + (r - 4) * WIDTH + i] = x[i];
            }
            ext_linear(x);
        }
        for (int i = 0; i < WIDTH; i++) x[i] = sbox7(addmod(x[i], EXT_RCS[7][i]));
        ext_linear(x);
        for (int i = 0; i < WIDTH; i++) out[kk * WIDTH + i] = x[i];
    }
}

/* plonky2-style overwrite-mode sponge: absorb rate-8 chunks of `in`
 * (len felts), squeeze digest[4]. One call a hash. */
void p2_hash_no_pad(const uint64_t *in, size_t len, uint64_t *digest) {
    uint64_t st[WIDTH] = {0};
    size_t off = 0;
    while (off < len) {
        size_t chunk = len - off < 8 ? len - off : 8;
        for (size_t i = 0; i < chunk; i++) st[i] = in[off + i];
        permute_one(st);
        off += chunk;
    }
    for (int i = 0; i < 4; i++) digest[i] = st[i];
}

/* batched independent sponges over fixed-length preimages:
 * in is n rows of `len` felts; digests is n rows of 4. */
void p2_hash_no_pad_many(const uint64_t *in, size_t n, size_t len,
                         uint64_t *digests) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 16)
#endif
    for (size_t k = 0; k < n; k++)
        p2_hash_no_pad(in + k * len, len, digests + 4 * k);
}

/* Full Merkle path walk in one call: start from a leaf digest, fold in
 * `levels` sibling digests (order chosen by the index bits), write the
 * reached cap entry (the verifier's 28 query rounds x 4 oracles x ~10
 * levels at the leaf). */
void p2_merkle_walk(const uint64_t *leaf /* 4 */, uint64_t index,
                    const uint64_t *siblings /* levels x 4 */, size_t levels,
                    uint64_t *out /* 4 */) {
    uint64_t st[WIDTH];
    uint64_t cur[4];
    for (int i = 0; i < 4; i++) cur[i] = leaf[i];
    for (size_t l = 0; l < levels; l++) {
        const uint64_t *sib = siblings + 4 * l;
        for (int i = 0; i < WIDTH; i++) st[i] = 0;
        if (index & 1) {
            for (int i = 0; i < 4; i++) { st[i] = sib[i]; st[4 + i] = cur[i]; }
        } else {
            for (int i = 0; i < 4; i++) { st[i] = cur[i]; st[4 + i] = sib[i]; }
        }
        permute_one(st);
        for (int i = 0; i < 4; i++) cur[i] = st[i];
        index >>= 1;
    }
    for (int i = 0; i < 4; i++) out[i] = cur[i];
}

/* Merkle 2-to-1 compression, batched: left/right/out are n rows of 4. */
void p2_two_to_one_many(const uint64_t *left, const uint64_t *right, size_t n,
                        uint64_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n >= 64)
#endif
    for (size_t k = 0; k < n; k++) {
        uint64_t st[WIDTH] = {0};
        for (int i = 0; i < 4; i++) {
            st[i] = left[4 * k + i];
            st[4 + i] = right[4 * k + i];
        }
        permute_one(st);
        for (int i = 0; i < 4; i++) out[4 * k + i] = st[i];
    }
}

/* ---- the transcripts of a batch of proofs, in lockstep ---- */

int64_t p2_absorb_many(uint64_t *state, uint64_t *buf, int64_t k, const uint64_t *felts,
                       uint64_t n); /* fri_verify.c */

/* K transcripts' absorbs of one step: state k of `states` (K x 12) with its
 * partial input buffer `bufs` (K x 8, `fill` felts each: the transcripts of
 * one circuit advance in lockstep, so every buffer holds as many) absorbs
 * row k of `felts` (K x n). Returns the buffers' new fill. Each state is
 * p2_absorb_many's own walk, so the result is bit-equal to K single calls;
 * the states fan out across cores. */
int64_t p2_absorb_batch(uint64_t *states, uint64_t *bufs, int64_t fill, const uint64_t *felts,
                        uint64_t n, int64_t count) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (count > 1 && n >= 16)
#endif
    for (int64_t k = 0; k < count; k++)
        p2_absorb_many(states + WIDTH * k, bufs + 8 * k, fill, felts + n * k, n);
    return (fill + (int64_t)(n % 8)) % 8;
}

/* K transcripts' duplexes: the first `fill` lanes of state k take buffer k
 * (K x 8), then the state is permuted (Challenger._duplex, K at once). */
void p2_duplex_batch(uint64_t *states, const uint64_t *bufs, int64_t fill, int64_t count) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (count >= 4)
#endif
    for (int64_t k = 0; k < count; k++) {
        uint64_t *x = states + WIDTH * k;
        for (int64_t i = 0; i < fill; i++) x[i] = bufs[8 * k + i];
        permute_one(x);
    }
}
