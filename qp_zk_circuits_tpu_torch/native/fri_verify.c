/* FRI query-phase verifier on the host, in C.
 *
 * Given the Fiat-Shamir outputs (alpha, betas, query indices, still drawn
 * by the Python transcript, which is the protocol's surface) it runs all
 * query rounds in one call: the initial Merkle openings, the composition
 * value recomputed from the opened rows, the fold walk, and the final
 * polynomial's evaluation. fri/verifier.py keeps the pure-Python loop as
 * the tests' oracle; the two are bit-equal and fail at the same check.
 *
 * Also here: the constraint tape's evaluator (plonk/constraint_tape.py)
 * and the transcript's batched absorb (plonk/transcript.py).
 *
 * Built with poseidon2.c and witness_tape.c into one shared object; uses
 * its exported sponge and Merkle functions.
 */

#include <stddef.h>
#include <stdint.h>

#define P 0xFFFFFFFF00000001ULL
#define NEG_P 0xFFFFFFFFULL
#define EXT_W 7ULL /* X^2 = 7, field/extension.py */

/* exported by poseidon2.c (same .so) */
void p2_hash_no_pad(const uint64_t *in, size_t len, uint64_t *digest);
void p2_merkle_walk(const uint64_t *leaf, uint64_t index,
                    const uint64_t *siblings, size_t levels, uint64_t *out);

static inline uint64_t reduce128_v(unsigned __int128 x) {
    uint64_t lo = (uint64_t)x;
    uint64_t hi = (uint64_t)(x >> 64);
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= NEG_P;
    uint64_t t1 = hi_lo * NEG_P;
    uint64_t res = t0 + t1;
    if (res < t0) res += NEG_P;
    if (res >= P) res -= P;
    return res;
}

static inline uint64_t f_mul(uint64_t a, uint64_t b) {
    return reduce128_v((unsigned __int128)a * b);
}

static inline uint64_t f_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += NEG_P;
    else if (s >= P) s -= P;
    return s;
}

static inline uint64_t f_sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    if (a < b) d -= NEG_P; /* wrapped: true difference plus p */
    return d >= P ? d - P : d;
}

static uint64_t f_pow(uint64_t base, uint64_t e) {
    uint64_t acc = 1;
    while (e) {
        if (e & 1) acc = f_mul(acc, base);
        base = f_mul(base, base);
        e >>= 1;
    }
    return acc;
}

static inline uint64_t f_inv(uint64_t a) { return f_pow(a, P - 2); }

/* ---- quadratic extension, c0 + c1*X with X^2 = 7 ---- */

typedef struct {
    uint64_t c0, c1;
} ext_t;

static inline ext_t e_add(ext_t a, ext_t b) {
    return (ext_t){f_add(a.c0, b.c0), f_add(a.c1, b.c1)};
}

static inline ext_t e_sub(ext_t a, ext_t b) {
    return (ext_t){f_sub(a.c0, b.c0), f_sub(a.c1, b.c1)};
}

static inline ext_t e_mul(ext_t a, ext_t b) {
    uint64_t t00 = f_mul(a.c0, b.c0);
    uint64_t t11 = f_mul(a.c1, b.c1);
    uint64_t c0 = f_add(t00, f_mul(EXT_W, t11));
    uint64_t c1 = f_add(f_mul(a.c0, b.c1), f_mul(a.c1, b.c0));
    return (ext_t){c0, c1};
}

static inline ext_t e_scalar(ext_t a, uint64_t s) {
    return (ext_t){f_mul(a.c0, s), f_mul(a.c1, s)};
}

static inline uint64_t f_neg(uint64_t a) { return a == 0 ? 0 : P - a; }

static inline ext_t e_inv(ext_t a) {
    uint64_t norm = f_sub(f_mul(a.c0, a.c0), f_mul(EXT_W, f_mul(a.c1, a.c1)));
    uint64_t ninv = f_inv(norm);
    return (ext_t){f_mul(a.c0, ninv), f_mul(f_neg(a.c1), ninv)};
}

static inline int e_eq(ext_t a, ext_t b) { return a.c0 == b.c0 && a.c1 == b.c1; }

static inline ext_t e_load(const uint64_t *p) { return (ext_t){p[0], p[1]}; }

/* error encoding: (code << 32) | (round << 16) | sub */
static int64_t err(int64_t code, uint64_t round, uint64_t sub) {
    return (code << 32) | ((int64_t)(round & 0xFFFF) << 16) | (int64_t)(sub & 0xFFFF);
}

static int verify_row_c(const uint64_t *cap, uint64_t cap_entries,
                        const uint64_t *row, uint64_t width, uint64_t index,
                        const uint64_t *sibs, uint64_t levels) {
    uint64_t digest[4];
    if (width <= 4) {
        for (int i = 0; i < 4; i++) digest[i] = i < (int)width ? row[i] : 0;
    } else {
        p2_hash_no_pad(row, width, digest);
    }
    uint64_t root[4];
    p2_merkle_walk(digest, index, sibs, levels, root);
    uint64_t cap_index = index >> levels;
    if (cap_index >= cap_entries) return 0;
    const uint64_t *want = cap + 4 * cap_index;
    for (int i = 0; i < 4; i++)
        if (root[i] != want[i]) return 0;
    return 1;
}

#define MAX_LAYERS 16
#define MAX_ORACLES 8
#define MAX_ARITY 64

/* Everything a single query round needs, precomputed once. Rounds are
 * mutually independent (each re-opens its own Merkle paths and walks its own
 * fold chain), so the round loop parallelises without any sharing. */
typedef struct {
    uint64_t lde_bits, n_layers, n_oracles, n_batches, cap_height;
    uint64_t final_len, g, w0, half_inv;
    uint64_t row_stride, sibs_stride, leaves_stride, stepsibs_stride;
    uint64_t sib_len_init;
    const uint64_t *schedule, *oracle_widths, *oracle_caps, *commit_caps;
    const uint64_t *batch_sizes, *batch_points, *poly_oi, *poly_pj;
    const uint64_t *openings, *betas, *final_poly;
    const uint64_t *indices, *initial_rows, *initial_sibs;
    const uint64_t *step_leaves, *step_sibs;
    const ext_t *apows;
    const uint64_t *layer_mp_bits, *layer_cap_h;
    const uint64_t *layer_leaf_off, *layer_sib_off, *layer_cap_off;
    const uint64_t *cap_off_oracle, *row_off;
} vq_ctx;

static int64_t verify_one_round(const vq_ctx *c, uint64_t r) {
    uint64_t q0 = c->indices[r];
    const uint64_t *rows = c->initial_rows + r * c->row_stride;
    const uint64_t *sibs = c->initial_sibs + r * c->sibs_stride;
    const uint64_t *leaves = c->step_leaves + r * c->leaves_stride;
    const uint64_t *ssibs = c->step_sibs + r * c->stepsibs_stride;

    /* 1. initial tree openings */
    {
        uint64_t off = 0;
        for (uint64_t o = 0; o < c->n_oracles; o++) {
            if (!verify_row_c(c->oracle_caps + c->cap_off_oracle[o],
                              1ULL << c->cap_height, rows + off,
                              c->oracle_widths[o], q0,
                              sibs + o * c->sib_len_init * 4, c->sib_len_init))
                return err(1, r, o);
            off += c->oracle_widths[o];
        }
    }

    /* 2. recompute the composition value Q(x) from the opened rows */
    uint64_t x = f_mul(c->g, f_pow(c->w0, q0));
    ext_t qval = {0, 0};
    {
        uint64_t term = 0;
        for (uint64_t b = 0; b < c->n_batches; b++) {
            ext_t sb = {0, 0}, cb = {0, 0};
            for (uint64_t k = 0; k < c->batch_sizes[b]; k++, term++) {
                uint64_t v =
                    rows[c->row_off[c->poly_oi[term]] + c->poly_pj[term]];
                sb = e_add(sb, e_scalar(c->apows[term], v));
                cb = e_add(cb, e_mul(c->apows[term], e_load(c->openings + 2 * term)));
            }
            ext_t num = e_sub(sb, cb);
            ext_t z = e_load(c->batch_points + 2 * b);
            ext_t xz = {f_sub(x, z.c0), f_sub(0, z.c1)};
            qval = e_add(qval, e_mul(num, e_inv(xz)));
        }
    }

    /* 3. fold walk */
    ext_t cur = qval;
    uint64_t q = q0;
    uint64_t m_bits = c->lde_bits;
    for (uint64_t l = 0; l < c->n_layers; l++) {
        uint64_t a_bits = c->schedule[l];
        uint64_t arity = 1ULL << a_bits;
        uint64_t mp_bits = c->layer_mp_bits[l];
        uint64_t j = q >> mp_bits;
        uint64_t q_next = q & ((1ULL << mp_bits) - 1);
        const uint64_t *leaf = leaves + c->layer_leaf_off[l];
        if (!e_eq(e_load(leaf + 2 * j), cur)) return err(2, r, l);
        uint64_t sib_levels = mp_bits - c->layer_cap_h[l];
        if (!verify_row_c(c->commit_caps + c->layer_cap_off[l],
                          1ULL << c->layer_cap_h[l], leaf, arity * 2, q_next,
                          ssibs + c->layer_sib_off[l], sib_levels))
            return err(3, r, l);
        /* fold the arity group down to one value: element k sits at
         * global index q_next + k*2^mp_bits in the size-2^m_bits domain,
         * i.e. at x_q * gamma^k with gamma = w_cur^(2^mp_bits). */
        uint64_t k_shift = c->lde_bits - m_bits;
        uint64_t w_cur = f_pow(c->w0, 1ULL << k_shift);
        uint64_t x_q =
            f_mul(f_pow(c->g, 1ULL << k_shift), f_pow(w_cur, q_next));
        uint64_t gamma = f_pow(w_cur, 1ULL << mp_bits);
        ext_t vals[MAX_ARITY];
        uint64_t pts[MAX_ARITY];
        for (uint64_t k = 0; k < arity; k++) {
            vals[k] = e_load(leaf + 2 * k);
            pts[k] = k == 0 ? x_q : f_mul(pts[k - 1], gamma);
        }
        ext_t beta = e_load(c->betas + 2 * l);
        uint64_t len = arity;
        while (len > 1) {
            uint64_t half = len >> 1;
            for (uint64_t k = 0; k < half; k++) {
                ext_t vs = e_add(vals[k], vals[k + half]);
                ext_t vd = e_sub(vals[k], vals[k + half]);
                uint64_t inv_p = f_inv(pts[k]);
                ext_t t = e_scalar(e_mul(vd, beta), inv_p);
                vals[k] = e_scalar(e_add(vs, t), c->half_inv);
                pts[k] = f_mul(pts[k], pts[k]);
            }
            beta = e_mul(beta, beta);
            len = half;
        }
        cur = vals[0];
        q = q_next;
        m_bits = mp_bits;
    }

    /* 4. final polynomial evaluation (Horner) */
    uint64_t k_shift = c->lde_bits - m_bits;
    uint64_t x_final =
        f_mul(f_pow(c->g, 1ULL << k_shift),
              f_pow(f_pow(c->w0, 1ULL << k_shift), q));
    ext_t acc = {0, 0};
    for (uint64_t k = c->final_len; k > 0; k--) {
        acc = e_scalar(acc, x_final);
        acc = e_add(acc, e_load(c->final_poly + 2 * (k - 1)));
    }
    if (!e_eq(acc, cur)) return err(4, r, 0);
    return 0;
}

/* Verify all FRI query rounds. Shapes are pre-validated by
 * plonk/verifier.py::check_proof_shape; this kernel trusts them.
 * Returns 0 on success, an err() code on the first failure. */
int64_t fri_verify_queries(
    uint64_t lde_bits, uint64_t n_rounds,
    const uint64_t *schedule, uint64_t n_layers, /* arity bits per layer */
    uint64_t n_oracles,
    const uint64_t *oracle_widths, /* row width per oracle (incl. salt) */
    const uint64_t *oracle_caps,   /* concat, each (2^cap_height, 4) */
    uint64_t cap_height,
    /* composition instance */
    uint64_t n_batches, const uint64_t *batch_sizes,
    const uint64_t *batch_points, /* (n_batches, 2) */
    const uint64_t *poly_oi, const uint64_t *poly_pj, /* (total_terms,) */
    const uint64_t *openings,                         /* (total_terms, 2) */
    const uint64_t *alpha,                            /* (2,) */
    const uint64_t *betas,                            /* (n_layers, 2) */
    const uint64_t *final_poly, uint64_t final_len,   /* (final_len, 2) */
    const uint64_t *commit_caps, /* concat per layer (2^cap_l, 4) */
    uint64_t g,                  /* multiplicative group generator */
    uint64_t w0,                 /* 2^lde_bits root of unity */
    /* per-round data, all concatenated in round order */
    const uint64_t *indices,      /* (n_rounds,) */
    const uint64_t *initial_rows, /* rounds x sum(widths) */
    const uint64_t *initial_sibs, /* rounds x n_oracles x init_sib x 4 */
    const uint64_t *step_leaves,  /* rounds x sum(2^a_l * 2) */
    const uint64_t *step_sibs     /* rounds x sum(sib_len_l * 4) */
) {
    if (n_layers > MAX_LAYERS || n_oracles > MAX_ORACLES) return err(9, 0, 0);
    /* the round field of err() is 16 bits; more rounds would make the
     * "lowest failing round" merge below ambiguous (a capacity, not a real
     * limit: the configs use 28-100 rounds) */
    if (n_rounds > 0xFFFF) return err(9, 0, 2);

    uint64_t total_terms = 0;
    for (uint64_t b = 0; b < n_batches; b++) total_terms += batch_sizes[b];

    /* alpha powers (heap-free: bounded by caller shape checks) */
    ext_t apows_small[1024];
    ext_t *apows = apows_small;
    if (total_terms > 1024) return err(9, 0, 1);
    ext_t al = e_load(alpha);
    apows[0] = (ext_t){1, 0};
    for (uint64_t k = 1; k < total_terms; k++) apows[k] = e_mul(apows[k - 1], al);

    /* per-layer geometry */
    uint64_t sib_len_init = lde_bits - cap_height;
    uint64_t layer_mp_bits[MAX_LAYERS], layer_cap_h[MAX_LAYERS];
    uint64_t layer_leaf_off[MAX_LAYERS], layer_sib_off[MAX_LAYERS];
    uint64_t layer_cap_off[MAX_LAYERS];
    {
        uint64_t log_m = lde_bits, leaf_off = 0, sib_off = 0, cap_off = 0;
        for (uint64_t l = 0; l < n_layers; l++) {
            uint64_t a_bits = schedule[l];
            uint64_t mp_bits = log_m - a_bits;
            uint64_t cl = cap_height < mp_bits ? cap_height : mp_bits;
            layer_mp_bits[l] = mp_bits;
            layer_cap_h[l] = cl;
            layer_leaf_off[l] = leaf_off;
            layer_sib_off[l] = sib_off;
            layer_cap_off[l] = cap_off;
            leaf_off += (1ULL << a_bits) * 2;
            sib_off += (mp_bits - cl) * 4;
            cap_off += (1ULL << cl) * 4;
            log_m = mp_bits;
        }
    }
    uint64_t row_stride = 0, cap_off_oracle[MAX_ORACLES];
    for (uint64_t o = 0; o < n_oracles; o++) {
        cap_off_oracle[o] = o * (1ULL << cap_height) * 4;
        row_stride += oracle_widths[o];
    }
    uint64_t sibs_stride = n_oracles * sib_len_init * 4;
    uint64_t leaves_stride = 0, stepsibs_stride = 0;
    for (uint64_t l = 0; l < n_layers; l++) {
        leaves_stride += (1ULL << schedule[l]) * 2;
        stepsibs_stride += (layer_mp_bits[l] - layer_cap_h[l]) * 4;
    }

    uint64_t half_inv = f_inv(2);

    uint64_t row_off[MAX_ORACLES];
    row_off[0] = 0;
    for (uint64_t o = 1; o < n_oracles; o++)
        row_off[o] = row_off[o - 1] + oracle_widths[o - 1];

    vq_ctx ctx = {
        .lde_bits = lde_bits, .n_layers = n_layers, .n_oracles = n_oracles,
        .n_batches = n_batches, .cap_height = cap_height,
        .final_len = final_len, .g = g, .w0 = w0, .half_inv = half_inv,
        .row_stride = row_stride, .sibs_stride = sibs_stride,
        .leaves_stride = leaves_stride, .stepsibs_stride = stepsibs_stride,
        .sib_len_init = sib_len_init,
        .schedule = schedule, .oracle_widths = oracle_widths,
        .oracle_caps = oracle_caps, .commit_caps = commit_caps,
        .batch_sizes = batch_sizes, .batch_points = batch_points,
        .poly_oi = poly_oi, .poly_pj = poly_pj, .openings = openings,
        .betas = betas, .final_poly = final_poly, .indices = indices,
        .initial_rows = initial_rows, .initial_sibs = initial_sibs,
        .step_leaves = step_leaves, .step_sibs = step_sibs,
        .apows = apows,
        .layer_mp_bits = layer_mp_bits, .layer_cap_h = layer_cap_h,
        .layer_leaf_off = layer_leaf_off, .layer_sib_off = layer_sib_off,
        .layer_cap_off = layer_cap_off,
        .cap_off_oracle = cap_off_oracle, .row_off = row_off,
    };

    /* rounds are independent; verify them in parallel and report the
     * error of the LOWEST-numbered failing round so the result (success
     * or exact failure code) is identical to the serial walk. */
    int64_t result = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int64_t r = 0; r < (int64_t)n_rounds; r++) {
        int64_t e = verify_one_round(&ctx, (uint64_t)r);
        if (e) {
#ifdef _OPENMP
#pragma omp critical
#endif
            {
                uint64_t r_new = (uint64_t)((e >> 16) & 0xFFFF);
                uint64_t r_old = (uint64_t)((result >> 16) & 0xFFFF);
                if (result == 0 || r_new < r_old) result = e;
            }
        }
    }
    return result;
}

/* ---- linear op-tape evaluator (plonk/constraint_tape.py) ----
 *
 * Replays the recorded vanishing-check computation (gate constraints through
 * the shared definitions + permutation argument + alpha combination) over
 * the quadratic extension. Node ids: [0, n_inputs) are caller-filled in
 * `values`; op k defines node n_inputs + k. */

#define TOP_CONST 0
#define TOP_ADD 1
#define TOP_SUB 2
#define TOP_MUL 3
#define TOP_SMUL 4

void eval_tape(const uint8_t *ops, const uint32_t *ia, const uint32_t *ib,
               uint64_t n_ops, const uint64_t *pool /* (n_pool, 2) */,
               uint64_t n_inputs, uint64_t *values /* (n_inputs+n_ops, 2) */) {
    ext_t *v = (ext_t *)values;
    for (uint64_t k = 0; k < n_ops; k++) {
        uint64_t id = n_inputs + k;
        uint32_t a = ia[k], b = ib[k];
        switch (ops[k]) {
        case TOP_CONST:
            v[id] = (ext_t){pool[2 * a], pool[2 * a + 1]};
            break;
        case TOP_ADD:
            v[id] = e_add(v[a], v[b]);
            break;
        case TOP_SUB:
            v[id] = e_sub(v[a], v[b]);
            break;
        case TOP_MUL:
            v[id] = e_mul(v[a], v[b]);
            break;
        case TOP_SMUL:
            v[id] = e_scalar(v[a], pool[2 * b]);
            break;
        default:
            v[id] = (ext_t){0, 0};
        }
    }
}

/* Duplex-sponge absorption for the Fiat-Shamir challenger: absorb `n` felts
 * into (state, partial input buffer of k felts), overwrite mode, permuting on
 * each full rate-8 block. Returns the new buffer fill count; the state is
 * updated in place and the leftover felts stay in buf. */
void p2_permute_batch(uint64_t *states, size_t n); /* poseidon2.c */

int64_t p2_absorb_many(uint64_t *state /* 12 */, uint64_t *buf /* 8 */,
                       int64_t k, const uint64_t *felts, uint64_t n) {
    for (uint64_t i = 0; i < n; i++) {
        buf[k++] = felts[i];
        if (k == 8) {
            for (int j = 0; j < 8; j++) state[j] = buf[j];
            p2_permute_batch(state, 1);
            k = 0;
        }
    }
    return k;
}
