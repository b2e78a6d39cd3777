/* Witness-replay tape VM: a circuit's recorded generator program, lowered
 * to an opcode stream and run in C.
 *
 * The Python builder records the generators' firing order the first time a
 * circuit proves (plonk/builder.py::run_generators); plonk/witness_tape.py
 * lowers it to this VM, so a later proof's witness is one C call instead of
 * a Python closure call a generator.
 *
 * Opcode stream (int32 records, see plonk/witness_tape.py for the encoder):
 *   CONST     1, out, const_idx
 *   FMADD     2, out, a, b, c, const_idx        out = k0*a*b + k1*c
 *   INV       3, out, a                          out = a^(p-2)
 *   INVZ      4, out, a                          out = a ? a^(p-2) : 0
 *   SPLIT64   5, lo, hi, x                       lo = x & 2^32-1, hi = x >> 32
 *   EXTINV    6, o0, o1, x0, x1                  quadratic-ext inverse (W=7)
 *   POSEIDON  7, in0..in11, 118 trace outputs    (ext_a 48 | inter 22 | ext_b 36 | out 12)
 *   SPLITBITS 8, x, nbits, out0..out_{nbits-1}   little-endian bits (x < 2^nbits checked)
 *
 * Write semantics mirror plonk/builder.py::set_val: first write wins, a
 * later write with a DIFFERENT value is a conflict (error). Returns 0 on
 * success, else ((uint64)code << 32) | record_start_index:
 *   code 1 = value conflict, 2 = unknown opcode, 3 = range-check overflow.
 */

#include <stdint.h>
#include <stddef.h>

#define P 0xFFFFFFFF00000001ULL
#define EXT_W 7ULL /* x^2 - 7 is the irreducible (field/extension.py) */

/* from poseidon2.c (same shared object) */
void p2_permute_trace_batch(const uint64_t *in, size_t n, uint64_t *ext_a,
                            uint64_t *inter, uint64_t *ext_b, uint64_t *out);

#define NEG_P 0xFFFFFFFFULL /* 2^64 mod p = 2^32 - 1 */

/* same reduction as poseidon2.c::reduce128 (two-step carry/borrow fixups) */
static inline uint64_t wt_reduce128(unsigned __int128 x) {
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

static inline uint64_t wt_mul(uint64_t a, uint64_t b) {
    return wt_reduce128((unsigned __int128)a * b);
}

static inline uint64_t wt_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += NEG_P;
    else if (s >= P) s -= P;
    return s;
}

static inline uint64_t wt_sub(uint64_t a, uint64_t b) {
    return a >= b ? a - b : a + (P - b);
}

static uint64_t wt_pow(uint64_t a, uint64_t e) {
    uint64_t r = 1, base = a;
    while (e) {
        if (e & 1) r = wt_mul(r, base);
        base = wt_mul(base, base);
        e >>= 1;
    }
    return r;
}

static inline uint64_t wt_inv(uint64_t a) { return wt_pow(a, P - 2); }

/* set with builder.set_val semantics; returns 0 ok, 1 conflict */
static inline int wt_set(uint64_t *vals, uint8_t *written, int32_t idx, uint64_t v) {
    if (written[idx]) return vals[idx] != v;
    vals[idx] = v;
    written[idx] = 1;
    return 0;
}

int64_t wt_run(const int32_t *code, int64_t code_len, const uint64_t *consts,
               uint64_t *vals, uint8_t *written, int64_t rounds_p) {
    int64_t i = 0;
    while (i < code_len) {
        int64_t rec = i;
        int32_t op = code[i++];
        switch (op) {
        case 1: { /* CONST out, kidx */
            int32_t out = code[i], kidx = code[i + 1];
            i += 2;
            if (wt_set(vals, written, out, consts[kidx]))
                return (1LL << 32) | rec;
            break;
        }
        case 2: { /* FMADD out, a, b, c, kidx */
            int32_t out = code[i], a = code[i + 1], b = code[i + 2],
                    c = code[i + 3], kidx = code[i + 4];
            i += 5;
            uint64_t v = wt_add(wt_mul(consts[kidx], wt_mul(vals[a], vals[b])),
                                wt_mul(consts[kidx + 1], vals[c]));
            if (wt_set(vals, written, out, v)) return (1LL << 32) | rec;
            break;
        }
        case 3: { /* INV out, a */
            int32_t out = code[i], a = code[i + 1];
            i += 2;
            if (wt_set(vals, written, out, wt_inv(vals[a])))
                return (1LL << 32) | rec;
            break;
        }
        case 4: { /* INVZ out, a */
            int32_t out = code[i], a = code[i + 1];
            i += 2;
            uint64_t x = vals[a];
            if (wt_set(vals, written, out, x ? wt_inv(x) : 0))
                return (1LL << 32) | rec;
            break;
        }
        case 5: { /* SPLIT64 lo, hi, x */
            int32_t lo = code[i], hi = code[i + 1], x = code[i + 2];
            i += 3;
            uint64_t v = vals[x];
            if (wt_set(vals, written, lo, v & 0xFFFFFFFFULL))
                return (1LL << 32) | rec;
            if (wt_set(vals, written, hi, v >> 32)) return (1LL << 32) | rec;
            break;
        }
        case 6: { /* EXTINV o0, o1, x0, x1 */
            int32_t o0 = code[i], o1 = code[i + 1], x0 = code[i + 2],
                    x1 = code[i + 3];
            i += 4;
            uint64_t a0 = vals[x0], a1 = vals[x1];
            uint64_t norm = wt_sub(wt_mul(a0, a0), wt_mul(EXT_W, wt_mul(a1, a1)));
            uint64_t ninv = wt_inv(norm);
            if (wt_set(vals, written, o0, wt_mul(a0, ninv)))
                return (1LL << 32) | rec;
            if (wt_set(vals, written, o1, wt_mul(wt_sub(0, a1), ninv)))
                return (1LL << 32) | rec;
            break;
        }
        case 7: { /* POSEIDON 12 ins, 48 + rounds_p + 36 + 12 outs */
            const int32_t *ins = &code[i];
            const int32_t *outs = &code[i + 12];
            int64_t n_out = 48 + rounds_p + 36 + 12;
            i += 12 + n_out;
            uint64_t st[12], ext_a[48], inter[64], ext_b[36], out[12];
            for (int k = 0; k < 12; k++) st[k] = vals[ins[k]];
            p2_permute_trace_batch(st, 1, ext_a, inter, ext_b, out);
            int64_t j = 0;
            for (int k = 0; k < 48; k++, j++)
                if (wt_set(vals, written, outs[j], ext_a[k]))
                    return (1LL << 32) | rec;
            for (int k = 0; k < rounds_p; k++, j++)
                if (wt_set(vals, written, outs[j], inter[k]))
                    return (1LL << 32) | rec;
            for (int k = 0; k < 36; k++, j++)
                if (wt_set(vals, written, outs[j], ext_b[k]))
                    return (1LL << 32) | rec;
            for (int k = 0; k < 12; k++, j++)
                if (wt_set(vals, written, outs[j], out[k]))
                    return (1LL << 32) | rec;
            break;
        }
        case 8: { /* SPLITBITS x, nbits, outs */
            int32_t x = code[i], nbits = code[i + 1];
            const int32_t *outs = &code[i + 2];
            i += 2 + nbits;
            uint64_t v = vals[x];
            if (nbits < 64 && (v >> nbits)) return (3LL << 32) | rec;
            for (int k = 0; k < nbits; k++)
                if (wt_set(vals, written, outs[k], (v >> k) & 1ULL))
                    return (1LL << 32) | rec;
            break;
        }
        default:
            return (2LL << 32) | rec;
        }
    }
    return 0;
}

/* One tape over `count` value arrays (a batch of proofs of one circuit):
 * array k is vals + k * n_vals with its written flags; rcs[k] is wt_run's
 * result for it. The arrays are independent and fan out across cores; each
 * is wt_run's own walk, so the values are bit-equal to `count` single
 * runs. */
void wt_run_many(const int32_t *code, int64_t code_len, const uint64_t *consts,
                 uint64_t *vals, uint8_t *written, int64_t n_vals, int64_t count,
                 int64_t rounds_p, int64_t *rcs) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1) if (count > 1)
#endif
    for (int64_t k = 0; k < count; k++)
        rcs[k] = wt_run(code, code_len, consts, vals + k * n_vals, written + k * n_vals,
                        rounds_p);
}
