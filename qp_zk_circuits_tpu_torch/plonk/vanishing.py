"""The vanishing-polynomial constraint list, shared by prover and verifier.

Defines the CANONICAL ordered list of constraints whose alpha-combination
must equal Z_H(x) * t(x):

  [ per gate type, per gate constraint:  selector_s(x) * constraint_k(x) ]
  ++ per challenge c:
     [ L_1(x) * (Z_c(x) - 1),
       pp_{c,0}(x) * D_0(x) - Z_c(x)    * N_0(x),
       pp_{c,j}(x) * D_j(x) - pp_{c,j-1}(x) * N_j(x)      (0 < j < last),
       Z_c(gx)     * D_last(x) - pp_{c,last-1}(x) * N_last(x) ]

with N_j = prod_{i in chunk_j} (w_i + beta_c * k_i * x + gamma_c) and
D_j = prod (w_i + beta_c * sigma_i(x) + gamma_c); chunks of size
max_quotient_degree_factor (the reference's partial-products split keeps
constraint degree at qdf + 1 = 9).

The verifier runs this code in the host extension algebra at zeta
(`HostExtAlg`). The prover's quotient evaluates the same list in the same
order, in torch (`plonk/prover.py::quotient_evals_plain`) and in kernel A
(csrc/quotient.cu); tests/test_torch_quotient.py holds both to the JAX
package's copy of this function.
"""

from __future__ import annotations

import numpy as np


def permutation_chunks(num_routed: int, qdf: int) -> list[list[int]]:
    cols = list(range(num_routed))
    return [cols[i : i + qdf] for i in range(0, num_routed, qdf)]


def num_partial_products(num_routed: int, qdf: int) -> int:
    """Committed pp columns per challenge (last product is Z(gx) itself)."""
    return len(permutation_chunks(num_routed, qdf)) - 1


def eval_constraints(
    ctx_gates,
    data,
    wires,
    constants_vals,
    selector_vals,
    sigma_vals,
    zs,
    zs_next,
    pps,
    id_coords,
    l1,
    betas,
    gammas,
    alg,
):
    """Return the full ordered constraint list (values in algebra `alg`).

    wires: list per wire column; constants/selector/sigma_vals: per column;
    zs / zs_next / pps: per challenge (pps: list of lists); id_coords: per
    routed column the value k_i * x; l1: L_1(x); betas/gammas: per-challenge
    scalars in the algebra.
    """
    constraints = []
    # gate constraints, masked by one-hot selectors
    for s, gate in enumerate(data.gate_types):
        for c_val in gate.eval(ctx_gates):
            constraints.append(alg.mul(selector_vals[s], c_val))

    chunks = permutation_chunks(
        data.config.num_routed_wires, data.config.max_quotient_degree_factor
    )
    for c in range(data.config.num_challenges):
        beta, gamma = betas[c], gammas[c]
        # boundary: L_1 * (Z - 1)
        constraints.append(alg.mul(l1, alg.sub(zs[c], alg.one())))
        prev = zs[c]
        for j, chunk in enumerate(chunks):
            num = None
            den = None
            for i in chunk:
                f_num = alg.add(wires[i], alg.add(alg.mul(beta, id_coords[i]), gamma))
                f_den = alg.add(wires[i], alg.add(alg.mul(beta, sigma_vals[i]), gamma))
                num = f_num if num is None else alg.mul(num, f_num)
                den = f_den if den is None else alg.mul(den, f_den)
            nxt = zs_next[c] if j == len(chunks) - 1 else pps[c][j]
            constraints.append(alg.sub(alg.mul(nxt, den), alg.mul(prev, num)))
            prev = nxt
    return constraints


class HostExtAlg:
    """Extension-scalar algebra (verifier at zeta)."""

    def __init__(self):
        from ..field import extension as ext

        self.ext = ext

    def add(self, a, b):
        return self.ext.add(a, b)

    def sub(self, a, b):
        return self.ext.sub(a, b)

    def mul(self, a, b):
        return self.ext.mul(a, b)

    def one(self):
        return (1, 0)
