"""PoseidonGate: one full width-12 Poseidon permutation per trace row.

Counterpart of the reference's ``snark/gate_poseidon.py``: the same wire
layout and constraints (in the same order), without the witness
generator. The 8 full
rounds each store their 12-element output state in wires, giving degree-7
constraints (one x^7 S-box between stored states). The 22 partial rounds
store only their single S-box *input* wire; the linear (MDS + round
constant) evolution between them is precomputed once as affine maps over
the basis [pre-partial state (12), S-box outputs (22), 1], so the whole
partial section costs 22 + 12 wires and constraints instead of 22 * 12.
Total: 142 wires, 130 constraints, max degree 7.

Row layout:
  [0..12)    permutation input   (routed)
  [12..24)   permutation output  (routed)
  [24..60)   state after initial full rounds 0,1,2        (3 * 12)
  [60..72)   state after initial full round 3 (pre-partial)
  [72..94)   S-box input of each partial round            (22)
  [94..106)  state after all partial rounds
  [106..142) state after final full rounds 4,5,6          (3 * 12)
"""

from __future__ import annotations

import functools

from ..core import gl64
from ..core import poseidon_params as params
from .gates import Gate

P = gl64.P
W12 = params.WIDTH
HF = params.HALF_N_FULL_ROUNDS
NPR = params.N_PARTIAL_ROUNDS

COL_IN = 0
COL_OUT = 12
COL_FULL0 = 24                    # 3 stored states (after rounds 0,1,2)
COL_PRE_PARTIAL = COL_FULL0 + 3 * W12
COL_SBOX = COL_PRE_PARTIAL + W12  # 22 partial-round s-box inputs
COL_POST_PARTIAL = COL_SBOX + NPR
COL_FULL1 = COL_POST_PARTIAL + W12  # 3 stored states (after rounds 4,5,6)
NUM_WIRES = COL_FULL1 + 3 * W12   # 142


def _mds_row(state, rr):
    """Affine MDS over vectors of python ints (runs once at import)."""
    circ, diag = params.MDS_MATRIX_CIRC, params.MDS_MATRIX_DIAG
    acc = [diag[rr] * v for v in state[rr]]
    for i in range(W12):
        src = state[(i + rr) % W12]
        c = circ[i]
        acc = [(a + c * v) for a, v in zip(acc, src)]
    return [a % P for a in acc]


@functools.lru_cache(maxsize=1)
def _partial_affine():
    """Precompute the affine evolution of the 22 partial rounds.

    Basis (dim 35): [s_0..s_11 (pre-partial state), y_0..y_21 (s-box
    outputs), 1]. Returns (sbox_in_vecs: 22 x 35, final: 12 x 35) with
    sbox_in_vecs[k] = coefficients of partial round k's s-box input and
    final[j] = coefficients of post-partial state element j.
    """
    dim = W12 + NPR + 1
    rc = params.ALL_ROUND_CONSTANTS
    state = []
    for i in range(W12):
        v = [0] * dim
        v[i] = 1
        state.append(v)
    sbox_in_vecs = []
    for k in range(NPR):
        r = HF + k
        for i in range(W12):
            state[i] = list(state[i])
            state[i][dim - 1] = (state[i][dim - 1] + rc[r * W12 + i]) % P
        sbox_in_vecs.append(list(state[0]))
        y = [0] * dim
        y[W12 + k] = 1
        state[0] = y
        state = [_mds_row(state, rr) for rr in range(W12)]
    return sbox_in_vecs, state


_VEC_TABLES: dict = {}


def _pow7(alg, x):
    x2 = alg.mul(x, x)
    x3 = alg.mul(x2, x)
    x6 = alg.mul(x3, x3)
    return alg.mul(x6, x)


def _mds_alg(alg, state):
    circ, diag = params.MDS_MATRIX_CIRC, params.MDS_MATRIX_DIAG
    out = []
    for rr in range(W12):
        acc = alg.cmul(diag[rr], state[rr])
        for i in range(W12):
            acc = alg.add(acc, alg.cmul(circ[i], state[(i + rr) % W12]))
        out.append(acc)
    return out


def _affine_eval(alg, vec, basis_vals, like):
    acc = alg.const_like(vec[-1], like)
    for c, v in zip(vec[:-1], basis_vals):
        if c:
            acc = alg.add(acc, alg.cmul(c, v))
    return acc


class PoseidonGate(Gate):
    key = "poseidon"
    degree = 7
    num_constraints = 2 * HF * W12 + NPR + W12   # 130

    def eval_alg(self, wires, constants, pi_hash, alg):
        rc = params.ALL_ROUND_CONSTANTS
        cons = []
        # initial full rounds 0..3
        state = [wires[COL_IN + i] for i in range(W12)]
        for fr in range(HF):
            u = [alg.cadd(rc[fr * W12 + i], state[i]) for i in range(W12)]
            s7 = [_pow7(alg, ui) for ui in u]
            nxt = _mds_alg(alg, s7)
            base = (COL_FULL0 + fr * W12 if fr < HF - 1 else COL_PRE_PARTIAL)
            tgt = [wires[base + i] for i in range(W12)]
            cons.extend(alg.sub(tgt[i], nxt[i]) for i in range(W12))
            state = tgt
        # partial rounds: bind each s-box input wire, then the final state
        sbox_vecs, final_vecs = _partial_affine()
        ys = [_pow7(alg, wires[COL_SBOX + k]) for k in range(NPR)]
        basis = state + ys
        like = state[0]
        for k in range(NPR):
            cons.append(alg.sub(wires[COL_SBOX + k],
                                _affine_eval(alg, sbox_vecs[k], basis, like)))
        post = [wires[COL_POST_PARTIAL + i] for i in range(W12)]
        for i in range(W12):
            cons.append(alg.sub(post[i],
                                _affine_eval(alg, final_vecs[i], basis, like)))
        state = post
        # final full rounds 4..7
        r0 = HF + NPR
        for fr in range(HF):
            u = [alg.cadd(rc[(r0 + fr) * W12 + i], state[i])
                 for i in range(W12)]
            s7 = [_pow7(alg, ui) for ui in u]
            nxt = _mds_alg(alg, s7)
            base = (COL_FULL1 + fr * W12 if fr < HF - 1 else COL_OUT)
            tgt = [wires[base + i] for i in range(W12)]
            cons.extend(alg.sub(tgt[i], nxt[i]) for i in range(W12))
            state = tgt
        return cons

