"""PoseidonGate: one full width-12 Poseidon permutation per trace row.

Counterpart of the reference's ``snark/gate_poseidon.py``: the same wire
layout, constraints (in the same order) and witness generator. The 8 full
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

import torch

from ..core import gl64, poseidon_host
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


def _vec_tables(device):
    """eval_torch_vec's constants on `device` (int64 bit patterns): the
    full rounds' round constants (8, 12), the MDS diagonal (12,), and the
    partial section's affine maps as coefficients (34 out, 34 basis) and
    constant terms (34,)."""
    key = str(device)
    ent = _VEC_TABLES.get(key)
    if ent is None:
        rc = params.ALL_ROUND_CONSTANTS
        r0 = HF + NPR
        rounds = list(range(HF)) + [r0 + fr for fr in range(HF)]
        sbox_vecs, final_vecs = _partial_affine()
        vecs = sbox_vecs + final_vecs

        def tensor(vals):
            return torch.tensor([gl64.to_i64(v) for v in vals],
                                dtype=torch.int64, device=device)

        ent = (tensor([rc[r * W12 + i] for r in rounds
                       for i in range(W12)]).reshape(8, W12),
               tensor(params.MDS_MATRIX_DIAG),
               tensor([v[i] for v in vecs for i in range(W12 + NPR)])
               .reshape(len(vecs), W12 + NPR),
               tensor([v[-1] for v in vecs]))
        _VEC_TABLES[key] = ent
    return ent


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

    def eval_torch_vec(self, wires, constants, pi_hash):
        """eval_alg over int64 tensors with few launches: the eight full
        rounds evaluate as one pass over a leading round axis (their input
        and target states are all stored wires, so the rounds are
        independent), the MDS is 12 lane rolls instead of 144 scalar terms,
        and the partial section is a 35-term affine matvec. eval_alg under
        TorchAlg would launch ~600k elementwise ops per challenge.

        wires: tensors of one shape, (B, M) or (M,). Returns the same 130
        constraints in eval_alg order."""
        dom = wires[0].shape
        ones = (1,) * len(dom)
        rc, diag, coef, const = _vec_tables(wires[0].device)

        def stack(cols):
            return torch.stack([wires[c] for c in cols])

        def state(base):
            return list(range(base, base + W12))

        # ---- full rounds, vectorized over (8 rounds, 12 lanes) ----------
        ins = (state(COL_IN) + state(COL_FULL0) + state(COL_FULL0 + W12) +
               state(COL_FULL0 + 2 * W12) + state(COL_POST_PARTIAL) +
               state(COL_FULL1) + state(COL_FULL1 + W12) +
               state(COL_FULL1 + 2 * W12))
        tgts = (state(COL_FULL0) + state(COL_FULL0 + W12) +
                state(COL_FULL0 + 2 * W12) + state(COL_PRE_PARTIAL) +
                state(COL_FULL1) + state(COL_FULL1 + W12) +
                state(COL_FULL1 + 2 * W12) + state(COL_OUT))
        s7 = gl64.exp7(gl64.add(stack(ins).reshape((8, W12) + dom),
                                rc.reshape((8, W12) + ones)))
        acc = gl64.mul(s7, diag.reshape((1, W12) + ones))
        for i, c in enumerate(params.MDS_MATRIX_CIRC):
            # out[rr] += circ[i] * s7[(i + rr) % 12]: roll lanes by -i
            acc = gl64.add(acc, gl64.mul_small(torch.roll(s7, -i, dims=1),
                                               c))
        full = gl64.sub(stack(tgts).reshape((8, W12) + dom), acc)
        full = full.reshape((8 * W12,) + dom)

        # ---- partial section: 35-term affine matvec ---------------------
        basis = torch.cat([stack(state(COL_PRE_PARTIAL)),
                           gl64.exp7(stack(range(COL_SBOX,
                                                 COL_SBOX + NPR)))])
        out = const.reshape((-1,) + ones)
        for i in range(W12 + NPR):
            out = gl64.add(out, gl64.mul(coef[:, i].reshape((-1,) + ones),
                                         basis[i]))
        aff = gl64.sub(stack(list(range(COL_SBOX, COL_SBOX + NPR)) +
                             state(COL_POST_PARTIAL)), out)

        # ---- emit in eval_alg order -------------------------------------
        half = HF * W12
        return list(torch.cat([full[:half], aff, full[half:]]))

    def generate(self, row, get, set_wire, constants=None):
        state = [get(COL_IN + i) for i in range(W12)]
        if any(v is None for v in state):
            return
        rc = params.ALL_ROUND_CONSTANTS
        r = 0
        for fr in range(HF):
            state = [(s + rc[r * W12 + i]) % P for i, s in enumerate(state)]
            state = [poseidon_host._sbox(s) for s in state]
            state = poseidon_host._mds(state)
            base = (COL_FULL0 + fr * W12 if fr < HF - 1 else COL_PRE_PARTIAL)
            for i in range(W12):
                set_wire(base + i, state[i])
            r += 1
        for k in range(NPR):
            state = [(s + rc[r * W12 + i]) % P for i, s in enumerate(state)]
            set_wire(COL_SBOX + k, state[0])
            state[0] = poseidon_host._sbox(state[0])
            state = poseidon_host._mds(state)
            r += 1
        for i in range(W12):
            set_wire(COL_POST_PARTIAL + i, state[i])
        for fr in range(HF):
            state = [(s + rc[r * W12 + i]) % P for i, s in enumerate(state)]
            state = [poseidon_host._sbox(s) for s in state]
            state = poseidon_host._mds(state)
            base = (COL_FULL1 + fr * W12 if fr < HF - 1 else COL_OUT)
            for i in range(W12):
                set_wire(base + i, state[i])
            r += 1

    def sub_generators(self):
        return [([COL_IN + i for i in range(W12)], self.generate)]
