"""The port's gates and evaluation algebras against the reference's: each
gate's constraints over the LDE domain (TorchAlg against NpAlg), at one
extension point (HostExtAlg against the reference's), PoseidonGate's
vectorized form against the reference's numpy eval_alg, and the witness
generators. Exact: Goldilocks values are canonical u64s."""

import numpy as np
import pytest
import torch

from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.snark import algebra as jalg
from city_rollup_tpu.snark import gate_poseidon as jpos
from city_rollup_tpu.snark import gates as jgates
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.snark import algebra, gate_poseidon, gates

P = jg.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]
B, M = 2, 16


def _edge_or_random(rng) -> int:
    return int(rng.choice(EDGE + [int(rng.integers(0, P, dtype=np.uint64))]))


def _gate_pairs():
    """(reference gate, port gate) of every kind, at small sizes."""
    return [(jgates.ArithmeticGate(8), gates.ArithmeticGate(8)),
            (jgates.ConstantGate(2), gates.ConstantGate(2)),
            (jgates.BaseSumGate(5), gates.BaseSumGate(5)),
            (jgates.PublicInputGate(), gates.PublicInputGate()),
            (jgates.ReducingGate(3), gates.ReducingGate(3)),
            (jgates.ReducingExtGate(2), gates.ReducingExtGate(2)),
            (jpos.PoseidonGate(), gate_poseidon.PoseidonGate())]


def _domain(seed, rows, shape=(B, M)):
    """rows random (B, M) uint64 arrays, each with every edge value in its
    first columns (shifted by row, so the edge pairs vary)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, P, size=(rows,) + shape, dtype=np.uint64)
    for r in range(rows):
        for j, v in enumerate(EDGE):
            out[r, ..., (j + r) % len(EDGE)] = v
    return out


def _inputs(seed):
    wires = _domain(seed, 144)
    consts = _domain(seed + 1, 2, (M,))
    pis = [np.array([EDGE[i], (i * 7919) % P], dtype=np.uint64)
           for i in range(4)]
    return wires, consts, pis


def _port_args(wires, consts, pis):
    w = [convert.from_u64(x, "cpu") for x in wires]
    c = [convert.from_u64(x, "cpu") for x in consts]
    pi = [algebra.lift_torch(v, w[0]) for v in pis]
    return w, c, pi


@pytest.mark.parametrize("k", range(7))
def test_eval_alg_under_torch_alg_matches_numpy(k):
    ref, port = _gate_pairs()[k]
    wires, consts, pis = _inputs(seed=10 + k)
    want = ref.eval_alg(list(wires), list(consts),
                        [v.reshape(B, 1) for v in pis], jalg.NpAlg)
    got = port.eval_alg(*_port_args(wires, consts, pis), algebra.TorchAlg)
    assert len(got) == len(want) == port.num_constraints
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(g),
                                      np.broadcast_to(w, (B, M)))


@pytest.mark.parametrize("k", range(7))
def test_eval_torch_vec_matches_numpy(k):
    """eval_torch_vec, the quotient pass's entry (PoseidonGate's own
    vectorized form: 8 stacked full rounds, rolled MDS, affine partial
    section), against the reference's numpy eval_vec."""
    ref, port = _gate_pairs()[k]
    wires, consts, pis = _inputs(seed=30 + k)
    want = ref.eval_vec(list(wires), list(consts),
                        [v.reshape(B, 1) for v in pis])
    got = port.eval_torch_vec(*_port_args(wires, consts, pis))
    assert len(got) == len(want) == port.num_constraints
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(g),
                                      np.broadcast_to(w, (B, M)))


def test_poseidon_vec_is_zero_on_a_valid_row():
    """A generated PoseidonGate row satisfies all 130 constraints."""
    port = gate_poseidon.PoseidonGate()
    row = dict(enumerate(EDGE + [5, 6, 7, 8, 9, 10]))
    port.generate(0, row.get, row.__setitem__)
    w = [convert.from_u64(np.full((1, 4), row[c], dtype=np.uint64), "cpu")
         for c in range(gate_poseidon.NUM_WIRES)]
    for cv in port.eval_torch_vec(w, [], []):
        assert not cv.any()


@pytest.mark.parametrize("k", range(7))
def test_eval_host_matches_reference(k):
    ref, port = _gate_pairs()[k]
    rng = np.random.default_rng(50 + k)

    def ext():
        return (_edge_or_random(rng),
                int(rng.integers(0, P, dtype=np.uint64)))

    wires = [ext() for _ in range(144)]
    consts = [ext() for _ in range(2)]
    pi = [EDGE[i] for i in range(4)]
    assert port.eval_host(wires, consts, pi) == \
        ref.eval_host(wires, consts, pi)


def _run_generators(gate, inputs, consts):
    """Run a gate's sub-generators on one row whose dependency columns hold
    `inputs`; returns the row."""
    row = {}
    for deps, fn in gate.sub_generators():
        for c in (range(len(inputs)) if deps is None else deps):
            row.setdefault(c, inputs[c])
        fn(0, row.get, row.__setitem__, constants=consts)
    return row


@pytest.mark.parametrize("k", range(7))
def test_generate_matches_reference(k):
    ref, port = _gate_pairs()[k]
    rng = np.random.default_rng(70 + k)
    inputs = [_edge_or_random(rng) for _ in range(144)]
    if isinstance(port, gates.BaseSumGate):
        inputs[0] = 0b10110
    consts = (P - 1, 1 << 32)
    assert [d for d, _ in ref.sub_generators()] == \
        [d for d, _ in port.sub_generators()]
    want = _run_generators(ref, inputs, consts)
    assert _run_generators(port, inputs, consts) == want
    assert bool(want) == bool(port.sub_generators())


def test_gate_keys_round_trip():
    for ref, port in _gate_pairs():
        assert port.key == ref.key
        assert gates.gate_from_key(port.key).key == port.key
        assert (port.num_constraints, port.degree) == \
            (ref.num_constraints, ref.degree)
    with pytest.raises(KeyError):
        gates.gate_from_key("nope<3>")


def test_poseidon_layout_and_affine_tables_match_reference():
    for name in ("COL_IN", "COL_OUT", "COL_FULL0", "COL_PRE_PARTIAL",
                 "COL_SBOX", "COL_POST_PARTIAL", "COL_FULL1", "NUM_WIRES"):
        assert getattr(gate_poseidon, name) == getattr(jpos, name)
    assert gate_poseidon.NUM_WIRES == 142
    assert gate_poseidon._partial_affine() == jpos._partial_affine()


def test_torch_alg_literals_and_lifts():
    like = convert.from_u64(_domain(90, 1)[0], "cpu")          # (B, M)
    for c in EDGE + [P + 3, -1]:
        want_mul = jalg.NpAlg.cmul(c, convert.to_u64(like))
        np.testing.assert_array_equal(
            convert.to_u64(algebra.TorchAlg.cmul(c, like)), want_mul)
        np.testing.assert_array_equal(
            convert.to_u64(algebra.TorchAlg.cadd(c, like)),
            jalg.NpAlg.cadd(c, convert.to_u64(like)))
        k = algebra.TorchAlg.const_like(c, like)
        assert k.shape == like.shape
        np.testing.assert_array_equal(
            convert.to_u64(k), jalg.NpAlg.const_like(c, convert.to_u64(like)))
    col = algebra.lift_torch(np.array([3, P - 1], dtype=np.uint64), like)
    assert col.shape == (B, 1)
    assert convert.to_u64(col).ravel().tolist() == [3, P - 1]
    assert convert.to_u64(algebra.lift_torch(torch.tensor([5, 6]), like)
                          ).ravel().tolist() == [5, 6]
    assert algebra.lift_torch(P + 2, like).shape == ()
    assert int(algebra.lift_torch(P + 2, like)) == 2
    assert algebra.lift_host(P + 1) == jalg.lift_host(P + 1) == (1, 0)
