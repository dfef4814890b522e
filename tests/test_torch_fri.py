"""The port's FRI prover and verifier, held field for field against the
reference's on the golden input of chip_smoke.GOLDEN_FRI (log_n 5, rate 3,
tests/test_fri.py's configuration).

The reference's fri_prove takes 15-30 s of CPU here, so one module-scoped
fixture runs it once; every other reference call in this file reuses the
shapes it compiled."""

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import ntt as jntt
from city_rollup_tpu.core.challenger import Challenger as JChallenger
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri, ntt
from city_rollup_tpu_torch.core.challenger import Challenger

P = jg.P
CFG = fri.FriConfig(**chip_smoke.GOLDEN_FRI_CONFIG)
JCFG = jfri.FriConfig(**chip_smoke.GOLDEN_FRI_CONFIG)
LOG_N, SHIFT = 5, 7
LOG_M = LOG_N + CFG.rate_bits


@pytest.fixture(scope="module")
def ref():
    """The reference's codeword (jax pairs) and proof on the golden input."""
    c0, c1 = chip_smoke.golden_fri_coeffs()
    cw = (jntt.coset_lde(jg.from_u64(c0), LOG_N, CFG.rate_bits),
          jntt.coset_lde(jg.from_u64(c1), LOG_N, CFG.rate_bits))
    return cw, jfri.fri_prove(cw, LOG_M, SHIFT, JCFG, JChallenger())


def _port_codeword(seed=None):
    """The golden codeword (seed None) or another low-degree one, computed
    by the port on the CPU."""
    if seed is None:
        coeffs = chip_smoke.golden_fri_coeffs()
    else:
        rng = np.random.default_rng(seed)
        coeffs = [rng.integers(0, P, size=1 << LOG_N, dtype=np.uint64)
                  for _ in range(2)]
    return tuple(ntt.coset_lde(convert.from_u64(c, "cpu"), LOG_N,
                               CFG.rate_bits) for c in coeffs)


def _prove(codeword):
    return fri.fri_prove(codeword, LOG_M, SHIFT, CFG, Challenger(),
                         device="cpu")


def test_codeword_and_proof_equal_the_references(ref):
    cw, want = ref
    port_cw = convert.from_jax_ext(cw, device="cpu")
    for got, c in zip(_port_codeword(), port_cw):
        assert torch.equal(got, c)
    for got, c in zip(convert.to_jax_ext(port_cw), cw):
        np.testing.assert_array_equal(got[0], np.asarray(c[0]))
        np.testing.assert_array_equal(got[1], np.asarray(c[1]))
    proof = _prove(port_cw)
    assert convert.fri_proof_equal(proof, want)
    # numpy uint64 codewords are taken too
    np_cw = tuple(convert.to_u64(c) for c in port_cw)
    assert convert.fri_proof_equal(
        fri.fri_prove(np_cw, LOG_M, SHIFT, CFG, Challenger(), device="cpu"),
        want)


def test_golden_fri_is_the_references(ref):
    assert chip_smoke.golden_fri_differences(ref[1]) == []


def test_each_verifier_accepts_the_other_packages_proof(ref):
    proof = _prove(_port_codeword())
    assert jfri.fri_verify(proof, LOG_M, SHIFT, JCFG, JChallenger())
    assert fri.fri_verify(ref[1], LOG_M, SHIFT, CFG, Challenger())


def test_tampered_final_poly_is_rejected(ref):
    for proof in (_prove(_port_codeword()), copy.deepcopy(ref[1])):
        c = proof.final_poly[0]
        proof.final_poly[0] = ((c[0] + 1) % P, c[1])
        assert not fri.fri_verify(proof, LOG_M, SHIFT, CFG, Challenger())
        assert not jfri.fri_verify(proof, LOG_M, SHIFT, JCFG, JChallenger())


@pytest.mark.parametrize("keep", [0, CFG.num_query_rounds - 1])
def test_missing_query_rounds_are_rejected(ref, keep):
    """A proof must carry every query round: one with fewer is rejected
    even though each round it does carry checks out."""
    proof = copy.deepcopy(ref[1])
    del proof.query_rounds[keep:]
    assert not fri.fri_verify(proof, LOG_M, SHIFT, CFG, Challenger())
    extra = copy.deepcopy(ref[1])
    extra.query_rounds.append(extra.query_rounds[0])
    assert not fri.fri_verify(extra, LOG_M, SHIFT, CFG, Challenger())


def test_high_degree_codeword_raises():
    rng = np.random.default_rng(9)
    evals = [rng.integers(0, P, size=1 << LOG_M, dtype=np.uint64)
             for _ in range(2)]
    with pytest.raises(ValueError):
        fri.fri_prove(evals, LOG_M, SHIFT, CFG, Challenger(), device="cpu")


def test_batch_equals_one_at_a_time(ref):
    cws = [_port_codeword(), _port_codeword(seed=3)]
    batch = fri.fri_prove_batch(
        (torch.stack([c[0] for c in cws]), torch.stack([c[1] for c in cws])),
        LOG_M, SHIFT, CFG, [Challenger(), Challenger()], device="cpu")
    assert len(batch) == 2
    assert convert.fri_proof_equal(batch[0], ref[1])
    assert convert.fri_proof_equal(batch[1], _prove(cws[1]))
    assert not convert.fri_proof_equal(batch[0], batch[1])
    assert fri.fri_verify(batch[1], LOG_M, SHIFT, CFG, Challenger())


def test_fold_and_leaves_match_the_references(ref):
    cw, _ = ref
    port_cw = convert.from_jax_ext(cw, device="cpu")
    leaves = jfri._ext_codeword_to_leaves(cw)
    np.testing.assert_array_equal(
        convert.to_u64(fri._ext_codeword_to_leaves(port_cw)),
        jg.to_u64(np.asarray(leaves[0]), np.asarray(leaves[1])))
    lo, hi = jfri._fold_inv_x_table(LOG_M, SHIFT)
    np.testing.assert_array_equal(
        convert.to_u64(fri._fold_inv_x_table(LOG_M, SHIFT, "cpu")),
        jg.to_u64(lo, hi))
    beta = (P - 5, (1 << 63) + 11)
    want = jfri._fold_codeword(cw, beta, LOG_M, SHIFT)
    got = fri._fold_codeword(port_cw, fri._betas([beta], "cpu")[0], LOG_M,
                             SHIFT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            convert.to_u64(g), jg.to_u64(np.asarray(w[0]), np.asarray(w[1])))
    # per-codeword betas (B, 2) fold B codewords in one pass
    other = _port_codeword(seed=4)
    betas = [beta, (3, P - 1)]
    both = fri._fold_codeword(
        (torch.stack([port_cw[0], other[0]]),
         torch.stack([port_cw[1], other[1]])),
        fri._betas(betas, "cpu"), LOG_M, SHIFT)
    for b, c in enumerate((port_cw, other)):
        one = fri._fold_codeword(c, fri._betas([betas[b]], "cpu")[0], LOG_M,
                                 SHIFT)
        assert torch.equal(both[0][b], one[0])
        assert torch.equal(both[1][b], one[1])


def test_grind_returns_the_references_witness():
    ch, jch = Challenger(), JChallenger()
    ch.observe_elements([1, 2, 3])
    jch.observe_elements([1, 2, 3])
    assert fri.grind(ch, pow_bits=8, device="cpu") == \
        jfri.grind(jch, pow_bits=8)


@pytest.mark.parametrize("observed", [[], list(range(10, 17))])
def test_grind_returns_the_first_hit(observed):
    """The witness is the first candidate, in order, whose challenge meets
    the target (checked with the host permutation; the reference's grind
    costs ~8 s of CPU per call here)."""
    ch = Challenger()
    ch.observe_elements(observed)
    w = fri.grind(ch, pow_bits=8, device="cpu")
    assert ch.input_buffer == observed               # grind works on a copy
    for cand in range(w + 1):
        trial = copy.deepcopy(ch)
        trial.observe_element(cand)
        assert (trial.get_challenge() < 1 << 56) == (cand == w)


def test_challenger_matches_reference():
    ch, jch = Challenger(), JChallenger()
    rng = np.random.default_rng(12)
    cap = rng.integers(0, P, size=(4, 4), dtype=np.uint64)
    for c in (ch, jch):
        c.observe_cap(cap)
        c.observe_ext((5, P - 1))
        c.observe_elements(range(11))
    assert ch.get_extension_challenge() == jch.get_extension_challenge()
    assert ch.get_hash() == jch.get_hash()
    assert ch.get_n_challenges(9) == jch.get_n_challenges(9)
    assert ch.state == jch.state
    with pytest.raises(ValueError):
        ch.observe_element(P)


@pytest.mark.parametrize("claim", ["right", "wrong", "none"])
def test_initial_eval_fn_matches_the_references(ref, claim):
    """fri_verify's initial_eval_fn(query_round, index): the codeword's
    value at each queried index passes; a wrong value in one round, or
    None, rejects, in both packages' verifiers, on the same proof."""
    cw = [convert.to_u64(c) for c in _port_codeword()]
    seen = []

    def value(qr, idx):
        seen.append((qr, idx))
        v = (int(cw[0][idx]), int(cw[1][idx]))
        if claim == "none" and qr == 2:
            return None
        if claim == "wrong" and qr == CFG.num_query_rounds - 1:
            return ((v[0] + 1) % P, v[1])
        return v

    want = claim == "right"
    assert fri.fri_verify(ref[1], LOG_M, SHIFT, CFG, Challenger(),
                          initial_eval_fn=value) == want
    assert [i for _, i in seen] == list(ref[1].query_indices)[:len(seen)]
    assert jfri.fri_verify(ref[1], LOG_M, SHIFT, JCFG, JChallenger(),
                           initial_eval_fn=value) == want
