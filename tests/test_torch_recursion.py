"""The port's recursion (snark/recursion.py, gadgets.py, minifier.py,
verify_template.py, debug.py) against the reference's, on
tests/test_recursion.py's tiny chain (chip_smoke.recursion_configs): an
inner circuit proved by the port on the CPU, then a wrapper that verifies
that proof in-circuit (ProofMinifier), built by both packages from the same
inner common and verifier data.

The wrappers are equal (rows, gates, sigmas, selector groups, the
wrapper's verifier data), both packages' witness generators give the same
wire matrix, the port's CPU proof of the wrapper equals the reference's
(GOLDEN_WRAP_PROOF) and passes both verifiers. No reference prove runs
here (its XLA compiles cost minutes of CPU); the port proves the inner
circuit and the 2^10 wrapper once each, in module fixtures."""

import copy
import types

import numpy as np
import pytest
import torch

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import minifier as jminifier
from city_rollup_tpu.snark import recursion as jrecursion
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu.snark import verify_template as jtemplate
from city_rollup_tpu.snark.debug import check_witness as jcheck_witness
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import (circuit, minifier, prover,
                                         recursion, verifier,
                                         verify_template)
from city_rollup_tpu_torch.snark.debug import check_witness
from test_torch_snark import ref_proof_from_plain

P = 0xFFFF_FFFF_0000_0001


def _inner(builder_cls, config_cls, fri_cls):
    inner_cfg, _ = chip_smoke.recursion_configs(config_cls, fri_cls)
    b = builder_cls(inner_cfg)
    x, y = chip_smoke.recursion_inner_circuit(b)
    return b, x, y


def _ref_vd(vd):
    """Verifier data (of either package) as the reference's type."""
    return jcircuit.VerifierData(
        constants_sigmas_cap=np.asarray(vd.constants_sigmas_cap,
                                        dtype=np.uint64),
        circuit_digest=[int(v) for v in vd.circuit_digest])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU prove is thousands of small torch ops; beside other
    processes, each op's thread barrier costs more than the op, so the
    module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def chain(one_thread):
    """The port's inner data and CPU proof, its one-step MinifierChain
    over it and the chain's CPU proof of the inner proof."""
    b, x, y = _inner(CircuitBuilder, CircuitConfig, fri.FriConfig)
    data = b.build(device="cpu")
    pw = b.partial_witness()
    for t, v in zip((x, y), chip_smoke.RECURSION_INNER_XY):
        pw.set(t, v)
    proof = prover.prove(data, pw)
    _, wrap_cfg = chip_smoke.recursion_configs(CircuitConfig, fri.FriConfig)
    ch = minifier.MinifierChain.build(data, 1, wrap_cfg, device="cpu")
    return data, proof, ch, ch.prove(proof)


@pytest.fixture(scope="module")
def ref_wrapper(chain):
    """The reference's wrapper, built (host only) from the reference's
    inner common and the port's inner verifier data."""
    data = chain[0]
    b, _, _ = _inner(JBuilder, JConfig, jfri.FriConfig)
    inner = types.SimpleNamespace(common=b.build().common,
                                  verifier=_ref_vd(data.verifier))
    _, wrap_cfg = chip_smoke.recursion_configs(JConfig, jfri.FriConfig)
    return jminifier.ProofMinifier.build(inner, wrap_cfg)


def _witness(step, proof, recursion_mod, generate):
    pw = step.data._builder.partial_witness()
    recursion_mod.set_proof_witness(pw, step.proof_targets, proof)
    wires = generate(step.data, pw)
    pis = [pw.get(t) or 0 for t in step.data.prover.pi_targets]
    return wires, prover.public_inputs_hash(pis)


@pytest.fixture(scope="module")
def wrap_witness(chain):
    _, proof, ch, _ = chain
    return _witness(ch.steps[0], proof, recursion,
                    circuit.generate_witness)


def _rows(data):
    return [None if r is None else (r.gate.key, r.constants)
            for r in data.prover.rows]


def test_wrapper_circuit_equals_the_references(chain, ref_wrapper):
    data, _, ch, _ = chain
    td, jd = ch.steps[0].data, ref_wrapper.data
    assert (td.common.log_n, len(_rows(td))) == (10, 1 << 10)
    assert _rows(td) == _rows(jd)
    assert td.prover.row_gate_id == jd.prover.row_gate_id
    assert [g.key for g in td.common.gates] == \
        [g.key for g in jd.common.gates]
    assert td.common.selector_groups == jd.common.selector_groups
    assert td.common.num_public_inputs == jd.common.num_public_inputs == 1
    for name in ("sigmas", "const_sigma_values", "subgroup"):
        np.testing.assert_array_equal(getattr(td.prover, name),
                                      getattr(jd.prover, name))
    # the six gate kinds of the in-circuit verifier, and the public input
    assert set(chip_smoke.gate_row_counts(td)) == {
        "arithmetic<8>", "poseidon", "reducing<26>", "reducing_ext<13>",
        "base_sum<16>", "constant<2>", "public_input"}


def test_wrapper_verifier_data_and_template_equal_the_references(
        chain, ref_wrapper):
    """The wrapper's constants/sigmas cap and digest (pinned by the
    golden proof, whose transcript starts with them) and, over the same
    verifier data, the fingerprint and the verifier template."""
    _, _, ch, _ = chain
    td, jd = ch.steps[0].data, ref_wrapper.data
    vd = td.verifier
    fp = recursion.fingerprint_verifier_data(vd)
    assert fp == jrecursion.fingerprint_verifier_data(_ref_vd(vd))
    assert ch.fingerprint == ch.steps[0].fingerprint == tuple(fp)
    ref_view = types.SimpleNamespace(common=jd.common, verifier=_ref_vd(vd))
    assert verify_template.circuit_template(td) == \
        jtemplate.circuit_template(ref_view)
    assert verify_template.template_to_json(td) == \
        jtemplate.template_to_json(ref_view)
    assert verify_template.template_shape_key(
        verify_template.circuit_template(td)) == \
        jtemplate.template_shape_key(jtemplate.circuit_template(ref_view))


def test_same_wrapper_witness(chain, ref_wrapper, wrap_witness):
    _, proof, _, _ = chain
    want, want_pi = _witness(
        ref_wrapper, ref_proof_from_plain(convert.proof_to_plain(proof)),
        jrecursion, jcircuit.generate_witness)
    got, got_pi = wrap_witness
    assert got.dtype == np.uint64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got_pi == want_pi
    assert jcheck_witness(ref_wrapper.data, want, want_pi) == []


def test_check_witness_accepts_the_wrapper_witness(chain, wrap_witness):
    wires, pi_hash = wrap_witness
    assert check_witness(chain[2].steps[0].data, wires, pi_hash) == []


def _tampered(proof, what):
    bad = copy.deepcopy(proof)
    if what == "wire opening":
        w0 = bad.openings.wires[0]
        bad.openings.wires[0] = ((w0[0] + 1) % P, w0[1])
    elif what == "public input":
        bad.public_inputs = [999]
    elif what == "final poly":
        c = bad.fri_proof.final_poly[0]
        bad.fri_proof.final_poly[0] = ((c[0] + 1) % P, c[1])
    else:
        bad.fri_proof.pow_witness = int(bad.fri_proof.pow_witness) + 1
    return bad


@pytest.mark.parametrize("what", ["wire opening", "public input",
                                  "final poly", "pow witness"])
def test_wrap_rejects_tampered_inner_proof(chain, wrap_witness, what):
    """A changed inner proof cannot be completed into a wrapper witness
    (a witness conflict at the first in-circuit check it fails), and the
    honest witness with the changed felt's copy class rewritten violates
    gate constraints."""
    _, proof, ch, _ = chain
    step = ch.steps[0]
    bad = _tampered(proof, what)
    with pytest.raises(ValueError, match="witness conflict"):
        _witness(step, bad, recursion, circuit.generate_witness)
    pt = step.proof_targets
    target, value = {
        "wire opening": (pt.openings.wires[0][0],
                         bad.openings.wires[0][0]),
        "public input": (pt.public_inputs[0], 999),
        "final poly": (pt.fri.final_poly[0][0],
                       bad.fri_proof.final_poly[0][0]),
        "pow witness": (pt.fri.pow_witness, bad.fri_proof.pow_witness),
    }[what]
    wires, pi_hash = wrap_witness
    forged = chip_smoke.with_target_value(step.data, wires, target, value)
    if what == "public input":
        pi_hash = prover.public_inputs_hash([value])
    bad_rows = check_witness(step.data, forged, pi_hash)
    assert bad_rows and all(b.startswith("row ") for b in bad_rows)


def test_wrap_proof_is_the_golden_and_passes_both_verifiers(chain,
                                                            ref_wrapper):
    data, proof, ch, wproof = chain
    td = ch.steps[0].data
    plain = convert.proof_to_plain(wproof)
    assert chip_smoke.proof_digest(plain) == chip_smoke.GOLDEN_WRAP_PROOF
    assert wproof.public_inputs == proof.public_inputs == [3 * 5 + 3 + 7]
    assert verifier.verify(convert.proof_from_plain(plain), td.common,
                           td.verifier)
    assert jverifier.verify(ref_proof_from_plain(plain),
                            ref_wrapper.data.common, _ref_vd(td.verifier))
    # and the inner proof, which the reference verifier also accepts
    assert jverifier.verify(
        ref_proof_from_plain(convert.proof_to_plain(proof)),
        _inner(JBuilder, JConfig, jfri.FriConfig)[0].build().common,
        _ref_vd(data.verifier))


def test_wrap_proof_with_changed_opening_is_rejected_by_both(chain,
                                                             ref_wrapper):
    _, _, ch, wproof = chain
    td = ch.steps[0].data
    plain = convert.proof_to_plain(_tampered(wproof, "wire opening"))
    assert not verifier.verify(convert.proof_from_plain(plain), td.common,
                               td.verifier)
    assert not jverifier.verify(ref_proof_from_plain(plain),
                                ref_wrapper.data.common,
                                _ref_vd(td.verifier))


def _aggregation(builder_cls, config_cls, fri_cls, recursion_mod,
                 child_common):
    _, wrap_cfg = chip_smoke.recursion_configs(config_cls, fri_cls)
    b = builder_cls(wrap_cfg)
    pt, vdt = chip_smoke.aggregation_circuit(b, recursion_mod, child_common)
    return b, pt, vdt


def test_aggregation_step_admits_a_child_by_fingerprint(chain):
    """chip_smoke.aggregation_circuit over the inner proof, with the
    verifier data as witness: the same rows and witness in both packages,
    a clean witness whose public inputs are the child's fingerprint, and
    another circuit's verifier data rejected."""
    data, proof, ch, _ = chain
    jb, _, _ = _inner(JBuilder, JConfig, jfri.FriConfig)
    jcommon = jb.build().common
    tb, tpt, tvdt = _aggregation(CircuitBuilder, CircuitConfig,
                                 fri.FriConfig, recursion, data.common)
    jbb, jpt, jvdt = _aggregation(JBuilder, JConfig, jfri.FriConfig,
                                  jrecursion, jcommon)
    td, jd = tb.build(device="cpu"), jbb.build()
    assert _rows(td) == _rows(jd)
    np.testing.assert_array_equal(td.prover.sigmas, jd.prover.sigmas)

    def fill(b, rec, pt, vdt, prf, vd):
        pw = b.partial_witness()
        rec.set_proof_witness(pw, pt, prf)
        rec.set_verifier_data_witness(pw, vdt, vd)
        return pw

    tpw = fill(tb, recursion, tpt, tvdt, proof, data.verifier)
    jpw = fill(jbb, jrecursion, jpt, jvdt,
               ref_proof_from_plain(convert.proof_to_plain(proof)),
               _ref_vd(data.verifier))
    got = circuit.generate_witness(td, tpw)
    np.testing.assert_array_equal(got, jcircuit.generate_witness(jd, jpw))
    pis = [tpw.get(t) for t in td.prover.pi_targets]
    assert pis == recursion.fingerprint_verifier_data(data.verifier)
    assert check_witness(td, got, prover.public_inputs_hash(pis)) == []
    # the wrapper's verifier data is not the inner proof's
    wrong = fill(tb, recursion, tpt, tvdt, proof, ch.steps[0].data.verifier)
    with pytest.raises(ValueError, match="witness conflict"):
        circuit.generate_witness(td, wrong)
