"""The port's SNARK prover and verifier against the reference's, on
chip_smoke's tiny circuit under the FAST configuration
(tests/test_device_passes.py's): with zk off the port's proof equals the
reference's field for field, each package's verifier accepts the other's
proofs (zk off and on), and both reject tampered ones.

The reference's build and prove take ~65 s of CPU here (XLA compiles), so
one module fixture runs them once; the port runs on the CPU."""

import copy

import numpy as np
import pytest

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import prover as jprover
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import prover, verifier

P = 0xFFFF_FFFF_0000_0001


def ref_proof_from_plain(plain):
    """convert.proof_to_plain's form -> the reference package's Proof."""
    def cap(c):
        return np.array(c, dtype=np.uint64).reshape(-1, 4)

    def ext(vals):
        return [tuple(v) for v in vals]

    pis, wcap, zcap, qcap, opens, fp, initial = plain
    caps, final_poly, pow_witness, rounds, indices = fp
    return jprover.Proof(
        public_inputs=list(pis), wires_cap=cap(wcap), zs_pp_cap=cap(zcap),
        quotient_cap=cap(qcap),
        openings=jprover.OpeningSet(*[ext(v) for v in opens]),
        fri_proof=jfri.FriProof(
            commit_caps=[cap(c) for c in caps], final_poly=ext(final_poly),
            pow_witness=pow_witness,
            query_rounds=[[jfri.FriQueryLayer(coset=ext(coset),
                                              merkle_path=path)
                           for coset, path in rnd] for rnd in rounds],
            query_indices=list(indices)),
        initial_openings=[jprover.InitialTreeOpening(values=vals,
                                                     paths=paths)
                          for vals, paths in initial])


def _tiny(builder_cls, config_cls, fri_cls, zk=False, xs=(3,)):
    b = builder_cls(chip_smoke.fast_config(config_cls, fri_cls, zk=zk))
    x = chip_smoke.tiny_circuit(b)
    pws = []
    for v in xs:
        pw = b.partial_witness()
        pw.set(x, v)
        pws.append(pw)
    return b, pws


def _port(zk=False, xs=(3,)):
    b, pws = _tiny(CircuitBuilder, CircuitConfig, fri.FriConfig, zk, xs)
    return b.build(device="cpu"), pws


def _ref_host(zk=False):
    """The reference's circuit data, host side only (no preprocessing)."""
    b, _ = _tiny(JBuilder, JConfig, jfri.FriConfig, zk)
    return b.build()


@pytest.fixture(scope="module")
def ref():
    """The reference's data and proof of the tiny circuit, zk off."""
    b, (pw,) = _tiny(JBuilder, JConfig, jfri.FriConfig)
    data = b.build()
    return data, jprover.prove(data, pw)


@pytest.fixture(scope="module")
def port():
    data, (pw,) = _port()
    return data, prover.prove(data, pw)


def _verify_both(plain, tdata, jcommon, jvd):
    return (verifier.verify(convert.proof_from_plain(plain), tdata.common,
                            tdata.verifier),
            jverifier.verify(ref_proof_from_plain(plain), jcommon, jvd))


def _port_vd_for_reference(tdata):
    """The port's verifier data as the reference's type (the two packages'
    caps and digests are held equal in tests/test_torch_snark_circuit.py
    and by test_proof_equals_the_references)."""
    return jcircuit.VerifierData(
        constants_sigmas_cap=tdata.verifier.constants_sigmas_cap,
        circuit_digest=tdata.verifier.circuit_digest)


def test_proof_equals_the_references(ref, port):
    (jd, jp), (td, tp) = ref, port
    np.testing.assert_array_equal(td.verifier.constants_sigmas_cap,
                                  jd.verifier.constants_sigmas_cap)
    assert td.verifier.circuit_digest == jd.verifier.circuit_digest
    assert convert.proof_to_plain(tp) == convert.proof_to_plain(jp)
    assert tp.public_inputs == [9]


def test_golden_proof_is_the_references(ref):
    assert chip_smoke.proof_digest(convert.proof_to_plain(ref[1])) == \
        chip_smoke.GOLDEN_PROOF


def test_plain_form_round_trips(port):
    plain = convert.proof_to_plain(port[1])
    again = convert.proof_to_plain(convert.proof_from_plain(plain))
    assert again == plain
    assert convert.proof_to_plain(ref_proof_from_plain(plain)) == plain


def test_each_verifier_accepts_the_other_packages_proof(ref, port):
    (jd, jp), (td, tp) = ref, port
    assert _verify_both(convert.proof_to_plain(tp), td, jd.common,
                        jd.verifier) == (True, True)
    assert _verify_both(convert.proof_to_plain(jp), td, jd.common,
                        jd.verifier) == (True, True)


def test_zk_proofs_verify_on_both(ref):
    td, pws = _port(zk=True)
    assert td.common.config.num_blinding_rows > 0
    jd = _ref_host(zk=True)
    assert td.common.log_n == jd.common.log_n
    first, second = (convert.proof_to_plain(prover.prove(td, pws[0]))
                     for _ in range(2))
    assert first != second                  # fresh blinding and salts
    for plain in (first, second):
        assert _verify_both(plain, td, jd.common,
                            _port_vd_for_reference(td)) == (True, True)
    # the salts ride in the leaves of the three prover trees
    values = convert.proof_from_plain(first).initial_openings[0].values
    cfg = td.common.config
    assert len(values[1]) == cfg.num_wires + prover.SALT_WIDTH


def _tamper(plain, what):
    plain = copy.deepcopy(plain)
    if what == "public_inputs":
        plain[0][0] = (plain[0][0] + 1) % P
    elif what == "opening":
        w = plain[4][1][0]
        plain[4][1][0] = [(w[0] + 1) % P, w[1]]
    elif what == "quotient_opening":
        q = plain[4][4][-1]
        plain[4][4][-1] = [q[0], (q[1] + 1) % P]
    else:
        k = {"wires_cap": 1, "zs_pp_cap": 2, "quotient_cap": 3}[what]
        plain[k][0][0] = (plain[k][0][0] + 1) % P
    return plain


@pytest.mark.parametrize("what", ["public_inputs", "opening",
                                  "quotient_opening", "wires_cap",
                                  "zs_pp_cap", "quotient_cap"])
def test_tampered_proofs_are_rejected_by_both(ref, port, what):
    (jd, _), (td, tp) = ref, port
    plain = _tamper(convert.proof_to_plain(tp), what)
    assert _verify_both(plain, td, jd.common, jd.verifier) == (False, False)


@pytest.mark.parametrize("keep", [0, 3])
def test_missing_query_round_is_rejected(port, keep):
    """A proof that drops query rounds (FRI round and initial opening) is
    rejected; the reference's verifier does not count them."""
    td, tp = port
    assert len(tp.initial_openings) == td.common.config.fri.num_query_rounds
    short = copy.deepcopy(tp)
    del short.fri_proof.query_rounds[keep:]
    del short.initial_openings[keep:]
    assert not verifier.verify(short, td.common, td.verifier)
    one_less = copy.deepcopy(tp)
    del one_less.initial_openings[-1]
    assert not verifier.verify(one_less, td.common, td.verifier)


def test_prove_batch_equals_prove_one_at_a_time():
    td, pws = _port(xs=(3, 5))
    batch = prover.prove_batch(td, pws)
    assert [p.public_inputs for p in batch] == [[9], [25]]
    for pw, got in zip(pws, batch):
        assert convert.proof_to_plain(got) == \
            convert.proof_to_plain(prover.prove(td, pw))
        assert verifier.verify(got, td.common, td.verifier)


def test_poseidon_circuit_proof_verifies_on_both():
    """A circuit with PoseidonGate rows and hashed public inputs (a Merkle
    path of height 2), proved by the port."""
    def build(builder_cls, config_cls, fri_cls):
        b = builder_cls(chip_smoke.fast_config(config_cls, fri_cls))
        return b, chip_smoke.merkle_paths_circuit(b, 1, height=2)

    tb, paths = build(CircuitBuilder, CircuitConfig, fri.FriConfig)
    td = tb.build(device="cpu")
    jb, _ = build(JBuilder, JConfig, jfri.FriConfig)
    jd = jb.build()
    steps = []
    (proof,) = prover.prove_batch(
        td, [chip_smoke.merkle_paths_witness(tb, paths, seed=3)],
        on_step=steps.append)
    assert steps == ["witness", "wires commit", "permutation pass",
                     "Z commit", "quotient pass", "quotient commit",
                     "openings", "reduced codeword", "FRI",
                     "initial openings"]
    assert len(proof.public_inputs) == 8
    plain = convert.proof_to_plain(proof)
    assert _verify_both(plain, td, jd.common,
                        _port_vd_for_reference(td)) == (True, True)
    assert _verify_both(_tamper(plain, "opening"), td, jd.common,
                        _port_vd_for_reference(td)) == (False, False)
