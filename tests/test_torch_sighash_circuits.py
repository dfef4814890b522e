"""The port's sighash circuits (rollup/sha256_accelerator.py,
sighash_circuit.py's gadgets and circuit, sighash_wrapper.py, the
`sighash-corpus` CLI) against the reference's, at the test configuration
of test_torch_signature.py: circuits built the same way in both packages
have equal rows, columns and witnesses, and proofs made by the port on
the CPU pass the reference's verifier.

A sighash shape circuit is large whatever the FRI settings: the dev
covenant's accelerator alone is 68,512 rows at 2^17 (its shape circuit
35,964 at 2^16 at full width, 9,963 at 2^14 here). So the tests here
hold the pieces at small sizes: an accelerator of one short message
(8,650 rows at 2^14), the felt-packing gadgets, the domain planner, the
wrapper and the final GL over small stand-in inner circuits with the
real public-input layouts (8 inputs for the minified shape, 16 for the
block transition). Whole shapes, proofs of 2^11 rows or more, the corpus
entry and the full-width goldens are `slow`. Where the reference needs a
circuit's verifier data, it is given the port's (`ref_view`, after the
columns are held equal)."""

import random

import numpy as np
import pytest
import torch

import chip_smoke
from city_rollup_tpu.rollup import btc as jbtc
from city_rollup_tpu.rollup import sha256_accelerator as jsa
from city_rollup_tpu.rollup import sighash_circuit as jsc
from city_rollup_tpu.rollup import sighash_tree as jtree
from city_rollup_tpu.rollup import sighash_wrapper as jsw
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu_torch.core import poseidon_host
from city_rollup_tpu_torch.crypto import felts as feltenc
from city_rollup_tpu_torch.crypto.hashes import sha256, sha256d
from city_rollup_tpu_torch.crypto.qhashout import QHashOut
from city_rollup_tpu_torch.rollup import btc
from city_rollup_tpu_torch.rollup import sha256_accelerator as sa
from city_rollup_tpu_torch.rollup import sighash_circuit as sc
from city_rollup_tpu_torch.rollup import sighash_tree
from city_rollup_tpu_torch.rollup import sighash_wrapper as sw
from city_rollup_tpu_torch.snark import CircuitBuilder
from city_rollup_tpu_torch.snark import circuit, prover, verifier
from city_rollup_tpu_torch.snark.debug import check_witness
from city_rollup_tpu_torch.snark.recursion import fingerprint_verifier_data
from city_rollup_tpu_torch.snark.sha256 import set_bytes_witness
from test_torch_signature import (P, assert_same_circuit,
                                  assert_same_witness, configs, ref_proof,
                                  ref_verify, ref_view)

ACCEL_MSG = bytes(random.Random(1).getrandbits(8) for _ in range(40))


@pytest.fixture(scope="module")
def one_thread_module():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def accelerators(one_thread_module):
    """(port, reference) accelerator of one 40-byte message, single sha256
    (one compression)."""
    cfg, jcfg = configs()
    return (sa.Sha256AcceleratorCircuit.build_multi(cfg, [(40, False)],
                                                    device="cpu"),
            jsa.Sha256AcceleratorCircuit.build_multi(jcfg, [(40, False)]))


def test_accelerator_equals_the_reference(accelerators):
    acc, jacc = accelerators
    assert chip_smoke.circuit_rows(acc.data) == 8650
    assert acc.data.common.log_n == 14
    assert_same_circuit(acc.data, jacc.data)
    pws = []
    for a in (acc, jacc):
        pw = a.data._builder.partial_witness()
        set_bytes_witness(pw, a.msg_targets[0], ACCEL_MSG)
        pws.append(pw)
    assert_same_witness(acc.data, pws[0], jacc.data, pws[1])
    root = [pws[0].get(t) for t in acc.data.prover.pi_targets]
    assert root == sa.commitment_root_host([(ACCEL_MSG, sha256(ACCEL_MSG))])
    assert [pws[0].get(t) for t in acc.digest_targets[0]] == \
        list(sha256(ACCEL_MSG))


def standin(builder, n_pis: int):
    """A stand-in inner circuit: `n_pis` free public inputs (the layout of
    the circuit it stands for), nothing else."""
    xs = builder.add_virtual_targets(n_pis)
    builder.register_public_inputs(xs)
    return xs


def standin_pair(n_pis: int):
    """(port data, reference data, port targets) of a stand-in circuit."""
    cfg, jcfg = configs()
    b, jb = CircuitBuilder(cfg), JBuilder(jcfg)
    xs = standin(b, n_pis)
    standin(jb, n_pis)
    data, jdata = b.build(device="cpu"), jb.build()
    assert_same_circuit(data, jdata)
    return data, jdata, xs


def prove_standin(data, xs, values):
    pw = data._builder.partial_witness()
    for t, v in zip(xs, values):
        pw.set(t, int(v))
    return prover.prove(data, pw)


def gadgets_circuit(mod, b):
    """Every felt-packing gadget of sighash_circuit.py over free byte and
    felt targets (mod: either package's sighash_circuit); returns the
    input targets."""
    t = {"h32": b.add_virtual_targets(32), "h4": b.add_virtual_targets(4),
         "val": b.add_virtual_targets(8), "pk": b.add_virtual_targets(33),
         "pkh": b.add_virtual_targets(20),
         "events": [b.add_virtual_targets(4) for _ in range(3)]}
    outs = (mod.felt252_of_bytes(b, None, t["h32"]) +
            mod.felt248_of_bytes(b, None, t["h32"]) +
            mod.felt248_of_hashout(b, t["h4"]) +
            mod.hash224_of_bytes(b, t["h32"]) +
            [mod.le_value_felt(b, t["val"])] +
            mod.pk33_felts(b, t["pk"]) + mod.pkh_felts(b, t["pkh"], 1) +
            mod._events_root_gadget(b, t["events"]) +
            mod._events_root_gadget(b, []))
    b.register_public_inputs(outs)
    return t


def test_felt_packing_gadgets_equal_the_reference_and_the_host():
    cfg, jcfg = configs()
    b, jb = CircuitBuilder(cfg), JBuilder(jcfg)
    t, jt = gadgets_circuit(sc, b), gadgets_circuit(jsc, jb)
    data, jdata = b.build(device="cpu"), jb.build()
    assert_same_circuit(data, jdata)
    rnd = random.Random(3)
    h32 = bytes(rnd.getrandbits(8) for _ in range(32))
    h4 = [rnd.randrange(P) for _ in range(3)] + [P - 1]
    val = (rnd.getrandbits(61)).to_bytes(8, "little")
    pk = b"\x03" + bytes(rnd.getrandbits(8) for _ in range(32))
    pkh = bytes(rnd.getrandbits(8) for _ in range(20))
    events = [[rnd.randrange(P) for _ in range(4)] for _ in range(3)]
    pws = []
    for tt, bb in ((t, b), (jt, jb)):
        pw = bb.partial_witness()
        set_bytes_witness(pw, tt["h32"], h32)
        set_bytes_witness(pw, tt["val"], val)
        set_bytes_witness(pw, tt["pk"], pk)
        set_bytes_witness(pw, tt["pkh"], pkh)
        for targets, values in [(tt["h4"], h4)] + list(zip(tt["events"],
                                                           events)):
            for x, v in zip(targets, values):
                pw.set(x, v)
        pws.append(pw)
    assert_same_witness(data, pws[0], jdata, pws[1])
    pis = [pws[0].get(x) for x in data.prover.pi_targets]
    assert pis == (feltenc.hash256_to_felt252(h32) +
                   feltenc.hash256_to_felt248(h32) +
                   feltenc.hash256_to_felt248(QHashOut(tuple(h4))
                                              .to_le_bytes()) +
                   feltenc.hash256_to_hash224(h32) +
                   [int.from_bytes(val, "little")] +
                   feltenc.bytes33_to_felts(pk) +
                   feltenc.hash160_to_felts(pkh, 1) +
                   btc.events_hash(events) + [0, 0, 0, 0])


def planner_circuit(mod, b, accel_view, messages):
    """Two sha256 requests through mod.Sha256DomainPlanner, bound to the
    accelerator's proof by finalize (mod: either package's
    sha256_accelerator). Returns (planner, message targets, proof
    targets)."""
    planner = mod.Sha256DomainPlanner(msg_len=len(messages[0]))
    msgs = [b.add_virtual_targets(len(m)) for m in messages]
    for m in msgs:
        planner.request_digest(b, m)
    pt = planner.finalize(b, accel_view)
    return planner, msgs, pt


def test_domain_planner_finalize_equals_the_reference(one_thread_module):
    """The consumer side of the accelerator: two 8-byte requests, their
    commitment root connected to a stand-in accelerator's public inputs
    (the root), whose proof the consumer verifies in-circuit."""
    cfg, jcfg = configs()
    messages = [bytes(range(8)), bytes(range(8, 16))]
    digests = [sha256(m) for m in messages]
    root = sa.commitment_root_host(list(zip(messages, digests)))
    accel, jaccel, xs = standin_pair(4)
    accel_proof = prove_standin(accel, xs, root)
    b, jb = CircuitBuilder(cfg), JBuilder(jcfg)
    planner, msgs, pt = planner_circuit(sa, b, accel, messages)
    jplanner, jmsgs, jpt = planner_circuit(jsa, jb,
                                           ref_view(accel, jaccel), messages)
    data, jdata = b.build(device="cpu"), jb.build()
    assert_same_circuit(data, jdata)
    pws = []
    for pl, ms, ptt, bb, proof in (
            (planner, msgs, pt, b, accel_proof),
            (jplanner, jmsgs, jpt, jb, ref_proof(accel_proof))):
        pw = bb.partial_witness()
        for m_t, m in zip(ms, messages):
            set_bytes_witness(pw, m_t, m)
        pl.set_witness(pw, ptt, proof, messages, digests)
        pws.append(pw)
    assert_same_witness(data, pws[0], jdata, pws[1])
    # a digest that is not the message's breaks the root's connection
    pw = b.partial_witness()
    for m_t, m in zip(msgs, messages):
        set_bytes_witness(pw, m_t, m)
    planner.set_witness(pw, pt, accel_proof, messages,
                        [digests[0], sha256d(messages[1])])
    with pytest.raises(ValueError):
        circuit.generate_witness(data, pw)


def capture_prove(monkeypatch, *modules):
    """Make each module's snark_prover.prove return its partial witness
    instead of a proof (the witness a circuit's prove method fills)."""
    for mod in modules:
        monkeypatch.setattr(mod.snark_prover, "prove", lambda data, pw: pw)


@pytest.fixture(scope="module")
def wrappers(one_thread_module):
    """The sighash wrapper in both packages over a stand-in minified shape
    (8 public inputs: finalized hash, sighash felt252), whose fingerprint
    is the second leaf of a three-leaf whitelist; and the stand-in."""
    cfg, jcfg = configs()
    inner, jinner, xs = standin_pair(8)
    fp = tuple(fingerprint_verifier_data(inner.verifier))
    fps = [(1, 2, 3, 4), fp, (5, 6, 7, 8)]
    wl, jwl = sighash_tree.SigHashMerkleTree.build(fps), \
        jtree.SigHashMerkleTree.build(fps)
    wrapper = sw.SigHashWrapperCircuit.build(cfg, inner.common, wl,
                                             device="cpu")
    jwrapper = jsw.SigHashWrapperCircuit.build(jcfg, jinner.common, jwl)
    return wrapper, jwrapper, (inner, jinner, xs, fp)


def test_sighash_wrapper_equals_the_reference(wrappers, monkeypatch):
    wrapper, jwrapper, (inner, jinner, xs, fp) = wrappers
    assert chip_smoke.circuit_rows(wrapper.data) == 2033
    # the whitelist root is a constant: equal trees, equal columns
    assert_same_circuit(wrapper.data, jwrapper.data)
    pis = [random.Random(5).randrange(P) for _ in range(8)]
    inner_proof = prove_standin(inner, xs, pis)
    capture_prove(monkeypatch, sw, jsw)
    pw = wrapper.prove(inner_proof, inner.verifier, fp)
    jpw = jwrapper.prove(ref_proof(inner_proof), ref_view(inner,
                                                          jinner).verifier,
                         fp)
    wires = assert_same_witness(wrapper.data, pw, jwrapper.data, jpw)
    out = [pw.get(t) for t in wrapper.data.prover.pi_targets]
    assert out == pis
    assert check_witness(wrapper.data, wires,
                         prover.public_inputs_hash(out)) == []
    # a fingerprint outside the whitelist has no inclusion proof
    with pytest.raises(ValueError):
        wrapper.prove(inner_proof, inner.verifier, (9, 9, 9, 9))


@pytest.fixture(scope="module")
def final_gls(wrappers):
    """The final GL in both packages over a stand-in block transition (16
    public inputs: old root, new root, withdrawal and deposit events) and
    the wrapper above (preprocessed by the port on the CPU)."""
    wrapper, jwrapper, _ = wrappers
    cfg, jcfg = configs()
    tr, jtr, xs = standin_pair(16)
    fgl = sw.SigHashFinalGLCircuit.build(cfg, tr, wrapper.data, device="cpu")
    jfgl = jsw.SigHashFinalGLCircuit.build(
        jcfg, ref_view(tr, jtr), ref_view(wrapper.data, jwrapper.data))
    return fgl, jfgl, (tr, jtr, xs)


def test_final_gl_equals_the_reference(final_gls):
    fgl, jfgl, _ = final_gls
    assert chip_smoke.circuit_rows(fgl.data) == 4251
    assert fgl.data.common.log_n == 13
    assert_same_circuit(fgl.data, jfgl.data)


# --- slow: the proofs of 2^11 rows and more, whole shapes, the corpus -------

def finalized_hash(tr_pis, comps) -> list:
    """The host's finalized introspection hash of a transition's public
    inputs and the free components (SigHashCircuit.build's order)."""
    felt248 = [feltenc.hash256_to_felt248(QHashOut(tuple(tr_pis[k:k + 4]))
                                          .to_le_bytes()) for k in (0, 4)]
    return poseidon_host.hash_no_pad(
        list(tr_pis[12:16]) + list(tr_pis[8:12]) + felt248[0] + felt248[1] +
        [comps["cur_bal"], comps["next_bal"], comps["spend_idx"]])


@pytest.mark.slow
def test_wrapper_and_final_gl_proofs(wrappers, final_gls, monkeypatch):
    """A wrapper proof by the port on the CPU (2^11 rows) passes the
    reference's verifier; the final GL's witness over it and a stand-in
    transition proof equals the reference's, and its public inputs are
    felt248 of the old root and the sighash felts; a wrong spend index
    gives no witness."""
    wrapper, jwrapper, (inner, _, ixs, fp) = wrappers
    fgl, jfgl, (tr, _, txs) = final_gls
    rnd = random.Random(8)
    tr_pis = [rnd.randrange(P) for _ in range(16)]
    comps = {"cur_bal": 5_000_000, "next_bal": 5_960_000, "spend_idx": 0}
    sighash_f252 = feltenc.hash256_to_felt252(sha256d(b"preimage"))
    inner_proof = prove_standin(inner, ixs, finalized_hash(tr_pis, comps) +
                                sighash_f252)
    wproof = wrapper.prove(inner_proof, inner.verifier, fp)
    assert verifier.verify(wproof, wrapper.data.common, wrapper.data.verifier)
    assert ref_verify(wproof, wrapper.data, jwrapper.data)
    tr_proof = prove_standin(tr, txs, tr_pis)
    capture_prove(monkeypatch, sw, jsw)
    pw = fgl.prove(tr_proof, wproof, comps)
    jpw = jfgl.prove(ref_proof(tr_proof), ref_proof(wproof), comps)
    wires = assert_same_witness(fgl.data, pw, jfgl.data, jpw)
    pis = [pw.get(t) for t in fgl.data.prover.pi_targets]
    assert pis == feltenc.hash256_to_felt248(QHashOut(tuple(tr_pis[:4]))
                                             .to_le_bytes()) + sighash_f252
    assert check_witness(fgl.data, wires,
                         prover.public_inputs_hash(pis)) == []
    with pytest.raises(ValueError):
        circuit.generate_witness(fgl.data, fgl.prove(
            tr_proof, wproof, dict(comps, spend_idx=1)))


@pytest.mark.slow
def test_accelerator_proof_passes_the_references_verifier(accelerators):
    acc, jacc = accelerators
    proof = acc.prove([ACCEL_MSG])
    assert proof.public_inputs == sa.commitment_root_host(
        [(ACCEL_MSG, sha256(ACCEL_MSG))])
    assert verifier.verify(proof, acc.data.common, acc.data.verifier)
    assert ref_verify(proof, acc.data, jacc.data)


def shape_pair(gid_ids, standin_vd: bool):
    """The dev covenant's shape circuit `gid_ids` in both packages at the
    test configuration. The accelerator's verifier data, a constant of the
    shape circuit, is a random stand-in in both (`standin_vd`: rows and
    columns do not depend on its values), else the port's preprocessing
    of its accelerator, on the CPU."""
    from city_rollup_tpu.snark import circuit as jcircuit
    from city_rollup_tpu_torch.snark.circuit import VerifierData
    cfg, jcfg = configs()
    rnd = random.Random(9)
    cap = np.array([[rnd.randrange(P) for _ in range(4)]
                    for _ in range(1 << cfg.fri.cap_height)], dtype=np.uint64)
    digest = tuple(rnd.randrange(P) for _ in range(4))
    port_accel = []

    def patched(mod, vd_of):
        orig = mod.Sha256AcceleratorCircuit.build_multi.__func__

        def build_multi(cls, config, specs, **kw):
            acc = orig(cls, config, specs, **kw)
            acc.data._verifier = vd_of(acc)
            return acc
        return classmethod(build_multi)

    def port_vd(acc):
        port_accel.append(acc)
        return VerifierData(constants_sigmas_cap=cap, circuit_digest=digest) \
            if standin_vd else acc.data.verifier

    def jvd(acc):
        if standin_vd:
            return jcircuit.VerifierData(constants_sigmas_cap=cap,
                                         circuit_digest=digest)
        return ref_view(port_accel[0].data, acc.data).verifier

    saved = (sc.Sha256AcceleratorCircuit.build_multi,
             jsc.Sha256AcceleratorCircuit.build_multi)
    sc.Sha256AcceleratorCircuit.build_multi = patched(sc, port_vd)
    jsc.Sha256AcceleratorCircuit.build_multi = patched(jsc, jvd)
    try:
        circ = sc.SigHashCircuit.build(
            cfg, sc.SigHashShape(gid=btc.SigHashGadgetId(*gid_ids),
                                 cfg=btc.dev_spend_cfg()),
            btc.DEV_SCRIPT_BODY, device="cpu")
        jcirc = jsc.SigHashCircuit.build(
            jcfg, jsc.SigHashShape(gid=jbtc.SigHashGadgetId(*gid_ids),
                                   cfg=jbtc.dev_spend_cfg()),
            jbtc.DEV_SCRIPT_BODY)
    finally:
        (sc.Sha256AcceleratorCircuit.build_multi,
         jsc.Sha256AcceleratorCircuit.build_multi) = saved
    return circ, jcirc


# the dev covenant's shapes: the covenant input alone, and with a deposit
# (accelerator rows, shape circuit rows at the test configuration; at
# DEFAULT_PARAMS.config, 28 FRI queries, the shape circuits are 35,964
# and 36,309 rows)
DEV_SHAPES = {(0, 0, 0, 0, 0): (68512, 9963),
              (0, 0, 1, 0, 0): (102784, 10309)}


@pytest.mark.slow
@pytest.mark.parametrize("gid_ids", sorted(DEV_SHAPES))
def test_sighash_shape_circuit_equals_the_reference(gid_ids,
                                                    one_thread_module):
    circ, jcirc = shape_pair(gid_ids, standin_vd=True)
    assert (chip_smoke.circuit_rows(circ.accel.data),
            chip_smoke.circuit_rows(circ.data)) == DEV_SHAPES[gid_ids]
    assert_same_circuit(circ.accel.data, jcirc.accel.data)
    assert_same_circuit(circ.data, jcirc.data)


@pytest.mark.slow
def test_sighash_shape_witness_equals_the_reference(one_thread_module):
    """The covenant-input shape's witness from one hint: the port proves
    the 2^17 accelerator on the CPU (hours), and both packages' shape
    circuits take that proof."""
    from test_torch_sighash import make_hint
    circ, jcirc = shape_pair((0, 0, 0, 0, 0), standin_vd=False)
    hint, _, _ = make_hint(btc.SigHashGadgetId(0, 0, 0, 0, 0), seed=11)
    jhint = jbtc.BlockSpendIntrospectionHint.from_dict(hint.to_dict())
    proofs = []
    orig = circ.accel.prove

    def prove(messages):
        proofs.append(orig(messages))
        return proofs[-1]
    circ.accel.prove = prove
    pw = circ.fill_witness(hint)
    jcirc.accel.prove = lambda messages: ref_proof(proofs[0])
    jpw = jcirc.fill_witness(jhint)
    wires = assert_same_witness(circ.data, pw, jcirc.data, jpw)
    pis = [pw.get(t) for t in circ.data.prover.pi_targets]
    assert pis[4:8] == feltenc.hash256_to_felt252(
        sha256d(hint.sighash_preimage))
    assert check_witness(circ.data, wires,
                         prover.public_inputs_hash(pis)) == []


@pytest.mark.slow
def test_cli_sighash_corpus_entry_equals_the_fixture(tmp_path, capsys,
                                                     one_thread_module):
    """`sighash-corpus --fast --dev-covenant --start 0 --count 1` over a
    corpus file that holds the fixture's shared shape and no entry: the
    entry it computes for gid 0 is the fixture's."""
    import json
    from city_rollup_tpu_torch import cli
    from city_rollup_tpu_torch.rollup import sighash_corpus
    fixture = sighash_corpus.SigHashCorpus.load(
        "fixtures/sighash_corpus_dev.json")
    out = tmp_path / "corpus.json"
    sighash_corpus.SigHashCorpus(
        config_key=fixture.config_key, spend_cfg=fixture.spend_cfg,
        script_body=fixture.script_body, gate_keys=fixture.gate_keys,
        log_d=fixture.log_d, fps={}).save(str(out))
    assert cli.main(["sighash-corpus", "--fast", "--dev-covenant",
                     "--start", "0", "--count", "1", "--device", "cpu",
                     "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["entries"] == 1
    got = sighash_corpus.SigHashCorpus.load(str(out))
    assert got.fps == {0: fixture.fps[0]}


@pytest.mark.slow
def test_golden_sighash_shapes_are_the_references_host_build():
    """chip_smoke.GOLDEN_SIGHASH_SHAPES from the reference's host build at
    DEFAULT_PARAMS.config: the dev covenant's shape gid (0, 0, 0, 0, 0),
    its accelerator, the minified shape, the wrapper and the final GL,
    each inner circuit's verifier data a random stand-in (its values are
    constants only), the final GL's transition a stand-in common data with
    the gates and degree the port's toolbox gives it on the card."""
    import types
    from city_rollup_tpu.rollup.circuits import DEFAULT_CONFIG
    from city_rollup_tpu.snark import circuit as jcircuit
    from city_rollup_tpu.snark.gates import gate_from_key
    from city_rollup_tpu.snark.minifier import ProofMinifier as JMinifier
    from city_rollup_tpu.snark.recursion import (
        fingerprint_verifier_data as jfingerprint)
    cfg = DEFAULT_CONFIG
    rnd = random.Random(7)

    def vd():
        return jcircuit.VerifierData(
            constants_sigmas_cap=np.array(
                [[rnd.randrange(P) for _ in range(4)]
                 for _ in range(1 << cfg.fri.cap_height)], dtype=np.uint64),
            circuit_digest=tuple(rnd.randrange(P) for _ in range(4)))

    orig = jsc.Sha256AcceleratorCircuit.build_multi.__func__
    built = {}

    def build_multi(cls, config, specs):
        acc = orig(cls, config, specs)
        acc.data._verifier = vd()
        return acc
    jsc.Sha256AcceleratorCircuit.build_multi = classmethod(build_multi)
    try:
        circ = jsc.SigHashCircuit.build(
            cfg, jsc.SigHashShape(gid=jbtc.SigHashGadgetId(0, 0, 0, 0, 0),
                                  cfg=jbtc.dev_spend_cfg()),
            jbtc.DEV_SCRIPT_BODY)
    finally:
        jsc.Sha256AcceleratorCircuit.build_multi = classmethod(orig)
    built["accelerator"], built["shape"] = circ.accel.data, circ.data
    circ.data._verifier = vd()
    probe = JMinifier.build(circ.data, cfg)
    gates = sorted({g.key: g for g in probe.data.common.gates}.items())
    mini = JMinifier.build(circ.data, cfg,
                           declared_gates=[g for _, g in gates],
                           min_log_n=probe.data.common.log_n)
    built["minified"] = mini.data
    mini.data._verifier = vd()
    wl = jtree.SigHashMerkleTree.build(
        [tuple(jfingerprint(mini.data.verifier))])
    wrapper = jsw.SigHashWrapperCircuit.build(cfg, mini.data.common, wl)
    built["wrapper"] = wrapper.data
    wrapper.data._verifier = vd()
    # the block transition's gates at DEFAULT_PARAMS (its build on the card)
    tr_gates = [gate_from_key(k) for k in (
        "constant<2>", "poseidon", "arithmetic<8>", "reducing_ext<13>",
        "base_sum<16>", "reducing<26>", "public_input")]
    transition = types.SimpleNamespace(
        common=jcircuit.CommonData(
            config=cfg, log_n=16, gates=tr_gates,
            selector_groups=jcircuit.compute_selector_groups(tr_gates, cfg),
            num_public_inputs=16),
        verifier=vd())
    built["final GL"] = jsw.SigHashFinalGLCircuit.build(
        cfg, transition, wrapper.data).data
    assert chip_smoke.sighash_shape_differences(built) == []
