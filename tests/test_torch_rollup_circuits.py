"""The port's rollup circuits (rollup/op_gadgets.py, op_circuits.py,
circuits.py) against the reference's: shape family A (register, claim,
transfer, add_withdrawal, its dummy and its self-recursive aggregator),
the witnesses of the demo block's ops, and one op circuit proved by the
port and verified by the reference.

Test configuration (small_params, the same for both packages): trees of
height 4, one challenge, FRI at rate 1/8 with one query round, a cap of
height 1, 2 PoW bits and a final polynomial of 2^3. Family A's aggregator
is then 5,196 rows at 2^13. The port finds the family's degree itself
(build_shape_family's fixed point); the reference is given it
(min_log_n=13), since its walk up from the leaves' degree costs a
minute of CPU here. Family B has its own file
(test_torch_rollup_circuits_b.py). Host builds only, but the proof: the
port proves on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.rollup import circuits as jcircuits
from city_rollup_tpu.rollup import op_circuits as joc
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu_torch import cli, convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.rollup import circuits, op_circuits as oc
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.circuits import decode_witness
from city_rollup_tpu_torch.rollup.job_id import JobID
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import QueueHub
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import circuit, prover, verifier
from test_torch_snark import ref_proof_from_plain

TEST_FRI = dict(rate_bits=3, cap_height=1, proof_of_work_bits=2,
                num_query_rounds=1, final_poly_bits=3)
TEST_HEIGHT = 4
FAMILY_LOG_N = 13
# any felts stand for the family's allowed root, a witness of every member
ALLOWED_ROOT = (11, 12, 13, 14)


def small_params(oc_mod, config_cls, fri_cls):
    """The test configuration's RollupParams in either package."""
    return oc_mod.RollupParams(
        config=config_cls.poseidon_config(num_challenges=1,
                                          fri=fri_cls(**TEST_FRI)),
        user_tree_height=TEST_HEIGHT, deposit_tree_height=TEST_HEIGHT,
        withdrawal_tree_height=TEST_HEIGHT)


def families(shape: str):
    """(port family, reference family) of shape 'A' or 'B'."""
    ops, jops, events = {
        "A": (circuits.SHAPE_A_OPS, jcircuits.SHAPE_A_OPS, False),
        "B": (circuits.SHAPE_B_OPS, jcircuits.SHAPE_B_OPS, True)}[shape]
    port = oc.build_shape_family(
        small_params(oc, CircuitConfig, fri.FriConfig), ops,
        with_events=events, device="cpu")
    ref = joc.build_shape_family(
        small_params(joc, JConfig, jfri.FriConfig), jops, with_events=events,
        min_log_n=FAMILY_LOG_N)
    return port, ref


def members(fam) -> dict:
    out = dict(fam.leaves)
    out.update(dummy=fam.dummy, agg=fam.agg)
    return out


def shape_key(mod, common) -> tuple:
    """mod.common_shape_key with the config as a dict of its fields (the
    two packages' config classes differ)."""
    key = mod.common_shape_key(common)
    return (dataclasses.asdict(key[0]),) + key[1:]


def assert_members_equal(port, ref, name):
    d, j = members(port)[name].data, members(ref)[name].data
    assert chip_smoke.circuit_rows(d) == chip_smoke.circuit_rows(j)
    assert [g.key for g in d.common.gates] == [g.key for g in j.common.gates]
    assert shape_key(circuit, d.common) == shape_key(jcircuit, j.common)
    assert shape_key(circuit, d.common) == shape_key(circuit, port.common)
    assert np.array_equal(d.prover.const_sigma_values,
                          j.prover.const_sigma_values)


@pytest.fixture(scope="module")
def family_a():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield families("A")
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["register", "claim", "transfer",
                                  "add_withdrawal", "dummy", "agg"])
def test_family_a_member_equals_the_reference(family_a, name):
    port, ref = family_a
    assert port.common.log_n == FAMILY_LOG_N
    assert_members_equal(port, ref, name)


def test_family_a_aggregator_size(family_a):
    port, _ = family_a
    assert chip_smoke.circuit_rows(port.agg.data) == 5196


def _demo_plan(mod, city_cls, store_cls, hub_cls, params, requests):
    city = city_cls(user_tree_height=TEST_HEIGHT,
                    deposit_tree_height=TEST_HEIGHT,
                    withdrawal_tree_height=TEST_HEIGHT)
    cli.demo_genesis(city, params)
    store = store_cls()
    planned = mod.Orchestrator(city, store, hub_cls(),
                               params=params).plan_block(1, requests)
    return planned, store


@pytest.fixture(scope="module")
def demo_op_witnesses(family_a):
    """[(op name, the port's wires, the reference's wires)] for the demo
    block's five op jobs, each from the witness its plan stored."""
    from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
    from city_rollup_tpu.rollup.proof_store import MemoryProofStore as JStore
    from city_rollup_tpu.rollup.queues import QueueHub as JHub
    from test_torch_rollup_plan import _as_ref
    port, ref = family_a
    pp = small_params(oc, CircuitConfig, fri.FriConfig)
    jp = small_params(joc, JConfig, jfri.FriConfig)
    planned, store = _demo_plan(om, CityStore, MemoryProofStore, QueueHub,
                                pp, cli.demo_requests())
    _, jstore = _demo_plan(jom, JCityStore, JStore, JHub, jp,
                           _as_ref(cli.demo_requests()))
    out = []
    for job in planned.leaf_jobs:
        name = circuits.OP_NAME_BY_TYPE.get(job.circuit_type)
        if name is None:
            continue                                  # a dummy
        raw = store.get_bytes(job.input_witness_id())
        jraw = jstore.get_bytes(JobID.from_bytes(job.to_bytes())
                                .input_witness_id())
        assert raw == jraw
        wires = []
        for fam, dec in ((port, decode_witness),
                         (ref, jcircuits.decode_witness)):
            built = fam.leaves[name]
            pw = built.data._builder.partial_witness()
            built.setter(pw, dict(dec(raw), allowed_root=ALLOWED_ROOT))
            gen = circuit.generate_witness if fam is port else \
                jcircuit.generate_witness
            wires.append(gen(built.data, pw))
        out.append((name, wires[0], wires[1]))
    return out


@pytest.mark.parametrize("k", range(5))
def test_demo_op_witness_equals_the_reference(demo_op_witnesses, k):
    names = [n for n, _, _ in demo_op_witnesses]
    assert names == ["register", "transfer", "transfer", "transfer",
                     "add_withdrawal"]
    _, wires, jwires = demo_op_witnesses[k]
    assert np.array_equal(wires, np.asarray(jwires, dtype=np.uint64))


def test_standalone_op_proof_passes_the_references_verifier():
    """The register circuit alone (unpadded, a few dozen rows), proved by
    the port on the CPU; the reference's verifier accepts the proof
    against the reference's own build of the circuit, and the port's
    rejects a changed public input."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pp = small_params(oc, CircuitConfig, fri.FriConfig)
        b = CircuitBuilder(pp.config)
        _, setter = oc.make_register_user(b, pp)
        data = b.build(device="cpu")
        jb = JBuilder(small_params(joc, JConfig, jfri.FriConfig).config)
        joc.make_register_user(jb, small_params(joc, JConfig,
                                               jfri.FriConfig))
        jdata = jb.build()
        assert chip_smoke.circuit_rows(data) < 64
        assert np.array_equal(data.prover.const_sigma_values,
                              jdata.prover.const_sigma_values)
        planned, store = _demo_plan(om, CityStore, MemoryProofStore,
                                    QueueHub, pp, cli.demo_requests())
        raw = store.get_bytes(planned.leaf_jobs[0].input_witness_id())
        pw = b.partial_witness()
        setter(pw, dict(decode_witness(raw), allowed_root=ALLOWED_ROOT))
        proof = prover.prove(data, pw)
        assert verifier.verify(proof, data.common, data.verifier)
        # the proof store pickles proofs: no tensor may ride along
        assert not chip_smoke.holds_tensor(proof)
        again = circuits.decode_proof(circuits.encode_proof(proof))
        assert convert.proof_to_plain(again) == convert.proof_to_plain(proof)
        vd = jcircuit.VerifierData(
            constants_sigmas_cap=np.asarray(
                data.verifier.constants_sigmas_cap, dtype=np.uint64),
            circuit_digest=[int(v) for v in data.verifier.circuit_digest])
        jproof = ref_proof_from_plain(convert.proof_to_plain(proof))
        assert jverifier.verify(jproof, jdata.common, vd)
        assert proof.public_inputs[:4] == list(ALLOWED_ROOT)
        proof.public_inputs[4] = (proof.public_inputs[4] + 1) % chip_smoke.P
        assert not verifier.verify(proof, data.common, data.verifier)
    finally:
        torch.set_num_threads(threads)


def test_toolbox_takes_a_device_and_refuses_signatures():
    """The toolbox builds lazily on its device; since the signature slice
    it no longer refuses `with_signatures` (it builds the ZK wrapper on
    that device). Since the Groth16 slice the sighash toolbox takes
    `with_groth16` too, and what it refuses is to wrap a final-GL proof
    when it was built without the wrap (as the reference's does)."""
    from city_rollup_tpu_torch.rollup.sighash_toolbox import SigHashToolbox
    tb = circuits.CircuitToolbox(small_params(oc, CircuitConfig,
                                             fri.FriConfig), device="cpu")
    assert tb.device == "cpu" and tb._family_a is None
    assert tb.zk_wrapper is None and tb.params.sig_wrapper is None
    signed = circuits.CircuitToolbox(circuits.FAST_TEST_PARAMS,
                                     with_signatures=True, device="cpu")
    assert signed.params.sig_wrapper is signed.zk_wrapper.data
    assert signed._family_a is None
    without = SigHashToolbox.__new__(SigHashToolbox)
    without.groth16 = None
    with pytest.raises(AssertionError, match="without groth16"):
        without.wrap_groth16(None)
