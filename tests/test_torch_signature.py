"""The port's user signatures (rollup/zk_signature.py, wallet.py,
l1_signature.py, and the op circuits with `sig_wrapper` set) against the
reference's: circuits built the same way in both packages have equal
rows, columns and witnesses, and proofs made by the port on the CPU pass
the reference's verifier.

Test configuration (the one of test_torch_rollup_circuits.py): one
challenge, FRI at rate 1/8 with one query round, a cap of height 1, 2 PoW
bits, a final polynomial of 2^3; trees of height 4. The inner signature
circuit is then 4 rows at 2^4 (zk, with blinding rows), its wrapper 2,018
rows at 2^11, the L1 dev signature circuit 1,810 rows at 2^11. A 2^11
proof takes tens of seconds of one CPU on the plain kernels, so the
tests that prove the wrapper or the L1 circuit are `slow`; the others
prove only the small circuits. Where the reference needs a circuit's
verifier data (a minifier's or an op circuit's constant), it is given the
port's (`ref_view`): the tests hold the columns it derives from equal,
and the reference's jnp preprocessing of a 2^11 circuit costs more than
a test may here."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.rollup import l1_signature as jl1
from city_rollup_tpu.rollup import op_circuits as joc
from city_rollup_tpu.rollup import zk_signature as jzs
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu.snark.minifier import ProofMinifier as JMinifier
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.crypto import secp256k1 as secp
from city_rollup_tpu_torch.rollup import l1_signature as l1
from city_rollup_tpu_torch.rollup import op_circuits as oc
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup import wallet as wallet_mod
from city_rollup_tpu_torch.rollup import zk_signature as zs
from city_rollup_tpu_torch.rollup.circuits import decode_witness
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import QueueHub
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import circuit, prover, verifier
from city_rollup_tpu_torch.snark.debug import check_witness
from test_torch_rollup_circuits import ALLOWED_ROOT, TEST_FRI, small_params
from test_torch_snark import ref_proof_from_plain

P = chip_smoke.P
SK = [11, 22, 33, 44]
OTHER_SK = [5, 6, 7, 8]
ACTION = [5, 6, 7, 8]


def configs():
    """(port, reference) CircuitConfig at the test configuration."""
    return (CircuitConfig.poseidon_config(num_challenges=1,
                                          fri=fri.FriConfig(**TEST_FRI)),
            JConfig.poseidon_config(num_challenges=1,
                                    fri=jfri.FriConfig(**TEST_FRI)))


def ref_vd(data):
    """The port's verifier data of `data` as the reference's."""
    vd = data.verifier
    return jcircuit.VerifierData(
        constants_sigmas_cap=np.asarray(vd.constants_sigmas_cap,
                                        dtype=np.uint64),
        circuit_digest=tuple(int(v) for v in vd.circuit_digest))


def ref_view(data, jdata):
    """What the reference reads of a built circuit (its common and its
    verifier data): the reference's common data, the port's verifier
    data."""
    return types.SimpleNamespace(common=jdata.common, verifier=ref_vd(data))


def ref_proof(proof):
    """A proof made by the port as the reference's Proof."""
    return ref_proof_from_plain(convert.proof_to_plain(proof))


def ref_verify(proof, data, jdata) -> bool:
    """The reference's verifier on a proof made by the port."""
    return jverifier.verify(ref_proof(proof), jdata.common, ref_vd(data))


def assert_same_circuit(data, jdata, columns: bool = True):
    assert chip_smoke.circuit_rows(data) == chip_smoke.circuit_rows(jdata)
    assert data.common.log_n == jdata.common.log_n
    assert [g.key for g in data.common.gates] == \
        [g.key for g in jdata.common.gates]
    assert data.common.num_public_inputs == jdata.common.num_public_inputs
    if columns:
        assert np.array_equal(data.prover.const_sigma_values,
                              jdata.prover.const_sigma_values)


def assert_same_witness(data, pw, jdata, jpw) -> np.ndarray:
    wires = circuit.generate_witness(data, pw)
    jwires = jcircuit.generate_witness(jdata, jpw)
    assert np.array_equal(wires, np.asarray(jwires, dtype=np.uint64))
    return wires


def set_key_and_action(pw, circ, sk, action):
    for t, v in zip(circ.sk_targets, sk):
        pw.set(t, int(v))
    for t, v in zip(circ.action_targets, action):
        pw.set(t, int(v))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("sk", [SK, OTHER_SK, [0, 0, 0, 0],
                                [P - 1, 1 << 63, 3, P - 2]])
def test_derive_public_key_equals_the_reference(sk):
    assert zs.derive_public_key(sk) == jzs.derive_public_key(sk)


def test_inner_circuit_equals_the_reference():
    cfg, jcfg = configs()
    inner = zs.ZKSignatureInnerCircuit.build(cfg, device="cpu")
    jinner = jzs.ZKSignatureInnerCircuit.build(jcfg)
    assert inner.data.common.config.zk and chip_smoke.circuit_rows(
        inner.data) == 4 and inner.data.common.log_n == 4
    assert_same_circuit(inner.data, jinner.data)
    pw, jpw = inner.data._builder.partial_witness(), \
        jinner.data._builder.partial_witness()
    set_key_and_action(pw, inner, SK, ACTION)
    set_key_and_action(jpw, jinner, SK, ACTION)
    assert_same_witness(inner.data, pw, jinner.data, jpw)
    pis = [pw.get(t) for t in inner.data.prover.pi_targets]
    assert pis == zs.derive_public_key(SK) + ACTION


def test_inner_signature_proof_passes_the_references_verifier(one_thread):
    """A signature by the inner circuit (2^4 rows), proved by the port on
    the CPU: the reference's verifier accepts it, the port's refuses a
    changed action, and a second proof of the same statement opens the
    wires at other values (the zk blinding rows)."""
    cfg, jcfg = configs()
    inner = zs.ZKSignatureInnerCircuit.build(cfg, device="cpu")
    jinner = jzs.ZKSignatureInnerCircuit.build(jcfg)
    proof = inner.sign(SK, ACTION)
    assert proof.public_inputs == zs.derive_public_key(SK) + ACTION
    assert verifier.verify(proof, inner.data.common, inner.data.verifier)
    assert ref_verify(proof, inner.data, jinner.data)
    again = inner.sign(SK, ACTION)
    assert verifier.verify(again, inner.data.common, inner.data.verifier)
    assert again.public_inputs == proof.public_inputs
    assert again.openings.wires != proof.openings.wires
    assert not np.array_equal(again.wires_cap, proof.wires_cap)
    proof.public_inputs[4] = (proof.public_inputs[4] + 1) % P
    assert not verifier.verify(proof, inner.data.common, inner.data.verifier)


def test_wallet_key_management():
    cfg, _ = configs()
    wrapper = zs.ZKSignatureWrapperCircuit.build(cfg, device="cpu")
    wallet = wallet_mod.CityMemoryWallet.new_fast_setup(wrapper=wrapper)
    assert wallet.zk.wrapper is wrapper
    pk = wallet.zk.add_zk_private_key(SK)
    assert pk == tuple(jzs.derive_public_key(SK))
    assert wallet.zk.has_public_key(pk)
    assert wallet.zk.add_zk_private_key([v + P for v in SK]) == pk
    pk2 = wallet.zk.create_zk_private_key()
    assert pk2 != pk and len(wallet.zk.get_public_keys()) == 2
    assert not wallet.zk.has_public_key((1, 2, 3, 4))
    # the L1 keyring: ECDSA over a message hash, checked on the host
    key = wallet.secp.add_key(0xC0FFEE)
    key2 = wallet.secp.create_key()
    assert wallet.secp.public_keys() == [key, key2]
    sig = wallet.secp.sign(key, 12345)
    assert secp.ecdsa_verify(key, 12345, sig)
    assert not secp.ecdsa_verify(key, 12346, sig)
    assert not secp.ecdsa_verify(key2, 12345, sig)


def test_fixed_public_key_circuit_proved_and_verified(one_thread):
    cfg, jcfg = configs()
    pk = zs.derive_public_key(SK)
    circ = zs.FixedPublicKeyZKSignatureCircuit.build(cfg, pk, device="cpu")
    jcirc = jzs.FixedPublicKeyZKSignatureCircuit.build(jcfg, pk)
    assert_same_circuit(circ.data, jcirc.data)
    proof = circ.sign(SK, ACTION)
    assert proof.public_inputs == pk + ACTION
    assert verifier.verify(proof, circ.data.common, circ.data.verifier)
    assert ref_verify(proof, circ.data, jcirc.data)
    # another key's preimage gives no witness
    pw = circ.data._builder.partial_witness()
    set_key_and_action(pw, circ, OTHER_SK, ACTION)
    with pytest.raises(ValueError):
        circuit.generate_witness(circ.data, pw)


def test_l1_dev_signature_circuit_equals_the_reference():
    cfg, jcfg = configs()
    circ = l1.L1DevSignatureCircuit.build(cfg, device="cpu")
    jcirc = jl1.L1DevSignatureCircuit.build(jcfg)
    assert chip_smoke.circuit_rows(circ.data) == 1810
    assert_same_circuit(circ.data, jcirc.data)
    key = secp.Secp256K1Wallet().add_private_key(0xC0FFEE)
    msg = secp.action_digest_to_msg([1, 2, 3, 4])
    pws = []
    for c in (circ, jcirc):
        pw = c.data._builder.partial_witness()
        c.targets["g"].set_point(pw, c.targets["pk"], key.point)
        c.targets["g"].big.set_biguint(pw, c.targets["msg"], msg)
        pws.append(pw)
    assert_same_witness(circ.data, pws[0], jcirc.data, pws[1])
    pis = [pws[0].get(t) for t in circ.data.prover.pi_targets]
    assert pis == secp.combined_action_hash(key, msg)


@pytest.fixture(scope="module")
def zk_wrappers():
    """(port wrapper, its reference view, the reference's minifier) at the
    test configuration; the port's wrapper preprocessed on the CPU (its
    verifier data is a constant of the signed op circuits)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg, jcfg = configs()
    wrapper = zs.ZKSignatureWrapperCircuit.build(cfg, device="cpu")
    jinner = jzs.ZKSignatureInnerCircuit.build(jcfg)
    jmini = JMinifier.build(ref_view(wrapper.inner.data, jinner.data), jcfg)
    wrapper.data.verifier
    yield wrapper, ref_view(wrapper.data, jmini.data), jmini
    torch.set_num_threads(threads)


def test_zk_wrapper_equals_the_reference(zk_wrappers):
    wrapper, _, jmini = zk_wrappers
    assert chip_smoke.circuit_rows(wrapper.data) == 2018
    assert_same_circuit(wrapper.data, jmini.data)
    assert wrapper.fingerprint == wrapper.minifier.fingerprint


def signed_params(zk_wrappers):
    """(port, reference) RollupParams of the test configuration with the
    ZK wrapper threaded in, as CircuitToolbox(with_signatures=True) does."""
    wrapper, jview, _ = zk_wrappers
    cfg, jcfg = configs()
    p = dataclasses.replace(small_params(oc, CircuitConfig, fri.FriConfig),
                            sig_wrapper=wrapper.data)
    jp = dataclasses.replace(small_params(joc, JConfig, jfri.FriConfig),
                             sig_wrapper=jview)
    return p, jp


@pytest.mark.parametrize("op", ["make_l2_transfer", "make_add_l1_withdrawal"])
def test_signed_op_circuit_equals_the_reference(zk_wrappers, op):
    p, jp = signed_params(zk_wrappers)
    b, jb = CircuitBuilder(p.config), JBuilder(jp.config)
    getattr(oc, op)(b, p)
    getattr(joc, op)(jb, jp)
    data, jdata = b.build(device="cpu"), jb.build()
    assert_same_circuit(data, jdata)
    unsigned = CircuitBuilder(p.config)
    getattr(oc, op)(unsigned, dataclasses.replace(p, sig_wrapper=None))
    assert chip_smoke.circuit_rows(data) > \
        chip_smoke.circuit_rows(unsigned.build(device="cpu")) + 1000


def test_toolbox_with_signatures_threads_the_wrapper():
    from city_rollup_tpu_torch.rollup.circuits import CircuitToolbox
    cfg, _ = configs()
    p = small_params(oc, CircuitConfig, fri.FriConfig)
    tb = CircuitToolbox(p, with_signatures=True, device="cpu")
    assert tb.zk_wrapper is not None and tb.device == "cpu"
    assert tb.params.sig_wrapper is tb.zk_wrapper.data
    assert tb.zk_wrapper.data.prover.device.type == "cpu"
    assert CircuitToolbox(tb.params, with_signatures=True,
                          device="cpu").zk_wrapper is None


# --- slow: the 2^11 proofs ---------------------------------------------------

def signed_plan(p, sig_pk, sign):
    """A one-transfer, one-withdrawal block at the test configuration on a
    scratch CityStore whose user 0 holds `sig_pk` (as the reference's
    tests/test_full_block.py plans one); `sign(action)` gives the encoded
    signature proof hex. Returns {op name: stored witness}."""
    from city_rollup_tpu_torch.rollup.circuits import OP_NAME_BY_TYPE
    city = CityStore(user_tree_height=p.user_tree_height,
                     deposit_tree_height=p.deposit_tree_height,
                     withdrawal_tree_height=p.withdrawal_tree_height)
    city.register_user(0, 0, tuple(sig_pk))
    city.register_user(0, 1, (2, 2, 2, 2))
    city.increment_user_balance(0, 0, 1_000 + 60 + p.withdrawal_fee)
    addr = (7, 8, 9)
    reqs = om.BlockRequests(
        token_transfers=[om.TokenTransfer(0, 1, 250, signature_proof=sign(
            om.transfer_action_hash(p, 0, 1, 1, 250)))],
        add_withdrawals=[om.AddWithdrawal(0, 0, addr, 60,
                                          signature_proof=sign(
            om.withdrawal_action_hash(p, 0, 2, addr, 60)))])
    store = MemoryProofStore()
    planned = om.Orchestrator(city, store, QueueHub(),
                              params=p).plan_block(1, reqs)
    out = {}
    for job in planned.leaf_jobs:
        name = OP_NAME_BY_TYPE.get(job.circuit_type)
        if name is not None:
            out[name] = store.get_bytes(job.input_witness_id())
    return out


@pytest.fixture(scope="module")
def signatures(zk_wrappers):
    """The wallet's two signatures (transfer, withdrawal) by the port's
    wrapper on the CPU, keyed by action hash."""
    from city_rollup_tpu_torch.rollup.circuits import encode_proof
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    wrapper = zk_wrappers[0]
    p, _ = signed_params(zk_wrappers)
    wallet = wallet_mod.CityMemoryWallet.new_fast_setup(wrapper=wrapper)
    pk = wallet.zk.add_zk_private_key(SK)
    proofs = {}

    def sign(action):
        proofs[tuple(action)] = wallet.zk.sign(pk, action)
        return encode_proof(proofs[tuple(action)]).hex()
    plan = signed_plan(p, pk, sign)
    yield pk, proofs, plan
    torch.set_num_threads(threads)


@pytest.mark.slow
def test_wrapper_signature_passes_the_references_verifier(zk_wrappers,
                                                          signatures):
    wrapper, jview, jmini = zk_wrappers
    pk, proofs, _ = signatures
    for action, proof in proofs.items():
        assert proof.public_inputs == list(pk) + list(action)
        assert wrapper.verify(proof)
        assert ref_verify(proof, wrapper.data, jmini.data)
    proof = next(iter(proofs.values()))
    bad = list(proof.public_inputs)
    bad[4] = (bad[4] + 1) % P
    assert not wrapper.verify(dataclasses.replace(proof, public_inputs=bad))


@pytest.mark.slow
@pytest.mark.parametrize("name,op", [("transfer", "make_l2_transfer"),
                                     ("add_withdrawal",
                                      "make_add_l1_withdrawal")])
def test_signed_op_witness_equals_the_reference(zk_wrappers, signatures,
                                                name, op):
    """The signed op's witness from the plan, in both packages; then the
    same op with the sender registered under another key gives none."""
    from city_rollup_tpu.snark import prover as jprover
    from city_rollup_tpu_torch.rollup.circuits import decode_proof
    p, jp = signed_params(zk_wrappers)
    pk, _, plan = signatures
    b, jb = CircuitBuilder(p.config), JBuilder(jp.config)
    _, setter = getattr(oc, op)(b, p)
    _, jsetter = getattr(joc, op)(jb, jp)
    data, jdata = b.build(device="cpu"), jb.build()
    w = decode_witness(plan[name])
    sig = decode_proof(bytes.fromhex(w["signature_proof"]))
    pw, jpw = b.partial_witness(), jb.partial_witness()
    setter(pw, dict(w, signature_proof=sig, allowed_root=ALLOWED_ROOT))
    jsetter(jpw, dict(w, signature_proof=ref_proof(sig),
                      allowed_root=ALLOWED_ROOT))
    wires = assert_same_witness(data, pw, jdata, jpw)
    pis = [pw.get(t) for t in data.prover.pi_targets]
    assert check_witness(data, wires, prover.public_inputs_hash(pis)) == []
    assert jprover.public_inputs_hash(pis) == prover.public_inputs_hash(pis)
    # the same signature, the sender's leaf under another key
    other = signed_plan(p, zs.derive_public_key(OTHER_SK),
                        lambda action: w["signature_proof"])
    pw = b.partial_witness()
    with pytest.raises(ValueError, match="conflict"):
        setter(pw, dict(decode_witness(other[name]), signature_proof=sig,
                        allowed_root=ALLOWED_ROOT))
        circuit.generate_witness(data, pw)


@pytest.mark.slow
def test_l1_dev_signature_proved_and_verified(one_thread):
    cfg, jcfg = configs()
    circ = l1.L1DevSignatureCircuit.build(cfg, device="cpu")
    jcirc = jl1.L1DevSignatureCircuit.build(jcfg)
    key = secp.Secp256K1Wallet().add_private_key(0xC0FFEE)
    msg = secp.action_digest_to_msg([1, 2, 3, 4])
    proof = circ.prove(key, msg)
    assert proof.public_inputs == secp.combined_action_hash(key, msg)
    assert verifier.verify(proof, circ.data.common, circ.data.verifier)
    assert ref_verify(proof, circ.data, jcirc.data)


@pytest.mark.slow
def test_secp256k1_signature_circuit_equals_the_reference():
    """The full ECDSA circuit (2^22 rows): rows, columns and the witness of
    one signature, host builds in both packages (hours of CPU)."""
    cfg, jcfg = configs()
    circ = l1.Secp256K1SignatureCircuit.build(cfg, device="cpu")
    jcirc = jl1.Secp256K1SignatureCircuit.build(jcfg)
    assert_same_circuit(circ.data, jcirc.data)
    wallet = secp.Secp256K1Wallet()
    key = wallet.add_private_key(0xC0FFEE)
    msg = secp.action_digest_to_msg([1, 2, 3, 4])
    sig = wallet.sign(key, msg)
    pw, jpw = circ.data._builder.partial_witness(), \
        jcirc.data._builder.partial_witness()
    circ.fill_witness(pw, key, msg, sig)
    jcirc.fill_witness(jpw, key, msg, sig)
    assert_same_witness(circ.data, pw, jcirc.data, jpw)
