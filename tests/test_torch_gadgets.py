"""The port's gadget library (snark/u32.py, sha256.py, ripemd160.py,
biguint.py, secp_gadgets.py) and crypto copies (crypto/hashes.py,
secp256k1.py) against the reference's, at the sizes of
tests/test_u32.py, test_sha256.py, test_ripemd160.py and
test_secp_circuit.py: the same builder function run against either
package gives the same rows, sigmas and witness; the port's check_witness
finds the witness clean; the outputs equal the host answers of the port's
crypto copies and hashlib. Host only (no proving), except the u32
soundness case, which the port proves on the CPU."""

import hashlib
import random
import types

import numpy as np
import pytest
import torch

import city_rollup_tpu.crypto.hashes as jhashes
import city_rollup_tpu.crypto.secp256k1 as jcurve
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import biguint as jbiguint
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import ripemd160 as jripemd160
from city_rollup_tpu.snark import secp_gadgets as jsecp
from city_rollup_tpu.snark import sha256 as jsha256
from city_rollup_tpu.snark import u32 as ju32
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu.snark.debug import check_witness as jcheck_witness
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.crypto import hashes
from city_rollup_tpu_torch.crypto import secp256k1 as curve
from city_rollup_tpu_torch.snark import (CircuitBuilder, CircuitConfig,
                                         biguint, circuit, prover,
                                         ripemd160, secp_gadgets, sha256,
                                         u32, verifier)
from city_rollup_tpu_torch.snark.debug import check_witness
from test_torch_snark import ref_proof_from_plain

B32 = 1 << 32

REF = types.SimpleNamespace(
    Builder=JBuilder, Config=JConfig, Fri=jfri.FriConfig, u32=ju32,
    sha256=jsha256, ripemd160=jripemd160, biguint=jbiguint, secp=jsecp,
    curve=jcurve, circuit=jcircuit)
PORT = types.SimpleNamespace(
    Builder=CircuitBuilder, Config=CircuitConfig, Fri=fri.FriConfig,
    u32=u32, sha256=sha256, ripemd160=ripemd160, biguint=biguint,
    secp=secp_gadgets, curve=curve, circuit=circuit)


def u32_config(pkg):
    """tests/test_u32.py's TEST_CONFIG."""
    return pkg.Config(num_routed_wires=32, num_wires=64, num_challenges=2,
                      fri=pkg.Fri(rate_bits=3, cap_height=2,
                                  proof_of_work_bits=4, num_query_rounds=8,
                                  final_poly_bits=3))


# Each circuit: a builder function over a package namespace, returning the
# builder, a function that fills a partial witness (after build) and a
# function that reads the outputs from the filled witness; beside it the
# expected outputs from the host.

def u32_ops(pkg):
    b = pkg.Builder(u32_config(pkg))
    u = pkg.u32.U32Builder(b)
    a, c, d = (u.add_virtual_u32() for _ in range(3))
    lo, hi = u.mul_add_u32(a, c, d)
    s, carry = u.add_many_u32([a, c, d, lo])
    diff, borrow = u.sub_u32(a, d)
    outs = [lo, hi, s, carry, diff, borrow, u.xor_u32(a, c),
            u.and_u32(a, c), u.rotr_u32(a, 7), u.shr_u32(a, 3)]
    lte = u.is_lte_u32(d, a)
    u.assert_lte_u32(c, a)
    b.register_public_inputs([o.target for o in outs[:3]])

    def fill(pw):
        for t, v in zip((a, c, d), U32_ABD):
            u.set_u32(pw, t, v)

    def read(pw):
        return [pw.get(o.target) for o in outs] + [pw.get(lte)]
    return b, fill, read


U32_ABD = (0xFFFFFFFF, 0xDEADBEEF, 0xFFFFFFFE)


def u32_expected():
    a, c, d = U32_ABD
    total = a * c + d
    lo, hi = total % B32, total // B32
    s = a + c + d + lo
    rot = ((a >> 7) | (a << 25)) % B32
    return [lo, hi, s % B32, s // B32, (a - d) % B32, int(a < d), a ^ c,
            a & c, rot, a >> 3, int(d <= a)]


def _bytes_circuit(msg: bytes, make):
    def build(pkg):
        b = pkg.Builder(pkg.Config.poseidon_config())
        byte_ts = b.add_virtual_targets(len(msg))
        out = make(pkg, b, byte_ts)
        return (b, lambda pw: pkg.sha256.set_bytes_witness(pw, byte_ts, msg),
                lambda pw: pkg.sha256.get_bytes_witness(pw, out))
    return build


SHA_MSG = bytes((7 * i + 1) % 256 for i in range(53))
RIPEMD_MSG = b"city-rollup-hash160-test-vec!!!!"


def biguint_ops(pkg):
    b = pkg.Builder(pkg.Config.poseidon_config())
    big = pkg.biguint.BigUintBuilder(b)
    x = big.add_virtual_biguint(16)
    y = big.add_virtual_biguint(16)
    outs = [big.mul_mod(x, y, pkg.curve.N), big.inv_mod(x, pkg.curve.N),
            big.add_mod(x, y, pkg.curve.P), big.sub_mod(x, y, pkg.curve.P)]

    def fill(pw):
        big.set_biguint(pw, x, BIG_XY[0])
        big.set_biguint(pw, y, BIG_XY[1])
    return b, fill, lambda pw: [big.get_biguint(pw, o) for o in outs]


_rnd = random.Random(7)
BIG_XY = ((_rnd.getrandbits(255) | 1) % curve.P, _rnd.getrandbits(255))


def biguint_expected():
    x, y = BIG_XY
    return [x * y % curve.N, pow(x, -1, curve.N), (x + y) % curve.P,
            (x - y) % curve.P]


def point_add(pkg):
    b = pkg.Builder(pkg.Config.poseidon_config())
    g = pkg.secp.SecpGadget(b)
    p1, p2 = g.add_virtual_point(), g.add_virtual_point()
    out = g.point_add(p1, p2)
    gen = pkg.curve.GENERATOR

    def fill(pw, a1=gen, a2=pkg.curve.add(gen, gen), hints=None):
        """The two points; `hints` = (is_double, lam, inv_dx) forges the
        add's case hints (is_neg 0) in place of the ones it computes."""
        g.set_point(pw, p1, a1)
        g.set_point(pw, p2, a2)
        if hints is not None:
            is_double, lam, inv_dx = hints
            h = out.hints
            pw.set(h["is_double"], is_double)
            pw.set(h["is_neg"], 0)
            big = pkg.biguint.BigUintBuilder(b)
            big.set_biguint(pw, h["lam"], lam)
            big.set_biguint(pw, h["inv_dx"], inv_dx)

    def read(pw):
        pt = g.get_point(pw, out)
        return [pt.x, pt.y, pt.infinity]
    return b, fill, read


def _point(p):
    return [p.x, p.y]


CIRCUITS = {
    "u32": (u32_ops, u32_expected),
    "sha256": (_bytes_circuit(
        SHA_MSG, lambda pkg, b, ts: pkg.sha256.Sha256Gadget(b)
        .sha256_bytes(ts)), lambda: hashlib.sha256(SHA_MSG).digest()),
    "ripemd160": (_bytes_circuit(
        RIPEMD_MSG, lambda pkg, b, ts: pkg.ripemd160.Ripemd160Gadget(b)
        .ripemd160_bytes(ts)), lambda: bytes(hashes.ripemd160(RIPEMD_MSG))),
    "biguint": (biguint_ops, biguint_expected),
    "point_add": (point_add, lambda: _point(curve.add(
        curve.GENERATOR, curve.add(curve.GENERATOR, curve.GENERATOR)))
        + [False]),
}


@pytest.fixture(scope="module")
def built():
    """get(pkg, name) -> (builder, fill, read, data): each circuit built
    once a package, for the tests that share it."""
    cache = {}

    def get(pkg, name):
        key = (pkg is PORT, name)
        if key not in cache:
            b, fill, read = CIRCUITS[name][0](pkg)
            data = b.build(device="cpu") if pkg is PORT else b.build()
            cache[key] = (b, fill, read, data)
        return cache[key]
    return get


def _run(built, pkg, name):
    b, fill, read, data = built(pkg, name)
    pw = b.partial_witness()
    fill(pw)
    wires = pkg.circuit.generate_witness(data, pw)
    pis = [pw.get(t) or 0 for t in data.prover.pi_targets]
    return data, wires, prover.public_inputs_hash(pis), read(pw)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_gadget_circuit_and_witness_equal_the_references(built, name):
    jd, jw, jpi, jout = _run(built, REF, name)
    td, tw, tpi, tout = _run(built, PORT, name)
    assert [None if r is None else (r.gate.key, r.constants)
            for r in td.prover.rows] == \
        [None if r is None else (r.gate.key, r.constants)
         for r in jd.prover.rows]
    assert td.common.selector_groups == jd.common.selector_groups
    np.testing.assert_array_equal(td.prover.sigmas, jd.prover.sigmas)
    assert tw.dtype == np.uint64
    np.testing.assert_array_equal(tw, jw)
    assert tpi == jpi
    assert check_witness(td, tw, tpi) == []
    want = CIRCUITS[name][1]()
    assert tout == jout == want


def test_crypto_copies_equal_the_references():
    for name in ("P", "N", "GX", "GY", "A", "B", "GLV_BETA", "GLV_LAMBDA"):
        assert getattr(curve, name) == getattr(jcurve, name), name
    assert (curve.GENERATOR.x, curve.GENERATOR.y) == \
        (jcurve.GENERATOR.x, jcurve.GENERATOR.y)
    assert curve.GENERATOR.is_on_curve() and curve.INFINITY.infinity
    sk, msg = 0xC0FFEE + 17, 0x1234_5678_9ABC_DEF0 << 190
    pk, jpk = (curve.ECDSAPublicKey(curve.scalar_mul(sk, curve.GENERATOR)),
               jcurve.ECDSAPublicKey(jcurve.scalar_mul(sk,
                                                       jcurve.GENERATOR)))
    assert (pk.point.x, pk.point.y) == (jpk.point.x, jpk.point.y)
    sig, jsig = curve.ecdsa_sign(sk, msg), jcurve.ecdsa_sign(sk, msg)
    assert (sig.r, sig.s) == (jsig.r, jsig.s)
    assert curve.ecdsa_verify(pk, msg, sig)
    assert not curve.ecdsa_verify(pk, msg + 1, sig)
    assert curve.combined_action_hash(pk, msg) == \
        jcurve.combined_action_hash(jpk, msg)
    assert curve.glv_mul(sk, curve.GENERATOR) == \
        curve.scalar_mul(sk, curve.GENERATOR)
    for data in (b"", bytes(range(32)), b"city" * 40):
        for fn in ("sha256", "sha256d", "hash256", "ripemd160", "hash160"):
            assert bytes(getattr(hashes, fn)(data)) == \
                bytes(getattr(jhashes, fn)(data)), fn
        assert bytes(hashes.sha256(data)) == hashlib.sha256(data).digest()


def test_forged_point_add_case_bits_are_rejected(built):
    """tests/test_secp_circuit.py's soundness case on the port: a prover
    claiming is_double=0 on an equal-point add (free lambda), or
    is_double=1 on a distinct-point add, gets a witness conflict or
    violated constraints."""
    b, fill, _, data = built(PORT, "point_add")
    gen = curve.GENERATOR

    def rejected(a1, a2, hints):
        pw = b.partial_witness()
        fill(pw, a1, a2, hints)
        try:
            wires = circuit.generate_witness(data, pw)
        except ValueError:
            return True
        pis = [pw.get(t) or 0 for t in data.prover.pi_targets]
        return check_witness(data, wires,
                             prover.public_inputs_hash(pis)) != []

    assert rejected(gen, gen, (0, 0xDEADBEEF, 12345))
    assert rejected(gen, curve.add(gen, gen), (1, 0xDEADBEEF, 0))


def test_u32_balance_check_soundness():
    """A decrement below zero (amount 11 > balance 10): the reference's
    prove does not raise on it (tests/test_u32.py's test of that name
    fails), and neither does the port's. What both packages do: the
    witness breaks the range check that assert_lte_u32 makes (a BaseSum
    row), check_witness reports it, and the proof the port makes of that
    witness is rejected by both verifiers."""
    def build(pkg):
        b = pkg.Builder(u32_config(pkg))
        u = pkg.u32.U32Builder(b)
        bal, amt = u.add_virtual_u32(), u.add_virtual_u32()
        u.assert_lte_u32(amt, bal)
        data = b.build(device="cpu") if pkg is PORT else b.build()
        pw = b.partial_witness()
        u.set_u32(pw, bal, 10)
        u.set_u32(pw, amt, 11)
        return data, pw

    found, datas = [], []
    for pkg, check in ((REF, jcheck_witness), (PORT, check_witness)):
        data, pw = build(pkg)
        wires = pkg.circuit.generate_witness(data, pw)
        bad = check(data, wires, [0, 0, 0, 0])
        assert bad and all("base_sum" in v for v in bad), bad
        found.append(bad)
        datas.append(data)
    assert found[0] == found[1]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        proof = prover.prove(data, pw)
    finally:
        torch.set_num_threads(threads)
    assert not verifier.verify(proof, data.common, data.verifier)
    assert not jverifier.verify(
        ref_proof_from_plain(convert.proof_to_plain(proof)), datas[0].common,
        jcircuit.VerifierData(
            constants_sigmas_cap=data.verifier.constants_sigmas_cap,
            circuit_digest=data.verifier.circuit_digest))
