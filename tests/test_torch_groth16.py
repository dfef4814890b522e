"""The port's Groth16 wrap (crypto/bls12_381.py, crypto/groth16.py,
rollup/groth16_wrap.py, SigHashToolbox.wrap_groth16) against the
reference's: the same inputs give the same field elements, points,
encodings, keys, proof bytes and R1CS, exactly (they are python ints in
both packages).

Costs on one CPU: a pairing ~0.4 s, a verify ~0.8 s, the toy circuit's
setup ~1.2 s a package. The wrap statement's R1CS (3,151 constraints) is
built here with its trusted setup skipped (the test replaces
`groth16.setup` for the build; ~0.1 s), since its setup and prove take
~40 s a package: the whole statement end to end is `slow`."""

import dataclasses
import random
import types

import pytest
import torch

from city_rollup_tpu.crypto import bls12_381 as jbls
from city_rollup_tpu.crypto import groth16 as jg16
from city_rollup_tpu.rollup import groth16_wrap as jwrap
from city_rollup_tpu_torch.core.fri import FriConfig
from city_rollup_tpu_torch.crypto import bls12_381 as bls
from city_rollup_tpu_torch.crypto import groth16 as g16
from city_rollup_tpu_torch.rollup import groth16_wrap as wrap
from city_rollup_tpu_torch.rollup import sighash_toolbox as stb
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import prover
from city_rollup_tpu_torch.snark.recursion import fingerprint_verifier_data
from test_torch_rollup_circuits import TEST_FRI

R, P = bls.R, bls.P
SCALARS = [0, 1, R - 1, R, 2 * R + 5, 0x1234_5678_9ABC_DEF0]


def plain(x):
    """A field element, point, key or list of them as nested python values
    (type names dropped), comparable across the two packages."""
    if dataclasses.is_dataclass(x):
        return tuple(plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def fp2(mod, rnd):
    return mod.Fp2(rnd.randrange(P), rnd.randrange(P))


def fp6(mod, rnd):
    return mod.Fp6(fp2(mod, rnd), fp2(mod, rnd), fp2(mod, rnd))


def fp12(mod, rnd):
    return mod.Fp12(fp6(mod, rnd), fp6(mod, rnd))


@pytest.mark.parametrize("seed", [0, 1])
def test_tower_arithmetic_equals_the_references(seed):
    """Fp2, Fp6 and Fp12 mul, square, inverse and the Frobenius maps on
    seeded random elements."""
    for make in (fp2, fp6, fp12):
        a, b = make(bls, random.Random(seed)), \
            make(bls, random.Random(seed + 10))
        ja, jb = make(jbls, random.Random(seed)), \
            make(jbls, random.Random(seed + 10))
        assert plain(a) == plain(ja)
        pairs = [(a * b, ja * jb), (a.square(), ja.square()),
                 (a.inv(), ja.inv())]
        if make is not fp12:                # Fp12 has no + or - of its own
            pairs += [(a + b, ja + jb), (a - b, ja - jb), (-a, -ja)]
        for got, want in pairs:
            assert plain(got) == plain(want)
        assert plain(a * a.inv()) == plain(type(a).one())
    a = fp12(bls, random.Random(seed))
    ja = fp12(jbls, random.Random(seed))
    for k in (1, 2, 3, 6):
        assert plain(a.frobenius(k)) == plain(ja.frobenius(k))
    assert plain(a.conjugate()) == plain(ja.conjugate())
    assert plain(a.pow(R + 3)) == plain(ja.pow(R + 3))
    assert plain(a.frobenius(12)) == plain(a)
    assert plain((bls._FROB_C1, bls._FROB_C2, bls._FROB_W)) == \
        plain((jbls._FROB_C1, jbls._FROB_C2, jbls._FROB_W))


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_curve_arithmetic_equals_the_references(group):
    """add, double, mul, the unreduced ladder, the MSM and the fixed-base
    table, with the edge scalars 0, 1, R-1, R, and the compressed
    encodings."""
    G, JG = getattr(bls, group), getattr(jbls, group)
    mul_unreduced = getattr(bls, f"{group.lower()}_mul_unreduced")
    jmul_unreduced = getattr(jbls, f"{group.lower()}_mul_unreduced")
    msm = getattr(bls, f"{group.lower()}_msm")
    jmsm = getattr(jbls, f"{group.lower()}_msm")
    comp = getattr(g16, f"_{group.lower()}_compress")
    jcomp = getattr(jg16, f"_{group.lower()}_compress")
    g, jg = G.generator(), JG.generator()
    rnd = random.Random(3)
    ks = [rnd.randrange(R) for _ in range(3)]
    pts, jpts = [g.mul(k) for k in ks], [jg.mul(k) for k in ks]
    assert [plain(p) for p in pts] == [plain(p) for p in jpts]
    for p, jp in [(g, jg)] + list(zip(pts, jpts)):
        assert plain(p.add(p)) == plain(jp.add(jp))
        assert plain(p.add(g)) == plain(jp.add(jg))
        assert plain(p.add(p.neg())) == plain(jp.add(jp.neg()))
        assert comp(p) == jcomp(jp)
        assert p.is_on_curve() and jp.is_on_curve()
        for k in SCALARS:
            assert plain(p.mul(k)) == plain(jp.mul(k))
            assert comp(p.mul(k)) == jcomp(jp.mul(k))
    for k in SCALARS[:4]:
        assert plain(mul_unreduced(pts[0], k)) == \
            plain(jmul_unreduced(jpts[0], k))
    assert mul_unreduced(pts[0], R).inf             # prime-order subgroup
    assert not mul_unreduced(pts[0], R - 1).inf
    scs = [rnd.randrange(R) for _ in pts] + [0]
    assert plain(msm(pts + [g], scs)) == plain(jmsm(jpts + [jg], scs))
    assert plain(msm(pts, [R, 0, 1])) == plain(pts[2])
    table, jtable = bls.FixedBaseTable(g), jbls.FixedBaseTable(jg)
    for k in SCALARS:
        assert plain(table.mul(k)) == plain(jtable.mul(k))
        assert plain(table.mul(k)) == plain(g.mul(k))
    assert comp(G.identity()) == jcomp(JG.identity())


def test_pairing_equals_the_references():
    """One pairing and one pairing_check give the reference's Fp12 value
    and verdict, and the pairing is bilinear."""
    g1, g2 = bls.G1.generator(), bls.G2.generator()
    a, b = 0x5EED, 0xC0FFEE
    e = bls.pairing(g1.mul(a), g2)
    assert plain(e) == plain(jbls.pairing(jbls.G1.generator().mul(a),
                                          jbls.G2.generator()))
    assert plain(bls.pairing(g1, g2.mul(a))) == plain(e)
    assert plain(bls.pairing(g1.mul(b), g2.mul(a))) == plain(e.pow(b))
    assert plain(e) != plain(bls.Fp12.one())
    assert plain(e.pow(R)) == plain(bls.Fp12.one())
    pairs = [(g1.mul(a), g2.mul(b)), (g1.mul(a * b % R).neg(), g2)]
    jpairs = [(jbls.G1.generator().mul(a), jbls.G2.generator().mul(b)),
              (jbls.G1.generator().mul(a * b % R).neg(), jbls.G2.generator())]
    assert bls.pairing_check(pairs) and jbls.pairing_check(jpairs)
    pairs[1] = (g1.mul(a * b + 1).neg(), g2)
    assert not bls.pairing_check(pairs)
    assert plain(bls.miller_loop(bls.G1.identity(), g2)) == \
        plain(bls.Fp12.one())


def toy_r1cs(mod):
    """tests/test_groth16_wrap.py's toy statement: x1 = x2 * x3, x1
    public."""
    return mod.R1CS(num_public=1, num_vars=4, a_rows=[{2: 1}],
                    b_rows=[{3: 1}], c_rows=[{1: 1}])


def key_encoding(key) -> list:
    """Every point of a proving or verifying key, compressed."""
    out = []
    for f in dataclasses.fields(key):
        v = getattr(key, f.name)
        for p in v if isinstance(v, list) else [v]:
            if isinstance(p, (bls.G1, jbls.G1)):
                out.append(g16._g1_compress(bls.G1(*plain(p))))
            elif isinstance(p, (bls.G2, jbls.G2)):
                (x0, x1), (y0, y1), inf = plain(p)
                out.append(g16._g2_compress(bls.G2(bls.Fp2(x0, x1),
                                                   bls.Fp2(y0, y1), inf)))
    return out


def as_port_proof(jproof) -> g16.Groth16Proof:
    (ax, ay, ainf), ((bx0, bx1), (by0, by1), binf), (cx, cy, cinf) = \
        plain(jproof)
    return g16.Groth16Proof(
        a=bls.G1(ax, ay, ainf),
        b=bls.G2(bls.Fp2(bx0, bx1), bls.Fp2(by0, by1), binf),
        c=bls.G1(cx, cy, cinf))


def as_ref_proof(proof) -> jg16.Groth16Proof:
    (ax, ay, ainf), ((bx0, bx1), (by0, by1), binf), (cx, cy, cinf) = \
        plain(proof)
    return jg16.Groth16Proof(
        a=jbls.G1(ax, ay, ainf),
        b=jbls.G2(jbls.Fp2(bx0, bx1), jbls.Fp2(by0, by1), binf),
        c=jbls.G1(cx, cy, cinf))


def test_toy_groth16_equals_the_references():
    """Under one setup seed the keys are the reference's; under one
    rand_seed the proof bytes are; each package's verifier accepts the
    other's proof and rejects a wrong public input and an invalid point;
    an explicit seed without the dev flag raises."""
    pk, vk = g16.setup(toy_r1cs(g16), b"test", dev_deterministic=True)
    jpk, jvk = jg16.setup(toy_r1cs(jg16), b"test", dev_deterministic=True)
    assert key_encoding(pk) == key_encoding(jpk)
    assert key_encoding(vk) == key_encoding(jvk)
    assert len(key_encoding(vk)) == 6
    proof = g16.prove(pk, [1, 6, 2, 3], rand_seed=b"r")
    jproof = jg16.prove(jpk, [1, 6, 2, 3], rand_seed=b"r")
    assert proof.to_ps_bytes() == jproof.to_ps_bytes()
    assert len(proof.to_ps_bytes()) == 192
    assert proof.to_city_data() == jproof.to_city_data()
    assert g16.verify(vk, [6], as_port_proof(jproof))
    assert jg16.verify(jvk, [6], as_ref_proof(proof))
    assert not g16.verify(vk, [7], proof)
    assert not g16.verify(vk, [6, 1], proof)
    assert not g16.verify(vk, [6], dataclasses.replace(proof,
                                                       a=bls.G1(5, 7)))
    with pytest.raises(ValueError):
        g16.setup(toy_r1cs(g16), b"seed")
    with pytest.raises(AssertionError):
        g16.prove(pk, [1, 7, 2, 3])                 # unsatisfied


@pytest.fixture
def wrap_circuits(monkeypatch):
    """(port, reference) Groth16WrapCircuit over one fingerprint, built
    with the trusted setup skipped (R1CS and witness only)."""
    monkeypatch.setattr(g16, "setup", lambda *a, **k: (None, None))
    monkeypatch.setattr(jg16, "setup", lambda *a, **k: (None, None))
    fp = (123456789, 987654321, 555, (1 << 64) - (1 << 32))
    return (wrap.Groth16WrapCircuit.build(fp),
            jwrap.Groth16WrapCircuit.build(fp))


EDGE_PIS = [[(1 << 62) - 1, 3, 5, 7, (1 << 63) - 1, 11, 13, 17],
            [0] * 8,
            [(1 << 62) - 1] * 4 + [(1 << 63) - 1] * 4]


def test_wrap_r1cs_and_witness_equal_the_references(wrap_circuits):
    """The wrap statement's rows, variable counts and witnesses at the
    range edges; a felt past its range fails the witness in both."""
    wc, jwc = wrap_circuits
    r, jr = wc.r1cs, jwc.r1cs
    assert (r.num_vars, r.num_public) == (jr.num_vars, jr.num_public)
    assert (len(r.a_rows), r.num_vars, r.num_public) == (3151, 3152, 3)
    assert (r.a_rows, r.b_rows, r.c_rows) == (jr.a_rows, jr.b_rows,
                                              jr.c_rows)
    for pis in EDGE_PIS:
        w = wc._witness(pis)
        assert w == jwc._witness(pis)
        assert w[1:4] == [*wrap.pack_state(pis),
                          wrap.binding_digest(pis, wc.fingerprint)]
    for bad in ([1 << 62] + [0] * 7, [0] * 4 + [1 << 63] + [0] * 3):
        with pytest.raises(AssertionError):
            wc._witness(bad)
        with pytest.raises(AssertionError):
            jwc._witness(bad)


def test_mimc_packing_and_digest_equal_the_references():
    rnd = random.Random(17)
    assert wrap.MIMC_CONSTANTS == jwrap.MIMC_CONSTANTS
    for _ in range(3):
        xs = [rnd.randrange(R) for _ in range(rnd.randrange(1, 5))]
        assert wrap.mimc_sponge(xs) == jwrap.mimc_sponge(xs)
        assert wrap.mimc_permute(xs[0], 5) == jwrap.mimc_permute(xs[0], 5)
        pis = [rnd.randrange(1 << 62) for _ in range(4)] + \
            [rnd.randrange(1 << 63) for _ in range(4)]
        fp = [rnd.randrange(1 << 64) for _ in range(4)]
        assert wrap.pack_state(pis) == jwrap.pack_state(pis)
        assert wrap.binding_digest(pis, fp) == jwrap.binding_digest(pis, fp)
    assert wrap.binding_digest([0] * 8, (0, 0, 0, 0)) != \
        wrap.binding_digest([0] * 8, (1, 0, 0, 0))
    assert (wrap.GROTH16_DISABLED_DEV_MODE,
            wrap.GROTH16_WRAP_ATTESTATION_DEV_MODE) == (
        jwrap.GROTH16_DISABLED_DEV_MODE,
        jwrap.GROTH16_WRAP_ATTESTATION_DEV_MODE) == (False, False)


@pytest.fixture(scope="module")
def final_stand_in():
    """A stand-in for the final-GL circuit, built and proved by the port
    on the CPU: 8 public inputs in the felt248/felt252 limb ranges, at the
    rollup tests' FRI configuration."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = CircuitConfig.poseidon_config(num_challenges=1,
                                        fri=FriConfig(**TEST_FRI))
    b = CircuitBuilder(cfg)
    ts = [b.add_virtual_target() for _ in range(8)]
    b.register_public_inputs(ts)
    data = b.build(device="cpu")
    pw = b.partial_witness()
    pis = [(1 << 62) - 1, 3, 5, 7, (1 << 63) - 1, 11, 13, 17]
    for t, v in zip(ts, pis):
        pw.set(t, v)
    proof = prover.prove(data, pw)
    torch.set_num_threads(threads)
    return data, proof


class RecordingWrap:
    """Stands in for Groth16WrapCircuit: records the public inputs it is
    asked to prove and answers with the toy circuit's proof."""

    def __init__(self):
        self.pk, self.vk = g16.setup(toy_r1cs(g16), b"t",
                                     dev_deterministic=True)
        self.asked = []

    def prove(self, pis):
        self.asked.append(pis)
        return g16.prove(self.pk, [1, 6, 2, 3], b"r"), [6]

    def verify(self, proof, pub):
        return g16.verify(self.vk, pub, proof)


def test_wrap_final_proof_verifies_the_final_gl_proof(final_stand_in):
    """wrap_final_proof runs the Goldilocks verifier first (the reference
    calls it with the wrong arguments: a TypeError, ROADMAP reference
    caveats): a proof it accepts goes on to the wrap with its 8 public
    inputs; one it rejects raises before any Groth16 work."""
    data, proof = final_stand_in
    rec = RecordingWrap()
    out = wrap.wrap_final_proof(rec, data, proof)
    assert rec.asked == [list(proof.public_inputs)]
    assert out["public_inputs"] == [6]
    assert out["proof_data"] == out["proof"].to_city_data()
    assert [len(bytes.fromhex(v)) for v in out["proof_data"].values()] == \
        [48] * 4
    bad = dataclasses.replace(proof, public_inputs=[
        (proof.public_inputs[0] + 1)] + list(proof.public_inputs[1:]))
    with pytest.raises(ValueError, match="does not verify"):
        wrap.wrap_final_proof(rec, data, bad)
    assert len(rec.asked) == 1
    with pytest.raises(TypeError):
        jwrap.wrap_final_proof(rec, data, proof)


def test_sighash_toolbox_builds_and_runs_the_groth16_wrap(final_stand_in,
                                                          monkeypatch):
    """SigHashToolbox(with_groth16=True) builds Groth16WrapCircuit over the
    final GL's fingerprint with the seed and dev flag it was given (the
    whitelist, wrapper and final GL are stand-ins here), and wrap_groth16
    wraps a final-GL proof through wrap_final_proof."""
    data, proof = final_stand_in
    built = []
    monkeypatch.setattr(stb.SigHashMerkleTree, "build",
                        staticmethod(lambda fps: ("whitelist", fps)))
    monkeypatch.setattr(stb.SigHashWrapperCircuit, "build",
                        staticmethod(lambda *a, **k:
                                     types.SimpleNamespace(data="wrapper")))
    monkeypatch.setattr(stb.SigHashFinalGLCircuit, "build",
                        staticmethod(lambda *a, **k:
                                     types.SimpleNamespace(data=data)))
    monkeypatch.setattr(wrap.Groth16WrapCircuit, "build", classmethod(
        lambda cls, fp, **kw: built.append((fp, kw)) or RecordingWrap()))
    tb = stb.SigHashToolbox.__new__(stb.SigHashToolbox)
    tb.config, tb.device, tb.minified_common = None, "cpu", None
    tb._build_tail([(1, 2, 3, 4)], None, False, None, False)
    assert tb.groth16 is None and built == []
    tb._build_tail([(1, 2, 3, 4)], None, True, b"seed", True)
    fp = tuple(fingerprint_verifier_data(data.verifier))
    assert built == [(fp, {"setup_seed": b"seed",
                           "dev_deterministic": True})]
    assert tb.final_fingerprint == fp
    out = tb.wrap_groth16(proof)
    assert tb.groth16.asked == [list(proof.public_inputs)]
    assert out["public_inputs"] == [6]


@pytest.mark.slow
def test_wrap_statement_end_to_end_equals_the_references():
    """The whole wrap statement in both packages under one setup seed and
    one rand_seed (~40 s a package on one CPU): equal keys and proof bytes;
    the port's proof passes the reference's verifier; tampering any public
    input fails."""
    fp = (123456789, 987654321, 555, 777)
    wc = wrap.Groth16WrapCircuit.build(fp, setup_seed=b"test",
                                       dev_deterministic=True)
    jwc = jwrap.Groth16WrapCircuit.build(fp, setup_seed=b"test",
                                         dev_deterministic=True)
    assert key_encoding(wc.vk) == key_encoding(jwc.vk)
    assert key_encoding(wc.pk) == key_encoding(jwc.pk)
    pis = EDGE_PIS[0]
    w = wc._witness(pis)
    proof = g16.prove(wc.pk, w, rand_seed=b"r")
    jproof = jg16.prove(jwc.pk, jwc._witness(pis), rand_seed=b"r")
    assert proof.to_ps_bytes() == jproof.to_ps_bytes()
    pub = w[1:4]
    assert wc.verify(proof, pub)
    assert jwc.verify(as_ref_proof(proof), pub)
    for i in range(3):
        bad = list(pub)
        bad[i] ^= 1
        assert not wc.verify(proof, bad)
