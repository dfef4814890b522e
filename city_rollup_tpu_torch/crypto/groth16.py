"""Groth16 over BLS12-381: R1CS, trusted setup, prover, verifier.

Reference role: the gnark side of `gnark-plonky2-wrapper`
(SURVEY.md §2.1 row 3) — the reference wraps its final Plonky2 proof into a
Groth16 proof a patched Dogecoin verifies with OP_CHECKGROTH16VERIFY.
This module implements the Groth16 system itself (Groth16 [Gro16], as
standardized by gnark/snarkjs); the wrap *statement* is assembled in
rollup/groth16_wrap.py.

Proof encoding mirrors `CityGroth16ProofData {pi_a, pi_b_a0, pi_b_a1,
pi_c}` (city_rollup_common/src/block_template/data.rs): 48-byte field
elements of A (G1), B (G2, two Fp2 coords), C (G1).

Counterpart of the reference's ``crypto/groth16.py``: a copy. The same
``seed`` gives the same keys, and the same ``rand_seed`` the same proof
bytes, in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib

from . import bls12_381 as bls
from .bls12_381 import G1, G2, P, R


@dataclasses.dataclass
class R1CS:
    """Constraints a_i(w) * b_i(w) = c_i(w) over witness vector
    w = [1, public..., private...]; each row is a sparse {idx: coeff}."""
    num_public: int                 # not counting the leading 1
    num_vars: int                   # total incl. 1 + public + private
    a_rows: list
    b_rows: list
    c_rows: list

    def eval_row(self, row: dict, w: list) -> int:
        return sum(c * w[i] for i, c in row.items()) % R

    def is_satisfied(self, w: list) -> bool:
        for a, b, c in zip(self.a_rows, self.b_rows, self.c_rows):
            if (self.eval_row(a, w) * self.eval_row(b, w) -
                    self.eval_row(c, w)) % R != 0:
                return False
        return True


@dataclasses.dataclass
class ProvingKey:
    alpha1: G1
    beta1: G1
    beta2: G2
    delta1: G1
    delta2: G2
    a_query: list                   # [A_i(tau)]1 per variable
    b1_query: list
    b2_query: list                  # [B_i(tau)]2
    k_query: list                   # private-var K terms / delta
    h_query: list                   # powers tau^i Z(tau)/delta
    r1cs: R1CS


@dataclasses.dataclass
class VerifyingKey:
    alpha1: G1
    beta2: G2
    gamma2: G2
    delta2: G2
    ic: list                        # IC_0..IC_pub


def _g1_compress(p: G1) -> bytes:
    """zkcrypto/gnark compressed G1: 48 bytes, x big-endian with flag bits
    in the top 3 bits of byte 0 (compression, infinity, y-lexicographically-
    largest)."""
    if p.inf:
        out = bytearray(48)
        out[0] = 0b1100_0000
        return bytes(out)
    out = bytearray(p.x.to_bytes(48, "big"))
    out[0] |= 0b1000_0000
    if p.y > (P - 1) // 2:
        out[0] |= 0b0010_0000
    return bytes(out)


def _g2_compress(p: G2) -> bytes:
    """zkcrypto/gnark compressed G2: 96 bytes = x.c1 ∥ x.c0 big-endian, flag
    bits on byte 0; sign flag set when y is lexicographically largest
    (compare (y.c1, y.c0))."""
    if p.inf:
        out = bytearray(96)
        out[0] = 0b1100_0000
        return bytes(out)
    out = bytearray(p.x.c1.to_bytes(48, "big") + p.x.c0.to_bytes(48, "big"))
    out[0] |= 0b1000_0000
    neg_y = (P - p.y.c1 if p.y.c1 else 0, P - p.y.c0 if p.y.c0 else 0)
    if (p.y.c1, p.y.c0) > neg_y:
        out[0] |= 0b0010_0000
    return bytes(out)


@dataclasses.dataclass
class Groth16Proof:
    a: G1
    b: G2
    c: G1

    def to_city_data(self) -> dict:
        """CityGroth16ProofData encoding: each field is ONE 48-byte element
        (compressed G1 for pi_a/pi_c; the two 48-byte halves of compressed
        G2 for pi_b_a0/pi_b_a1 — 192 bytes total), matching
        city_rollup_common/src/block_template/data.rs to_ps_bytes."""
        b_comp = _g2_compress(self.b)
        return {
            "pi_a": _g1_compress(self.a).hex(),
            "pi_b_a0": b_comp[:48].hex(),
            "pi_b_a1": b_comp[48:].hex(),
            "pi_c": _g1_compress(self.c).hex(),
        }

    def to_ps_bytes(self) -> bytes:
        """192-byte witness-script payload (data.rs to_ps_bytes twin)."""
        d = self.to_city_data()
        return bytes.fromhex(d["pi_a"] + d["pi_b_a0"] + d["pi_b_a1"] +
                             d["pi_c"])


# QAP domain: multiplicative subgroup of Fr of size 2^k (Fr has 2-adicity
# 32; 7 generates Fr^*), interpolated with a radix-2 NTT — the snarkjs/gnark
# layout, O(n log n) instead of Lagrange's O(n^2)/O(n^3).
_FR_GENERATOR = 7
_FR_TWO_ADICITY = 32


def _domain(m: int) -> tuple[int, int]:
    """(n, omega): subgroup size (next pow2 >= m) and its generator."""
    n = 1
    while n < m:
        n <<= 1
    assert n <= 1 << _FR_TWO_ADICITY
    omega = pow(_FR_GENERATOR, (R - 1) // n, R)
    return n, omega


def _ntt(vals: list[int], omega: int, inverse: bool = False) -> list[int]:
    """In-place iterative radix-2 NTT over Fr."""
    n = len(vals)
    a = list(vals)
    # bit-reverse permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    if inverse:
        omega = pow(omega, -1, R)
    length = 2
    while length <= n:
        wl = pow(omega, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length >> 1
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * wl % R
        length <<= 1
    if inverse:
        n_inv = pow(n, -1, R)
        a = [x * n_inv % R for x in a]
    return a


def _poly_eval_points(r1cs: R1CS, tau: int):
    """Evaluate the QAP variable polynomials u_i/v_i/w_i at tau over the
    subgroup domain, via the closed-form Lagrange kernel
    L_j(tau) = (tau^n - 1) * omega^j / (n * (tau - omega^j))."""
    m = len(r1cs.a_rows)
    n, omega = _domain(m)
    z_tau = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, -1, R)
    l_at_tau = []
    wj = 1
    for _ in range(n):
        l_at_tau.append(z_tau * wj % R * n_inv % R *
                        pow((tau - wj) % R, -1, R) % R)
        wj = wj * omega % R
    u = [0] * r1cs.num_vars
    v = [0] * r1cs.num_vars
    w = [0] * r1cs.num_vars
    for j in range(m):
        lj = l_at_tau[j]
        for i, coef in r1cs.a_rows[j].items():
            u[i] = (u[i] + coef * lj) % R
        for i, coef in r1cs.b_rows[j].items():
            v[i] = (v[i] + coef * lj) % R
        for i, coef in r1cs.c_rows[j].items():
            w[i] = (w[i] + coef * lj) % R
    return u, v, w, z_tau, n


def setup(r1cs: R1CS, seed: bytes | None = None, *,
          dev_deterministic: bool = False
          ) -> tuple[ProvingKey, VerifyingKey]:
    """Trusted setup. By default the toxic waste (tau/alpha/beta/gamma/
    delta) is drawn from the OS CSPRNG and discarded; pass an explicit seed
    ONLY with dev_deterministic=True (CI/test ceremonies — anyone knowing
    the seed can forge proofs). The reference ships a pre-generated gnark
    keystore the same way (initialize(keystore), root.rs:296-304); a
    production deployment must load externally-ceremonied keys instead."""
    if seed is None:
        import secrets
        seed = secrets.token_bytes(32)
    elif not dev_deterministic:
        raise ValueError(
            "explicit setup seed requires dev_deterministic=True — "
            "a known seed makes the trapdoor recomputable (forgeable proofs)")

    def felt(tag):
        return int.from_bytes(hashlib.sha512(seed + tag).digest(),
                              "big") % (R - 2) + 1

    tau, alpha, beta, gamma, delta = (felt(b"tau"), felt(b"alpha"),
                                      felt(b"beta"), felt(b"gamma"),
                                      felt(b"delta"))
    u, v, w, z_tau, domain_n = _poly_eval_points(r1cs, tau)
    g1, g2 = G1.generator(), G2.generator()
    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)

    # fixed-base windowed tables: every setup mul shares the two generators
    t1 = bls.FixedBaseTable(g1)
    t2 = bls.FixedBaseTable(g2)
    a_query = [t1.mul(u[i]) for i in range(r1cs.num_vars)]
    b1_query = [t1.mul(v[i]) for i in range(r1cs.num_vars)]
    b2_query = [t2.mul(v[i]) for i in range(r1cs.num_vars)]
    n_pub = 1 + r1cs.num_public
    ic = [t1.mul((beta * u[i] + alpha * v[i] + w[i]) * gamma_inv % R)
          for i in range(n_pub)]
    k_query = [t1.mul((beta * u[i] + alpha * v[i] + w[i]) * delta_inv % R)
               for i in range(n_pub, r1cs.num_vars)]
    tau_pow = 1
    h_query = []
    for _ in range(max(domain_n - 1, 1)):
        h_query.append(t1.mul(tau_pow * z_tau % R * delta_inv % R))
        tau_pow = tau_pow * tau % R
    pk = ProvingKey(alpha1=g1.mul(alpha), beta1=g1.mul(beta),
                    beta2=g2.mul(beta), delta1=g1.mul(delta),
                    delta2=g2.mul(delta), a_query=a_query,
                    b1_query=b1_query, b2_query=b2_query,
                    k_query=k_query, h_query=h_query, r1cs=r1cs)
    vk = VerifyingKey(alpha1=pk.alpha1, beta2=pk.beta2,
                      gamma2=g2.mul(gamma), delta2=pk.delta2, ic=ic)
    return pk, vk


def _h_coeffs(r1cs: R1CS, w_vec: list) -> list:
    """Coefficients of h(x) = (A(x)B(x) - C(x)) / Z(x) over the subgroup
    domain, via coset evaluation: Z(g omega^i) = g^n - 1 is constant on the
    coset, so h is one pointwise division away (snarkjs `buildABC` +
    `joinABC` shape)."""
    m = len(r1cs.a_rows)
    n, omega = _domain(m)

    av = [r1cs.eval_row(r, w_vec) for r in r1cs.a_rows] + [0] * (n - m)
    bv = [r1cs.eval_row(r, w_vec) for r in r1cs.b_rows] + [0] * (n - m)
    cv = [r1cs.eval_row(r, w_vec) for r in r1cs.c_rows] + [0] * (n - m)

    a_c = _ntt(av, omega, inverse=True)
    b_c = _ntt(bv, omega, inverse=True)
    c_c = _ntt(cv, omega, inverse=True)

    g = _FR_GENERATOR
    # evaluate on the coset g * <omega>
    def coset_eval(coeffs):
        shifted = [c * pow(g, i, R) % R for i, c in enumerate(coeffs)]
        return _ntt(shifted, omega)

    a_e, b_e, c_e = coset_eval(a_c), coset_eval(b_c), coset_eval(c_c)
    z_inv = pow((pow(g, n, R) - 1) % R, -1, R)
    h_e = [(x * y - z) % R * z_inv % R for x, y, z in zip(a_e, b_e, c_e)]
    h_shifted = _ntt(h_e, omega, inverse=True)
    g_inv = pow(g, -1, R)
    h = [c * pow(g_inv, i, R) % R for i, c in enumerate(h_shifted)]
    # deg(AB - C) <= 2n - 2 -> deg(h) <= n - 2; the coset transform only
    # returns n coefficients, which is exactly enough since AB - C vanishes
    # on the subgroup. Highest coefficient must be 0 for a satisfied R1CS.
    assert h[-1] == 0 or m < n, "unexpected h degree"
    return h


def prove(pk: ProvingKey, witness: list, rand_seed: bytes | None = None
          ) -> Groth16Proof:
    """Prove. The zero-knowledge blinders r,s are drawn fresh from the OS
    CSPRNG per proof; a fixed rand_seed (tests only) makes proofs
    deterministic and leaks linkability."""
    r1cs = pk.r1cs
    assert len(witness) == r1cs.num_vars
    assert witness[0] == 1
    assert r1cs.is_satisfied(witness)
    if rand_seed is None:
        import secrets
        rand_seed = secrets.token_bytes(32)
    r_val = int.from_bytes(hashlib.sha256(rand_seed + b"r").digest(),
                           "big") % R
    s_val = int.from_bytes(hashlib.sha256(rand_seed + b"s").digest(),
                           "big") % R

    msm1 = bls.g1_msm
    msm2 = bls.g2_msm

    a = pk.alpha1.add(msm1(pk.a_query, witness)).add(pk.delta1.mul(r_val))
    b2 = pk.beta2.add(msm2(pk.b2_query, witness)).add(pk.delta2.mul(s_val))
    b1 = pk.beta1.add(msm1(pk.b1_query, witness)).add(pk.delta1.mul(s_val))

    h = _h_coeffs(r1cs, witness)
    h_term = msm1(pk.h_query[:len(h)], h)
    n_pub = 1 + r1cs.num_public
    k_term = msm1(pk.k_query, witness[n_pub:])
    c = (k_term.add(h_term).add(a.mul(s_val)).add(b1.mul(r_val))
         .add(pk.delta1.mul((-r_val * s_val) % R)))
    return Groth16Proof(a=a, b=b2, c=c)


def _valid_g1(p: G1) -> bool:
    # [r]P == O via the UNREDUCED ladder (G1.mul reduces k mod r, which
    # would make this check pass for any on-curve point)
    return p.is_on_curve() and (p.inf or bls.g1_mul_unreduced(p, R).inf)


def _valid_g2(p: G2) -> bool:
    return p.is_on_curve() and (p.inf or bls.g2_mul_unreduced(p, R).inf)


def verify(vk: VerifyingKey, public_inputs: list,
           proof: Groth16Proof) -> bool:
    """e(A,B) == e(alpha,beta) e(IC(pub),gamma) e(C,delta).

    Proof points are validated first (on-curve + prime-order subgroup via
    an unreduced [r]P == O) so deserialized untrusted bytes cannot feed
    invalid points into the pairing. Malformed inputs return False (never
    raise — this is the untrusted-input boundary)."""
    if len(public_inputs) != len(vk.ic) - 1:
        return False
    if not (_valid_g1(proof.a) and _valid_g2(proof.b) and
            _valid_g1(proof.c)):
        return False
    if proof.a.inf or proof.b.inf:
        return False
    acc = vk.ic[0]
    for base, x in zip(vk.ic[1:], public_inputs):
        acc = acc.add(base.mul(x))
    return bls.pairing_check([
        (proof.a.neg(), proof.b),
        (vk.alpha1, vk.beta2),
        (acc, vk.gamma2),
        (proof.c, vk.delta2),
    ])
