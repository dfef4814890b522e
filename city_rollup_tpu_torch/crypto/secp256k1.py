"""secp256k1 curve arithmetic, ECDSA, and wallet — host-side (CPU) twin of
the in-circuit gadget, built from the curve spec (SEC2).

Reference role: city_crypto/src/signature/secp256k1/curve/
{curve_types,ecdsa,glv,curve_msm}.rs and wallet.rs (SURVEY.md §2.1 row 4).
Point math uses Jacobian coordinates with a wNAF-free fixed-window ladder;
signing uses RFC6979 deterministic nonces so vectors are reproducible.
The circuit-facing "combined hash" (Poseidon over pubkey ∥ msg) matches the
signature-circuit public-input convention
(city_common_circuit/src/crypto/secp256k1/signature_circuit.rs:40-60).

Counterpart of the reference's ``crypto/secp256k1.py``: the same code over the port's
``core/`` (host Python).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac

from ..core import gl64, poseidon_host

# SEC2 secp256k1 parameters
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
A, B = 0, 7


@dataclasses.dataclass(frozen=True)
class AffinePoint:
    x: int
    y: int
    infinity: bool = False

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return (self.y * self.y - self.x * self.x * self.x - B) % P == 0


INFINITY = AffinePoint(0, 0, True)
GENERATOR = AffinePoint(GX, GY)


# --- Jacobian arithmetic ---------------------------------------------------

def _to_jac(p: AffinePoint):
    if p.infinity:
        return (1, 1, 0)
    return (p.x, p.y, 1)


def _jac_double(q):
    x, y, z = q
    if z == 0 or y == 0:
        return (1, 1, 0)
    ysq = (y * y) % P
    s = (4 * x * ysq) % P
    m = (3 * x * x) % P
    nx = (m * m - 2 * s) % P
    ny = (m * (s - nx) - 8 * ysq * ysq) % P
    nz = (2 * y * z) % P
    return (nx, ny, nz)


def _jac_add(q1, q2):
    x1, y1, z1 = q1
    x2, y2, z2 = q2
    if z1 == 0:
        return q2
    if z2 == 0:
        return q1
    z1sq, z2sq = (z1 * z1) % P, (z2 * z2) % P
    u1, u2 = (x1 * z2sq) % P, (x2 * z1sq) % P
    s1, s2 = (y1 * z2sq * z2) % P, (y2 * z1sq * z1) % P
    if u1 == u2:
        if s1 != s2:
            return (1, 1, 0)
        return _jac_double(q1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hsq = (h * h) % P
    hcu = (hsq * h) % P
    u1hsq = (u1 * hsq) % P
    nx = (r * r - hcu - 2 * u1hsq) % P
    ny = (r * (u1hsq - nx) - s1 * hcu) % P
    nz = (h * z1 * z2) % P
    return (nx, ny, nz)


def _jac_to_affine(q) -> AffinePoint:
    x, y, z = q
    if z == 0:
        return INFINITY
    zinv = pow(z, P - 2, P)
    zsq = (zinv * zinv) % P
    return AffinePoint((x * zsq) % P, (y * zsq * zinv) % P)


def scalar_mul(k: int, p: AffinePoint) -> AffinePoint:
    """4-bit fixed-window scalar multiplication (mirrors the windowed-mul
    strategy of the reference's curve_windowed_mul gadget on the host)."""
    k %= N
    if k == 0 or p.infinity:
        return INFINITY
    base = _to_jac(p)
    table = [(1, 1, 0), base]
    for _ in range(14):
        table.append(_jac_add(table[-1], base))
    acc = (1, 1, 0)
    for shift in range(k.bit_length() + (-k.bit_length()) % 4 - 4, -1, -4):
        for _ in range(4):
            acc = _jac_double(acc)
        acc = _jac_add(acc, table[(k >> shift) & 0xF])
    return _jac_to_affine(acc)


def msm(pairs: list[tuple[int, AffinePoint]]) -> AffinePoint:
    """Multi-scalar multiplication (curve_msm.rs equivalent) — Shamir trick
    over jacobian accumulation."""
    acc = (1, 1, 0)
    for k, p in pairs:
        acc = _jac_add(acc, _to_jac(scalar_mul(k, p)))
    return _jac_to_affine(acc)


def add(p: AffinePoint, q: AffinePoint) -> AffinePoint:
    return _jac_to_affine(_jac_add(_to_jac(p), _to_jac(q)))


# --- ECDSA ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ECDSAPublicKey:
    point: AffinePoint

    def to_bytes_compressed(self) -> bytes:
        prefix = b"\x03" if self.point.y & 1 else b"\x02"
        return prefix + self.point.x.to_bytes(32, "big")

    @staticmethod
    def from_bytes_compressed(data: bytes) -> "ECDSAPublicKey":
        assert len(data) == 33
        x = int.from_bytes(data[1:], "big")
        ysq = (pow(x, 3, P) + B) % P
        y = pow(ysq, (P + 1) // 4, P)
        if (y & 1) != (data[0] & 1):
            y = P - y
        return ECDSAPublicKey(AffinePoint(x, y))


@dataclasses.dataclass(frozen=True)
class ECDSASignature:
    r: int
    s: int

    def to_bytes(self) -> bytes:
        return self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big")


def _rfc6979_k(sk: int, msg_hash: int) -> int:
    h1 = msg_hash.to_bytes(32, "big")
    x = sk.to_bytes(32, "big")
    v, k = b"\x01" * 32, b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(sk: int, msg_hash: int) -> ECDSASignature:
    msg_hash %= N
    while True:
        k = _rfc6979_k(sk, msg_hash)
        pt = scalar_mul(k, GENERATOR)
        r = pt.x % N
        if r == 0:
            msg_hash = (msg_hash + 1) % N
            continue
        s = (pow(k, N - 2, N) * (msg_hash + r * sk)) % N
        if s == 0:
            msg_hash = (msg_hash + 1) % N
            continue
        if s > N // 2:      # low-s normalization (BTC standardness)
            s = N - s
        return ECDSASignature(r, s)


def ecdsa_verify(pk: ECDSAPublicKey, msg_hash: int,
                 sig: ECDSASignature) -> bool:
    if not (1 <= sig.r < N and 1 <= sig.s < N):
        return False
    if not pk.point.is_on_curve() or pk.point.infinity:
        return False
    w = pow(sig.s, N - 2, N)
    u1 = ((msg_hash % N) * w) % N
    u2 = (sig.r * w) % N
    pt = _jac_to_affine(_jac_add(_to_jac(scalar_mul(u1, GENERATOR)),
                                 _to_jac(scalar_mul(u2, pk.point))))
    if pt.infinity:
        return False
    return pt.x % N == sig.r


# --- wallet -----------------------------------------------------------------

def felts_of_u256(v: int) -> list[int]:
    """256-bit int -> 6 felts of 48 LE bits each (the last carries 16) —
    matches the in-circuit BigUintBuilder.pack_felts(_, 48) packing."""
    return [(v >> (48 * i)) & ((1 << 48) - 1) for i in range(6)]


# -- GLV endomorphism (curve/glv.rs twin) --------------------------------------
# secp256k1 has an efficient endomorphism psi(x, y) = (BETA x, y) acting as
# scalar multiplication by LAMBDA; splitting k = k1 + k2*LAMBDA with
# |k1|, |k2| ~ sqrt(n) halves the double-and-add length (the reference's
# in-circuit windowed mul builds on exactly this decomposition).

GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = _GLV_A1


def glv_decompose(k: int) -> tuple[int, int]:
    """k mod n -> (k1, k2) with k == k1 + k2 * LAMBDA (mod n) and
    |k1|, |k2| < ~2^128 (may be negative)."""
    k %= N
    c1 = (_GLV_B2 * k + N // 2) // N
    c2 = (-_GLV_B1 * k + N // 2) // N
    k1 = k - c1 * _GLV_A1 - c2 * _GLV_A2
    k2 = -c1 * _GLV_B1 - c2 * _GLV_B2
    return k1, k2


def endo(p: AffinePoint) -> AffinePoint:
    """psi(P) = (beta x, y) = [LAMBDA] P."""
    if p.infinity:
        return p
    return AffinePoint(GLV_BETA * p.x % P, p.y)


def glv_mul(k: int, p: AffinePoint) -> AffinePoint:
    """Scalar mul via the GLV split: two ~128-bit double-and-adds merged
    (Straus-Shamir trick), half the doublings of the plain ladder."""
    k1, k2 = glv_decompose(k)
    p1 = p if k1 >= 0 else AffinePoint(p.x, P - p.y) \
        if not p.infinity else p
    q = endo(p)
    p2 = q if k2 >= 0 else AffinePoint(q.x, P - q.y) \
        if not q.infinity else q
    a, b = abs(k1), abs(k2)
    bits = max(a.bit_length(), b.bit_length())
    both = add(p1, p2)
    acc = INFINITY
    for i in range(bits - 1, -1, -1):
        acc = add(acc, acc)
        ba, bb = (a >> i) & 1, (b >> i) & 1
        if ba and bb:
            acc = add(acc, both)
        elif ba:
            acc = add(acc, p1)
        elif bb:
            acc = add(acc, p2)
    return acc


def combined_action_hash(pk: ECDSAPublicKey, msg_hash: int) -> list[int]:
    """Poseidon(pk9 ∥ msg as 4x64-bit LE felts) — the single public input
    the secp256k1 signature circuit exposes (combined-hash convention of
    signature_circuit.rs:40-60; in-circuit twin:
    rollup/l1_signature.combined_hash_gadget). pk9 is the 9-felt packing
    of the compressed pubkey — the same packing used by deposit leaves and
    the sighash introspection circuit."""
    from .felts import bytes33_to_felts
    m = msg_hash % (1 << 256)
    msg4 = [(m >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
    return poseidon_host.hash_no_pad(
        bytes33_to_felts(pk.to_bytes_compressed()) + msg4)


def action_digest_to_msg(action: list[int]) -> int:
    """Pack a 4-felt action digest into the 256-bit ECDSA message int
    (little-endian 64-bit groups) — the wallet signing convention the
    claim-deposit op circuit pins."""
    return sum(int(a) << (64 * i) for i, a in enumerate(action))


class Secp256K1Wallet:
    """In-memory key store: add/derive keys, sign felt-encoded messages
    (city_crypto wallet.rs equivalent)."""

    def __init__(self):
        self._keys: dict[bytes, int] = {}

    def add_private_key(self, sk: int) -> ECDSAPublicKey:
        pk = ECDSAPublicKey(scalar_mul(sk, GENERATOR))
        self._keys[pk.to_bytes_compressed()] = sk
        return pk

    def add_random_key(self, seed: bytes) -> ECDSAPublicKey:
        sk = int.from_bytes(hashlib.sha256(seed).digest(), "big") % N
        return self.add_private_key(max(sk, 1))

    def public_keys(self) -> list[ECDSAPublicKey]:
        return [ECDSAPublicKey.from_bytes_compressed(b)
                for b in self._keys]

    def sign(self, pk: ECDSAPublicKey, msg_hash: int) -> ECDSASignature:
        sk = self._keys[pk.to_bytes_compressed()]
        return ecdsa_sign(sk, msg_hash)
