"""BLS12-381 pairing curve, implemented from the spec (draft-irtf-cfrg-
pairing-friendly-curves; parameters as in the zkcrypto/ietf standard).

Reference role: the curve under the reference's Groth16 wrap
(`gnark-plonky2-wrapper` -> gnark BLS12-381, SURVEY.md §2.1 row 3).
This is the host-side wrap stage — TPU offers nothing for pairings, and the
reference also runs this on CPU (in Go). The hot path (MSMs in proving) is
vectorizable later; correctness first.

Implements: Fp / Fp2 / Fp6 / Fp12 towers, G1/G2 (Jacobian), untwist-free
ate Miller loop with line evaluations in Fp12, final exponentiation
(easy part + hard part via the standard x-power chain).

Counterpart of the reference's ``crypto/bls12_381.py``: a copy (host
Python ints; no JAX in either).
"""

from __future__ import annotations

import dataclasses

# field modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# subgroup order (Fr)
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative: x = -0xd201000000010000)
X = 0xD201000000010000
X_NEG = True

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE


# --- Fp ---------------------------------------------------------------------

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


# --- Fp2 = Fp[u]/(u^2+1) ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fp2:
    c0: int
    c1: int

    @staticmethod
    def zero():
        return Fp2(0, 0)

    @staticmethod
    def one():
        return Fp2(1, 0)

    def __add__(self, o):
        return Fp2((self.c0 + o.c0) % P, (self.c1 + o.c1) % P)

    def __sub__(self, o):
        return Fp2((self.c0 - o.c0) % P, (self.c1 - o.c1) % P)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp2(self.c0 * o % P, self.c1 * o % P)
        t0 = self.c0 * o.c0 % P
        t1 = self.c1 * o.c1 % P
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1) % P
        return Fp2((t0 - t1) % P, (t2 - t0 - t1) % P)

    def __neg__(self):
        return Fp2(-self.c0 % P, -self.c1 % P)

    def square(self):
        a, b = self.c0, self.c1
        return Fp2((a + b) * (a - b) % P, 2 * a * b % P)

    def inv(self):
        norm = fp_inv((self.c0 * self.c0 + self.c1 * self.c1) % P)
        return Fp2(self.c0 * norm % P, -self.c1 * norm % P)

    def conjugate(self):
        return Fp2(self.c0, -self.c1 % P)

    def mul_by_nonresidue(self):
        """* (u + 1)."""
        return Fp2((self.c0 - self.c1) % P, (self.c0 + self.c1) % P)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0


# --- Fp6 = Fp2[v]/(v^3 - (u+1)) ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fp6:
    c0: Fp2
    c1: Fp2
    c2: Fp2

    @staticmethod
    def zero():
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one():
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        """* v."""
        return Fp6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        denom = (a0 * t0 + (a2 * t1).mul_by_nonresidue() +
                 (a1 * t2).mul_by_nonresidue())
        dinv = denom.inv()
        return Fp6(t0 * dinv, t1 * dinv, t2 * dinv)


# --- Fp12 = Fp6[w]/(w^2 - v) ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fp12:
    c0: Fp6
    c1: Fp6

    @staticmethod
    def one():
        return Fp12(Fp6.one(), Fp6.zero())

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(t0 + t1.mul_by_nonresidue(),
                    (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        a0, a1 = self.c0, self.c1
        t0 = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t0 - \
            t0.mul_by_nonresidue()
        return Fp12(c0, t0 + t0)

    def conjugate(self):
        return Fp12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inv()
        return Fp12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        result = Fp12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self, power: int):
        """x -> x^(p^power) via coefficient conjugation + Frobenius
        coefficients."""
        out = self
        for _ in range(power):
            out = out._frobenius1()
        return out

    def _frobenius1(self):
        c0 = _fp6_frob(self.c0)
        c1 = _fp6_frob(self.c1)
        c1 = Fp6(c1.c0 * _FROB_W, c1.c1 * _FROB_W, c1.c2 * _FROB_W)
        return Fp12(c0, c1)


# Frobenius coefficients, computed once from the tower definition:
# xi = u + 1 (the Fp6 nonresidue); c1 = xi^((p-1)/3), c2 = xi^((2p-2)/3),
# w-coefficient = xi^((p-1)/6).
def _fp2_pow(a: Fp2, e: int) -> Fp2:
    out, base = Fp2.one(), a
    while e:
        if e & 1:
            out = out * base
        base = base.square()
        e >>= 1
    return out


_XI = Fp2(1, 1)
_FROB_C1 = _fp2_pow(_XI, (P - 1) // 3)
_FROB_C2 = _fp2_pow(_XI, 2 * (P - 1) // 3)
_FROB_W = _fp2_pow(_XI, (P - 1) // 6)


def _fp6_frob(a: Fp6) -> Fp6:
    return Fp6(a.c0.conjugate(),
               a.c1.conjugate() * _FROB_C1,
               a.c2.conjugate() * _FROB_C2)


# --- G1 / G2 (Jacobian) ------------------------------------------------------

# Generic Jacobian-coordinate scalar ladder shared by G1 (Fp) and G2 (Fp2):
# double-and-add with no per-step inversion. `ops` = (mul, add, sub, is_zero,
# dbl) over the coordinate field.
_FP_OPS = (lambda a, b: a * b % P,
           lambda a, b: (a + b) % P,
           lambda a, b: (a - b) % P,
           lambda a: a % P == 0,
           lambda a: 2 * a % P)
_FP2_OPS = (lambda a, b: a * b,
            lambda a, b: a + b,
            lambda a, b: a - b,
            lambda a: a.is_zero(),
            lambda a: a + a)


def _jac_mul_generic(px, py, k: int, ops):
    mul, add, sub, is_zero, dbl = ops

    def jdouble(X, Y, Z):
        A = mul(X, X)
        B = mul(Y, Y)
        C = mul(B, B)
        t = mul(add(X, B), add(X, B))
        D = dbl(sub(sub(t, A), C))
        E = add(dbl(A), A)
        F = mul(E, E)
        X3 = sub(F, dbl(D))
        Y3 = sub(mul(E, sub(D, X3)), dbl(dbl(dbl(C))))
        Z3 = dbl(mul(Y, Z))
        return X3, Y3, Z3

    def jadd_mixed(X1, Y1, Z1, x2, y2):
        # None encodes infinity for the accumulator
        ZZ = mul(Z1, Z1)
        U2 = mul(x2, ZZ)
        S2 = mul(mul(y2, ZZ), Z1)
        H = sub(U2, X1)
        r = sub(S2, Y1)
        if is_zero(H):
            if is_zero(r):
                return jdouble(X1, Y1, Z1)
            return None
        HH = mul(H, H)
        HHH = mul(H, HH)
        V = mul(X1, HH)
        X3 = sub(sub(mul(r, r), HHH), dbl(V))
        Y3 = sub(mul(r, sub(V, X3)), mul(Y1, HHH))
        Z3 = mul(Z1, H)
        return X3, Y3, Z3

    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = jdouble(*acc)
        if bit == "1":
            if acc is None:
                acc = (px, py, _field_one(px))
            else:
                acc = jadd_mixed(acc[0], acc[1], acc[2], px, py)
    return acc


def _field_one(sample):
    """Multiplicative identity matching the coordinate type."""
    return 1 if isinstance(sample, int) else Fp2.one()


def g1_mul_unreduced(p: "G1", k: int) -> "G1":
    """Scalar mul WITHOUT reducing k mod R — required for subgroup checks
    ([r]P == O must actually compute r·P; G1.mul's k %= R would make the
    check vacuously true for every on-curve point)."""
    if k == 0 or p.inf:
        return G1.identity()
    xyz = _jac_mul_generic(p.x, p.y, k, _FP_OPS)
    if xyz is None:
        return G1.identity()
    x, y, z = xyz
    zi = fp_inv(z)
    zi2 = zi * zi % P
    return G1(x * zi2 % P, y * zi2 % P * zi % P)


def g2_mul_unreduced(p: "G2", k: int) -> "G2":
    if k == 0 or p.inf:
        return G2.identity()
    xyz = _jac_mul_generic(p.x, p.y, k, _FP2_OPS)
    if xyz is None:
        return G2.identity()
    x, y, z = xyz
    zi = z.inv()
    zi2 = zi * zi
    return G2(x * zi2, y * zi2 * zi)


def _jac_add(a, b, ops):
    """Full Jacobian + Jacobian addition (a, b = (X,Y,Z) or None=inf)."""
    if a is None:
        return b
    if b is None:
        return a
    mul, add, sub, is_zero, dbl = ops
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    Z1Z1 = mul(Z1, Z1)
    Z2Z2 = mul(Z2, Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2Z2), Z2)
    S2 = mul(mul(Y2, Z1Z1), Z1)
    H = sub(U2, U1)
    r = sub(S2, S1)
    if is_zero(H):
        if is_zero(r):
            return _jac_double(a, ops)
        return None
    HH = mul(H, H)
    HHH = mul(H, HH)
    V = mul(U1, HH)
    X3 = sub(sub(mul(r, r), HHH), dbl(V))
    Y3 = sub(mul(r, sub(V, X3)), mul(S1, HHH))
    Z3 = mul(mul(Z1, Z2), H)
    return X3, Y3, Z3


def _jac_double(a, ops):
    if a is None:
        return None
    mul, add, sub, is_zero, dbl = ops
    X, Y, Z = a
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    t = mul(add(X, B), add(X, B))
    D = dbl(sub(sub(t, A), C))
    E = add(dbl(A), A)
    F = mul(E, E)
    X3 = sub(F, dbl(D))
    Y3 = sub(mul(E, sub(D, X3)), dbl(dbl(dbl(C))))
    Z3 = dbl(mul(Y, Z))
    return X3, Y3, Z3


def _msm_jac(jac_points: list, scalars: list, ops, window: int = 8):
    """Pippenger bucket MSM over Jacobian points (None = infinity)."""
    acc = None
    n_windows = (256 + window - 1) // window
    mask = (1 << window) - 1
    for wi in range(n_windows - 1, -1, -1):
        if acc is not None:
            for _ in range(window):
                acc = _jac_double(acc, ops)
        buckets = [None] * (mask + 1)
        shift = wi * window
        for pt, sc in zip(jac_points, scalars):
            d = (sc >> shift) & mask
            if d and pt is not None:
                buckets[d] = _jac_add(buckets[d], pt, ops)
        running = None
        win_sum = None
        for d in range(mask, 0, -1):
            running = _jac_add(running, buckets[d], ops)
            win_sum = _jac_add(win_sum, running, ops)
        acc = _jac_add(acc, win_sum, ops)
    return acc


def _to_jac(pt):
    """Affine group element -> Jacobian triple (None for infinity)."""
    if pt.inf:
        return None
    return (pt.x, pt.y, _field_one(pt.x))


def g1_msm(points: list, scalars: list) -> "G1":
    """sum scalars[i] * points[i] via Pippenger (the Groth16 prover/setup
    hot loop — replaces per-point double-and-add)."""
    jacs = [_to_jac(p) for p in points]
    acc = _msm_jac(jacs, [s % R for s in scalars], _FP_OPS)
    if acc is None:
        return G1.identity()
    x, y, z = acc
    zi = fp_inv(z)
    zi2 = zi * zi % P
    return G1(x * zi2 % P, y * zi2 % P * zi % P)


def g2_msm(points: list, scalars: list) -> "G2":
    jacs = [_to_jac(p) for p in points]
    acc = _msm_jac(jacs, [s % R for s in scalars], _FP2_OPS)
    if acc is None:
        return G2.identity()
    x, y, z = acc
    zi = z.inv()
    zi2 = zi * zi
    return G2(x * zi2, y * zi2 * zi)


class FixedBaseTable:
    """Windowed fixed-base table: precompute base * d * 2^(w i) for all
    windows i and digits d; each mul is then ~32 Jacobian adds. Used by the
    Groth16 setup, whose thousands of muls share the two generators."""

    def __init__(self, base, window: int = 8):
        self.window = window
        self.ops = _FP_OPS if isinstance(base, G1) else _FP2_OPS
        self.cls = type(base)
        n_windows = (256 + window - 1) // window
        self.table = []
        cur = _to_jac(base)
        for _ in range(n_windows):
            row = [None] * (1 << window)
            acc = None
            for d in range(1, 1 << window):
                acc = _jac_add(acc, cur, self.ops)
                row[d] = acc
            self.table.append(row)
            for _ in range(window):
                cur = _jac_double(cur, self.ops)

    def mul(self, k: int):
        k %= R
        acc = None
        mask = (1 << self.window) - 1
        wi = 0
        while k:
            d = k & mask
            if d:
                acc = _jac_add(acc, self.table[wi][d], self.ops)
            k >>= self.window
            wi += 1
        if acc is None:
            return self.cls.identity()
        x, y, z = acc
        if self.cls is G1:
            zi = fp_inv(z)
            zi2 = zi * zi % P
            return G1(x * zi2 % P, y * zi2 % P * zi % P)
        zi = z.inv()
        zi2 = zi * zi
        return G2(x * zi2, y * zi2 * zi)


@dataclasses.dataclass(frozen=True)
class G1:
    x: int
    y: int
    inf: bool = False

    @staticmethod
    def generator():
        return G1(G1_X, G1_Y)

    @staticmethod
    def identity():
        return G1(0, 0, True)

    def is_on_curve(self):
        if self.inf:
            return True
        return (self.y * self.y - self.x ** 3 - 4) % P == 0

    def neg(self):
        return self if self.inf else G1(self.x, -self.y % P)

    def add(self, o: "G1") -> "G1":
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if (self.y + o.y) % P == 0:
                return G1.identity()
            lam = 3 * self.x * self.x * fp_inv(2 * self.y) % P
        else:
            lam = (o.y - self.y) * fp_inv((o.x - self.x) % P) % P
        x3 = (lam * lam - self.x - o.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return G1(x3, y3)

    def mul(self, k: int) -> "G1":
        """Jacobian double-and-add (one field inversion total; the affine
        `add` pays an inversion per step, which dominates Groth16 MSMs)."""
        k %= R
        if k == 0 or self.inf:
            return G1.identity()
        xyz = _jac_mul_generic(self.x, self.y, k, _FP_OPS)
        if xyz is None:
            return G1.identity()
        x, y, z = xyz
        zi = fp_inv(z)
        zi2 = zi * zi % P
        return G1(x * zi2 % P, y * zi2 % P * zi % P)


@dataclasses.dataclass(frozen=True)
class G2:
    x: Fp2
    y: Fp2
    inf: bool = False

    @staticmethod
    def generator():
        return G2(Fp2(G2_X0, G2_X1), Fp2(G2_Y0, G2_Y1))

    @staticmethod
    def identity():
        return G2(Fp2.zero(), Fp2.zero(), True)

    def is_on_curve(self):
        if self.inf:
            return True
        b = Fp2(4, 4)           # twist: b' = 4(u+1)
        return (self.y.square() - self.x.square() * self.x - b).is_zero()

    def neg(self):
        return self if self.inf else G2(self.x, -self.y)

    def add(self, o: "G2") -> "G2":
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return G2.identity()
            lam = (self.x.square() * 3) * (self.y * 2).inv()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return G2(x3, y3)

    def mul(self, k: int) -> "G2":
        """Jacobian double-and-add over Fp2 (one inversion total)."""
        k %= R
        if k == 0 or self.inf:
            return G2.identity()
        xyz = _jac_mul_generic(self.x, self.y, k, _FP2_OPS)
        if xyz is None:
            return G2.identity()
        x, y, z = xyz
        zi = z.inv()
        zi2 = zi * zi
        return G2(x * zi2, y * zi2 * zi)


# --- pairing ------------------------------------------------------------------

def _line(q1: G2, q2: G2, p: G1) -> Fp12:
    """Evaluation of the line through q1, q2 on the twist E' (tangent when
    equal), at the *twisted image* of p: P' = (p.x w^2, p.y w^3). BLS12-381
    is an M-twist, so p is mapped INTO E'(Fp12) rather than untwisting q:
        l(P') = p.y w^3 - lam p.x w^2 + (lam x1 - y1)
    with Fp12 = Fp6[w]/(w^2 - v): the w^2 coeff sits at first-Fp6 c1, the
    w^3 = v w coeff at second-Fp6 c1."""
    if q1.x == q2.x and q1.y == q2.y:
        lam = (q1.x.square() * 3) * (q1.y * 2).inv()
    elif q1.x == q2.x:
        # vertical line: x-coordinate difference  p.x w^2 - x1
        return Fp12(Fp6(-q1.x, Fp2(p.x, 0), Fp2.zero()), Fp6.zero())
    else:
        lam = (q2.y - q1.y) * (q2.x - q1.x).inv()
    a = lam * q1.x - q1.y                         # 1-part (Fp2)
    b = lam * p.x                                 # w^2 coeff (negated)
    c = Fp2(p.y, 0)                               # w^3 coeff
    return Fp12(Fp6(a, -b, Fp2.zero()),
                Fp6(Fp2.zero(), c, Fp2.zero()))


def miller_loop(p: G1, q: G2) -> Fp12:
    if p.inf or q.inf:
        return Fp12.one()
    f = Fp12.one()
    t = q
    bits = bin(X)[3:]            # skip leading 1
    for bit in bits:
        f = f.square() * _line(t, t, p)
        t = t.add(t)
        if bit == "1":
            f = f * _line(t, q, p)
            t = t.add(q)
    if X_NEG:
        f = f.conjugate()
    return f


def final_exponentiation(f: Fp12) -> Fp12:
    # easy part: f^((p^6-1)(p^2+1))
    f1 = f.conjugate() * f.inv()            # f^(p^6 - 1)
    f2 = f1.frobenius(2) * f1               # ^(p^2 + 1)
    # hard part (generic, slow but correct): f2^((p^4 - p^2 + 1)/r)
    e = (P ** 4 - P ** 2 + 1) // R
    return f2.pow(e)


def pairing(p: G1, q: G2) -> Fp12:
    return final_exponentiation(miller_loop(p, q))


def pairing_check(pairs: list) -> bool:
    """prod e(p_i, q_i) == 1."""
    f = Fp12.one()
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f) == Fp12.one()
