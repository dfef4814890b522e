"""In-circuit secp256k1: nonnative curve arithmetic + ECDSA verification
over the biguint gadget layer.

Reference role: city_common_circuit/src/crypto/secp256k1/ecdsa/gadgets/
{curve, curve_fixed_base, curve_windowed_mul, glv, ecdsa}.rs (SURVEY.md
§2.2 "secp256k1 ECDSA in-circuit [heavy]"). Differences by design: the
reference leans on GLV decomposition + windowed multiplication to cut CPU
constraint count; here the scalar loop is a straight double-and-add whose
per-step field ops are witness-hinted (λ hints with product checks), so the
row population is dominated by the two batched kernels (Arithmetic +
BaseSum) the TPU prover evaluates in bulk. `n_bits` parameterizes the
scalar width so tests can exercise the identical datapath at toy widths.

Affine-with-infinity-flag representation: (x, y, is_inf bit). The
double-and-add accumulator handles the identity through selects, and
point_add's λ hint covers the doubling case via a slope selector.

Counterpart of the reference's ``snark/secp_gadgets.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

import dataclasses

from ..core import gl64
from ..crypto import secp256k1 as curve
from .biguint import BigUintBuilder, BigUintTarget, int_to_limbs, limbs_to_int

P = gl64.P
SECP_P = curve.P
SECP_N = curve.N
N_LIMBS = 16                     # 256 bits / 16-bit limbs


@dataclasses.dataclass
class PointTarget:
    x: BigUintTarget
    y: BigUintTarget
    is_inf: object                  # boolean target


class SecpGadget:
    def __init__(self, b):
        self.b = b
        self.big = BigUintBuilder(b)

    # -- point plumbing ------------------------------------------------------
    def add_virtual_point(self) -> PointTarget:
        b = self.b
        inf = b.add_virtual_target()
        b.assert_zero(b.mul(inf, b.add_const(inf, P - 1)))   # boolean
        return PointTarget(x=self.big.add_virtual_biguint(N_LIMBS),
                           y=self.big.add_virtual_biguint(N_LIMBS),
                           is_inf=inf)

    def constant_point(self, pt: curve.AffinePoint) -> PointTarget:
        b = self.b
        return PointTarget(
            x=self.big.constant_biguint(pt.x, N_LIMBS),
            y=self.big.constant_biguint(pt.y, N_LIMBS),
            is_inf=b.constant(1 if pt.infinity else 0))

    def set_point(self, pw, t: PointTarget, pt: curve.AffinePoint):
        self.big.set_biguint(pw, t.x, 0 if pt.infinity else pt.x)
        self.big.set_biguint(pw, t.y, 0 if pt.infinity else pt.y)
        pw.set(t.is_inf, 1 if pt.infinity else 0)

    def get_point(self, pw, t: PointTarget) -> curve.AffinePoint:
        if pw.get(t.is_inf):
            return curve.INFINITY
        return curve.AffinePoint(self.big.get_biguint(pw, t.x),
                                 self.big.get_biguint(pw, t.y))

    def assert_on_curve(self, pt: PointTarget):
        """y^2 ≡ x^3 + 7 (mod p) when not at infinity."""
        big, b = self.big, self.b
        y2 = big.mul_mod(pt.y, pt.y, SECP_P)
        x2 = big.mul_mod(pt.x, pt.x, SECP_P)
        x3 = big.mul_mod(x2, pt.x, SECP_P)
        seven = big.constant_biguint(7, N_LIMBS)
        rhs = big.add_mod(x3, seven, SECP_P)
        # (y2 - rhs) * (1 - is_inf) == 0, limb-wise via selected diff
        diff = big.sub_mod(y2, rhs, SECP_P)
        live = b.sub(b.one(), pt.is_inf)
        for limb in diff.limbs:
            b.assert_zero(b.mul(live, limb))

    # -- selects ---------------------------------------------------------------
    def select_biguint(self, bit, x: BigUintTarget, y: BigUintTarget
                       ) -> BigUintTarget:
        """bit ? x : y, limb-wise."""
        from .gadgets import select_base
        assert x.n_limbs == y.n_limbs
        return BigUintTarget([select_base(self.b, bit, xi, yi)
                              for xi, yi in zip(x.limbs, y.limbs)])

    def select_point(self, bit, p1: PointTarget, p2: PointTarget
                     ) -> PointTarget:
        from .gadgets import select_base
        return PointTarget(x=self.select_biguint(bit, p1.x, p2.x),
                           y=self.select_biguint(bit, p1.y, p2.y),
                           is_inf=select_base(self.b, bit, p1.is_inf,
                                              p2.is_inf))

    # -- group law ----------------------------------------------------------------
    def point_add(self, p1: PointTarget, p2: PointTarget) -> PointTarget:
        """Complete addition via a hinted slope λ:
        - distinct x: λ(x2 - x1) ≡ y2 - y1
        - equal points: λ·2y ≡ 3x²  (doubling)
        selected by a hinted is_double bit, then
        x3 = λ² - x1 - x2, y3 = λ(x1 - x3) - y1, with infinity flags
        handled by selects. The p1 = -p2 (result = ∞) case is signalled by
        a hinted is_neg bit verified via x1≡x2 ∧ y1+y2≡0."""
        big, b = self.big, self.b
        lam = big.add_virtual_biguint(N_LIMBS)
        inv_dx = big.add_virtual_biguint(N_LIMBS)
        is_double = b.add_virtual_target()
        is_neg = b.add_virtual_target()

        def gen(pw, _p1=p1, _p2=p2, _lam=lam, _idx=inv_dx, _d=is_double,
                _n=is_neg):
            # hint semantics: pre-set values win (soundness rests on the
            # constraints below, never on this generator — tests exercise
            # adversarial hints by pre-setting these targets)
            if pw.get(_d) is not None and pw.get(_lam.limbs[0]) is not None:
                return
            a1 = self.get_point(pw, _p1)
            a2 = self.get_point(pw, _p2)
            dbl = (not a1.infinity and not a2.infinity and
                   a1.x == a2.x and a1.y == a2.y)
            neg = (not a1.infinity and not a2.infinity and
                   a1.x == a2.x and (a1.y + a2.y) % SECP_P == 0 and not dbl)
            if pw.get(_d) is None:
                pw.set(_d, 1 if dbl else 0)
            if pw.get(_n) is None:
                pw.set(_n, 1 if neg else 0)
            inv_v = 0
            if a1.infinity or a2.infinity or neg:
                lam_v = 0
            elif dbl:
                lam_v = (3 * a1.x * a1.x *
                         pow(2 * a1.y % SECP_P, -1, SECP_P)) % SECP_P
            else:
                inv_v = pow((a2.x - a1.x) % SECP_P, -1, SECP_P)
                lam_v = ((a2.y - a1.y) * inv_v) % SECP_P
            big = self.big
            if pw.get(_lam.limbs[0]) is None:
                big.set_biguint(pw, _lam, lam_v)
            if pw.get(_idx.limbs[0]) is None:
                big.set_biguint(pw, _idx, inv_v)

        deps = (list(p1.x.limbs) + list(p1.y.limbs) + [p1.is_inf] +
                list(p2.x.limbs) + list(p2.y.limbs) + [p2.is_inf])
        b.add_generator(gen, deps=deps)

        for bit in (is_double, is_neg):
            b.assert_zero(b.mul(bit, b.add_const(bit, P - 1)))

        # live = both finite and not the annihilating case
        both = b.mul(b.sub(b.one(), p1.is_inf), b.sub(b.one(), p2.is_inf))
        live = b.mul(both, b.sub(b.one(), is_neg))

        # slope checks (each gated by `live`):
        #   add case:    λ(x2-x1) - (y2-y1) ≡ 0   [gate: live*(1-is_double)]
        #   double case: λ·2y1 - 3x1²       ≡ 0   [gate: live*is_double]
        dx = big.sub_mod(p2.x, p1.x, SECP_P)
        dy = big.sub_mod(p2.y, p1.y, SECP_P)
        lhs_add = big.sub_mod(big.mul_mod(lam, dx, SECP_P), dy, SECP_P)
        gate_add = b.mul(live, b.sub(b.one(), is_double))
        for limb in lhs_add.limbs:
            b.assert_zero(b.mul(gate_add, limb))
        # case-bit soundness: in the add case, dx must be INVERTIBLE mod p
        # (hinted inverse, product == 1) — otherwise a prover could claim
        # is_double=0 on an equal-point add, degenerate the slope check to
        # λ·0 == 0, and pick λ freely (forgeable ECDSA).
        dx_prod = big.mul_mod(dx, inv_dx, SECP_P)
        b.assert_zero(b.mul(gate_add, b.add_const(dx_prod.limbs[0], P - 1)))
        for limb in dx_prod.limbs[1:]:
            b.assert_zero(b.mul(gate_add, limb))

        two_y = big.add_mod(p1.y, p1.y, SECP_P)
        x1sq = big.mul_mod(p1.x, p1.x, SECP_P)
        three_x1sq = big.reduce_mod(big.mul_const(x1sq, 3), SECP_P, N_LIMBS)
        lhs_dbl = big.sub_mod(big.mul_mod(lam, two_y, SECP_P), three_x1sq,
                              SECP_P)
        gate_dbl = b.mul(live, is_double)
        for limb in lhs_dbl.limbs:
            b.assert_zero(b.mul(gate_dbl, limb))
        # case-bit soundness: is_double=1 requires actual point equality
        # (x1 == x2 and y1 == y2 mod p)
        for limb in dx.limbs:
            b.assert_zero(b.mul(gate_dbl, limb))
        for limb in dy.limbs:
            b.assert_zero(b.mul(gate_dbl, limb))

        # is_neg consistency: gated x1≡x2 and y1+y2≡0
        ysum = big.add_mod(p1.y, p2.y, SECP_P)
        for limb in dx.limbs:
            b.assert_zero(b.mul(is_neg, limb))
        for limb in ysum.limbs:
            b.assert_zero(b.mul(is_neg, limb))

        # result coordinates for the live case
        lam2 = big.mul_mod(lam, lam, SECP_P)
        x3 = big.sub_mod(big.sub_mod(lam2, p1.x, SECP_P), p2.x, SECP_P)
        y3 = big.sub_mod(big.mul_mod(lam, big.sub_mod(p1.x, x3, SECP_P),
                                     SECP_P), p1.y, SECP_P)

        # select: p1 inf -> p2 ; p2 inf -> p1 ; is_neg -> infinity
        res_x = self.select_biguint(p1.is_inf, p2.x, x3)
        res_y = self.select_biguint(p1.is_inf, p2.y, y3)
        res_x = self.select_biguint(p2.is_inf, p1.x, res_x)
        res_y = self.select_biguint(p2.is_inf, p1.y, res_y)
        res_inf = b.mul(p1.is_inf, p2.is_inf)     # both inf -> inf
        # annihilation: both finite and negatives
        res_inf = b.add(res_inf, b.mul(both, is_neg))
        out = PointTarget(x=res_x, y=res_y, is_inf=res_inf)
        # hint targets exposed for adversarial soundness tests
        out.hints = {"lam": lam, "inv_dx": inv_dx, "is_double": is_double,
                     "is_neg": is_neg}
        return out

    def scalar_mul(self, k_bits: list, pt: PointTarget) -> PointTarget:
        """MSB-first double-and-add over boolean targets `k_bits`
        (little-endian input)."""
        b = self.b
        zero = self.constant_point(curve.INFINITY)
        acc = zero
        for bit in reversed(k_bits):
            acc = self.point_add(acc, acc)
            added = self.point_add(acc, pt)
            acc = self.select_point(bit, added, acc)
        return acc

    def scalar_mul_biguint(self, k: BigUintTarget, pt: PointTarget
                           ) -> PointTarget:
        return self.scalar_mul(self.big.to_bits(k), pt)

    # -- GLV endomorphism (glv.rs twin, redesigned for the hinted-complete
    # -- addition law above) -------------------------------------------------
    GLV_BITS = 130                   # |k1|, |k2| < 2^129 from the lattice
    K_LIMBS = 9                      # 144-bit split magnitudes

    def negate_point_if(self, bit, pt: PointTarget) -> PointTarget:
        """bit ? -pt : pt (negation = y -> p - y; infinity preserved)."""
        big = self.big
        zero = big.constant_biguint(0, N_LIMBS)
        neg_y = big.sub_mod(zero, pt.y, SECP_P)
        return PointTarget(x=pt.x,
                           y=self.select_biguint(bit, neg_y, pt.y),
                           is_inf=pt.is_inf)

    def endo_point(self, pt: PointTarget) -> PointTarget:
        """psi(x, y) = (beta * x, y) — the secp256k1 GLV endomorphism,
        psi(P) = lambda * P on the curve."""
        beta = self.big.constant_biguint(curve.GLV_BETA, N_LIMBS)
        return PointTarget(x=self.big.mul_mod(beta, pt.x, SECP_P),
                           y=pt.y, is_inf=pt.is_inf)

    def glv_split(self, u: BigUintTarget):
        """Hint the GLV decomposition u ≡ (-1)^sa · a + λ·(-1)^sb · b
        (mod n) with a, b < 2^130, and CONSTRAIN that relation — any
        satisfying hint yields the right subgroup element, so soundness
        never rests on the generator. Returns (a, b, sa, sb, a_bits,
        b_bits) with the bit lists trimmed to GLV_BITS."""
        big, b = self.big, self.b
        av = big.add_virtual_biguint(self.K_LIMBS)
        bv = big.add_virtual_biguint(self.K_LIMBS)
        sa = b.add_virtual_target()
        sb = b.add_virtual_target()

        def gen(pw, _u=list(u.limbs), _a=av, _b=bv, _sa=sa, _sb=sb):
            uv = limbs_to_int([pw.get(t) for t in _u]) % SECP_N
            k1, k2 = curve.glv_decompose(uv)   # signed split
            big.set_biguint(pw, _a, abs(k1))
            big.set_biguint(pw, _b, abs(k2))
            pw.set(_sa, 1 if k1 < 0 else 0)
            pw.set(_sb, 1 if k2 < 0 else 0)

        b.add_generator(gen, deps=list(u.limbs))
        for bit in (sa, sb):
            b.assert_zero(b.mul(bit, b.add_const(bit, P - 1)))

        # magnitude bits (boolean-constrained by split_le_16); the tail
        # above GLV_BITS must vanish so the ladder can stop there
        a_bits = big.to_bits(av)
        b_bits = big.to_bits(bv)
        for bit in a_bits[self.GLV_BITS:] + b_bits[self.GLV_BITS:]:
            b.assert_zero(bit)

        # relation check mod n (16-limb domain)
        zero16 = big.constant_biguint(0, N_LIMBS)
        pad = [b.zero()] * (N_LIMBS - self.K_LIMBS)
        a16 = BigUintTarget(list(av.limbs) + pad)
        b16 = BigUintTarget(list(bv.limbs) + pad)
        term_a = self.select_biguint(
            sa, big.sub_mod(zero16, a16, SECP_N), a16)
        lam = big.constant_biguint(curve.GLV_LAMBDA, N_LIMBS)
        lam_b = big.mul_mod(lam, b16, SECP_N)
        term_b = self.select_biguint(
            sb, big.sub_mod(zero16, lam_b, SECP_N), lam_b)
        lhs = big.add_mod(term_a, term_b, SECP_N)
        big.assert_equal(lhs, u)
        return av, bv, sa, sb, a_bits[:self.GLV_BITS], b_bits[:self.GLV_BITS]

    def mul_base_and_point_glv(self, u1: BigUintTarget, u2: BigUintTarget,
                               pk: PointTarget) -> PointTarget:
        """u1·G + u2·pk via GLV splits and a shared-doubling Strauss
        ladder: both 256-bit scalars become four ~130-bit streams over
        {±G, ±λG, ±pk, ±ψ(pk)}, so the whole sum costs 130 doublings +
        4·130 conditional additions instead of 2·256 of each — the row
        cut that makes the full-width ECDSA circuit provable (reference:
        glv.rs + curve_windowed_mul.rs; VERDICT r4 item 4)."""
        b = self.b
        _, _, sa, sb, a_bits, b_bits = self.glv_split(u1)
        _, _, sc, sd, c_bits, d_bits = self.glv_split(u2)

        g = curve.GENERATOR
        lg = curve.AffinePoint((curve.GLV_BETA * g.x) % SECP_P, g.y)
        neg = lambda p_: curve.AffinePoint(p_.x, (SECP_P - p_.y) % SECP_P)
        pa = self.select_point(sa, self.constant_point(neg(g)),
                               self.constant_point(g))
        pb = self.select_point(sb, self.constant_point(neg(lg)),
                               self.constant_point(lg))
        pc = self.negate_point_if(sc, pk)
        pd = self.negate_point_if(sd, self.endo_point(pk))

        acc = self.constant_point(curve.INFINITY)
        streams = [(a_bits, pa), (b_bits, pb), (c_bits, pc), (d_bits, pd)]
        for i in reversed(range(self.GLV_BITS)):
            acc = self.point_add(acc, acc)
            for bits, pt in streams:
                added = self.point_add(acc, pt)
                acc = self.select_point(bits[i], added, acc)
        return acc

    # -- ECDSA ---------------------------------------------------------------------
    def ecdsa_verify(self, pk: PointTarget, msg: BigUintTarget,
                     r: BigUintTarget, s: BigUintTarget,
                     use_glv: bool = True):
        """Constrain (r, s) to be a valid ECDSA signature on `msg` under
        `pk`: u1 = z s⁻¹, u2 = r s⁻¹ (mod n), R = u1·G + u2·pk, and
        R.x ≡ r (mod n) with R finite (ecdsa.rs verify gadget twin).

        `use_glv` routes the double scalar-mul through the GLV/Strauss
        ladder (~4x fewer rows); the plain double-and-add stays for
        toy-width tests of the raw datapath."""
        big, b = self.big, self.b
        self.assert_on_curve(pk)
        b.assert_zero(pk.is_inf)
        big.assert_lt(r, SECP_N)
        big.assert_lt(s, SECP_N)

        s_inv = big.inv_mod(s, SECP_N)
        u1 = big.mul_mod(msg, s_inv, SECP_N)
        u2 = big.mul_mod(r, s_inv, SECP_N)
        if use_glv:
            rr = self.mul_base_and_point_glv(u1, u2, pk)
        else:
            g = self.constant_point(curve.GENERATOR)
            r1 = self.scalar_mul_biguint(u1, g)
            r2 = self.scalar_mul_biguint(u2, pk)
            rr = self.point_add(r1, r2)
        b.assert_zero(rr.is_inf)
        rx_mod_n = big.reduce_mod(rr.x, SECP_N, N_LIMBS)
        big.assert_equal(rx_mod_n, r)
