"""The recursive verifier: verify one proof *inside* another circuit.

This is the capability every city-rollup aggregation layer rests on
(reference: plonky2's recursive verifier gadget consumed via
`builder.verify_proof::<C>` — SURVEY.md §2.14, §7 "hard part (a)"). The
gadget is an exact in-circuit twin of snark/verifier.py + core/fri.fri_verify:

  * ChallengerGadget replays the Fiat-Shamir transcript with in-circuit
    Poseidon rows (one PoseidonGate row per duplex);
  * the PLONK vanishing identity at zeta re-evaluates every child gate's
    constraints through the target algebra (gates.Gate.eval_alg +
    gadgets.CircuitExtAlg);
  * the FRI check derives query indices from canonical 64-bit decompositions
    of transcript challenges, walks Merkle paths with select gadgets, and
    folds codeword layers with witness-hinted inverses;
  * batch-opening sums run on ReducingGate rows (26 base / 13 ext terms per
    row) instead of per-term arithmetic.

Verifier data (constants_sigmas cap + circuit digest) may be circuit
constants (fixed inner circuit — proof minifier / wrapper style) or witness
targets constrained by fingerprint (aggregation style,
`verify_proof_with_fingerprint_enum`, SURVEY.md §2.2 "Builder extensions").

Counterpart of the reference's ``snark/recursion.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

import dataclasses

from ..core import gl64, poseidon_host
from ..core.poseidon_params import SPONGE_RATE, WIDTH
from .circuit import CircuitBuilder, CommonData, VerifierData
from .gadgets import (ExtGadgets, CircuitExtAlg, base_inverse,
                      exp_from_bits_const_base, reduce_with_powers,
                      reduce_with_powers_ext,
                      split_le_64, verify_merkle_proof_gadget,
                      eval_poly_ext_horner)
from .proof import Proof

P = gl64.P


# ---------------------------------------------------------------------------
# In-circuit Fiat-Shamir challenger (twin of core/challenger.py)
# ---------------------------------------------------------------------------

class ChallengerGadget:
    def __init__(self, b: CircuitBuilder):
        self.b = b
        self.state = [b.zero()] * WIDTH
        self.input_buffer: list = []
        self.output_buffer: list = []

    def observe_element(self, t):
        self.output_buffer.clear()
        self.input_buffer.append(t)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplex()

    def observe_elements(self, ts):
        for t in ts:
            self.observe_element(t)

    def observe_hash(self, h):
        assert len(h) == 4
        self.observe_elements(h)

    def observe_cap(self, cap):
        for d in cap:
            self.observe_hash(list(d))

    def observe_ext(self, x):
        self.observe_element(x[0])
        self.observe_element(x[1])

    def get_challenge(self):
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n):
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self):
        a0 = self.get_challenge()
        a1 = self.get_challenge()
        return (a0, a1)

    def _duplex(self):
        for i, t in enumerate(self.input_buffer):
            self.state[i] = t
        self.input_buffer.clear()
        self.state = self.b.poseidon_permute(self.state)
        self.output_buffer = list(self.state[:SPONGE_RATE])


# ---------------------------------------------------------------------------
# Proof / verifier-data target structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VerifierDataTargets:
    constants_sigmas_cap: list      # (2^cap) entries of 4 targets
    circuit_digest: list            # 4 targets


@dataclasses.dataclass
class OpeningSetTargets:
    constants_sigmas: list          # ExtTargets
    wires: list
    zs: list
    pps: list
    quotient: list
    zs_next: list

    def flat(self):
        return (self.constants_sigmas + self.wires + self.zs + self.pps +
                self.quotient + self.zs_next)


@dataclasses.dataclass
class FriQueryLayerTargets:
    coset: list                     # [ExtTarget, ExtTarget]
    merkle_path: list               # sibling digests (4 targets each)


@dataclasses.dataclass
class InitialOpeningTargets:
    values: list                    # per tree: list of base targets
    paths: list                     # per tree: sibling digests


@dataclasses.dataclass
class FriProofTargets:
    commit_caps: list               # per fold layer: list of 4-target digests
    final_poly: list                # ExtTargets
    pow_witness: object
    query_rounds: list              # [ [FriQueryLayerTargets ...] ...]
    initial_openings: list          # [InitialOpeningTargets ...]


@dataclasses.dataclass
class ProofTargets:
    public_inputs: list
    wires_cap: list
    zs_pp_cap: list
    quotient_cap: list
    openings: OpeningSetTargets
    fri: FriProofTargets


def _salt_widths(common):
    """Per-tree salt felts in the inner proof's initial openings: zk-mode
    commitments (wires/zs_pp/quotient) are salted, the preprocessed
    constants tree never is (snark/proof.py SALT_WIDTH)."""
    from .proof import SALT_WIDTH
    w = SALT_WIDTH if common.config.zk else 0
    return [0, w, w, w]


def _opening_sizes(common: CommonData):
    cfg = common.config
    S = common.num_sel_cols + cfg.num_constants + cfg.num_routed_wires
    nc = cfg.num_challenges
    return [S, cfg.num_wires, nc * (1 + cfg.num_partial_products),
            nc * cfg.quotient_chunks]


def _fri_layer_shapes(common: CommonData):
    """[(log_m_l, path_len, cap_entries)] per fold layer + final-poly len."""
    cfg = common.config
    log_m = common.log_n + cfg.rate_bits
    n_folds = cfg.fri.num_folds(common.log_n)
    shapes = []
    for l in range(n_folds):
        lm = log_m - l
        cap = min(cfg.fri.cap_height, lm - 1)
        shapes.append((lm, (lm - 1) - cap, 1 << cap))
    final_len = 1 << (common.log_n - n_folds)
    return shapes, final_len


def add_virtual_proof(b: CircuitBuilder, common: CommonData) -> ProofTargets:
    """Allocate virtual targets for every felt of a Proof with shape
    `common` (plonky2 add_virtual_proof_with_pis twin)."""
    cfg = common.config
    nc = cfg.num_challenges
    npp = cfg.num_partial_products
    log_m = common.log_n + cfg.rate_bits
    cap_h = min(cfg.fri.cap_height, log_m)
    n_cap = 1 << cap_h
    sizes = _opening_sizes(common)

    def digests(n):
        return [b.add_virtual_targets(4) for _ in range(n)]

    def exts(n):
        return [(b.add_virtual_target(), b.add_virtual_target())
                for _ in range(n)]

    openings = OpeningSetTargets(
        constants_sigmas=exts(sizes[0]), wires=exts(sizes[1]),
        zs=exts(nc), pps=exts(nc * npp),
        quotient=exts(nc * cfg.quotient_chunks), zs_next=exts(nc))

    shapes, final_len = _fri_layer_shapes(common)
    query_rounds = []
    initial_openings = []
    path_len0 = log_m - cap_h
    for _ in range(cfg.fri.num_query_rounds):
        layers = []
        for (_lm, plen, _ncap) in shapes:
            layers.append(FriQueryLayerTargets(
                coset=exts(2), merkle_path=digests(plen)))
        query_rounds.append(layers)
        salt_w = _salt_widths(common)
        initial_openings.append(InitialOpeningTargets(
            values=[b.add_virtual_targets(s + sw)
                    for s, sw in zip(sizes, salt_w)],
            paths=[digests(path_len0) for _ in range(4)]))

    fri_t = FriProofTargets(
        commit_caps=[digests(ncap) for (_lm, _p, ncap) in shapes],
        final_poly=exts(final_len),
        pow_witness=b.add_virtual_target(),
        query_rounds=query_rounds,
        initial_openings=initial_openings)

    return ProofTargets(
        public_inputs=b.add_virtual_targets(common.num_public_inputs),
        wires_cap=digests(n_cap), zs_pp_cap=digests(n_cap),
        quotient_cap=digests(n_cap), openings=openings, fri=fri_t)


def add_virtual_verifier_data(b: CircuitBuilder, common: CommonData
                              ) -> VerifierDataTargets:
    log_m = common.log_n + common.config.rate_bits
    n_cap = 1 << min(common.config.fri.cap_height, log_m)
    return VerifierDataTargets(
        constants_sigmas_cap=[b.add_virtual_targets(4) for _ in range(n_cap)],
        circuit_digest=b.add_virtual_targets(4))


# ---------------------------------------------------------------------------
# Circuit fingerprints (reference: get_circuit_fingerprint,
# city_common_circuit/src/builder/verify.rs:42-54)
# ---------------------------------------------------------------------------

def fingerprint_verifier_data(vd: VerifierData) -> list:
    """Host: Poseidon over (constants_sigmas_cap || circuit_digest)."""
    felts = [int(x) for row in vd.constants_sigmas_cap for x in row]
    felts += [int(x) for x in vd.circuit_digest]
    return poseidon_host.hash_no_pad(felts)


def fingerprint_gadget(b: CircuitBuilder, vdt: VerifierDataTargets) -> list:
    felts = [t for row in vdt.constants_sigmas_cap for t in row]
    felts += list(vdt.circuit_digest)
    return b.hash_n_to_hash_no_pad(felts)


# ---------------------------------------------------------------------------
# The verifier gadget
# ---------------------------------------------------------------------------

def _pi_hash_gadget(b: CircuitBuilder, pis: list) -> list:
    """In-circuit twin of proof.public_inputs_hash."""
    if len(pis) > 4:
        return b.hash_n_to_hash_no_pad(list(pis))
    return (list(pis) + [b.zero()] * 4)[:4]


def _hash_or_noop_gadget(b: CircuitBuilder, felts: list) -> list:
    if len(felts) <= 4:
        return (list(felts) + [b.zero()] * 4)[:4]
    return b.hash_n_to_hash_no_pad(list(felts))


def verify_proof_gadget(b: CircuitBuilder, pt: ProofTargets,
                        common: CommonData, vdt: VerifierDataTargets):
    """Add constraints asserting `pt` is a valid proof for the circuit shape
    `common` under verifier data `vdt` (in-circuit twin of
    snark/verifier.verify + core/fri.fri_verify)."""
    ext = ExtGadgets(b)
    alg = CircuitExtAlg(ext)
    cfg = common.config
    n, log_n = common.n, common.log_n
    rate_bits = cfg.rate_bits
    log_m = log_n + rate_bits
    R = cfg.num_routed_wires
    nc = cfg.num_challenges
    npp = cfg.num_partial_products
    num_sel = common.num_sel_cols
    o = pt.openings
    sizes = _opening_sizes(common)

    pi_hash = _pi_hash_gadget(b, pt.public_inputs)

    # ---- transcript replay -------------------------------------------------
    ch = ChallengerGadget(b)
    ch.observe_hash(vdt.circuit_digest)
    ch.observe_cap(vdt.constants_sigmas_cap)
    ch.observe_elements(pi_hash)
    ch.observe_cap(pt.wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(pt.zs_pp_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(pt.quotient_cap)
    zeta = ch.get_extension_challenge()
    for y in o.flat():
        ch.observe_ext(y)
    fri_alpha = ch.get_extension_challenge()

    # ---- vanishing identity at zeta ----------------------------------------
    sels = o.constants_sigmas[:num_sel]
    consts = o.constants_sigmas[num_sel:num_sel + cfg.num_constants]
    sigs = o.constants_sigmas[num_sel + cfg.num_constants:]
    one = ext.one()

    def add_base(x, t):
        return (b.add(x[0], t), x[1])

    zeta_n = ext.exp_pow2(zeta, log_n)
    zh = ext.sub(zeta_n, one)
    l0_den = ext.cmul(n % P, ext.cadd(P - 1, zeta))
    l0 = ext.mul(zh, ext.inverse(l0_den))
    k_is = common.k_is
    pi_hash_ext = [ext.ext(t) for t in pi_hash]

    for c in range(nc):
        beta, gamma = betas[c], gammas[c]
        beta_zeta = ext.mul_base(zeta, beta)
        terms = [ext.mul(l0, ext.sub(o.zs[c], one))]
        cs = cfg.perm_chunk_size
        for j in range(cfg.num_perm_chunks):
            num, den = one, one
            for i in range(j * cs, min((j + 1) * cs, R)):
                w_i = o.wires[i]
                ni = add_base(ext.add(w_i, ext.cmul(k_is[i], beta_zeta)),
                              gamma)
                di = add_base(ext.add(w_i, ext.mul_base(sigs[i], beta)),
                              gamma)
                num = ext.mul(num, ni)
                den = ext.mul(den, di)
            prev = o.zs[c] if j == 0 else o.pps[c * npp + j - 1]
            nxt = (o.zs_next[c] if j == cfg.num_perm_chunks - 1
                   else o.pps[c * npp + j])
            terms.append(ext.sub(ext.mul(nxt, den), ext.mul(prev, num)))
        for gid, gate in enumerate(common.gates):
            sel_val = sels[common.gate_group(gid)]
            filt = one
            for t in common.filter_terms(gid):
                filt = ext.mul(filt, ext.cadd(P - (t % P), sel_val))
            for cv in gate.eval_alg(o.wires, consts, pi_hash_ext, alg):
                terms.append(ext.mul(filt, cv))
        combined = reduce_with_powers_ext(b, ext, terms,
                                          ext.ext(alphas[c]))
        q = reduce_with_powers_ext(
            b, ext, o.quotient[c * cfg.quotient_chunks:
                               (c + 1) * cfg.quotient_chunks], zeta_n)
        ext.connect(combined, ext.mul(zh, q))

    # ---- FRI ----------------------------------------------------------------
    fri_cfg = cfg.fri
    shapes, final_len = _fri_layer_shapes(common)
    n_folds = len(shapes)
    assert len(pt.fri.commit_caps) == n_folds
    assert len(pt.fri.final_poly) == final_len

    fri_betas = []
    for cap in pt.fri.commit_caps:
        ch.observe_cap(cap)
        fri_betas.append(ch.get_extension_challenge())
    for coeff in pt.fri.final_poly:
        ch.observe_ext(coeff)
    ch.observe_element(pt.fri.pow_witness)
    pow_chal = ch.get_challenge()
    pow_bits = split_le_64(b, pow_chal)
    for i in range(64 - fri_cfg.proof_of_work_bits, 64):
        b.assert_zero(pow_bits[i])

    # batch-opening targets (query-independent)
    ys = (o.constants_sigmas + o.wires + o.zs + o.pps + o.quotient)
    n_polys = len(ys)
    y0 = reduce_with_powers_ext(b, ext, ys, fri_alpha)
    y1 = reduce_with_powers_ext(b, ext, o.zs_next, fri_alpha)
    # alpha^n_polys (static exponent): square-and-multiply over ext targets
    apow = one
    base_pow = fri_alpha
    e = n_polys
    while e:
        if e & 1:
            apow = ext.mul(apow, base_pow)
        e >>= 1
        if e:
            base_pow = ext.square(base_pow)
    alpha_npolys = apow

    g_n = gl64.h_primitive_root_of_unity(log_n)
    gzeta = ext.cmul(g_n, zeta)
    w_m = gl64.h_primitive_root_of_unity(log_m)
    shift = gl64.MULTIPLICATIVE_GROUP_GENERATOR
    caps_t = [vdt.constants_sigmas_cap, pt.wires_cap, pt.zs_pp_cap,
              pt.quotient_cap]

    fin_log = log_m - n_folds
    fin_shift = shift
    for _ in range(n_folds):
        fin_shift = (fin_shift * fin_shift) % P
    w_fin = gl64.h_primitive_root_of_unity(fin_log)

    for qr in range(fri_cfg.num_query_rounds):
        idx_chal = ch.get_challenge()
        idx_bits = split_le_64(b, idx_chal, canonical=True)[:log_m]
        io = pt.fri.initial_openings[qr]

        # initial witness trees: leaf hash + Merkle path per tree
        flat_vals = []
        salt_w = _salt_widths(common)
        for tree_i in range(4):
            vals = io.values[tree_i]
            assert len(vals) == sizes[tree_i] + salt_w[tree_i]
            # salt felts (zk commitments) enter the leaf digest but not
            # the FRI combination
            digest = _hash_or_noop_gadget(b, vals)
            verify_merkle_proof_gadget(b, digest, idx_bits,
                                       io.paths[tree_i], caps_t[tree_i])
            flat_vals.extend(vals[:sizes[tree_i]])

        x = exp_from_bits_const_base(b, w_m, idx_bits, scale=shift)
        x_ext = ext.ext(x)
        s0 = reduce_with_powers(b, ext, flat_vals, fri_alpha)
        f = ext.mul(ext.sub(s0, y0), ext.inverse(ext.sub(x_ext, zeta)))
        z_vals = io.values[2][:nc]
        s1 = reduce_with_powers(b, ext, z_vals, fri_alpha)
        f1 = ext.mul(ext.sub(s1, y1), ext.inverse(ext.sub(x_ext, gzeta)))
        value = ext.add(f, ext.mul(alpha_npolys, f1))

        # fold layers
        i_bits = idx_bits
        s_l = shift
        for l, (lm, _plen, _ncap) in enumerate(shapes):
            layer = pt.fri.query_rounds[qr][l]
            top_bit = i_bits[lm - 1]
            j_bits = i_bits[:lm - 1]
            vj, vjh = layer.coset
            claimed = ext.select(top_bit, vjh, vj)
            ext.connect(claimed, value)
            leaf = [vj[0], vj[1], vjh[0], vjh[1]]
            verify_merkle_proof_gadget(b, leaf, j_bits, layer.merkle_path,
                                       pt.fri.commit_caps[l])
            w_l = gl64.h_primitive_root_of_unity(lm)
            x_l = exp_from_bits_const_base(b, w_l, j_bits, scale=s_l)
            inv2x = base_inverse(b, b.mul_const(2, x_l))
            inv2 = pow(2, P - 2, P)
            even = ext.cmul(inv2, ext.add(vj, vjh))
            odd = ext.mul_base(ext.sub(vj, vjh), inv2x)
            value = ext.add(even, ext.mul(fri_betas[l], odd))
            i_bits = j_bits
            s_l = (s_l * s_l) % P

        # final polynomial check
        assert len(i_bits) == fin_log
        x_fin = exp_from_bits_const_base(b, w_fin, i_bits, scale=fin_shift)
        fin_val = eval_poly_ext_horner(b, ext, pt.fri.final_poly, x_fin)
        ext.connect(fin_val, value)
