"""Proof verification: exact host-side math (the check is tiny: one
evaluation point plus the FRI queries).

Counterpart of the reference's ``snark/verifier.py`` (plonky2
`CircuitData::verify`), over the port's ``fri_verify`` with its
``initial_eval_fn``. It also rejects a proof whose number of query rounds
(FRI rounds or initial openings) is not the config's, which the
reference's does not check.
"""

from __future__ import annotations

from ..core import fri, gl64, gl64_ext, merkle
from ..core.challenger import Challenger
from .circuit import CommonData, VerifierData
from .proof import Proof

P = gl64.P


def _h_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _ext(v: int):
    return (v % P, 0)


def verify(proof: Proof, common: CommonData, vd: VerifierData) -> bool:
    cfg = common.config
    n, log_n = common.n, common.log_n
    rate_bits = cfg.rate_bits
    log_m = log_n + rate_bits
    R = cfg.num_routed_wires
    nc = cfg.num_challenges
    npp = cfg.num_partial_products
    num_sel = common.num_sel_cols
    o = proof.openings

    if len(proof.public_inputs) != common.num_public_inputs:
        return False
    if len(proof.initial_openings) != cfg.fri.num_query_rounds or \
            len(proof.fri_proof.query_rounds) != cfg.fri.num_query_rounds:
        return False
    from .proof import public_inputs_hash
    pi_hash = public_inputs_hash(proof.public_inputs)

    # ---- replay transcript --------------------------------------------------
    ch = Challenger()
    ch.observe_hash(list(vd.circuit_digest))
    ch.observe_cap(vd.constants_sigmas_cap)
    ch.observe_elements(pi_hash)
    ch.observe_cap(proof.wires_cap)
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.zs_pp_cap)
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_extension_challenge()
    for y in o.flat():
        ch.observe_ext(y)
    fri_alpha = ch.get_extension_challenge()

    # ---- vanishing identity at zeta ----------------------------------------
    sels = o.constants_sigmas[:num_sel]
    consts = o.constants_sigmas[num_sel:num_sel + cfg.num_constants]
    sigs = o.constants_sigmas[num_sel + cfg.num_constants:]
    if len(sigs) != R or len(o.wires) != cfg.num_wires:
        return False
    if len(o.zs) != nc or len(o.pps) != nc * npp or len(o.zs_next) != nc:
        return False
    if len(o.quotient) != nc * cfg.quotient_chunks:
        return False

    zeta_n = gl64_ext.h_exp(zeta, n)
    zh = _h_sub(zeta_n, (1, 0))
    one = (1, 0)
    l0_den = gl64_ext.h_mul(_h_sub(zeta, one), (n % P, 0))
    l0 = gl64_ext.h_mul(zh, gl64_ext.h_inverse(l0_den))
    k_is = common.k_is
    g_n = gl64.h_primitive_root_of_unity(log_n)

    for c in range(nc):
        beta, gamma = betas[c], gammas[c]
        terms = [gl64_ext.h_mul(l0, _h_sub(o.zs[c], one))]
        cs = cfg.perm_chunk_size
        for j in range(cfg.num_perm_chunks):
            num, den = one, one
            for i in range(j * cs, min((j + 1) * cs, R)):
                w_i = o.wires[i]
                ni = gl64_ext.h_add(
                    w_i, gl64_ext.h_add(
                        gl64_ext.h_mul(zeta, _ext(beta * k_is[i])),
                        _ext(gamma)))
                di = gl64_ext.h_add(
                    w_i, gl64_ext.h_add(
                        gl64_ext.h_mul(sigs[i], _ext(beta)), _ext(gamma)))
                num = gl64_ext.h_mul(num, ni)
                den = gl64_ext.h_mul(den, di)
            prev = o.zs[c] if j == 0 else o.pps[c * npp + j - 1]
            nxt = (o.zs_next[c] if j == cfg.num_perm_chunks - 1
                   else o.pps[c * npp + j])
            terms.append(_h_sub(gl64_ext.h_mul(nxt, den),
                                gl64_ext.h_mul(prev, num)))
        for gid, gate in enumerate(common.gates):
            sel_val = sels[common.gate_group(gid)]
            filt = one
            for t in common.filter_terms(gid):
                filt = gl64_ext.h_mul(filt, _h_sub(sel_val, _ext(t)))
            for cv in gate.eval_host(o.wires, consts, pi_hash):
                terms.append(gl64_ext.h_mul(filt, cv))
        combined = (0, 0)
        apow = one
        for t in terms:
            combined = gl64_ext.h_add(combined, gl64_ext.h_mul(t, apow))
            apow = gl64_ext.h_mul(apow, _ext(alphas[c]))
        # Q_c(zeta) from chunk openings
        q = (0, 0)
        zpow = one
        for j in range(cfg.quotient_chunks):
            q = gl64_ext.h_add(q, gl64_ext.h_mul(
                o.quotient[c * cfg.quotient_chunks + j], zpow))
            zpow = gl64_ext.h_mul(zpow, zeta_n)
        if combined != gl64_ext.h_mul(zh, q):
            return False

    # ---- FRI opening proof ---------------------------------------------------
    caps = [vd.constants_sigmas_cap, proof.wires_cap, proof.zs_pp_cap,
            proof.quotient_cap]
    S = len(o.constants_sigmas)
    W = cfg.num_wires
    nzp = nc * (1 + npp)
    sizes = [S, W, nzp, nc * cfg.quotient_chunks]
    # zk-mode commitments carry 4 salt felts per leaf (wires/zs_pp/quotient
    # trees only) — hashed into the leaf digest, excluded from the FRI sum
    from .proof import SALT_WIDTH
    salt_w = [0] + [SALT_WIDTH if cfg.zk else 0] * 3
    ys = (o.constants_sigmas + o.wires + o.zs + o.pps + o.quotient)
    gzeta = gl64_ext.h_mul(zeta, (g_n, 0))
    w_m = gl64.h_primitive_root_of_unity(log_m)
    shift = gl64.MULTIPLICATIVE_GROUP_GENERATOR

    def initial_eval(qr: int, idx: int):
        if qr >= len(proof.initial_openings):
            return None
        io = proof.initial_openings[qr]
        if len(io.values) != 4 or len(io.paths) != 4:
            return None
        flat_vals = []
        for tree_i in range(4):
            vals = [v % P for v in io.values[tree_i]]
            if len(vals) != sizes[tree_i] + salt_w[tree_i]:
                return None
            digest = merkle.h_hash_leaf(vals)
            if not merkle.h_verify_merkle_proof(digest, idx,
                                                io.paths[tree_i],
                                                caps[tree_i]):
                return None
            flat_vals.extend(vals[:sizes[tree_i]])
        x = (shift * pow(w_m, idx, P)) % P
        # batch 0: all polys at zeta
        s0, y0 = (0, 0), (0, 0)
        apow = one
        for v, y in zip(flat_vals, ys):
            s0 = gl64_ext.h_add(s0, gl64_ext.h_mul(apow, _ext(v)))
            y0 = gl64_ext.h_add(y0, gl64_ext.h_mul(apow, y))
            apow = gl64_ext.h_mul(apow, fri_alpha)
        f = gl64_ext.h_mul(_h_sub(s0, y0),
                           gl64_ext.h_inverse(_h_sub(_ext(x), zeta)))
        # batch 1: Zs at g*zeta
        z_vals = io.values[2][:nc]
        s1, y1 = (0, 0), (0, 0)
        for c in range(nc):
            s1 = gl64_ext.h_add(s1, gl64_ext.h_mul(apow, _ext(z_vals[c])))
            y1 = gl64_ext.h_add(y1, gl64_ext.h_mul(apow, o.zs_next[c]))
            apow = gl64_ext.h_mul(apow, fri_alpha)
        f1 = gl64_ext.h_mul(_h_sub(s1, y1),
                            gl64_ext.h_inverse(_h_sub(_ext(x), gzeta)))
        return gl64_ext.h_add(f, f1)

    return fri.fri_verify(proof.fri_proof, log_m, shift, cfg.fri, ch,
                          initial_eval_fn=initial_eval)
