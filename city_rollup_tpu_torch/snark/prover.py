"""The PLONK+FRI prover: witnesses -> proofs, every polynomial-sized pass
on the circuit's device (LDE NTTs, Merkle hashing, the permutation and
quotient passes, the openings, the reduced codeword, FRI), the irregular
glue (witness generation, transcripts) on the host.

Counterpart of the reference's ``snark/prover.py`` (plonky2
`CircuitData::prove`). ``prove`` is ``prove_batch`` on a batch of one; with
zk off its proof equals the reference's ``prove``, field for field. The
LDEs stay on the device: the openings at zeta, the reduced codeword and the
query columns of the initial trees are computed there, and only their
values are copied to the host.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..core import fri, gl64, gl64_ext, ntt, poseidon_host
from ..core.challenger import Challenger
from ..core.merkle import BatchedMerkleTree
from ..parallel import mesh as device_mesh
from . import device_passes
from .circuit import (CircuitData, PartialWitness, generate_witness,
                      interp_and_lde)

P = gl64.P


# ---------------------------------------------------------------------------
# Proof objects
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpeningSet:
    constants_sigmas: list      # ext (int,int) per preprocessing poly
    wires: list
    zs: list                    # Z_c(zeta)
    pps: list                   # partial products (challenge-major)
    quotient: list              # chunks (challenge-major)
    zs_next: list               # Z_c(g*zeta)

    def flat(self):
        return (self.constants_sigmas + self.wires + self.zs + self.pps +
                self.quotient + self.zs_next)


@dataclasses.dataclass
class InitialTreeOpening:
    values: list[list[int]]     # per tree: leaf row (all polys at the index)
    paths: list[list[list[int]]]


@dataclasses.dataclass
class Proof:
    public_inputs: list[int]
    wires_cap: np.ndarray
    zs_pp_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: OpeningSet
    fri_proof: fri.FriProof
    initial_openings: list[InitialTreeOpening]   # one per query round


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def _csprng_felts(shape) -> np.ndarray:
    """CSPRNG field elements, uniform mod p via a 128-bit fold per felt
    (2^128 mod-p bias ~2^-64, against 2^-32 for a raw u64 % p)."""
    import secrets
    raw = np.frombuffer(secrets.token_bytes(16 * int(np.prod(shape))),
                        dtype=np.uint64).reshape(tuple(shape) + (2,))
    # hi * 2^64 + lo == hi * EPSILON + lo (mod p)
    return gl64.np_add(gl64.np_mul(raw[..., 1], np.uint64(gl64.EPSILON)),
                       raw[..., 0] % np.uint64(P))


def _blinding_rows(num_wires: int, nb: int) -> np.ndarray:
    """(num_wires, nb) CSPRNG blinding values for zk's padding rows."""
    return _csprng_felts((num_wires, nb))


SALT_WIDTH = 4      # salt felts per committed leaf in zk mode (plonky2 SALT_SIZE)


def _salt_rows(m: int, batch: int) -> np.ndarray:
    """(B, 4, M) CSPRNG salt columns for zk-mode Merkle leaves: every leaf
    of the wires / zs_pp / quotient trees gets 4 fresh random felts, so the
    Merkle openings at the FRI query indices are statistically independent
    of the witness (plonky2's salted commitments)."""
    return _csprng_felts((batch, SALT_WIDTH, m))


def public_inputs_hash(pis: list[int]) -> list[int]:
    """<=4 PIs pass through zero-padded; more are Poseidon-hashed (matches
    CircuitBuilder.build's public-input wiring)."""
    pis = [int(v) % P for v in pis]
    if len(pis) > 4:
        return poseidon_host.hash_no_pad(pis)
    return (pis + [0, 0, 0, 0])[:4]


def _ext_powers(points, n: int, device) -> tuple[torch.Tensor, ...]:
    """(B, n) ext pair: point_b^i for i < n, by doubling (log2 n ext
    multiplies of the table so far by point^len)."""
    p0 = gl64.full((len(points), 1), 1, device)
    p1 = gl64.zeros((len(points), 1), device)
    while p0.shape[1] < n:
        step = np.array([gl64_ext.h_exp(pt, p0.shape[1]) for pt in points],
                        dtype=np.uint64)
        s = (convert.from_u64(step[:, 0:1], device),
             convert.from_u64(step[:, 1:2], device))
        q0, q1 = gl64_ext.mul((p0, p1), s)
        p0, p1 = torch.cat([p0, q0], dim=1), torch.cat([p1, q1], dim=1)
    return p0[:, :n], p1[:, :n]


def ext_eval_batch(blocks, points) -> np.ndarray:
    """Evaluate base-coefficient polynomials at one extension point per
    proof: blocks are (B, k, n) coefficient tensors, or (k, n) shared by
    every proof; points: B ext (int, int). Returns (B, sum k, 2) uint64
    on the host, in block order (one copy)."""
    device = blocks[0].device
    n = blocks[0].shape[-1]
    p0, p1 = _ext_powers(points, n, device)
    p0, p1 = p0[:, None, :], p1[:, None, :]
    out = torch.cat([torch.stack([gl64.reduce_add(gl64.mul(blk, p0)),
                                  gl64.reduce_add(gl64.mul(blk, p1))], dim=-1)
                     for blk in blocks], dim=1)
    return convert.to_u64(out)


@functools.lru_cache(maxsize=None)
def _lde_points_cached(log_m: int) -> np.ndarray:
    w = gl64.h_primitive_root_of_unity(log_m)
    pows = gl64.np_powers(w, 1 << log_m)
    return gl64.np_mul(pows, np.uint64(gl64.MULTIPLICATIVE_GROUP_GENERATOR))


@functools.lru_cache(maxsize=None)
def _zh_inv_lde(log_n: int, rate_bits: int) -> np.ndarray:
    """(x^n - 1)^-1 over the LDE coset ((M,), 2^rate-periodic)."""
    n, M = 1 << log_n, 1 << (log_n + rate_bits)
    x = _lde_points_cached(log_n + rate_bits)
    xn = gl64.np_pow(x[: 1 << rate_bits], n)        # periodic: first period
    vals = gl64.np_sub(xn, np.ones_like(xn))
    inv = gl64.np_inverse(vals)
    return np.tile(inv, M >> rate_bits)


@functools.lru_cache(maxsize=None)
def _l0_lde(log_n: int, rate_bits: int) -> np.ndarray:
    """L_0(x) = (x^n - 1) / (n (x - 1)) over the LDE coset."""
    n, M = 1 << log_n, 1 << (log_n + rate_bits)
    x = _lde_points_cached(log_n + rate_bits)
    zh = gl64.np_sub(gl64.np_pow(x, n), np.ones(M, dtype=np.uint64))
    den = gl64.np_mul(gl64.np_sub(x, np.ones(M, dtype=np.uint64)),
                      np.full(M, n % P, dtype=np.uint64))
    return gl64.np_mul(zh, gl64.np_inverse(den))


_DOMAIN: dict = {}


def domain_tables(log_n: int, rate_bits: int, device):
    """(x, L_0(x), (x^n - 1)^-1) over the LDE coset, (M,) each, cached on
    the device."""
    key = (log_n, rate_bits, str(device))
    ent = _DOMAIN.get(key)
    if ent is None:
        ent = tuple(convert.from_u64(t, device) for t in (
            _lde_points_cached(log_n + rate_bits),
            _l0_lde(log_n, rate_bits), _zh_inv_lde(log_n, rate_bits)))
        _DOMAIN[key] = ent
    return ent


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------

def prove(data: CircuitData, pw: PartialWitness) -> Proof:
    """One proof: prove_batch on a batch of one."""
    return prove_batch(data, [pw])[0]


def _commit(ldes: torch.Tensor, zk: bool, cap_h: int):
    """(leaf matrix (B, k[+4], M), its B trees); zk leaves carry fresh
    salts."""
    leaf = ldes
    if zk:
        bsz, _, m = ldes.shape
        leaf = torch.cat([ldes, convert.from_u64(_salt_rows(m, bsz),
                                                 ldes.device)], dim=1)
    return leaf, BatchedMerkleTree.from_polys(leaf, cap_h)


def _challenge_major(per_proof, nc: int) -> list:
    return [[vals[c] for vals in per_proof] for c in range(nc)]


def prove_batch(data: CircuitData, pws: list[PartialWitness],
                on_step=None, mesh=None) -> list[Proof]:
    """Prove B same-circuit witnesses together. Every polynomial-sized pass
    (LDE NTTs, Merkle levels, constraint/quotient evaluation, openings,
    reduced codeword, FRI folds) carries a leading batch axis: one pass for
    the whole batch. Fiat-Shamir transcripts, challenges and FRI query
    sampling stay per proof, so the proofs equal ``prove``'s one at a time
    (bar zk randomness). Runs on the circuit's device (``build``'s).

    on_step(name), if given, is called as each step ends: "witness",
    "wires commit", "permutation pass", "Z commit", "quotient pass",
    "quotient commit", "openings", "reduced codeword", "FRI",
    "initial openings".

    With a ``parallel.mesh.make_mesh`` mesh (SPMD: every rank calls with
    the same witnesses and its own device's circuit data), each rank
    proves its contiguous slice of the batch on its device, and every rank
    returns all B proofs, in order (``_prove_sharded``)."""
    if mesh is not None:
        return _prove_sharded(data, pws, on_step, mesh)
    step = on_step or (lambda name: None)
    B = len(pws)
    common, pd, vd = data.common, data.prover, data.verifier
    dev = pd.device
    cfg = common.config
    n, log_n = common.n, common.log_n
    rate_bits = cfg.rate_bits
    nc = cfg.num_challenges
    npp = cfg.num_partial_products
    cap_h = min(cfg.fri.cap_height, log_n + rate_bits)
    zk = cfg.num_blinding_rows > 0

    # 1. witnesses (irregular: host loop)
    wires_list, pis_list, pi_hashes = [], [], []
    for pw in pws:
        w = generate_witness(data, pw)
        if zk:
            nb = cfg.num_blinding_rows
            if any(pd.rows[r] is not None for r in range(n - nb, n)):
                raise ValueError("zk blinding rows must be gate-less padding")
            w[:, n - nb:] = _blinding_rows(cfg.num_wires, nb)
        wires_list.append(w)
        pis = [pw.get(t) or 0 for t in pd.pi_targets]
        pis_list.append(pis)
        pi_hashes.append(public_inputs_hash(pis))
    wires = convert.from_u64(np.stack(wires_list), dev)     # (B, W, n)
    step("witness")

    # 2. wire commitment (batched LDE + batched trees; zk: salted leaves)
    wire_coeffs, wire_ldes = interp_and_lde(wires, log_n, rate_bits)
    wires_leaf, wires_tree = _commit(wire_ldes, zk, cap_h)
    wire_caps = [wires_tree.cap_u64(b) for b in range(B)]
    chs, betas_b, gammas_b = [], [], []
    for b in range(B):
        ch = Challenger()
        ch.observe_hash(list(vd.circuit_digest))
        ch.observe_cap(vd.constants_sigmas_cap)
        ch.observe_elements(pi_hashes[b])
        ch.observe_cap(wire_caps[b])
        betas_b.append(ch.get_n_challenges(nc))
        gammas_b.append(ch.get_n_challenges(nc))
        chs.append(ch)
    betas = _challenge_major(betas_b, nc)
    gammas = _challenge_major(gammas_b, nc)
    step("wires commit")

    # 3. permutation columns
    zs_pp = device_passes.perm_zs_pp(common, pd, wires, betas, gammas)
    del wires
    step("permutation pass")
    zs_pp_coeffs, zs_pp_ldes = interp_and_lde(zs_pp, log_n, rate_bits)
    del zs_pp
    zs_pp_leaf, zs_pp_tree = _commit(zs_pp_ldes, zk, cap_h)
    zs_pp_caps = [zs_pp_tree.cap_u64(b) for b in range(B)]
    alphas_b = []
    for b in range(B):
        chs[b].observe_cap(zs_pp_caps[b])
        alphas_b.append(chs[b].get_n_challenges(nc))
    alphas = _challenge_major(alphas_b, nc)
    step("Z commit")

    # 4. quotients
    q_coeffs = device_passes.quotient_coeffs(
        common, pd, wire_ldes, zs_pp_ldes, betas, gammas, alphas, pi_hashes)
    step("quotient pass")
    q_ldes = ntt.coset_lde(q_coeffs, log_n, rate_bits)      # (B, nc*8, M)
    q_leaf, q_tree = _commit(q_ldes, zk, cap_h)
    q_caps = [q_tree.cap_u64(b) for b in range(B)]
    zetas = []
    for b in range(B):
        chs[b].observe_cap(q_caps[b])
        zetas.append(chs[b].get_extension_challenge())
    step("quotient commit")

    # 5. openings at zeta / g*zeta, then each proof's alpha-power schedule
    # and reduced opening values (host-exact ints)
    cs_coeffs = pd.const_sigma_coeffs                    # (S, n)
    S = cs_coeffs.shape[0]
    W = cfg.num_wires
    ys_b = ext_eval_batch([cs_coeffs, wire_coeffs, zs_pp_coeffs, q_coeffs],
                          zetas)                         # (B, K, 2)
    g_n = gl64.h_primitive_root_of_unity(log_n)
    gzetas = [gl64_ext.h_mul(z, (g_n, 0)) for z in zetas]
    ys_next_b = ext_eval_batch([zs_pp_coeffs[:, :nc]], gzetas)
    n_polys = ys_b.shape[1]
    openings_list = []
    apows0 = np.empty((B, n_polys, 2), dtype=np.uint64)
    apows1 = np.empty((B, nc, 2), dtype=np.uint64)
    y0s = np.empty((B, 2), dtype=np.uint64)
    y1s = np.empty((B, 2), dtype=np.uint64)
    for b in range(B):
        ch = chs[b]
        ys = [tuple(v) for v in ys_b[b].tolist()]
        ys_next = [tuple(v) for v in ys_next_b[b].tolist()]
        openings = OpeningSet(
            constants_sigmas=ys[:S],
            wires=ys[S:S + W],
            zs=ys[S + W:S + W + nc],
            pps=ys[S + W + nc:S + W + nc + nc * npp],
            quotient=ys[S + W + nc + nc * npp:],
            zs_next=ys_next)
        openings_list.append(openings)
        for y in openings.flat():
            ch.observe_ext(y)
        fri_alpha = ch.get_extension_challenge()
        apow = (1, 0)
        y0 = (0, 0)
        for i in range(n_polys):
            apows0[b, i] = apow
            y0 = gl64_ext.h_add(y0, gl64_ext.h_mul(apow, ys[i]))
            apow = gl64_ext.h_mul(apow, fri_alpha)
        y1 = (0, 0)
        for c in range(nc):
            apows1[b, c] = apow
            y1 = gl64_ext.h_add(y1, gl64_ext.h_mul(apow, ys_next[c]))
            apow = gl64_ext.h_mul(apow, fri_alpha)
        y0s[b] = y0
        y1s[b] = y1
    step("openings")

    # 6. the reduced codeword, then ONE batched FRI (folds and layer trees
    # shared across the batch)
    csv = pd.const_sigma_ldes                            # (S, M)
    codewords = device_passes.reduced_codeword(
        common, [csv, wire_ldes, zs_pp_ldes, q_ldes], zs_pp_ldes[:, :nc],
        apows0, apows1, y0s, y1s, zetas, gzetas)
    step("reduced codeword")
    fri_proofs = fri.fri_prove_batch(codewords, log_n + rate_bits,
                                     gl64.MULTIPLICATIVE_GROUP_GENERATOR,
                                     cfg.fri, chs, device=dev)
    del codewords
    step("FRI")

    # 7. initial-tree openings at the FRI query indices: the query columns
    # gathered on the device, one copy to the host
    idx = torch.tensor([p.query_indices for p in fri_proofs],
                       dtype=torch.int64, device=dev)        # (B, Q)
    leaves = [wires_leaf, zs_pp_leaf, q_leaf]
    cols = torch.cat(
        [csv[:, idx].permute(1, 0, 2)] +
        [torch.gather(lf, 2, idx[:, None, :].expand(B, lf.shape[1], -1))
         for lf in leaves], dim=1)                           # (B, K', Q)
    cols = convert.to_u64(cols)
    widths = np.cumsum([0, S] + [lf.shape[1] for lf in leaves])
    proofs = []
    for b in range(B):
        fri_proof = fri_proofs[b]
        initial = []
        for qi, i in enumerate(fri_proof.query_indices):
            col = cols[b, :, qi].tolist()
            initial.append(InitialTreeOpening(
                values=[col[widths[t]:widths[t + 1]] for t in range(4)],
                paths=[pd.tree.prove(i)] +
                [tr.prove(b, i) for tr in (wires_tree, zs_pp_tree, q_tree)]))
        proofs.append(Proof(
            public_inputs=[int(v) for v in pis_list[b]],
            wires_cap=wire_caps[b], zs_pp_cap=zs_pp_caps[b],
            quotient_cap=q_caps[b], openings=openings_list[b],
            fri_proof=fri_proof, initial_openings=initial))
    step("initial openings")
    return proofs


def _prove_sharded(data: CircuitData, pws: list[PartialWitness], on_step,
                   mesh) -> list[Proof]:
    """The batch axis over the mesh: pure data parallelism, since each
    proof's transcript is its own, so the proofs equal the unsharded
    batch's. The slices' proofs are gathered through their plain form
    (one object all-gather)."""
    d = device_mesh.size(mesh)
    if len(pws) % d:
        raise ValueError(f"a batch of {len(pws)} does not divide the "
                         f"{d}-device mesh")
    if data.prover.device.type != mesh.device_type:
        raise ValueError(f"circuit data on {data.prover.device}, mesh over "
                         f"{mesh.device_type}")
    k = len(pws) // d
    r = device_mesh.rank(mesh)
    mine = prove_batch(data, pws[r * k:(r + 1) * k], on_step) if k else []
    parts = [None] * d
    dist.all_gather_object(parts, [convert.proof_to_plain(p) for p in mine],
                           group=device_mesh.group(mesh))
    return [convert.proof_from_plain(p) for part in parts for p in part]
