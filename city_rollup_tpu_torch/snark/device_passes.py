"""The prover's passes over the trace and LDE domains, as PyTorch on the
tensors' device.

Counterpart of the reference's ``snark/device_passes.py``:

  * the permutation-argument columns (Z and partial products, with the
    inverse and the cumulative product),
  * the constraint/quotient evaluation over the LDE domain (every gate's
    constraints under ``TorchAlg``, PoseidonGate's in its vectorized form),
    then the quotient's coset interpolation (kernels K1/K2 on a CUDA
    tensor), and
  * the FRI reduced-codeword combination (alpha-power matvec and the
    (x - zeta)^-1 extension division).

These are the port's only route, on the CPU in the tests and on the card
otherwise; the reference's numpy twins (``prover.compute_quotients`` and
the step-3 and step-6 loops of ``prove_batch``) are the tests' oracle.
Challenges arrive challenge-major: ``betas[c][b]`` is proof b's python int.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import gl64, gl64_ext, ntt
from .algebra import lift_torch

P = gl64.P


def _col(vals, like: torch.Tensor) -> torch.Tensor:
    """Per-proof python ints -> a (B, 1) int64 column on like's device."""
    return lift_torch(np.array([int(v) % P for v in vals], dtype=np.uint64),
                      like)


def _chunk_products(ratios: torch.Tensor, cs: int, nchunks: int
                    ) -> torch.Tensor:
    """(B, R, n) -> (B, nchunks, n): the product of each run of cs rows
    (the last run padded with ones)."""
    bsz, r, n = ratios.shape
    pad = nchunks * cs - r
    if pad:
        ratios = torch.cat([ratios, gl64.full((bsz, pad, n), 1,
                                              ratios.device)], dim=1)
    r4 = ratios.reshape(bsz, nchunks, cs, n)
    out = r4[:, :, 0]
    for i in range(1, cs):
        out = gl64.mul(out, r4[:, :, i])
    return out


def _cumprod(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative product mod p along the last axis
    (Hillis-Steele: log2 n passes of one multiply each)."""
    n = x.shape[-1]
    s = 1
    while s < n:
        x = torch.cat([x[..., :s], gl64.mul(x[..., s:], x[..., :-s])],
                      dim=-1)
        s <<= 1
    return x


def _perm_terms(cfg, k_is, wires, sigmas, x, beta, gamma):
    """Per-chunk numerator and denominator products of the permutation
    argument: (B, nchunks, D) each, over a domain of D points x."""
    R = cfg.num_routed_wires
    w = wires[:, :R]                                       # (B, R, D)
    k = lift_torch(np.array(k_is, dtype=np.uint64), w).reshape(1, R, 1)
    beta = beta.reshape(-1, 1, 1)
    gamma = gamma.reshape(-1, 1, 1)
    nums = gl64.add(gl64.add(w, gl64.mul(gl64.mul(beta, k), x)), gamma)
    dens = gl64.add(gl64.add(w, gl64.mul(sigmas, beta)), gamma)
    return nums, dens


# ---------------------------------------------------------------------------
# Permutation-argument columns (prover step 3)
# ---------------------------------------------------------------------------

def perm_zs_pp(common, prover_data, wires: torch.Tensor, betas, gammas
               ) -> torch.Tensor:
    """(B, W, n) wire values -> (B, nc*(1+npp), n) columns, challenge-major
    ([Z_c...] then [pp_{c,j}...])."""
    cfg = common.config
    cs, nchunks = cfg.perm_chunk_size, cfg.num_perm_chunks
    sigmas, x = prover_data.perm_tables                    # (R, n), (n,)
    bsz = wires.shape[0]
    zs, pps = [], []
    for c in range(cfg.num_challenges):
        nums, dens = _perm_terms(cfg, common.k_is, wires, sigmas, x,
                                 _col(betas[c], wires), _col(gammas[c], wires))
        cp = _chunk_products(gl64.mul(nums, gl64.inverse(dens)), cs, nchunks)
        row = cp[:, 0]
        for j in range(1, nchunks):
            row = gl64.mul(row, cp[:, j])
        cum = _cumprod(row)                                # (B, n)
        z = torch.cat([gl64.full((bsz, 1), 1, wires.device), cum[:, :-1]],
                      dim=1)
        zs.append(z)
        run = z
        for j in range(cfg.num_partial_products):
            run = gl64.mul(run, cp[:, j])
            pps.append(run)
    return torch.stack(zs + pps, dim=1)


# ---------------------------------------------------------------------------
# Constraint / quotient evaluation (prover step 4)
# ---------------------------------------------------------------------------

def _gate_terms(common, csv: torch.Tensor, wire_ldes: torch.Tensor,
                pi_hashes) -> torch.Tensor:
    """Every gate's filtered constraints over the LDE domain, in the
    canonical order: (num gate constraints, B, M). They depend on no
    challenge, so every challenge shares them."""
    cfg = common.config
    num_sel = common.num_sel_cols
    wires = list(wire_ldes.unbind(1))                      # W x (B, M)
    consts = [csv[num_sel + i] for i in range(cfg.num_constants)]
    pi = [_col([h[i] for h in pi_hashes], wire_ldes) for i in range(4)]
    out = []
    for gid, gate in enumerate(common.gates):
        sel = csv[common.gate_group(gid)]
        filt = None
        for t in common.filter_terms(gid):
            f = gl64.sub(sel, gl64.to_i64(t % P))
            filt = f if filt is None else gl64.mul(filt, f)
        cvals = torch.stack(gate.eval_torch_vec(wires, consts, pi))
        out.append(gl64.mul(cvals, filt))
    return torch.cat(out)


def _alpha_powers(alphas, k: int, like: torch.Tensor) -> torch.Tensor:
    """(k, B, 1): alpha_b^i for i < k, per proof b."""
    cols = []
    for a in alphas:
        pw, cur = [], 1
        for _ in range(k):
            pw.append(cur)
            cur = cur * a % P
        cols.append(pw)
    return lift_torch(np.array(cols, dtype=np.uint64).T.reshape(-1),
                      like).reshape(k, len(alphas), 1)


def quotient_coeffs(common, prover_data, wire_ldes: torch.Tensor,
                    zs_pp_ldes: torch.Tensor, betas, gammas, alphas,
                    pi_hashes) -> torch.Tensor:
    """Per challenge: the constraints combined with alpha powers, divided
    by Z_H, interpolated on the coset and split into quotient_chunks
    degree-n chunks. wire_ldes (B, W, M), zs_pp_ldes (B, nc*(1+npp), M);
    pi_hashes: per proof, 4 ints. Returns (B, nc*chunks, n)
    coefficients."""
    from .prover import domain_tables
    cfg = common.config
    R = cfg.num_routed_wires
    nc, npp = cfg.num_challenges, cfg.num_partial_products
    n = common.n
    log_m = common.log_n + cfg.rate_bits
    rate = 1 << cfg.rate_bits
    num_sel = common.num_sel_cols
    bsz = wire_ldes.shape[0]
    csv = prover_data.const_sigma_ldes                     # (S, M)
    sigmas = csv[num_sel + cfg.num_constants:num_sel + cfg.num_constants + R]
    x, l0, zh_inv = domain_tables(common.log_n, cfg.rate_bits,
                                  wire_ldes.device)
    gate_terms = _gate_terms(common, csv, wire_ldes, pi_hashes)
    qs = []
    for c in range(nc):
        z = zs_pp_ldes[:, c]                               # (B, M)
        pps = zs_pp_ldes[:, nc + c * npp:nc + (c + 1) * npp]
        z_next = torch.roll(z, -rate, dims=-1)
        nums, dens = _perm_terms(cfg, common.k_is, wire_ldes, sigmas, x,
                                 _col(betas[c], z), _col(gammas[c], z))
        num = _chunk_products(nums, cfg.perm_chunk_size, cfg.num_perm_chunks)
        den = _chunk_products(dens, cfg.perm_chunk_size, cfg.num_perm_chunks)
        prev = torch.cat([z[:, None], pps], dim=1)
        nxt = torch.cat([pps, z_next[:, None]], dim=1)
        chunk_terms = gl64.sub(gl64.mul(nxt, den), gl64.mul(prev, num))
        terms = torch.cat([gl64.mul(l0, gl64.sub(z, 1))[None],
                           chunk_terms.transpose(0, 1), gate_terms])
        acc = gl64.reduce_add(
            gl64.mul(terms, _alpha_powers(alphas[c], terms.shape[0], z)), 0)
        qs.append(gl64.mul(acc, zh_inv))
    cf = ntt.coset_intt(torch.stack(qs, dim=1), log_m)     # (B, nc, M)
    chunks = cfg.quotient_chunks
    return cf[..., :chunks * n].reshape(bsz, nc * chunks, n)


# ---------------------------------------------------------------------------
# FRI reduced-codeword combination (prover step 6)
# ---------------------------------------------------------------------------

def _ext_col(vals, like: torch.Tensor):
    """(B, 2) ext values -> a pair of (B, 1) columns."""
    v = np.asarray(vals, dtype=np.uint64).reshape(-1, 2)
    return lift_torch(v[:, 0], like), lift_torch(v[:, 1], like)


def _combine(blocks, apows: np.ndarray, like: torch.Tensor):
    """sum_i apow_i * row_i over the rows of the blocks, in order: an ext
    (B, M) pair. blocks: (B, k, M) tensors, or (k, M) shared by every
    proof; apows (B, sum k, 2) uint64."""
    a0 = a1 = None
    i = 0
    for blk in blocks:
        k = blk.shape[-2]
        c = torch.from_numpy(np.ascontiguousarray(
            apows[:, i:i + k]).view(np.int64)).to(like.device)
        i += k
        s0 = gl64.reduce_add(gl64.mul(blk, c[..., 0:1]), -2)
        s1 = gl64.reduce_add(gl64.mul(blk, c[..., 1:2]), -2)
        a0 = s0 if a0 is None else gl64.add(a0, s0)
        a1 = s1 if a1 is None else gl64.add(a1, s1)
    return a0, a1


def reduced_codeword(common, blocks, z_ldes: torch.Tensor, apows0, apows1,
                     y0s, y1s, zetas, gzetas):
    """F = (sum_i apow_i * lde_i - y0) / (x - zeta)
         + (sum_c apow'_c * Z_c - y1) / (x - g zeta).

    blocks: the opened polynomials' LDEs in opening order ((S, M) shared,
    then (B, k, M) each); z_ldes: (B, nc, M). apows0 (B, K, 2) and apows1
    (B, nc, 2) uint64 ext alpha powers; y0s/y1s/zetas/gzetas: (B, 2).
    Returns the (B, M) ext codeword pair."""
    from .prover import domain_tables
    cfg = common.config
    x = domain_tables(common.log_n, cfg.rate_bits, z_ldes.device)[0]
    xe = (x, torch.zeros_like(x))
    out = None
    for g, ys, pts in ((_combine(blocks, apows0, z_ldes), y0s, zetas),
                       (_combine([z_ldes], apows1, z_ldes), y1s, gzetas)):
        num = gl64_ext.sub(g, _ext_col(ys, z_ldes))
        inv = gl64_ext.inverse(gl64_ext.sub(xe, _ext_col(pts, z_ldes)))
        f = gl64_ext.mul(num, inv)
        out = f if out is None else gl64_ext.add(out, f)
    return out
