"""The port's prover passes (snark/device_passes.py, and the openings'
evaluation in snark/prover.py) against the reference's numpy twins on the
same inputs, with B = 2 and two challenges: the permutation columns
against the step-3 loop (as tests/test_device_passes.py replicates it),
the quotient against prover.compute_quotients, the reduced codeword
against the step-6 loop of prove_batch. Exact."""

import numpy as np
import pytest

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import gl64_ext as jext
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import prover as jprover
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import device_passes, prover

P = jg.P
B = 2
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]


def _build(builder_cls, config_cls, fri_cls):
    cfg = config_cls.poseidon_config(
        num_challenges=2, fri=fri_cls(**chip_smoke.FAST_FRI))
    b = builder_cls(cfg)
    paths = chip_smoke.merkle_paths_circuit(b, 1, height=2)
    return b, paths


@pytest.fixture(scope="module")
def case():
    """The reference's and the port's data for one circuit (the port's on
    the CPU), two witnesses, and seeded random challenges."""
    jb, jpaths = _build(JBuilder, JConfig, jfri.FriConfig)
    tb, tpaths = _build(CircuitBuilder, CircuitConfig, fri.FriConfig)
    jd, td = jb.build(), tb.build(device="cpu")
    wires = np.stack([
        jcircuit.generate_witness(
            jd, chip_smoke.merkle_paths_witness(jb, jpaths, seed=s))
        for s in (1, 2)])
    rng = np.random.default_rng(11)
    nc = jd.common.config.num_challenges
    chal = {k: [rng.integers(1, P, size=B, dtype=np.uint64)
                for _ in range(nc)] for k in ("beta", "gamma", "alpha")}
    chal["alpha"][0][0] = P - 1
    return jd, td, wires, chal


def _ints(cols):
    return [[int(v) for v in col] for col in cols]


def test_domain_tables_match_reference():
    for log_n, rate_bits in ((3, 3), (5, 2)):
        np.testing.assert_array_equal(
            prover._lde_points_cached(log_n + rate_bits),
            jprover._lde_points_cached(log_n + rate_bits))
        np.testing.assert_array_equal(prover._zh_inv_lde(log_n, rate_bits),
                                      jprover._zh_inv_lde(log_n, rate_bits))
        np.testing.assert_array_equal(prover._l0_lde(log_n, rate_bits),
                                      jprover._l0_lde(log_n, rate_bits))
        x, l0, zh = prover.domain_tables(log_n, rate_bits, "cpu")
        np.testing.assert_array_equal(convert.to_u64(l0),
                                      jprover._l0_lde(log_n, rate_bits))


def test_perm_pass_matches_numpy_loop(case):
    jd, td, wires_b, chal = case
    common, pd = jd.common, jd.prover
    cfg = common.config
    n = common.n
    got = device_passes.perm_zs_pp(td.common, td.prover,
                                   convert.from_u64(wires_b, "cpu"),
                                   _ints(chal["beta"]), _ints(chal["gamma"]))
    # the numpy twin: prove_batch's step-3 loop, as test_device_passes.py
    # replicates it
    betas, gammas = chal["beta"], chal["gamma"]
    R = cfg.num_routed_wires
    x = pd.subgroup
    k_is = common.k_is
    sigmas = pd.sigmas
    zs_rows, pp_rows = [], []
    for c in range(cfg.num_challenges):
        beta = betas[c].reshape(B, 1)
        gamma = gammas[c].reshape(B, 1)
        ratios = np.empty((R, B, n), dtype=np.uint64)
        for i in range(R):
            bkx = jg.np_mul(x, jg.np_mul(beta, np.uint64(k_is[i])))
            nums = jg.np_add(jg.np_add(wires_b[:, i, :], bkx), gamma)
            bs = jg.np_mul(sigmas[i], beta)
            dens = jg.np_add(jg.np_add(wires_b[:, i, :], bs), gamma)
            ratios[i] = jg.np_mul(nums, jg.np_inverse(dens))
        cs = cfg.perm_chunk_size
        chunk_prod = []
        for j in range(cfg.num_perm_chunks):
            blk = ratios[j * cs:(j + 1) * cs]
            pr = blk[0]
            for rrow in blk[1:]:
                pr = jg.np_mul(pr, rrow)
            chunk_prod.append(pr)
        row_prod = chunk_prod[0]
        for cp in chunk_prod[1:]:
            row_prod = jg.np_mul(row_prod, cp)
        cum = jprover.np_cumprod_mod(row_prod)
        z = np.concatenate(
            [np.ones((B, 1), dtype=np.uint64), cum[:, :-1]], axis=1)
        zs_rows.append(z)
        run = z
        for j in range(cfg.num_partial_products):
            run = jg.np_mul(run, chunk_prod[j])
            pp_rows.append(run)
    want = np.stack(zs_rows + pp_rows, axis=1)
    assert got.shape == want.shape == (B, 2 * (1 + 4), n)
    np.testing.assert_array_equal(convert.to_u64(got), want)


def _random_ldes(common, seed):
    cfg = common.config
    M = common.n << cfg.rate_bits
    rng = np.random.default_rng(seed)
    nzp = cfg.num_challenges * (1 + cfg.num_partial_products)
    wl = rng.integers(0, P, size=(B, cfg.num_wires, M), dtype=np.uint64)
    wl[0, :len(EDGE), 0] = EDGE
    zl = rng.integers(0, P, size=(B, nzp, M), dtype=np.uint64)
    return wl, zl


def test_quotient_pass_matches_compute_quotients(case):
    jd, td, _, chal = case
    common = jd.common
    cfg = common.config
    nc, npp = cfg.num_challenges, cfg.num_partial_products
    R, num_sel = cfg.num_routed_wires, common.num_sel_cols
    wl, zl = _random_ldes(common, seed=4)
    csv = convert.to_u64(td.prover.const_sigma_ldes)
    pi_hashes = [[int(v) for v in np.random.default_rng(b).integers(
        0, P, size=4, dtype=np.uint64)] for b in range(B)]
    got = device_passes.quotient_coeffs(
        td.common, td.prover, convert.from_u64(wl, "cpu"),
        convert.from_u64(zl, "cpu"), _ints(chal["beta"]),
        _ints(chal["gamma"]), _ints(chal["alpha"]), pi_hashes)
    ldes = {
        "selectors": [csv[i] for i in range(num_sel)],
        "constants": [csv[num_sel + i] for i in range(cfg.num_constants)],
        "sigmas": [csv[num_sel + cfg.num_constants + i] for i in range(R)],
        "wires": [wl[:, i, :] for i in range(cfg.num_wires)],
        "zs": [zl[:, c, :] for c in range(nc)],
        "pps": [zl[:, nc + c * npp: nc + (c + 1) * npp, :]
                .transpose(1, 0, 2) for c in range(nc)],
    }
    pi_cols = [np.array([h[i] for h in pi_hashes], dtype=np.uint64)
               .reshape(B, 1) for i in range(4)]
    want = jprover.compute_quotients(common, ldes, chal["beta"],
                                     chal["gamma"], chal["alpha"], pi_cols)
    assert got.shape == want.shape == (B, nc * 8, common.n)
    np.testing.assert_array_equal(convert.to_u64(got), want)


def test_reduced_codeword_matches_numpy_loop(case):
    jd, td, _, _ = case
    common = jd.common
    cfg = common.config
    nc = cfg.num_challenges
    M = common.n << cfg.rate_bits
    wl, zl = _random_ldes(common, seed=6)
    csv = convert.to_u64(td.prover.const_sigma_ldes)
    rng = np.random.default_rng(8)
    ql = rng.integers(0, P, size=(B, nc * 8, M), dtype=np.uint64)
    all_ldes_b = np.concatenate(
        [np.broadcast_to(csv, (B,) + csv.shape), wl, zl, ql], axis=1)
    n_polys = all_ldes_b.shape[1]
    apows0 = rng.integers(0, P, size=(B, n_polys, 2), dtype=np.uint64)
    apows1 = rng.integers(0, P, size=(B, nc, 2), dtype=np.uint64)
    y0s = rng.integers(0, P, size=(B, 2), dtype=np.uint64)
    y1s = rng.integers(0, P, size=(B, 2), dtype=np.uint64)
    zetas = [tuple(int(v) for v in rng.integers(0, P, size=2,
                                                dtype=np.uint64))
             for _ in range(B)]
    zetas[1] = (P - 1, 1 << 32)
    g_n = jg.h_primitive_root_of_unity(common.log_n)
    gzetas = [jext.h_mul(z, (g_n, 0)) for z in zetas]
    t = {k: convert.from_u64(v, "cpu") for k, v in
         (("csv", csv), ("w", wl), ("z", zl), ("q", ql))}
    got = device_passes.reduced_codeword(
        td.common, [t["csv"], t["w"], t["z"], t["q"]], t["z"][:, :nc],
        apows0, apows1, y0s, y1s, zetas, gzetas)
    # the numpy twin: prove_batch's step-6 loop (the non-device branch)
    xs = jprover._lde_points_cached(common.log_n + cfg.rate_bits)
    for b in range(B):
        zeta, gzeta = zetas[b], gzetas[b]
        y0, y1 = (int(y0s[b, 0]), int(y0s[b, 1])), (int(y1s[b, 0]),
                                                    int(y1s[b, 1]))
        all_ldes = all_ldes_b[b]
        G0 = (np.zeros(M, dtype=np.uint64), np.zeros(M, dtype=np.uint64))
        for i in range(n_polys):
            G0 = jext.np_ext_add(G0, jext.np_ext_scale(
                (all_ldes[i], np.zeros_like(all_ldes[i])),
                tuple(int(v) for v in apows0[b, i])))
        inv0 = jext.np_ext_inverse(jext.np_ext_sub(
            (xs, np.zeros_like(xs)),
            (np.full(M, zeta[0], dtype=np.uint64),
             np.full(M, zeta[1], dtype=np.uint64))))
        num0 = jext.np_ext_sub(G0, (np.full(M, y0[0], dtype=np.uint64),
                                    np.full(M, y0[1], dtype=np.uint64)))
        F = jext.np_ext_mul(num0, inv0)
        G1 = (np.zeros(M, dtype=np.uint64), np.zeros(M, dtype=np.uint64))
        for c in range(nc):
            zlde = zl[b, c, :]
            G1 = jext.np_ext_add(G1, jext.np_ext_scale(
                (zlde, np.zeros_like(zlde)),
                tuple(int(v) for v in apows1[b, c])))
        inv1 = jext.np_ext_inverse(jext.np_ext_sub(
            (xs, np.zeros_like(xs)),
            (np.full(M, gzeta[0], dtype=np.uint64),
             np.full(M, gzeta[1], dtype=np.uint64))))
        num1 = jext.np_ext_sub(G1, (np.full(M, y1[0], dtype=np.uint64),
                                    np.full(M, y1[1], dtype=np.uint64)))
        F = jext.np_ext_add(F, jext.np_ext_mul(num1, inv1))
        np.testing.assert_array_equal(convert.to_u64(got[0][b]), F[0])
        np.testing.assert_array_equal(convert.to_u64(got[1][b]), F[1])


def test_openings_match_ext_horner():
    rng = np.random.default_rng(12)
    shared = rng.integers(0, P, size=(3, 16), dtype=np.uint64)
    per = rng.integers(0, P, size=(B, 5, 16), dtype=np.uint64)
    per[0, 0, :len(EDGE)] = EDGE
    points = [(P - 1, 1 << 32), (12345, 0)]
    got = prover.ext_eval_batch([convert.from_u64(shared, "cpu"),
                                 convert.from_u64(per, "cpu")], points)
    want = jprover.np_ext_horner_batch(
        np.concatenate([np.broadcast_to(shared, (B, 3, 16)), per], axis=1),
        points)
    np.testing.assert_array_equal(got, want)
    assert [tuple(map(int, v)) for v in got[1, 3:]] == \
        jprover.np_ext_horner(per[1], points[1])
