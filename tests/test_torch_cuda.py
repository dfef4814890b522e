"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch:

    CITY_TPU_TESTS=1 python -m pytest -m cuda tests/test_torch_cuda.py -q

(CITY_TPU_TESTS=1 keeps tests/conftest.py from configuring JAX.)
"""

import numpy as np
import pytest
import torch

from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import cuda_ntt as cn
from city_rollup_tpu_torch.core import cuda_poseidon as cp
from city_rollup_tpu_torch.core import fri, gl64
from city_rollup_tpu_torch.core import ntt as tn
from city_rollup_tpu_torch.core import poseidon as tposeidon
from city_rollup_tpu_torch.core.challenger import Challenger

P = gl64.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _cols(n, b, seed):
    """(n, b) uint64: random columns, then edge-valued columns and rows
    (as many as fit)."""
    x = _rand((n, b), seed)
    for j, v in enumerate(EDGE[:b]):
        x[:, j] = v
        if j < n:
            x[j, len(EDGE):len(EDGE) + 8] = v
    return x


@pytest.mark.parametrize("log_n,batch,log_in", [(6, 5, 6), (22, 2, 19),
                                                (25, 1, 22), (5, 3, 2)])
def test_block_kernels_match_plain(cuda, log_n, batch, log_in):
    """K1 (with and without the coset's pre-scaling, its input the first
    2^log_in values of each row) and K2 (forward, and inverse with its
    output scaling) against their plain versions, with edge values."""
    log_n2 = cn._split(log_n)
    x = convert.from_u64(_cols(batch, 1 << log_in, seed=log_n), cuda)
    pre = tn._coset_table(log_in, 7, cuda)
    for p in (pre, None):
        got = cn._k1(x, log_n, log_n2, p)
        torch.cuda.synchronize()
        assert torch.equal(got, cn._k1_plain(x, log_n, log_n2, p))
    y = convert.from_u64(_cols(batch, 1 << log_n, seed=log_n + 1), cuda)
    scale = cn._table("oscale", cn._out_scale, log_n, 7, device=cuda)
    for reverse, sc in ((False, None), (True, scale)):
        got = cn._k2(y, log_n, log_n2, 0, reverse, sc)
        torch.cuda.synchronize()
        assert torch.equal(got, cn._k2_plain(y, log_n, log_n2, 0, reverse,
                                             sc))


def test_tail_kernel_matches_plain(cuda):
    x = convert.from_u64(_rand((6, 1 << 13), seed=5), cuda)
    tt = cn._stage_table(13, cuda)
    for s in (0, 12):
        got = cn._tail_stage(x, s, 13, tt)
        torch.cuda.synchronize()
        assert torch.equal(got, cn._tail_stage_plain(x, s, 13, tt))


def test_fourstep_kernels_match_radix2(cuda, monkeypatch):
    vals = _rand((3, 1 << 14), seed=14)
    x = convert.from_u64(vals, cuda)
    want = tn._ntt_core(x, tn._root_table(14, False, cuda), 14)
    assert torch.equal(tn.ntt(x, 14), want)
    np.testing.assert_array_equal(convert.to_u64(tn.intt(want, 14)), vals)
    monkeypatch.setattr(cn, "MAX_KERNEL_LOG", 5)     # 4 tail stages
    before = cn.LAUNCHES["ntt_tail_stage"]
    assert torch.equal(tn.ntt(x, 14), want)
    assert cn.LAUNCHES["ntt_tail_stage"] == before + 4
    c = convert.from_u64(_cols(2, 1 << 11, seed=11), cuda)
    padded = tn._coset_scale_pad(c, 11, 3, 7)
    assert torch.equal(tn.coset_lde(c, 11, 3),
                       tn._ntt_core(padded, tn._root_table(14, False, cuda),
                                    14))


@pytest.mark.parametrize("n", [3, 8, 10, 64, 14, 16, 20, 37, 144, 148])
def test_sponge_kernel_matches_plain(cuda, n):
    x = convert.from_u64(_cols(n, 1 << 14, seed=n), cuda)
    got = cp.sponge_t(x)
    torch.cuda.synchronize()
    assert torch.equal(got, cp.sponge_t_plain(x))


@pytest.mark.parametrize("width", [2, 1 << 14])
def test_merkle_level_kernel_matches_plain(cuda, width):
    """K4's Merkle-level entry reads the children in place; its launches
    count under poseidon_sponge."""
    x = convert.from_u64(_cols(4, width, seed=width) if width > 8
                         else _rand((4, width), width), cuda)
    before = cp.LAUNCHES["poseidon_sponge"]
    got = cp.reduce_level_t(x)
    torch.cuda.synchronize()
    assert cp.LAUNCHES["poseidon_sponge"] == before + 1
    assert torch.equal(got, cp.reduce_level_t_plain(x))
    assert torch.equal(got, cp.two_to_one_t(x[:, 0::2], x[:, 1::2]))


@pytest.mark.parametrize("k", [3, 8])
def test_absorb_kernel_matches_plain(cuda, k):
    state = convert.from_u64(_cols(12, 1 << 14, seed=k), cuda)
    chunk = convert.from_u64(_cols(k, 1 << 14, seed=k + 1), cuda)
    got = cp.absorb_t(state, chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, cp.absorb_t_plain(state, chunk))


@pytest.mark.parametrize("b", [5, 1 << 14])
def test_permute_kernel_matches_plain(cuda, b):
    s = convert.from_u64(_cols(12, b, seed=b) if b > 8 else _rand((12, b), b),
                         cuda)
    before = cp.LAUNCHES["poseidon_permute"]
    got = cp.permute_t(s)
    torch.cuda.synchronize()
    assert cp.LAUNCHES["poseidon_permute"] == before + 1
    assert torch.equal(got, cp.permute_t_plain(s))
    # the (..., 12) entry point transposes to (12, B) and launches K3 too
    assert torch.equal(tposeidon.permute(s.T), got.T)
    assert cp.LAUNCHES["poseidon_permute"] == before + 2


def test_fri_golden_proof_on_card(cuda):
    import chip_smoke
    cw = tuple(tn.coset_lde(convert.from_u64(c, cuda), 5, 3)
               for c in chip_smoke.golden_fri_coeffs())
    cfg = fri.FriConfig(**chip_smoke.GOLDEN_FRI_CONFIG)
    before = cp.LAUNCHES["poseidon_permute"]
    proof = fri.fri_prove(cw, 8, 7, cfg, Challenger())
    assert cp.LAUNCHES["poseidon_permute"] > before
    assert chip_smoke.golden_fri_differences(proof) == []
    assert fri.fri_verify(proof, 8, 7, cfg, Challenger())


def _snark_case(device, zk=False):
    """chip_smoke's Merkle-path circuit (2 paths of height 3) under its
    FAST configuration, built for `device`, and two witnesses."""
    import chip_smoke
    from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
    b = CircuitBuilder(chip_smoke.fast_config(CircuitConfig, fri.FriConfig,
                                              zk=zk))
    paths = chip_smoke.merkle_paths_circuit(b, 2, height=3)
    return b.build(device=device), [
        chip_smoke.merkle_paths_witness(b, paths, seed) for seed in (1, 2)]


def test_snark_golden_proof_on_card(cuda):
    import chip_smoke
    from city_rollup_tpu_torch.snark import (CircuitBuilder, CircuitConfig,
                                             prover, verifier)
    b = CircuitBuilder(chip_smoke.fast_config(CircuitConfig, fri.FriConfig))
    x = chip_smoke.tiny_circuit(b)
    data = b.build()
    pw = b.partial_witness()
    pw.set(x, 3)
    before = {**cn.LAUNCHES, **cp.LAUNCHES}
    proof = prover.prove(data, pw)
    after = {**cn.LAUNCHES, **cp.LAUNCHES}
    assert all(after[k] > before[k] for k in
               ("ntt_fourstep_tw", "ntt_block", "poseidon_sponge"))
    assert chip_smoke.proof_digest(convert.proof_to_plain(proof)) == \
        chip_smoke.GOLDEN_PROOF
    assert verifier.verify(proof, data.common, data.verifier)


def test_snark_prove_batch_on_card_equals_cpu(cuda):
    """The card's batch of two equals the CPU's proofs one at a time, and
    a zk proof made on the card verifies."""
    from city_rollup_tpu_torch.snark import prover, verifier
    data, pws = _snark_case(None)
    cpu_data, cpu_pws = _snark_case("cpu")
    batch = prover.prove_batch(data, pws)
    for got, pw in zip(batch, cpu_pws):
        assert convert.proof_to_plain(got) == \
            convert.proof_to_plain(prover.prove(cpu_data, pw))
        assert verifier.verify(got, data.common, data.verifier)
    zk_data, zk_pws = _snark_case(None, zk=True)
    assert verifier.verify(prover.prove(zk_data, zk_pws[0]), zk_data.common,
                           zk_data.verifier)
