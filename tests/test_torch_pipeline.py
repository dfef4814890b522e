"""The port's lde_commit and lde_commit_streamed, held bit for bit against
the reference package's caps.

The reference's jnp Poseidon takes about 200 s of CPU for the 2^10 x 16
commit, so that cap is pinned as chip_smoke.GOLDEN_CAP and recomputed from
the reference only by the slow-marked test; the live comparisons with the
reference run at 2^4 (128 leaves)."""

import numpy as np
import pytest

import chip_smoke
from city_rollup_tpu import pipeline as jpipeline
from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import pallas_poseidon as pp
from city_rollup_tpu_torch import pipeline

P = jg.P


def _coeffs(batch, log_n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(batch, 1 << log_n), dtype=np.uint64)


def _ref_cap(fn, vals, **kw):
    lo, hi = jg.from_u64(vals)
    cap = fn(lo, hi, **kw)
    return jg.to_u64(np.asarray(cap[0]), np.asarray(cap[1]))


def _port_cap(fn, vals, **kw):
    from city_rollup_tpu_torch import convert
    return convert.to_u64(fn(vals, device="cpu", **kw))


def _golden_input():
    return np.random.default_rng(7).integers(0, P, size=(16, 1 << 10),
                                             dtype=np.uint64)


@pytest.mark.parametrize("fn", [pipeline.lde_commit,
                                pipeline.lde_commit_streamed])
def test_golden_cap_2_10_x_16(fn):
    got = _port_cap(fn, _golden_input(), log_n=10, rate_bits=3, cap_height=4)
    np.testing.assert_array_equal(
        got, np.array(chip_smoke.GOLDEN_CAP, dtype=np.uint64))


@pytest.mark.slow
def test_golden_cap_is_the_references():
    want = _ref_cap(jpipeline.jit_lde_commit(10, 3, 4), _golden_input())
    np.testing.assert_array_equal(
        np.array(chip_smoke.GOLDEN_CAP, dtype=np.uint64), want)


@pytest.mark.parametrize("batch", [4, 8, 16])
def test_lde_commit_matches_reference(batch):
    """B <= 4 passes leaves through (hash_or_noop); B > 4 hashes them."""
    vals = _coeffs(batch, 4, seed=batch)
    kw = dict(log_n=4, rate_bits=3, cap_height=5)
    want = _ref_cap(jpipeline.lde_commit, vals, **kw)
    np.testing.assert_array_equal(_port_cap(pipeline.lde_commit, vals, **kw),
                                  want)
    if batch % 8 == 0:
        np.testing.assert_array_equal(
            _port_cap(pipeline.lde_commit_streamed, vals, **kw), want)


def test_streamed_matches_reference(monkeypatch):
    """The reference's streamed commit runs its Pallas absorb kernel (here in
    interpreter mode); 4-poly slabs hash the 4 values, unlike one-shot."""
    monkeypatch.setenv("CITY_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pp, "B_TILE", 128)
    pp.absorb_t._clear_cache()
    try:
        vals = _coeffs(4, 4, seed=41)
        kw = dict(log_n=4, rate_bits=3, cap_height=5, chunk=4)
        want = _ref_cap(jpipeline.lde_commit_streamed, vals, **kw)
    finally:
        pp.absorb_t._clear_cache()
    np.testing.assert_array_equal(
        _port_cap(pipeline.lde_commit_streamed, vals, **kw), want)


def test_streamed_rejects_ragged_slabs():
    with pytest.raises(ValueError):
        pipeline.lde_commit_streamed(_coeffs(6, 3, seed=0), log_n=3,
                                     rate_bits=1, cap_height=0,
                                     device="cpu")
