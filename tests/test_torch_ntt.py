"""The port's NTT, held bit for bit against the reference: the plain radix-2
path and the four-step path (run here with the kernels' plain versions)
against the jnp path, and the block and tail stages against
pallas_ntt._small_ntt / _tail_stage in interpreter mode. The kernels
themselves are held against their plain versions on the card in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import ntt as jntt
from city_rollup_tpu.core import pallas_ntt as pn
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import cuda_ntt as cn
from city_rollup_tpu_torch.core import ntt as tn


def _clear():
    pn._fourstep_jit._clear_cache()
    pn._scale_const_jit._clear_cache()
    pn._coset_scale_pad_jit._clear_cache()
    pn._mul_table_jit._clear_cache()


@pytest.fixture
def interpret(monkeypatch):
    """Run the reference's Pallas kernels as its own tests do."""
    monkeypatch.setenv("CITY_PALLAS_INTERPRET", "1")
    _clear()
    yield
    _clear()


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jg.P, size=shape, dtype=np.uint64)


def _ref(fn, vals, *args):
    """A reference core/ntt.py entry point on the jnp path."""
    out = fn(jg.from_u64(vals), *args)
    return jg.to_u64(np.asarray(out[0]), np.asarray(out[1]))


def _port(fn, vals, *args):
    return convert.to_u64(fn(convert.from_u64(vals, "cpu"), *args))


@pytest.mark.parametrize("mod", [tn, cn], ids=["radix2", "fourstep"])
@pytest.mark.parametrize("name,log_n,shape", [
    ("ntt", 10, (3,)), ("ntt", 13, (2,)), ("ntt", 12, (2, 3)),
    ("intt", 11, (2,)), ("coset_intt", 12, (1,))])
def test_transform_matches_jnp(mod, name, log_n, shape):
    vals = _rand(shape + (1 << log_n,), seed=log_n)
    np.testing.assert_array_equal(_port(getattr(mod, name), vals, log_n),
                                  _ref(getattr(jntt, name), vals, log_n))


@pytest.mark.parametrize("mod", [tn, cn], ids=["radix2", "fourstep"])
def test_coset_lde_matches_jnp(mod):
    log_n, rate = 9, 3
    vals = _rand((2, 1 << log_n), seed=7)
    np.testing.assert_array_equal(
        _port(mod.coset_lde, vals, log_n, rate),
        _ref(jntt.coset_lde, vals, log_n, rate))


def test_ntt_matches_naive():
    log_n = 5
    vals = _rand((2, 1 << log_n), seed=1)
    want = np.array([jntt.h_ntt([int(v) for v in row], log_n)
                     for row in vals], dtype=np.uint64)
    np.testing.assert_array_equal(_port(cn.ntt, vals, log_n), want)
    np.testing.assert_array_equal(_port(tn.ntt, vals, log_n), want)


def test_intt_round_trip():
    vals = _rand((2, 1 << 12), seed=99)
    x = convert.from_u64(vals, "cpu")
    np.testing.assert_array_equal(
        convert.to_u64(cn.intt(cn.ntt(x, 12), 12)), vals)


def test_tail_stages_beyond_kernel_block(monkeypatch):
    """Transforms longer than MAX_KERNEL_LOG split into per-block stages
    plus tail stages; a tiny cap reaches that path at a small size."""
    monkeypatch.setattr(cn, "MAX_KERNEL_LOG", 3)
    log_n = 9          # split: log_n2=3 (block), log_n1=6 -> 3 tail stages
    vals = _rand((2, 1 << log_n), seed=11)
    np.testing.assert_array_equal(_port(cn.ntt, vals, log_n),
                                  _ref(jntt.ntt, vals, log_n))


def _col(arr):
    lo, hi = jg.from_u64(arr)
    return lo.reshape(-1, 1), hi.reshape(-1, 1)


@pytest.mark.parametrize("with_g", [True, False])
def test_small_ntt_matches_pallas(interpret, with_g):
    """The block stages (K1 with g, K2 without) against the reference's
    kernel in interpreter mode. The reference takes (m, L) with one
    transform per column; the port takes (L, m), one per row."""
    log_m, lanes = 5, 96
    vals = _rand((1 << log_m, lanes), seed=20 + with_g)
    tw = cn._stage_twiddle_cols(log_m, False)
    twl, twh = _col(tw)
    g_vals = _rand((lanes,), seed=30) if with_g else None
    g_ref = None
    if with_g:
        glo, ghi = jg.from_u64(g_vals)
        g_ref = (glo.reshape(1, -1), ghi.reshape(1, -1))
    lo, hi = jg.from_u64(vals)
    out = pn._small_ntt(lo, hi, twl, twh, g_ref, log_m)
    want = jg.to_u64(np.asarray(out[0]), np.asarray(out[1]))
    got = cn._small_ntt(
        convert.from_u64(vals.T.copy(), "cpu"), convert.from_u64(tw, "cpu"),
        None if g_vals is None else convert.from_u64(g_vals, "cpu"), log_m)
    np.testing.assert_array_equal(convert.to_u64(got).T, want)


@pytest.mark.parametrize("s", [3, 4])
def test_tail_stage_matches_reference(s):
    log_m, lanes = 5, 6
    vals = _rand((1 << log_m, lanes), seed=40 + s)
    tt = cn._stage_twiddle_cols(log_m, False)
    ttl, tth = _col(tt)
    lo, hi = jg.from_u64(vals)
    out = pn._tail_stage(lo, hi, s, log_m, ttl, tth)
    want = jg.to_u64(np.asarray(out[0]), np.asarray(out[1]))
    got = cn._tail_stage(convert.from_u64(vals.T.copy(), "cpu"), s, log_m,
                         convert.from_u64(tt, "cpu"))
    np.testing.assert_array_equal(convert.to_u64(got).T, want)


def test_wrappers_reject_bad_shapes():
    x = torch.zeros(4, 16, dtype=torch.int64)
    tw = convert.from_u64(cn._stage_twiddle_cols(4, False), "cpu")
    with pytest.raises(ValueError):
        cn._block_stages(x, tw, torch.zeros(3, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        cn._tail_stage(x, 4, 4, tw)
    with pytest.raises(ValueError):
        tn.ntt(x, 3)
