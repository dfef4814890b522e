"""The port's gl64 ops added for FRI (neg, mul_small, inverse, select, eq,
is_zero, zeros, full) and its GF(p^2) ops and host twins, held bit for bit
against the reference's jnp functions and python-int ground truth on random
and edge inputs."""

import numpy as np
import pytest
import jax

from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import gl64_ext as jext
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import gl64 as tg
from city_rollup_tpu_torch.core import gl64_ext as text

P = jg.P
EDGE = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        1 << 63, (1 << 63) - 1, P - (1 << 32), P - 0xFFFFFFFF]


def _values(n, seed):
    """n uint64: the edge values, then random canonical values."""
    x = np.random.default_rng(seed).integers(0, P, size=n, dtype=np.uint64)
    x[:len(EDGE)] = EDGE
    return x


def _pairs(n, seed):
    """Every pair of edge values, then random pairs."""
    a, b = _values(n, seed), _values(n, seed + 1)
    e = np.array(EDGE, dtype=np.uint64)
    k = len(e)
    a[:k * k] = np.repeat(e, k)
    b[:k * k] = np.tile(e, k)
    return a, b


def _t(x):
    return convert.from_u64(x, "cpu")


def _jax_base(fn, *args):
    out = jax.jit(fn)(*[jg.from_u64(x) for x in args])
    return jg.to_u64(np.asarray(out[0]), np.asarray(out[1]))


def _ext(seed, n=256):
    """(a0, a1) numpy uint64: edge pairs in the first rows, then random."""
    return _pairs(n, seed)


def _jax_ext(fn, *args):
    out = jax.jit(fn)(*[(jg.from_u64(a[0]), jg.from_u64(a[1]))
                        for a in args])
    return tuple(jg.to_u64(np.asarray(c[0]), np.asarray(c[1])) for c in out)


def _port_ext(fn, *args):
    out = fn(*[(_t(a[0]), _t(a[1])) for a in args])
    return tuple(convert.to_u64(c) for c in out)


# ---------------------------------------------------------------------------
# gl64: the ops FRI needs
# ---------------------------------------------------------------------------

def test_neg_matches_reference():
    a = _values(512, seed=0)
    got = convert.to_u64(tg.neg(_t(a)))
    np.testing.assert_array_equal(got, _jax_base(jg.neg, a))
    np.testing.assert_array_equal(
        got, np.array([(-int(x)) % P for x in a], dtype=np.uint64))


@pytest.mark.parametrize("k", [0, 1, 7, 17, (1 << 20) - 1])
def test_mul_small_matches_reference(k):
    a = _values(512, seed=k % 97)
    got = convert.to_u64(tg.mul_small(_t(a), k))
    np.testing.assert_array_equal(
        got, _jax_base(lambda x: jg.mul_small(x, k), a))
    np.testing.assert_array_equal(
        got, np.array([int(x) * k % P for x in a], dtype=np.uint64))


def test_mul_small_rejects_large_constants():
    with pytest.raises(ValueError):
        tg.mul_small(_t(_values(4, seed=0)), 1 << 20)


def test_inverse_matches_reference():
    a = _values(64, seed=3)
    got = convert.to_u64(tg.inverse(_t(a)))
    np.testing.assert_array_equal(got, _jax_base(jg.inverse, a))
    np.testing.assert_array_equal(
        got, np.array([pow(int(x), P - 2, P) for x in a], dtype=np.uint64))
    np.testing.assert_array_equal(got, tg.np_inverse(a))


def test_select_eq_is_zero_zeros_full():
    a, b = _pairs(256, seed=5)
    ta, tb = _t(a), _t(b)
    mask = tg.eq(ta, tb)
    want_mask = np.asarray(jax.jit(jg.eq)(jg.from_u64(a), jg.from_u64(b)))
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(tg.is_zero(ta).numpy(),
                                  np.asarray(jg.is_zero(jg.from_u64(a))))
    np.testing.assert_array_equal(
        convert.to_u64(tg.select(mask, ta, tb)),
        _jax_base(lambda x, y: jg.select(jg.eq(x, y), x, y), a, b))
    z = tg.zeros((3, 5), "cpu")
    assert z.shape == (3, 5) and not z.any()
    for v in (0, 1, P - 1, P, P + 5, 1 << 63):
        np.testing.assert_array_equal(
            convert.to_u64(tg.full((4,), v, "cpu")),
            jg.to_u64(*map(np.asarray, jg.full((4,), v))))


# ---------------------------------------------------------------------------
# gl64_ext: device ops against the reference's jnp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_ext_binary_ops_match_reference(name):
    a, b = _ext(seed=10), _ext(seed=20)
    got = _port_ext(getattr(text, name), a, b)
    want = _jax_ext(getattr(jext, name), a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    h = getattr(jext, f"h_{name}")
    for i in range(0, 256, 7):
        assert (int(got[0][i]), int(got[1][i])) == h(
            (int(a[0][i]), int(a[1][i])), (int(b[0][i]), int(b[1][i])))


@pytest.mark.parametrize("name", ["neg", "square", "inverse"])
def test_ext_unary_ops_match_reference(name):
    a = _ext(seed=30, n=160 if name == "inverse" else 256)
    got = _port_ext(getattr(text, name), a)
    want = _jax_ext(getattr(jext, name), a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "inverse":
        prod = _port_ext(text.mul, a, got)
        nonzero = (a[0] != 0) | (a[1] != 0)
        assert (prod[0][nonzero] == 1).all() and not prod[1][nonzero].any()
        np.testing.assert_array_equal(np.stack(got),
                                      np.stack(text.np_ext_inverse(a)))


def test_ext_mul_base_from_base_select_eq():
    a, b = _ext(seed=40), _values(256, seed=41)
    got = _port_ext(lambda x: text.mul_base(x, _t(b)), a)
    want = _jax_ext(lambda x: jext.mul_base(x, jg.from_u64(b)), a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lifted = text.from_base(_t(b))
    np.testing.assert_array_equal(convert.to_u64(lifted[0]), b)
    assert not lifted[1].any()
    c = _ext(seed=42)
    c[0][::2], c[1][::2] = a[0][::2], a[1][::2]
    ta, tc = (_t(a[0]), _t(a[1])), (_t(c[0]), _t(c[1]))
    mask = text.eq(ta, tc)
    np.testing.assert_array_equal(
        mask.numpy(),
        np.asarray(jext.eq((jg.from_u64(a[0]), jg.from_u64(a[1])),
                           (jg.from_u64(c[0]), jg.from_u64(c[1])))))
    assert mask[::2].all()
    sel = text.select(mask, text.zeros((256,), "cpu"), ta)
    assert not sel[0][mask].any()
    np.testing.assert_array_equal(convert.to_u64(sel[1][~mask]),
                                  a[1][~mask.numpy()])


# ---------------------------------------------------------------------------
# gl64_ext: copied host helpers
# ---------------------------------------------------------------------------

def test_ext_host_helpers_match_reference():
    a, b = _ext(seed=50, n=160), _ext(seed=60, n=160)
    for name in ("np_ext_add", "np_ext_sub", "np_ext_mul"):
        for g, w in zip(getattr(text, name)(a, b), getattr(jext, name)(a, b)):
            np.testing.assert_array_equal(g, w)
    s = (int(b[0][9]), int(b[1][9]))
    for g, w in zip(text.np_ext_scale(a, s), jext.np_ext_scale(a, s)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(text.np_ext_inverse(a), jext.np_ext_inverse(a)):
        np.testing.assert_array_equal(g, w)
    x = (int(a[0][20]), int(a[1][20]))
    y = (int(b[0][21]), int(b[1][21]))
    for name in ("h_add", "h_sub", "h_mul"):
        assert getattr(text, name)(x, y) == getattr(jext, name)(x, y)
    assert text.h_inverse(x) == jext.h_inverse(x)
    assert text.h_mul(x, text.h_inverse(x)) == (1, 0)
    assert text.h_exp(x, 12345) == jext.h_exp(x, 12345)
    assert text.h_exp(x, P * P - 1) == (1, 0)
    coeffs = [int(v) for v in a[0][:9]]
    assert text.h_eval_poly_ext(coeffs, y) == jext.h_eval_poly_ext(coeffs, y)
    assert (text.W, text.P, text.DTH_ROOT) == (jext.W, jext.P, jext.DTH_ROOT)
