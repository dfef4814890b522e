"""The port's int64 Goldilocks ops and copied host helpers, held bit for bit
against the reference's gl64 and python-int ground truth."""

import numpy as np
import pytest
import torch
import jax

from city_rollup_tpu.core import gl64 as jg
import city_rollup_tpu_torch as port
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import gl64 as tg

P = jg.P
EDGE = [0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        1 << 63, (1 << 63) - 1, P - (1 << 32), P - 0xFFFFFFFF]


def _operands(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    n = max(n, len(EDGE) ** 2)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    e = np.array(EDGE, dtype=np.uint64)
    k = len(e)
    # every pair of edge values, then random values
    a[:k * k] = np.repeat(e, k)
    b[:k * k] = np.tile(e, k)
    return a, b


def _jax(fn, *args):
    out = jax.jit(fn)(*[jg.from_u64(x) for x in args])
    return jg.to_u64(np.asarray(out[0]), np.asarray(out[1]))


def _port(fn, *args):
    return convert.to_u64(fn(*[convert.from_u64(x, "cpu") for x in args]))


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_reference(name):
    a, b = _operands()
    got = _port(getattr(tg, name), a, b)
    np.testing.assert_array_equal(got, _jax(getattr(jg, name), a, b))
    op = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
          "mul": lambda x, y: x * y}[name]
    want = np.array([op(int(x), int(y)) % P for x, y in zip(a, b)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,power", [("square", 2), ("exp7", 7)])
def test_unary_ops_match_reference(name, power):
    a, _ = _operands(seed=1)
    got = _port(getattr(tg, name), a)
    np.testing.assert_array_equal(got, _jax(getattr(jg, name), a))
    want = np.array([pow(int(x), power, P) for x in a], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_canonicalize_matches_reference():
    rng = np.random.default_rng(2)
    # every u64 below 2p: canonical values and [p, 2^64)
    x = np.concatenate([
        np.array(EDGE + [P, P + 1, (1 << 64) - 1, P + 0xFFFFFFFE],
                 dtype=np.uint64),
        np.uint64(P) + rng.integers(0, (1 << 64) - P, size=200,
                                    dtype=np.uint64),
        rng.integers(0, P, size=200, dtype=np.uint64)])
    got = _port(tg.canonicalize, x)
    np.testing.assert_array_equal(
        got, _jax(lambda a: jg.canonicalize(*a), x))
    np.testing.assert_array_equal(
        got, np.array([int(v) % P for v in x], dtype=np.uint64))


def test_host_helpers_match_reference():
    a, b = _operands(n=256, seed=4)
    for name in ("np_mul", "np_add", "np_sub"):
        np.testing.assert_array_equal(getattr(tg, name)(a, b),
                                      getattr(jg, name)(a, b))
    np.testing.assert_array_equal(tg.np_pow(a, 12345), jg.np_pow(a, 12345))
    np.testing.assert_array_equal(tg.np_inverse(a), jg.np_inverse(a))
    np.testing.assert_array_equal(tg.np_powers(7, 100), jg.np_powers(7, 100))
    for k in (0, 1, 12, 32):
        assert tg.h_primitive_root_of_unity(k) == \
            jg.h_primitive_root_of_unity(k)
    assert tg.h_inverse(12345) == jg.h_inverse(12345)
    assert (tg.P, tg.EPSILON, tg.MULTIPLICATIVE_GROUP_GENERATOR,
            tg.TWO_ADICITY, tg.POWER_OF_TWO_GENERATOR) == \
        (jg.P, jg.EPSILON, jg.MULTIPLICATIVE_GROUP_GENERATOR,
         jg.TWO_ADICITY, jg.POWER_OF_TWO_GENERATOR)


def test_convert_round_trips():
    a, _ = _operands(n=64, seed=5)
    lo, hi = jg.from_u64(a)
    t = convert.from_jax_pair(np.asarray(lo), np.asarray(hi), device="cpu")
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(convert.to_u64(t), a)
    plo, phi = convert.to_jax_pair(t)
    np.testing.assert_array_equal(plo, np.asarray(lo))
    np.testing.assert_array_equal(phi, np.asarray(hi))
    np.testing.assert_array_equal(
        convert.to_u64(convert.as_tensor(a, device="cpu")), a)


def test_device_picker():
    assert port.device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port.device()
        with pytest.raises(RuntimeError):
            convert.from_u64(np.zeros(4, dtype=np.uint64))
    else:
        assert port.device().type == "cuda"
