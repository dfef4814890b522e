"""The port's Poseidon permutation, sponge, absorb and Merkle tree, held bit
for bit against the reference: poseidon_host (python ints), the jnp
permutation and pallas_poseidon in interpreter mode. The kernels are held
against their plain versions on the card in test_torch_cuda.py.

The reference's Poseidon runs slowly on the CPU (the jnp path at
optimization level 1, Pallas in the interpreter), so its side stays at one
128-lane tile."""

import numpy as np
import pytest
import torch

from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import merkle as jmerkle
from city_rollup_tpu.core import pallas_poseidon as pp
from city_rollup_tpu.core import poseidon as jposeidon
from city_rollup_tpu.core import poseidon_host
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import cuda_poseidon as cp
from city_rollup_tpu_torch.core import merkle as tmerkle
from city_rollup_tpu_torch.core import poseidon as tposeidon
from city_rollup_tpu_torch.core import poseidon_host as t_host

P = jg.P
EDGE = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, 1 << 63]


@pytest.fixture
def interpret(monkeypatch):
    """Run the reference's Pallas kernels as its own tests do."""
    monkeypatch.setenv("CITY_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pp, "B_TILE", 128)
    for fn in (pp.permute_t, pp.absorb_t, pp._sponge_t_impl):
        fn._clear_cache()
    yield
    for fn in (pp.permute_t, pp.absorb_t, pp._sponge_t_impl):
        fn._clear_cache()


def _cols(n, b, seed):
    """(n, b) uint64: random columns, then edge-valued columns and rows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=(n, b), dtype=np.uint64)
    for j, v in enumerate(EDGE):
        x[:, j] = v                              # a column of one edge value
        if j < n:
            x[j, len(EDGE):len(EDGE) + 8] = v    # a row of one edge value
    return x


def _host_cols(fn, x):
    return np.array([fn([int(v) for v in col]) for col in x.T],
                    dtype=np.uint64).T


def _u64(pair):
    return jg.to_u64(np.asarray(pair[0]), np.asarray(pair[1]))


def _t(x):
    return convert.from_u64(x, "cpu")


def test_permute_matches_host_and_jnp():
    states = _cols(12, 40, seed=0).T.copy()      # (40, 12)
    got = convert.to_u64(tposeidon.permute(_t(states)))
    np.testing.assert_array_equal(
        got, _host_cols(poseidon_host.permute, states.T).T)
    np.testing.assert_array_equal(
        got[:16], _u64(jposeidon.permute(jg.from_u64(states[:16]))))


def test_permute_t_matches_pallas_and_host(interpret):
    """K3's plain version against the reference's Pallas permutation kernel
    (interpreted) at one 128-lane tile, and against poseidon_host."""
    x = _cols(12, 128, seed=7)
    got = convert.to_u64(cp.permute_t(_t(x)))
    np.testing.assert_array_equal(got, _u64(pp.permute_t(*jg.from_u64(x))))
    np.testing.assert_array_equal(got, _host_cols(poseidon_host.permute, x))
    np.testing.assert_array_equal(
        convert.to_u64(cp.permute_t_plain(_t(x))), got)
    np.testing.assert_array_equal(
        convert.to_u64(tposeidon.permute(_t(x.T.copy()))), got.T)


def test_host_permute_matches_reference():
    """The port's host permutation (the CUDA core's schedule: fast partial
    rounds) against the reference's round-by-round one, on seeded random
    states and on states of edge values."""
    edge = [0, 1, P - 1, (1 << 32) - 1, (1 << 32) + 1]
    rng = np.random.default_rng(11)
    states = [[int(v) for v in row]
              for row in rng.integers(0, P, size=(24, 12), dtype=np.uint64)]
    states += [[v] * 12 for v in edge]
    states += [[int(v) for v in rng.choice(edge, size=12)] for _ in range(16)]
    states += [[0] * i + [v] + [0] * (11 - i) for i in range(12)
               for v in edge[1:]]
    for state in states:
        assert t_host.permute(state) == poseidon_host.permute(state)


def test_permute_t_rejects_bad_shapes():
    for shape in [(11, 4), (12,), (2, 12, 4)]:
        with pytest.raises(ValueError):
            cp.permute_t(torch.zeros(shape, dtype=torch.int64))


@pytest.mark.parametrize("n", [3, 10])
def test_sponge_matches_pallas_and_host(interpret, n):
    x = _cols(n, 24, seed=n)
    got = convert.to_u64(cp.sponge_t(_t(x)))
    np.testing.assert_array_equal(got, _host_cols(poseidon_host.hash_no_pad,
                                                  x))
    if n > 4:
        np.testing.assert_array_equal(
            got, _u64(pp.hash_rows_t(jg.from_u64(x))))


@pytest.mark.parametrize("k", [3, 8])
def test_absorb_matches_pallas(interpret, k):
    state = _cols(12, 20, seed=20 + k)
    chunk = _cols(k, 20, seed=30 + k)
    got = convert.to_u64(cp.absorb_t(_t(state), _t(chunk)))
    want = _u64(pp.absorb_t(jg.from_u64(state), jg.from_u64(chunk)))
    np.testing.assert_array_equal(got, want)
    merged = np.concatenate([chunk, state[k:]])
    np.testing.assert_array_equal(got, _host_cols(poseidon_host.permute,
                                                  merged))


def test_two_to_one_and_reduce_level(interpret):
    d = _cols(4, 40, seed=3)                     # 40 digests, transposed
    got = convert.to_u64(cp.reduce_level_t(_t(d)))
    want = _u64(pp.reduce_level_t(jg.from_u64(d)))
    np.testing.assert_array_equal(got, want)
    left, right = d.T[0::2].copy(), d.T[1::2].copy()
    np.testing.assert_array_equal(
        convert.to_u64(tposeidon.two_to_one(_t(left), _t(right))), want.T)
    np.testing.assert_array_equal(
        want.T, np.array([poseidon_host.two_to_one([int(v) for v in a],
                                                   [int(v) for v in b])
                          for a, b in zip(left, right)], dtype=np.uint64))


@pytest.mark.parametrize("n", [1, 4, 5])
def test_hash_no_pad_hashes_short_rows(n):
    """hash_no_pad hashes every n; hash_rows_t and hash_leaves pass rows of
    n <= 4 through zero-padded (hash_or_noop)."""
    rows = _cols(n, 12, seed=50 + n).T.copy()        # (12, n)
    hashed = convert.to_u64(tposeidon.hash_no_pad(_t(rows)))
    np.testing.assert_array_equal(
        hashed, _host_cols(poseidon_host.hash_no_pad, rows.T).T)
    leaves = convert.to_u64(tmerkle.hash_leaves(_t(rows)))
    np.testing.assert_array_equal(
        leaves, _host_cols(poseidon_host.hash_or_noop, rows.T).T)
    np.testing.assert_array_equal(
        convert.to_u64(cp.hash_rows_t(_t(rows.T.copy()))), leaves.T)


def test_merkle_tree_matches_reference():
    leaves = _cols(6, 16, seed=60).T.copy()          # 16 leaves of 6 felts
    tree = tmerkle.MerkleTree(_t(leaves), cap_height=1)
    ref = jmerkle.MerkleTree(jg.from_u64(leaves), cap_height=1)
    assert len(tree.levels) == len(ref.levels)
    for got, want in zip(tree.levels, ref.levels):
        np.testing.assert_array_equal(convert.to_u64(got), _u64(want))
    cap = tree.cap_u64()
    np.testing.assert_array_equal(cap, ref.cap_u64())
    for i in (0, 5, 15):
        path = tree.prove(i)
        assert path == ref.prove(i)
        leaf = tmerkle.h_hash_leaf([int(v) for v in leaves[i]])
        assert tmerkle.h_verify_merkle_proof(leaf, i, path, cap)
        assert not tmerkle.h_verify_merkle_proof(leaf, i ^ 1, path, cap)


def test_batched_merkle_tree_matches_reference():
    """B = 3 trees of N = 16 leaves of k = 8 felts: every level, the caps
    and the paths equal the reference's, and each tree equals a MerkleTree
    of its own leaves."""
    leaves = np.stack([_cols(8, 16, seed=70 + b).T for b in range(3)])
    tree = tmerkle.BatchedMerkleTree(_t(leaves), cap_height=2)
    ref = jmerkle.BatchedMerkleTree(jg.from_u64(leaves), cap_height=2)
    assert len(tree.levels) == len(ref.levels) == 3
    for got, want in zip(tree.levels, ref.levels):
        np.testing.assert_array_equal(convert.to_u64(got), _u64(want))
    for b in range(3):
        cap = tree.cap_u64(b)
        np.testing.assert_array_equal(cap, ref.cap_u64(b))
        single = tmerkle.MerkleTree(_t(leaves[b]), cap_height=2)
        np.testing.assert_array_equal(cap, single.cap_u64())
        for i in (0, 6, 15):
            path = tree.prove(b, i)
            assert path == ref.prove(b, i) == single.prove(i)
            leaf = tmerkle.h_hash_leaf([int(v) for v in leaves[b, i]])
            assert tmerkle.h_verify_merkle_proof(leaf, i, path, cap)
    np.testing.assert_array_equal(convert.to_u64(tree.cap), _u64(ref.cap))


def test_reduce_level_t_plain_reads_strided_children():
    """K4's Merkle-level entry on the CPU: the plain version over the
    strided children, which every tree level takes; odd widths and other
    row counts are refused."""
    d = _cols(4, 64, seed=4)
    got = convert.to_u64(cp.reduce_level_t(_t(d)))
    want = np.array([poseidon_host.two_to_one([int(v) for v in d[:, 2 * j]],
                                              [int(v) for v in d[:, 2 * j + 1]])
                     for j in range(32)], dtype=np.uint64).T
    np.testing.assert_array_equal(got, want)
    # a transposed view (the layout BatchedMerkleTree hands it)
    view = _t(d.T.copy()).T
    assert not view.is_contiguous()
    np.testing.assert_array_equal(convert.to_u64(cp.reduce_level_t(view)),
                                  want)
    for shape in [(4, 5), (8, 4), (4,)]:
        with pytest.raises(ValueError):
            cp.reduce_level_t(torch.zeros(shape, dtype=torch.int64))


def test_absorb_rejects_bad_shapes():
    with pytest.raises(ValueError):
        cp.absorb_t(torch.zeros(12, 4, dtype=torch.int64),
                    torch.zeros(9, 4, dtype=torch.int64))
