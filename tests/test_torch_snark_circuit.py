"""The port's CircuitBuilder against the reference's: the same builder
function (chip_smoke's) run against either package's builder gives equal
rows, sigmas, selector groups, preprocessing, constants/sigmas cap and
circuit digest, and generate_witness gives equal wire matrices. The port
runs on the CPU (build(device="cpu"))."""

import numpy as np
import pytest
import torch

import chip_smoke
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import circuit

P = jg.P


def _tiny(builder_cls, config_cls, fri_cls):
    """The builder and a function that makes its partial witness (after
    build, which joins copy classes a witness set earlier could lose)."""
    b = builder_cls(chip_smoke.fast_config(config_cls, fri_cls))
    x = chip_smoke.tiny_circuit(b)

    def witness():
        pw = b.partial_witness()
        pw.set(x, 3)
        return pw
    return b, witness


def _paths(builder_cls, config_cls, fri_cls):
    """Two Merkle paths of height 3: PoseidonGate rows, 16 public inputs
    (hashed in-circuit), the conditional swaps."""
    b = builder_cls(chip_smoke.fast_config(config_cls, fri_cls))
    paths = chip_smoke.merkle_paths_circuit(b, 2, height=3)
    return b, lambda: chip_smoke.merkle_paths_witness(b, paths, seed=5)


CIRCUITS = {"tiny": _tiny, "merkle_paths": _paths}


@pytest.fixture(scope="module")
def built():
    """name -> ((reference data, witness), (port data, witness)), built
    once each."""
    cache = {}

    def get(name):
        if name not in cache:
            make = CIRCUITS[name]
            jb, jwitness = make(JBuilder, JConfig, jfri.FriConfig)
            tb, twitness = make(CircuitBuilder, CircuitConfig, fri.FriConfig)
            jd, td = jb.build(), tb.build(device="cpu")
            cache[name] = (jd, jwitness()), (td, twitness())
        return cache[name]
    return get


@pytest.fixture(params=sorted(CIRCUITS))
def both(request, built):
    return built(request.param)


def _rows(data):
    return [None if r is None else (r.gate.key, r.constants)
            for r in data.prover.rows]


def test_same_rows_gates_and_selectors(both):
    (jd, _), (td, _) = both
    assert _rows(td) == _rows(jd)
    assert td.prover.row_gate_id == jd.prover.row_gate_id
    assert [g.key for g in td.common.gates] == [g.key for g in jd.common.gates]
    assert td.common.selector_groups == jd.common.selector_groups
    assert (td.common.log_n, td.common.num_public_inputs) == \
        (jd.common.log_n, jd.common.num_public_inputs)
    assert td.common.k_is == jd.common.k_is
    assert [td.common.filter_terms(g) for g in range(len(td.common.gates))] \
        == [jd.common.filter_terms(g) for g in range(len(jd.common.gates))]


def test_same_sigmas_and_preprocessing_values(both):
    (jd, _), (td, _) = both
    for name in ("sigmas", "const_sigma_values", "subgroup"):
        np.testing.assert_array_equal(getattr(td.prover, name),
                                      getattr(jd.prover, name))


def test_same_preprocessing_cap_and_digest(built):
    """On the Merkle-path circuit (four gates in two selector groups); the
    tiny circuit's cap and digest are held in tests/test_torch_snark.py,
    whose fixture builds its verifier data anyway (the reference's cap
    costs ~15 s of XLA compiles a circuit here)."""
    (jd, _), (td, _) = built("merkle_paths")
    assert len(td.common.selector_groups) > 1
    np.testing.assert_array_equal(td.verifier.constants_sigmas_cap,
                                  jd.verifier.constants_sigmas_cap)
    assert td.verifier.circuit_digest == jd.verifier.circuit_digest
    np.testing.assert_array_equal(
        convert.to_u64(td.prover.const_sigma_coeffs),
        jd.prover.const_sigma_coeffs)
    np.testing.assert_array_equal(
        convert.to_u64(td.prover.const_sigma_ldes),
        jd.prover.const_sigma_ldes)
    assert td.prover.const_sigma_ldes.device == torch.device("cpu")


def test_same_witness(both):
    (jd, jpw), (td, tpw) = both
    want = jcircuit.generate_witness(jd, jpw)
    got = circuit.generate_witness(td, tpw)
    assert got.dtype == np.uint64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # every Poseidon row is generated: its output and round states
    # (wires 12..141) are random-looking, so none is 0
    rows = [r for r, g in enumerate(td.prover.rows)
            if g is not None and g.gate.key == "poseidon"]
    assert got[12:142][:, rows].all()
    assert got.any()


def test_interp_and_lde_matches_reference():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, P, size=(2, 3, 16), dtype=np.uint64)
    vals[0, 0, :6] = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]
    jc, jl = jcircuit.interp_and_lde(vals, 4, 3)
    tc, tl = circuit.interp_and_lde(convert.from_u64(vals, "cpu"), 4, 3)
    np.testing.assert_array_equal(convert.to_u64(tc), jc)
    np.testing.assert_array_equal(convert.to_u64(tl), jl)


def test_conflicting_witness_and_build_errors():
    b = CircuitBuilder(CircuitConfig())
    x, y = b.add_virtual_target(), b.add_virtual_target()
    b.connect(x, y)
    pw = b.partial_witness()
    pw.set(x, 1)
    with pytest.raises(ValueError):
        pw.set(y, 2)
    with pytest.raises(AssertionError):
        b.poseidon_permute([x] * 12)       # 32 wires: too narrow
    c = CircuitBuilder(CircuitConfig())
    for _ in range(20):
        c.add(c.add_virtual_target(), c.one())
    with pytest.raises(AssertionError):
        c.build(min_log_n=2)


def test_full_width_circuit_fills_2_12_rows():
    """chip_smoke's full-width circuit: FULL_PATHS Merkle paths of height
    32 fit build(min_log_n=12) under poseidon_config(), one more does
    not."""
    def rows(k):
        b = CircuitBuilder(CircuitConfig.poseidon_config())
        chip_smoke.merkle_paths_circuit(b, k)
        data = b.build()
        return data.common.log_n, sum(r is not None for r in data.prover.rows)

    log_n, used = rows(chip_smoke.FULL_PATHS)
    assert log_n == chip_smoke.FULL_LOG_N and used <= 1 << log_n
    assert rows(chip_smoke.FULL_PATHS + 1)[0] > chip_smoke.FULL_LOG_N
