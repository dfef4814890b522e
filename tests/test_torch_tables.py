"""The port's copied tables and constants equal the reference's, and the
port imports neither JAX nor the reference package."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from city_rollup_tpu.core import gl64 as jg
from city_rollup_tpu.core import ntt as jntt
from city_rollup_tpu.core import pallas_ntt as pn
from city_rollup_tpu.core import poseidon_host as j_host
from city_rollup_tpu.core import poseidon_params as j_params
from city_rollup_tpu_torch.core import cuda_ntt as cn
from city_rollup_tpu_torch.core import cuda_poseidon as cp
from city_rollup_tpu_torch.core import ntt as tn
from city_rollup_tpu_torch.core import poseidon_host as t_host
from city_rollup_tpu_torch.core import poseidon_params as t_params

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "city_rollup_tpu_torch"


def test_poseidon_params_verbatim():
    ref = (ROOT / "city_rollup_tpu/core/poseidon_params.py").read_text()
    assert (PORT / "core/poseidon_params.py").read_text() == ref
    assert t_params.ALL_ROUND_CONSTANTS == j_params.ALL_ROUND_CONSTANTS
    assert t_params.MDS_MATRIX_CIRC == j_params.MDS_MATRIX_CIRC
    assert t_params.MDS_MATRIX_DIAG == j_params.MDS_MATRIX_DIAG
    assert (t_params.HALF_N_FULL_ROUNDS, t_params.N_PARTIAL_ROUNDS,
            t_params.WIDTH, t_params.SPONGE_RATE) == (4, 22, 12, 8)
    assert t_params.PLONKY2_COMPAT_VERIFIED is False


def test_poseidon_host_matches_reference():
    rng = np.random.default_rng(3)
    for row in rng.integers(0, t_host.P, size=(4, 12), dtype=np.uint64):
        state = [int(v) for v in row]
        assert t_host.permute(state) == j_host.permute(state)
    assert t_host.hash_or_noop([1, 2, 3]) == j_host.hash_or_noop([1, 2, 3])
    assert t_host.hash_no_pad(list(range(10))) == \
        j_host.hash_no_pad(list(range(10)))


def _cuh_table(name: str) -> list[int]:
    src = (PORT / "csrc/poseidon.cuh").read_text()
    m = re.search(name + r"\(int i\) \{\s*constexpr uint32_t v\[POS_WIDTH\]"
                  r" = \{([^}]*)\}", src)
    assert m, name
    return [int(v) for v in m.group(1).split(",")]


def test_kernel_mds_constants_match_params():
    assert _cuh_table("pos_mds_circ") == j_params.MDS_MATRIX_CIRC
    assert _cuh_table("pos_mds_diag") == j_params.MDS_MATRIX_DIAG
    src = (PORT / "csrc/poseidon.cuh").read_text()
    for macro, value in [("POS_WIDTH", 12), ("POS_RATE", 8),
                         ("POS_HALF_FULL", 4), ("POS_PARTIAL", 22),
                         ("POS_ROUNDS", 30)]:
        assert re.search(rf"#define {macro} {value}\b", src), macro


def test_kernel_table_layout():
    """csrc/poseidon.cuh's PosTables, in the order and at the sizes that
    cuda_poseidon copies them: the round constants, then the FP64 MDS's
    start values 2^52 + each 32-bit word of each round's constants (and a
    last row of 2^52), which are exact doubles."""
    src = (PORT / "csrc/poseidon.cuh").read_text()
    body = re.search(r"struct PosTables \{([^}]*)\}", src).group(1)
    fields = re.findall(r"(uint64_t|double) (\w+)((?:\[[^\]]+\])+);", body)
    dims = {"POS_ROUNDS": 30, "POS_WIDTH": 12, "POS_ROUNDS + 1": 31, "2": 2}
    sizes = []
    for _, _, shape in fields:
        n = 1
        for d in re.findall(r"\[([^\]]+)\]", shape):
            n *= dims[d]
        sizes.append(n)
    assert [(t, f) for t, f, _ in fields] == [
        ("uint64_t", "round_constants"), ("double", "mds_start")]
    assert sizes == [360, 744]
    tables = cp._TABLES_HOST
    assert tables.dtype == np.uint64 and tables.size == sum(sizes)
    assert [int(v) for v in tables[:360]] == j_params.ALL_ROUND_CONSTANTS
    start = tables[360:].view(np.float64).reshape(31, 12, 2)
    rc = j_params.ALL_ROUND_CONSTANTS + [0] * 12
    for r in (0, 1, 17, 29, 30):
        for i in range(12):
            c = rc[r * 12 + i]
            assert start[r, i, 0] == 2.0 ** 52 + (c & 0xFFFFFFFF)
            assert start[r, i, 1] == 2.0 ** 52 + (c >> 32)


@pytest.mark.parametrize("log_m", [0, 1, 5, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_stage_twiddle_cols(log_m, inverse):
    np.testing.assert_array_equal(cn._stage_twiddle_cols(log_m, inverse),
                                  pn._stage_twiddle_cols(log_m, inverse))


@pytest.mark.parametrize("log_n", [1, 9, 23])
def test_fourstep_twiddle_table(log_n):
    """K1's two-level w_N table gives the reference's four-step seeds
    (w_N^c, pallas_ntt._gcol) and their powers w_N^(c k2)."""
    log_n2 = cn._split(log_n)
    n1 = 1 << (log_n - log_n2)
    tw = cn._tw_cols(log_n).astype(object)
    h = cn._tw_split(log_n)

    def w_pow(e):
        return tw[e & ((1 << h) - 1)] * tw[(1 << h) + (e >> h)] % jg.P

    seeds = pn._gcol(log_n, log_n2, 1, n1, False)
    picks = np.random.default_rng(log_n).integers(0, n1, size=64)
    for c in sorted(set(picks.tolist()) | {0, n1 - 1}):
        assert w_pow(c) == int(seeds[c])
        k2 = (1 << log_n2) - 1
        assert w_pow(c * k2) == pow(int(seeds[c]), k2, jg.P)
    np.testing.assert_array_equal(
        cn._pow_cols(min(log_n, 12)),
        jg.np_powers(jg.h_primitive_root_of_unity(min(log_n, 12)),
                     1 << min(log_n, 12)))


@pytest.mark.parametrize("log_n", [0, 3, 11])
def test_ntt_host_tables(log_n):
    np.testing.assert_array_equal(tn._bit_reverse_perm(log_n),
                                  jntt._bit_reverse_perm(log_n))
    np.testing.assert_array_equal(tn._root_powers(log_n),
                                  jntt._root_powers(log_n))
    np.testing.assert_array_equal(tn._inv_root_powers(log_n),
                                  jntt._inv_root_powers(log_n))
    np.testing.assert_array_equal(tn._coset_powers(log_n, 7),
                                  jntt._coset_powers(log_n, 7))


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "profile_commit.py"]
    assert len(files) >= 17
    return files


def test_port_never_imports_the_reference():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("city_rollup_tpu", "jax", "jaxlib"), \
                    f"{path.name} imports {name}"


def test_port_imports_with_jax_blocked():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in _port_files()]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {f"city_rollup_tpu_torch.core.{m}"
            for m in ("gl64_ext", "challenger", "fri")} <= set(mods)
    assert {f"city_rollup_tpu_torch.snark.{m}"
            for m in ("config", "algebra", "gates", "gate_poseidon",
                      "circuit", "device_passes", "prover",
                      "verifier", "gadgets", "recursion", "minifier",
                      "verify_template", "debug", "u32", "sha256",
                      "ripemd160", "biguint", "secp_gadgets")} <= set(mods)
    assert {f"city_rollup_tpu_torch.crypto.{m}"
            for m in ("hashes", "secp256k1", "felts")} <= set(mods)
    assert {"city_rollup_tpu_torch.snark",
            "city_rollup_tpu_torch.crypto"} <= set(mods)
    assert {"city_rollup_tpu_torch.parallel"} | {
        f"city_rollup_tpu_torch.parallel.{m}"
        for m in ("mesh", "dist_ntt", "dist_merkle",
                  "dist_pipeline")} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'city_rollup_tpu' or\n"
            "               k.startswith('city_rollup_tpu.')\n"
            "               for k in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_c_signatures_match_sources():
    """Each C entry's ctypes argtypes (_build.SIGNATURES) follow its
    parameters in csrc/: a pointer per pointer, c_longlong per long long,
    c_int per int."""
    import ctypes
    from city_rollup_tpu_torch import _build
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "long long",
             ctypes.c_int: "int"}
    for lib, fns in _build.SIGNATURES.items():
        source = (PORT / "csrc" / f"{lib}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", source)
            assert m, fn
            params = [" ".join(p.split()) for p in m.group(1).split(",")]
            want = ["ptr" if "*" in p else
                    "long long" if p.startswith("long long") else "int"
                    for p in params]
            assert [kinds[t] for t in argtypes] == want, fn


def test_w16_constant_matches_source():
    """csrc/ntt.cu's radix-16 twiddles assume w_16 = 2^kW16Log2: the same
    exponent as the wrapper's, and the reference's 16th root."""
    m = re.search(r"constexpr int kW16Log2 = (\d+);",
                  (PORT / "csrc" / "ntt.cu").read_text())
    assert int(m.group(1)) == cn.W16_LOG2
    assert pow(2, cn.W16_LOG2, jg.P) == jg.h_primitive_root_of_unity(4)
