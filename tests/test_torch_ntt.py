"""The port's NTT, held bit for bit against the reference: the plain radix-2
path and the four-step path (run here with the kernels' plain versions)
against the jnp path, the fused coset scaling, padding and inverse
scaling with edge values, and K1, K2 and the tail stages against
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


EDGE = [0, 1, jg.P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]


def _with_edges(vals):
    """Seeded values with the edge values in the first columns and rows."""
    vals = vals.copy()
    flat = vals.reshape(-1, vals.shape[-1])
    for j, v in enumerate(EDGE[:flat.shape[-1]]):
        flat[:, j] = v
        flat[j % flat.shape[0], -1 - j] = v
    return vals


def _ref_small_ntt(cols, log_m, g=None):
    """pallas_ntt._small_ntt on (m, L): one transform per column of cols,
    its input in natural order (the reference's kernel takes it
    bit-reversed)."""
    cols = cols[jntt._bit_reverse_perm(log_m)]
    twl, twh = _col(pn._stage_twiddle_cols(min(log_m, pn.MAX_KERNEL_LOG),
                                           False))
    ttl, tth = _col(pn._stage_twiddle_cols(log_m, False))
    lo, hi = jg.from_u64(cols)
    out = pn._small_ntt(lo, hi, twl, twh, g, log_m, ttl, tth)
    return jg.to_u64(np.asarray(out[0]), np.asarray(out[1]))


@pytest.mark.parametrize("with_g", [True, False])
def test_small_ntt_matches_pallas(interpret, with_g):
    """K1 (with g) and K2 (without) against the reference's kernel in
    interpreter mode, one sub-transform per column there. K1: the
    length-n2 DFT of each column c of the (n2, n1) matrix times the
    four-step seed g = w_N^c raised to k2 (pallas_ntt._gcol), tiled. K2:
    the length-n1 DFT of each row of that tiled matrix, in natural order."""
    log_n = 9
    log_n2 = cn._split(log_n)
    n2, n1 = 1 << log_n2, 1 << (log_n - log_n2)
    vals = _with_edges(_rand((1, 1 << log_n), seed=20 + with_g))
    x = convert.from_u64(vals, "cpu")
    if with_g:
        g = pn._gcol(log_n, log_n2, 1, n1, False)
        glo, ghi = jg.from_u64(g)
        want = _ref_small_ntt(vals.reshape(n2, n1), log_n2,
                              (glo.reshape(1, -1), ghi.reshape(1, -1)))
        got = cn._untile(cn._k1(x, log_n, log_n2), log_n, log_n2)
        np.testing.assert_array_equal(convert.to_u64(got)[0], want)
    else:
        rows = convert.to_u64(cn._untile(x, log_n, log_n2))[0]
        want = _ref_small_ntt(rows.T.copy(), log_n - log_n2)
        got = cn._k2(x, log_n, log_n2)
        np.testing.assert_array_equal(convert.to_u64(got)[0],
                                      want.reshape(-1))


def test_segmented_k2_matches_pallas(interpret, monkeypatch):
    """A K2 row longer than a segment: K2's DIT stages per segment, then the
    tail stages, against the reference's kernel plus its _tail_stage
    passes, with MAX_KERNEL_LOG lowered on both sides (segments of 2^3,
    rows of 2^6: three tail stages)."""
    monkeypatch.setattr(cn, "MAX_KERNEL_LOG", 3)
    monkeypatch.setattr(pn, "MAX_KERNEL_LOG", 3)
    log_n, log_n2 = 9, 3
    log_n1 = log_n - log_n2
    vals = _with_edges(_rand((2, 1 << log_n), seed=23))
    x = convert.from_u64(vals, "cpu")
    rows = cn._k2(x, log_n, log_n2, log_t=log_n1 - cn._segment_log(log_n1))
    tt = convert.from_u64(cn._stage_twiddle_cols(log_n1, False), "cpu")
    for s in range(cn._segment_log(log_n1), log_n1):
        rows = cn._tail_stage(rows, s, log_n1, tt)
    ref_rows = convert.to_u64(cn._untile(x, log_n, log_n2)).reshape(
        -1, 1 << log_n1)
    want = _ref_small_ntt(ref_rows.T.copy(), log_n1)
    np.testing.assert_array_equal(convert.to_u64(rows), want.T)


@pytest.mark.parametrize("log_n,rate_bits,batch", [
    (5, 3, 1), (5, 1, 3), (2, 3, 1), (8, 3, 3), (0, 1, 2)])
def test_fused_coset_lde_matches_jnp(log_n, rate_bits, batch):
    """K1 reads the coefficients, scales by shift^j and pads itself; edge
    values, n2 < 2^rate_bits (log_n 2: n2 = 4, n_in = 4 < n1 = 8)."""
    vals = _with_edges(_rand((batch, 1 << log_n), seed=50 + log_n))
    np.testing.assert_array_equal(
        _port(cn.coset_lde, vals, log_n, rate_bits),
        _ref(jntt.coset_lde, vals, log_n, rate_bits))


@pytest.mark.parametrize("name", ["intt", "coset_intt"])
@pytest.mark.parametrize("log_m,batch", [(5, 1), (8, 3)])
def test_fused_inverse_matches_jnp(name, log_m, batch):
    """K2 writes an inverse transform backwards and scales it by n^-1
    (times shift^-k for coset_intt) on its way out."""
    vals = _with_edges(_rand((batch, 1 << log_m), seed=60 + log_m))
    np.testing.assert_array_equal(_port(getattr(cn, name), vals, log_m),
                                  _ref(getattr(jntt, name), vals, log_m))


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
    with pytest.raises(ValueError):
        cn._k1(x, 4, 2, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        cn._k1(torch.zeros(4, 12, dtype=torch.int64), 4, 2)
    with pytest.raises(ValueError):
        cn._k2(x, 4, 2, log_t=1, reverse=True)
    with pytest.raises(ValueError):
        cn._k2(x, 5, 2)
    tw = convert.from_u64(cn._stage_twiddle_cols(4, False), "cpu")
    with pytest.raises(ValueError):
        cn._tail_stage(x, 4, 4, tw)
    with pytest.raises(ValueError):
        tn.ntt(x, 3)


# --- a model of csrc/ntt.cu's index math --------------------------------------
# K1 and K2 address the four-step matrix themselves (tiles, the shared-memory
# swizzle, the digit reversal of the last pass, the block order, the pruned
# first pass of K1); a mistake there shows only on the card. The functions
# below transcribe ntt_block_kernel and run_pass line for line on python
# ints, with exact field arithmetic (the lazy steps are modelled in
# test_torch_gl64_lazy.py), and are held against the plain versions.

W16_LOG2 = cn.W16_LOG2


def _brev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _swz(pos, lc):
    b = 4 - lc
    h = 0
    for i in range(1, 8):
        h ^= pos >> (i * b)
    return pos ^ (h & ((1 << b) - 1))


def _dft_regs(v, rl, s0):
    for i in range(1 << rl):
        if i & ((1 << s0) - 1):
            v[_brev(i, rl)] = v[_brev(i & ~((1 << s0) - 1), rl)]
    for s in range(s0, rl):
        h = 1 << s
        for i in range((1 << rl) // 2):
            j = i & (h - 1)
            i0 = ((i >> s) << (s + 1)) | j
            a, b = _brev(i0, rl), _brev(i0 + h, rl)
            t = v[b] * pow(2, (W16_LOG2 * j * (8 >> s)) % 192, jg.P)
            v[a], v[b] = (v[a] + t) % jg.P, (v[a] - t) % jg.P
    return [v[_brev(k, rl)] for k in range(1 << rl)]


def _y_index(a, k2, c):
    lt = min(a["log_n2"], 2)
    return ((((k2 >> lt) << a["log_n1"]) + c) << lt) + (k2 & ((1 << lt) - 1))


def _tw_pow(a, e):
    h, tw = a["tw_h"], a["tw"]
    return tw[e & ((1 << h) - 1)] * tw[(1 << h) + (e >> h)] % jg.P


def _model_kernel(k1, a):
    """ntt_block_kernel<k1> over every block; a: the NttArgs fields, with
    in/out/pw/tw/scale as lists of ints."""
    p_ = jg.P
    n = 1 << (a["log_n1"] + a["log_n2"])
    lc, log_m = a["log_cols"], a["log_m"]
    groups = ((1 << a["log_n1"]) if k1 else (1 << a["log_n2"])) >> lc
    tiles = groups << (0 if k1 else a["log_t"])
    run = min(tiles, 16)
    lt = min(a["log_n2"], 2)
    for bid in range(a["batch"] * tiles):
        b = (bid // run) % a["batch"]
        tile = bid // (run * a["batch"]) * run + bid % run
        if k1:
            c0, in_off = tile << lc, b * a["n_in"]
        else:
            k20, seg = (tile % groups) << lc, tile // groups
            r, in_off = _brev(seg, a["log_t"]), b * n
        out_off = b * n
        passes = -(-log_m // 4) if log_m > 0 else 1  # kRadixLog
        base_r, extra = log_m // passes, log_m % passes
        sh, consumed = {}, 0
        for p in range(passes):
            rl = base_r + (p < extra)
            log_l = log_m - consumed
            log_s = log_l - rl
            lpre = log_m - rl
            first, last = p == 0, p == passes - 1
            z = rl
            if k1 and first:
                nz = max(a["n_in"].bit_length() - 1 - a["log_n1"], 0)
                z = min(max(nz - log_s, 0), rl)
            bit_slot = [_swz(1 << (log_s + i), lc) << lc for i in range(rl)]
            for g in range((1 << (log_m - rl)) << lc):
                col, rest = g & ((1 << lc) - 1), g >> lc
                a_lo = 0
                if last:
                    kap, x = 0, rest
                    for q in range(p):
                        rq = base_r + (q < extra)
                        kap = (kap << rq) | (x & ((1 << rq) - 1))
                        x >>= rq
                    base = kap << rl
                else:
                    a_lo = rest & ((1 << log_s) - 1)
                    base = ((rest >> log_s) << log_l) + a_lo
                slot0 = (_swz(base, lc) << lc) | col
                slot = []
                for j in range(1 << rl):
                    s_ = slot0
                    for i in range(rl):
                        if (j >> i) & 1:
                            s_ ^= bit_slot[i]
                    slot.append(s_)
                    pos = base + (j << log_s)
                    assert s_ == (_swz(pos, lc) << lc) + col
                if not first:
                    v = [sh[s_] for s_ in slot]
                elif k1:
                    i0 = (base << a["log_n1"]) + c0 + col
                    sh_j = log_s + a["log_n1"]
                    v = []
                    for j in range(1 << rl):
                        x = 0
                        if j < (1 << z) and i0 + (j << sh_j) < a["n_in"]:
                            x = a["in"][in_off + i0 + (j << sh_j)]
                            if a["scale"] is not None:
                                x = x * a["scale"][i0 + (j << sh_j)] % p_
                        v.append(x)
                else:
                    i0 = _y_index(a, k20 + col, (base << a["log_t"]) + r)
                    sh_j = log_s + a["log_t"] + lt
                    v = [a["in"][in_off + i0 + (j << sh_j)]
                         for j in range(1 << rl)]
                out = _dft_regs(v, rl, rl - z if k1 and first else 0)
                if not last:
                    for k in range(1 << rl):
                        w = a["pw"][(a_lo * k) << consumed] if k else 1
                        sh[slot[k]] = out[k] * w % p_
                elif k1:
                    c = c0 + col
                    w = _tw_pow(a, c * rest)
                    step = _tw_pow(a, c << lpre)
                    for k in range(1 << rl):
                        idx = _y_index(a, rest + (k << lpre), c)
                        if lpre >= lt:
                            assert idx == _y_index(a, rest, c) + (
                                k << (lpre + a["log_n1"]))
                        a["out"][out_off + idx] = out[k] * w % p_
                        w = w * step % p_
                else:
                    k2 = k20 + col
                    for k in range(1 << rl):
                        k1_ = rest + (k << lpre)
                        if a["log_t"] > 0:
                            dest = (k2 << a["log_n1"]) + (seg << log_m) + k1_
                        else:
                            dest = (k1_ << a["log_n2"]) + k2
                            if a["reverse"]:
                                dest = -dest & (n - 1)
                        x = out[k]
                        if a["scale"] is not None and not a["log_t"]:
                            x = x * a["scale"][dest & a["scale_mask"]] % p_
                        a["out"][out_off + dest] = x
            consumed += rl


def _ints(t):
    return [int(v) for v in convert.to_u64(t).reshape(-1)]


@pytest.mark.parametrize("log_n,batch,log_in,mode,max_log", [
    (9, 3, 6, "coset_lde", 13), (8, 2, 8, "coset_intt", 13),
    (5, 1, 5, "intt", 13), (2, 2, 1, "coset_lde", 13),
    (9, 2, 9, "ntt", 3), (3, 5, 3, "intt", 13), (6, 2, 3, "coset_lde", 13),
    (6, 2, 6, "coset_intt", 13)])
def test_kernel_index_model_matches_plain(monkeypatch, log_n, batch, log_in,
                                          mode, max_log):
    """K1 then K2 as the CUDA code addresses them (modelled above) against
    _k1_plain and _k2_plain: coset scaling and padding, the inverse's
    reversal and scaling, tiny transforms, and K2's segments (MAX_KERNEL_LOG
    lowered to 3: rows of 2^6 in segments of 2^3)."""
    monkeypatch.setattr(cn, "MAX_KERNEL_LOG", max_log)
    vals = _with_edges(_rand((batch, 1 << log_in), seed=70 + log_n))
    x = convert.from_u64(vals, "cpu")
    log_n2 = cn._split(log_n)
    log_n1 = log_n - log_n2
    pre = tn._coset_table(log_in, 7, "cpu") if mode == "coset_lde" else None
    n_in = 1 << log_in
    a = {"in": [int(v) for v in vals.reshape(-1)], "out": [None] * (
        batch << log_n), "pw": [int(v) for v in cn._pow_cols(log_n2)],
        "tw": [int(v) for v in cn._tw_cols(log_n)],
        "scale": None if pre is None else _ints(pre), "n_in": n_in,
        "scale_mask": 0, "batch": batch, "log_n2": log_n2,
        "log_n1": log_n1, "log_m": log_n2, "log_t": 0,
        "log_cols": cn._launch_shape(log_n2, log_n1)[0],
        "tw_h": cn._tw_split(log_n), "reverse": 0}
    _model_kernel(True, a)
    y = cn._k1_plain(x, log_n, log_n2, pre)
    assert a["out"] == _ints(y)
    log_t = log_n1 - cn._segment_log(log_n1)
    reverse = mode in ("intt", "coset_intt") and not log_t
    scale = None
    if reverse:
        scale = convert.from_u64(cn._out_scale(
            log_n, 7 if mode == "coset_intt" else None), "cpu")
    a.update({"in": a["out"], "out": [None] * (batch << log_n),
              "pw": [int(v) for v in cn._pow_cols(log_n1 - log_t)],
              "scale": None if scale is None else _ints(scale),
              "scale_mask": 0 if scale is None else scale.numel() - 1,
              "log_m": log_n1 - log_t, "log_t": log_t,
              "log_cols": cn._launch_shape(log_n1 - log_t,
                                           cn._tile_log(log_n2))[0],
              "reverse": int(reverse)})
    _model_kernel(False, a)
    assert a["out"] == _ints(cn._k2_plain(y, log_n, log_n2, log_t, reverse,
                                          scale))
