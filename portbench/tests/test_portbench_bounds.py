"""The copied bound functions give the kernel table's bounds."""

import pytest

from portbench import bounds


@pytest.mark.parametrize("fn,args,ms", [
    # K1 + K2 intt (288, 2^12) and coset LDE (288, 2^12) -> 2^15
    (bounds.ntt_bound_s, (288, 1 << 12, 1 << 12), 0.0056),
    (bounds.ntt_bound_s, (288, 1 << 12, 1 << 15), 0.0254),
    # the rollup path's coset LDE (144, 2^16) -> 2^19
    (bounds.ntt_bound_s, (144, 1 << 16, 1 << 19), 0.2028),
    # K4: the one-shot leaf hash (64, 2^21), the rollup's wires (144, 2^19)
    (bounds.sponge_bound_s, (64, 1 << 21), 6.2181),
    (bounds.sponge_bound_s, (144, 1 << 19), 3.4977),
    (bounds.sponge_bound_s, (38, 1 << 19), 0.9716),
    # K3: one grinding batch (12, 2^17); K5: a slab (12 + 8, 2^23)
    (bounds.permute_bound_s, (1 << 17,), 0.0486),
    (bounds.absorb_bound_s, (8, 1 << 23), 3.1090),
])
def test_bound_matches_the_kernel_table(fn, args, ms):
    assert round(fn(*args) * 1e3, 4) == ms


def test_level_bound_is_one_permutation_a_parent():
    assert bounds.level_bound_s(1 << 20) == pytest.approx(
        bounds.permute_bound_s(1 << 20))
