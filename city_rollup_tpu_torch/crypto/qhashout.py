"""QHashOut — the 4-Goldilocks-felt digest type — plus felt248/felt252
packing between 32-byte BTC hashes and felt digests.

Reference role: city_crypto/src/hash/qhashout.rs:21 (QHashOut<F>),
base_types/felt248.rs, felt252.rs. Semantics mirrored exactly:
 - felt252: each of the 4 LE u64 limbs masked to 63 bits.
 - felt248: limbs a,b,c full LE u64, limb d masked to 56 bits.

Counterpart of the reference's ``crypto/qhashout.py``: a copy.
"""

from __future__ import annotations

import dataclasses

from ..core import gl64, poseidon_host

_MASK_63 = (1 << 63) - 1
_MASK_56 = (1 << 56) - 1


@dataclasses.dataclass(frozen=True, order=True)
class QHashOut:
    elements: tuple[int, int, int, int]

    ZERO: "QHashOut" = None  # set below

    @staticmethod
    def from_values(a: int, b: int, c: int, d: int) -> "QHashOut":
        return QHashOut((a % gl64.P, b % gl64.P, c % gl64.P, d % gl64.P))

    @staticmethod
    def hash_many(felts: list[int]) -> "QHashOut":
        return QHashOut(tuple(poseidon_host.hash_no_pad([f % gl64.P
                                                         for f in felts])))

    def two_to_one(self, right: "QHashOut") -> "QHashOut":
        return QHashOut(tuple(poseidon_host.two_to_one(
            list(self.elements), list(right.elements))))

    def to_le_bytes(self) -> bytes:
        return b"".join(e.to_bytes(8, "little") for e in self.elements)

    @staticmethod
    def from_le_bytes(data: bytes) -> "QHashOut":
        assert len(data) == 32
        return QHashOut(tuple(int.from_bytes(data[i:i + 8], "little") % gl64.P
                              for i in range(0, 32, 8)))

    def __iter__(self):
        return iter(self.elements)


QHashOut.ZERO = QHashOut((0, 0, 0, 0))


def felt252_from_hash256(hash_le: bytes) -> tuple[int, int, int, int]:
    """hash256_le_to_felt252_hashout (felt252.rs:21-33): LE u64 limbs, top
    bit of each cleared."""
    assert len(hash_le) == 32
    return tuple(int.from_bytes(hash_le[i:i + 8], "little") & _MASK_63
                 for i in range(0, 32, 8))


def felt252_to_hash256(felts) -> bytes:
    return b"".join(((f % gl64.P) & _MASK_63).to_bytes(8, "little")
                    for f in felts)


def felt248_from_hash256(hash_le: bytes) -> tuple[int, int, int, int]:
    """hash256_le_to_felt248_hashout (felt248.rs:21-33): limbs a,b,c full LE
    u64, limb d masked to 56 bits (the top byte is dropped)."""
    assert len(hash_le) == 32
    limbs = [int.from_bytes(hash_le[i:i + 8], "little")
             for i in range(0, 32, 8)]
    limbs[3] &= _MASK_56
    return tuple(limbs)


def felt248_to_hash256(felts) -> bytes:
    limbs = [f % gl64.P for f in felts]
    limbs[3] &= _MASK_56
    return b"".join(l.to_bytes(8, "little") for l in limbs)
