"""Felt-packed hash encodings: fit ~32-byte L1 hashes into 4 Goldilocks
felts.

Reference roles (city_crypto/src/hash/base_types/{felt248,felt252}.rs and
signature/secp256k1/core.rs hash256_to_hashout_u224):
- felt252: a 32-byte hash packed as 4 x 63-bit little-endian limbs (252
  bits; the top 4 bits of the last limb are dropped) — used for the
  sighash_felt252 public input.
- felt248: 31 bytes as 4 x 62-bit limbs (248 bits) — fits a truncated
  Hash256 while staying strictly canonical.
- hash224: a txid truncated to 224 bits as 4 x 56-bit limbs (txid_224 in
  deposit leaves).
All limb packings stay < 2^63 < p, so every limb is a canonical felt.

Counterpart of the reference's ``crypto/felts.py``: a copy (it imports
nothing; ``secp256k1.combined_action_hash`` packs a public key with it).
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1


def _pack_bits(data: bytes, bits_per_limb: int, n_limbs: int) -> list[int]:
    """Little-endian bitstream of `data` -> n_limbs limbs of
    bits_per_limb bits each."""
    v = int.from_bytes(data, "little")
    mask = (1 << bits_per_limb) - 1
    return [(v >> (bits_per_limb * i)) & mask for i in range(n_limbs)]


def _unpack_bits(limbs: list[int], bits_per_limb: int, n_bytes: int) -> bytes:
    v = 0
    for i, limb in enumerate(limbs):
        assert 0 <= limb < (1 << bits_per_limb), "limb out of range"
        v |= limb << (bits_per_limb * i)
    return v.to_bytes((bits_per_limb * len(limbs) + 7) // 8, "little")[:n_bytes]


def hash256_to_felt252(h: bytes) -> list[int]:
    """32-byte hash -> 4 felts of 63 bits (top 4 bits dropped)."""
    assert len(h) == 32
    return _pack_bits(h, 63, 4)


def felt252_to_hash256(limbs: list[int]) -> bytes:
    """4 x 63-bit felts -> 32 bytes (top 4 bits zero)."""
    return (_unpack_bits(limbs, 63, 32) + b"\x00" * 32)[:32]


def hash256_to_felt248(h: bytes) -> list[int]:
    """First 31 bytes -> 4 felts of 62 bits."""
    assert len(h) >= 31
    return _pack_bits(h[:31], 62, 4)


def felt248_to_hash256(limbs: list[int]) -> bytes:
    return (_unpack_bits(limbs, 62, 31) + b"\x00")[:32]


def hash256_to_hash224(h: bytes) -> list[int]:
    """txid -> 4 x 56-bit felts (224-bit truncation, deposit txid_224)."""
    assert len(h) == 32
    return _pack_bits(h[:28], 56, 4)


def hash224_to_bytes(limbs: list[int]) -> bytes:
    return _unpack_bits(limbs, 56, 28)


def hash160_to_felts(h: bytes, type_flag: int = 0) -> list[int]:
    """20-byte hash160 -> 3 felts [56b, 56b, 48b | flag<<48] (the
    withdrawal-leaf address packing,
    introspection_result.rs hash_from_public_key_hash)."""
    assert len(h) == 20
    v = int.from_bytes(h, "little")
    return [v & ((1 << 56) - 1),
            (v >> 56) & ((1 << 56) - 1),
            ((v >> 112) & ((1 << 48) - 1)) | (type_flag << 48)]


def felts_to_hash160(limbs: list[int]) -> tuple[bytes, int]:
    """Inverse of hash160_to_felts: -> (20 bytes, type_flag)."""
    v = (limbs[0] | (limbs[1] << 56) | ((limbs[2] & ((1 << 48) - 1)) << 112))
    return v.to_bytes(20, "little"), limbs[2] >> 48


def bytes33_to_felts(pk: bytes) -> list[int]:
    """33-byte compressed secp256k1 public key -> 9 felts of 4 bytes
    (LE u32 limbs, last limb 1 byte) — bytes33_to_public_key twin."""
    assert len(pk) == 33
    return [int.from_bytes(pk[4 * i:4 * i + 4], "little") for i in range(9)]


def felts_to_bytes33(felts: list[int]) -> bytes:
    out = b"".join(
        int(f).to_bytes(4 if i < 8 else 1, "little")
        for i, f in enumerate(felts))
    return out
