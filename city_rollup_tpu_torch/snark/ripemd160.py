"""In-circuit RIPEMD-160 over u32 gadgets — needed for hash160 =
ripemd160(sha256(x)) checks (P2SH/P2PKH script bindings in the sighash
introspection circuits).

Reference role: city_common_circuit/src/builder/hash/ripemd160.rs
(SURVEY.md §2.2 "In-circuit SHA256/RIPEMD"). Same TPU-first lowering as
sha256.py: bitwise ops on memoized boolean decompositions, all rows landing
on the two batched device kernels (Arithmetic/BaseSum).

Counterpart of the reference's ``snark/ripemd160.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

from ..core import gl64
from .sha256 import Sha256Gadget
from .u32 import U32Target

P = gl64.P

# message word selection / rotation schedules (ISO/IEC 10118-3)
RL = [  # left lane word index per round
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
]
RR = [  # right lane
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
]
SL = [  # left rotation amounts
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
]
SR = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
]
KL = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
KR = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
IV = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]


class Ripemd160Gadget(Sha256Gadget):
    """Extends the sha256 gadget's bit plumbing with the ripemd lanes."""

    def _rol_bits(self, bits: list, n: int) -> list:
        """rotate-left on an LE bit list."""
        n %= 32
        return bits[32 - n:] + bits[:32 - n]

    def _or_not_bits(self, xs: list, ys: list) -> list:
        """x | ~y per bit: 1 - y + x*y."""
        b = self.b
        return [b.arithmetic(1, 1, x, y,
                             b.sub(b.one(), y)) for x, y in zip(xs, ys)]

    def _f(self, k: int, xb, yb, zb) -> list:
        if k == 0:
            return self._xor_bits(self._xor_bits(xb, yb), zb)
        if k == 1:          # (x&y)|(~x&z) = z ^ (x & (y^z))
            return self._xor_bits(zb, self._and_bits(
                xb, self._xor_bits(yb, zb)))
        if k == 2:          # (x|~y)^z
            return self._xor_bits(self._or_not_bits(xb, yb), zb)
        if k == 3:          # (x&z)|(y&~z) = y ^ (z & (x^y))
            return self._xor_bits(yb, self._and_bits(
                zb, self._xor_bits(xb, yb)))
        # x ^ (y|~z)
        return self._xor_bits(xb, self._or_not_bits(yb, zb))

    def _lane(self, state, x_words, rounds, rots, consts, reverse_f: bool):
        a, bb, c, d, e = state
        for j in range(80):
            k = (4 - j // 16) if reverse_f else (j // 16)
            fb = self._f(k, self.bits_of(bb), self.bits_of(c),
                         self.bits_of(d))
            k = consts[j // 16]
            t = self._add_mod32([a, self._pack(fb),
                                 x_words[rounds[j]],
                                 self.u32.constant_u32(k)])
            t_rot = self._pack(self._rol_bits(self.bits_of(t), rots[j]))
            t = self._add_mod32([t_rot, e])
            a, e, d, c, bb = e, d, self._pack(
                self._rol_bits(self.bits_of(c), 10)), bb, t
        return [a, bb, c, d, e]

    def compress160(self, state: list, block: list) -> list:
        """One RIPEMD-160 compression: state (5 U32), block (16 LE U32)."""
        assert len(state) == 5 and len(block) == 16
        left = self._lane(list(state), block, RL, SL, KL, reverse_f=False)
        right = self._lane(list(state), block, RR, SR, KR, reverse_f=True)
        h0, h1, h2, h3, h4 = state
        out = [
            self._add_mod32([h1, left[2], right[3]]),
            self._add_mod32([h2, left[3], right[4]]),
            self._add_mod32([h3, left[4], right[0]]),
            self._add_mod32([h4, left[0], right[1]]),
            self._add_mod32([h0, left[1], right[2]]),
        ]
        return out

    # -- byte-level interface (LE words, unlike sha256) -----------------------
    def bytes_to_le_words(self, byte_targets: list) -> list:
        b = self.b
        assert len(byte_targets) % 4 == 0
        words = []
        for i in range(0, len(byte_targets), 4):
            acc = b.zero()
            for j in range(4):
                byte = byte_targets[i + j]
                b.range_check(byte, 8)
                acc = b.arithmetic(1 << (8 * j), 1, byte, b.one(), acc)
            words.append(U32Target(acc))
        return words

    def le_words_to_bytes(self, words: list) -> list:
        b = self.b
        out = []
        for wt in words:
            byts = [b.add_virtual_target() for _ in range(4)]

            def gen(pw, _w=wt.target, _b=byts):
                v = pw.get(_w)
                if v is None or pw.get(_b[0]) is not None:
                    return
                for j in range(4):
                    pw.set(_b[j], (v >> (8 * j)) & 0xFF)

            b.add_generator(gen, deps=[wt.target])
            acc = b.zero()
            for j in range(4):
                b.range_check(byts[j], 8)
                acc = b.arithmetic(1 << (8 * j), 1, byts[j], b.one(), acc)
            b.connect(acc, wt.target)
            out.extend(byts)
        return out

    def ripemd160_bytes(self, byte_targets: list) -> list:
        """RIPEMD-160 of a fixed-length byte message; returns 20 byte
        targets. Message length must be a multiple of 4."""
        n = len(byte_targets)
        assert n % 4 == 0
        u = self.u32
        words = self.bytes_to_le_words(byte_targets)
        # MD-strengthening padding (LE length)
        bit_len = 8 * n
        words.append(u.constant_u32(0x00000080))
        while (len(words) + 2) % 16 != 0:
            words.append(u.zero_u32())
        words.append(u.constant_u32(bit_len & 0xFFFFFFFF))
        words.append(u.constant_u32((bit_len >> 32) & 0xFFFFFFFF))
        state = [u.constant_u32(v) for v in IV]
        for i in range(0, len(words), 16):
            state = self.compress160(state, words[i:i + 16])
        return self.le_words_to_bytes(state)

    def hash160_bytes(self, byte_targets: list) -> list:
        """hash160 = ripemd160(sha256(x)) — 20 byte targets (btc.rs
        btc_hash160 twin)."""
        return self.ripemd160_bytes(self.sha256_bytes(byte_targets))
