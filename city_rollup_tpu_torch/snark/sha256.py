"""In-circuit SHA256 over u32 gadgets (pure gates, no accelerator).

Reference role: city_common_circuit/src/builder/hash/{sha256,
sha256_truncated}.rs — sha256 compression over U32Targets, used where the
STARK accelerator is overkill (single digests inside a circuit). The
reference implements u32 XOR via bit-interleave gates (a CPU trick to dodge
bit shuffles); here bitwise ops run on boolean decompositions with per-bit
arithmetic identities (xor = x+y-2xy, maj = ab+ac+bc-2abc, ch = g^(e&(f^g)))
— the constraint rows evaluate inside the same two batched device kernels
(ArithmeticGate/BaseSumGate) as everything else, which is the TPU-first
shape of this workload.

Bit decompositions are memoized per target so rotations/shifts are free
(rewirings of one split), matching the reference's cost model.

Counterpart of the reference's ``snark/sha256.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

from ..core import gl64
from .u32 import U32Builder, U32Target

P = gl64.P

# SHA256 round constants / IV (FIPS 180-4)
K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


class Sha256Gadget:
    """SHA256 compression circuit-builder with memoized bit decompositions."""

    def __init__(self, b):
        self.b = b
        self.u32 = U32Builder(b)
        self._bits: dict = {}       # target -> 32 LE bit targets

    # -- bit plumbing -------------------------------------------------------
    def bits_of(self, x: U32Target) -> list:
        """32 little-endian bits, memoized per underlying target."""
        key = x.target
        if key not in self._bits:
            self._bits[key] = self.u32.split_bits(x)
        return self._bits[key]

    def _pack(self, bits: list) -> U32Target:
        t = self.u32.from_bits(bits)
        self._bits[t.target] = list(bits)
        return t

    def _xor_bits(self, xs: list, ys: list) -> list:
        b = self.b
        return [b.arithmetic(P - 2, 1, x, y, b.add(x, y))
                for x, y in zip(xs, ys)]

    def _and_bits(self, xs: list, ys: list) -> list:
        return [self.b.mul(x, y) for x, y in zip(xs, ys)]

    # -- sha256 bit functions ----------------------------------------------
    def _rotr(self, bits: list, n: int) -> list:
        return bits[n:] + bits[:n]

    def _shr(self, bits: list, n: int) -> list:
        z = self.b.zero()
        return bits[n:] + [z] * n

    def _small_sigma0(self, bits):                       # rotr7 ^ rotr18 ^ shr3
        return self._xor_bits(self._xor_bits(self._rotr(bits, 7),
                                             self._rotr(bits, 18)),
                              self._shr(bits, 3))

    def _small_sigma1(self, bits):                       # rotr17 ^ rotr19 ^ shr10
        return self._xor_bits(self._xor_bits(self._rotr(bits, 17),
                                             self._rotr(bits, 19)),
                              self._shr(bits, 10))

    def _big_sigma0(self, bits):                         # rotr2 ^ rotr13 ^ rotr22
        return self._xor_bits(self._xor_bits(self._rotr(bits, 2),
                                             self._rotr(bits, 13)),
                              self._rotr(bits, 22))

    def _big_sigma1(self, bits):                         # rotr6 ^ rotr11 ^ rotr25
        return self._xor_bits(self._xor_bits(self._rotr(bits, 6),
                                             self._rotr(bits, 11)),
                              self._rotr(bits, 25))

    def _ch(self, e_bits, f_bits, g_bits) -> list:
        """ch = g ^ (e & (f ^ g)) — 2 muls/bit."""
        fg = self._xor_bits(f_bits, g_bits)
        efg = self._and_bits(e_bits, fg)
        return self._xor_bits(g_bits, efg)

    def _maj(self, a_bits, b_bits, c_bits) -> list:
        """maj = ab + ac + bc - 2abc per bit."""
        b = self.b
        out = []
        for x, y, z in zip(a_bits, b_bits, c_bits):
            xy = b.mul(x, y)
            m = b.mul_add(x, z, xy)
            m = b.mul_add(y, z, m)
            m = b.arithmetic(P - 2, 1, xy, z, m)
            out.append(m)
        return out

    def _add_mod32(self, terms: list) -> U32Target:
        out, _carry = self.u32.add_many_u32(terms)
        return out

    # -- compression ---------------------------------------------------------
    def compress(self, state: list, block: list) -> list:
        """One SHA256 compression: state (8 U32), block (16 U32, BE words)
        -> new state (8 U32)."""
        assert len(state) == 8 and len(block) == 16
        w = list(block)
        w_bits = [self.bits_of(x) for x in w]
        for i in range(16, 64):
            s0 = self._small_sigma0(w_bits[i - 15])
            s1 = self._small_sigma1(w_bits[i - 2])
            wi = self._add_mod32([self._pack(s0), self._pack(s1),
                                  w[i - 16], w[i - 7]])
            w.append(wi)
            w_bits.append(self.bits_of(wi))

        a, bb, c, d, e, f, g, h = state
        for i in range(64):
            eb, fb, gb = self.bits_of(e), self.bits_of(f), self.bits_of(g)
            ab, bbb, cb = self.bits_of(a), self.bits_of(bb), self.bits_of(c)
            t1 = self._add_mod32([h, self._pack(self._big_sigma1(eb)),
                                  self._pack(self._ch(eb, fb, gb)),
                                  self.u32.constant_u32(K[i]), w[i]])
            t2 = self._add_mod32([self._pack(self._big_sigma0(ab)),
                                  self._pack(self._maj(ab, bbb, cb))])
            h, g, f = g, f, e
            e = self._add_mod32([d, t1])
            d, c, bb = c, bb, a
            a = self._add_mod32([t1, t2])
        return [self._add_mod32([x, y])
                for x, y in zip([a, bb, c, d, e, f, g, h], state)]

    # -- full hashes (build-time-fixed lengths) -------------------------------
    def digest_blocks(self, blocks: list) -> list:
        """blocks: list of 16-U32 blocks (already padded). Returns 8 U32."""
        state = [self.u32.constant_u32(v) for v in IV]
        for blk in blocks:
            state = self.compress(state, blk)
        return state

    def pad_message_u32(self, words: list, bit_len: int) -> list:
        """FIPS padding for a message of `bit_len` bits given as 32-bit
        words (bit_len % 32 == 0 — byte messages are packed first).
        Returns a list of 16-word blocks."""
        assert bit_len % 32 == 0 and len(words) == bit_len // 32
        u = self.u32
        padded = list(words)
        padded.append(u.constant_u32(0x80000000))
        while (len(padded) + 2) % 16 != 0:
            padded.append(u.zero_u32())
        padded.append(u.constant_u32((bit_len >> 32) & 0xFFFFFFFF))
        padded.append(u.constant_u32(bit_len & 0xFFFFFFFF))
        return [padded[i:i + 16] for i in range(0, len(padded), 16)]

    def digest_u32_message(self, words: list) -> list:
        """SHA256 of a message of len(words)*4 bytes given as BE 32-bit
        words; returns 8 U32 digest words."""
        return self.digest_blocks(self.pad_message_u32(words,
                                                       32 * len(words)))

    # -- byte-target interface (Hash256BytesTarget role) ----------------------
    def bytes_to_u32_words(self, byte_targets: list) -> list:
        """Pack 8-bit byte targets (big-endian) into U32 words; each byte is
        range-checked. len must be a multiple of 4."""
        b = self.b
        assert len(byte_targets) % 4 == 0
        words = []
        for i in range(0, len(byte_targets), 4):
            acc = b.zero()
            for j in range(4):
                byte = byte_targets[i + j]
                b.range_check(byte, 8)
                acc = b.arithmetic(1 << (8 * (3 - j)), 1, byte, b.one(), acc)
            words.append(U32Target(acc))
        return words

    def u32_words_to_bytes(self, words: list) -> list:
        """Split U32 words into 4 BE byte targets each (range-checked)."""
        b = self.b
        out = []
        for wt in words:
            byts = [b.add_virtual_target() for _ in range(4)]

            def gen(pw, _w=wt.target, _b=byts):
                v = pw.get(_w)
                if v is None or pw.get(_b[0]) is not None:
                    return
                for j in range(4):
                    pw.set(_b[j], (v >> (8 * (3 - j))) & 0xFF)

            b.add_generator(gen, deps=[wt.target])
            acc = b.zero()
            for j in range(4):
                b.range_check(byts[j], 8)
                acc = b.arithmetic(1 << (8 * (3 - j)), 1, byts[j], b.one(),
                                   acc)
            b.connect(acc, wt.target)
            out.extend(byts)
        return out

    def _pad_blocks_bytes(self, byte_targets: list) -> list:
        """FIPS padding at BYTE granularity (arbitrary message length —
        sighash preimages are not 4-byte-aligned): the 0x80 marker lands
        inside the trailing partial word when len % 4 != 0."""
        b = self.b
        u = self.u32
        n = len(byte_targets)
        full = n - (n % 4)
        words = self.bytes_to_u32_words(byte_targets[:full])
        if n % 4:
            rem = byte_targets[full:]
            acc = b.zero()
            for j, byte in enumerate(rem):
                b.range_check(byte, 8)
                acc = b.arithmetic(1 << (8 * (3 - j)), 1, byte, b.one(),
                                   acc)
            acc = b.add_const(acc, 0x80 << (8 * (3 - len(rem))))
            words.append(U32Target(acc))
        else:
            words.append(u.constant_u32(0x80000000))
        padded = list(words)
        while (len(padded) + 2) % 16 != 0:
            padded.append(u.zero_u32())
        bit_len = 8 * n
        padded.append(u.constant_u32((bit_len >> 32) & 0xFFFFFFFF))
        padded.append(u.constant_u32(bit_len & 0xFFFFFFFF))
        return [padded[i:i + 16] for i in range(0, len(padded), 16)]

    def sha256_bytes(self, byte_targets: list) -> list:
        """SHA256 of a fixed-length byte message (targets) of ANY length;
        returns 32 byte targets."""
        digest = self.digest_blocks(self._pad_blocks_bytes(byte_targets))
        return self.u32_words_to_bytes(digest)

    def sha256d_bytes(self, byte_targets: list) -> list:
        """double-SHA256 (the BTC sighash: sha256(sha256(preimage)))."""
        return self.sha256_bytes(self.sha256_bytes(byte_targets))

    def two_to_one(self, left_bytes: list, right_bytes: list) -> list:
        """sha256(left||right) for two 32-byte digests (sha256 Merkle
        interior node — hash/merkle/gadgets/sha256 twin)."""
        assert len(left_bytes) == 32 and len(right_bytes) == 32
        return self.sha256_bytes(list(left_bytes) + list(right_bytes))


def set_bytes_witness(pw, byte_targets: list, data: bytes):
    assert len(byte_targets) == len(data)
    for t, v in zip(byte_targets, data):
        pw.set(t, v)


def get_bytes_witness(pw, byte_targets: list) -> bytes:
    return bytes(pw.get(t) for t in byte_targets)
