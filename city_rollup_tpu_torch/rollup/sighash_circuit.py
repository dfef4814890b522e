"""CRSigHashCircuit: the Dogecoin sighash/introspection circuit family.

One circuit per transaction *shape* (SigHashGadgetId): it parses the raw
sighash preimage and every funding transaction as byte targets at
compile-time-fixed offsets, enforces the covenant script layout, extracts
deposits/withdrawals/state-hashes, computes sighash = sha256d(preimage)
through the batched SHA256 accelerator, and outputs
``[introspection_finalized_hash (4), sighash_felt252 (4)]``.

Reference: `CRSigHashCircuit`
(city_rollup_circuit/src/sighash_circuits/sighash.rs:44-156) with the byte
gadgets of city_rollup_circuit/src/introspection/gadgets/{transaction,
rollup/introspection}.rs (SURVEY.md §2.5). Fixed-shape parsing is the
TPU-first win: every offset is static, so "parsing" costs zero rows — only
the hashes and felt packings materialize constraints, and those ride the
batched accelerator + Poseidon rows.

Shapes are enumerated by `btc.generate_id_permutations` (1,875 for the
standard 4/4 config); `SigHashShape.layout()` derives every byte offset
from (SigHashGadgetId, BlockSpendCoreConfig).

Counterpart of the reference's ``rollup/sighash_circuit.py``, on the
port's circuit builder: the same rows; the circuit and its accelerator
are built for one ``device``, where their preprocessing and proofs run.
"""

from __future__ import annotations

import dataclasses

from ..snark import recursion
from ..snark.circuit import CircuitBuilder, CircuitData
from ..snark.config import CircuitConfig
from ..snark import prover as snark_prover
from ..snark.prover import Proof
from ..snark.ripemd160 import Ripemd160Gadget
from ..snark.sha256 import set_bytes_witness
from . import btc
from .sha256_accelerator import (Sha256AcceleratorCircuit,
                                 commitment_root_host)

P = (1 << 64) - (1 << 32) + 1


def varint_len(n: int) -> int:
    return 1 if n < 0xFD else (3 if n <= 0xFFFF else 5)


@dataclasses.dataclass
class SigHashShape:
    """All byte lengths/offsets of one (gadget id, core config) shape."""
    gid: btc.SigHashGadgetId
    cfg: btc.BlockSpendCoreConfig

    @property
    def n_inputs(self) -> int:
        return self.gid.num_deposits + 1

    @property
    def n_outputs(self) -> int:
        return self.gid.num_withdrawals + 1

    def input_script_len(self, i: int) -> int:
        return self.cfg.block_sighash_script_size \
            if i == self.gid.current_spend_index else 0

    def output_script_len(self, j: int) -> int:
        return self.cfg.block_output_script_size if j == 0 else \
            self.cfg.withdrawal_output_script_size

    def preimage_layout(self):
        """Returns (total_len, input_offsets, output_offsets) where
        input_offsets[i] = (txid_off, vout_off, script_off, script_len),
        output_offsets[j] = (value_off, script_off, script_len)."""
        off = 4                                   # version
        off += varint_len(self.n_inputs)
        ins = []
        for i in range(self.n_inputs):
            txid_off = off
            off += 32
            vout_off = off
            off += 4
            slen = self.input_script_len(i)
            off += varint_len(slen)
            script_off = off
            off += slen
            off += 4                              # sequence
            ins.append((txid_off, vout_off, script_off, slen))
        off += varint_len(self.n_outputs)
        outs = []
        for j in range(self.n_outputs):
            value_off = off
            off += 8
            slen = self.output_script_len(j)
            off += varint_len(slen)
            script_off = off
            off += slen
            outs.append((value_off, script_off, slen))
        off += 4                                  # locktime
        off += 4                                  # sighash type
        return off, ins, outs

    def funding_tx_layout(self, i: int):
        """Funding tx i: the block tx (i == block_spend_index, spending the
        previous covenant with `last_block_*` counts) or a deposit tx.
        Returns (total_len, input_offsets, output_offsets) like above."""
        if i == self.cfg.block_spend_index:
            n_in = self.gid.last_block_num_deposits + 1
            n_out = self.gid.last_block_num_withdrawals + 1
            in_slen = [self.cfg.block_funding_script_size if k ==
                       self.cfg.block_spend_index else
                       self.cfg.deposit_funding_script_size
                       for k in range(n_in)]
            out_slen = [self.cfg.block_output_script_size if j == 0 else
                        self.cfg.withdrawal_output_script_size
                        for j in range(n_out)]
        else:
            n_in, n_out = 1, 1
            in_slen = [self.cfg.deposit_funding_script_size]
            out_slen = [self.cfg.block_output_script_size]
        off = 4 + varint_len(n_in)
        ins = []
        for k in range(n_in):
            txid_off = off
            off += 32
            vout_off = off
            off += 4
            off += varint_len(in_slen[k])
            script_off = off
            off += in_slen[k]
            off += 4
            ins.append((txid_off, vout_off, script_off, in_slen[k]))
        off += varint_len(n_out)
        outs = []
        for j in range(n_out):
            value_off = off
            off += 8
            off += varint_len(out_slen[j])
            script_off = off
            off += out_slen[j]
            outs.append((value_off, script_off, out_slen[j]))
        off += 4
        return off, ins, outs


# ---------------------------------------------------------------------------
# felt-packing helpers over byte targets
# ---------------------------------------------------------------------------

def _byte_bits(b: CircuitBuilder, g, byte_targets: list) -> list:
    """LE bit list of a byte string (one 8-bit split per byte)."""
    from ..snark.gadgets import split_le_16
    bits = []
    for t in byte_targets:
        row_bits = split_le_16(b, t)
        for i in range(8, 16):
            b.assert_zero(row_bits[i])
        bits.extend(row_bits[:8])
    return bits


def _bits_to_felts(b: CircuitBuilder, bits: list, bits_per_felt: int,
                   n_felts: int) -> list:
    out = []
    for i in range(n_felts):
        chunk = bits[i * bits_per_felt:(i + 1) * bits_per_felt]
        acc = b.zero()
        for j, bit in enumerate(chunk):
            acc = b.arithmetic(pow(2, j, P), 1, bit, b.one(), acc)
        out.append(acc)
    return out


def felt252_of_bytes(b, g, byte_targets: list) -> list:
    """32 bytes -> 4 x 63-bit felts (crypto.felts.hash256_to_felt252 twin)."""
    assert len(byte_targets) == 32
    return _bits_to_felts(b, _byte_bits(b, g, byte_targets), 63, 4)


def felt248_of_bytes(b, g, byte_targets: list) -> list:
    """First 31 bytes -> 4 x 62-bit felts (felt248 twin)."""
    return _bits_to_felts(b, _byte_bits(b, g, byte_targets[:31]), 62, 4)


def felt248_of_hashout(b, h4: list) -> list:
    """felt248 packing of a 4-felt HashOut, matching
    felt248_of_bytes(qhashout.to_bytes(h)): the canonical LE byte encoding's
    first 31 bytes regrouped as 4 x 62-bit felts. canonical=True on the bit
    split so a prover cannot substitute x+p for x (reference binding:
    felthash248.rs connect_full_hashout_to_felt248_hashout)."""
    from ..snark.gadgets import split_le_64
    bits = []
    for t in h4:
        bits.extend(split_le_64(b, t, canonical=True))
    return _bits_to_felts(b, bits[:248], 62, 4)


def hash224_of_bytes(b, byte_targets: list) -> list:
    """First 28 bytes -> 4 x 56-bit LE felts (txid224 twin)."""
    out = []
    for i in range(4):
        acc = b.zero()
        for j in range(7):
            t = byte_targets[7 * i + j]
            b.range_check(t, 8)
            acc = b.arithmetic(1 << (8 * j), 1, t, b.one(), acc)
        out.append(acc)
    return out


def le_value_felt(b, byte_targets: list) -> object:
    """8 LE bytes -> value felt, constrained < 2^61."""
    assert len(byte_targets) == 8
    acc = b.zero()
    for j, t in enumerate(byte_targets):
        b.range_check(t, 8 if j < 7 else 5)
        acc = b.arithmetic(1 << (8 * j), 1, t, b.one(), acc)
    return acc


def pk33_felts(b, byte_targets: list) -> list:
    """33-byte compressed pubkey -> 9 LE 4-byte felts
    (crypto.felts.bytes33_to_felts twin)."""
    assert len(byte_targets) == 33
    out = []
    for i in range(9):
        chunk = byte_targets[4 * i:4 * i + 4]
        acc = b.zero()
        for j, t in enumerate(chunk):
            b.range_check(t, 8)
            acc = b.arithmetic(1 << (8 * j), 1, t, b.one(), acc)
        out.append(acc)
    return out


def pkh_felts(b, pkh_bytes: list, type_flag: int) -> list:
    """20-byte hash160 -> [56b, 56b, 48b|flag<<48]
    (crypto.felts.hash160_to_felts twin)."""
    assert len(pkh_bytes) == 20
    limbs = []
    for (start, count) in ((0, 7), (7, 7), (14, 6)):
        acc = b.zero()
        for j in range(count):
            t = pkh_bytes[start + j]
            b.range_check(t, 8)
            acc = b.arithmetic(1 << (8 * j), 1, t, b.one(), acc)
        limbs.append(acc)
    limbs[2] = b.add_const(limbs[2], type_flag << 48)
    return limbs


def _events_root_gadget(b, leaves: list) -> list:
    """In-circuit twin of btc.events_hash (zero for empty)."""
    if not leaves:
        z = b.zero()
        return [z, z, z, z]
    n = 1
    while n < len(leaves):
        n <<= 1
    z = b.zero()
    leaves = list(leaves) + [[z, z, z, z]] * (n - len(leaves))
    while len(leaves) > 1:
        leaves = [b.hash_two_to_one(leaves[i], leaves[i + 1])
                  for i in range(0, len(leaves), 2)]
    return leaves[0]


# ---------------------------------------------------------------------------
# The circuit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SigHashCircuit:
    data: CircuitData
    shape: SigHashShape
    accel: Sha256AcceleratorCircuit
    targets: dict

    @classmethod
    def build(cls, config: CircuitConfig, shape: SigHashShape,
              script_body: bytes, device=None) -> "SigHashCircuit":
        """`script_body`: the constant covenant body (everything after the
        33-byte state-hash push — embeds the groth16 verifier data; see
        btc.encode_block_script). The circuit and its accelerator are built
        for `device` (CUDA unless ``"cpu"``): the accelerator's verifier
        data, a constant here, is its preprocessing there."""
        cfg = shape.cfg
        pre_len, pre_ins, pre_outs = shape.preimage_layout()
        fund_layouts = [shape.funding_tx_layout(i)
                        for i in range(shape.n_inputs)]
        script_len = cfg.block_sighash_script_size
        assert script_len == 33 + len(script_body)

        # the accelerator proves: sha256d(preimage), sha256d(funding_i)...,
        # sha256(next_redeem_script)
        accel_specs = [(pre_len, True)] + \
            [(fl[0], True) for fl in fund_layouts] + [(script_len, False)]
        accel = Sha256AcceleratorCircuit.build_multi(config, accel_specs,
                                                     device=device)

        b = CircuitBuilder(config)
        g = Ripemd160Gadget(b)

        preimage = b.add_virtual_targets(pre_len)
        fundings = [b.add_virtual_targets(fl[0]) for fl in fund_layouts]
        next_script = b.add_virtual_targets(script_len)

        # --- accelerator binding (digests as virtual byte targets) --------
        planner_pairs = [(preimage,)] + [(f,) for f in fundings] + \
            [(next_script,)]
        digests = [b.add_virtual_targets(32) for _ in planner_pairs]
        sighash_bytes = digests[0]
        fund_txids = digests[1:1 + shape.n_inputs]
        next_script_sha = digests[-1]

        # commitment root must match the accelerator proof's public input
        from .sha256_accelerator import _pad4
        leaves = []
        for (msg,), dig in zip(planner_pairs, digests):
            words_m = [w.target for w in g.bytes_to_u32_words(_pad4(b, msg))]
            for t in dig:
                b.range_check(t, 8)
            words_d = [w.target for w in g.bytes_to_u32_words(dig)]
            leaves.append(b.hash_n_to_hash_no_pad(words_m + words_d))
        from .sha256_accelerator import _commit_root_gadget
        root = _commit_root_gadget(b, leaves)
        accel_pt = recursion.add_virtual_proof(b, accel.data.common)
        accel_vdt = recursion.constant_verifier_data(b, accel.data.verifier)
        recursion.verify_proof_gadget(b, accel_pt, accel.data.common,
                                      accel_vdt)
        b.connect_hashes(accel_pt.public_inputs[0:4], root)

        # --- preimage structural constraints -------------------------------
        consts = _constant_bytes_map(shape, script_body)
        for off, val in consts["preimage"].items():
            b.connect(preimage[off], b.constant(val))

        # funding txids bound into the preimage inputs
        for i, (txid_off, _v, _s, _l) in enumerate(pre_ins):
            for j in range(32):
                b.connect(preimage[txid_off + j], fund_txids[i][j])

        # current covenant script: state hash bytes + constant body
        cur_script_off = pre_ins[shape.gid.current_spend_index][2]
        cur_state_bytes = [preimage[cur_script_off + 1 + j]
                           for j in range(32)]
        for j, v in enumerate(script_body):
            b.connect(preimage[cur_script_off + 33 + j], b.constant(v))
        b.connect(preimage[cur_script_off], b.constant(btc.OP_PUSHBYTES_32))

        # next covenant: output 0 p2sh must commit hash160(next_script)
        out0_off = pre_outs[0][1]
        ripemd_in = next_script_sha
        nxt_h160 = g.ripemd160_bytes(ripemd_in)
        for j in range(20):
            b.connect(preimage[out0_off + 2 + j], nxt_h160[j])
        next_state_bytes = [next_script[1 + j] for j in range(32)]
        for j, v in enumerate(script_body):
            b.connect(next_script[33 + j], b.constant(v))
        b.connect(next_script[0], b.constant(btc.OP_PUSHBYTES_32))

        # --- funding tx structure + deposits -------------------------------
        deposits = []
        cur_balance = None
        for i, (flen, f_ins, f_outs) in enumerate(fund_layouts):
            ftx = fundings[i]
            for off, val in consts["funding"][i].items():
                b.connect(ftx[off], b.constant(val))
            if i == cfg.block_spend_index:
                # previous block tx: output 0 value is the current rollup
                # balance; its covenant input script embeds the previous
                # state (not checked here — the recursion chain covers it)
                v_off = f_outs[0][0]
                cur_balance = le_value_felt(b, [ftx[v_off + j]
                                                for j in range(8)])
            else:
                # deposit tx: pubkey = last 33 bytes of input 0 script
                s_off, s_len = f_ins[0][2], f_ins[0][3]
                pk_bytes = [ftx[s_off + s_len - 33 + j] for j in range(33)]
                v_off = f_outs[0][0]
                val = le_value_felt(b, [ftx[v_off + j] for j in range(8)])
                dep_hash = b.hash_n_to_hash_no_pad(
                    hash224_of_bytes(b, fund_txids[i]) + [val] +
                    pk33_felts(b, pk_bytes))
                deposits.append(dep_hash)

        # --- withdrawals ----------------------------------------------------
        withdrawals = []
        for j in range(1, shape.n_outputs):
            v_off, s_off, s_len = pre_outs[j]
            val = le_value_felt(b, [preimage[v_off + k] for k in range(8)])
            if s_len == 25:                      # p2pkh
                pkh = [preimage[s_off + 3 + k] for k in range(20)]
                flag = 0
            else:                                # p2sh (23)
                pkh = [preimage[s_off + 2 + k] for k in range(20)]
                flag = 1
            withdrawals.append([val] + pkh_felts(b, pkh, flag))

        next_balance = le_value_felt(
            b, [preimage[pre_outs[0][0] + k] for k in range(8)])

        # --- result hash + sighash felt252 ---------------------------------
        dep_root = _events_root_gadget(b, deposits)
        wd_root = _events_root_gadget(b, withdrawals)
        cur_state = felt248_of_bytes(b, g, cur_state_bytes)
        next_state = felt248_of_bytes(b, g, next_state_bytes)
        finalized = b.hash_n_to_hash_no_pad(
            dep_root + wd_root + cur_state + next_state +
            [cur_balance, next_balance,
             b.constant(shape.gid.current_spend_index)])
        sighash_f252 = felt252_of_bytes(b, g, sighash_bytes)

        b.register_public_inputs(finalized)
        b.register_public_inputs(sighash_f252)
        data = b.build(device=device)
        return cls(data=data, shape=shape, accel=accel,
                   targets={"preimage": preimage, "fundings": fundings,
                            "next_script": next_script, "digests": digests,
                            "accel_pt": accel_pt})

    # -- witness -------------------------------------------------------------
    def prove(self, hint: btc.BlockSpendIntrospectionHint) -> Proof:
        pw = self.fill_witness(hint)
        return snark_prover.prove(self.data, pw)

    def fill_witness(self, hint: btc.BlockSpendIntrospectionHint):
        from ..crypto.hashes import sha256, sha256d
        t = self.targets
        msgs = [hint.sighash_preimage] + \
            [ftx.serialize() for ftx in hint.funding_transactions] + \
            [hint.next_block_redeem_script]
        digs = [bytes(sha256d(msgs[0]))] + \
            [bytes(sha256d(m)) for m in msgs[1:-1]] + \
            [bytes(sha256(msgs[-1]))]
        accel_proof = self.accel.prove(msgs)

        pw = self.data._builder.partial_witness()
        set_bytes_witness(pw, t["preimage"], hint.sighash_preimage)
        for f_t, ftx in zip(t["fundings"], hint.funding_transactions):
            set_bytes_witness(pw, f_t, ftx.serialize())
        set_bytes_witness(pw, t["next_script"],
                          hint.next_block_redeem_script)
        for d_t, d in zip(t["digests"], digs):
            set_bytes_witness(pw, d_t, d)
        recursion.set_proof_witness(pw, t["accel_pt"], accel_proof)
        return pw


def _constant_bytes_map(shape: SigHashShape, script_body: bytes) -> dict:
    """Compile-time-known bytes: version/varints/script-length prefixes/
    sequence/locktime/sighash-type of the preimage and each funding tx,
    plus fixed script opcodes (everything except txids, values, state
    hashes, pubkeys and pkh bytes)."""
    cfg = shape.cfg

    def tx_consts(n_in, in_slens, n_out, out_slens, version, locktime,
                  with_sighash_type):
        consts = {}
        off = 0
        for k, v in enumerate(version.to_bytes(4, "little")):
            consts[off + k] = v
        off += 4
        for k, v in enumerate(btc.write_varint(n_in)):
            consts[off + k] = v
        off += len(btc.write_varint(n_in))
        for slen in in_slens:
            off += 32 + 4                       # txid, vout free... vout:
            vi = btc.write_varint(slen)
            for k, v in enumerate(vi):
                consts[off + k] = v
            off += len(vi) + slen
            for k, v in enumerate((0xFFFFFFFF).to_bytes(4, "little")):
                consts[off + k] = v
            off += 4
        for k, v in enumerate(btc.write_varint(n_out)):
            consts[off + k] = v
        off += len(btc.write_varint(n_out))
        for slen in out_slens:
            off += 8
            vi = btc.write_varint(slen)
            for k, v in enumerate(vi):
                consts[off + k] = v
            off += len(vi) + slen
        for k, v in enumerate(locktime.to_bytes(4, "little")):
            consts[off + k] = v
        off += 4
        if with_sighash_type:
            for k, v in enumerate(cfg.sighash_type.to_bytes(4, "little")):
                consts[off + k] = v
        return consts

    pre = tx_consts(
        shape.n_inputs,
        [shape.input_script_len(i) for i in range(shape.n_inputs)],
        shape.n_outputs,
        [shape.output_script_len(j) for j in range(shape.n_outputs)],
        cfg.version, cfg.locktime, True)
    # fixed p2sh prefix of output 0: OP_HASH160 0x14 ... OP_EQUAL
    _plen, _pins, pouts = shape.preimage_layout()
    o0 = pouts[0][1]
    pre[o0] = btc.OP_HASH160
    pre[o0 + 1] = 20
    pre[o0 + 22] = btc.OP_EQUAL
    for j in range(1, shape.n_outputs):
        so = pouts[j][1]
        if pouts[j][2] == 25:
            pre[so] = btc.OP_DUP
            pre[so + 1] = btc.OP_HASH160
            pre[so + 2] = 20
            pre[so + 23] = btc.OP_EQUALVERIFY
            pre[so + 24] = btc.OP_CHECKSIG
        else:
            pre[so] = btc.OP_HASH160
            pre[so + 1] = 20
            pre[so + 22] = btc.OP_EQUAL

    fund = []
    for i in range(shape.n_inputs):
        _flen, f_ins, f_outs = shape.funding_tx_layout(i)
        if i == cfg.block_spend_index:
            n_in = shape.gid.last_block_num_deposits + 1
            n_out = shape.gid.last_block_num_withdrawals + 1
        else:
            n_in, n_out = 1, 1
        consts = tx_consts(n_in, [x[3] for x in f_ins], n_out,
                           [x[2] for x in f_outs], cfg.version,
                           cfg.locktime, False)
        fund.append(consts)
    return {"preimage": pre, "funding": fund}
