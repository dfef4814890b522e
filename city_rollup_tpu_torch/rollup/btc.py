"""Dogecoin/BTC transaction data model + sighash preimages + the rollup's
covenant block script templates and introspection hints.

Reference roles:
- `BTCTransaction{,Input,Output}` parse/serialize + txid
  (city_rollup_common/src/introspection/transaction.rs);
- legacy SIGHASH_ALL preimage construction
  (introspection/sighash.rs; the preimage the CRSigHashCircuit parses);
- `BlockSpendCoreConfig::generate_permutations` — the 1,875 whitelisted
  sighash circuit shapes (introspection/rollup/introspection.rs:344-430,
  5*5*5*sum(d+1 for d in 0..5) = 1875 with max 4 deposits/4 withdrawals);
- block P2SH covenant script template: OP_PUSHBYTES_32 <state_hash> body
  with groth16 verifier data pushes + OP_CHECKGROTH16VERIFY
  (city_rollup_common/src/block_template/config.rs:26-96, 489-byte
  template);
- `BlockSpendIntrospectionHint` — everything the sighash circuit needs
  as witness (introspection/rollup/introspection.rs:34-46);
- introspection results: deposit (txid224, pubkey, value) and withdrawal
  (script, value) felt encodings (introspection_result.rs).

Counterpart of the reference's ``rollup/btc.py``: a copy.
"""

from __future__ import annotations

import dataclasses
import io

from ..crypto import felts as feltenc
from ..crypto.hashes import hash160 as _hash160
from ..crypto.hashes import sha256d
from ..core import poseidon_host

P = (1 << 64) - (1 << 32) + 1

SIGHASH_ALL = 1

# script opcodes used by the covenant (block_template/config.rs:11-31)
OP_PUSHBYTES_32 = 0x20
OP_PUSHDATA1 = 0x4C
OP_SWAP = 0x7C
OP_DUP = 0x76
OP_SHA256 = 0xA8
OP_EQUALVERIFY = 0x88
OP_1 = 0x51
OP_2DROP = 0x6D
OP_NOP = 0x61
OP_0NOTEQUAL = 0x92
OP_CHECKGROTH16VERIFY = 0xB3
OP_HASH160 = 0xA9
OP_EQUAL = 0x87
OP_CHECKSIG = 0xAC

# dev-mode escape hatch: replaces OP_CHECKGROTH16VERIFY with OP_NOP so the
# pipeline runs without the Groth16 wrap (block_template/config.rs:7).
GROTH16_DISABLED_DEV_MODE = False


# ---------------------------------------------------------------------------
# var-int + serialization helpers
# ---------------------------------------------------------------------------

def write_varint(n: int) -> bytes:
    if n < 0xFD:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + n.to_bytes(2, "little")
    if n <= 0xFFFFFFFF:
        return b"\xfe" + n.to_bytes(4, "little")
    return b"\xff" + n.to_bytes(8, "little")


def read_varint(r: io.BytesIO) -> int:
    b0 = r.read(1)[0]
    if b0 < 0xFD:
        return b0
    size = {0xFD: 2, 0xFE: 4, 0xFF: 8}[b0]
    return int.from_bytes(r.read(size), "little")


# ---------------------------------------------------------------------------
# Transactions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BTCTransactionInput:
    hash: bytes                 # 32-byte prev txid (little-endian on wire)
    index: int
    script: bytes
    sequence: int = 0xFFFFFFFF

    def serialize(self) -> bytes:
        return (self.hash + self.index.to_bytes(4, "little") +
                write_varint(len(self.script)) + self.script +
                self.sequence.to_bytes(4, "little"))

    @classmethod
    def parse(cls, r: io.BytesIO) -> "BTCTransactionInput":
        h = r.read(32)
        idx = int.from_bytes(r.read(4), "little")
        slen = read_varint(r)
        script = r.read(slen)
        seq = int.from_bytes(r.read(4), "little")
        return cls(hash=h, index=idx, script=script, sequence=seq)


@dataclasses.dataclass
class BTCTransactionOutput:
    value: int
    script: bytes

    def serialize(self) -> bytes:
        return (self.value.to_bytes(8, "little") +
                write_varint(len(self.script)) + self.script)

    @classmethod
    def parse(cls, r: io.BytesIO) -> "BTCTransactionOutput":
        value = int.from_bytes(r.read(8), "little")
        slen = read_varint(r)
        return cls(value=value, script=r.read(slen))


@dataclasses.dataclass
class BTCTransaction:
    version: int
    inputs: list
    outputs: list
    locktime: int = 0

    def serialize(self) -> bytes:
        out = [self.version.to_bytes(4, "little"),
               write_varint(len(self.inputs))]
        out += [i.serialize() for i in self.inputs]
        out.append(write_varint(len(self.outputs)))
        out += [o.serialize() for o in self.outputs]
        out.append(self.locktime.to_bytes(4, "little"))
        return b"".join(out)

    @classmethod
    def parse(cls, data: bytes) -> "BTCTransaction":
        r = io.BytesIO(data)
        version = int.from_bytes(r.read(4), "little")
        n_in = read_varint(r)
        inputs = [BTCTransactionInput.parse(r) for _ in range(n_in)]
        n_out = read_varint(r)
        outputs = [BTCTransactionOutput.parse(r) for _ in range(n_out)]
        locktime = int.from_bytes(r.read(4), "little")
        return cls(version=version, inputs=inputs, outputs=outputs,
                   locktime=locktime)

    def txid(self) -> bytes:
        """sha256d of the serialization (internal byte order)."""
        return bytes(sha256d(self.serialize()))

    @classmethod
    def dummy(cls) -> "BTCTransaction":
        return cls(version=2, inputs=[], outputs=[], locktime=0)


def sighash_preimage(tx: BTCTransaction, input_index: int,
                     subscript: bytes,
                     sighash_type: int = SIGHASH_ALL) -> bytes:
    """Legacy SIGHASH_ALL preimage: tx with every input's script emptied
    except `input_index` (replaced by `subscript`), followed by the 4-byte
    hash type (introspection/sighash.rs preimage layout)."""
    mod_inputs = [
        BTCTransactionInput(hash=i.hash, index=i.index,
                            script=(subscript if k == input_index else b""),
                            sequence=i.sequence)
        for k, i in enumerate(tx.inputs)]
    mod = BTCTransaction(version=tx.version, inputs=mod_inputs,
                         outputs=tx.outputs, locktime=tx.locktime)
    return mod.serialize() + sighash_type.to_bytes(4, "little")


def sighash(tx: BTCTransaction, input_index: int, subscript: bytes,
            sighash_type: int = SIGHASH_ALL) -> bytes:
    return bytes(sha256d(sighash_preimage(tx, input_index, subscript,
                                          sighash_type)))


# ---------------------------------------------------------------------------
# Standard scripts
# ---------------------------------------------------------------------------

def p2pkh_script(pubkey_hash160: bytes) -> bytes:
    """25-byte pay-to-pubkey-hash output script."""
    assert len(pubkey_hash160) == 20
    return bytes([OP_DUP, OP_HASH160, 20]) + pubkey_hash160 + \
        bytes([OP_EQUALVERIFY, OP_CHECKSIG])


def p2sh_script(script_hash160: bytes) -> bytes:
    """23-byte pay-to-script-hash output script."""
    assert len(script_hash160) == 20
    return bytes([OP_HASH160, 20]) + script_hash160 + bytes([OP_EQUAL])


def p2sh_address_of(redeem_script: bytes) -> bytes:
    return bytes(_hash160(redeem_script))


# ---------------------------------------------------------------------------
# Block covenant script (the 489-byte template)
# ---------------------------------------------------------------------------

BLOCK_SCRIPT_LEN = 489
# five 80-byte chunks of groth16 verifier data embedded in the script body;
# chunk 0 is committed by its sha256 (block_template/verifier_data.rs role).
G16_VD_CHUNKS = 6
G16_VD_CHUNK_LEN = 80


def encode_block_script(state_hash: bytes, g16_vd_chunks: list[bytes],
                        genesis: bool = False) -> bytes:
    """The 489-byte block P2SH redeem script:
    PUSH32 <state_hash> ; SWAP DUP SHA256 PUSH32 <sha256(vd[0])>
    EQUALVERIFY ; PUSHDATA1 80 <vd[1..6]> x5 ; 1 OP_CHECKGROTH16VERIFY
    2DROP x6 1  (block_template/config.rs:36-96)."""
    assert len(state_hash) == 32
    assert len(g16_vd_chunks) == G16_VD_CHUNKS
    assert all(len(c) == G16_VD_CHUNK_LEN for c in g16_vd_chunks)
    from ..crypto.hashes import sha256
    op_action = OP_0NOTEQUAL if genesis else (
        OP_NOP if GROTH16_DISABLED_DEV_MODE else OP_CHECKGROTH16VERIFY)
    body = bytes([OP_SWAP, OP_DUP, OP_SHA256, OP_PUSHBYTES_32]) + \
        bytes(sha256(g16_vd_chunks[0])) + bytes([OP_EQUALVERIFY])
    for chunk in g16_vd_chunks[1:]:
        body += bytes([OP_PUSHDATA1, G16_VD_CHUNK_LEN]) + chunk
    body += bytes([OP_1, op_action] + [OP_2DROP] * 6 + [OP_1])
    script = bytes([OP_PUSHBYTES_32]) + state_hash + body
    assert len(script) == BLOCK_SCRIPT_LEN, len(script)
    return script


# Dev-tier shrunken covenant: the spend config + script body the test
# suite and the committed sighash-corpus fixture are generated against
# (the production corpus pins the full 489-byte script body, which embeds
# the deployment's Groth16 verifier-data chunks).
DEV_SPEND_CFG_KW = dict(
    block_spend_index=0, block_funding_script_size=20,
    block_sighash_script_size=41, block_output_script_size=23,
    deposit_funding_script_size=40, withdrawal_output_script_size=25,
    sighash_type=1, locktime=0, version=2)
DEV_SCRIPT_BODY = bytes(range(8))


def dev_spend_cfg() -> "BlockSpendCoreConfig":
    return BlockSpendCoreConfig(**DEV_SPEND_CFG_KW)


def push_data(data: bytes) -> bytes:
    """Minimal script push encoding for arbitrary data."""
    n = len(data)
    if n < 0x4c:
        return bytes([n]) + data
    if n <= 0xFF:
        return bytes([OP_PUSHDATA1, n]) + data
    assert n <= 0xFFFF
    return bytes([0x4d]) + n.to_bytes(2, "little") + data


def encode_binary_witness_script_for_p2sh(base_script: bytes,
                                          inputs: list[bytes]) -> bytes:
    """The P2SH spend script: push every witness item (the four 48-byte
    Groth16 proof elements + verifier-data chunks), then the redeem script
    itself (block_template/data.rs encode_binary_witness_script_for_p2sh
    twin — what CityGroth16ProofData.encode_witness_script assembles)."""
    out = b"".join(push_data(item) for item in inputs)
    return out + push_data(base_script)


# ---------------------------------------------------------------------------
# Spend-shape configs + permutations (the whitelist universe)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSpendCoreConfig:
    """Template constants for one covenant deployment
    (BlockSpendCoreConfig twin, introspection.rs:344-368)."""
    block_spend_index: int = 0
    block_funding_script_size: int = 770
    block_sighash_script_size: int = BLOCK_SCRIPT_LEN
    block_output_script_size: int = 23
    deposit_funding_script_size: int = 106
    withdrawal_output_script_size: int = 25
    sighash_type: int = SIGHASH_ALL
    locktime: int = 0
    version: int = 2

    @classmethod
    def standard_p2sh_p2pkh(cls) -> "BlockSpendCoreConfig":
        return cls()


@dataclasses.dataclass(frozen=True)
class SigHashGadgetId:
    """The 5 shape parameters that determine one sighash circuit
    (SigHashGadgetId twin)."""
    last_block_num_deposits: int
    last_block_num_withdrawals: int
    num_deposits: int
    num_withdrawals: int
    current_spend_index: int

    def to_felt(self) -> int:
        return (self.last_block_num_deposits |
                (self.last_block_num_withdrawals << 8) |
                (self.num_deposits << 16) |
                (self.num_withdrawals << 24) |
                (self.current_spend_index << 32))


def generate_id_permutations(max_deposits: int = 4,
                             max_withdrawals: int = 4
                             ) -> list[SigHashGadgetId]:
    """All whitelisted sighash shapes: 1,875 for (4, 4)
    (generate_permutations twin, introspection.rs:369-430)."""
    out = []
    for last_wd in range(max_withdrawals + 1):
        for last_dep in range(max_deposits + 1):
            for num_wd in range(max_withdrawals + 1):
                for num_dep in range(max_deposits + 1):
                    for spend_idx in range(num_dep + 1):
                        out.append(SigHashGadgetId(
                            last_block_num_deposits=last_dep,
                            last_block_num_withdrawals=last_wd,
                            num_deposits=num_dep,
                            num_withdrawals=num_wd,
                            current_spend_index=spend_idx))
    return out


# ---------------------------------------------------------------------------
# Introspection hint + result (witness + circuit-output data models)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockSpendIntrospectionHint:
    """Everything the sighash circuit consumes as witness for ONE tx input
    (BlockSpendIntrospectionHint twin, introspection.rs:34-46)."""
    sighash_preimage: bytes
    last_block_spend_index: int
    block_spend_index: int
    current_spend_index: int
    funding_transactions: list          # list[BTCTransaction]
    next_block_redeem_script: bytes

    def gadget_id(self) -> SigHashGadgetId:
        tx = BTCTransaction.parse(self.sighash_preimage[:-4])
        num_dep = len(tx.inputs) - 1
        num_wd = len(tx.outputs) - 1
        fund = self.funding_transactions[self.block_spend_index]
        return SigHashGadgetId(
            last_block_num_deposits=len(fund.inputs) - 1,
            last_block_num_withdrawals=len(fund.outputs) - 1,
            num_deposits=num_dep,
            num_withdrawals=num_wd,
            current_spend_index=self.current_spend_index)

    def sighash(self) -> bytes:
        return bytes(sha256d(self.sighash_preimage))

    def to_dict(self) -> dict:
        return {
            "sighash_preimage": self.sighash_preimage.hex(),
            "last_block_spend_index": self.last_block_spend_index,
            "block_spend_index": self.block_spend_index,
            "current_spend_index": self.current_spend_index,
            "funding_transactions": [f.serialize().hex()
                                     for f in self.funding_transactions],
            "next_block_redeem_script": self.next_block_redeem_script.hex(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BlockSpendIntrospectionHint":
        return cls(
            sighash_preimage=bytes.fromhex(d["sighash_preimage"]),
            last_block_spend_index=d["last_block_spend_index"],
            block_spend_index=d["block_spend_index"],
            current_spend_index=d["current_spend_index"],
            funding_transactions=[
                BTCTransaction.parse(bytes.fromhex(h))
                for h in d["funding_transactions"]],
            next_block_redeem_script=bytes.fromhex(
                d["next_block_redeem_script"]))


@dataclasses.dataclass
class IntrospectionDeposit:
    """(txid224, 33-byte pubkey, value) — deposit discovered by parsing a
    funding tx (BTCRollupIntrospectionResultDeposit twin)."""
    txid: bytes
    public_key: bytes
    value: int

    def txid224(self) -> list[int]:
        return feltenc.hash256_to_hash224(self.txid)

    def hash(self) -> list[int]:
        pk_felts = feltenc.bytes33_to_felts(self.public_key)
        return poseidon_host.hash_no_pad(
            self.txid224() + [self.value] + pk_felts)


@dataclasses.dataclass
class IntrospectionWithdrawal:
    """(output script, value) — withdrawal read from a block tx output
    (BTCRollupIntrospectionResultWithdrawal twin)."""
    script: bytes
    value: int

    def hash(self) -> list[int]:
        """[value, pkh56, pkh56, pkh48|flag<<48] (introspection_result.rs
        get_hash: p2sh len 23 flag 1, p2pkh len 25 flag 0)."""
        n = len(self.script)
        assert n in (23, 25), "only p2sh (23) / p2pkh (25) withdrawals"
        if n == 23:
            pkh, flag = self.script[2:22], 1
        else:
            pkh, flag = self.script[3:23], 0
        limbs = feltenc.hash160_to_felts(pkh, flag)
        return [self.value % P] + limbs


def events_hash(event_hashes: list) -> list[int]:
    """Partial Merkle root over event leaf hashes (zero-padded to the next
    power of two; [0,0,0,0] when empty) —
    get_introspection_events_hash twin."""
    if not event_hashes:
        return [0, 0, 0, 0]
    leaves = [list(h) for h in event_hashes]
    n = 1
    while n < len(leaves):
        n <<= 1
    leaves += [[0, 0, 0, 0]] * (n - len(leaves))
    while len(leaves) > 1:
        leaves = [poseidon_host.two_to_one(leaves[i], leaves[i + 1])
                  for i in range(0, len(leaves), 2)]
    return leaves[0]


@dataclasses.dataclass
class IntrospectionResult:
    """What one sighash circuit exposes (BTCRollupIntrospectionResult
    twin): deposits/withdrawals discovered, the two block state hashes,
    balances, and the felt252-packed sighash."""
    deposits: list
    withdrawals: list
    current_block_state_hash: list
    next_block_state_hash: list
    current_block_rollup_balance: int
    next_block_rollup_balance: int
    spend_index: int
    sighash: bytes

    def sighash_felt252(self) -> list[int]:
        return feltenc.hash256_to_felt252(self.sighash)

    def finalized_hash(self) -> list[int]:
        """One digest binding everything the rollup must agree with:
        H(deposit events root, withdrawal events root, state hashes,
        balances, spend index) (get_finalized_result role)."""
        dep_root = events_hash([d.hash() for d in self.deposits])
        wd_root = events_hash([w.hash() for w in self.withdrawals])
        return poseidon_host.hash_no_pad(
            dep_root + wd_root + list(self.current_block_state_hash) +
            list(self.next_block_state_hash) +
            [self.current_block_rollup_balance % P,
             self.next_block_rollup_balance % P, self.spend_index])


def parse_deposits(funding_transactions: list, block_spend_index: int
                   ) -> list:
    """Extract deposits from the non-block funding transactions: a deposit
    funding tx commits (txid, sender pubkey from its first input's p2pkh
    scriptsig, value of output 0)."""
    out = []
    for i, tx in enumerate(funding_transactions):
        if i == block_spend_index:
            continue
        # p2pkh scriptsig = <sig> <33-byte pubkey>; pubkey is the last push
        sig_script = tx.inputs[0].script
        pubkey = sig_script[-33:]
        out.append(IntrospectionDeposit(txid=tx.txid(), public_key=pubkey,
                                        value=tx.outputs[0].value))
    return out


def parse_withdrawals(block_tx: BTCTransaction) -> list:
    """Outputs 1.. of the block tx are withdrawals (output 0 re-funds the
    next block covenant)."""
    return [IntrospectionWithdrawal(script=o.script, value=o.value)
            for o in block_tx.outputs[1:]]
