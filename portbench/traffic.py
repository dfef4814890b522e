"""The general traffic generator: a mix's parameters (``traffic/*.json``)
and a seed -> the rollup's requests, as plain data.

A mix names a genesis (users registered and funded at checkpoint 0, as the
CLI's demo genesis does), an optional prelude block (planned at checkpoint
1 and never proven: the blocks before the measured ones), and ``blocks``
blocks of ``per_block`` requests of each family. Every seed gives the same
counts in the same order; the seed draws the keys, values, addresses and
users. Requests are plain dicts, so that the program and the reference
each build their own request objects from the same data.
"""

from __future__ import annotations

import numpy as np

from .ref.crypto.felts import bytes33_to_felts

P = (1 << 64) - (1 << 32) + 1
FAMILIES = ("register", "claim", "transfer", "add_withdrawal",
            "process_withdrawal", "add_deposit")
# the fields of each family's request dataclass in the orchestrator
_REQUEST_CLASS = {"register": "RegisterUser", "claim": "ClaimDeposit",
                  "transfer": "TokenTransfer",
                  "add_withdrawal": "AddWithdrawal",
                  "process_withdrawal": "ProcessWithdrawal",
                  "add_deposit": "AddDeposit"}
_REQUESTS_FIELD = {"register": "register_users", "claim": "claim_deposits",
                   "transfer": "token_transfers",
                   "add_withdrawal": "add_withdrawals",
                   "process_withdrawal": "process_withdrawals",
                   "add_deposit": "add_deposits"}


class _State:
    def __init__(self, mix: dict, seed: int):
        self.rng = np.random.default_rng(seed)
        self.mix = mix
        lo, hi = mix.get("value_range", [1, 1_000_000])
        self.lo, self.hi = int(lo), int(hi)
        self.funded = list(range(int(mix["genesis_users"])))
        self.next_user = len(self.funded)
        self.next_withdrawal = 0
        self.pending_withdrawals: list[int] = []
        self.next_deposit = 0

    def felts(self, k: int, bits: int = 63) -> list[int]:
        return [int(x) % P for x in self.rng.integers(0, 1 << bits, size=k,
                                                      dtype=np.uint64)]

    def value(self) -> int:
        return int(self.rng.integers(self.lo, self.hi + 1))

    def two_users(self) -> tuple[int, int]:
        a, b = self.rng.choice(len(self.funded), size=2, replace=False)
        return self.funded[int(a)], self.funded[int(b)]

    def request(self, family: str) -> dict:
        if family == "register":
            uid = self.next_user
            self.next_user += 1
            return {"user_id": uid, "public_key": self.felts(4)}
        if family == "transfer":
            a, b = self.two_users()
            return {"from_user": a, "to_user": b, "value": self.value()}
        if family == "add_withdrawal":
            uid = self.funded[int(self.rng.integers(len(self.funded)))]
            wid = self.next_withdrawal
            self.next_withdrawal += 1
            self.pending_withdrawals.append(wid)
            # a hash160 in three limbs; the top limb's flag bits clear
            return {"user_id": uid, "withdrawal_id": wid,
                    "address": self.felts(2, 56) + self.felts(1, 48),
                    "value": self.value()}
        if family == "process_withdrawal":
            if not self.pending_withdrawals:
                raise ValueError("the mix processes a withdrawal that no "
                                 "earlier block added")
            return {"withdrawal_id": self.pending_withdrawals.pop(0)}
        if family == "add_deposit":
            did = self.next_deposit
            self.next_deposit += 1
            # a compressed secp256k1 key's 33 bytes, in their 9-felt packing
            key = bytes([2 + int(self.rng.integers(2))]) + \
                self.rng.bytes(32)
            return {"deposit_id": did, "txid224": self.felts(4, 56),
                    "public_key": bytes33_to_felts(key),
                    "value": self.value()}
        raise ValueError(f"the generator has no {family!r} requests")

    def block(self, counts: dict) -> dict:
        unknown = set(counts) - set(FAMILIES)
        if unknown:
            raise ValueError(f"unknown request families {sorted(unknown)}")
        return {f: [self.request(f) for _ in range(int(counts.get(f, 0)))]
                for f in FAMILIES}


def generate(mix: dict, seed: int) -> dict:
    """{"genesis": {"users": [[uid, pk, balance]]}, "blocks": [{"checkpoint",
    "enqueue", "requests": {family: [request dict]}}]}."""
    st = _State(mix, seed)
    balance = int(mix["genesis_balance"])
    genesis = [[uid, st.felts(4), balance] for uid in st.funded]
    blocks = []
    cp = 1
    if mix.get("prelude"):
        blocks.append({"checkpoint": cp, "enqueue": False,
                       "requests": st.block(mix["prelude"])})
        cp += 1
    for _ in range(int(mix["blocks"])):
        blocks.append({"checkpoint": cp, "enqueue": True,
                       "requests": st.block(mix["per_block"])})
        cp += 1
    return {"genesis": {"users": genesis}, "blocks": blocks}


def block_requests(om, requests: dict):
    """The orchestrator module `om`'s BlockRequests for one block's plain
    requests (the program's module or the reference's copy)."""
    kw = {}
    for family, reqs in requests.items():
        cls = getattr(om, _REQUEST_CLASS[family])
        kw[_REQUESTS_FIELD[family]] = [
            cls(**{k: tuple(v) if isinstance(v, list) else v
                   for k, v in r.items()}) for r in reqs]
    return om.BlockRequests(**kw)


def apply_genesis(city, genesis: dict) -> None:
    """Register and fund the genesis users at checkpoint 0 of a CityStore
    (the program's or the reference's)."""
    for uid, pk, balance in genesis["users"]:
        city.register_user(0, uid, tuple(pk))
        city.increment_user_balance(0, uid, balance)
