"""Wallets: key management + signing (= proving) for the two signature
schemes the rollup supports.

Reference roles:
- `SimpleZKSignatureWallet` (city_common_circuit/src/wallet/zk.rs:61-240):
  pk<->sk maps; "sign" = prove the zk-signature circuit for an action hash.
- secp256k1 wallet (city_crypto/src/signature/secp256k1/wallet.rs): L1 keys,
  ECDSA sign over action hashes.
- `CityMemoryWallet` (city_rollup_circuit/src/wallet/memory.rs:37-57):
  bundles both, with a fast-setup constructor.

Counterpart of the reference's ``rollup/wallet.py``: a copy, with the
wrapper circuit built for a ``device``.
"""

from __future__ import annotations

import dataclasses
import os

from ..core import poseidon_host
from ..crypto import secp256k1 as secp
from ..snark.config import CircuitConfig
from ..snark.prover import Proof
from .zk_signature import ZKSignatureWrapperCircuit, derive_public_key

P = (1 << 64) - (1 << 32) + 1


def _random_felts(n: int) -> list[int]:
    return [int.from_bytes(os.urandom(8), "little") % P for _ in range(n)]


class SimpleZKSignatureWallet:
    """pk -> sk map; sign = prove (wallet/zk.rs twin). Shares one wrapper
    circuit across keys (the circuit is key-independent)."""

    def __init__(self, wrapper: ZKSignatureWrapperCircuit | None = None,
                 config: CircuitConfig | None = None, device=None):
        if wrapper is None:
            wrapper = ZKSignatureWrapperCircuit.build(
                config or CircuitConfig.poseidon_config(), device=device)
        self.wrapper = wrapper
        self._keys: dict[tuple, list[int]] = {}

    def add_zk_private_key(self, sk: list[int]) -> tuple:
        pk = tuple(derive_public_key(sk))
        self._keys[pk] = [int(x) % P for x in sk]
        return pk

    def create_zk_private_key(self) -> tuple:
        return self.add_zk_private_key(_random_felts(4))

    def get_public_keys(self) -> list[tuple]:
        return list(self._keys)

    def has_public_key(self, pk) -> bool:
        return tuple(pk) in self._keys

    def sign(self, pk, action_hash: list[int]) -> Proof:
        sk = self._keys[tuple(pk)]
        return self.wrapper.sign(sk, action_hash)

    def sign_hash_string(self, pk, felts: list[int]) -> Proof:
        return self.sign(pk, poseidon_host.hash_no_pad(
            [int(x) % P for x in felts]))


class Secp256K1WalletBundle:
    """L1 (secp256k1) keyring: ECDSA sign over 256-bit message hashes
    (city_crypto wallet.rs twin; in-circuit proving lands with the secp
    gadget layer)."""

    def __init__(self):
        self._wallet = secp.Secp256K1Wallet()

    def create_key(self):
        return self._wallet.add_random_key(os.urandom(32))

    def add_key(self, sk: int):
        return self._wallet.add_private_key(sk)

    def public_keys(self):
        return self._wallet.public_keys()

    def sign(self, pk, msg_hash: int) -> secp.ECDSASignature:
        return self._wallet.sign(pk, msg_hash)


@dataclasses.dataclass
class CityMemoryWallet:
    """Both keyrings behind one API (wallet/memory.rs CityMemoryWallet)."""
    zk: SimpleZKSignatureWallet
    secp: Secp256K1WalletBundle

    @classmethod
    def new_fast_setup(cls, config: CircuitConfig | None = None,
                       wrapper: ZKSignatureWrapperCircuit | None = None,
                       device=None) -> "CityMemoryWallet":
        return cls(zk=SimpleZKSignatureWallet(wrapper=wrapper, config=config,
                                              device=device),
                   secp=Secp256K1WalletBundle())
