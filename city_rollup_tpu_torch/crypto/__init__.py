"""Out-of-circuit cryptography (city_crypto equivalent, SURVEY.md §2.1 row 4):
BTC hash primitives, secp256k1 curve + ECDSA + wallet.

Counterpart of the reference's ``crypto/``: copies of ``hashes.py``,
``secp256k1.py`` and ``felts.py`` (which it packs public keys with) over the port's ``core/`` (host Python), which the
in-circuit gadgets (``snark/sha256.py``, ``snark/ripemd160.py``,
``snark/secp_gadgets.py``) are held against, and of ``qhashout.py`` (the
QHashOut digest and felt248/felt252 packing the rollup's sighash finalizer
uses), and of ``bls12_381.py`` and ``groth16.py`` (the pairing curve and
the Groth16 system under the block's Groth16 wrap, python ints). Import
those two by module: nothing here loads them.
"""

from .hashes import (Hash160, Hash256, hash160, hash256, ripemd160, sha256,
                     sha256d)
from .secp256k1 import (ECDSAPublicKey, ECDSASignature, Secp256K1Wallet,
                        ecdsa_sign, ecdsa_verify)
