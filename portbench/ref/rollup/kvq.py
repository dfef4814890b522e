"""KVQ: binary key-value store abstraction with exact and fuzzy (get_leq)
range reads.

``get_leq(key, fuzzy_bytes)`` returns the value at the greatest key K such
that K <= key and K agrees with key on all but the trailing ``fuzzy_bytes``
bytes — the primitive behind copy-on-write checkpoint versioning: Merkle node
keys end with the checkpoint_id, so a read at checkpoint c finds the newest
write at or before c.

Reference role: kvq/src/traits.rs:136-199, memory impl kvq/src/memory/simple.rs
(SURVEY.md §2.1 row 9). The redb/rocksdb backends map to any sorted-KV here;
the in-memory backend is a sorted list + bisect (BTreeMap twin).

Counterpart of the reference's ``rollup/kvq.py``: a copy.
"""

from __future__ import annotations

import bisect
from typing import Optional


class KVQBinaryStore:
    """Interface: byte keys -> byte values, sorted iteration."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> bool:
        raise NotImplementedError

    def get_leq(self, key: bytes, fuzzy_bytes: int) -> Optional[bytes]:
        raise NotImplementedError

    def get_leq_kv(self, key: bytes, fuzzy_bytes: int
                   ) -> Optional[tuple[bytes, bytes]]:
        raise NotImplementedError


class KVQMemoryStore(KVQBinaryStore):
    """Sorted in-memory store (BTreeMap twin)."""

    def __init__(self):
        self._keys: list[bytes] = []
        self._map: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._map.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._map:
            bisect.insort(self._keys, key)
        self._map[key] = value

    def delete(self, key: bytes) -> bool:
        if key in self._map:
            del self._map[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]
            return True
        return False

    def get_leq_kv(self, key: bytes, fuzzy_bytes: int
                   ) -> Optional[tuple[bytes, bytes]]:
        assert fuzzy_bytes <= len(key)
        prefix = key[: len(key) - fuzzy_bytes]
        i = bisect.bisect_right(self._keys, key)
        if i == 0:
            return None
        cand = self._keys[i - 1]
        if cand[: len(prefix)] != prefix:
            return None
        return cand, self._map[cand]

    def get_leq(self, key: bytes, fuzzy_bytes: int) -> Optional[bytes]:
        kv = self.get_leq_kv(key, fuzzy_bytes)
        return kv[1] if kv else None


