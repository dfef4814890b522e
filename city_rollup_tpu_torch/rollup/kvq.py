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


class KVQSqliteStore(KVQBinaryStore):
    """Durable, transactional sorted-KV over sqlite3 — the true equivalent
    of the reference's redb backend (kvq_store_redb/src/lib.rs): state
    survives process exit/crash, and the fuzzy get_leq range read maps to
    one indexed ORDER BY query. WAL mode keeps concurrent readers cheap."""

    def __init__(self, path: str = ":memory:"):
        import sqlite3
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
        self._db.commit()
        import threading
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._db.execute("SELECT v FROM kv WHERE k = ?",
                                   (key,)).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, value))
            self._db.commit()

    def delete(self, key: bytes) -> bool:
        with self._lock:
            cur = self._db.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._db.commit()
            return cur.rowcount > 0

    def get_leq_kv(self, key: bytes, fuzzy_bytes: int
                   ) -> Optional[tuple[bytes, bytes]]:
        assert fuzzy_bytes <= len(key)
        lo = key[: len(key) - fuzzy_bytes] + b"\x00" * fuzzy_bytes
        with self._lock:
            row = self._db.execute(
                "SELECT k, v FROM kv WHERE k <= ? AND k >= ? "
                "ORDER BY k DESC LIMIT 1", (key, lo)).fetchone()
        if row is None:
            return None
        return bytes(row[0]), bytes(row[1])

    def get_leq(self, key: bytes, fuzzy_bytes: int) -> Optional[bytes]:
        kv = self.get_leq_kv(key, fuzzy_bytes)
        return kv[1] if kv else None

    def close(self):
        self._db.close()


class KVQFileStore(KVQMemoryStore):
    """Durable variant: snapshot/load the whole map to a file (stand-in for
    the reference's redb backend, kvq_store_redb; suits checkpoint/resume)."""

    def __init__(self, path: str | None = None):
        super().__init__()
        self.path = path
        if path:
            import os
            if os.path.exists(path):
                self.load(path)

    def snapshot(self, path: str | None = None) -> None:
        import pickle
        with open(path or self.path, "wb") as f:
            pickle.dump(self._map, f)

    def load(self, path: str) -> None:
        import pickle
        with open(path, "rb") as f:
            self._map = pickle.load(f)
        self._keys = sorted(self._map)
