"""Master-side KV store: the port of ``dlrover_tpu/master/kv_store.py``.

Backs the agents' coordinator election and barriers. The JAX module's
persistence hooks (the write-ahead journal and snapshot import/export)
wait for the slice that ports master persistence.
"""

import threading
from typing import Dict, List


class KVStoreService:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._store[key] = value

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def add(self, key: str, amount: int) -> int:
        """Atomic counter add; the value is stored as decimal string bytes."""
        with self._lock:
            current = int(self._store.get(key, b"0") or b"0") + amount
            self._store[key] = str(current).encode()
            return current

    def multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        with self._lock:
            return {k: self._store[k] for k in keys if k in self._store}

    def multi_set(self, kvs: Dict[str, bytes]) -> None:
        with self._lock:
            self._store.update(kvs)

    def delete(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
