"""Host inference caches (counterpart of ``nuzero_tpu/utils/caches.py``;
ref ``Utils/Caches/``).

Batched self-play needs no host cache (leaf evaluations are batched on
the device); the caches serve host-driven, batch-of-one play: human games
and visual tests, through ``Agent.set_cache``.

- ``DictCache``: a dict keyed by the state's bytes; evicts the oldest 10%
  when full; merges by update; update threshold 0.7
  (ref ``Utils/Caches/DictCache.py``).
- ``KeylessCache``: stores no keys: the state's xxHash64 is split into a
  table index and an identifier; direct-mapped, silently overwritten on a
  collision; power-of-2 size; slot-wise merge; update threshold 0.8
  (ref ``Utils/Caches/KeylessCache.py``).  The hash is the port's own
  native xxhash (``nuzero_tpu_torch/native``).
- ``create_cache`` (ref ``Utils/Functions/general_utils.py:13-22``).

A state is a NumPy array or a tensor (on any device); its key is its
bytes in C order, so a tensor and the equal NumPy array (and the JAX
package's array of the same dtype) give one key.
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

import numpy as np
import torch

from nuzero_tpu_torch.native import xxh64


def _state_bytes(state) -> bytes:
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().numpy()
    return np.ascontiguousarray(state).tobytes()


class Cache(abc.ABC):
    """(ref ``Utils/Caches/Cache.py``)."""

    update_threshold: float = 0.7

    def __init__(self):
        self.hits = 0
        self.misses = 0

    @abc.abstractmethod
    def get(self, state) -> Optional[Any]: ...

    @abc.abstractmethod
    def put(self, entry: Tuple[Any, Any]) -> None: ...

    @abc.abstractmethod
    def update(self, other: "Cache") -> None: ...

    @abc.abstractmethod
    def clear(self) -> None: ...

    @abc.abstractmethod
    def length(self) -> int: ...

    @abc.abstractmethod
    def max_length(self) -> int: ...

    def fill_ratio(self) -> float:
        return self.length() / max(self.max_length(), 1)

    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def should_update(self) -> bool:
        """Gossip-merge gate (ref cache ``update`` thresholds)."""
        return self.fill_ratio() < self.update_threshold


class DictCache(Cache):
    update_threshold = 0.7

    def __init__(self, max_size: int = 10000):
        super().__init__()
        self.max_size = max_size
        self._table = {}

    def get(self, state):
        key = _state_bytes(state)
        result = self._table.get(key)
        if result is None:
            self.misses += 1
        else:
            self.hits += 1
        return result

    def put(self, entry):
        key_state, value = entry
        if len(self._table) >= self.max_size:
            # Evict 10% oldest (ref DictCache.py:37-51).
            n_evict = max(self.max_size // 10, 1)
            for k in list(self._table.keys())[:n_evict]:
                del self._table[k]
        self._table[_state_bytes(key_state)] = value

    def update(self, other: "DictCache"):
        self._table.update(other._table)

    def clear(self):
        self._table.clear()

    def length(self):
        return len(self._table)

    def max_length(self):
        return self.max_size


class KeylessCache(Cache):
    update_threshold = 0.8

    def __init__(self, max_size: int = 10000):
        super().__init__()
        # Power-of-2 sizing (ref KeylessCache.py:152-159).
        size = 1
        while size * 2 <= max_size:
            size *= 2
        self.size = size
        self._index_bits = size.bit_length() - 1
        self._ident = np.zeros(size, np.uint64)  # 0 = empty
        self._values = [None] * size

    def _locate(self, state):
        h = np.uint64(xxh64(_state_bytes(state)))
        index = int(h & np.uint64(self.size - 1))
        ident = (h >> np.uint64(self._index_bits)) | np.uint64(1)
        return index, ident

    def get(self, state):
        index, ident = self._locate(state)
        if self._ident[index] == ident:
            self.hits += 1
            return self._values[index]
        self.misses += 1
        return None

    def put(self, entry):
        key_state, value = entry
        index, ident = self._locate(key_state)
        # Silent overwrite on collision (ref KeylessCache.py:74-85).
        self._ident[index] = ident
        self._values[index] = value

    def update(self, other: "KeylessCache"):
        # Slot-wise overwrite merge (ref KeylessCache.py:87-103).
        if other.size != self.size:
            raise ValueError("can only merge equally-sized keyless caches")
        occupied = other._ident != 0
        for i in np.flatnonzero(occupied):
            self._ident[i] = other._ident[i]
            self._values[i] = other._values[i]

    def clear(self):
        self._ident[:] = 0
        self._values = [None] * self.size

    def length(self):
        return int((self._ident != 0).sum())

    def max_length(self):
        return self.size


def create_cache(cache_choice: str, max_size: int) -> Optional[Cache]:
    """(ref ``general_utils.create_cache``)."""
    if cache_choice == "dict":
        return DictCache(max_size)
    if cache_choice == "keyless":
        return KeylessCache(max_size)
    if cache_choice in ("disabled", "none"):
        return None
    raise ValueError(f"bad cache_choice {cache_choice!r}")
