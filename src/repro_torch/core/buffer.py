"""On-chip buffer models for the Pointer back-end — the port's copy of the
JAX package's ``repro.core.buffer`` (pure Python).

The paper evaluates a 9 KB SRAM buffer shared by all feature vectors but does
not specify the eviction policy; we implement FIFO and LRU (LRU is the
default used for headline numbers) and, beyond the paper, a Belady oracle
(evict the entry whose next use is farthest in the future) as an upper bound
on what any replacement policy could achieve for a given execution order —
this cleanly separates "how good is the order" (the paper's contribution)
from "how good is the policy".
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Hashable

__all__ = ["BufferModel", "BeladyBuffer"]


@dataclass
class BufferStats:
    hits: int = 0
    misses: int = 0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0


class BufferModel:
    """Byte-capacity buffer of variable-size entries (feature vectors)."""

    def __init__(self, capacity_bytes: int, policy: str = "lru"):
        if policy not in ("lru", "fifo"):
            raise ValueError(f"unknown policy {policy!r}")
        self.capacity = int(capacity_bytes)
        self.policy = policy
        self._entries: OrderedDict[Hashable, int] = OrderedDict()
        self._used = 0

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    @property
    def used_bytes(self) -> int:
        return self._used

    def access(self, key: Hashable, size: int) -> bool:
        """Look up ``key``; on miss, insert it (evicting as needed).
        Returns True on hit."""
        if key in self._entries:
            if self.policy == "lru":
                self._entries.move_to_end(key)
            return True
        self.insert(key, size)
        return False

    def insert(self, key: Hashable, size: int) -> None:
        size = int(size)
        if size > self.capacity:
            return  # cannot be cached at all
        if key in self._entries:
            if self.policy == "lru":
                self._entries.move_to_end(key)
            return
        while self._used + size > self.capacity and self._entries:
            _, s = self._entries.popitem(last=False)
            self._used -= s
        self._entries[key] = size
        self._used += size


class BeladyBuffer:
    """Optimal-replacement oracle (beyond paper). Requires the full future
    reference string, which the scheduler conveniently *has* (the execution
    plan is static) — so on the real accelerator this policy is actually
    implementable by the order generator, which is the interesting insight.
    """

    def __init__(self, capacity_bytes: int, reference_string: list[Hashable]):
        self.capacity = int(capacity_bytes)
        self._entries: dict[Hashable, int] = {}
        self._used = 0
        # next-use lists: for each key, sorted positions in the ref string
        self._positions: dict[Hashable, list[int]] = {}
        for t, key in enumerate(reference_string):
            self._positions.setdefault(key, []).append(t)
        self._cursor: dict[Hashable, int] = {k: 0 for k in self._positions}
        self._t = -1

    def _next_use(self, key: Hashable) -> int:
        pos = self._positions.get(key, [])
        c = self._cursor.get(key, 0)
        while c < len(pos) and pos[c] <= self._t:
            c += 1
        self._cursor[key] = c
        return pos[c] if c < len(pos) else 1 << 60

    def access(self, key: Hashable, size: int) -> bool:
        self._t += 1
        if key in self._entries:
            return True
        self.insert(key, size)
        return False

    def insert(self, key: Hashable, size: int) -> None:
        size = int(size)
        if size > self.capacity or key in self._entries:
            return
        while self._used + size > self.capacity and self._entries:
            victim = max(self._entries, key=self._next_use)
            if self._next_use(victim) <= self._next_use(key):
                return  # inserting would evict something more useful
            self._used -= self._entries.pop(victim)
        self._entries[key] = size
        self._used += size
