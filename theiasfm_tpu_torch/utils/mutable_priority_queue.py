"""Mutable (updatable-key) priority queue (a copy of
theiasfm_tpu/utils/mutable_priority_queue.py).

ref: src/theia/util/mutable_priority_queue.h — a min-queue whose entry
values can be updated in place (used by graph algorithms that relax
priorities). Host-side helper: lazy-deletion heap over (value, key).
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, Tuple


class MutablePriorityQueue:
    """Min-priority queue with update/remove by key.

    insert(key, value), update(key, value), pop() -> (key, value) of the
    smallest value, top() peeks, remove(key), contains, __len__.
    """

    def __init__(self):
        self._heap: list = []
        self._values: Dict[Any, Any] = {}

    def __len__(self):
        return len(self._values)

    def __contains__(self, key) -> bool:
        return key in self._values

    def insert(self, key, value):
        self._values[key] = value
        heapq.heappush(self._heap, (value, key))

    # update and insert share the lazy-deletion path
    update = insert

    def value_of(self, key):
        return self._values[key]

    def remove(self, key):
        del self._values[key]  # stale heap entries skipped lazily

    def _skip_stale(self):
        while self._heap:
            value, key = self._heap[0]
            if key in self._values and self._values[key] == value:
                return
            heapq.heappop(self._heap)

    def top(self) -> Tuple[Any, Any]:
        self._skip_stale()
        value, key = self._heap[0]
        return key, value

    def pop(self) -> Tuple[Any, Any]:
        self._skip_stale()
        value, key = heapq.heappop(self._heap)
        del self._values[key]
        return key, value
