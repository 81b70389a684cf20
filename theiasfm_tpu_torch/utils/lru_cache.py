"""Thread-safe LRU cache with miss-fetch callback (a copy of
theiasfm_tpu/utils/lru_cache.py).

ref: src/theia/util/lru_cache.h:53 (templated LRU with fetch function +
mutex; backs ImageCache, image/image_cache.h:49-63).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Generic, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    def __init__(self, fetch: Callable[[K], V], max_entries: int):
        self._fetch = fetch
        self._max = max_entries
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def fetch(self, key: K) -> V:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
        value = self._fetch(key)
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self._max:
                self._data.popitem(last=False)
            self.misses += 1
        return value

    def insert(self, key: K, value: V):
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self._max:
                self._data.popitem(last=False)

    def contains(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self):
        return len(self._data)


class ImageCache:
    """LRU image-from-disk cache for out-of-core pipelines.
    ref: src/theia/image/image_cache.h:49-63."""

    def __init__(self, image_directory: str, max_images: int = 64):
        import os

        from ..image.float_image import FloatImage
        self.dir = image_directory
        self._cache = LRUCache(
            lambda name: FloatImage.from_file(
                os.path.join(self.dir, name)), max_images)

    def fetch_image(self, name: str):
        return self._cache.fetch(name)
