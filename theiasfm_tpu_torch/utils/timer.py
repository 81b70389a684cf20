"""Wall-clock timer (a copy of theiasfm_tpu/utils/timer.py).
ref: src/theia/util/timer.h:45-59."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed_seconds(self) -> float:
        return time.perf_counter() - self._t0
