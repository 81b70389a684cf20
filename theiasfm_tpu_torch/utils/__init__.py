from .padding import pad_to, next_bucket  # noqa: F401
from .timer import Timer  # noqa: F401
from .lru_cache import LRUCache  # noqa: F401
from .mutable_priority_queue import MutablePriorityQueue  # noqa: F401
from .dispatch import (count_dispatch, dispatch_counts,  # noqa: F401
                       reset_dispatch_counts, total_dispatches)
