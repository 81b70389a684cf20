from .padding import pad_to, next_bucket  # noqa: F401
from .dispatch import (count_dispatch, dispatch_counts,  # noqa: F401
                       reset_dispatch_counts)
