from . import polynomial, rotation  # noqa: F401
from .gauss_jordan import gauss_jordan  # noqa: F401
