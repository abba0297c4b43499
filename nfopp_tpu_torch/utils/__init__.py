"""Host-side utilities: config, factory, timers, profiling, geometry, SE(2)
poses (port of `nfopp_tpu/utils/`; its aot.py and compile_cache.py serve
XLA's compile path and are not ported)."""

from .config import AttributeDict, Config, deep_update  # noqa: F401
from .factory import UniversalFactory  # noqa: F401
from .position2 import Position2  # noqa: F401
from .timer import Timer, timer  # noqa: F401
from . import host_math  # noqa: F401
