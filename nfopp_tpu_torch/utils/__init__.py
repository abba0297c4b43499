"""Host-side utilities: config, factory, timers, profiling, geometry, SE(2)
poses, and the captured programs (`aot.py`) and the kernel library's build
(`compile_cache.py`) that take the place of XLA's compiled programs and
compile cache (port of `nfopp_tpu/utils/`)."""

from .config import AttributeDict, Config, deep_update  # noqa: F401
from .factory import UniversalFactory  # noqa: F401
from .position2 import Position2  # noqa: F401
from .timer import Timer, timer  # noqa: F401
from . import host_math  # noqa: F401
from .compile_cache import enable_compile_cache  # noqa: F401
