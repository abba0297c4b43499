"""Batched tensor ops of the solver (ports of `nfopp_tpu/ops`)."""

from . import math  # noqa: F401
from . import hessian  # noqa: F401
from . import sampling  # noqa: F401
from . import losses  # noqa: F401
from . import reparametrize  # noqa: F401
