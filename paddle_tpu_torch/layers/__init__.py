"""Layer DSL (paddle_tpu/layers), cut to what the ported programs use:
functions that append ops to the default program."""

from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .sequence import *  # noqa: F401,F403
from .sequence import __all__ as _seq_all

__all__ = list(_nn_all) + list(_seq_all)
