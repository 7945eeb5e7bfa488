"""Layer DSL (paddle_tpu/layers), cut to what the ported programs use:
functions that append ops to the default program, and the recurrent
groups and control flow that build sub-blocks."""

from .attention import *  # noqa: F401,F403
from .control_flow import While, cond  # noqa: F401
from .attention import __all__ as _attn_all
from .crf import *  # noqa: F401,F403
from .crf import __all__ as _crf_all
from .generation import BeamSearchDecoder  # noqa: F401
from .misc import *  # noqa: F401,F403
from .misc import __all__ as _misc_all
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .recurrent import *  # noqa: F401,F403
from .recurrent import __all__ as _rec_all
from .sequence import *  # noqa: F401,F403
from .sequence import __all__ as _seq_all

__all__ = (list(_nn_all) + list(_seq_all) + list(_misc_all) + list(_attn_all)
           + list(_crf_all) + list(_rec_all) + ["BeamSearchDecoder", "While", "cond"])
