"""Layer DSL (paddle_tpu/layers): functions that append ops to the default
program, and the recurrent groups, control flow and generation that build
sub-blocks. `__all__` is the JAX package's, name for name."""

from .attention import *  # noqa: F401,F403
from .attention import __all__ as _att_all
from .control_flow import *  # noqa: F401,F403
from .control_flow import __all__ as _cf_all
from .crf import *  # noqa: F401,F403
from .crf import __all__ as _crf_all
from .ctc import *  # noqa: F401,F403
from .ctc import __all__ as _ctc_all
from .detection import *  # noqa: F401,F403
from .detection import __all__ as _det_all
from .generation import *  # noqa: F401,F403
from .generation import __all__ as _gen_all
from .misc import *  # noqa: F401,F403
from .misc import __all__ as _misc_all
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .recurrent import *  # noqa: F401,F403
from .recurrent import __all__ as _rec_all
from .sequence import *  # noqa: F401,F403
from .sequence import __all__ as _seq_all

__all__ = (list(_nn_all) + list(_seq_all) + list(_att_all) + list(_crf_all) + list(_ctc_all)
           + list(_misc_all) + list(_det_all) + list(_rec_all) + list(_gen_all)
           + list(_cf_all))
