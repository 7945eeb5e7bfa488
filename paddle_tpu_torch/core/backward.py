"""append_backward (paddle_tpu/core/backward.py): one `autodiff` op names
the loss and the trainable parameters; the executor runs it as
torch.autograd.grad over the forward ops before it, so that every such
parameter P has `P@GRAD` for the optimizer ops after it."""

from __future__ import annotations

from typing import List, Optional, Sequence

from .program import Variable, grad_var_name


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[set] = None,
) -> List[tuple]:
    """Returns [(param_var, grad_var)] as the fluid API does."""
    program = loss.block.program
    block = program.global_block()
    no_grad = {v.name if isinstance(v, Variable) else v for v in (no_grad_set or set())}
    if parameter_list is not None:
        params = [p if isinstance(p, Variable) else block.var(p) for p in parameter_list]
    else:
        params = program.parameters()
    params = [p for p in params if p.trainable and p.name not in no_grad]
    if not params:
        raise ValueError("append_backward: no trainable parameters in program")
    grad_vars = [block.create_var(grad_var_name(p.name), p.shape, p.dtype) for p in params]
    block.append_op("autodiff", inputs={"Loss": [loss]}, outputs={"Grads": grad_vars},
                    attrs={"params": [p.name for p in params]})
    return list(zip(params, grad_vars))
