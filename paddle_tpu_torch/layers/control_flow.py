"""While loops and two-way branches over sub-blocks
(paddle_tpu/layers/control_flow.py): Fluid's `While` (while_op.cc) and
`cond` (conditional_block_op.cc). The ops are ops/control_flow_ops.py's:
each reads its condition on the host, so a program that holds one runs
step by step and cannot be captured as a CUDA graph."""

from __future__ import annotations

import contextlib
from typing import List, Tuple

from ..core.program import Variable, unique_name
from .helper import LayerHelper

__all__ = ["While", "cond"]


class While:
    """A loop over a sub-block while a carried condition holds::

        i = ptt.layers.fill_constant([1], np.int32, 0)
        c = ptt.layers.less_than(i, n)           # the entry condition
        loop = ptt.layers.While(cond=c)
        with loop.block():
            i2 = ptt.layers.increment(i)         # reads see carried values
            loop.update(i, i2)
            loop.update(c, ptt.layers.less_than(i2, n))
        i_fin, _ = loop()                        # finals, in update order

    The condition's value entering the op decides the first iteration,
    the value computed in the block the next. Carried values are declared
    with `update(outer, new)`; inside the block a read of `outer` sees the
    carried value. Forward only, as the JAX package's: a loss that depends
    on a While output raises in the backward. Trainable recurrences belong
    in recurrent_group."""

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("while_loop", name=name)
        self.cond = cond
        self._updates: List[Tuple[Variable, Variable]] = []
        self._block = None
        self._done = False

    @contextlib.contextmanager
    def block(self):
        with self.helper.main_program.block_guard() as b:
            self._block = b
            yield
        self._complete()

    def update(self, outer: Variable, new: Variable) -> None:
        """A carried value: `outer`'s final value is returned by the loop."""
        if self._done:
            raise RuntimeError("update() after the block() has closed: the loop op is "
                               "already emitted; declare all carried values inside the "
                               "with-block")
        if any(o.name == outer.name for o, _ in self._updates):
            raise ValueError(f"{outer.name} updated twice")
        self._updates.append((outer, new))

    def _complete(self):
        if not any(o.name == self.cond.name for o, _ in self._updates):
            raise ValueError("While condition var must be updated inside the block "
                             "(otherwise the loop cannot terminate)")
        helper = self.helper
        parent = helper.block
        self.outputs = [parent.create_var(unique_name(f"{helper.name}.out"), tuple(o.shape),
                                          o.dtype) for o, _ in self._updates]
        parent.append_op(
            "while_loop",
            inputs={"Cond": [self.cond.name], "Carried": [o.name for o, _ in self._updates]},
            outputs={"Out": [v.name for v in self.outputs]},
            attrs={"sub_block": self._block.idx,
                   "carried": [o.name for o, _ in self._updates],
                   "updates": [n.name for _, n in self._updates]})
        self._done = True

    def __call__(self):
        if not self._done:
            raise RuntimeError("call after the block() has closed")
        return tuple(self.outputs)


def cond(pred: Variable, true_fn, false_fn, name=None):
    """A two-way branch: `true_fn` and `false_fn` build their sub-networks
    in sub-blocks of their own and return a Variable, or a tuple of them of
    matching shapes and dtypes; only the branch the predicate picks runs,
    and the other's parameters get zero gradient."""
    helper = LayerHelper("cond", name=name)
    prog = helper.main_program

    def trace(fn):
        with prog.block_guard() as b:
            outs = fn()
        return b, list(outs) if isinstance(outs, (list, tuple)) else [outs]

    tb, t_outs = trace(true_fn)
    fb, f_outs = trace(false_fn)
    if len(t_outs) != len(f_outs):
        raise ValueError("cond branches must return the same number of vars")
    outputs = [helper.block.create_var(unique_name(f"{helper.name}.out"), tuple(v.shape),
                                       v.dtype) for v in t_outs]
    helper.block.append_op(
        "cond", inputs={"Pred": [pred.name]}, outputs={"Out": [v.name for v in outputs]},
        attrs={"true_block": tb.idx, "false_block": fb.idx,
               "true_outs": [v.name for v in t_outs], "false_outs": [v.name for v in f_outs]})
    return outputs[0] if len(outputs) == 1 else tuple(outputs)
