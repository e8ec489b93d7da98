"""ScaleKernel: outputscale · base kernel; ConstantKernel: k = c.

Counterpart of ``gpytorch_tpu/kernels/scale_kernel.py``.  In the fused matvec the
outputscale is an operand of its own (``fused_scaled_kernel_matvec``), so that its
gradient comes out of the fused backward and not through the right-hand side.
"""

from __future__ import annotations

import torch

from ..constraints import Positive
from .kernel import Kernel, sub_hypers


class ScaleKernel(Kernel):
    def __init__(self, base_kernel: Kernel, outputscale_prior=None, outputscale_constraint=None, **kwargs):
        super().__init__(**kwargs)
        self.base_kernel = base_kernel
        # one outputscale per batch element: shape batch_shape
        self.register_parameter("raw_outputscale", torch.nn.Parameter(torch.zeros(self.batch_shape)))
        self.register_constraint("raw_outputscale", outputscale_constraint or Positive())
        if outputscale_prior is not None:
            self.register_prior("outputscale_prior", outputscale_prior, lambda m: m.outputscale,
                                lambda m, v: m._set_constrained("raw_outputscale", v))

    @property
    def returns_lazy_structure(self) -> bool:
        """The base kernel's: a structured base (an RFF root) is evaluated at every size."""
        return getattr(self.base_kernel, "returns_lazy_structure", False)

    @property
    def outputscale(self) -> torch.Tensor:
        return self._constrained("raw_outputscale")

    @outputscale.setter
    def outputscale(self, value) -> None:
        self._set_constrained("raw_outputscale", value)

    def hypers(self):
        base = {f"base_kernel.{k}": v for k, v in self.base_kernel.hypers().items()}
        return {"outputscale": self.outputscale, **base}

    def evaluate(self, hypers, x1, x2, diag: bool = False, **kwargs):
        base = sub_hypers(hypers, "base_kernel.")
        outputscale = hypers["outputscale"]
        if outputscale.ndim:  # a batch of outputscales scales its own matrix (or diagonal)
            # (one more unit dimension against the input dimensions of last_dim_is_batch)
            extra = (1 if diag else 2) + (1 if kwargs.get("last_dim_is_batch") else 0)
            outputscale = outputscale.reshape(outputscale.shape + (1,) * extra)
        # the base first: a structured operator (a grid kernel's) takes the product
        return self.base_kernel.evaluate(base, x1, x2, diag=diag, **kwargs) * outputscale

    def num_outputs_per_input(self, x1, x2) -> int:
        return self.base_kernel.num_outputs_per_input(x1, x2)

    def prediction_strategy(self, *args, **kwargs):
        return self.base_kernel.prediction_strategy(*args, **kwargs)


class ConstantKernel(Kernel):
    """k(x, x') = c, with c in ``raw_constant`` of shape batch + (1,)."""

    def __init__(self, constant_prior=None, constant_constraint=None, **kwargs):
        super().__init__(**kwargs)
        self.register_parameter("raw_constant", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))
        self.register_constraint("raw_constant", constant_constraint or Positive())
        if constant_prior is not None:
            self.register_prior("constant_prior", constant_prior, lambda m: m.constant,
                                lambda m, v: m._set_constrained("raw_constant", v))

    @property
    def constant(self) -> torch.Tensor:
        return self._constrained("raw_constant")

    @constant.setter
    def constant(self, value) -> None:
        self._set_constrained("raw_constant", value)

    def hypers(self):
        return {"constant": self.constant}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        """c broadcast to the matrix (its diagonal) of the inputs' and the kernel's batch."""
        c = hypers["constant"]
        tail = 1 if diag else 2
        if last_dim_is_batch:
            shape = x1.shape[:-2] + (x1.shape[-1], x1.shape[-2]) + (() if diag else (x2.shape[-2],))
        else:
            shape = torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2]) + x1.shape[-2:-1] + (() if diag else
                                                                                              x2.shape[-2:-1])
        shape = tuple(torch.broadcast_shapes(self.batch_shape, shape[:len(shape) - tail])) + tuple(shape[-tail:])
        return c.reshape(c.shape[:-1] + (1,) * (len(shape) - c.ndim + 1)).expand(shape)
