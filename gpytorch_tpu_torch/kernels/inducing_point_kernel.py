"""InducingPointKernel — SGPR's Nyström kernel.  Counterpart of
``gpytorch_tpu/kernels/inducing_point_kernel.py``.

K(x1, x2) ≈ Q = (K_x1Z L⁻ᵀ)(K_x2Z L⁻ᵀ)ᵀ with L the Cholesky factor of K_ZZ + 1e-4·I (the base
kernel on the inducing points Z, a parameter): on one input a ``LowRankRootLinearOperator``
of the root K_xZ L⁻ᵀ (n × m), on two a ``MatmulLinearOperator`` of the two roots; its diagonal
is Q's.  K_ZZ, K_xZ and L are formed densely, by matrix products and a triangular solve.

Each evaluation in training mode sets the kernel's added loss term (Titsias's variance
correction, ``mlls/added_loss_term.py::InducingPointKernelAddedLossTerm``) from the base
kernel's diagonal and Q's at x1, which the exact MLL adds; ``train(False)`` clears it, so
that an objective taken in eval mode adds none, and a deep copy of the kernel leaves it
behind (it holds the training graph).

The likelihood is a submodule, as in GPyTorch; ``named_parameters`` lists the model's noise
once, under the model's own path, where the JAX package keeps a second copy under the
kernel's (``load_jax_params`` loads either name).  ``prediction_strategy`` is the SGPR
strategy: the default strategy's math on R Rᵀ + σ²I (``linop/root.py``)."""

from __future__ import annotations

import torch

from ..distributions import MultivariateNormal
from ..linop import DiagLinearOperator, LowRankRootLinearOperator, MatmulLinearOperator
from ..mlls.added_loss_term import InducingPointKernelAddedLossTerm
from ..solvers.cholesky import psd_safe_cholesky
from .kernel import Kernel, sub_hypers

_LOSS_TERM = "inducing_point_loss_term"


class InducingPointKernel(Kernel):
    returns_lazy_structure = True

    def __init__(self, base_kernel: Kernel, inducing_points: torch.Tensor, likelihood, active_dims=None):
        super().__init__(active_dims=active_dims)
        self.base_kernel = base_kernel
        self.likelihood = likelihood
        inducing_points = inducing_points.detach().clone()
        if inducing_points.ndim == 1:
            inducing_points = inducing_points.unsqueeze(-1)
        self.register_parameter("inducing_points", torch.nn.Parameter(inducing_points))
        self.register_added_loss_term(_LOSS_TERM)

    def hypers(self):
        base = {f"base_kernel.{k}": v for k, v in self.base_kernel.hypers().items()}
        return {"inducing_points": self.inducing_points, **base}

    def _inducing_inv_root(self, base, Z) -> torch.Tensor:
        """L⁻ᵀ, L the Cholesky factor of K_ZZ + 1e-4·I."""
        eye = torch.eye(Z.shape[-2], dtype=Z.dtype, device=Z.device)
        L = psd_safe_cholesky(self.base_kernel.evaluate(base, Z, Z) + 1e-4 * eye)
        return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False).mT

    def evaluate(self, hypers, x1, x2, diag: bool = False):
        base, Z = sub_hypers(hypers, "base_kernel."), hypers["inducing_points"]
        inv_root = self._inducing_inv_root(base, Z)
        root1 = self.base_kernel.evaluate(base, x1, Z) @ inv_root
        symmetric = x1 is x2
        root2 = root1 if symmetric else self.base_kernel.evaluate(base, x2, Z) @ inv_root
        q_diag = (root1 * root2).sum(-1) if x1.shape == x2.shape else None
        if self.training:
            if x1.shape != x2.shape:
                raise RuntimeError("x1 must equal x2 in training mode")
            zero = torch.zeros(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
            prior = MultivariateNormal(zero, DiagLinearOperator(self.base_kernel.evaluate(base, x1, x1, diag=True)))
            self.update_added_loss_term(_LOSS_TERM, InducingPointKernelAddedLossTerm(
                prior, MultivariateNormal(zero, DiagLinearOperator(q_diag)), self.likelihood))
        if diag:
            return q_diag
        if symmetric:
            return LowRankRootLinearOperator(root1)
        return MatmulLinearOperator(root1, root2.mT)

    def num_outputs_per_input(self, x1, x2) -> int:
        return self.base_kernel.num_outputs_per_input(x1, x2)

    def train(self, mode: bool = True) -> "InducingPointKernel":
        super().train(mode)
        if not mode:
            self._added_loss_terms[_LOSS_TERM] = None
        return self

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_added_loss_terms"] = {name: None for name in self._added_loss_terms}
        return state

    def prediction_strategy(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
        from ..models.exact_prediction_strategies import SGPRPredictionStrategy

        return SGPRPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
