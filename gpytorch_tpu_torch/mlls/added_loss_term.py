"""Added loss terms: objects with a ``loss(*params)`` that an objective adds to the model's
(``Module.added_loss_terms``).  Counterpart of ``gpytorch_tpu/mlls/added_loss_term.py``.

* ``InducingPointKernelAddedLossTerm``: SGPR's variance correction −½ Σᵢ (k_ii − q_ii)/σ²ᵢ,
  which ``InducingPointKernel`` sets on each training call and the exact MLL adds;
* ``KLGaussianAddedLossTerm``: KL(q(x) ‖ p(x)) of a GPLVM's latent inputs, per data point and
  observed dimension;
* ``NoiseModelAddedLossTerm``: the marginal log likelihood of a heteroskedastic noise model.

``params`` are the arguments after the target of the objective's call (the likelihood's)."""

from __future__ import annotations

import torch


class AddedLossTerm:
    def loss(self, *params) -> torch.Tensor:
        raise NotImplementedError


class InducingPointKernelAddedLossTerm(AddedLossTerm):
    """−½ Σᵢ (k_ii − q_ii) / σ²ᵢ, from the diagonals of the prior K (``prior_dist``) and of
    the Nyström approximation Q (``variational_dist``) and the likelihood's noise."""

    def __init__(self, prior_dist, variational_dist, likelihood):
        self.prior_dist = prior_dist
        self.variational_dist = variational_dist
        self.likelihood = likelihood

    def loss(self, *params) -> torch.Tensor:
        prior_diag = self.prior_dist.variance
        noise_diag = self.likelihood._shaped_noise_covar(prior_diag.shape, *params)._diagonal().expand(prior_diag.shape)
        return -0.5 * ((prior_diag - self.variational_dist.variance) / noise_diag).sum(-1)


class KLGaussianAddedLossTerm(AddedLossTerm):
    """Σ KL(q(x) ‖ p(x)) over the latent dimensions and points of two diagonal Gaussians,
    over n · data_dim: a variational objective adds it to each of a GPLVM's data_dim batch
    elements, so a loss summed over them counts the KL once per point, as in GPyTorch.  (The
    JAX package multiplies by data_dim / (n · data_dim), 1/n, and so counts it data_dim
    times.)"""

    def __init__(self, q_x, p_x, n: int, data_dim: int):
        self.q_x = q_x
        self.p_x = p_x
        self.n = n
        self.data_dim = data_dim

    def loss(self, *params) -> torch.Tensor:
        var_q, var_p = self.q_x.variance, self.p_x.variance
        kl = 0.5 * (torch.log(var_p / var_q) + (var_q + (self.q_x.mean - self.p_x.mean) ** 2) / var_p - 1.0)
        kl_per_point = kl.sum(-1) if kl.ndim > 1 else kl
        return kl_per_point.sum() / (self.n * max(self.data_dim, 1))


class NoiseModelAddedLossTerm(AddedLossTerm):
    """Σ of the noise model's objective ``noise_mll`` on its own output at the inputs
    (``params`` but the last) and the targets (the last of ``params``)."""

    def __init__(self, noise_model, noise_mll):
        self.noise_model = noise_model
        self.noise_mll = noise_mll

    def loss(self, *params) -> torch.Tensor:
        output = self.noise_model(*params[:-1]) if len(params) > 1 else self.noise_model(*params)
        return self.noise_mll(output, params[-1]).sum()
