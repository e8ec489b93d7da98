"""The Bayesian GPLVM: GPs on latent inputs that are learned.  Counterpart of
``gpytorch_tpu/models/gplvm.py``.

A latent variable gives the inputs: a point estimate (``PointLatentVariable``), a MAP
estimate under a prior (``MAPLatentVariable``), or an isotropic Gaussian q(X) =
N(q_mu, softplus(q_log_sigma)²) (``VariationalLatentVariable``), whose call draws X by
reparametrisation and sets the added loss term ``x_kl``, KL(q(X) ‖ p(X)), which a variational
objective subtracts.  Its ε comes from ``generator`` (torch's default generator when None),
or is passed as ``eps``.  ``BayesianGPLVM`` is an ``ApproximateGP`` over a latent variable,
usually with one GP per observed dimension in a batch."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.module import Module
from ..mlls.added_loss_term import KLGaussianAddedLossTerm
from .approximate_gp import ApproximateGP


class LatentVariable(Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.n = int(n)
        self.latent_dim = int(dim)

    def forward(self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        raise NotImplementedError


class PointLatentVariable(LatentVariable):
    """X itself, a parameter."""

    def __init__(self, n: int, latent_dim: int, X_init):
        super().__init__(n, latent_dim)
        self.X = nn.Parameter(torch.as_tensor(X_init))

    def forward(self, generator=None, eps=None):
        return self.X


class MAPLatentVariable(PointLatentVariable):
    """X, a parameter, with the prior ``prior_x`` on it."""

    def __init__(self, n: int, latent_dim: int, X_init, prior_x):
        super().__init__(n, latent_dim, X_init)
        self.register_prior("prior_x", prior_x, "X")


class VariationalLatentVariable(LatentVariable):
    """q(X) = N(q_mu, softplus(q_log_sigma)²) with the prior ``prior_x`` (a ``NormalPrior``);
    q_log_sigma starts at 0.1 ε from ``generator``."""

    def __init__(self, n: int, data_dim: int, latent_dim: int, X_init, prior_x,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n, latent_dim)
        self.data_dim = int(data_dim)
        self.prior_x = prior_x
        X_init = torch.as_tensor(X_init)
        self.q_mu = nn.Parameter(X_init.clone())
        self.q_log_sigma = nn.Parameter(0.1 * torch.randn((n, latent_dim), generator=generator, dtype=X_init.dtype))
        self.register_added_loss_term("x_kl")

    def forward(self, generator=None, eps=None):
        sigma = nn.functional.softplus(self.q_log_sigma)
        q_x = torch.distributions.Normal(self.q_mu, sigma, validate_args=False)
        self.update_added_loss_term("x_kl", KLGaussianAddedLossTerm(q_x, self.prior_x, self.n, self.data_dim))
        if eps is None:
            eps = torch.randn(self.q_mu.shape, generator=generator, dtype=self.q_mu.dtype, device=self.q_mu.device)
        return self.q_mu + sigma * eps


class BayesianGPLVM(ApproximateGP):
    """An ``ApproximateGP`` over the latent variable ``X``: the subclass defines
    ``forward(x)``; train on ``model(model.sample_latent_variable(...))`` (indexed by a
    minibatch where there is one) against the observations, one GP per observed dimension."""

    def __init__(self, X: LatentVariable, variational_strategy):
        super().__init__(variational_strategy)
        self.X = X

    def forward(self, x):
        raise NotImplementedError

    def sample_latent_variable(self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None):
        return self.X(generator=generator, eps=eps)
