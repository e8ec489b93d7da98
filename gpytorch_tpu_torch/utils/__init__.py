"""Helpers that carry state between the JAX package and this one."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def load_jax_params(module: torch.nn.Module, params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy raw parameters, and optionally a grid kernel's grid state, from a
    ``gpytorch_tpu`` model into ``module``.

    ``params`` is ``{name: np.asarray(value) for name, value in model.trainable_params().items()}``
    of a ``gpytorch_tpu`` model; the names are dotted paths (``covar_module.raw_outputscale``)
    that match this package's parameter names.  Every parameter of ``module`` must be
    given, with its shape; values are cast to the parameter's dtype and device.

    A grid kernel's state may be given too, under the JAX kernel's attribute names:
    ``<kernel>.grid`` (its list of 1D grids), ``<kernel>.grid_bounds`` and
    ``<kernel>.has_initialized_grid``.  These become the kernel's buffers with the values'
    own dtypes (the JAX package keeps a grid made from bounds in float32 even under x64),
    so that both packages interpolate on the same grid.  So may a variational strategy's
    ``<strategy>.variational_params_initialized``: given as 1, the loaded q(u) is kept on the
    model's first call instead of being initialised from the prior, and a VNNGP strategy's
``<strategy>.nn_xinduce_idx`` (the k nearest preceding inducing points of each, which an
approximate index builds differently in the two packages).  Every new parameter of the
variational long tail is a parameter here too (DSPP's ``quad_sites`` and
``raw_quad_weights``, the non-Gaussian likelihoods' raw parameters, LMC's
``lmc_coefficients``, the additive grid strategy's ``mixing_params``, the decoupled
strategies' nested ``base_variational_strategy.*``, an ``InducingPointKernel``'s
``inducing_points``), and so is every raw parameter of the kernel long tail (``raw_alpha``,
``raw_beta``, ``raw_variance``, ``raw_offset``, ``raw_constant``,
``raw_mixture_{weights,means,scales}``, ``raw_Z``, ``raw_angle``, ``raw_radius``,
``raw_angular_weights``, the grad means' ``raw_constant``, ``weights`` and ``bias``).  A
grid variational strategy takes ``<strategy>.grid`` as a grid kernel does, and an RFF kernel ``<kernel>.randn_weights`` (a buffer, in the value's own
dtype).  A model list's parameters are ``models.<i>.<name>``, a GPLVM's latent variable's
``X.X``, ``X.q_mu`` and ``X.q_log_sigma``.  Any other buffer of ``module`` may be given by
its name (a prior's hyperparameters, e.g. ``X.prior_x.loc`` or an LKJ prior's
``correlation_prior.eta``), and is copied in its dtype.  A parameter that the module reaches
by two paths (an ``InducingPointKernel``'s likelihood, which is also the model's) is given
under either; the JAX package holds a copy under each.  Clears the module's caches, since they depend on the parameters."""
    own = dict(module.named_parameters(remove_duplicate=False))
    buffers = dict(module.named_buffers(remove_duplicate=False))
    state = {name: value for name, value in params.items() if name not in own}
    unknown = {name for name in state if name not in buffers and name.rsplit(".", 1)[-1] not in _STATE}
    given = {id(own[name]) for name in params if name in own}
    missing = {name for name, p in module.named_parameters() if id(p) not in given}
    if unknown or missing:
        raise KeyError(f"parameter names differ: unknown {sorted(unknown)}, missing {sorted(missing)}")
    with torch.no_grad():
        for name, value in params.items():
            if name in state:
                continue
            value = torch.as_tensor(np.array(value))
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(own[name].shape)}")
            own[name].copy_(value)
    for name, value in state.items():
        path, attr = name.rsplit(".", 1) if "." in name else ("", name)
        if name in buffers and attr not in _STATE:
            value = torch.as_tensor(np.array(value))
            if tuple(value.shape) != tuple(buffers[name].shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(buffers[name].shape)}")
            with torch.no_grad():
                buffers[name].copy_(value)
            continue
        if attr == "variational_params_initialized":
            module.get_submodule(path).variational_params_initialized.fill_(int(np.asarray(value)))
            continue
        if attr == "randn_weights":
            owner = module.get_submodule(path)
            owner.register_buffer("randn_weights", torch.as_tensor(np.array(value), device=owner.raw_lengthscale.device))
            continue
        if attr == "nn_xinduce_idx":
            owner = module.get_submodule(path)
            device = owner.nn_xinduce_idx.device
            owner.nn_xinduce_idx = torch.as_tensor(np.array(value), dtype=torch.long, device=device)
            continue
        kernel = module.get_submodule(path)
        device = kernel.grid_0.device
        if attr == "grid":
            kernel.update_grid([torch.as_tensor(np.array(g), device=device) for g in value])
        else:
            setattr(kernel, attr, torch.as_tensor(np.array(value), device=device))
    for m in module.modules():
        if hasattr(m, "clear_caches"):
            m.clear_caches()
    return module


# the state besides parameters that ``load_jax_params`` carries: a grid kernel's (and a grid
# variational strategy's grid), a variational strategy's flag, a VNNGP strategy's sequential
# neighbours and an RFF kernel's frequencies
_STATE = ("grid", "grid_bounds", "has_initialized_grid", "variational_params_initialized", "nn_xinduce_idx",
          "randn_weights")
