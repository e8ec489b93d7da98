"""Natural-gradient descent.  Counterpart of ``gpytorch_tpu/optim/ngd.py``: the update
p ← p − lr · num_data · ∇p, for the parameters of a natural-coordinate variational
distribution (``variational.NaturalVariationalDistribution``), whose gradients are the
natural gradients (the expectation-parameter gradients its conversion's backward returns).
With a Gaussian likelihood and the whole data set, lr = 1 reaches the optimal q(u) in one
step.  Train the other parameters with another optimizer, chosen by name."""

from __future__ import annotations

import torch


class NGD(torch.optim.Optimizer):
    def __init__(self, params, num_data: int, lr: float = 0.1):
        super().__init__(params, {"lr": float(lr), "num_data": int(num_data)})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(p.grad, alpha=-group["lr"] * group["num_data"])
        return loss
