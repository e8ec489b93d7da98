"""The JAX package's float64 values that chip_smoke.py's phases 16 and 16c gate on.

* ``jax_ciq_elbo``: the ELBO of a whitened CIQ-SVGP (``CiqVariationalStrategy``, a Cholesky
  q(u), K_ZZ's jitter ``SVGP_JITTER``) at ``chip_smoke.svgp_parity_state(m=CIQ_PARITY_M,
  batch_size=CIQ_PARITY_BATCH, seed=CIQ_SEED)``, num_data = N_TRAIN: ``CIQ_ELBO_JAX``.
* ``jax_pseudo_points``: (Σ ỹ, tr D̃, ‖D̃‖_F) of the whitened strategy's online-conditioning
  pseudo-points (``VariationalStrategy.pseudo_points``) at ``chip_smoke.ovc_state`` (phase
  14's parity state with q(u)'s factor scaled): ``OVC_PSEUDO_JAX``.

Both run the JAX package (gpytorch_tpu) in float64 on the CPU with exact float64 distances
(the JAX ``sq_dist`` forms its distance product in float32 even under x64):

    JAX_PLATFORMS=cpu python tests/ciq_elbo_reference.py

``tests/test_torch_ciq.py`` runs both and checks chip_smoke's constants against them.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import gpytorch_tpu as gp  # noqa: E402
from svgp_elbo_reference import _exact_float64_sq_dist  # noqa: E402

F64 = jnp.float64


def _exact_distances(fn):
    def run():
        sq_mod, kernel_mod = sys.modules["gpytorch_tpu.ops.sq_dist"], sys.modules["gpytorch_tpu.kernels.kernel"]
        saved = sq_mod.sq_dist, kernel_mod._sq_dist_op
        sq_mod.sq_dist = kernel_mod._sq_dist_op = _exact_float64_sq_dist
        try:
            return fn()
        finally:
            sq_mod.sq_dist, kernel_mod._sq_dist_op = saved
    return run


def _model(strategy_cls, params, x0):
    Z = jnp.asarray(params["variational_strategy.inducing_points"])

    class SVGP(gp.models.ApproximateGP):
        def __init__(self):
            vd = gp.variational.CholeskyVariationalDistribution(Z.shape[-2], dtype=F64)
            super().__init__(strategy_cls(self, Z, vd, jitter_val=chip_smoke.SVGP_JITTER))
            self.mean_module = gp.means.ConstantMean(dtype=F64)
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=chip_smoke.D, dtype=F64),
                                                       dtype=F64)

        def forward(self, x):
            return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    model = SVGP()
    model(jnp.asarray(x0))  # eager initialisation, then overwritten
    return model.with_params({k: jnp.asarray(v) for k, v in params.items()})


@_exact_distances
def jax_ciq_elbo() -> float:
    train_x, train_y, _, _ = chip_smoke.make_task(chip_smoke.N_TRAIN, chip_smoke.N_TEST)
    params, lik_params, xb, yb = chip_smoke.svgp_parity_state(train_x, train_y, m=chip_smoke.CIQ_PARITY_M,
                                                              batch_size=chip_smoke.CIQ_PARITY_BATCH,
                                                              seed=chip_smoke.CIQ_SEED)
    model = _model(gp.variational.CiqVariationalStrategy, params, xb[:4])
    likelihood = gp.likelihoods.GaussianLikelihood(noise_constraint=gp.constraints.GreaterThan(chip_smoke.NOISE_FLOOR),
                                                   dtype=F64).with_params({k: jnp.asarray(v)
                                                                           for k, v in lik_params.items()})
    mll = gp.mlls.VariationalELBO(likelihood, model, num_data=chip_smoke.N_TRAIN)
    return float(jax.jit(lambda x, y: mll(model(x), y))(jnp.asarray(xb), jnp.asarray(yb)))


@_exact_distances
def jax_pseudo_points() -> tuple:
    train_x, train_y, _, _ = chip_smoke.make_task(chip_smoke.N_TRAIN, chip_smoke.N_TEST)
    params, _ = chip_smoke.ovc_state(train_x, train_y)
    model = _model(gp.variational.VariationalStrategy, params, train_x[:4])
    covar, mean = jax.jit(lambda: model.variational_strategy.pseudo_points(model))()
    covar, mean = np.asarray(covar), np.asarray(mean)
    return float(mean.sum()), float(np.trace(covar)), float(np.linalg.norm(covar))


if __name__ == "__main__":
    print(f"CIQ_ELBO_JAX = {jax_ciq_elbo()!r}\nOVC_PSEUDO_JAX = {jax_pseudo_points()!r}")
