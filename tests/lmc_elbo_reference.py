"""The JAX package's float64 ELBO and KL term at the parity state of chip_smoke.py's phase 17.

``chip_smoke.lmc_parity_state`` draws, with numpy, the parameters of an LMC multitask SVGP on
``make_lmc_task``'s data (4 tasks from 3 latent GPs, m = 256 inducing points a latent, a
Cholesky q(u), K_ZZ's jitter 1e-4, a MultitaskGaussianLikelihood) and one minibatch of 512
training points.  This script builds the same model with the JAX package (gpytorch_tpu), in
float64 on the CPU with exact float64 distances (the JAX ``sq_dist`` forms its distance
product in float32 even under x64), and prints its ELBO and its KL term (KL(q(u) ‖ p(u)) /
num_data, the second of ``combine_terms=False``'s terms), the values chip_smoke.py keeps as
``LMC_ELBO_JAX`` and ``LMC_KL_JAX``:

    JAX_PLATFORMS=cpu python tests/lmc_elbo_reference.py

``tests/test_torch_lmc.py`` runs ``jax_terms`` and checks the constants against it.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import gpytorch_tpu as gp  # noqa: E402


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


def jax_terms() -> tuple:
    """(ELBO, KL term) (num_data = chip_smoke.N_TRAIN) of the parity state on its minibatch."""
    sq_mod, kernel_mod = sys.modules["gpytorch_tpu.ops.sq_dist"], sys.modules["gpytorch_tpu.kernels.kernel"]
    saved = sq_mod.sq_dist, kernel_mod._sq_dist_op
    sq_mod.sq_dist = kernel_mod._sq_dist_op = _exact_float64_sq_dist
    try:
        cs = chip_smoke
        train_x, train_y, _, _ = cs.make_lmc_task(cs.N_TRAIN, cs.N_TEST)
        params, lik_params, xb, yb = cs.lmc_parity_state(train_x, train_y)
        f64, q, batch = jnp.float64, cs.LMC_LATENTS, (cs.LMC_LATENTS,)
        Z = jnp.asarray(params["variational_strategy.base_variational_strategy.inducing_points"])

        class LMCSVGP(gp.models.ApproximateGP):
            def __init__(self):
                vd = gp.variational.CholeskyVariationalDistribution(Z.shape[-2], batch_shape=batch, dtype=f64)
                base = gp.variational.VariationalStrategy(self, Z, vd, jitter_val=cs.SVGP_JITTER)
                super().__init__(gp.variational.LMCVariationalStrategy(base, num_tasks=cs.LMC_TASKS, num_latents=q,
                                                                       latent_dim=-1))
                self.mean_module = gp.means.ConstantMean(batch_shape=batch, dtype=f64)
                self.covar_module = gp.kernels.ScaleKernel(
                    gp.kernels.RBFKernel(ard_num_dims=cs.D, batch_shape=batch, dtype=f64), batch_shape=batch, dtype=f64)

            def forward(self, x):
                return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

        model = LMCSVGP()
        model(jnp.asarray(xb[:4]))  # eager initialisation, then overwritten
        model = model.with_params({k: jnp.asarray(v) for k, v in params.items()})
        likelihood = gp.likelihoods.MultitaskGaussianLikelihood(num_tasks=cs.LMC_TASKS, dtype=f64)
        likelihood = likelihood.with_params({k: jnp.asarray(v) for k, v in lik_params.items()})
        mll = gp.mlls.VariationalELBO(likelihood, model, num_data=cs.N_TRAIN, combine_terms=False)
        log_lik, kl, log_prior = jax.jit(lambda x, y: mll(model(x), y))(jnp.asarray(xb), jnp.asarray(yb))
        return float(log_lik - kl + log_prior), float(kl)
    finally:
        sq_mod.sq_dist, kernel_mod._sq_dist_op = saved


if __name__ == "__main__":
    elbo, kl = jax_terms()
    print(f"LMC_ELBO_JAX = {elbo!r}\nLMC_KL_JAX = {kl!r}")
