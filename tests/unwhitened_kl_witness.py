"""The unwhitened KL by mBCG at m = 1,024: the JAX package beside the port, on one state.

Phase 14b of chip_smoke.py trains the unwhitened strategy at m = 1,024 inducing points (a
Cholesky q(u), K_ZZ's jitter 1e-4), and its KL, which runs mBCG/SLQ on the lazy
K_ZZ + jitter (1,024 rows are above max_cholesky_size), reads far from the dense-Cholesky
KL of the same state.  This script reads both packages' mBCG KL on one state, with the same
probes injected into both (as ``tests/test_torch_svgp.py`` injects them), under each
package's default solver settings, beside each package's dense-Cholesky KL, in float64 and
in float32, on the CPU (exact float64 distances in JAX, as the tests patch them).  The state
is the one ``chip_smoke.phase_unwhitened(save=path)`` wrote on the card, or, with no path,
that phase's state before its first step (q(u) initialised from the prior):

    python3 -c 'import chip_smoke; chip_smoke.phase_unwhitened(save="chiprun_out/uw_state.npz")'  # on the card
    python tests/unwhitened_kl_witness.py [chiprun_out/uw_state.npz]

A few minutes on the CPU, not part of the test run.  On the last state of one H100 run of
phase 14b it read, with the same probes in both packages: mBCG float64 JAX −1,460.257, port
−1,460.126; mBCG float32 −1,204.752 and −1,198.378; dense Cholesky float64 128,563.933 in
both, float32 JAX 128,550.641 and port 128,557.180 (both factor the float32 K_ZZ in float64:
``settings._linalg_dtype_cholesky``; factored in float32 the port read 127,070.7).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import gpytorch_tpu as gp  # noqa: E402
import gpytorch_tpu.linop.base  # noqa: E402
import gpytorch_tpu_torch as gt  # noqa: E402
import gpytorch_tpu_torch.linop.base  # noqa: E402
from svgp_elbo_reference import _exact_float64_sq_dist  # noqa: E402

PROBE_TAG = 7


def _probes(shape):
    return np.random.default_rng([PROBE_TAG, *shape]).normal(size=shape)


def _initial_state(train_x):
    """Phase 14b's state before its first step, from the port: q(u) initialised from the
    prior N(μ_Z, K_ZZ + jitter) on the model's first call (float64 on the CPU)."""
    model, likelihood = cs.build_svgp(train_x, "cpu", torch.float64, dist="cholesky", whitened=False,
                                      jitter_val=cs.SVGP_JITTER)
    with torch.no_grad():
        model(torch.as_tensor(train_x[:4]))
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


def _jax_model(params, dtype):
    Z = jnp.asarray(params["variational_strategy.inducing_points"], dtype=dtype)

    class SVGP(gp.models.ApproximateGP):
        def __init__(self):
            vd = gp.variational.CholeskyVariationalDistribution(Z.shape[-2], dtype=dtype)
            super().__init__(gp.variational.UnwhitenedVariationalStrategy(self, Z, vd, jitter_val=cs.SVGP_JITTER))
            self.mean_module = gp.means.ConstantMean(dtype=dtype)
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=cs.D, dtype=dtype),
                                                       dtype=dtype)

        def forward(self, x):
            return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    model = SVGP()
    model(Z[:4])  # eager initialisation, then overwritten
    return model.with_params({k: jnp.asarray(v, dtype=dtype) for k, v in params.items()})


def _torch_model(train_x, params, dtype):
    model, _ = cs.build_svgp(train_x, "cpu", dtype, dist="cholesky", whitened=False, jitter_val=cs.SVGP_JITTER)
    gt.load_jax_params(model, params | {"variational_strategy.variational_params_initialized": 1})
    return model


def readings(train_x, params):
    """{(package, dtype): (mBCG KL, dense-Cholesky KL)} on ``params``."""
    out = {}
    for name, jdt, tdt in (("float64", jnp.float64, torch.float64), ("float32", jnp.float32, torch.float32)):
        jm = _jax_model(params, jdt)
        kl = jax.jit(lambda: jm.variational_strategy.kl_divergence(model=jm))
        with gp.settings.max_cholesky_size(cs.SVGP_M):
            dense = float(jax.jit(lambda: jm.variational_strategy.kl_divergence(model=jm))())
        out[("JAX package", name)] = (float(kl()), dense)
        tm = _torch_model(train_x, params, tdt)
        with torch.no_grad():
            mbcg = tm.variational_strategy.kl_divergence(model=tm).item()
            with gt.settings.max_cholesky_size(cs.SVGP_M):
                dense = tm.variational_strategy.kl_divergence(model=tm).item()
        out[("port", name)] = (mbcg, dense)
    return out


def main(path=None):
    torch.set_num_threads(4)
    sys.modules["gpytorch_tpu.ops.sq_dist"].sq_dist = _exact_float64_sq_dist
    sys.modules["gpytorch_tpu.kernels.kernel"]._sq_dist_op = _exact_float64_sq_dist
    gpytorch_tpu.linop.base.probe_base_samples = lambda key, shape, dtype: jnp.asarray(_probes(tuple(shape)),
                                                                                       dtype=dtype)
    gpytorch_tpu_torch.linop.base.probe_base_samples = (
        lambda shape, dtype, device, source=None: torch.from_numpy(_probes(tuple(shape))).to(dtype))

    train_x, _, _, _ = cs.make_task(cs.N_TRAIN, cs.N_TEST)
    if path is None:
        params, origin = _initial_state(train_x), "phase 14b's state before its first step"
    else:
        with np.load(path) as f:
            params = {k: f[k] for k in f.files if not k.startswith("likelihood.")}
        origin = f"the state in {path}"
    print(f"unwhitened KL at m = {cs.SVGP_M}, {origin}: mBCG (injected probes, each package's default "
          f"settings) and dense Cholesky", flush=True)
    for (pkg, dtype), (mbcg, dense) in readings(train_x, params).items():
        print(f"  {pkg:<12} {dtype}: mBCG {mbcg:.6f}, dense Cholesky {dense:.6f}", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:2])
