"""LOVE's rank on 1D KISS-GP: the JAX package's LOVE against its own exact branch, beside the port's.

Phase 11 of chip_smoke.py serves a 1D KISS-GP model (the periodic task's time column,
m = N grid points) whose LOVE variances, from a rank-100 Lanczos root, read far above the
exact interpolated branch's at the forecast's first points.  This script reads the JAX
package on the same model: ``chip_smoke.love_rank_model`` trains it at N=3,000 in float64
with the port, the JAX model takes its raw parameters, both packages take the JAX model's
grid and the same Lanczos start block (as ``tests/test_torch_kissgp.py`` injects them),
and each package's LOVE of each rank is read against its own exact branch (CG to 1e-10)
on the forecast's first 256 readings, every 16th.  Float64 on the CPU, a few minutes, not
part of the test run:

    python tests/love_rank_witness.py [N] [rank ...]
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

import chip_smoke  # noqa: E402
import gpytorch_tpu as gp  # noqa: E402
import gpytorch_tpu.solvers.lanczos  # noqa: E402
import gpytorch_tpu_torch as gt  # noqa: E402
import gpytorch_tpu_torch.solvers.lanczos  # noqa: E402
from test_torch_kissgp import JaxKiss, _exact_float64_sq_dist, _grid_state, _start_block  # noqa: E402


def _jax_settings(n, rank, exact):
    s = gp.settings
    ctxs = [s.max_cholesky_size(0), s.max_preconditioner_size(50), s.cg_stall_window(50),
            s.preconditioner_noise_budget(chip_smoke.PC_NOISE_BUDGET_F64), s.skip_posterior_variances(False)]
    if exact:
        ctxs += [s.fast_pred_var(False), s.eval_cg_tolerance(1e-10), s.max_cg_iterations(10 * n)]
    else:
        ctxs += [s.fast_pred_var(True), s.eval_cg_tolerance(1e-3), s.max_cg_iterations(1000),
                 s.max_root_decomposition_size(rank)]
    return ctxs


def main(n=3000, ranks=(100,)):
    torch.set_num_threads(4)
    sys.modules["gpytorch_tpu.ops.sq_dist"].sq_dist = _exact_float64_sq_dist
    sys.modules["gpytorch_tpu.kernels.kernel"]._sq_dist_op = _exact_float64_sq_dist
    gpytorch_tpu.solvers.lanczos._block_init = lambda linop, iv, b: jnp.asarray(_start_block(linop.shape[-1], b))
    gpytorch_tpu_torch.solvers.lanczos._block_init = (
        lambda linop, iv, b: torch.from_numpy(_start_block(linop.shape[-1], b)))

    model, cand = chip_smoke.love_rank_model(n)
    kernel = model.covar_module
    tx, ty = model.train_inputs[0].numpy(), model.train_targets.numpy()
    jm = JaxKiss(jnp.asarray(tx), jnp.asarray(ty),
                 gp.likelihoods.GaussianLikelihood(noise_constraint=gp.constraints.GreaterThan(chip_smoke.NOISE_FLOOR)),
                 kernel.grid_sizes[0], 1, [tuple(float(b) for b in kernel.grid_bounds[0])])
    jm.covar_module(jnp.asarray(tx)).evaluate_kernel()
    params = {k: p.detach().numpy() for k, p in model.named_parameters()}
    gt.load_jax_params(model, {**params, **_grid_state(jm.covar_module)})

    port = chip_smoke.love_rank_readings(model, cand, ranks)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def variances(exact, rank):
        @jax.jit
        def run(p, x):
            ctxs = _jax_settings(n, rank, exact)
            for c in ctxs:
                c.__enter__()
            try:
                return jnp.diagonal(jm.with_params(p).eval()(x).covariance_matrix)
            finally:
                for c in reversed(ctxs):
                    c.__exit__(None, None, None)
        return np.asarray(run(jparams, jnp.asarray(cand.numpy())))

    exact = variances(True, None)
    for (rank, port_max, port_median) in port:
        love = variances(False, rank)
        rel = np.abs(love - exact) / exact
        print(f"[love rank] N={n}, m={n}, float64, the JAX package on the CPU: LOVE of rank {rank} against its exact "
              f"branch: max |Δσ²| / σ² {rel.max():.3e}, median {np.median(rel):.3e} (the port: {port_max:.3e}, "
              f"{port_median:.3e}); σ² {exact.min():.4e} to {exact.max():.4e}", flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*(args[:1] or [3000]), *([tuple(args[1:])] if len(args) > 1 else []))
