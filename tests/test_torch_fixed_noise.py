"""The port's fixed-noise likelihoods and Dirichlet classification against the JAX package,
in float64 on the CPU.

``FixedGaussianNoise`` (its floor ``settings.min_fixed_noise`` and its zero operator at points
it holds no noise for), ``FixedNoiseGaussianLikelihood`` with and without a learned noise on
top, ``GaussianLikelihoodWithMissingObs``, ``HeteroskedasticNoise``, the Dirichlet targets,
and a three-class Dirichlet GP (a batch of three GPs with ``batch_shape=(3,)`` on the
transformed targets): its MLL and gradient on the dense-Cholesky path (N=300) and by mBCG
with probes injected into both packages (N=900), its class predictions, and
``get_fantasy_model(noise=...)`` of a fixed-noise model.  The same numpy data and raw
parameters go through both packages; the JAX side gets float64 distances (its ``sq_dist``
forms the distance product in float32 even under x64) and is ``jax.jit``ted.

Tolerances are stated at each test: 1e-8 relative wherever both packages run the same
float64 arithmetic in another order, 1e-12 for closed forms.
"""

import contextlib
import functools
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.root
import gpytorch_tpu_torch as gt
from gpytorch_tpu_torch.utils.warnings import GPInputWarning

D, C, PROBES, PC_RANK = 3, 3, 8, 20
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


def _draw(tag, shape):
    return np.random.default_rng([tag, *shape]).normal(size=shape)


_JAX_DRAWS = {}


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    """Float64 distances in JAX; probes injected, keyed by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))


def _classification_task(n, seed=0):
    """Inputs (n, D) and labels 0..2: the terciles of a smooth function plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    f = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.2 * rng.normal(size=n)
    return x, np.digitize(f, np.quantile(f, [1 / 3, 2 / 3])).astype(np.int64)


def _params():
    return {
        "covar_module.base_kernel.raw_lengthscale": np.array([[[-0.4, 0.1, -0.7]], [[0.3, -0.5, 0.2]],
                                                              [[-1.0, 0.6, 0.0]]]),
        "covar_module.raw_outputscale": np.array([0.5, -0.3, 1.1]),
        "mean_module.raw_constant": np.array([0.05, -0.1, 0.2]),
    }


def _model_class(pkg, b):
    class BatchGP(pkg.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean(batch_shape=(b,))
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D, batch_shape=(b,)),
                                                        batch_shape=(b,))

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return BatchGP


def _solver_settings(mod, mbcg):
    stack = contextlib.ExitStack()
    if mbcg:
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_cg_iterations(300),
                    mod.cg_tolerance(1e-2), mod.num_trace_samples(PROBES), mod.max_lanczos_quadrature_iterations(5),
                    mod.max_preconditioner_size(PC_RANK), mod.cg_stall_window(10),
                    mod.preconditioner_noise_budget(1e-3), mod.fast_precond_grad(True)):
            stack.enter_context(ctx)
    return stack


def _torch_dirichlet(x, labels):
    lik = gt.likelihoods.DirichletClassificationLikelihood(torch.from_numpy(labels), dtype=torch.float64)
    model = _model_class(gt, C)(torch.from_numpy(x).expand((C,) + x.shape), lik.transformed_targets, lik)
    return gt.load_jax_params(model.double(), _params())


@functools.lru_cache(maxsize=None)
def _jax_dirichlet_loss(n, mbcg):
    x, labels = _classification_task(n)
    jx = jnp.broadcast_to(jnp.asarray(x), (C,) + x.shape)
    jl = gp.likelihoods.DirichletClassificationLikelihood(jnp.asarray(labels), dtype=jnp.float64)
    jm = _model_class(gp, C)(jx, jl.transformed_targets, jl)

    def loss(p, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _solver_settings(gp.settings, mbcg):
            mll = gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jx), m.train_targets,
                                                                      key=jax.random.PRNGKey(0))
        return -jnp.sum(mll), mll

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def test_fixed_gaussian_noise_floor_and_zero_operator_match_jax_package():
    # the floor min_fixed_noise (1e-6 in float64, 1e-4 in float32), the explicit noise=, and
    # the zero operator (n*, n*) at another number of points; closed forms, 1e-12
    noise = np.array([1e-9, 0.2, 3e-5, 0.7])
    for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        tn = gt.likelihoods.FixedGaussianNoise(torch.from_numpy(noise).to(dtype))
        jn = gp.likelihoods.noise_models.FixedGaussianNoise(jnp.asarray(noise, dtype=jdt))
        np.testing.assert_allclose(tn(shape=(4,)).to_dense().numpy(), np.asarray(jn(shape=(4,)).to_dense()),
                                   rtol=1e-6 if dtype == torch.float32 else 1e-12)
        assert tn(shape=(4,))._diagonal().min().item() == pytest.approx(gt.settings.min_fixed_noise.value(dtype))
    tn = gt.likelihoods.FixedGaussianNoise(torch.from_numpy(noise))
    jn = gp.likelihoods.noise_models.FixedGaussianNoise(jnp.asarray(noise))
    new = np.array([0.3, 1e-12])
    np.testing.assert_allclose(tn(shape=(2,), noise=torch.from_numpy(new)).to_dense().numpy(),
                               np.asarray(jn(shape=(2,), noise=jnp.asarray(new)).to_dense()), rtol=1e-12)
    zero = tn(shape=(3, 2))
    assert isinstance(zero, gt.linop.ZeroLinearOperator) and zero.shape == (3, 2, 2)
    np.testing.assert_array_equal(zero.to_dense().numpy(), np.asarray(jn(shape=(3, 2)).to_dense()))
    kernel = gt.linop.DenseLinearOperator(torch.eye(2, dtype=torch.float64))
    assert (kernel + zero) is kernel


@pytest.mark.parametrize("learn", [False, True], ids=["fixed", "learn_additional_noise"])
def test_fixed_noise_likelihood_matches_jax_package(learn):
    # the marginal's covariance, its log-density, expected_log_prob and the fantasy
    # likelihood's noise, with and without a learned noise on top; closed forms, 1e-12
    rng = np.random.default_rng(3)
    n = 6
    noise, mean, y = rng.uniform(0.05, 0.5, size=n), rng.normal(size=n), rng.normal(size=n)
    a = rng.normal(size=(n, n))
    cov = a @ a.T / n
    tl = gt.likelihoods.FixedNoiseGaussianLikelihood(torch.from_numpy(noise), learn_additional_noise=learn).double()
    jl = gp.likelihoods.FixedNoiseGaussianLikelihood(jnp.asarray(noise), learn_additional_noise=learn,
                                                     dtype=jnp.float64)
    if learn:
        gt.load_jax_params(tl, {"second_noise_covar.raw_noise": np.array([-1.3])})
        jl = jl.with_params({"second_noise_covar.raw_noise": jnp.asarray([-1.3])})
    tf = gt.distributions.MultivariateNormal(torch.from_numpy(mean), gt.linop.DenseLinearOperator(torch.from_numpy(cov)))
    jf = gp.distributions.MultivariateNormal(jnp.asarray(mean), jnp.asarray(cov))
    with torch.no_grad():
        tm, jm = tl(tf), jl(jf)
        np.testing.assert_allclose(tm.covariance_matrix.numpy(), np.asarray(jm.covariance_matrix), rtol=1e-12)
        np.testing.assert_allclose(tm.log_prob(torch.from_numpy(y)).item(), float(jm.log_prob(jnp.asarray(y))),
                                   rtol=1e-12)
        np.testing.assert_allclose(tl.expected_log_prob(torch.from_numpy(y), tf).numpy(),
                                   np.asarray(jl.expected_log_prob(jnp.asarray(y), jf)), rtol=1e-12)
        np.testing.assert_allclose(tl.noise.numpy(), np.asarray(jl.noise), rtol=1e-12)
    new = np.array([0.11, 0.22])
    tfl, jfl = tl.get_fantasy_likelihood(noise=torch.from_numpy(new)), jl.get_fantasy_likelihood(noise=jnp.asarray(new))
    np.testing.assert_allclose(tfl.noise_covar.noise.numpy(), np.asarray(jfl.noise_covar.noise), rtol=1e-12)
    with pytest.raises(RuntimeError, match="noise"):
        tl.get_fantasy_likelihood()


def test_fixed_noise_prediction_warns_and_predicts_without_noise():
    # at points other than the training points the fixed part is the zero operator: the
    # marginal is the latent distribution itself (as in the JAX package), and the port warns
    # (the JAX package's shape test never fires: its zero operator has the points' shape)
    tl = gt.likelihoods.FixedNoiseGaussianLikelihood(torch.full((5,), 0.1, dtype=torch.float64))
    jl = gp.likelihoods.FixedNoiseGaussianLikelihood(jnp.full((5,), 0.1), dtype=jnp.float64)
    cov = np.diag([1.0, 2.0, 3.0])
    tf = gt.distributions.MultivariateNormal(torch.zeros(3, dtype=torch.float64),
                                             gt.linop.DenseLinearOperator(torch.from_numpy(cov)))
    with pytest.warns(GPInputWarning, match="no-noise"):
        out = tl(tf)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jout = jl(gp.distributions.MultivariateNormal(jnp.zeros(3), jnp.asarray(cov)))
    np.testing.assert_array_equal(out.covariance_matrix.numpy(), cov)
    np.testing.assert_array_equal(np.asarray(jout.covariance_matrix), cov)
    # with a learned noise on top there is no warning, and the marginal adds that noise
    tl2 = gt.likelihoods.FixedNoiseGaussianLikelihood(torch.full((5,), 0.1, dtype=torch.float64),
                                                      learn_additional_noise=True).double()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out2 = tl2(tf)
    np.testing.assert_allclose(out2.covariance_matrix.detach().numpy(), cov + tl2.second_noise.item() * np.eye(3),
                               rtol=1e-12)


def test_missing_obs_likelihood_matches_jax_package():
    # NaN targets read 0 in log_marginal and expected_log_prob; closed forms, 1e-12
    rng = np.random.default_rng(4)
    mean, var = rng.normal(size=7), rng.uniform(0.1, 1.0, size=7)
    y = rng.normal(size=7)
    y[[1, 4]] = np.nan
    tl = gt.load_jax_params(gt.likelihoods.GaussianLikelihoodWithMissingObs().double(),
                            {"noise_covar.raw_noise": np.array([-1.1])})
    jl = gp.likelihoods.GaussianLikelihoodWithMissingObs(dtype=jnp.float64).with_params(
        {"noise_covar.raw_noise": jnp.asarray([-1.1])})
    tf = gt.distributions.MultivariateNormal(torch.from_numpy(mean), gt.linop.DiagLinearOperator(torch.from_numpy(var)))
    jf = gp.distributions.MultivariateNormal(jnp.asarray(mean), jnp.diag(jnp.asarray(var)))
    with torch.no_grad():
        t_lm = tl.log_marginal(torch.from_numpy(y), tf).numpy()
        t_el = tl.expected_log_prob(torch.from_numpy(y), tf).numpy()
    np.testing.assert_allclose(t_lm, np.asarray(jl.log_marginal(jnp.asarray(y), jf)), rtol=1e-12)
    np.testing.assert_allclose(t_el, np.asarray(jl.expected_log_prob(jnp.asarray(y), jf)), rtol=1e-12)
    assert t_lm[1] == 0.0 and t_el[4] == 0.0 and np.isfinite(t_lm).all()


def test_heteroskedastic_noise_matches_jax_package():
    # the noise of each point read from a second model's mean, through GreaterThan(1e-4); 1e-12
    x, _ = _classification_task(20)

    def noise_model(pkg):
        class NoiseGP(pkg.models.ExactGP):
            def __init__(self):
                super().__init__(None, None, pkg.likelihoods.GaussianLikelihood())
                self.mean_module = pkg.means.LinearMean(D)
                self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel())

            def forward(self, z):
                return pkg.distributions.MultivariateNormal(self.mean_module(z), self.covar_module(z))

        return NoiseGP()

    w = np.array([[0.3], [-0.7], [0.2]])
    tn = gt.likelihoods.HeteroskedasticNoise(noise_model(gt).double())
    tn.noise_model.mean_module.weights.data = torch.from_numpy(w)
    jmod = noise_model(gp)
    jmod = jmod.with_params({**{k: jnp.asarray(v, dtype=jnp.float64) for k, v in jmod.trainable_params().items()},
                             "mean_module.weights": jnp.asarray(w)})
    jn = gp.likelihoods.noise_models.HeteroskedasticNoise(jmod)
    with torch.no_grad():
        got = tn(torch.from_numpy(x))._diagonal().numpy()
    np.testing.assert_allclose(got, np.asarray(jn(jnp.asarray(x))._diagonal()), rtol=1e-12)


def test_dirichlet_targets_match_jax_package():
    # σ² = log(1/α + 1), log α − σ²/2 with α = ε + one-hot, both (C, n), and the targets
    # prepared anew by __call__(..., targets=); 1e-14
    _, labels = _classification_task(50)
    tl = gt.likelihoods.DirichletClassificationLikelihood(torch.from_numpy(labels), dtype=torch.float64)
    jl = gp.likelihoods.DirichletClassificationLikelihood(jnp.asarray(labels), dtype=jnp.float64)
    assert tl.num_classes == jl.num_classes == C
    assert tl.transformed_targets.shape == (C, 50)
    np.testing.assert_allclose(tl.transformed_targets.numpy(), np.asarray(jl.transformed_targets), rtol=1e-14)
    np.testing.assert_allclose(tl.noise.numpy(), np.asarray(jl.noise), rtol=1e-14)
    other = (labels + 1) % C
    f = gt.distributions.MultivariateNormal(torch.zeros(C, 50, dtype=torch.float64),
                                            gt.linop.DiagLinearOperator(torch.ones(C, 50, dtype=torch.float64)))
    out = tl(f, targets=torch.from_numpy(other))
    jl(gp.distributions.MultivariateNormal(jnp.zeros((C, 50)), jnp.broadcast_to(jnp.eye(50), (C, 50, 50))),
       targets=jnp.asarray(other))
    np.testing.assert_allclose(tl.transformed_targets.numpy(), np.asarray(jl.transformed_targets), rtol=1e-14)
    np.testing.assert_allclose(out.variance.numpy(), 1.0 + np.asarray(jl.noise), rtol=1e-14)
    assert tl.get_fantasy_likelihood() is tl


@pytest.mark.parametrize("n,mbcg", [(300, False), (900, True)], ids=["cholesky_300", "mbcg_900"])
def test_dirichlet_gp_mll_and_gradient_match_jax_package(n, mbcg):
    # three classes as a batch of three GPs on the transformed targets, with the fixed
    # heteroskedastic noise (≈ 0.69 at the true class, ≈ 4.6 elsewhere): one dense Cholesky
    # factor per class at N=300; at N=900 mBCG with a rank-20 preconditioner per class over
    # max(D, τ) of a non-constant diagonal and injected probes ((t, C, k, 1), (t, C, n));
    # 1e-8 relative
    draws = {s: jnp.asarray(_draw(0, s)) for s in ((PROBES, C, PC_RANK, 1), (PROBES, C, n))}
    (_, jmll), jgrad = _jax_dirichlet_loss(n, mbcg)({k: jnp.asarray(v) for k, v in _params().items()}, draws)
    model = _torch_dirichlet(*_classification_task(n))
    with _solver_settings(gt.settings, mbcg):
        mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(
            model(model.train_inputs[0]), model.train_targets, base_samples=lambda s: _draw(0, s))
    (-mll.sum()).backward()
    np.testing.assert_allclose(mll.detach().numpy(), np.asarray(jmll), rtol=RTOL)
    for name, p in model.named_parameters():
        want = np.asarray(jgrad[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_dirichlet_posterior(n, m):
    x, labels = _classification_task(n + m)
    jx = jnp.broadcast_to(jnp.asarray(x[:n]), (C, n, D))
    jl = gp.likelihoods.DirichletClassificationLikelihood(jnp.asarray(labels[:n]), dtype=jnp.float64)

    @jax.jit
    def posterior(p, tx):
        jm = _model_class(gp, C)(jx, jl.transformed_targets, jl).with_params(p).eval()
        post = jm(jnp.broadcast_to(tx, (C,) + tx.shape))
        return post.mean, post.variance

    mean, var = posterior({k: jnp.asarray(v) for k, v in _params().items()}, jnp.asarray(x[n:]))
    return np.asarray(mean), np.asarray(var)


def test_dirichlet_gp_class_predictions_match_jax_package():
    # the latent means and variances of the three classes at 80 test points on the
    # dense-Cholesky path (N=300), and the predicted class, the argmax of the means; 1e-8
    n, m = 300, 80
    want_mean, want_var = _jax_dirichlet_posterior(n, m)
    x, labels = _classification_task(n + m)
    model = _torch_dirichlet(x[:n], labels[:n]).eval()
    with torch.no_grad():
        post = model(torch.from_numpy(x[n:]))
    assert post.mean.shape == (C, m)
    np.testing.assert_allclose(post.mean.numpy(), want_mean, rtol=RTOL, atol=RTOL * np.abs(want_mean).max())
    np.testing.assert_allclose(post.variance.numpy(), want_var, rtol=RTOL, atol=RTOL * want_var.max())
    np.testing.assert_array_equal(post.mean.argmax(0).numpy(), want_mean.argmax(0))
    assert (post.mean.argmax(0).numpy() == labels[n:]).mean() > 1 / C


def _fixed_noise_model(pkg, x, y, noise):
    class FixedNoiseGP(pkg.models.ExactGP):
        def __init__(self, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean()
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D))

        def forward(self, z):
            return pkg.distributions.MultivariateNormal(self.mean_module(z), self.covar_module(z))

    if pkg is gt:
        return FixedNoiseGP(gt.likelihoods.FixedNoiseGaussianLikelihood(noise))
    return FixedNoiseGP(gp.likelihoods.FixedNoiseGaussianLikelihood(noise, dtype=jnp.float64))


FN_PARAMS = {"covar_module.base_kernel.raw_lengthscale": np.array([[-0.4, 0.1, -0.7]]),
             "covar_module.raw_outputscale": np.array(0.5), "mean_module.raw_constant": np.array(0.05)}


def test_fixed_noise_fantasy_model_matches_jax_package():
    # get_fantasy_model(x_new, y_new, noise=...) on a fixed-noise model at N=300 (dense
    # Cholesky): the Schur update's D block takes the new points' noise, and the fantasy
    # likelihood holds n + m noises.  The fantasy's posterior mean and variances at 40 test
    # points against the JAX package's fantasy (1e-8) and against a model built on the joint
    # data with the joint noise (1e-8)
    n, m, q = 300, 12, 40
    x, labels = _classification_task(n + m + q, seed=5)
    y = np.sin(3 * x[:, 0]) + 0.1 * labels
    noise = np.random.default_rng(6).uniform(0.02, 0.2, size=n + m)
    tx, ty, tn = (torch.from_numpy(a) for a in (x, y, noise))
    tm = gt.load_jax_params(_fixed_noise_model(gt, tx[:n], ty[:n], tn[:n]).double(), FN_PARAMS).eval()
    jm = _fixed_noise_model(gp, jnp.asarray(x[:n]), jnp.asarray(y[:n]), jnp.asarray(noise[:n]))
    jm = jm.with_params({k: jnp.asarray(v) for k, v in FN_PARAMS.items()}).eval()
    test = x[n + m:]
    with torch.no_grad():
        tm(tx[n + m:])
        fant = tm.get_fantasy_model(tx[n:n + m], ty[n:n + m], noise=tn[n:n + m])
        post = fant(tx[n + m:])
        mean, var = post.mean.numpy(), post.variance.numpy()
    assert fant.likelihood.noise_covar.noise.shape == (n + m,)
    assert tm.likelihood.noise_covar.noise.shape == (n,)

    @jax.jit
    def jax_fantasy(tz):
        jm(tz)
        jf = jm.get_fantasy_model(jnp.asarray(x[n:n + m]), jnp.asarray(y[n:n + m]), noise=jnp.asarray(noise[n:n + m]))
        p = jf(tz)
        return p.mean, p.variance

    jmean, jvar = (np.asarray(a) for a in jax_fantasy(jnp.asarray(test)))
    np.testing.assert_allclose(mean, jmean, rtol=RTOL, atol=RTOL * np.abs(jmean).max())
    np.testing.assert_allclose(var, jvar, rtol=RTOL, atol=RTOL * jvar.max())
    joint = gt.load_jax_params(_fixed_noise_model(gt, tx[:n + m], ty[:n + m], tn).double(), FN_PARAMS).eval()
    with torch.no_grad():
        ref = joint(tx[n + m:])
    np.testing.assert_allclose(mean, ref.mean.numpy(), rtol=RTOL, atol=RTOL * np.abs(mean).max())
    np.testing.assert_allclose(var, ref.variance.numpy(), rtol=RTOL, atol=RTOL * var.max())
