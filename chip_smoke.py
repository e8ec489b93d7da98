#!/usr/bin/env python3
"""Smoke test of gpytorch_tpu_torch on one NVIDIA GPU: exact-GP training and serving at
N=100k, for the flagship RBF model (bench.py's default and honest recipes) and for a
periodic model, gradients of the flagship's predictions with respect to the test inputs,
LOVE posterior sampling, iterative refinement of the mean cache, the dense-Cholesky path on
a 1D toy, fantasy updates with a knowledge-gradient step through the caches, missing
targets, KISS-GP in 1D and 2D with WISKI fantasy updates, LOVE differentiated through its
Lanczos roots, a batch of two independent GPs at N=100k, Kronecker, LCM and Hadamard
multitask GPs, at N=100k sparse variational GPs (natural gradients, whitened and
unwhitened) and a two-layer deep GP, Dirichlet GP classification at N=100k, fantasies of
batched, fixed-noise and multitask models, the structure kernels (additive and SKIP), and at
N=100k a CIQ-SVGP at m = 4,096, a probit SVGP classifier, online variational conditioning, a
two-layer DSPP and VNNGP, an LMC multitask SVGP, grid-interpolation, large-batch and decoupled
SVGPs, and SGPR and random-Fourier-feature exact GPs, a spectral-mixture forecast and a derivative GP,
every kernel and mean of the long tail against the CPU, a model list of two outcomes at N=100k,
the leave-one-out pseudo-likelihood, a Bayesian GPLVM, and the LKJ, Wishart, horseshoe and
smoothed-box priors and the metrics against the CPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the result line is printed:

1. device   — a CUDA device must be present (no CPU fallback); prints the card's name and
              power limit (nvidia-smi) and turns TF32 off for matmuls and cuDNN.
2. build    — builds the five csrc/*.cu kernels for sm_90a with nvcc, one process per
              source, into one library (or reuses the build).
3. kernel   — the CUDA K·V kernel against its plain PyTorch version on the card, for the
              four kernel types at ragged shapes, and both timed at the serving shapes and
              at the training CG shape (t=64, the tensor-core tier, read against float64
              beside the plain version and timed against ``matvec_tc_bound``); the strips of
              2048 and 256 test rows against the 100k training rows at t=1 and 100, split
              over the j range, each printed with its slab count, its bound and, at t=1, the
              exp floor, the 2048-row ones gated against float64 at twice the plain float32
              version's error; the wide-d tier (d = 100) at ragged shapes and timed at
              16,384 × 16,384, t = 64; a Lanczos block of the LOVE sample root (2048 × 2048,
              t = 20, symmetric), gated as the 2048-row strips and timed beside the launch
              floor (a 64 × 64 product at t = 1).
3b. bwd     — the CUDA fused backward kernel against its plain version on the card, for
              the four kernel types, d ∈ {3, 11}, t ∈ {1, 20, 33, 64} (the tensor-core tier
              at 33 and 64), with and without dv (the kernel forms no dv: the wrapper
              launches the product for it); at the training shape (N=100k, d=3, t=64, dos,
              no dv) against the plain version in float64 beside the plain float32
              version, gated at twice its error, and both timed; the wide-d tier (d = 100)
              likewise, at n = 517 and at 16,384 rows.
3d. grad_x  — the CUDA grad_x kernel (the cotangent of one input of K·V) against its
              float32 plain version for the four kernel types, d ∈ {3, 11}, t ∈ {1, 20, 33,
              64, 100, 128, 129} (the tensor-core tier at 33-128) at ragged n ≪ m and n ≫ m,
              each tensor-core launch rerun bit for bit; at the path's shapes (2,048
              candidates against the 100k training points both ways, t = 1 and 100) against
              float64, the t=100 ones (the tensor-core tier) gated at twice the plain float32
              version's error, timed there beside both bounds, with the tier's staging (one
              staged tile of rows j) and t = 128 (all 16 k-steps) timed beside them; the
              wide-d tier (d = 100) at ragged shapes and on a 2048 × 16,384 strip.
3c. periodic kernels — the CUDA periodic K·V and fused periodic backward kernels against
              their float32 plain versions for d ∈ {1, 2, 3, 11}, t ∈ {1, 20, 64, 100}
              (ragged n ≠ m for the product, symmetric n for the backward: dx, dw and dos,
              without and with dv; at t = 64 the backward's tensor-core tier); at every
              shape of the path on the periodic task (N=100k, a = t / period up to 355: the
              product at t = 64, 1 and 20 and on the strips of 2048 and 256 rows at t = 100
              and 1, the backward's training call at t = 64: dx, dw and dos) against the
              plain versions in float64, the t=64 product and backward (the tensor-core
              tiers) and the 2048-row strips (split over the j range) gated at twice the
              plain float32 version's error there; both timed, the strips as in phase 3;
              the product's wide-d tier (d = 100) at ragged shapes and at 16,384 rows.
4. slice    — serving at N=2000 on CPU tensors (plain path) against CUDA tensors (kernel
              path), from the same data, parameters and Lanczos start; then LOVE sampling
              (``fast_pred_samples``) of the 512 points on both devices from the same base
              samples and start block: the sample root R_s R_sᵀ and the mean gated, the
              draws read beside a CPU float32-against-float64 run.
1k. cholesky — BASELINE.json config 1: an exact GP on a 1D toy (N=1,000, y = sin 2πx + 0.1
              noise), 50 Adam steps through the dense-Cholesky MLL and the mean and exact
              variance of 200 points, under ``fast_computations(False, False, False)``: CPU
              float32 against CUDA float32 (a CPU float64 run for the RMSE); no kernel may
              launch.
4c. grad-slice — the gradient of ΣUCB (UCB = μ + 2σ) with respect to 512 candidates at
              N=2000, CPU tensors against CUDA tensors, with the parameters frozen and live;
              the gate sits above a CPU float32-vs-float64 reading and below a planted fault
              in the plain grad_x (the last sixteenth of the j range dropped); then the same
              for the periodic model at its initial values on the forecast week, through
              the periodic product and the plain general periodic backward (its fault the
              same sixteenth dropped there).
5. serve    — the flagship exact GP of bench.py (ConstantMean + Scale(RBF-ARD) +
              GaussianLikelihood) on its synthetic 3droad-shaped task, N=100,000 train,
              2,048 test, d=3, under bench.py's eval settings, from fixed parameters: one
              model refresh (mean cache by preconditioned CG, LOVE cache by block Lanczos),
              then 8 requests of 256 test points and one of all 2,048 (request_ms).  Checks
              RMSE, variances and that the path launched the CUDA kernel.
5b. refine  — phase 5's mean cache built again under ``solve_iterative_refinements`` 1
              and 2: the float64 true residual of each beside the unrefined one's (gated:
              no higher), the CG iterations, the refresh time, the launches (one a CG
              iteration and one residual product a pass) and the RMSE change.
6. train    — training at N=2000 on CPU tensors against CUDA tensors under bench.py's
              training recipe: the same data, initial parameters and injected probe base
              samples; 3 Adam steps, compared at step 1 (loss, gradients) and after step 3.
              The gradient gate is shown to sit above float32 rounding (CPU float32
              against float64) and below a planted fault in the plain backward.
6b. periodic slice — phases 4 and 6 for the periodic model (ConstantMean +
              Scale(Periodic-ARD, d=2) + GaussianLikelihood) on the seasonal task at N=2000;
              its fault the plain periodic backward's dw short by one block of 16.  In the
              training slices every run follows the pivots of the CPU float32 run
              (``PinnedPivots``) and a float64 run takes the float32 runs' τ.
6c. wide slice — phase 6 for the flagship's model on 100 inputs (``make_wide_task``,
              N=4096), whose CUDA run goes through the wide-d tier of the K·V and backward
              kernels (launches checked), then one request of 512 points served on both
              devices from the CPU run's trained parameters, compared as phase 4 does.
7. flagship — the initial parameters served on all 2,048 test points; then bench.py's
              training recipe at full width (N=100,000, d=3, 63 probes, rank-50
              preconditioner, rhs-warm lagged mBCG with the variance-reduced log-det
              gradient, 120 steps of cosine Adam), then the trained model refreshed and
              asked for all 2,048 test points under the eval settings.  Checks finite
              losses and gradients, RMSE, that training lowered the loss and the
              marginal NLPD, and the launches of both kernels.
7b. honest  — the same with bench.py's honest recipe (BENCH_HONEST=1): noise ≥ 1e-4 with a
              LogNormal(−4, 1) noise prior in the MLL, CG at tolerance 0.05 with a stall
              window of 50; phase 7's data, initial values, probes and optimizer.  Prints
              the noise trajectory and the prior term, and phase 7's readings beside its
              own; gated as phase 7, with its own CG limit and RMSE band.  Alone:
              ``python3 -c 'import chip_smoke; chip_smoke.phase_honest()'``.
8. periodic — the periodic model on 347 days of 5-minute readings (N=100,000, x = [t, t],
              periods starting at 1 and 7 days): the initial parameters served on the
              forecast week (the next 2,048 readings); the sources of the gradients' noise
              there (``period_gradient_sources``: the float32 kernel path and the float32
              plain path against the float64 plain path, and the spread over probe seeds;
              the period's round-off must stay under the probe noise); phase 7's recipe for
              120 steps with
              the periods at their own learning rate; the trained model refreshed and asked
              for the week in 8 requests of 256 and one of 2,048.  Checks finite losses and
              gradients, the CG iterations of training and the forecast RMSE (within 0.003
              of the FMA tier's trajectory), variances, that training lowered the loss and
              the marginal NLPD, and the launches of both periodic kernels (none of the RBF
              ones); reads the forecast's LOVE variances against a float64 twin from the
              same caches, beside the float32 plain path's.

9. acquisition — on phase 7's trained flagship, the 2,048 test points as candidates: the
              latent (LOVE) variances against the float64 plain path from the same caches
              (read, not gated); the kernel path's ∇ΣUCB against that path; central
              differences of single candidates' UCB in float64; one gradient evaluation
              launches 2 kernel_matvec + 2 kernel_grad_x with the parameters frozen, 4 + 4
              with them live; 20 Adam steps of ascent on the candidates (the UCB must rise;
              acq_grad_ms, the median gradient evaluation);
              the float64 check and the launches again for Scale(Matérn-5/2 ARD) with the
              fitted hyperparameters, and its RMSE (no gate).
9b. sampling — on phase 7's trained flagship under ``fast_pred_samples``: 16 draws of all
              2,048 test points from a seeded generator; one draw launches kernel_matvec 7
              times (the mean, K*x R, and 5 Lanczos blocks on K** at 2048², t = 20); the
              sample root's diagonal against the float64 plain path from the same caches
              and start block; love_samp_ms, the median of 10 synchronised draws.

10. fantasy — on phase 7's trained flagship: 16 fantasy points (every 128th test point, a
              LOVE draw at them as targets); ``get_fantasy_model`` with the old strategy built
              (fantasy_ms; one 16-column CG), against a refit on the n + 16 points (the mean
              gated, with a float64 bracket and a planted fault; the LOVE variances from the
              same joint operator); the one-shot knowledge-gradient step, ∇Σμ* over the 2,048
              test points with respect to the fantasy inputs and the hyperparameters under
              ``detach_test_caches(False)`` at eval tolerance 1e-6 (kg_grad_s, the time of a
              gradient unresolved at N=100k; kernel_bwd_fused at t=1 and t=16); at N=4096 that
              step's directional derivative against central differences on the float64 plain
              path, and its CUDA float32 gradient against a CPU float64 plain run, each gate
              bracketed by planted faults; kernel_bwd_fused at t=1 and 16 (dos over the sum of
              its terms' magnitudes, beside a planted dos × 0.99) and kernel_matvec at t=16 on
              the 100k training rows against float64.  Alone:
              ``python3 -c 'import chip_smoke; chip_smoke.phase_fantasy()'`` (phase 5's model).
10b. missing — the flagship's data with 1 % of the targets NaN: one loss and gradient under
              the NaN policies "fill" and "mask" at N=100k (CG iterations, seconds), both
              policies at N=4096 through the kernels against their plain versions on the card
              and CUDA float32 against CPU float64, and "mask" against the
              observed subset's MLL in float64 at N=1000.

11. kissgp  — KISS-GP (BASELINE config 3): ConstantMean + GridInterpolationKernel(
              ScaleKernel(RBF)) + GaussianLikelihood on the periodic task's time column
              (N=100,000; m = choose_grid_size = 100,000 grid points, a Toeplitz K_UU; the
              grid spans the forecast week): Wᵀ· twice, bit for bit; 30 Adam steps at lr 0.1
              under bench.py's training solver settings; the mean, LOVE variances and 16 LOVE
              draws (the test-independent sample cache) of the 2,048 forecast points; the
              exact interpolated branch on 128 of them against LOVE (Rayleigh–Ritz: LOVE may
              not fall below it; the reference's relative gate is read); no CUDA kernel may
              launch.  Prints ms a step, the refresh, a request and a draw, and the peak
              device memory.
11b. kissgp 2d — the same on a 316 × 316 Kronecker grid, the flagship task's first two
              inputs at N=100,000, 10 steps and one request.
11c. wiski  — phase 11's model on a grid of 4,096 with phase 11's hyperparameters,
              conditioned 4 times on 16 new readings (``get_fantasy_model``: WISKI): the mean
              against a model rebuilt on all the points, beside a planted fault;
              wiski_fantasy_ms.
12. love gradient — on phase 7's trained flagship, one fantasy of 16 points under
              ``detach_test_caches(False)`` and ``fast_pred_var``: ∇Σσ² over the 2,048 test
              points with respect to X_f and the hyperparameters through the joint
              operator's Lanczos root (love_grad_ms, the step of qNIPV), its launches
              (backward: 5 kernel_bwd_fused at t=20, their dv, K*x R's dv, dos, dx1 and dx2);
              the kernels against their plain versions at N=100k, CUDA float32 against the
              float64 plain path at N=8,192 beside planted faults, central differences in
              float64 at N=2,000; kernel_bwd_fused at 100k², t=20 against float64.  Alone:
              ``python3 -c 'import chip_smoke; chip_smoke.phase_love_gradient()'``.
13. batch   — a batch-independent GP at full width (``make_batch_task``: two outputs of
              N=100,000 on the flagship's inputs, the second with other lengthscales): the
              flagship's model with ``batch_shape=(2,)`` on the kernel, outputscale, mean
              and likelihood, bench.py's recipe for 30 steps, then both outputs' 2,048 test
              points served (mean and LOVE variances).  Gates: the launches (2
              kernel_matvec a CG iteration, 2 kernel_bwd_fused a step, no kernel_grad_x),
              each output's RMSE and NLPD, one batched loss and gradient against two
              unbatched models with each element's parameters, probes and warm start
              (beside a planted fault); then CUDA against CPU at N=2,000 with pinned pivots,
              RBF and the batched periodic branch.  Alone:
              ``python3 -c 'import chip_smoke; chip_smoke.phase_batch()'``.
13b. multitask — ``examples/03_multitask_gp.py``'s Kronecker multitask GP with 4 tasks on
              8,192 inputs (n·t = 32,768, K_data formed once a solve, unpreconditioned
              mBCG): 30 Adam steps and 512 test points (per-task MAE against the noiseless
              function, gated at each task's noise), CUDA float32 against a CPU float64 run
              at n = 1,024; no kernel may launch.
13c. lcm-hadamard — LCMKernel([RBF, Matérn-3/2]) with 2 tasks on 4,096 inputs, and a
              Hadamard GP (RBF on column 0 times an IndexKernel on column 1,
              HadamardGaussianLikelihood) on 2 × 4,096 points, dense, its mBCG
              preconditioned: 20 steps and a request each, each against its CPU float64 run
              at a small n; no kernel may launch.

14. svgp    — BASELINE config 5: a whitened SVGP (m = 1,024 inducing points, a seeded subset of
              the training inputs; NaturalVariationalDistribution, ConstantMean,
              ScaleKernel(RBF-ARD), GaussianLikelihood) on the flagship task at N=100,000: the
              ELBO of a seeded parity state (Cholesky q(u)) and its KL term on the card in
              float32 and float64 against the JAX package's float64 values (SVGP_ELBO_JAX and
              SVGP_KL_JAX, from ``tests/svgp_elbo_reference.py``), gated; 196 steps (two epochs of minibatches of
              1,024) of NGD (lr 0.1) on q(u) and Adam (lr 0.01) on the rest; finite ELBOs, a
              fixed minibatch's ELBO raised, the RMSE of the 2,048 test points below the
              constant predictor's (NLPD read), no kernel launched; svgp_step_ms.  Alone:
              ``python3 -c 'import chip_smoke; chip_smoke.phase_svgp()'``.
14b. unwhitened — the unwhitened strategy at m = 1,024 with a Cholesky q(u), 3 Adam steps: its
              KL runs mBCG on the lazy K_ZZ + jitter and launches kernel_matvec at 1,024 × 1,024,
              t = 1,035 ([L_S | μ_Z − m | 10 probes]), its backward kernel_bwd_fused at the
              same t (gated: both launched, and the first launch of each against its plain
              version on the same operands, timed beside its bound); the stochastic KL beside
              the dense-Cholesky KL in float32 and float64 (read).
14c. deep gp — a two-layer deep GP: 10 hidden GPs (LinearMean) and an output GP (ConstantMean),
              128 inducing points each, 10 likelihood samples, DeepApproximateMLL(VariationalELBO),
              100 Adam steps on minibatches of 1,024, each drawing one joint sample of the
              10,240 hidden values per sample through a rank-100 Lanczos root; finite values,
              the objective raised, the RMSE below the constant predictor's, no kernel
              launched; deep_gp_step_ms and the peak device memory.

15. dirichlet — Dirichlet GP classification (BASELINE config 4, batch-independent GPs): the
              terciles of the flagship task's targets at N=100,000 as three classes,
              DirichletClassificationLikelihood and one GP per class (batch_shape=(3,)) on the
              transformed targets with their fixed heteroskedastic noise, 20 steps of
              bench.py's recipe, then the 2,048 test points served; dirichlet_step_ms, CG
              iterations (each class's own at the refresh), refresh_s, request_ms, held-out
              accuracy beside chance, peak memory.  Gates: the loss falls, each class's mean
              cache by its float64 true residual, accuracy above chance, the launches (3
              kernel_matvec a CG iteration, 3 kernel_bwd_fused a step, no kernel_grad_x),
              and the first t=64 product and backward against their plain versions on the
              same operands.  Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_dirichlet()'``.
15b. fantasy more — fantasies of phase 13's batch (16 points per output, a Schur update per
              element), of the flagship's parameters in a FixedNoiseGaussianLikelihood model
              (get_fantasy_model(..., noise=...)) and of phase 13b's Kronecker model (caches
              rebuilt on the joint operator), each against a model built on the joint data
              (means, variances, float64 true residuals, a planted fault).  Alone:
              ``python3 -c 'import chip_smoke; chip_smoke.phase_fantasy_more()'``.
15c. structure — AdditiveStructureKernel(ScaleKernel(RBF)) and SKIP
              (ProductStructureKernel(ScaleKernel(GridInterpolationKernel(RBF, 1,024 points))))
              at N=16,384, 10 steps each and a request: ms a step, peak memory, RMSE; no
              kernel may launch.  Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_structure()'``.

16. ciq     — a CIQ-SVGP (BASELINE config 5's model with ``CiqVariationalStrategy``): m = 4,096
              inducing points from the training rows, NaturalVariationalDistribution, jitter
              1e-4, 100 steps of NGD and Adam on minibatches of 1,024 at N=100,000.  The ELBO
              of a seeded state at m = 1,024 in float32 (kernels) and float64 (plain versions)
              against the JAX package's float64 value (``tests/ciq_elbo_reference.py``); per
              step 10 + (forward + backward multi-shift CG iterations) kernel_matvec launches on
              the lazy symmetric K_ZZ, one kernel_bwd_fused at t = 15,360 (15 shifts × 1,024
              columns) and no kernel_grad_x, gated; the path's shapes (4,096² at t = 1 and
              1,024, the backward at t = 15,360) against the plain versions and float64; the
              trained interpolation term K_ZZ^(-1/2) K_Zx of 1,024 points against float64 eigh;
              RMSE, NLPD, ciq_step_ms, peak memory.  Alone: ``chip_smoke.phase_ciq()``.
16b. classification — a whitened SVGP (m = 1,024, NGD) with a BernoulliLikelihood on the
              flagship's inputs, labels its function above the median, 100 steps: the
              quadrature ELBO in float32 against a float64 copy, test accuracy above 0.80.
16c. ovc    — online variational conditioning: the whitened strategy's pseudo-points at a
              seeded state (m = 1,024, q(u) at the collapsed optimum of 8,192 points) against
              the JAX package's float64 values; ``get_fantasy_model`` with 16 points, its mean
              and variances at 2,048 points against dense float64 (dense Cholesky factors:
              K_ZZ + D̃ is too ill-conditioned for CG), its one strip launch held against the
              plain versions; ovc_fantasy_ms.
16d. dspp   — a two-layer DSPP (3 hidden GPs, m = 512 a layer, 8 quadrature sites), 100 Adam
              steps of DeepPredictiveLogLikelihood: the loss in float32 against float64, the
              fixed minibatch's loss lowered; dspp_step_ms, RMSE.
16e. vnngp  — VNNGP over all 100,000 points (k = 16, Matérn-5/2 ARD, an IVF index, minibatch
              1,024, KL batch 256, 100 steps): the IVF recall of 1,024 queries against the
              exact search ≥ 0.95; the index's build time, vnngp_step_ms, RMSE.

17. lmc     — an LMC multitask SVGP (``make_lmc_task``: 4 tasks mixed from 3 latent functions,
              N=100,000, d=3): LMCVariationalStrategy over a whitened VariationalStrategy of batch
              shape (3,), m = 1,024 a latent, a Cholesky q(u), MultitaskGaussianLikelihood.  The
              ELBO and KL term of a seeded state at m = 256 in float32 and float64 against the JAX
              package's float64 values (``tests/lmc_elbo_reference.py``); 196 Adam steps on
              minibatches of 1,024; finite ELBOs, a fixed minibatch's ELBO raised, no kernel
              launched; lmc_step_ms, per-task RMSE and NLPD of the 2,048 test points, peak memory.
17b. grid svgp — the additive grid-interpolation strategy (a 1-D grid of 1,024 points, 3 input
              dimensions) and the 2-D one (32 × 32) on the flagship's data, 100 Adam steps each:
              their unwhitened KL's mBCG launches kernel_matvec (1,024², d = 1 with the 3 dimensions
              folded into the columns, and d = 2) and its backward kernel_bwd_fused on every
              step (gated), the first launch of each against its plain version and timed beside
              its bound; the mBCG KL beside the dense float64 KL (read); grid_svgp_step_ms, RMSE.
17c. large batch — LargeBatchVariationalStrategy against VariationalStrategy at m = 1,024 on
              minibatches of 16,384, 30 Adam steps each (step times read); at one state the ELBO
              and its gradients against the whitened strategy's in float32 and float64 (gated).
17d. decoupled — the orthogonally decoupled strategy (4,096 mean inducing points with a Delta
              q(u) over a whitened strategy with 512) and the batch-decoupled one (1,024, a kernel
              of batch shape (2,)), 100 Adam steps each: the ELBO in float32 against float64, a
              fixed minibatch's ELBO raised; the orthogonal KL's ½ mᵀK m launch at 4,096², t = 1,
              held against its plain version; step times, RMSE, launches a step.
17e. sgpr, rff — exact GPs on the flagship's data at N=100,000 with InducingPointKernel(ScaleKernel(
              RBF-ARD)) (1,024 inducing points) and RFFKernel (1,024 frequencies), 50 steps each of
              bench.py's training recipe, then 2,048 test points served: SGPR's added loss term
              against its float64 closed form, rᵀ(R Rᵀ + σ²I)⁻¹r and the served mean against a float64
              Woodbury evaluation (gated), no kernel launched; step times, CG iterations, RMSE, NLPD
              and the strategy that served.

18. spectral mixture — an exact GP with SpectralMixtureKernel(num_mixtures=4) (initialised from the
              empirical spectrum), ConstantMean and GaussianLikelihood on the periodic task's daily
              profile without its weekends, time column alone, in readings: N=16,128 (56 days; the
              streamed backward keeps every block's graph, so not 100k), 30 steps of bench.py's recipe
              with CG at 0.01 and the means at a rate of their own, K·V through
              ``_matmul_chunked`` and the preconditioner's rows through ``_get_rows``; then a refresh
              and the forecast of the next week (2,048 readings): ms a step, CG iterations, peak
              memory, refresh_s, request_ms, RMSE (gated below the constant predictor's), NLPD; the
              float64 loss and gradient at N=2,048 against the CPU (injected probes, pinned pivots);
              no kernel may launch.
18b. derivative gp — ConstantMeanGrad, ScaleKernel(RBFKernelGrad) and a MultitaskGaussianLikelihood
              of 4 tasks without task noise on make_task's function and its analytic gradient at
              2,048 inputs (8,192 observations: the CG path, the preconditioner from the lazy grad
              kernel's rows), 30 steps, then 256 test inputs served: ms a step, CG iterations, peak
              memory, the value and gradient RMSE (each gated below the constant predictor's); no
              kernel may launch.
18c. kernel tail — every new kernel and mean (RQ, cosine, linear, polynomial, piecewise polynomial,
              spectral mixture and delta, constant, the misc kernels, the grad kernels and means, the
              zero mean) on inputs made on the card, float32 and float64: the 300 × 200 matrix, its
              diagonal and a product above 512² (``_matmul_chunked``) against the CPU in float64.

19. model list — an IndependentModelList of two outcomes of make_task's inputs at N=100,000
              (``make_list_task``): a copy of phase 7's trained flagship (RBF-ARD) and an exact GP
              with ScaleKernel(Matérn-5/2 ARD), trained jointly by SumMarginalLogLikelihood for 10
              Adam steps under bench.py's recipe with no stall exit and a cap of 400 CG iterations
              (every solve cold), then both outcomes' 2,048 test points through the LikelihoodList,
              and a fantasy of 16 points an outcome: s a step, each outcome's CG iterations,
              kernel_matvec and kernel_bwd_fused launches by kernel type (gated on both types), per
              outcome RMSE, MAE, SMSE, MSLL, the 95 % coverage error, refresh_s and request_ms.
              Gates: step 0's sum against the two MLLs alone, each rhs solve's true residual, the
              Matérn outcome's loss falling, RMSE below the constant predictor's, the Matérn
              outcome's first training product (t=64, the tensor-core tier) and backward on their
              own operands against float64, and CUDA float32 against CPU float64 at N=2,000.
              Alone: ``chip_smoke.phase_model_list()``.
19b. loo    — the flagship's model trained by LeaveOneOutPseudoLikelihood on 16,384 of phase 7's
              points (8,192 where a step at 16,384 takes over 1.5 s), 20 Adam steps: ms a step, peak
              memory, LOO-RMSE, the float32 σᵢ² against float64; the float64 value and gradient at
              N=2,048 against the CPU, μᵢ and σᵢ² against conditioning on the others; no kernel.
19c. gplvm  — a Bayesian GPLVM at the shape of GPyTorch's GPLVM tutorial (1,000 points, 12
              observed and latent dimensions, 25 inducing points, minibatches of 100): 300 Adam
              steps; the latent geometry against the truth, a float64 ELBO and gradient against the
              CPU, the point and MAP latents; no kernel.
19d. priors — the LKJ, Wishart, horseshoe and smoothed-box priors' log-densities and gradients in
              float32 and float64 against the CPU, their samplers against moments, a Hadamard model
              with BoTorch's LKJ task-covariance prior (against the CPU, then 5 steps), the four new
              metrics against the CPU; no kernel.

The last three lines are the card's name and power limit, the kernel report and
{"ok": true, "device": {...}}.

``period_witness``, ``sass_witness``, ``slab_sweep`` and ``love_rank_witness`` are not part
of the run (see their docstrings).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

# Raw hyperparameters of the flagship model, fitted with the JAX package (gpytorch_tpu) on
# the CPU at a reduced N=4,000 of the same synthetic task (numpy seed 0): exact Cholesky
# marginal log likelihood, 120 Adam steps with cosine decay 0.1 → 0.01, noise constraint
# GreaterThan(2e-2), starting at noise 0.1 and lengthscale 0.5 as bench.py does.
# Keys and shapes are those of gpytorch_tpu's model.trainable_params().  To regenerate
# them: python scripts/_fit_chip_smoke_params.py (prints this dict).
JAX_PARAMS = {  # lengthscale [0.3266, 0.6635, 0.3955], outputscale 1.891, noise 0.03259
    "covar_module.base_kernel.raw_lengthscale": [[-0.9512472568345939, -0.06019485260749456, -0.7234818870498149]],
    "covar_module.raw_outputscale": 1.727311992402188,
    "likelihood.noise_covar.raw_noise": [-4.368459104888554],
    "mean_module.raw_constant": -0.23213198537173907,
}

N_TRAIN, N_TEST, D = 100_000, 2048, 3
REQUEST_ROWS, N_REQUESTS = 256, 8
RMSE_LIMIT = 0.21           # noise floor of the task is ≈ 0.18 (JAX package on this task: 0.1792)
KERNEL_REL_TOL = 1e-5       # float32: max |kernel − plain| / max K|v| (K ≥ 0, so K|v| is the
                            # sum of absolute terms that bounds float32 summation error)
BWD_REL_TOL = 1e-5          # float32 backward kernel against the plain version in float64, each
                            # output relative to its sum of absolute terms (dx: 2Σ|k′|(|g_i·v_j| +
                            # |v_i·g_j|)|x_i − x_j|; dv: K|g|; dos: Σ|k||g_i·v_j|)
BWD_TERMS_N = 8192          # _bwd_at_path_shape: the dense sums of the backward's terms up to this many rows
BWD_TRAIN_TOL = 1e-4        # float32 backward kernel at the training shape (N=100k, t=64) against
                            # the plain version in float64: max |Δdx| / max |dx| and |Δdos| / |dos|
                            # (the n² sums of absolute terms are not formed at this size)
TRAIN_STEPS, TRAIN_TIMED = 120, 8   # bench.py: 1 warm-up step, 8 synchronised steps, the rest
PROBE_SEED = 2                      # bench.py:344
SLICE_TRAIN_N, SLICE_TRAIN_STEPS = 2000, 3
SLICE_LOSS_TOL = 1e-3       # N=2000 CPU vs CUDA, float32: |Δloss| / max(|loss|, 1) at step 1 (the
                            # loss is −MLL per datum, a difference of O(1) terms)
SLICE_GRAD_TOL = 1e-3       # … max |Δgrad| over all parameters / max |grad| over all parameters at
                            # step 1 (one scale for the whole gradient: the constant mean's own,
                            # −Σα/N, cancels to ≈ 3e-3 of the others and would amplify round-off)
SLICE_PARAM_TOL = 1e-3      # … max |Δraw| after 3 steps (Adam moves each raw by ≈ lr = 0.1 a step)
FLAGSHIP_CG_LIMIT = 800     # phase 7: CG iterations over the 120 steps.  With the t=64 product on the
                            # CUDA cores' FP32 FMA the trajectory read 769 on an H100, bit for bit
                            # over reruns; the tensor-core tier sums in another order (756), so the
                            # trajectory moves, but not by more
FLAGSHIP_RMSE = 0.1840      # … and the trained model's RMSE, which both trajectories read
FLAGSHIP_RMSE_TOL = 3e-3    # … within this of it (the RMSE over seeds of the JAX package spans 6e-4)
TRAIN_LOSS_DROP = 0.1       # N=100k: mean loss of the last 10 steps at least this far below step 0's
TRAIN_NLPD_DROP = 0.1       # N=100k: marginal NLPD of the trained model at least this far below that
                            # of the initial parameters
H100_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores, at 700 W
H100_TF32_FLOPS = 495e12    # H100 SXM, TF32 on the tensor cores, dense, at 700 W
H100_FP64_TC_FLOPS = 67e12  # H100 SXM, FP64 on the tensor cores, at 700 W (NVIDIA's data sheet)
H100_FP64_FLOPS = 34e12     # H100 SXM, FP64 outside the tensor cores, at 700 W (NVIDIA's data sheet)
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
H100_EXPS_PER_S = 132 * 16 * 1.98e9  # H100 SXM: 132 SMs × 16 exp2 a clock on the special-function
                            # units (sm_90) × 1.98 GHz, the largest SM clock (nvidia-smi clocks.max.sm)
SLICE_CG_TOL = 1e-4         # N=2000 slice: tighter than eval's 1e-3, so that where the two
                            # float32 runs stop CG does not dominate their difference
SLICE_MEAN_TOL = 1e-3       # N=2000 CPU vs CUDA: max |Δmean| / max |mean|
SLICE_VAR_TOL = 1e-3        # N=2000 CPU vs CUDA: max |Δvar| / max var
NOISE_FLOOR = 2e-2          # bench.py's noise constraint
TRUE_RES_LIMIT = 2e-3       # N=100k mean cache: true residual within twice eval's CG tolerance 1e-3
# the periodic model (phases 3c, 6b, 8): 5-minute readings of 347 days, x = [t, t] in days
P_N_TRAIN, P_N_TEST, P_D = 100_000, 2048, 2
P_PERIODS = (1.0, 7.0)      # initial periods: the daily and the weekly cycle
P_PERIOD_LR = 1e-6          # Adam learning rate of raw_period_length.  An Adam step moves a raw value
                            # by up to ≈ lr, the daily period by 0.63·lr (softplus′ at p = 1), and the
                            # phase at t = 347 d by 347 · 0.63·lr: 2e-4 cycles a step.  Over a run the
                            # steps add up as a random walk: at lr 1e-4 the period ended 2.24e-4 off,
                            # 0.078 cycles (1.9 h) at the far end, and the forecast failed (PERF.md)
P_TRAIN_STEPS = 120
P_CG_LIMIT = 1260           # phase 8: CG iterations over the 120 steps.  With the t=64 product on the
                            # CUDA cores' FP32 FMA the trajectory read 1,205 on an H100, bit for bit
                            # over reruns; a tier that sums in another order moves it, but not by more
P_RMSE = 0.1006             # … and the forecast RMSE that trajectory read
P_RMSE_TOL = 3e-3           # … within this of it (as FLAGSHIP_RMSE_TOL)
P_RMSE_LIMIT = 0.12         # the task's noise std is 0.1·std(f)/std(y) ≈ 0.0995 in standardised units,
                            # the least RMSE a forecast can reach; 0.12 leaves a posterior-mean error
                            # of up to 0.067 (7 % of the signal's std)
P_KERNEL_REL_TOL = 1e-5     # periodic kernels against their float32 plain versions on the card, each
                            # output relative to its sum of absolute terms (forward: K|v|; dv: K|g|;
                            # dx: 4π w Σ K(|g_i·v_j| + |v_i·g_j|)|S C|; dw: 2 Σ K|g_i·v_j| S²)
P_PATH_TOL = 1e-4           # periodic kernels at the path's shapes (N=100k, a up to 355) against the
                            # plain version in float64: max |Δ| / max |·| of each output
P_GRAD_SEEDS = 8            # probe seeds behind phase 8's reading of the period gradient's noise
P_GRAD_ROUNDOFF_TOL = 1.0   # … the float32 path's raw period gradient within this many standard
                            # deviations over probe seeds of the float64 plain path's: round-off must
                            # not be what moves the periods (P_PERIOD_LR rests on probe noise)
# the wide-d tier of the kernels (d > 64; phases 3, 3b, 3c, 3d and 6c)
WIDE_D = 100                # inputs of the wide-d cases
WIDE_N = 16_384             # rows of the wide tiers' timed shapes (n × n, and 2048 × n for grad_x)
WIDE_TRAIN_N = 4096         # phase 6c: an RBF-ARD model on WIDE_D inputs, trained and served
WIDE_TEST_N = 512           # … and the points of its one request
# the prediction gradient (phases 3d, 4c, 9)
GX_REL_TOL = 1e-5           # grad_x kernel against its float32 plain version, relative to the sum of
                            # absolute terms 2 Σ_j |k′||g_i·v_j||x1_i − x2_j|, which bounds float32 summation
GX_PATH_TOL = 1e-4          # grad_x kernel at the path's shapes (2048 × 100k both ways) against the plain
                            # version in float64: max |Δ| / max |·|
GX_TIER_T = (1, 20, 33, 64, 100, 128, 129)  # grad_x's ragged checks: the tensor-core tier's edges (33-128)
GX_SLICE_TOL = 3e-3         # N=2000 CPU vs CUDA: max |Δ∇| / max |∇| of the UCB gradient, for the candidates
                            # and (parameters live) for the parameters, each over its own largest.  A float32
                            # run is up to ~1e-3 off float64 (CPU float32 read 2.6e-4 frozen, 9.8e-4 live): the
                            # LOVE variance σ² = K** − |K*x R|² is ≈ 5e-4 at its smallest against an outputscale
                            # of 1.9, so its gradient keeps ~1e-3 of float32 rounding, and two float32 runs can
                            # differ by the sum of theirs
UCB_BETA = 2.0              # UCB(x) = μ(x) + 2σ(x) of the latent posterior, the acquisition of phases 4c, 9
ACQ_F64_TOL = 1e-3          # N=100k: the float32 kernel path's ∇ΣUCB against the float64 plain path from the
                            # same caches, max |Δ| / max |∇|
ACQ_FD_H = 1e-4             # central differences of one candidate's UCB, float64 plain path
ACQ_FD_TOL = 1e-6           # … against the float64 autograd gradient, max |Δ| / max |∇| over 6 coordinates
ACQ_STEPS, ACQ_LR = 20, 0.02  # Adam ascent of ΣUCB over the candidates, clamped to the unit cube
PC_NOISE_BUDGET = 1e-3      # bench.py's preconditioner noise budget: τ = λ_max(LLᵀ)·eps/budget
# bench.py's honest recipe (BENCH_HONEST=1, bench.py:90-100, 256-266; phase 7b): a noise floor
# of 1e-4 plus a LogNormal(−4, 1) noise prior, and CG at tolerance 0.05 with a stall window of 50
HONEST_NOISE_FLOOR = 1e-4
HONEST_CG_TOL, HONEST_STALL = 0.05, 50
HONEST_CG_LIMIT = 1070      # phase 7b: CG iterations over the 120 steps.  The trajectory read 1,010 on an
                            # H100, bit for bit over reruns (PERF.md, PR 13); the limit leaves 6 %, as
                            # FLAGSHIP_CG_LIMIT does over phase 7's 752
HONEST_RMSE = 0.1839        # … and the trained model's RMSE, which that trajectory read
HONEST_RMSE_TOL = 3e-3      # … within this of it (as FLAGSHIP_RMSE_TOL)
# LOVE sampling (phases 4 and 9b): draws of all test points under fast_pred_samples
SAMPLES, SAMPLE_SEED, SAMPLE_REPS = 16, 11, 10
SAMPLE_DIAG_TOL = 2e-2      # phase 9b: diag(R_s R_sᵀ) of the kernel path against the float64 plain path
                            # from the same caches, max |Δ| / max diag.  The float32 plain path read
                            # 6.802e-03 there (the kernel path 6.999e-03; PERF.md, PR 13): K** − CCᵀ
                            # cancels to 2.4e-5 at the smallest against an outputscale of 0.71
SLICE_SAMPLE_TOL = 1e-2     # phase 4: R_s R_sᵀ, CPU against CUDA, max |Δ| / max |R_s R_sᵀ|
REFINE_PASSES = (1, 2)      # phase 5b: the mean cache rebuilt under these solve_iterative_refinements
# BASELINE.json config 1 (phase 1k): a 1D toy on the dense-Cholesky path
TOY_N, TOY_TEST, TOY_STEPS, TOY_LR = 1000, 200, 50, 0.1
TOY_LOSS_TOL = 1e-3         # CPU against CUDA, float32: max over the steps of |Δloss| / max(|loss|, 1)
TOY_MEAN_TOL = 1e-3         # … max |Δ| / max |·| of the served mean (CPU float32 against float64: 1.5e-4)
TOY_VAR_TOL = 2e-2          # … and of the exact variances, K** − K*x K̂⁻¹ Kx* ≈ 5e-5-3e-4 against an
                            # outputscale of ≈ 1, which cancels in float32 (CPU float32 against float64:
                            # 4.5e-3), so two float32 runs may differ by twice that
TOY_RMSE_TOL = 1e-3         # … and |RMSE(float32, CUDA) − RMSE(float64, CPU)|
# fantasy updates and the one-shot knowledge-gradient path (phase 10) on phase 7's model
FANT_Q, FANT_SEED, FANT_REPS = 16, 17, 3   # fantasy points (every 128th test point), the LOVE draw's seed
FANT_MEAN_TOL = 1e-2        # N=100k: the fantasy model's 2,048-point mean against a refit's (a new CG solve
                            # of the joint system), max |Δ| / max |μ|.  Both caches solve to eval's tolerance
                            # 1e-3; the float64 bracket (true residuals, means from the same caches by the
                            # float64 plain path) and a planted fault (the update without its −(A⁻¹B)v
                            # term) are printed beside it
KG_FD_TOL, KG_FD_H = 1e-10, 5e-2  # N=KG_SLICE_N, float64 plain path on the card: the directional derivative of Σμ*
                            # along its gradient (X_f and the raw hyperparameters) against central differences,
                            # both at eval tolerance KG_FD_TOL, the step KG_FD_H along the unit vector
KG_FD_GATE = 1e-2           # … |Δ| / |derivative| (at N=3000 on the CPU: 4e-3, the step's truncation)
KG_WITNESS_TOL = 1e-9       # kg_float64_witness: the float64 plain path's eval tolerance
KG_SLICE_N = 4096           # the gradient at N=4096 on the card (the kernels launch above 512²) against a
KG_SLICE_TOL = (0.1, 0.3)   # CPU float64 plain run with pinned pivots, max |Δ∇| / max |∇| of X_f and of the
                            # hyperparameters.  Both gradients are differences of terms far larger than they
                            # are, so float32 round-off moves them far: on an H100 CUDA read 4.2e-2 and 0.147,
                            # CPU float32 1.9e-2 and 0.134 (PERF.md).  A relative error of KG_FAULT_EPS
                            # in a kernel's cotangents reads 0.253 (grad_x, on ∇X_f) and 0.837 (the symmetric
                            # backward, on ∇θ)
KG_FAULT_EPS = 1e-4         # the planted faults: grad_x's output, and the symmetric backward's dx and dos,
                            # each × (1 − KG_FAULT_EPS), in a float64 run
KG_TOL = 1e-6               # the knowledge-gradient step's eval tolerance (timed at N=100k, gated at
                            # N=KG_SLICE_N): the Schur complement S = D − BᵀA⁻¹B cancels (≈ 0.05 against an
                            # outputscale of 1.9), so the gradient through it needs tight solves.  Against the
                            # float64 plain path (kg_float64_witness on a CPU, PERF.md) the float32 ∇X_f
                            # at eval's 1e-3 has cosine −0.27 (N=3000) and −0.52 (N=8192), at 1e-6 0.9999 and
                            # 0.9994
NAN_FRACTION, NAN_SEED = 0.01, 19  # phase 10b: the share of targets set to NaN
NAN_KERNEL_TOL = 1e-3       # N=4096: the CUDA kernels against their plain versions on the card, both float32
                            # with the same pinned pivots: loss (|Δ| / max(|loss|, 1)) and gradients (max |Δ| /
                            # max |∇|).  On an H100 "fill" read 3.4e-5 in gradients, "mask" 4.2e-6, and the
                            # fault below 3.1e-3 and 1.0e-2 (PERF.md)
NAN_FAULT_EPS = 1e-2        # … bracketed by the symmetric backward kernel's dx and dos × (1 − NAN_FAULT_EPS)
NAN_SLICE_TOL = 5e-3        # … and CUDA float32 against CPU float64 (phase 5's parameters, the training
                            # recipe's CG at tolerance 0.3).  Under "fill" the plain versions on the card read
                            # 2.237e-3 in gradients there, as the kernels do (2.243e-3; CPU float32 2.873e-4):
                            # the card's float32 arithmetic outside the kernels sets that floor; the float64
                            # fault (the backward × 15/16) reads 1.982e-2 (PERF.md)
NAN_SUBSET_N = 1000         # float64 CPU: "mask" × N against the observed subset's MLL × N_obs at N=1000
NAN_SUBSET_TOL = 1e-6       # (above max_cholesky_size: mBCG), relative, at CG tolerance 1e-10 and 100 Lanczos
                            # steps, unpreconditioned (as tests/test_torch_nan_policies.py; 40 steps read 3.6e-4
                            # at N=600, 100 steps 6.5e-8)
# the budget under which a float64 run's τ is the float32 run's, so that a float32 and a
# float64 run precondition alike and draw the same probes z ~ N(0, P)
PC_NOISE_BUDGET_F64 = PC_NOISE_BUDGET * float(np.finfo(np.float64).eps / np.finfo(np.float32).eps)
# KISS-GP (phases 11, 11b, 11c; no CUDA kernel: interpolation, FFT Toeplitz and Kronecker
# products are plain PyTorch) and LOVE differentiated through its Lanczos roots (phase 12)
KISS_STEPS, KISS2_STEPS = 30, 10   # Adam steps at lr 0.1 (examples/02_scalable_kissgp_love.py)
KISS_LENGTHSCALE = (0.05, 0.5)     # initial RBF lengthscales: 1D in days (72 minutes), 2D on the unit square
KISS_EXACT_ROWS = 128       # test points of the exact interpolated branch (every 16th): it solves one CG
                            # column a test point against W K_UU Wᵀ + σ²I at N=100k
KISS_EXACT_CG_TOL, KISS_EXACT_MAX_ITER = 1e-9, 1000  # … solved in float64 on the card (the float32 branch
                            # cannot resolve σ² ≈ 1e-4 against k** ≈ 1: at tolerance 1e-5 it read 4 % of the
                            # largest σ² above LOVE's in 2D on an H100, the cancellation's round-off)
KISS_MEAN_TOL = 1e-2        # the float32 path against its float64 twin on the card (the same raw parameters
                            # and grid, both caches at eval's CG tolerance 1e-3): mean, max |Δ| / max |μ|
KISS_VAR_TOL = 1e-4         # … and LOVE variances, max |Δσ²| / max k** (σ² = k** − |W* K_UU Wᵀ R|² cancels),
                            # both beside a planted fault: the test side's interpolation W*· × 15/16
KISS_LOVE_TOL = 1e-6        # Rayleigh–Ritz: R Rᵀ ≼ K̂⁻¹ on the Krylov space, so σ²_LOVE ≥ σ²_exact; gated in
                            # float64 as max (σ²_exact − σ²_LOVE) / max k** ≤ KISS_LOVE_TOL
KISS_LOVE_REL = 0.05        # … and LOVE against the exact branch, |Δσ²| / σ², the reference's own limit
                            # (test_kissgp_gp_regression.py:133, BASELINE.md:18): gated on the median, the max
                            # read.  A rank-100 root from a random start resolves the variances only where the
                            # kernel's effective rank is below its own: in 1D at N=100k the forecast's first
                            # points read up to 90 times over (``love_rank_witness``; ROADMAP queue 3)
KISS_SAMPLES = 16           # LOVE draws of the 2,048 forecast points from the test-independent sample cache
WISKI_GRID, WISKI_UPDATES = 4096, 4  # phase 11c: a 1D grid of 4,096 (WISKI's caches are dense m × m) and
                            # four get_fantasy_model calls of FANT_Q new readings each
WISKI_MEAN_TOL = 1e-2       # the WISKI mean against a KISS-GP model rebuilt on all the points (its mean
                            # cache a CG solve at eval's tolerance 1e-3), max |Δ| / max |μ|, as phase 10
LG_REPS = 3                 # phase 12: love_grad_ms, the median of LG_REPS evaluations
LG_SLICE_N = 8192           # CUDA float32 against the float64 plain path on the card, at N=8192
LG_SLICE_TOL = (3e-2, 3e-2) # … max |Δ∇| / max |∇| of X_f and of the hyperparameters (on an H100 CUDA float32
                            # read 3.6e-3 and 3.4e-4, the float32 plain path 2.7e-3 and 4.2e-4; PERF.md),
LG_FAULT_EPS = 1e-2         # … bracketed by planted faults: grad_x's output and the symmetric backward's dx and
                            # dos × (1 − LG_FAULT_EPS), in float64 plain runs (0.115 on ∇X_f and 11.2 on ∇θ)
LG_FULL_TOL = 0.08          # N=100k: the kernels against their plain versions on the card, both float32, max
                            # |Δ∇| / max |∇| of X_f and of the hyperparameters.  The two paths sum K·V in other
                            # orders, and the Lanczos run and its eigh backward amplify that: on an H100, phase
                            # 5's model, they read 1.6e-2 and 2.1e-3 apart, and 2.4e-3 and 9.2e-4 (kernels) and
                            # 1.6e-2 and 3.0e-3 (plain) from the float64 plain path (PERF.md); phase 7's trained
                            # model 1.9e-3 and 2.9e-4 apart
LG_FULL_FAULT_EPS = 0.1     # … bracketed by the same planted faults in the kernel path, × (1 − LG_FULL_FAULT_EPS)
                            # (× 0.95 read 0.193 on ∇X_f through grad_x and 69 on ∇θ through the backward; × 0.9
                            # on the model that phase 7 trains with the float64 Cholesky factors 0.124 and 104)
LG_DOS_TOL = 1e-10          # kernel_bwd_fused at N=100k, t=20 against float64: |Δdos| / Σ|k_ij g_i·v_j|.  dos
                            # cancels to ≈ 4e-6 of that sum, so the limit sits between float32's readings there
                            # (≈ 5e-13 to 1e-12 on an H100, kernel and plain version alike) and a planted fault
                            # of dos × (1 − LG_FAULT_EPS), which reads ≈ 4e-8.  Phase 10 gates its t=1 and t=16
                            # backwards, and phase 16 the CIQ backward (4,096 rows, t=15,360), by the same bound
LG_FD_N, LG_FD_H = 2000, 1e-4  # central differences of Σσ² along its gradient, float64 plain path on the card
LG_FD_TOL = 1e-4            # … |Δ| / |derivative|
# the batch-independent GP (phase 13) and the multitask GPs (phases 13b, 13c)
B_STEPS = 30                # phase 13: Adam steps (cosine 0.1 → 0.01 over them) of the two-output batch at N=100k
B_FIXED_ITERS = 6           # … the per-element check's CG, run for exactly this many iterations (the SLQ minimum)
B_ELEMENT_TOL = 1e-2        # … each element's MLL (|Δ| / max(|MLL|, 1)) and gradient (max |Δ| / max |∇|) batched
                            # against unbatched.  The products launch per element on the same operands, and so do
                            # the preconditioner's Gram matrices (one batched GEMM over the 100k rows read 4e-5 of
                            # |B| from the unbatched product on an H100, which sent an element's MLL 7.4e-3 away
                            # at tolerance 0), but CG's column reductions and the preconditioner's eigensolvers and
                            # factors run batched, which sums in another order, and CG amplifies float32 round-off
                            # on the trained K̂: a CPU float32 rehearsal (N=3,000, trained, 8 iterations) read
                            # 1.6e-4 and 1.5e-3, and an H100 at N=100k 5.5e-3 and 2.4e-3 before the Grams were
                            # formed per element, 1.4e-4 and 2.7e-5 after (the gradients; PERF.md).  A planted
                            # fault (element 1 given element 0's lengthscales) must read above the gate: 0.515-0.721
B_SLICE_N = 2000            # phase 13's CUDA-against-CPU slice, gated as phase 6
MT_N, MT_TASKS, MT_TEST, MT_STEPS = 8192, 4, 512, 30  # phase 13b: inputs, tasks, test points, Adam steps
MT_SLICE_N = 1024           # phases 13b and 13c: CUDA float32 against a CPU float64 run at this n (13c at n/2, n/4)
MT_SLICE_TOL = (1e-3, 1e-2, 1e-3)  # … loss (|Δ| / max(|loss|, 1)), gradient (max |Δ| / max |∇|), served mean
                            # (max |Δ| / max |μ|)
LCM_N, HAD_N, MT_SMALL_STEPS = 4096, 4096, 20  # phase 13c: LCM inputs, Hadamard points per task, Adam steps
# the sparse variational GPs (phases 14, 14b) and the two-layer deep GP (phase 14c), on make_task's data
SVGP_M, SVGP_BATCH, SVGP_STEPS = 1024, 1024, 196  # inducing points, minibatch, steps (two epochs of N_TRAIN)
SVGP_NGD_LR, SVGP_ADAM_LR, SVGP_SEED = 0.1, 0.01, 14  # NGD on q(u)'s natural parameters, Adam on the rest
SVGP_JITTER = 1e-4          # the parity gate's K_ZZ jitter in every dtype (by default 1e-4 in float32, 1e-6 in
                            # float64: two dtypes would fit two models)
# the JAX package's float64 ELBO at svgp_parity_state and its KL term, KL(q ‖ p) / N_TRAIN:
# python tests/svgp_elbo_reference.py
SVGP_ELBO_JAX, SVGP_KL_JAX = -29.657439592867885, 0.021697786488198416
SVGP_ELBO_TOL = (2e-4, 1e-10)  # |ELBO − SVGP_ELBO_JAX| / |SVGP_ELBO_JAX| in float32 and float64: the port read
                            # 3.42e-05 and 5.02e-14 on an H100, 4.2e-05 and 1.0e-13 on the CPU (float32 round-off,
                            # amplified by K_ZZ + 1e-4·I, condition ≈ 2e7 at m = 1,024).  The KL term is 7.3e-4 of
                            # |ELBO|, so a float32 path that dropped it would read 7.3e-4 and fail
SVGP_KL_TOL = (1e-5, 1e-10)  # … and |KL − SVGP_KL_JAX| / SVGP_KL_JAX in float32 and float64 (closed forms of q(u)'s
                            # factor; the CPU read 5.0e-08 and 3.2e-16), so that a mis-scaled KL fails in float32
UW_STEPS = 3                # phase 14b: Adam steps of the unwhitened strategy at m = SVGP_M
DIR_CLASSES, DIR_STEPS = 3, 20  # phase 15: classes (the terciles of make_task's targets), Adam steps
FN_NOISE_FACTOR, FN_SEED = (0.5, 2.0), 19  # phase 15b: the fixed noise, the trained noise times a seeded factor
                            # uniform in this range per point, and that draw's seed
STRUCT_N, STRUCT_STEPS, SKIP_GRID = 16_384, 10, 1024  # phase 15c: training points (the kernels densify d × n × n),
                            # Adam steps of each model, SKIP's grid points
FANT_CG_TOL = 1e-4          # phase 15b: CG tolerance of the gated conditioning.  On observed targets (not draws
                            # of the posterior, as phase 10's) r₂ − Bᵀu is large and the Schur update amplifies
                            # the solves' error: the joint system's true residual read up to 17 times the
                            # tolerance on an H100 (phase 15b prints it at eval's 1e-3 beside this one)
DGP_H, DGP_M, DGP_S = 10, 128, 10  # phase 14c: hidden outputs, inducing points per layer, likelihood samples
DGP_STEPS, DGP_LR, DGP_SEED = 100, 0.03, 15  # … Adam steps on minibatches of SVGP_BATCH, its rate (GPyTorch's example: 0.01
                            # over many epochs; 40 steps on the CPU at 0.03 took the RMSE from 1.02 to 0.79), the seed

# CIQ-SVGP (phase 16), SVGP classification (16b), online variational conditioning (16c), DSPP (16d)
# and VNNGP (16e), on make_task's data
CIQ_M, CIQ_BATCH, CIQ_STEPS, CIQ_SEED = 4096, 1024, 100, 16  # inducing points, minibatch, steps, seed
CIQ_PARITY_M, CIQ_PARITY_BATCH = 1024, 256  # the parity state's inducing points and minibatch
# the JAX package's float64 ELBO of the CIQ-SVGP at svgp_parity_state(m=CIQ_PARITY_M,
# batch_size=CIQ_PARITY_BATCH, seed=CIQ_SEED), jitter SVGP_JITTER: python tests/ciq_elbo_reference.py
CIQ_ELBO_JAX = -57.732998331771654
CIQ_ELBO_TOL = (2e-4, 1e-6)  # |ELBO − CIQ_ELBO_JAX| / |CIQ_ELBO_JAX| in float32 and float64: the CPU read 1.3e-05
                            # and 1.7e-07 (both packages stop at the cap of 100 iterations, where CG has long lost
                            # the orthogonality of its Krylov basis and amplifies rounding differences)
CLS_STEPS, CLS_ACCURACY = 100, 0.80  # phase 16b: NGD + Adam steps of the probit SVGP, the test accuracy gate
CLS_ELBO_TOL = 1e-4         # … its trained ELBO on one minibatch, float32 against a float64 copy, relative
OVC_Q, OVC_FIT_N = 16, 8192  # phase 16c: new points of the fantasy; training points of ovc_state's q(u)
OVC_PSEUDO_TOL = 1e-9       # … (Σ ỹ, tr D̃, ‖D̃‖_F) in float64 against OVC_PSEUDO_JAX, relative
OVC_MEAN_TOL, OVC_VAR_TOL = 1e-3, 1e-3  # … the fantasy's mean and variances against dense float64, max |Δ| / max |·|
                            # (float32 on the CPU: 1.6e-4 and 6.0e-5)
# (Σ ỹ, tr D̃, ‖D̃‖_F) of the whitened strategy's pseudo-points at ovc_state, the JAX package
# in float64: python tests/ciq_elbo_reference.py
OVC_PSEUDO_JAX = (198.88336943274766, 1.0016231818534662, 0.07841994570055712)
DSPP_H, DSPP_M, DSPP_Q = 3, 512, 8  # phase 16d: hidden GPs, inducing points a layer, quadrature sites
DSPP_STEPS, DSPP_LR, DSPP_SEED = 100, 0.01, 17  # … Adam steps on minibatches of SVGP_BATCH, its rate, the seed
DSPP_LOSS_TOL = 1e-4        # … the initial loss on one minibatch, float32 against a float64 copy, relative
VNN_K, VNN_KL_BATCH, VNN_STEPS, VNN_LR = 16, 256, 100, 0.1  # phase 16e (examples/12_vnngp_large_scale.py's
VNN_SEED, VNN_RECALL = 18, 0.95  # configuration at N=100k, d=3), the seed, the IVF index's recall gate

# an LMC multitask SVGP (phase 17), grid-interpolation SVGPs (17b), the large-batch strategy (17c), the
# decoupled strategies (17d) and SGPR and RFF exact GPs (17e), at N=100k
LMC_TASKS, LMC_LATENTS, LMC_M, LMC_STEPS, LMC_LR, LMC_SEED = 4, 3, 1024, 196, 0.01, 20  # tasks, latent GPs,
                            # inducing points a latent, Adam steps (two epochs of minibatches), its rate, the seed
LMC_PARITY_M, LMC_PARITY_BATCH = 256, 512  # the parity state's inducing points a latent and minibatch
# the JAX package's float64 ELBO at lmc_parity_state and its KL term, KL / N_TRAIN:
# python tests/lmc_elbo_reference.py
LMC_ELBO_JAX, LMC_KL_JAX = -62.20488984715707, 0.012575767516202993
LMC_ELBO_TOL = (1e-4, 1e-10)  # |ELBO − LMC_ELBO_JAX| / |LMC_ELBO_JAX| in float32 and float64: the CPU read 4.7e-07
                            # and 9.8e-15; the KL term is 2.0e-4 of |ELBO|, so a float32 path that dropped it fails
LMC_KL_TOL = (1e-5, 1e-10)  # … and |KL − LMC_KL_JAX| / LMC_KL_JAX (the CPU read 1.1e-07 and 1.4e-16)
GRID_M, GRID_2D, GRID_STEPS, GRID_SEED = 1024, 32, 100, 21  # phase 17b: the additive 1-D grid, the 2-D grid's side,
                            # Adam steps of each model, the seed
LB_M, LB_BATCH, LB_STEPS, LB_SEED = 1024, 16_384, 30, 22  # phase 17c: inducing points, minibatch, Adam steps, seed
LB_TOL = ((1e-4, 5e-3), (1e-9, 1e-7))  # … its ELBO and gradients at one state against the whitened strategy's
                            # (|ΔELBO| / |ELBO|, max |Δ∇| / max |∇|), float32 and float64.  A CPU run at m = 1,024,
                            # minibatch 4,096, 30 steps read each float32 strategy against float64 at ≤ 1.3e-06 and
                            # ≤ 3.3e-04, the two float64 ones 1.9e-10 and 5.6e-09 apart; an H100 read the two
                            # strategies 8.3e-06 and 1.6e-03 apart in float32, 1.3e-11 and 4.0e-09 in float64.  With
                            # the grouped L⁻ᵀ(S − I)L⁻¹ in float32 (the JAX package's dtype) it read 1.4e-03 and 1.14
DEC_MEAN_M, DEC_COVAR_M, DEC_BATCH_M, DEC_STEPS, DEC_SEED = 4096, 512, 1024, 100, 23  # phase 17d: the orthogonal
                            # strategy's mean and covariance inducing points, the batch one's, Adam steps, the seed
DEC_MEAN_LR = 1e-3          # … Adam's rate for the orthogonal strategy's Delta q(u) values
DEC_ELBO_TOL = 1e-4         # … the initial ELBO of a fixed minibatch, float32 against float64, relative (an H100
                            # read 3.0e-08 orthogonal, 3.2e-08 batch; the CPU 4.5e-08, 8.0e-09)
SPARSE_M, RFF_SAMPLES, SPARSE_STEPS, SPARSE_LR, SPARSE_SEED = 1024, 1024, 50, 0.05, 24  # phase 17e: SGPR's inducing
                            # points, RFF's frequencies, Adam steps (inducing points at SVGP_ADAM_LR), rate, seed
SPARSE_CG_TOL = 1e-4        # … the CG tolerance of the gated rᵀ(R Rᵀ + σ²I)⁻¹r
SGPR_TERM_TOL = 1e-12       # … SGPR's loss term in float64 against ``_sgpr_term64``, |Δ| over ½ Σ (k_ii + q_ii) / σ²,
                            # the sum of its terms' magnitudes (the CPU at N=20,000 read 1.0e-17; a planted term = 0
                            # 5.0e-06).  The float32 term is printed, not gated: k_ii − q_ii cancels (an H100 read
                            # 10.50 against −16.86 at N=100,000, the CPU 2.1e-07 of the terms at N=20,000), in the
                            # JAX package's float32 as well, and a term of 0 lies inside that error
SPARSE_IQ_TOL = 1e-4        # … rᵀ(R Rᵀ + σ²I)⁻¹r against float64 Woodbury, relative (an H100 read 1.1e-05 SGPR and
                            # 5.2e-09 RFF, the CPU at N=20,000 5.5e-06 and 1.0e-07)
SPARSE_MEAN_TOL = 1e-2      # … the served mean (eval CG at 1e-3), max |Δ| / max |μ| (an H100 read 1.6e-03 and 7.0e-05)

# The kernel long tail: a spectral-mixture forecast (phase 18), a derivative GP (18b) and every
# new kernel and mean (18c); no TPU kernel is on these paths
SM_Q, SM_N, SM_TEST, SM_STEPS = 4, 16_128, 2048, 30  # phase 18: mixtures, training readings (56 days: whole days, so
                            # that the daily harmonics fall on the periodogram's bins, which the empirical-spectrum
                            # initialiser draws from; at 16,384 it drew 2.021 cycles a day for 2, and the CPU's analogue
                            # at 4,096 against 4,032 read 0.979 against 0.560; the chunked backward keeps each block's
                            # graph, ≈ Q·N²·4 bytes a few times over, so not 100k), the forecast's readings (a week),
                            # Adam steps
SM_MEAN_LR = 1e-5           # … Adam's rate for raw_mixture_means (the rest at 0.1 → 0.01), as phase 8's period: a mean
                            # μ ≈ 0.007 a reading sits where softplus is ≈ exp, so a step moves it by ≈ lr·μ and the
                            # phase at the far end of 16,128 readings by 113·lr cycles.  At 0.1 on the CPU (N=8,192,
                            # 30 steps) the means left the spectrum's lines (2.00, 2.99 → 2.76, 3.11 cycles a day)
                            # and the forecast rmse read 2.23 against the constant predictor's 1.04
SM_SETTINGS = {"cg_tolerance": 0.01, "fast_precond_grad": False}  # … bench.py's recipe with these replaced.  CG
                            # at 0.01 (0.3 elsewhere): on the CPU at N=4,032, 30 steps, 6 CG iterations a step either
                            # way, at 0.3 the scales widened to 0.13 cycles a day and the forecast rmse read 1.085
                            # against the constant's 1.001; at 0.01 they narrowed to 0.017-0.021, as the exact dense
                            # gradient narrows them, and it read 0.564.  The preconditioner's gradient through its
                            # pivoted-Cholesky loop, not the Nyström factor's Cholesky of K[piv, piv]: the float32
                            # kernel's phase 2π·τ·μ carries ≈ 6e-5 rad of round-off at 168 cycles, and on an H100 that
                            # factor failed at every jitter psd_safe_cholesky tries (leading minor 46)
SM_PARITY_N, SM_PARITY_TOL = 2048, 1e-8  # … its float64 loss and gradient at this N, CUDA against the CPU, relative
DER_N, DER_TEST, DER_STEPS = 2048, 256, 30  # phase 18b: inputs (× (D + 1) observations), test inputs, Adam steps
TAIL_N, TAIL_M, TAIL_PRODUCT_N, TAIL_COLS = 300, 200, 600, 4  # phase 18c: the matrix's inputs, the streamed
                            # product's (600² > 512²) and its columns
TAIL_VOCAB, TAIL_LENGTH, TAIL_SEED = 4, 8, 25  # … one-hot sequences of the Hamming kernel, the parameters' seed
TAIL_F64_TOL = 1e-10        # … max |Δ| / max |·| against the CPU in float64
TAIL_F32_TOL = 1e-4         # … and the card's float32 against it, ≈ 840 float32 round-offs (the CPU's float32 read
                            # ≤ 9.1e-06, the cosine kernel's)
TAIL_F32_ROOT_TOL = 4e-3    # … for the Wendland function of q = 0, (1 − r)^j, whose slope at r = 0 lifts the
                            # round-off of a distance near 0 to its square root, ≈ 12 √ε (the CPU's float32 read 5.3e-04
                            # on the streamed product, whose blocks keep that round-off on their diagonal)
TAIL_F64_ROOT_TOL = 1e-7    # … and in float64, ≈ 7 √ε (an H100 read 2.6e-08 against the CPU: each side's expansion
                            # leaves its own ≈ 1e-16 on those distances)
TAIL_ROOT_KERNELS = ("piecewise_q0",)
# phases 19-19d: model lists, the leave-one-out objective, the Bayesian GPLVM, the new priors and metrics
LIST_STEPS, LIST_FANT = 10, 16  # phase 19: joint Adam steps of the two-outcome list; fantasy points per outcome
LIST_LR = (0.01, 0.1)       # … Adam's rates: outcome 0 (phase 7's trained flagship) at the last rate of phase 7's
                            # schedule (at 0.1 its loss rose from −0.277 to −0.209 in 10 steps and its cold CG grew from
                            # 21 to 88 iterations on an H100 80GB HBM3 at 700 W), outcome 1 cosine 0.1 → 0.01
LIST_SEED = 19              # … the second outcome's noise, and the probes of step 0's sum check
LIST_CG = {"cg_stall_window": 1000, "max_cg_iterations": 400}  # … bench.py's recipe with these replaced.  The sum
                            # passes no warm state, so every solve starts at zero, where CG keeps x = 0 until |r|
                            # first drops below |y| (ROADMAP queue 3); without the stall exit each runs to tolerance
LIST_RES_TOL = 0.6          # … each outcome's rhs solve: ‖K̂x − y‖ / ‖y‖ within twice the CG tolerance 0.3 (x = 0: 1)
LIST_SUM_TOL = 1e-5         # … step 0: |summed − Σ alone| / max(|Σ alone|, 1) with the same probes (float32 round-off)
LIST_SLICE_N = 2000         # … CUDA float32 against CPU float64 at this N, gated at SLICE_LOSS_TOL and SLICE_GRAD_TOL
LOO_N, LOO_PROBE_N, LOO_STEPS = 16_384, 8192, 20  # phase 19b: points, the size read first, Adam steps
LOO_STEP_LIMIT = 1.5        # … seconds a step at LOO_N above which training runs at LOO_PROBE_N
LOO_PARITY_N, LOO_F64_TOL = 2048, 1e-10  # … float64 value and gradient, the card against the CPU, relative
LOO_POINTS, LOO_COND_TOL = 8, 1e-10 # … μᵢ and σᵢ² against conditioning on the other n − 1 points (float64, card)
GPLVM_N, GPLVM_DIM, GPLVM_M, GPLVM_BATCH = 1000, 12, 25, 100  # phase 19c: GPyTorch's GPLVM tutorial's shape
GPLVM_STEPS, GPLVM_LR, GPLVM_CORR = 300, 0.01, 0.5  # … Adam steps at the tutorial's rate; the geometry gate
GPLVM_F64_TOL = 1e-10       # … one float64 ELBO and gradient, the card against the CPU, relative
GPLVM_POINT_STEPS = 5       # … steps of the point and MAP latents
PRIOR_TOL = (1e-4, 1e-10)   # phase 19d: float32 and float64 log-densities and gradients on the card against the CPU
PRIOR_DRAWS = 200_000       # … draws of each sampler, its moment within 5 standard errors
METRIC_TOL = 1e-10          # … the metrics in float64 on the card against the CPU
HAD_PRIOR_N, HAD_PRIOR_STEPS = 1024, 5  # … the Hadamard model with an LKJ task-covariance prior: points a task, steps


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def make_task(n_train: int, n_test: int, seed: int = 0):
    """bench.py's synthetic task (bench.py:224-240), drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_train + n_test, D))
    f = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * x[:, 2]
    y = f + 0.1 * rng.normal(size=n_train + n_test)
    y = (y - y.mean()) / y.std()
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def make_periodic_task(n_train: int, n_test: int, seed: int = 0):
    """A sensor read every 5 minutes (t_i = i / 288 days): a daily profile with a morning
    and an evening peak, damped to 0.4 on weekends, plus Gaussian noise of 0.1·std(f),
    standardised.  x = [t, t]; the last ``n_test`` readings follow the training ones."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_train + n_test) / 288.0
    h = 24.0 * (t - np.floor(t))
    f = np.exp(-(((h - 8.0) / 1.5) ** 2)) + 0.8 * np.exp(-(((h - 17.5) / 2.0) ** 2))
    f = np.where(np.floor(t) % 7 >= 5, 0.4 * f, f)
    y = f + 0.1 * f.std() * rng.normal(size=t.shape)
    y = (y - y.mean()) / y.std()
    x = np.stack([t, t], axis=1)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def make_wide_task(n_train: int, n_test: int, d: int = WIDE_D, seed: int = 0):
    """A regression task on d inputs, drawn with numpy: x uniform on the unit cube, the
    flagship's function of the first three inputs plus a smooth term in all of them,
    Gaussian noise of 0.1, standardised."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_train + n_test, d))
    f = (np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0])
         + np.sin(2 * np.pi * x @ rng.normal(size=d) / np.sqrt(d)))
    y = f + 0.1 * rng.normal(size=n_train + n_test)
    y = (y - y.mean()) / y.std()
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def build_model(train_x, train_y, device, dtype, params=JAX_PARAMS, nu=None, honest=False):
    """The flagship model on ``device``: from the raw parameters ``params`` in eval mode, or
    with ``params=None`` at bench.py's initial values (noise 0.1, lengthscale 0.5) in
    train mode.  ``nu`` swaps the RBF kernel for a Matérn kernel of that smoothness.  Its
    ARD width is that of ``train_x``; past d = 3 the initial lengthscale is 0.5·√(d/3),
    which keeps the typical squared distance of points in the unit cube at the flagship's.
    ``honest``: the likelihood of bench.py's honest recipe, noise ≥ 1e-4 with a
    LogNormal(−4, 1) prior, in place of noise ≥ 2e-2."""
    import torch

    import gpytorch_tpu_torch as gt

    base = gt.kernels.RBFKernel if nu is None else (lambda **kw: gt.kernels.MaternKernel(nu=nu, **kw))
    d = np.shape(train_x)[1]

    class FlagshipGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(base(ard_num_dims=d))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx = torch.as_tensor(train_x, dtype=dtype, device=device)
    ty = torch.as_tensor(train_y, dtype=dtype, device=device)
    if honest:
        likelihood = gt.likelihoods.GaussianLikelihood(noise_prior=gt.priors.LogNormalPrior(-4.0, 1.0),
                                                       noise_constraint=gt.constraints.GreaterThan(HONEST_NOISE_FLOOR))
    else:
        likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    model = FlagshipGP(tx, ty, likelihood).to(device=device, dtype=dtype)
    if params is None:
        model.likelihood.noise = 0.1
        model.covar_module.base_kernel.lengthscale = 0.5 * math.sqrt(d / D)
        return model.train()
    gt.load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    return model.eval()


def build_periodic_model(train_x, train_y, device, dtype):
    """The periodic exact GP (ConstantMean + ScaleKernel(PeriodicKernel(ard_num_dims=2)) +
    GaussianLikelihood with noise ≥ 2e-2) on ``device`` at its initial values (noise 0.1,
    lengthscale 0.5, periods of 1 and 7 days), in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    class PeriodicGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.PeriodicKernel(ard_num_dims=P_D))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx = torch.as_tensor(train_x, dtype=dtype, device=device)
    ty = torch.as_tensor(train_y, dtype=dtype, device=device)
    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    model = PeriodicGP(tx, ty, likelihood).to(device=device, dtype=dtype)
    model.likelihood.noise = 0.1
    model.covar_module.base_kernel.lengthscale = 0.5
    model.covar_module.base_kernel.period_length = P_PERIODS
    return model.train()


def train_settings(budget: float = PC_NOISE_BUDGET, honest: bool = False, overrides=None):
    """bench.py's default training recipe (bench.py:103-209, no BENCH_* variable set), or
    with ``honest`` its honest recipe's CG (tolerance 0.05, stall window 50); ``overrides``
    ({setting name: value}) replaces some of its settings; a float64 run that is to match a
    float32 one takes ``budget=PC_NOISE_BUDGET_F64``."""
    from gpytorch_tpu_torch import settings

    stack = contextlib.ExitStack()
    for ctx in (
        settings.max_cholesky_size(0),
        settings.max_cg_iterations(100),
        settings.cg_tolerance(0.3),
        settings.num_trace_samples(63),
        settings.max_lanczos_quadrature_iterations(6),
        settings.max_preconditioner_size(50),
        settings.cg_stall_window(15),
        settings.cg_lagged_rhs(True),
        settings.precond_logdet_vr(True),
        settings.preconditioner_noise_budget(budget),
        settings.fast_precond_grad(True),
        settings.skip_logdet_forward(False),
    ):
        stack.enter_context(ctx)
    if honest:
        stack.enter_context(settings.cg_tolerance(HONEST_CG_TOL))
        stack.enter_context(settings.cg_stall_window(HONEST_STALL))
    for name, value in (overrides or {}).items():
        stack.enter_context(getattr(settings, name)(value))
    return stack


def make_optimizer(model):
    """Adam with cosine decay 0.1 → 0.01 over the run (bench.py:276-293)."""
    import torch

    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    return optimizer, torch.optim.lr_scheduler.CosineAnnealingLR(optimizer, T_max=TRAIN_STEPS, eta_min=0.01)


def make_periodic_optimizer(model):
    """``make_optimizer``'s cosine Adam 0.1 → 0.01, with raw_period_length at its own
    learning rate ``P_PERIOD_LR``, decayed alike."""
    import torch

    period = model.covar_module.base_kernel.raw_period_length
    rest = [p for p in model.parameters() if p is not period]
    optimizer = torch.optim.Adam([{"params": rest, "lr": 0.1}, {"params": [period], "lr": P_PERIOD_LR}])

    def cosine(step):
        return 0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * min(step, P_TRAIN_STEPS) / P_TRAIN_STEPS))

    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, cosine)


def mll_loss(model, base_samples, state, budget: float = PC_NOISE_BUDGET, honest: bool = False, overrides=None):
    """−MLL per datum (with the priors' log-densities, where the model has priors) by mBCG
    with the rhs-only warm state, under the training recipe; returns (loss, state)."""
    import gpytorch_tpu_torch as gt

    tx, ty = model.train_inputs[0], model.train_targets
    with train_settings(budget, honest, overrides):
        mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)
        value, state = mll(model(tx), ty, base_samples=base_samples, solver_state=state, return_state=True)
    return -value, state


def train_step(model, optimizer, scheduler, base_samples, state, budget: float = PC_NOISE_BUDGET,
               honest: bool = False, overrides=None):
    """One step of −MLL by mBCG with the rhs-only warm state; returns (loss, state)."""
    optimizer.zero_grad()
    loss, state = mll_loss(model, base_samples, state, budget, honest, overrides)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return loss.detach(), state


class InjectedProbes:
    """Probe base samples made with numpy from (seed, step, shape), the same on any device."""

    def __init__(self, step: int, seed: int = PROBE_SEED):
        self.step, self.seed = step, seed

    def __call__(self, shape):
        return np.random.default_rng([self.seed, self.step, *shape]).normal(size=shape)


class PinnedPivots:
    """The preconditioner's pivot order, recorded in one run (``record``) and followed in
    others (``replay``: the n-th pivoted-Cholesky call of the run takes the n-th recorded
    order).  On the periodic kernel the greedy order is set by round-off (after the first
    pivot about half the points tie to within 1e-8 of the largest residual), so two
    devices or dtypes would pick different pivots, hence different probes z ~ N(0, P), and
    their gap would measure the stochastic estimator; pinned, they differ by round-off."""

    def __init__(self):
        self.orders = []

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        import importlib

        pc = importlib.import_module("gpytorch_tpu_torch.solvers.pivoted_cholesky")
        sound, orders = pc.pivoted_cholesky, iter(self.orders)

        def pinned(linop, rank, rel_tol=0.0, return_pivots=False):
            if replay:
                order = next(orders, None)
                check(order is not None, "a replayed run made more pivoted-Cholesky calls than the recorded one")
                L, piv = sound(linop, rank, rel_tol, return_pivots=True, pivots=order)
            else:
                L, piv = sound(linop, rank, rel_tol, return_pivots=True)
                self.orders.append(piv.cpu())
            return (L, piv) if return_pivots else L

        pc.pivoted_cholesky = pinned
        try:
            yield
        finally:
            pc.pivoted_cholesky = sound

    def record(self):
        return self._patched(replay=False)

    def replay(self):
        return self._patched(replay=True)


@contextlib.contextmanager
def plain_kernels():
    """Routes CUDA tensors through the plain versions instead of the five CUDA kernels: a
    float64 reference run of a whole path on the card."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    swaps = [(fk, "kernel_matvec_cuda", fk._matvec_reference), (fk, "kernel_grad_x_cuda", fk._grad_x_reference),
             (fk, "kernel_bwd_fused_cuda", fk._bwd_fused_reference),
             (ppk, "periodic_matvec_cuda", ppk._periodic_matvec_reference),
             (ppk, "periodic_bwd_fused_cuda", ppk._periodic_bwd_fused_reference)]
    kernels = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), kernel in zip(swaps, kernels):
            setattr(module, name, kernel)


@contextlib.contextmanager
def counted_products():
    """Counts the kernel products K·V of a run, on either device and through either the
    kernel or its plain version (the CG iterations of a training loss, one product each);
    yields a one-element list that holds the count."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    product, count = fk._product, [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return product(*args, **kwargs)

    fk._product = counted
    try:
        yield count
    finally:
        fk._product = product


def finite_step(loss, model) -> bool:
    import torch

    flags = [torch.isfinite(loss).all()] + [torch.isfinite(p.grad).all() for p in model.parameters()]
    return bool(torch.stack(flags).all())


def eval_settings(min_preconditioning_size=None):
    """bench.py's eval settings (bench.py:469-476)."""
    from gpytorch_tpu_torch import settings

    stack = contextlib.ExitStack()
    for ctx in (
        settings.max_cholesky_size(0),
        settings.eval_cg_tolerance(1e-3),
        settings.max_preconditioner_size(50),
        settings.max_cg_iterations(1000),
        settings.cg_stall_window(50),
        settings.preconditioner_noise_budget(PC_NOISE_BUDGET),
        settings.fast_pred_var(True),
        settings.max_root_decomposition_size(100),
        settings.skip_posterior_variances(False),
    ):
        stack.enter_context(ctx)
    if min_preconditioning_size is not None:
        stack.enter_context(settings.min_preconditioning_size(min_preconditioning_size))
    return stack


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve(model, test_x, device, batches):
    """Refresh the model, then answer one request per slice in ``batches``.

    Returns (cg_result, refresh_s, [(prediction, mean, variance, seconds) per request])."""
    import torch

    sync(device)
    t0 = time.perf_counter()
    strategy = model.refresh()
    sync(device)
    refresh_s = time.perf_counter() - t0
    answers = []
    with torch.no_grad():
        for sl in batches:
            xb = test_x[sl]
            t0 = time.perf_counter()
            pred = model.likelihood(model(xb))
            mean, var = pred.mean, pred.variance
            sync(device)
            answers.append((pred, mean, var, time.perf_counter() - t0))
    return strategy.lik_train_train_covar.last_cg_result, refresh_s, answers


def ucb(model, x):
    """(UCB, variance) of the latent posterior at each candidate row of ``x``:
    UCB(x) = μ(x) + 2σ(x), the acquisition function of phases 4c and 9."""
    latent = model(x)
    var = latent.variance
    return latent.mean + UCB_BETA * var.sqrt(), var


def ucb_gradient(model, x, params=()):
    """One gradient evaluation: ∇ΣUCB with respect to the candidates ``x`` (and to
    ``params``, None for one that the prediction does not reach), the UCB and the
    variances."""
    import torch

    xg = x.detach().requires_grad_(True)
    u, var = ucb(model, xg)
    grads = torch.autograd.grad(u.sum(), [xg, *params], allow_unused=True)
    return grads[0], grads[1:], u.detach(), var.detach()


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exp_floor_ms(exps: float) -> float:
    """The least time for ``exps`` exps on the special-function units."""
    return 1e3 * exps / H100_EXPS_PER_S


def bound_ms(flops: float, nbytes: float, exps: float):
    """The least time the card could take on its CUDA cores: the larger of the FP32
    operations over the FP32 peak, the exps (one a pair in every kernel here) over the
    special-function units' rate and the bytes over the memory rate; and which of them it
    is ("operations" for the first two).  The exps bind the t = 1 products."""
    t_ops = max(flops / H100_FP32_FLOPS, 1e-3 * exp_floor_ms(exps))
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def matvec_bound(n: int, m: int, d: int, t: int):
    """K·V: 2t FLOP for the product and 3d for the distance per (i, j) pair, and one exp;
    x1, x2 and v read once, the output written once.  At t = 1 the exps bind."""
    return bound_ms(n * m * (2 * t + 3 * d), 4 * (n * d + m * d + m * t + n * t), n * m)


def tc_bound(pairs: int, t: int, cuda_ops: int, nbytes: int, fp64_t: int = 0, fp64_ops: int = 0):
    """A K·V tier on the tensor cores in 3xTF32: the larger of three passes of 2t operations
    per (i, j) pair over the dense TF32 peak (plus, for a float64 product of depth ``fp64_t``
    on the same tensor cores, 2 fp64_t over their FP64 peak), ``cuda_ops`` operations per
    pair on the CUDA cores (forming K and its hi/lo split) over the FP32 peak, ``fp64_ops``
    over the FP64 peak, and ``nbytes`` over the memory rate (one exp per pair besides, which
    binds neither t ∈ (32, 64] tier)."""
    tensor = 3 * 2 * t * pairs / H100_TF32_FLOPS + 2 * fp64_t * pairs / H100_FP64_TC_FLOPS
    times = {"operations": max(tensor, cuda_ops * pairs / H100_FP32_FLOPS, fp64_ops * pairs / H100_FP64_FLOPS),
             "bytes": nbytes / H100_BYTES_PER_S}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def matvec_tc_bound(n: int, m: int, d: int, t: int):
    """K·V's t ∈ (32, 64] tier: ``tc_bound`` with the 3d + 4 CUDA-core operations per pair
    of the distance, the kernel and the split, and the bytes of ``matvec_bound``."""
    return tc_bound(n * m, t, 3 * d + 4, 4 * (n * d + m * d + m * t + n * t))


def grad_x_bound(n: int, m: int, d: int, t: int):
    """The cotangent of x1: per (i, j) pair 2t FLOP for g_i·v_j, 5d for the distance and the
    moment, 4 for k′ and the weight, and one exp; x1, x2, g and v read once, dx1 written
    once."""
    return bound_ms(n * m * (2 * t + 5 * d + 4), 4 * (2 * n * d + m * d + n * t + m * t), n * m)


def grad_x_tc_bound(n: int, m: int, d: int, t: int):
    """grad_x's t ∈ (32, 128] tier: ``tc_bound`` with the score g_i·v_j of depth t on the
    tensor cores, the 5d + 4 CUDA-core operations per pair of the distance, the moment, k′
    and the weight, and the bytes of ``grad_x_bound``."""
    return tc_bound(n * m, t, 5 * d + 4, 4 * (2 * n * d + m * d + n * t + m * t))


def bwd_bound(n: int, d: int, t: int, dv: bool = False):
    """Fused backward on the FP32 cores (dx and dos): per (i, j) pair 4t FLOP for g_i·v_j
    and v_i·g_j, 5d for the distance and the dx update, about 9 for k, k′, the weight and
    dos, and one exp; x, g and v read once, dx written once.  With ``dv`` (= K·g) 2t FLOP
    more per pair on the same k and dv written once."""
    return bound_ms(n * n * (4 * t + 5 * d + 9 + (2 * t if dv else 0)), 4 * (2 * n * d + (3 if dv else 2) * n * t),
                    n * n)


def bwd_tc_bound(n: int, d: int, t: int, dv: bool = False, dos: bool = True):
    """The fused backward's t ∈ (32, 64] tier: ``tc_bound`` with the score
    [g_i | v_i]·[v_j | g_j] of depth 2t on the tensor cores (3t with ``dv``'s product) and
    the 5d + 9 CUDA-core operations per pair of ``bwd_bound`` for dx, and for ``dos`` the
    float64 score g_i·v_j of depth t on the FP64 tensor cores with 3d + 4 float64 operations
    per pair (the distance, k and the sum; one float64 exp besides); and its bytes."""
    return tc_bound(n * n, (3 if dv else 2) * t, 5 * d + 9, 4 * (2 * n * d + (3 if dv else 2) * n * t),
                    t if dos else 0, 3 * d + 4 if dos else 0)


def periodic_matvec_bound(n: int, m: int, d: int, t: int):
    """Periodic K·V: per (i, j) pair 2t FLOP for the product, 6d for the weighted sin² from
    the per-point half-angle tables (s_i c_j − c_i s_j, its square and weight), 1 for the
    exponent, and one exp (the tables' sines are O((n + m) d)); x1, x2, w and v read once,
    the output written once.  At t = 1 the exps bind."""
    return bound_ms(n * m * (2 * t + 6 * d + 1), 4 * (n * d + m * d + d + m * t + n * t), n * m)


def periodic_matvec_tc_bound(n: int, m: int, d: int, t: int):
    """Periodic K·V's t ∈ (32, 64] tier: ``tc_bound`` with the 6d + 2 CUDA-core operations
    per pair of the weighted sin² from the tables, the exponent and the split, and the bytes
    of ``periodic_matvec_bound``."""
    return tc_bound(n * m, t, 6 * d + 2, 4 * (n * d + m * d + d + m * t + n * t))


def periodic_bwd_bound(n: int, d: int, t: int):
    """Fused periodic backward on the FP32 cores: per (i, j) pair 4t FLOP for the score
    g_i·v_j + v_i·g_j, 15d for the sine and cosine of the difference from the tables, the
    weighted sin² and the dx and dw updates, 4 for the exponent, the score's weight and dos,
    and one exp; x, w, g and v read once, dx, dw and dos written once."""
    return bound_ms(n * n * (4 * t + 15 * d + 4), 4 * (2 * n * d + 2 * d + 2 * n * t + 1), n * n)


def periodic_bwd_tc_bound(n: int, d: int, t: int):
    """The fused periodic backward's t ∈ (32, 64] tier (dx, dw and dos): ``tc_bound`` with
    the score [g_i | v_i]·[v_j | g_j] of depth 2t on the tensor cores, the 15d + 4
    CUDA-core operations per pair of ``periodic_bwd_bound``, and its bytes."""
    return tc_bound(n * n, 2 * t, 15 * d + 4, 4 * (2 * n * d + 2 * d + 2 * n * t + 1))


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, timeout=60
    )
    return smi.stdout.strip()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke test runs only on a GPU")
    print(f"[device] {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"[device] nvidia-smi: {nvidia_smi()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    t0 = time.perf_counter()
    so = fk.build()
    fk.load_library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)


def _rel_err(got, want, x1, x2, v, kt):
    """max |got − want| / max K|v|, and max |got − want|."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    err = (got.double() - want.double()).abs().max().item()
    return err / fk._matvec_reference(x1, x2, v.abs(), kt).abs().max().item(), err


def strip_entry(n: int, m: int, t: int, slabs: int, ms: float, plain_ms: float, bound) -> dict:
    """One strip's reading for the report line: ``slabs`` is the count of the timed launch
    (the wrapper's ``last_slabs``)."""
    return {"n": n, "m": m, "t": t, "slabs": slabs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def print_strip(tag: str, e: dict) -> None:
    floor = f", exp floor {exp_floor_ms(e['n'] * e['m']):.4f} ms" if e["t"] == 1 else ""
    print(f"[{tag}] strip {e['n']}x{e['m']} t={e['t']}: {e['slabs']} slabs of the j range; kernel {e['ms']:.4f} ms, "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}{floor})", flush=True)


def phase_kernel():
    """Kernel against plain on the card; returns (max_abs_err, {(n, m, t): (ms, plain_ms)},
    [strip readings])."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    rng = np.random.default_rng(1)
    dev = "cuda"
    max_abs, worst_rel = 0.0, 0.0
    for kt in fk.KERNEL_TYPES:
        for d in (3, 11):
            for t in (1, 20, 100):
                x1 = torch.as_tensor(rng.normal(size=(1000, d)), dtype=torch.float32, device=dev)
                x2 = torch.as_tensor(rng.normal(size=(1537, d)), dtype=torch.float32, device=dev)
                v = torch.as_tensor(rng.normal(size=(1537, t)), dtype=torch.float32, device=dev)
                got = fk.kernel_matvec_cuda(x1, x2, v, kt)
                rel, err = _rel_err(got, fk._matvec_reference(x1, x2, v, kt), x1, x2, v, kt)
                max_abs, worst_rel = max(max_abs, err), max(worst_rel, rel)
                check(rel <= KERNEL_REL_TOL, f"kernel type {kt}, d={d}, t={t}: relative error {rel:.3e} > {KERNEL_REL_TOL}")
        print(f"[kernel] type {kt}: n=1000 m=1537 d∈{{3,11}} t∈{{1,20,100}} within {KERNEL_REL_TOL} "
              f"(worst so far {worst_rel:.3e})", flush=True)
    # the tiled tier of 16 columns (t ∈ (1, 16], a fantasy update's solves) and that of 32
    # at t ∈ (20, 32] (t ∈ (16, 20], a Lanczos block, above), on their own draws
    rng16 = np.random.default_rng(16)
    for kt in fk.KERNEL_TYPES:
        for d, t in ((3, 16), (11, 5), (3, 27)):
            x1, x2 = (torch.as_tensor(rng16.normal(size=(r, d)), dtype=torch.float32, device=dev) for r in (1000, 1537))
            v = torch.as_tensor(rng16.normal(size=(1537, t)), dtype=torch.float32, device=dev)
            rel, err = _rel_err(fk.kernel_matvec_cuda(x1, x2, v, kt), fk._matvec_reference(x1, x2, v, kt), x1, x2, v, kt)
            max_abs, worst_rel = max(max_abs, err), max(worst_rel, rel)
            check(rel <= KERNEL_REL_TOL, f"kernel type {kt}, d={d}, t={t}: relative error {rel:.3e} > {KERNEL_REL_TOL}")
    print(f"[kernel] the tiled tiers of 16 and 32 columns: n=1000 m=1537 (d, t) ∈ {{(3, 16), (11, 5), (3, 27)}}, four "
          f"kernel types, within {KERNEL_REL_TOL} (worst so far {worst_rel:.3e})", flush=True)

    # serving shapes: CG (100k × 100k, t=1), Lanczos block (t=20), K(test, train)·R (t=100)
    # and K(test, train)·α (t=1, the mean); training shape: mBCG over [y, 63 probes] (t=64);
    # then the strips of a request of 256 points, and a Lanczos block of the LOVE sample
    # root on K(test, test) (2048 × 2048, t=20, symmetric).  The strips (fewer rows than the
    # card has SMs) split the j range into slabs (fk.product_slabs); the 2048-row ones, the
    # Lanczos block and the training product are gated against float64 at twice the plain
    # float32 version's error
    timed, strips = {}, []
    for n, m, t in ((N_TRAIN, N_TRAIN, 1), (N_TRAIN, N_TRAIN, 20), (N_TEST, N_TRAIN, 100), (N_TEST, N_TRAIN, 1),
                    (N_TRAIN, N_TRAIN, 64), (REQUEST_ROWS, N_TRAIN, 100), (REQUEST_ROWS, N_TRAIN, 1),
                    (N_TEST, N_TEST, 20)):
        x2 = torch.as_tensor(rng.uniform(size=(m, D)) / 0.3, dtype=torch.float32, device=dev)
        x1 = x2 if n == m else torch.as_tensor(rng.uniform(size=(n, D)) / 0.3, dtype=torch.float32, device=dev)
        v = torch.as_tensor(rng.normal(size=(m, t)), dtype=torch.float32, device=dev)
        got = fk.kernel_matvec_cuda(x1, x2, v, fk.RBF)
        plain = fk._matvec_reference(x1, x2, v, fk.RBF)
        rel, err = _rel_err(got, plain, x1, x2, v, fk.RBF)
        check(rel <= KERNEL_REL_TOL, f"serving shape {n}x{m} t={t}: relative error {rel:.3e} > {KERNEL_REL_TOL}")
        max_abs = max(max_abs, err)
        if t in (1, 20, 64) or n == N_TEST:  # both float32 versions against float64
            exact = fk._matvec_reference(x1.double(), x2.double(), v.double(), fk.RBF)
            rel64 = _rel_err(got, exact, x1, x2, v, fk.RBF)[0]
            plain64 = _rel_err(plain, exact, x1, x2, v, fk.RBF)[0]
            del exact
            print(f"[kernel] {n}x{m} t={t} against float64: kernel {rel64:.3e}, plain float32 {plain64:.3e}", flush=True)
            if t in (20, 64) or n == N_TEST:  # the Lanczos block, the training product and the 2048-row strips
                check(rel64 <= min(2.0 * plain64, KERNEL_REL_TOL), f"the product {n}x{m} t={t} against float64: "
                      f"{rel64:.3e}, more than twice the plain version's {plain64:.3e} or over {KERNEL_REL_TOL}")
        ms = cuda_time_ms(lambda: fk.kernel_matvec_cuda(x1, x2, v, fk.RBF), 10)
        slabs = fk.kernel_matvec_cuda.last_slabs
        plain_ms = cuda_time_ms(lambda: fk._matvec_reference(x1, x2, v, fk.RBF), 2)
        timed[(n, m, t)] = (ms, plain_ms)
        bound = matvec_tc_bound(n, m, D, t) if 32 < t <= 64 else matvec_bound(n, m, D, t)
        print(f"[kernel] {n}x{m} t={t}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
              f"({bound[1]}; {n * m:.3e} exp), max abs err {err:.3e} (rel {rel:.3e})", flush=True)
        if n < m or n == N_TEST:
            strips.append(strip_entry(n, m, t, slabs, ms, plain_ms, bound))
            print_strip("kernel", strips[-1])
    # what a launch costs at the least: a 64 × 64 product at t=1 through the same wrapper
    # (argument checks, the slab plan, the launch and the fold), back to back
    x = torch.as_tensor(rng.uniform(size=(64, D)), dtype=torch.float32, device=dev)
    v = torch.ones(64, 1, dtype=torch.float32, device=dev)
    strips[-1]["launch_floor_ms"] = cuda_time_ms(lambda: fk.kernel_matvec_cuda(x, x, v, fk.RBF), 100)
    print(f"[kernel] launch floor: a 64x64 t=1 product {strips[-1]['launch_floor_ms']:.4f} ms a launch, back to back; "
          f"the sample root's 2048x2048 t=20 block {strips[-1]['ms']:.4f} ms", flush=True)

    # the wide-d tier (d > 64): the four kernel types at ragged shapes, t = 1 and 64 (two
    # column tiles of 32); then timed at WIDE_N × WIDE_N, t = 64.  Inputs scaled by 1/√d, so
    # that squared distances stay O(1)
    rng = np.random.default_rng(11)
    for kt in fk.KERNEL_TYPES:
        for t in (1, 64):
            x1, x2 = (torch.as_tensor(rng.normal(size=(r, WIDE_D)) / math.sqrt(WIDE_D), dtype=torch.float32, device=dev)
                      for r in (1000, 1537))
            v = torch.as_tensor(rng.normal(size=(1537, t)), dtype=torch.float32, device=dev)
            got = fk.kernel_matvec_cuda(x1, x2, v, kt)
            rel, err = _rel_err(got, fk._matvec_reference(x1, x2, v, kt), x1, x2, v, kt)
            max_abs, worst_rel = max(max_abs, err), max(worst_rel, rel)
            check(rel <= KERNEL_REL_TOL, f"kernel type {kt}, d={WIDE_D}, t={t}: relative error {rel:.3e} > {KERNEL_REL_TOL}")
    print(f"[kernel] wide tier: n=1000 m=1537 d={WIDE_D} t∈{{1,64}}, four kernel types, within {KERNEL_REL_TOL} "
          f"(worst so far {worst_rel:.3e})", flush=True)
    n, t = WIDE_N, 64
    x = torch.as_tensor(rng.uniform(size=(n, WIDE_D)) / (0.3 * math.sqrt(WIDE_D / D)), dtype=torch.float32, device=dev)
    v = torch.as_tensor(rng.normal(size=(n, t)), dtype=torch.float32, device=dev)
    got = fk.kernel_matvec_cuda(x, x, v, fk.RBF)
    rel, err = _rel_err(got, fk._matvec_reference(x, x, v, fk.RBF), x, x, v, fk.RBF)
    check(rel <= KERNEL_REL_TOL, f"wide tier {n}x{n} d={WIDE_D} t={t}: relative error {rel:.3e} > {KERNEL_REL_TOL}")
    max_abs = max(max_abs, err)
    ms = cuda_time_ms(lambda: fk.kernel_matvec_cuda(x, x, v, fk.RBF), 5)
    plain_ms = cuda_time_ms(lambda: fk._matvec_reference(x, x, v, fk.RBF), 3)
    timed[("wide", n, n, t)] = (ms, plain_ms)
    bms, by = matvec_bound(n, n, WIDE_D, t)
    print(f"[kernel] wide tier {n}x{n} d={WIDE_D} t={t}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.3f} ms "
          f"({by}), max abs err {err:.3e} (rel {rel:.3e})", flush=True)
    return max_abs, timed, strips


def _bwd_abs_terms(x, g, v, kt):
    """Sums of absolute terms of the fused backward's outputs (dx, dv, dos), dense, float64."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    diff = (x[:, None, :] - x[None, :, :]).abs()
    k, kp = fk._kernel_fn_and_prime((diff * diff).sum(-1), kt)
    kp.fill_diagonal_(0.0)
    gv = (g @ v.mT).abs()
    w = kp.abs() * (gv + (v @ g.mT).abs())
    return 2.0 * torch.einsum("ij,ijk->ik", w, diff), k.abs() @ g.abs(), (k.abs() * gv).sum()


def phase_bwd():
    """Backward kernel against plain on the card; returns (max_abs_err, ms, plain_ms) at the
    training shape."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    rng = np.random.default_rng(4)
    dev = "cuda"
    max_abs, worst_rel = 0.0, 0.0
    for kt in fk.KERNEL_TYPES:
        for d in (3, 11):
            for t in (1, 20, 33, 64):
                x, g, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
                           for s in ((1537, d), (1537, t), (1537, t)))
                x64, g64, v64 = x.double(), g.double(), v.double()
                bx, bdv, bdos = _bwd_abs_terms(x64, g64, v64, kt)
                for need_dv in (True, False):
                    dv, dx, dos = fk.kernel_bwd_fused_cuda(x, g, v, kt, need_dv=need_dv, need_dos=True)
                    torch.cuda.synchronize()
                    rdv, rdx, rdos = fk._bwd_fused_reference(x64, g64, v64, kt, need_dv=need_dv, need_dos=True)
                    errs = [((dx.double() - rdx).abs().max(), bx.max()), ((dos.double() - rdos).abs(), bdos)]
                    if need_dv:
                        errs.append(((dv.double() - rdv).abs().max(), bdv.max()))
                    for err, scale in errs:
                        max_abs, rel = max(max_abs, err.item()), (err / scale).item()
                        worst_rel = max(worst_rel, rel)
                        check(rel <= BWD_REL_TOL, f"backward kernel type {kt}, d={d}, t={t}, need_dv={need_dv}: "
                                                  f"relative error {rel:.3e} > {BWD_REL_TOL}")
        print(f"[bwd] type {kt}: n=1537 d∈{{3,11}} t∈{{1,20,33,64}} (the tensor-core tier at 33 and 64) dv on/off, "
              f"dos, within {BWD_REL_TOL} (worst so far {worst_rel:.3e})", flush=True)

    # the training shape: every mBCG backward (N=100k, d=3, t = 1 rhs + 63 probes, dos, no dv)
    t = 64
    x = torch.as_tensor(rng.uniform(size=(N_TRAIN, D)) / 0.3, dtype=torch.float32, device=dev)
    g, v = (torch.as_tensor(rng.normal(size=(N_TRAIN, t)), dtype=torch.float32, device=dev) for _ in range(2))
    _, dx, dos = fk.kernel_bwd_fused_cuda(x, g, v, fk.RBF, need_dv=False, need_dos=True)
    _, pdx, pdos = fk._bwd_fused_reference(x, g, v, fk.RBF, need_dv=False, need_dos=True)
    _, edx, edos = fk._bwd_fused_reference(x.double(), g.double(), v.double(), fk.RBF, need_dv=False, need_dos=True)
    rel = {}  # (dx, dos) of the kernel and of the float32 plain version, against float64
    for name, (ddx, ddos) in (("kernel", (dx, dos)), ("plain float32", (pdx, pdos))):
        err_dx, err_dos = (ddx.double() - edx).abs().max().item(), abs(ddos.double() - edos).item()
        rel[name] = (err_dx / edx.abs().max().item(), err_dos / abs(edos.item()))
        if name == "kernel":
            max_abs = max(max_abs, err_dx, err_dos)
    ms = cuda_time_ms(lambda: fk.kernel_bwd_fused_cuda(x, g, v, fk.RBF, need_dv=False, need_dos=True), 5)
    plain_ms = cuda_time_ms(lambda: fk._bwd_fused_reference(x, g, v, fk.RBF, need_dv=False, need_dos=True), 2)
    bms, by = bwd_tc_bound(N_TRAIN, D, t)
    fp32_ms, _ = bwd_bound(N_TRAIN, D, t)
    print(f"[bwd] {N_TRAIN}x{N_TRAIN} d={D} t={t} (dos, no dv; the tensor-core tier): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by}; on the FP32 cores {fp32_ms:.3f} ms; {N_TRAIN**2:.3e} exp); "
          f"against float64, max |Δdx| / max |dx| and |Δdos| / |dos|: kernel {rel['kernel'][0]:.3e}, "
          f"{rel['kernel'][1]:.3e}; plain float32 {rel['plain float32'][0]:.3e}, {rel['plain float32'][1]:.3e} "
          f"(gate: twice the plain version's, and {BWD_TRAIN_TOL})", flush=True)
    for name, r, p in zip(("dx", "dos"), rel["kernel"], rel["plain float32"]):
        check(r <= min(2.0 * p, BWD_TRAIN_TOL), f"backward kernel at the training shape, {name}, against float64: "
                                                f"{r:.3e}, more than twice the plain version's {p:.3e} or over "
                                                f"{BWD_TRAIN_TOL}")

    # the wide-d tier (d > 64): the four kernel types at a ragged n, t = 1 and 40, dv on and
    # off, against float64 over the sums of absolute terms; then at WIDE_N, t = 64 (dos, no
    # dv) against float64, and timed there
    rng = np.random.default_rng(12)
    for kt in fk.KERNEL_TYPES:
        for t in (1, 40):
            x, g, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
                       for s in ((517, WIDE_D), (517, t), (517, t)))
            x = x / math.sqrt(WIDE_D)
            x64, g64, v64 = x.double(), g.double(), v.double()
            bx, bdv, bdos = _bwd_abs_terms(x64, g64, v64, kt)
            for need_dv in (True, False):
                dv, dx, dos = fk.kernel_bwd_fused_cuda(x, g, v, kt, need_dv=need_dv, need_dos=True)
                rdv, rdx, rdos = fk._bwd_fused_reference(x64, g64, v64, kt, need_dv=need_dv, need_dos=True)
                errs = [((dx.double() - rdx).abs().max(), bx.max()), ((dos.double() - rdos).abs(), bdos)]
                if need_dv:
                    errs.append(((dv.double() - rdv).abs().max(), bdv.max()))
                for err, scale in errs:
                    max_abs, rel_ = max(max_abs, err.item()), (err / scale).item()
                    worst_rel = max(worst_rel, rel_)
                    check(rel_ <= BWD_REL_TOL, f"backward kernel type {kt}, d={WIDE_D}, t={t}, need_dv={need_dv}: "
                                               f"relative error {rel_:.3e} > {BWD_REL_TOL}")
    print(f"[bwd] wide tier: n=517 d={WIDE_D} t∈{{1,40}}, four kernel types, dv on/off, dos, within {BWD_REL_TOL} "
          f"(worst so far {worst_rel:.3e})", flush=True)
    n, t = WIDE_N, 64
    x = torch.as_tensor(rng.uniform(size=(n, WIDE_D)) / (0.3 * math.sqrt(WIDE_D / D)), dtype=torch.float32, device=dev)
    g, v = (torch.as_tensor(rng.normal(size=(n, t)), dtype=torch.float32, device=dev) for _ in range(2))
    _, dx, dos = fk.kernel_bwd_fused_cuda(x, g, v, fk.RBF, need_dv=False, need_dos=True)
    _, edx, edos = fk._bwd_fused_reference(x.double(), g.double(), v.double(), fk.RBF, need_dv=False, need_dos=True)
    err_dx, err_dos = (dx.double() - edx).abs().max().item(), abs(dos.double() - edos).item()
    rel_w = max(err_dx / edx.abs().max().item(), err_dos / abs(edos.item()))
    max_abs = max(max_abs, err_dx, err_dos)
    check(rel_w <= BWD_TRAIN_TOL, f"wide-tier backward {n}x{n} d={WIDE_D}: relative error {rel_w:.3e} > {BWD_TRAIN_TOL}")
    wide_ms = cuda_time_ms(lambda: fk.kernel_bwd_fused_cuda(x, g, v, fk.RBF, need_dv=False, need_dos=True), 3)
    wide_plain_ms = cuda_time_ms(lambda: fk._bwd_fused_reference(x, g, v, fk.RBF, need_dv=False, need_dos=True), 2)
    bms, by = bwd_bound(n, WIDE_D, t)
    print(f"[bwd] wide tier {n}x{n} d={WIDE_D} t={t} (dos, no dv): kernel {wide_ms:.3f} ms, plain {wide_plain_ms:.3f} ms, "
          f"bound {bms:.3f} ms ({by}); against float64 max of |Δdx| / max |dx| and |Δdos| / |dos| {rel_w:.3e} "
          f"(tol {BWD_TRAIN_TOL})", flush=True)
    return max_abs, ms, plain_ms


def _grad_x_abs_terms(x1, x2, g, v, kt):
    """Sum of absolute terms of the grad_x kernel's output, 2 Σ_j |k′(d2_ij)||g_i·v_j||x1_i − x2_j|,
    dense, float64."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    diff = x1[:, None, :] - x2[None, :, :]
    w = fk._kernel_prime((diff * diff).sum(-1), kt).abs() * (g @ v.mT).abs()
    return 2.0 * torch.einsum("ij,ijk->ik", w, diff.abs())


def phase_grad_x():
    """The grad_x kernel against its plain version on the card: float32 against float32 for
    the four kernel types, d ∈ {3, 11}, t ∈ {1, 20, 33, 64, 100, 128, 129} (the tensor-core
    tier's edges), at ragged n ≪ m and n ≫ m; at the path's shapes on the flagship task
    (2,048 candidates against the 100k training points, scaled by the fitted lengthscales,
    both ways: dx1 and dx2, at t = 1 and 100) against float64, and timed there.  Returns
    (max_abs_err, {(n, m, t): (ms, plain_ms)})."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    rng = np.random.default_rng(7)
    dev = "cuda"

    def data(*shapes):
        return tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev) for s in shapes)

    max_abs, worst = 0.0, 0.0
    for kt in fk.KERNEL_TYPES:
        for d in (3, 11):
            for t in GX_TIER_T:
                for n, m in ((300, 1537), (1537, 300)):
                    x1, x2, g, v = data((n, d), (m, d), (n, t), (m, t))
                    got = fk.kernel_grad_x_cuda(x1, x2, g, v, kt)
                    err = (got.double() - fk._grad_x_reference(x1, x2, g, v, kt).double()).abs().max().item()
                    rel = err / _grad_x_abs_terms(x1.double(), x2.double(), g.double(), v.double(), kt).max().item()
                    max_abs, worst = max(max_abs, err), max(worst, rel)
                    check(rel <= GX_REL_TOL, f"grad_x kernel type {kt}, d={d}, t={t}, {n}x{m}: relative error "
                                             f"{rel:.3e} > {GX_REL_TOL}")
                    if 32 < t <= 128:  # the tensor-core tier: no atomics, so a rerun repeats it
                        check(torch.equal(got, fk.kernel_grad_x_cuda(x1, x2, g, v, kt)),
                              f"grad_x kernel type {kt}, d={d}, t={t}, {n}x{m}: a rerun differs")
        ts = ",".join(map(str, GX_TIER_T))
        print(f"[grad-x] type {kt}: 300x1537 and 1537x300, d∈{{3,11}} t∈{{{ts}}} within {GX_REL_TOL} of the float32 "
              f"plain version, the tensor-core tier rerun bit for bit (worst so far {worst:.3e})", flush=True)

    # the path's shapes: dx1 of K(candidates, train)·v for v = the mean cache (t=1) and the
    # LOVE root (t=100), and dx2 (the training side, with the parameters live)
    train_x, _, test_x, _ = make_task(N_TRAIN, N_TEST, seed=0)
    ls = np.log1p(np.exp(np.asarray(JAX_PARAMS["covar_module.base_kernel.raw_lengthscale"])))  # softplus
    xt = torch.as_tensor(train_x / ls, dtype=torch.float32, device=dev)
    xq = torch.as_tensor(test_x / ls, dtype=torch.float32, device=dev)
    timed = {}
    for x1, x2 in ((xq, xt), (xt, xq)):
        n, m = x1.shape[0], x2.shape[0]
        for t in (1, 100):
            g, v = data((n, t), (m, t))
            got = fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF)
            slabs = fk.kernel_grad_x_cuda.last_slabs
            exact = fk._grad_x_reference(x1.double(), x2.double(), g.double(), v.double(), fk.RBF)
            err = (got.double() - exact).abs().max().item()
            rel = err / exact.abs().max().item()
            plain_rel = (fk._grad_x_reference(x1, x2, g, v, fk.RBF).double() - exact).abs().max().item() / exact.abs().max().item()
            max_abs = max(max_abs, err)
            del exact
            check(rel <= GX_PATH_TOL, f"grad_x kernel {n}x{m} t={t} against float64: {rel:.3e} > {GX_PATH_TOL}")
            if t > 32:  # the tensor-core tier
                check(rel <= 2 * plain_rel, f"grad_x kernel {n}x{m} t={t} against float64: {rel:.3e}, over twice the "
                                            f"plain float32 version's {plain_rel:.3e}")
                check(torch.equal(got, fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF)),
                      f"grad_x {n}x{m} t={t}: a rerun differs")
            ms = cuda_time_ms(lambda: fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF), 10)
            plain_ms = cuda_time_ms(lambda: fk._grad_x_reference(x1, x2, g, v, fk.RBF), 3)
            timed[(n, m, t)] = (ms, plain_ms)
            bms, by = grad_x_bound(n, m, D, t)
            tc = ""
            if t > 32:
                tms, tby = grad_x_tc_bound(n, m, D, t)
                # the tier's staging of the block's rows and its epilogue, alone: one staged tile
                # of rows j; and t = 128, which runs all 16 k-steps where t = 100 runs 13
                stage_ms = cuda_time_ms(lambda: fk.kernel_grad_x_cuda(x1, x2[:32], g, v[:32], fk.RBF), 10)
                g128, v128 = data((n, 128), (m, 128))
                ms128 = cuda_time_ms(lambda: fk.kernel_grad_x_cuda(x1, x2, g128, v128, fk.RBF), 10)
                del g128, v128
                tc = (f", tensor-core bound {tms:.3f} ms ({tby}, {tms / ms:.0%}); one staged tile of rows j (staging "
                      f"and epilogue) {stage_ms:.4f} ms; t=128 (16 k-steps) {ms128:.3f} ms")
            print(f"[grad-x] {n}x{m} d={D} t={t}: {slabs} slabs of the j range; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, FP32 bound {bms:.3f} ms ({by}, {bms / ms:.0%}){tc}; {n * m:.3e} pairs; against "
                  f"float64 max |Δ| / max |·|: kernel {rel:.3e}, plain float32 {plain_rel:.3e} (tol {GX_PATH_TOL})",
                  flush=True)

    # the wide-d tier (d > 64): the four kernel types at ragged n ≪ m and n ≫ m, t = 1 and
    # 40, against the float32 plain version; then a 2048-row strip against WIDE_N rows at
    # t = 100 against float64, timed there
    for kt in fk.KERNEL_TYPES:
        for t in (1, 40):
            for n, m in ((300, 517), (517, 300)):
                x1, x2, g, v = data((n, WIDE_D), (m, WIDE_D), (n, t), (m, t))
                x1, x2 = x1 / math.sqrt(WIDE_D), x2 / math.sqrt(WIDE_D)
                got = fk.kernel_grad_x_cuda(x1, x2, g, v, kt)
                err = (got.double() - fk._grad_x_reference(x1, x2, g, v, kt).double()).abs().max().item()
                rel = err / _grad_x_abs_terms(x1.double(), x2.double(), g.double(), v.double(), kt).max().item()
                max_abs, worst = max(max_abs, err), max(worst, rel)
                check(rel <= GX_REL_TOL, f"grad_x kernel type {kt}, d={WIDE_D}, t={t}, {n}x{m}: relative error "
                                         f"{rel:.3e} > {GX_REL_TOL}")
    print(f"[grad-x] wide tier: 300x517 and 517x300, d={WIDE_D} t∈{{1,40}}, four kernel types, within {GX_REL_TOL} of "
          f"the float32 plain version (worst so far {worst:.3e})", flush=True)
    n, m, t = N_TEST, WIDE_N, 100
    x1, x2 = (torch.as_tensor(rng.uniform(size=(r, WIDE_D)) / (0.3 * math.sqrt(WIDE_D / D)), dtype=torch.float32,
                              device=dev) for r in (n, m))
    g, v = data((n, t), (m, t))
    got = fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF)
    exact = fk._grad_x_reference(x1.double(), x2.double(), g.double(), v.double(), fk.RBF)
    err = (got.double() - exact).abs().max().item()
    rel = err / exact.abs().max().item()
    max_abs = max(max_abs, err)
    del exact
    check(rel <= GX_PATH_TOL, f"wide-tier grad_x {n}x{m} d={WIDE_D} t={t} against float64: {rel:.3e} > {GX_PATH_TOL}")
    ms = cuda_time_ms(lambda: fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF), 5)
    plain_ms = cuda_time_ms(lambda: fk._grad_x_reference(x1, x2, g, v, fk.RBF), 2)
    timed[("wide", n, m, t)] = (ms, plain_ms)
    bms, by = grad_x_bound(n, m, WIDE_D, t)
    print(f"[grad-x] wide tier {n}x{m} d={WIDE_D} t={t}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.3f} ms "
          f"({by}); against float64 max |Δ| / max |·| {rel:.3e} (tol {GX_PATH_TOL})", flush=True)
    return max_abs, timed


def _periodic_abs_terms(x1, x2, w, v, g=None):
    """Sums of absolute terms, dense and float64: of the periodic product (K|v|) without
    ``g``, else of the fused backward's (dv, dx, dw, dos) with x1 = x2."""
    import torch

    f1, f2 = x1 - torch.round(x1), x2 - torch.round(x2)
    diff = f1[:, None, :] - f2[None, :, :]
    S = torch.sin(torch.pi * diff)
    K = torch.exp(-2.0 * (w * S * S).sum(-1))
    if g is None:
        return K @ v.abs()
    gg = K * ((g @ v.mT).abs() + (v @ g.mT).abs())
    dx = 4.0 * torch.pi * w * torch.einsum("ij,ijk->ik", gg, (S * torch.cos(torch.pi * diff)).abs())
    return K @ g.abs(), dx, torch.einsum("ij,ijk->k", gg, S * S), 0.5 * gg.sum()


def phase_periodic_kernels():
    """Both periodic kernels against their plain versions on the card: float32 against
    float32 over the grid (ragged n ≠ m for the product, symmetric n for the backward), and
    at the path's shapes on the task (N=100k, a = t / period up to 355) against float64;
    both timed at the path's shapes.  Returns (product max_abs_err, {(n, m, t): (ms,
    plain_ms)}, [strip readings], backward max_abs_err, ms, plain_ms)."""
    import torch

    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    rng = np.random.default_rng(6)
    dev = "cuda"

    def data(*shapes):
        return tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev) for s in shapes)

    mv_abs = bwd_abs = worst_mv = worst_bwd = 0.0
    for d in (1, 2, 3, 11):
        w = torch.as_tensor(rng.uniform(0.5, 4.0, size=d), dtype=torch.float32, device=dev)
        for t in (1, 20, 64, 100):
            x1, x2 = (torch.as_tensor(rng.uniform(0.0, 355.0, size=(n, d)), dtype=torch.float32, device=dev)
                      for n in (1000, 1537))
            (v,) = data((1537, t))
            got, plain = ppk.periodic_matvec_cuda(x1, x2, w, v), ppk._periodic_matvec_reference(x1, x2, w, v)
            err = (got.double() - plain.double()).abs().max().item()
            rel = err / _periodic_abs_terms(x1.double(), x2.double(), w.double(), v.double()).max().item()
            mv_abs, worst_mv = max(mv_abs, err), max(worst_mv, rel)
            check(rel <= P_KERNEL_REL_TOL, f"periodic product d={d}, t={t}: relative error {rel:.3e} > {P_KERNEL_REL_TOL}")

            g, v = data((1537, t), (1537, t))
            plain = ppk._periodic_bwd_fused_reference(x2, w, g, v, True, True)
            scales = _periodic_abs_terms(x2.double(), x2.double(), w.double(), v.double(), g.double())
            # the FMA tier at t = 1, 20, 100, the tensor-core tier at t = 64; dv, where
            # asked for, is one product besides
            for need_dv in (False, True):
                got = ppk.periodic_bwd_fused_cuda(x2, w, g, v, need_dv, True)
                for name, a, b, scale in zip(("dv", "dx", "dw", "dos"), got, plain, scales):
                    if a is None:
                        continue
                    err = (a.double() - b.double()).abs().max().item()
                    rel = err / scale.max().item()
                    bwd_abs, worst_bwd = max(bwd_abs, err), max(worst_bwd, rel)
                    check(rel <= P_KERNEL_REL_TOL, f"periodic backward d={d}, t={t}, dv {need_dv}, {name}: relative "
                                                   f"error {rel:.3e} > {P_KERNEL_REL_TOL}")
        print(f"[periodic-kernel] d={d}: product n=1000 m=1537 and backward n=1537 (dx, dw, dos, without and with "
              f"dv; at t=64 the tensor-core tier), t∈{{1,20,64,100}}, within "
              f"{P_KERNEL_REL_TOL} of the float32 plain versions (worst so far: product {worst_mv:.3e}, backward "
              f"{worst_bwd:.3e})", flush=True)

    # the path's shapes on the task: training CG (t=64), serving CG (t=1), Lanczos (t=20),
    # K(test, train)·R (t=100); then the forecast's mean K(test, train)·α (t=1) and the
    # strips of a request of 256 points, whose v come from a generator of their own; one
    # backward per training step (t=64).  The strips split the j range into slabs
    # (fk.product_slabs); the 2048-row ones are gated against float64 at twice the plain
    # float32 version's error
    train_x, _, test_x, _ = make_periodic_task(P_N_TRAIN, P_N_TEST)
    per = torch.tensor(P_PERIODS, dtype=torch.float32, device=dev)
    xp = torch.as_tensor(train_x, dtype=torch.float32, device=dev) / per
    xq = torch.as_tensor(test_x, dtype=torch.float32, device=dev) / per
    w = torch.full((P_D,), 4.0, dtype=torch.float32, device=dev)  # lengthscale 0.5
    N = P_N_TRAIN
    timed, strips = {}, []
    strip_rng = np.random.default_rng(16)
    xr = xq[:REQUEST_ROWS].contiguous()
    for x1, t in ((xp, 64), (xp, 1), (xp, 20), (xq, 100), (xq, 1), (xr, 100), (xr, 1)):
        n = x1.shape[0]
        if n < N and (n, t) != (P_N_TEST, 100):
            v = torch.as_tensor(strip_rng.normal(size=(N, t)), dtype=torch.float32, device=dev)
        else:
            (v,) = data((N, t))
        got = ppk.periodic_matvec_cuda(x1, xp, w, v)
        exact = ppk._periodic_matvec_reference(x1.double(), xp.double(), w.double(), v.double())
        scale = exact.abs().max().item()
        err = (got.double() - exact).abs().max().item()
        rel = err / scale
        mv_abs = max(mv_abs, err)
        check(rel <= P_PATH_TOL, f"periodic product {n}x{N} t={t} against float64: {rel:.3e} > {P_PATH_TOL}")
        if t == 64 or n == P_N_TEST:  # the training product (tensor cores) and the 2048-row strips (the
            # LOVE root in 32-column tiles summed per staged tile, the mean): both float32 versions against float64
            plain64 = (ppk._periodic_matvec_reference(x1, xp, w, v).double() - exact).abs().max().item() / scale
            print(f"[periodic-kernel] product {n}x{N} t={t} against float64, max |Δ| / max |·|: kernel {rel:.3e}, "
                  f"plain float32 {plain64:.3e}", flush=True)
            check(rel <= min(2.0 * plain64, P_PATH_TOL), f"periodic product {n}x{N} t={t} against float64: {rel:.3e}, "
                  f"more than twice the plain version's {plain64:.3e} or over {P_PATH_TOL}")
        del exact
        ms = cuda_time_ms(lambda: ppk.periodic_matvec_cuda(x1, xp, w, v), 10 if t < 64 else 5)
        slabs = ppk.periodic_matvec_cuda.last_slabs
        plain_ms = cuda_time_ms(lambda: ppk._periodic_matvec_reference(x1, xp, w, v), 2)
        timed[(n, N, t)] = (ms, plain_ms)
        bound = periodic_matvec_tc_bound(n, N, P_D, t) if 32 < t <= 64 else periodic_matvec_bound(n, N, P_D, t)
        print(f"[periodic-kernel] product {n}x{N} d={P_D} t={t}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}), against float64 max |Δ| / max |·| {rel:.3e} (tol {P_PATH_TOL})",
              flush=True)
        if n < N:
            strips.append(strip_entry(n, N, t, slabs, ms, plain_ms, bound))
            print_strip("periodic-kernel", strips[-1])

    bwd_err, bwd_ms, bwd_plain_ms = periodic_bwd_at_path(xp, w)
    bwd_abs = max(bwd_abs, bwd_err)

    # the product's wide-d tier (d > 64; the fused backward takes d ≤ 64, as the JAX
    # package's): ragged n ≠ m at t = 1 and 64 against the float32 plain version, weights
    # over d so that Σ w sin² stays O(1); then WIDE_N × WIDE_N at t = 64 against float64,
    # timed there
    for t in (1, 64):
        w = torch.as_tensor(rng.uniform(0.5, 4.0, size=WIDE_D) / WIDE_D, dtype=torch.float32, device=dev)
        x1, x2 = (torch.as_tensor(rng.uniform(0.0, 355.0, size=(r, WIDE_D)), dtype=torch.float32, device=dev)
                  for r in (1000, 1537))
        (v,) = data((1537, t))
        got, plain = ppk.periodic_matvec_cuda(x1, x2, w, v), ppk._periodic_matvec_reference(x1, x2, w, v)
        err = (got.double() - plain.double()).abs().max().item()
        rel = err / ppk._periodic_matvec_reference(x1.double(), x2.double(), w.double(), v.double().abs()).max().item()
        mv_abs, worst_mv = max(mv_abs, err), max(worst_mv, rel)
        check(rel <= P_KERNEL_REL_TOL, f"periodic product d={WIDE_D}, t={t}: relative error {rel:.3e} > {P_KERNEL_REL_TOL}")
    n, t = WIDE_N, 64
    w = torch.as_tensor(rng.uniform(0.5, 4.0, size=WIDE_D) / WIDE_D, dtype=torch.float32, device=dev)
    x = torch.as_tensor(rng.uniform(0.0, 355.0, size=(n, WIDE_D)), dtype=torch.float32, device=dev)
    (v,) = data((n, t))
    got = ppk.periodic_matvec_cuda(x, x, w, v)
    # the plain version holds d (chunk, n) matrices: chunks of 256 rows keep them to 3.4 GB
    exact = ppk._periodic_matvec_reference(x.double(), x.double(), w.double(), v.double(), chunk=256)
    err = (got.double() - exact).abs().max().item()
    rel = err / exact.abs().max().item()
    mv_abs = max(mv_abs, err)
    del exact
    check(rel <= P_PATH_TOL, f"wide-tier periodic product {n}x{n} d={WIDE_D} against float64: {rel:.3e} > {P_PATH_TOL}")
    ms = cuda_time_ms(lambda: ppk.periodic_matvec_cuda(x, x, w, v), 3)
    plain_ms = cuda_time_ms(lambda: ppk._periodic_matvec_reference(x, x, w, v, chunk=256), 1)
    timed[("wide", n, n, t)] = (ms, plain_ms)
    bms, by = periodic_matvec_bound(n, n, WIDE_D, t)
    print(f"[periodic-kernel] product wide tier: n=1000 m=1537 d={WIDE_D} t∈{{1,64}} within {P_KERNEL_REL_TOL} of the "
          f"float32 plain version (worst product so far {worst_mv:.3e}); {n}x{n} t={t}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by}), against float64 max |Δ| / max |·| {rel:.3e} (tol {P_PATH_TOL})",
          flush=True)
    return mv_abs, timed, strips, bwd_abs, bwd_ms, bwd_plain_ms


def periodic_bwd_at_path(xp=None, w=None):
    """The fused periodic backward's training call (dx, dw and dos, no dv; the tensor-core
    tier) at N=100k on the periodic task's inputs ``xp`` (x / period) with weights ``w``,
    on random g and v (t = 64): against float64 beside the plain float32 version, gated at
    twice the plain version's error and ``P_PATH_TOL``; timed beside its bounds and the
    plain version.  Returns (max_abs_err, ms, plain_ms).  Phase 3c calls it; alone (phase
    8's inputs, about a minute after the build):

        python3 -c 'import chip_smoke; chip_smoke.periodic_bwd_at_path()'
    """
    import torch

    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    dev = "cuda"
    if xp is None:
        phase_device()
        train_x, _, _, _ = make_periodic_task(P_N_TRAIN, P_N_TEST)
        xp = torch.as_tensor(train_x, dtype=torch.float32, device=dev) / torch.tensor(P_PERIODS, device=dev)
        w = torch.full((P_D,), 4.0, dtype=torch.float32, device=dev)  # lengthscale 0.5
    n, t = xp.shape[0], 64
    rng = np.random.default_rng(7)
    g, v = (torch.as_tensor(rng.normal(size=(n, t)), dtype=torch.float32, device=dev) for _ in range(2))
    exact = ppk._periodic_bwd_fused_reference(xp.double(), w.double(), g.double(), v.double(), False, True)

    def rel(out):
        return [(a.double() - b).abs().max().item() / b.abs().max().item() for a, b in zip(out[1:], exact[1:])]

    got = ppk.periodic_bwd_fused_cuda(xp, w, g, v, False, True)
    rels = rel(got)
    plain_rels = rel(ppk._periodic_bwd_fused_reference(xp, w, g, v, False, True))
    err = max((a.double() - b).abs().max().item() for a, b in zip(got[1:], exact[1:]))
    del exact
    ms = cuda_time_ms(lambda: ppk.periodic_bwd_fused_cuda(xp, w, g, v, False, True), 3)
    plain_ms = cuda_time_ms(lambda: ppk._periodic_bwd_fused_reference(xp, w, g, v, False, True), 1)
    bms, by = periodic_bwd_tc_bound(n, P_D, t)
    fp32_ms, _ = periodic_bwd_bound(n, P_D, t)

    def fmt(r):
        return ", ".join(f"{x:.3e}" for x in r)

    print(f"[periodic-kernel] backward {n}x{n} d={P_D} t={t}, dx, dw and dos (the tensor-core tier): kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}; on the FP32 cores {fp32_ms:.3f} ms); against float64, "
          f"max |Δ| / max |·| of dx, dw, dos: kernel {fmt(rels)}, plain float32 {fmt(plain_rels)} (gate: twice the "
          f"plain version's, and {P_PATH_TOL})", flush=True)
    for name, r, p in zip(("dx", "dw", "dos"), rels, plain_rels):
        check(r <= min(2.0 * p, P_PATH_TOL), f"periodic backward at the training shape, {name}, against float64: "
                                             f"{r:.3e}, more than twice the plain version's {p:.3e} or over {P_PATH_TOL}")
    return err, ms, plain_ms


def phase_slice(periodic=False):
    """Serving at N=2000 on CPU tensors (plain path) against CUDA tensors (kernel path):
    the flagship from JAX_PARAMS, or the periodic model at its initial values.  For the
    flagship, also LOVE sampling (``fast_pred_samples``) of the 512 points on both devices
    from the same base samples (``InjectedProbes``) and Lanczos start block, with a CPU
    float64 run beside them."""
    import torch

    tag = "periodic-slice" if periodic else "slice"
    n, n_test = 2000, 512
    task = make_periodic_task if periodic else make_task
    train_x, train_y, test_x, _ = task(n, n_test, seed=2)
    batches = [slice(0, n_test)]
    out, drawn = {}, {}
    from gpytorch_tpu_torch import settings

    with eval_settings(min_preconditioning_size=1000), settings.eval_cg_tolerance(SLICE_CG_TOL):
        for device in ("cpu", "cuda"):
            if periodic:
                model = build_periodic_model(train_x, train_y, device, torch.float32).eval()
            else:
                model = build_model(train_x, train_y, device, torch.float32)
            tx = torch.as_tensor(test_x, dtype=torch.float32, device=device)
            cg, _, answers = serve(model, tx, device, batches)
            _, mean, var, _ = answers[0]
            out[device] = (mean.cpu().double(), var.cpu().double(), cg.num_iters)
            if not periodic:
                drawn[device] = _love_samples(model, tx)
        if not periodic:
            drawn["float64"] = _love_samples(build_model(train_x, train_y, "cpu", torch.float64),
                                             torch.as_tensor(test_x, dtype=torch.float64))
    (m_cpu, v_cpu, it_cpu), (m_gpu, v_gpu, it_gpu) = out["cpu"], out["cuda"]
    dm = ((m_cpu - m_gpu).abs().max() / m_cpu.abs().max()).item()
    dv = ((v_cpu - v_gpu).abs().max() / v_cpu.abs().max()).item()
    print(f"[{tag}] N={n} test={n_test}: CG iters cpu {it_cpu} cuda {it_gpu}; mean rel diff {dm:.3e} "
          f"(tol {SLICE_MEAN_TOL}), var rel diff {dv:.3e} (tol {SLICE_VAR_TOL})", flush=True)
    check(dm <= SLICE_MEAN_TOL, f"{tag} mean differs: {dm:.3e}")
    check(dv <= SLICE_VAR_TOL, f"{tag} variance differs: {dv:.3e}")
    if periodic:
        return

    def gaps(ref, got):
        return [((a - b).abs().max() / a.abs().max()).item() for a, b in zip(ref, got)]

    (dd, dc, dmean), (fd, fc, fmean) = gaps(drawn["cpu"], drawn["cuda"]), gaps(drawn["float64"], drawn["cpu"])
    print(f"[{tag}] LOVE sampling, {SAMPLES} draws of the {n_test} points: CPU against CUDA, max |Δ| / max |·| of "
          f"R_s R_sᵀ {dc:.3e} (tol {SLICE_SAMPLE_TOL}), of the mean {dmean:.3e} (tol {SLICE_MEAN_TOL}), of the draws "
          f"{dd:.3e} (read, not gated); CPU float32 against float64: R_s R_sᵀ {fc:.3e}, mean {fmean:.3e}, draws {fd:.3e}",
          flush=True)
    check(all(bool(torch.isfinite(drawn[k][0]).all()) for k in drawn), f"{tag}: LOVE samples not finite")
    check(dc <= SLICE_SAMPLE_TOL, f"{tag}: the sample root differs between CPU and CUDA: {dc:.3e}")
    check(dmean <= SLICE_MEAN_TOL, f"{tag}: the sampled posterior's mean differs between CPU and CUDA: {dmean:.3e}")


def _love_samples(model, x):
    """(draws, R_s R_sᵀ, mean) of the eval-mode ``model`` at ``x`` under
    ``fast_pred_samples``: SAMPLES draws from ``InjectedProbes`` base samples, on the CPU in
    float64.  The sample root's Lanczos run starts from the seeded CPU block, the same on
    every device."""
    import torch

    from gpytorch_tpu_torch import settings

    with settings.fast_pred_samples(True), torch.no_grad():
        model.refresh()
        post = model(x)
        draws = post.rsample((SAMPLES,), base_samples=InjectedProbes(0, SAMPLE_SEED))
        root = post.lazy_covariance_matrix.root.double().cpu()
        return draws.double().cpu(), root @ root.mT, post.mean.double().cpu()


def _per_key_gap(ref, got):
    """max over keys of max |Δ| / max |ref| (each gradient over its own largest)."""
    return max((ref[k] - got[k]).abs().max().item() / ref[k].abs().max().item() for k in ref)


def phase_grad_slice(periodic=False):
    """The gradient of ΣUCB at N=2000 on CPU tensors (plain path) against CUDA tensors
    (kernel path), from the same data, parameters and Lanczos start: with the parameters
    frozen (dx1 of each product) and live (dx1, dx2 and dos).  The gate sits above a CPU
    float32-against-float64 reading and below a planted fault, which it must see: the last
    sixteenth of the j range dropped from the plain ``_grad_x_reference`` (flagship, from
    JAX_PARAMS) or, for the periodic model at its initial values on the forecast week, from
    the plain general backward ``_periodic_backward_reference`` (plain on both devices;
    on the card its products and the outputscale's dos = Σ g ⊙ (K v) launch the periodic
    K·V kernel)."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    tag = "periodic-grad-slice" if periodic else "grad-slice"
    n, n_test = 2000, 512
    train_x, train_y, test_x, _ = (make_periodic_task if periodic else make_task)(n, n_test, seed=2)

    def run(device, dtype, live):
        if periodic:
            model = build_periodic_model(train_x, train_y, device, dtype).eval()
        else:
            model = build_model(train_x, train_y, device, dtype)
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(live)
        x = torch.as_tensor(test_x, dtype=dtype, device=device)
        with eval_settings(min_preconditioning_size=1000), settings.eval_cg_tolerance(SLICE_CG_TOL):
            model.refresh()
            grad, pgrads, _, _ = ucb_gradient(model, x, params.values() if live else ())
        out = {"candidates": grad}
        out.update({k: g for k, g in zip(params, pgrads) if g is not None})
        return {k: g.detach().cpu().double() for k, g in out.items()}

    module, name = (ppk, "_periodic_backward_reference") if periodic else (fk, "_grad_x_reference")
    sound = getattr(module, name)

    def planted(x1, x2, *args, **kwargs):
        keep = x2.shape[0] - x2.shape[0] // 16
        if not periodic:
            g, v, kernel_type = args
            return sound(x1, x2[:keep], g, v[:keep], kernel_type, **kwargs)
        w, g, v = args  # the rows j past keep add nothing to dx1, dx2 and dw
        return sound(x1, x2, w, g, torch.cat((v[:keep], torch.zeros_like(v[keep:]))), **kwargs)

    for live in (False, True):
        cpu, gpu = run("cpu", torch.float32, live), run("cuda", torch.float32, live)
        gap, floor = _per_key_gap(cpu, gpu), _per_key_gap(run("cpu", torch.float64, live), cpu)
        setattr(module, name, planted)
        try:
            fault = _per_key_gap(cpu, run("cpu", torch.float32, live))
        finally:
            setattr(module, name, sound)
        label = "parameters live" if live else "parameters frozen"
        print(f"[{tag}] N={n} candidates={n_test}, {label} ({', '.join(cpu)}): CPU against CUDA max |Δ∇| / max "
              f"|∇| {gap:.3e} (tol {GX_SLICE_TOL}; cpu float32 against float64 {floor:.3e}, against a planted fault "
              f"{fault:.3e})", flush=True)
        check(gap <= GX_SLICE_TOL, f"{tag} ({label}): CPU and CUDA gradients differ: {gap:.3e}")
        check(fault > GX_SLICE_TOL, f"the {tag} gate ({label}) does not see a planted fault: {fault:.3e}")


def phase_serve():
    """Full-width serving; returns the kernel launch count of the main path."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    model = build_model(train_x, train_y, dev, torch.float32)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)
    batches = [slice(i * REQUEST_ROWS, (i + 1) * REQUEST_ROWS) for i in range(N_REQUESTS)] + [slice(0, N_TEST)]
    torch.cuda.reset_peak_memory_stats()
    with eval_settings():
        fk.kernel_matvec_cuda.launches = 0
        cg, refresh_s, answers = serve(model, tx, dev, batches)
        launches = fk.kernel_matvec_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    resid = cg.residual_norm.max().item()
    print(f"[serve] refresh (mean cache + LOVE cache): {refresh_s:.3f} s, CG {cg.num_iters} iterations, "
          f"relative residual {resid:.3e}", flush=True)
    for i, (_, mean, var, secs) in enumerate(answers):
        print(f"[serve] request {i}: {mean.shape[0]} points in {secs * 1e3:.2f} ms", flush=True)
        check(bool(torch.isfinite(mean).all()), f"request {i}: non-finite mean")
        check(bool(torch.isfinite(var).all()) and bool((var > 0).all()), f"request {i}: variance not finite and > 0")
    print_request_ms("serve", [a[3] for a in answers])
    pred, mean, var, _ = answers[-1]
    rmse = gt.metrics.mean_squared_error(pred, ty, squared=False).item()
    noise = model.likelihood.noise.reshape(-1)[0]
    nlpd = marginal_nlpd(mean, var, ty, noise)
    # what the main path should have launched: one K·V per CG iteration, one per Lanczos
    # block (5 blocks of 20), and per request one for the mean and one for the LOVE root
    expected = cg.num_iters + 5 + 2 * len(batches)
    print(f"[serve] rmse {rmse:.4f} (limit {RMSE_LIMIT}), marginal nlpd {nlpd:.4f}, noise {noise.item():.4f}, "
          f"variance range [{var.min().item():.4e}, {var.max().item():.4e}]", flush=True)
    print(f"[serve] peak device memory {peak / 2**20:.1f} MiB, kernel launches {launches} (expected {expected})", flush=True)
    # true residual of the mean cache, in float64 (after the launch count was read)
    true_res = true_residuals(model, model.prediction_strategy().mean_cache)[0]
    print(f"[serve] true relative residual of the mean cache (float64): {true_res:.3e} (limit {TRUE_RES_LIMIT})",
          flush=True)
    check(launches > 0, "the main path launched the CUDA kernel no time")
    check(launches == expected, f"kernel launches {launches} != expected {expected}")
    check(rmse <= RMSE_LIMIT, f"rmse {rmse:.4f} > {RMSE_LIMIT}")
    check(true_res <= TRUE_RES_LIMIT, f"mean cache true residual {true_res:.3e} > {TRUE_RES_LIMIT}")
    return launches


def _float64_copy(model):
    """A float64 copy of an exact ``model`` (parameters, buffers and training data), without
    its caches, in eval mode."""
    import copy

    held = {name: model.__dict__[name] for name in ("_cache", "train_inputs", "train_targets", "lanczos_init")}
    model.__dict__.update(_cache={}, train_inputs=None, train_targets=None, lanczos_init=None)
    try:
        twin = copy.deepcopy(model)
    finally:
        model.__dict__.update(held)
    twin.train_inputs = tuple(x.double() for x in model.train_inputs)
    twin.train_targets = model.train_targets.double()
    return twin.double().eval()


def true_residuals(model, cache) -> list:
    """‖(y − μ) − K̂u‖ / ‖y − μ‖ of a mean cache u of the eval-mode exact ``model``'s
    training system K̂ (the likelihood's marginal over the training data), per batch
    element, in float64 through the plain kernels on the model's device."""
    import torch

    twin = _float64_copy(model)
    with plain_kernels(), torch.no_grad():
        strategy = twin.prediction_strategy()
        diff = strategy.train_labels - strategy.train_prior_dist.loc
        res = diff.unsqueeze(-1) - strategy.lik_train_train_covar.matmul(cache.double().unsqueeze(-1))
        return (res.squeeze(-1).norm(dim=-1) / diff.norm(dim=-1)).reshape(-1).tolist()


def phase_refine():
    """Phase 5's mean cache built again under ``solve_iterative_refinements`` 1 and 2 (and
    0, phase 5's own solve, as the reference): each refresh's CG iterations over all
    passes, its time, its kernel_matvec launches (one a CG iteration and one residual
    product a pass), the float64 true residual and the RMSE of the 2,048 test means.
    Returns the launches of the refined refreshes."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    model = build_model(train_x, train_y, dev, torch.float32)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)
    readings, launches = {}, 0
    for passes in (0, *REFINE_PASSES):
        model.clear_caches()
        # the mean cache alone: no LOVE cache, and the request reads only the means
        with eval_settings(), settings.fast_pred_var(False), settings.skip_posterior_variances(True), \
                settings.solve_iterative_refinements(passes):
            fk.kernel_matvec_cuda.launches = 0
            sync(dev)
            t0 = time.perf_counter()
            strategy = model.refresh()
            sync(dev)
            secs = time.perf_counter() - t0
            count = fk.kernel_matvec_cuda.launches
            with torch.no_grad():
                rmse = gt.metrics.mean_squared_error(model(tx), ty, squared=False).item()
        cg = strategy.lik_train_train_covar.last_cg_result
        res = true_residuals(model, strategy.mean_cache)[0]
        readings[passes] = (res, cg.num_iters, secs, rmse)
        launches += count if passes else 0
        print(f"[refine] solve_iterative_refinements({passes}): refresh {secs:.3f} s, CG {cg.num_iters} iterations over "
              f"{passes + 1} solve(s), kernel_matvec {count} launches (expected {cg.num_iters + passes}); true relative "
              f"residual (float64) {res:.3e}, CG's estimate {cg.residual_norm.max().item():.3e}; rmse {rmse:.6f}",
              flush=True)
        check(count == cg.num_iters + passes, f"refinement {passes}: kernel_matvec launched {count} times, expected "
                                              f"{cg.num_iters + passes}")
    base = readings[0]
    for passes in REFINE_PASSES:
        res, iters, secs, rmse = readings[passes]
        print(f"[refine] {passes} pass(es) against none: residual {base[0]:.3e} → {res:.3e}, CG {base[1]} → {iters}, "
              f"refresh {base[2]:.3f} → {secs:.3f} s, rmse change {rmse - base[3]:+.3e}", flush=True)
        check(res <= base[0], f"refinement {passes}: true residual {res:.3e} above the unrefined {base[0]:.3e}")
    return launches


def print_request_ms(tag: str, secs) -> None:
    """request_ms: the median of the requests of REQUEST_ROWS points and the last request
    (all the test points)."""
    small = sorted(secs[:-1])
    median = f"{REQUEST_ROWS} points median {small[len(small) // 2] * 1e3:.3f} ms (of {len(small)}), " if small else ""
    print(f"[{tag}] request_ms: {median}{N_TEST} points {secs[-1] * 1e3:.3f} ms", flush=True)


def marginal_nlpd(mean, var, y, noise) -> float:
    import torch

    var_f = torch.maximum(var, noise)
    return (0.5 * (torch.log(2 * math.pi * var_f) + (mean - y) ** 2 / var_f)).mean().item()


def _slice_run(device, dtype, steps, periodic=False, wide=False):
    """Training at N=2000 (``wide``: N=4096 on WIDE_D inputs) from the initial values
    (bench.py's for the flagship) with injected probes, a float64 run with the float32
    runs' τ: (step-1 loss, step-1 gradients, raw parameters after ``steps`` steps, CG
    iterations per step, the model)."""
    import torch

    n = WIDE_TRAIN_N if wide else SLICE_TRAIN_N
    budget = PC_NOISE_BUDGET_F64 if dtype == torch.float64 else PC_NOISE_BUDGET
    if periodic:
        train_x, train_y, _, _ = make_periodic_task(n, 0, seed=3)
        model = build_periodic_model(train_x, train_y, device, dtype)
        optimizer, scheduler = make_periodic_optimizer(model)
    else:
        train_x, train_y, _, _ = make_wide_task(n, WIDE_TEST_N, seed=3) if wide else make_task(n, 0, seed=3)
        model = build_model(train_x, train_y, device, dtype, params=None)
        optimizer, scheduler = make_optimizer(model)
    state = torch.zeros(n, 1, dtype=dtype, device=device)
    iters = []
    for step in range(steps):
        loss, state = train_step(model, optimizer, scheduler, InjectedProbes(step), state, budget)
        check(finite_step(loss, model), f"slice training on {device}, step {step}: non-finite loss or gradient")
        iters.append(state.num_iters)
        if step == 0:
            loss0 = loss.item()
            grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
    raw = {k: p.detach().cpu().double() for k, p in model.named_parameters()}
    return loss0, grads, raw, iters, model


def _grad_gap(g_ref, g):
    """max |Δgrad| over all parameters / max |grad| over all parameters, and per parameter."""
    scale = max(t.abs().max().item() for t in g_ref.values())
    gaps = {k: (g_ref[k] - g[k]).abs().max().item() for k in g_ref}
    return max(gaps.values()) / scale, gaps


def phase_train_slice(periodic=False, wide=False):
    """Training at N=2000, CPU tensors (plain path) against CUDA tensors (kernel path); on
    the CPU besides, float32 against float64 (the rounding floor of the gradient gate) and
    against a planted fault, which the gate must see: the plain backward's dos (flagship)
    or dw (periodic) short by one block of 16.  Every run follows the CPU float32 run's
    preconditioner pivots (``PinnedPivots``).  ``wide`` (phase 6c): the flagship's model on
    ``make_wide_task`` (N=4096, WIDE_D inputs), whose CUDA run goes through the wide-d tier
    of the K·V and backward kernels; then one request of WIDE_TEST_N points, served from
    the CPU run's trained parameters on both devices, compared as phase 4 does."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    tag = "periodic-train-slice" if periodic else "wide-train-slice" if wide else "train-slice"
    pins = PinnedPivots()
    with pins.record():
        l_cpu, g_cpu, r_cpu, it_cpu, m_cpu = _slice_run("cpu", torch.float32, SLICE_TRAIN_STEPS, periodic, wide)
    launches = (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
    with pins.replay():
        l_gpu, g_gpu, r_gpu, it_gpu, _ = _slice_run("cuda", torch.float32, SLICE_TRAIN_STEPS, periodic, wide)
    launches = (fk.kernel_matvec_cuda.launches - launches[0], fk.kernel_bwd_fused_cuda.launches - launches[1])
    d_loss = abs(l_cpu - l_gpu) / max(abs(l_cpu), 1.0)
    d_grad, gaps = _grad_gap(g_cpu, g_gpu)
    d_raw = max((r_cpu[k] - r_gpu[k]).abs().max().item() for k in r_cpu)
    with pins.replay():
        floor = _grad_gap(_slice_run("cpu", torch.float64, 1, periodic, wide)[1], g_cpu)[0]
    module, name = (ppk, "_periodic_bwd_fused_reference") if periodic else (fk, "_bwd_fused_reference")
    sound = getattr(module, name)

    def planted(*args, **kwargs):
        # the third output: dos of (dv, dx, dos), dw of the periodic (dv, dx, dw, dos)
        out = list(sound(*args, **kwargs))
        out[2] = None if out[2] is None else out[2] * (15 / 16)
        return tuple(out)

    setattr(module, name, planted)
    try:
        with pins.replay():
            fault = _grad_gap(g_cpu, _slice_run("cpu", torch.float32, 1, periodic, wide)[1])[0]
    finally:
        setattr(module, name, sound)
    shape = f"N={WIDE_TRAIN_N} d={WIDE_D}" if wide else f"N={SLICE_TRAIN_N}"
    print(f"[{tag}] {shape}: CG iters cpu {it_cpu} cuda {it_gpu}; step-1 loss cpu {l_cpu:.6f} cuda "
          f"{l_gpu:.6f} (rel diff {d_loss:.3e}, tol {SLICE_LOSS_TOL}); step-1 grads max diff {d_grad:.3e} of the "
          f"largest (tol {SLICE_GRAD_TOL}; cpu float32 against float64 {floor:.3e}, against a planted fault "
          f"{fault:.3e}); raw parameters after {SLICE_TRAIN_STEPS} steps max diff {d_raw:.3e} (tol {SLICE_PARAM_TOL})",
          flush=True)
    for k in g_cpu:
        print(f"[{tag}]   {k}: grad cpu {g_cpu[k].reshape(-1).numpy().round(6).tolist()}, max diff "
              f"{gaps[k]:.3e} ({gaps[k] / g_cpu[k].abs().max().item():.3e} of its own largest)", flush=True)
    check(d_loss <= SLICE_LOSS_TOL, f"{tag} training loss differs: {d_loss:.3e}")
    check(d_grad <= SLICE_GRAD_TOL, f"{tag} training gradients differ: {d_grad:.3e}")
    check(fault > SLICE_GRAD_TOL, f"the {tag} gradient gate does not see a planted fault: {fault:.3e}")
    check(d_raw <= SLICE_PARAM_TOL, f"{tag} training parameters differ: {d_raw:.3e}")
    if not wide:
        return
    print(f"[{tag}] CUDA training launched kernel_matvec {launches[0]} (CG iterations {sum(it_gpu)}), "
          f"kernel_bwd_fused {launches[1]} (expected {SLICE_TRAIN_STEPS})", flush=True)
    check(launches == (sum(it_gpu), SLICE_TRAIN_STEPS), f"{tag}: CUDA training launched {launches}, expected "
                                                         f"({sum(it_gpu)}, {SLICE_TRAIN_STEPS})")
    _, _, test_x, _ = make_wide_task(WIDE_TRAIN_N, WIDE_TEST_N, seed=3)
    train_x, train_y = m_cpu.train_inputs[0].numpy(), m_cpu.train_targets.numpy()
    out = {}
    from gpytorch_tpu_torch import settings

    with eval_settings(min_preconditioning_size=1000), settings.eval_cg_tolerance(SLICE_CG_TOL):
        for device in ("cpu", "cuda"):
            model = build_model(train_x, train_y, device, torch.float32, params=None)
            model.load_state_dict(m_cpu.state_dict())
            model.eval()
            before = fk.kernel_matvec_cuda.launches
            cg, _, answers = serve(model, torch.as_tensor(test_x, dtype=torch.float32, device=device), device,
                                   [slice(0, WIDE_TEST_N)])
            _, mean, var, _ = answers[0]
            out[device] = (mean.cpu().double(), var.cpu().double(), cg.num_iters, fk.kernel_matvec_cuda.launches - before)
    (mc, vc, itc, _), (mg, vg, itg, served) = out["cpu"], out["cuda"]
    dm = ((mc - mg).abs().max() / mc.abs().max()).item()
    dv = ((vc - vg).abs().max() / vc.abs().max()).item()
    print(f"[{tag}] served {WIDE_TEST_N} points from the CPU run's parameters: CG iters cpu {itc} cuda {itg}; CUDA "
          f"launched kernel_matvec {served} (expected {itg + 5 + 2}); mean rel diff {dm:.3e} (tol {SLICE_MEAN_TOL}), var "
          f"rel diff {dv:.3e} (tol {SLICE_VAR_TOL})", flush=True)
    check(served == itg + 5 + 2, f"{tag}: serving launched kernel_matvec {served} times, expected {itg + 5 + 2}")
    check(bool(torch.isfinite(mg).all()) and bool((vg > 0).all()), f"{tag}: served means not finite or variances ≤ 0")
    check(dm <= SLICE_MEAN_TOL, f"{tag} served mean differs: {dm:.3e}")
    check(dv <= SLICE_VAR_TOL, f"{tag} served variance differs: {dv:.3e}")


def train_flagship(tag: str, honest: bool = False) -> dict:
    """bench.py's training at full width (with ``honest``, its honest recipe), then serving
    from the trained model: the initial parameters served on all 2,048 test points, 120
    steps of cosine Adam with the launch counts set to 0 before the first, the trained
    model refreshed and asked for all 2,048 points.  Returns the readings: the model, the
    launches of (kernel_matvec, kernel_bwd_fused) from the first step to the request, the
    CG iterations, losses, noise and seconds of each step, and the served model's
    quality beside the initial parameters'."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    model = build_model(train_x, train_y, dev, torch.float32, params=None, honest=honest)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)

    def quality():
        """(rmse, marginal nlpd, the refresh's CG result, refresh s, request s) of the model
        in eval mode on all 2,048 test points."""
        model.eval()
        with eval_settings():
            cg, refresh_s, answers = serve(model, tx, dev, [slice(0, N_TEST)])
        pred, mean_, var, secs = answers[0]
        check(bool(torch.isfinite(mean_).all()) and bool((var > 0).all()), f"{tag} predictions not finite or variance ≤ 0")
        rmse = gt.metrics.mean_squared_error(pred, ty, squared=False).item()
        return rmse, marginal_nlpd(mean_, var, ty, model.likelihood.noise.reshape(-1)[0]), cg, refresh_s, secs

    # the initial parameters, served before the launch counts are set to 0: the reading
    # that training has to improve on
    rmse0, nlpd0, _, _, _ = quality()
    print(f"[{tag}] serving the initial parameters: rmse {rmse0:.4f}, marginal nlpd {nlpd0:.4f}", flush=True)
    model.train()
    optimizer, scheduler = make_optimizer(model)
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(N_TRAIN, 1, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, iters, losses, noises = [], [], [], []
    fk.kernel_matvec_cuda.launches = 0
    fk.kernel_bwd_fused_cuda.launches = 0
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state = train_step(model, optimizer, scheduler, generator, state, honest=honest)
        ok = finite_step(loss, model)  # reads the device, so the step has ended
        times.append(time.perf_counter() - t0)
        iters.append(state.num_iters)
        losses.append(loss.item())
        noises.append(model.likelihood.noise.item())
        check(ok, f"{tag} training step {step}: non-finite loss or gradient")
        if step % 10 == 0 or step == TRAIN_STEPS - 1:
            print(f"[{tag}] step {step}: loss {losses[-1]:.5f}, CG iterations {state.num_iters}, "
                  f"{times[-1]:.3f} s", flush=True)
    train_launches = (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
    train_peak = torch.cuda.max_memory_allocated()
    median = sorted(times[1 : 1 + TRAIN_TIMED])[TRAIN_TIMED // 2]
    mean = sum(times[1:]) / (TRAIN_STEPS - 1)
    kern = model.covar_module
    print(f"[{tag}] {TRAIN_STEPS} steps: median {median:.4f} s/step over steps 1-{TRAIN_TIMED} (synchronised), "
          f"mean {mean:.4f} s/step over steps 1-{TRAIN_STEPS - 1}, first step {times[0]:.3f} s", flush=True)
    print(f"[{tag}] CG iterations per step: {iters} ({sum(iters)} in all)", flush=True)
    print(f"[{tag}] loss per step: {[round(x, 6) for x in losses]}", flush=True)
    print(f"[{tag}] lengthscale {kern.base_kernel.lengthscale.detach().cpu().numpy().round(5).tolist()}, "
          f"outputscale {kern.outputscale.item():.5f}, noise {model.likelihood.noise.item():.5f}, "
          f"mean {model.mean_module.constant.item():.5f}", flush=True)
    print(f"[{tag}] training launches: kernel_matvec {train_launches[0]}, kernel_bwd_fused {train_launches[1]}; "
          f"peak device memory {train_peak / 2**20:.1f} MiB", flush=True)

    rmse, nlpd, cg, refresh_s, secs = quality()
    launches = (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
    print_request_ms(tag, [secs])
    print(f"[{tag}] serving the trained model: refresh {refresh_s:.3f} s (CG {cg.num_iters} iterations, relative "
          f"residual {cg.residual_norm.max().item():.3e}), {N_TEST} points in {secs * 1e3:.2f} ms; rmse {rmse:.4f} "
          f"(limit {RMSE_LIMIT}; initial {rmse0:.4f}), marginal nlpd {nlpd:.4f} (initial {nlpd0:.4f}, limit "
          f"{nlpd0 - TRAIN_NLPD_DROP:.4f})", flush=True)
    return dict(model=model, launches=launches, iters=iters, losses=losses, noises=noises, median=median, mean=mean,
                rmse=rmse, nlpd=nlpd, rmse0=rmse0, nlpd0=nlpd0, refresh_iters=cg.num_iters,
                loss_end=sum(losses[-10:]) / 10)


def check_training(tag: str, r: dict, cg_limit: int) -> None:
    """The gates of a full-width flagship run (``train_flagship``'s readings): the launches
    of both kernels, the RMSE limit, the CG iterations, and that training lowered the loss
    and the marginal NLPD."""
    # one K·V per CG iteration of training; then one per CG iteration of the mean cache,
    # one per Lanczos block (5 blocks of 20), and two for the request (mean and LOVE)
    launches, iters, losses = r["launches"], r["iters"], r["losses"]
    expected_mv = sum(iters) + r["refresh_iters"] + 5 + 2
    print(f"[{tag}] loss at step 0 {losses[0]:.5f}, mean of the last 10 steps {r['loss_end']:.5f} (limit "
          f"{losses[0] - TRAIN_LOSS_DROP:.5f})", flush=True)
    print(f"[{tag}] launches: kernel_matvec {launches[0]} (expected {expected_mv}), kernel_bwd_fused {launches[1]} "
          f"(expected {TRAIN_STEPS}); CG iterations {sum(iters)} (limit {cg_limit})", flush=True)
    check(launches[1] == TRAIN_STEPS, f"{tag}: kernel_bwd_fused launched {launches[1]} times, expected {TRAIN_STEPS}")
    check(launches[0] == expected_mv, f"{tag}: kernel_matvec launched {launches[0]} times, expected {expected_mv}")
    check(r["rmse"] <= RMSE_LIMIT, f"{tag} rmse {r['rmse']:.4f} > {RMSE_LIMIT}")
    check(sum(iters) <= cg_limit, f"{tag} training took {sum(iters)} CG iterations > {cg_limit}")
    check(r["loss_end"] <= losses[0] - TRAIN_LOSS_DROP, f"{tag}: training loss fell from {losses[0]:.5f} only to "
                                                        f"{r['loss_end']:.5f}")
    check(r["nlpd"] <= r["nlpd0"] - TRAIN_NLPD_DROP, f"{tag}: training took the marginal nlpd from {r['nlpd0']:.4f} "
                                                      f"only to {r['nlpd']:.4f}")


def phase_flagship():
    """bench.py's training at full width, then serving from the trained model; returns
    ``train_flagship``'s readings."""
    r = train_flagship("flagship")
    check_training("flagship", r, FLAGSHIP_CG_LIMIT)
    check(abs(r["rmse"] - FLAGSHIP_RMSE) <= FLAGSHIP_RMSE_TOL, f"flagship rmse {r['rmse']:.4f} is more than "
                                                                f"{FLAGSHIP_RMSE_TOL} from {FLAGSHIP_RMSE}")
    return r


def phase_honest(default=None):
    """Phase 7b: bench.py's honest recipe at full width (a noise floor of 1e-4 with a
    LogNormal(−4, 1) noise prior, CG at tolerance 0.05 with a stall window of 50), from
    phase 7's data, initial values, probe seed and optimizer, 120 steps, then served.
    Prints the noise trajectory and the prior term beside the readings, and phase 7's
    readings (``default``, ``train_flagship``'s) beside them: which recipe wins on this
    card.  Alone (≈ 1.5 min with the build):

        python3 -c 'import chip_smoke; chip_smoke.phase_honest()'

    Returns its readings."""
    import torch

    if default is None:  # called alone
        phase_device()
        phase_build()
    r = train_flagship("honest", honest=True)
    model = r["model"]
    with torch.no_grad():
        prior = model.likelihood.prior_log_prob_sum().item()
    noises = r["noises"]
    print(f"[honest] noise per step (every 10th): {[round(x, 5) for x in noises[::10]]} → {noises[-1]:.5f} (floor "
          f"{HONEST_NOISE_FLOOR}; not gated); the noise prior's log-density at the end {prior:.4f}, "
          f"{prior / N_TRAIN:.3e} of the loss per datum", flush=True)
    rows = [("honest", r)] + ([("default (phase 7)", default)] if default is not None else [])
    for name, x in rows:
        print(f"[honest] {name}: median {x['median']:.4f} s/step, mean {x['mean']:.4f} s/step, CG {sum(x['iters'])} "
              f"iterations, final loss {x['losses'][-1]:.5f}, rmse {x['rmse']:.4f}, marginal nlpd {x['nlpd']:.4f}, "
              f"noise {x['noises'][-1]:.5f}", flush=True)
    if default is not None:
        best = min(rows, key=lambda row: row[1]["nlpd"])[0]
        faster = min(rows, key=lambda row: row[1]["mean"])[0]
        print(f"[honest] on this card: the lower marginal nlpd is {best}'s, the faster training {faster}'s", flush=True)
    check_training("honest", r, HONEST_CG_LIMIT)
    check(abs(r["rmse"] - HONEST_RMSE) <= HONEST_RMSE_TOL, f"honest rmse {r['rmse']:.4f} is more than "
                                                            f"{HONEST_RMSE_TOL} from {HONEST_RMSE}")
    return r


def period_gradient_sources(model):
    """Where the noise in the raw parameters' gradients comes from, at ``model``'s
    parameters (phase 8's initial ones): the raw gradients of one cold-started step by the
    float32 kernel path for each of ``P_GRAD_SEEDS`` probe seeds, and on the first seed's
    probes, pivots and τ by the float32 and the float64 plain paths.  The kernel path's gap
    to float64 is the float32 round-off (kernels, CG, preconditioner); the plain float32
    path's gap is the part that the kernels do not carry; the spread over seeds is the
    probe noise of the stochastic log-det gradient.  Returns {name: (float64 grad, float32
    kernel-path grad, float32 plain-path grad, standard deviation over seeds)} of the first
    seed."""
    import torch

    train_x = model.train_inputs[0].double().cpu().numpy()
    train_y = model.train_targets.double().cpu().numpy()
    dev = model.train_targets.device
    n = train_y.shape[0]

    def grads(m, seed, budget=PC_NOISE_BUDGET):
        m.zero_grad()
        state = torch.zeros(n, 1, dtype=m.train_targets.dtype, device=dev)
        loss, state = mll_loss(m, InjectedProbes(0, seed), state, budget)
        loss.backward()
        check(finite_step(loss, m), f"period gradient reading, seed {seed}: non-finite loss or gradient")
        return {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}, state.num_iters

    model.train()
    pins = PinnedPivots()
    t0 = time.perf_counter()
    with pins.record():
        g32, it32 = grads(model, 0)
    draws = [g32] + [grads(model, seed)[0] for seed in range(1, P_GRAD_SEEDS)]
    t32 = time.perf_counter() - t0
    ref = build_periodic_model(train_x, train_y, dev, torch.float64)
    ref.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    with plain_kernels(), pins.replay():
        g64, it64 = grads(ref, 0, PC_NOISE_BUDGET_F64)
    t64 = time.perf_counter() - t0
    with plain_kernels(), pins.replay():
        g32p, it32p = grads(model, 0)
    out = {}
    print(f"[periodic] gradient sources at the initial parameters: float32 kernel path, {P_GRAD_SEEDS} probe seeds "
          f"(CG {it32} iterations on the first; {t32:.1f} s), float64 and float32 plain paths on the first seed's "
          f"probes and pivots (CG {it64} and {it32p}; {t64:.1f} s for float64)", flush=True)
    for k in g32:
        spread = torch.stack([d[k] for d in draws]).std(0)
        mean = torch.stack([d[k] for d in draws]).mean(0)
        out[k] = (g64[k], g32[k], g32p[k], spread)

        def gap(a):
            return ((a - g64[k]).abs() / spread).reshape(-1).numpy().round(4).tolist()

        print(f"[periodic]   {k}: float64 {g64[k].reshape(-1).numpy().tolist()}, float32 kernel path "
              f"{g32[k].reshape(-1).numpy().tolist()}, float32 plain path {g32p[k].reshape(-1).numpy().tolist()}; "
              f"|Δ| from float64 / spread: kernel path {gap(g32[k])}, plain float32 {gap(g32p[k])}; over seeds mean "
              f"{mean.reshape(-1).numpy().tolist()}, spread {spread.reshape(-1).numpy().tolist()}", flush=True)
    return out


def period_witness():
    """What a drifted period costs the periodic forecast: phase 8's model on one set of
    trained parameters (those phase 8 reached with the periods trained at an Adam learning
    rate of 1e-4: lengthscale [0.48801, 1.33398], outputscale 0.32223, noise 0.02377,
    constant −0.26549), served on the forecast week under the eval settings twice: with the
    periods that run ended at, [1.0002239, 6.9999375] days, and with the periods reset to
    [1, 7].  A daily period off by 2.24e-4 puts the oldest readings 347 · 2.24e-4 ≈ 0.078
    cycles (1.9 hours) out of phase with the newest.  Prints the forecast RMSE and marginal
    NLPD of each; about 20 s on an H100 after the kernel build.  Not part of ``main``:

        python3 -c 'import chip_smoke; chip_smoke.period_witness()'
    """
    import torch

    import gpytorch_tpu_torch as gt

    phase_device()
    train_x, train_y, test_x, test_y = make_periodic_task(P_N_TRAIN, P_N_TEST)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device="cuda")
    ty = torch.as_tensor(test_y, dtype=torch.float32, device="cuda")
    for label, period in (("drifted", (1.0002239, 6.9999375)), ("reset", P_PERIODS)):
        model = build_periodic_model(train_x, train_y, "cuda", torch.float32)
        kern = model.covar_module
        kern.base_kernel.lengthscale = torch.tensor([[0.48801, 1.33398]])
        kern.base_kernel.period_length = torch.tensor([period])
        kern.outputscale = 0.32223
        model.likelihood.noise = 0.02377
        model.mean_module.initialize(constant=-0.26549)
        model.eval()
        with eval_settings():
            cg, _, answers = serve(model, tx, "cuda", [slice(0, P_N_TEST)])
        pred, mean, var, _ = answers[0]
        rmse = gt.metrics.mean_squared_error(pred, ty, squared=False).item()
        nlpd = marginal_nlpd(mean, var, ty, model.likelihood.noise.reshape(-1)[0])
        print(f"[period-witness] {label} periods {list(period)}: forecast rmse {rmse:.4f}, marginal nlpd {nlpd:.4f}, "
              f"refresh CG {cg.num_iters}", flush=True)


def sass_witness():
    """Which functions of the built kernel library run on the tensor cores: the count of
    ``HMMA.1688.F32.TF32`` in each function's SASS (``cuobjdump -sass``), printed for every
    function that has one.  Fails unless every ``kernel_matvec_tc``, ``kernel_bwd_tc``,
    ``kernel_grad_x_tc``, ``periodic_matvec_tc`` and ``periodic_bwd_tc`` function has them
    and no other function does.  Not part of ``main`` (the disassembly is over 64 MiB and
    takes a minute):

        python3 -c 'import chip_smoke; chip_smoke.sass_witness()'
    """
    import os
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    so = fk.build()
    proc = subprocess.Popen([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(so)], stdout=subprocess.PIPE,
                            text=True)
    counts, name = {}, None
    for line in proc.stdout:
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA.1688.F32.TF32" in line:
            counts[name] += 1
    check(proc.wait() == 0, "cuobjdump failed")
    demangled = (subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True, text=True).stdout.split("\n")
                 if shutil.which("c++filt") else list(counts))
    tc_names = ("kernel_matvec_tc", "kernel_bwd_tc", "kernel_grad_x_tc", "periodic_matvec_tc", "periodic_bwd_tc")
    for (mangled, hmma), pretty in zip(counts.items(), demangled):
        if hmma or any(k in mangled for k in tc_names):
            print(f"[sass] {pretty[:120]}: {hmma} HMMA.1688.F32.TF32", flush=True)
    for k in tc_names:
        fns = [h for f, h in counts.items() if k in f]
        check(bool(fns) and all(fns), f"a {k} function without HMMA.1688.F32.TF32, or none built")
    others = sum(h for f, h in counts.items() if not any(k in f for k in tc_names))
    print(f"[sass] {len(counts)} functions; HMMA.1688.F32.TF32 outside the tensor-core tiers: {others}", flush=True)
    check(others == 0, "HMMA.1688.F32.TF32 outside the tensor-core tiers")


def slab_sweep():
    """The two K·V kernels' strips (2048 and 256 rows against the 100k training rows of both
    tasks, t = 1, 20, 64 and 100) and grad_x's (2048 candidates against the 100k training
    rows both ways, t = 1 and 100) at the wrappers' slab count and at a sweep of counts
    through the C entries, each with its time and its error against float64.  Not part of
    ``main`` (≈ 1 min after the build):

        python3 -c 'import chip_smoke; chip_smoke.slab_sweep()'
    """
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    phase_device()
    lib, dev = fk.load_library(), "cuda"

    def launch(kind, x1, x2, w, v, slabs):
        (n, d), (m, t) = x1.shape, v.shape
        out = torch.empty((slabs, n, t), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "rbf":
            rc = lib.gp_kernel_matvec_f32(x1.data_ptr(), x2.data_ptr(), v.data_ptr(), out.data_ptr(), n, m, d, t,
                                          fk.RBF, slabs, stream)
        else:
            rc = lib.gp_periodic_matvec_f32(x1.data_ptr(), x2.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(),
                                            n, m, d, t, slabs, stream)
        check(rc == 0, f"{kind} launch failed")
        return out.sum(0)

    rng = np.random.default_rng(1)
    train_x, _, test_x, _ = make_periodic_task(P_N_TRAIN, P_N_TEST)
    per = torch.tensor(P_PERIODS, dtype=torch.float32, device=dev)
    w4 = torch.full((P_D,), 4.0, dtype=torch.float32, device=dev)
    tasks = {"rbf": (torch.as_tensor(rng.uniform(size=(N_TRAIN, D)) / 0.3, dtype=torch.float32, device=dev),
                     torch.as_tensor(rng.uniform(size=(N_TEST, D)) / 0.3, dtype=torch.float32, device=dev), None,
                     lambda x1, x2, w, v: fk.kernel_matvec_cuda(x1, x2, v, fk.RBF), fk.kernel_matvec_cuda),
             "periodic": (torch.as_tensor(train_x, dtype=torch.float32, device=dev) / per,
                          torch.as_tensor(test_x, dtype=torch.float32, device=dev) / per, w4,
                          ppk.periodic_matvec_cuda, ppk.periodic_matvec_cuda)}
    for kind, (xt, xs, w, product, wrapper) in tasks.items():
        m = xt.shape[0]
        for n in (N_TEST, REQUEST_ROWS):
            x1 = xs[:n].contiguous()
            for t in (1, 20, 64, 100):
                v = torch.as_tensor(rng.normal(size=(m, t)), dtype=torch.float32, device=dev)
                product(x1, xt, w, v)
                slabs = wrapper.last_slabs
                ref = (fk._matvec_reference(x1.double(), xt.double(), v.double(), fk.RBF) if kind == "rbf" else
                       ppk._periodic_matvec_reference(x1.double(), xt.double(), w.double(), v.double()))
                scale = ref.abs().max().item()
                sweep = []
                for s in sorted({1, 2, 4, 8, 16, 17, 33, 66, 99, 131, 196, 262, slabs} & set(range(1, m // 256 + 1))):
                    err = (launch(kind, x1, xt, w, v, s).double() - ref).abs().max().item() / scale
                    ms = cuda_time_ms(lambda s=s: launch(kind, x1, xt, w, v, s), 10)
                    sweep.append(f"{s}: {ms:.4f} ms {err:.2e}")
                del ref
                print(f"[slab-sweep] {kind} {n}x{m} t={t}: the wrapper takes {slabs} slabs; by slab count (ms, "
                      f"max |Δ| / max |·| against float64): {sweep}", flush=True)

    # grad_x: dx1 over the candidates (a strip) and dx2 over the training rows, on the
    # flagship's task as phase 3d scales it
    def launch_gx(x1, x2, g, v, slabs):
        (n, d), (m, t) = x1.shape, v.shape
        chunks = fk._launch_plan("gp_kernel_grad_x_plan", x1.device.index, n, d, t, fk.RBF)[1]
        dx = torch.empty((slabs * chunks, n, d), dtype=torch.float32, device=dev)
        rc = lib.gp_kernel_grad_x_f32(x1.data_ptr(), x2.data_ptr(), g.data_ptr(), v.data_ptr(), dx.data_ptr(), n, m,
                                      d, t, fk.RBF, slabs, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, "grad_x launch failed")
        return dx.sum(0)

    xt, xq = tasks["rbf"][0], tasks["rbf"][1]
    for x1, x2 in ((xq, xt), (xt, xq)):
        n, m = x1.shape[0], x2.shape[0]
        for t in (1, 100):
            g = torch.as_tensor(rng.normal(size=(n, t)), dtype=torch.float32, device=dev)
            v = torch.as_tensor(rng.normal(size=(m, t)), dtype=torch.float32, device=dev)
            fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF)
            slabs = fk.kernel_grad_x_cuda.last_slabs
            ref = fk._grad_x_reference(x1.double(), x2.double(), g.double(), v.double(), fk.RBF)
            scale = ref.abs().max().item()
            sweep = []
            for s in sorted({1, 2, 3, 4, 8, 16, 17, 33, 66, 82, 99, 131, 196, slabs} & set(range(1, m // 256 + 1))):
                err = (launch_gx(x1, x2, g, v, s).double() - ref).abs().max().item() / scale
                ms = cuda_time_ms(lambda s=s: launch_gx(x1, x2, g, v, s), 10)
                sweep.append(f"{s}: {ms:.4f} ms {err:.2e}")
            del ref
            print(f"[slab-sweep] grad_x {n}x{m} t={t}: the wrapper takes {slabs} slabs; by slab count (ms, max |Δ| / "
                  f"max |·| against float64): {sweep}", flush=True)


def phase_periodic():
    """The periodic model at N=100k: the initial parameters served on the forecast week; 120
    steps of training under the flagship's recipe with the periods at their own learning
    rate; the trained model refreshed and asked for the forecast week in 8 requests of 256
    points and one of all 2,048.  Returns the launches of (periodic_matvec,
    periodic_bwd_fused) over training and serving."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    train_x, train_y, test_x, test_y = make_periodic_task(P_N_TRAIN, P_N_TEST)
    dev = "cuda"
    model = build_periodic_model(train_x, train_y, dev, torch.float32)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)
    kern = model.covar_module

    def forecast(batches):
        """(rmse, marginal nlpd, the refresh's CG result, refresh s, request s) of the model in
        eval mode; rmse and nlpd of the last request (all 2,048 points)."""
        model.eval()
        with eval_settings():
            cg, refresh_s, answers = serve(model, tx, dev, batches)
        for i, (_, mean_, var, _) in enumerate(answers):
            check(bool(torch.isfinite(mean_).all()), f"periodic request {i}: non-finite mean")
            check(bool(torch.isfinite(var).all()) and bool((var > 0).all()), f"periodic request {i}: variance not finite and > 0")
        pred, mean_, var, _ = answers[-1]
        rmse = gt.metrics.mean_squared_error(pred, ty, squared=False).item()
        nlpd = marginal_nlpd(mean_, var, ty, model.likelihood.noise.reshape(-1)[0])
        return rmse, nlpd, cg, refresh_s, [a[3] for a in answers]

    rmse0, nlpd0, _, _, _ = forecast([slice(0, P_N_TEST)])
    print(f"[periodic] serving the initial parameters: rmse {rmse0:.4f}, marginal nlpd {nlpd0:.4f}", flush=True)
    sources = period_gradient_sources(model)
    g64, g32, _, spread = sources["covar_module.base_kernel.raw_period_length"]
    roundoff = ((g32 - g64).abs() / spread).max().item()
    check(roundoff <= P_GRAD_ROUNDOFF_TOL, f"the float32 path's period gradient is {roundoff:.3f} probe-noise standard "
                                           f"deviations from the float64 plain path's (tol {P_GRAD_ROUNDOFF_TOL})")
    model.train()
    optimizer, scheduler = make_periodic_optimizer(model)
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(P_N_TRAIN, 1, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, iters, losses = [], [], []
    ppk.periodic_matvec_cuda.launches = 0
    ppk.periodic_bwd_fused_cuda.launches = 0
    rbf_before = (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
    for step in range(P_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state = train_step(model, optimizer, scheduler, generator, state)
        ok = finite_step(loss, model)  # reads the device, so the step has ended
        times.append(time.perf_counter() - t0)
        iters.append(state.num_iters)
        losses.append(loss.item())
        check(ok, f"periodic training step {step}: non-finite loss or gradient")
        if step % 10 == 0 or step == P_TRAIN_STEPS - 1:
            print(f"[periodic] step {step}: loss {losses[-1]:.5f}, CG iterations {state.num_iters}, "
                  f"{times[-1]:.3f} s, period {kern.base_kernel.period_length.detach().cpu().numpy().round(7).tolist()}",
                  flush=True)
    train_launches = (ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)
    train_peak = torch.cuda.max_memory_allocated()
    median = sorted(times[1 : 1 + TRAIN_TIMED])[TRAIN_TIMED // 2]
    mean = sum(times[1:]) / (P_TRAIN_STEPS - 1)
    print(f"[periodic] {P_TRAIN_STEPS} steps: median {median:.4f} s/step over steps 1-{TRAIN_TIMED} (synchronised), "
          f"mean {mean:.4f} s/step over steps 1-{P_TRAIN_STEPS - 1}, first step {times[0]:.3f} s", flush=True)
    print(f"[periodic] CG iterations per step: {iters} ({sum(iters)} in all, limit {P_CG_LIMIT})", flush=True)
    print(f"[periodic] loss per step: {[round(x, 6) for x in losses]}", flush=True)
    print(f"[periodic] lengthscale {kern.base_kernel.lengthscale.detach().cpu().numpy().round(5).tolist()}, period "
          f"{kern.base_kernel.period_length.detach().cpu().numpy().round(7).tolist()}, outputscale "
          f"{kern.outputscale.item():.5f}, noise {model.likelihood.noise.item():.5f}, mean "
          f"{model.mean_module.constant.item():.5f}", flush=True)
    print(f"[periodic] training launches: periodic_matvec {train_launches[0]}, periodic_bwd_fused {train_launches[1]}; "
          f"peak device memory {train_peak / 2**20:.1f} MiB", flush=True)

    batches = [slice(i * REQUEST_ROWS, (i + 1) * REQUEST_ROWS) for i in range(N_REQUESTS)] + [slice(0, P_N_TEST)]
    rmse, nlpd, cg, refresh_s, secs = forecast(batches)
    launches = (ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)
    rbf = (fk.kernel_matvec_cuda.launches - rbf_before[0], fk.kernel_bwd_fused_cuda.launches - rbf_before[1])
    # one K·V per CG iteration of training; then one per CG iteration of the mean cache,
    # one per Lanczos block (5 blocks of 20), and two per request (mean and LOVE)
    expected_mv = sum(iters) + cg.num_iters + 5 + 2 * len(batches)
    loss_end = sum(losses[-10:]) / 10
    print_request_ms("periodic", secs)
    print(f"[periodic] serving the trained model: refresh {refresh_s:.3f} s (CG {cg.num_iters} iterations, relative "
          f"residual {cg.residual_norm.max().item():.3e}); requests {[round(x * 1e3, 2) for x in secs]} ms; forecast "
          f"rmse {rmse:.4f} (limit {P_RMSE_LIMIT}; initial {rmse0:.4f}), marginal nlpd {nlpd:.4f} (initial "
          f"{nlpd0:.4f}, limit {nlpd0 - TRAIN_NLPD_DROP:.4f})", flush=True)
    print(f"[periodic] loss at step 0 {losses[0]:.5f}, mean of the last 10 steps {loss_end:.5f} (limit "
          f"{losses[0] - TRAIN_LOSS_DROP:.5f})", flush=True)
    print(f"[periodic] launches: periodic_matvec {launches[0]} (expected {expected_mv}), periodic_bwd_fused "
          f"{launches[1]} (expected {P_TRAIN_STEPS}); RBF kernels {rbf} (expected (0, 0))", flush=True)
    _variances_against_float64(model, _float64_twin(model, train_x, train_y, periodic=True), tx, "periodic")
    check(launches[1] == P_TRAIN_STEPS, f"periodic_bwd_fused launched {launches[1]} times, expected {P_TRAIN_STEPS}")
    check(launches[0] == expected_mv, f"periodic_matvec launched {launches[0]} times, expected {expected_mv}")
    check(rbf == (0, 0), f"the periodic path launched the RBF kernels {rbf} times")
    check(rmse <= P_RMSE_LIMIT, f"periodic forecast rmse {rmse:.4f} > {P_RMSE_LIMIT}")
    check(abs(rmse - P_RMSE) <= P_RMSE_TOL, f"periodic forecast rmse {rmse:.4f} is more than {P_RMSE_TOL} from {P_RMSE}")
    check(sum(iters) <= P_CG_LIMIT, f"periodic training took {sum(iters)} CG iterations > {P_CG_LIMIT}")
    check(loss_end <= losses[0] - TRAIN_LOSS_DROP, f"periodic training loss fell from {losses[0]:.5f} only to {loss_end:.5f}")
    check(nlpd <= nlpd0 - TRAIN_NLPD_DROP, f"periodic training took the marginal nlpd from {nlpd0:.4f} only to {nlpd:.4f}")
    return launches


def _float64_twin(model, train_x, train_y, nu=None, periodic=False):
    """A float64 copy of the eval-mode ``model`` (the flagship's, or with ``periodic`` the
    periodic one) whose prediction caches are ``model``'s own, cast to float64: the
    reference of a float32 prediction through the plain versions."""
    import torch

    if periodic:
        ref = build_periodic_model(train_x, train_y, "cuda", torch.float64)
    else:
        ref = build_model(train_x, train_y, "cuda", torch.float64, params=None, nu=nu)
    ref.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
    ref.eval()
    for p in ref.parameters():
        p.requires_grad_(False)
    with torch.no_grad():
        strategy, ref_strategy = model.prediction_strategy(), ref.prediction_strategy()
        ref_strategy._mean_cache = strategy.mean_cache.double()
        ref_strategy._covar_cache = strategy.covar_cache.double()
    return ref


def _variances_against_float64(model, ref, x, tag):
    """A reading, not a gate: the latent (LOVE) variances at ``x`` by the kernel path and
    by the float32 plain path, each against the float64 plain path of ``ref`` from the same
    caches; prints the largest relative error over the smallest 1 % of the float64
    variances (where σ² = K** − |K*x R|² cancels most) and over all of them."""
    import torch

    with eval_settings(), torch.no_grad():
        kernel = model(x).variance.double()
        with plain_kernels():
            plain = model(x).variance.double()
            var64 = ref(x.double()).variance
    smallest = var64.argsort()[: max(1, var64.numel() // 100)]
    for name, v in (("kernel path", kernel), ("plain float32", plain)):
        rel = (v - var64).abs() / var64
        print(f"[{tag}] latent variances against float64 from the same caches, {name}: max |Δ| / σ² over the "
              f"smallest 1 % ({smallest.numel()} of {var64.numel()}, σ² {var64[smallest].min().item():.3e} to "
              f"{var64[smallest].max().item():.3e}) {rel[smallest].max().item():.3e}, over all {rel.max().item():.3e}",
              flush=True)


def ucb_parts(model, x):
    """(∇Σμ, ∇Σ2σ, variances) at the candidates ``x``: the two parts of ∇ΣUCB."""
    import torch

    xg = x.detach().requires_grad_(True)
    latent = model(xg)
    var = latent.variance
    grad_mean = torch.autograd.grad(latent.mean.sum(), xg, retain_graph=True)[0]
    grad_sd = torch.autograd.grad(UCB_BETA * var.sqrt().sum(), xg)[0]
    return grad_mean.double(), grad_sd.double(), var.detach().double()


def _gradient_against_float64(model, ref, cand, tag):
    """One frozen-parameter gradient evaluation by the kernel path, with its launches, held
    against the float64 plain path of ``ref`` from the same caches; beside it, the mean and
    2σ parts of the gradient and the variances of the kernel path and of the float32 plain
    path, each against float64.  Returns the float64 gradient."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    with eval_settings():
        fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
        grad, _, u, var = ucb_gradient(model, cand)
        torch.cuda.synchronize()
        launches = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
        kernel = ucb_parts(model, cand)
        with plain_kernels():
            plain = ucb_parts(model, cand)
            mean64, sd64, var64 = ucb_parts(ref, cand.double())
    grad64 = mean64 + sd64
    scale = grad64.abs().max().item()
    err = (grad.double() - grad64).abs().max().item() / scale
    finite = bool(torch.isfinite(grad).all()) and bool(torch.isfinite(u).all()) and bool((var > 0).all())
    print(f"[acquisition] {tag}: one gradient evaluation launched kernel_matvec, kernel_grad_x, kernel_bwd_fused "
          f"{launches} (expected (2, 2, 0)); ∇ΣUCB against the float64 plain path max |Δ| / max |∇| {err:.3e} (tol "
          f"{ACQ_F64_TOL}); max |∇| {scale:.4e}; latent variances {var64.min().item():.3e} to "
          f"{var64.max().item():.3e}", flush=True)
    for name, (gm, gs, v) in (("kernel path", kernel), ("plain float32", plain)):
        print(f"[acquisition] {tag}: {name} against float64, max |Δ| / max |∇| of the mean part "
              f"{(gm - mean64).abs().max().item() / scale:.3e} and of the 2σ part {(gs - sd64).abs().max().item() / scale:.3e}; "
              f"variances max |Δ| / σ² {((v - var64).abs() / var64).max().item():.3e}", flush=True)
    check(launches == (2, 2, 0), f"{tag}: a frozen-parameter gradient launched {launches}, expected (2, 2, 0)")
    check(finite, f"{tag}: non-finite gradient or UCB, or a variance ≤ 0")
    check(err <= ACQ_F64_TOL, f"{tag}: the gradient differs from float64 by {err:.3e}")
    return grad64


def phase_acquisition(model):
    """Gradients of the trained flagship's predictions with respect to 2,048 candidates
    (the test points): ∇ΣUCB against the float64 plain path from the same caches; central
    differences of single candidates' UCB in float64; the launches of one gradient
    evaluation with the parameters frozen and live; 20 Adam steps of ascent on the
    candidates; the same checks for Scale(Matérn-5/2 ARD) with the flagship's fitted
    hyperparameters.  Returns the launches of (kernel_matvec, kernel_grad_x) over the
    ascent."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    cand = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)
    model.eval()
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(False)
    with eval_settings():
        model.refresh()
    ref = _float64_twin(model, train_x, train_y)
    _variances_against_float64(model, ref, cand, "acquisition")
    grad64 = _gradient_against_float64(model, ref, cand, "RBF")

    # central differences of single candidates' UCB (which depends on that candidate alone)
    coords = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    x64 = cand.double()
    fd = []
    with eval_settings(), plain_kernels(), torch.no_grad():
        for i, k in coords:
            e = torch.zeros_like(x64)
            e[i, k] = ACQ_FD_H
            fd.append(((ucb(ref, x64 + e)[0][i] - ucb(ref, x64 - e)[0][i]) / (2 * ACQ_FD_H)).item())
    ad = [grad64[i, k].item() for i, k in coords]
    fd_err = max(abs(a - b) for a, b in zip(fd, ad)) / max(abs(a) for a in ad)
    print(f"[acquisition] central differences (h={ACQ_FD_H}, float64 plain) at {coords}: {fd}; autograd {ad}; max |Δ| "
          f"/ max |∇| {fd_err:.3e} (tol {ACQ_FD_TOL})", flush=True)
    check(fd_err <= ACQ_FD_TOL, f"central differences differ from the autograd gradient by {fd_err:.3e}")

    # the parameters live: dx2 over the training rows and dos, for each of the two products
    for p in params:
        p.requires_grad_(True)
    with eval_settings():
        fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = 0
        grad, pgrads, _, _ = ucb_gradient(model, cand, params)
        torch.cuda.synchronize()
        live = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches)
    for p in params:
        p.requires_grad_(False)
    finite = all(bool(torch.isfinite(g).all()) for g in (grad, *(g for g in pgrads if g is not None)))
    print(f"[acquisition] parameters live: kernel_matvec, kernel_grad_x launched {live} (expected (4, 4): the two "
          f"products, their dos and their dx1 and dx2); gradients finite {finite}", flush=True)
    check(live == (4, 4), f"a live-parameter gradient launched {live}, expected (4, 4)")
    check(finite, "a live-parameter gradient is not finite")

    # ascent: the main path of this slice
    x = cand.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([x], lr=ACQ_LR)
    times, means = [], []
    fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
    with eval_settings():
        for step in range(ACQ_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimizer.zero_grad()
            u, var = ucb(model, x)
            (-u.sum()).backward()
            ok = bool(torch.isfinite(x.grad).all()) and bool((var > 0).all())  # reads the device
            times.append(time.perf_counter() - t0)
            means.append(u.mean().item())
            check(ok, f"ascent step {step}: non-finite gradient or a variance ≤ 0")
            optimizer.step()
            with torch.no_grad():
                x.clamp_(0.0, 1.0)
        launches = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
        with torch.no_grad():
            end = ucb(model, x)[0].mean().item()
    median = sorted(times)[len(times) // 2]
    print(f"[acquisition] acq_grad_ms: median {median * 1e3:.3f} ms over the {ACQ_STEPS} gradient evaluations of the "
          f"ascent", flush=True)
    print(f"[acquisition] ascent, {ACQ_STEPS} Adam steps (lr {ACQ_LR}) on {N_TEST} candidates: mean UCB "
          f"{means[0]:.5f} → {end:.5f}; per step {[round(m_, 5) for m_ in means]}; median "
          f"{median * 1e3:.3f} ms per gradient evaluation (first {times[0] * 1e3:.3f}); launches kernel_matvec, "
          f"kernel_grad_x, kernel_bwd_fused {launches} (expected ({2 * ACQ_STEPS}, {2 * ACQ_STEPS}, 0))", flush=True)
    check(launches == (2 * ACQ_STEPS, 2 * ACQ_STEPS, 0), f"the ascent launched {launches}")
    check(end > means[0], f"the ascent did not raise the mean UCB: {means[0]:.5f} → {end:.5f}")

    # Scale(Matérn-5/2 ARD) with the flagship's fitted hyperparameters
    matern = build_model(train_x, train_y, dev, torch.float32, params=None, nu=2.5)
    matern.load_state_dict(model.state_dict())
    matern.eval()
    for p in matern.parameters():
        p.requires_grad_(False)
    with eval_settings(), torch.no_grad():
        strategy = matern.refresh()
        rmse = gt.metrics.mean_squared_error(matern(cand), ty, squared=False).item()
    cg = strategy.lik_train_train_covar.last_cg_result
    print(f"[acquisition] Matérn-5/2 with the fitted hyperparameters: refresh CG {cg.num_iters} iterations (relative "
          f"residual {cg.residual_norm.max().item():.3e}), rmse {rmse:.4f} (no gate)", flush=True)
    _gradient_against_float64(matern, _float64_twin(matern, train_x, train_y, nu=2.5), cand, "Matérn-5/2")
    return launches[:2]


def phase_sampling(model):
    """Phase 9b: LOVE posterior sampling (``fast_pred_samples``) on phase 7's trained
    flagship: SAMPLES draws of all 2,048 test points from a seeded CUDA generator.  One
    draw (a request and its samples) launches kernel_matvec 7 times: the mean strip
    (t=1), K(test, train)·R (t=100) and the sample root's 5 Lanczos blocks on K(test,
    test) (2048 × 2048, t=20), and nothing else.  The sample root's diagonal
    diag(R_s R_sᵀ) is held against the float64 plain path's from the same caches and the
    same start block, beside the float32 plain path's; love_samp_ms is the median of
    SAMPLE_REPS synchronised draws.  Returns the launches of one draw."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, _ = make_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    cand = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    with eval_settings(), settings.fast_pred_samples(True), torch.no_grad():
        model.refresh()
        generator = torch.Generator(device=dev).manual_seed(SAMPLE_SEED)
        sync(dev)
        fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
        t0 = time.perf_counter()
        post = model(cand)
        draws = post.rsample((SAMPLES,), base_samples=generator)
        sync(dev)
        first = time.perf_counter() - t0
        launches = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
        times = []
        for _ in range(SAMPLE_REPS):
            sync(dev)
            t0 = time.perf_counter()
            again = model(cand).rsample((SAMPLES,), base_samples=generator)
            sync(dev)
            times.append(time.perf_counter() - t0)
        diag = post.lazy_covariance_matrix._diagonal().double()
        with plain_kernels():
            plain = model(cand).lazy_covariance_matrix._diagonal().double()
            diag64 = _float64_twin(model, train_x, train_y)(cand.double()).lazy_covariance_matrix._diagonal()
    rank = post.lazy_covariance_matrix.root.shape[-1]
    scale = diag64.abs().max().item()
    err, plain_err = ((diag - diag64).abs().max().item() / scale, (plain - diag64).abs().max().item() / scale)
    finite = bool(torch.isfinite(draws).all()) and bool(torch.isfinite(again).all())
    median = sorted(times)[len(times) // 2]
    print(f"[sampling] love_samp_ms: median {median * 1e3:.3f} ms over {SAMPLE_REPS} synchronised draws of {SAMPLES} "
          f"samples x {N_TEST} points (first draw {first * 1e3:.3f} ms); sample root rank {rank}", flush=True)
    print(f"[sampling] one draw launched kernel_matvec, kernel_grad_x, kernel_bwd_fused {launches} (expected (7, 0, 0): "
          f"the mean, K*x R and 5 Lanczos blocks on K**)", flush=True)
    print(f"[sampling] diag(R_s R_sᵀ) against the float64 plain path from the same caches: kernel path max |Δ| / max "
          f"{err:.3e} (tol {SAMPLE_DIAG_TOL}), plain float32 {plain_err:.3e}; diag {diag64.min().item():.3e} to "
          f"{scale:.3e}; the smallest 1 %: kernel path max |Δ| / diag "
          f"{((diag - diag64).abs() / diag64)[diag64.argsort()[: N_TEST // 100]].max().item():.3e}; draws finite "
          f"{finite}", flush=True)
    check(launches == (7, 0, 0), f"one LOVE draw launched {launches}, expected (7, 0, 0)")
    check(finite, "LOVE samples not finite")
    check(err <= SAMPLE_DIAG_TOL, f"the sample root's diagonal differs from float64 by {err:.3e}")
    return launches[0]


def sampling_profile():
    """Where the time of one LOVE draw goes: phase 9b's request of 2,048 points and its
    SAMPLES samples, on phase 5's model from fixed parameters (caches built first).
    Prints the wall time of SAMPLE_REPS synchronised draws, then ``torch.profiler`` over
    as many: the device time by kernel and by host operation per draw, and the device's
    busy share of the profiled wall time.  Not part of ``main`` (≈ 30 s after the build):

        python3 -c 'import chip_smoke; chip_smoke.sampling_profile()'
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpytorch_tpu_torch import settings

    phase_device()
    phase_build()
    train_x, train_y, test_x, _ = make_task(N_TRAIN, N_TEST, seed=0)
    model = build_model(train_x, train_y, "cuda", torch.float32)
    cand = torch.as_tensor(test_x, dtype=torch.float32, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(SAMPLE_SEED)

    def draws():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SAMPLE_REPS):
            model(cand).rsample((SAMPLES,), base_samples=generator)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SAMPLE_REPS

    with eval_settings(), settings.fast_pred_samples(True), torch.no_grad():
        model.refresh()
        draws()
        plain_s = draws()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = draws()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(device_us(e) for e in events) / SAMPLE_REPS
    print(f"[sampling-profile] one draw: {plain_s * 1e3:.3f} ms (profiled {profiled_s * 1e3:.3f} ms); device busy "
          f"{busy / 1e3:.3f} ms of it ({busy / 1e3 / (profiled_s * 1e3):.1%} of the profiled wall time)", flush=True)
    for e in sorted(events, key=device_us, reverse=True)[:15]:
        if device_us(e) > 0:
            print(f"[sampling-profile] device {device_us(e) / SAMPLE_REPS / 1e3:8.4f} ms/draw, {e.count // SAMPLE_REPS:4d} "
                  f"calls/draw: {e.key[:90]}", flush=True)
    for e in sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]:
        print(f"[sampling-profile] host {e.self_cpu_time_total / SAMPLE_REPS / 1e3:8.4f} ms/draw, "
              f"{e.count // SAMPLE_REPS:4d} calls/draw: {e.key[:90]}", flush=True)


def make_toy_task(n_train: int, n_test: int, seed: int = 0):
    """BASELINE.json config 1: x uniform on [0, 1], y = sin 2πx + 0.1 noise, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_train + n_test, 1))
    y = np.sin(2 * np.pi * x[:, 0]) + 0.1 * rng.normal(size=n_train + n_test)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def phase_cholesky():
    """Phase 1k: BASELINE.json config 1, the exact GP (ConstantMean + Scale(RBF) +
    GaussianLikelihood) on a 1D toy of TOY_N points, trained for TOY_STEPS Adam steps
    through the dense-Cholesky MLL and served (mean and exact variance of TOY_TEST points)
    under ``fast_computations(False, False, False)``: CPU float32 against CUDA float32,
    and a CPU float64 run for the RMSE.  No Pallas kernel lies on this path: the CUDA run
    must launch none."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, test_y = make_toy_task(TOY_N, TOY_TEST)

    class ToyGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel())

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    runs = {}
    counts = lambda: (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches,  # noqa: E731
                      fk.kernel_grad_x_cuda.launches)
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        tx, ty, sx = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y, test_x))
        model = ToyGP(tx, ty, gt.likelihoods.GaussianLikelihood()).to(device=device, dtype=dtype).train()
        optimizer = torch.optim.Adam(model.parameters(), lr=TOY_LR)
        before, losses, times = counts(), [], []
        with gt.settings.fast_computations(False, False, False):
            mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)
            for _ in range(TOY_STEPS):
                sync(device)
                t0 = time.perf_counter()
                optimizer.zero_grad()
                loss = -mll(model(tx), ty)
                loss.backward()
                optimizer.step()
                losses.append(loss.item())
                times.append(time.perf_counter() - t0)
            model.eval()
            with torch.no_grad():
                sync(device)
                t0 = time.perf_counter()
                pred = model(sx)
                mean, var = pred.mean.double().cpu(), pred.variance.double().cpu()
                serve_s = time.perf_counter() - t0
        launched = tuple(a - b for a, b in zip(counts(), before))
        rmse = (mean - torch.as_tensor(test_y)).square().mean().sqrt().item()
        runs[(device, dtype)] = dict(losses=losses, mean=mean, var=var, rmse=rmse, launched=launched,
                                     step_s=sorted(times[1:])[len(times[1:]) // 2], serve_s=serve_s,
                                     noise=model.likelihood.noise.item())
    f64, cpu, gpu = runs[("cpu", torch.float64)], runs[("cpu", torch.float32)], runs[("cuda", torch.float32)]

    def gaps(a, b):
        return (max(abs(x - y) / max(abs(x), 1.0) for x, y in zip(a["losses"], b["losses"])),
                ((a["mean"] - b["mean"]).abs().max() / a["mean"].abs().max()).item(),
                ((a["var"] - b["var"]).abs().max() / a["var"].abs().max()).item())

    (d_loss, d_mean, d_var), floor = gaps(cpu, gpu), gaps(f64, cpu)
    d_rmse = abs(gpu["rmse"] - f64["rmse"])
    for name, r in (("cpu float64", f64), ("cpu float32", cpu), ("cuda float32", gpu)):
        print(f"[cholesky] {name}: {TOY_STEPS} steps at a median {r['step_s'] * 1e3:.2f} ms/step, loss "
              f"{r['losses'][0]:.5f} → {r['losses'][-1]:.5f}, noise {r['noise']:.5f}; {TOY_TEST} points served in "
              f"{r['serve_s'] * 1e3:.2f} ms, rmse {r['rmse']:.5f}", flush=True)
    print(f"[cholesky] N={TOY_N} 1D toy, fast_computations(False, False, False): CPU against CUDA (float32) loss "
          f"max rel diff {d_loss:.3e} (tol {TOY_LOSS_TOL}), mean {d_mean:.3e} (tol {TOY_MEAN_TOL}), variance "
          f"{d_var:.3e} (tol {TOY_VAR_TOL}); CPU float32 against float64: loss {floor[0]:.3e}, mean {floor[1]:.3e}, "
          f"variance {floor[2]:.3e}; rmse against float64 {d_rmse:.3e} (tol {TOY_RMSE_TOL}); CUDA launched "
          f"kernel_matvec, kernel_bwd_fused, kernel_grad_x {gpu['launched']} (expected (0, 0, 0))", flush=True)
    check(gpu["launched"] == (0, 0, 0), f"the Cholesky path launched {gpu['launched']}")
    check(all(math.isfinite(x) for x in gpu["losses"]) and bool((gpu["var"] > 0).all()),
          "the Cholesky path's losses not finite or variances ≤ 0")
    check(d_loss <= TOY_LOSS_TOL, f"the Cholesky path's losses differ between CPU and CUDA: {d_loss:.3e}")
    check(d_mean <= TOY_MEAN_TOL and d_var <= TOY_VAR_TOL, f"the Cholesky path's predictions differ between CPU and "
                                                           f"CUDA: mean {d_mean:.3e}, variance {d_var:.3e}")
    check(d_rmse <= TOY_RMSE_TOL, f"the Cholesky path's rmse {gpu['rmse']:.5f} is {d_rmse:.3e} from float64's")


def _fantasy_points(model, cand):
    """The fantasy points of phase 10: X_f, every (N_TEST / FANT_Q)-th candidate, and y_f,
    one LOVE draw of the latent posterior at X_f (``fast_pred_samples``, the phase 9b path)
    from a generator seeded with FANT_SEED."""
    import torch

    from gpytorch_tpu_torch import settings

    xf = cand[:: len(cand) // FANT_Q][:FANT_Q].contiguous()
    generator = torch.Generator(device=cand.device).manual_seed(FANT_SEED)
    with eval_settings(), settings.fast_pred_samples(True), torch.no_grad():
        yf = model(xf).rsample((1,), base_samples=generator)[0]
    return xf, yf


def kg_gradient(model, xf, yf, cand, split=None):
    """The one-shot knowledge-gradient step: Σμ* over ``cand`` of ``model`` conditioned on
    (``xf``, ``yf``), under ``detach_test_caches(False)`` and ``skip_posterior_variances``,
    with the fantasy's solves at eval's tolerance, and its gradient with respect to the
    fantasy inputs and to the hyperparameters (the sum of the model's and its copy's: the
    copy's parameters are new leaves).  The model must hold a prediction strategy, so that
    the fantasy is its rank-m update.  ``split``, a list, receives the launches of the three
    kernels after the forward pass.  Returns (value, ∇X_f, {name: ∇}, the fantasy model)."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    xg = xf.detach().clone().requires_grad_(True)
    with settings.detach_test_caches(False), settings.skip_posterior_variances(True), \
            settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        fantasy = model.get_fantasy_model(xg, yf)
        value = fantasy(cand).mean.sum()
    if split is not None:
        split.extend((fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches))
    own, copied = dict(model.named_parameters()), dict(fantasy.named_parameters())
    names = list(own)
    grads = torch.autograd.grad(value, [xg] + [own[k] for k in names] + [copied[k] for k in names], allow_unused=True)
    by_name = {}
    for k, a, b in zip(names, grads[1:1 + len(names)], grads[1 + len(names):]):
        by_name[k] = sum((g for g in (a, b) if g is not None), torch.zeros_like(own[k])).detach()
    return value.detach(), grads[0], by_name, fantasy


def kg_value(model, xf, yf, cand):
    """Σμ* of ``model`` conditioned on (``xf``, ``yf``) as ``kg_gradient`` computes it, without
    gradients: the model's mean cache is rebuilt (its parameters may have moved), then
    updated by the rank-m Schur step at eval's tolerance."""
    import torch

    from gpytorch_tpu_torch import settings

    with torch.no_grad(), settings.skip_posterior_variances(True), \
            settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        model.clear_caches()
        model.prediction_strategy().mean_cache
        return model.get_fantasy_model(xf, yf)(cand).mean.sum().item()


@contextlib.contextmanager
def planted_bwd_fault(scale: float):
    """The symmetric backward's dx and dos (CUDA kernel and plain version) scaled by
    ``scale``: 0 drops the solves' operator cotangents, as a port that differentiated its
    solves only through the right-hand side would."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    kernel, plain = fk.kernel_bwd_fused_cuda, fk._bwd_fused_reference

    def faulty(fn):
        def run(*args, **kwargs):
            dv, dx, dos = fn(*args, **kwargs)
            return dv, dx * scale, (None if dos is None else dos * scale)
        return run

    fk.kernel_bwd_fused_cuda, fk._bwd_fused_reference = faulty(kernel), faulty(plain)
    try:
        yield
    finally:
        fk.kernel_bwd_fused_cuda, fk._bwd_fused_reference = kernel, plain


@contextlib.contextmanager
def planted_grad_x_fault(scale: float):
    """grad_x's cotangents (CUDA kernel and plain version) scaled by ``scale``: the
    asymmetric backward through which the fantasy inputs' gradient leaves the mean strip."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    kernel, plain = fk.kernel_grad_x_cuda, fk._grad_x_reference
    fk.kernel_grad_x_cuda = lambda *args, **kwargs: kernel(*args, **kwargs) * scale
    fk._grad_x_reference = lambda *args, **kwargs: plain(*args, **kwargs) * scale
    try:
        yield
    finally:
        fk.kernel_grad_x_cuda, fk._grad_x_reference = kernel, plain


def _fantasy_kernel_shapes(model):
    """Step 5 of phase 10: the shapes that the fantasy path gives the kernels at N=100k and
    no main path timed before: the symmetric backward at d=3, t=1 (the mean cache's solve)
    and t=16 (the 16 solves A⁻¹B), dx and dos on the FMA tier (``_bwd_against_float64``: dx
    at twice the plain float32 version's error, dos over the sum of its terms' magnitudes at
    LG_DOS_TOL beside a planted fault, since dos cancels to a fraction of that sum that the
    trained state sets: plain's own |Δdos| / |dos| read 2.5e-08 to 2.2e-07 between trained
    states on an H100), and the product at t=16 (the 16-column CG;
    ``_matvec_against_float64``), on the model's scaled training inputs and seeded g and v.
    Returns {name: report entry}."""
    import torch

    tx = model.train_inputs[0]
    ls = model.covar_module.base_kernel.lengthscale.detach()
    x = ((tx - tx.mean(0, keepdim=True)) / ls).contiguous()
    rng = np.random.default_rng(21)
    out = {}
    for t in (1, FANT_Q):
        g, v = (torch.as_tensor(rng.normal(size=(N_TRAIN, t)), dtype=torch.float32, device="cuda") for _ in range(2))
        out[f"bwd_t{t}"] = _bwd_against_float64(x, g, v, "fantasy", "a solve of the fantasy path differentiated")
    v = torch.as_tensor(rng.normal(size=(N_TRAIN, FANT_Q)), dtype=torch.float32, device="cuda")
    out[f"matvec_t{FANT_Q}"] = _matvec_against_float64(x, x, v, "fantasy", "the 16-column CG, a tiled tier of 16")
    return out


def _kg_slice_run(device, dtype):
    """The knowledge-gradient step at N=KG_SLICE_N from JAX_PARAMS: its X_f, every 32nd of
    512 candidates, y_f their targets.  Returns (value, ∇X_f, {name: ∇}) on the CPU in
    float64."""
    import torch

    from gpytorch_tpu_torch import settings

    train_x, train_y, test_x, test_y = make_task(KG_SLICE_N, 512, seed=5)
    model = build_model(train_x, train_y, device, dtype)
    cand = torch.as_tensor(test_x, dtype=dtype, device=device)
    xf, yf = cand[::32][:FANT_Q], torch.as_tensor(test_y[::32][:FANT_Q], dtype=dtype, device=device)
    budget = PC_NOISE_BUDGET_F64 if dtype == torch.float64 else PC_NOISE_BUDGET
    for p in model.parameters():
        p.requires_grad_(True)
    with eval_settings(min_preconditioning_size=1000), settings.eval_cg_tolerance(KG_TOL), \
            settings.preconditioner_noise_budget(budget):
        model.prediction_strategy()
        value, gxf, grads, _ = kg_gradient(model, xf, yf, cand)
    return value.item(), gxf.detach().cpu().double(), {k: g.cpu().double() for k, g in grads.items()}


def _kg_fd_check():
    """The knowledge-gradient step's directional derivative against central differences at
    N=KG_SLICE_N, float64 on the card through the plain path, along the gradient's own
    direction over X_f and the raw hyperparameters, bracketed by a planted fault (the
    symmetric backward's dx and dos dropped: the solves differentiated through their
    right-hand sides only)."""
    import torch

    from gpytorch_tpu_torch import settings

    train_x, train_y, test_x, test_y = make_task(KG_SLICE_N, 512, seed=5)
    model = build_model(train_x, train_y, "cuda", torch.float64)
    cand = torch.as_tensor(test_x, dtype=torch.float64, device="cuda")
    xf, yf = cand[::32][:FANT_Q], torch.as_tensor(test_y[::32][:FANT_Q], dtype=torch.float64, device="cuda")
    params = list(model.parameters())
    names = [k for k, _ in model.named_parameters()]
    for p in params:
        p.requires_grad_(True)

    def along(direction):
        _, g_x, g_p, _ = kg_gradient(model, xf, yf, cand)
        return float((g_x * direction[0]).sum()) + sum(float((g_p[k] * d_).sum()) for k, d_ in
                                                         zip(names, direction[1:]))

    def shifted(direction, h):
        with torch.no_grad():
            for p, d_ in zip(params, direction[1:]):
                p.add_(h * d_)
        try:
            return kg_value(model, xf + h * direction[0], yf, cand)
        finally:
            with torch.no_grad():
                for p, d_ in zip(params, direction[1:]):
                    p.sub_(h * d_)

    with eval_settings(min_preconditioning_size=1000), plain_kernels(), settings.eval_cg_tolerance(KG_FD_TOL), \
            settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64):
        model.prediction_strategy()
        _, g_x, g_p, _ = kg_gradient(model, xf, yf, cand)
        direction = [g_x.detach()] + [g_p[k] for k in names]
        dd = math.sqrt(sum(float((d_ * d_).sum()) for d_ in direction))  # the derivative along it
        direction = [d_ / dd for d_ in direction]
        fd = (shifted(direction, KG_FD_H) - shifted(direction, -KG_FD_H)) / (2 * KG_FD_H)
        model.prediction_strategy()
        with planted_bwd_fault(0.0):
            dd_fault = along(direction)
    fd_err, fault_err = abs(dd - fd) / abs(fd), abs(dd_fault - fd) / abs(fd)
    print(f"[fantasy] N={KG_SLICE_N}, float64 plain path (eval tolerance {KG_FD_TOL}): the directional derivative of Σμ* "
          f"along its gradient over X_f and the raw hyperparameters, autograd {dd:.6e}, central difference "
          f"(h={KG_FD_H}) {fd:.6e}, |Δ| / |fd| {fd_err:.3e} (tol {KG_FD_GATE}); planted fault (the solves' operator "
          f"cotangents dropped) {dd_fault:.6e}, {fault_err:.3e}", flush=True)
    check(fd_err <= KG_FD_GATE, f"the knowledge-gradient derivative differs from central differences by {fd_err:.3e}")
    check(fault_err > KG_FD_GATE, f"the central-difference gate does not see a planted fault: {fault_err:.3e}")


def _kg_gaps(ref, got):
    """(|Δvalue| / |value|, max |Δ∇X_f| / max |∇X_f|, max |Δ∇θ| / max |∇θ|) of two
    ``_kg_slice_run`` results."""
    dv = abs(ref[0] - got[0]) / abs(ref[0])
    dx = (ref[1] - got[1]).abs().max().item() / ref[1].abs().max().item()
    return dv, dx, _grad_gap(ref[2], got[2])[0]


def phase_fantasy(model=None):
    """Phase 10: fantasy updates and the one-shot knowledge-gradient path on phase 7's
    trained flagship (alone, ``python3 -c 'import chip_smoke; chip_smoke.phase_fantasy()'``,
    on phase 5's model from JAX_PARAMS).  Returns the readings for the report."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, _ = make_task(N_TRAIN, N_TEST, seed=0)
    if model is None:
        phase_device()
        phase_build()
        model = build_model(train_x, train_y, "cuda", torch.float32)
    dev = "cuda"
    cand = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    model.eval()
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(False)
    shapes = _fantasy_kernel_shapes(model)

    # 1-2: the fantasy points, then conditioning on them (the old strategy built), timed
    with eval_settings():
        model.refresh()
    xf, yf = _fantasy_points(model, cand)
    counts = lambda: (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches,  # noqa: E731
                      fk.kernel_bwd_fused_cuda.launches)
    times = []
    with eval_settings(), torch.no_grad(), settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        for _ in range(FANT_REPS):
            fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
            sync(dev)
            t0 = time.perf_counter()
            fantasy = model.get_fantasy_model(xf, yf)
            sync(dev)
            times.append(time.perf_counter() - t0)
            launches = counts()
        cg = model.prediction_strategy().lik_train_train_covar.last_cg_result
    fantasy_ms = 1e3 * sorted(times)[len(times) // 2]
    print(f"[fantasy] fantasy_ms: median {fantasy_ms:.3f} ms over {FANT_REPS} get_fantasy_model calls "
          f"({[round(1e3 * t_, 3) for t_ in times]}); {FANT_Q} fantasy points; the {FANT_Q}-column CG against the old "
          f"K + σ²I took {cg.num_iters} iterations (relative residual {cg.residual_norm.max().item():.3e}); launches "
          f"kernel_matvec, kernel_grad_x, kernel_bwd_fused {launches} (expected ({cg.num_iters}, 0, 0))", flush=True)
    check(launches == (cg.num_iters, 0, 0), f"conditioning launched {launches}, expected ({cg.num_iters}, 0, 0)")

    # 3: against a refit on the n + 16 points (a new mean cache by CG); the LOVE variances
    # of both come from the same joint operator and start block
    refit = build_model(train_x, train_y, dev, torch.float32)
    refit.load_state_dict(model.state_dict())
    refit.set_train_data(fantasy.train_inputs[0], fantasy.train_targets, strict=False)
    refit.eval()
    with eval_settings(), torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        fantasy.refresh()
        sync(dev)
        fantasy_love_s = time.perf_counter() - t0
        refit_cg = refit.refresh().lik_train_train_covar.last_cg_result
        post_f, post_r = fantasy(cand), refit(cand)
        mean_f, mean_r = post_f.mean.double(), post_r.mean.double()
        var_f, var_r = post_f.variance.double(), post_r.variance.double()
        u_f, u_r = fantasy.prediction_strategy().mean_cache, refit.prediction_strategy().mean_cache
        old_u = model.prediction_strategy().mean_cache
        # the planted fault: the update without its −(A⁻¹B)v term
        u_fault = torch.cat([old_u, u_f[N_TRAIN:]])
        full_x = fantasy.train_inputs[0]
        kern = fantasy.covar_module
        cross = kern(cand, full_x)
        mean_fault = (cross.matmul(u_fault.unsqueeze(-1)).squeeze(-1) + fantasy.mean_module(cand)).double()
        # float64 bracket: the means from both caches by the float64 plain path, and each
        # cache's true residual against the joint system
        with plain_kernels():
            ref = _float64_twin(refit, full_x.cpu().numpy(), fantasy.train_targets.cpu().numpy())
            k64 = ref.covar_module
            x64, c64 = full_x.double(), cand.double()
            mean64 = {name: (k64(c64, x64).matmul(u.double().unsqueeze(-1)).squeeze(-1) + ref.mean_module(c64))
                      for name, u in (("fantasy", u_f), ("refit", u_r))}
            y64 = fantasy.train_targets.double() - ref.mean_module(x64)
            joint = ref.likelihood(ref.forward(x64)).lazy_covariance_matrix.evaluate_kernel()
            res = y64.unsqueeze(-1) - joint.matmul(torch.stack([u_f, u_r], -1).double())
            true_res = (res.norm(dim=0) / y64.norm()).tolist()
    scale = mean_r.abs().max().item()
    gap, gap64 = ((a - b).abs().max().item() / scale for a, b in ((mean_f, mean_r), (mean64["fantasy"], mean64["refit"])))
    fault_gap = (mean_fault - mean_r).abs().max().item() / scale
    var_gap = ((var_f - var_r).abs() / var_r).max().item()
    print(f"[fantasy] against a refit on {N_TRAIN + FANT_Q} points (refresh CG {refit_cg.num_iters} iterations): mean "
          f"max |Δ| / max |μ| {gap:.3e} (tol {FANT_MEAN_TOL}); float64 bracket: the same caches through the float64 "
          f"plain path {gap64:.3e}, their float64 true residuals |y − μ − K̂u| / |y − μ| fantasy {true_res[0]:.3e}, "
          f"refit {true_res[1]:.3e}; planted fault (no −(A⁻¹B)v) {fault_gap:.3e}; LOVE variances max |Δ| / σ² "
          f"{var_gap:.3e} ({var_r.min().item():.6e} to {var_r.max().item():.6e}); the fantasy's LOVE cache on the "
          f"joint operator {fantasy_love_s:.3f} s", flush=True)
    finite = bool(torch.isfinite(mean_f).all()) and bool((var_f > 0).all())
    check(finite, "the fantasy model's mean not finite or a variance ≤ 0")
    check(gap <= FANT_MEAN_TOL, f"the fantasy mean differs from a refit's by {gap:.3e}")
    check(fault_gap > FANT_MEAN_TOL, f"the fantasy gate does not see a planted fault: {fault_gap:.3e}")
    check(var_gap <= 1e-6, f"the fantasy's LOVE variances differ from a refit's by {var_gap:.3e}")

    # 4: the gradient of Σμ* with respect to X_f, the hyperparameters live, at eval tolerance
    # KG_TOL (the configuration that step 4b gates at N=KG_SLICE_N), timed
    for p in params:
        p.requires_grad_(True)
    kg_times, kg_launches, forward = [], [], []
    with eval_settings(), settings.eval_cg_tolerance(KG_TOL):
        for _ in range(FANT_REPS):
            model.prediction_strategy()
            fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
            forward.clear()
            sync(dev)
            t0 = time.perf_counter()
            value, gxf, grads, _ = kg_gradient(model, xf, yf, cand, forward)
            sync(dev)
            kg_times.append(time.perf_counter() - t0)
            kg_launches.append(counts())
    kg_grad_s = sorted(kg_times)[len(kg_times) // 2]
    finite = bool(torch.isfinite(gxf).all()) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    backward = tuple(a - b for a, b in zip(kg_launches[-1], forward))
    print(f"[fantasy] kg_grad_s (eval tolerance {KG_TOL}; its gradient unresolved at N={N_TRAIN}, see below): median "
          f"{kg_grad_s:.3f} s over {FANT_REPS} evaluations of ∇Σμ* (X_f and the hyperparameters; "
          f"{[round(t_, 3) for t_ in kg_times]}); Σμ* {value.item():.6f}; launches kernel_matvec, kernel_grad_x, "
          f"kernel_bwd_fused {kg_launches[-1]}: forward {tuple(forward)} (the CG of the mean cache, the {FANT_Q}-column "
          f"CG and the mean strip), backward {backward} (two CG solves, the strip's dv and dos, its dx and dx2, and the "
          f"symmetric backward at t=1 and t={FANT_Q}); max |∇X_f| {gxf.abs().max().item():.4e}; gradients finite "
          f"{finite}", flush=True)
    check(finite, "the knowledge-gradient step's gradient is not finite")
    check(backward[1:] == (2, 2), f"the knowledge-gradient step's backward launched kernel_grad_x, kernel_bwd_fused "
                                  f"{backward[1:]}, expected (2, 2)")

    # Read, not gated: the step at eval's own tolerance 1e-3, and a float32 central
    # difference in X_f along the timed step's gradient.  At N=100k the fantasy's effect on
    # Σμ* is carried by the posterior covariance Σ(x*, X_f) = K(x*, X_f) − K*x A⁻¹B, ≈ 1e-3
    # of the outputscale, near the float32 caches' true residuals (1.2e-3-1.6e-3, the refit
    # check above); the float32 CG hardly reaches KG_TOL there (the step's forward took
    # 1,712 products on an H100), and no float64 reference at this size ends in the time limit
    # (``kg_float64_witness``), so neither float32 gradient is known to be right here.
    direction = gxf / gxf.norm()
    with eval_settings(), settings.eval_cg_tolerance(KG_TOL):
        fd = _kg_xf_central_difference(model, xf, yf, cand, direction, KG_FD_H)
    with eval_settings():
        _, g_loose, g_theta, _ = kg_gradient(model, xf, yf, cand)
    theta = [math.sqrt(sum(float((g_ * g_).sum()) for g_ in gs.values())) for gs in (grads, g_theta)]
    print(f"[fantasy] float32 at N={N_TRAIN}, not gated: ∇X_f along its own direction {gxf.norm().item():.6e} at eval "
          f"tolerance {KG_TOL}, {float((g_loose * direction).sum()):.6e} at 1e-3; a central difference (h={KG_FD_H}) "
          f"{fd:.6e}; max |∇X_f| {gxf.abs().max().item():.4e} and "
          f"{g_loose.abs().max().item():.4e}; |∇θ| {theta[0]:.4e} and {theta[1]:.4e}", flush=True)
    for p in params:
        p.requires_grad_(False)

    # 4b: at N=KG_SLICE_N, the directional derivative against central differences (float64,
    # the plain path on the card), then CUDA float32 against a CPU float64 plain run
    _kg_fd_check()
    pins = PinnedPivots()
    with pins.record():
        cuda_run = _kg_slice_run("cuda", torch.float32)
    with pins.replay():
        cpu64 = _kg_slice_run("cpu", torch.float64)
    with pins.replay():
        cpu32 = _kg_slice_run("cpu", torch.float32)
    with pins.replay(), planted_grad_x_fault(1 - KG_FAULT_EPS):
        fault_x = _kg_gaps(cpu64, _kg_slice_run("cpu", torch.float64))
    with pins.replay(), planted_bwd_fault(1 - KG_FAULT_EPS):
        fault_theta = _kg_gaps(cpu64, _kg_slice_run("cpu", torch.float64))
    gaps, floor = _kg_gaps(cpu64, cuda_run), _kg_gaps(cpu64, cpu32)
    print(f"[fantasy] N={KG_SLICE_N}: CUDA float32 against CPU float64 (pinned pivots, eval tolerance "
          f"{KG_TOL}): Σμ* {gaps[0]:.3e}, ∇X_f {gaps[1]:.3e}, ∇θ {gaps[2]:.3e} (tol {KG_SLICE_TOL}); CPU "
          f"float32 against float64 {floor[0]:.3e}, {floor[1]:.3e}, {floor[2]:.3e}; planted faults, float64: grad_x's "
          f"dx1 and dx2 × (1 − {KG_FAULT_EPS}) {fault_x[0]:.3e}, {fault_x[1]:.3e}, {fault_x[2]:.3e}; the symmetric "
          f"backward's dx and dos × (1 − {KG_FAULT_EPS}) {fault_theta[0]:.3e}, {fault_theta[1]:.3e}, "
          f"{fault_theta[2]:.3e}", flush=True)
    check(gaps[1] <= KG_SLICE_TOL[0] and gaps[2] <= KG_SLICE_TOL[1],
          f"N={KG_SLICE_N} knowledge-gradient gradients differ: {gaps}")
    check(fault_x[1] > KG_SLICE_TOL[0], f"the N={KG_SLICE_N} ∇X_f gate does not see a planted grad_x fault: {fault_x}")
    check(fault_theta[2] > KG_SLICE_TOL[1], f"the N={KG_SLICE_N} ∇θ gate does not see a planted backward fault: "
                                            f"{fault_theta}")
    return {"fantasy_ms": fantasy_ms, "kg_grad_s": kg_grad_s, "launches": kg_launches[-1], "shapes": shapes,
            "conditioning_launches": launches}


def _kg_xf_gradient(model, xf, yf, cand):
    """Σμ* of ``model`` conditioned on (``xf``, ``yf``) and its gradient with respect to
    ``xf`` alone, as ``kg_gradient`` computes them with the hyperparameters frozen."""
    import torch

    from gpytorch_tpu_torch import settings

    xg = xf.detach().clone().requires_grad_(True)
    with settings.detach_test_caches(False), settings.skip_posterior_variances(True), \
            settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        value = model.get_fantasy_model(xg, yf)(cand).mean.sum()
    return value.item(), torch.autograd.grad(value, xg)[0].detach().double().cpu()


def _kg_xf_central_difference(model, xf, yf, cand, direction, h):
    """(Σμ*(xf + h d) − Σμ*(xf − h d)) / 2h on ``model``'s mean cache, built once."""
    import torch

    from gpytorch_tpu_torch import settings

    d = direction.to(dtype=xf.dtype, device=xf.device)
    with torch.no_grad(), settings.skip_posterior_variances(True), \
            settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        model.prediction_strategy().mean_cache
        up, down = (model.get_fantasy_model(xf + s_ * h * d, yf)(cand).mean.sum().item() for s_ in (1, -1))
    return (up - down) / (2 * h)


def kg_float64_witness(n: int = N_TRAIN, device: str = "cuda"):
    """A witness, not in ``main``: the knowledge-gradient step's ∇X_f at ``n`` training
    points from JAX_PARAMS (``python3 -c 'import chip_smoke; chip_smoke.kg_float64_witness(8192,
    "cpu")'``), in float32 at eval tolerances 1e-3 and KG_TOL (through the kernels on the
    card, the plain versions on the CPU), against the float64 plain path at KG_WITNESS_TOL,
    whose own directional derivative is read beside a central difference along it.  Reads,
    and gates nothing.  On an H100 the float64 step at n=100k did not end in 950 s."""
    import torch

    from gpytorch_tpu_torch import settings

    if device == "cuda":
        phase_device()
        phase_build()
    train_x, train_y, test_x, _ = make_task(n, N_TEST, seed=0)
    model = build_model(train_x, train_y, device, torch.float32)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    cand = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    xf, yf = _fantasy_points(model, cand)
    runs = {}
    for tol in (1e-3, KG_TOL):
        with eval_settings(), settings.eval_cg_tolerance(tol):
            model.clear_caches()
            model.prediction_strategy()
            sync(device)
            t0 = time.perf_counter()
            runs[tol] = _kg_xf_gradient(model, xf, yf, cand) + (time.perf_counter() - t0,)
        print(f"[kg-witness] N={n}, float32 at eval tolerance {tol}: Σμ* {runs[tol][0]:.6f}, max |∇X_f| "
              f"{runs[tol][1].abs().max().item():.4e}, the step {runs[tol][2]:.3f} s", flush=True)
    ref = build_model(train_x, train_y, device, torch.float64)
    ref.eval()
    for p in ref.parameters():
        p.requires_grad_(False)
    xf64, yf64, cand64 = xf.double(), yf.double(), cand.double()
    with eval_settings(), plain_kernels(), settings.eval_cg_tolerance(KG_WITNESS_TOL), \
            settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64), counted_products() as count:
        ref.prediction_strategy()
        t0 = time.perf_counter()
        value, grad = _kg_xf_gradient(ref, xf64, yf64, cand64)
        secs, products = time.perf_counter() - t0, count[0]
        exact = grad.norm().item()
        direction = grad / exact
        fd = _kg_xf_central_difference(ref, xf64, yf64, cand64, direction, KG_FD_H)
    print(f"[kg-witness] N={n}, float64 plain path (eval tolerance {KG_WITNESS_TOL}): Σμ* {value:.9f}; ∇X_f along its "
          f"own direction {exact:.6e}, central difference (h={KG_FD_H}) {fd:.6e}, |Δ| / |fd| "
          f"{abs(exact - fd) / abs(fd):.3e}; the step (its mean cache included) {products} products, {secs:.1f} s",
          flush=True)
    for tol, (v, g, _) in runs.items():
        gap = (g - grad).abs().max().item() / grad.abs().max().item()
        cos = float((g * grad).sum()) / (g.norm().item() * exact)
        print(f"[kg-witness] float32 at {tol} against float64: Σμ* Δ {v - value:.3e}; max |Δ∇X_f| / max |∇X_f| "
              f"{gap:.3e}, cosine {cos:.4f}", flush=True)


def _nan_targets(train_y, seed=NAN_SEED):
    y = np.array(train_y, dtype=np.float64)
    y[np.random.default_rng(seed).choice(len(y), int(NAN_FRACTION * len(y)), replace=False)] = np.nan
    return y


def _nan_loss(model, policy, probes, budget=PC_NOISE_BUDGET, extra=()):
    """−MLL and its gradient under the training recipe's CG (cold, max_cg_iterations 1000)
    with NaN targets treated by ``policy``; returns (loss, {name: ∇})."""
    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch import settings

    model.train()
    model.zero_grad()
    with train_settings(budget), settings.max_cg_iterations(1000), settings.observation_nan_policy(policy), \
            contextlib.ExitStack() as stack:
        for ctx in extra:
            stack.enter_context(ctx)
        mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)
        loss = -mll(model(model.train_inputs[0]), model.train_targets, base_samples=probes)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}


def phase_missing():
    """Phase 10b: the flagship's data with NAN_FRACTION of the targets NaN.  At N=100k one
    loss and gradient under "fill" and one under "mask" (the masked operator has no
    preconditioner, as in the JAX package), with their CG iterations and seconds; at
    N=KG_SLICE_N both policies CUDA float32 against CPU float64 (pinned pivots), and "mask"
    against the ordinary MLL on the observed subset in float64 on the CPU."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, _, _ = make_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    model = build_model(train_x, _nan_targets(train_y), dev, torch.float32)
    readings = {}
    for policy in ("fill", "mask"):
        secs = []
        for _ in range(2):  # the first call also loads the solvers' libraries
            fk.kernel_matvec_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
            sync(dev)
            t0 = time.perf_counter()
            loss, grads = _nan_loss(model, policy, InjectedProbes(0))
            sync(dev)
            secs.append(time.perf_counter() - t0)
        finite = math.isfinite(loss.item()) and all(bool(torch.isfinite(g).all()) for g in grads.values())
        readings[policy] = (fk.kernel_matvec_cuda.launches, secs[1])
        print(f"[missing] N={N_TRAIN}, {int(NAN_FRACTION * N_TRAIN)} targets NaN, policy {policy!r}: loss "
              f"{loss.item():.6f}, one loss and gradient {secs[1]:.3f} s (the first call {secs[0]:.3f} s), CG "
              f"iterations {fk.kernel_matvec_cuda.launches} (one t=64 product each), kernel_bwd_fused "
              f"{fk.kernel_bwd_fused_cuda.launches}; finite {finite}", flush=True)
        check(finite, f"policy {policy}: the loss or a gradient is not finite")
        check(fk.kernel_bwd_fused_cuda.launches == 1, f"policy {policy}: kernel_bwd_fused launched "
                                                      f"{fk.kernel_bwd_fused_cuda.launches} times, expected 1")

    sx, sy, _, _ = make_task(KG_SLICE_N, 0, seed=7)
    sy = _nan_targets(sy)
    for policy in ("fill", "mask"):
        pins, products, runs = PinnedPivots(), {}, {}
        for name, device, dtype, budget, fault, plain in (
                ("kernels", dev, torch.float32, PC_NOISE_BUDGET, 1.0, False),
                ("plain", dev, torch.float32, PC_NOISE_BUDGET, 1.0, True),
                ("kernel fault", dev, torch.float32, PC_NOISE_BUDGET, 1 - NAN_FAULT_EPS, False),
                ("float64", "cpu", torch.float64, PC_NOISE_BUDGET_F64, 1.0, False),
                ("float32", "cpu", torch.float32, PC_NOISE_BUDGET, 1.0, False),
                ("fault", "cpu", torch.float64, PC_NOISE_BUDGET_F64, 15 / 16, False)):
            with (pins.replay() if runs else pins.record()), planted_bwd_fault(fault), \
                    (plain_kernels() if plain else contextlib.nullcontext()), counted_products() as count:
                runs[name] = _nan_loss(build_model(sx, sy, device, dtype), policy, InjectedProbes(1), budget)
            products[name] = count[0]

        def gaps(a, b):
            return abs(a[0].item() - b[0].item()) / max(abs(b[0].item()), 1.0), _grad_gap(b[1], a[1])[0]

        (d_loss, d_grad), plain, floor, fault = (gaps(runs[r], runs["float64"]) for r in
                                                 ("kernels", "plain", "float32", "fault"))
        k_loss, k_grad = gaps(runs["kernels"], runs["plain"])
        k_fault = gaps(runs["kernel fault"], runs["plain"])
        worst = {name: max(_grad_gap(runs["float64"][1], runs[name][1])[1].items(), key=lambda kv: kv[1])[0]
                 for name in ("kernels", "float32")}
        print(f"[missing] N={KG_SLICE_N} policy {policy!r}: the kernels against their plain versions on the card "
              f"(float32 both) loss {k_loss:.3e}, gradients {k_grad:.3e} (tol {NAN_KERNEL_TOL}; the backward's dx and "
              f"dos × (1 − {NAN_FAULT_EPS}) {k_fault[0]:.3e}, {k_fault[1]:.3e}); CUDA float32 against CPU float64 loss "
              f"{d_loss:.3e}, gradients {d_grad:.3e} (tol {NAN_SLICE_TOL}); the plain versions on the card against "
              f"float64 {plain[0]:.3e}, {plain[1]:.3e}; CPU float32 against float64 {floor[0]:.3e}, {floor[1]:.3e}; "
              f"planted fault (float64, the backward's dx and dos × 15/16) {fault[1]:.3e}; products (CG iterations) "
              f"{products}; the largest gradient gap from float64 in {worst['kernels']} (CUDA), {worst['float32']} "
              f"(CPU float32)", flush=True)
        check(k_loss <= NAN_KERNEL_TOL and k_grad <= NAN_KERNEL_TOL, f"N={KG_SLICE_N} policy {policy}: the kernels "
              f"against their plain versions on the card: loss {k_loss:.3e}, grads {k_grad:.3e}")
        check(k_fault[1] > NAN_KERNEL_TOL, f"N={KG_SLICE_N} policy {policy}: the kernel gate does not see a planted fault")
        check(d_loss <= NAN_SLICE_TOL and d_grad <= NAN_SLICE_TOL, f"N={KG_SLICE_N} policy {policy}: CUDA against "
                                                                    f"CPU float64 loss {d_loss:.3e}, grads {d_grad:.3e}")
        check(fault[1] > NAN_SLICE_TOL, f"N={KG_SLICE_N} policy {policy}: the gate does not see a planted fault")

    # "mask" against the observed subset, float64 on the CPU, the subset's probes the masked
    # run's restricted to the observed rows (the masked rows scaled so that each probe's
    # squared norm per row is the same over the observed rows as over all)
    sx, sy, _, _ = make_task(NAN_SUBSET_N, 0, seed=9)
    sy = _nan_targets(sy)
    observed = ~np.isnan(sy)
    n_obs = int(observed.sum())
    draws = {}

    def masked_draw(shape):
        z = InjectedProbes(2)(shape)
        z[~observed] *= np.sqrt((z[observed] ** 2).sum(0) * (NAN_SUBSET_N - n_obs)
                                / (n_obs * (z[~observed] ** 2).sum(0)))
        draws[shape] = z
        return z

    tight = (settings.cg_tolerance(1e-10), settings.max_lanczos_quadrature_iterations(100),
             settings.num_trace_samples(8), settings.max_preconditioner_size(0), settings.cg_stall_window(50),
             settings.max_cg_iterations(2 * NAN_SUBSET_N + 10), settings.cg_lagged_rhs(False))
    masked = _nan_loss(build_model(sx, sy, "cpu", torch.float64), "mask", masked_draw, PC_NOISE_BUDGET_F64, tight)[0]
    subset = _nan_loss(build_model(sx[observed], sy[observed], "cpu", torch.float64), "ignore",
                       lambda shape: draws[(NAN_SUBSET_N,) + tuple(shape[1:])][observed], PC_NOISE_BUDGET_F64, tight)[0]
    gap = abs(masked.item() * NAN_SUBSET_N - subset.item() * n_obs) / abs(subset.item() * n_obs)
    print(f"[missing] N={NAN_SUBSET_N} float64: \"mask\" MLL × N {-masked.item() * NAN_SUBSET_N:.6f} against the observed "
          f"subset's MLL × N_obs {-subset.item() * n_obs:.6f}: relative gap {gap:.3e} (tol {NAN_SUBSET_TOL})",
          flush=True)
    check(gap <= NAN_SUBSET_TOL, f"the masked MLL differs from the observed subset's by {gap:.3e}")
    return readings

def build_kiss_model(train_x, train_y, device, dtype, grid_size, grid_bounds, lengthscale):
    """ConstantMean + GridInterpolationKernel(ScaleKernel(RBFKernel())) + GaussianLikelihood
    with noise ≥ 2e-2 (KISS-GP, BASELINE config 3) on ``device``, on a grid of ``grid_size``
    points a dimension over ``grid_bounds``, at noise 0.1 and ``lengthscale``, in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    class KissGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.GridInterpolationKernel(
                gt.kernels.ScaleKernel(gt.kernels.RBFKernel()), grid_size=grid_size, num_dims=len(grid_bounds),
                grid_bounds=grid_bounds)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx = torch.as_tensor(train_x, dtype=dtype, device=device)
    ty = torch.as_tensor(train_y, dtype=dtype, device=device)
    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    model = KissGP(tx, ty, likelihood).to(device=device, dtype=dtype)
    model.likelihood.noise = 0.1
    model.covar_module.base_kernel.base_kernel.lengthscale = lengthscale
    return model.train()


def _kiss_run(tag, train_x, train_y, test_x, test_y, grid_size, grid_bounds, lengthscale, steps):
    """KISS-GP at full width: Wᵀ· twice on the card (bit for bit), ``steps`` Adam steps at
    lr 0.1 under bench.py's training solver settings, then served under the eval settings:
    refresh, a request of all the test points (mean and LOVE variances), the LOVE sample
    cache and SAMPLES draws, and the exact interpolated branch on KISS_EXACT_ROWS of the
    points against LOVE's variances there.  No CUDA kernel may launch.  Returns the
    readings and the trained model."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk
    from gpytorch_tpu_torch.ops.interp import left_t_interp

    dev = "cuda"
    torch.cuda.reset_peak_memory_stats()
    model = build_kiss_model(train_x, train_y, dev, torch.float32, grid_size, grid_bounds, lengthscale)
    tx, cand = model.train_inputs[0], torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)
    m = math.prod(model.covar_module.grid_sizes)

    # Wᵀ·, a segment sum over the sorted interpolation indices, twice on 64 columns
    with torch.no_grad():
        op = model.covar_module(tx).evaluate_kernel()
        rhs = torch.randn(tx.shape[0], 64, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        a = left_t_interp(op.left_interp_indices, op.left_interp_values, rhs, m)
        b = left_t_interp(op.left_interp_indices, op.left_interp_values, rhs, m)
        ref = left_t_interp(op.left_interp_indices.cpu(), op.left_interp_values.double().cpu(), rhs.double().cpu(), m)
    same = bool(torch.equal(a, b))
    wt_err = (a.double().cpu() - ref).abs().max().item() / ref.abs().max().item()
    print(f"[{tag}] N={tx.shape[0]}, grid {model.covar_module.grid_sizes} (m={m}), {op.left_interp_indices.shape[-1]} "
          f"interpolation weights a row; Wᵀ· on 64 columns twice on the card: bit-identical {same}; against float64 "
          f"on the CPU max |Δ| / max {wt_err:.3e}", flush=True)
    check(same, f"{tag}: two runs of Wᵀ· on the card differ")

    fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
    ppk.periodic_matvec_cuda.launches = ppk.periodic_bwd_fused_cuda.launches = 0
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(tx.shape[0], 1, dtype=torch.float32, device=dev)
    times, losses, iters = [], [], []
    for step in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss, state = mll_loss(model, generator, state)
        loss.backward()
        optimizer.step()
        ok = finite_step(loss, model)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        iters.append(state.num_iters)
        check(ok, f"{tag} training step {step}: non-finite loss or gradient")
    train_peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
    kern = model.covar_module.base_kernel
    print(f"[{tag}] {steps} Adam steps (lr 0.1; CG tolerance 0.3, 63 probes, rank-50 preconditioner): median "
          f"{step_ms:.3f} ms/step over steps 1-{steps - 1} (first {1e3 * times[0]:.1f} ms); loss {losses[0]:.5f} → "
          f"{losses[-1]:.5f}; CG iterations {iters}; lengthscale {kern.base_kernel.lengthscale.item():.5f}, "
          f"outputscale {kern.outputscale.item():.5f}, noise {model.likelihood.noise.item():.5f}; peak device memory "
          f"{train_peak / 2**20:.1f} MiB", flush=True)

    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    torch.cuda.reset_peak_memory_stats()
    with eval_settings(), torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        strategy = model.refresh()
        sync(dev)
        refresh_ms = 1e3 * (time.perf_counter() - t0)
        cg = strategy.lik_train_train_covar.last_cg_result
        secs = []
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            post = model(cand)
            mean, var = post.mean, post.variance
            sync(dev)
            secs.append(time.perf_counter() - t0)
        request_ms = 1e3 * sorted(secs)[1]
        with settings.fast_pred_samples(True):
            sync(dev)
            t0 = time.perf_counter()
            strategy.interp_sample_cache
            sync(dev)
            sample_cache_ms = 1e3 * (time.perf_counter() - t0)
            draw_secs, gen = [], torch.Generator(device=dev).manual_seed(SAMPLE_SEED)
            for _ in range(3):
                sync(dev)
                t0 = time.perf_counter()
                draws = model(cand).rsample((KISS_SAMPLES,), base_samples=gen)
                sync(dev)
                draw_secs.append(time.perf_counter() - t0)
            draw_ms = 1e3 * sorted(draw_secs)[1]
    serve_peak = torch.cuda.max_memory_allocated()
    launches = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches,
                ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)

    # the float64 twin on the card (the same raw parameters and grid): the float32 path's
    # reference, and the exact interpolated branch on KISS_EXACT_ROWS points
    twin = build_kiss_model(train_x, train_y, dev, torch.float64, grid_size, grid_bounds, lengthscale).eval()
    with torch.no_grad():
        for name, p in twin.named_parameters():
            p.copy_(dict(model.named_parameters())[name])
            p.requires_grad_(False)
    rows = slice(None, None, len(cand) // KISS_EXACT_ROWS)
    c64 = cand.double()
    with eval_settings(), settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64), torch.no_grad():
        twin.refresh()
        post64 = twin(c64)
        mean64, var64 = post64.mean, post64.variance
        with settings.fast_pred_var(False), settings.eval_cg_tolerance(KISS_EXACT_CG_TOL), \
                settings.max_cg_iterations(KISS_EXACT_MAX_ITER):
            sync(dev)
            t0 = time.perf_counter()
            exact64 = twin(c64[rows]).variance
            sync(dev)
            exact_s = time.perf_counter() - t0
        exact_iters = twin.prediction_strategy().lik_train_train_covar.last_cg_result.num_iters
        prior64 = twin.covar_module(c64[rows], diag=True)
    # the float32 path again under a planted fault: the test side's W*· scaled by 15/16
    with eval_settings(), torch.no_grad(), planted_interp_fault():
        model.clear_caches()
        model.refresh()
        fault_post = model(cand)
        fault_mean, fault_var = fault_post.mean.double(), fault_post.variance.double()
    model.clear_caches()

    mean_scale, var_scale = mean64.abs().max().item(), prior64.max().item()
    mean_gap = (mean.double() - mean64).abs().max().item() / mean_scale
    var_gap = (var.double() - var64).abs().max().item() / var_scale
    fault_gaps = ((fault_mean - mean64).abs().max().item() / mean_scale,
                  (fault_var - var64).abs().max().item() / var_scale)
    love64 = var64[rows]
    undershoot = (exact64 - love64).max().item() / var_scale
    # read, not gated: the root doubled (σ² = k** − 4 |W* K_UU Wᵀ R|²), and the reference's gate
    doubled = (exact64 - (4.0 * love64 - 3.0 * prior64)).max().item() / var_scale
    rel = (love64 - exact64).abs() / exact64
    rmse = (mean - ty).square().mean().sqrt().item()
    finite = bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()) and bool(torch.isfinite(draws).all())
    positive = bool((var > 0).all())
    print(f"[{tag}] serving: refresh {refresh_ms:.1f} ms (mean cache CG {cg.num_iters} iterations, relative residual "
          f"{cg.residual_norm.max().item():.3e}; then K_UU Wᵀ·, the LOVE root and K_UU Wᵀ R), a request of "
          f"{len(cand)} points (mean and LOVE variances) {request_ms:.3f} ms, the sample cache (a Lanczos root of "
          f"K_UU − (K_UU Wᵀ R)(K_UU Wᵀ R)ᵀ on the grid) {sample_cache_ms:.1f} ms, a draw of {KISS_SAMPLES} samples "
          f"of {len(cand)} points {draw_ms:.3f} ms; peak device memory {serve_peak / 2**20:.1f} MiB", flush=True)
    print(f"[{tag}] rmse {rmse:.4f}; LOVE variances {var.min().item():.4e} to {var.max().item():.4e} (finite "
          f"{finite}, all > 0 {positive}); against the float64 twin on the card: mean max |Δ| / max |μ| "
          f"{mean_gap:.3e} (tol {KISS_MEAN_TOL}), LOVE variances max |Δσ²| / max k** {var_gap:.3e} (tol "
          f"{KISS_VAR_TOL}); planted fault (W*· × 15/16) {fault_gaps[0]:.3e}, {fault_gaps[1]:.3e}; "
          f"launches of the five CUDA kernels {launches} (expected none: no TPU kernel on this path)", flush=True)
    print(f"[{tag}] float64 twin, the exact interpolated branch on {len(exact64)} points (a {len(exact64)}-column CG at "
          f"tolerance {KISS_EXACT_CG_TOL}, {exact_iters} iterations, {exact_s:.2f} s; σ² {exact64.min().item():.4e} to "
          f"{exact64.max().item():.4e}, k** {var_scale:.4e}): max (σ²_exact − σ²_LOVE) / max k** {undershoot:.3e} (tol "
          f"{KISS_LOVE_TOL}; the LOVE root doubled {doubled:.3e}); read: LOVE against it max |Δσ²| / σ² "
          f"{rel.max().item():.3e}; gated: median {rel.median().item():.3e} (tol {KISS_LOVE_REL})", flush=True)
    check(sum(losses[-3:]) / 3 < losses[0], f"{tag}: the loss did not fall ({losses[0]:.5f} → {losses[-1]:.5f})")
    check(finite, f"{tag}: a mean, variance or draw is not finite")
    check(positive, f"{tag}: a LOVE variance ≤ 0 (min {var.min().item():.4e}): see ROADMAP queue 3")
    check(mean_gap <= KISS_MEAN_TOL and var_gap <= KISS_VAR_TOL, f"{tag}: float32 against the float64 twin: mean "
                                                                  f"{mean_gap:.3e}, variances {var_gap:.3e}")
    check(fault_gaps[0] > KISS_MEAN_TOL and fault_gaps[1] > KISS_VAR_TOL, f"{tag}: the float64 gates do not see a "
                                                                          f"planted fault: {fault_gaps}")
    check(undershoot <= KISS_LOVE_TOL, f"{tag}: LOVE variances fall below the exact branch's by {undershoot:.3e}")
    check(rel.median().item() <= KISS_LOVE_REL, f"{tag}: LOVE against the exact branch, median relative error "
                                                f"{rel.median().item():.3e}")
    check(launches == (0, 0, 0, 0, 0), f"{tag}: CUDA kernels launched {launches} on the KISS-GP path")
    return dict(model=model, step_ms=step_ms, refresh_ms=refresh_ms, request_ms=request_ms, draw_ms=draw_ms,
                sample_cache_ms=sample_cache_ms, love_rel=rel.max().item(), train_peak=train_peak,
                serve_peak=serve_peak, launches=launches[0])


@contextlib.contextmanager
def planted_interp_fault():
    """The test points' interpolation W*· of a KISS-GP request (``left_interp`` as the
    prediction strategies call it) scaled by 15/16: the mean scaled alike, the LOVE term
    |W* K_UU Wᵀ R|² by (15/16)²."""
    from gpytorch_tpu_torch.models import exact_prediction_strategies as eps

    sound = eps.left_interp
    eps.left_interp = lambda *args: sound(*args) * (15.0 / 16.0)
    try:
        yield
    finally:
        eps.left_interp = sound


def phase_kissgp():
    """Phase 11: KISS-GP in 1D at full width on the periodic task's time column (100,000
    five-minute readings; m = choose_grid_size = 100,000 grid points, a Toeplitz K_UU), the
    grid's bounds spanning the training readings and the forecast week (a dynamic grid would
    refit to the forecast's times at the request, as the JAX package's does, and the caches
    built on the old grid would not match it).  Returns ``_kiss_run``'s readings."""
    import gpytorch_tpu_torch as gt

    train_x, train_y, test_x, test_y = make_periodic_task(P_N_TRAIN, P_N_TEST)
    t_train, t_test = train_x[:, :1], test_x[:, :1]
    grid_size = gt.utils.grid.choose_grid_size(t_train)
    bounds = [(float(t_train.min()), float(t_test.max()))]
    return _kiss_run("kissgp", t_train, train_y, t_test, test_y, grid_size, bounds, KISS_LENGTHSCALE[0], KISS_STEPS)


def phase_kissgp_2d():
    """Phase 11b: KISS-GP in 2D on a Kronecker grid, the flagship task's first two inputs
    at N=100,000 (316 × 316 grid points, 16 interpolation weights a row)."""
    import gpytorch_tpu_torch as gt

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST, seed=0)
    x2, t2 = train_x[:, :2], test_x[:, :2]
    grid_size = gt.utils.grid.choose_grid_size(x2)
    return _kiss_run("kissgp 2d", x2, train_y, t2, test_y, grid_size, [(0.0, 1.0), (0.0, 1.0)],
                     KISS_LENGTHSCALE[1], KISS2_STEPS)


def _wiski_model(params, train_x, train_y, bounds, dtype=None):
    import torch

    dtype = torch.float32 if dtype is None else dtype
    model = build_kiss_model(train_x, train_y, "cuda", dtype, WISKI_GRID, bounds, KISS_LENGTHSCALE[0])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
            p.requires_grad_(False)
    return model.eval()


def phase_wiski(kiss_model):
    """Phase 11c: WISKI fantasy updates.  Phase 11's model on a 1D grid of WISKI_GRID points
    with phase 11's trained hyperparameters, conditioned WISKI_UPDATES times on FANT_Q new
    readings (the ones after the training readings) by ``get_fantasy_model``: the first call
    promotes the KISS-GP strategy to WISKI (WᵀW and Wᵀr from the 100,000 training rows), each
    later one adds its readings' terms.  wiski_fantasy_ms: the median over the updates of
    the update and a request of the rest of the forecast (mean and variance).  The mean is
    gated against a KISS-GP model rebuilt on all the points, beside a planted fault (the
    last update's terms left out)."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    train_x, train_y, test_x, test_y = make_periodic_task(P_N_TRAIN, P_N_TEST)
    t_train, t_test = train_x[:, :1], test_x[:, :1]
    bounds = [(float(t_train.min()), float(t_test.max()))]
    params = {k: p.detach() for k, p in kiss_model.named_parameters()}
    model = _wiski_model(params, t_train, train_y, bounds)
    dev = "cuda"
    new = FANT_Q * WISKI_UPDATES
    cand = torch.as_tensor(t_test[new:], dtype=torch.float32, device=dev)
    xs = torch.as_tensor(t_test[:new], dtype=torch.float32, device=dev)
    ys = torch.as_tensor(test_y[:new], dtype=torch.float32, device=dev)
    fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
    ppk.periodic_matvec_cuda.launches = ppk.periodic_bwd_fused_cuda.launches = 0
    times, request_times, models = [], [], [model]
    with eval_settings(), torch.no_grad():
        model.refresh()
        model(cand)
        for k in range(WISKI_UPDATES):
            sl = slice(k * FANT_Q, (k + 1) * FANT_Q)
            sync(dev)
            t0 = time.perf_counter()
            fantasy = models[-1].get_fantasy_model(xs[sl], ys[sl])
            sync(dev)
            t1 = time.perf_counter()
            post = fantasy(cand)
            mean, var = post.mean, post.variance
            sync(dev)
            times.append(t1 - t0)
            request_times.append(time.perf_counter() - t1)
            models.append(fantasy)
        strategy = type(models[-1]._cache["prediction_strategy"]).__name__
        short = models[-2](cand).mean.double()  # the planted fault: the last update left out
    launches = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches,
                ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)
    # the reference: the KISS-GP model rebuilt on all the points in float64, its mean cache a
    # CG solve at eval tolerance 1e-8; and read, WISKI's own updates in float64
    full_x, full_y = np.concatenate([t_train, t_test[:new]]), np.concatenate([train_y, test_y[:new]])
    with eval_settings(), settings.eval_cg_tolerance(1e-8), settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64), \
            torch.no_grad():
        rebuilt = _wiski_model(params, full_x, full_y, bounds, torch.float64)
        rebuilt.refresh()
        ref = rebuilt(cand.double()).mean
        wiski64 = _wiski_model(params, t_train, train_y, bounds, torch.float64)
        wiski64(cand.double())
        for k in range(WISKI_UPDATES):
            sl = slice(k * FANT_Q, (k + 1) * FANT_Q)
            wiski64 = wiski64.get_fantasy_model(xs[sl].double(), ys[sl].double())
        mean64 = wiski64(cand.double()).mean
    total = [a + b for a, b in zip(times, request_times)]
    wiski_ms = 1e3 * sorted(total)[len(total) // 2]
    scale = ref.abs().max().item()
    gap = (mean.double() - ref).abs().max().item() / scale
    gap64 = (mean64 - ref).abs().max().item() / scale
    fault = (short - ref).abs().max().item() / scale
    finite = bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    print(f"[wiski] grid {WISKI_GRID}, {WISKI_UPDATES} updates of {FANT_Q} readings ({strategy}): wiski_fantasy_ms "
          f"median {wiski_ms:.3f} ms (update + a request of {len(cand)} points: "
          f"{[round(1e3 * t_, 3) for t_ in times]} + {[round(1e3 * t_, 3) for t_ in request_times]} ms; the first "
          f"update builds WᵀW and Wᵀr from the {P_N_TRAIN} training rows); mean against a KISS-GP model rebuilt on "
          f"all {P_N_TRAIN + new} points (float64, CG to 1e-8) max |Δ| / max |μ| {gap:.3e} (tol {WISKI_MEAN_TOL}; "
          f"WISKI in float64 {gap64:.3e}); planted fault (the last update left out) {fault:.3e}; variances finite and "
          f"> 0 {finite}; launches of the five CUDA kernels {launches} (expected none)", flush=True)
    check(strategy == "WiskiPredictionStrategy", f"the fantasy model's strategy is {strategy}")
    check(finite, "a WISKI mean is not finite or a variance ≤ 0")
    check(gap <= WISKI_MEAN_TOL, f"the WISKI mean differs from a rebuilt model's by {gap:.3e}")
    check(fault > WISKI_MEAN_TOL, f"the WISKI gate does not see a planted fault: {fault:.3e}")
    check(launches == (0, 0, 0, 0, 0), f"CUDA kernels launched {launches} on the WISKI path")
    return dict(wiski_ms=wiski_ms, launches=launches[0])


def love_rank_model(n: int = 3000, device: str = "cpu"):
    """Phase 11's model at N=``n`` (the periodic task's time column, m = n grid points)
    trained KISS_STEPS steps in float64, in eval mode, and the forecast's first 256 readings,
    every 16th.  Returns (model, test points)."""
    import torch

    import gpytorch_tpu_torch as gt

    train_x, train_y, test_x, _ = make_periodic_task(n, 256)
    t_train, t_test = train_x[:, :1], test_x[:, :1]
    bounds = [(float(t_train.min()), float(t_test.max()))]
    model = build_kiss_model(t_train, train_y, device, torch.float64, gt.utils.grid.choose_grid_size(t_train), bounds,
                             KISS_LENGTHSCALE[0])
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    state = torch.zeros(n, 1, dtype=torch.float64, device=device)
    for _ in range(KISS_STEPS):
        optimizer.zero_grad()
        loss, state = mll_loss(model, torch.Generator(device=device).manual_seed(PROBE_SEED), state, PC_NOISE_BUDGET_F64)
        loss.backward()
        optimizer.step()
    return model.eval(), torch.as_tensor(t_test[::16], dtype=torch.float64, device=device)


def love_rank_readings(model, cand, ranks=(100, 300, 1000)):
    """LOVE's variances at each rank against the exact interpolated branch (eval tolerance
    1e-10), float64, printed and returned as [(rank, max |Δσ²| / σ², median)]."""
    import torch

    from gpytorch_tpu_torch import settings

    n, readings = model.train_inputs[0].shape[0], []
    with eval_settings(), settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64), torch.no_grad():
        model.clear_caches()
        with settings.fast_pred_var(False), settings.eval_cg_tolerance(1e-10), settings.max_cg_iterations(10 * n):
            exact = model(cand).variance
        for rank in ranks:
            model.clear_caches()
            with settings.max_root_decomposition_size(rank):
                love = model(cand).variance
            rel = (love - exact).abs() / exact
            readings.append((rank, rel.max().item(), rel.median().item()))
            print(f"[love rank] N={n}, m={n}, float64 on {cand.device}: LOVE of rank {rank} against the exact branch: "
                  f"max |Δσ²| / σ² {rel.max().item():.3e}, median {rel.median().item():.3e}, min (σ²_LOVE − σ²_exact) "
                  f"{(love - exact).min().item():.3e} (σ² {exact.min().item():.4e} to {exact.max().item():.4e}; "
                  f"lengthscale {model.covar_module.base_kernel.base_kernel.lengthscale.item():.5f} days)", flush=True)
    return readings


def love_rank_witness(n: int = 3000, device: str = "cpu", ranks=(100, 300, 1000)):
    """LOVE's variances against the exact interpolated branch as the Lanczos rank grows, on
    ``love_rank_model``'s model.  The reference's relative limit (0.05) holds once the rank
    passes the kernel's effective rank.  Not part of the run (about a minute at N=3,000 on
    four CPU threads): ``python3 -c 'import chip_smoke; chip_smoke.love_rank_witness()'``;
    ``tests/love_rank_witness.py`` reads the JAX package's LOVE on the same model."""
    model, cand = love_rank_model(n, device)
    return love_rank_readings(model, cand, ranks)


def love_gradient(model, xf, yf, cand, split=None):
    """The step of qNIPV: Σσ² (LOVE, ``fast_pred_var``) over ``cand`` of ``model``
    conditioned on (``xf``, ``yf``) under ``detach_test_caches(False)``, and its gradient
    with respect to the fantasy inputs and to the hyperparameters (the sum of the model's and
    its copy's).  The fantasy's LOVE root is a block-Lanczos run on the joint (n + m)
    operator with X_f's history; the gradient runs back through it.  ``split``, a list,
    receives the launches of the three kernels after the forward pass.  Returns (value,
    ∇X_f, {name: ∇})."""
    import torch

    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    xg = xf.detach().clone().requires_grad_(True)
    with settings.detach_test_caches(False), settings.fast_pred_var(True), \
            settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        fantasy = model.get_fantasy_model(xg, yf)
        value = fantasy(cand).variance.sum()
    if split is not None:
        split.extend((fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches, fk.kernel_bwd_fused_cuda.launches))
    own, copied = dict(model.named_parameters()), dict(fantasy.named_parameters())
    names = list(own)
    grads = torch.autograd.grad(value, [xg] + [own[k] for k in names] + [copied[k] for k in names], allow_unused=True)
    by_name = {}
    for k, a, b in zip(names, grads[1:1 + len(names)], grads[1 + len(names):]):
        by_name[k] = sum((g for g in (a, b) if g is not None), torch.zeros_like(own[k])).detach()
    return value.detach(), grads[0], by_name


def _dos_abs_sum(x, g, v, chunk: int = 2048) -> float:
    """Σ_ij |k(d2_ij) g_i·v_j| (RBF) in float64, streamed by blocks of rows: the scale of the
    terms that dos = Σ_ij k_ij g_i·v_j sums."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops.sq_dist import sq_dist_centered

    x, g, v = x.double(), g.double(), v.double()
    xc = x - x.mean(0, keepdim=True)
    total = 0.0
    for i in range(0, x.shape[0], chunk):
        k = fk._kernel_fn(sq_dist_centered(xc[i:i + chunk], xc), fk.RBF)
        total += (k * (g[i:i + chunk] @ v.mT).abs()).sum().item()
    return total


def _love_bwd_shape(model):
    """kernel_bwd_fused at the Lanczos blocks' shape (N=100k, d=3, t=20: dx and dos, no dv,
    the FMA tier) on the model's scaled training inputs and seeded g and v, by
    ``_bwd_against_float64``: dx at twice the plain float32 version's error, dos over
    Σ|k_ij g_i·v_j| at LG_DOS_TOL beside a planted fault."""
    import torch

    tx = model.train_inputs[0]
    ls = model.covar_module.base_kernel.lengthscale.detach()
    x = ((tx - tx.mean(0, keepdim=True)) / ls).contiguous()
    rng = np.random.default_rng(23)
    g, v = (torch.as_tensor(rng.normal(size=(N_TRAIN, 20)), dtype=torch.float32, device="cuda") for _ in range(2))
    return _bwd_against_float64(x, g, v, "love gradient", "a Lanczos block differentiated")


def _lg_gaps(ref, got):
    """(|Δvalue| / |value|, max |Δ∇X_f| / max |∇X_f|, max |Δ∇θ| / max |∇θ|)."""
    dv = abs(ref[0] - got[0]) / abs(ref[0])
    dx = (ref[1] - got[1]).abs().max().item() / ref[1].abs().max().item()
    return dv, dx, _grad_gap(ref[2], got[2])[0]


def _lg_cpu(run):
    value, gxf, grads = run
    return value.item(), gxf.detach().cpu().double(), {k: g.cpu().double() for k, g in grads.items()}


def _lg_slice_run(dtype, n=LG_SLICE_N):
    """The step at N=``n`` on the card from JAX_PARAMS: X_f every 32nd of 512 candidates,
    y_f their targets.  Returns (value, ∇X_f, {name: ∇}) on the CPU in float64."""
    import torch

    import gpytorch_tpu_torch as gt

    train_x, train_y, test_x, test_y = make_task(n, 512, seed=5)
    model = build_model(train_x, train_y, "cuda", dtype)
    cand = torch.as_tensor(test_x, dtype=dtype, device="cuda")
    xf, yf = cand[::32][:FANT_Q], torch.as_tensor(test_y[::32][:FANT_Q], dtype=dtype, device="cuda")
    budget = PC_NOISE_BUDGET_F64 if dtype == torch.float64 else PC_NOISE_BUDGET
    for p in model.parameters():
        p.requires_grad_(True)
    with eval_settings(min_preconditioning_size=1000), gt.settings.preconditioner_noise_budget(budget):
        model.prediction_strategy()
        return _lg_cpu(love_gradient(model, xf, yf, cand))


def _lg_fd_check():
    """Σσ²'s directional derivative along its own gradient (over X_f and the raw
    hyperparameters) against central differences at N=LG_FD_N, float64 plain path on the
    card, beside a planted fault (the symmetric backward dropped: the Lanczos root
    differentiated through nothing but its right-hand sides)."""
    import torch

    import gpytorch_tpu_torch as gt

    train_x, train_y, test_x, test_y = make_task(LG_FD_N, 256, seed=11)
    model = build_model(train_x, train_y, "cuda", torch.float64)
    cand = torch.as_tensor(test_x, dtype=torch.float64, device="cuda")
    xf, yf = cand[::16][:FANT_Q], torch.as_tensor(test_y[::16][:FANT_Q], dtype=torch.float64, device="cuda")
    params = list(model.parameters())
    names = [k for k, _ in model.named_parameters()]
    for p in params:
        p.requires_grad_(True)

    def value_at(direction, h):
        with torch.no_grad():
            for p, d_ in zip(params, direction[1:]):
                p.add_(h * d_)
        try:
            model.clear_caches()
            with torch.no_grad(), gt.settings.fast_pred_var(True), \
                    gt.settings.cg_tolerance(gt.settings.eval_cg_tolerance.value()):
                model.prediction_strategy()
                return model.get_fantasy_model(xf + h * direction[0], yf)(cand).variance.sum().item()
        finally:
            with torch.no_grad():
                for p, d_ in zip(params, direction[1:]):
                    p.sub_(h * d_)

    def along(direction, fault=1.0):
        model.prediction_strategy()
        with planted_bwd_fault(fault):
            _, g_x, g_p = love_gradient(model, xf, yf, cand)
        return float((g_x * direction[0]).sum()) + sum(float((g_p[k] * d_).sum()) for k, d_ in zip(names, direction[1:]))

    with eval_settings(min_preconditioning_size=1000), plain_kernels(), \
            gt.settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64):
        model.prediction_strategy()
        _, g_x, g_p = love_gradient(model, xf, yf, cand)
        direction = [g_x.detach()] + [g_p[k] for k in names]
        dd = math.sqrt(sum(float((d_ * d_).sum()) for d_ in direction))
        direction = [d_ / dd for d_ in direction]
        fd = (value_at(direction, LG_FD_H) - value_at(direction, -LG_FD_H)) / (2 * LG_FD_H)
        dd_fault = along(direction, 0.0)
    for p in params:
        p.requires_grad_(False)
    err, fault_err = abs(dd - fd) / abs(fd), abs(dd_fault - fd) / abs(fd)
    print(f"[love gradient] N={LG_FD_N}, float64 plain path: the directional derivative of Σσ² along its gradient over "
          f"X_f and the raw hyperparameters, autograd {dd:.8e}, central difference (h={LG_FD_H}) {fd:.8e}, |Δ| / |fd| "
          f"{err:.3e} (tol {LG_FD_TOL}); planted fault (the symmetric backward dropped) {dd_fault:.8e}, "
          f"{fault_err:.3e}", flush=True)
    check(err <= LG_FD_TOL, f"Σσ²'s derivative differs from central differences by {err:.3e}")
    check(fault_err > LG_FD_TOL, f"the central-difference gate does not see a planted fault: {fault_err:.3e}")


def phase_love_gradient(model=None):
    """Phase 12: LOVE differentiated through its Lanczos roots at full width — the step of
    BoTorch's qNegIntegratedPosteriorVariance: on phase 7's trained flagship (alone, phase
    5's model), one fantasy of FANT_Q points under ``detach_test_caches(False)`` and
    ``fast_pred_var``, Σσ² over the 2,048 test points and its gradient with respect to X_f
    and the hyperparameters (love_grad_ms, the median of LG_REPS), with the launches of the
    kernels by shape; at N=100k the kernels against their plain versions on the card (both
    float32); at N=LG_SLICE_N CUDA float32 against the float64 plain path on the card, beside
    planted faults; central differences in float64 at N=LG_FD_N; kernel_bwd_fused at the
    Lanczos blocks' shape (t=20) against float64.  Returns the readings for the report."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    train_x, train_y, test_x, _ = make_task(N_TRAIN, N_TEST, seed=0)
    if model is None:
        phase_device()
        phase_build()
        model = build_model(train_x, train_y, "cuda", torch.float32)
    dev = "cuda"
    cand = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    model.eval()
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(False)
    shape = _love_bwd_shape(model)
    with eval_settings():
        model.refresh()
    xf, yf = _fantasy_points(model, cand)
    for p in params:
        p.requires_grad_(True)
    times, launches, forward = [], [], []
    with eval_settings():
        for _ in range(LG_REPS):
            model.prediction_strategy()
            fk.kernel_matvec_cuda.launches = fk.kernel_grad_x_cuda.launches = fk.kernel_bwd_fused_cuda.launches = 0
            forward.clear()
            sync(dev)
            t0 = time.perf_counter()
            run = love_gradient(model, xf, yf, cand, forward)
            sync(dev)
            times.append(time.perf_counter() - t0)
            launches.append((fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches,
                             fk.kernel_bwd_fused_cuda.launches))
        model.prediction_strategy()
        with plain_kernels():
            plain = _lg_cpu(love_gradient(model, xf, yf, cand))
        full_faults = []
        for fault in (planted_grad_x_fault, planted_bwd_fault):
            model.prediction_strategy()
            with fault(1 - LG_FULL_FAULT_EPS):
                full_faults.append(_lg_gaps(plain, _lg_cpu(love_gradient(model, xf, yf, cand))))
    for p in params:
        p.requires_grad_(False)
    # read, not gated: the float64 plain path at N=100k (its solves at eval's tolerance, which
    # Σσ² does not depend on: the variances read the LOVE root alone)
    ref = build_model(train_x, train_y, dev, torch.float64, params=None)
    ref.load_state_dict({k: v.double() for k, v in model.state_dict().items()})
    ref.eval()
    with eval_settings(), plain_kernels(), gt.settings.preconditioner_noise_budget(PC_NOISE_BUDGET_F64):
        ref.prediction_strategy()
        sync(dev)
        t0 = time.perf_counter()
        full64 = _lg_cpu(love_gradient(ref, xf.double(), yf.double(), cand.double()))
        sync(dev)
        full64_s = time.perf_counter() - t0
    kernels = _lg_cpu(run)
    love_grad_ms = 1e3 * sorted(times)[len(times) // 2]
    backward = tuple(a - b for a, b in zip(launches[-1], forward))
    gaps = _lg_gaps(plain, kernels)
    finite = bool(torch.isfinite(kernels[1]).all()) and all(bool(torch.isfinite(g).all()) for g in kernels[2].values())
    print(f"[love gradient] love_grad_ms: median {love_grad_ms:.3f} ms over {LG_REPS} evaluations of ∇Σσ² over {N_TEST} "
          f"points (X_f and the hyperparameters; {[round(1e3 * t_, 3) for t_ in times]}); Σσ² {kernels[0]:.6f}; "
          f"launches kernel_matvec, kernel_grad_x, kernel_bwd_fused {launches[-1]}: forward {tuple(forward)} (the old "
          f"strategy's mean-cache CG, the {FANT_Q}-column CG, 5 Lanczos blocks t=20 on the joint {N_TRAIN + FANT_Q} "
          f"rows, the mean strip t=1 and K*x R t=100), backward {backward} (5 symmetric backwards t=20 with dv = K·g "
          f"t=20 for 4 of them, K*x R's dv and dos t=100 and its dx1 and dx2); gradients finite {finite}", flush=True)
    g64, p64 = _lg_gaps(full64, kernels), _lg_gaps(full64, plain)
    print(f"[love gradient] N={N_TRAIN}: the kernels against their plain versions on the card (float32 both): Σσ² "
          f"{gaps[0]:.3e}, ∇X_f {gaps[1]:.3e}, ∇θ {gaps[2]:.3e} (tol {LG_FULL_TOL}); planted faults in the kernel "
          f"path, grad_x × (1 − {LG_FULL_FAULT_EPS}) {full_faults[0][1]:.3e}, {full_faults[0][2]:.3e}; the symmetric "
          f"backward's dx and dos × (1 − {LG_FULL_FAULT_EPS}) {full_faults[1][1]:.3e}, {full_faults[1][2]:.3e}; read, "
          f"against the float64 plain path ({full64_s:.1f} s): the kernels {g64[0]:.3e}, {g64[1]:.3e}, {g64[2]:.3e}, "
          f"the plain float32 path {p64[0]:.3e}, {p64[1]:.3e}, {p64[2]:.3e}; max |∇X_f| "
          f"{kernels[1].abs().max().item():.4e}", flush=True)
    check(finite, "the LOVE gradient is not finite")
    check(backward == (6, 2, 5), f"the LOVE gradient's backward launched {backward}, expected (6, 2, 5)")
    check(gaps[1] <= LG_FULL_TOL and gaps[2] <= LG_FULL_TOL, f"N={N_TRAIN}: the LOVE gradient's kernels differ from "
                                                              f"their plain versions by {gaps}")
    check(full_faults[0][1] > LG_FULL_TOL and full_faults[1][2] > LG_FULL_TOL,
          f"N={N_TRAIN}: the LOVE gradient's kernel gate does not see a planted fault: {full_faults}")

    cuda32 = _lg_slice_run(torch.float32)
    with plain_kernels():
        ref = _lg_slice_run(torch.float64)
        plain32 = _lg_slice_run(torch.float32)
        with planted_grad_x_fault(1 - LG_FAULT_EPS):
            fault_x = _lg_gaps(ref, _lg_slice_run(torch.float64))
        with planted_bwd_fault(1 - LG_FAULT_EPS):
            fault_theta = _lg_gaps(ref, _lg_slice_run(torch.float64))
    slice_gaps, floor = _lg_gaps(ref, cuda32), _lg_gaps(ref, plain32)
    print(f"[love gradient] N={LG_SLICE_N}: CUDA float32 against the float64 plain path on the card: Σσ² "
          f"{slice_gaps[0]:.3e}, ∇X_f {slice_gaps[1]:.3e}, ∇θ {slice_gaps[2]:.3e}; the float32 plain path "
          f"{floor[0]:.3e}, {floor[1]:.3e}, {floor[2]:.3e}; planted faults, float64: grad_x × (1 − {LG_FAULT_EPS}) "
          f"{fault_x[0]:.3e}, {fault_x[1]:.3e}, {fault_x[2]:.3e}; the symmetric backward's dx and dos × "
          f"(1 − {LG_FAULT_EPS}) {fault_theta[0]:.3e}, {fault_theta[1]:.3e}, {fault_theta[2]:.3e} (tol "
          f"{LG_SLICE_TOL})", flush=True)
    check(slice_gaps[1] <= LG_SLICE_TOL[0] and slice_gaps[2] <= LG_SLICE_TOL[1],
          f"N={LG_SLICE_N}: the LOVE gradient differs from float64 by {slice_gaps}")
    check(fault_x[1] > LG_SLICE_TOL[0], f"N={LG_SLICE_N}: the ∇X_f gate does not see a planted grad_x fault: {fault_x}")
    check(fault_theta[2] > LG_SLICE_TOL[1], f"N={LG_SLICE_N}: the ∇θ gate does not see a planted backward fault: "
                                            f"{fault_theta}")
    _lg_fd_check()
    return {"love_grad_ms": love_grad_ms, "launches": launches[-1], "backward": backward, "shape": shape,
            "full_gaps": gaps, "slice_gaps": slice_gaps, "floor": floor, "fault_x": fault_x,
            "fault_theta": fault_theta}


def make_batch_task(n_train: int, n_test: int, seed: int = 0):
    """The two outputs of phase 13 on the flagship task's inputs: output 0 is
    ``make_task``'s target (the same draws), output 1 a second smooth function of the same
    inputs with other lengthscales (long in x₀, short in x₁) plus Gaussian noise of 0.1
    drawn with numpy from the seed; each standardised.  Returns x (n_train, D), y
    (2, n_train), the test inputs and targets (2, n_test), and each output's noise standard
    deviation in its standardised units."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_train + n_test, D))
    f0 = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * x[:, 2]
    y0 = f0 + 0.1 * rng.normal(size=n_train + n_test)
    f1 = np.cos(1.5 * x[:, 0] + 0.5) + 0.8 * np.sin(10 * x[:, 1]) * np.exp(-x[:, 2])
    y1 = f1 + 0.1 * np.random.default_rng([seed, 1]).normal(size=n_train + n_test)
    y = np.stack([(y0 - y0.mean()) / y0.std(), (y1 - y1.mean()) / y1.std()])
    return x[:n_train], y[:, :n_train], x[n_train:], y[:, n_train:], (0.1 / y0.std(), 0.1 / y1.std())


def build_batch_model(train_x, train_y, device, dtype, periodic=False):
    """Phase 13's batch-independent GP: the flagship's model (the periodic model's with
    ``periodic``) with a batch shape of one element per row of ``train_y`` on the kernel, the
    outputscale, the mean and the likelihood, on inputs shared by the outputs (broadcast to
    (b, n, d)), every element at the flagship's initial values, in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    b, d = np.shape(train_y)[0], np.shape(train_x)[1]

    class BatchGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            base = (gt.kernels.PeriodicKernel(ard_num_dims=d, batch_shape=(b,)) if periodic
                    else gt.kernels.RBFKernel(ard_num_dims=d, batch_shape=(b,)))
            self.mean_module = gt.means.ConstantMean(batch_shape=(b,))
            self.covar_module = gt.kernels.ScaleKernel(base, batch_shape=(b,))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx = torch.as_tensor(train_x, dtype=dtype, device=device)
    ty = torch.as_tensor(train_y, dtype=dtype, device=device)
    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR),
                                                   batch_shape=(b,))
    model = BatchGP(tx.expand((b,) + tx.shape), ty, likelihood).to(device=device, dtype=dtype)
    model.likelihood.noise = 0.1
    model.covar_module.base_kernel.lengthscale = 0.5
    if periodic:
        model.covar_module.base_kernel.period_length = P_PERIODS
    return model.train()


class BatchProbes:
    """Probe base samples of a batch: element i's from ``element(i)`` (an ``InjectedProbes``
    with i in its seed), stacked on the batch axis of the shapes (probes, b, …), so that an
    unbatched model of element i given ``element(i)`` draws the same probes."""

    def __init__(self, step: int, seed: int = PROBE_SEED):
        self.step, self.seed = step, seed

    def element(self, i: int) -> InjectedProbes:
        return InjectedProbes(self.step, seed=self.seed * 1000 + i)

    def __call__(self, shape):
        return np.stack([self.element(i)(shape[:1] + shape[2:]) for i in range(shape[1])], axis=1)


def batch_loss(model, base_samples, state, budget: float = PC_NOISE_BUDGET):
    """The mean over the outputs of −MLL per datum, by one batched mBCG under the training
    recipe with the rhs-only warm state; returns (loss, each element's MLL, state)."""
    import gpytorch_tpu_torch as gt

    tx, ty = model.train_inputs[0], model.train_targets
    with train_settings(budget):
        mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)
        value, state = mll(model(tx), ty, base_samples=base_samples, solver_state=state, return_state=True)
    return -value.mean(), value.detach(), state


def batch_quality(model, test_x, test_y, dev):
    """The batch model in eval mode, refreshed and asked for all test points under the eval
    settings: (rmse per output, marginal nlpd per output, the refresh's CG result, refresh
    s, request s, predictive variances)."""
    import torch

    model.eval()
    with eval_settings():
        cg, refresh_s, answers = serve(model, test_x, dev, [slice(0, test_x.shape[-2])])
    _, mean, var, secs = answers[0]
    check(bool(torch.isfinite(mean).all()) and bool((var > 0).all()), "batch: predictions not finite or variance ≤ 0")
    noise = model.likelihood.noise.reshape(-1)
    rmse = (mean - test_y).square().mean(-1).sqrt().tolist()
    nlpd = [marginal_nlpd(mean[i], var[i], test_y[i], noise[i]) for i in range(mean.shape[0])]
    return rmse, nlpd, cg, refresh_s, secs, var


def _unbatched_element(batch_model, train_x, train_y, i: int):
    """An unbatched flagship model on element i's targets with element i's raw parameters."""
    import torch

    import gpytorch_tpu_torch as gt

    model = build_model(train_x, train_y[i], "cuda", torch.float32, params=None)
    raw = dict(batch_model.named_parameters())
    gt.load_jax_params(model, {name: raw[name][i].detach().cpu().numpy() for name, _ in model.named_parameters()})
    return model.train()


def _batch_mll(m, base_samples, state, fixed: bool, grads: bool = True):
    """The MLL of an exact model (batched or not) under the training recipe from the warm
    ``state``, and with ``grads`` its gradient; with ``fixed``, CG runs exactly
    B_FIXED_ITERS iterations (tolerance 0, no stall exit).  A float64 model takes
    PC_NOISE_BUDGET_F64, the float32 runs' τ.  Returns (MLL, {name: gradient} or None, CG
    iterations)."""
    import torch

    import gpytorch_tpu_torch as gt

    stack = train_settings(PC_NOISE_BUDGET_F64 if m.train_targets.dtype == torch.float64 else PC_NOISE_BUDGET)
    if fixed:
        for ctx in (gt.settings.max_cg_iterations(B_FIXED_ITERS), gt.settings.cg_tolerance(0.0),
                    gt.settings.cg_stall_window(10**6)):
            stack.enter_context(ctx)
    m.zero_grad()
    with stack, torch.set_grad_enabled(grads):
        mll, state = gt.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(
            m(m.train_inputs[0]), m.train_targets, base_samples=base_samples, solver_state=state, return_state=True)
    if not grads:
        return mll.detach(), None, state.num_iters
    (-mll.sum()).backward()
    return mll.detach(), {k: p.grad.detach().clone() for k, p in m.named_parameters()}, state.num_iters


def _element_gap(mll, grads, i: int, mll_i, grads_i) -> tuple:
    """Element i of a batched MLL and gradient against an unbatched model's:
    (|ΔMLL| / max(|MLL|, 1), max |Δ∇| / max |∇|)."""
    d_loss = abs(mll[i].item() - mll_i.item()) / max(abs(mll_i.item()), 1.0)
    scale = max(g.abs().max().item() for g in grads_i.values())
    return d_loss, max((grads[k][i] - g).abs().max().item() for k, g in grads_i.items()) / scale


def batch_against_unbatched(model, train_x, train_y, state):
    """Phase 13's per-element check at N=100k: one batched loss and gradient against two
    unbatched port models with each element's raw parameters, the same probes and the same
    warm start (``state``, the last training step's rhs solves).  Under the training recipe
    CG stops when every column of the batch has converged or none has improved for the
    stall window, so the batched solve runs at least as long as the slower element's: its
    CG counts from a zero start are printed beside the unbatched ones (a reading; CG keeps
    its best iterate, the start itself, until the 2-norm residual first drops below |y|, so
    a run that stops before then drops the inverse quadratic, ROADMAP queue 3).  The gate
    runs CG for B_FIXED_ITERS iterations in both (tolerance 0, no stall exit), the same
    function then, and holds each element's MLL and gradient to B_ELEMENT_TOL, beside a
    planted fault that the gate must see."""
    import torch

    probes = BatchProbes(step=10_000)
    warm = state.detach()
    singles = [_unbatched_element(model, train_x, train_y, i) for i in range(2)]

    def run(fixed, start):
        return (_batch_mll(model, probes, start, fixed),
                [_batch_mll(single, probes.element(i), start[i], fixed) for i, single in enumerate(singles)])

    (mll, _, iters), alone = run(False, torch.zeros_like(warm))
    print(f"[batch] N={N_TRAIN}, from a zero start, the training recipe: batched CG {iters} iterations, unbatched "
          f"{[a[2] for a in alone]}; MLL batched {mll.tolist()}, unbatched {[a[0].item() for a in alone]} (readings)",
          flush=True)
    (mll, grads, iters), alone = run(True, warm)
    gaps = []
    for i, (mll_i, grads_i, iters_i) in enumerate(alone):
        d_loss, d_grad = _element_gap(mll, grads, i, mll_i, grads_i)
        gaps.append((d_loss, d_grad))
        print(f"[batch] element {i}, CG fixed at {B_FIXED_ITERS} iterations (batched {iters}, unbatched {iters_i}): "
              f"MLL batched {mll[i].item():.6f} unbatched {mll_i.item():.6f} (rel diff {d_loss:.3e}), gradient max "
              f"diff {d_grad:.3e} of the largest (tol {B_ELEMENT_TOL})", flush=True)
    # the planted fault: element 1 alone with element 0's lengthscales, a state shared across elements
    faulty = _unbatched_element(model, train_x, train_y, 1)
    with torch.no_grad():
        faulty.covar_module.base_kernel.raw_lengthscale.copy_(model.covar_module.base_kernel.raw_lengthscale[0])
    fault = max(_element_gap(mll, grads, 1, *_batch_mll(faulty, probes.element(1), warm[1], True)[:2]))
    print(f"[batch] planted fault (element 1 with element 0's lengthscales): {fault:.3e} (must exceed "
          f"{B_ELEMENT_TOL})", flush=True)
    check(all(d_loss <= B_ELEMENT_TOL and d_grad <= B_ELEMENT_TOL for d_loss, d_grad in gaps),
          f"batch: a batched element differs from its unbatched model: {gaps}")
    check(fault > B_ELEMENT_TOL, f"batch: the per-element gate does not see a planted fault: {fault:.3e}")
    return gaps


def batch_gram_witness():
    """Phase 13's per-element check (CG fixed at B_FIXED_ITERS iterations, tolerance 0) with
    the preconditioner's Gram matrices formed one product per element (the port's
    ``linop.added_diag._gram``) and by one batched GEMM, on the model that ``phase_batch``
    trains (its own check runs after): the batched GEMM's LᵀL against the per-element one
    on the trained factors, each element's MLL and gradient gaps under each, and the MLLs
    in float64 through the plain kernels, batched and unbatched.  Not part of the run:
    ``python3 -c 'import chip_smoke; chip_smoke.batch_gram_witness()'``."""
    import torch

    from gpytorch_tpu_torch.linop import added_diag

    gate, per_element = batch_against_unbatched, added_diag._gram

    def batched_gemm(a):
        return a.mT @ a

    def readings(model, train_x, train_y, state):
        probes, warm = BatchProbes(step=10_000), state.detach()
        singles = [_unbatched_element(model, train_x, train_y, i) for i in range(2)]
        with train_settings(), torch.no_grad():
            op = model.likelihood(model(model.train_inputs[0])).lazy_covariance_matrix.evaluate_kernel()
            root = op._preconditioner()[1].low_rank.root
            own = per_element(root)
            apart = ((batched_gemm(root) - own).norm(dim=(-2, -1)) / own.norm(dim=(-2, -1))).tolist()
        print(f"[gram] LᵀL of the trained factors {tuple(root.shape)}: one batched GEMM against one product per "
              f"element, |Δ| / |LᵀL| per element {apart}", flush=True)
        alone = [_batch_mll(single, probes.element(i), warm[i], True) for i, single in enumerate(singles)]
        float32 = {}
        for name, gram in (("one product per element", per_element), ("one batched GEMM", batched_gemm)):
            added_diag._gram = gram
            try:
                mll, grads, _ = _batch_mll(model, probes, warm, True)
            finally:
                added_diag._gram = per_element
            float32[name] = mll
            print(f"[gram] the Gram matrices by {name}, CG fixed at {B_FIXED_ITERS} iterations at tolerance 0: "
                  + "; ".join(f"element {i} MLL {mll[i].item():.7f}, unbatched {a[0].item():.7f}, gaps (MLL, "
                              f"gradient) {_element_gap(mll, grads, i, a[0], a[1])}" for i, a in enumerate(alone)),
                  flush=True)
        twins = [_float64_copy(m).train() for m in (model, *singles)]
        with plain_kernels():
            mll64 = _batch_mll(twins[0], probes, warm.double(), True, grads=False)[0]
            alone64 = [_batch_mll(t, probes.element(i), warm[i].double(), True, grads=False)[0]
                       for i, t in enumerate(twins[1:])]
        for i, one in enumerate(alone64):
            print(f"[gram] float64 through the plain kernels, element {i}: MLL batched {mll64[i].item():.12f}, "
                  f"unbatched {one.item():.12f}; float32 from it: unbatched {abs(alone[i][0].item() - one.item()):.3e}, "
                  + ", ".join(f"batched by {name} {abs(m[i].item() - one.item()):.3e}" for name, m in float32.items()),
                  flush=True)
        return gate(model, train_x, train_y, state)

    names = globals()
    names["batch_against_unbatched"] = readings
    try:
        phase_batch()
    finally:
        names["batch_against_unbatched"] = gate


def dos_fold_witness():
    """kernel_bwd_fused's dos with its n per-row partials folded in float32 and in float64
    (``kernel_bwd_fused_cuda.dos_fold_dtype``), each against float64 beside the plain
    float32 version, on phase 10's operands (``_fantasy_kernel_shapes``: the trained
    flagship's scaled inputs, seeded g and v at t=1 and t=FANT_Q), for the flagship trained
    with each fold in turn (the fold moves dos, hence the trajectory).  Not part of the run:
    ``python3 -c 'import chip_smoke; chip_smoke.dos_fold_witness()'``."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    phase_device()
    phase_build()
    wrapper = fk.kernel_bwd_fused_cuda
    try:
        for trained_with in (torch.float32, torch.float64):
            wrapper.dos_fold_dtype = trained_with
            model = train_flagship("flagship")["model"]
            tx = model.train_inputs[0]
            x = ((tx - tx.mean(0, keepdim=True)) / model.covar_module.base_kernel.lengthscale.detach()).contiguous()
            rng = np.random.default_rng(21)
            for t in (1, FANT_Q):
                g, v = (torch.as_tensor(rng.normal(size=(N_TRAIN, t)), dtype=torch.float32, device="cuda")
                        for _ in range(2))
                exact = fk._bwd_fused_reference(x.double(), g.double(), v.double(), fk.RBF, need_dv=False,
                                                need_dos=True)[2]
                plain = fk._bwd_fused_reference(x, g, v, fk.RBF, need_dv=False, need_dos=True)[2]
                errs = []
                for fold in (torch.float32, torch.float64):
                    wrapper.dos_fold_dtype = fold
                    dos = wrapper(x, g, v, fk.RBF, need_dv=False, need_dos=True)[2]
                    errs.append(abs(dos.double() - exact).item() / abs(exact.item()))
                print(f"[dos fold] the flagship trained with the {str(trained_with)[6:]} fold, t={t}: |Δdos| / |dos| "
                      f"against float64: kernel, float32 fold {errs[0]:.4e}, float64 fold {errs[1]:.4e}; plain "
                      f"float32 {abs(plain.double() - exact).item() / abs(exact.item()):.4e} (|dos| "
                      f"{abs(exact.item()):.6e})", flush=True)
            del model
    finally:
        wrapper.dos_fold_dtype = torch.float64


def dos_noise_witness():
    """The rounding noise of dos = Σ_ij k_ij g_i·v_j in float32 at phase 19's first Matérn-5/2
    training backward (N_TRAIN points, t = 64: the operands that phase 19's gate reads), the
    same operands under the RBF and Matérn-3/2 kernels beside it: the signed error from
    float64 of the kernel (its dos in float64, ``kernel_bwd_dos64``), of the plain float32
    version, of the FP32 FMA tier (two launches of 32 columns), of float64 k times float32
    g_i·v_j (a float32 product on the card), and of float32 k (the kernel's differences,
    ``torch.exp``) times float64 g_i·v_j, with |dos| and its diagonal's share Σ_i g_i·v_i;
    and the backward's time with dos and with dx alone (``kernel_bwd_dos64``'s share) beside
    the plain version's.  Not part of the run:
    ``python3 -c 'import chip_smoke; chip_smoke.dos_noise_witness()'``."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    phase_device()
    phase_build()
    train_x, targets, _, _ = make_list_task(N_TRAIN, N_TEST)
    model = build_model_list(train_x, targets, "cuda", torch.float32)
    ts = [torch.as_tensor(t, dtype=torch.float32, device="cuda") for t in targets]
    torch.manual_seed(LIST_SEED)
    with recorded_calls("kernel_bwd_fused_cuda", kt=fk.MATERN25) as seen:
        list_loss(model, gt.mlls.SumMarginalLogLikelihood(model.likelihood, model), ts).backward()
    (x, g, v, _), _ = seen["first"]
    del model
    xc = x - x.mean(0, keepdim=True)
    halves = [(g[:, c].contiguous(), v[:, c].contiguous()) for c in (slice(0, 32), slice(32, None))]
    for kt in (fk.MATERN25, fk.RBF, fk.MATERN15):
        exact = fk._bwd_fused_reference(x.double(), g.double(), v.double(), kt, need_dv=False, need_dos=True)[2].item()
        got = {"kernel": fk.kernel_bwd_fused_cuda(x, g, v, kt, need_dv=False, need_dos=True)[2].item(),
               "plain float32": fk._bwd_fused_reference(x, g, v, kt, need_dv=False, need_dos=True)[2].item(),
               "FMA tier": sum(fk.kernel_bwd_fused_cuda(x, a, b, kt, need_dv=False, need_dos=True)[2].item()
                               for a, b in halves)}
        k64_gv32 = k32_gv64 = 0.0
        for i in range(0, N_TRAIN, 2048):
            rows = slice(i, i + 2048)
            d2 = torch.zeros((xc[rows].shape[0], N_TRAIN), dtype=torch.float32, device="cuda")
            for k in range(D):
                diff = xc[rows, k:k + 1] - xc[:, k][None, :]
                d2 = torch.addcmul(d2, diff, diff)
            k32 = fk._kernel_fn_and_prime(d2, kt)[0]
            k64 = fk._kernel_fn_and_prime(torch.cdist(xc[rows].double(), xc.double()).pow(2), kt)[0]
            k64_gv32 += (k64 * (g[rows] @ v.mT).double()).sum().item()
            k32_gv64 += (k32.double() * (g[rows].double() @ v.double().mT)).sum().item()
        got |= {"float64 k × float32 g·v": k64_gv32, "float32 k × float64 g·v": k32_gv64}
        ms = {dos: cuda_time_ms(lambda: fk.kernel_bwd_fused_cuda(x, g, v, kt, need_dv=False, need_dos=dos), 5)
              for dos in (True, False)}
        plain_ms = cuda_time_ms(lambda: fk._bwd_fused_reference(x, g, v, kt, need_dv=False, need_dos=True), 2)
        print(f"[dos noise] kernel type {kt}: dos {exact:.6e}, its diagonal's share {(g.double() * v.double()).sum().item():.6e}; "
              f"signed error from float64: " + ", ".join(f"{name} {val - exact:+.3e}" for name, val in got.items())
              + f"; the backward {ms[True]:.3f} ms with dos, {ms[False]:.3f} ms dx alone, plain {plain_ms:.3f} ms; "
              f"{nvidia_smi()}", flush=True)


def pivot_correction_witness(n: int = N_TRAIN, rank: int = 50, device: str = "cuda"):
    """Whether the pivoted Cholesky's correction L·L[p] as a one-column matrix product
    ((n, rank) @ (rank, 1), the form that serves batched and unbatched factors alike)
    rounds as the matrix-vector product (n, rank) @ (rank,) does, in float32 on ``device``,
    at each step m of a rank-``rank`` factorisation (columns past m zero): the entries that
    differ and their largest gap.  Not part of the run:
    ``python3 -c 'import chip_smoke; chip_smoke.pivot_correction_witness()'``."""
    import torch

    gen = torch.Generator().manual_seed(PROBE_SEED)
    full = torch.randn(n, rank, generator=gen).to(device)
    pivots = torch.randint(n, (rank,), generator=gen).tolist()
    differ, gap = 0, 0.0
    for m, p in enumerate(pivots, start=1):
        L = torch.where(torch.arange(rank, device=device) < m, full, torch.zeros((), device=device))
        gemv = L @ L[p]
        gemm = (L @ L[p:p + 1].mT).squeeze(-1)
        differ += int((gemv != gemm).sum())
        gap = max(gap, (gemv - gemm).abs().max().item())
    print(f"[pivot correction] n={n}, rank {rank}, float32 on {device}: one-column gemm against gemv over {rank} "
          f"steps: {differ} entries differ, largest gap {gap:.3e}", flush=True)
    return differ, gap


def phase_batch():
    """Phase 13: the batch-independent GP at full width (``make_batch_task``: two outputs of
    N=100,000 on the flagship's inputs), trained with bench.py's recipe for B_STEPS steps
    and served on the 2,048 test points of each output, every product one fused launch per
    output.  Gates: finite losses, gradients and variances; each output's marginal NLPD
    lowered; output 0's RMSE ≤ RMSE_LIMIT (1.153 times its noise), output 1's ≤ 1.153 times
    its own noise;
    training launches 2 kernel_matvec per CG iteration, 2 kernel_bwd_fused a step and no
    kernel_grad_x (the one-pass symmetric backward per element), serving 2 per CG
    iteration, Lanczos block and product; then ``batch_against_unbatched``.  Alone:

        python3 -c 'import chip_smoke; chip_smoke.phase_batch()'

    Returns the readings."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    train_x, train_y, test_x, test_y, noise_std = make_batch_task(N_TRAIN, N_TEST, seed=0)
    dev = "cuda"
    model = build_batch_model(train_x, train_y, dev, torch.float32)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    ty = torch.as_tensor(test_y, dtype=torch.float32, device=dev)
    # output 1's RMSE gate: its own noise scaled as the flagship's gate scales output 0's
    limits = (RMSE_LIMIT, RMSE_LIMIT * noise_std[1] / noise_std[0])
    rmse0, nlpd0, *_ = batch_quality(model, tx, ty, dev)
    print(f"[batch] two outputs of N={N_TRAIN} (noise std {noise_std[0]:.4f} and {noise_std[1]:.4f} in standardised "
          f"units); the initial parameters served: rmse {[round(r, 4) for r in rmse0]}, marginal nlpd "
          f"{[round(v, 4) for v in nlpd0]}", flush=True)
    model.train()
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    scheduler = torch.optim.lr_scheduler.CosineAnnealingLR(optimizer, T_max=B_STEPS, eta_min=0.01)
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(2, N_TRAIN, 1, dtype=torch.float32, device=dev)
    wrappers = (fk.kernel_matvec_cuda, fk.kernel_bwd_fused_cuda, fk.kernel_grad_x_cuda)
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, iters, losses = [], [], []
    for step in range(B_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss, _, state = batch_loss(model, generator, state)
        loss.backward()
        optimizer.step()
        scheduler.step()
        ok = finite_step(loss, model)
        times.append(time.perf_counter() - t0)
        iters.append(state.num_iters)
        losses.append(loss.item())
        check(ok, f"batch training step {step}: non-finite loss or gradient")
    train_launches = tuple(w.launches for w in wrappers)
    train_peak = torch.cuda.max_memory_allocated()
    median = sorted(times[1:])[(B_STEPS - 1) // 2]
    mean = sum(times[1:]) / (B_STEPS - 1)
    kern = model.covar_module
    print(f"[batch] {B_STEPS} steps: median {median:.4f} s/step, mean {mean:.4f} s/step over steps 1-{B_STEPS - 1}, "
          f"first step {times[0]:.3f} s; CG iterations per step {iters} ({sum(iters)} in all); loss per step "
          f"{[round(x, 5) for x in losses]}", flush=True)
    print(f"[batch] lengthscales {kern.base_kernel.lengthscale.detach().cpu().numpy().round(4).tolist()}, outputscales "
          f"{kern.outputscale.detach().cpu().numpy().round(4).tolist()}, noises "
          f"{model.likelihood.noise.detach().cpu().numpy().reshape(-1).round(5).tolist()}; peak device memory "
          f"{train_peak / 2**20:.1f} MiB", flush=True)
    expected = (2 * sum(iters), 2 * B_STEPS, 0)
    print(f"[batch] training launched kernel_matvec, kernel_bwd_fused, kernel_grad_x {train_launches} (expected "
          f"{expected}: one product per output a CG iteration, one fused backward per output a step)", flush=True)
    check(train_launches == expected, f"batch training launched {train_launches}, expected {expected}")
    for w in wrappers:
        w.launches = 0
    rmse, nlpd, cg, refresh_s, secs, var = batch_quality(model, tx, ty, dev)
    serve_launches = tuple(w.launches for w in wrappers)
    serve_expected = (2 * (cg.num_iters + 5 + 2), 0, 0)
    print(f"[batch] serving the trained model: refresh_s {refresh_s:.3f} (CG {cg.num_iters} iterations), request_ms "
          f"{secs * 1e3:.2f} ({N_TEST} points of each output); rmse {[round(r, 4) for r in rmse]} (limits "
          f"{[round(v, 4) for v in limits]}), marginal nlpd {[round(v, 4) for v in nlpd]} (initial "
          f"{[round(v, 4) for v in nlpd0]}); smallest predictive variance {var.min().item():.4e}; launches "
          f"{serve_launches} (expected {serve_expected}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {nvidia_smi()}", flush=True)
    check(serve_launches == serve_expected, f"batch serving launched {serve_launches}, expected {serve_expected}")
    check(all(r <= lim for r, lim in zip(rmse, limits)), f"batch rmse {rmse} above {limits}")
    check(all(v < v0 - TRAIN_NLPD_DROP for v, v0 in zip(nlpd, nlpd0)), f"batch: training took the marginal nlpd "
                                                                        f"from {nlpd0} only to {nlpd}")
    model.train()
    gaps = batch_against_unbatched(model, train_x, train_y, state.solution)
    return dict(launches=tuple(a + b for a, b in zip(train_launches, serve_launches)), median=median, mean=mean,
                iters=iters, rmse=rmse, nlpd=nlpd, refresh_s=refresh_s, request_ms=secs * 1e3, gaps=gaps,
                peak=train_peak, model=model)


def _batch_slice_run(device, dtype, steps, periodic=False):
    """Phase 13's slice: the batch model (periodic with ``periodic``) at N=B_SLICE_N from
    its initial values with ``BatchProbes``, a float64 run with the float32 runs' τ:
    (step-1 loss, step-1 gradients, raw parameters after ``steps`` steps, the model)."""
    import torch

    budget = PC_NOISE_BUDGET_F64 if dtype == torch.float64 else PC_NOISE_BUDGET
    if periodic:
        (x, y0, _, _), (_, y1, _, _) = (make_periodic_task(B_SLICE_N, 0, seed=s) for s in (3, 4))
        model = build_batch_model(x, np.stack([y0, y1]), device, dtype, periodic=True)
        optimizer, scheduler = make_periodic_optimizer(model)
    else:
        x, y, _, _, _ = make_batch_task(B_SLICE_N, 0, seed=3)
        model = build_batch_model(x, y, device, dtype)
        optimizer, scheduler = make_optimizer(model)
    state = torch.zeros(2, B_SLICE_N, 1, dtype=dtype, device=device)
    for step in range(steps):
        optimizer.zero_grad()
        loss, _, state = batch_loss(model, BatchProbes(step), state, budget)
        loss.backward()
        check(finite_step(loss, model), f"batch slice on {device}, step {step}: non-finite loss or gradient")
        if step == 0:
            loss0 = loss.item()
            grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
        optimizer.step()
        scheduler.step()
    raw = {k: p.detach().cpu().double() for k, p in model.named_parameters()}
    return loss0, grads, raw, model


def phase_batch_slice(periodic=False):
    """Phase 13's CUDA-against-CPU check at N=B_SLICE_N: the batch model (with ``periodic``,
    two outputs of the periodic task through the batched periodic branch) trained 3 steps on
    CPU tensors and on CUDA tensors, every run on the CPU float32 run's pinned pivots (each
    element its own), with a CPU float64 run as the floor of the gradient gate; then the
    CPU run's parameters served on both devices (the mean and LOVE variances of 512
    points), as phase 6 and phase 4 do."""
    import torch

    tag = "batch-periodic-slice" if periodic else "batch-slice"
    pins = PinnedPivots()
    with pins.record():
        l_cpu, g_cpu, r_cpu, m_cpu = _batch_slice_run("cpu", torch.float32, SLICE_TRAIN_STEPS, periodic)
    with pins.replay():
        l_gpu, g_gpu, r_gpu, _ = _batch_slice_run("cuda", torch.float32, SLICE_TRAIN_STEPS, periodic)
    with pins.replay():
        floor = _grad_gap(_batch_slice_run("cpu", torch.float64, 1, periodic)[1], g_cpu)[0]
    d_loss = abs(l_cpu - l_gpu) / max(abs(l_cpu), 1.0)
    d_grad, _ = _grad_gap(g_cpu, g_gpu)
    d_raw = max((r_cpu[k] - r_gpu[k]).abs().max().item() for k in r_cpu)
    test_x = (make_periodic_task(B_SLICE_N, 512, seed=3)[2] if periodic else make_batch_task(B_SLICE_N, 512, seed=3)[2])
    out = {}
    from gpytorch_tpu_torch import settings

    with eval_settings(min_preconditioning_size=1000), settings.eval_cg_tolerance(SLICE_CG_TOL):
        for device in ("cpu", "cuda"):
            model = build_batch_model(m_cpu.train_inputs[0][0].numpy(), m_cpu.train_targets.numpy(), device,
                                      torch.float32, periodic)
            model.load_state_dict(m_cpu.state_dict())
            model.eval()
            _, _, answers = serve(model, torch.as_tensor(test_x, dtype=torch.float32, device=device), device,
                                  [slice(0, 512)])
            out[device] = (answers[0][1].cpu().double(), answers[0][2].cpu().double())
    (mc, vc), (mg, vg) = out["cpu"], out["cuda"]
    dm = ((mc - mg).abs().max() / mc.abs().max()).item()
    dv = ((vc - vg).abs().max() / vc.abs().max()).item()
    print(f"[{tag}] N={B_SLICE_N}, 2 outputs: step-1 loss cpu {l_cpu:.6f} cuda {l_gpu:.6f} (rel diff {d_loss:.3e}, tol "
          f"{SLICE_LOSS_TOL}); step-1 grads max diff {d_grad:.3e} of the largest (tol {SLICE_GRAD_TOL}; cpu float32 "
          f"against float64 {floor:.3e}); raw parameters after {SLICE_TRAIN_STEPS} steps max diff {d_raw:.3e} (tol "
          f"{SLICE_PARAM_TOL}); 512 points served: mean rel diff {dm:.3e} (tol {SLICE_MEAN_TOL}), var rel diff "
          f"{dv:.3e} (tol {SLICE_VAR_TOL})", flush=True)
    check(d_loss <= SLICE_LOSS_TOL, f"{tag} training loss differs: {d_loss:.3e}")
    check(d_grad <= SLICE_GRAD_TOL, f"{tag} training gradients differ: {d_grad:.3e}")
    check(d_raw <= SLICE_PARAM_TOL, f"{tag} training parameters differ: {d_raw:.3e}")
    check(bool(torch.isfinite(mg).all()) and bool((vg > 0).all()), f"{tag}: served means not finite or variances ≤ 0")
    check(dm <= SLICE_MEAN_TOL and dv <= SLICE_VAR_TOL, f"{tag} served predictions differ: mean {dm:.3e}, var {dv:.3e}")


def make_multitask_task(n_train: int, n_test: int, num_tasks: int, seed: int = 0):
    """t correlated outputs of x uniform on [0, 1]: a shared smooth function f mixed by a
    seeded 1 × t vector w, y_t = w_t f + noise of standard deviation 0.05·(t + 1), drawn with
    numpy.  Returns x, y (n_train, t), the test inputs and the noiseless test targets."""
    rng = np.random.default_rng([seed, 13])
    x = rng.uniform(size=n_train + n_test)
    f = np.sin(6 * x) + 0.5 * np.cos(13 * x)
    w = rng.normal(size=num_tasks)
    clean = f[:, None] * w[None, :]
    y = clean + 0.05 * (1 + np.arange(num_tasks)) * rng.normal(size=clean.shape)
    return x[:n_train], y[:n_train], x[n_train:], clean[n_train:]


def build_multitask_model(train_x, train_y, device, dtype, lcm=False):
    """``examples/03_multitask_gp.py``'s Kronecker multitask GP (MultitaskMean(ConstantMean),
    MultitaskKernel(RBFKernel, rank 1), MultitaskGaussianLikelihood), or with ``lcm`` its
    LCMKernel([RBF, Matérn-3/2]) variant, at its initial values, in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    t = np.shape(train_y)[1]

    class MultitaskGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.MultitaskMean(gt.means.ConstantMean(), num_tasks=t)
            self.covar_module = (gt.kernels.LCMKernel([gt.kernels.RBFKernel(), gt.kernels.MaternKernel(nu=1.5)],
                                                      num_tasks=t) if lcm
                                 else gt.kernels.MultitaskKernel(gt.kernels.RBFKernel(), num_tasks=t, rank=1))

        def forward(self, x):
            return gt.distributions.MultitaskMultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx, ty = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y))
    return MultitaskGP(tx, ty, gt.likelihoods.MultitaskGaussianLikelihood(num_tasks=t)).to(device=device, dtype=dtype)


def make_hadamard_task(n_per_task: int, n_test_per_task: int, seed: int = 0):
    """Two tasks on their own inputs, each a row [task, x]: task 0 sin 6x, task 1
    0.8 sin(6x + 0.5) + 0.3 cos 3x, noise 0.1, drawn with numpy.  Returns the training rows
    (2n, 2) and targets, the test rows and their noiseless targets."""
    rng = np.random.default_rng([seed, 17])

    def rows(n):
        xs = rng.uniform(size=(2, n))
        f = np.concatenate([np.sin(6 * xs[0]), 0.8 * np.sin(6 * xs[1] + 0.5) + 0.3 * np.cos(3 * xs[1])])
        return np.stack([np.repeat([0.0, 1.0], n), xs.reshape(-1)], axis=1), f

    x, f = rows(n_per_task)
    xs, fs = rows(n_test_per_task)
    return x, f + 0.1 * rng.normal(size=f.shape), xs, fs


def build_hadamard_model(train_x, train_y, device, dtype, task_prior=None):
    """A Hadamard multitask GP: K = K_RBF(x) ⊙ K_task(task), an RBF kernel on column 1 times
    an IndexKernel (2 tasks, rank 1, ``task_prior`` on its covariance) on column 0, formed
    densely; the task noise of each point from ``HadamardGaussianLikelihood``, which reads the
    task from column 0."""
    import torch

    import gpytorch_tpu_torch as gt

    class HadamardGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.data_kernel = gt.kernels.RBFKernel(active_dims=(1,))
            self.task_kernel = gt.kernels.IndexKernel(num_tasks=2, rank=1, active_dims=(0,), prior=task_prior)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.data_kernel(x) * self.task_kernel(x))

    tx, ty = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y))
    likelihood = gt.likelihoods.HadamardGaussianLikelihood(num_tasks=2)
    return HadamardGP(tx, ty, likelihood).to(device=device, dtype=dtype)


def _kernel_wrappers():
    """The five CUDA kernels' wrappers, whose ``launches`` count every launch, in the order
    of every five-count tuple printed: (matvec, bwd_fused, grad_x, periodic matvec, periodic
    bwd_fused)."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk
    from gpytorch_tpu_torch.ops import periodic_kernels as ppk

    return (fk.kernel_matvec_cuda, fk.kernel_bwd_fused_cuda, fk.kernel_grad_x_cuda, ppk.periodic_matvec_cuda,
            ppk.periodic_bwd_fused_cuda)


def _mt_loss(model, base_samples, state, extra=(), budget: float = PC_NOISE_BUDGET):
    """−MLL per datum of a multitask or Hadamard model by mBCG under the training recipe
    (``extra``: the likelihood's arguments); returns (loss, state)."""
    import gpytorch_tpu_torch as gt

    tx, ty = model.train_inputs[0], model.train_targets
    with train_settings(budget):
        mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)
        value, state = mll(model(tx), ty, *extra, base_samples=base_samples, solver_state=state, return_state=True)
    return -value, state


def _mt_train_and_serve(tag, model, test_x, steps, extra=False):
    """``steps`` Adam steps (cosine 0.1 → 0.01) of ``_mt_loss`` with probes from a seeded
    generator, then the model refreshed and asked for ``test_x`` under the eval settings.
    Returns (losses, CG iterations, median s/step, peak MiB, refresh s, request s, the
    prediction's mean and variance, the launches of the five kernels, which must be none:
    no pallas_call on these paths)."""
    import torch

    dev = test_x.device
    tx = model.train_inputs[0]
    rows = model.train_targets.numel()
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    scheduler = torch.optim.lr_scheduler.CosineAnnealingLR(optimizer, T_max=steps, eta_min=0.01)
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(rows, 1, dtype=tx.dtype, device=dev)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, iters, times = [], [], []
    for step in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss, state = _mt_loss(model, generator, state, (tx,) if extra else ())
        loss.backward()
        optimizer.step()
        scheduler.step()
        check(finite_step(loss, model), f"{tag} training step {step}: non-finite loss or gradient")
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        iters.append(state.num_iters)
    peak = torch.cuda.max_memory_allocated() / 2**20
    model.eval()
    with eval_settings(), torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        model.refresh()
        sync(dev)
        refresh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = model(test_x)
        mean, var = pred.mean, pred.variance
        sync(dev)
        request_s = time.perf_counter() - t0
    launched = tuple(w.launches for w in wrappers)
    median = sorted(times[1:])[(steps - 1) // 2]
    print(f"[{tag}] {steps} steps: median {median * 1e3:.1f} ms/step (first {times[0]:.3f} s, all {sum(times):.2f} s); CG "
          f"iterations {iters} ({sum(iters)} in all); loss {losses[0]:.5f} → {losses[-1]:.5f}; peak device memory "
          f"{peak:.1f} MiB; refresh_s {refresh_s:.3f}, request_ms {request_s * 1e3:.2f} ({test_x.shape[0]} points)",
          flush=True)
    print(f"[{tag}] launches of the five kernels in training and serving: {launched} (none expected)", flush=True)
    check(launched == (0,) * 5, f"{tag} launched {launched}")
    check(bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()) and bool((var > 0).all()),
          f"{tag}: predictions not finite or variance ≤ 0")
    check(sum(losses[-5:]) / 5 < losses[0], f"{tag}: the loss did not fall ({losses[0]:.5f} → {losses[-1]:.5f})")
    return dict(losses=losses, iters=iters, median=median, peak=peak, refresh_s=refresh_s, request_s=request_s,
                mean=mean, var=var, total_s=sum(times), launches=launched)


def _mt_slice(tag, build, data, extra=False):
    """CUDA float32 against a CPU float64 run of the port, beside a CPU float32 run (the
    float32 floor): one loss and gradient at the initial values with the same injected
    probes and pinned pivots (a float64 run with the float32 runs' τ), then the mean of the
    test points served from those values at eval tolerance SLICE_CG_TOL.  Returns the
    gaps (loss, gradient, mean)."""
    import torch

    from gpytorch_tpu_torch import settings

    train_x, train_y, test_x = data
    runs, pins = {}, PinnedPivots()
    for device, dtype in (("cpu", torch.float32), ("cpu", torch.float64), ("cuda", torch.float32)):
        model = build(train_x, train_y, device, dtype).train()
        tx = model.train_inputs[0]
        rows = model.train_targets.numel()
        budget = PC_NOISE_BUDGET_F64 if dtype == torch.float64 else PC_NOISE_BUDGET
        with pins.replay() if runs else pins.record():
            loss, _ = _mt_loss(model, InjectedProbes(0), torch.zeros(rows, 1, dtype=dtype, device=device),
                               (tx,) if extra else (), budget)
            loss.backward()
            grads = {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()}
            model.eval()
            with eval_settings(), settings.eval_cg_tolerance(SLICE_CG_TOL), torch.no_grad():
                mean = model(torch.as_tensor(test_x, dtype=dtype, device=device)).mean.cpu().double()
        runs[(device, dtype)] = (loss.item(), grads, mean)

    def gaps(a, b):
        return (abs(a[0] - b[0]) / max(abs(a[0]), 1.0), _grad_gap(a[1], b[1])[0],
                ((a[2] - b[2]).abs().max() / a[2].abs().max()).item())

    ref = runs[("cpu", torch.float64)]
    got, floor = gaps(ref, runs[("cuda", torch.float32)]), gaps(ref, runs[("cpu", torch.float32)])
    print(f"[{tag}] slice: CUDA float32 against CPU float64: loss {got[0]:.3e}, gradient {got[1]:.3e}, mean {got[2]:.3e} "
          f"(CPU float32: {floor[0]:.3e}, {floor[1]:.3e}, {floor[2]:.3e}; tol {MT_SLICE_TOL})", flush=True)
    check(all(g <= tol for g, tol in zip(got, MT_SLICE_TOL)), f"{tag}: CUDA differs from CPU float64: {got}")
    return got


def phase_multitask():
    """Phase 13b: the Kronecker multitask GP (``build_multitask_model``) on MT_TASKS
    correlated outputs of MT_N inputs (``make_multitask_task``): MT_STEPS Adam steps by
    unpreconditioned mBCG over the n·t rows of K_data ⊗ K_task + (I ⊗ D + σ²I) (K_data
    formed once per solve, 268 MB of float32), then MT_TEST points served: ms a step, CG
    iterations, per-task MAE against the noiseless function, peak memory.  Checks finite
    values, a falling loss, no kernel launch, and ``_mt_slice`` at n = MT_SLICE_N."""
    import torch

    train_x, train_y, test_x, clean = make_multitask_task(MT_N, MT_TEST, MT_TASKS)
    model = build_multitask_model(train_x, train_y, "cuda", torch.float32).train()
    r = _mt_train_and_serve("multitask", model, torch.as_tensor(test_x, dtype=torch.float32, device="cuda"), MT_STEPS)
    mae = (r["mean"].cpu().double() - torch.as_tensor(clean)).abs().mean(0).tolist()
    print(f"[multitask] n={MT_N}, {MT_TASKS} tasks: per-task MAE against the noiseless function "
          f"{[round(v, 4) for v in mae]} (noise std {[0.05 * (1 + i) for i in range(MT_TASKS)]}); task covariance "
          f"{model.covar_module.task_covar_module.covar_matrix.detach().cpu().numpy().round(3).tolist()}", flush=True)
    check(all(m < 0.05 * (1 + i) for i, m in enumerate(mae)), f"multitask: a task's MAE above its noise: {mae}")
    sx, sy, stx, _ = make_multitask_task(MT_SLICE_N, 64, MT_TASKS, seed=1)
    gaps = _mt_slice("multitask", build_multitask_model, (sx, sy, stx))
    return dict(r, mae=mae, gaps=gaps, model=model)


def phase_lcm_hadamard():
    """Phase 13c: the LCM model (``build_multitask_model(lcm=True)``, 2 tasks on LCM_N inputs)
    and the Hadamard model (``build_hadamard_model``, 2 × HAD_N points, dense, its mBCG
    preconditioned), each MT_SMALL_STEPS Adam steps and a request, and each against its CPU
    float64 run at a small n (``_mt_slice``); no kernel launch."""
    import torch

    train_x, train_y, test_x, clean = make_multitask_task(LCM_N, 256, 2, seed=2)
    lcm = build_multitask_model(train_x, train_y, "cuda", torch.float32, lcm=True).train()
    r_lcm = _mt_train_and_serve("lcm", lcm, torch.as_tensor(test_x, dtype=torch.float32, device="cuda"), MT_SMALL_STEPS)
    lcm_mae = (r_lcm["mean"].cpu().double() - torch.as_tensor(clean)).abs().mean(0).tolist()
    sx, sy, stx, _ = make_multitask_task(MT_SLICE_N // 2, 64, 2, seed=3)
    lcm_gaps = _mt_slice("lcm", lambda *a: build_multitask_model(*a, lcm=True), (sx, sy, stx))
    hx, hy, htx, hclean = make_hadamard_task(HAD_N, 128)
    had = build_hadamard_model(hx, hy, "cuda", torch.float32).train()
    r_had = _mt_train_and_serve("hadamard", had, torch.as_tensor(htx, dtype=torch.float32, device="cuda"),
                                MT_SMALL_STEPS, extra=True)
    had_mae = [(r_had["mean"].cpu().double() - torch.as_tensor(hclean)).abs()[task * 128:(task + 1) * 128].mean().item()
               for task in range(2)]
    sx, sy, stx, _ = make_hadamard_task(MT_SLICE_N // 4, 32, seed=1)
    had_gaps = _mt_slice("hadamard", build_hadamard_model, (sx, sy, stx), extra=True)
    print(f"[lcm-hadamard] per-task MAE against the noiseless function (read, not gated): lcm "
          f"{[round(v, 4) for v in lcm_mae]} (noise std 0.05, 0.1), hadamard {[round(v, 4) for v in had_mae]} (noise std "
          f"0.1)", flush=True)
    launched = tuple(a + b for a, b in zip(r_lcm["launches"], r_had["launches"]))
    return dict(lcm=r_lcm, hadamard=r_had, lcm_mae=lcm_mae, had_mae=had_mae, gaps=(lcm_gaps, had_gaps),
                launches=launched)

def _quartiles_ms(secs) -> str:
    q = np.percentile(np.asarray(secs) * 1e3, [25, 50, 75])
    return f"median {q[1]:.3f} ms (quartiles {q[0]:.3f}-{q[2]:.3f}, min {min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f})"


def build_svgp(train_x, device, dtype, dist="natural", whitened=True, jitter_val=None, m=SVGP_M, seed=SVGP_SEED,
               strategy="whitened", likelihood=None):
    """Phase 14's model: an ApproximateGP on m inducing points (a subset of the training
    inputs drawn from ``seed``) with ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=D)) and
    q(u) of the kind ``dist`` ("natural" or "cholesky") under the whitened (or unwhitened)
    strategy, or with ``strategy="ciq"`` the CIQ strategy (phase 16) or ``"large_batch"`` the
    large-batch strategy (phase 17c), and a GaussianLikelihood
    with noise ≥ NOISE_FLOOR (or ``likelihood``); (model, likelihood) on ``device`` in
    train mode.  ``jitter_val`` fixes K_ZZ's jitter (by default it follows the dtype)."""
    import torch

    import gpytorch_tpu_torch as gt

    Z = torch.as_tensor(train_x[np.random.default_rng(seed).choice(len(train_x), m, replace=False)])
    dist_cls = {"natural": gt.variational.NaturalVariationalDistribution,
                "cholesky": gt.variational.CholeskyVariationalDistribution}[dist]
    strategy_cls = {"whitened": gt.variational.VariationalStrategy if whitened
                    else gt.variational.UnwhitenedVariationalStrategy,
                    "ciq": gt.variational.CiqVariationalStrategy,
                    "large_batch": gt.variational.LargeBatchVariationalStrategy}[strategy]

    class SVGP(gt.models.ApproximateGP):
        def __init__(self):
            super().__init__(strategy_cls(self, Z, dist_cls(m), jitter_val=jitter_val))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    if likelihood is None:
        likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    return SVGP().to(device=device, dtype=dtype).train(), likelihood.to(device=device, dtype=dtype).train()


def svgp_parity_state(train_x, train_y, m=SVGP_M, batch_size=SVGP_BATCH, seed=SVGP_SEED):
    """The state of phase 14's parity gate (and, with its own m, minibatch and seed, phase
    16's), drawn with numpy from ``seed``: the model's raw parameters under the JAX
    package's names (the flagship's fitted hyperparameters, m inducing points from the
    training inputs, q(u) = N(m, L Lᵀ) with m ~ 0.5·N(0, I) and L lower triangular, its
    diagonal uniform on [0.05, 0.3] and 0.05·N(0, 1) below it), the likelihood's, and one
    minibatch of ``batch_size`` training points (none of them inducing)."""
    rng = np.random.default_rng(seed)
    z_idx = rng.choice(len(train_x), m, replace=False)
    rest = np.setdiff1d(np.arange(len(train_x)), z_idx)
    batch = np.random.default_rng([seed, 1]).choice(rest, batch_size, replace=False)
    rng = np.random.default_rng([seed, 2])
    L = np.tril(0.05 * rng.normal(size=(m, m)), -1) + np.diag(rng.uniform(0.05, 0.3, size=m))
    params = {k: np.asarray(v) for k, v in JAX_PARAMS.items() if not k.startswith("likelihood.")}
    params |= {"variational_strategy.inducing_points": train_x[z_idx],
               "variational_strategy._variational_distribution.variational_mean": 0.5 * rng.normal(size=m),
               "variational_strategy._variational_distribution.chol_variational_covar": L}
    lik_params = {"noise_covar.raw_noise": np.asarray(JAX_PARAMS["likelihood.noise_covar.raw_noise"])}
    return params, lik_params, train_x[batch], train_y[batch]


def svgp_parity_terms(device, dtype, strategy="whitened", m=SVGP_M, batch_size=SVGP_BATCH,
                      seed=SVGP_SEED) -> tuple:
    """(ELBO, KL term) (num_data = N_TRAIN) of ``svgp_parity_state(m, batch_size, seed)`` on
    its minibatch: a Cholesky q(u) under the whitened (or with ``strategy="ciq"`` the CIQ)
    strategy, K_ZZ's jitter SVGP_JITTER."""
    import torch

    import gpytorch_tpu_torch as gt

    train_x, train_y, _, _ = make_task(N_TRAIN, N_TEST)
    params, lik_params, xb, yb = svgp_parity_state(train_x, train_y, m, batch_size, seed)
    model, likelihood = build_svgp(train_x, device, dtype, dist="cholesky", jitter_val=SVGP_JITTER, m=m, seed=seed,
                                   strategy=strategy)
    gt.load_jax_params(model, params | {"variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(likelihood, lik_params)
    xb, yb = (torch.as_tensor(a, dtype=dtype, device=device) for a in (xb, yb))
    with torch.no_grad():
        log_lik, kl, log_prior = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN, combine_terms=False)(
            model(xb), yb)
    return (log_lik - kl + log_prior).item(), kl.item()


def _svgp_batches(generator, steps: int, device, batch: int = SVGP_BATCH):
    """Minibatch indices of ``batch`` rows: a fresh permutation of the N_TRAIN rows each
    epoch, from ``generator``."""
    import torch

    out = []
    while len(out) < steps:
        perm = torch.randperm(N_TRAIN, generator=generator, device=device)
        out.extend(perm[i:i + batch] for i in range(0, N_TRAIN - batch + 1, batch))
    return out[:steps]


def _predictive_quality(mean, var, test_y, train_y_mean):
    """(RMSE, NLPD of N(mean, var), RMSE of the constant predictor at the training mean)."""
    import torch

    rmse = (mean - test_y).pow(2).mean().sqrt().item()
    nlpd = (0.5 * (torch.log(2 * math.pi * var) + (mean - test_y) ** 2 / var)).mean().item()
    return rmse, nlpd, (test_y - train_y_mean).pow(2).mean().sqrt().item()


def phase_svgp():
    """Phase 14: whitened SVGP trained with natural gradients at N=100k (``build_svgp``:
    SVGP_M inducing points, NaturalVariationalDistribution).  First the parity gate: the ELBO
    and the KL term of ``svgp_parity_state`` on the card in float32 and float64 against the
    JAX package's float64 values SVGP_ELBO_JAX and SVGP_KL_JAX, within SVGP_ELBO_TOL and
    SVGP_KL_TOL.  Then SVGP_STEPS steps on minibatches
    of SVGP_BATCH (two epochs): NGD (lr SVGP_NGD_LR, num_data = N_TRAIN) on the natural
    parameters and Adam (lr SVGP_ADAM_LR) on the inducing points, the hyperparameters and the
    noise; every ELBO finite, the ELBO of a fixed minibatch raised; the RMSE and NLPD of the
    N_TEST test points, the RMSE gated below the constant predictor's; svgp_step_ms.  The
    path launches no hand-written kernel (K_ZZ and K_Zx are evaluated densely, and of K_xx
    the ELBO and the predictions read the diagonal): the launches are gated at 0.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_svgp()'``.  Returns the readings."""
    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    dtypes = (torch.float32, torch.float64)
    terms = {dt: svgp_parity_terms(dev, dt) for dt in dtypes}
    elbo = {dt: terms[dt][0] for dt in dtypes}
    gap = tuple(abs(elbo[dt] - SVGP_ELBO_JAX) / abs(SVGP_ELBO_JAX) for dt in dtypes)
    kl_gap = tuple(abs(terms[dt][1] - SVGP_KL_JAX) / SVGP_KL_JAX for dt in dtypes)
    print(f"[svgp] parity: ELBO of the parity state on {SVGP_BATCH} points, m={SVGP_M}: float32 "
          f"{elbo[torch.float32]:.9f}, float64 {elbo[torch.float64]:.12f} on the card; JAX package float64 "
          f"{SVGP_ELBO_JAX:.12f}; relative gaps {gap[0]:.3e} and {gap[1]:.3e} (tol {SVGP_ELBO_TOL}); KL term float32 "
          f"{terms[torch.float32][1]:.9f}, float64 {terms[torch.float64][1]:.12f}, JAX package {SVGP_KL_JAX:.12f}, "
          f"relative gaps {kl_gap[0]:.3e} and {kl_gap[1]:.3e} (tol {SVGP_KL_TOL}); {nvidia_smi()}", flush=True)
    check(all(g <= tol for g, tol in zip(gap, SVGP_ELBO_TOL)), f"svgp: ELBO gaps {gap} above {SVGP_ELBO_TOL}")
    check(all(g <= tol for g, tol in zip(kl_gap, SVGP_KL_TOL)), f"svgp: KL gaps {kl_gap} above {SVGP_KL_TOL}")

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model, likelihood = build_svgp(train_x, dev, torch.float32)
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    ngd, adam = _ngd_and_adam(model, likelihood)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(SVGP_SEED), SVGP_STEPS, dev)
    fixed = slice(0, SVGP_BATCH)  # a fixed minibatch: the rows are i.i.d. uniform draws

    def fixed_elbo():
        with torch.no_grad():
            return mll(model(tx[fixed]), ty[fixed]).item()

    elbo0 = fixed_elbo()  # the first call also initialises q(u) from the prior, N(0, I)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    elbos, times = [], []
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ngd.zero_grad()
        adam.zero_grad()
        loss = -mll(model(tx[idx]), ty[idx])
        loss.backward()
        ngd.step()
        adam.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        elbos.append(-loss.item())
    train_launches = tuple(w.launches for w in wrappers)
    peak = torch.cuda.max_memory_allocated()
    elbo1 = fixed_elbo()
    model.eval()
    for w in wrappers:
        w.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = likelihood(model(sx))
        mean, var = pred.mean, pred.variance
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    serve_launches = tuple(w.launches for w in wrappers)
    rmse, nlpd, const_rmse = _predictive_quality(mean, var, sy, ty.mean())
    kern = model.covar_module
    print(f"[svgp] {SVGP_STEPS} steps (NGD lr {SVGP_NGD_LR} + Adam lr {SVGP_ADAM_LR}, minibatch {SVGP_BATCH}): "
          f"svgp_step_ms {_quartiles_ms(times[1:])} over steps 1-{SVGP_STEPS - 1}, first step {times[0] * 1e3:.1f} ms; "
          f"ELBO per step {[round(e, 4) for e in elbos[:5]]} … {[round(e, 4) for e in elbos[-5:]]}; fixed minibatch "
          f"ELBO {elbo0:.5f} → {elbo1:.5f}; peak device memory {peak / 2**20:.1f} MiB; {nvidia_smi()}", flush=True)
    print(f"[svgp] lengthscale {kern.base_kernel.lengthscale.detach().cpu().numpy().round(4).tolist()}, outputscale "
          f"{kern.outputscale.item():.4f}, noise {likelihood.noise.item():.5f}; {N_TEST} test points in "
          f"{request_s * 1e3:.2f} ms: rmse {rmse:.4f} (constant predictor {const_rmse:.4f}), nlpd {nlpd:.4f}; "
          f"hand-written kernel launches (matvec, bwd_fused, grad_x, periodic matvec, periodic bwd): training "
          f"{train_launches}, prediction {serve_launches} (predicted none)", flush=True)
    check(all(math.isfinite(e) for e in elbos), "svgp: a non-finite ELBO")
    check(elbo1 > elbo0, f"svgp: training took the fixed minibatch's ELBO from {elbo0} only to {elbo1}")
    check(rmse < const_rmse, f"svgp: rmse {rmse} not below the constant predictor's {const_rmse}")
    check(not any(train_launches) and not any(serve_launches), f"svgp: kernels launched {train_launches}, "
                                                                 f"{serve_launches}")
    return dict(elbo=elbo, gap=gap, kl_gap=kl_gap, step_ms=float(np.median(times[1:])) * 1e3, rmse=rmse, nlpd=nlpd,
                const_rmse=const_rmse, launches=sum(train_launches) + sum(serve_launches))


@contextlib.contextmanager
def recorded_calls(name: str, t=None, kt=None):
    """Wraps ``fused_kernels.<name>`` (a kernel's wrapper) for a run: keeps the operands of
    its first call (of ``t`` columns in the third operand and kernel type ``kt``, where they
    are given; tensors cloned, a tensor passed twice kept as one) and the shape (rows of the
    first operand, rows of the second, columns of the third) of every call, in a dict it
    yields (``first``: (args, kwargs), ``shapes``: [(n, m, t)])."""
    import torch

    from gpytorch_tpu_torch.ops import fused_kernels as fk

    wrapper, seen = getattr(fk, name), {"first": None, "shapes": []}

    def recording(*args, **kwargs):
        if seen["first"] is None and (t is None or args[2].shape[1] == t) and (kt is None or int(args[3]) == kt):
            copies = {}
            seen["first"] = (tuple(copies.setdefault(id(a), a.clone()) if isinstance(a, torch.Tensor) else a
                                   for a in args), dict(kwargs))
        seen["shapes"].append((args[0].shape[0], args[1].shape[0], args[2].shape[1]))
        return wrapper(*args, **kwargs)

    setattr(fk, name, recording)
    try:
        yield seen
    finally:
        setattr(fk, name, wrapper)


def _product_at_path_shape(args, tag: str = "unwhitened", what: str = "the KL's product",
                           against_float64: bool = False) -> dict:
    """kernel_matvec on the operands of a path's first product launch (``tag``: the
    unwhitened KL's by default) against its plain version on the same operands, gated at
    KERNEL_REL_TOL, both timed beside the bound (``matvec_tc_bound`` for the tensor-core
    tier, t in (32, 64], else ``matvec_bound``).  ``against_float64``: both float32 versions
    also against float64 on the same operands, the kernel gated at twice the plain version's
    error, as phase 3's training product is."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    x1, x2, v, kt = args
    got, plain = fk.kernel_matvec_cuda(x1, x2, v, kt), fk._matvec_reference(x1, x2, v, kt)
    rel, err = _rel_err(got, plain, x1, x2, v, kt)
    if against_float64:
        exact = fk._matvec_reference(x1.double(), x2.double(), v.double(), kt)
        rel64, plain64 = _rel_err(got, exact, x1, x2, v, kt)[0], _rel_err(plain, exact, x1, x2, v, kt)[0]
        del exact
        print(f"[{tag}] {what} against float64: kernel {rel64:.3e}, plain float32 {plain64:.3e}", flush=True)
        check(rel64 <= min(2.0 * plain64, KERNEL_REL_TOL), f"{tag}: {what} against float64: {rel64:.3e}, more than "
              f"twice the plain version's {plain64:.3e} or over {KERNEL_REL_TOL}")
    n, m, d, t = x1.shape[0], x2.shape[0], x1.shape[1], v.shape[1]
    ms = cuda_time_ms(lambda: fk.kernel_matvec_cuda(x1, x2, v, kt), 10)
    plain_ms = cuda_time_ms(lambda: fk._matvec_reference(x1, x2, v, kt), 10)
    bound = matvec_tc_bound(n, m, d, t) if 32 < t <= 64 else matvec_bound(n, m, d, t)
    print(f"[{tag}] {what} {n}x{m} d={d} t={t} (symmetric: {x1 is x2}) against its plain "
          f"version on the same operands: max abs err {err:.3e}, rel {rel:.3e} (tol {KERNEL_REL_TOL}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); {nvidia_smi()}", flush=True)
    check(rel <= KERNEL_REL_TOL, f"{tag}: {what} differs from its plain version by {rel:.3e}")
    return dict(n=n, m=m, d=d, t=t, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], max_abs_err=err)


def _e(x) -> str:
    """x in the %.3e form, or "not formed" for None."""
    return "not formed" if x is None else f"{x:.3e}"


def _bwd_at_path_shape(args, kwargs, tag: str = "unwhitened", what: str = "the KL's backward") -> dict:
    """kernel_bwd_fused on the operands of a path's first backward launch (``tag``: the
    unwhitened KL's by default), with the outputs that launch asked for (dv = K·g, where asked,
    is the wrapper's launch of the product kernel), against ``_bwd_fused_reference`` in float64
    on the same operands, beside the plain float32 version's errors.  Up to BWD_TERMS_N rows,
    where the sums of its terms' magnitudes (``_bwd_abs_terms``) are formed densely, each
    output's error is gated at BWD_REL_TOL of those sums as phase 2's ragged shapes are, dx and
    dv also at BWD_TRAIN_TOL of their own size, and dos, one sum that may cancel to a small
    fraction of its terms (|dos| / Σ|k g·v| is printed), at twice the plain float32 version's
    error; above BWD_TERMS_N rows each at BWD_TRAIN_TOL of its size and twice the plain
    version's, as phase 3b's training call is.  A planted fault, dos = 0, must fail its gate.
    Timed beside the bound (``bwd_tc_bound`` for the tensor-core tier, t in (32, 64], else
    ``bwd_bound``, with dv where it is asked for) and the plain version."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    x, g, v, kt = args
    need_dv, need_dos = kwargs.get("need_dv", True), kwargs.get("need_dos", False)
    n, d, t = x.shape[0], x.shape[1], v.shape[1]
    names = ("dv", "dx", "dos")
    got = dict(zip(names, fk.kernel_bwd_fused_cuda(x, g, v, kt, need_dv=need_dv, need_dos=need_dos)))
    plain = dict(zip(names, fk._bwd_fused_reference(x, g, v, kt, need_dv=need_dv, need_dos=need_dos)))
    x64, g64, v64 = x.double(), g.double(), v.double()
    exact = dict(zip(names, fk._bwd_fused_reference(x64, g64, v64, kt, need_dv=need_dv, need_dos=need_dos)))
    with_terms = n <= BWD_TERMS_N
    if with_terms:
        bx, bdv, bdos = _bwd_abs_terms(x64, g64, v64, kt)
        terms = {"dv": bdv.max().item(), "dx": bx.max().item(), "dos": bdos.item()}
    asked = [k for k in names if exact[k] is not None]
    err, limit, rel, max_abs = {}, {}, {}, 0.0
    for k in asked:
        size = exact[k].abs().max().item()
        for name, out in (("kernel", got), ("plain", plain)):
            err[(name, k)] = (out[k].double() - exact[k]).abs().max().item()
            rel[(name, k)] = (err[(name, k)] / terms[k] if with_terms else None, err[(name, k)] / size)
        max_abs = max(max_abs, err[("kernel", k)])
        if with_terms:
            limit[k] = min(BWD_REL_TOL * terms[k], 2.0 * err[("plain", k)] if k == "dos" else BWD_TRAIN_TOL * size)
        else:
            limit[k] = min(BWD_TRAIN_TOL * size, 2.0 * err[("plain", k)])
        rel[("gate", k)] = limit[k] / (terms[k] if with_terms else size)
    fault = abs(exact["dos"].item()) if need_dos else None  # the error of a planted dos = 0
    ms = cuda_time_ms(lambda: fk.kernel_bwd_fused_cuda(x, g, v, kt, need_dv=need_dv, need_dos=need_dos), 10)
    plain_ms = cuda_time_ms(lambda: fk._bwd_fused_reference(x, g, v, kt, need_dv=need_dv, need_dos=need_dos), 10)
    tc = 32 < t <= 64
    bound = bwd_tc_bound(n, d, t, need_dv, need_dos) if tc else bwd_bound(n, d, t, need_dv)
    tier = "the tensor-core tier" if tc else f"the FMA tier, {-(-t // 32)} column chunks of partials"
    cancel = (f"; |dos| / Σ|k g·v| = {fault / terms['dos']:.3e}, which a planted dos = 0 reads"
              if need_dos and with_terms else "")
    print(f"[{tag}] {what} {n}x{n} d={d} t={t} ({', '.join(asked)}; {tier}) against float64 on the same operands, "
          f"error over the sums of the terms' magnitudes / over the output's size: "
          + "; ".join(f"{k} kernel {_e(rel[('kernel', k)][0])} / {rel[('kernel', k)][1]:.3e}, plain float32 "
                      f"{_e(rel[('plain', k)][0])} / {rel[('plain', k)][1]:.3e}, gate {rel[('gate', k)]:.3e} "
                      f"{'of the terms' if with_terms else 'of the size'}"
                      for k in asked)
          + f"{cancel}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
            f"{nvidia_smi()}", flush=True)
    for k in asked:
        check(err[("kernel", k)] <= limit[k], f"{tag}: {what}, {k}, against float64: error {err[('kernel', k)]:.3e}, "
                                              f"over its gate {limit[k]:.3e} (plain float32 {err[('plain', k)]:.3e})")
    if need_dos:
        check(fault > limit["dos"], f"{tag}: {what}: the dos gate {limit['dos']:.3e} does not see a planted dos = 0 "
                                    f"({fault:.3e})")
    return dict(n=n, m=n, d=d, t=t, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], max_abs_err=max_abs,
                outputs=asked, rel_err={k: rel[("kernel", k)] for k in asked},
                plain_rel_err={k: rel[("plain", k)] for k in asked})


def phase_unwhitened(save=None):
    """Phase 14b: the unwhitened strategy at m = SVGP_M with a Cholesky q(u) (initialised from
    the prior N(μ_Z, K_ZZ + jitter)), UW_STEPS Adam steps (lr SVGP_ADAM_LR) on minibatches of
    SVGP_BATCH.  Its KL reads K_ZZ⁻¹ and log|K_ZZ| by mBCG on the lazy K_ZZ + jitter (SVGP_M
    > max_cholesky_size, SVGP_M² > max_eager_kernel_size²), so it launches kernel_matvec at
    SVGP_M × SVGP_M with t = SVGP_M + 1 + num_trace_samples columns ([L_S | μ_Z − m | probes]),
    and its backward kernel_bwd_fused at the same t.  Gates: finite values, both kernels
    launched in the KL, and the first launch of each held against its plain version on the
    same operands (the product at KERNEL_REL_TOL, the backward by ``_bwd_at_path_shape``), each
    timed beside its bound.  Prints the stochastic KL beside the dense-Cholesky KL of the same
    state in float32 and float64 (not gated).  ``save``: a path where the last state's
    parameters go (``np.savez``, under the JAX package's names), which
    ``tests/unwhitened_kl_witness.py`` reads into both packages.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_unwhitened()'``.  Returns the readings."""
    import copy

    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, _, _ = make_task(N_TRAIN, N_TEST)
    tx, ty = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y))
    # the jitter fixed, so that the float64 twin below is the same model
    model, likelihood = build_svgp(train_x, dev, torch.float32, dist="cholesky", whitened=False, jitter_val=SVGP_JITTER)
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    optimizer = torch.optim.Adam(list(model.parameters()) + list(likelihood.parameters()), lr=SVGP_ADAM_LR)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(SVGP_SEED), UW_STEPS, dev)
    with torch.no_grad():
        model(tx[:4])  # initialises q(u) from the prior
    torch.manual_seed(SVGP_SEED)  # the KL's probes come from torch's default generator
    wrappers = _kernel_wrappers()
    rows, times = [], []
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad()
        for w in wrappers:
            w.launches = 0
        with recorded_calls("kernel_matvec_cuda") as seen:
            loss = -mll(model(tx[idx]), ty[idx])
        forward = tuple(w.launches for w in wrappers)
        for w in wrappers:
            w.launches = 0
        with recorded_calls("kernel_bwd_fused_cuda") as seen_bwd:
            loss.backward()
        backward = tuple(w.launches for w in wrappers)
        optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        ok = finite_step(loss, model) and finite_step(loss, likelihood)
        rows.append((loss.item(), forward, backward, sorted(set(seen["shapes"])), sorted(set(seen_bwd["shapes"]))))
        check(ok, f"unwhitened: non-finite loss or gradient at step {len(rows) - 1}")
    for i, (loss, fwd, bwd, shapes, bwd_shapes) in enumerate(rows):
        print(f"[unwhitened] step {i}: ELBO {-loss:.5f}; launches (matvec, bwd_fused, grad_x, periodic matvec, "
              f"periodic bwd) forward {fwd}, backward {bwd}; K·V shapes {shapes}, backward shapes {bwd_shapes}",
              flush=True)
    check(all(fwd[0] > 0 for _, fwd, _, _, _ in rows), "unwhitened: the KL launched no kernel_matvec")
    check(all(bwd[1] > 0 for _, _, bwd, _, _ in rows), "unwhitened: the KL's backward launched no kernel_bwd_fused")
    shape = _product_at_path_shape(seen["first"][0])
    bwd_shape = _bwd_at_path_shape(*seen_bwd["first"])
    with torch.no_grad():
        kl32 = model.variational_strategy.kl_divergence(model=model).item()
        twin = copy.deepcopy(model).double()
        with gt.settings.max_cholesky_size(SVGP_M):
            kl32_dense = model.variational_strategy.kl_divergence(model=model).item()
            kl64 = twin.variational_strategy.kl_divergence(model=twin).item()
    print(f"[unwhitened] KL at the last state: mBCG float32 {kl32:.4f}, dense Cholesky float32 {kl32_dense:.4f}, dense "
          f"Cholesky float64 {kl64:.4f} (gap of the mBCG one {abs(kl32 - kl64) / abs(kl64):.3e} relative, not gated); "
          f"step {_quartiles_ms(times)}", flush=True)
    check(math.isfinite(kl32) and math.isfinite(kl64), "unwhitened: a non-finite KL")
    if save is not None:
        np.savez(save, **{k: p.detach().cpu().numpy() for k, p in model.named_parameters()},
                 **{f"likelihood.{k}": p.detach().cpu().numpy() for k, p in likelihood.named_parameters()})
        print(f"[unwhitened] the last state's parameters written to {save}", flush=True)
    launches = [fwd[0] for _, fwd, _, _, _ in rows]
    bwd_launches = [bwd[1] for _, _, bwd, _, _ in rows]
    return dict(shape=dict(shape, launches_per_step=launches),
                bwd_shape=dict(bwd_shape, launches_per_step=bwd_launches),
                launches=sum(launches), bwd_launches=sum(bwd_launches), kl=(kl32, kl32_dense, kl64))


def build_deep_gp(train_x, device, dtype):
    """Phase 14c's two-layer deep GP: a hidden layer of DGP_H GPs on the D inputs (LinearMean,
    ScaleKernel(RBFKernel(ard_num_dims=D)) with lengthscales and outputscales drawn from the
    seed, each a whitened Cholesky q(u) on DGP_M inducing points, a seeded subset of the
    training inputs of its own) and an output layer on the
    DGP_H hidden values (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=DGP_H)), DGP_M
    inducing points drawn from N(0, I)), with a GaussianLikelihood; on ``device``."""
    import torch

    import gpytorch_tpu_torch as gt

    rng = np.random.default_rng(DGP_SEED)
    Z_hidden = np.stack([train_x[rng.choice(len(train_x), DGP_M, replace=False)] for _ in range(DGP_H)])
    Z_out = rng.normal(size=(DGP_M, DGP_H))

    class Layer(gt.models.deep_gps.DeepGPLayer):
        def __init__(self, Z, input_dims, output_dims):
            batch = () if output_dims is None else (output_dims,)
            vd = gt.variational.CholeskyVariationalDistribution(DGP_M, batch_shape=batch)
            super().__init__(gt.variational.VariationalStrategy(self, torch.as_tensor(Z), vd), input_dims, output_dims)
            self.mean_module = (gt.means.LinearMean(input_dims, batch_shape=batch) if output_dims
                                else gt.means.ConstantMean())
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=input_dims, batch_shape=batch),
                                                       batch_shape=batch)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    class TwoLayerDeepGP(gt.models.deep_gps.DeepGP):
        def __init__(self):
            super().__init__()
            self.hidden_layer = Layer(Z_hidden, D, DGP_H)
            self.last_layer = Layer(Z_out, DGP_H, None)
            self.likelihood = gt.likelihoods.GaussianLikelihood()

        def forward(self, x, base_samples=None):
            return self.last_layer(self.hidden_layer(x), base_samples=base_samples)

    model = TwoLayerDeepGP()
    # distinct hidden GPs: with one set of hyperparameters and q(u) at its prior (the whitened
    # start), every hidden output has the same covariance, each eigenvalue of the block-diagonal
    # covariance is DGP_H-fold, and the eigh backward of the sample's Lanczos root divides by
    # the gaps between its Ritz values (in float32 on the CPU the first gradient read NaN)
    kern = model.hidden_layer.covar_module
    kern.base_kernel.lengthscale = rng.uniform(0.2, 1.0, size=(DGP_H, 1, D))
    kern.outputscale = rng.uniform(0.5, 1.5, size=DGP_H)
    return model.to(device=device, dtype=dtype)


def phase_deep_gp():
    """Phase 14c: the two-layer deep GP (``build_deep_gp``) at N=100k, DGP_STEPS Adam steps (lr
    DGP_LR) on minibatches of SVGP_BATCH with DeepApproximateMLL(VariationalELBO) and
    DGP_S samples: each step the output layer reads one joint draw of the SVGP_BATCH × DGP_H
    hidden values per sample, from a rank-100 Lanczos root of the hidden layer's whole
    block-diagonal covariance (SVGP_BATCH · DGP_H > max_cholesky_size).  Gates: finite
    objectives, the mean objective of the last ten steps above that of the first ten, the
    RMSE of the N_TEST test points (the mean over DGP_S samples) below the constant
    predictor's, and no hand-written kernel launched (every kernel matrix here is formed
    densely).  Prints deep_gp_step_ms and the peak device memory.  Returns the readings."""
    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model = build_deep_gp(train_x, dev, torch.float32)
    mll = gt.mlls.DeepApproximateMLL(gt.mlls.VariationalELBO(model.likelihood, model, num_data=N_TRAIN))
    optimizer = torch.optim.Adam(model.parameters(), lr=DGP_LR)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(DGP_SEED), DGP_STEPS, dev)
    samples = torch.Generator(device=dev).manual_seed(DGP_SEED + 1)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    objectives, times = [], []
    with gt.settings.num_likelihood_samples(DGP_S):
        for idx in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimizer.zero_grad()
            objective = mll(model(tx[idx], base_samples=samples), ty[idx])
            (-objective).backward()
            optimizer.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            objectives.append(objective.item())
            check(finite_step(objective, model), f"deep gp: non-finite objective or gradient at step {len(times) - 1}")
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            means = [model(sx[i:i + SVGP_BATCH], base_samples=samples).mean.mean(0) for i in range(0, N_TEST, SVGP_BATCH)]
    launches = tuple(w.launches for w in wrappers)
    mean = torch.cat(means)
    rmse = (mean - sy).pow(2).mean().sqrt().item()
    const_rmse = (sy - ty.mean()).pow(2).mean().sqrt().item()
    first, last = float(np.mean(objectives[:10])), float(np.mean(objectives[-10:]))
    print(f"[deep gp] H={DGP_H}, m={DGP_M} per layer, S={DGP_S}, minibatch {SVGP_BATCH}, {DGP_STEPS} Adam steps (lr "
          f"{DGP_LR}): deep_gp_step_ms {_quartiles_ms(times[1:])} over steps 1-{DGP_STEPS - 1}, first step "
          f"{times[0] * 1e3:.1f} ms; objective, mean of the first and last ten steps {first:.4f} → {last:.4f} (per step "
          f"{[round(o, 3) for o in objectives[::10]]} every tenth); peak device memory {peak / 2**20:.1f} MiB; "
          f"{nvidia_smi()}", flush=True)
    print(f"[deep gp] {N_TEST} test points, mean over {DGP_S} samples: rmse {rmse:.4f} (constant predictor "
          f"{const_rmse:.4f}); hand-written kernel launches (matvec, bwd_fused, grad_x, periodic matvec, periodic bwd) "
          f"{launches} (predicted none)", flush=True)
    check(last > first, f"deep gp: the objective went from {first} only to {last}")
    check(rmse < const_rmse, f"deep gp: rmse {rmse} not below the constant predictor's {const_rmse}")
    check(not any(launches), f"deep gp: kernels launched {launches}")
    return dict(step_ms=float(np.median(times[1:])) * 1e3, rmse=rmse, const_rmse=const_rmse, objective=(first, last),
                peak=peak, launches=sum(launches))


def make_dirichlet_task(n_train: int, n_test: int, seed: int = 0):
    """Phase 15's classification task: ``make_task``'s inputs, and as labels the terciles of
    its targets (0, 1, 2), the thresholds from the training targets.  Returns x, labels,
    the test inputs and the test labels."""
    train_x, train_y, test_x, test_y = make_task(n_train, n_test, seed)
    thresholds = np.quantile(train_y, [1 / 3, 2 / 3])
    return train_x, np.digitize(train_y, thresholds), test_x, np.digitize(test_y, thresholds)


def build_dirichlet_model(train_x, labels, device, dtype):
    """GPyTorch's Dirichlet GP classifier: ``DirichletClassificationLikelihood(labels)`` and a
    batch of one GP per class (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=d)), each
    with ``batch_shape=(C,)``) on the transformed targets (C, n), the inputs shared by the
    classes (broadcast to (C, n, d)), at the flagship's initial lengthscale 0.5, in train
    mode."""
    import torch

    import gpytorch_tpu_torch as gt

    d = np.shape(train_x)[1]
    likelihood = gt.likelihoods.DirichletClassificationLikelihood(torch.as_tensor(labels, device=device), dtype=dtype)
    c = likelihood.num_classes

    class DirichletGP(gt.models.ExactGP):
        def __init__(self, x, y, lik):
            super().__init__(x, y, lik)
            self.mean_module = gt.means.ConstantMean(batch_shape=(c,))
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=d, batch_shape=(c,)),
                                                       batch_shape=(c,))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx = torch.as_tensor(train_x, dtype=dtype, device=device)
    model = DirichletGP(tx.expand((c,) + tx.shape), likelihood.transformed_targets, likelihood).to(device=device,
                                                                                                   dtype=dtype)
    model.covar_module.base_kernel.lengthscale = 0.5
    return model.train()


def build_fixed_noise_model(train_x, train_y, noise, device, dtype):
    """The flagship's model (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=d))) with a
    ``FixedNoiseGaussianLikelihood(noise)``, in eval mode."""
    import torch

    import gpytorch_tpu_torch as gt

    d = np.shape(train_x)[1]

    class FixedNoiseGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=d))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx, ty, tn = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y, noise))
    return FixedNoiseGP(tx, ty, gt.likelihoods.FixedNoiseGaussianLikelihood(tn)).to(device=device, dtype=dtype).eval()


def _dirichlet_element(model, c: int):
    """Class ``c`` of the Dirichlet ``model`` as an unbatched fixed-noise model with that
    element's parameters, in eval mode."""
    import torch

    import gpytorch_tpu_torch as gt

    lik = model.likelihood
    element = build_fixed_noise_model(model.train_inputs[0][c], model.train_targets[c], lik.noise_covar.noise[c],
                                      model.train_targets.device, model.train_targets.dtype)
    raw = dict(model.named_parameters())
    gt.load_jax_params(element, {name: raw[name][c].detach().cpu().numpy() for name, _ in element.named_parameters()})
    return element.eval()


def phase_dirichlet():
    """Phase 15: Dirichlet GP classification at full width (``make_dirichlet_task``: the
    terciles of the flagship task's targets at N=100,000, d=3, C=3 classes), the model of
    ``build_dirichlet_model`` trained on the transformed targets with bench.py's recipe for
    DIR_STEPS steps (the mean over the classes of −MLL per datum), then refreshed and asked
    for the 2,048 test points: dirichlet_step_ms, CG iterations (each class's own count
    read from an unbatched solve of its mean cache), refresh_s, request_ms, held-out
    accuracy (the argmax of the three latent means) beside chance, peak memory.  Gates:
    finite losses, the last 5 losses below the first 5, each class's mean cache within
    TRUE_RES_LIMIT by its float64 true residual, the accuracy above chance, the launches (3
    kernel_matvec a CG iteration, 3 kernel_bwd_fused a step, no kernel_grad_x; serving 3 a
    CG iteration, Lanczos block and product), and the first t=64 launch of kernel_matvec
    and of kernel_bwd_fused against their plain versions on the same operands (one class's).
    Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_dirichlet()'``.  Returns the
    readings."""
    import torch

    from gpytorch_tpu_torch import settings

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, labels, test_x, test_labels = make_dirichlet_task(N_TRAIN, N_TEST)
    model = build_dirichlet_model(train_x, labels, dev, torch.float32)
    c = model.likelihood.num_classes
    check(c == DIR_CLASSES, f"dirichlet: {c} classes, expected {DIR_CLASSES}")
    noise = model.likelihood.noise_covar.noise
    print(f"[dirichlet] N={N_TRAIN}, {c} classes of {np.bincount(labels).tolist()} points; fixed noise "
          f"{noise.min().item():.4f} (the true class) to {noise.max().item():.4f}", flush=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    scheduler = torch.optim.lr_scheduler.CosineAnnealingLR(optimizer, T_max=DIR_STEPS, eta_min=0.01)
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(c, N_TRAIN, 1, dtype=torch.float32, device=dev)
    wrappers = _kernel_wrappers()
    times, iters, losses = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with recorded_calls("kernel_matvec_cuda", t=64) as seen, recorded_calls("kernel_bwd_fused_cuda", t=64) as seen_bwd:
        for w in wrappers:
            w.launches = 0
        for step in range(DIR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optimizer.zero_grad()
            loss, _, state = batch_loss(model, generator, state)
            loss.backward()
            optimizer.step()
            scheduler.step()
            ok = finite_step(loss, model)
            times.append(time.perf_counter() - t0)
            iters.append(state.num_iters)
            losses.append(loss.item())
            check(ok, f"dirichlet training step {step}: non-finite loss or gradient")
        train_launches = tuple(w.launches for w in wrappers)
    train_peak = torch.cuda.max_memory_allocated()
    ms = sorted(1e3 * t_ for t_ in times[1:])
    median = ms[(DIR_STEPS - 1) // 2]
    kern = model.covar_module
    print(f"[dirichlet] {DIR_STEPS} steps: dirichlet_step_ms median {median:.1f} (range {ms[0]:.1f} to {ms[-1]:.1f}) "
          f"over steps 1-{DIR_STEPS - 1}, first step {times[0]:.3f} s; CG iterations per step {iters} ({sum(iters)} in "
          f"all); loss per step {[round(x, 5) for x in losses]}; peak device memory {train_peak / 2**20:.1f} MiB",
          flush=True)
    print(f"[dirichlet] lengthscales {kern.base_kernel.lengthscale.detach().cpu().numpy().round(4).tolist()}, "
          f"outputscales {kern.outputscale.detach().cpu().numpy().round(4).tolist()}, constant means "
          f"{model.mean_module.constant.detach().cpu().numpy().round(4).tolist()}", flush=True)
    expected = (c * sum(iters), c * DIR_STEPS, 0, 0, 0)
    print(f"[dirichlet] training launched {train_launches} (expected {expected}: one product per class a CG iteration, "
          f"one fused backward per class a step)", flush=True)
    check(train_launches == expected, f"dirichlet training launched {train_launches}, expected {expected}")
    check(all(math.isfinite(x) for x in losses), "dirichlet: a non-finite loss")
    check(sum(losses[-5:]) < sum(losses[:5]), f"dirichlet: the loss did not fall: {losses}")
    check(seen["first"] is not None and seen_bwd["first"] is not None, "dirichlet: no t=64 launch recorded")
    shape = _product_at_path_shape(seen["first"][0], "dirichlet", "the training product (one class)")
    bwd_shape = _bwd_at_path_shape(*seen_bwd["first"], tag="dirichlet", what="the training backward (one class)")

    model.eval()
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    for w in wrappers:
        w.launches = 0
    with eval_settings(), torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        strategy = model.refresh()
        sync(dev)
        refresh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = model(tx)
        mean, var = pred.mean, pred.variance
        sync(dev)
        request_s = time.perf_counter() - t0
    serve_launches = tuple(w.launches for w in wrappers)
    cg = strategy.lik_train_train_covar.last_cg_result
    serve_expected = (c * (cg.num_iters + 5 + 2), 0, 0, 0, 0)
    check(bool(torch.isfinite(mean).all()) and bool((var > 0).all()), "dirichlet: predictions not finite or ≤ 0")
    accuracy = (mean.argmax(0).cpu().numpy() == test_labels).mean()
    residuals = true_residuals(model, strategy.mean_cache)
    per_class = []
    with eval_settings(), torch.no_grad(), settings.cg_tolerance(settings.eval_cg_tolerance.value()):
        for k in range(c):
            element = _dirichlet_element(model, k).prediction_strategy()
            gap = ((element.mean_cache - strategy.mean_cache[k]).abs().max() / strategy.mean_cache[k].abs().max())
            per_class.append((element.lik_train_train_covar.last_cg_result.num_iters, gap.item()))
    print(f"[dirichlet] serving: refresh_s {refresh_s:.3f} (batched CG {cg.num_iters} iterations, relative residual "
          f"{cg.residual_norm.reshape(-1).tolist()}; each class alone {[k for k, _ in per_class]} iterations, its "
          f"cache {[f'{g:.2e}' for _, g in per_class]} from the batched one), request_ms {request_s * 1e3:.2f} "
          f"({N_TEST} points, {c} classes); held-out accuracy {accuracy:.4f} (chance {1 / c:.4f}); float64 true "
          f"residuals of the classes' mean caches {[f'{r:.3e}' for r in residuals]} (limit {TRUE_RES_LIMIT}); launches "
          f"{serve_launches} (expected {serve_expected}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {nvidia_smi()}", flush=True)
    check(serve_launches == serve_expected, f"dirichlet serving launched {serve_launches}, expected {serve_expected}")
    check(all(r <= TRUE_RES_LIMIT for r in residuals), f"dirichlet: mean-cache residuals {residuals}")
    check(accuracy > 1 / c, f"dirichlet: held-out accuracy {accuracy:.4f} not above chance")
    return dict(launches=(train_launches[0] + serve_launches[0], train_launches[1]), median_ms=median, iters=iters,
                refresh_s=refresh_s, request_ms=request_s * 1e3, accuracy=accuracy, peak=train_peak, shape=shape,
                bwd_shape=bwd_shape, per_class_iters=[k for k, _ in per_class])


def _fantasy_against_refit(tag, model, refit, xf, yf, test_x, noise=None, planted=True):
    """Conditions the eval-mode ``model`` on (``xf``, ``yf``) (with ``noise`` the new points'
    fixed noise), timed, at eval's CG tolerance (its joint true residual read) and at
    FANT_CG_TOL, and holds the latter against ``refit``, a model of the same parameters on
    the joint data: their means at ``test_x`` within FANT_MEAN_TOL of the largest, their
    variances within 1e-6 (both LOVE on the same joint operator), each mean cache's float64
    true residual read, and with ``planted`` a planted fault (the update without its
    −(A⁻¹B)v term) that the mean gate must see.  Returns (fantasy_ms at eval's tolerance,
    launches of the five kernels in the gated conditioning, its CG iterations, gaps)."""
    import torch

    from gpytorch_tpu_torch import settings

    dev = test_x.device
    wrappers = _kernel_wrappers()
    kwargs = {} if noise is None else {"noise": noise}
    runs = {}
    with eval_settings(), torch.no_grad():
        model.refresh()
        old_u = model.prediction_strategy().mean_cache
        for tol in (settings.eval_cg_tolerance.value(), FANT_CG_TOL):
            with settings.cg_tolerance(tol):
                for w in wrappers:
                    w.launches = 0
                sync(dev)
                t0 = time.perf_counter()
                fantasy = model.get_fantasy_model(xf, yf, **kwargs)
                sync(dev)
                runs[tol] = (1e3 * (time.perf_counter() - t0), tuple(w.launches for w in wrappers),
                             model.prediction_strategy().lik_train_train_covar.last_cg_result.num_iters, fantasy)
        fantasy_ms, _, eval_iters, loose = runs[settings.eval_cg_tolerance.value()]
        _, launches, iters, fantasy = runs[FANT_CG_TOL]
        with settings.cg_tolerance(settings.eval_cg_tolerance.value()):  # a multitask fantasy builds it here
            loose_u = loose.prediction_strategy().mean_cache
        fantasy.refresh()
        refit.refresh()
        u_f = fantasy.prediction_strategy().mean_cache
        post_f, post_r = fantasy(test_x), refit(test_x)
        u_r = refit.prediction_strategy().mean_cache
        mean_f, mean_r = post_f.mean.double(), post_r.mean.double()
        var_f, var_r = post_f.variance.double(), post_r.variance.double()
        if planted:
            n = old_u.shape[-1]
            u_fault = torch.cat([old_u, u_f[..., n:]], -1)
            cross = fantasy.covar_module(test_x, fantasy.train_inputs[0])
            mean_fault = (cross.matmul(u_fault.unsqueeze(-1)).squeeze(-1) + fantasy.mean_module(test_x)).double()
    scale = mean_r.abs().max().item()
    gap = (mean_f - mean_r).abs().max().item() / scale
    var_gap = ((var_f - var_r).abs() / var_r).max().item()
    fault_gap = (mean_fault - mean_r).abs().max().item() / scale if planted else float("nan")
    res_f, res_r, res_loose = (true_residuals(m, u) for m, u in ((fantasy, u_f), (refit, u_r), (loose, loose_u)))
    print(f"[{tag}] conditioning at eval's CG tolerance: fantasy_ms {fantasy_ms:.3f}, CG {eval_iters} iterations, the "
          f"joint float64 true residual |y − μ − K̂u| / |y − μ| {[f'{r:.3e}' for r in res_loose]} (read); at "
          f"{FANT_CG_TOL}: CG {iters} iterations, launches {launches}; against a model built on the joint data: mean max "
          f"|Δ| / max |μ| {gap:.3e} (tol {FANT_MEAN_TOL}), variances max |Δ| / σ² {var_gap:.3e} (tol 1e-6); true "
          f"residuals fantasy {[f'{r:.3e}' for r in res_f]}, refit {[f'{r:.3e}' for r in res_r]}"
          + (f"; planted fault (no −(A⁻¹B)v) {fault_gap:.3e}" if planted else ""), flush=True)
    check(bool(torch.isfinite(mean_f).all()) and bool((var_f > 0).all()), f"{tag}: mean not finite or a variance ≤ 0")
    check(gap <= FANT_MEAN_TOL, f"{tag}: the fantasy mean differs from a refit's by {gap:.3e}")
    check(var_gap <= 1e-6, f"{tag}: the fantasy's variances differ from a refit's by {var_gap:.3e}")
    if planted:
        check(fault_gap > FANT_MEAN_TOL, f"{tag}: the gate does not see a planted fault: {fault_gap:.3e}")
    return fantasy_ms, launches, iters, dict(mean=gap, var=var_gap, fault=fault_gap, res_f=res_f, res_r=res_r,
                                             res_loose=res_loose)


def phase_fantasy_more(batch_model=None, flagship_model=None, multitask_model=None):
    """Phase 15b: fantasies of the batched, fixed-noise and multitask models, each held
    against a model built on the joint data (``_fantasy_against_refit``):

    * phase 13's two-output batch at N=100k (``batch_model``), FANT_Q new points per output
      (every 128th test point, with its own targets): a Schur update per element, its t=16
      solves launching 2 kernel_matvec a CG iteration (gated);
    * the flagship's trained parameters (``flagship_model``) in a ``FixedNoiseGaussianLikelihood``
      model whose noise per point is the trained noise times a seeded factor in
      FN_NOISE_FACTOR, conditioned on FANT_Q points with their own noise
      (``get_fantasy_model(..., noise=...)``), one kernel_matvec a CG iteration (gated);
    * phase 13b's Kronecker model (``multitask_model``, MT_N × MT_TASKS), conditioned on FANT_Q
      points (targets FANT_Q × MT_TASKS): no Schur update, its caches rebuilt on the joint
      operator; no kernel launch (gated).

    Alone (models at their initial values, the flagship at JAX_PARAMS):
    ``python3 -c 'import chip_smoke; chip_smoke.phase_fantasy_more()'``.  Returns the readings."""
    import torch

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    out = {}
    f32 = dict(dtype=torch.float32, device=dev)

    # the batched fantasy
    train_x, train_y, test_x, test_y, _ = make_batch_task(N_TRAIN, N_TEST, seed=0)
    model = batch_model if batch_model is not None else build_batch_model(train_x, train_y, dev, torch.float32)
    model.eval()
    b = train_y.shape[0]
    step = N_TEST // FANT_Q
    xf = torch.as_tensor(test_x[::step][:FANT_Q], **f32).expand(b, FANT_Q, D)
    yf = torch.as_tensor(test_y[:, ::step][:, :FANT_Q], **f32)
    refit = build_batch_model(np.concatenate([train_x, test_x[::step][:FANT_Q]]),
                              np.concatenate([train_y, test_y[:, ::step][:, :FANT_Q]], -1), dev, torch.float32)
    refit.load_state_dict(model.state_dict())
    ms, launches, iters, gaps = _fantasy_against_refit("batch fantasy", model, refit.eval(), xf, yf,
                                                       torch.as_tensor(test_x, **f32))
    check(launches == (b * iters, 0, 0, 0, 0), f"batch fantasy launched {launches}, expected ({b * iters}, 0, …)")
    out["batch"] = dict(ms=ms, launches=launches[0], gaps=gaps)

    # the fixed-noise fantasy on the flagship's parameters
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST, seed=0)
    flagship = flagship_model if flagship_model is not None else build_model(train_x, train_y, dev, torch.float32)
    sigma2 = flagship.likelihood.noise.reshape(-1)[0].item()
    factor = np.random.default_rng(FN_SEED).uniform(*FN_NOISE_FACTOR, size=N_TRAIN + FANT_Q)
    noise = sigma2 * factor
    xf_np, yf_np = test_x[::step][:FANT_Q], test_y[::step][:FANT_Q]
    params = {k: v for k, v in flagship.state_dict().items() if not k.startswith("likelihood.")}
    fixed = build_fixed_noise_model(train_x, train_y, noise[:N_TRAIN], dev, torch.float32)
    fixed.load_state_dict(params, strict=False)
    joint = build_fixed_noise_model(np.concatenate([train_x, xf_np]), np.concatenate([train_y, yf_np]), noise, dev,
                                    torch.float32)
    joint.load_state_dict(params, strict=False)
    ms, launches, iters, gaps = _fantasy_against_refit(
        "fixed-noise fantasy", fixed, joint, torch.as_tensor(xf_np, **f32), torch.as_tensor(yf_np, **f32),
        torch.as_tensor(test_x, **f32), noise=torch.as_tensor(noise[N_TRAIN:], **f32))
    check(launches == (iters, 0, 0, 0, 0), f"fixed-noise fantasy launched {launches}, expected ({iters}, 0, …)")
    out["fixed_noise"] = dict(ms=ms, launches=launches[0], gaps=gaps, noise=(float(noise.min()), float(noise.max())))

    # the multitask fantasy
    train_x, train_y, test_x, clean = make_multitask_task(MT_N, MT_TEST, MT_TASKS)
    mt = multitask_model if multitask_model is not None else build_multitask_model(train_x, train_y, dev,
                                                                                     torch.float32)
    mt.eval()
    mt_xf, mt_yf = test_x[:FANT_Q], clean[:FANT_Q]
    refit = build_multitask_model(np.concatenate([train_x, mt_xf]), np.concatenate([train_y, mt_yf]), dev,
                                  torch.float32)
    refit.load_state_dict(mt.state_dict())
    ms, launches, _, gaps = _fantasy_against_refit("multitask fantasy", mt, refit.eval(), torch.as_tensor(mt_xf, **f32),
                                                   torch.as_tensor(mt_yf, **f32), torch.as_tensor(test_x, **f32),
                                                   planted=False)
    check(launches == (0,) * 5, f"multitask fantasy launched {launches}")
    out["multitask"] = dict(ms=ms, gaps=gaps)
    return out


def build_structure_model(train_x, train_y, device, dtype, skip=False):
    """An exact GP (ConstantMean, GaussianLikelihood with noise ≥ NOISE_FLOOR) with
    ``AdditiveStructureKernel(ScaleKernel(RBFKernel()), num_dims=d)``, or with ``skip`` SKIP,
    ``ProductStructureKernel(ScaleKernel(GridInterpolationKernel(RBFKernel(), grid_size=SKIP_GRID,
    num_dims=1)), num_dims=d)``, at the flagship's initial noise 0.1 and lengthscale 0.5, in
    train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    d = np.shape(train_x)[1]
    ks = gt.kernels
    if skip:
        covar = ks.ProductStructureKernel(ks.ScaleKernel(ks.GridInterpolationKernel(ks.RBFKernel(), grid_size=SKIP_GRID,
                                                                                    num_dims=1)), num_dims=d)
    else:
        covar = ks.AdditiveStructureKernel(ks.ScaleKernel(ks.RBFKernel()), num_dims=d)

    class StructureGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = covar

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx, ty = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y))
    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    model = StructureGP(tx, ty, likelihood).to(device=device, dtype=dtype)
    model.likelihood.noise = 0.1
    rbf = model.covar_module.base_kernel.base_kernel
    (rbf.base_kernel if skip else rbf).lengthscale = 0.5
    return model.train()


def phase_structure():
    """Phase 15c: the structure kernels on the flagship task at N=STRUCT_N, d=3 (the JAX
    package's kernels densify d × n × n values, 3.2 GB of float32 here, so this path does
    not run at 100k): the additive structure model and SKIP (``build_structure_model``), each
    STRUCT_STEPS Adam steps (cosine 0.1 → 0.01) of bench.py's recipe with the kernel matrix
    evaluated densely once a step (``max_eager_kernel_size(STRUCT_N)``), then refreshed and
    asked for the 2,048 test points: ms a step, peak memory, RMSE.  Gates: finite losses, the
    last 5 losses below the first 5, the RMSE below the constant predictor's, and no kernel
    launch (no TPU kernel is on this path).  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_structure()'``.  Returns the readings."""
    import torch

    from gpytorch_tpu_torch import settings

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(STRUCT_N, N_TEST, seed=0)
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=dev)
    constant_rmse = float(np.sqrt(np.mean((test_y - train_y.mean()) ** 2)))
    wrappers = _kernel_wrappers()
    out = {}
    for name, skip in (("additive", False), ("skip", True)):
        model = build_structure_model(train_x, train_y, dev, torch.float32, skip=skip)
        optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
        scheduler = torch.optim.lr_scheduler.CosineAnnealingLR(optimizer, T_max=STRUCT_STEPS, eta_min=0.01)
        generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
        state = torch.zeros(STRUCT_N, 1, dtype=torch.float32, device=dev)
        for w in wrappers:
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times, iters = [], [], []
        with settings.max_eager_kernel_size(STRUCT_N):
            for step in range(STRUCT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, state = train_step(model, optimizer, scheduler, generator, state)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss.item())
                iters.append(state.num_iters)
                check(finite_step(loss, model), f"structure {name} step {step}: non-finite loss or gradient")
            peak = torch.cuda.max_memory_allocated()
            model.eval()
            with eval_settings(), torch.no_grad():
                sync(dev)
                t0 = time.perf_counter()
                model.refresh()
                sync(dev)
                refresh_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                pred = model(tx)
                mean, var = pred.mean, pred.variance
                sync(dev)
                request_s = time.perf_counter() - t0
        launched = tuple(w.launches for w in wrappers)
        rmse = (mean.double().cpu() - torch.as_tensor(test_y)).square().mean().sqrt().item()
        ms = sorted(1e3 * t_ for t_ in times[1:])
        median = ms[(STRUCT_STEPS - 1) // 2]
        print(f"[structure] {name} at N={STRUCT_N}, d={D}: {STRUCT_STEPS} steps, median {median:.1f} ms/step (range "
              f"{ms[0]:.1f} to {ms[-1]:.1f}, first {times[0]:.3f} s); CG iterations {iters}; loss {losses[0]:.5f} → "
              f"{losses[-1]:.5f}; peak device memory {peak / 2**20:.1f} MiB; refresh_s {refresh_s:.3f}, request_ms "
              f"{request_s * 1e3:.2f} ({N_TEST} points); rmse {rmse:.4f} (the constant predictor's {constant_rmse:.4f}); "
              f"launches {launched} (none expected: no TPU kernel on this path); {nvidia_smi()}", flush=True)
        check(all(math.isfinite(x) for x in losses), f"structure {name}: a non-finite loss")
        check(sum(losses[-5:]) < sum(losses[:5]), f"structure {name}: the loss did not fall: {losses}")
        check(bool(torch.isfinite(mean).all()) and bool((var > 0).all()), f"structure {name}: predictions not finite")
        check(rmse < constant_rmse, f"structure {name}: rmse {rmse:.4f} not below the constant predictor's")
        check(launched == (0,) * 5, f"structure {name} launched {launched}")
        out[name] = dict(median_ms=median, peak=peak, rmse=rmse, refresh_s=refresh_s, request_ms=request_s * 1e3,
                         iters=iters)
        del model, optimizer, state, pred, mean, var
        torch.cuda.empty_cache()
    return out


def _ngd_and_adam(model, likelihood):
    """NGD (lr SVGP_NGD_LR, num_data = N_TRAIN) on q(u)'s natural parameters and Adam (lr
    SVGP_ADAM_LR) on the model's other parameters and the likelihood's."""
    import torch

    import gpytorch_tpu_torch as gt

    is_natural = lambda name: "_variational_distribution.natural" in name  # noqa: E731
    named = dict(model.named_parameters())
    ngd = gt.optim.NGD([p for k, p in named.items() if is_natural(k)], num_data=N_TRAIN, lr=SVGP_NGD_LR)
    adam = torch.optim.Adam([p for k, p in named.items() if not is_natural(k)] + list(likelihood.parameters()),
                            lr=SVGP_ADAM_LR)
    return ngd, adam


def _matvec_against_float64(x1, x2, v, tag, what):
    """kernel_matvec on a path's operands (x2 is x1 where the product is symmetric) against
    the plain float32 version and the plain version in float64, gated at twice the plain
    float32 version's max |Δ| / max |K v|, both timed beside ``matvec_bound``."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    got, plain = fk.kernel_matvec_cuda(x1, x2, v, fk.RBF), fk._matvec_reference(x1, x2, v, fk.RBF)
    exact = fk._matvec_reference(x1.double(), x2.double(), v.double(), fk.RBF)
    scale = exact.abs().max().item()
    rel, prel = ((a.double() - exact).abs().max().item() / scale for a in (got, plain))
    n, m, t = x1.shape[0], x2.shape[0], v.shape[1]
    ms = cuda_time_ms(lambda: fk.kernel_matvec_cuda(x1, x2, v, fk.RBF), 5)
    plain_ms = cuda_time_ms(lambda: fk._matvec_reference(x1, x2, v, fk.RBF), 2)
    bms, by = matvec_tc_bound(n, m, D, t) if 32 < t <= 64 else matvec_bound(n, m, D, t)
    print(f"[{tag}] kernel_matvec {n}x{m} d={D} t={t} ({what}; symmetric: {x1 is x2}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.0%}); against float64 max |Δ| / max |K v|: kernel "
          f"{rel:.3e}, plain float32 {prel:.3e} (gate: twice the plain version's); {nvidia_smi()}", flush=True)
    check(rel <= 2.0 * prel, f"{tag}: kernel_matvec at {n}x{m}, t={t} against float64: {rel:.3e}, more than twice "
                             f"the plain version's {prel:.3e}")
    return dict(n=n, m=m, t=t, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                max_abs_err=(got.double() - exact).abs().max().item(), rel_err=rel, plain_rel_err=prel)


def _bwd_against_float64(x, g, v, tag, what):
    """kernel_bwd_fused (dx and dos, no dv) on the path's operands against the plain float32
    version and the plain version in float64: dx gated at twice the plain float32 version's
    max |Δdx| / max |dx|, dos over Σ|k_ij g_i·v_j| at LG_DOS_TOL beside a planted fault (the
    kernel's dos × (1 − LG_FAULT_EPS)) that the gate must see, as phase 10 gates it; both
    timed beside ``bwd_bound``."""
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    kw = dict(need_dv=False, need_dos=True)
    _, dx, dos = fk.kernel_bwd_fused_cuda(x, g, v, fk.RBF, **kw)
    _, pdx, pdos = fk._bwd_fused_reference(x, g, v, fk.RBF, **kw)
    _, edx, edos = fk._bwd_fused_reference(x.double(), g.double(), v.double(), fk.RBF, **kw)
    size = edx.abs().max().item()
    rel, prel = ((a.double() - edx).abs().max().item() / size for a in (dx, pdx))
    terms = _dos_abs_sum(x, g, v)
    dos_terms = {name: abs(b.double() - edos).item() / terms
                 for name, b in (("kernel", dos), ("plain", pdos), ("fault", dos * (1.0 - LG_FAULT_EPS)))}
    n, t = x.shape[0], v.shape[1]
    ms = cuda_time_ms(lambda: fk.kernel_bwd_fused_cuda(x, g, v, fk.RBF, **kw), 5)
    plain_ms = cuda_time_ms(lambda: fk._bwd_fused_reference(x, g, v, fk.RBF, **kw), 2)
    bms, by = bwd_tc_bound(n, D, t) if 32 < t <= 64 else bwd_bound(n, D, t)
    chunks = fk.load_library().gp_kernel_bwd_fused_chunks(t, D)
    print(f"[{tag}] kernel_bwd_fused {n}x{n} d={D} t={t} ({what}; dx, dos, no dv; {chunks} column chunks of partials): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}, {bms / ms:.0%}); against float64 "
          f"max |Δdx| / max |dx|: kernel {rel:.3e}, plain float32 {prel:.3e} (gate: twice the plain version's); "
          f"|Δdos| / Σ|k g·v| (|dos| / Σ|k g·v| = {abs(edos.item()) / terms:.3e}): kernel {dos_terms['kernel']:.3e}, "
          f"plain float32 {dos_terms['plain']:.3e} (gate {LG_DOS_TOL}; planted fault {dos_terms['fault']:.3e}); "
          f"{nvidia_smi()}", flush=True)
    check(rel <= 2.0 * prel, f"{tag}: kernel_bwd_fused at {n}x{n}, t={t}, dx against float64: {rel:.3e}, more than "
                             f"twice the plain version's {prel:.3e}")
    check(dos_terms["kernel"] <= LG_DOS_TOL, f"{tag}: kernel_bwd_fused at {n}x{n}, t={t}, dos against float64: "
                                             f"{dos_terms['kernel']:.3e} of its terms' magnitudes")
    check(dos_terms["fault"] > LG_DOS_TOL, f"{tag}: the dos gate does not see a planted fault: {dos_terms['fault']:.3e}")
    err = max((dx.double() - edx).abs().max().item(), abs(dos.double() - edos).item())
    return dict(n=n, m=n, t=t, chunks=chunks, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                rel_err=rel, plain_rel_err=prel, dos_over_terms=dos_terms)


def _interp_against_eigh(model, sx):
    """K_ZZ^{-1/2} K_Zx of the points ``sx`` on the model's state, by CIQ in float32 through
    the kernels, in float32 through the plain versions and in float64 (a float64 copy of the
    model, plain versions), each against float64 eigh of K_ZZ + jitter on the card: returns
    ({path: max |Δ| / max |exact|}, λ_min, λ_max of K_ZZ + jitter, CIQ iterations)."""
    import copy

    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.solvers import contour

    def interp(m):
        Z = m.variational_strategy.inducing_points.detach()
        op = m.covar_module(Z).evaluate_kernel().add_jitter(m.variational_strategy.jitter_val)
        with gt.settings.max_preconditioner_size(0):
            return gt.solvers.sqrt_inv_matmul(op, m.covar_module(Z, sx.to(Z.dtype)).to_dense())

    with torch.no_grad():
        Z = model.variational_strategy.inducing_points.detach()
        twin = copy.deepcopy(model).double()
        dense = twin.covar_module(Z.double()).to_dense()
        dense = dense + model.variational_strategy.jitter_val * torch.eye(Z.shape[0], dtype=dense.dtype, device=dense.device)
        lam, V = torch.linalg.eigh(dense)
        exact = V @ (lam.rsqrt().unsqueeze(-1) * (V.mT @ twin.covar_module(Z.double(), sx.double()).to_dense()))
        scale = exact.abs().max().item()
        out = {"kernel": interp(model)}
        iters = contour.last_iterations["forward"]
        with plain_kernels():
            out["plain float32"] = interp(model)
            out["plain float64"] = interp(twin)
    return {k: (a.double() - exact).abs().max().item() / scale for k, a in out.items()}, lam[0].item(), lam[-1].item(), iters


def phase_ciq():
    """Phase 16: CIQ-SVGP with natural gradients at N=100k (``build_svgp(strategy="ciq")``:
    CIQ_M inducing points from the training rows, NaturalVariationalDistribution, K_ZZ's
    jitter SVGP_JITTER).  First the parity gate: the ELBO of ``svgp_parity_terms``'s CIQ
    state (m = CIQ_PARITY_M, seed CIQ_SEED) on the card in float32 (kernels) and float64
    (plain versions) against the JAX package's float64 CIQ_ELBO_JAX within CIQ_ELBO_TOL.  Then CIQ_STEPS steps of NGD
    (lr SVGP_NGD_LR) and Adam (lr SVGP_ADAM_LR) on minibatches of CIQ_BATCH: each step's
    forward is 10 Lanczos products at t = 1 and one kernel_matvec at t = CIQ_BATCH a
    multi-shift CG iteration on the lazy symmetric K_ZZ (CIQ_M² > max_eager_kernel_size²),
    its backward one more multi-shift CG and one kernel_bwd_fused at t = 15·CIQ_BATCH (every
    shift's columns, dx and dos), and no kernel_grad_x and no forward product at that width:
    gated per step (matvec launches = 10 + forward + backward iterations, one backward, no
    grad_x), the iteration counts printed.  The path's shapes (4,096² at t = 1 and CIQ_BATCH,
    the backward at t = 15·CIQ_BATCH, on the first step's operands) against the plain
    versions and float64 (``_matvec_against_float64``, ``_bwd_against_float64``).  Every ELBO
    finite and a fixed minibatch's ELBO raised; on the trained state the interpolation term
    of 1,024 test points against float64 eigh, the kernel path gated at twice the plain
    float32 path's error; RMSE and NLPD of the N_TEST test points (ciq_step_ms, the
    prediction's time, peak memory).  Alone: ``python3 -c 'import chip_smoke;
    chip_smoke.phase_ciq()'``.  Returns the readings."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.solvers import contour

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    parity = dict(strategy="ciq", m=CIQ_PARITY_M, batch_size=CIQ_PARITY_BATCH, seed=CIQ_SEED)
    elbo = {torch.float32: svgp_parity_terms(dev, torch.float32, **parity)[0]}
    with plain_kernels():  # the kernels take float32 alone
        elbo[torch.float64] = svgp_parity_terms(dev, torch.float64, **parity)[0]
    gap = tuple(abs(e - CIQ_ELBO_JAX) / abs(CIQ_ELBO_JAX) for e in elbo.values())
    print(f"[ciq] parity: ELBO of the parity state on {CIQ_PARITY_BATCH} points, m={CIQ_PARITY_M}: float32 (kernels) "
          f"{elbo[torch.float32]:.9f}, float64 (plain versions) {elbo[torch.float64]:.12f} on the card; JAX package "
          f"float64 {CIQ_ELBO_JAX:.12f}; relative gaps {gap[0]:.3e} and {gap[1]:.3e} (tol {CIQ_ELBO_TOL}); "
          f"{nvidia_smi()}", flush=True)
    check(all(g <= tol for g, tol in zip(gap, CIQ_ELBO_TOL)), f"ciq: ELBO gaps {gap} above {CIQ_ELBO_TOL}")

    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model, likelihood = build_svgp(train_x, dev, torch.float32, jitter_val=SVGP_JITTER, m=CIQ_M, seed=CIQ_SEED,
                                   strategy="ciq")
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    ngd, adam = _ngd_and_adam(model, likelihood)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(CIQ_SEED), CIQ_STEPS, dev, CIQ_BATCH)
    fixed = slice(0, CIQ_BATCH)

    def fixed_elbo():
        with torch.no_grad():
            return mll(model(tx[fixed]), ty[fixed]).item()

    elbo0 = fixed_elbo()  # the first call also initialises q(u) from the prior, N(0, I)
    wrappers = _kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    elbos, times, iters, launches = [], [], [], []
    q = gt.settings.num_contour_quadrature.value()
    with recorded_calls("kernel_matvec_cuda", t=CIQ_BATCH) as mv, recorded_calls("kernel_matvec_cuda", t=1) as mv1, \
            recorded_calls("kernel_bwd_fused_cuda") as bwd:
        for idx in batches:
            for w in wrappers:
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ngd.zero_grad()
            adam.zero_grad()
            loss = -mll(model(tx[idx]), ty[idx])
            loss.backward()
            ngd.step()
            adam.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(tuple(w.launches for w in wrappers))
            iters.append((contour.last_iterations["forward"], contour.last_iterations["backward"]))
            elbos.append(-loss.item())
    peak = torch.cuda.max_memory_allocated()
    elbo1 = fixed_elbo()
    expected = [(10 + f + b, 1, 0, 0, 0) for f, b in iters]
    print(f"[ciq] {CIQ_STEPS} steps at m={CIQ_M} (NGD lr {SVGP_NGD_LR} + Adam lr {SVGP_ADAM_LR}, minibatch {CIQ_BATCH}, "
          f"{q} quadrature shifts): ciq_step_ms {_quartiles_ms(times[1:])} over steps 1-{CIQ_STEPS - 1}, first step "
          f"{times[0] * 1e3:.1f} ms; multi-shift CG iterations (forward, backward) per step {iters}; ELBO per step "
          f"{[round(e, 4) for e in elbos[:5]]} … {[round(e, 4) for e in elbos[-5:]]}; fixed minibatch ELBO {elbo0:.5f} "
          f"→ {elbo1:.5f}; peak device memory {peak / 2**20:.1f} MiB; {nvidia_smi()}", flush=True)
    print(f"[ciq] launches per step (matvec, bwd_fused, grad_x, periodic matvec, periodic bwd): first {launches[0]}, "
          f"last {launches[-1]}; predicted (10 Lanczos + forward + backward iterations, 1, 0, 0, 0); kernel_matvec "
          f"shapes of the first step {sorted(set(mv['shapes']) | set(mv1['shapes']))}, kernel_bwd_fused "
          f"{sorted(set(bwd['shapes']))}", flush=True)
    check(all(math.isfinite(e) for e in elbos), "ciq: a non-finite ELBO")
    check(elbo1 > elbo0, f"ciq: training took the fixed minibatch's ELBO from {elbo0} only to {elbo1}")
    check(launches == expected, f"ciq: launches per step {launches} differ from {expected}")
    check(set(bwd["shapes"]) == {(CIQ_M, CIQ_M, q * CIQ_BATCH)}, f"ciq: backward shapes {set(bwd['shapes'])}")

    shapes = {"matvec_t1": _matvec_against_float64(*mv1["first"][0][:3], "ciq", "a Lanczos step"),
              "matvec_batch": _matvec_against_float64(*mv["first"][0][:3], "ciq", "a multi-shift CG iteration")}
    check(all(shapes[k]["n"] == CIQ_M and rec["first"][0][0] is rec["first"][0][1]
              for k, rec in (("matvec_t1", mv1), ("matvec_batch", mv))), "ciq: the K_ZZ products are not symmetric")
    (bx, bg, bv, _), _ = bwd["first"]
    shapes["bwd"] = _bwd_against_float64(bx, bg, bv, "ciq", "the CIQ backward, every shift")

    model.eval()
    errs, lam_min, lam_max, interp_iters = _interp_against_eigh(model, sx[:1024])
    print(f"[ciq] trained state: K_ZZ^(-1/2) K_Zx of 1,024 test points against float64 eigh of K_ZZ + jitter "
          f"(λ from {lam_min:.3e} to {lam_max:.3e}), max |Δ| / max |exact|: "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" ({interp_iters} multi-shift CG iterations; gate: the kernel path within twice the plain float32 "
            f"path's)", flush=True)
    check(errs["kernel"] <= 2.0 * errs["plain float32"], f"ciq: the interpolation term's error {errs}")
    for w in wrappers:
        w.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = likelihood(model(sx))
        mean, var = pred.mean, pred.variance
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    serve_launches = tuple(w.launches for w in wrappers)
    rmse, nlpd, const_rmse = _predictive_quality(mean, var, sy, ty.mean())
    print(f"[ciq] {N_TEST} test points in {request_s * 1e3:.2f} ms (launches {serve_launches}): rmse {rmse:.4f} "
          f"(constant predictor {const_rmse:.4f}; phase 14's whitened SVGP at m={SVGP_M}: 0.1889), nlpd {nlpd:.4f}",
          flush=True)
    check(rmse < const_rmse, f"ciq: rmse {rmse} not below the constant predictor's {const_rmse}")
    check(serve_launches[0] > 0 and not any(serve_launches[1:]), f"ciq: prediction launches {serve_launches}")
    return dict(elbo=elbo, gap=gap, step_ms=float(np.median(times[1:])) * 1e3, iters=iters, rmse=rmse, nlpd=nlpd,
                peak=peak, request_ms=request_s * 1e3, interp_err=errs, shapes=shapes,
                launches=(sum(l[0] for l in launches), sum(l[1] for l in launches), sum(l[2] for l in launches)),
                serve_launches=serve_launches)


def make_classification_task(n_train: int, n_test: int, seed: int = 0):
    """make_task's inputs with labels 1 where its noiseless function lies above its median
    over the training inputs, 0 elsewhere: two balanced classes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_train + n_test, D))
    f = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * x[:, 2]
    labels = (f > np.median(f[:n_train])).astype(np.float64)
    return x[:n_train], labels[:n_train], x[n_train:], labels[n_train:]


def phase_classification():
    """Phase 16b: a whitened SVGP (m = SVGP_M, NaturalVariationalDistribution, K_ZZ's jitter
    SVGP_JITTER in both dtypes) with a
    BernoulliLikelihood (probit) on ``make_classification_task`` at N=100k, CLS_STEPS steps of
    NGD and Adam on minibatches of SVGP_BATCH.  Its ELBO takes E_q[log Φ((2y − 1) f)] by
    Gauss–Hermite quadrature.  Gates: every ELBO finite; on the trained state one minibatch's
    ELBO in float32 against a float64 copy on the card within CLS_ELBO_TOL; test accuracy of
    the N_TEST points above CLS_ACCURACY; no kernel launched (K_ZZ and K_Zx dense).  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_classification()'``."""
    import copy

    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_classification_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model, likelihood = build_svgp(train_x, dev, torch.float32, jitter_val=SVGP_JITTER,
                                   likelihood=gt.likelihoods.BernoulliLikelihood())
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    ngd, adam = _ngd_and_adam(model, likelihood)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(CIQ_SEED + 1), CLS_STEPS, dev)
    with torch.no_grad():
        model(tx[:4])  # initialises q(u)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    elbos, times = [], []
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ngd.zero_grad()
        adam.zero_grad()
        loss = -mll(model(tx[idx]), ty[idx])
        loss.backward()
        ngd.step()
        adam.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        elbos.append(-loss.item())
    train_launches = tuple(w.launches for w in wrappers)
    twin, twin_lik = copy.deepcopy(model).double(), copy.deepcopy(likelihood).double()
    idx = batches[0]
    with torch.no_grad():
        e32 = mll(model(tx[idx]), ty[idx]).item()
        e64 = gt.mlls.VariationalELBO(twin_lik, twin, num_data=N_TRAIN)(twin(tx[idx].double()), ty[idx].double()).item()
        model.eval()
        probs = likelihood(model(sx)).probs
    accuracy = ((probs > 0.5).to(sy.dtype) == sy).double().mean().item()
    gap = abs(e32 - e64) / abs(e64)
    print(f"[classification] {CLS_STEPS} steps (NGD lr {SVGP_NGD_LR} + Adam lr {SVGP_ADAM_LR}, minibatch {SVGP_BATCH}, "
          f"m={SVGP_M}, Bernoulli probit, {gt.settings.num_gauss_hermite_locs.value()} Gauss–Hermite nodes): "
          f"cls_step_ms {_quartiles_ms(times[1:])}; ELBO {[round(e, 4) for e in elbos[:3]]} … "
          f"{[round(e, 4) for e in elbos[-3:]]}; trained ELBO float32 {e32:.7f}, float64 {e64:.10f}, relative gap "
          f"{gap:.3e} (tol {CLS_ELBO_TOL}); test accuracy {accuracy:.4f} (gate > {CLS_ACCURACY}); launches "
          f"{train_launches}; {nvidia_smi()}", flush=True)
    check(all(math.isfinite(e) for e in elbos), "classification: a non-finite ELBO")
    check(gap <= CLS_ELBO_TOL, f"classification: ELBO float32 against float64 {gap:.3e}")
    check(accuracy > CLS_ACCURACY, f"classification: accuracy {accuracy}")
    check(not any(train_launches), f"classification: kernels launched {train_launches}")
    return dict(step_ms=float(np.median(times[1:])) * 1e3, accuracy=accuracy, gap=gap)


def ovc_state(train_x, train_y):
    """Phase 16c's state, in float64 with numpy: phase 14's parity state (its hyperparameters
    and inducing points) with q(u) at the collapsed optimum of the whitened ELBO given
    OVC_FIT_N training points (Titsias 2009): with A = L⁻¹ K_Zx (L = chol(K_ZZ + jitter)),
    S = (I + A Aᵀ/σ²)⁻¹ and m = S A (y − μ)/σ², a state as training would leave it.  Its
    pseudo-noise D̃ is large where the data do not inform q(u), which bounds the conditioning of
    K_ZZ + D̃ (the parity state's own random q(u) makes D̃ indefinite, and any S small in K_ZZ's
    near-null directions makes K_ZZ + D̃ singular in float64)."""
    params, lik_params, _, _ = svgp_parity_state(train_x, train_y)
    softplus = lambda a: np.log1p(np.exp(np.asarray(a, dtype=np.float64)))  # noqa: E731
    ls = softplus(params["covar_module.base_kernel.raw_lengthscale"]).reshape(-1)
    outputscale = softplus(params["covar_module.raw_outputscale"])
    noise = NOISE_FLOOR + softplus(lik_params["noise_covar.raw_noise"]).item()
    Z = params["variational_strategy.inducing_points"] / ls
    rows = np.random.default_rng([SVGP_SEED, 3]).choice(len(train_x), OVC_FIT_N, replace=False)
    X = train_x[rows] / ls

    def kernel(a, b):
        d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * a @ b.T
        return outputscale * np.exp(-0.5 * np.maximum(d2, 0.0))

    L = np.linalg.cholesky(kernel(Z, Z) + SVGP_JITTER * np.eye(len(Z)))
    A = np.linalg.solve(L, kernel(Z, X))
    L_P = np.linalg.cholesky(np.eye(len(Z)) + A @ A.T / noise)
    L_P_inv = np.linalg.solve(L_P, np.eye(len(Z)))
    S = L_P_inv.T @ L_P_inv
    name = "variational_strategy._variational_distribution."
    params[name + "variational_mean"] = S @ (A @ (train_y[rows] - params["mean_module.raw_constant"])) / noise
    params[name + "chol_variational_covar"] = np.linalg.cholesky(0.5 * (S + S.T))
    return params, lik_params


def _ovc_model(train_x, train_y, device, dtype):
    import gpytorch_tpu_torch as gt

    params, lik_params = ovc_state(train_x, train_y)
    model, likelihood = build_svgp(train_x, device, dtype, dist="cholesky", jitter_val=SVGP_JITTER)
    gt.load_jax_params(model, params | {"variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(likelihood, lik_params)
    model.likelihood = likelihood  # amortized_exact_gp's likelihood
    return model.eval()


def _ovc_dense_reference(model64, xf, yf, xs):
    """The fantasy's mean and variances at ``xs`` from dense float64 solves of the same
    conditioning on the card: the mean from the block system [[K_ZZ + D̃, K_Zf],
    [K_fZ, K_ff + σ²I]] on [ỹ; y_f] − μ, the variances from K + σ²I on all the points (as both
    packages take them), each with psd_safe_cholesky's 1e-8."""
    import torch

    with torch.no_grad():
        cov, mean = model64.variational_strategy.pseudo_points(model64)
        Z = model64.variational_strategy.inducing_points
        X = torch.cat([Z, xf])
        K = model64.covar_module(X).to_dense()
        mu = model64.mean_module(X)
        noise = model64.likelihood.noise.item()
        m, n = Z.shape[0], X.shape[0]
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        A = K + 1e-8 * eye
        A[:m, :m] += cov
        A[m:, m:] += noise * torch.eye(n - m, dtype=K.dtype, device=K.device)
        targets = torch.cat([mean[:, 0] + model64.mean_module(Z), yf])
        K_sx = model64.covar_module(xs, X).to_dense()
        pred_mean = model64.mean_module(xs) + K_sx @ torch.linalg.solve(A, targets - mu)
        pred_var = model64.covar_module(xs, diag=True) - (K_sx * torch.linalg.solve(K + (noise + 1e-8) * eye,
                                                                                    K_sx.mT).mT).sum(-1)
    return pred_mean, pred_var


def phase_ovc():
    """Phase 16c: online variational conditioning of a whitened SVGP (m = SVGP_M, Cholesky
    q(u); ``ovc_state``): its pseudo-points (Σ ỹ, tr D̃, ‖D̃‖_F) in float64 on the card against
    the JAX package's float64 values OVC_PSEUDO_JAX within OVC_PSEUDO_TOL (the float32 ones
    read), then ``get_fantasy_model`` with OVC_Q new points (the first test points and their
    targets): an exact GP over the m pseudo-points and the new points.  Its system K_ZZ + D̃
    keeps K_ZZ's conditioning (its smallest eigenvalue is the jitter: κ ≈ 7e6), where CG stops
    far short of the mean within max_cg_iterations (16 % off in float64 on the CPU, at any
    tolerance), so the update and the request run under max_cholesky_size(m + OVC_Q): dense
    Cholesky factors, promoted to float64.  The request's mean reads the test points' strip
    of the kernel operator on the m + OVC_Q points (N_TEST × 1,040 > max_eager_kernel_size²):
    one launch of kernel_matvec at t = 1 (gated), held against the plain versions and
    float64.  The mean and variances at the N_TEST test points against a dense float64
    computation of the same conditioning (``_ovc_dense_reference``), gated at OVC_MEAN_TOL
    and OVC_VAR_TOL (max |Δ| / max |·|); ovc_fantasy_ms (the update) and the request's time.
    Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_ovc()'``."""
    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    model = _ovc_model(train_x, train_y, dev, torch.float32)
    model64 = _ovc_model(train_x, train_y, dev, torch.float64)
    readings = {}
    for tag, m in (("float32", model), ("float64", model64)):
        with torch.no_grad():
            cov, mean = m.variational_strategy.pseudo_points(m)
        readings[tag] = (mean.sum().item(), torch.trace(cov).item(), cov.norm().item())
    gaps = {tag: max(abs(a - b) / abs(b) for a, b in zip(r, OVC_PSEUDO_JAX)) for tag, r in readings.items()}
    print(f"[ovc] pseudo-points (Σ ỹ, tr D̃, ‖D̃‖_F) at m={SVGP_M}: float64 {readings['float64']}, float32 "
          f"{readings['float32']} on the card; JAX package float64 {OVC_PSEUDO_JAX}; largest relative gaps float64 "
          f"{gaps['float64']:.3e} (tol {OVC_PSEUDO_TOL}), float32 {gaps['float32']:.3e} (read)", flush=True)
    check(gaps["float64"] <= OVC_PSEUDO_TOL, f"ovc: pseudo-points {readings['float64']} against {OVC_PSEUDO_JAX}")
    xf, yf, xs = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (test_x[:OVC_Q], test_y[:OVC_Q], test_x))
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    with torch.no_grad(), gt.settings.max_cholesky_size(SVGP_M + OVC_Q), recorded_calls("kernel_matvec_cuda") as mv:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fantasy = model.get_fantasy_model(xf, yf)
        torch.cuda.synchronize()
        fantasy_s = time.perf_counter() - t0
        update_launches = tuple(w.launches for w in wrappers)
        t0 = time.perf_counter()
        pred = fantasy(xs)
        mean, var = pred.mean, pred.variance
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    launches = tuple(w.launches for w in wrappers)
    ref_mean, ref_var = _ovc_dense_reference(model64, xf.double(), yf.double(), xs.double())
    gap_mean = (mean.double() - ref_mean).abs().max().item() / ref_mean.abs().max().item()
    gap_var = (var.double() - ref_var).abs().max().item() / ref_var.abs().max().item()
    print(f"[ovc] get_fantasy_model with {OVC_Q} points on {SVGP_M} pseudo-points (dense Cholesky): "
          f"ovc_fantasy_ms {fantasy_s * 1e3:.2f} (launches {update_launches}), {N_TEST} test points in "
          f"{request_s * 1e3:.2f} ms; launches in all {launches}; against dense float64: mean {gap_mean:.3e} (tol "
          f"{OVC_MEAN_TOL}), variance {gap_var:.3e} (tol {OVC_VAR_TOL}); {nvidia_smi()}", flush=True)
    check(gap_mean <= OVC_MEAN_TOL and gap_var <= OVC_VAR_TOL, f"ovc: fantasy gaps {gap_mean:.3e}, {gap_var:.3e}")
    check(launches == (1, 0, 0, 0, 0) and not any(update_launches), f"ovc: launches {update_launches}, {launches}")
    check(mv["shapes"] == [(N_TEST, SVGP_M + OVC_Q, 1)], f"ovc: kernel_matvec shapes {mv['shapes']}")
    shape = _matvec_against_float64(*mv["first"][0][:3], "ovc", "the request's mean, the test rows' strip")
    return dict(fantasy_ms=fantasy_s * 1e3, request_ms=request_s * 1e3, launches=launches[0], gaps=(gap_mean, gap_var),
                pseudo_gap=gaps, shape=shape)


def build_dspp(train_x, device, dtype):
    """Phase 16d's model: a two-layer DSPP with DSPP_H hidden GPs (ConstantMean,
    ScaleKernel(RBF-ARD), a whitened Cholesky q(u) of DSPP_M inducing points each, drawn
    from the training inputs) and an output GP on them, DSPP_Q quadrature sites a layer, and a
    GaussianLikelihood with noise ≥ NOISE_FLOOR; in train mode on ``device``."""
    import torch

    import gpytorch_tpu_torch as gt

    rng = np.random.default_rng(DSPP_SEED)

    class Layer(gt.models.deep_gps.DSPPLayer):
        def __init__(self, input_dims, output_dims):
            batch = () if output_dims is None else (output_dims,)
            if output_dims is None:
                Z = torch.as_tensor(rng.normal(size=(DSPP_M, input_dims)))
            else:
                Z = torch.as_tensor(train_x[rng.choice(len(train_x), (output_dims, DSPP_M), replace=True)])
            vd = gt.variational.CholeskyVariationalDistribution(DSPP_M, batch_shape=batch)
            super().__init__(gt.variational.VariationalStrategy(self, Z, vd), input_dims, output_dims,
                             num_quad_sites=DSPP_Q)
            self.mean_module = gt.means.ConstantMean(batch_shape=batch)
            self.covar_module = gt.kernels.ScaleKernel(
                gt.kernels.RBFKernel(ard_num_dims=input_dims, batch_shape=batch), batch_shape=batch)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    class TwoLayerDSPP(gt.models.deep_gps.DSPP):
        def __init__(self):
            super().__init__(num_quad_sites=DSPP_Q)
            self.hidden_layer = Layer(D, DSPP_H)
            self.last_layer = Layer(DSPP_H, None)
            self.likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))

        def forward(self, x):
            return self.last_layer(self.hidden_layer(x))

    return TwoLayerDSPP().to(device=device, dtype=dtype).train()


def phase_dspp():
    """Phase 16d: a two-layer DSPP (``build_dspp``) at N=100k, DSPP_STEPS Adam steps (lr
    DSPP_LR) of ``DeepPredictiveLogLikelihood`` on minibatches of SVGP_BATCH.  Gates: finite
    losses; the loss of one minibatch on the initial state in float32 against a float64 copy
    on the card within DSPP_LOSS_TOL; a fixed minibatch's loss lowered; no kernel launched
    (K_ZZ at DSPP_M² is dense).  Prints dspp_step_ms, the RMSE of the quadrature-weighted
    mean of the N_TEST test points beside the constant predictor's.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_dspp()'``."""
    import copy

    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model = build_dspp(train_x, dev, torch.float32)
    mll = gt.mlls.DeepPredictiveLogLikelihood(model.likelihood, model, num_data=N_TRAIN)
    fixed = slice(0, SVGP_BATCH)

    def fixed_loss(m=model, objective=mll, dtype=torch.float32):
        with torch.no_grad():
            return -objective(m(tx[fixed].to(dtype)), ty[fixed].to(dtype)).item()

    loss0 = fixed_loss()  # initialises every layer's q(u)
    twin = copy.deepcopy(model).double()
    loss64 = fixed_loss(twin, gt.mlls.DeepPredictiveLogLikelihood(twin.likelihood, twin, num_data=N_TRAIN),
                        torch.float64)
    gap = abs(loss0 - loss64) / abs(loss64)
    optimizer = torch.optim.Adam(model.parameters(), lr=DSPP_LR)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(DSPP_SEED), DSPP_STEPS, dev)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss = -mll(model(tx[idx]), ty[idx])
        loss.backward()
        optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = tuple(w.launches for w in wrappers)
    peak = torch.cuda.max_memory_allocated()
    loss1 = fixed_loss()
    model.eval()
    with torch.no_grad():
        out = model.likelihood(model(sx))
        weights = model.quad_weights.exp().unsqueeze(-1)
        mean = (weights * out.mean).sum(0)
    rmse = (mean - sy).pow(2).mean().sqrt().item()
    const_rmse = (sy - ty.mean()).pow(2).mean().sqrt().item()
    print(f"[dspp] {DSPP_STEPS} Adam steps (lr {DSPP_LR}, minibatch {SVGP_BATCH}; {DSPP_H} hidden GPs, m={DSPP_M} a "
          f"layer, {DSPP_Q} sites): dspp_step_ms {_quartiles_ms(times[1:])}; initial loss float32 {loss0:.7f}, "
          f"float64 {loss64:.10f}, relative gap {gap:.3e} (tol {DSPP_LOSS_TOL}); fixed minibatch loss {loss0:.5f} → "
          f"{loss1:.5f}; rmse {rmse:.4f} (constant predictor {const_rmse:.4f}); quadrature weights "
          f"{[round(w, 4) for w in weights.squeeze(-1).tolist()]}; peak device memory {peak / 2**20:.1f} MiB; launches "
          f"{launches}; {nvidia_smi()}", flush=True)
    check(all(math.isfinite(v) for v in losses), "dspp: a non-finite loss")
    check(gap <= DSPP_LOSS_TOL, f"dspp: loss float32 against float64 {gap:.3e}")
    check(loss1 < loss0, f"dspp: training took the fixed minibatch's loss from {loss0} only to {loss1}")
    check(not any(launches), f"dspp: kernels launched {launches}")
    return dict(step_ms=float(np.median(times[1:])) * 1e3, rmse=rmse, gap=gap)


def phase_vnngp():
    """Phase 16e: VNNGP at ``examples/12_vnngp_large_scale.py``'s configuration on make_task's
    data: every training point an inducing point (M = N_TRAIN), k = VNN_K, ScaleKernel(
    Matérn-5/2 ARD), the IVF index (``preferred_nnlib="ivf"``, its k-means seeded by a
    torch.Generator), jitter 1e-4, VNN_STEPS Adam steps (lr VNN_LR) on minibatches of
    SVGP_BATCH with the stochastic KL over VNN_KL_BATCH inducing points (``indices`` and
    ``kl_indices`` passed explicitly).  Gates: the IVF index's recall of the VNN_K nearest of
    1,024 test points against the exact search ≥ VNN_RECALL (the JAX package's test's
    threshold); finite losses; no kernel launched.  Prints the index build time,
    vnngp_step_ms and the RMSE beside the constant predictor's (read: a step moves q(u) at
    its minibatch's points alone, so VNN_STEPS steps of SVGP_BATCH touch each of the N_TRAIN
    points about once).  Alone: ``python3 -c 'import
    chip_smoke; chip_smoke.phase_vnngp()'``."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch.utils.nearest_neighbors import NNUtil

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))

    class VNNGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = gt.variational.MeanFieldVariationalDistribution(N_TRAIN)
            super().__init__(gt.variational.NNVariationalStrategy(
                self, tx, vd, k=VNN_K, training_batch_size=SVGP_BATCH, jitter_val=1e-4, preferred_nnlib="ivf",
                generator=torch.Generator().manual_seed(VNN_SEED)))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.MaternKernel(nu=2.5, ard_num_dims=D))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = VNNGP()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = model.to(dev)
    likelihood = gt.likelihoods.GaussianLikelihood().to(dev)
    exact = NNUtil(VNN_K, D)
    exact.set_nn_idx(tx)
    queries = sx[:1024]
    want, got = exact.find_nn_idx(queries).cpu().numpy(), model.variational_strategy.nn_util.find_nn_idx(queries)
    recall = float(np.mean([len(set(a) & set(b)) / VNN_K for a, b in zip(want.tolist(), got.cpu().numpy().tolist())]))
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    optimizer = torch.optim.Adam(list(model.parameters()) + list(likelihood.parameters()), lr=VNN_LR)
    gen = torch.Generator(device=dev).manual_seed(VNN_SEED)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    with torch.no_grad():
        model(tx[:4])  # initialises q(u)
    losses, times = [], []
    for _ in range(VNN_STEPS):
        idx = torch.randperm(N_TRAIN, generator=gen, device=dev)[:SVGP_BATCH]
        kl_idx = torch.randperm(N_TRAIN - VNN_K, generator=gen, device=dev)[:VNN_KL_BATCH] + VNN_K
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss = -mll(model(tx[idx], indices=idx), ty[idx], kl_indices=kl_idx)
        loss.backward()
        optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    model.eval()
    with torch.no_grad():
        pred = likelihood(model(sx))
    launches = tuple(w.launches for w in wrappers)
    rmse = (pred.mean - sy).pow(2).mean().sqrt().item()
    const_rmse = (sy - ty.mean()).pow(2).mean().sqrt().item()
    print(f"[vnngp] M={N_TRAIN}, k={VNN_K}, Matérn-5/2 ARD, IVF index built with the sequential structure in "
          f"{build_s:.2f} s; recall of the {VNN_K} nearest of 1,024 test points against the exact search {recall:.4f} "
          f"(gate ≥ {VNN_RECALL}); {VNN_STEPS} Adam steps (lr {VNN_LR}, minibatch {SVGP_BATCH}, KL batch "
          f"{VNN_KL_BATCH}): vnngp_step_ms {_quartiles_ms(times[1:])}; loss {[round(v, 4) for v in losses[:3]]} … "
          f"{[round(v, 4) for v in losses[-3:]]}; rmse {rmse:.4f} (constant predictor {const_rmse:.4f}); launches "
          f"{launches}; {nvidia_smi()}", flush=True)
    check(recall >= VNN_RECALL, f"vnngp: IVF recall {recall}")
    check(all(math.isfinite(v) for v in losses), "vnngp: a non-finite loss")
    check(not any(launches), f"vnngp: kernels launched {launches}")
    return dict(step_ms=float(np.median(times[1:])) * 1e3, build_s=build_s, recall=recall, rmse=rmse)


def make_lmc_task(n_train: int, n_test: int, seed: int = LMC_SEED):
    """Phase 17's multitask task, drawn with numpy: x uniform on the unit cube (d = D), LMC_LATENTS
    latent functions of make_task's kind with seeded frequencies, each standardised, mixed into
    LMC_TASKS tasks by a seeded LMC_LATENTS × LMC_TASKS matrix, plus Gaussian noise of 0.1."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(2.0, 7.0, size=(LMC_LATENTS, 3))
    mixing = rng.normal(size=(LMC_LATENTS, LMC_TASKS))
    x = rng.uniform(size=(n_train + n_test, D))  # the training rows do not depend on n_test
    f = np.stack([np.sin(a[k, 0] * x[:, 0]) * np.cos(a[k, 1] * x[:, 1]) + 0.5 * np.sin(a[k, 2] * x[:, 2] * x[:, 0])
                  for k in range(LMC_LATENTS)], -1)
    f = (f - f[:n_train].mean(0)) / f[:n_train].std(0)
    y = f @ mixing + 0.1 * np.random.default_rng([seed, 1]).normal(size=(n_train + n_test, LMC_TASKS))
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def build_lmc(train_x, device, dtype, m=LMC_M, seed=LMC_SEED):
    """Phase 17's model: LMCVariationalStrategy(LMC_TASKS tasks, LMC_LATENTS latents) over a
    whitened VariationalStrategy with batch shape (LMC_LATENTS,) (m inducing points a latent,
    each a seeded subset of the training inputs; a Cholesky q(u); K_ZZ's jitter SVGP_JITTER in
    every dtype), ConstantMean and ScaleKernel(RBFKernel(ard_num_dims=D)) with the latents'
    batch shape, and a MultitaskGaussianLikelihood (a noise a task and the global noise);
    (model, likelihood) on ``device`` in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    rng = np.random.default_rng(seed)
    Z = torch.as_tensor(np.stack([train_x[rng.choice(len(train_x), m, replace=False)] for _ in range(LMC_LATENTS)]))
    batch = (LMC_LATENTS,)

    class LMCSVGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = gt.variational.CholeskyVariationalDistribution(m, batch_shape=batch)
            base = gt.variational.VariationalStrategy(self, Z, vd, jitter_val=SVGP_JITTER)
            super().__init__(gt.variational.LMCVariationalStrategy(base, num_tasks=LMC_TASKS, num_latents=LMC_LATENTS,
                                                                   latent_dim=-1))
            self.mean_module = gt.means.ConstantMean(batch_shape=batch)
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D, batch_shape=batch),
                                                       batch_shape=batch)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    likelihood = gt.likelihoods.MultitaskGaussianLikelihood(num_tasks=LMC_TASKS)
    return LMCSVGP().to(device=device, dtype=dtype).train(), likelihood.to(device=device, dtype=dtype).train()


def lmc_parity_state(train_x, train_y, m=LMC_PARITY_M, batch_size=LMC_PARITY_BATCH, seed=LMC_SEED):
    """The state of phase 17's parity gate, drawn with numpy from ``seed`` under the JAX
    package's names: the LMC coefficients, m inducing points a latent from the training inputs,
    q(u) = N(m, L Lᵀ) a latent as ``svgp_parity_state`` draws it, the hyperparameters of each
    latent and the likelihood's noises; and one minibatch of ``batch_size`` training points."""
    rng = np.random.default_rng(seed)
    z_idx = np.stack([rng.choice(len(train_x), m, replace=False) for _ in range(LMC_LATENTS)])
    batch = np.random.default_rng([seed, 1]).choice(len(train_x), batch_size, replace=False)
    rng = np.random.default_rng([seed, 2])
    L = (np.tril(0.05 * rng.normal(size=(LMC_LATENTS, m, m)), -1)
         + np.eye(m) * rng.uniform(0.05, 0.3, size=(LMC_LATENTS, m, 1)))
    base = "variational_strategy.base_variational_strategy."
    params = {"variational_strategy.lmc_coefficients": rng.normal(size=(LMC_LATENTS, LMC_TASKS)),
              base + "inducing_points": train_x[z_idx],
              base + "_variational_distribution.variational_mean": 0.5 * rng.normal(size=(LMC_LATENTS, m)),
              base + "_variational_distribution.chol_variational_covar": L,
              "mean_module.raw_constant": 0.1 * rng.normal(size=LMC_LATENTS),
              "covar_module.raw_outputscale": rng.uniform(-0.5, 0.5, size=LMC_LATENTS),
              "covar_module.base_kernel.raw_lengthscale": rng.uniform(-1.5, 0.0, size=(LMC_LATENTS, 1, D))}
    lik_params = {"raw_task_noises": rng.uniform(-3.5, -2.5, size=LMC_TASKS), "raw_noise": np.asarray([-4.0])}
    return params, lik_params, train_x[batch], train_y[batch]


def lmc_parity_terms(device, dtype) -> tuple:
    """(ELBO, KL term) (num_data = N_TRAIN) of ``lmc_parity_state`` on its minibatch."""
    import torch

    import gpytorch_tpu_torch as gt

    train_x, train_y, _, _ = make_lmc_task(N_TRAIN, N_TEST)
    params, lik_params, xb, yb = lmc_parity_state(train_x, train_y)
    model, likelihood = build_lmc(train_x, device, dtype, m=LMC_PARITY_M)
    gt.load_jax_params(model, params | {"variational_strategy.base_variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(likelihood, lik_params)
    xb, yb = (torch.as_tensor(a, dtype=dtype, device=device) for a in (xb, yb))
    with torch.no_grad():
        log_lik, kl, log_prior = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN, combine_terms=False)(
            model(xb), yb)
    return (log_lik - kl + log_prior).item(), kl.item()


def _train_svgp_steps(model, likelihood, optimizer, mll, tx, ty, batches, tag, wrappers=None):
    """Adam steps of −ELBO on ``batches``: (ELBOs, seconds a step, the five launch counts of
    each step's forward and backward) from ``wrappers`` (``_kernel_wrappers()`` by default;
    taken before ``recorded_calls`` wraps them)."""
    import torch

    elbos, times, launches = [], [], []
    wrappers = _kernel_wrappers() if wrappers is None else wrappers
    for idx in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad()
        for w in wrappers:
            w.launches = 0
        loss = -mll(model(tx[idx]), ty[idx])
        forward = tuple(w.launches for w in wrappers)
        for w in wrappers:
            w.launches = 0
        loss.backward()
        backward = tuple(w.launches for w in wrappers)
        optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        elbos.append(-loss.item())
        launches.append((forward, backward))
        check(finite_step(loss, model) and finite_step(loss, likelihood),
              f"{tag}: non-finite ELBO or gradient at step {len(times) - 1}")
    return elbos, times, launches


def phase_lmc():
    """Phase 17: an LMC multitask SVGP at N=100k (``build_lmc``: LMC_TASKS tasks from
    LMC_LATENTS latent GPs, LMC_M inducing points a latent) on ``make_lmc_task``.  First the
    parity gate: the ELBO and the KL term of ``lmc_parity_state`` (m = LMC_PARITY_M) on the card
    in float32 and float64 against the JAX package's float64 values LMC_ELBO_JAX and LMC_KL_JAX
    (``tests/lmc_elbo_reference.py``), within LMC_ELBO_TOL and LMC_KL_TOL.  Then LMC_STEPS Adam
    steps (lr LMC_LR) on minibatches of SVGP_BATCH: every ELBO finite and the ELBO of a fixed
    minibatch raised; no hand-written kernel launched (K_ZZ and K_Zx dense, K_xx read through
    the dense latent covariances).  Prints lmc_step_ms, the per-task RMSE and NLPD of the
    N_TEST test points and the peak device memory.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_lmc()'``.  Returns the readings."""
    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    dtypes = (torch.float32, torch.float64)
    terms = {dt: lmc_parity_terms(dev, dt) for dt in dtypes}
    gap = tuple(abs(terms[dt][0] - LMC_ELBO_JAX) / abs(LMC_ELBO_JAX) for dt in dtypes)
    kl_gap = tuple(abs(terms[dt][1] - LMC_KL_JAX) / LMC_KL_JAX for dt in dtypes)
    print(f"[lmc] parity: ELBO of the parity state on {LMC_PARITY_BATCH} points, m={LMC_PARITY_M} a latent: float32 "
          f"{terms[torch.float32][0]:.9f}, float64 {terms[torch.float64][0]:.12f} on the card; JAX package float64 "
          f"{LMC_ELBO_JAX:.12f}; relative gaps {gap[0]:.3e} and {gap[1]:.3e} (tol {LMC_ELBO_TOL}); KL term float32 "
          f"{terms[torch.float32][1]:.9f}, float64 {terms[torch.float64][1]:.12f}, JAX package {LMC_KL_JAX:.12f}, "
          f"relative gaps {kl_gap[0]:.3e} and {kl_gap[1]:.3e} (tol {LMC_KL_TOL}); {nvidia_smi()}", flush=True)
    check(all(g <= tol for g, tol in zip(gap, LMC_ELBO_TOL)), f"lmc: ELBO gaps {gap} above {LMC_ELBO_TOL}")
    check(all(g <= tol for g, tol in zip(kl_gap, LMC_KL_TOL)), f"lmc: KL gaps {kl_gap} above {LMC_KL_TOL}")

    train_x, train_y, test_x, test_y = make_lmc_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model, likelihood = build_lmc(train_x, dev, torch.float32)
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    optimizer = torch.optim.Adam(list(model.parameters()) + list(likelihood.parameters()), lr=LMC_LR)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(LMC_SEED), LMC_STEPS, dev)
    fixed = slice(0, SVGP_BATCH)

    def fixed_elbo():
        with torch.no_grad():
            return mll(model(tx[fixed]), ty[fixed]).item()

    elbo0 = fixed_elbo()  # the first call also initialises q(u) from the prior, N(0, I)
    torch.cuda.reset_peak_memory_stats()
    elbos, times, launches = _train_svgp_steps(model, likelihood, optimizer, mll, tx, ty, batches, "lmc")
    peak = torch.cuda.max_memory_allocated()
    elbo1 = fixed_elbo()
    model.eval()
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = likelihood(model(sx))
        mean, var = pred.mean, pred.variance
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    serve_launches = tuple(w.launches for w in wrappers)
    rmse = (mean - sy).pow(2).mean(0).sqrt().tolist()
    nlpd = (0.5 * (torch.log(2 * math.pi * var) + (mean - sy) ** 2 / var)).mean(0).tolist()
    const_rmse = (sy - ty.mean(0)).pow(2).mean(0).sqrt().tolist()
    train_launches = tuple(sum(f[i] + b[i] for f, b in launches) for i in range(5))
    print(f"[lmc] {LMC_STEPS} Adam steps (lr {LMC_LR}, minibatch {SVGP_BATCH}; {LMC_TASKS} tasks from {LMC_LATENTS} "
          f"latents, m={LMC_M} a latent): lmc_step_ms {_quartiles_ms(times[1:])} over steps 1-{LMC_STEPS - 1}, first "
          f"step {times[0] * 1e3:.1f} ms; ELBO per step {[round(e, 4) for e in elbos[:5]]} … "
          f"{[round(e, 4) for e in elbos[-5:]]}; fixed minibatch ELBO {elbo0:.5f} → {elbo1:.5f}; peak device memory "
          f"{peak / 2**20:.1f} MiB; {nvidia_smi()}", flush=True)
    print(f"[lmc] {N_TEST} test points in {request_s * 1e3:.2f} ms: rmse per task {[round(r, 4) for r in rmse]} "
          f"(constant predictor {[round(r, 4) for r in const_rmse]}), nlpd per task {[round(v, 4) for v in nlpd]}; "
          f"LMC coefficients {model.variational_strategy.lmc_coefficients.detach().cpu().numpy().round(3).tolist()}; "
          f"hand-written kernel launches (matvec, bwd_fused, grad_x, periodic matvec, periodic bwd): training "
          f"{train_launches}, prediction {serve_launches} (predicted none)", flush=True)
    check(all(math.isfinite(e) for e in elbos), "lmc: a non-finite ELBO")
    check(elbo1 > elbo0, f"lmc: training took the fixed minibatch's ELBO from {elbo0} only to {elbo1}")
    check(not any(train_launches) and not any(serve_launches), f"lmc: kernels launched {train_launches}, "
                                                                f"{serve_launches}")
    return dict(gap=gap, kl_gap=kl_gap, step_ms=float(np.median(times[1:])) * 1e3, rmse=rmse, nlpd=nlpd, peak=peak,
                launches=sum(train_launches) + sum(serve_launches))


def build_grid_svgp(device, dtype, additive: bool):
    """Phase 17b's models: with ``additive``, AdditiveGridInterpolationVariationalStrategy on a
    1-D grid of GRID_M points over (0, 1) for the D inputs (q(u) a Cholesky factor a dimension)
    with ScaleKernel(RBFKernel()); else GridInterpolationVariationalStrategy on a GRID_2D ×
    GRID_2D grid over the unit square (the first two inputs) with
    ScaleKernel(RBFKernel(ard_num_dims=2)); ConstantMean and a GaussianLikelihood with noise ≥
    NOISE_FLOOR; (model, likelihood) on ``device`` in train mode."""
    import gpytorch_tpu_torch as gt

    class GridSVGP(gt.models.ApproximateGP):
        def __init__(self):
            if additive:
                vd = gt.variational.CholeskyVariationalDistribution(GRID_M, batch_shape=(D,))
                strategy = gt.variational.AdditiveGridInterpolationVariationalStrategy(self, GRID_M, [(0.0, 1.0)], D, vd)
                kernel = gt.kernels.RBFKernel()
            else:
                vd = gt.variational.CholeskyVariationalDistribution(GRID_2D ** 2)
                strategy = gt.variational.GridInterpolationVariationalStrategy(self, GRID_2D, [(0.0, 1.0)] * 2, vd)
                kernel = gt.kernels.RBFKernel(ard_num_dims=2)
            super().__init__(strategy)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(kernel)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    return GridSVGP().to(device=device, dtype=dtype).train(), likelihood.to(device=device, dtype=dtype).train()


def _grid_svgp_run(additive: bool) -> dict:
    """One model of phase 17b: GRID_STEPS Adam steps with the launches of each step's forward
    and backward and the operands of the first kernel_matvec and kernel_bwd_fused launch
    (``recorded_calls``), then the mBCG KL beside the dense float32 and float64 KL of the last
    state, the fixed minibatch's ELBO and the RMSE of the test points."""
    import copy

    import torch

    import gpytorch_tpu_torch as gt

    tag = "grid svgp additive" if additive else "grid svgp 2d"
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    cols = slice(None) if additive else slice(0, 2)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (train_x[:, cols], train_y, test_x[:, cols], test_y))
    model, likelihood = build_grid_svgp(dev, torch.float32, additive)
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    optimizer = torch.optim.Adam(list(model.parameters()) + list(likelihood.parameters()), lr=SVGP_ADAM_LR)
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(GRID_SEED), GRID_STEPS, dev)
    fixed = slice(0, SVGP_BATCH)

    def fixed_elbo():
        with torch.no_grad():
            return mll(model(tx[fixed]), ty[fixed]).item()

    elbo0 = fixed_elbo()  # the first call initialises q(u) from the prior
    torch.manual_seed(GRID_SEED)  # the KL's probes come from torch's default generator
    wrappers = _kernel_wrappers()
    with recorded_calls("kernel_matvec_cuda") as seen, recorded_calls("kernel_bwd_fused_cuda") as seen_bwd:
        elbos, times, launches = _train_svgp_steps(model, likelihood, optimizer, mll, tx, ty, batches, tag, wrappers)
    elbo1 = fixed_elbo()
    fwd, bwd = [f[0] for f, _ in launches], [b[1] for _, b in launches]
    others = [f[2:] + b[2:] + (f[1], b[0]) for f, b in launches]
    print(f"[{tag}] {GRID_STEPS} Adam steps (lr {SVGP_ADAM_LR}, minibatch {SVGP_BATCH}): grid_svgp_step_ms "
          f"{_quartiles_ms(times[1:])} over steps 1-{GRID_STEPS - 1}, first step {times[0] * 1e3:.1f} ms; the KL's "
          f"kernel_matvec launches a step (one a CG iteration) {fwd}, kernel_bwd_fused a step {bwd}; K·V shapes "
          f"{sorted(set(seen['shapes']))}, backward shapes {sorted(set(seen_bwd['shapes']))}; fixed minibatch ELBO "
          f"{elbo0:.5f} → {elbo1:.5f}; {nvidia_smi()}", flush=True)
    check(all(math.isfinite(e) for e in elbos), f"{tag}: a non-finite ELBO")
    check(all(n > 0 for n in fwd), f"{tag}: a step's KL launched no kernel_matvec: {fwd}")
    check(all(n > 0 for n in bwd), f"{tag}: a step's KL backward launched no kernel_bwd_fused: {bwd}")
    check(not any(any(o) for o in others), f"{tag}: other kernels launched: {others}")
    check(elbo1 > elbo0, f"{tag}: training took the fixed minibatch's ELBO from {elbo0} only to {elbo1}")
    shape = _product_at_path_shape(seen["first"][0], tag=tag)
    bwd_shape = _bwd_at_path_shape(*seen_bwd["first"], tag=tag)
    strategy = model.variational_strategy
    with torch.no_grad():
        torch.manual_seed(GRID_SEED + 1)
        kl32 = strategy.kl_divergence(model=model).sum().item()
        twin = copy.deepcopy(model).double()
        with gt.settings.max_cholesky_size(4 * GRID_M):
            kl32_dense = strategy.kl_divergence(model=model).sum().item()
            kl64 = twin.variational_strategy.kl_divergence(model=twin).sum().item()
        model.eval()
        mean = likelihood(model(sx)).mean
    rmse = (mean - sy).pow(2).mean().sqrt().item()
    print(f"[{tag}] KL at the last state: mBCG float32 {kl32:.4f}, dense Cholesky float32 {kl32_dense:.4f}, dense "
          f"Cholesky float64 {kl64:.4f} (gap of the mBCG one {abs(kl32 - kl64) / abs(kl64):.3e} relative, not gated); "
          f"rmse of the {N_TEST} test points {rmse:.4f}", flush=True)
    check(all(math.isfinite(k) for k in (kl32, kl32_dense, kl64)), f"{tag}: a non-finite KL")
    return dict(step_ms=float(np.median(times[1:])) * 1e3, rmse=rmse, kl=(kl32, kl32_dense, kl64),
                shape=dict(shape, launches_per_step=fwd), bwd_shape=dict(bwd_shape, launches_per_step=bwd),
                launches=sum(fwd), bwd_launches=sum(bwd))


def phase_grid_svgp():
    """Phase 17b: the grid-interpolation SVGPs on make_task's data (``build_grid_svgp``):
    the additive strategy on all D inputs (a 1-D grid of GRID_M points) and the 2-D strategy
    on the first two (GRID_2D² points), GRID_STEPS Adam steps each on minibatches of
    SVGP_BATCH.  q(u) is unwhitened: its KL against N(μ_U, K_UU + 1e-3·I) runs mBCG on the lazy
    K_UU (GRID_M > max_cholesky_size, GRID_M² > max_eager_kernel_size²), whose products launch
    kernel_matvec (the additive prior repeats the 1-D K_UU over the D dimensions and folds them
    into the columns of one launch) and whose backward launches kernel_bwd_fused.  Gates: every
    step launched both in the KL and no other kernel; the first launch of each against its
    plain version on the same operands (the product at KERNEL_REL_TOL, the backward by
    ``_bwd_at_path_shape``), timed beside its bound; finite ELBOs and the ELBO of a fixed
    minibatch raised.  Prints the mBCG KL beside the dense float64 KL (not gated),
    grid_svgp_step_ms, the RMSE and the launches a step (CG iterations).  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_grid_svgp()'``.  Returns the readings."""
    import torch

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    return dict(additive=_grid_svgp_run(True), grid2d=_grid_svgp_run(False))


def _elbo_and_grads(model, likelihood, x, y) -> tuple:
    """The ELBO of (x, y) and its gradient in every parameter of the model and the likelihood,
    by name."""
    import gpytorch_tpu_torch as gt

    for p in list(model.parameters()) + list(likelihood.parameters()):
        p.grad = None
    elbo = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)(model(x), y)
    elbo.backward()
    grads = {f"m.{k}": p.grad.detach().clone() for k, p in model.named_parameters()}
    grads |= {f"l.{k}": p.grad.detach().clone() for k, p in likelihood.named_parameters()}
    return elbo.item(), grads


def phase_large_batch():
    """Phase 17c: LargeBatchVariationalStrategy against VariationalStrategy, which computes the
    same function, on make_task's data: m = LB_M inducing points (``build_svgp``'s seeded
    subset), a Cholesky q(u), minibatches of LB_BATCH.  Each strategy takes LB_STEPS Adam steps
    (lr SVGP_ADAM_LR) from the same state on the same minibatches; their step times are printed
    (not a claim).  Gate: at the large-batch model's last state, its ELBO on one minibatch and
    the ELBO's gradients against the whitened strategy's on the same state, in float32 and in
    float64 (float64 copies), within LB_TOL (|ΔELBO| / |ELBO| and max |Δ∇| / max |∇|); no kernel
    launched.  Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_large_batch()'``."""
    import torch

    import gpytorch_tpu_torch as gt

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    dev = "cuda"
    train_x, train_y, _, _ = make_task(N_TRAIN, N_TEST)
    tx, ty = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y))
    kw = dict(dist="cholesky", jitter_val=SVGP_JITTER, m=LB_M, seed=LB_SEED)
    large, lik_large = build_svgp(train_x, dev, torch.float32, strategy="large_batch", **kw)
    with torch.no_grad():
        large(tx[:4])  # initialises q(u)
    whitened, lik_whitened = build_svgp(train_x, dev, torch.float32, **kw)
    whitened.load_state_dict(large.state_dict())
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(LB_SEED), LB_STEPS, dev, batch=LB_BATCH)
    runs = {}
    for name, model, likelihood in (("large batch", large, lik_large), ("whitened", whitened, lik_whitened)):
        mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
        optimizer = torch.optim.Adam(list(model.parameters()) + list(likelihood.parameters()), lr=SVGP_ADAM_LR)
        runs[name] = _train_svgp_steps(model, likelihood, optimizer, mll, tx, ty, batches, f"large batch: {name}")
    xb, yb = tx[batches[0]], ty[batches[0]]
    gaps = {}
    for dtype in (torch.float32, torch.float64):
        pair = []
        for cls_name in ("large_batch", "whitened"):
            model, likelihood = build_svgp(train_x, dev, dtype, strategy=cls_name, **kw)
            model.load_state_dict(large.state_dict())
            likelihood.load_state_dict(lik_large.state_dict())
            pair.append(_elbo_and_grads(model, likelihood, xb.to(dtype), yb.to(dtype)))
        (e_large, g_large), (e_white, g_white) = pair
        scale = max(g.abs().max().item() for g in g_white.values())
        grad_gap = max((g_large[k] - g_white[k]).abs().max().item() for k in g_white) / scale
        gaps[dtype] = (abs(e_large - e_white) / abs(e_white), grad_gap)
    launches = [tuple(a + b for a, b in zip(f, bw)) for name in runs for f, bw in runs[name][2]]
    print(f"[large batch] m={LB_M}, minibatch {LB_BATCH}, {LB_STEPS} Adam steps each from one state on the same "
          f"minibatches: large-batch step {_quartiles_ms(runs['large batch'][1][1:])}, whitened step "
          f"{_quartiles_ms(runs['whitened'][1][1:])} (printed, not a claim); ELBO {runs['large batch'][0][0]:.5f} → "
          f"{runs['large batch'][0][-1]:.5f} and {runs['whitened'][0][0]:.5f} → {runs['whitened'][0][-1]:.5f}; at the "
          f"last state against the whitened strategy (|ΔELBO| / |ELBO|, max |Δ∇| / max |∇|): float32 "
          f"{gaps[torch.float32][0]:.3e}, {gaps[torch.float32][1]:.3e}; float64 {gaps[torch.float64][0]:.3e}, "
          f"{gaps[torch.float64][1]:.3e} (tol {LB_TOL}); {nvidia_smi()}", flush=True)
    for dtype, tol in zip((torch.float32, torch.float64), LB_TOL):
        check(all(g <= t for g, t in zip(gaps[dtype], tol)), f"large batch: {dtype} gaps {gaps[dtype]} above {tol}")
    check(not any(any(x) for x in launches), f"large batch: kernels launched {launches}")
    return dict(step_ms=float(np.median(runs["large batch"][1][1:])) * 1e3,
                whitened_step_ms=float(np.median(runs["whitened"][1][1:])) * 1e3, gaps=gaps)


def build_decoupled(train_x, device, dtype, kind: str):
    """Phase 17d's models, with ConstantMean and ScaleKernel(RBFKernel(ard_num_dims=D)) and a
    GaussianLikelihood with noise ≥ NOISE_FLOOR: ``kind`` "orthogonal" is
    OrthogonallyDecoupledVariationalStrategy with DEC_MEAN_M mean inducing points (a Delta
    q(u)) over a whitened VariationalStrategy with DEC_COVAR_M (a Cholesky q(u)); "batch" is
    BatchDecoupledVariationalStrategy with DEC_BATCH_M inducing points and a kernel of batch
    shape (2,).  Inducing points are seeded subsets of the training inputs, K_ZZ's jitter
    SVGP_JITTER; (model, likelihood) on ``device`` in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    rng = np.random.default_rng(DEC_SEED)

    def rows(m):
        return torch.as_tensor(train_x[rng.choice(len(train_x), m, replace=False)])

    batch = (2,) if kind == "batch" else ()

    class DecoupledSVGP(gt.models.ApproximateGP):
        def __init__(self):
            if kind == "orthogonal":
                covar = gt.variational.VariationalStrategy(
                    self, rows(DEC_COVAR_M), gt.variational.CholeskyVariationalDistribution(DEC_COVAR_M),
                    jitter_val=SVGP_JITTER)
                strategy = gt.variational.OrthogonallyDecoupledVariationalStrategy(
                    covar, rows(DEC_MEAN_M), gt.variational.DeltaVariationalDistribution(DEC_MEAN_M),
                    jitter_val=SVGP_JITTER)
            else:
                strategy = gt.variational.BatchDecoupledVariationalStrategy(
                    self, rows(DEC_BATCH_M), gt.variational.CholeskyVariationalDistribution(DEC_BATCH_M),
                    jitter_val=SVGP_JITTER)
            super().__init__(strategy)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D, batch_shape=batch),
                                                       batch_shape=batch)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    return DecoupledSVGP().to(device=device, dtype=dtype).train(), likelihood.to(device=device, dtype=dtype).train()


def _decoupled_run(kind: str) -> dict:
    import copy

    import torch

    import gpytorch_tpu_torch as gt

    tag = f"decoupled {kind}"
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    tx, ty, sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (train_x, train_y, test_x, test_y))
    model, likelihood = build_decoupled(train_x, dev, torch.float32, kind)
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N_TRAIN)
    fixed = slice(0, SVGP_BATCH)

    def fixed_elbo(m=model, lik=likelihood, dtype=torch.float32):
        with torch.no_grad():
            return gt.mlls.VariationalELBO(lik, m, num_data=N_TRAIN)(m(tx[fixed].to(dtype)), ty[fixed].to(dtype)).item()

    elbo0 = fixed_elbo()  # initialises q(u) (and the wrapped strategy's)
    twin, twin_lik = copy.deepcopy(model).double(), copy.deepcopy(likelihood).double()
    with plain_kernels():
        elbo64 = fixed_elbo(twin, twin_lik, torch.float64)
    gap = abs(elbo0 - elbo64) / abs(elbo64)
    # the Delta q(u)'s values over DEC_MEAN_M correlated points move the mean together: their own rate
    delta = [p for name, p in model.named_parameters() if name == "variational_strategy._variational_distribution"
             ".variational_mean" and kind == "orthogonal"]
    rest = [p for p in list(model.parameters()) + list(likelihood.parameters()) if all(p is not q for q in delta)]
    optimizer = torch.optim.Adam([{"params": rest, "lr": SVGP_ADAM_LR}]
                                 + ([{"params": delta, "lr": DEC_MEAN_LR}] if delta else []))
    batches = _svgp_batches(torch.Generator(device=dev).manual_seed(DEC_SEED), DEC_STEPS, dev)
    wrappers = _kernel_wrappers()
    with recorded_calls("kernel_matvec_cuda") as seen, recorded_calls("kernel_bwd_fused_cuda") as seen_bwd:
        elbos, times, launches = _train_svgp_steps(model, likelihood, optimizer, mll, tx, ty, batches, tag, wrappers)
    elbo1 = fixed_elbo()
    model.eval()
    with torch.no_grad():
        mean = likelihood(model(sx)).mean
    rmse = (mean - sy).pow(2).mean().sqrt().item()
    fwd = [f for f, _ in launches]
    bwd = [b for _, b in launches]
    print(f"[{tag}] {DEC_STEPS} Adam steps (lr {SVGP_ADAM_LR}, minibatch {SVGP_BATCH}): step "
          f"{_quartiles_ms(times[1:])} over steps 1-{DEC_STEPS - 1}; ELBO of the fixed minibatch at the initial state "
          f"float32 {elbo0:.7f}, float64 {elbo64:.10f}, relative gap {gap:.3e} (tol {DEC_ELBO_TOL}); fixed minibatch "
          f"ELBO {elbo0:.5f} → {elbo1:.5f}; rmse {rmse:.4f}; launches a step (matvec, bwd_fused, grad_x, periodic "
          f"matvec, periodic bwd) forward {sorted(set(fwd))}, backward {sorted(set(bwd))}; K·V shapes "
          f"{sorted(set(seen['shapes']))}; {nvidia_smi()}", flush=True)
    check(all(math.isfinite(e) for e in elbos), f"{tag}: a non-finite ELBO")
    check(gap <= DEC_ELBO_TOL, f"{tag}: ELBO float32 against float64 {gap:.3e}")
    check(kind != "orthogonal" or all(f[0] > 0 and b[0] > 0 and b[1] > 0 for f, b in zip(fwd, bwd)),
          f"{tag}: a step launched no kernel_matvec or kernel_bwd_fused: forward {fwd}, backward {bwd}")
    check(elbo1 > elbo0, f"{tag}: training took the fixed minibatch's ELBO from {elbo0} only to {elbo1}")
    # the backward's kernel_matvec launches are its dv = K·g, inside kernel_bwd_fused's wrapper
    out = dict(step_ms=float(np.median(times[1:])) * 1e3, rmse=rmse, gap=gap,
               launches=sum(f[0] for f in fwd) + sum(b[0] for b in bwd), bwd_launches=sum(b[1] for b in bwd))
    if seen["first"] is not None:
        out["shape"] = dict(_product_at_path_shape(seen["first"][0], tag=tag, what="½ mᵀK m's product"),
                            launches_per_step=[f[0] + b[0] for f, b in zip(fwd, bwd)])
    if seen_bwd["first"] is not None:
        out["bwd_shape"] = dict(_bwd_at_path_shape(*seen_bwd["first"], tag=tag, what="½ mᵀK m's backward"),
                                launches_per_step=[b[1] for b in bwd])
    return out


def phase_decoupled():
    """Phase 17d: the decoupled strategies (``build_decoupled``) at N=100k on make_task's data,
    DEC_STEPS Adam steps (lr SVGP_ADAM_LR) each on minibatches of SVGP_BATCH.  Gates: each ELBO
    of a fixed minibatch on the initial state in float32 against a float64 copy (plain versions
    of the kernels) within DEC_ELBO_TOL, finite ELBOs, the fixed minibatch's ELBO raised.  The
    orthogonally decoupled KL's ½ mᵀ(K_mm + …)m reads the lazy K at DEC_MEAN_M² (above
    max_eager_kernel_size²): its kernel_matvec launch (t = 1) is held against its plain version
    on the same operands, and its backward's kernel_bwd_fused launch (dv, dx, dos; the dv a
    second kernel_matvec launch) by ``_bwd_at_path_shape``, each timed beside its bound.
    Prints the step times, the RMSE and the launches a step.  Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_decoupled()'``."""
    import torch

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    return dict(orthogonal=_decoupled_run("orthogonal"), batch=_decoupled_run("batch"))


def build_sparse_exact(train_x, train_y, device, dtype, kind: str):
    """Phase 17e's exact GPs on the training data: ConstantMean, a GaussianLikelihood with noise
    ≥ NOISE_FLOOR (initial 0.1) and, for ``kind`` "sgpr", InducingPointKernel(ScaleKernel(
    RBFKernel(ard_num_dims=D))) with SPARSE_M inducing points drawn from the training rows with
    SPARSE_SEED, for "rff" RFFKernel(num_samples=RFF_SAMPLES, ard_num_dims=D) (frequencies from
    a generator seeded with SPARSE_SEED); lengthscales 0.5; on ``device`` in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    x = torch.as_tensor(train_x, dtype=dtype, device=device)
    y = torch.as_tensor(train_y, dtype=dtype, device=device)
    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))

    class SparseExact(gt.models.ExactGP):
        def __init__(self):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            if kind == "sgpr":
                Z = torch.as_tensor(train_x[np.random.default_rng(SPARSE_SEED).choice(len(train_x), SPARSE_M,
                                                                                     replace=False)])
                base = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))
                self.covar_module = gt.kernels.InducingPointKernel(base, Z, likelihood)
            else:
                self.covar_module = gt.kernels.RFFKernel(RFF_SAMPLES, num_dims=D, ard_num_dims=D,
                                                         generator=torch.Generator().manual_seed(SPARSE_SEED))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    model = SparseExact().to(device=device, dtype=dtype)
    model.likelihood.noise = 0.1
    kernel = model.covar_module.base_kernel.base_kernel if kind == "sgpr" else model.covar_module
    kernel.lengthscale = 0.5
    return model.train()


def _woodbury64(R, R_test, r, noise):
    """Float64: rᵀ(R Rᵀ + σ²I)⁻¹r and R_test Rᵀ (R Rᵀ + σ²I)⁻¹ r by the Woodbury identity,
    O(n k²): with C = σ²I + RᵀR, (R Rᵀ + σ²I)⁻¹ r = (r − R C⁻¹ Rᵀ r) / σ²."""
    import torch

    C = noise * torch.eye(R.shape[-1], dtype=R.dtype, device=R.device) + R.mT @ R
    Rt_r = R.mT @ r
    w = torch.linalg.solve(C, Rt_r)
    inv_quad = (r @ r - Rt_r @ w) / noise
    return inv_quad.item(), R_test @ w


def _sgpr_term64(kernel, x, noise):
    """SGPR's added loss term −½ Σ_i (k_ii − q_ii) / σ² in float64 from an
    InducingPointKernel(ScaleKernel(RBF ARD))'s hyperparameters alone: q_ii = |L⁻¹ k_Z(x_i)|²,
    L the Cholesky factor of K_ZZ + 1e-4·I and psd_safe_cholesky's float64 1e-8·I; with the
    sum of its terms' magnitudes ½ Σ_i (k_ii + q_ii) / σ²."""
    import torch

    scaled = kernel.base_kernel
    os = scaled.outputscale.double().reshape(())
    ls = scaled.base_kernel.lengthscale.double().reshape(-1)
    z, xs = kernel.inducing_points.double() / ls, x.double() / ls

    def k(a, b):
        return os * torch.exp(-0.5 * torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist").square())

    eye = torch.eye(z.shape[0], dtype=torch.float64, device=z.device)
    L = torch.linalg.cholesky(k(z, z) + (1e-4 + 1e-8) * eye)
    q = torch.linalg.solve_triangular(L, k(z, xs), upper=False).square().sum(0)
    return (-0.5 * (os - q) / noise).sum().item(), (0.5 * (os + q) / noise).sum().item()


def _sparse_run(kind: str) -> dict:
    """One model of phase 17e (``build_sparse_exact``)."""
    import torch

    import gpytorch_tpu_torch as gt

    tag = kind
    dev = "cuda"
    train_x, train_y, test_x, test_y = make_task(N_TRAIN, N_TEST)
    sx, sy = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (test_x, test_y))
    model = build_sparse_exact(train_x, train_y, dev, torch.float32, kind)
    z = [p for name, p in model.named_parameters() if name.endswith("inducing_points")]
    rest = [p for name, p in model.named_parameters() if not name.endswith("inducing_points")]
    optimizer = torch.optim.Adam([{"params": rest, "lr": SPARSE_LR}] + ([{"params": z, "lr": SVGP_ADAM_LR}] if z else []))
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(N_TRAIN, 1, dtype=torch.float32, device=dev)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    times, iters, losses = [], [], []
    for step in range(SPARSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss, state = mll_loss(model, generator, state)
        loss.backward()
        optimizer.step()
        ok = finite_step(loss, model)
        times.append(time.perf_counter() - t0)
        iters.append(state.num_iters)
        losses.append(loss.item())
        check(ok, f"{tag}: non-finite loss or gradient at step {step}")
    train_launches = tuple(w.launches for w in wrappers)
    tx, ty = model.train_inputs[0], model.train_targets
    twin = _float64_copy(model)
    tx64 = tx.double()
    r64 = ty.double() - twin.mean_module(tx64).detach()
    noise64 = twin.likelihood.noise.reshape(-1)[0].item()
    with torch.no_grad():
        R = gt.models.LinearPredictionStrategy._root_of(twin.covar_module(tx64))
        R_test = gt.models.LinearPredictionStrategy._root_of(twin.covar_module(sx.double()))
        iq64, mean64 = _woodbury64(R, R_test, r64, noise64)
        mean64 = mean64 + twin.mean_module(sx.double())
        with gt.settings.max_cholesky_size(0), gt.settings.cg_tolerance(SPARSE_CG_TOL), \
                gt.settings.max_cg_iterations(1000), gt.settings.max_preconditioner_size(50), \
                gt.settings.cg_stall_window(50), gt.settings.preconditioner_noise_budget(PC_NOISE_BUDGET):
            marginal = model.likelihood(model(tx)).lazy_covariance_matrix
            iq32 = marginal.inv_quad_logdet(inv_quad_rhs=ty - model.mean_module(tx), logdet=False)[0].item()
        term = None
        if kind == "sgpr":  # the training-mode terms at the last state, float32 and float64
            model.covar_module(tx).evaluate_kernel()
            term = next(iter(model.added_loss_terms())).loss().item()
            twin.covar_module.train()
            twin.covar_module(tx64).evaluate_kernel()
            term64 = next(iter(twin.added_loss_terms())).loss().item()
            twin.covar_module.eval()
            closed64, magnitudes = _sgpr_term64(twin.covar_module, tx64, noise64)
            term_gap = abs(term64 - closed64) / magnitudes
    iq_gap = abs(iq32 - iq64) / abs(iq64)
    model.eval()
    with eval_settings():
        cg, refresh_s, answers = serve(model, sx, dev, [slice(0, N_TEST)])
    _, mean, var, request_s = answers[0]
    strategy = model.prediction_strategy()
    feature_path = getattr(strategy, "_feat_mean_cache", None) is not None
    served = f"{type(strategy).__name__} ({'feature-space caches' if feature_path else 'mean cache and LOVE'})"
    mean_gap = (mean.double() - mean64).abs().max().item() / mean64.abs().max().item()
    rmse = (mean - sy).pow(2).mean().sqrt().item()
    nlpd = marginal_nlpd(mean, var, sy, model.likelihood.noise.reshape(-1)[0])
    serve_launches = tuple(w.launches for w in wrappers)
    cg_text = "no CG" if cg is None else f"CG {cg.num_iters} iterations"
    term_text = "" if term is None else (
        f"; the added loss term in float64 {term64:.9f} against its closed form {closed64:.9f}: {term_gap:.3e} of "
        f"its terms' magnitudes {magnitudes:.6e} (tol {SGPR_TERM_TOL}), a planted term = 0 "
        f"{abs(closed64) / magnitudes:.3e}; in float32 {term:.6f}, {abs(term - closed64) / magnitudes:.3e} of "
        f"them (not gated: float32 cancels k_ii − q_ii as the JAX package does)")
    print(f"[{tag}] {SPARSE_STEPS} Adam steps under bench.py's training recipe: step {_quartiles_ms(times[1:])}, "
          f"first step {times[0] * 1e3:.1f} ms; CG iterations per step {iters}; loss {losses[0]:.5f} → {losses[-1]:.5f}"
          f"{term_text}; rᵀK̂⁻¹r float32 (CG at {SPARSE_CG_TOL}) {iq32:.6f} against float64 Woodbury {iq64:.6f}: "
          f"{iq_gap:.3e} (tol {SPARSE_IQ_TOL}); {nvidia_smi()}", flush=True)
    print(f"[{tag}] served by {served}: refresh {refresh_s:.3f} s ({cg_text}), {N_TEST} points in {request_s * 1e3:.2f} "
          f"ms; mean against float64 Woodbury max |Δ| / max |μ| {mean_gap:.3e} (tol {SPARSE_MEAN_TOL}); rmse "
          f"{rmse:.4f}, marginal nlpd {nlpd:.4f}; launches training {train_launches}, serving {serve_launches} "
          f"(predicted none)", flush=True)
    if kind == "sgpr":
        check(term_gap <= SGPR_TERM_TOL, f"{tag}: float64 added loss term {term64} against its closed form {closed64}")
        check(abs(closed64) / magnitudes > SGPR_TERM_TOL, f"{tag}: the term's gate does not see a planted term = 0")
    check(iq_gap <= SPARSE_IQ_TOL, f"{tag}: inverse quadratic term {iq32} against float64 {iq64}")
    check(mean_gap <= SPARSE_MEAN_TOL, f"{tag}: predictive mean against float64: {mean_gap:.3e}")
    check(not any(train_launches) and not any(serve_launches), f"{tag}: kernels launched {train_launches}, "
                                                                f"{serve_launches}")
    return dict(step_ms=float(np.median(times[1:])) * 1e3, iters=iters, rmse=rmse, nlpd=nlpd, served=served,
                iq_gap=iq_gap, mean_gap=mean_gap)


def phase_sparse_exact():
    """Phase 17e: SGPR and random-Fourier-feature exact GPs (``build_sparse_exact``) on
    make_task's data at N=100k, SPARSE_STEPS Adam steps each under ``train_settings`` (the
    likelihood's noise makes R Rᵀ + σ²I an ``AddedDiagLinearOperator``: preconditioned mBCG on
    root products, as in the JAX package), then the N_TEST test points served under
    ``eval_settings``.  Gates: SGPR's added loss term in float64 against ``_sgpr_term64`` (the
    float32 term printed); rᵀ(R Rᵀ + σ²I)⁻¹r by CG at SPARSE_CG_TOL and the served mean against
    a float64 Woodbury evaluation of the same state, O(n m²); no kernel launched.  Prints the
    step times, the CG iterations, RMSE, NLPD and the strategy that served.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_sparse_exact()'``."""
    import torch

    if not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    return dict(sgpr=_sparse_run("sgpr"), rff=_sparse_run("rff"))



def make_spectral_task(n_train: int, n_test: int, seed: int = 0):
    """``make_periodic_task``'s daily profile without its weekend damping, the time column
    alone as (n, 1), counted in readings (5 minutes: the spectral initialisers read frequencies
    per unit of the input spacing, so that the daily cycle lies at 1/288).  Four mixtures cannot
    represent the weekly amplitude modulation: on the CPU their week-ahead forecast of the
    damped series read above the constant predictor's, even from the spectrum's exact lines."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_train + n_test) / 288.0
    h = 24.0 * (t - np.floor(t))
    f = np.exp(-(((h - 8.0) / 1.5) ** 2)) + 0.8 * np.exp(-(((h - 17.5) / 2.0) ** 2))
    y = f + 0.1 * f.std() * rng.normal(size=t.shape)
    y = (y - y.mean()) / y.std()
    x = 288.0 * t[:, None]
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def build_spectral_mixture_model(train_x, train_y, device, dtype):
    """Phase 18's exact GP: ConstantMean, SpectralMixtureKernel(num_mixtures=SM_Q) initialised by
    ``initialize_from_data_empspect`` (means drawn from the periodogram; GPyTorch's tutorial's
    ``initialize_from_data`` puts them uniform up to the Nyquist rate, 144 cycles a day here,
    where the float32 kernel is indefinite by 3e-3 of its largest eigenvalue and the
    preconditioner's factor fails at the first step), and a GaussianLikelihood with noise ≥
    NOISE_FLOOR (initial 0.1), on ``device`` in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    class SpectralMixtureGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.SpectralMixtureKernel(num_mixtures=SM_Q)

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx, ty = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y))
    likelihood = gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    model = SpectralMixtureGP(tx, ty, likelihood).to(device=device, dtype=dtype)
    model.covar_module.initialize_from_data_empspect(train_x, train_y)
    model.likelihood.noise = 0.1
    return model.train()


def make_derivative_task(n_train: int, n_test: int, seed: int = 0):
    """``make_task``'s function f of d = D inputs with its analytic gradient: each of f and ∂_a f
    with Gaussian noise of 0.1, all of them standardised by the values' mean and std, as
    ``make_task`` standardises y; targets (n, D + 1) as [f, ∂₁f, …, ∂_D f]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n_train + n_test, D))
    a, b, c = x[:, 0], x[:, 1], x[:, 2]
    f = np.sin(4 * a) * np.cos(3 * b) + 0.5 * np.sin(7 * c * a) + 0.1 * c
    grad = np.stack([4 * np.cos(4 * a) * np.cos(3 * b) + 3.5 * c * np.cos(7 * c * a),
                     -3 * np.sin(4 * a) * np.sin(3 * b), 3.5 * a * np.cos(7 * c * a) + 0.1], -1)
    y = f + 0.1 * rng.normal(size=n_train + n_test)
    grad = grad + 0.1 * rng.normal(size=grad.shape)
    mean, std = y.mean(), y.std()
    targets = np.concatenate([((y - mean) / std)[:, None], grad / std], -1)
    return x[:n_train], targets[:n_train], x[n_train:], targets[n_train:]


def build_derivative_model(train_x, train_y, device, dtype):
    """Phase 18b's derivative GP (``tests/test_derivative_and_dspp.py:19-31``): ConstantMeanGrad,
    ScaleKernel(RBFKernelGrad(ard_num_dims=D)) and MultitaskGaussianLikelihood(num_tasks=D + 1,
    has_task_noise=False), returning a MultitaskMultivariateNormal, at bench.py's initial noise
    0.1 and lengthscale 0.5, on ``device`` in train mode."""
    import torch

    import gpytorch_tpu_torch as gt

    class DerivativeGP(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMeanGrad()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernelGrad(ard_num_dims=D))

        def forward(self, x):
            return gt.distributions.MultitaskMultivariateNormal(self.mean_module(x), self.covar_module(x))

    tx, ty = (torch.as_tensor(a, dtype=dtype, device=device) for a in (train_x, train_y))
    likelihood = gt.likelihoods.MultitaskGaussianLikelihood(num_tasks=D + 1, has_task_noise=False)
    model = DerivativeGP(tx, ty, likelihood).to(device=device, dtype=dtype)
    model.likelihood.noise = 0.1
    model.covar_module.base_kernel.lengthscale = 0.5
    return model.train()


def _train_exact(tag, model, steps, dev, slow=(), slow_lr=None, overrides=None):
    """``steps`` Adam steps (cosine 0.1 → 0.01, the parameters ``slow`` at ``slow_lr`` decayed
    alike) of −MLL under bench.py's training recipe (``train_step``, with ``overrides`` of its
    settings), the warm state carried; returns (losses, seconds, CG iterations) per step, each
    step gated finite."""
    import torch

    rest = [p for p in model.parameters() if not any(p is q for q in slow)]
    optimizer = torch.optim.Adam([{"params": rest, "lr": 0.1}] + ([{"params": list(slow), "lr": slow_lr}] if slow else []))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps)))
    generator = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    state = torch.zeros(model.train_targets.numel(), 1, dtype=model.train_targets.dtype, device=dev)
    losses, times, iters = [], [], []
    for step in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        loss, state = train_step(model, optimizer, scheduler, generator, state, overrides=overrides)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        iters.append(state.num_iters)
        check(finite_step(loss, model), f"{tag} step {step}: non-finite loss or gradient")
    return losses, times, iters


def _loss_and_grad64(model, probes, pins, replay: bool):
    """One float64 −MLL and its gradient in every raw parameter under bench.py's recipe with
    CG run to 1e-10 (cold, no warm state), the probes injected and the preconditioner's pivots
    recorded (``replay`` False) or followed."""
    from gpytorch_tpu_torch import mlls, settings

    model.zero_grad()
    tx, ty = model.train_inputs[0], model.train_targets
    with train_settings(PC_NOISE_BUDGET_F64), settings.cg_tolerance(1e-10), settings.max_cg_iterations(1000), \
            settings.cg_stall_window(1000), settings.max_lanczos_quadrature_iterations(30), \
            (pins.replay() if replay else pins.record()):
        loss = -mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(tx), ty, base_samples=probes)
    loss.backward()
    return loss.item(), {name: p.grad.detach().cpu() for name, p in model.named_parameters()}


def spectral_mixture_parity(n: int = SM_PARITY_N, device: str = "cuda"):
    """Phase 18's float64 gate: the loss and gradient of the initialised model at N=``n`` on
    ``device`` against the same call on the CPU (``_loss_and_grad64``: the same injected probes,
    the CPU run's pivots), as (|Δloss| / |loss|, max |Δ∇| / max |∇|)."""
    import torch

    train_x, train_y, _, _ = make_spectral_task(n, 1)
    pins, out = PinnedPivots(), []
    for dev, replay in (("cpu", False), (device, True)):
        model = build_spectral_mixture_model(train_x, train_y, dev, torch.float64)
        out.append(_loss_and_grad64(model, InjectedProbes(0), pins, replay))
    (l_ref, g_ref), (loss, grads) = out
    scale = max(g.abs().max().item() for g in g_ref.values())
    return abs(loss - l_ref) / abs(l_ref), max((grads[k] - g_ref[k]).abs().max().item() for k in g_ref) / scale


def phase_spectral_mixture(n: int = SM_N, n_test: int = SM_TEST, steps: int = SM_STEPS, device: str = "cuda"):
    """Phase 18: a spectral-mixture forecast (``build_spectral_mixture_model``) on
    ``make_spectral_task``'s readings: N=``n`` training readings (SM_N, 56 days; the chunked
    backward keeps every block's graph, ≈ Q × N² × 4 bytes a few times over, so N=100k does not
    fit), ``steps`` Adam steps of bench.py's recipe (63 probes, the rank-50 preconditioner, cosine
    Adam; SM_SETTINGS replaced, the mixture means at SM_MEAN_LR), K·V streaming through
    ``_matmul_chunked`` and the preconditioner through ``_get_rows``;
    then a refresh (mean cache and LOVE) and the forecast of the next ``n_test`` readings.  Prints
    ms a step, CG iterations, peak memory, refresh_s, request_ms, RMSE and NLPD.  Gates: finite
    losses and gradients, the last 5 losses below the first 5, the forecast RMSE below the
    constant predictor's, no launch of the five kernel wrappers, and (on the card) the float64
    loss and gradient at SM_PARITY_N against the CPU within SM_PARITY_TOL.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_spectral_mixture()'``."""
    import torch

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    train_x, train_y, test_x, test_y = make_spectral_task(n, n_test)
    constant_rmse = float(np.sqrt(np.mean((test_y - train_y.mean()) ** 2)))
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build_spectral_mixture_model(train_x, train_y, device, torch.float32)
    losses, times, iters = _train_exact("spectral mixture", model, steps, device,
                                        slow=[model.covar_module.raw_mixture_means], slow_lr=SM_MEAN_LR,
                                        overrides=SM_SETTINGS)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    model.eval()
    sx = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    with eval_settings():
        cg, refresh_s, answers = serve(model, sx, device, [slice(0, n_test)])
    _, mean, var, request_s = answers[0]
    sy = torch.as_tensor(test_y, dtype=torch.float32, device=device)
    rmse = (mean - sy).square().mean().sqrt().item()
    nlpd = marginal_nlpd(mean, var, sy, model.likelihood.noise.reshape(-1)[0])
    launched = tuple(w.launches for w in wrappers)
    ms = sorted(1e3 * t_ for t_ in times[1:])
    median = ms[(len(ms) - 1) // 2]
    kernel = model.covar_module
    print(f"[spectral mixture] Q={SM_Q} at N={n} (d=1, in readings), {steps} steps: median {median:.1f} ms/step (range "
          f"{ms[0]:.1f} to {ms[-1]:.1f}, first {times[0]:.3f} s); CG iterations {iters}; loss {losses[0]:.5f} → "
          f"{losses[-1]:.5f}; peak device memory {peak / 2**20:.1f} MiB; refresh_s {refresh_s:.3f} (CG "
          f"{None if cg is None else cg.num_iters}), request_ms {request_s * 1e3:.2f} ({n_test} points); forecast rmse "
          f"{rmse:.4f} (the constant predictor's {constant_rmse:.4f}), nlpd {nlpd:.4f}; means "
          f"{[round(288 * v, 4) for v in kernel.mixture_means.reshape(-1).tolist()]} cycles a day, scales "
          f"{[round(288 * v, 4) for v in kernel.mixture_scales.reshape(-1).tolist()]}, weights "
          f"{[round(v, 4) for v in kernel.mixture_weights.reshape(-1).tolist()]}; launches {launched} (none expected: "
          f"no TPU kernel on this path); {nvidia_smi() if device == 'cuda' else device}", flush=True)
    check(sum(losses[-5:]) < sum(losses[:5]), f"spectral mixture: the loss did not fall: {losses}")
    check(bool(torch.isfinite(mean).all()) and bool((var > 0).all()), "spectral mixture: predictions not finite")
    check(rmse < constant_rmse, f"spectral mixture: rmse {rmse:.4f} not below the constant predictor's")
    check(launched == (0,) * 5, f"spectral mixture launched {launched}")
    out = dict(median_ms=median, iters=iters, peak=peak, refresh_s=refresh_s, request_ms=request_s * 1e3, rmse=rmse,
               nlpd=nlpd, launches=launched)
    del model, mean, var, answers
    if device == "cuda":
        torch.cuda.empty_cache()
        gaps = spectral_mixture_parity()
        print(f"[spectral mixture] float64 at N={SM_PARITY_N}, CUDA against CPU (injected probes, pinned pivots, CG "
              f"at 1e-10): loss {gaps[0]:.3e}, gradient {gaps[1]:.3e} (tol {SM_PARITY_TOL})", flush=True)
        check(max(gaps) <= SM_PARITY_TOL, f"spectral mixture: float64 CUDA against CPU {gaps}")
        out["parity"] = gaps
    return out


def phase_derivative_gp(n: int = DER_N, n_test: int = DER_TEST, steps: int = DER_STEPS, device: str = "cuda"):
    """Phase 18b: a derivative GP (``build_derivative_model``) on ``make_derivative_task``'s
    values and gradients at n inputs (n·(D + 1) observations: DER_N gives 8,192, on the CG path
    with the preconditioner, whose rows come from ``_get_rows`` of the lazy grad-kernel
    operator, each product evaluating the kernel's blocks), ``steps`` Adam steps of bench.py's
    recipe, then the ``n_test`` test inputs served (mean cache and LOVE).  Prints ms a step, CG
    iterations, peak memory, the value RMSE and the gradient RMSE (the mean over the D partial
    derivatives).  Gates: finite values, the last 5 losses below the first 5, both RMSEs below
    the constant predictor's, no launch of the five kernel wrappers.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_derivative_gp()'``."""
    import torch

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    train_x, train_y, test_x, test_y = make_derivative_task(n, n_test)
    constant = np.sqrt(np.mean((test_y - train_y.mean(0)) ** 2, axis=0))
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build_derivative_model(train_x, train_y, device, torch.float32)
    losses, times, iters = _train_exact("derivative gp", model, steps, device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    model.eval()
    sx = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    with eval_settings():
        cg, refresh_s, answers = serve(model, sx, device, [slice(0, n_test)])
    _, mean, var, request_s = answers[0]
    err = (mean.double().cpu().numpy() - test_y) ** 2
    rmse = np.sqrt(err.mean(0))
    value_rmse, grad_rmse = float(rmse[0]), float(rmse[1:].mean())
    launched = tuple(w.launches for w in wrappers)
    ms = sorted(1e3 * t_ for t_ in times[1:])
    median = ms[(len(ms) - 1) // 2]
    print(f"[derivative gp] n={n}, d={D} ({n * (D + 1)} observations), {steps} steps: median {median:.1f} ms/step (range "
          f"{ms[0]:.1f} to {ms[-1]:.1f}, first {times[0]:.3f} s); CG iterations {iters}; loss {losses[0]:.5f} → "
          f"{losses[-1]:.5f}; peak device memory {peak / 2**20:.1f} MiB; refresh_s {refresh_s:.3f} (CG "
          f"{None if cg is None else cg.num_iters}), request_ms {request_s * 1e3:.2f} ({n_test} points); value rmse "
          f"{value_rmse:.4f} (constant {constant[0]:.4f}), gradient rmse {grad_rmse:.4f} (constant "
          f"{constant[1:].mean():.4f}; per dimension {[round(float(r), 4) for r in rmse[1:]]}); launches {launched} (none "
          f"expected: no TPU kernel on this path); {nvidia_smi() if device == 'cuda' else device}", flush=True)
    check(sum(losses[-5:]) < sum(losses[:5]), f"derivative gp: the loss did not fall: {losses}")
    check(bool(torch.isfinite(mean).all()) and bool((var > 0).all()), "derivative gp: predictions not finite")
    check(value_rmse < constant[0], f"derivative gp: value rmse {value_rmse:.4f} not below the constant predictor's")
    check(grad_rmse < constant[1:].mean(), f"derivative gp: gradient rmse {grad_rmse:.4f} not below the constant "
                                           f"predictor's")
    check(launched == (0,) * 5, f"derivative gp launched {launched}")
    return dict(median_ms=median, iters=iters, peak=peak, refresh_s=refresh_s, request_ms=request_s * 1e3,
                value_rmse=value_rmse, grad_rmse=grad_rmse, launches=launched)


def _tail_modules():
    """Phase 18c's kernels and means by name: (a constructor, the kind of inputs)."""
    import gpytorch_tpu_torch as gt

    k, m = gt.kernels, gt.means
    return {
        "rq": (lambda: k.RQKernel(ard_num_dims=D), "cube"),
        "cosine": (lambda: k.CosineKernel(), "cube"),
        "linear": (lambda: k.LinearKernel(), "cube"),
        "polynomial": (lambda: k.PolynomialKernel(power=3), "cube"),
        **{f"piecewise_q{q}": ((lambda q=q: k.PiecewisePolynomialKernel(q=q, ard_num_dims=D)), "cube") for q in range(4)},
        "spectral_mixture": (lambda: k.SpectralMixtureKernel(num_mixtures=4, ard_num_dims=D), "cube"),
        "spectral_delta": (lambda: k.SpectralDeltaKernel(num_dims=D, num_deltas=16), "cube"),
        "constant": (lambda: k.ConstantKernel(), "cube"),
        "arc": (lambda: k.ArcKernel(k.RBFKernel(), ard_num_dims=D), "cube"),
        "cylindrical": (lambda: k.CylindricalKernel(4, k.RBFKernel()), "cube"),
        "gibbs": (lambda: k.GibbsKernel(), "cube"),
        "hamming": (lambda: k.HammingIMQKernel(vocab_size=TAIL_VOCAB), "one_hot"),
        "spherical_linear": (lambda: k.SphericalLinearKernel(), "cube"),
        "gaussian_kl": (lambda: k.GaussianSymmetrizedKLKernel(), "gaussians"),
        "rbf_grad": (lambda: k.ScaleKernel(k.RBFKernelGrad(ard_num_dims=D)), "cube"),
        "rbf_gradgrad": (lambda: k.RBFKernelGradGrad(ard_num_dims=D), "cube"),
        "matern52_grad": (lambda: k.Matern52KernelGrad(ard_num_dims=D), "cube"),
        "polynomial_grad": (lambda: k.PolynomialKernelGrad(power=3), "cube"),
        "zero_mean": (lambda: m.ZeroMean(), "cube"),
        "constant_mean_grad": (lambda: m.ConstantMeanGrad(), "cube"),
        "constant_mean_gradgrad": (lambda: m.ConstantMeanGradGrad(), "cube"),
        "linear_mean_grad": (lambda: m.LinearMeanGrad(D), "cube"),
        "linear_mean_gradgrad": (lambda: m.LinearMeanGradGrad(D), "cube"),
    }


def _tail_inputs(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "one_hot":
        return np.eye(TAIL_VOCAB)[rng.integers(TAIL_VOCAB, size=(n, TAIL_LENGTH))].reshape(n, -1)
    if kind == "gaussians":  # means, then log-variances
        return np.concatenate([rng.normal(size=(n, D)), 0.5 * rng.normal(size=(n, D))], -1)
    return rng.uniform(-1, 1, size=(n, D))


def _tail_module(build, device, dtype):
    """A module from ``build`` with its raw parameters moved off zero by a seeded draw (the same
    on every device and dtype), on ``device`` in ``dtype``."""
    import torch

    module = build().double()
    rng = np.random.default_rng(TAIL_SEED)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.as_tensor(0.3 * rng.normal(size=tuple(p.shape))))
    return module.to(device=device, dtype=dtype)


def _tail_readings(name, build, kind, device, dtype):
    """The kernel's matrix of TAIL_N × TAIL_M inputs, its symmetric diagonal and its product
    with TAIL_COLS columns on TAIL_PRODUCT_N inputs (above max_eager_kernel_size²: the lazy
    operator's ``_matmul_chunked``), or a mean's values, as float64 CPU tensors."""
    import torch

    module = _tail_module(build, device, dtype)
    x1, x2, xp = (torch.as_tensor(_tail_inputs(kind, n, s), dtype=dtype, device=device)
                  for n, s in ((TAIL_N, 0), (TAIL_M, 1), (TAIL_PRODUCT_N, 2)))
    with torch.no_grad():
        if not hasattr(module, "num_outputs_per_input"):  # a mean
            return {"values": module(x1).double().cpu()}
        op = module(xp)
        check(op._is_big(), f"kernel tail {name}: the product is not above max_eager_kernel_size²")
        v = torch.as_tensor(np.random.default_rng(3).normal(size=(op.shape[-1], TAIL_COLS)), dtype=dtype,
                            device=device)
        return {"dense": module(x1, x2).to_dense().double().cpu(), "diag": module(x1, diag=True).double().cpu(),
                "product": op.matmul(v).double().cpu()}


def phase_kernel_tail(device: str = "cuda"):
    """Phase 18c: every kernel and mean of the long tail (``_tail_modules``; raw parameters moved
    off zero by a seeded draw) on inputs made on ``device``, in float32 and float64: the matrix
    of TAIL_N × TAIL_M inputs, the diagonal, and the symmetric product on TAIL_PRODUCT_N inputs
    above max_eager_kernel_size² (``_matmul_chunked``; for the linear and spectral-delta kernels
    their root's products), each against the same module on the CPU in float64, as max |Δ| /
    max |·|.  Gates: float64 within TAIL_F64_TOL, float32 within TAIL_F32_TOL (TAIL_F64_ROOT_TOL
    and TAIL_F32_ROOT_TOL for TAIL_ROOT_KERNELS), no launch of the five kernel wrappers.  Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_kernel_tail()'``."""
    import torch

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    rows, failed = [], []
    for name, (build, kind) in _tail_modules().items():
        ref = _tail_readings(name, build, kind, "cpu", torch.float64)
        gaps = []
        root = name in TAIL_ROOT_KERNELS
        for dtype, tol in ((torch.float64, TAIL_F64_ROOT_TOL if root else TAIL_F64_TOL),
                           (torch.float32, TAIL_F32_ROOT_TOL if root else TAIL_F32_TOL)):
            got = _tail_readings(name, build, kind, device, dtype)
            gap = max((got[k] - ref[k]).abs().max().item() / max(ref[k].abs().max().item(), 1e-300) for k in ref)
            gaps.append(gap)
            if not gap <= tol:
                failed.append(f"{name} {dtype}: {gap:.3e} (tol {tol})")
        rows.append((name, *gaps))
    launched = tuple(w.launches for w in wrappers)
    print(f"[kernel tail] {len(rows)} modules, max |Δ| / max |·| against the CPU in float64 (float64/float32 on "
          f"{device}; tol {TAIL_F64_TOL}/{TAIL_F32_TOL}, {TAIL_F64_ROOT_TOL}/{TAIL_F32_ROOT_TOL} for "
          f"{', '.join(TAIL_ROOT_KERNELS)}): "
          f"{'; '.join(f'{n} {a:.1e}/{b:.1e}' for n, a, b in rows)}; {time.perf_counter() - t0:.1f} s; launches "
          f"{launched} (none expected)", flush=True)
    check(not failed, f"kernel tail: {failed}")
    check(launched == (0,) * 5, f"kernel tail launched {launched}")
    plain = [r for r in rows if r[0] not in TAIL_ROOT_KERNELS]
    return dict(worst64=max(r[1] for r in plain), worst32=max(r[2] for r in plain), launches=launched)


def make_list_task(n_train: int, n_test: int, seed: int = 0):
    """Phase 19's two outcomes of ``make_task``'s inputs: the flagship's y, and c(x) =
    cos(5x₀ + 2x₁)·exp(−x₂) plus Gaussian noise of 0.1, standardised, drawn with numpy from its
    own seed.  Returns the training inputs, [y, c], the test inputs and [test y, test c]."""
    train_x, train_y, test_x, test_y = make_task(n_train, n_test, seed)
    x = np.concatenate([train_x, test_x])
    c = np.cos(5 * x[:, 0] + 2 * x[:, 1]) * np.exp(-x[:, 2])
    c = c + 0.1 * np.random.default_rng([seed, LIST_SEED]).normal(size=len(x))
    c = (c - c.mean()) / c.std()
    return train_x, [train_y, c[:n_train]], test_x, [test_y, c[n_train:]]


def build_model_list(train_x, targets, device, dtype, params0=JAX_PARAMS):
    """Phase 19's ``IndependentModelList`` in train mode: outcome 0 the flagship's model (RBF-ARD)
    from the raw parameters ``params0``, outcome 1 ExactGP(ConstantMean, ScaleKernel(Matérn-5/2
    ARD), GaussianLikelihood) at bench.py's initial values (``build_model(..., nu=2.5)``)."""
    import gpytorch_tpu_torch as gt

    m0 = build_model(train_x, targets[0], device, dtype, params=params0).train()
    m1 = build_model(train_x, targets[1], device, dtype, params=None, nu=2.5)
    return gt.models.IndependentModelList(m0, m1)


def list_loss(model, mll, targets, budget: float = PC_NOISE_BUDGET):
    """−(the summed MLL) of the list on its training inputs under bench.py's recipe with LIST_CG."""
    tx = model.models[0].train_inputs[0]
    with train_settings(budget, overrides=LIST_CG):
        return -mll(model(tx, tx), targets)


@contextlib.contextmanager
def recorded_solves():
    """Wraps the mBCG's CG (``solvers/inv_quad.py::linear_cg``) for a run; yields a list that
    gets (CG iterations, the operator's product, the rhs column, its solution) of every solve."""
    from gpytorch_tpu_torch.solvers import inv_quad

    cg, seen = inv_quad.linear_cg, []

    def recording(matmul, rhs, **kwargs):
        result = cg(matmul, rhs, **kwargs)
        seen.append((result.num_iters, matmul, rhs[..., :1].detach(), result.solution[..., :1].detach()))
        return result

    inv_quad.linear_cg = recording
    try:
        yield seen
    finally:
        inv_quad.linear_cg = cg


@contextlib.contextmanager
def injected_probes():
    """``InjectedProbes(0)``'s draws (numpy, keyed by shape, the same on any device and dtype)
    injected into both places that draw probe base samples: the summed MLL passes none."""
    import torch

    from gpytorch_tpu_torch.linop import base, root

    saved, source = (base.probe_base_samples, root.probe_base_samples), InjectedProbes(0)

    def draw(shape, dtype, device, _=None):
        return torch.as_tensor(source(tuple(int(s) for s in shape)), dtype=dtype, device=device)

    base.probe_base_samples = root.probe_base_samples = draw
    try:
        yield
    finally:
        base.probe_base_samples, root.probe_base_samples = saved


def _list_slice(params0):
    """Phase 19's list at N=LIST_SLICE_N: one summed loss and its gradient from the same injected
    probes, CPU float32 (its pivots recorded), CPU float64 (the float32 runs' τ) and CUDA float32
    (pivots followed); returns the CUDA run's (loss, gradient) gaps from CPU float64 beside the
    CPU float32 run's."""
    import torch

    import gpytorch_tpu_torch as gt

    train_x, targets, _, _ = make_list_task(LIST_SLICE_N, 64, seed=1)
    runs, pins = {}, PinnedPivots()
    for device, dtype in (("cpu", torch.float32), ("cpu", torch.float64), ("cuda", torch.float32)):
        model = build_model_list(train_x, targets, device, dtype, params0)
        ts = [torch.as_tensor(t, dtype=dtype, device=device) for t in targets]
        budget = PC_NOISE_BUDGET_F64 if dtype == torch.float64 else PC_NOISE_BUDGET
        with injected_probes(), pins.replay() if runs else pins.record():
            loss = list_loss(model, gt.mlls.SumMarginalLogLikelihood(model.likelihood, model), ts, budget)
        loss.backward()
        runs[(device, dtype)] = (loss.item(), {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()})
    ref = runs[("cpu", torch.float64)]

    def gaps(run):
        return abs(run[0] - ref[0]) / max(abs(ref[0]), 1.0), _grad_gap(ref[1], run[1])[0]

    return gaps(runs[("cuda", torch.float32)]), gaps(runs[("cpu", torch.float32)])


def phase_model_list(flagship_model=None, n: int = N_TRAIN, n_test: int = N_TEST, steps: int = LIST_STEPS,
                     device: str = "cuda"):
    """Phase 19: a model list of two outcomes of ``make_list_task`` at N=``n``: outcome 0 a copy of
    phase 7's trained flagship (RBF-ARD; alone, at JAX_PARAMS), outcome 1 an exact GP with
    ScaleKernel(Matérn-5/2 ARD) at bench.py's initial values (``build_model_list``), trained jointly
    by ``SumMarginalLogLikelihood`` for ``steps`` Adam steps (LIST_LR) under bench.py's
    recipe with LIST_CG (every solve cold: the sum passes no warm state), then
    ``model.likelihood(*model(test_x, test_x))`` at the ``n_test`` test points, and a fantasy of the
    list with LIST_FANT points per outcome and one request from it.  Prints s a step, each
    outcome's CG iterations and losses, the launches of kernel_matvec and kernel_bwd_fused by
    kernel type, and per outcome RMSE, MAE, SMSE, MSLL (against the training targets), the 95 %
    coverage error, refresh_s and request_ms.  Gates: at step 0 the summed loss equals the two
    ``ExactMarginalLogLikelihood`` values alone with the same probes (LIST_SUM_TOL); both kernels
    launch on the RBF and the Matérn type (kernel_bwd_fused once per outcome a step), counted
    by the wrappers' ``launches_by_type``; outcome 1's first Matérn-5/2 training product (t=64)
    and backward, on their own operands, against float64 (``_product_at_path_shape``,
    ``_bwd_at_path_shape``); each outcome's rhs solve at the last step within LIST_RES_TOL of
    its true residual; outcome 1's loss falls; each outcome's RMSE below the constant
    predictor's; at N=LIST_SLICE_N the CUDA float32 loss and gradient against a CPU float64
    run.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_model_list()'``."""
    import torch

    import gpytorch_tpu_torch as gt
    from gpytorch_tpu_torch import settings
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    params0 = (JAX_PARAMS if flagship_model is None else
               {k: v.detach().cpu().numpy() for k, v in flagship_model.named_parameters()})
    train_x, targets, test_x, test_targets = make_list_task(n, n_test)
    model = build_model_list(train_x, targets, device, torch.float32, params0)
    ts = [torch.as_tensor(t, dtype=torch.float32, device=device) for t in targets]
    tx = torch.as_tensor(test_x, dtype=torch.float32, device=device)
    tys = [torch.as_tensor(t, dtype=torch.float32, device=device) for t in test_targets]
    mll = gt.mlls.SumMarginalLogLikelihood(model.likelihood, model)
    parts = [[], []]
    for i, inner in enumerate(mll.mlls):
        inner.register_forward_hook(lambda module, args, out, i=i: parts[i].append(-out.item()))
    optimizer = torch.optim.Adam([{"params": list(m.parameters()), "lr": lr} for m, lr in zip(model.models, LIST_LR)])
    scheduler = torch.optim.lr_scheduler.CosineAnnealingLR(optimizer, T_max=steps, eta_min=min(LIST_LR))
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    for w in (fk.kernel_matvec_cuda, fk.kernel_bwd_fused_cuda):
        w.launches_by_type.clear()
    times, losses, iters, shape, bwd_shape = [], [], [], None, None
    # outcome 1's first Matérn-5/2 training product (t=64, the tensor-core tier) and backward
    with recorded_calls("kernel_matvec_cuda", t=64, kt=fk.MATERN25) as seen, \
            recorded_calls("kernel_bwd_fused_cuda", kt=fk.MATERN25) as seen_bwd:
        for step in range(steps):
            sync(device)
            t0 = time.perf_counter()
            if step == 0:
                torch.manual_seed(LIST_SEED)
            with recorded_solves() as solves:
                optimizer.zero_grad()
                loss = list_loss(model, mll, ts)
                loss.backward()
                optimizer.step()
                scheduler.step()
            check(finite_step(loss, model), f"model list step {step}: non-finite loss or gradient")
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            iters.append([s[0] for s in solves])
        last_solves = solves
        model.eval()
        refresh_s, refresh_iters = [], []
        with eval_settings(), torch.no_grad():
            for m in model.models:
                sync(device)
                t0 = time.perf_counter()
                strategy = m.refresh()
                sync(device)
                refresh_s.append(time.perf_counter() - t0)
                refresh_iters.append(strategy.lik_train_train_covar.last_cg_result.num_iters)
            t0 = time.perf_counter()
            preds = model.likelihood(*model(tx, tx))
            moments = [(p.mean, p.variance) for p in preds]
            sync(device)
            list_request_s = time.perf_counter() - t0
            every = slice(0, n_test, n_test // LIST_FANT)
            t0 = time.perf_counter()
            with settings.cg_tolerance(FANT_CG_TOL):  # phase 15b's: the 16 solves on observed targets
                fantasy = model.get_fantasy_model([tx[every], tx[every]], [ty[every] for ty in tys])
            fantasy_preds = fantasy.likelihood(*fantasy(tx, tx))
            fantasy_moments = [(p.mean, p.variance) for p in fantasy_preds]
            sync(device)
            fantasy_s = time.perf_counter() - t0
    launched = tuple(w.launches for w in wrappers)
    by_type = {(name, kt): getattr(fk, name).launches_by_type[kt] for name in ("kernel_matvec_cuda",
                                                                             "kernel_bwd_fused_cuda")
               for kt in fk.KERNEL_TYPES}
    step0_alone = _list_step0_alone(model, params0, train_x, targets, device)
    with torch.no_grad():
        residuals = [((matmul(x) - b).norm() / b.norm()).item() for _, matmul, b, x in last_solves]
        request_ms = []
        with eval_settings():
            for i, m in enumerate(model.models):
                sync(device)
                t0 = time.perf_counter()
                model.likelihood_i(i, m(tx)).variance
                sync(device)
                request_ms.append((time.perf_counter() - t0) * 1e3)
    readings = []
    for i, (pred, ty) in enumerate(zip(preds, tys)):
        mean, var = moments[i]
        check(bool(torch.isfinite(mean).all()) and bool((var > 0).all()), f"model list outcome {i}: predictions")
        fmean, fvar = fantasy_moments[i]
        check(bool(torch.isfinite(fmean).all()) and bool((fvar > 0).all()), f"model list outcome {i}: fantasy")
        readings.append(dict(
            rmse=gt.metrics.mean_squared_error(pred, ty, squared=False).item(),
            mae=gt.metrics.mean_absolute_error(pred, ty).item(),
            smse=gt.metrics.standardized_mean_squared_error(pred, ty).item(),
            msll=gt.metrics.mean_standardized_log_loss(pred, ty, ts[i]).item(),
            qce=gt.metrics.quantile_coverage_error(pred, ty).item(),
            constant=(ty - ts[i].mean()).pow(2).mean().sqrt().item(), refresh_s=refresh_s[i],
            refresh_iters=refresh_iters[i], request_ms=request_ms[i]))
    per_outcome = [[it[i] for it in iters] for i in range(2)]
    ms = sorted(times[1:])
    median = ms[(len(ms) - 1) // 2]
    counts = {f"{name.split('_cuda')[0]} {'rbf' if kt == fk.RBF else 'matern52' if kt == fk.MATERN25 else kt}": c
              for (name, kt), c in sorted(by_type.items()) if c}
    sum_gap = abs(losses[0] - step0_alone) / max(abs(step0_alone), 1.0)
    print(f"[model list] N={n}, 2 outcomes (RBF-ARD, Matérn-5/2 ARD), {steps} steps: median {median:.3f} s/step (first "
          f"{times[0]:.3f} s); CG iterations per step (outcome 0, 1) {iters}; summed loss {losses[0]:.5f} → "
          f"{losses[-1]:.5f}; outcome losses {[round(v, 5) for v in parts[0]]} and {[round(v, 5) for v in parts[1]]}; "
          f"step 0 summed {losses[0]:.7f} against the two alone {step0_alone:.7f} (gap {sum_gap:.2e}, tol "
          f"{LIST_SUM_TOL}); rhs true relative residuals at the last step {[f'{r:.3e}' for r in residuals]} (tol "
          f"{LIST_RES_TOL}); launches {launched}, by kernel type {counts}", flush=True)
    for i, r in enumerate(readings):
        print(f"[model list] outcome {i}: rmse {r['rmse']:.4f} (constant {r['constant']:.4f}), mae {r['mae']:.4f}, smse "
              f"{r['smse']:.4f}, msll {r['msll']:.4f}, 95 % coverage error {r['qce']:.4f}, refresh_s "
              f"{r['refresh_s']:.3f} (CG {r['refresh_iters']}), request_ms {r['request_ms']:.2f} ({n_test} points)",
              flush=True)
    print(f"[model list] the list's request {list_request_s * 1e3:.2f} ms; fantasy ({LIST_FANT} points an outcome) and "
          f"its request {fantasy_s * 1e3:.2f} ms; {nvidia_smi() if device == 'cuda' else device}", flush=True)
    check(sum_gap <= LIST_SUM_TOL, f"model list: step 0's sum differs from the models alone by {sum_gap:.3e}")
    check(all(r <= LIST_RES_TOL for r in residuals), f"model list: rhs residuals {residuals}")
    check(sum(parts[1][-3:]) / 3 < parts[1][0], f"model list: outcome 1's loss did not fall: {parts[1]}")
    for i, r in enumerate(readings):
        check(r["rmse"] < r["constant"], f"model list outcome {i}: rmse {r['rmse']:.4f} not below {r['constant']:.4f}")
    if device == "cuda":
        for name, count in (("kernel_matvec_cuda", None), ("kernel_bwd_fused_cuda", steps)):
            for kt in (fk.RBF, fk.MATERN25):
                got = by_type[(name, kt)]
                check(got > 0 if count is None else got == count,
                      f"model list: {name} launched {got} times on kernel type {kt}")
        for i, kt in enumerate((fk.RBF, fk.MATERN25)):
            check(by_type[("kernel_matvec_cuda", kt)] >= sum(per_outcome[i]),
                  f"model list: fewer kernel_matvec launches than CG iterations on outcome {i}")
        check(seen["first"] is not None and seen_bwd["first"] is not None,
              "model list: no Matérn-5/2 training product (t=64) or backward recorded")
        shape = _product_at_path_shape(seen["first"][0], "model list", "outcome 1's Matérn-5/2 training product",
                                       against_float64=True)
        bwd_shape = _bwd_at_path_shape(*seen_bwd["first"], tag="model list",
                                       what="outcome 1's Matérn-5/2 training backward")
        del seen, seen_bwd
        (loss_gap, grad_gap), floor = _list_slice(params0)
        print(f"[model list] N={LIST_SLICE_N}: CUDA float32 against CPU float64: loss {loss_gap:.3e}, gradient "
              f"{grad_gap:.3e} (CPU float32: {floor[0]:.3e}, {floor[1]:.3e}; tol {SLICE_LOSS_TOL}, {SLICE_GRAD_TOL})",
              flush=True)
        check(loss_gap <= SLICE_LOSS_TOL and grad_gap <= SLICE_GRAD_TOL, "model list: CUDA differs from CPU float64")
    return dict(launches=launched, by_type=counts, median=median, iters=per_outcome, readings=readings,
                residuals=residuals, sum_gap=sum_gap, fantasy_ms=fantasy_s * 1e3, model=model,
                matern_shape=shape, matern_bwd_shape=bwd_shape)


def _list_step0_alone(model, params0, train_x, targets, device):
    """Step 0's loss again, each outcome's ``ExactMarginalLogLikelihood`` alone and summed, from a
    new list at the same initial values and the same probes (the default generator seeded with
    LIST_SEED, drawn outcome by outcome)."""
    import torch

    import gpytorch_tpu_torch as gt

    fresh = build_model_list(train_x, targets, device, torch.float32, params0)
    ts = [torch.as_tensor(t, dtype=torch.float32, device=device) for t in targets]
    torch.manual_seed(LIST_SEED)
    with train_settings(overrides=LIST_CG), torch.no_grad():
        values = [-gt.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(m.train_inputs[0]), t)
                  for m, t in zip(fresh.models, ts)]
    return sum(v.item() for v in values)


def _loo_train(train_x, train_y, n, steps, device, limit=None):
    """The flagship's model at bench.py's initial values on the first ``n`` points, ``steps`` Adam
    steps (lr 0.1) of −LeaveOneOutPseudoLikelihood, stopped after step 1 where that took over
    ``limit`` seconds; returns (model, losses, seconds, peak bytes)."""
    import torch

    import gpytorch_tpu_torch as gt

    model = build_model(train_x[:n], train_y[:n], device, torch.float32, params=None)
    x, y = model.train_inputs[0], model.train_targets
    mll = gt.mlls.LeaveOneOutPseudoLikelihood(model.likelihood, model)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for step in range(steps):
        sync(device)
        t0 = time.perf_counter()
        optimizer.zero_grad()
        loss = -mll(model(x), y)
        loss.backward()
        optimizer.step()
        sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        check(finite_step(loss, model), f"loo step {step}: non-finite loss or gradient")
        if step == 1 and limit is not None and times[1] > limit:
            break
    return model, losses, times, torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _loo_value_and_grad(params, x, y, device):
    import torch

    import gpytorch_tpu_torch as gt

    model = build_model(x, y, device, torch.float64, params=params).train()
    value = gt.mlls.LeaveOneOutPseudoLikelihood(model.likelihood, model)(model(model.train_inputs[0]),
                                                                         model.train_targets)
    value.backward()
    return model, value.item(), {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def phase_loo(n: int = LOO_N, probe_n: int = LOO_PROBE_N, steps: int = LOO_STEPS, device: str = "cuda"):
    """Phase 19b: the flagship's model trained by ``LeaveOneOutPseudoLikelihood`` (dense K̂, its
    float64 Cholesky factor and L⁻¹) on the first points of phase 7's data: two steps at
    ``probe_n`` read first (ms a step, peak memory); ``steps`` Adam steps at ``n``, or at
    ``probe_n`` where the second step at ``n`` took over LOO_STEP_LIMIT s.  Prints ms a step, the peak,
    the LOO-RMSE and the float32 σᵢ²'s largest relative error from a float64 twin's.  Gates: the
    loss falls; at N=LOO_PARITY_N the card's float64 value and gradient against the CPU's
    (LOO_F64_TOL); at LOO_POINTS points μᵢ and σᵢ² against conditioning on the other n − 1
    points in float64 on the card (LOO_COND_TOL); no launch of the five kernel wrappers.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_loo()'``."""
    import torch

    from gpytorch_tpu_torch.mlls.leave_one_out_pseudo_likelihood import _loo_moments

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    train_x, train_y, _, _ = make_task(N_TRAIN, N_TEST)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    _, _, times, peak = _loo_train(train_x, train_y, probe_n, 2, device)
    sizing = {probe_n: (times[1], peak)}
    model, losses, times, peak = _loo_train(train_x, train_y, n, steps, device, limit=LOO_STEP_LIMIT)
    sizing[n] = (times[1], peak)
    n_used = n if len(losses) == steps else probe_n
    if n_used != n:
        model, losses, times, peak = _loo_train(train_x, train_y, probe_n, steps, device)
    x, y = model.train_inputs[0], model.train_targets
    with torch.no_grad():
        mu, sigma2 = _loo_moments(model.likelihood(model(x)), y)
        twin = _float64_copy(model).train()
        _, sigma2_64 = _loo_moments(twin.likelihood(twin(twin.train_inputs[0])), twin.train_targets)
    loo_rmse = (y - mu).pow(2).mean().sqrt().item()
    sigma2_err = ((sigma2.double() - sigma2_64).abs() / sigma2_64).max().item()
    params = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
    px, py = train_x[:LOO_PARITY_N], train_y[:LOO_PARITY_N]
    card, value_card, grad_card = _loo_value_and_grad(params, px, py, device)
    _, value_cpu, grad_cpu = _loo_value_and_grad(params, px, py, "cpu")
    value_gap = abs(value_card - value_cpu) / abs(value_cpu)
    grad_gap = _grad_gap(grad_cpu, grad_card)[0]
    with torch.no_grad():
        cx, cy = card.train_inputs[0], card.train_targets
        mu_c, sigma2_c = _loo_moments(card.likelihood(card(cx)), cy)
        prior = card.likelihood(card(cx))
        K = prior.covariance_matrix + 1e-8 * torch.eye(LOO_PARITY_N, dtype=torch.float64, device=cx.device)
        m = prior.mean
        points = np.random.default_rng(LIST_SEED).choice(LOO_PARITY_N, LOO_POINTS, replace=False).tolist()
        cond = []
        for i in points:
            rest = torch.arange(LOO_PARITY_N, device=cx.device) != i
            w = torch.linalg.solve(K[rest][:, rest], K[rest, i])
            cond.append((m[i] + w @ (cy[rest] - m[rest]), K[i, i] - K[i, rest] @ w))
        mu_b, sigma2_b = (torch.stack(v) for v in zip(*cond))
    cond_gap = max(((mu_b - mu_c[points]).abs().max() / mu_b.abs().max()).item(),
                   ((sigma2_b - sigma2_c[points]).abs().max() / sigma2_b.abs().max()).item())
    launched = tuple(w.launches for w in wrappers)
    ms = sorted(1e3 * t_ for t_ in times[1:])
    median = ms[(len(ms) - 1) // 2]
    print(f"[loo] sizing: a step at N={probe_n} {sizing[probe_n][0] * 1e3:.1f} ms (peak {sizing[probe_n][1] / 2**20:.1f} "
          f"MiB), at N={n} {sizing[n][0] * 1e3:.1f} ms (peak {sizing[n][1] / 2**20:.1f} MiB; limit {LOO_STEP_LIMIT} s): "
          f"trained at N={n_used}", flush=True)
    print(f"[loo] N={n_used}, {steps} steps: median {median:.1f} ms/step (range {ms[0]:.1f} to {ms[-1]:.1f}, first "
          f"{times[0] * 1e3:.1f} ms); loss {losses[0]:.5f} → {losses[-1]:.5f}; peak device memory {peak / 2**20:.1f} MiB; "
          f"LOO-RMSE {loo_rmse:.4f}; float32 σᵢ² against a float64 twin: max relative error {sigma2_err:.3e}; "
          f"N={LOO_PARITY_N} float64 card against CPU: value {value_gap:.3e}, gradient {grad_gap:.3e} (tol "
          f"{LOO_F64_TOL}); μᵢ, σᵢ² at {LOO_POINTS} points against conditioning on the others {cond_gap:.3e} (tol "
          f"{LOO_COND_TOL}); launches {launched} (none expected); {nvidia_smi() if device == 'cuda' else device}",
          flush=True)
    check(sum(losses[-5:]) / 5 < losses[0], f"loo: the loss did not fall: {losses}")
    check(value_gap <= LOO_F64_TOL and grad_gap <= LOO_F64_TOL, f"loo: float64 card against CPU {value_gap:.3e}, "
                                                                 f"{grad_gap:.3e}")
    check(cond_gap <= LOO_COND_TOL, f"loo: the closed form differs from conditioning by {cond_gap:.3e}")
    check(launched == (0,) * 5, f"loo launched {launched}")
    return dict(n=n_used, median_ms=median, peak=peak, loo_rmse=loo_rmse, sigma2_err=sigma2_err, launches=launched,
                sizing=sizing)


def make_gplvm_task(n: int, data_dim: int, seed: int = 0):
    """``examples/10_gplvm_latent_space.py::make_data``'s lift of a 2-d latent into ``data_dim``
    observed dimensions, drawn with numpy; returns (the true latents, Y, Y's PCA initialisation of
    ``data_dim`` latent dimensions, each standardised as ``tests/test_gplvm.py::_pca_init`` does)."""
    rng = np.random.default_rng(seed)
    X_true = rng.normal(size=(n, 2))
    lin = X_true @ (0.6 * rng.normal(size=(2, data_dim)))
    Y = lin + 0.4 * np.sin(2.0 * lin) + 0.05 * rng.normal(size=(n, data_dim))
    Yc = Y - Y.mean(0)
    X0 = Yc @ np.linalg.svd(Yc, full_matrices=False)[2].T
    return X_true, Y, X0 / X0.std(0, keepdims=True)


def build_gplvm(X_init, device, dtype, kind: str = "variational"):
    """Phase 19c's Bayesian GPLVM: a latent variable of ``kind`` (variational with a N(0, I) prior,
    point, or MAP under N(0, 1)) from ``X_init``, one GP per observed dimension in a batch of
    GPLVM_DIM (ConstantMean, ScaleKernel(RBF-ARD)), GPLVM_M inducing points a seeded choice of
    initial latents, a Cholesky q(u); and its batched GaussianLikelihood."""
    import torch

    import gpytorch_tpu_torch as gt

    n, latent_dim = X_init.shape
    xi = torch.as_tensor(X_init, dtype=dtype)
    if kind == "variational":
        prior = gt.priors.NormalPrior(torch.zeros_like(xi), torch.ones_like(xi))
        latent = gt.models.VariationalLatentVariable(n, GPLVM_DIM, latent_dim, xi, prior,
                                                     generator=torch.Generator().manual_seed(0))
    elif kind == "point":
        latent = gt.models.PointLatentVariable(n, latent_dim, xi)
    else:
        latent = gt.models.MAPLatentVariable(n, latent_dim, xi, gt.priors.NormalPrior(0.0, 1.0))
    Z = xi[np.random.default_rng(3).choice(n, GPLVM_M, replace=False)].expand(GPLVM_DIM, GPLVM_M, latent_dim)

    class GPLVM(gt.models.BayesianGPLVM):
        def __init__(self):
            vd = gt.variational.CholeskyVariationalDistribution(GPLVM_M, batch_shape=(GPLVM_DIM,))
            super().__init__(latent, gt.variational.VariationalStrategy(self, Z, vd, learn_inducing_locations=True))
            self.mean_module = gt.means.ConstantMean(batch_shape=(GPLVM_DIM,))
            self.covar_module = gt.kernels.ScaleKernel(
                gt.kernels.RBFKernel(ard_num_dims=latent_dim, batch_shape=(GPLVM_DIM,)), batch_shape=(GPLVM_DIM,))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    model = GPLVM().to(device=device, dtype=dtype)
    return model, gt.likelihoods.GaussianLikelihood(batch_shape=(GPLVM_DIM,)).to(device=device, dtype=dtype)


def _gplvm_steps(model, likelihood, Y, steps, generator, lr=GPLVM_LR):
    """``steps`` Adam steps of −Σ ELBO over the batch on minibatches of GPLVM_BATCH rows of the
    latent draw; returns (losses, seconds)."""
    import torch

    import gpytorch_tpu_torch as gt

    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=Y.shape[0])
    optimizer = torch.optim.Adam([*model.parameters(), *likelihood.parameters()], lr=lr)
    losses, times = [], []
    for _ in range(steps):
        sync(Y.device)
        t0 = time.perf_counter()
        idx = torch.randperm(Y.shape[0], generator=generator, device=Y.device)[:GPLVM_BATCH]
        optimizer.zero_grad()
        loss = -mll(model(model.sample_latent_variable(generator=generator)[idx]), Y[idx].T).sum()
        loss.backward()
        optimizer.step()
        sync(Y.device)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return losses, times


def _gplvm_elbo64(state, X_init, Y, eps, idx, device):
    """One float64 −Σ ELBO of the variational GPLVM at ``state`` with the latent draw's ε and the
    minibatch ``idx`` given, and its gradient in every parameter."""
    import torch

    import gpytorch_tpu_torch as gt

    model, likelihood = build_gplvm(X_init, device, torch.float64)
    model.load_state_dict(state[0])
    likelihood.load_state_dict(state[1])
    y = torch.as_tensor(Y, dtype=torch.float64, device=device)
    x = model.sample_latent_variable(eps=torch.as_tensor(eps, device=device))[idx]
    loss = -gt.mlls.VariationalELBO(likelihood, model, num_data=Y.shape[0])(model(x), y[idx].T).sum()
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in [*model.named_parameters(), *likelihood.named_parameters()]}
    return loss.item(), grads


def _distance_correlation(A, B) -> float:
    """The correlation of the two point sets' pairwise distances (``tests/test_gplvm.py``)."""
    dA = np.linalg.norm(A[:, None] - A[None], axis=-1).ravel()
    dB = np.linalg.norm(B[:, None] - B[None], axis=-1).ravel()
    return float(np.corrcoef(dA, dB)[0, 1])


def phase_gplvm(steps: int = GPLVM_STEPS, device: str = "cuda"):
    """Phase 19c: the Bayesian GPLVM at the shape of GPyTorch's GPLVM tutorial (the oil-flow set:
    GPLVM_N points, GPLVM_DIM observed dimensions, latent_dim = data_dim, GPLVM_M inducing
    points) on ``make_gplvm_task``'s synthetic data: a ``VariationalLatentVariable`` with a N(0, I)
    prior from the PCA initialisation, ``VariationalELBO(num_data=GPLVM_N)``, ``steps`` Adam steps at
    GPLVM_LR on minibatches of GPLVM_BATCH rows of the latent draw.  Prints ms a step, the loss, the
    distance correlation of q_mu with the true latents (the PCA initialisation's beside it).
    Gates: the correlation above GPLVM_CORR and above the PCA initialisation's; one float64
    ELBO and gradient on the card, with the same ε and minibatch, against the CPU's
    (GPLVM_F64_TOL); the point and MAP latents train GPLVM_POINT_STEPS steps to finite values;
    no launch of the five kernel wrappers.  Alone:
    ``python3 -c 'import chip_smoke; chip_smoke.phase_gplvm()'``."""
    import torch

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    X_true, Y, X_init = make_gplvm_task(GPLVM_N, GPLVM_DIM)
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    model, likelihood = build_gplvm(X_init, device, torch.float32)
    y = torch.as_tensor(Y, dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(LIST_SEED)
    losses, times = _gplvm_steps(model, likelihood, y, steps, generator)
    check(bool(np.isfinite(losses).all()), "gplvm: a non-finite loss")
    corr = _distance_correlation(model.X.q_mu.detach().cpu().numpy(), X_true)
    corr0 = _distance_correlation(X_init, X_true)
    rng = np.random.default_rng(LIST_SEED)
    eps, idx = rng.normal(size=X_init.shape), np.sort(rng.choice(GPLVM_N, GPLVM_BATCH, replace=False))
    state = (model.state_dict(), likelihood.state_dict())
    value_card, grad_card = _gplvm_elbo64(state, X_init, Y, eps, idx, device)
    value_cpu, grad_cpu = _gplvm_elbo64(state, X_init, Y, eps, idx, "cpu")
    value_gap, grad_gap = abs(value_card - value_cpu) / abs(value_cpu), _grad_gap(grad_cpu, grad_card)[0]
    others = {}
    for kind in ("point", "map"):
        m, lik = build_gplvm(X_init, device, torch.float32, kind)
        kind_losses, _ = _gplvm_steps(m, lik, y, GPLVM_POINT_STEPS, generator)
        finite = bool(np.isfinite(kind_losses).all()) and all(bool(torch.isfinite(p).all()) for p in m.parameters())
        check(finite, f"gplvm {kind} latents: non-finite values")
        others[kind] = kind_losses
    launched = tuple(w.launches for w in wrappers)
    ms = sorted(1e3 * t_ for t_ in times[1:])
    median = ms[(len(ms) - 1) // 2]
    print(f"[gplvm] n={GPLVM_N}, {GPLVM_DIM} observed and latent dimensions, m={GPLVM_M}, minibatch {GPLVM_BATCH}, "
          f"{steps} steps at lr {GPLVM_LR}: median {median:.2f} ms/step (range {ms[0]:.2f} to {ms[-1]:.2f}); loss "
          f"{losses[0]:.3f} → {np.mean(losses[-20:]):.3f} (mean of the last 20); latent geometry: distance correlation "
          f"with the true latents {corr:.4f} (PCA initialisation {corr0:.4f}; gate > {GPLVM_CORR} and > the PCA's); "
          f"float64 card against CPU: value {value_gap:.3e}, gradient {grad_gap:.3e} (tol {GPLVM_F64_TOL}); point and "
          f"MAP latents {GPLVM_POINT_STEPS} steps: {[round(v, 3) for v in others['point']]}, {[round(v, 3) for v in others['map']]}; "
          f"launches {launched} (none expected); {nvidia_smi() if device == 'cuda' else device}", flush=True)
    check(corr > max(GPLVM_CORR, corr0), f"gplvm: latent geometry correlation {corr:.4f}, not above "
                                          f"{GPLVM_CORR} and the PCA initialisation's {corr0:.4f}")
    check(value_gap <= GPLVM_F64_TOL and grad_gap <= GPLVM_F64_TOL, f"gplvm: float64 card against CPU {value_gap:.3e}, "
                                                                     f"{grad_gap:.3e}")
    check(launched == (0,) * 5, f"gplvm launched {launched}")
    return dict(median_ms=median, corr=corr, corr0=corr0, launches=launched)


def _prior_cases():
    """Phase 19d's priors, each (name, the prior in float64 on the CPU, its input as numpy)."""
    import gpytorch_tpu_torch as gt

    rng = np.random.default_rng(LIST_SEED)
    pr = gt.priors
    L = np.tril(rng.normal(size=(5, 3, 3)))
    L[:, range(3), range(3)] = np.abs(L[:, range(3), range(3)]) + 0.3
    L = L / np.linalg.norm(L, axis=-1, keepdims=True)
    R = L @ np.swapaxes(L, -1, -2)
    sd = rng.uniform(0.05, 2.3, size=(5, 3))
    A = rng.normal(size=(5, 3, 5))
    X = A @ np.swapaxes(A, -1, -2) / 5 + 0.2 * np.eye(3)
    K = X[0]
    box = pr.SmoothedBoxPrior(0.1, 2.0, 0.1)
    return [("smoothed_box", pr.SmoothedBoxPrior(0.1, 2.0, 0.1), np.array([-0.5, 0.1, 0.7, 1.9, 2.05, 2.6])),
            ("horseshoe", pr.HorseshoePrior(0.7), np.array([-3.0, -0.4, 0.07, 0.7, 1.4, 3.5])),
            ("lkj", pr.LKJPrior(3, 2.0), R),
            ("lkj_cholesky", pr.LKJCholeskyFactorPrior(3, 0.7), L),
            ("lkj_covariance", pr.LKJCovariancePrior(3, 1.5, box), R * sd[:, :, None] * sd[:, None, :]),
            ("wishart", pr.WishartPrior(5.5, K), X[1:]),
            ("inverse_wishart", pr.InverseWishartPrior(5.5, K), X[1:])]


def _prior_reading(prior, x, device, dtype):
    """(log_prob, its gradient in the input) as float64 CPU tensors."""
    import copy

    import torch

    xt = torch.as_tensor(x, dtype=dtype, device=device).requires_grad_(True)
    value = copy.deepcopy(prior).to(device=device, dtype=dtype).log_prob(xt)
    (grad,) = torch.autograd.grad(value.sum(), xt)
    return value.detach().double().cpu(), grad.double().cpu()


def _moment_gaps(device):
    """Each sampler's draws from a seeded generator on ``device`` in float64 against a moment:
    {name: (|mean − want| / its standard error, max over entries)}."""
    import torch

    import gpytorch_tpu_torch as gt

    pr = gt.priors
    K = torch.as_tensor(_prior_cases()[5][2][0], dtype=torch.float64)
    # P(|θ| < τ) of the horseshoe: E over λ ~ C⁺(0, 1) of 2Φ(1/λ) − 1, λ = tan(πu/2), midpoint rule in u
    u = (np.arange(200_000) + 0.5) / 200_000
    inside = float(np.mean([math.erf(v) for v in 1 / (np.tan(np.pi * u / 2) * math.sqrt(2))]))

    def draws(prior, seed):
        return prior.to(device=device, dtype=torch.float64).sample(
            (PRIOR_DRAWS,), generator=torch.Generator(device=device).manual_seed(seed))

    def gap(values, want):
        values = values.double().cpu()
        se = values.std(0) / math.sqrt(values.shape[0])
        return ((values.mean(0) - want).abs() / se).max().item()

    lkj = draws(pr.LKJPrior(4, 2.0), 1)
    lkj_chol = draws(pr.LKJCholeskyFactorPrior(4, 0.7), 2)
    cov = draws(pr.LKJCovariancePrior(3, 1.5, pr.SmoothedBoxPrior(0.1, 2.0, 0.1)), 3)
    sd = torch.diagonal(cov, dim1=-2, dim2=-1).sqrt()
    iu = torch.triu_indices(4, 4, 1)
    return {"lkj": gap(lkj[:, iu[0], iu[1]] ** 2, 1 / (2 * 2.0 + 3)),
            "lkj_cholesky": gap((lkj_chol @ lkj_chol.mT)[:, iu[0], iu[1]] ** 2, 1 / (2 * 0.7 + 3)),
            "lkj_covariance": max(gap(sd, 1.05), gap((cov[:, 0, 1] / (sd[:, 0] * sd[:, 1])) ** 2, 1 / (2 * 1.5 + 2))),
            "wishart": gap(draws(pr.WishartPrior(6.0, K), 4), 6.0 * K),
            "inverse_wishart": gap(draws(pr.InverseWishartPrior(9.0, K), 5), K / (9.0 - 3 - 1)),
            "horseshoe": gap((draws(pr.HorseshoePrior(0.7), 6).abs() < 0.7).double(), inside),
            "smoothed_box": gap(draws(pr.SmoothedBoxPrior(-1.0, 3.0), 7), 1.0)}


def _metric_gap(device) -> float:
    """The four metrics (MAE, SMSE, MSLL with and without the training targets, the 95 % coverage
    error) of a MultivariateNormal and an interleaved MultitaskMultivariateNormal made from numpy,
    on ``device`` in float64 against the CPU: the largest relative difference."""
    import torch

    import gpytorch_tpu_torch as gt

    rng = np.random.default_rng(LIST_SEED)
    worst = 0.0
    for shape in ((256,), (128, 3)):
        size = int(np.prod(shape))
        A = rng.normal(size=(size, size))
        cov, mean = 0.05 * A @ A.T / size + np.diag(rng.uniform(0.05, 0.3, size=size)), rng.normal(size=shape)
        y, train_y = mean + 0.4 * rng.normal(size=shape), 0.5 + 2.0 * rng.normal(size=shape[0])
        values = {}
        for dev in ("cpu", device):
            t = (lambda a, dev=dev: torch.as_tensor(a, dtype=torch.float64, device=dev))
            dist = (gt.distributions.MultivariateNormal(t(mean), t(cov)) if len(shape) == 1
                    else gt.distributions.MultitaskMultivariateNormal(t(mean), t(cov)))
            ty = t(y)
            values[dev] = torch.stack([gt.metrics.mean_absolute_error(dist, ty),
                                       gt.metrics.standardized_mean_squared_error(dist, ty),
                                       gt.metrics.mean_standardized_log_loss(dist, ty),
                                       gt.metrics.quantile_coverage_error(dist, ty)]
                                      + ([gt.metrics.mean_standardized_log_loss(dist, ty, t(train_y))]
                                         if len(shape) == 1 else [])).cpu()
        worst = max(worst, ((values[device] - values["cpu"]).abs() / values["cpu"].abs().clamp_min(1e-300)).max().item())
    return worst


def _task_prior():
    """BoTorch's MultiTaskGP task-covariance prior: LKJ(2, 1.5) with SmoothedBox(e⁻⁶, e^1.25, 0.05)
    standard deviations."""
    import gpytorch_tpu_torch as gt

    return gt.priors.LKJCovariancePrior(2, 1.5, gt.priors.SmoothedBoxPrior(math.exp(-6), math.exp(1.25), 0.05))


def phase_priors(device: str = "cuda"):
    """Phase 19d: every new prior (``_prior_cases``) — log_prob and its gradient in the input in
    float32 and float64 on the card against the CPU in float64, as max |Δ| / max |·|
    (PRIOR_TOL); each sampler with a seeded generator on the card against a moment, within 5
    standard errors of PRIOR_DRAWS draws; the phase-13c Hadamard model with an LKJ covariance
    prior on its IndexKernel (``_task_prior``, BoTorch's MultiTaskGP's), its MLL plus the prior
    on the card against a CPU float64 run at MT_SLICE_N // 4 points a task (``_mt_slice``), then
    HAD_PRIOR_STEPS steps at HAD_PRIOR_N points a task and a request (``_mt_train_and_serve``); the
    four new metrics in float64 on the card against the CPU (METRIC_TOL); no launch of the five
    kernel wrappers.  Alone: ``python3 -c 'import chip_smoke; chip_smoke.phase_priors()'``."""
    import torch

    if device == "cuda" and not torch.cuda.is_initialized():  # called alone
        phase_device()
        phase_build()
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    rows, failed = [], []
    for name, prior, x in _prior_cases():
        ref = _prior_reading(prior, x, "cpu", torch.float64)
        gaps = []
        for dtype, tol in zip((torch.float32, torch.float64), PRIOR_TOL):
            got = _prior_reading(prior, x, device, dtype)
            gap = max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref))
            gaps.append(gap)
            if not gap <= tol:
                failed.append(f"{name} {dtype}: {gap:.3e} (tol {tol})")
        rows.append((name, *gaps))
    moments = _moment_gaps(device)
    metric_gap = _metric_gap(device)
    hx, hy, htx, _ = make_hadamard_task(HAD_PRIOR_N, 128)
    sx, sy, stx, _ = make_hadamard_task(MT_SLICE_N // 4, 32, seed=1)
    build = (lambda *a: build_hadamard_model(*a, task_prior=_task_prior()))
    gaps = _mt_slice("hadamard prior", build, (sx, sy, stx), extra=True)
    had = build(hx, hy, device, torch.float32).train()
    prior_term = had.prior_log_prob_sum().item()
    before = tuple(w.launches for w in wrappers)  # _mt_train_and_serve counts its own from 0
    r = _mt_train_and_serve("hadamard prior", had, torch.as_tensor(htx, dtype=torch.float32, device=device),
                            HAD_PRIOR_STEPS, extra=True)
    launched = tuple(a + b for a, b in zip(before, r["launches"]))
    print(f"[priors] log_prob and its gradient, max |Δ| / max |·| against the CPU in float64 (float32/float64 on "
          f"{device}; tol {PRIOR_TOL}): {'; '.join(f'{n} {a:.1e}/{b:.1e}' for n, a, b in rows)}; samplers, |mean − "
          f"moment| in standard errors of {PRIOR_DRAWS} draws (limit 5): "
          f"{', '.join(f'{k} {v:.2f}' for k, v in moments.items())}; metrics float64 against the CPU {metric_gap:.3e} "
          f"(tol {METRIC_TOL}); hadamard with the LKJ task prior: prior term {prior_term:.4f} → "
          f"{had.prior_log_prob_sum().item():.4f}, {HAD_PRIOR_STEPS} steps {r['median'] * 1e3:.1f} ms/step; "
          f"{time.perf_counter() - t0:.1f} s; launches {launched} (none expected)", flush=True)
    check(not failed, f"priors: {failed}")
    check(all(v <= 5.0 for v in moments.values()), f"priors: a sampler's moment {moments}")
    check(metric_gap <= METRIC_TOL, f"priors: metrics on the card differ from the CPU by {metric_gap:.3e}")
    check(launched == (0,) * 5, f"priors launched {launched}")
    return dict(worst32=max(r_[1] for r_ in rows), worst64=max(r_[2] for r_ in rows), moments=moments,
                hadamard_gaps=gaps, launches=launched)


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch

        import gpytorch_tpu_torch  # noqa: F401  (fails when run outside the repository)

        phase_device()
        phase_build()
        mv_err, mv_timed, mv_strips = phase_kernel()
        bwd_err, bwd_ms, bwd_plain_ms = phase_bwd()
        gx_err, gx_timed = phase_grad_x()
        pmv_err, pmv_timed, pmv_strips, pbwd_err, pbwd_ms, pbwd_plain_ms = phase_periodic_kernels()
        phase_slice()
        phase_cholesky()
        phase_grad_slice()
        phase_grad_slice(periodic=True)
        serve_launches = phase_serve()
        refine_launches = phase_refine()
        phase_train_slice()
        phase_slice(periodic=True)
        phase_train_slice(periodic=True)
        phase_train_slice(wide=True)
        flagship = phase_flagship()
        mv_launches, bwd_launches = flagship["launches"]
        honest = phase_honest(flagship)
        pmv_launches, pbwd_launches = phase_periodic()
        _, gx_launches = phase_acquisition(flagship["model"])
        sample_launches = phase_sampling(flagship["model"])
        fantasy = phase_fantasy(flagship["model"])
        missing = phase_missing()
        kiss = phase_kissgp()
        kiss2 = phase_kissgp_2d()
        wiski = phase_wiski(kiss["model"])
        love_grad = phase_love_gradient(flagship["model"])
        batch = phase_batch()
        phase_batch_slice()
        phase_batch_slice(periodic=True)
        multitask = phase_multitask()
        lcm_had = phase_lcm_hadamard()
        svgp = phase_svgp()
        unwhitened = phase_unwhitened()
        deep = phase_deep_gp()
        dirichlet = phase_dirichlet()
        more = phase_fantasy_more(batch["model"], flagship["model"], multitask["model"])
        structure = phase_structure()
        ciq = phase_ciq()
        classification = phase_classification()
        ovc = phase_ovc()
        dspp = phase_dspp()
        vnngp = phase_vnngp()
        lmc = phase_lmc()
        grid = phase_grid_svgp()
        large_batch = phase_large_batch()
        decoupled = phase_decoupled()
        sparse = phase_sparse_exact()
        spectral = phase_spectral_mixture()
        derivative = phase_derivative_gp()
        tail = phase_kernel_tail()
        model_list = phase_model_list(flagship["model"])
        loo = phase_loo()
        gplvm = phase_gplvm()
        priors = phase_priors()
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    by_path = {"flagship": mv_launches, "honest": honest["launches"][0], "serving": serve_launches,
               "refinement": refine_launches, "sampling draw": sample_launches,
               "fantasy conditioning": fantasy["conditioning_launches"][0], "fantasy gradient": fantasy["launches"][0],
               "missing fill": missing["fill"][0], "missing mask": missing["mask"][0],
               "kissgp": kiss["launches"] + kiss2["launches"], "wiski": wiski["launches"],
               "love gradient": love_grad["launches"][0], "batch": batch["launches"][0],
               "multitask": multitask["launches"][0] + lcm_had["launches"][0], "svgp": svgp["launches"],
               "unwhitened kl": unwhitened["launches"], "deep gp": deep["launches"],
               "dirichlet": dirichlet["launches"][0], "batch fantasy": more["batch"]["launches"],
               "fixed-noise fantasy": more["fixed_noise"]["launches"], "multitask fantasy": 0, "structure": 0,
               "ciq": ciq["launches"][0] + ciq["serve_launches"][0], "classification": 0,
               "online conditioning": ovc["launches"], "dspp": 0, "vnngp": 0, "lmc": lmc["launches"],
               "grid svgp": grid["additive"]["launches"] + grid["grid2d"]["launches"], "large batch": 0,
               "decoupled": decoupled["orthogonal"]["launches"] + decoupled["batch"]["launches"], "sgpr": 0, "rff": 0,
               "spectral mixture": spectral["launches"][0], "derivative gp": derivative["launches"][0],
               "model list": model_list["launches"][0], "loo": loo["launches"][0], "gplvm": gplvm["launches"][0],
               "priors": priors["launches"][0]}
    print(f"[report] kernel_matvec launches by path: {by_path} (kissgp, wiski, multitask, svgp, deep gp, multitask "
          f"fantasy, structure, classification, dspp, vnngp, lmc, large batch, sgpr, rff, spectral mixture, derivative gp, "
          f"loo, gplvm and priors: none expected, no TPU kernel on those paths); dirichlet ({DIR_CLASSES} classes, "
          f"N={N_TRAIN}) dirichlet_step_ms {dirichlet['median_ms']:.1f}, CG {sum(dirichlet['iters'])} iterations in "
          f"{DIR_STEPS} steps, each class alone at the refresh {dirichlet['per_class_iters']}, refresh_s "
          f"{dirichlet['refresh_s']:.3f}, request_ms {dirichlet['request_ms']:.2f}, accuracy {dirichlet['accuracy']:.4f} "
          f"(chance {1 / DIR_CLASSES:.4f}); fantasy_ms batch {more['batch']['ms']:.3f}, fixed-noise "
          f"{more['fixed_noise']['ms']:.3f}, multitask {more['multitask']['ms']:.3f}; structure at N={STRUCT_N}: "
          f"additive {structure['additive']['median_ms']:.1f} ms/step (rmse {structure['additive']['rmse']:.4f}, peak "
          f"{structure['additive']['peak'] / 2**20:.1f} MiB), skip {structure['skip']['median_ms']:.1f} ms/step (rmse "
          f"{structure['skip']['rmse']:.4f}, peak {structure['skip']['peak'] / 2**20:.1f} MiB); svgp (m={SVGP_M}, NGD) svgp_step_ms {svgp['step_ms']:.3f}, rmse "
          f"{svgp['rmse']:.4f}, nlpd {svgp['nlpd']:.4f}; unwhitened KL product {unwhitened['shape']['n']}x"
          f"{unwhitened['shape']['m']} t={unwhitened['shape']['t']} {unwhitened['shape']['ms']:.4f} ms, "
          f"{unwhitened['shape']['launches_per_step']} launches a step, its backward "
          f"{unwhitened['bwd_shape']['ms']:.4f} ms, {unwhitened['bwd_shape']['launches_per_step']} a step; deep gp deep_gp_step_ms {deep['step_ms']:.3f}, "
          f"rmse {deep['rmse']:.4f}; batch (2 outputs, N={N_TRAIN}): median {batch['median']:.4f} s/step, mean "
          f"{batch['mean']:.4f} s/step, CG {sum(batch['iters'])} iterations in {B_STEPS} steps, refresh_s "
          f"{batch['refresh_s']:.3f}, request_ms {batch['request_ms']:.2f}, rmse {[round(r, 4) for r in batch['rmse']]}; "
          f"multitask (n={MT_N}, {MT_TASKS} tasks) {multitask['median'] * 1e3:.1f} ms/step, LCM "
          f"{lcm_had['lcm']['median'] * 1e3:.1f} ms/step, Hadamard {lcm_had['hadamard']['median'] * 1e3:.1f} ms/step; "
          f"fantasy_ms {fantasy['fantasy_ms']:.3f}, kg_grad_s "
          f"{fantasy['kg_grad_s']:.3f} (unresolved at N={N_TRAIN}); missing targets, one loss and gradient at N={N_TRAIN}: fill "
          f"{missing['fill'][1]:.3f} s, mask {missing['mask'][1]:.3f} s; KISS-GP 1D step {kiss['step_ms']:.3f} ms, "
          f"refresh {kiss['refresh_ms']:.1f} ms, request {kiss['request_ms']:.3f} ms, draw {kiss['draw_ms']:.3f} ms "
          f"(peak {max(kiss['train_peak'], kiss['serve_peak']) / 2**20:.1f} MiB); 2D step {kiss2['step_ms']:.3f} ms, "
          f"request {kiss2['request_ms']:.3f} ms (peak {max(kiss2['train_peak'], kiss2['serve_peak']) / 2**20:.1f} "
          f"MiB); wiski_fantasy_ms {wiski['wiski_ms']:.3f}; love_grad_ms {love_grad['love_grad_ms']:.3f}; ciq (m={CIQ_M}) "
          f"ciq_step_ms {ciq['step_ms']:.1f}, rmse {ciq['rmse']:.4f}, nlpd {ciq['nlpd']:.4f}, request_ms "
          f"{ciq['request_ms']:.1f}, peak {ciq['peak'] / 2**20:.1f} MiB; classification cls_step_ms "
          f"{classification['step_ms']:.3f}, accuracy {classification['accuracy']:.4f}; ovc_fantasy_ms "
          f"{ovc['fantasy_ms']:.2f}; dspp_step_ms {dspp['step_ms']:.3f}, rmse {dspp['rmse']:.4f}; vnngp index "
          f"{vnngp['build_s']:.2f} s, vnngp_step_ms {vnngp['step_ms']:.3f}, rmse {vnngp['rmse']:.4f}; lmc "
          f"({LMC_TASKS} tasks, {LMC_LATENTS} latents, m={LMC_M}) lmc_step_ms {lmc['step_ms']:.3f}, rmse per task "
          f"{[round(r, 4) for r in lmc['rmse']]}; grid svgp additive grid_svgp_step_ms {grid['additive']['step_ms']:.3f}, "
          f"2d {grid['grid2d']['step_ms']:.3f}, rmse {grid['additive']['rmse']:.4f} and {grid['grid2d']['rmse']:.4f}; "
          f"large batch step {large_batch['step_ms']:.3f} ms (whitened {large_batch['whitened_step_ms']:.3f} ms); "
          f"decoupled orthogonal step {decoupled['orthogonal']['step_ms']:.3f} ms, batch "
          f"{decoupled['batch']['step_ms']:.3f} ms; sgpr step {sparse['sgpr']['step_ms']:.1f} ms, rmse "
          f"{sparse['sgpr']['rmse']:.4f}; rff step {sparse['rff']['step_ms']:.1f} ms, rmse {sparse['rff']['rmse']:.4f}; "
          f"spectral mixture (Q={SM_Q}, N={SM_N}) {spectral['median_ms']:.1f} ms/step, CG {sum(spectral['iters'])} "
          f"iterations in {SM_STEPS} steps, peak {spectral['peak'] / 2**20:.1f} MiB, refresh_s {spectral['refresh_s']:.3f}, "
          f"request_ms {spectral['request_ms']:.2f}, forecast rmse {spectral['rmse']:.4f}, nlpd {spectral['nlpd']:.4f}; "
          f"derivative gp (n={DER_N}, {DER_N * (D + 1)} observations) {derivative['median_ms']:.1f} ms/step, CG "
          f"{sum(derivative['iters'])} iterations in {DER_STEPS} steps, peak {derivative['peak'] / 2**20:.1f} MiB, value "
          f"rmse {derivative['value_rmse']:.4f}, gradient rmse {derivative['grad_rmse']:.4f}; kernel tail worst (q = 0 aside) "
          f"float64 "
          f"{tail['worst64']:.2e}, float32 {tail['worst32']:.2e}; model list (2 outcomes, N={N_TRAIN}) "
          f"{model_list['median']:.3f} s/step, CG iterations {model_list['iters']}, launches by kernel type "
          f"{model_list['by_type']}, rmse {[round(r['rmse'], 4) for r in model_list['readings']]}; loo (N={loo['n']}) "
          f"{loo['median_ms']:.1f} ms/step, peak {loo['peak'] / 2**20:.1f} MiB, LOO-RMSE {loo['loo_rmse']:.4f}; gplvm "
          f"{gplvm['median_ms']:.2f} ms/step, latent correlation {gplvm['corr']:.4f}; priors worst float32 "
          f"{priors['worst32']:.2e}, float64 {priors['worst64']:.2e}; "
          f"whole script {time.perf_counter() - t_start:.1f} s", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda", "source": f"gpytorch_tpu_torch/csrc/{source}",
                "replaces": f"gpytorch_tpu/ops/pallas_kernels.py:{replaces}", "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}

    report = {
        "kernels": [
            entry("kernel_matvec", "kernel_matvec.cu", 230, mv_launches, mv_err, *mv_timed[(N_TRAIN, N_TRAIN, 64)],
                  matvec_tc_bound(N_TRAIN, N_TRAIN, D, 64))
            | {"tier": "t in (32, 64] on the tensor cores, 3xTF32 mma.sync m16n8k8; bound_ms from matvec_tc_bound",
               "strips": mv_strips, "launches_by_path": by_path,
               "fantasy_shape": fantasy["shapes"][f"matvec_t{FANT_Q}"], "unwhitened_kl_shape": unwhitened["shape"],
               "dirichlet_shape": dirichlet["shape"],
               "ciq_shape": [ciq["shapes"]["matvec_t1"], ciq["shapes"]["matvec_batch"]],
               "ovc_shape": ovc["shape"], "grid_kl_shape": [grid["additive"]["shape"], grid["grid2d"]["shape"]],
               "decoupled_shape": decoupled["orthogonal"]["shape"], "model_list_matern_shape": model_list["matern_shape"]},
            entry("kernel_grad_x", "kernel_grad_x.cu", 328, gx_launches, gx_err, *gx_timed[(N_TEST, N_TRAIN, 100)],
                  grad_x_tc_bound(N_TEST, N_TRAIN, D, 100))
            | {"tier": "t in (32, 128] and d <= 64 on the tensor cores, 3xTF32 mma.sync m16n8k8; bound_ms from "
                       "grad_x_tc_bound", "launches_by_path": {"acquisition": gx_launches,
                                                               "fantasy gradient": fantasy["launches"][1],
                                                               "love gradient": love_grad["launches"][1]}},
            entry("kernel_bwd_fused", "kernel_bwd_fused.cu", 404, bwd_launches, bwd_err, bwd_ms, bwd_plain_ms,
                  bwd_tc_bound(N_TRAIN, D, 64))
            | {"launches_by_path": {"flagship": bwd_launches, "honest": honest["launches"][1],
                                    "fantasy": fantasy["launches"][2], "love gradient": love_grad["launches"][2],
                                    "batch": batch["launches"][1], "unwhitened kl": unwhitened["bwd_launches"],
                                    "dirichlet": dirichlet["launches"][1], "ciq": ciq["launches"][1],
                                    "grid svgp": grid["additive"]["bwd_launches"] + grid["grid2d"]["bwd_launches"],
                                    "decoupled": decoupled["orthogonal"]["bwd_launches"]
                                    + decoupled["batch"]["bwd_launches"], "model list": model_list["launches"][1]},
               "love_gradient_shape": love_grad["shape"], "unwhitened_kl_shape": unwhitened["bwd_shape"],
               "ciq_shape": ciq["shapes"]["bwd"], "grid_kl_shape": [grid["additive"]["bwd_shape"], grid["grid2d"]["bwd_shape"]],
               "dirichlet_shape": dirichlet["bwd_shape"], "decoupled_shape": decoupled["orthogonal"]["bwd_shape"],
               "model_list_matern_shape": model_list["matern_bwd_shape"],
               "tier": "t in (32, 64] and d <= 64 (dx, dos) on the tensor cores, 3xTF32 mma.sync m16n8k8; "
                       "bound_ms from bwd_tc_bound",
               "fantasy_shapes": [fantasy["shapes"]["bwd_t1"], fantasy["shapes"][f"bwd_t{FANT_Q}"]]},
            entry("periodic_matvec", "kernel_periodic_matvec.cu", 806, pmv_launches, pmv_err,
                  *pmv_timed[(P_N_TRAIN, P_N_TRAIN, 64)], periodic_matvec_tc_bound(P_N_TRAIN, P_N_TRAIN, P_D, 64))
            | {"tier": "t in (32, 64] on the tensor cores, 3xTF32 mma.sync m16n8k8; bound_ms from "
                       "periodic_matvec_tc_bound", "strips": pmv_strips},
            entry("periodic_bwd_fused", "kernel_periodic_bwd_fused.cu", 872, pbwd_launches, pbwd_err, pbwd_ms,
                  pbwd_plain_ms, periodic_bwd_tc_bound(P_N_TRAIN, P_D, 64))
            | {"tier": "t in (32, 64] (dx, dw, dos) on the tensor cores, 3xTF32 mma.sync m16n8k8; "
                       "bound_ms from periodic_bwd_tc_bound"},
        ]
    }
    print(nvidia_smi(), flush=True)
    print(json.dumps(report), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
