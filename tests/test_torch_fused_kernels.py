"""The port's fused kernel matvec (gpytorch_tpu_torch/ops/fused_kernels.py) against the
JAX package's: the Pallas kernel in interpret mode, and its jnp reference path.

On the CPU the dispatch takes the plain PyTorch version; the CUDA kernel itself is checked
against that plain version on a GPU by tests/test_torch_cuda_kernel.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
from gpytorch_tpu.ops import pallas_kernels as pk
from gpytorch_tpu_torch.ops import fused_kernels as fk

KERNEL_TYPES = [fk.RBF, fk.MATERN05, fk.MATERN15, fk.MATERN25]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret_small_tiles(monkeypatch):
    # as tests/test_pallas_interpret.py: small tiles so ragged shapes span several tiles
    monkeypatch.setattr(pk, "_BN", 128)
    monkeypatch.setattr(pk, "_BM", 256)
    with gp.settings.pallas_interpret(True):
        yield


def _data(n, m, d, t, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype) for s in ((n, d), (m, d), (m, t)))


def _port(x1, x2, v, ktype, **kw):
    return fk._matvec_reference(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(v), ktype, **kw).numpy()


def test_kernel_ids_match_the_jax_package():
    assert (fk.RBF, fk.MATERN05, fk.MATERN15, fk.MATERN25) == (pk.RBF, pk.MATERN05, pk.MATERN15, pk.MATERN25)


@pytest.mark.parametrize("ktype,d", [pytest.param(k, 3, id=str(k)) for k in KERNEL_TYPES]
                         + [pytest.param(k, 100, id=f"{k}-d100") for k in KERNEL_TYPES])
def test_plain_matches_pallas_kernel_interpret(ktype, d, pallas_interpret_small_tiles):
    # float32, ragged: 137 rows = 2 row tiles, 251 columns = 1 padded column tile.  d = 100
    # (the Pallas kernel's quadratic-expansion path, past 8 dims): 40 × 70, the inputs
    # scaled by 1/√d so that K is not all 0; the same tolerance
    if d == 3:
        x1, x2, v = _data(137, 251, 3, 5, seed=ktype, dtype=np.float32)
    else:
        x1, x2, v = _data(40, 70, d, 5, seed=ktype, dtype=np.float32)
        x1, x2 = x1 / np.float32(np.sqrt(d)), x2 / np.float32(np.sqrt(d))
    want = np.asarray(pk._matvec_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), ktype))
    np.testing.assert_allclose(_port(x1, x2, v, ktype), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ktype", KERNEL_TYPES)
def test_plain_matches_jax_reference_float64(ktype):
    # gpytorch_tpu's sq_dist forms its distance product with preferred_element_type=float32
    # even under x64.  Inputs on a quarter grid with a power-of-two row count keep every
    # entry and partial sum of that product exact in float32, so both sides see the same
    # distances and agree to float64 round-off.
    rng = np.random.default_rng(10 + ktype)
    x1 = rng.integers(-6, 7, size=(64, 3)) / 4.0
    x2 = rng.integers(-6, 7, size=(75, 3)) / 4.0
    v = rng.normal(size=(75, 4))
    want = np.asarray(pk._matvec_reference(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), ktype))
    np.testing.assert_allclose(_port(x1, x2, v, ktype), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("chunk", [1, 64, 299, 300, 4096])
def test_plain_row_chunking(chunk):
    x1, x2, v = _data(300, 200, 3, 3, seed=7)
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    exact = np.exp(-0.5 * d2) @ v
    np.testing.assert_allclose(_port(x1, x2, v, fk.RBF, chunk=chunk), exact, rtol=1e-10, atol=1e-12)


def test_dispatch_takes_plain_version_on_cpu():
    x1, x2, v = (torch.from_numpy(a) for a in _data(30, 20, 2, 2, seed=3))
    before = fk.kernel_matvec_cuda.launches
    out = fk.fused_scaled_kernel_matvec(x1, x2, v, torch.tensor(0.7, dtype=torch.float64), fk.MATERN25)
    torch.testing.assert_close(out, 0.7 * fk._matvec_reference(x1, x2, v, fk.MATERN25), rtol=1e-12, atol=1e-12)
    assert fk.kernel_matvec_cuda.launches == before


def _f32(*shapes):
    return tuple(torch.zeros(s, dtype=torch.float32) for s in shapes)


@pytest.mark.parametrize(
    "args,error",
    [
        (tuple(torch.zeros(s, dtype=torch.float64) for s in ((4, 3), (5, 3), (5, 2))), TypeError),  # dtype
        (_f32((4, 3), (5, 2), (5, 2)), ValueError),  # d of x1 and x2 differ
        (_f32((4, 3), (5, 3), (6, 2)), ValueError),  # rows of x2 and v differ
        (_f32((4, 3), (5, 3), (5,)), ValueError),  # v not 2-D
        (_f32((4, 3), (5, 3), (5, 2)), ValueError),  # a CPU tensor
    ],
)
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    before = fk.kernel_matvec_cuda.launches
    with pytest.raises(error):
        fk.kernel_matvec_cuda(*args, fk.RBF)
    assert fk.kernel_matvec_cuda.launches == before


@pytest.mark.parametrize("ktype", [-1, 4])
def test_unknown_kernel_type_raises(ktype):
    with pytest.raises(ValueError):
        fk.fused_kernel_matvec(*_f32((4, 3), (5, 3), (5, 2)), ktype)


def test_dispatch_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        fk.fused_kernel_matvec(*_f32((4, 3), (5, 3), (6, 2)), fk.RBF)


# ---------------------------------------------------------------------------------------
# the slab split of the j range (ops/fused_kernels.py::_slab_count): the rule on its own,
# with an H100's 132 SMs; the kernels themselves are checked on a GPU
# ---------------------------------------------------------------------------------------

H100_SMS = 132
N_PATH = 100_000


def _slab_len(m, slabs, tile=64):
    """The slab length of the C entries of the K·V kernels: ceil(m / slabs) rounded up to a
    multiple of the 64-row staged tile."""
    return -(-(-(-m // slabs)) // tile) * tile


def _cols(t):
    """The column tile of the K·V tier at t: 1, 64 on the tensor cores, else 32."""
    return 1 if t == 1 else 64 if 32 < t <= 64 else 32


def _product_slabs(n, m, t, rows, per_sm):
    """``fk.product_slabs`` for a plan of the kind the K·V tiers report on the card
    (``gp_kernel_matvec_plan``, ``gp_periodic_matvec_plan``): blocks of ``rows`` rows (128,
    or 64 in the padded tensor-core tier), column tiles of 1 (t = 1), 64 (t ∈ (32, 64], the
    tensor cores) or 32, ``per_sm`` blocks an SM, a 64-row staged tile."""
    return fk._slab_count(-(-n // rows), -(-t // _cols(t)), m, H100_SMS, per_sm, fk._MIN_SLAB, 64)


# (t, rows a block) of every tier: 64-row blocks only in the padded tensor-core tier
TIER_ROWS = [(t, rows) for t in (1, 20, 33, 64, 100) for rows in ((128, 64) if 32 < t <= 64 else (128,))]
BLOCKS_PER_SM = [1, 2, 3, 4, 6, 8, 12, 16]


@pytest.mark.parametrize("per_sm", BLOCKS_PER_SM)
@pytest.mark.parametrize("t,rows", TIER_ROWS)
@pytest.mark.parametrize("n", [1, 100, 256, 2048])
def test_product_strips_split_over_j(n, t, rows, per_sm):
    # a serving or acquisition strip against 100k training rows fills fewer SMs than the
    # card has, so its j range is split, as far as one wave; each slab holds whole staged
    # tiles and is not empty
    slabs = _product_slabs(n, N_PATH, t, rows, per_sm)
    assert 1 < slabs <= 65535
    grid = -(-n // rows) * -(-t // _cols(t))
    assert grid * slabs <= max(per_sm * H100_SMS, grid)
    length = _slab_len(N_PATH, slabs)
    assert length >= fk._MIN_SLAB and length % 64 == 0
    assert (slabs - 1) * length < N_PATH <= slabs * length  # the last slab is not empty


@pytest.mark.parametrize("per_sm", BLOCKS_PER_SM)
@pytest.mark.parametrize("t,rows", TIER_ROWS)
def test_product_at_full_width_keeps_one_slab(t, rows, per_sm):
    # every 100k × 100k launch (training CG, the refresh's CG, Lanczos, dv) fills the card
    # alone and keeps one slab: it sums in the same order as without the split
    assert _product_slabs(N_PATH, N_PATH, t, rows, per_sm) == 1


@pytest.mark.parametrize("per_sm", [1, 4, 16])
@pytest.mark.parametrize("n,m,t", [(2048, 20_011, 1), (256, 20_011, 100), (1, 300, 1), (7, 255, 20), (2048, 0, 1)])
def test_product_slabs_bounded_by_the_least_length(per_sm, n, m, t):
    # ragged m, not a multiple of the slab length: at least _MIN_SLAB rows a slab (one slab
    # where m is shorter), whole staged tiles, grid.z within 65535
    slabs = _product_slabs(n, m, t, 128, per_sm)
    assert 1 <= slabs <= max(1, m // fk._MIN_SLAB)
    if slabs > 1:
        length = _slab_len(m, slabs)
        assert length >= fk._MIN_SLAB and length % 64 == 0 and slabs * length >= m


def _grad_x_plan(n, d, t, per_sm):
    """A plan of the kind ``gp_kernel_grad_x_plan`` reports on the card: the tensor-core tier
    (t ∈ (32, 128], d ≤ 64) on blocks of 128 rows (d = 3) or 64 (padded d) and one column
    chunk, the FMA tier on 128 rows and chunks of 32 columns (one at t = 1), the wide-d tier
    (d > 64) on 128 rows times slabs of 32 output dims; ``per_sm`` blocks an SM; a 32-row
    staged tile."""
    tc = 32 < t <= 128 and d <= 64
    rows = 64 if tc and d != 3 else 128
    chunks = 1 if t == 1 or tc else -(-t // 32)
    return -(-n // rows) * (-(-d // 32) if d > 64 else 1), chunks, per_sm, 32


@pytest.fixture
def grad_x_plan(monkeypatch):
    """``fk.grad_x_slabs`` on an H100's 132 SMs, with the C plan replaced by ``_grad_x_plan``
    at ``per_sm`` blocks an SM (the entry point is checked; the plan itself runs on a GPU)."""
    def use(per_sm):
        def plan(entry, device_index, n, d, t, kernel_type):
            assert entry == "gp_kernel_grad_x_plan" and kernel_type in KERNEL_TYPES
            return _grad_x_plan(n, d, t, per_sm)

        monkeypatch.setattr(fk, "_launch_plan", plan)
        monkeypatch.setattr(fk, "_sm_count", lambda device: H100_SMS)

    return use


# (d, t) of every grad_x tier: the FMA tier at t = 1, 20 and 129, the tensor cores at its
# edges 33, 64, 100 and 128 (d = 3 in registers, d = 11 padded), the wide-d tier at d = 100
GX_TIERS = [(d, t) for d in (3, 11) for t in (1, 20, 33, 64, 100, 128, 129)] + [(100, 1), (100, 40)]


@pytest.mark.parametrize("per_sm", [1, 2, 3, 10])
@pytest.mark.parametrize("d,t", GX_TIERS)
@pytest.mark.parametrize("n", [256, 2048])
def test_grad_x_strip_splits_within_one_wave(grad_x_plan, n, d, t, per_sm):
    # an acquisition strip (2,048 candidates, or a request of 256) against 100k training rows
    # splits its j range as far as one wave, rounded down; each slab holds whole staged tiles
    # of 32 rows, at least _MIN_SLAB of them, and none is empty
    grad_x_plan(per_sm)
    slabs = fk.grad_x_slabs(torch.device("cuda", 0), n, N_PATH, d, t, fk.RBF)
    row_blocks, chunks, _, tile = _grad_x_plan(n, d, t, per_sm)
    grid = row_blocks * chunks
    if grid >= H100_SMS:  # the wide-d tier's 2048-row strip fills the card alone
        assert slabs == 1
        return
    assert 1 <= slabs <= 65535 and grid * slabs <= max(per_sm * H100_SMS, grid)
    assert slabs > 1 or per_sm * H100_SMS < 2 * grid  # splits wherever one wave holds two slabs
    length = _slab_len(N_PATH, slabs, tile)
    assert length >= fk._MIN_SLAB and length % 32 == 0
    assert (slabs - 1) * length < N_PATH <= slabs * length  # the last slab is not empty


@pytest.mark.parametrize("per_sm", [1, 2, 3, 10])
@pytest.mark.parametrize("d,t", GX_TIERS)
def test_grad_x_training_side_keeps_one_slab(grad_x_plan, d, t, per_sm):
    # dx2, the 100k training rows against 2,048 candidates (782 row blocks of 128, or 1,563
    # of 64), fills the card alone: one slab, summed as without the split
    grad_x_plan(per_sm)
    assert fk.grad_x_slabs(torch.device("cuda", 0), N_PATH, 2048, d, t, fk.RBF) == 1


@pytest.mark.parametrize("row_blocks,chunks", [(782, 1), (132, 1), (33, 4)])
def test_slab_rule_splits_a_full_grid_only_when_asked(row_blocks, chunks):
    # a grid of at least the SM count (782 row blocks of a 100k launch, or 33 × 4 chunks)
    # keeps one slab, however many blocks an SM would hold
    assert fk._slab_count(row_blocks, chunks, N_PATH, H100_SMS, 8, 256, 64) == 1
    # grid.z is at most 65535, and slabs past m are trimmed
    assert fk._slab_count(1, 1, 65535 * 1000, H100_SMS, 10**4, 1, 1) == 65535
    assert fk._slab_count(1, 1, 300, H100_SMS, 10**4, 1, 64) == 5


@pytest.mark.parametrize("per_sm,want", [(2, 16), (3, 24)])
def test_slab_rule_rounds_down_to_one_wave(per_sm, want):
    # 16 row blocks, two blocks an SM: 16.5 slabs would fill the card, one wave holds 16;
    # three an SM: 24.75 slabs, one wave holds 24
    assert fk._slab_count(16, 1, N_PATH, H100_SMS, per_sm, 256, 64) == want


@pytest.mark.parametrize("n,t,want_ms,exps_bind", [(2048, 1, 0.04897, True), (N_PATH, 1, 2.39134, True),
                                                   (2048, 100, 0.63885, False), (N_PATH, 20, 7.31343, False)])
def test_matvec_bound_takes_the_exp_floor(n, t, want_ms, exps_bind):
    # chip_smoke.py's least time of a K·V product on the CUDA cores: at t = 1 the one exp a
    # pair on the special-function units (132 SMs × 16 a clock × 1.98 GHz) binds above the
    # 2t + 3d FP32 operations
    import chip_smoke as cs

    ms, by = cs.matvec_bound(n, N_PATH, 3, t)
    assert by == "operations" and ms == pytest.approx(want_ms, abs=5e-5)
    assert (ms == pytest.approx(cs.exp_floor_ms(n * N_PATH), rel=1e-12)) == exps_bind
