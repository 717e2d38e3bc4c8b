"""The fused MLP's dataflows in the port against the JAX package: the same
dataflow chosen for every MLP of the paper's models, and the port's
'mtiled' and 'wstat' runs (their plain version on the CPU) equal to the
JAX package's (Pallas in interpret mode).

Zero biases leave no multiply-add for XLA to contract into an FMA, so the
results must be equal bit for bit. With biases XLA may contract the
dequant ``y * c + bias`` (``repro/kernels/fused_mlp.py:59-68``), so the
comparison takes the JAX suite's own tolerance: ``rtol=1e-5`` and
``atol=1e-5 * max|ref|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_fused_mlp import _numpy_quant_chain                     # noqa: E402

from repro.core.workload import PAPER_MODELS as J_MODELS          # noqa: E402
from repro.kernels import CrossbarProgram as JProgram             # noqa: E402
from repro.kernels import build_program as jbuild                 # noqa: E402
from repro.kernels import plan_fused_mlp as jplan                 # noqa: E402
from repro.kernels import reram_mlp_fused as jfused               # noqa: E402
from repro.kernels import reram_mlp_fused_batched as jfused_b     # noqa: E402
from repro.models import pointnet2 as jpn                         # noqa: E402
from repro_torch.convert import params_from_numpy                 # noqa: E402
from repro_torch.kernels import (FUSED_MODES, CrossbarProgram,    # noqa: E402
                                 build_program, fused_mlp, plan_fused_mlp,
                                 plan_launch, reram_mlp_fused,
                                 reram_mlp_fused_batched)
from repro_torch.kernels.program import (                          # noqa: E402
    wstat_blocks_per_sm, wstat_row_groups)


def _mlps(model):
    """Every MLP of a paper model with its real rows per cloud."""
    cfg = J_MODELS[model]
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rows = [s.n_centers * s.n_neighbors for s in cfg.layers] + [1]
    return [(jbuild(jm), build_program(tm), r) for jm, tm, r in
            zip(jparams["sa"] + [jparams["head"]],
                tparams["sa"] + [tparams["head"]], rows)]


@pytest.mark.parametrize("model", ["model0", "model1", "model2"])
def test_mode_choice_equals_jax(model):
    modes = []
    for pj, pt, rows in _mlps(model):
        want = jplan(pj, rows)
        got = plan_fused_mlp(pt, rows)
        assert (got.mode, got.fits_budget, got.vmem_bytes) == (
            want.mode, want.fits_budget, want.vmem_bytes)
        assert got.block_n == want.block_n
        modes.append(got.mode)
    if model == "model2":          # SA-1 panel-bound, SA-2 N-tiled, head
        assert modes == ["mtiled", "wstat", "whole"]


def test_nothing_fits_falls_back_to_mtiled():
    # the choice reads only d_pad and the plane count: at d_pad 8192 not
    # even a 128-wide 'mtiled' tile fits the budget (no weights are made —
    # the planes are shapes only)
    d = 8192
    pj = JProgram(planes=jax.ShapeDtypeStruct((1, 4, d, d), jnp.int8),
                  bias=None, w_scale=None, col_mask=None, widths=(d, d))
    pt = CrossbarProgram(
        torch.zeros((), dtype=torch.int8).expand(1, 4, d, d),
        torch.zeros((1, d)), torch.ones((1, 1)), torch.ones((1, d)), (d, d))
    want, got = jplan(pj, 1024), plan_fused_mlp(pt, 1024)
    assert got.mode == want.mode == "mtiled"
    assert got.block_n == want.block_n == 128
    assert not got.fits_budget and not want.fits_budget
    assert got.vmem_bytes == want.vmem_bytes


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_pinned_mode_equals_jax(mode):
    rng = np.random.default_rng(1)
    layers = [{"w": rng.normal(size=(k, n)).astype(np.float32),
               "b": np.zeros(n, np.float32)}
              for k, n in ((512, 512), (512, 1024))]
    pj = jbuild([{k: jnp.asarray(v) for k, v in l.items()} for l in layers])
    pt = build_program(layers)
    want, got = jplan(pj, 2048, mode=mode), plan_fused_mlp(pt, 2048,
                                                           mode=mode)
    assert (got.mode, got.block_n, got.vmem_bytes) == (
        want.mode, want.block_n, want.vmem_bytes)


def test_launch_geometry_per_mode():
    rng = np.random.default_rng(2)
    prog = build_program([{"w": rng.normal(size=(k, n)).astype(np.float32),
                           "b": np.zeros(n, np.float32)}
                          for k, n in ((16, 256), (256, 1024))])
    # K1 keeps a 64-row int8 stripe of k_lim bytes (pitch k_lim + 16) and
    # a ring of 3 weight slabs of 128 x (64 + 16) bytes; K2 two stripes of
    # the widest k_lim and the ring, in every launch; K3 a 128-column chunk
    # of s8 weights (pitch k_lim + 16) and a ring of 4 activation slabs of
    # 64 x (64 + 16) bytes
    ring = 3 * 128 * (64 + 16)
    whole = plan_launch(prog, 8192)
    assert whole.smem_bytes == (64 * (32 + 16) + ring,
                                64 * (256 + 16) + ring)
    assert plan_launch(prog, 8192, "mtiled").smem_bytes == (
        2 * 64 * (256 + 16) + ring,) * 2
    wstat = plan_launch(prog, 8192, "wstat")
    a_ring = 4 * 64 * (64 + 16)
    assert wstat.smem_bytes == (128 * (32 + 16) + a_ring,
                                128 * (256 + 16) + a_ring)
    assert (wstat.m_pad, wstat.k_lims, wstat.n_lims) == (
        whole.m_pad, whole.k_lims, whole.n_lims)
    # at d_pad 1024 K2's stripe needs the opt-in above 48 KB
    wide = build_program([{"w": np.ones((1024, 8), np.float32),
                           "b": np.zeros(8, np.float32)}])
    assert plan_launch(wide, 1, "mtiled").smem_bytes[0] > 48 * 1024
    with pytest.raises(ValueError, match="mode"):
        plan_launch(prog, 8, "diagonal")


def test_wstat_row_groups_fill_the_card():
    # model2 SA-2's first layer: k_lim 512 leaves room for two blocks of
    # 88 KB per SM, so 4 chunks x 66 groups fill 2 x 132 slots
    smem = 128 * (512 + 16) + 4 * 64 * 80
    assert wstat_blocks_per_sm(smem) == 2
    assert wstat_row_groups(4, 256, 132, smem) == 66
    # the head's k_lim 1024: one 150 KB block per SM, and never more
    # groups than row tiles
    head = 128 * (1024 + 16) + 4 * 64 * 80
    assert wstat_blocks_per_sm(head) == 1
    assert wstat_row_groups(2, 256, 132, head) == 66
    assert wstat_row_groups(2, 8, 132, head) == 8
    assert wstat_row_groups(4096, 256, 132, smem) == 1


def _layers(widths, seed, zero_bias):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(k, n)).astype(np.float32),
             "b": (np.zeros((n,), np.float32) if zero_bias
                   else rng.normal(size=(n,)).astype(np.float32))}
            for k, n in zip(widths[:-1], widths[1:])]


def _both(layers):
    return (jbuild([{k: jnp.asarray(v) for k, v in l.items()}
                    for l in layers]),
            build_program(layers))


def _jax_kwargs(mode):
    # d_pad 256: 'wstat' takes the 128 edge by itself; 'mtiled' would keep
    # the whole edge, so pin 128 to give the JAX kernel two N-tiles
    return {"mode": mode, "block_n": 128, "interpret": True}


@pytest.mark.parametrize("zero_bias", [True, False])
@pytest.mark.parametrize("mode", ["mtiled", "wstat"])
def test_mode_equals_jax(mode, zero_bias):
    layers = _layers((130, 200, 70), 3, zero_bias)
    pj, pt = _both(layers)
    x = np.random.default_rng(4).normal(size=(300, 130)).astype(np.float32)
    ref = np.asarray(jfused(jnp.asarray(x), pj, **_jax_kwargs(mode)))
    got = reram_mlp_fused(torch.from_numpy(x), pt, mode=mode).numpy()
    assert got.shape == ref.shape == (300, 70)
    if zero_bias:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("mode", ["mtiled", "wstat"])
def test_batched_mode_equals_jax(mode):
    layers = _layers((130, 200, 70), 5, zero_bias=True)
    pj, pt = _both(layers)
    x = np.random.default_rng(6).normal(size=(2, 150, 130))
    x = (x * np.array([1.0, 0.1]).reshape(2, 1, 1)).astype(np.float32)
    ref = np.asarray(jfused_b(jnp.asarray(x), pj, **_jax_kwargs(mode)))
    got = reram_mlp_fused_batched(torch.from_numpy(x), pt, mode=mode).numpy()
    assert got.shape == ref.shape == (2, 150, 70)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("scale", [1.0, 10.0])
def test_batched_equals_numpy_oracle(scale):
    # Under jit, XLA on the CPU divides by a scale computed in the same
    # computation as a multiply by its reciprocal, so the JAX package can
    # round a quotient within an ulp of .5 the other way (at scale 10 here,
    # ROADMAP queue 3). The port divides exactly, as the JAX suite's
    # correctly rounded oracle does: it must equal the oracle bit for bit.
    layers = _layers((130, 200, 70), 5, zero_bias=True)
    x = (scale * np.random.default_rng(6).normal(size=(2, 150, 130))
         ).astype(np.float32)
    got = reram_mlp_fused_batched(torch.from_numpy(x), build_program(layers),
                                  mode="wstat").numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], _numpy_quant_chain(layers, x[b]))


def test_modes_share_one_plain_version_and_reject_unknown():
    layers = _layers((8, 32, 16), 7, zero_bias=False)
    prog = build_program(layers)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 40, 8)).astype(np.float32))
    outs = [reram_mlp_fused_batched(x, prog, mode=m) for m in FUSED_MODES]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    x_p, sx = fused_mlp.prepare_input(x, prog)
    with pytest.raises(ValueError, match="mode"):
        fused_mlp.fused_mlp(x_p, sx, prog, m_real=40, mode="diagonal")
