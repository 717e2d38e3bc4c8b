"""``PlanPolicy`` in the port against the JAX package's, and the Hopper
dataflow choice the port launches.

The reference's TPU decisions are reproduced exactly: ``plan_fused_mlp``
field for field (default walk, ``PlanPolicy(hw=TPU_ROOFLINE)`` against the
reference's ``PlanPolicy()``, pinned modes and tile edges, VMEM budgets, on
plain and ECC-widened programs of every paper model), the TPU cost model's
numbers, and the ordering decisions (``predict_dma_elisions``,
``select_intra``, ``precommit``, ``build_plan``) and ``select_protection``
on the same workloads. The Hopper choice (``select_launch``) is a function
of shapes only, and the fused backends launch it unless a mode is pinned.
``compile_model(policy=)`` follows the reference's rules; its logits and
stats rows equal the reference's on the same weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro                                                       # noqa: E402
import repro_torch                                                 # noqa: E402
from repro.core.policy import PlanPolicy as JPolicy                # noqa: E402
from repro.core.workload import PAPER_MODELS as J_MODELS           # noqa: E402
from repro.core.workload import PointNetConfig as JConfig          # noqa: E402
from repro.core.workload import PointNetWorkload as JWorkload      # noqa: E402
from repro.core.workload import SALayerSpec as JSpec               # noqa: E402
from repro.kernels import CrossbarProgram as JProgram             # noqa: E402
from repro.kernels import build_program as jbuild                  # noqa: E402
from repro.kernels import plan_fused_mlp as jplan                  # noqa: E402
from repro.models import pointnet2 as jpn                          # noqa: E402
from repro.reliability import DesignPoint as JPoint                # noqa: E402
from repro_torch.convert import params_from_numpy                  # noqa: E402
from repro_torch.core.energy import (DEFAULT_ROOFLINE,             # noqa: E402
                                     TPU_ROOFLINE, RooflineParams)
from repro_torch.core.policy import (DEFAULT_POLICY,               # noqa: E402
                                     HOPPER_MODES, PlanPolicy)
from repro_torch.core.workload import (PAPER_MODELS,               # noqa: E402
                                       PointNetConfig, PointNetWorkload,
                                       SALayerSpec)
from repro_torch.kernels import (FUSED_MODES, CrossbarProgram,    # noqa: E402
                                 build_program, launch_bytes, launch_count,
                                 launch_work, plan_fused_mlp, plan_launch)
from repro_torch.kernels.program import mtiled_on_chip             # noqa: E402
from repro_torch.models import pointnet2 as tpn                    # noqa: E402
from repro_torch.reliability import DesignPoint, EccConfig         # noqa: E402
from repro_torch.reliability.ecc import (hamming_r,                # noqa: E402
                                         protect_program)

TPU = PlanPolicy(hw=TPU_ROOFLINE)


def tiny_config(cfg_cls, spec_cls):
    return cfg_cls(name="tiny", n_points=64, layers=(
        spec_cls(n_centers=24, n_neighbors=4, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=8, n_neighbors=4, in_features=16,
                 mlp=(16, 16, 16, 32))))


def _program(widths, seed=0, scale=1.0):
    """The port's program of an MLP of ``widths``, random weights."""
    rng = np.random.default_rng(seed)
    return build_program([{"w": scale * rng.normal(size=(k, n)).astype(
        np.float32), "b": np.zeros(n, np.float32)}
        for k, n in zip(widths[:-1], widths[1:])])


def _ecc_d_pad(widths, group):
    """``d_pad`` of an MLP of ``widths`` protected at ``group``
    (``protect_program``'s widening; the reliability tests hold it to the
    reference's)."""
    need = max(max(n + -(-n // min(group, n)) * hamming_r(min(group, n))
                   for n in widths[1:]), -(-max(widths) // 128) * 128)
    return -(-need // 128) * 128


def _shape_programs(widths_list, ecc=None):
    """Both packages' programs for MLPs of the given widths, as shapes
    only (the dataflow choice reads ``d_pad`` and the plane count), plain
    or at the ``d_pad`` ECC at group ``ecc`` widens them to."""
    out = []
    for widths in widths_list:
        d = (-(-max(widths) // 128) * 128 if ecc is None
             else _ecc_d_pad(widths, ecc))
        n_layers = len(widths) - 1
        shape = (n_layers, 4, d, d)
        pj = JProgram(planes=jax.ShapeDtypeStruct(shape, jnp.int8),
                      bias=None, w_scale=None, col_mask=None,
                      widths=tuple(widths))
        pt = CrossbarProgram(torch.zeros((), dtype=torch.int8).expand(shape),
                             torch.zeros((n_layers, d)),
                             torch.ones((n_layers, 1)),
                             torch.ones((n_layers, d)), widths)
        out.append((pj, pt))
    return out


#: Every MLP of the paper's models with its real rows per cloud.
PAPER_MLPS = [(spec.mlp, spec.n_centers * spec.n_neighbors)
              for m in ("model0", "model1", "model2")
              for spec in PAPER_MODELS[m].layers] + [
    ((PAPER_MODELS[m].layers[-1].out_features, 256, 40), 1)
    for m in ("model0", "model1", "model2")]


@pytest.fixture(scope="module", params=[None, 16, 4],
                ids=["plain", "ecc16", "ecc4"])
def paper_programs(request):
    progs = _shape_programs([w for w, _ in PAPER_MLPS], ecc=request.param)
    return [(pj, pt, rows) for (pj, pt), (_, rows) in zip(progs, PAPER_MLPS)]


def _asdict_equal(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("tiled", "fits_budget", "n_steps", "m_steps",
                 "plane_tile_fetches_per_layer", "plane_hbm_bytes_per_layer",
                 "act_hbm_bytes_per_layer"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("scale", [1, 8, 64])
def test_plan_fused_mlp_equals_jax_field_for_field(paper_programs, scale):
    for pj, pt, rows in paper_programs:
        assert pt.d_pad == pj.d_pad
        _asdict_equal(plan_fused_mlp(pt, rows * scale), jplan(pj, rows * scale))
        _asdict_equal(plan_fused_mlp(pt, rows * scale, policy=TPU),
                      jplan(pj, rows * scale, policy=JPolicy()))


@pytest.mark.parametrize("mode", FUSED_MODES)
def test_plan_fused_mlp_pinned_mode_equals_jax(paper_programs, mode):
    for pj, pt, rows in paper_programs:
        _asdict_equal(plan_fused_mlp(pt, rows, mode=mode),
                      jplan(pj, rows, mode=mode))


@pytest.mark.parametrize("kw", [
    {"block_n": 128}, {"block_k": 128}, {"block_m": 64},
    {"vmem_budget": 4 * 2 ** 20}, {"vmem_budget": 1},
    {"mode": "wstat", "block_n": 128}, {"mode": "tiled", "block_k": 256},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_plan_fused_mlp_pins_equal_jax(kw):
    (pj, pt), = _shape_programs([(512, 512, 512, 1024)])
    for rows in (1, 2048, 3072, 16384):
        _asdict_equal(plan_fused_mlp(pt, rows, **kw), jplan(pj, rows, **kw))
        _asdict_equal(plan_fused_mlp(pt, rows, policy=TPU, **kw),
                      jplan(pj, rows, policy=JPolicy(), **kw))


@pytest.mark.parametrize("kw", [{"block_n": 100}, {"block_k": 384},
                                {"block_m": 12}, {"mode": "diagonal"},
                                {"mode": "whole", "block_n": 128}])
def test_plan_fused_mlp_rejects_what_jax_rejects(kw):
    (pj, pt), = _shape_programs([(512, 512, 512, 1024)])
    with pytest.raises(ValueError) as want:
        jplan(pj, 2048, **kw)
    with pytest.raises(ValueError) as got:
        plan_fused_mlp(pt, 2048, **kw)
    assert str(got.value) == str(want.value)


def test_tpu_cost_model_equals_jax():
    (pj, pt), = _shape_programs([(512, 512, 512, 1024)])
    for rows in (1, 2048, 3072, 16384):
        a, b = jplan(pj, rows), plan_fused_mlp(pt, rows)
        for n in (1, 3):
            assert TPU.predict_hbm_bytes(b, n_layers=n) == \
                JPolicy().predict_hbm_bytes(a, n_layers=n)
            assert TPU.predict_compute_cycles(b, n_layers=n) == \
                JPolicy().predict_compute_cycles(a, n_layers=n)
            assert TPU.fused_cost(b, n_layers=n) == \
                JPolicy().fused_cost(a, n_layers=n)
        _asdict_equal(TPU.select_fused_plan(pt, rows),
                      JPolicy().select_fused_plan(pj, rows))
    assert TPU.vmem_budget == JPolicy().vmem_budget
    assert PlanPolicy().vmem_budget == DEFAULT_ROOFLINE.vmem_bytes


# ---------------------------------------------------------------------------
# the Hopper choice
# ---------------------------------------------------------------------------

def test_ecc_widening_of_the_shape_programs():
    for widths, group in (((24, 48, 130, 10), 16), ((16, 120, 64), 4),
                          ((40, 40), 1), ((512, 512, 512, 1024), 4)):
        assert protect_program(_program(widths), EccConfig(group)).d_pad \
            == _ecc_d_pad(widths, group)


def test_select_launch_is_the_least_predicted_cost():
    for pj, pt in _shape_programs([w for w, _ in PAPER_MLPS]):
        rows = 2048
        for batch in (1, 8):
            geom = DEFAULT_POLICY.select_launch(pt, rows, batch=batch)
            costs = [DEFAULT_POLICY.launch_cost(pt, rows, m, batch=batch)
                     for m in HOPPER_MODES]
            first_best = HOPPER_MODES[costs.index(min(costs))]
            assert geom.mode == first_best
            assert geom == plan_launch(pt, rows, geom.mode)


def test_select_launch_is_a_function_of_shapes_only():
    widths = (16, 256, 256, 512)
    a, b = _program(widths), _program(widths, seed=9, scale=5.0)
    for rows in (1, 100, 8192):
        for batch in (1, 8):
            assert DEFAULT_POLICY.select_launch(a, rows, batch=batch) == \
                DEFAULT_POLICY.select_launch(b, rows, batch=batch)


def test_select_launch_skips_k2_where_its_stripes_do_not_fit():
    # the widest input 2100 bytes: K2's two stripes pass a block's shared
    # memory, and 'mtiled' would run K1 — it is not a candidate
    (_, pt), = _shape_programs([(2100, 2080, 40)])
    assert not mtiled_on_chip(plan_launch(pt, 200, "mtiled"))
    chosen = {PlanPolicy(hw=dataclasses.replace(
        DEFAULT_ROOFLINE, hbm_gbps=g)).select_launch(pt, 200).mode
        for g in (1.0, 3350.0, 1e9)}
    assert "mtiled" not in chosen


def test_hopper_byte_model_counts_what_each_kernel_moves():
    pt = _program((16, 256, 256, 512))
    rows, batch = 8192, 8
    geom = plan_launch(pt, rows, "whole")
    r = batch * geom.m_pad
    pre = sum(5 * k * n for k, n in zip(geom.k_lims, geom.n_lims))
    w = [k * n + 8 * n for k, n in zip(geom.k_lims, geom.n_lims)]
    # K1: int8 input, then float32 panels in and out
    assert launch_bytes(pt, rows, "whole", batch=batch) == pre + sum(w) + (
        r * 32 + 4 * r * 256) + (4 * r * 256 + 4 * r * 256) + (
        4 * r * 256 + 4 * r * 512)
    # K2: the int8 input and the weights so far in each launch, the output
    # once
    assert launch_bytes(pt, rows, "mtiled", batch=batch) == pre + 3 * r * 32 \
        + w[0] + (w[0] + w[1]) + sum(w) + 4 * r * 512
    # K3: K1's bytes, plus each later layer's snapshot written and read
    assert launch_bytes(pt, rows, "wstat", batch=batch) == launch_bytes(
        pt, rows, "whole", batch=batch) + 2 * (2 * r * 256)
    assert [launch_count(pt, m) for m in ("whole", "mtiled", "wstat")] == \
        [4, 4, 6] == [len(launch_work(pt, rows, m, batch=batch))
                      for m in ("whole", "mtiled", "wstat")]
    # what a block of each launch does: 64-byte slabs of a 128-column
    # chunk, 64 x 128 epilogues, float32 inputs requantized on load
    tiles = r // 64
    k1 = launch_work(pt, rows, "whole", batch=batch)
    assert [(w.blocks, w.slabs, w.tiles, w.requant) for w in k1] == [
        (0, 0, 0, 0), (2 * tiles, 1, 1, 0), (2 * tiles, 4, 1, 64 * 256),
        (4 * tiles, 4, 1, 64 * 256)]
    k2 = launch_work(pt, rows, "mtiled", batch=batch)
    assert [(w.blocks, w.slabs, w.tiles) for w in k2[1:]] == [
        (tiles, 2, 2), (tiles, 2 + 8, 4), (tiles, 2 + 8 + 16, 8)]
    k3 = launch_work(pt, rows, "wstat", batch=batch)
    # two blocks an SM, 132 SMs: 264 blocks, 132 row groups a 2-chunk layer
    assert [w.blocks for w in k3] == [0, 2 * 132, 0, 2 * 132, 0, 4 * 66]
    assert [w.slabs for w in k3 if w.blocks] == [
        -(-tiles // 132) * 1, -(-tiles // 132) * 4, -(-tiles // 66) * 4]


def test_launch_cost_sums_each_launch_time():
    (_, pt), = _shape_programs([(512, 512, 512, 1024)])
    hw = RooflineParams(hbm_gbps=1.0, freq_ghz=1.0, sms=4,
                        launch_cycles=7.0, slab_cycles=3.0,
                        tile_cycles=5.0, requant_cycles=0.5,
                        block_overlap=2.0)
    pol = PlanPolicy(hw=hw)
    for mode in HOPPER_MODES:
        for rows, batch in ((64, 1), (2048, 8)):
            want = 0.0
            for w in launch_work(pt, rows, mode, batch=batch, sms=4):
                block = 3.0 * w.slabs + 5.0 * w.tiles + 0.5 * w.requant
                busy = block * max(1.0, -(-w.blocks // 4) / 2.0)
                want += 7.0 + max(w.bytes, busy)
            assert pol.launch_cost(pt, rows, mode, batch=batch) == want


def test_the_h100_choice_at_the_paper_mlps():
    """The default policy, its constants fitted to the kernels' device
    times on the card: K3 at every MLP of model2 and at every head, K1 at
    model0's SA layers, K2 nowhere."""
    chosen = {}
    for (widths, rows), (_, pt) in zip(PAPER_MLPS, _shape_programs(
            [w for w, _ in PAPER_MLPS])):
        for batch in (1, 8):
            chosen[widths, batch] = DEFAULT_POLICY.select_launch(
                pt, rows, batch=batch).mode
    assert "mtiled" not in chosen.values()
    for m, want in (("model2", "wstat"), ("model0", "whole")):
        for spec in PAPER_MODELS[m].layers:
            assert {chosen[spec.mlp, b] for b in (1, 8)} == {want}
    assert {v for (w, _), v in chosen.items() if w[-1] == 40} == {"wstat"}


# ---------------------------------------------------------------------------
# the ordering decisions and the protection decision
# ---------------------------------------------------------------------------

def clustered_cloud(seed=0, n_clusters=8, per_cluster=32):
    rng = np.random.default_rng(seed)
    ctrs = rng.normal(size=(n_clusters, 3)) * 4.0
    return np.concatenate(
        [c + 0.25 * rng.normal(size=(per_cluster, 3)) for c in ctrs])


@pytest.fixture(scope="module")
def workloads():
    """Three workloads in both packages: the tiny config on a clustered
    and a Gaussian cloud, and model0's surface workload."""
    out = []
    cfg_j, cfg_t = (tiny_config(JConfig, JSpec),
                    tiny_config(PointNetConfig, SALayerSpec))
    for cloud in (clustered_cloud()[:64],
                  np.random.default_rng(2).normal(size=(64, 3))):
        out.append((JWorkload.build(cloud, cfg_j),
                    PointNetWorkload.build(cloud, cfg_t)))
    out.append((JWorkload.random(J_MODELS["model0"], seed=0),
                PointNetWorkload.random(PAPER_MODELS["model0"], seed=0)))
    return out


@pytest.mark.parametrize("window", [1, 72])
def test_predict_dma_elisions_equal_jax(workloads, window):
    for jwl, twl in workloads:
        for intra in ("index", "greedy", "morton"):
            for coordinated in (False, True):
                assert PlanPolicy().predict_dma_elisions(
                    twl, intra=intra, coordinated=coordinated,
                    window=window) == JPolicy().predict_dma_elisions(
                    jwl, intra=intra, coordinated=coordinated,
                    window=window)


@pytest.mark.parametrize("candidates", [("index", "greedy", "morton"),
                                        ("morton", "index"), ("greedy",)])
def test_ordering_decisions_equal_jax(workloads, candidates):
    jp, tp = (JPolicy(intra_candidates=candidates),
              PlanPolicy(intra_candidates=candidates))
    for jwl, twl in workloads:
        assert tp.select_intra(twl) == jp.select_intra(jwl)
        assert tp.precommit(twl).intra_candidates == \
            jp.precommit(jwl).intra_candidates
        got, want = tp.build_plan(twl), jp.build_plan(jwl)
        assert (got.intra, got.coordinated) == (want.intra, want.coordinated)
        assert all(np.array_equal(got.order_of(k), want.order_of(k))
                   for k in range(1, twl.n_layers + 1))


@pytest.mark.parametrize("target", [None, 0.5, 0.9, 0.99])
def test_select_protection_equals_jax(target):
    rows = [(0.0, "none", 1.0, 2e-6, 10), (0.05, "none", 0.6, 2e-6, 10),
            (0.05, "ecc", 0.95, 3e-6, 12), (0.05, "ecc", 0.95, 3e-6, 11),
            (0.12, "ecc", 0.9, 2.5e-6, 12)]
    got = PlanPolicy(reliability_target=target).select_protection(
        [DesignPoint(*r) for r in rows])
    want = JPolicy(reliability_target=target).select_protection(
        [JPoint(*r) for r in rows])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_select_protection_errors_equal_jax():
    pts = [DesignPoint(0.1, "none", 0.5, 1e-6, 4)]
    with pytest.raises(ValueError, match="at least one"):
        PlanPolicy().select_protection([])
    with pytest.raises(ValueError, match="reliability_target=0.9"):
        PlanPolicy(reliability_target=0.9).select_protection(pts)


# ---------------------------------------------------------------------------
# compile_model(policy=) and the backends
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg_j = tiny_config(JConfig, JSpec)
    cfg_t = tiny_config(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j, n_classes=10)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    return cfg_j, cfg_t, jparams, tparams, clouds


def test_policy_compile_follows_the_references_rules(setup):
    cfg_j, cfg_t, jparams, tparams, clouds = setup
    pol = PlanPolicy()
    m = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                  policy=pol, device="cpu")
    jm = repro.compile_model(jparams, cfg_j, policy=JPolicy())
    assert m.schedule == jm.schedule == {"intra": "auto",
                                         "coordinated": True}
    assert m.policy is pol and m.stats()["policy"] is pol
    assert not m.device_planning and not jm.device_planning
    with pytest.raises(TypeError, match="precommit the policy"):
        m.jit_batched_forward(clouds)
    with pytest.raises(TypeError, match="PlanPolicy"):
        repro_torch.compile_model(tparams, cfg_t, policy="pointer",
                                  device="cpu")
    with pytest.raises(ValueError, match="precommit"):
        repro_torch.compile_model(tparams, cfg_t, policy=pol,
                                  device_planning=True, device="cpu")
    pinned = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                       schedule="pointer", policy=pol,
                                       device="cpu")
    assert pinned.schedule == {"intra": "greedy", "coordinated": True}
    assert pinned.device_planning


def test_policy_logits_equal_jax_and_pointer(setup):
    cfg_j, cfg_t, jparams, tparams, clouds = setup
    wl = PointNetWorkload.build(clouds[0].astype(np.float64), cfg_t)
    jwl = JWorkload.build(clouds[0].astype(np.float64), cfg_j)
    pre = PlanPolicy().precommit(wl)
    assert pre.intra_candidates == JPolicy().precommit(jwl).intra_candidates
    host = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                     policy=PlanPolicy(), device="cpu")
    dev = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                    policy=pre, device="cpu")
    assert dev.device_planning and dev._resolved_intra() == \
        pre.intra_candidates[0]
    ref = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                    schedule="pointer", device="cpu")
    want = ref.batched_forward(clouds)
    assert torch.equal(host.batched_forward(clouds), want)
    assert torch.equal(dev.batched_forward(clouds), want)
    assert torch.equal(dev.jit_batched_forward(clouds), want)
    assert torch.equal(dev.forward(clouds[0]), want[0])
    jm = repro.compile_model(jparams, cfg_j, backend="reram-fused",
                             policy=JPolicy())
    assert np.array_equal(host.forward(clouds[0]).numpy(),
                          np.asarray(jm.forward(jnp.asarray(clouds[0]))))
    st, jst = host.stats(clouds[0]), jm.stats(clouds[0])
    assert st["dma"] == jst["dma"]


def test_stats_rows_equal_jax_under_the_tpu_roofline(setup):
    cfg_j, cfg_t, jparams, tparams, _ = setup
    # the rows are the reference's whatever the policy's roofline: a plain
    # PlanPolicy() (the H100's) reports the TPU rows as the reference's
    # PlanPolicy() does
    for jpol, tpol in ((JPolicy(), TPU), (JPolicy(), PlanPolicy()),
                       (JPolicy(vmem_budget=1),
                        PlanPolicy(vmem_budget=1, hw=TPU_ROOFLINE)),
                       (JPolicy(vmem_budget=1), PlanPolicy(vmem_budget=1))):
        jm = repro.compile_model(jparams, cfg_j, backend="reram-fused",
                                 policy=jpol)
        tm = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                       policy=tpol, device="cpu")
        assert tm.stats()["fused_plan"] == jm.stats()["fused_plan"]
    assert {r["mode"] for r in tm.stats()["fused_plan"].values()} == {
        "mtiled"}


def test_fused_backend_launches_the_hopper_choice(setup, monkeypatch):
    _, cfg_t, _, tparams, clouds = setup
    from repro_torch.models import backend as be
    seen = []
    real = be.reram_mlp_fused_batched
    monkeypatch.setattr(be, "reram_mlp_fused_batched",
                        lambda x, p, **kw: seen.append(kw["mode"]) or real(
                            x, p, **kw))
    slow_hbm = PlanPolicy(hw=dataclasses.replace(DEFAULT_ROOFLINE,
                                                 hbm_gbps=1e-3))
    for policy in (None, slow_hbm):
        seen.clear()
        m = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                      schedule="pointer", policy=policy,
                                      device="cpu")
        m.batched_forward(clouds)
        pol = policy or DEFAULT_POLICY
        progs = m.backend.program
        rows = [s.n_centers * s.n_neighbors for s in cfg_t.layers] + [1]
        want = [pol.select_launch(p, r, batch=len(clouds)).mode
                for p, r in zip(progs["sa"] + [progs["head"]], rows)]
        assert seen == want
        launch = m.stats()["launch_plan"]
        assert [launch[k]["mode"] for k in ("sa0", "sa1", "head")] == [
            pol.select_launch(p, r).mode
            for p, r in zip(progs["sa"] + [progs["head"]], rows)]
    for kw, mode in (({"backend": "reram-fused", "mode": "wstat"}, "wstat"),
                     ({"backend": "reram-fused-mtiled"}, "mtiled"),
                     ({"backend": "reram-fused-wstat",
                       "policy": slow_hbm}, "wstat")):
        seen.clear()
        repro_torch.compile_model(tparams, cfg_t, schedule="pointer",
                                  device="cpu", **kw).batched_forward(clouds)
        assert seen == [mode] * 3


def test_launch_plan_stats_rows(setup):
    _, cfg_t, _, tparams, _ = setup
    m = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                  device="cpu")
    rows = m.stats()["launch_plan"]
    assert set(rows) == {"sa0", "sa1", "head"}
    for name, row in rows.items():
        key, r = ("head", 1) if name == "head" else (
            ("sa", int(name[2:])), cfg_t.layers[int(name[2:])].n_centers
            * cfg_t.layers[int(name[2:])].n_neighbors)
        prog = m.backend._prog(key)
        geom = plan_launch(prog, r, row["mode"])
        assert row["smem_bytes"] == list(geom.smem_bytes)
        assert row["launches"] == launch_count(prog, row["mode"])
        assert len(row["blocks"]) == prog.n_layers
        assert row["predicted_bytes"] == launch_bytes(prog, r, row["mode"])
        assert row["predicted_cycles"] == DEFAULT_POLICY.launch_cost(
            prog, r, row["mode"])
        assert row["kernel"] == {"whole": "K1", "mtiled": "K2",
                                 "wstat": "K3"}[row["mode"]]


# ---------------------------------------------------------------------------
# the module-level delegates
# ---------------------------------------------------------------------------

def _float_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("schedule", ["pointer"])
def test_module_delegates_equal_jax(setup, schedule):
    cfg_j, cfg_t, jparams, tparams, clouds = setup
    cloud = clouds[0]
    _float_close(tpn.forward(tparams, cfg_t, cloud, schedule=schedule,
                             device="cpu"),
                 jpn.forward(jparams, cfg_j, jnp.asarray(cloud),
                             schedule=schedule))
    got = tpn.batched_forward(tparams, cfg_t, clouds, schedule=schedule,
                              device="cpu")
    _float_close(got[0], jpn.forward(jparams, cfg_j, jnp.asarray(clouds[0]),
                                     schedule=schedule))
    labels = np.array([1, 2, 3])
    nll, acc = tpn.loss_fn(tparams, cfg_t, clouds, labels,
                           schedule=schedule, device="cpu")
    jnll, jacc = jpn.loss_fn(jparams, cfg_j, jnp.asarray(clouds),
                             jnp.asarray(labels), schedule=schedule)
    assert abs(float(nll) - float(jnll)) <= 1e-5 * abs(float(jnll))
    assert float(acc) == float(jacc)
    enll, eacc = tpn.eval_step(tparams, cfg_t, clouds, labels,
                               schedule=schedule, device="cpu")
    assert float(enll) == float(nll) and float(eacc) == float(acc)


def test_eval_step_delegate_runs_loss_fn_eagerly(setup, monkeypatch):
    """The delegate compiles anew on every call, so it captures nothing:
    it is ``loss_fn`` without autograd, never the compiled model's captured
    ``eval_step``."""
    _, cfg_t, _, tparams, clouds = setup
    from repro_torch.models.backend import CompiledModel

    def captured(*args, **kwargs):
        raise AssertionError("the delegate reached a captured eval_step")
    monkeypatch.setattr(CompiledModel, "eval_step", captured)
    labels = np.array([1, 2, 3])
    nll, acc = tpn.eval_step(tparams, cfg_t, clouds, labels,
                             schedule="pointer", device="cpu")
    want = tpn.loss_fn(tparams, cfg_t, clouds, labels, schedule="pointer",
                       device="cpu")
    assert not nll.requires_grad
    assert torch.equal(nll, want[0]) and torch.equal(acc, want[1])


def test_module_delegates_take_a_policy(setup):
    _, cfg_t, _, tparams, clouds = setup
    pol = PlanPolicy()
    want = tpn.batched_forward(tparams, cfg_t, clouds, schedule="pointer",
                               device="cpu")
    got = tpn.batched_forward(tparams, cfg_t, clouds, policy=pol,
                              device="cpu")
    assert torch.equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpn.forward(tparams, cfg_t, clouds[0])


def test_sa_layer_equals_jax(setup):
    cfg_j, cfg_t, jparams, tparams, clouds = setup
    pts = clouds[0]
    feats = tpn.lift_features(torch.from_numpy(pts), 4)
    c_pts, out = tpn.sa_layer(tparams["sa"][0], cfg_t.layers[0],
                              torch.from_numpy(pts), feats)
    jc, jout = jpn.sa_layer(jparams["sa"][0], cfg_j.layers[0],
                            jnp.asarray(pts), jnp.asarray(feats.numpy()))
    assert np.array_equal(c_pts.numpy(), np.asarray(jc))
    _float_close(out, jout)
