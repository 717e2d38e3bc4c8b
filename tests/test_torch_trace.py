"""The port's launch-contract verifier (``repro_torch.analysis``) against
the JAX package's ``repro.analysis.trace`` on the same tiny models.

Two obligations, as in ``tests/test_static_trace.py``:
  * on the real compiled models (float / reram-fused, planning on the
    device, 'baseline', planning on the host; one cloud and a batch) the
    port's report gives the reference's verdict: ``ok``, the violated
    contracts and their layers, and the gather and MLP launch counts;
  * a seeded regression of each contract class (an extra gather, a
    missing one, a per-cloud gather in a batched call, an ``.item()``
    inside the call, a float64 cast, a shared-memory budget) is caught,
    naming the kernel or op and the layer.

The reference's verifier walks ``jax.core.ClosedJaxpr`` and
``jax.core.Jaxpr``, which the installed JAX keeps in ``jax.extend.core``
only; a fixture lends them back to ``jax.core`` for each test here
(nothing in the JAX package changes).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro                                                        # noqa: E402
from repro.analysis import verify_contracts as jverify              # noqa: E402
from repro.core.workload import PointNetConfig as JConfig           # noqa: E402
from repro.core.workload import SALayerSpec as JSpec                # noqa: E402
from repro.models import pointnet2 as jpn                           # noqa: E402
import repro_torch                                                  # noqa: E402
from repro_torch.analysis import (CONTRACTS, ContractViolation,     # noqa: E402
                                  trace_info, verify_contracts)
from repro_torch.convert import params_from_numpy                   # noqa: E402
from repro_torch.core.workload import PointNetConfig, SALayerSpec   # noqa: E402
from repro_torch.kernels import (aggregate_diff_batched,            # noqa: E402
                                 launch_counts, reram_linear,
                                 reset_launch_counts)
from repro_torch.kernels.program import quantize_tensor             # noqa: E402
from repro_torch.kernels.record import as_captured, recording       # noqa: E402


def _tiny(cfg_cls, spec_cls):
    return cfg_cls(name="tiny", n_points=64, layers=(
        spec_cls(n_centers=24, n_neighbors=4, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=8, n_neighbors=4, in_features=16,
                 mlp=(16, 16, 16, 32))))


@pytest.fixture(autouse=True)
def _jax_core_names(monkeypatch):
    import jax.extend.core as jec
    for name in ("ClosedJaxpr", "Jaxpr"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(jec, name),
                                raising=False)


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = _tiny(JConfig, JSpec), _tiny(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j, n_classes=10)
    tparams = params_from_numpy(jax.device_get(jparams))
    cloud = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    return cfg_j, cfg_t, jparams, tparams, cloud


MODES = {"device": dict(schedule="pointer", device_planning=True),
         "baseline": dict(schedule="baseline"),
         "host": dict(schedule="pointer", device_planning=False)}


def _models(setup, backend, mode):
    cfg_j, cfg_t, jparams, tparams, _ = setup
    return (repro.compile_model(jparams, cfg_j, backend=backend,
                                **MODES[mode]),
            repro_torch.compile_model(tparams, cfg_t, backend=backend,
                                      device="cpu", **MODES[mode]))


def device_model(setup, backend):
    return _models(setup, backend, "device")[1]


def _verdict(report) -> dict:
    info = report.info
    return {"ok": report.ok,
            "violations": sorted((v.contract, v.layer)
                                 for v in report.violations),
            "gathers": None if info is None else info.gather_launches,
            "mlps": None if info is None else info.mlp_launches}


def _x(cloud, batched):
    return np.stack([cloud, cloud * 0.5, cloud - 0.2]) if batched else cloud


class _Proxy:
    """A CompiledModel stand-in whose forward/batched_forward are replaced
    (how the regressions inject contract breakage)."""

    def __init__(self, model, forward=None, batched_forward=None):
        self.forward = forward if forward is not None else model.forward
        self.batched_forward = (batched_forward if batched_forward
                                is not None else model.batched_forward)
        self.config = model.config
        self.backend = model.backend
        self.backend_name = model.backend_name
        self.schedule = model.schedule
        self.planned = model.planned
        self.device = model.device


# ---------------------------------------------------------------------------
# the reference's verdicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["cloud", "batch"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("backend", ["float", "reram-fused"])
def test_verdict_equals_the_reference(setup, backend, mode, batched):
    jm, tm = _models(setup, backend, mode)
    x = _x(setup[4], batched)
    want = jverify(jm, jnp.asarray(x))
    got = verify_contracts(tm, x)
    assert _verdict(got) == _verdict(want)
    mlps = lambda rows: {r.partition("@")[0] for r in rows}   # noqa: E731
    assert mlps(got.smem_rows) == mlps(want.vmem_rows)
    if batched and got.info is not None and tm.planned:
        shapes = [l.out_shape[0] for l in got.info.launches_of(
            "gather-batched")]
        assert shapes == [l.out_shape[0] for l in want.info.launches_of(
            "gather-batched")] == [3, 3]


@pytest.mark.parametrize("expected", [1, 3])
def test_gather_count_regression_equals_the_reference(setup, expected):
    jm, tm = _models(setup, "float", "device")
    want = jverify(jm, jnp.asarray(setup[4]),
                   expected_gather_launches=expected)
    got = verify_contracts(tm, setup[4], expected_gather_launches=expected)
    assert _verdict(got) == _verdict(want)
    assert [v.primitive for v in got.violations] == \
        [v.primitive for v in want.violations]


# ---------------------------------------------------------------------------
# the real models honor their contracts
# ---------------------------------------------------------------------------

class TestContractsHold:
    @pytest.mark.parametrize("backend", ["float", "reram-fused", "reram"])
    def test_device_planned_forward_and_batched(self, setup, backend):
        m = device_model(setup, backend)
        for batched in (False, True):
            report = verify_contracts(m, _x(setup[4], batched))
            report.raise_if_violated()
            assert report.info.gather_launches == m.config.n_layers
            assert report.info.host_callbacks == ()
            assert report.info.f64_primitives == ()
            assert len(report.info.launches_of("geometry")) == 2
            assert len(report.info.launches_of("plan")) == 2

    def test_batched_gathers_carry_the_full_batch(self, setup):
        m = device_model(setup, "reram-fused")
        report = verify_contracts(m, np.stack([setup[4]] * 4))
        report.raise_if_violated()
        recs = report.info.launches_of("gather-batched")
        assert len(recs) == m.config.n_layers
        assert all(r.out_shape[0] == 4 and r.dtype == "float32"
                   for r in recs)
        assert report.info.launches_of("gather") == []

    def test_fused_backend_one_mlp_launch_per_layer_plus_head(self, setup):
        m = device_model(setup, "reram-fused")
        report = verify_contracts(m, np.stack([setup[4]] * 2))
        report.raise_if_violated()
        assert report.info.mlp_launches == m.config.n_layers + 1
        assert all(l.name.startswith("reram_mlp_fused_")
                   for l in report.info.launches_of("mlp"))

    def test_per_layer_backend_records_each_product(self, setup):
        m = device_model(setup, "reram")
        report = verify_contracts(m, setup[4])
        report.raise_if_violated()     # the activation check is skipped
        assert len(report.info.launches_of("linear")) == 8
        assert report.info.mlp_launches == 0

    def test_baseline_schedule_issues_zero_gathers(self, setup):
        _, tm = _models(setup, "float", "baseline")
        report = verify_contracts(tm, setup[4])
        report.raise_if_violated()
        assert report.expected_gather_launches == 0
        assert report.info.gather_launches == 0

    def test_host_planned_model_violates_traceable_by_design(self, setup):
        _, tm = _models(setup, "reram-fused", "host")
        report = verify_contracts(tm, setup[4])
        assert not report.ok and report.info is None
        assert [v.contract for v in report.violations] == ["traceable"]

    def test_smem_rows_populated_for_fused_backend(self, setup):
        m = device_model(setup, "reram-fused")
        report = verify_contracts(m, setup[4])
        assert set(report.smem_rows) == {"sa0@96", "sa1@32", "head@1"}
        assert all(r["fits_budget"] for r in report.smem_rows.values())

    def test_summary_is_json_ready(self, setup):
        report = verify_contracts(device_model(setup, "float"), setup[4])
        assert json.loads(json.dumps(report.summary()))["ok"] is True

    def test_check_graph_needs_the_card(self, setup):
        with pytest.raises(ValueError, match="card"):
            verify_contracts(device_model(setup, "float"), setup[4],
                             check_graph=True)


# ---------------------------------------------------------------------------
# seeded regressions: each contract class must be catchable
# ---------------------------------------------------------------------------

def violations_of(report, contract):
    return [v for v in report.violations if v.contract == contract]


class TestSeededRegressions:
    def test_extra_gather_launch_is_flagged_with_layer(self, setup):
        m = device_model(setup, "float")
        nbr = torch.zeros((2, 4, 4), dtype=torch.int32)
        ctr = torch.zeros((2, 4), dtype=torch.int32)

        def leaky_batched(x):
            out = m.batched_forward(x)
            feats = torch.zeros((2, 64, out.shape[-1]))
            return out + aggregate_diff_batched(feats, nbr, ctr).sum() * 0

        report = verify_contracts(_Proxy(m, batched_forward=leaky_batched),
                                  np.stack([setup[4]] * 2))
        vs = violations_of(report, "gather-launches")
        assert vs, report.violations
        assert vs[0].primitive == "aggregate_diff_batched"
        assert vs[0].layer == m.config.n_layers

    def test_missing_gather_launch_is_flagged(self, setup):
        m = device_model(setup, "float")
        report = verify_contracts(m, setup[4], expected_gather_launches=3)
        vs = violations_of(report, "gather-launches")
        assert vs and vs[0].layer == 2     # SA layer 2 issues no gather

    def test_per_cloud_gather_in_a_batched_call_is_flagged(self, setup):
        m = device_model(setup, "reram-fused")

        def looped(x):
            return torch.stack([m.forward(c) for c in x])

        report = verify_contracts(_Proxy(m, batched_forward=looped),
                                  np.stack([setup[4]] * 2))
        vs = violations_of(report, "gather-launches")
        assert any(v.primitive == "aggregate_diff" and "per-cloud"
                   in v.message for v in vs)
        assert {v.layer for v in vs if v.primitive == "aggregate_diff"} \
            == {0, 1, 2, 3}

    def test_item_inside_the_call_is_flagged_by_op_name(self, setup):
        m = device_model(setup, "float")

        def chatty_forward(x):
            y = m.forward(x)
            return y * float(y.abs().max() > 0)

        report = verify_contracts(_Proxy(m, forward=chatty_forward),
                                  setup[4])
        vs = violations_of(report, "host-callbacks")
        assert vs and vs[0].primitive == "aten._local_scalar_dense"

    def test_f64_creep_is_flagged(self, setup):
        m = device_model(setup, "float")

        def promoted_forward(x):
            return m.forward(x).double()

        report = verify_contracts(_Proxy(m, forward=promoted_forward),
                                  setup[4])
        vs = violations_of(report, "f64")
        assert vs and "f64" in vs[0].message
        assert vs[0].primitive == "aten._to_copy"

    def test_smem_budget_breach_names_the_mlp_layer(self, setup):
        m = device_model(setup, "reram-fused")
        report = verify_contracts(m, setup[4], smem_budget=1)
        vs = violations_of(report, "smem-budget")
        assert len(vs) == len(report.smem_rows) == 3
        assert {v.layer for v in vs} == {0, 1, 2}
        assert all(v.primitive.startswith("reram_mlp_fused") for v in vs)

    def test_rule_selection_masks_contracts(self, setup):
        m = device_model(setup, "reram-fused")
        report = verify_contracts(
            m, setup[4], smem_budget=1,
            rules=tuple(c for c in CONTRACTS if c != "smem-budget"))
        assert report.ok

    def test_raise_if_violated_formats_all_violations(self, setup):
        m = device_model(setup, "reram-fused")
        report = verify_contracts(m, setup[4], smem_budget=1)
        with pytest.raises(AssertionError, match="smem-budget"):
            report.raise_if_violated()

    def test_bad_input_rank_rejected(self, setup):
        with pytest.raises(ValueError, match="cloud"):
            verify_contracts(device_model(setup, "float"), np.zeros((4,)))


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class TestTraceInfo:
    def test_counts_launches_on_the_plain_branch(self):
        feats = torch.zeros((1, 8, 4))
        nbr = torch.zeros((1, 4, 2), dtype=torch.int32)
        ctr = torch.zeros((1, 4), dtype=torch.int32)

        def two(f):
            return (aggregate_diff_batched(f, nbr, ctr),
                    aggregate_diff_batched(f, nbr, ctr))

        reset_launch_counts()
        info = trace_info(two, feats)
        assert info.gather_launches == 2
        assert all(r.name == "aggregate_diff_batched"
                   and r.out_shape == (1, 4, 2, 4) for r in info.launches)
        assert launch_counts()["aggregate_diff_batched"] == 0   # no kernel

    def test_no_kernel_means_no_launches(self):
        info = trace_info(lambda x: x * 2 + 1, torch.zeros((3,)))
        assert info.launches == ()
        assert info.host_callbacks == ()
        assert info.primitive_counts == {"aten.mul": 1, "aten.add": 1}

    def test_a_launch_inside_another_is_recorded_once(self):
        x = torch.randn(5, 8)
        w = torch.randn(8, 3)
        with recording() as log:
            reram_linear(x, w)
        assert [name for name, _, _ in log] == ["reram_matmul_int"]

    def test_as_captured_skips_the_finite_check(self):
        bad = torch.tensor([1.0, float("nan")])
        with pytest.raises(ValueError, match="NaN"):
            quantize_tensor(bad)
        with as_captured():
            quantize_tensor(bad)

    def test_violation_str_carries_primitive_and_layer(self):
        v = ContractViolation("gather-launches", "boom",
                              primitive="aggregate_diff", layer=1)
        assert "aggregate_diff" in str(v) and "layer=1" in str(v)
