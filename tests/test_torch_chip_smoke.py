"""``chip_smoke.py``'s arithmetic and its refusal to run without a card.

The script's device phases need a CUDA card; what can be held on the CPU
is the least-time bound it reports beside each kernel time, the byte and
operation counts behind it, and that it exits non-zero, printing no
result, where no card exists."""
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build_program, launch_bytes       # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_is_the_larger_of_bytes_and_operations(smoke):
    ms, by = smoke.bound(3.35e9, 1.0, smoke.INT8_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = smoke.bound(1.0, 1.979e12, smoke.INT8_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_k1_and_gather_counts(smoke):
    rng = np.random.default_rng(0)
    layers = [{"w": rng.normal(size=(k, n)).astype(np.float32),
               "b": np.zeros(n, np.float32)} for k, n in ((8, 16), (16, 4))]
    prog = build_program(layers)
    nbytes, ops = smoke._k1_bound(prog, 10)
    b = smoke.BATCH
    n_weights = 8 * 16 + 16 * 4
    assert ops == 2 * b * 10 * n_weights
    # real widths only: the padded planes (here 4 x 128 x 128 per layer)
    # are no part of the function
    assert nbytes == (b * 10 * 8 + n_weights + 4 * (2 * (16 + 4) + 2 + b)
                      + 4 * b * 10 * 4)
    assert nbytes < prog.planes.numel()
    # feature rows count once each, and only those an index refers to:
    # batch 0 refers to rows 0..6, batch 1 to rows 0 and 9
    feats = torch.zeros((2, 30, 8))
    nbr = torch.stack([torch.arange(15, dtype=torch.int32).reshape(5, 3) % 7,
                       torch.zeros((5, 3), dtype=torch.int32)])
    ctr = torch.stack([torch.arange(5, dtype=torch.int32),
                       torch.full((5,), 9, dtype=torch.int32)])
    nbytes, ops = smoke._gather_bound(feats, nbr, ctr)
    assert ops == 2 * 5 * 3 * 8
    assert nbytes == 4 * ((7 + 2) * 8 + 2 * 5 * 3 + 2 * 5 + 2 * 5 * 3 * 8)


def test_k1_k2_design_bytes(smoke):
    """The modeled device-memory bytes of K1's and K2's code: one pre-pass over
    each layer's (k_lim, n_lim); K1 a float32 panel out of every layer and
    back into the next; K2 the int8 input in every launch, the weights of
    layers 0 .. j in launch j, and the float32 output once."""
    rng = np.random.default_rng(1)
    layers = [{"w": rng.normal(size=(k, n)).astype(np.float32),
               "b": np.zeros(n, np.float32)}
              for k, n in ((16, 256), (256, 256), (256, 512))]
    prog = build_program(layers)           # model2 SA-1's widths
    b, m = smoke.BATCH, 8192
    rows = b * m
    k, n = (32, 256, 256), (256, 256, 512)
    pre = sum(5 * a * c for a, c in zip(k, n))
    w = [a * c + 8 * c for a, c in zip(k, n)]
    assert launch_bytes(prog, m, "whole", batch=b) == pre + (
        rows * 32 + w[0] + 4 * rows * 256
        + 4 * rows * 256 + w[1] + 4 * rows * 256
        + 4 * rows * 256 + w[2] + 4 * rows * 512)
    assert launch_bytes(prog, m, "mtiled", batch=b) == pre + (
        3 * rows * 32 + 3 * w[0] + 2 * w[1] + w[2] + 4 * rows * 512)
    # K2 moves about its bound: the int8 input thrice and the output once
    bound_bytes, _ = smoke._k1_bound(prog, m)
    assert launch_bytes(prog, m, "mtiled", batch=b) < 1.05 * bound_bytes
    assert launch_bytes(prog, m, "whole", batch=b) > 2.5 * bound_bytes


def test_paths_count_one_prepass_per_k1_k2_call(smoke):
    """One s8 pre-pass per K1, K2 or K3 call, and one per K6 product; the
    'reram-fused' paths count the Hopper choice of every MLP at batch 8
    (``batched_forward``) and 1 (``forward``)."""
    from repro_torch import PAPER_MODELS
    from repro_torch.core.policy import DEFAULT_POLICY
    from repro_torch.models.pointnet2 import build_model_program, init_params
    counter = {"whole": "fused_mlp", "mtiled": "fused_mlp_mtiled",
               "wstat": "fused_mlp_wstat"}
    for model, paths in smoke.PATHS.items():
        for name in ("reram-fused", "reram-fused-mtiled"):
            fused = paths.get(name)
            if fused is None:
                continue
            assert fused["fused_mlp_combine"] == (
                fused.get("fused_mlp", 0) + fused.get("fused_mlp_mtiled", 0)
                + fused.get("fused_mlp_wstat", 0))
            assert set(fused) <= set(smoke.MLP_COUNTERS)
        cfg = PAPER_MODELS[model]
        progs = build_model_program(init_params(cfg, seed=0))
        rows = [s.n_centers * s.n_neighbors for s in cfg.layers] + [1]
        want = {}
        for prog, r in zip(progs["sa"] + [progs["head"]], rows):
            for batch in (smoke.BATCH, 1):
                c = counter[DEFAULT_POLICY.select_launch(
                    prog, r, batch=batch).mode]
                want[c] = want.get(c, 0) + 1
                layer = "fused_mlp_layer" if c == "fused_mlp" else c + "_layer"
                want[layer] = want.get(layer, 0) + prog.n_layers
                want["fused_mlp_combine"] = want.get(
                    "fused_mlp_combine", 0) + 1
        assert paths["reram-fused"] == want, model
    reram = smoke.PATHS["model2"]["reram"]
    assert reram["reram_combine"] == reram["reram_matmul_int"]
    assert set(reram) <= set(smoke.MLP_COUNTERS)
    # K2 one launch per layer: 3 + 3 + 2 layers, two calls
    assert smoke.PATHS["model2"]["reram-fused-mtiled"][
        "fused_mlp_mtiled_layer"] == 16
    # a served step at every batch bucket runs the Hopper choice
    cfg = PAPER_MODELS["model2"]
    progs = build_model_program(init_params(cfg, seed=0))
    rows = [s.n_centers * s.n_neighbors for s in cfg.layers] + [1]
    for batch, step in smoke.PATHS["model2"]["serve"].items():
        want = {}
        for prog, r in zip(progs["sa"] + [progs["head"]], rows):
            c = counter[DEFAULT_POLICY.select_launch(prog, r,
                                                     batch=batch).mode]
            layer = "fused_mlp_layer" if c == "fused_mlp" else c + "_layer"
            for key, n in ((c, 1), (layer, prog.n_layers),
                           ("fused_mlp_combine", 1)):
                want[key] = want.get(key, 0) + n
        assert step == want, batch


def test_k6_counts_and_reram_layer_shapes(smoke):
    assert smoke._k6_bound(10, 16, 8) == (10 * 16 + 16 * 8 + 4 * 10 * 8,
                                          2 * 10 * 16 * 8)
    from repro_torch import PAPER_MODELS
    from repro_torch.models.pointnet2 import init_params
    cfg = PAPER_MODELS["model2"]
    shapes = smoke.reram_layer_shapes(init_params(cfg, seed=0), cfg, 8)
    # 8 layer products: SA-1 and SA-2 over all their rows, the head over
    # one row per cloud
    assert shapes == [(65536, 16, 256), (65536, 256, 256),
                      (65536, 256, 512), (16384, 512, 512),
                      (16384, 512, 512), (16384, 512, 1024),
                      (8, 1024, 256), (8, 256, 40)]
    assert smoke.PATHS["model2"]["reram"]["reram_matmul_int"] \
        == 2 * len(shapes)


def test_k7_counts(smoke):
    # points read once, indices written once; 9 float32 operations per
    # point and step
    nbytes, ops = smoke._fps_bound(8, 1024, 512)
    assert nbytes == 8 * 1024 * 12 + 8 * 512 * 8
    assert ops == 9 * 8 * 1024 * 512
    ms, by = smoke.bound(nbytes, ops, smoke.FP32_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)


def test_ptxas_registers_are_read_per_kernel(smoke):
    """The build phase reports registers per kernel, template arguments
    kept, though anonymous namespaces mangle with a per-file hash."""
    ns = "_ZN51_GLOBAL__N__48e030b8_18_fused_mlp_wstat_cu_5b1c2ad5"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}16wstat_mma_kernel"
        "ILi4ELb0EEEvPKaPfS2_PKfS5_S5_S5_Piiiiiiiiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 100 registers, used 1 barriers, 32 bytes smem",
        f"ptxas info    : Compiling entry function '{ns}16wstat_mma_kernel"
        "ILi2ELb1EEEvPKaPfS2_PKfS5_S5_S5_Piiiiiiiiiii' for 'sm_90a'",
        "ptxas info    : Used 114 registers, used 1 barriers, 32 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN4xmma22combine_weights_kernelEPKaPaPiiPKiiiiiiii' for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 1 barriers, 1056 bytes smem"])
    got = smoke._ptxas_registers(log)
    assert set(got) == {"wstat_mma_kernelILi4ELb0EE",
                        "wstat_mma_kernelILi2ELb1EE", "combine_weights_kernel"}
    assert got["wstat_mma_kernelILi4ELb0EE"][-1].startswith("Used 100 ")
    assert got["wstat_mma_kernelILi2ELb1EE"] == [
        "Used 114 registers, used 1 barriers, 32 bytes smem"]


def test_clouds_are_seeded_float32_surfaces(smoke):
    a, b = smoke.make_clouds(64, 3, 0), smoke.make_clouds(64, 3, 0)
    assert a.dtype == np.float32 and a.shape == (3, 64, 3)
    assert np.array_equal(a, b)
    assert np.abs(a).max() < 1.2


def test_exits_nonzero_without_a_card(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the script runs for real there")
    assert smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("n", [1024, 1000, 600, 512, 5])
def test_k7_tier_plans_cover_every_tier(smoke, n):
    """The plans K7 is held and timed under at the main path's shapes (and
    the ragged case's 1000 points) are ones the kernel takes, one or more
    of each tier."""
    from repro_torch.kernels.fps_update import FPS_TIERS, check_plan
    plans = smoke.fps_tier_plans(n)
    assert {p.tier for p in plans.values()} == set(FPS_TIERS)
    for plan in plans.values():
        check_plan(plan, n)
    assert {plans[f"block{t}"].threads for t in (128, 256, 512)} == {
        128, 256, 512}


def test_k7_register_check_reads_ptxas(smoke):
    """The build phase holds each K7 kernel's registers to the figure
    ``plan_fps`` counts on, refuses spills, and refuses a report that
    lacks one of the kernels (a library built elsewhere has none)."""
    ok = {name: ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                 "loads", "Used 36 registers, used 1 barriers"]
          for name in smoke.fps_kernel_names()}
    ok["fps_update_kernel"] = ["Used 21 registers"]
    smoke._check_fps_registers(ok)
    with pytest.raises(RuntimeError, match="counts on 48"):
        smoke._check_fps_registers({
            **ok, "fps_loop_kernelILi128ELi4ELb1ELb0EE": [
                "Used 50 registers, used 1 barriers"]})
    with pytest.raises(RuntimeError, match="spills"):
        smoke._check_fps_registers({
            **ok, "fps_stream_kernelILi1024ELb1EE": [
                "Used 50 registers", "0 bytes stack frame, 8 bytes spill "
                "stores, 8 bytes spill loads"]})
    del ok["fps_stream_kernelILi1024ELb0EE"]
    with pytest.raises(RuntimeError, match="no ptxas register report"):
        smoke._check_fps_registers(ok)
    with pytest.raises(RuntimeError, match="no ptxas register report"):
        smoke._check_fps_registers({})


def test_k7_kernel_names_are_the_sources_instantiations(smoke):
    """The register check expects each ``FPS_SHAPES`` pair in the block and
    cluster tiers and the streamed kernel, each with and without the
    relaxation: as many names as the source instantiates."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fps.cu").read_text()
    shapes = src[src.index("#define FPS_SHAPES"):]
    shapes = shapes[:shapes.index("\n\n")]
    pairs = re.findall(r"X\((\d+), (\d+)\)", shapes)
    names = smoke.fps_kernel_names()
    assert len(names) == 4 * len(pairs) + 2
    for t, per in pairs:
        assert f"fps_loop_kernelILi{t}ELi{per}ELb1ELb0EE" in names


def test_k7_chain_binding_matches_the_c_signature(smoke):
    """``fps_chain_run``, the measurement entry only this script binds: its
    ctypes types follow the C signature."""
    import ctypes
    import types
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fps.cu").read_text()
    sig = re.search(r"\bint fps_chain_run\(([^)]*)\)", src)
    kinds = ["ptr" if "*" in a else "i64" if a.strip().startswith("long long")
             else "int" for a in sig.group(1).split(",")]
    lib = types.SimpleNamespace(fps_chain_run=types.SimpleNamespace())
    smoke._bind_fps_chain(lib)
    want = {"ptr": ctypes.c_void_p, "i64": ctypes.c_longlong,
            "int": ctypes.c_int}
    assert lib.fps_chain_run.argtypes == [want[k] for k in kinds]
    assert kinds == ["ptr"] * 3 + ["i64"] * 3 + ["int"] * 4 + ["ptr"]


@pytest.mark.parametrize("n", [16385, 65536, 131072, 300000])
def test_k7_streamed_plans_take_the_large_clouds(smoke, n):
    """The streamed plans the cluster tier is held and timed against past
    one block are ones the kernel takes, over 8 and 16 blocks."""
    from repro_torch.kernels.fps_update import check_plan
    plans = smoke.fps_streamed_plans(n)
    assert sorted(p.cluster for p in plans.values()) == [8, 16]
    for plan in plans.values():
        check_plan(plan, n)
        assert plan.tier == "streamed"
        assert plan.threads * plan.per_thread * plan.cluster >= n


def test_gather_bound_counts_index_width_and_the_order(smoke):
    """The plan interface's gather reads int64 index-order indices and an
    int32 plan order: each at its own width, once."""
    feats = torch.zeros((2, 30, 8))
    nbr = (torch.arange(2 * 5 * 3).reshape(2, 5, 3) % 7).to(torch.int64)
    ctr = torch.zeros((2, 5), dtype=torch.int64)
    order = torch.zeros((2, 5), dtype=torch.int32)
    nbytes, ops = smoke._gather_bound(feats, nbr, ctr, order)
    rows = sum(int(torch.unique(torch.cat((nbr[i].reshape(-1), ctr[i])))
                   .numel()) for i in range(2))
    assert ops == 2 * 5 * 3 * 8
    assert nbytes == (4 * rows * 8 + 8 * 2 * 5 * 3 + 8 * 2 * 5
                      + 4 * 2 * 5 * 3 * 8 + 4 * 2 * 5)


def test_plan_bounds(smoke):
    """P1: the points in and the int32 order out once, 8 float operations
    a point and step over n - 1 steps; P2: the last order and the walked
    receptive fields in, an order and an inverse a layer out, no float
    operation: bound by bytes."""
    assert smoke._p1_bound(8, 128) == (8 * 128 * 16, 8 * 8 * 128 * 127)
    ms, by = smoke.bound(*smoke._p1_bound(8, 128), smoke.FP32_OPS_PER_S)
    assert by == "operations"
    nbrs = [torch.zeros((8, 512, 16), dtype=torch.int64),
            torch.zeros((8, 128, 16), dtype=torch.int64)]
    last = torch.zeros((8, 128), dtype=torch.int32)
    nbytes, ops = smoke._p2_bound(nbrs, last)
    assert ops == 0
    assert nbytes == 8 * 128 * 4 + 8 * 128 * 16 * 8 + 2 * 4 * 8 * (512 + 128)
    assert smoke.bound(nbytes, ops, smoke.FP32_OPS_PER_S)[1] == "bytes"


def test_profiled_kernel_names_are_the_sources(smoke):
    """The names the script looks for in ``torch.profiler``'s rows (the
    port's kernels, and those a captured call must replay) are kernels
    the CUDA sources define."""
    from repro_torch.kernels import _build
    src = "".join(p.read_text() for p in _build.CSRC.glob("*.cu*"))
    for name in smoke.CAPTURED_KERNELS:
        assert re.search(rf"\b{name}\b", src), name
    for name in smoke.PORT_KERNELS:
        assert name in src, name
    assert set(smoke.CAPTURED_KERNELS) >= {"greedy_kernel",
                                           "coordinate_kernel"}


def test_tie_clouds_are_seeded_and_tie_heavy(smoke):
    kinds = smoke._cloud_kinds(0)
    assert set(kinds) == {"clustered", "grid", "dup"}
    for name, c in kinds.items():
        assert c.shape == (2, 1024, 3) and c.dtype == np.float32, name
        assert np.array_equal(c, smoke._cloud_kinds(0)[name])
    # the grid and the duplicated cloud repeat distances exactly
    assert np.unique(kinds["dup"][0], axis=0).shape[0] == 256
    assert np.array_equal(kinds["grid"][0], np.round(kinds["grid"][0]))


def test_oracle_plan_is_the_device_twins_plan(smoke):
    """The NumPy planner the plan phase holds P1 and P2 to gives, on the
    CPU, the device twins' plan of model1's geometry on the tie clouds."""
    from repro_torch import PAPER_MODELS
    from repro_torch.core.schedule import device_build_plan
    from repro_torch.models import pointnet2 as pn
    cfg = PAPER_MODELS["model1"]
    for name, clouds in smoke._cloud_kinds(3).items():
        pts, _, nbr = pn.geometry_pass(cfg, torch.from_numpy(clouds[:1]))
        plan = device_build_plan(nbr[1:], pts[-1], intra="greedy",
                                 coordinated=True)
        want = smoke._oracle_plan(cfg, pts[-1][0].numpy(),
                                  [nb[0].numpy() for nb in nbr[1:]])
        for k in (1, 2):
            np.testing.assert_array_equal(plan.order_of(k)[0].numpy(),
                                          want[k - 1])


def test_served_path_counts_are_the_batched_half(smoke):
    """One served step is one ``batched_forward`` at its batch bucket: the
    batch-1 and batch-8 steps together count what the 'reram-fused' path
    (a ``forward`` and a batch-8 ``batched_forward``) counts, one pre-pass
    per MLP call; the kernels the serve phase must see launched are rows
    of the kernels line and counters of the port."""
    from repro_torch.kernels import launch_counts
    fused, serve = (smoke.PATHS["model2"]["reram-fused"],
                    smoke.PATHS["model2"]["serve"])
    assert set(serve) == set(smoke.SERVE_BUCKETS["batch"])
    assert {k: serve[1].get(k, 0) + serve[smoke.BATCH].get(k, 0)
            for k in fused} == fused
    for step in serve.values():
        assert step["fused_mlp_combine"] == (step.get("fused_mlp", 0)
                                             + step.get("fused_mlp_mtiled", 0)
                                             + step.get("fused_mlp_wstat", 0))
    assert set(smoke.SERVE_KERNELS.values()) <= set(launch_counts())
    assert {"K5 aggregate_diff", "K6 reram_matmul_int"}.isdisjoint(
        smoke.SERVE_KERNELS)


def test_served_streams_are_the_configured_ones(smoke):
    """Both point buckets in use (1024 and 700 -> 768), every bucket with
    SA-1's 512 centres of real points, the pool stream saturated (every
    arrival at t=0) and paced, the LiDAR stream at 10 Hz."""
    streams = smoke._serve_streams()
    assert set(streams) == {"pool_saturated", "pool_paced", "lidar"}
    sat, paced, lidar = (streams[k][0] for k in (
        "pool_saturated", "pool_paced", "lidar"))
    assert len(sat) == len(paced) == 64 and len(lidar) == 32
    assert {t for t, _, _ in sat} == {0.0}
    assert all(a[1] is not None and np.array_equal(a[1], b[1])
               for a, b in zip(sat, paced))
    assert paced[-1][0] > 0 and lidar[1][0] == pytest.approx(0.1)
    sizes = {c.shape[0] for _, c, _ in sat}
    assert sizes == {1024, 700}
    buckets = smoke.SERVE_BUCKETS["points"]
    assert {next(b for b in buckets if n <= b) for n in sizes} == set(
        buckets)
    assert min(sizes) >= 512
    assert [s[1] for s in streams.values()] == [False, False, True]


def test_fit_launch_model_recovers_the_package_constants(smoke):
    """Fed the cost model's own predictions at every MLP of the paper's
    models (batch 1 and 8, K1, K2 and K3), the fit returns its constants:
    the least-squares problem is the model's, and the memory term binds
    at none of those block launches."""
    from repro_torch import PAPER_MODELS
    from repro_torch.core.policy import DEFAULT_POLICY
    from repro_torch.kernels import launch_work
    hw = DEFAULT_POLICY.hw
    cycles_per_ms = hw.freq_ghz * 1e6
    samples = []
    for model in ("model0", "model1", "model2"):
        cfg = PAPER_MODELS[model]
        mlps = [(s.mlp, s.n_centers * s.n_neighbors) for s in cfg.layers]
        mlps.append(((cfg.layers[-1].out_features, 256, 40), 1))
        for widths, rows in mlps:
            prog = _shape_program(widths)
            for batch in (1, 8):
                for mode in smoke.KERNEL_NAMES:
                    samples.append((
                        launch_work(prog, rows, mode, batch=batch,
                                    sms=hw.sms),
                        DEFAULT_POLICY.launch_cost(prog, rows, mode,
                                                   batch=batch)
                        / cycles_per_ms))
    fit = smoke.fit_launch_model(samples, hw)
    assert fit["block_overlap"] == pytest.approx(hw.block_overlap)
    assert fit["rms_rel_err"] < 1e-9
    for key in ("launch_cycles", "slab_cycles", "tile_cycles",
                "requant_cycles"):
        assert fit[key] == pytest.approx(getattr(hw, key), rel=1e-6), key


def _shape_program(widths):
    """A program of an MLP of ``widths`` as shapes only (the cost model
    reads the widths, ``d_pad`` and the plane count)."""
    from repro_torch.kernels import CrossbarProgram
    d = -(-max(widths) // 128) * 128
    n_layers = len(widths) - 1
    return CrossbarProgram(
        torch.zeros((), dtype=torch.int8).expand((n_layers, 4, d, d)),
        torch.zeros((n_layers, d)), torch.ones((n_layers, 1)),
        torch.ones((n_layers, d)), widths)


def test_cpu_logits_on_card_features_feed_the_card_features(smoke):
    """The helper runs the CPU model on the given clouds' layer-0 features
    as computed where the clouds lie (here the CPU: the plain run), and
    puts ``lift_features`` back."""
    from repro_torch import compile_model
    from repro_torch.core.workload import PointNetConfig, SALayerSpec
    from repro_torch.models import pointnet2 as pn
    cfg = PointNetConfig(name="tiny", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32))))
    model = compile_model(pn.init_params(cfg, seed=0, n_classes=10), cfg,
                          backend="reram-fused", schedule="pointer",
                          device="cpu")
    clouds = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, 3)).astype(np.float32))
    real = pn.lift_features
    got = smoke._cpu_logits_on_card_features(model, clouds)
    assert pn.lift_features is real
    assert torch.equal(got, model.batched_forward(clouds))


def test_train_phase_runs_the_trainers_model0_and_batch(smoke):
    """The train phase's run is model0 unreduced at the reference's batch
    and step count, and its step-0 check feeds the trainer's own first
    batch to the trainer's own model."""
    assert smoke.TRAIN_ARGS == {"points": 1024, "batch": 16, "steps": 200,
                                "seed": 0}
    trainer = smoke._trainer()
    assert trainer.train_config(1024) is smoke_model0()
    args = dict(smoke.TRAIN_ARGS, points=64, batch=2)
    clouds, labels = smoke._first_batch(args)
    assert clouds.shape == (2, 64, 3) and labels.shape == (2,)
    from repro_torch.data import PointCloudDataset
    again = next(PointCloudDataset(n_points=64, n_clouds=512,
                                   seed=0).batches(2, 1))
    assert np.array_equal(again[0], clouds)
    loss, acc, grads = smoke._step0(trainer, args, "cpu")
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert len(grads) == 16 and all(bool(torch.isfinite(g).all())
                                    for g in grads)


def smoke_model0():
    import repro_torch
    return repro_torch.PAPER_MODELS["model0"]


def test_p4_bound_counts_gradient_indices_and_output(smoke):
    """P4's bound at the training path's SA-2 neighbour gather: the
    upstream gradient and the int64 indices read once, the gradient rows
    written once, one float32 addition per gradient element."""
    nbytes, ops = smoke._p4_bound(16, 2048, 512, 128)
    assert nbytes == 4 * 16 * 2048 * 128 + 8 * 16 * 2048 + 4 * 16 * 512 * 128
    assert ops == 16 * 2048 * 128
    assert smoke.bound(nbytes, ops, smoke.FP32_OPS_PER_S)[1] == "bytes"


def test_scatter_gather_swap_computes_the_same_gradient(smoke):
    """The gather the train phase swaps in to time what P4 replaced gives
    ``gather_rows``' values and, on the CPU, its gradient bit for bit."""
    from repro_torch.models import pointnet2 as pn
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 9, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 3, (2, 5, 3)))
    g = torch.from_numpy(rng.normal(size=(2, 5, 3, 4)).astype(np.float32))
    grads = []
    for fn in (pn.gather_rows, smoke._scatter_gather_rows):
        xt = x.clone().requires_grad_()
        out = fn(xt, idx)
        grads.append((out.detach(), torch.autograd.grad(out, xt, g)[0]))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_train_phase_counts_kernels_by_their_profiled_names(smoke):
    rows = [{"kernel": "void (anonymous namespace)::fps_loop_kernel<256, 4>",
             "count": 1, "device_ms": 0.1},
            {"kernel": "void (anonymous namespace)::fps_stream_kernel<8>",
             "count": 1, "device_ms": 0.1},
            {"kernel": "(anonymous namespace)::gather_rows_backward_kernel(",
             "count": 2, "device_ms": 0.01},
            {"kernel": "at::native::scatter_gather_elementwise_kernel",
             "count": 2, "device_ms": 0.01}]
    assert smoke._k7_count(rows) == 2 and smoke._p4_count(rows) == 2
    assert "gather_rows_backward_kernel" in smoke.PORT_KERNELS
