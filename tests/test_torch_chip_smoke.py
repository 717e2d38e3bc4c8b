"""``chip_smoke.py``'s arithmetic and its refusal to run without a card.

The script's device phases need a CUDA card; what can be held on the CPU
is the least-time bound it reports beside each kernel time, the byte and
operation counts behind it, and that it exits non-zero, printing no
result, where no card exists."""
import dataclasses
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
        if model == "lm_train":
            continue
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


@pytest.mark.parametrize("argv", [["--profiler-loss"], ["--other"]])
def test_modes_exit_nonzero_without_a_card(smoke, capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the script runs for real there")
    assert smoke.main(argv) != 0
    assert "profiler_loss" not in capsys.readouterr().out


def test_profiles_settle_before_the_profiled_calls(smoke):
    """Each profiling session waits ``PROFILE_SETTLE_S`` (more than the
    5 ms after which no launch was lost) before its calls."""
    import inspect
    assert smoke.PROFILE_SETTLE_S >= 0.005
    assert inspect.signature(smoke._device_rows).parameters[
        "settle"].default == smoke.PROFILE_SETTLE_S
    from repro_torch.analysis import trace
    assert trace.PROFILE_SETTLE_S == smoke.PROFILE_SETTLE_S


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


# ---------------------------------------------------------------------------
# the lm phase
# ---------------------------------------------------------------------------

def test_lm_phase_runs_the_published_qwen(smoke):
    from repro_torch.configs import get_config
    cfg = get_config(smoke.LM_ARCH)
    assert smoke.LM_ARCH == "qwen1.5-0.5b"
    assert cfg.n_params() == smoke.LM_PARAMS == 463_863_808
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (24, 1024, 16, 16, 2816, 151936)
    assert cfg.qkv_bias and cfg.tie_embeddings and cfg.rope_theta == 1e6
    assert cfg.dtype == "bfloat16" and cfg.tp == 1
    assert (smoke.LM_BATCH, smoke.LM_PROMPT, smoke.LM_NEW) == (4, 1000, 64)
    # the prompt pads the last query chunk; the long one pads nothing
    assert smoke.LM_PROMPT % cfg.q_chunk and smoke.LM_PROMPT < cfg.kv_chunk
    assert smoke.LM_LONG_PROMPT % cfg.q_chunk == 0
    assert smoke.LM_LONG_PROMPT // cfg.kv_chunk == 2


def test_lm_decode_bytes_bound_by_hand(smoke):
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    # 24 layers x (k, v) x 16 heads x 64 x 2 bytes a cached position
    per_position = 24 * 2 * 16 * 64 * 2
    assert per_position == 98_304
    nbytes = smoke.lm_decode_bytes(cfg, 4, 1064)
    assert nbytes == 463_863_808 * 2 + 4 * 1064 * 98_304 == 1_346_109_440
    ms, by = smoke.bound(nbytes, 0.0, smoke.BF16_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(0.40182, abs=1e-5)


def test_lm_prefill_flops_bound_by_hand(smoke):
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    embed = 151_936 * 1024
    blocks = 463_863_808 - embed            # tied: one embedding matrix
    assert blocks == 308_281_344
    attention = 4 * 24 * 4 * 16 * 64 * (1000 * 1001 // 2)
    want = 2 * blocks * 4000 + 2 * embed * 4 + attention
    assert smoke.lm_prefill_flops(cfg, 4, 1000) == want == 2_664_300_019_712
    assert want / smoke.BF16_OPS_PER_S * 1e3 == pytest.approx(2.6939, 1e-4)
    # untied heads: the embedding is no product, the head one a sequence
    mistral = get_config("mistral-nemo-12b")
    v_d = mistral.vocab_size * mistral.d_model
    assert smoke.lm_prefill_flops(mistral, 1, 1) == \
        2 * (mistral.n_params() - 2 * v_d) + 2 * v_d \
        + 4 * 40 * 32 * 128


def test_lm_compare_holds_the_bound_and_the_sure_argmaxes(smoke):
    ref = torch.tensor([[0.0, 1.0, 0.2], [0.5, 0.49, 0.0]])
    ok = ref + torch.tensor([[0.01, -0.01, 0.0], [-0.02, 0.02, 0.0]])
    res = smoke._lm_compare([(ok, ref)], 0.05, "ok")
    # row 1's gap (0.01) is under twice the bound: its flipped argmax is
    # not held; row 0's is
    assert res["rows_argmax_checked"] == 1
    assert res["err_over_max"] == pytest.approx(0.02)
    with pytest.raises(RuntimeError, match="logits"):
        smoke._lm_compare([(ref + 0.1, ref)], 0.05, "off")


# ---------------------------------------------------------------------------
# the lm_families phase
# ---------------------------------------------------------------------------

def test_lm_families_run_the_published_widths(smoke):
    from repro_torch.configs import get_config
    runs = {arch: (layers, n) for arch, layers, n in smoke.LM_FAMILY_RUNS}
    assert sorted(runs) == ["llama4-scout-17b-a16e", "rwkv6-3b",
                            "zamba2-7b"]
    for arch, (layers, n) in runs.items():
        cfg = get_config(arch)
        assert cfg.dtype == "bfloat16" and cfg.tp == 1
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        assert cfg.n_params() == n, arch
    # only llama4-scout is cut, and only in depth
    assert runs["rwkv6-3b"][0] is None and runs["zamba2-7b"][0] is None
    assert runs["llama4-scout-17b-a16e"][0] == 8
    scout = get_config("llama4-scout-17b-a16e")
    assert (scout.d_model, scout.n_heads, scout.n_kv_heads, scout.d_ff,
            scout.n_experts, scout.experts_per_token, scout.vocab_size) == \
        (5120, 40, 8, 8192, 16, 1, 202048)
    assert scout.n_params() * 2 > 80e9           # the 48 layers: 203 GB
    # the check's prompts sit on both state-space chunks
    from repro_torch.models import rwkv, ssm
    assert smoke.LM_CHUNK_PROMPT % rwkv.CHUNK == 0
    assert smoke.LM_CHUNK_PROMPT % ssm.CHUNK == 0
    assert smoke.LM_PROMPT % ssm.CHUNK and smoke.LM_PROMPT % rwkv.CHUNK
    assert set(smoke.LM_FAMILY_BF16_BOUND) == {"moe", "ssm", "hybrid"}


def test_lm_decode_bytes_per_family_by_hand(smoke):
    from repro_torch.configs import get_config
    # rwkv6 reduced: float32, 2 layers, d 64, 4 heads of 16; no KV cache,
    # each layer's 4 x 16 x 16 float32 state and two 64-wide shift rows
    # read and written once a sequence
    rwkv = get_config("rwkv6-3b").reduced()
    assert rwkv.n_params() == 2 * (6 * 64 * 64 + 2 * 64 * 128) \
        + 2 * 512 * 64 == 147_456
    state = 4 * 16 * 16 * 4 + 2 * 64 * 4
    assert smoke.lm_decode_bytes(rwkv, 2, 10) == \
        147_456 * 4 + 2 * 2 * 2 * state == 626_688
    # zamba2 reduced: 5 Mamba layers (d_inner 128, 2 heads of 64, state
    # 16, conv over 128 + 32 channels), the shared block applied twice
    zamba = get_config("zamba2-7b").reduced()
    mamba = 64 * (256 + 32 + 2) + 128 * 64 + 4 * (128 + 32)
    shared = 4 * 64 * 64 + 3 * 64 * 128
    assert zamba.n_params() == 2 * 512 * 64 + 5 * mamba + shared == 243_456
    state = 2 * 64 * 16 * 4 + 3 * (128 + 32) * 4
    kv_row = 2 * 4 * 16 * 4
    assert smoke.lm_decode_bytes(zamba, 2, 10) == \
        243_456 * 4 + 2 * 10 * 2 * kv_row + 2 * 5 * 2 * state
    # llama4-scout reduced: 2 layers of 4 experts; only 3 of the 8 expert
    # weight sets are routed to
    scout = get_config("llama4-scout-17b-a16e").reduced()
    expert = 3 * 64 * 128
    kv_row = 2 * 2 * 16 * 4
    assert smoke.lm_decode_bytes(scout, 2, 10, routed_experts=3) == \
        (scout.n_params() - 5 * expert) * 4 + 2 * 10 * 2 * kv_row
    assert smoke.lm_decode_bytes(scout, 2, 10, routed_experts=8) == \
        scout.n_params() * 4 + 2 * 10 * 2 * kv_row
    with pytest.raises(ValueError, match="routed"):
        smoke.lm_decode_bytes(scout, 2, 10)


def test_lm_prefill_flops_per_family_by_hand(smoke):
    from repro_torch.configs import get_config
    pairs = 10 * 11 // 2
    head = 2 * 512 * 64 * 2                  # the last position's logits
    # rwkv: the block weights once a token, no attention
    rwkv = get_config("rwkv6-3b").reduced()
    assert smoke.lm_prefill_flops(rwkv, 2, 10) == \
        2 * (147_456 - 2 * 512 * 64) * 20 + head
    # zamba2: the shared block's weights once per application, attention
    # over the 2 applications
    zamba = get_config("zamba2-7b").reduced()
    shared = 4 * 64 * 64 + 3 * 64 * 128
    blocks = 243_456 - 2 * 512 * 64 + shared
    assert smoke.lm_prefill_flops(zamba, 2, 10) == \
        2 * blocks * 20 + head + 4 * 2 * 2 * 4 * 16 * pairs
    # llama4-scout: only the routed expert of each layer
    scout = get_config("llama4-scout-17b-a16e").reduced()
    assert scout.n_active_params() == scout.n_params() - 2 * 3 * 3 * 64 * 128
    assert smoke.lm_prefill_flops(scout, 2, 10) == \
        2 * (scout.n_active_params() - 2 * 512 * 64) * 20 + head \
        + 4 * 2 * 2 * 4 * 16 * pairs


def test_route_flips_hold_each_rows_first_difference(smoke):
    """Forward routes 2 rows x 4 positions through 2 layers (top-1); the
    serving path's step at position 2 differs in row 1 at both layers (the
    second follows from the first) and in row 0 at layer 1; a row no
    longer held is not reported."""
    logits = torch.tensor([[3.0, 1.0], [1.0, 2.0], [2.0, 1.9], [0.0, 1.0],
                           [1.0, 3.0], [2.0, 1.0], [1.0, 1.2], [4.0, 0.0]])
    fwd = [{"top_idx": logits.argmax(-1, keepdim=True), "logits": logits}
           for _ in range(2)]
    step = [{"top_idx": torch.tensor([[0], [0]])},
            {"top_idx": torch.tensor([[1], [0]])}]
    flips = smoke._route_flips(step, fwd, 2, 2, 1,
                               torch.tensor([True, True]))
    assert sorted(flips, key=lambda f: f["row"]) == [
        {"row": 0, "position": 2, "layer": 1, "last_layer": True,
         "margin": pytest.approx(0.1), "max_abs_router_logit": 4.0},
        {"row": 1, "position": 2, "layer": 0, "last_layer": False,
         "margin": pytest.approx(0.2), "max_abs_router_logit": 4.0}]
    flips = smoke._route_flips(step, fwd, 2, 2, 1,
                               torch.tensor([False, True]))
    assert [(f["row"], f["layer"]) for f in flips] == [(1, 0)]
    agree = [{"top_idx": torch.tensor([[0], [1]])}] * 2
    assert smoke._route_flips(agree, fwd, 2, 2, 1,
                              torch.tensor([True, True])) == []


def test_route_flips_report_every_last_layer_difference(smoke):
    """A row whose choices differ only at the last layer (here at two of
    its four prompt positions) has each difference reported: each changes
    its own position's logits only, and each must be a near tie."""
    logits = torch.tensor([[3.0, 1.0], [1.0, 1.1], [2.0, 1.0], [1.0, 1.05]])
    fwd = [{"top_idx": logits.argmax(-1, keepdim=True), "logits": logits}
           for _ in range(2)]
    prefill = [{"top_idx": logits.argmax(-1, keepdim=True)},
               {"top_idx": torch.tensor([[0], [0], [0], [0]])}]
    flips = smoke._route_flips(prefill, fwd, 0, 1, 1, torch.tensor([True]))
    assert [(f["position"], f["layer"], f["last_layer"]) for f in flips] \
        == [(1, 1, True), (3, 1, True)]
    assert [f["margin"] for f in flips] == pytest.approx([0.1, 0.05])


def test_record_routes_wraps_route_local_for_the_block(smoke):
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 16, 32, 4, torch.float32)
    x = torch.randn(8, 16, generator=gen)
    real = moe._route_local
    with smoke.record_routes() as rec:
        y = moe.moe_apply(p, x, top_k=2, capacity_factor=1.25)
    assert moe._route_local is real
    assert torch.equal(y, moe.moe_apply(p, x, top_k=2, capacity_factor=1.25))
    assert len(rec) == 1 and rec[0]["cap"] == moe.capacity(1.25, 8, 2, 4)
    assert rec[0]["logits"].shape == (8, 4)
    assert rec[0]["top_idx"].shape == (8, 2) and rec[0]["keep"].shape == (16,)
    moe.moe_apply(p, x, top_k=2)
    assert len(rec) == 1


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "rwkv6-3b",
                                  "zamba2-7b"])
def test_eager_against_forward_compares_every_token_step(smoke, arch):
    """The eager prefill and teacher-forced steps of a reduced config in
    float32 on the CPU (moe dropless), on a prompt on both chunks: no
    expert choice differs from ``forward``'s, every token-step is
    compared, and all within ``LM_F32_BOUND``."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    params = lm.init(0, cfg, device="cpu")
    tokens = torch.from_numpy(smoke.lm_prompts(cfg, 2, 36, 3))
    run = smoke._eager_against_forward(params, cfg, tokens, 32,
                                       smoke.LM_ROUTE_TIE, arch)
    assert run["flips"] == []
    assert run["rows_compared_per_step"] == [2, 2, 2]
    assert run["token_steps_compared"] == [6, 6]
    pairs = run["prefill"] + run["steps"]
    assert len(pairs) == 4 and all(p is not None for p in pairs)
    smoke._lm_compare(pairs, smoke.LM_F32_BOUND, arch)


def test_lm_train_phase_runs_the_published_configs(smoke):
    """(a) the published qwen1.5-0.5b at train_4k's length; (d) each wide
    config at published width with its depth cut, as the phase names it."""
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(smoke.LM_ARCH)
    assert (smoke.LM_TRAIN_BATCH, smoke.LM_TRAIN_SEQ) == (
        2, SHAPES["train_4k"].seq_len)
    assert cfg.opt_moment_dtype == "float32"
    assert smoke.LM_TRAIN_COMPARE == 7 and smoke.LM_TRAIN_STEPS == 20
    for arch, over, moments, n_params in smoke.LM_TRAIN_WIDE:
        full = get_config(arch)
        cut = dataclasses.replace(full, **over)
        assert cut.n_params() == n_params and cut.dtype == "bfloat16"
        assert (cut.d_model, cut.vocab_size) == (full.d_model,
                                                 full.vocab_size)
        assert cut.n_layers < full.n_layers
        if cut.family == "hybrid":      # one attn_interval group, no trail
            assert cut.n_layers == cut.attn_interval == 6
        assert moments == ("bfloat16" if cut.family == "moe"
                           else "float32")


def test_lm_train_p4_counts_are_the_steps_gathers(smoke, monkeypatch):
    """``PATHS["lm_train"]``: one P4 call a step for the embedding, three
    more per MoE layer (counted on the CPU, where a call runs the plain
    version, over one step's backward at ``reduced()``)."""
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.kernels import gather_backward
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves, tree_map
    calls = []
    real = gather_backward.gather_rows_backward
    monkeypatch.setattr(gather_backward, "gather_rows_backward",
                        lambda *a: calls.append(1) or real(*a))
    for arch in ("qwen1.5-0.5b", "llama4-scout-17b-a16e", "grok-1-314b",
                 "rwkv6-3b", "zamba2-7b"):
        cfg = get_config(arch).reduced()
        p = tree_map(lambda t: t.requires_grad_(),
                     lm.init(0, cfg, device="cpu"))
        ins = dummy_inputs(cfg, "train", 2, 16, seed=1, device="cpu")
        calls.clear()
        loss, _ = lm.loss_fn(p, cfg, ins["ids"], ins["labels"])
        torch.autograd.grad(loss, tree_leaves(p))
        moe = cfg.family == "moe"
        assert len(calls) == 1 + (3 * cfg.n_layers if moe else 0), arch
    for arch, over, _, _ in smoke.LM_TRAIN_WIDE:
        cfg = dataclasses.replace(get_config(arch), **over)
        moe = cfg.family == "moe"
        assert smoke.PATHS["lm_train"][arch] == {
            "gather_rows_backward": 1 + (3 * cfg.n_layers if moe else 0)}
    assert smoke.PATHS["lm_train"][smoke.LM_ARCH] == {
        "gather_rows_backward": 1}


def test_lm_train_flops_by_hand(smoke):
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    got = smoke.lm_train_flops(cfg, 2, 4096)
    assert got["gemm_flops"] == 6 * 463_863_808 * 8192
    # chunks of 512 queries and 1024 keys: query chunk i sees key chunks
    # 0..i // 2, so 1+1+2+2+3+3+4+4 = 20 of the 8 x 4 pairs; 24 layers
    assert smoke._causal_chunk_pairs(4096, 512, 1024) == 20
    per_product = 2 * 2 * 16 * 512 * 1024 * 64 * 20 * 24
    assert got["attention_bf16_flops"] == 4 * per_product
    assert got["attention_f32_flops"] == 3 * per_product
    assert got["gemm_ms"] == pytest.approx(23.05, abs=0.01)
    assert got["attention_bf16_ms"] == pytest.approx(4.17, abs=0.01)
    assert got["attention_f32_ms"] == pytest.approx(46.16, abs=0.01)
    assert got["step_ms"] == pytest.approx(73.38, abs=0.01)
    # a ragged tail: 1000 tokens in chunks of 512 and 1024 -> 2 pairs
    assert smoke._causal_chunk_pairs(1000, 512, 1000) == 2
    assert smoke._causal_chunk_pairs(48, 16, 16) == 6
    # the hybrid pads to the Mamba2 chunk, then to its attention chunks;
    # rwkv has no attention
    zamba = dataclasses.replace(get_config("zamba2-7b"), n_layers=6)
    z = smoke.lm_train_flops(zamba, 2, 1000)
    assert z["attention_f32_flops"] == 3 * 2 * 2 * 32 * 1024 * 1024 * 112
    assert smoke.lm_train_flops(get_config("rwkv6-3b"), 2, 1024)[
        "attention_f32_flops"] == 0
    # moe: the active parameters
    scout = get_config("llama4-scout-17b-a16e")
    assert smoke.lm_train_flops(scout, 1, 1)["gemm_flops"] == \
        6 * scout.n_active_params()


def test_float64_weights_give_float64_gradients(smoke):
    """The ssm check's float64 run: float64 weights keep float64 through
    the norms, decays and logits (``layers.upcast``), and land within
    float32's distance of the float32 gradients."""
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.models import lm
    from repro_torch.optim import tree_map
    cfg = get_config("rwkv6-3b").reduced()
    params = lm.init(0, cfg, device="cpu")
    ins = dummy_inputs(cfg, "train", 2, 36, seed=5, device="cpu")
    loss32, g32, _ = smoke._loss_and_grads(params, cfg, ins)
    loss64, g64, _ = smoke._loss_and_grads(
        tree_map(lambda t: t.double(), params),
        dataclasses.replace(cfg, dtype="float64"), ins)
    assert all(g.dtype == torch.float64 for g in g64)
    assert loss64 != loss32 and abs(loss64 - loss32) <= 1e-6 * loss64
    assert 0 < smoke._grad_err(g32, g64) <= 1e-3
