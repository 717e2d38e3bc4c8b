"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and carries the ``cuda`` marker; the
``cuda`` fixture skips it where there is none. Run them on a machine with
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel and plain version must agree bit for bit: the kernels do every
integer step exactly and every float step as one correctly rounded IEEE
operation, as the plain versions do.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import PAPER_MODELS, compile_model        # noqa: E402
from repro_torch.core.workload import (PointNetConfig,     # noqa: E402
                                       SALayerSpec)
from repro_torch.kernels import (KERNEL_SOURCES, _build,   # noqa: E402
                                 aggregate, build_program, encode_planes,
                                 fps_batched, fused_mlp, launch_counts,
                                 ref_reram_matmul_int, reram_mlp,
                                 reset_launch_counts)
from repro_torch.kernels.fps_update import (              # noqa: E402
    FpsPlan, fps_batched_cuda, fps_batched_plain, fps_update_cuda,
    fps_update_plain, plan_fps)
from repro_torch.kernels import plan_order                 # noqa: E402
from repro_torch.core import schedule as tsched            # noqa: E402
from repro_torch.models.pointnet2 import init_params       # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layers(widths, rng):
    return [{"w": torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))}
            for k, n in zip(widths[:-1], widths[1:])]


def test_kernels_build(cuda):
    _build.build(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        assert _build.library(name) is not None


@pytest.mark.parametrize("widths,m,batch,final_relu", [
    ((8, 128, 128, 256), 512 * 16, 2, True),     # model1 SA-1
    ((256, 256, 256, 512), 128 * 16, 2, True),   # model1 SA-2
    ((512, 256, 40), 1, 8, False),               # model1 head
    ((130, 200, 70), 257, 3, True),              # ragged widths
    ((5, 7), 9, 1, False),
])
def test_fused_mlp_kernel_bitwise(cuda, widths, m, batch, final_relu):
    rng = np.random.default_rng(0)
    prog = build_program(_layers(widths, rng)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(batch, m, widths[0]))
                         .astype(np.float32)).to(cuda)
    x_p, sx = fused_mlp.prepare_input(x, prog)
    got = fused_mlp.fused_mlp_cuda(x_p, sx, prog, m_real=m,
                                   final_relu=final_relu)
    want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                     final_relu=final_relu)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (batch, m, widths[-1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["mtiled", "wstat"])
@pytest.mark.parametrize("widths,m,batch,final_relu", [
    ((16, 256, 256, 512), 512 * 16, 2, True),    # model2 SA-1
    ((512, 512, 512, 1024), 128 * 16, 2, True),  # model2 SA-2
    ((1024, 256, 40), 1, 8, False),              # model2 head
    ((130, 200, 70), 257, 3, True),              # ragged widths
    ((5, 7), 9, 1, False),
])
def test_fused_mlp_modes_bitwise(cuda, mode, widths, m, batch, final_relu):
    """K2 and K3 against the plain version and against K1 on the same
    inputs: one function, three dataflows."""
    rng = np.random.default_rng(1)
    prog = build_program(_layers(widths, rng)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(batch, m, widths[0]))
                         .astype(np.float32)).to(cuda)
    x_p, sx = fused_mlp.prepare_input(x, prog)
    kernel = fused_mlp.KERNEL_OF_MODE[mode]
    got = kernel(x_p, sx, prog, m_real=m, final_relu=final_relu)
    k1 = fused_mlp.fused_mlp_cuda(x_p, sx, prog, m_real=m,
                                  final_relu=final_relu)
    want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                     final_relu=final_relu)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (batch, m, widths[-1])
    assert torch.equal(got, want)
    assert torch.equal(got, k1)


@pytest.mark.parametrize("widths,m,batch,weight_bits", [
    ((16, 256, 256, 512), 512 * 16, 2, 8),       # model2 SA-1
    ((512, 512, 512, 1024), 128 * 16, 2, 8),     # model2 SA-2
    ((8, 128, 128, 256), 1000, 3, 6),            # ragged rows, 6-bit
    ((1024, 256, 40), 1, 8, 4),                  # 1-row head, 4-bit
    ((130, 200, 70), 257, 3, 5),
    ((2100, 2080, 40), 200, 2, 8),               # K1 in two K ranges
    ((20,) + (48,) * 9 + (24,), 300, 2, 7),      # ten layers
    ((4000, 64, 40), 100, 2, 8),                 # K3 in 32-column chunks
    ((7000, 40), 64, 2, 8),                      # K3 in K ranges
])
def test_tensor_core_kernels_equal_plain_and_k3(cuda, widths, m, batch,
                                                weight_bits):
    """K1, K2 and K3 (tensor cores, s8 weights) against the plain version
    and so against each other bit for bit, with non-zero biases, row counts
    that are not a multiple of the 64-row stripe and weight_bits below 8;
    past K1's 2048-byte stripe (where 'mtiled' runs K1 and K3 narrows its
    chunk to 64 columns), past K3's 3264-byte 64-column chunk (32
    columns) and its 6560-byte 32-column chunk (K in ranges), and at ten
    layers."""
    rng = np.random.default_rng(5)
    prog = build_program(_layers(widths, rng),
                         weight_bits=weight_bits).to(cuda)
    x = torch.from_numpy(rng.normal(size=(batch, m, widths[0]))
                         .astype(np.float32)).to(cuda)
    x_p, sx = fused_mlp.prepare_input(x, prog)
    want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m)
    got = {mode: fused_mlp.KERNEL_OF_MODE[mode](x_p, sx, prog, m_real=m)
           for mode in ("whole", "mtiled", "wstat")}
    torch.cuda.synchronize()
    for mode, y in got.items():
        assert torch.equal(y, want), mode


@pytest.mark.parametrize("widths,m,weight_bits", [
    ((8, 128, 128, 256), 8192, 8),               # model1 SA-1
    ((16, 256, 256, 512), 8192, 8),              # model2 SA-1
    ((1024, 256, 40), 1, 8),                     # model2 head
    ((130, 200, 70), 257, 6),                    # ragged k_lim / n_lim
    ((5, 7), 9, 4),
    ((20,) + (48,) * 9 + (24,), 30, 8),          # ten layers
])
def test_combine_weights_kernel_bitwise(cuda, widths, m, weight_bits):
    """The s8 weight pre-pass against its plain version over every layer's
    (k_lim, n_lim), padded columns included (-128 at 8 bits)."""
    from repro_torch.kernels import plan_launch
    rng = np.random.default_rng(6)
    prog = build_program(_layers(widths, rng),
                         weight_bits=weight_bits).to(cuda)
    geom = plan_launch(prog, m, "mtiled")
    reset_launch_counts()
    got = fused_mlp.combine_weights_cuda(prog, geom)
    want = fused_mlp.combine_weights_plain(prog, geom)
    torch.cuda.synchronize()
    assert launch_counts()["fused_mlp_combine"] == 1
    for l, (g, w) in enumerate(zip(fused_mlp.weight_regions(got, geom),
                                   fused_mlp.weight_regions(want, geom))):
        assert torch.equal(g, w), l
        k, n = widths[l], widths[l + 1]
        assert torch.equal(w[:n, :k].T.to(torch.int32),
                           prog.int_weights()[l])


@pytest.mark.parametrize("widths,on_chip", [
    ((1500, 64, 40), True),           # K2's two stripes fit (k_lim 1504)
    ((2100, 2080, 40), False),        # they do not: 'mtiled' runs K1
    ((20,) + (48,) * 9 + (24,), True),
])
def test_mtiled_launches_by_width_and_depth(cuda, widths, on_chip):
    """K2 launches once per layer at any depth; where its two stripes do
    not fit on chip, the 'mtiled' wrapper runs K1 in its place, and the
    counters say so. Either way the result is the plain version's."""
    rng = np.random.default_rng(7)
    prog = build_program(_layers(widths, rng)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(2, 130, widths[0]))
                         .astype(np.float32)).to(cuda)
    x_p, sx = fused_mlp.prepare_input(x, prog)
    reset_launch_counts()
    got = fused_mlp.fused_mlp_mtiled_cuda(x_p, sx, prog, m_real=130)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_layers = len(widths) - 1
    k2 = (1, n_layers) if on_chip else (0, 0)
    assert (counts["fused_mlp_mtiled"],
            counts["fused_mlp_mtiled_layer"]) == k2
    assert (counts["fused_mlp"], counts["fused_mlp_layer"]) == (
        (0, 0) if on_chip else (1, n_layers))
    assert counts["fused_mlp_combine"] == 1
    assert torch.equal(got, fused_mlp.fused_mlp_plain(x_p, sx, prog,
                                                      m_real=130))


@pytest.mark.parametrize("m,k,n", [
    (8192, 16, 256),       # model2 SA-1, first layer, one cloud
    (2048, 512, 1024),     # model2 SA-2, last layer, one cloud
    (8, 1024, 256),        # model2 head at batch 8: K split over blocks
    (130, 77, 5),          # ragged in every dimension
    (1, 3, 2),
    (8192, 4, 64),         # model0's first layer: rows of 4 bytes
    (8192, 8, 128),        # model1's first layer: rows of 8 bytes
    (1, 1024, 256),        # model2 head, one cloud: 16 K ranges
    (8, 256, 40),          # the last head layer: N = 40
    (300, 64, 5),          # N = 5, odd
    (3, 5000, 20),         # K past one stripe: split for width
])
def test_reram_matmul_kernel_bitwise(cuda, m, k, n):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                         .astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, size=(k, n))
                         .astype(np.int32))
    planes = encode_planes(w).to(cuda)
    reset_launch_counts()
    got = reram_mlp.reram_matmul_int_cuda(x, planes)
    want = ref_reram_matmul_int(x, planes)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want.cpu(), x.cpu().to(torch.int32) @ w)
    counts = launch_counts()
    assert (counts["reram_matmul_int"], counts["reram_combine"]) == (1, 1)
    # rows that do not start 16-byte aligned take the byte-load path
    buf = torch.empty(m * k + 1, dtype=torch.int8, device=cuda)
    x_off = buf[1:].view(m, k)
    x_off.copy_(x)
    assert torch.equal(reram_mlp.reram_matmul_int_cuda(x_off, planes), want)


@pytest.mark.parametrize("k,n,weight_bits", [
    (3, 5, 8), (8, 40, 4), (16, 256, 6), (77, 40, 8), (256, 256, 8),
    (1024, 256, 8), (512, 1024, 5)])
def test_reram_prepass_kernel_bitwise(cuda, k, n, weight_bits):
    """K6's s8 pre-pass against its plain version on (P, K, N) planes; its
    row padding (K up to a multiple of 16) holds zeros."""
    rng = np.random.default_rng(k + n)
    half = 1 << (weight_bits - 1)
    w = torch.from_numpy(rng.integers(-half, half, size=(k, n)))
    planes = encode_planes(w, weight_bits).to(cuda)
    reset_launch_counts()
    got = reram_mlp.reram_combine_cuda(planes, weight_bits=weight_bits)
    want = reram_mlp.reram_combine_plain(planes, 2, weight_bits)
    torch.cuda.synchronize()
    assert launch_counts()["reram_combine"] == 1
    assert got.shape == (n, k) and torch.equal(got, want)
    assert torch.equal(want.T.cpu().to(torch.int64), w)
    pad = got.as_strided((n, -(-k // 16) * 16), (got.stride(0), 1))
    assert not pad[:, k:].any()


@pytest.mark.parametrize("batch,n,c,m,k", [
    (3, 1024, 8, 512, 16),      # model1 SA-1 gather
    (2, 512, 256, 128, 16),     # model1 SA-2 gather
    (2, 64, 3, 24, 4),          # C not a multiple of 4
    (1, 1024, 4, 512, 16),      # K5 as batch 1
])
def test_aggregate_kernel_bitwise(cuda, batch, n, c, m, k):
    g = torch.Generator(device="cpu").manual_seed(0)
    feats = torch.randn((batch, n, c), generator=g).to(cuda)
    nbr = torch.randint(0, n, (batch, m, k), generator=g,
                        dtype=torch.int32).to(cuda)
    ctr = torch.randint(0, n, (batch, m), generator=g,
                        dtype=torch.int32).to(cuda)
    got = aggregate.aggregate_diff_cuda(feats, nbr, ctr)
    want = aggregate.aggregate_diff_batched_plain(feats, nbr, ctr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _tiny():
    return PointNetConfig(name="tiny", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32))))


#: The kernel calls each fused backend makes on the tiny model in one pass
#: ('reram-fused' runs the Hopper choice: K1 at both SA layers, K3 at the
#: head); 'reram' launches K6 once per layer.
_CALLS = {"reram-fused": {"fused_mlp": 2, "fused_mlp_wstat": 1},
          "reram-fused-mtiled": {"fused_mlp_mtiled": 3},
          "reram-fused-wstat": {"fused_mlp_wstat": 3},
          "reram": {}}


@pytest.mark.parametrize("backend", sorted(_CALLS))
def test_model_on_card_counts_launches_and_matches_cpu(cuda, backend):
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    gpu = compile_model(params, cfg, backend=backend, schedule="pointer")
    cpu = compile_model(params, cfg, backend=backend, schedule="pointer",
                        device="cpu")
    reset_launch_counts()
    got = gpu.batched_forward(clouds).cpu()
    one = gpu.forward(clouds[0]).cpu()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["aggregate_diff_batched"] == cfg.n_layers
    assert counts["aggregate_diff"] == cfg.n_layers
    # one call per MLP and pass, or, for 'reram', one launch per layer
    n_layers = sum(len(s.mlp) - 1 for s in cfg.layers) + 2
    want_n = 2 * (n_layers if backend == "reram" else cfg.n_layers + 1)
    counters = ("fused_mlp", "fused_mlp_mtiled", "fused_mlp_wstat",
                "reram_matmul_int")
    want_calls = dict.fromkeys(counters, 0)
    want_calls.update({k: 2 * n for k, n in _CALLS[backend].items()})
    if backend == "reram":
        want_calls["reram_matmul_int"] = want_n
    assert {k: counts[k] for k in counters} == want_calls
    # K1, K2 and K3 run the s8 weight pre-pass once per MLP call, K6 once
    # per product
    assert counts["fused_mlp_combine"] == (
        0 if backend == "reram" else want_n)
    assert counts["reram_combine"] == (
        want_n if backend == "reram" else 0)
    # one FPS launch per SA layer and call, whatever the batch
    assert counts["fps"] == 2 * cfg.n_layers and counts["fps_update"] == 0
    want = cpu.batched_forward(clouds)
    # lift_features' sin/cos may differ by an ulp between the card and the
    # CPU, which can move one requantized value by one step
    tol = 1e-2 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got.argmax(1), want.argmax(1))
    assert torch.equal(one, got[0])


def test_model2_shaped_launch_counts(cuda):
    """model2 at full size, batch 2 and 1: 'reram-fused' runs the Hopper
    choice (``PlanPolicy.select_launch``): every MLP through K3; 'reram'
    launches K6 once per layer and pass, and gives the same logits (zero
    biases: the two paths compute one function)."""
    cfg = PAPER_MODELS["model2"]
    params = init_params(cfg, seed=0)
    clouds = np.random.default_rng(3).normal(size=(2, 1024, 3)).astype(
        np.float32)
    fused = compile_model(params, cfg, backend="reram-fused",
                          schedule="pointer")
    per_layer = compile_model(params, cfg, backend="reram",
                              schedule="pointer")
    reset_launch_counts()
    logits = fused.batched_forward(clouds)
    one = fused.forward(clouds[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["fused_mlp"], counts["fused_mlp_mtiled"],
            counts["fused_mlp_wstat"]) == (0, 0, 6)
    # one pre-pass per K1, K2 or K3 call; one launch per layer
    assert counts["fused_mlp_combine"] == 6
    assert counts["fused_mlp_wstat_layer"] == 2 * (3 + 3 + 2)
    assert counts["fps"] == 2 * cfg.n_layers
    assert torch.equal(one, logits[0])
    reset_launch_counts()
    ref = per_layer.batched_forward(clouds)
    per_layer.forward(clouds[0])
    torch.cuda.synchronize()
    assert launch_counts()["reram_matmul_int"] == 2 * 8
    assert launch_counts()["reram_combine"] == 2 * 8
    assert launch_counts()["fused_mlp_combine"] == 0
    assert torch.equal(ref, logits)


def _fps_clouds(kind, batch, n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(batch, n, 3))
    if kind == "duplicated":
        pts[:, n // 2:] = pts[:, :n - n // 2]
    elif kind == "grid":                       # many exactly tied distances
        side = int(round(n ** (1 / 3))) + 1
        grid = np.stack(np.meshgrid(*[np.arange(float(side))] * 3),
                        -1).reshape(-1, 3)[:n]
        pts = np.broadcast_to(grid, (batch, n, 3)) + np.arange(batch)[
            :, None, None]
    pts = np.ascontiguousarray(pts, dtype=np.float32)
    if kind == "nan":      # a NaN, a negative NaN and a NaN with a payload
        pts[0, n // 3, 1] = np.nan
        pts[-1, n // 5, 2] = -np.float32(np.nan)
        pts[-1, n // 2, 0] = np.array([0x7F812345], np.uint32).view(
            np.float32)[0]
    return torch.from_numpy(pts)


def _check_fps(pts, n_samples, start, nv, plan):
    got = fps_batched_cuda(pts, n_samples, start, nv, plan=plan)
    want = fps_batched_plain(pts, n_samples, start, nv)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (pts.shape[0],
                                                      n_samples)
    assert torch.equal(got, want), plan
    return got


@pytest.mark.parametrize("kind,batch,n,n_samples,ragged", [
    ("random", 8, 1024, 512, False),    # model1/model2 SA-1
    ("random", 8, 512, 128, False),     # model1/model2 SA-2
    ("random", 3, 1000, 300, True),     # ragged N, pad rows by n_valid
    ("grid", 2, 1000, 400, False),
    ("duplicated", 2, 1024, 600, True),
    ("nan", 2, 1024, 300, False),
    ("random", 2, 16385, 1024, False),  # past one block's registers
    ("random", 1, 5, 5, False),
])
def test_fps_loop_kernel_bitwise(cuda, kind, batch, n, n_samples, ragged):
    pts = _fps_clouds(kind, batch, n, seed=n).to(cuda)
    nv = (torch.tensor([n - 7 * b for b in range(batch)], device=cuda)
          if ragged else None)
    start = 3 if ragged else 0
    got = _check_fps(pts, n_samples, start, nv, None)
    assert torch.equal(got.cpu(), fps_batched_plain(
        pts.cpu(), n_samples, start, None if nv is None else nv.cpu()))
    if ragged:
        assert bool((got < nv[:, None]).all())


#: Every tier pinned at the main path's shapes (batch, N, samples) and at
#: the edge cases, whether or not ``plan_fps`` would pick it.
_PINNED = [FpsPlan("block", 128, 8, 1), FpsPlan("block", 256, 4, 1),
           FpsPlan("block", 512, 2, 1), FpsPlan("cluster", 128, 4, 2),
           FpsPlan("cluster", 128, 1, 8), FpsPlan("cluster", 256, 1, 16),
           FpsPlan("streamed", 1024, 1, 2), FpsPlan("streamed", 1024, 1, 8)]


@pytest.mark.parametrize("plan", _PINNED, ids=lambda p: (
    f"{p.tier}-{p.threads}x{p.per_thread}x{p.cluster}"))
@pytest.mark.parametrize("kind,batch,n,n_samples,ragged", [
    ("random", 8, 1024, 512, False),    # SA-1
    ("random", 8, 512, 128, False),     # SA-2
    ("random", 1, 1024, 512, False),    # SA-1 of forward
    ("random", 3, 1000, 300, True),
    ("grid", 2, 1000, 400, False),
    ("duplicated", 2, 1024, 600, True),
    ("nan", 2, 1024, 300, False),
])
def test_fps_every_tier_bitwise(cuda, plan, kind, batch, n, n_samples,
                                ragged):
    pts = _fps_clouds(kind, batch, n, seed=n + 1).to(cuda)
    nv = (torch.tensor([n - 7 * b for b in range(batch)], device=cuda)
          if ragged else None)
    got = _check_fps(pts, n_samples, 3 if ragged else 0, nv, plan)
    if ragged:
        assert bool((got < nv[:, None]).all())


@pytest.mark.parametrize("batch,n,n_samples,tier,cluster", [
    (2, 16385, 1024, "cluster", 3),
    (1, 120000, 32, "cluster", 15),     # a non-portable cluster
    # the cluster tier's top: 16 blocks of 512 threads, one an SM
    (1, 131072, 64, "cluster", 16),
    (8, 131072, 16, "cluster", 16),     # 128 blocks in 8 clusters of 16
    (1, 300000, 64, "streamed", 8),
])
def test_fps_large_clouds_bitwise(cuda, batch, n, n_samples, tier,
                                  cluster):
    """Clouds past one block and past a cluster's registers run on their
    own kernel, not the plain loop: the launch counter moves."""
    pts = _fps_clouds("random", batch, n, seed=7).to(cuda)
    plan = plan_fps(batch, n, _build.sm_count(pts))
    assert (plan.tier, plan.cluster) == (tier, cluster)
    reset_launch_counts()
    _check_fps(pts, n_samples, 0, None, None)
    assert launch_counts()["fps"] == 1


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("batch,n,n_samples", [
    (2, 16385, 256), (1, 131072, 64)])
def test_fps_streamed_tier_past_one_block_bitwise(cuda, batch, n,
                                                  n_samples, cluster):
    """The streamed tier pinned where ``plan_fps`` takes a cluster: the
    tier the cluster tier is timed against."""
    plan = FpsPlan("streamed", 1024, -(-n // (1024 * cluster)), cluster)
    pts = _fps_clouds("random", batch, n, seed=11).to(cuda)
    _check_fps(pts, n_samples, 0, None, plan)


def test_fps_chain_variant_runs_the_same_launch(cuda):
    """``chip_smoke.py``'s measurement entry, the loop without its
    relaxation, launches under every tier and keeps the start index; its
    other indices mean nothing, and it counts no launch."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    pts = _fps_clouds("random", 2, 1024, seed=2).to(cuda)
    reset_launch_counts()
    for plan in _PINNED:
        out = smoke.fps_chain(pts, 64, plan)
        torch.cuda.synchronize()
        assert out.shape == (2, 64) and bool((out[:, 0] == 0).all())
        assert bool(((out >= 0) & (out < 1024)).all())
    assert launch_counts()["fps"] == 0


@pytest.mark.parametrize("n", [1000, 1024, 16384])
def test_fps_update_kernel_bitwise(cuda, n):
    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    dist = torch.from_numpy(rng.uniform(0, 4, (1, n)).astype(np.float32))
    dist[0, :3] = float("inf")
    dist[0, -2:] = float("-inf")
    pts, dist = pts.to(cuda), dist.to(cuda)
    cen = pts[:, 7:8].contiguous()
    got = fps_update_cuda(pts, cen, dist)
    want = fps_update_plain(pts, cen, dist)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), fps_update_plain(pts.cpu(), cen.cpu(),
                                                   dist.cpu()))


@pytest.mark.parametrize("schedule", ["baseline", "pointer"])
def test_fps_counter_reads_one_launch_per_sa_layer_and_call(cuda, schedule):
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    clouds = np.random.default_rng(4).normal(size=(5, 64, 3)).astype(
        np.float32)
    model = compile_model(params, cfg, backend="float", schedule=schedule)
    reset_launch_counts()
    model.batched_forward(clouds)
    model.forward(clouds[0])
    model.forward(clouds[1])
    torch.cuda.synchronize()
    assert launch_counts()["fps"] == 3 * cfg.n_layers


# ---------------------------------------------------------------------------
# P1, P2, K4/K5's plan interface, device planning and capture
# ---------------------------------------------------------------------------

def _cloud_batch(kind, batch, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "grid":
        side = int(np.ceil(n ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)[:n].astype(np.float32)
        return np.stack([g] * batch)
    pts = rng.normal(size=(batch, n, 3)).astype(np.float32)
    if kind == "dup":
        pts = np.repeat(pts[:, :-(-n // 4)], 4, axis=1)[:, :n]
    if kind == "nan":
        pts[:, n // 3, 1] = np.nan
    return np.ascontiguousarray(pts)


@pytest.mark.parametrize("kind,batch,n,start", [
    ("normal", 8, 128, 0), ("normal", 1, 128, 5), ("normal", 3, 300, 17),
    ("normal", 1, 2048, 0), ("grid", 2, 512, 0), ("dup", 2, 128, 3),
    ("nan", 1, 100, 0), ("normal", 4, 1, 0), ("normal", 2, 33, 32)])
def test_plan_greedy_kernel_bitwise(cuda, kind, batch, n, start):
    pts = _cloud_batch(kind, batch, n)
    got = plan_order.plan_greedy_cuda(torch.from_numpy(pts).to(cuda), start)
    want = plan_order.plan_greedy_plain(torch.from_numpy(pts), start)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for b in range(batch):
        np.testing.assert_array_equal(
            got[b].cpu().numpy(), tsched.greedy_nn_order(pts[b], start))


@pytest.mark.parametrize("kind,batch,n,start", [
    ("normal", 2, 32, 31), ("normal", 2, 33, 32), ("normal", 2, 256, 255),
    ("normal", 2, 257, 256), ("normal", 1, 2048, 2047),
    ("dup", 2, 256, 9), ("nan", 2, 256, 0), ("dup", 2, 1000, 9),
    ("nan", 2, 1000, 0), ("normal", 3, 200, 199), ("normal", 2, 1000, 999)])
def test_plan_greedy_one_warp_and_block_boundaries(cuda, kind, batch, n,
                                                   start):
    """P1 at the edges of its two designs, bit for bit against the plain
    version and the NumPy planner: one warp a cloud up to 256 points (32
    and 33 points, one and two a lane; 256, eight a lane), a block past it
    (257, 1000, 2048); duplicated and NaN clouds on both; ``start`` the
    last point a lane or warp holds (lane 31's last register on one warp;
    on the block at 1000 points, 999 = the last warp's thread 231, its
    fourth point)."""
    threads, _ = plan_order.greedy_launch(n)
    assert (threads == 32) == (n <= plan_order.GREEDY_WARP_POINTS)
    pts = _cloud_batch(kind, batch, n, seed=n)
    got = plan_order.plan_greedy_cuda(torch.from_numpy(pts).to(cuda), start)
    want = plan_order.plan_greedy_plain(torch.from_numpy(pts), start)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for b in range(batch):
        np.testing.assert_array_equal(
            got[b].cpu().numpy(), tsched.greedy_nn_order(pts[b], start))


def _walk_inputs(seed, sizes, ks, batch):
    rng = np.random.default_rng(seed)
    below = [2 * sizes[0]] + list(sizes[:-1])
    nbrs = [torch.from_numpy(rng.integers(0, max(1, nb // 2),
                                          size=(batch, n, k)))
            for n, k, nb in zip(sizes, ks, below)]
    last = torch.from_numpy(np.stack([rng.permutation(sizes[-1])
                                      for _ in range(batch)]).astype(np.int32))
    return nbrs, last


@pytest.mark.parametrize("sizes,ks,batch", [
    ((512, 128), (16, 16), 8), ((60, 20, 7), (5, 6, 3), 4),
    ((9,), (2,), 2), ((4096, 1024, 256), (32, 16, 8), 2)])
def test_plan_coordinate_kernel_bitwise(cuda, sizes, ks, batch):
    nbrs, last = _walk_inputs(1, sizes, ks, batch)
    got_o, got_i = plan_order.plan_coordinate_cuda(
        [nb.to(cuda) for nb in nbrs], last.to(cuda))
    want_o, want_i = plan_order.plan_coordinate_plain(nbrs, last)
    torch.cuda.synchronize()
    for g, w in zip(got_o + got_i, want_o + want_i):
        assert torch.equal(g.cpu(), w)


def _walk_case(case, batch, rng):
    """Receptive fields ``(B, n_k, K)`` per layer (layer 1's into a layer
    0 of twice its points) and last orders for the walk's edges."""
    def fields(n, k, hi):
        return rng.integers(0, hi, size=(batch, n, k))
    if case == "k1":                  # one neighbour a row at every layer
        nbrs = [fields(40, 1, 80), fields(20, 1, 40), fields(10, 1, 20)]
    elif case == "repeats":           # every row meets a point 3 times
        nbrs = [fields(64, 8, 128), fields(16, 8, 64)]
        for nb in nbrs:
            nb[..., 1] = nb[..., 0]
            nb[..., -1] = nb[..., 0]
    elif case == "one_point":         # layer 2's rows all name point 7:
        nbrs = [fields(50, 4, 100),   # the other 49 of layer 1 orphans
                np.full((batch, 12, 5), 7)]
    elif case in ("half", "repeated_last"):  # each walk reaches half
        nbrs = [fields(64, 8, 128), fields(32, 8, 32), fields(8, 4, 16)]
    else:                             # "unwalked": layer 3 walks 5 of
        l2 = fields(20, 6, 30)        # layer 2's 20 rows; the other rows
        l2[:, 5:] = rng.integers(30, 60, size=(batch, 15, 6))  # name
        nbrs = [fields(60, 4, 120), l2, fields(7, 3, 5)]   # 30..59 only
    last = np.stack([rng.permutation(nbrs[-1].shape[1])
                     for _ in range(batch)]).astype(np.int32)
    if case == "repeated_last":       # the last order names a point twice
        last[:, -1] = last[:, 0]      # (and leaves one out: an orphan)
    return [nb.astype(np.int64) for nb in nbrs], last


def _planner_orders(nbrs, last):
    """The NumPy planner's completed orders of one cloud: the recursive
    walk (``coordinate_layers``) completed with ``complete_order``."""
    from repro_torch.core.workload import PointNetWorkload
    sizes = [nb.shape[0] for nb in nbrs]
    cfg = PointNetConfig(name="walk", n_points=2 * sizes[0], layers=tuple(
        SALayerSpec(n_centers=n, n_neighbors=nb.shape[1], in_features=4,
                    mlp=(4, 4)) for n, nb in zip(sizes, nbrs)))
    wl = PointNetWorkload(
        config=cfg, points=[np.zeros((2 * sizes[0], 3))]
        + [np.zeros((n, 3)) for n in sizes],
        centers=[None] * (len(sizes) + 1), neighbors=[None] + list(nbrs))
    plan = tsched.coordinate_layers(wl, last)
    return [tsched.complete_order(plan.order_of(k), n, k)
            for k, n in enumerate(sizes, start=1)]


@pytest.mark.parametrize("case", ["k1", "repeats", "one_point", "half",
                                  "unwalked", "repeated_last"])
@pytest.mark.parametrize("in_shared", [3, 2, 1, 0])
def test_plan_coordinate_kernel_walk_edges(cuda, monkeypatch, in_shared,
                                           case):
    """P2 at the walk's edges, bit for bit against the plain version and
    the NumPy planner: K = 1; rows that repeat a point; a level where
    every point but one is an orphan; walks that reach half of the layer
    below (walked < n_k); rows of a layer that the walk above never
    reaches, naming points nothing else does (they must stay orphans); a
    last order that names a point twice (the top level's general path:
    the others take its shortcut for a last order without repeats). Each
    with the first ``in_shared`` of the walk's three parts (levels, marks,
    fields) in shared memory and the rest in the device-memory workspace
    (shared memory made to look smaller)."""
    nbrs, last = _walk_case(case, 3, np.random.default_rng(7))
    sizes = [nb.shape[1] for nb in nbrs]
    ks = [nb.shape[2] for nb in nbrs]
    parts = plan_order._coordinate_parts(sizes, ks)
    monkeypatch.setattr(plan_order, "_MAX_SMEM_BYTES",
                        4 * (32 + sum(parts[:in_shared])))
    assert plan_order.coordinate_workspace(sizes, ks) == \
        sum(parts[in_shared:])
    t_nbrs = [torch.from_numpy(nb) for nb in nbrs]
    got_o, got_i = plan_order.plan_coordinate_cuda(
        [nb.to(cuda) for nb in t_nbrs], torch.from_numpy(last).to(cuda))
    want_o, want_i = plan_order.plan_coordinate_plain(
        t_nbrs, torch.from_numpy(last))
    torch.cuda.synchronize()
    for g, w in zip(got_o + got_i, want_o + want_i):
        assert torch.equal(g.cpu(), w)
    for b in range(last.shape[0]):
        want = _planner_orders([nb[b] for nb in nbrs], last[b])
        for g, w in zip(got_o, want):
            np.testing.assert_array_equal(g[b].cpu().numpy(), w)
        if case == "one_point":
            assert got_o[0][b, 0] == 7
            np.testing.assert_array_equal(
                got_o[0][b, 1:].cpu().numpy(),
                np.delete(np.arange(50), 7))
        if case == "unwalked":
            assert (got_o[0][b, -30:].cpu().numpy() == np.arange(30, 60)
                    ).all()


@pytest.mark.parametrize("sizes,ks,batch", [
    ((4096, 1024), (32, 32), 2), ((2048, 1024), (8, 64), 2),
    ((16384, 4096), (8, 16), 1)])
def test_plan_coordinate_kernel_past_shared_memory(cuda, sizes, ks, batch):
    """Walks that do not fit in shared memory, bit for bit against the
    plain version and the NumPy planner: fields of 32768 entries (the
    fields in the device-memory workspace), of 65536 (the marks too), and
    a layer of 16384 points (all of the walk there)."""
    assert plan_order.coordinate_workspace(sizes, ks) > 0
    nbrs, last = _walk_inputs(2, sizes, ks, batch)
    got_o, got_i = plan_order.plan_coordinate_cuda(
        [nb.to(cuda) for nb in nbrs], last.to(cuda))
    want_o, want_i = plan_order.plan_coordinate_plain(nbrs, last)
    torch.cuda.synchronize()
    for g, w in zip(got_o + got_i, want_o + want_i):
        assert torch.equal(g.cpu(), w)
    want = _planner_orders([nb[0].numpy() for nb in nbrs], last[0].numpy())
    for g, w in zip(got_o, want):
        np.testing.assert_array_equal(g[0].cpu().numpy(), w)


def test_plan_coordinate_kernel_on_the_main_path_geometry(cuda):
    """8 clouds of 1024 points through model1's geometry: the kNN views
    (strided rows) and P1's order, as ``device_build_plan`` hands them."""
    from repro_torch.models import pointnet2 as pn
    cfg = PAPER_MODELS["model1"]
    x = torch.from_numpy(_cloud_batch("normal", 8, 1024, seed=3)).to(cuda)
    pts, ctr, nbr = pn.geometry_pass(cfg, x)
    reset_launch_counts()
    plan = tsched.device_build_plan(nbr[1:], pts[-1], intra="greedy",
                                    coordinated=True)
    torch.cuda.synchronize()
    assert launch_counts()["plan_greedy"] == 1
    assert launch_counts()["plan_coordinate"] == 1
    want = tsched.device_build_plan([n.cpu() for n in nbr[1:]],
                                    pts[-1].cpu(), intra="greedy",
                                    coordinated=True)
    for k in (1, 2):
        assert torch.equal(plan.order_of(k).cpu(), want.order_of(k))
        assert torch.equal(plan.inverse_of(k).cpu(), want.inverse_of(k))


@pytest.mark.parametrize("idx", [torch.int64, torch.int32])
@pytest.mark.parametrize("batch,n,c,m,k", [
    (8, 1024, 8, 512, 16),      # model1 SA-1 gather, K4
    (8, 512, 256, 128, 16),     # model1 SA-2 gather, K4
    (1, 1024, 16, 512, 16),     # model2 SA-1, K5
    (1, 512, 512, 128, 16),     # model2 SA-2, K5
    (2, 64, 3, 24, 4),          # C not a multiple of 4
])
def test_aggregate_kernel_plan_order_bitwise(cuda, idx, batch, n, c, m, k):
    """The kernel composing the plan order itself equals the plain version
    over the indices permuted first, for per-cloud and shared orders and
    kNN-shaped strided index views."""
    g = torch.Generator(device="cpu").manual_seed(1)
    feats = torch.randn((batch, n, c), generator=g).to(cuda)
    wide = torch.randint(0, n, (batch, m, 2 * k), generator=g).to(idx)
    nbr = wide.to(cuda)[:, :, :k]                   # strided rows
    ctr = torch.randint(0, n, (batch, m), generator=g).to(idx).to(cuda)
    order = torch.stack([torch.randperm(m, generator=g)
                         for _ in range(batch)]).to(torch.int32).to(cuda)
    nbr_o, ctr_o = aggregate.plan_ordered(nbr, ctr, order)
    want = aggregate.aggregate_diff_batched_plain(feats, nbr_o, ctr_o)
    got = aggregate.aggregate_diff_batched(feats, nbr, ctr, order)
    shared = aggregate.aggregate_diff_batched(feats, nbr, ctr, order[0])
    one = aggregate.aggregate_diff(feats[0], nbr[0], ctr[0], order[0])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(one, want[0])
    assert torch.equal(shared[0], want[0])


@pytest.mark.parametrize("backend", ["reram-fused", "reram", "float"])
def test_device_planning_on_card_equals_host_planning(cuda, backend):
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    clouds = np.random.default_rng(2).normal(size=(3, 64, 3)).astype(
        np.float32)
    dev = compile_model(params, cfg, backend=backend, schedule="pointer")
    host = compile_model(params, cfg, backend=backend, schedule="pointer",
                         device_planning=False)
    assert dev.device_planning and not host.device_planning
    reset_launch_counts()
    got = dev.batched_forward(clouds)
    one = dev.forward(clouds[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["plan_greedy"] == 2 and counts["plan_coordinate"] == 2
    assert torch.equal(got, host.batched_forward(clouds))
    assert torch.equal(one, host.forward(clouds[0]))


@pytest.mark.parametrize("backend", ["reram-fused", "reram", "float"])
def test_captured_replays_equal_eager(cuda, backend):
    """``jit_batched_forward`` replays one CUDA graph per batch shape:
    bitwise equal to eager ``batched_forward`` over two inputs and two
    batch shapes; ``jit_forward`` and ``eval_step`` alike. A replay moves
    no launch counter: its kernels were counted when it was captured."""
    cfg = PAPER_MODELS["model0"]
    params = init_params(cfg, seed=0)
    model = compile_model(params, cfg, backend=backend, schedule="pointer")
    rng = np.random.default_rng(5)
    for batch in (4, 2):
        for _ in range(2):
            x = torch.from_numpy(rng.normal(size=(batch, 1024, 3)).astype(
                np.float32)).to(cuda)
            got = model.jit_batched_forward(x)
            assert torch.equal(got, model.batched_forward(x))
    reset_launch_counts()
    model.jit_batched_forward(x)
    torch.cuda.synchronize()
    assert set(launch_counts().values()) == {0}
    for c in x:
        assert torch.equal(model.jit_forward(c), model.forward(c))
    labels = torch.tensor([3, 9], device=cuda)
    nll, acc = model.eval_step(x, labels)
    e_nll, e_acc = model.loss_fn(x, labels)
    assert torch.equal(nll, e_nll) and torch.equal(acc, e_acc)
    assert len(model._graphs) == 4      # two batch shapes, forward, eval


def _serve_on_card(model, clouds, scheduler, *, reuse=False, servable=None):
    from repro_torch.core.schedule import FrameTracker
    from repro_torch.launch import (PointCloudServable, ServingEngine,
                                    ShapeBuckets)
    if servable is None:
        servable = PointCloudServable(
            model, buckets=ShapeBuckets(points=(48, 64), batch=(1, 2, 4)),
            frame_reuse=FrameTracker(tol=1e-3) if reuse else False)
    eng = ServingEngine(servable, scheduler=scheduler)
    reqs = [eng.submit(c, t=i * 1e-3,
                       deadline_us=10_000 if i in (1, 3) else None)
            for i, c in enumerate(clouds)]
    eng.drain(now=0.1)
    torch.cuda.synchronize()
    return servable, reqs


def _served_clouds(seed):
    rng = np.random.default_rng(seed)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32)
              for n in (40, 48, 56, 64, 44)]
    return clouds + [clouds[4] + np.float32(1e-6)]


@pytest.mark.parametrize("backend", ["reram-fused", "reram"])
@pytest.mark.parametrize("scheduler", ["fifo", "edf"])
@pytest.mark.parametrize("reuse", [False, True])
def test_served_rows_bitwise_on_card(cuda, backend, scheduler, reuse):
    """Every served row (point pads, batch pads, plan-cache and frame
    hits) equals ``forward`` on the bare cloud, on the card."""
    cfg = _tiny()
    model = compile_model(init_params(cfg, seed=0, n_classes=10), cfg,
                          backend=backend, schedule="pointer")
    clouds = _served_clouds(0)
    servable, reqs = _serve_on_card(model, clouds, scheduler, reuse=reuse)
    for req, cloud in zip(reqs, clouds):
        assert req.result.device.type == "cuda"
        assert torch.equal(req.result, model.forward(cloud)), req.id
    assert model.captures == servable.jit_traces > 0


def test_serving_captures_once_per_bucket_shape(cuda):
    """At most one capture per (batch bucket, point bucket); a second pass
    over the same stream captures nothing, launches nothing outside the
    replays (every plan a cache hit) and gives the same rows."""
    cfg = _tiny()
    model = compile_model(init_params(cfg, seed=0, n_classes=10), cfg,
                          backend="reram-fused", schedule="pointer")
    clouds = _served_clouds(1)
    servable, first = _serve_on_card(model, clouds, "fifo")
    captures = model.captures
    assert 0 < captures == servable.jit_traces <= 2 * 3
    reset_launch_counts()
    _, second = _serve_on_card(model, clouds, "fifo", servable=servable)
    assert set(launch_counts().values()) == {0}
    assert model.captures == captures == servable.jit_traces
    assert servable.plan_cache.stats()["hits"] == len(clouds)
    for a, b in zip(first, second):
        assert torch.equal(a.result, b.result)


def test_served_replay_on_a_new_batch_of_the_same_shape(cuda):
    cfg = _tiny()
    model = compile_model(init_params(cfg, seed=0, n_classes=10), cfg,
                          backend="reram-fused", schedule="pointer")
    _serve_on_card(model, _served_clouds(2), "edf")
    captures = model.captures
    clouds = _served_clouds(3)
    _, reqs = _serve_on_card(model, clouds, "edf")
    assert model.captures == captures
    for req, cloud in zip(reqs, clouds):
        assert torch.equal(req.result, model.forward(cloud)), req.id


# ---------------------------------------------------------------------------
# the cost model's launches, and the reliability path
# ---------------------------------------------------------------------------

def test_k2_first_launch_at_48_kb_in_a_fresh_process(cuda):
    """K2 at a widest k_lim of 128 takes exactly 48 KB of dynamic shared
    memory beside its 32 static bytes: a launch is refused unless the
    kernel's limit was raised, which ``allow_smem`` now does on every call
    (before, only above 48 KB — so the first such launch in a process
    failed). A fresh process, so that no earlier launch raised it."""
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    code = (
        "import numpy as np, torch\n"
        "from repro_torch.kernels import build_program, fused_mlp\n"
        "rng = np.random.default_rng(0)\n"
        "prog = build_program([{'w': rng.normal(size=(k, n)).astype("
        "np.float32), 'b': np.zeros(n, np.float32)} for k, n in "
        "((128, 128), (128, 128), (128, 256))]).cuda()\n"
        "x = torch.randn((1, 2048, 128), device='cuda')\n"
        "x_p, sx = fused_mlp.prepare_input(x, prog)\n"
        "got = fused_mlp.fused_mlp_mtiled_cuda(x_p, sx, prog, m_real=2048)\n"
        "want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=2048)\n"
        "assert torch.equal(got, want)\n"
        "assert fused_mlp.LAUNCHES['mtiled'] == 1\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(root / "src")},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("group", [16, 4])
def test_fused_kernels_on_ecc_widened_programs_bitwise(cuda, group):
    """K1, K2 and K3 on programs ECC widens (d_pad 256 -> 384/512 here,
    parity cells inside n_lim under col_mask = 0), and with stuck-at
    faults in dead rows and columns: equal to the plain version, and the
    protected program's output equal to the unprotected one's."""
    from repro_torch.reliability import EccConfig, FaultModel
    rng = np.random.default_rng(4)
    layers = _layers((130, 200, 70), rng)
    plain = build_program(layers).to(cuda)
    prot = build_program(layers, ecc=EccConfig(group)).to(cuda)
    faulted = FaultModel(p_stuck0=0.02, p_stuck1=0.02, seed=3).apply(
        build_program(layers, ecc=EccConfig(group))).to(cuda)
    assert prot.d_pad > plain.d_pad
    x = torch.from_numpy(rng.normal(size=(3, 257, 130))
                         .astype(np.float32)).to(cuda)
    outs = {}
    for name, prog in (("plain", plain), ("prot", prot),
                       ("faulted", faulted)):
        x_p, sx = fused_mlp.prepare_input(x, prog)
        want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=257)
        for mode in ("whole", "mtiled", "wstat"):
            got = fused_mlp.KERNEL_OF_MODE[mode](x_p, sx, prog, m_real=257)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, mode)
        outs[name] = want
    assert torch.equal(outs["prot"], outs["plain"])
    assert not torch.equal(outs["faulted"], outs["plain"])


def test_faulted_models_on_card_equal_cpu_and_replay(cuda):
    """Faulted 'reram-fused' (raw and under ECC) and 'reram' models on the
    card: the same programs as on the CPU (the draws are made there), the
    captured call equal to the eager one, and the logits within the
    card-vs-CPU tolerance with equal argmax."""
    from repro_torch.reliability import EccConfig, FaultModel
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    fm = FaultModel(p_stuck0=0.05, p_stuck1=0.05, sigma=0.2, seed=7)
    for backend, ecc in (("reram-fused", None), ("reram-fused", EccConfig(4)),
                         ("reram", None)):
        kw = {"backend": backend, "schedule": "pointer", "fault_model": fm}
        if ecc is not None:
            kw["ecc"] = ecc
        gpu = compile_model(params, cfg, **kw)
        cpu = compile_model(params, cfg, device="cpu", **kw)
        for (name, a), b in zip(gpu.backend.named_buffers(),
                                cpu.backend.buffers()):
            assert torch.equal(a.cpu(), b), name
        got = gpu.batched_forward(clouds)
        assert torch.equal(gpu.jit_batched_forward(clouds), got)
        want = cpu.batched_forward(clouds)
        assert float((got.cpu() - want).abs().max()) <= \
            1e-2 * float(want.abs().max())
        assert torch.equal(got.cpu().argmax(1), want.argmax(1))


def test_select_intra_refuses_while_capturing(cuda):
    """A multi-candidate policy cannot score orders inside a CUDA-graph
    capture (the port's counterpart of a traced value); a precommitted one
    answers from its single candidate."""
    from repro_torch import PlanPolicy
    from repro_torch.core.workload import PointNetWorkload
    cfg = _tiny()
    cloud = np.random.default_rng(1).normal(size=(64, 3))
    wl = PointNetWorkload.build(cloud, cfg)
    pre = PlanPolicy().precommit(wl)
    pts = torch.zeros((64, 3), device=cuda)
    probe = PointNetWorkload(config=cfg, points=[pts] * 3,
                             centers=wl.centers, neighbors=wl.neighbors)
    graph = torch.cuda.CUDAGraph()
    answers, errors = [], []
    with torch.cuda.graph(graph):
        pts.add_(1.0)
        answers.append(pre.select_intra(probe))
        try:
            PlanPolicy().select_intra(probe)
        except TypeError as e:
            errors.append(str(e))
    assert answers == [pre.intra_candidates[0]]
    assert errors and "precommit" in errors[0]


def test_precommitted_policy_plans_on_card_like_pointer(cuda):
    from repro_torch import PlanPolicy
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    pre = PlanPolicy(intra_candidates=("greedy",))
    model = compile_model(params, cfg, backend="reram-fused", policy=pre)
    ref = compile_model(params, cfg, backend="reram-fused",
                        schedule="pointer")
    assert model.device_planning
    reset_launch_counts()
    got = model.batched_forward(clouds)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["plan_greedy"] == 1 and counts["plan_coordinate"] == 1
    assert torch.equal(got, ref.batched_forward(clouds))
    assert torch.equal(model.jit_batched_forward(clouds), got)
    host = compile_model(params, cfg, backend="reram-fused",
                         policy=PlanPolicy())
    with pytest.raises(TypeError, match="precommit"):
        host.jit_batched_forward(clouds)


# ---------------------------------------------------------------------------
# training and the launch-contract verifier on the card
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return PointNetConfig(name="tiny", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32))))


@pytest.mark.parametrize("backend", ["float", "reram-fused", "reram"])
def test_contracts_hold_on_the_card_eager_and_captured(cuda, backend):
    from repro_torch import verify_contracts
    cfg = _tiny_cfg()
    model = compile_model(init_params(cfg, seed=0, n_classes=10), cfg,
                          backend=backend, schedule="pointer")
    clouds = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 64, 3)).astype(np.float32)).to(cuda)
    for x in (clouds, clouds[0]):
        report = verify_contracts(model, x, check_graph=True)
        report.raise_if_violated()
        assert report.graph["captured"]
        assert report.info.gather_launches == cfg.n_layers
        assert report.info.host_callbacks == ()


def test_verifier_catches_a_sync_on_the_card(cuda):
    from repro_torch import verify_contracts
    cfg = _tiny_cfg()
    model = compile_model(init_params(cfg, seed=0, n_classes=10), cfg,
                          schedule="pointer")

    class Chatty:
        def __init__(self):
            self.config, self.backend = model.config, model.backend
            self.backend_name, self.schedule = model.backend_name, \
                model.schedule
            self.planned, self.device = model.planned, model.device

        def forward(self, x):
            y = model.forward(x)
            return y * float(y.abs().max() > 0)

    x = torch.zeros((64, 3), device=cuda).normal_()
    report = verify_contracts(Chatty(), x)
    assert any(v.contract == "host-callbacks" and "cuda-sync" in
               (v.primitive or "") for v in report.violations)


def test_float_gradients_on_the_card_match_the_cpu(cuda):
    """The gathers' backward is a scatter-add, whose summation order on the
    card is not fixed: gradients within 1e-4 x max|g| of the CPU's."""
    from repro_torch.optim import tree_leaves, tree_map
    cfg = _tiny_cfg()
    rng = np.random.default_rng(2)
    clouds = rng.normal(size=(4, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev).requires_grad_(),
                          init_params(cfg, seed=0, n_classes=10))
        model = compile_model(params, cfg, device=dev)
        loss, acc = model.loss_fn(clouds, labels)
        out[dev] = (float(loss.detach()), float(acc),
                    [g.cpu() for g in torch.autograd.grad(
                        loss, tree_leaves(params))])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-6)
    assert out["cuda"][1] == out["cpu"][1]
    for g, c in zip(out["cuda"][2], out["cpu"][2]):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())
