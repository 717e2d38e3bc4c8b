"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and carries the ``cuda`` marker; the
``cuda`` fixture skips it where there is none. Run them on a machine with
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel and plain version must agree bit for bit: the kernels do every
integer step exactly and every float step as one correctly rounded IEEE
operation, as the plain versions do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import PAPER_MODELS, compile_model        # noqa: E402
from repro_torch.core.workload import (PointNetConfig,     # noqa: E402
                                       SALayerSpec)
from repro_torch.kernels import (KERNEL_SOURCES, _build,   # noqa: E402
                                 aggregate, build_program, encode_planes,
                                 fused_mlp, launch_counts,
                                 ref_reram_matmul_int, reram_mlp,
                                 reset_launch_counts)
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


@pytest.mark.parametrize("m,k,n", [
    (8192, 16, 256),       # model2 SA-1, first layer, one cloud
    (2048, 512, 1024),     # model2 SA-2, last layer, one cloud
    (8, 1024, 256),        # model2 head at batch 8
    (130, 77, 5),          # ragged in every dimension
    (1, 3, 2),
])
def test_reram_matmul_kernel_bitwise(cuda, m, k, n):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 128, size=(m, k))
                         .astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-127, 128, size=(k, n))
                         .astype(np.int32))
    planes = encode_planes(w).to(cuda)
    got = reram_mlp.reram_matmul_int_cuda(x, planes)
    want = ref_reram_matmul_int(x, planes)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want.cpu(), x.cpu().to(torch.int32) @ w)


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


#: The kernel counter each backend's MLPs must reach on the tiny model.
_COUNTER = {"reram-fused": "fused_mlp",
            "reram-fused-mtiled": "fused_mlp_mtiled",
            "reram-fused-wstat": "fused_mlp_wstat",
            "reram": "reram_matmul_int"}


@pytest.mark.parametrize("backend", sorted(_COUNTER))
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
    assert {k: counts[k] for k in _COUNTER.values()} == {
        k: want_n if k == _COUNTER[backend] else 0
        for k in _COUNTER.values()}
    want = cpu.batched_forward(clouds)
    # lift_features' sin/cos may differ by an ulp between the card and the
    # CPU, which can move one requantized value by one step
    tol = 1e-2 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got.argmax(1), want.argmax(1))
    assert torch.equal(one, got[0])


def test_model2_shaped_launch_counts(cuda):
    """model2 at full size, batch 2: 'reram-fused' runs SA-1 through K2,
    SA-2 through K3 and the head through K1, as the dataflow choice says;
    'reram' launches K6 once per layer and pass, and gives the same logits
    (zero biases: the two paths compute one function)."""
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
            counts["fused_mlp_wstat"]) == (2, 2, 2)
    assert torch.equal(one, logits[0])
    reset_launch_counts()
    ref = per_layer.batched_forward(clouds)
    per_layer.forward(clouds[0])
    torch.cuda.synchronize()
    assert launch_counts()["reram_matmul_int"] == 2 * 8
    assert torch.equal(ref, logits)
