"""K7's launch plan (``plan_fps``), its binding to ``csrc/fps.cu``, the
integer-key argmax its kernels run, FPS past one block's points against
the JAX package, and the 'reram' backend's one weight check.

The kernels run only on the card (``tests/test_torch_cuda.py``). Here the
plan is held to the limits of an H100 block at every cloud size, the
ctypes binding to the C signature, and a NumPy emulation of the kernels'
reduction (order-preserving keys, warps over contiguous ranges, the first
slot on ties) to ``torch.argmax`` on ties, NaNs and pad rows."""
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.pointnet2 import farthest_point_sample as j_model_fps  # noqa: E402
from repro_torch import compile_model                             # noqa: E402
from repro_torch.core.workload import (PointNetConfig,            # noqa: E402
                                       SALayerSpec)
from repro_torch.kernels import _build, fps_batched, program      # noqa: E402
from repro_torch.kernels.fps_update import (                     # noqa: E402
    FPS_BLOCK_POINTS, FPS_MAX_CLUSTER, FPS_PER_THREAD, FPS_STREAM_THREADS,
    FPS_TIERS, FpsPlan, check_plan, plan_fps)
from repro_torch.models.pointnet2 import init_params              # noqa: E402

#: An H100 block's limits: threads, and shared memory in bytes.
_MAX_THREADS = 1024
_MAX_SMEM = 232448

_SIZES = sorted({1, 2, 31, 33, 255, 512, 1000, 1024, 4096, 4097, 8191,
                 8192, 8193, 16384, 16385, 65536, 100000, 131072, 131073,
                 300000, 2 ** 20, 2 ** 24 - 1, 2 ** 24}
                | {int(v) for v in np.random.default_rng(0).integers(
                    1, 2 ** 24, 40)})


@pytest.mark.parametrize("batch", [1, 8, 4096])
def test_plan_is_valid_for_every_cloud_size(batch):
    for n in _SIZES:
        plan = plan_fps(batch, n, 132)
        check_plan(plan, n)
        assert plan.tier in FPS_TIERS
        assert plan.threads <= _MAX_THREADS and plan.threads % 32 == 0
        assert plan.smem_bytes <= _MAX_SMEM
        assert 1 <= plan.cluster <= 16
        assert plan.regs <= plan.reg_budget <= 255
        if plan.tier == "streamed":
            assert plan.capacity is None
            assert plan.per_thread * plan.threads * plan.cluster >= n
        else:
            assert plan.capacity >= n
            assert plan.per_thread in FPS_PER_THREAD[plan.threads]


@pytest.mark.parametrize("n,tier,cluster", [
    (1, "block", 1), (1024, "block", 1), (FPS_BLOCK_POINTS, "block", 1),
    (FPS_BLOCK_POINTS + 1, "cluster", 2), (16385, "cluster", 3),
    (8 * FPS_BLOCK_POINTS, "cluster", 8),
    (8 * FPS_BLOCK_POINTS + 1, "cluster", 9),
    (FPS_MAX_CLUSTER * FPS_BLOCK_POINTS, "cluster", 16),
    (FPS_MAX_CLUSTER * FPS_BLOCK_POINTS + 1, "streamed", 8),
    (2 ** 24, "streamed", 8)])
def test_tier_changes_at_the_documented_sizes(n, tier, cluster):
    plan = plan_fps(8, n, 132)
    assert (plan.tier, plan.cluster) == (tier, cluster)
    # batch does not move the choice
    assert plan_fps(1, n, 132) == plan


def test_plan_takes_the_main_path_in_one_block_of_256():
    assert plan_fps(8, 1024, 132) == FpsPlan("block", 256, 4, 1)
    assert plan_fps(8, 512, 132) == FpsPlan("block", 256, 2, 1)
    assert plan_fps(1, 1024, 132) == FpsPlan("block", 256, 4, 1)


def test_a_card_of_few_sms_streams_what_it_cannot_cluster():
    assert plan_fps(1, 20000, 2).tier == "streamed"
    assert plan_fps(1, 20000, 2).cluster == 2
    assert plan_fps(1, 20000, 3).tier == "cluster"


@pytest.mark.parametrize("plan,n", [
    (FpsPlan("warp", 256, 4, 1), 1024),
    (FpsPlan("block", 256, 4, 2), 1024),
    (FpsPlan("cluster", 256, 4, 1), 1024),
    (FpsPlan("cluster", 256, 4, 17), 1024),
    (FpsPlan("block", 256, 3, 1), 512),
    (FpsPlan("block", 1024, 16, 1), 1024),
    (FpsPlan("block", 256, 2, 1), 1024),
    (FpsPlan("streamed", 256, 4, 8), 1024)])
def test_check_plan_refuses_what_the_kernel_does_not_take(plan, n):
    with pytest.raises(ValueError):
        check_plan(plan, n)


def test_binding_and_instantiations_match_the_c_source():
    """``fps_run``'s ctypes types follow its C signature, and the register
    tiers' (threads, points a thread) pairs and the streamed tier's threads
    are the ones the source instantiates."""
    import ctypes
    import types
    from repro_torch.kernels.fps_update import _bind_run
    src = (_build.CSRC / "fps.cu").read_text()
    sig = re.search(r"\bint fps_run\(([^)]*)\)", src)
    kinds = []
    for arg in sig.group(1).split(","):
        arg = arg.strip()
        kinds.append("ptr" if "*" in arg else
                     "i64" if arg.startswith("long long") else "int")
    assert kinds == ["ptr"] * 4 + ["i64"] * 4 + ["int"] * 4 + ["ptr"]
    lib = types.SimpleNamespace(fps_run=types.SimpleNamespace())
    _bind_run(lib)
    want = {"ptr": ctypes.c_void_p, "i64": ctypes.c_longlong,
            "int": ctypes.c_int}
    assert lib.fps_run.argtypes == [want[k] for k in kinds]
    shapes = src[src.index("#define FPS_SHAPES"):]
    shapes = shapes[:shapes.index("\n\n")]
    pairs = [tuple(map(int, m)) for m in
             re.findall(r"X\((\d+), (\d+)\)", shapes)]
    assert sorted(pairs) == sorted((t, p) for t, ps in FPS_PER_THREAD.items()
                                   for p in ps)
    streamed = re.search(r"constexpr int kStreamThreads = (\d+);", src)
    assert int(streamed.group(1)) == FPS_STREAM_THREADS


# ---------------------------------------------------------------------------
# the kernels' argmax, emulated
# ---------------------------------------------------------------------------

def _order_key(d: np.ndarray) -> np.ndarray:
    """``order_key`` of ``csrc/fps.cu`` in NumPy."""
    d = np.asarray(d, np.float32)
    bits = d.view(np.uint32)
    return np.where(d >= 0, bits | np.uint32(0x80000000),
                    np.where(np.isnan(d), np.uint32(0xFFFFFFFF),
                             ~bits)).astype(np.uint32)


def _emulate_argmax(d: np.ndarray, plan: FpsPlan) -> int:
    """One step's winner as the register tiers find it: warp w of block r
    holds the points [(r W + w) 32 PER, +32 PER), lane l the points
    l + 32 j, pad rows (-inf) beyond N; a thread keeps its first largest
    key, a warp
    the lowest index among its lanes' largest keys, and the block the
    first slot holding the largest slot key."""
    n = d.size
    per = plan.per_thread
    warps = plan.threads // 32 * plan.cluster
    keys = np.full(warps * 32 * per, _order_key(-np.inf), np.uint32)
    keys[:n] = _order_key(d)
    slot_key, slot_idx = [], []
    for w in range(warps):
        k = keys[w * 32 * per:(w + 1) * 32 * per].reshape(per, 32)
        best_j = np.argmax(k, axis=0)          # first largest over j
        best_k = k[best_j, np.arange(32)]
        rel = np.arange(32) + 32 * best_j
        kmax = best_k.max()
        slot_key.append(kmax)
        slot_idx.append(w * 32 * per + rel[best_k == kmax].min())
    return int(slot_idx[int(np.argmax(slot_key))])


def test_order_key_orders_as_torch_argmax():
    vals = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45,
                     3.4e38, 1.0, 2.5, np.float32(1.0) + np.float32(2e-7)],
                    np.float32)
    keys = _order_key(vals).astype(np.int64)
    for i, a in enumerate(vals):
        for j, b in enumerate(vals):
            if np.isnan(a) or np.isnan(b):
                assert (keys[i] == keys[j]) == (np.isnan(a) and np.isnan(b))
                assert (keys[i] > keys[j]) == (np.isnan(a)
                                               and not np.isnan(b))
            else:
                assert (keys[i] > keys[j]) == (a > b)
                assert (keys[i] == keys[j]) == (a == b)
    assert keys.min() >= 0x007FFFFF       # above every out-of-range row


def test_two_instruction_key_is_the_order_key_on_a_loops_distances():
    """The kernels key a distance as ``b ^ ((b >> 31) | 0x80000000)`` of
    its bits b: :func:`_order_key` on every value a loop's distance takes
    (+-inf, numbers >= +0.0, the card's canonical NaN 0x7FFFFFFF)."""
    rng = np.random.default_rng(5)
    d = np.concatenate([
        [np.inf, -np.inf, 0.0, 1e-45, 3.4e38],
        rng.uniform(0, 10, 200), rng.uniform(0, 1e-30, 50)]).astype(
            np.float32)
    d = np.concatenate([d, np.array([0x7FFFFFFF], np.uint32).view(
        np.float32)])
    b = d.view(np.int32)
    fast = (b ^ ((b >> 31) | np.int32(-2 ** 31))).view(np.uint32)
    np.testing.assert_array_equal(fast, _order_key(d))


@pytest.mark.parametrize("plan", [
    FpsPlan("block", 128, 8, 1), FpsPlan("block", 256, 4, 1),
    FpsPlan("block", 512, 2, 1), FpsPlan("cluster", 128, 2, 4),
    FpsPlan("cluster", 128, 1, 8)])
def test_emulated_kernel_argmax_equals_torch_argmax(plan):
    rng = np.random.default_rng(plan.threads * plan.cluster)
    n = 1000
    for case in range(40):
        d = rng.integers(0, 6, n).astype(np.float32)   # many ties
        if case % 4 == 1:
            d[rng.integers(0, n, 3)] = np.nan
        if case % 4 == 2:
            d[-rng.integers(1, 50):] = -np.inf         # pad rows
        if case % 4 == 3:
            d[:] = -np.inf
        d[rng.integers(0, n, 5)] = -0.0
        want = int(torch.argmax(torch.from_numpy(d)))
        assert _emulate_argmax(d, plan) == want, (case, plan)


# ---------------------------------------------------------------------------
# FPS past one block's points, against the JAX package
# ---------------------------------------------------------------------------

def test_fps_batched_past_one_block_equals_jax_model_fps():
    rng = np.random.default_rng(16385)
    pts = (rng.normal(size=(16385, 3)) * 2.0).astype(np.float32)
    pts[9000:9100] = pts[100:200]                     # exact ties
    got = fps_batched(torch.from_numpy(pts)[None], 36, 7)[0].numpy()
    want = np.asarray(j_model_fps(jnp.asarray(pts), 36, 7))
    np.testing.assert_array_equal(got, want)
    assert plan_fps(1, 16385, 132).tier == "cluster"


# ---------------------------------------------------------------------------
# 'reram': the weights are checked once, when the backend is built
# ---------------------------------------------------------------------------

def _tiny():
    return PointNetConfig(name="tiny", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32))))


def test_reram_refuses_a_nan_weight_at_compile_time():
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    params["sa"][1][0]["w"] = np.array(params["sa"][1][0]["w"], copy=True)
    params["sa"][1][0]["w"][2, 3] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        compile_model(params, cfg, backend="reram", device="cpu")


def test_reram_checks_no_weight_per_call(monkeypatch):
    cfg = _tiny()
    params = init_params(cfg, seed=0, n_classes=10)
    model = compile_model(params, cfg, backend="reram", device="cpu")
    weights = {id(lyr["w"]) for mlp in (*model.backend.sa,
                                        model.backend.head)
               for lyr in mlp.layers()}
    checked = []
    real = program.require_finite

    def counting(x):
        checked.append(x)
        real(x)

    monkeypatch.setattr(program, "require_finite", counting)
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    batched = model.batched_forward(clouds)
    assert checked == []
    one = model.forward(clouds[0])
    # the unbatched path checks its activations, one per layer, and no
    # weight
    assert len(checked) == sum(len(s.mlp) - 1 for s in cfg.layers) + 2
    assert not any(id(x) in weights for x in checked)
    assert torch.equal(one, batched[0])
