"""The port's on-device planning twins (``repro_torch.core.schedule``'s
``device_*``, over ``kernels/plan_order.py``'s plain versions of P1 and
P2) against the NumPy oracles and the JAX package's twins, on the same
float32 inputs made from a numpy seed: every order equal bit for bit, ties
to the first index, orphans appended ascending. Also NumPy emulations of
the two kernels' decompositions: P1's integer argmin keys and P2's
level-by-level first-occurrence walk, held against ``np.argmin`` and the
reference's recursive ``coordinate_layers``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import schedule as jsched                          # noqa: E402
from repro_torch.core import schedule as tsched                    # noqa: E402
from repro_torch.core.schedule import (GREEDY_DENSE_LIMIT,         # noqa: E402
                                       DevicePlan, device_build_plan,
                                       device_coordinate,
                                       device_order_greedy,
                                       device_order_morton)
from repro_torch.core.workload import (PointNetConfig,             # noqa: E402
                                       PointNetWorkload, SALayerSpec)
from repro_torch.kernels import (launch_counts, plan_order,        # noqa: E402
                                 reset_launch_counts)


def clustered(rng, n):
    """Tight clusters: many near-equal distances, so tie-breaks matter
    (made as the JAX package's own device-planning tests make them)."""
    ctrs = rng.normal(size=(max(1, n // 8), 3)) * 4.0
    pick = rng.integers(0, ctrs.shape[0], size=n)
    return (ctrs[pick] + 0.25 * rng.normal(size=(n, 3))).astype(np.float32)


def _clouds(kind, batch, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(batch, n, 3)).astype(np.float32)
    if kind == "clustered":
        return np.stack([clustered(rng, n) for _ in range(batch)])
    if kind == "grid":                           # exact ties everywhere
        side = int(np.ceil(n ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)[:n].astype(np.float32)
        return np.stack([g + b for b in range(batch)])
    if kind == "dup":                            # every point four times
        base = rng.normal(size=(batch, -(-n // 4), 3)).astype(np.float32)
        return np.repeat(base, 4, axis=1)[:, :n]
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# P1: the greedy order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "clustered", "grid", "dup"])
@pytest.mark.parametrize("n", [1, 5, 33, 96, 128])
def test_device_greedy_equals_oracle_and_jax(kind, n):
    pts = _clouds(kind, 3, n, seed=n)
    start = (7 * n) % n if n else 0
    got = device_order_greedy(torch.from_numpy(pts), start=start)
    assert got.dtype == torch.int32 and got.shape == (3, n)
    for b in range(3):
        oracle = tsched.greedy_nn_order(pts[b], start=start)
        jax_twin = np.asarray(jsched.device_order_greedy(
            jnp.asarray(pts[b]), start=start))
        np.testing.assert_array_equal(got[b].numpy(), oracle)
        np.testing.assert_array_equal(got[b].numpy(), jax_twin)
        # the single-cloud call is the batch's row
        assert torch.equal(device_order_greedy(torch.from_numpy(pts[b]),
                                               start=start), got[b])


@pytest.mark.parametrize("where", ["nan", "inf"])
def test_device_greedy_nan_and_inf_follow_argmin(where):
    """A NaN distance goes first (``np.argmin``/``jnp.argmin`` return the
    first NaN); +inf distances tie with removed points, and the first index
    wins, removed or not, as in the reference."""
    pts = _clouds("normal", 1, 40, seed=9)
    pts[0, 11, 1] = np.nan if where == "nan" else np.inf
    pts[0, 23, 0] = np.nan if where == "nan" else -np.inf
    got = device_order_greedy(torch.from_numpy(pts))[0].numpy()
    np.testing.assert_array_equal(got, tsched.greedy_nn_order(pts[0]))
    np.testing.assert_array_equal(got, np.asarray(
        jsched.device_order_greedy(jnp.asarray(pts[0]))))


def test_device_greedy_at_the_dense_limit_and_past_it():
    pts = _clouds("normal", 1, GREEDY_DENSE_LIMIT, seed=3)
    got = device_order_greedy(torch.from_numpy(pts))[0].numpy()
    np.testing.assert_array_equal(got, tsched.greedy_nn_order(pts[0]))
    big = torch.zeros((GREEDY_DENSE_LIMIT + 1, 3))
    with pytest.raises(ValueError, match=f"n <= {GREEDY_DENSE_LIMIT}"):
        device_order_greedy(big)
    with pytest.raises(ValueError, match=f"n <= {GREEDY_DENSE_LIMIT}"):
        jsched.device_order_greedy(jnp.zeros((GREEDY_DENSE_LIMIT + 1, 3)))


def _min_key(d: np.ndarray) -> np.ndarray:
    """P1's argmin key (``min_key`` in ``csrc/plan.cu``): NaN 0, else the
    float32 bits + 1 (distances are +0.0 or more)."""
    bits = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(np.isnan(d), 0, bits + 1)


@pytest.mark.parametrize("threads,per", [(32, 1), (64, 2), (256, 8)])
def test_p1_key_reduction_is_np_argmin(threads, per):
    """NumPy emulation of one P1 step: each thread's first least key over
    its points (tid + T j), each warp's least key then least index (two
    REDUX), the slots reduced the same way; removed points keyed as
    +inf. Equal to ``np.argmin`` of the reference's masked row."""
    rng = np.random.default_rng(threads)
    n = threads * per - 3
    for trial in range(30):
        d = rng.choice([0.0, 0.5, 1.0, 2.0, np.inf, np.nan], size=n,
                       p=[.1, .3, .3, .2, .05, .05]).astype(np.float32)
        removed = rng.random(n) < 0.3
        masked = np.where(removed, np.float32(np.inf), d)
        keys = np.where(removed, _min_key(np.float32(np.inf)), _min_key(d))
        kt = np.full((threads, per), 2 ** 32 - 1, np.uint64)
        it = np.full((threads, per), 2 ** 32 - 1, np.uint64)
        p = np.arange(threads)[:, None] + threads * np.arange(per)[None]
        ok = p < n
        kt[ok], it[ok] = keys[p[ok]], p[ok]
        first = np.argmin(kt, axis=1)                # first least key
        tk, ti = kt[np.arange(threads), first], it[np.arange(threads), first]
        wk = tk.reshape(-1, 32).min(axis=1)
        wi = np.where(tk.reshape(-1, 32) == wk[:, None], ti.reshape(-1, 32),
                      2 ** 32 - 1).min(axis=1)
        cur = wi[wk == wk.min()].min()
        assert cur == np.argmin(masked), trial


def test_greedy_launch_shapes():
    for n in (1, 31, 32, 33, 128, 256, 257, 1000, 2048):
        threads, per = plan_order.greedy_launch(n)
        assert threads % 32 == 0 and threads <= plan_order.GREEDY_THREADS
        assert per in plan_order.GREEDY_PER_THREAD
        assert threads * per >= n
    assert plan_order.greedy_launch(128) == (128, 1)
    assert plan_order.greedy_launch(2048) == (256, 8)
    for n in (0, 2049):
        with pytest.raises(ValueError, match="points a cloud"):
            plan_order.greedy_launch(n)


# ---------------------------------------------------------------------------
# Morton
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flat_axes", [(), (2,), (1, 2), (0, 1, 2)])
@pytest.mark.parametrize("kind", ["normal", "clustered", "grid"])
def test_device_morton_equals_oracle_and_jax(kind, flat_axes):
    pts = _clouds(kind, 2, 77, seed=5)
    for a in flat_axes:                          # degenerate extents
        pts[:, :, a] = 0.3
    got = device_order_morton(torch.from_numpy(pts))
    assert got.dtype == torch.int32
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      tsched.morton_order(pts[b]))
        np.testing.assert_array_equal(got[b].numpy(),
                                      jsched.morton_order(pts[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(
            jsched.device_order_morton(jnp.asarray(pts[b]))))
    with pytest.raises(ValueError, match="uint32"):
        device_order_morton(torch.from_numpy(pts), nbits=11)


# ---------------------------------------------------------------------------
# P2: the coordination walk
# ---------------------------------------------------------------------------

def _walk_first_occurrence(neighbors, last_order, threads=None):
    """NumPy emulation of P2: level by level, each layer's order the first
    occurrences of its stream in stream order, then its orphans ascending.
    With ``threads``, as ``csrc/plan.cu`` computes it: first positions by
    a running minimum, then chunked exclusive scans (thread t over a
    contiguous chunk) of the first-occurrence flags and of the orphans."""
    L = len(neighbors)
    sizes = [nb.shape[0] for nb in neighbors]
    orders = [None] * L
    stream, walked = np.asarray(last_order), None
    for level in range(L - 1, -1, -1):
        n = sizes[level]
        if level < L - 1:
            up = orders[level + 1][:walked]
            stream = neighbors[level + 1][up].reshape(-1)
        first = np.full(n, np.iinfo(np.int64).max)
        for s, p in enumerate(stream):
            first[p] = min(first[p], s)
        is_first = first[stream] == np.arange(stream.size)
        if threads is None:
            walk = stream[is_first]
            orphans = np.flatnonzero(first == np.iinfo(np.int64).max)
            order = np.concatenate([walk, orphans])
        else:
            order = np.empty(n, np.int64)
            cs = -(-stream.size // threads)
            cnt = [int(is_first[t * cs:(t + 1) * cs].sum())
                   for t in range(threads)]
            at = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            for t in range(threads):
                sel = stream[t * cs:(t + 1) * cs][is_first[t * cs:
                                                           (t + 1) * cs]]
                order[at[t]:at[t] + sel.size] = sel
            total = int(sum(cnt))
            cp = -(-n // threads)
            orph = first == np.iinfo(np.int64).max
            cnt2 = [int(orph[t * cp:(t + 1) * cp].sum())
                    for t in range(threads)]
            at2 = total + np.concatenate([[0], np.cumsum(cnt2)[:-1]])
            for t in range(threads):
                sel = np.flatnonzero(orph[t * cp:(t + 1) * cp]) + t * cp
                order[at2[t]:at2[t] + sel.size] = sel
        walked = int(is_first.sum())
        orders[level] = order
    return orders


def _random_structure(rng, sizes, ks, dup=True):
    """Receptive fields ``neighbors[k-1]`` (n_k, K_k) into layer k-1 (layer
    1's into a layer-0 of 2 n_1 points), rows with repeated members when
    ``dup``, and few enough members that every layer has orphans."""
    below = [2 * sizes[0]] + list(sizes[:-1])
    nbrs = []
    for n, k, nb in zip(sizes, ks, below):
        rows = rng.integers(0, max(1, nb // 2), size=(n, k))
        if dup:
            rows[:, -1] = rows[:, 0]
        nbrs.append(rows.astype(np.int64))
    return nbrs


def _workload(nbrs):
    sizes = [nb.shape[0] for nb in nbrs]
    cfg = PointNetConfig(name="walk", n_points=2 * sizes[0], layers=tuple(
        SALayerSpec(n_centers=n, n_neighbors=nb.shape[1], in_features=4,
                    mlp=(4, 4)) for n, nb in zip(sizes, nbrs)))
    pts = [np.zeros((2 * sizes[0], 3))] + [np.zeros((n, 3)) for n in sizes]
    return PointNetWorkload(config=cfg, points=pts, centers=[None] * (
        len(sizes) + 1), neighbors=[None] + list(nbrs))


STRUCTURES = {
    "two_layers": ((24, 8), (4, 4)),
    "three_layers": ((60, 20, 7), (5, 6, 3)),
    "wide_rows": ((40, 10), (3, 9)),
    "one_layer": ((9,), (2,)),
}


@pytest.mark.parametrize("name", sorted(STRUCTURES))
@pytest.mark.parametrize("threads", [None, 1, 4, 1024])
def test_p2_first_occurrence_walk_equals_the_recursion(name, threads):
    """P2's decomposition, emulated in NumPy, against
    ``coordinate_layers``'s recursion (port and reference) completed with
    ``complete_order``: duplicate members, ragged orphans, 1 to 3 layers,
    last orders that are permutations or repeat a point."""
    sizes, ks = STRUCTURES[name]
    for seed in range(6):
        rng = np.random.default_rng(seed)
        nbrs = _random_structure(rng, sizes, ks, dup=seed % 2 == 0)
        last = rng.permutation(sizes[-1])
        if seed == 5:
            last[-1] = last[0]                   # a repeated last point
        wl = _workload(nbrs)
        got = _walk_first_occurrence(nbrs, last, threads)
        for impl in (tsched, jsched):
            plan = impl.coordinate_layers(wl, last)
            for k, n in enumerate(sizes, start=1):
                want = tsched.complete_order(plan.order_of(k), n, k)
                np.testing.assert_array_equal(got[k - 1], want)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_device_coordinate_equals_oracle_and_jax(name):
    sizes, ks = STRUCTURES[name]
    batch = 3
    rng = np.random.default_rng(11)
    per = [_random_structure(rng, sizes, ks, dup=b != 1)
           for b in range(batch)]
    lasts = np.stack([rng.permutation(sizes[-1]) for _ in range(batch)])
    t_nbrs = [torch.from_numpy(np.stack([p[k] for p in per]))
              for k in range(len(sizes))]
    t_last = torch.from_numpy(lasts.astype(np.int32))
    orders = device_coordinate(t_nbrs, t_last)
    _, inverses = plan_order.plan_coordinate(t_nbrs, t_last)
    for b in range(batch):
        wl = _workload(per[b])
        host = tsched.coordinate_layers(wl, lasts[b])
        jax_orders = jsched.device_coordinate(
            [jnp.asarray(nb) for nb in per[b]], jnp.asarray(lasts[b]))
        for k, n in enumerate(sizes, start=1):
            o = orders[k - 1][b]
            assert o.dtype == torch.int32
            np.testing.assert_array_equal(
                o.numpy(), tsched.complete_order(host.order_of(k), n, k))
            np.testing.assert_array_equal(o.numpy(),
                                          np.asarray(jax_orders[k - 1]))
            np.testing.assert_array_equal(
                inverses[k - 1][b].numpy(),
                tsched.inverse_permutation(o.numpy()))
        single = device_coordinate([nb[b] for nb in t_nbrs], t_last[b])
        for k in range(len(sizes)):
            assert torch.equal(single[k], orders[k][b])


def test_device_complete_and_inverse_equal_jax():
    rng = np.random.default_rng(2)
    n = 12
    done = rng.random((4, n)) < 0.5
    order = np.zeros((4, n), np.int32)
    ptr = done.sum(1)
    for b in range(4):
        order[b, :ptr[b]] = rng.permutation(np.flatnonzero(done[b]))
    got = tsched._device_complete(torch.from_numpy(order),
                                  torch.from_numpy(ptr),
                                  torch.from_numpy(done))
    for b in range(4):
        want = np.asarray(jsched._device_complete(
            jnp.asarray(order[b]), jnp.asarray(ptr[b]),
            jnp.asarray(done[b])))
        np.testing.assert_array_equal(got[b].numpy(), want)
        np.testing.assert_array_equal(
            tsched._device_inverse(got[b]).numpy(),
            np.asarray(jsched._device_inverse(jnp.asarray(want))))


# ---------------------------------------------------------------------------
# the whole plan
# ---------------------------------------------------------------------------

def _geometry(seed, n_clouds=3):
    cfg = PointNetConfig(name="tiny", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=8,
                    mlp=(8, 8))))
    rng = np.random.default_rng(seed)
    wls = [PointNetWorkload.build(rng.normal(size=(64, 3)), cfg)
           for _ in range(n_clouds)]
    last = np.stack([w.points[-1] for w in wls]).astype(np.float32)
    nbrs = [np.stack([w.neighbors[k] for w in wls]) for k in (1, 2)]
    return last, nbrs


@pytest.mark.parametrize("intra", ["index", "greedy", "morton"])
@pytest.mark.parametrize("coordinated", [False, True])
def test_device_build_plan_equals_jax_and_lowered_oracle(intra, coordinated):
    last, nbrs = _geometry(seed=7)
    t_nbrs = [torch.from_numpy(nb) for nb in nbrs]
    plan = device_build_plan(t_nbrs, torch.from_numpy(last), intra=intra,
                             coordinated=coordinated)
    assert plan.batched and plan.batch_size == 3
    assert plan.layer_sizes == (24, 8)
    assert (plan.intra, plan.coordinated) == (intra, coordinated)
    for b in range(3):
        jplan = jsched.device_build_plan(
            [jnp.asarray(nb[b].astype(np.int32)) for nb in nbrs],
            jnp.asarray(last[b]), intra=intra, coordinated=coordinated)
        single = device_build_plan([nb[b] for nb in t_nbrs],
                                   torch.from_numpy(last[b]), intra=intra,
                                   coordinated=coordinated)
        assert not single.batched
        for k in (1, 2):
            for got, want in ((plan.order_of(k)[b], jplan.order_of(k)),
                              (plan.inverse_of(k)[b], jplan.inverse_of(k)),
                              (single.order_of(k), jplan.order_of(k)),
                              (single.inverse_of(k), jplan.inverse_of(k))):
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # batched equals the stack of the per-cloud plans
    stacked = DevicePlan.stack([
        device_build_plan([nb[b] for nb in t_nbrs], torch.from_numpy(last[b]),
                          intra=intra, coordinated=coordinated)
        for b in range(3)])
    for k in (1, 2):
        assert torch.equal(stacked.order_of(k), plan.order_of(k))
        assert torch.equal(stacked.inverse_of(k), plan.inverse_of(k))
    with pytest.raises(ValueError, match="unknown intra"):
        device_build_plan(t_nbrs, torch.from_numpy(last), intra="auto")


def test_plan_wrappers_check_shapes_and_launch_nothing_on_cpu():
    reset_launch_counts()
    last, nbrs = _geometry(seed=1, n_clouds=2)
    t_nbrs = [torch.from_numpy(nb) for nb in nbrs]
    device_build_plan(t_nbrs, torch.from_numpy(last), intra="greedy",
                      coordinated=True)
    assert launch_counts()["plan_greedy"] == 0
    assert launch_counts()["plan_coordinate"] == 0
    with pytest.raises(ValueError, match="plan_coordinate wants"):
        plan_order.plan_coordinate(t_nbrs, torch.zeros((2, 7),
                                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="plan_coordinate wants"):
        plan_order.plan_coordinate([], torch.zeros((2, 8),
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="start=8"):
        plan_order.plan_greedy(torch.from_numpy(last), start=8)
    with pytest.raises(ValueError, match=r"\(B, n, d\)"):
        plan_order.plan_greedy(torch.zeros(3))


def test_plan_bindings_match_the_c_signatures():
    """P1's and P2's ctypes types follow ``csrc/plan.cu``'s C signatures
    (a mismatch shows only on the card)."""
    import ctypes
    import re
    import types
    from repro_torch.kernels import _build
    src = (_build.CSRC / "plan.cu").read_text()
    want = {"ptr": ctypes.c_void_p, "i64": ctypes.c_longlong,
            "int": ctypes.c_int}
    lib = types.SimpleNamespace(plan_greedy=types.SimpleNamespace(),
                                plan_coordinate=types.SimpleNamespace())
    plan_order._bind(lib)
    for fn in ("plan_greedy", "plan_coordinate"):
        sig = re.search(rf"\bint {fn}\(([^)]*)\)", src)
        kinds = ["ptr" if "*" in a else "i64" if "long long" in a else "int"
                 for a in sig.group(1).split(",")]
        assert getattr(lib, fn).argtypes == [want[k] for k in kinds], fn
