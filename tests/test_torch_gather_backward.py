"""P4, the feature gather's backward as a fixed-order segment sum
(``repro_torch.kernels.gather_backward``), and ``gather_rows`` over it,
against autograd's own gradient of ``take_along_dim`` and the JAX
package's gradient of ``jnp.take_along_axis`` and of ``features[nbr]``
(the reference's ``_sa_geometry``), on the same NumPy inputs.

Tolerances: none. The forward is ``take_along_dim`` itself, and the
backward adds each source row's gradient rows left to right in increasing
position from ``0.0``, the order of the CPU's sequential scatter-add and
of XLA's CPU scatter: bit for bit equal to both. The kernel against this
plain version is in ``tests/test_torch_train_graph.py`` (``cuda``
marker).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (gather_backward, launch_counts,   # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels import _build, record                     # noqa: E402
from repro_torch.kernels.gather_backward import (                   # noqa: E402
    FUSED_MAX_POSITIONS, FUSED_MAX_ROWS, fused_fits, gather_rows_backward,
    gather_rows_backward_cuda, gather_rows_backward_fused_cuda,
    gather_rows_backward_plain, segments, segments_cuda)
from repro_torch.models.pointnet2 import gather_rows               # noqa: E402

#: (x shape, idx shape, indices drawn below): duplicated indices (a few
#: rows drawn many times, the others never), a single cloud, the training
#: path's SA-2 gathers at batch 2 (neighbours and centres into 128 rows of
#: 64), and indices that leave most rows ungathered.
CASES = {
    "duplicates": ((3, 20, 5), (3, 7, 4), 5),
    "one-cloud": ((20, 5), (7, 4), 20),
    "sa2-neighbours": ((2, 128, 64), (2, 32, 16), 128),
    "sa2-centres": ((2, 128, 64), (2, 32), 128),
    "sparse": ((2, 64, 8), (2, 300), 3),
}


def _inputs(case, seed=0):
    shape_x, shape_i, hi = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape_x).astype(np.float32)
    idx = rng.integers(0, hi, shape_i)
    g = rng.normal(size=shape_i + (shape_x[-1],)).astype(np.float32)
    return x, idx, g


def _take_along(x, idx):
    """The gather as it was: ``take_along_dim`` with autograd's backward."""
    lead = x.shape[:-2]
    flat = idx.reshape(*lead, -1)
    out = torch.take_along_dim(x, flat[..., None], dim=-2)
    return out.reshape(*idx.shape, x.shape[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_is_take_along_dim_bitwise(case):
    x, idx, _ = _inputs(case)
    got = gather_rows(torch.from_numpy(x), torch.from_numpy(idx))
    want = _take_along(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_equals_autograd_and_the_reference_bitwise(case):
    x, idx, g = _inputs(case)
    xt = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(gather_rows(xt, torch.from_numpy(idx)), xt,
                               torch.from_numpy(g))
    was, = torch.autograd.grad(_take_along(xt, torch.from_numpy(idx)), xt,
                               torch.from_numpy(g))
    assert torch.equal(got, was)
    lead = x.shape[:-2]
    flat = jnp.asarray(idx.reshape(*lead, -1))

    def take(f):
        out = jnp.take_along_axis(f, flat[..., None], axis=-2)
        return out.reshape(*idx.shape, x.shape[-1])
    _, vjp = jax.vjp(take, jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    assert np.array_equal(np.asarray(want), got.numpy())
    if x.ndim == 2:                  # the reference's own features[nbr]
        _, vjp = jax.vjp(lambda f: f[jnp.asarray(idx)], jnp.asarray(x))
        want, = vjp(jnp.asarray(g))
        assert np.array_equal(np.asarray(want), got.numpy())


def test_rows_never_gathered_get_zero_and_duplicates_their_sum():
    x, idx, g = _inputs("sparse")
    got = gather_rows_backward(torch.from_numpy(g), torch.from_numpy(idx),
                               x.shape[1])
    assert got.shape == x.shape
    for b in range(x.shape[0]):
        for n in range(x.shape[1]):
            hits = np.flatnonzero(idx[b] == n)
            want = np.zeros(x.shape[-1], np.float32)
            for p in hits:                       # left to right, float32
                want = (want + g[b, p]).astype(np.float32)
            assert np.array_equal(got[b, n].numpy(), want), (b, n)
    assert not got[:, 3:].any()


def test_segments_are_stable_and_cover_every_row():
    idx = torch.tensor([[2, 0, 2, 2, 1], [1, 1, 0, 2, 1]])
    perm, starts = segments(idx, 3)
    assert starts.tolist() == [0, 1, 2, 5, 6, 9, 10]
    # row (0, 2) takes positions 0, 2, 3 in order; row (1, 1) 5, 6, 9
    assert perm[2:5].tolist() == [0, 2, 3]
    assert perm[6:9].tolist() == [5, 6, 9]
    assert sorted(perm.tolist()) == list(range(10))
    assert perm.dtype == starts.dtype == torch.int64


def test_plain_version_handles_no_positions():
    out = gather_rows_backward_plain(torch.zeros((0, 4)),
                                     torch.zeros((0,), dtype=torch.int64),
                                     torch.zeros((6,), dtype=torch.int64))
    assert out.shape == (5, 4) and not out.any()


def test_entry_point_is_recorded_and_counts_no_plain_launch():
    x, idx, g = _inputs("duplicates")
    reset_launch_counts()
    xt = torch.from_numpy(x).requires_grad_()
    with record.recording() as log:
        out = gather_rows(xt, torch.from_numpy(idx))
        torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert [name for name, _, _ in log] == ["gather_rows_backward"]
    assert log[0][1:] == (x.shape, torch.float32)
    assert launch_counts()["gather_rows_backward"] == 0


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    g, perm, starts = (torch.zeros((4, 3), dtype=torch.float64),
                       torch.zeros(4, dtype=torch.int64),
                       torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        gather_rows_backward_cuda(g, perm, starts)
    with pytest.raises(TypeError, match="int64"):
        gather_rows_backward_cuda(g.float(), perm.int(), starts)
    with pytest.raises(ValueError, match="shape"):
        gather_rows_backward_cuda(g.float(), perm[:3], starts)
    with pytest.raises(ValueError, match="shape mismatch"):
        gather_rows_backward(torch.zeros((2, 5, 3)),
                             torch.zeros((2, 4), dtype=torch.int64), 7)


def _c_signatures() -> dict:
    """``extern "C"`` functions of ``csrc/gather_backward.cu``: name ->
    argument kinds (``ptr``, ``int``, ``long``) and return kind."""
    src = (_build.CSRC / "gather_backward.cu").read_text()
    body = src[src.index('extern "C" {'):]
    sigs = {}
    for ret, name, args in re.findall(r"^(int|long long) (\w+)\(([^)]*)\)",
                                      body, flags=re.M):
        kinds = [("ptr" if "*" in a else "long" if "long long" in a
                  else "int") for a in (x.strip() for x in args.split(","))]
        sigs[name] = (kinds, "long" if ret == "long long" else "int")
    return sigs


def test_binding_matches_the_c_signature(monkeypatch):
    """The ctypes bindings declare the pointers, ints, 64-bit ints and
    stream that each C entry of ``csrc/gather_backward.cu`` takes, and its
    return type (a mismatch would show only on the card)."""
    import ctypes

    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    fns = gather_backward._entries.__wrapped__()
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_longlong: "long"}
    sigs = _c_signatures()
    assert set(fns) == set(sigs)
    for name, fn in fns.items():
        assert ([kind[t] for t in fn.argtypes], kind[fn.restype]) == \
            sigs[name], name
    assert sigs["gather_rows_backward"][0] == ["ptr"] * 4 + ["int"] * 3 + \
        ["ptr"]


def test_fused_limits_are_the_sources():
    """The module's path limits are the kernel's own constants."""
    src = (_build.CSRC / "gather_backward.cu").read_text()
    for const, value in (("kFusedMaxRows", FUSED_MAX_ROWS),
                         ("kFusedMaxPositions", FUSED_MAX_POSITIONS)):
        assert re.search(rf"constexpr int {const} = {value};", src), const


@pytest.mark.parametrize("batch,positions,n_rows,fits", [
    (16, 2048, 512, True), (16, 128, 512, True),      # SA-2's gathers
    (1, 2048, 2048, True), (1, 2048, 2560, True),     # MoE dispatch
    (1, 8192, 151936, False),                         # the LM embedding
    (1, FUSED_MAX_POSITIONS, FUSED_MAX_ROWS, True),
    (1, FUSED_MAX_POSITIONS + 1, 8, False),
    (3, 5, FUSED_MAX_ROWS + 1, False),
    (2, 0, 1, True), (0, 5, 8, False), (2, 5, 0, False)])
def test_fused_fits_takes_the_small_gathers(batch, positions, n_rows, fits):
    assert fused_fits(batch, positions, n_rows) is fits


def _numpy_segments(idx, n_rows):
    """An independent stable order: NumPy's stable argsort of the flat
    keys, and each row's first sorted position by a linear count."""
    lead = idx.shape[0]
    keys = (idx + n_rows * np.arange(lead)[:, None]).reshape(-1)
    perm = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=lead * n_rows)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return perm, starts


#: (L, P, n_rows, index draw): the cases the kernel's paths and their
#: boundaries meet. "one" puts every position on one row; "low" draws from
#: a few rows (many duplicates); "all" from every row.
SEGMENT_CASES = {
    "one-key-every-position": (3, 300, 40, "one"),
    "no-positions": (4, 0, 9, "all"),
    "one-row": (5, 17, 1, "all"),
    "many-batch-rows": (257, 12, 6, "all"),
    "rows-below-the-fused-limit": (2, 700, FUSED_MAX_ROWS - 1, "all"),
    "rows-at-the-fused-limit": (2, 700, FUSED_MAX_ROWS, "all"),
    "rows-past-the-fused-limit": (2, 700, FUSED_MAX_ROWS + 1, "all"),
    "positions-past-the-fused-limit": (1, FUSED_MAX_POSITIONS + 1, 300,
                                       "low"),
    "embedding-like": (1, 2000, 30000, "zipf"),
}


def _segment_idx(case, seed=0):
    lead, positions, n_rows, draw = SEGMENT_CASES[case]
    rng = np.random.default_rng(seed)
    if draw == "one":
        return np.full((lead, positions), n_rows // 2), n_rows
    if draw == "low":
        return rng.integers(0, 7, (lead, positions)), n_rows
    if draw == "zipf":
        z = rng.zipf(1.3, (lead, positions)) - 1
        return np.minimum(z, n_rows - 1), n_rows
    return rng.integers(0, n_rows, (lead, positions)), n_rows


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segments_are_a_stable_counting_sort(case):
    """``segments()``, the plain version the card's sorts are held to,
    against NumPy's stable sort at the paths' boundaries."""
    idx, n_rows = _segment_idx(case)
    perm, starts = segments(torch.from_numpy(idx), n_rows)
    want_perm, want_starts = _numpy_segments(idx, n_rows)
    assert perm.dtype == starts.dtype == torch.int64
    assert np.array_equal(perm.numpy(), want_perm)
    assert np.array_equal(starts.numpy(), want_starts)


@pytest.mark.parametrize("case", ["one-key-every-position", "no-positions",
                                  "one-row", "many-batch-rows",
                                  "rows-past-the-fused-limit"])
def test_backward_at_the_path_boundaries_equals_the_reference(case):
    """The gradient at the sort's boundary cases, bit for bit the JAX
    package's ``take_along_axis`` gradient (C = 3)."""
    idx, n_rows = _segment_idx(case)
    lead, positions = idx.shape
    rng = np.random.default_rng(1)
    x = rng.normal(size=(lead, n_rows, 3)).astype(np.float32)
    g = rng.normal(size=(lead, positions, 3)).astype(np.float32)
    got = gather_rows_backward(torch.from_numpy(g), torch.from_numpy(idx),
                               n_rows)

    def take(f):
        return jnp.take_along_axis(f, jnp.asarray(idx)[..., None], axis=-2)
    _, vjp = jax.vjp(take, jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_card_wrappers_refuse_what_the_kernels_do_not_take():
    """The sort's and the fused launch's checks, made before any launch."""
    idx = torch.zeros((2, 5), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        segments_cuda(idx.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        segments_cuda(torch.zeros((5, 2), dtype=torch.int64).t(), 4)
    with pytest.raises(ValueError, match="no rows"):
        segments_cuda(idx, 0)
    with pytest.raises(ValueError, match="too large"):
        segments_cuda(idx, 2 ** 30)
    g = torch.zeros((10, 3))
    with pytest.raises(TypeError, match="float32"):
        gather_rows_backward_fused_cuda(g.double(), idx, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        gather_rows_backward_fused_cuda(g[:9], idx, 4)
    with pytest.raises(ValueError, match="do not fit"):
        gather_rows_backward_fused_cuda(g, idx, FUSED_MAX_ROWS + 1)
