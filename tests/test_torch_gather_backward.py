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
    gather_rows_backward, gather_rows_backward_cuda,
    gather_rows_backward_plain, segments)
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


def test_binding_matches_the_c_signature(monkeypatch):
    """The ctypes binding declares the pointers, ints and stream that
    ``gather_rows_backward`` in ``csrc/gather_backward.cu`` takes (a
    mismatch would show only on the card)."""
    class Lib:
        gather_rows_backward = type("Fn", (), {})()
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    fn = gather_backward._launch.__wrapped__()
    src = (_build.CSRC / "gather_backward.cu").read_text()
    sig = re.search(r"\bint gather_rows_backward\(([^)]*)\)", src)
    args = [a.strip() for a in sig.group(1).split(",")]
    kinds = ["ptr" if "*" in a else "int" for a in args]
    import ctypes
    assert [("ptr" if t is ctypes.c_void_p else "int")
            for t in fn.argtypes] == kinds
    assert kinds == ["ptr"] * 4 + ["int"] * 3 + ["ptr"]
