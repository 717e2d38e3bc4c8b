"""The port's plan-ordered gather (plain version, on CPU) against the JAX
package's ``aggregate_diff``/``_batched`` (Pallas in interpret mode):
exact float32 differences, equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import aggregate_diff as jagg                   # noqa: E402
from repro.kernels import aggregate_diff_batched as jagg_b         # noqa: E402
from repro_torch.kernels import (aggregate_diff,                   # noqa: E402
                                 aggregate_diff_batched, launch_counts,
                                 reset_launch_counts)
from repro_torch.kernels import aggregate                          # noqa: E402
from repro_torch.kernels.aggregate import gather_launch            # noqa: E402


def _inputs(batch, n, c, m, k, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, n, c)).astype(np.float32)
    nbr = rng.integers(0, n, size=(batch, m, k)).astype(np.int32)
    ctr = rng.integers(0, n, size=(batch, m)).astype(np.int32)
    return feats, nbr, ctr


@pytest.mark.parametrize("n,c,m,k", [(64, 4, 24, 4), (24, 16, 8, 4),
                                     (40, 3, 40, 7)])
def test_single_bitwise_vs_jax(n, c, m, k):
    feats, nbr, ctr = _inputs(1, n, c, m, k)
    ref = np.asarray(jagg(jnp.asarray(feats[0]), jnp.asarray(nbr[0]),
                          jnp.asarray(ctr[0])))
    got = aggregate_diff(torch.from_numpy(feats[0]), torch.from_numpy(nbr[0]),
                         torch.from_numpy(ctr[0])).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("batch,n,c,m,k", [(3, 64, 4, 24, 4),
                                           (2, 24, 16, 8, 4)])
def test_batched_bitwise_vs_jax(batch, n, c, m, k):
    feats, nbr, ctr = _inputs(batch, n, c, m, k, seed=1)
    ref = np.asarray(jagg_b(jnp.asarray(feats), jnp.asarray(nbr),
                            jnp.asarray(ctr)))
    got = aggregate_diff_batched(torch.from_numpy(feats),
                                 torch.from_numpy(nbr),
                                 torch.from_numpy(ctr)).numpy()
    assert got.shape == (batch, m, k, c)
    np.testing.assert_array_equal(got, ref)


def test_shape_checks_and_no_launch_on_cpu():
    reset_launch_counts()
    feats, nbr, ctr = (torch.from_numpy(a) for a in _inputs(2, 16, 4, 8, 3))
    aggregate_diff_batched(feats, nbr, ctr)
    aggregate_diff(feats[0], nbr[0], ctr[0])
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="batch mismatch"):
        aggregate_diff_batched(feats, nbr[:1], ctr)
    with pytest.raises(ValueError, match="shape mismatch"):
        aggregate_diff(feats[0], nbr[0], ctr[0, :3])


@pytest.mark.parametrize("m,k", [(0, 3), (5, 0)])
def test_empty_gather_launches_nothing(m, k):
    # an empty output returns before the launch, so no counter moves
    reset_launch_counts()
    feats = torch.zeros((2, 16, 4))
    nbr = torch.zeros((2, m, k), dtype=torch.int32)
    ctr = torch.zeros((2, m), dtype=torch.int32)
    for counter in ("aggregate_diff", "aggregate_diff_batched"):
        out = aggregate.aggregate_diff_cuda(feats, nbr, ctr, counter=counter)
        assert out.shape == (2, m, k, 4)
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="unknown launch counter"):
        aggregate.aggregate_diff_cuda(feats, nbr, ctr, counter="K4")


def test_centers_per_block_fills_the_card():
    # one thread a 16-byte chunk of an output row: a centre's K rows are
    # spread over blocks, so batch 1 at model2 SA-2 (128 x 16 x 512) and
    # model1 SA-1 at batch 8 (512 x 16 x 8) both give blocks for every SM
    assert gather_launch(128, 16, 512) == (4, 128 * 16 * 128 // 256)
    assert gather_launch(128, 16, 256)[1] >= 2 * 132
    assert gather_launch(512, 16, 8) == (4, 512 * 16 * 2 // 256)
    assert 8 * gather_launch(512, 16, 8)[1] >= 2 * 132
    # C not a multiple of 4, or rows not 16-byte aligned: one float a thread
    assert gather_launch(40, 7, 3) == (1, -(-40 * 7 * 3 // 256))
    assert gather_launch(8, 4, 16, aligned=False) == (1, 2)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch,n,c,m,k", [(3, 64, 4, 24, 4),
                                           (2, 40, 3, 40, 7)])
def test_plan_order_composed_bitwise_vs_jax(idx, batch, n, c, m, k):
    """With ``order``, row i is centre ``order[i]``'s: the same tensor as
    the reference's gather over the indices permuted first (the plain
    version the kernel is held to), for one order per cloud, one order
    batch-wide, and one cloud."""
    feats, nbr, ctr = _inputs(batch, n, c, m, k, seed=3)
    rng = np.random.default_rng(4)
    order = np.stack([rng.permutation(m) for _ in range(batch)]).astype(
        np.int32)
    t_f, t_nbr, t_ctr = (torch.from_numpy(a) for a in (feats, nbr, ctr))
    t_nbr, t_ctr = t_nbr.to(idx), t_ctr.to(idx)
    t_ord = torch.from_numpy(order)
    nbr_o = np.take_along_axis(nbr, order[:, :, None], axis=1)
    ctr_o = np.take_along_axis(ctr, order, axis=1)
    ref = np.asarray(jagg_b(jnp.asarray(feats), jnp.asarray(nbr_o),
                            jnp.asarray(ctr_o)))
    got = aggregate_diff_batched(t_f, t_nbr, t_ctr, t_ord).numpy()
    np.testing.assert_array_equal(got, ref)
    shared = aggregate_diff_batched(t_f, t_nbr, t_ctr, t_ord[0]).numpy()
    np.testing.assert_array_equal(
        shared[0], np.asarray(jagg(jnp.asarray(feats[0]),
                                   jnp.asarray(nbr[0][order[0]]),
                                   jnp.asarray(ctr[0][order[0]]))))
    one = aggregate_diff(t_f[1], t_nbr[1], t_ctr[1], t_ord[1]).numpy()
    np.testing.assert_array_equal(one, ref[1])
    # kNN's (M, K) index view of a wider sort: strided rows
    wide = torch.cat([t_nbr, t_nbr], dim=2)[:, :, :k]
    np.testing.assert_array_equal(
        aggregate_diff_batched(t_f, wide, t_ctr, t_ord).numpy(), ref)
    with pytest.raises(ValueError, match="does not match"):
        aggregate_diff_batched(t_f, t_nbr, t_ctr, t_ord[:, :-1])


def test_binding_matches_the_c_signature():
    """``aggregate_diff``'s ctypes types follow its C signature (a
    mismatch shows only on the card)."""
    import ctypes
    import re
    import types
    from repro_torch.kernels import _build
    src = (_build.CSRC / "aggregate.cu").read_text()
    sig = re.search(r"\bint aggregate_diff\(([^)]*)\)", src)
    want = {"ptr": ctypes.c_void_p, "i64": ctypes.c_longlong,
            "int": ctypes.c_int}
    kinds = ["ptr" if "*" in a else "i64" if "long long" in a else "int"
             for a in sig.group(1).split(",")]
    lib = types.SimpleNamespace(aggregate_diff=types.SimpleNamespace())
    aggregate._bind(lib)
    assert lib.aggregate_diff.argtypes == [want[k] for k in kinds]
