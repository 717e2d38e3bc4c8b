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
from repro_torch.kernels.aggregate import centers_per_block        # noqa: E402


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
    # model1: C=8 at SA-1 packs several centers per block; C=256 one
    assert centers_per_block(8, 512, 16, 8) > 1
    assert centers_per_block(8, 128, 16, 256) == 1
    assert 8 * -(-512 // centers_per_block(8, 512, 16, 8)) >= 2 * 132
