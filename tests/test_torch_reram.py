"""The port's per-layer crossbar matmul against the JAX package:
``reram_matmul_int`` (K6's plain version, on the CPU) against the JAX
kernel in interpret mode, bit for bit on the ints, and ``reram_linear``
against the JAX one — bit for bit at zero bias; with a bias XLA may
contract the dequant multiply-add into an FMA, so within ``rtol=1e-5``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import encode_planes as jencode                # noqa: E402
from repro.kernels.ops import reram_linear as jlinear             # noqa: E402
from repro.kernels.reram_mlp import reram_matmul_int as jmatmul   # noqa: E402
from repro_torch.kernels import (encode_planes, launch_counts,    # noqa: E402
                                 ref_reram_matmul_int, reram_linear,
                                 reram_matmul_int, reset_launch_counts)


def _pad(a, *mults):
    return np.pad(a, [(0, -s % m) for s, m in zip(a.shape, mults)])


@pytest.mark.parametrize("m,k,n", [(5, 3, 2), (130, 77, 5), (256, 128, 128),
                                   (64, 200, 300)])
def test_reram_matmul_int_equals_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int32)
    planes = np.array(jencode(jnp.asarray(w)))
    # the JAX kernel takes operands padded to its 128 blocks; the port's
    # needs no padding
    ref = np.asarray(jmatmul(jnp.asarray(_pad(x, 128, 128)),
                             jnp.asarray(_pad(planes, 1, 128, 128)),
                             interpret=True))[:m, :n]
    got = reram_matmul_int(torch.from_numpy(x), torch.from_numpy(planes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w)


def test_plain_version_is_the_signed_integer_product():
    w = torch.arange(-128, 128, dtype=torch.int32).reshape(16, 16)
    x = torch.arange(-120, 120, 15, dtype=torch.int8).reshape(1, 16)
    assert torch.equal(ref_reram_matmul_int(x, encode_planes(w)),
                       x.to(torch.int32) @ w)
    batch = torch.stack([x, -x])               # leading dims broadcast
    assert torch.equal(ref_reram_matmul_int(batch, encode_planes(w))[1],
                       -(x.to(torch.int32) @ w))


@pytest.mark.parametrize("lead,k,n", [((40,), 16, 24), ((3, 7), 130, 70),
                                      ((2, 4, 5), 8, 200)])
def test_reram_linear_zero_bias_bitwise_vs_jax(lead, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    ref = np.asarray(jlinear(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = reram_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == ref.shape == (*lead, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    zero = reram_linear(torch.from_numpy(x), torch.from_numpy(w),
                        torch.zeros(n))
    assert torch.equal(zero, got)


def test_reram_linear_with_bias_within_fma_tolerance():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(50, 33)).astype(np.float32)
    w = rng.normal(size=(33, 20)).astype(np.float32)
    b = rng.normal(size=(20,)).astype(np.float32)
    ref = np.asarray(jlinear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             interpret=True))
    got = reram_linear(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_batched_reram_linear_equals_per_input_loop_bitwise():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 6, 4, 12))
    x = torch.from_numpy((x * np.array([1.0, 30.0, 0.01]).reshape(3, 1, 1, 1))
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(12, 9)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(9,)).astype(np.float32))
    got = reram_linear(x, w, b, batched=True)
    for i in range(3):
        assert torch.equal(got[i], reram_linear(x[i], w, b))
    # one shared scale differs: the small-scale input loses resolution
    assert not torch.equal(reram_linear(x, w, b), got)


def test_cpu_runs_plain_version_and_counts_no_launch():
    reset_launch_counts()
    reram_linear(torch.ones((4, 8)), torch.ones((8, 3)))
    reram_linear(torch.ones((2, 4, 8)), torch.ones((8, 3)), batched=True)
    assert launch_counts()["reram_matmul_int"] == 0
    with pytest.raises(ValueError, match="no kernel"):
        reram_matmul_int(torch.zeros((2, 4), dtype=torch.int8,
                                     device="meta"),
                         torch.zeros((4, 4, 3), dtype=torch.int8,
                                     device="meta"))
