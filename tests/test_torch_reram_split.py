"""K6's arithmetic on the tensor cores, held on the CPU.

K6 (``csrc/reram_mlp.cu``) combines the planes once per product into s8
weights ``w_s8[n][k]`` (its pre-pass), and where its row tiles and column
chunks alone would leave SMs idle it splits K over blocks that add their
partial sums into the output. The kernel runs only on the card
(``tests/test_torch_cuda.py``); here the pieces it rests on are held
against the JAX package:

- the pre-pass's plain version equals the JAX package's ``combine_planes``,
  transposed, on non-square planes;
- the split plan covers K and N exactly once at every shape of the model2
  'reram' path, and a torch emulation of the split (partial products
  summed in int32) equals the plain version and the JAX kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import encode_planes as jencode                # noqa: E402
from repro.kernels.ref import combine_planes as jcombine          # noqa: E402
from repro.kernels.reram_mlp import reram_matmul_int as jmatmul   # noqa: E402
from repro_torch import PAPER_MODELS                              # noqa: E402
from repro_torch.kernels import encode_planes, ref_reram_matmul_int  # noqa
from repro_torch.kernels.program import (                          # noqa: E402
    BLOCK_M, MMA_BLOCK_K, MMA_BLOCK_N, MMA_STRIPE_K, plan_reram)
from repro_torch.kernels.reram_mlp import reram_combine_plain     # noqa: E402

#: SMs of an H100 SXM, the card the split is planned for.
SMS = 132


def _model2_shapes():
    """``(m, k, n)`` of every K6 product of one model2 'reram'
    ``batched_forward`` on 8 clouds and one ``forward``: M = 65536, 16384
    and 8, then 8192, 2048 and 1."""
    cfg = PAPER_MODELS["model2"]
    mlps = [s.mlp for s in cfg.layers] + [(cfg.layers[-1].mlp[-1], 256, 40)]
    out = []
    for batch in (8, 1):
        rows = [batch * s.n_centers * s.n_neighbors for s in cfg.layers]
        for mlp, m in zip(mlps, rows + [batch]):
            out += [(m, k, n) for k, n in zip(mlp[:-1], mlp[1:])]
    return out


def test_model2_shapes_are_the_reram_path():
    shapes = _model2_shapes()
    assert shapes[:8] == [(65536, 16, 256), (65536, 256, 256),
                          (65536, 256, 512), (16384, 512, 512),
                          (16384, 512, 512), (16384, 512, 1024),
                          (8, 1024, 256), (8, 256, 40)]
    assert shapes[-2:] == [(1, 1024, 256), (1, 256, 40)]


@pytest.mark.parametrize("weight_bits", [4, 6, 8])
@pytest.mark.parametrize("n", [5, 40, 256])
@pytest.mark.parametrize("k", [3, 8, 16, 77, 256])
def test_prepass_plain_equals_jax_combine_planes(k, n, weight_bits):
    rng = np.random.default_rng(k * n + weight_bits)
    half = 1 << (weight_bits - 1)
    w = rng.integers(-half, half, size=(k, n))
    planes = np.array(jencode(jnp.asarray(w), weight_bits=weight_bits))
    assert planes.shape == (-(-weight_bits // 2), k, n)
    got = reram_combine_plain(torch.from_numpy(planes), 2, weight_bits)
    want = np.asarray(jcombine(jnp.asarray(planes), 2, weight_bits)).T
    assert got.dtype == torch.int8 and tuple(got.shape) == (n, k)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    np.testing.assert_array_equal(want, w.T)


@pytest.mark.parametrize("m,k,n", _model2_shapes())
def test_split_covers_k_and_n_once(m, k, n):
    plan = plan_reram(m, k, n, SMS)
    assert plan.k_step % MMA_BLOCK_K == 0 and plan.k_step <= MMA_STRIPE_K
    assert plan.k_pad % 16 == 0 and k <= plan.k_pad < k + 16
    for ranges, total in ((plan.k_ranges(), k), (plan.n_ranges(), n)):
        covered = np.zeros(total, np.int64)
        for lo, hi in ranges:
            assert lo < hi
            covered[lo:hi] += 1
        assert (covered == 1).all()
    assert plan.split == len(plan.k_ranges())
    blocks = len(plan.n_ranges()) * -(-m // BLOCK_M)
    # never more blocks than one wave where K is split ...
    assert blocks * plan.split <= max(blocks, SMS)
    if 2 * blocks > SMS:
        assert plan.split == 1          # the big layers: no atomics
    else:                               # ... and the head's K fills it
        assert blocks * plan.split >= min(SMS // 2,
                                          blocks * -(-plan.k_pad // 64))


@pytest.mark.parametrize("m,k,n", [(65536, 16, 256), (1, 4, 3),
                                   (3, 5000, 20), (200, 3000, 300)])
def test_split_takes_any_width(m, k, n):
    plan = plan_reram(m, k, n, SMS)
    assert plan.k_step <= MMA_STRIPE_K
    assert plan.k_ranges()[-1][1] == k
    assert plan.split >= -(-plan.k_pad // MMA_STRIPE_K)


def _emulate_split(x, planes, plan):
    """K6's blocks in torch: each (N chunk, row tile, K range) block
    multiplies its stripe by the s8 weights of its range exactly and adds
    the int32 partial sum into the zeroed output."""
    w = reram_combine_plain(planes).T.to(torch.int64)      # (k, n)
    out = torch.zeros((plan.m, plan.n), dtype=torch.int32)
    for n0, n1 in plan.n_ranges():
        for m0 in range(0, plan.m, BLOCK_M):
            rows = x[m0:m0 + BLOCK_M].to(torch.int64)
            for kb, ke in plan.k_ranges():
                part = rows[:, kb:ke] @ w[kb:ke, n0:n1]
                out[m0:m0 + BLOCK_M, n0:n1] += part.to(torch.int32)
    return out


def _pad(a, *mults):
    return np.pad(a, [(0, -s % mult) for s, mult in zip(a.shape, mults)])


@pytest.mark.parametrize("m,k,n", [
    (8, 1024, 256),      # model2 head, batch 8: 16 K ranges
    (1, 256, 40),        # model2 head's last layer, one cloud
    (1, 1024, 256),
    (130, 77, 5),        # ragged in every dimension
    (3, 3000, 20),       # wider than one stripe
    (200, 64, 300),      # no split: N past two chunks
])
def test_split_emulation_equals_plain_and_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int32)
    planes = np.array(jencode(jnp.asarray(w)))
    plan = plan_reram(m, k, n, SMS)
    if m <= 8:
        assert plan.split > 1
    xt, pt = torch.from_numpy(x), torch.from_numpy(planes)
    got = _emulate_split(xt, pt, plan)
    assert torch.equal(got, ref_reram_matmul_int(xt, pt))
    assert torch.equal(got, ref_reram_matmul_int(xt, encode_planes(
        torch.from_numpy(w))))
    # the JAX kernel on operands padded to its 128 blocks, as its
    # reram_linear pads them
    ref = np.asarray(jmatmul(jnp.asarray(_pad(x, 128, 128)),
                             jnp.asarray(_pad(planes, 1, 128, 128)),
                             interpret=True))[:m, :n]
    np.testing.assert_array_equal(got.numpy(), ref)
