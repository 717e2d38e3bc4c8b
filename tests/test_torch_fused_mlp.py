"""The port's fused crossbar MLP (plain version, on CPU) against the JAX
package's ``reram_mlp_fused``/``_batched`` (Pallas in interpret mode) and
against ``tests/test_fused_mlp.py``'s correctly rounded NumPy oracle.

Zero biases leave no multiply-add for XLA to contract into an FMA, so the
results must be equal bit for bit. With biases XLA may contract the
dequant ``y * c + bias`` (``repro/kernels/fused_mlp.py:59-68``), so the
comparison takes the JAX suite's own tolerance: ``rtol=1e-5`` and
``atol=1e-5 * max|ref|``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_fused_mlp import _numpy_quant_chain                     # noqa: E402

from repro.kernels import build_program as jbuild                 # noqa: E402
from repro.kernels import reram_mlp_fused as jfused               # noqa: E402
from repro.kernels import reram_mlp_fused_batched as jfused_b     # noqa: E402
from repro_torch.kernels import (build_program, fused_mlp,        # noqa: E402
                                 launch_counts, reram_mlp_fused,
                                 reram_mlp_fused_batched,
                                 reset_launch_counts)


def _layers(widths, seed, zero_bias):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(k, n)).astype(np.float32),
             "b": (np.zeros((n,), np.float32) if zero_bias
                   else rng.normal(size=(n,)).astype(np.float32))}
            for k, n in zip(widths[:-1], widths[1:])]


def _both(layers):
    return (jbuild([{k: jnp.asarray(v) for k, v in l.items()}
                    for l in layers]),
            build_program(layers))


ZERO_BIAS_CASES = [
    ((5, 7), 9, True),
    ((3, 64, 10), 33, True),
    ((4, 64, 64, 128), 516, True),
    ((4, 64, 64, 128), 1, False),
    ((130, 200, 70), 257, True),
]


@pytest.mark.parametrize("widths,m,final_relu", ZERO_BIAS_CASES)
def test_zero_bias_bitwise_vs_jax(widths, m, final_relu):
    layers = _layers(widths, 1, zero_bias=True)
    pj, pt = _both(layers)
    x = np.random.default_rng(2).normal(size=(m, widths[0])).astype(
        np.float32)
    ref = np.asarray(jfused(jnp.asarray(x), pj, final_relu=final_relu))
    got = reram_mlp_fused(torch.from_numpy(x), pt,
                          final_relu=final_relu).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("widths,m,final_relu", ZERO_BIAS_CASES)
def test_zero_bias_bitwise_vs_numpy_oracle(widths, m, final_relu):
    layers = _layers(widths, 1, zero_bias=True)
    x = np.random.default_rng(2).normal(size=(m, widths[0])).astype(
        np.float32)
    got = reram_mlp_fused(torch.from_numpy(x), build_program(layers),
                          final_relu=final_relu).numpy()
    np.testing.assert_array_equal(
        got, _numpy_quant_chain(layers, x, final_relu=final_relu))


@pytest.mark.parametrize("widths,m", [((17, 100, 2), 200),
                                      ((4, 64, 64, 128), 516),
                                      ((130, 200, 70), 257)])
def test_with_biases_within_fma_tolerance(widths, m):
    layers = _layers(widths, 7, zero_bias=False)
    pj, pt = _both(layers)
    x = np.random.default_rng(8).normal(size=(m, widths[0])).astype(
        np.float32)
    ref = np.asarray(jfused(jnp.asarray(x), pj))
    got = reram_mlp_fused(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("widths,lead,final_relu", [
    ((8, 32, 16), (13, 16), True),       # (B, M, K, C) SA layout
    ((16, 16, 16, 32), (8, 4), True),
    ((32, 256, 10), (), False),          # head: one row per element
])
def test_batched_zero_bias_bitwise_vs_jax(widths, lead, final_relu):
    layers = _layers(widths, 3, zero_bias=True)
    pj, pt = _both(layers)
    x = np.random.default_rng(4).normal(size=(3, *lead, widths[0]))
    x = (x * np.array([1.0, 10.0, 0.1]).reshape(3, *[1] * (x.ndim - 1))
         ).astype(np.float32)            # per-element scales must differ
    ref = np.asarray(jfused_b(jnp.asarray(x), pj, final_relu=final_relu))
    got = reram_mlp_fused_batched(torch.from_numpy(x), pt,
                                  final_relu=final_relu).numpy()
    assert got.shape == ref.shape == (3, *lead, widths[-1])
    np.testing.assert_array_equal(got, ref)


def test_leading_dims_flatten_like_rows():
    layers = _layers((8, 32, 16), 5, zero_bias=False)
    prog = build_program(layers)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(13, 16, 8)).astype(np.float32))
    assert torch.equal(reram_mlp_fused(x, prog),
                       reram_mlp_fused(x.reshape(-1, 8), prog)
                       .reshape(13, 16, 16))


def test_cpu_runs_plain_version_and_counts_no_launch():
    reset_launch_counts()
    prog = build_program(_layers((4, 8, 16), 0, zero_bias=False))
    x = torch.ones((2, 5, 4))
    reram_mlp_fused_batched(x, prog)
    reram_mlp_fused(x[0], prog)
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="several devices"):
        fused_mlp.fused_mlp(torch.zeros((1, 64, 128), dtype=torch.int8),
                            torch.ones(1, device="meta"), prog, m_real=1)


def test_empty_rows_rejected():
    prog = build_program(_layers((4, 8), 0, zero_bias=False))
    with pytest.raises((RuntimeError, IndexError)):
        reram_mlp_fused(torch.zeros((0, 4)), prog)
