"""Crossbar programming in the port against the JAX package: planes,
biases, weight scales and column masks bitwise equal on the same weights;
``quantize_tensor`` rounding half to even and rejecting NaN/Inf."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import build_program as jbuild                 # noqa: E402
from repro.kernels import encode_planes as jencode                # noqa: E402
from repro.kernels import quantize_tensor as jquant               # noqa: E402
from repro_torch.kernels import (build_program, combine_planes,   # noqa: E402
                                 encode_planes, plan_launch,
                                 quantize_tensor)


def _layers(widths, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(k, n)).astype(np.float32),
             "b": rng.normal(size=(n,)).astype(np.float32)}
            for k, n in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("widths", [(4, 64, 64, 128), (130, 200, 70),
                                    (5, 7), (128, 256, 40)])
def test_program_bitwise_equal_to_jax(widths):
    layers = _layers(widths)
    pj = jbuild([{k: jnp.asarray(v) for k, v in l.items()} for l in layers])
    pt = build_program(layers)
    assert pt.widths == pj.widths and pt.d_pad == pj.d_pad
    assert pt.planes.dtype == torch.int8
    np.testing.assert_array_equal(pt.planes.numpy(), np.asarray(pj.planes))
    for name in ("bias", "w_scale", "col_mask"):
        assert getattr(pt, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)))
    for a, b in zip(pt.int_weights(), pj.int_weights()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pt.weights(), pj.weights()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pt.biases(), pj.biases()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantize_ties_round_half_to_even():
    # scale is exactly 1.0 (max 127), so x / scale keeps the .5 ties
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5],
                 np.float32)
    qt, st = quantize_tensor(torch.from_numpy(x))
    qj, sj = jquant(jnp.asarray(x))
    assert float(st) == float(sj) == 1.0
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -4]


def test_quantize_random_equal_and_rejects_nonfinite():
    x = np.random.default_rng(3).normal(size=(33, 17)).astype(np.float32)
    qt, st = quantize_tensor(torch.from_numpy(x))
    qj, sj = jquant(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    for bad in (np.nan, np.inf):
        x[2, 3] = bad
        with pytest.raises(ValueError, match="NaN/Inf"):
            quantize_tensor(torch.from_numpy(x))


def test_encode_and_combine_planes_round_trip():
    w = torch.arange(-128, 128, dtype=torch.int32).reshape(16, 16)
    planes = encode_planes(w)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(jencode(jnp.asarray(w.numpy()))))
    assert torch.equal(combine_planes(planes), w)


def test_launch_geometry_stops_at_real_widths():
    prog = build_program(_layers((8, 128, 128, 256)))
    geom = plan_launch(prog, 512 * 16 + 3)
    assert geom.m_pad % 64 == 0 and geom.m_pad >= 512 * 16 + 3
    assert geom.k_lims == (32, 128, 128)
    assert geom.n_lims == (128, 128, 256)
    head = plan_launch(build_program(_layers((512, 256, 40))), 1)
    assert (head.m_pad, head.k_lims, head.n_lims) == (64, (512, 256),
                                                       (256, 64))
