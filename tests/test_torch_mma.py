"""The arithmetic K1, K2 and K3 run on the tensor cores, held on the CPU.

K1, K2 and K3 multiply int8 activations by s8 weights that a pre-pass
combines from the crossbar planes once per call, and K2 recomputes the
stripe's earlier layers in every launch instead of reading a float32 panel
back.
The kernels run only on the card (``tests/test_torch_cuda.py``); here the
three facts they rest on are checked against the JAX package, and the
launch geometry that keeps every width and depth runnable is pinned:

- the pre-pass's plain version equals the JAX package's ``combine_planes``;
- ``x·u − (Σx) << (wb−1) == x·w_s8`` exactly, at the extreme values;
- K2's launch schedule (prefix recompute from the published maxima, stripe
  by stripe), emulated here in torch, equals the plain version and the JAX
  package's fused MLP bit for bit (zero biases).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import build_program as jbuild                 # noqa: E402
from repro.kernels import reram_mlp_fused as jfused               # noqa: E402
from repro.kernels import reram_mlp_fused_batched as jfused_b     # noqa: E402
from repro.kernels.ref import combine_planes as jcombine          # noqa: E402
from repro_torch.kernels import (build_program, encode_planes,    # noqa: E402
                                 fused_mlp, plan_launch)
from repro_torch.kernels.program import (                          # noqa: E402
    BLOCK_M, MAX_SMEM_BYTES, MMA_STRIPE_K, CrossbarProgram, _quantize,
    _scale, mtiled_on_chip, wstat_chunk)
from repro_torch.kernels.ref import (combine_planes,              # noqa: E402
                                     ref_reram_matmul_int)


def _layers(widths, seed, zero_bias=True):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(k, n)).astype(np.float32),
             "b": (np.zeros((n,), np.float32) if zero_bias
                   else rng.normal(size=(n,)).astype(np.float32))}
            for k, n in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("weight_bits", [4, 6, 8])
@pytest.mark.parametrize("widths", [(5, 7), (130, 200, 70), (40, 64, 96)])
def test_prepass_plain_equals_jax_combine_planes(weight_bits, widths):
    """Every layer's (k_lim, n_lim) region, padded columns included, is
    the JAX package's combined weight as int8, transposed to [n][k]."""
    prog = build_program(_layers(widths, weight_bits),
                         weight_bits=weight_bits)
    geom = plan_launch(prog, 100, "mtiled")
    wt = fused_mlp.combine_weights_plain(prog, geom)
    assert wt.dtype == torch.int8 and wt.shape == (prog.n_layers,
                                                   prog.d_pad, prog.d_pad)
    lo = -(1 << (weight_bits - 1))
    for l, (k, n) in enumerate(zip(geom.k_lims, geom.n_lims)):
        planes = prog.planes[l, :, :k, :n].numpy()
        want = np.asarray(jcombine(jnp.asarray(planes), prog.cell_bits,
                                   weight_bits)).T
        got = wt[l, :n, :k].numpy().astype(np.int32)
        np.testing.assert_array_equal(got, want)
        # padded columns hold the offset's negative, real ones the weights
        assert (got[widths[l + 1]:] == lo).all()
        assert lo <= got.min() and got.max() <= -lo - 1
    # nothing outside the regions is written
    mask = torch.ones_like(wt, dtype=torch.bool)
    for l, (k, n) in enumerate(zip(geom.k_lims, geom.n_lims)):
        mask[l, :n, :k] = False
    assert not wt[mask].any()


@pytest.mark.parametrize("weight_bits", [4, 8])
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
def test_signed_product_equals_offset_binary_product(weight_bits, fill):
    """``x·u − (Σx) << (wb−1) == x·w_s8`` on ±127 rows, all-0 and
    all-max planes, and the s8 sum fits the float32 conversion exactly."""
    rng = np.random.default_rng(weight_bits)
    k, n = 1024, 16
    n_planes = -(-weight_bits // 2)
    if fill == "zero":
        planes = np.zeros((n_planes, k, n), np.int8)
    elif fill == "max":
        planes = np.full((n_planes, k, n), 3, np.int8)
    else:
        half = 1 << (weight_bits - 1)
        w = rng.integers(-half + 1, half, size=(k, n))
        planes = encode_planes(torch.from_numpy(w), weight_bits).numpy()
    x = np.stack([np.full(k, 127), np.full(k, -127),
                  np.where(np.arange(k) % 2, 127, -127),
                  rng.integers(-127, 128, size=k)]).astype(np.int64)
    u = sum(planes[p].astype(np.int64) << (2 * p) for p in range(n_planes))
    offset_binary = x @ u - (x.sum(1, keepdims=True) << (weight_bits - 1))
    w_s8 = combine_planes(torch.from_numpy(planes), 2,
                          weight_bits).to(torch.int8)
    assert int(w_s8.min()) >= -128 and int(w_s8.max()) <= 127
    signed = x @ w_s8.numpy().astype(np.int64)
    np.testing.assert_array_equal(signed, offset_binary)
    assert np.abs(signed).max() < 2 ** 24
    ref = ref_reram_matmul_int(torch.from_numpy(x).to(torch.int32),
                               torch.from_numpy(planes), 2, weight_bits)
    np.testing.assert_array_equal(ref.numpy(), signed)


def _emulate_mtiled(x_p, sx, prog, m_real, final_relu):
    """K2's launch schedule in torch: launch j walks every ``BLOCK_M``-row
    stripe of every batch element, recomputes layers ``0 .. j-1`` of the
    stripe from the int8 input with the scales the maxima of launches
    ``0 .. j-1`` fix, requantizing each into an int8 stripe, computes layer
    j and publishes the max of |y|; only the last launch writes output."""
    geom = plan_launch(prog, m_real, "mtiled")
    wt = fused_mlp.combine_weights_plain(prog, geom)
    batch, m_pad, _ = x_p.shape
    n_layers = prog.n_layers
    qmax = float(2 ** (prog.weight_bits - 1) - 1)
    ks, ns = geom.k_lims, geom.n_lims
    published = torch.zeros((batch, n_layers))
    out = torch.zeros((batch, m_pad, ns[-1]))
    for j in range(n_layers):
        for b in range(batch):
            for m0 in range(0, m_pad, BLOCK_M):
                rows_ok = (m0 + torch.arange(BLOCK_M) < m_real)[:, None]
                stripe = x_p[b, m0:m0 + BLOCK_M, :ks[0]]
                for l in range(j + 1):
                    s = sx[b] if l == 0 else _scale(published[b, l - 1], qmax)
                    w = wt[l, :ns[l], :ks[l]].T.to(torch.float64)
                    y_int = (stripe[:, :ks[l]].to(torch.float64) @ w).to(
                        torch.int32)
                    y = (y_int.to(torch.float32) * (s * prog.w_scale[l, 0])
                         + prog.bias[l, :ns[l]])
                    if l < n_layers - 1 or final_relu:
                        y = torch.clamp_min(y, 0.0)
                    y = torch.where(rows_ok, y * prog.col_mask[l, :ns[l]],
                                    0.0)
                    if l < j:
                        s_next = _scale(published[b, l], qmax)
                        stripe = _quantize(y[:, :ks[l + 1]], s_next, qmax)
                        continue
                    published[b, j] = torch.maximum(published[b, j],
                                                    y.abs().max())
                    if j == n_layers - 1:
                        out[b, m0:m0 + BLOCK_M] = y
    return out[:, :m_real, :prog.widths[-1]]


@pytest.mark.parametrize("widths,m,batch,final_relu", [
    ((5, 24, 16, 12), 100, 2, True),     # ragged rows: 2 stripes, 36 pad
    ((12, 16, 10), 1, 3, False),         # a 1-row head per cloud
    ((40, 150, 70), 130, 1, True),       # n_lim past one 128-wide chunk
])
def test_mtiled_schedule_equals_plain_and_jax(widths, m, batch, final_relu):
    layers = _layers(widths, 11)
    prog = build_program(layers)
    x = np.random.default_rng(12).normal(size=(batch, m, widths[0]))
    x = x.astype(np.float32)
    x_p, sx = fused_mlp.prepare_input(torch.from_numpy(x), prog)
    got = _emulate_mtiled(x_p, sx, prog, m, final_relu)
    want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                     final_relu=final_relu)
    assert got.shape == want.shape == (batch, m, widths[-1])
    assert torch.equal(got, want)
    pj = jbuild([{k: jnp.asarray(v) for k, v in l.items()} for l in layers])
    ref_b = np.asarray(jfused_b(jnp.asarray(x), pj, final_relu=final_relu,
                                mode="mtiled", interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref_b)
    ref_0 = np.asarray(jfused(jnp.asarray(x[0]), pj, final_relu=final_relu,
                              mode="mtiled", interpret=True))
    np.testing.assert_array_equal(got[0].numpy(), ref_0)


def test_mtiled_schedule_with_biases_equals_plain():
    """Non-zero biases and 6-bit weights: the emulated schedule still equals
    the port's plain version bit for bit (both round every float step
    alike)."""
    prog = build_program(_layers((9, 33, 70, 20), 13, zero_bias=False),
                         weight_bits=6)
    x = torch.from_numpy(np.random.default_rng(14).normal(
        size=(2, 70, 9)).astype(np.float32))
    x_p, sx = fused_mlp.prepare_input(x, prog)
    assert torch.equal(_emulate_mtiled(x_p, sx, prog, 70, True),
                       fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=70))


def test_bindings_match_the_c_signatures():
    """Each bound C function takes the pointers, ints and stream its
    ctypes binding declares (a mismatch shows only on the card): K1's, K2's
    and K3's entries, and K6's product and pre-pass."""
    import re
    from repro_torch.kernels import _build, reram_mlp
    sources = {**fused_mlp._FUNCTIONS, "reram_mlp": reram_mlp._FUNCTIONS}
    assert set(sources["fused_mlp_wstat"]) == {"fused_mlp_wstat_run"}
    assert set(sources["reram_mlp"]) == {"reram_matmul_int", "reram_combine"}
    for name, fns in sources.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, (n_ptrs, n_ints) in fns.items():
            sig = re.search(rf"\bint {fn}\(([^)]*)\)", src)
            assert sig, (name, fn)
            args = [a.strip() for a in sig.group(1).split(",")]
            kinds = ["ptr" if "*" in a else "int" for a in args]
            assert kinds == ["ptr"] * n_ptrs + ["int"] * n_ints + ["ptr"], \
                (fn, args)


def _shape_program(widths):
    """A program of these widths whose planes are zeros (only the geometry
    is read)."""
    d = -(-max(widths) // 128) * 128
    n = len(widths) - 1
    return CrossbarProgram(torch.zeros((n, 4, d, d), dtype=torch.int8),
                           torch.zeros((n, d)), torch.ones((n, 1)),
                           torch.ones((n, d)), tuple(widths))


@pytest.mark.parametrize("kmax,on_chip", [
    (256, True), (1536, True), (1568, False), (4000, False)])
def test_k2_on_chip_up_to_kmax_1536_and_k1_fits_every_width(kmax, on_chip):
    """K2 keeps two stripes of the widest k_lim beside the 30 KB weight
    ring, which fit a block up to k_lim 1536; beyond, 'mtiled' runs K1,
    whose stripe stops at ``MMA_STRIPE_K`` bytes, so K1 fits at any
    width."""
    prog = _shape_program((kmax, 64, 40))
    ring = 3 * 128 * (64 + 16)
    assert mtiled_on_chip(plan_launch(prog, 100, "mtiled")) is on_chip
    whole = plan_launch(prog, 100)
    assert whole.smem_bytes[0] == 64 * (min(kmax, MMA_STRIPE_K) + 16) + ring
    assert max(whole.smem_bytes) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("mode", ["whole", "mtiled"])
@pytest.mark.parametrize("widths", [(20,) + (48,) * 9 + (24,),
                                    (4000, 40)])
def test_k1_k2_launch_checks_take_any_depth_and_width(mode, widths):
    """Ten layers and a 4000-wide input pass K1's and K2's launch checks,
    and K3's too: its chunk narrows, then runs K in ranges, so it has no
    shared-memory limit left."""
    prog = _shape_program(widths)
    x_p, sx = fused_mlp.prepare_input(torch.ones((2, 30, widths[0])), prog)
    geom = fused_mlp._check_launch(x_p, sx, prog, 30, mode)
    assert len(geom.k_lims) == len(widths) - 1
    wstat = fused_mlp._check_launch(x_p, sx, prog, 30, "wstat")
    assert wstat.k_lims == geom.k_lims
    assert max(wstat.smem_bytes) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("kmax,cols,resident", [
    (256, 128, 256), (512, 128, 512), (1536, 128, 1536),
    (3584, 32, 3584), (4000, 32, 4000), (8192, 64, MMA_STRIPE_K)])
def test_wstat_geometry_fits_every_width(kmax, cols, resident):
    """K3 keeps a chunk of s8 weights, all of a layer's k_lim deep, beside
    its 20 KB activation ring: 128 columns while they fit, then 64 or 32;
    past that 64 columns over K ranges of ``MMA_STRIPE_K`` bytes. Every
    layer's shared memory stays within a block's."""
    prog = _shape_program((kmax, 2100, 64, 40))
    geom = plan_launch(prog, 100, "wstat")
    a_ring = 4 * 64 * (64 + 16)
    assert wstat_chunk(geom.k_lims[0]) == (cols, resident)
    for k, smem in zip(geom.k_lims, geom.smem_bytes):
        c, kr = wstat_chunk(k)
        assert smem == c * (kr + 16) + a_ring <= MAX_SMEM_BYTES
        assert kr == k or kr == MMA_STRIPE_K < k
    # the 2100-wide middle layer (k_lim 2112) narrows to 64 columns
    assert wstat_chunk(geom.k_lims[1]) == (64, 2112)
