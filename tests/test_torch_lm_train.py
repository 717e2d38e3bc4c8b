"""LM training in the port (``models/attention.py::_Flash``, the gradients
of ``models/lm.py`` for every family, ``optim/compression.py``,
``launch/train.py``, ``convert.train_state_from_numpy``) against the JAX
package, on the CPU.

The same weights (the reference's ``lm.init`` through
``lm_params_from_numpy``, vlm's gate set non-zero) and the same inputs
(``dummy_inputs``, 2 x 36 tokens: past the reduced attention chunks of 32
and off the state-space chunks, so queries, keys and the scans are all
padded) go through both packages at ``reduced()`` of each of the ten
configs. Each reference gradient is computed once, jitted, in a module
fixture; JAX is imported inside the fixtures, so the ``cuda`` cases
collect where there is no JAX.

Tolerances, and why:
- the flash Function's gradients against the reference's ``_flash`` VJP
  within ``FLASH_EPS * n * max|g|``, ``n`` the longest sum of the
  backward (the padded key length): the two follow the same chunk order
  and differ only in the float32 summation order inside each product;
  against autograd through naive attention within the reference's own
  ``2e-4`` (``tests/test_models_lm.py``);
- the loss within ``1e-6`` relative, every gradient leaf within
  ``1e-4 * max|g|`` of the reference's (float32 products summed in
  another order). rwkv6's gradient (the ssm family's) is held against
  the reference's float64 gradient instead: at these inputs the
  reference's own float32 gradient lies ``2.3e-4 * max|g|`` from it (its
  decays' sums reach -40 in a chunk, so each ``exp(±lcum)`` carries ~40
  ulp of its argument's rounding, and the group norm's near-constant rows
  carry that into the gradients). The reference runs in float64 with x64
  on and its explicit ``float32`` read as ``float64`` (:func:`_lifted`);
  the port on float64 weights (``layers.upcast`` keeps float64). The
  port's float64 gradient is held within ``F64_TOL * max|g|`` of the
  reference's (float64's rounding through the same conditioning:
  ``2.3e-4 * 2**-29``, about ``4e-13``; measured ``1.4e-13``), and its
  float32 gradient within ``1e-4 * max|g|`` of the reference's float64
  one (measured ``8.4e-5``);
- ``compress_error_feedback`` bit for bit against the reference called
  eagerly (under ``jit`` XLA multiplies by the scale's reciprocal);
- one ``make_train_step`` step against the reference's jitted step: the
  loss within ``1e-6`` relative, the learning rate bit for bit, the
  gradient norm within ``1e-5`` relative, the moments as the gradients
  (``m = (1 - b1) g``, ``v = (1 - b2) g²``), the parameters within
  ``1e-5 * max|w|`` except where the reference's gradient is below
  ``1000 * eps`` (Adam's first step is ``lr * g / (|g| + eps)``: there
  the two gradients' difference in the last digits moves the step by up
  to ``lr``), held within ``2 * lr``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import dummy_inputs, get_config, list_archs  # noqa
from repro_torch.convert import (lm_params_from_numpy,              # noqa: E402
                                 train_state_from_numpy)
from repro_torch.kernels.gather_backward import gather_rows         # noqa: E402
from repro_torch.launch import train                                # noqa: E402
from repro_torch.models import attention, lm, rwkv                  # noqa: E402
from repro_torch.optim import (AdamWConfig, CompressionState,       # noqa: E402
                               compress_error_feedback, tree_leaves,
                               tree_map)

ARCHS = list_archs()
SEQ, BATCH = 36, 2
GATE_X = 0.5
TOL = 1e-4
F64_TOL = 1e-10
FLASH_EPS = float(np.finfo(np.float32).eps)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.configs import dummy_inputs as ref_dummy_inputs
    from repro.configs import get_config as ref_get_config
    from repro.launch import train as ref_train
    from repro.models import attention as ref_attention
    from repro.models import lm as ref_lm
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import compression as ref_compression
    return dict(jax=jax, jnp=jax.numpy, dummy_inputs=ref_dummy_inputs,
                get_config=ref_get_config, train=ref_train,
                attention=ref_attention, lm=ref_lm,
                AdamWConfig=RefAdamWConfig, compression=ref_compression)


def _ref_params(ref, rcfg):
    jax = ref["jax"]
    tree = jax.device_get(jax.jit(lambda key: ref["lm"].init(key, rcfg))(
        jax.random.PRNGKey(0)))
    if rcfg.family == "vlm":
        tree["crossed"]["gate_x"] = np.full_like(tree["crossed"]["gate_x"],
                                                 GATE_X)
    return tree


def _port_loss_and_grads(params, cfg, ins):
    params = tree_map(lambda t: t.requires_grad_(), params)
    loss, _ = lm.loss_fn(params, cfg, ins.get("ids"), ins["labels"],
                         embeds=ins.get("embeds"),
                         image_embeds=ins.get("image_embeds"))
    grads = torch.autograd.grad(loss, tree_leaves(params),
                                materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def grads(ref):
    """arch -> (the reference's loss and gradient leaves, the port's), on
    the same weights and inputs."""
    jax, jnp = ref["jax"], ref["jnp"]
    out = {}
    for arch in ARCHS:
        rcfg, cfg = ref["get_config"](arch).reduced(), \
            get_config(arch).reduced()
        tree = _ref_params(ref, rcfg)
        rin = ref["dummy_inputs"](rcfg, "train", BATCH, SEQ, seed=5)
        ins = dummy_inputs(cfg, "train", BATCH, SEQ, seed=5, device="cpu")
        vg = jax.jit(jax.value_and_grad(
            lambda p, ids, lab, emb, img, rcfg=rcfg: ref["lm"].loss_fn(
                p, rcfg, ids, lab, embeds=emb, image_embeds=img)[0]))
        rl, rg = vg(jax.tree.map(jnp.asarray, tree), rin.get("ids"),
                    rin["labels"], rin.get("embeds"),
                    rin.get("image_embeds"))
        out[arch] = ((float(rl), [np.asarray(g) for g in
                                  jax.tree.leaves(jax.device_get(rg))]),
                     _port_loss_and_grads(
                         lm_params_from_numpy(tree, cfg, device="cpu"), cfg,
                         ins), (tree, ins))
    return out


def _err(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    return err / scale if scale else err


# ---------------------------------------------------------------------------
# the flash Function
# ---------------------------------------------------------------------------

def _naive(q, k, v, causal=True):
    """Softmax attention over the whole sequence, autograd's backward."""
    groups = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[1]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _flash_grads(q, k, v, t, causal, chunk=16):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    pos = torch.arange(q.shape[1], dtype=torch.int32)
    out = attention.chunked_attention(q, k, v, q_positions=pos,
                                      kv_positions=pos, causal=causal,
                                      q_chunk=chunk, kv_chunk=chunk)
    return [g.numpy() for g in torch.autograd.grad(
        (out * torch.from_numpy(t)).sum(), (q, k, v))]


@pytest.mark.parametrize("hkv,causal", [(4, True), (2, True), (2, False)])
def test_flash_gradients_match_reference_vjp_and_naive(ref, hkv, causal):
    """``tests/test_models_lm.py``'s shapes and seed."""
    jax, jnp = ref["jax"], ref["jnp"]
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 48, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 48, hkv, 8)).astype(np.float32)
    v = rng.normal(size=(2, 48, hkv, 8)).astype(np.float32)
    t = rng.normal(size=(2, 48, 4, 8)).astype(np.float32)
    pos = jnp.arange(48, dtype=jnp.int32)

    def loss(q, k, v):
        return jnp.sum(ref["attention"].chunked_attention(
            q, k, v, q_positions=pos, kv_positions=pos, causal=causal,
            q_chunk=16, kv_chunk=16) * t)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _flash_grads(q, k, v, t, causal)
    for name, g, w in zip("qkv", got, want):
        assert _err(g, np.asarray(w)) <= FLASH_EPS * 48, name
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    naive = torch.autograd.grad((_naive(qt, kt, vt, causal)
                                 * torch.from_numpy(t)).sum(), (qt, kt, vt))
    for g, n in zip(got, naive):
        np.testing.assert_allclose(g, n.numpy(), rtol=2e-4, atol=2e-4)


def test_flash_gradient_with_ragged_seq(ref):
    """Queries and keys padded to the chunk (35 -> 48): the reference's
    ``test_flash_attention_grad_with_ragged_seq``."""
    jax, jnp = ref["jax"], ref["jnp"]
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(1, 35, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = jnp.arange(35, dtype=jnp.int32)
    want = jax.grad(lambda a: jnp.sum(ref["attention"].chunked_attention(
        a, jnp.asarray(k), jnp.asarray(v), q_positions=pos,
        kv_positions=pos, causal=True, q_chunk=16, kv_chunk=16) ** 2))(
            jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_()
    tpos = torch.arange(35, dtype=torch.int32)
    out = attention.chunked_attention(
        qt, torch.from_numpy(k), torch.from_numpy(v), q_positions=tpos,
        kv_positions=tpos, causal=True, q_chunk=16, kv_chunk=16)
    got, = torch.autograd.grad((out ** 2).sum(), qt)
    assert _err(got.numpy(), np.asarray(want)) <= FLASH_EPS * 48
    naive, = torch.autograd.grad((_naive(
        qt, torch.from_numpy(k), torch.from_numpy(v)) ** 2).sum(), qt)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_flash_function_keeps_the_forward_bitwise():
    """The Function's forward is ``_flash_fwd``'s output, bit for bit, with
    or without gradients (the serving path runs it under inference
    mode)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 40, 4, 8)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(40, dtype=torch.int32)
    kw = dict(q_positions=pos, kv_positions=pos, causal=True, q_chunk=16,
              kv_chunk=16)
    with torch.inference_mode():
        served = attention.chunked_attention(q, k, v, **kw)
    trained = attention.chunked_attention(q.requires_grad_(), k, v, **kw)
    assert trained.requires_grad
    assert torch.equal(served, trained.detach())


def test_flash_backward_in_bf16_returns_the_input_dtypes():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 32, 4, 8)).astype(
        np.float32)).bfloat16().requires_grad_() for _ in range(3))
    pos = torch.arange(32, dtype=torch.int32)
    out = attention.chunked_attention(q, k, v, q_positions=pos,
                                      kv_positions=pos, q_chunk=16,
                                      kv_chunk=16)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 and g.shape == t.shape
               for g, t in zip(grads, (q, k, v)))


# ---------------------------------------------------------------------------
# every family's loss and gradients
# ---------------------------------------------------------------------------

class _Float32IsFloat64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def _lifted(ref, arch, tree):
    """The reference's loss and gradient leaves in float64: x64 on, the
    weights lifted, and its models' explicit ``jnp.float32`` (norms,
    decays, logits) read as float64 for the trace."""
    import repro.models.layers as ref_layers
    import repro.models.rwkv as ref_rwkv
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg = dataclasses.replace(ref["get_config"](arch).reduced(),
                               dtype="float64")
    rin = ref["dummy_inputs"](rcfg, "train", BATCH, SEQ, seed=5)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (ref["lm"], ref_layers, ref_rwkv):
            mp.setattr(mod, "jnp", _Float32IsFloat64(jnp))
        vg = jax.jit(jax.value_and_grad(lambda p, ids, lab: ref["lm"].loss_fn(
            p, rcfg, ids, lab)[0]))
        _, g = vg(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree),
                  rin["ids"], rin["labels"])
        return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(g))]


@pytest.fixture(scope="module")
def exact(ref, grads):
    """ssm arch -> (the reference's float64 gradient leaves, the port's on
    float64 weights)."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        if cfg.family != "ssm":
            continue
        tree, ins = grads[arch][2]
        params = tree_map(lambda t: t.double(),
                          lm_params_from_numpy(tree, cfg, device="cpu"))
        port = _port_loss_and_grads(
            params, dataclasses.replace(cfg, dtype="float64"), ins)[1]
        out[arch] = (_lifted(ref, arch, tree), port)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(grads, exact, arch):
    (rloss, rg), (loss, g), _ = grads[arch]
    assert abs(loss - rloss) <= 1e-6 * abs(rloss), arch
    assert len(g) == len(rg)
    for i, (got, want) in enumerate(zip(g, rg)):
        assert got.shape == want.shape and got.dtype == want.dtype
        if arch not in exact:
            assert _err(got, want) <= TOL, (arch, i, _err(got, want))
    if arch not in exact:
        return
    ref64, port64 = exact[arch]
    assert len(ref64) == len(port64) == len(g)
    for i, (got, got64, want) in enumerate(zip(g, port64, ref64)):
        assert want.dtype == got64.dtype == np.float64
        assert _err(got64, want) <= F64_TOL, (arch, i, _err(got64, want))
        assert _err(got, want) <= TOL, (arch, i, _err(got, want))


def test_every_leaf_gets_a_gradient(grads):
    """Leaves the loss does not read (a cross layer's own norm) get zeros,
    as the reference's; every other gradient is non-zero somewhere."""
    for arch, ((_, rg), (_, g), _) in grads.items():
        for got, want in zip(g, rg):
            assert bool(np.any(got != 0)) == bool(np.any(want != 0)), arch


def test_rwkv_decay_sums_in_the_reference_order(ref):
    """``_CumSum`` forward and backward bit for bit against XLA's
    ``jnp.cumsum`` and its gradient (the reverse sum) on the CPU."""
    jax, jnp = ref["jax"], ref["jnp"]
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, rwkv.CHUNK, 4, 16)) * 3).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda a: jnp.cumsum(a, axis=1)),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = rwkv._CumSum.apply(xt)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    gx, = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert np.array_equal(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_embedding_gradient_is_a_fixed_order_row_sum():
    """The lookup's gradient (P4's plain version on the CPU) is autograd's
    ``index_select`` gradient bit for bit in float32; in bf16 it is the
    float32 row sum rounded once."""
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.integers(0, 9, (3, 20)))
    up = torch.from_numpy(rng.normal(size=(3, 20, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        a = w.to(dtype).requires_grad_()
        b = w.to(dtype).requires_grad_()
        ga, = torch.autograd.grad(gather_rows(a, ids), a, up.to(dtype))
        gb, = torch.autograd.grad(b.index_select(0, ids.reshape(-1)), b,
                                  up.to(dtype).reshape(-1, 5))
        assert ga.dtype == dtype
        if dtype == torch.float32:
            assert torch.equal(ga, gb)
        else:
            rows = torch.zeros(9, 5).index_add_(
                0, ids.reshape(-1), up.to(dtype).float().reshape(-1, 5))
            assert torch.equal(ga, rows.to(dtype))


# ---------------------------------------------------------------------------
# compression, the train state, one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_error_feedback_bitwise(ref, dtype):
    jax, jnp = ref["jax"], ref["jnp"]
    rc = ref["compression"]
    rng = np.random.default_rng(13)
    shapes = {"a": (37, 5), "b": {"c": (64,), "d": (3, 4, 5)}}
    g = jax.tree.map(lambda s: (rng.normal(size=s) * rng.uniform(1e-3, 10)
                                ).astype(np.float32), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    # exact half-way quotients: round half to even, as jnp.round
    g["b"]["c"][:8] = np.float32(127.0) / 2 ** np.arange(8) + 0.5
    e = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2).astype(
        np.float32), g)
    jg = jax.tree.map(lambda a: jnp.asarray(a, dtype), g)
    want_g, want_s = rc.compress_error_feedback(
        jg, rc.CompressionState(error=jax.tree.map(jnp.asarray, e)))
    tg = jax.tree.map(lambda a: torch.from_numpy(a).to(getattr(torch,
                                                               dtype)), g)
    got_g, got_s = compress_error_feedback(
        tg, CompressionState(error=jax.tree.map(torch.from_numpy, e)))
    for got, want in zip(tree_leaves(got_g) + tree_leaves(got_s.error),
                         jax.tree.leaves(want_g)
                         + jax.tree.leaves(want_s.error)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


def test_int8_quantize_rounds_half_to_even():
    from repro_torch.optim import int8_dequantize, int8_quantize
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, scale = int8_quantize(x)
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
    assert torch.equal(int8_dequantize(q, scale), q.float())


def test_adamw_updates_a_large_leaf_piece_by_piece_bitwise(monkeypatch):
    """A leaf over ``PIECE`` elements is updated in flat pieces (views of
    it): bit for bit the whole leaf's update, the clip's norm aside (its
    squares summed piece by piece), so held with clipping off."""
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim import optimizer
    rng = np.random.default_rng(14)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(  # noqa
        np.float32))
    params = {"a": mk(10, 7).bfloat16(), "b": mk(33), "c": mk(5, 4)}
    grads = {"a": mk(7, 10).bfloat16().T, "b": mk(33), "c": mk(5, 4)}
    cfg = AdamWConfig(moment_dtype="bfloat16", clip_norm=1e9, **OPT)
    runs = []
    for piece in (optimizer.PIECE, 8):
        monkeypatch.setattr(optimizer, "PIECE", piece)
        p = tree_map(torch.clone, params)
        ptrs = [t.data_ptr() for t in tree_leaves(p)]
        _, st, metrics = adamw_update(p, grads, adamw_init(p, cfg), cfg)
        assert [t.data_ptr() for t in tree_leaves(p)] == ptrs
        runs.append((tree_leaves((p, st["m"], st["v"])), metrics))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    gn = [float(m["grad_norm"]) for _, m in runs]
    assert abs(gn[0] - gn[1]) <= 1e-6 * gn[0]


@pytest.fixture(scope="module")
def one_step(ref):
    """The reference's jitted step and the port's step from the same
    ``init_train_state`` tree (qwen1.5-0.5b reduced, seed 0), on the
    ``TokenStream`` batch of step 0."""
    jax, jnp = ref["jax"], ref["jnp"]
    rcfg = ref["get_config"]("qwen1.5-0.5b").reduced()
    cfg = get_config("qwen1.5-0.5b").reduced()
    ropt, opt = ref["AdamWConfig"](**OPT), AdamWConfig(**OPT)
    state = jax.device_get(ref["train"].init_train_state(
        jax.random.PRNGKey(0), rcfg, ropt))
    ids, labels = ref["train"].TokenStream(rcfg.vocab_size, SEQ, BATCH,
                                           seed=0).batch(0)
    step = jax.jit(ref["train"].make_train_step(rcfg, ropt))
    grad = jax.jit(jax.grad(lambda p: ref["lm"].loss_fn(
        p, rcfg, jnp.asarray(ids), jnp.asarray(labels))[0]))
    rgrads = jax.device_get(grad(jax.tree.map(jnp.asarray,
                                              state["params"])))
    new, metrics = step(jax.tree.map(jnp.asarray, state),
                        {"ids": jnp.asarray(ids),
                         "labels": jnp.asarray(labels)})
    port = train_state_from_numpy(state, cfg, device="cpu")
    port_step = train.make_train_step(cfg, opt)
    same, pm = port_step(port, {"ids": ids, "labels": labels})
    assert same is port
    return (jax.device_get(new), jax.device_get(metrics),
            [np.asarray(g) for g in jax.tree.leaves(rgrads)], port, pm)


def test_one_train_step_matches_reference_jitted_step(ref, one_step):
    jax = ref["jax"]
    new, metrics, rgrads, port, pm = one_step
    assert abs(float(pm["loss"]) - float(metrics["loss"])) <= \
        1e-6 * abs(float(metrics["loss"]))
    assert np.float32(pm["lr"]) == np.float32(metrics["lr"])
    assert abs(float(pm["grad_norm"]) - float(metrics["grad_norm"])) <= \
        1e-5 * float(metrics["grad_norm"])
    assert int(port["opt"]["step"]) == int(new["opt"]["step"]) == 1
    for part in ("m", "v"):
        for got, want in zip(tree_leaves(port["opt"][part]),
                             jax.tree.leaves(new["opt"][part])):
            assert _err(got.numpy(), np.asarray(want)) <= TOL, part
    lr = float(metrics["lr"])
    for got, want, g in zip(tree_leaves(port["params"]),
                            jax.tree.leaves(new["params"]), rgrads):
        got, want = got.detach().numpy(), np.asarray(want)
        noise = np.abs(g) < 1e3 * AdamWConfig().eps
        np.testing.assert_allclose(got[~noise], want[~noise], rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert np.all(np.abs(got - want)[noise] <= 2 * lr)


def test_train_state_from_numpy_is_leaf_for_leaf(ref):
    jax = ref["jax"]
    rcfg = dataclasses.replace(ref["get_config"]("rwkv6-3b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(),
                              dtype="bfloat16")
    ropt = ref["AdamWConfig"](moment_dtype="bfloat16")
    state = jax.device_get(ref["train"].init_train_state(
        jax.random.PRNGKey(1), rcfg, ropt, grad_compression=True))
    port = train_state_from_numpy(state, cfg, device="cpu")
    assert sorted(port) == sorted(state) == ["comp_err", "opt", "params"]
    assert all(t.requires_grad for t in tree_leaves(port["params"]))
    for got, want in zip(tree_leaves(port), jax.tree.leaves(state)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        if want.dtype.name == "bfloat16":
            assert np.array_equal(got.detach().view(torch.int16).numpy(),
                                  want.view(np.int16))
        else:
            assert np.array_equal(got.detach().numpy(), want)


def test_init_train_state_layout_matches_reference(ref):
    jax = ref["jax"]
    rcfg = ref["get_config"]("zamba2-7b").reduced()
    cfg = get_config("zamba2-7b").reduced()
    want = jax.eval_shape(lambda: ref["train"].init_train_state(
        jax.random.PRNGKey(0), rcfg, ref["AdamWConfig"](),
        grad_compression=True))
    got = train.init_train_state(0, cfg, AdamWConfig(),
                                 grad_compression=True, device="cpu")
    from repro_torch.checkpoint.checkpoint import _flatten
    from jax.tree_util import keystr, tree_flatten_with_path
    flat = {keystr(p, simple=True, separator="/"): v
            for p, v in tree_flatten_with_path(want)[0]}
    mine = _flatten(got)
    assert sorted(mine) == sorted(flat)
    for key, t in mine.items():
        assert tuple(t.shape) == flat[key].shape, key
        assert str(t.dtype).removeprefix("torch.") == str(flat[key].dtype)


def test_compressed_step_carries_the_residual():
    """With compression the step applies AdamW to the dequantized gradient
    and keeps the residual in the state's own tensors."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt = AdamWConfig(**OPT)
    state = train.init_train_state(0, cfg, opt, grad_compression=True,
                                   device="cpu")
    errs = tree_leaves(state["comp_err"])
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, seed=5, device="cpu")
    _, metrics = train.make_train_step(cfg, opt, grad_compression=True)(
        state, ins)
    assert all(a is b for a, b in zip(errs, tree_leaves(state["comp_err"])))
    assert any(bool(e.abs().max() > 0) for e in errs)
    assert np.isfinite(float(metrics["loss"]))


def test_cpu_step_runs_eagerly_and_twice_the_same():
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    opt = AdamWConfig(**OPT)
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, seed=5, device="cpu")
    runs = []
    for _ in range(2):
        state = train.init_train_state(0, cfg, opt, device="cpu")
        step = train.make_train_step(cfg, opt)
        hist = [float(step(state, ins)[1]["loss"]) for _ in range(3)]
        assert step.graphs == {}
        runs.append((hist, train.state_leaves(state)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0][-1] < runs[0][0][0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama4-scout-17b-a16e",
                                  "rwkv6-3b", "zamba2-7b"])
def test_captured_steps_are_the_eager_steps_bitwise(cuda, arch):
    cfg = get_config(arch).reduced()
    opt = AdamWConfig(**OPT)
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, seed=5, device="cuda")
    runs = {}
    for mode in ("eager", "captured", "again"):
        state = train.init_train_state(0, cfg, opt, device=cuda)
        step = train.make_train_step(cfg, opt)
        if mode == "eager":
            hist = [train._step(cfg, opt, False, state,
                                *(ins.get(k) for k in train.BATCH_KEYS))[0]
                    for _ in range(5)]
        else:
            hist = [step(state, ins)[1]["loss"] for _ in range(5)]
            assert len(step.graphs) == 1
        runs[mode] = ([float(h) for h in hist], train.state_leaves(state))
    for mode in ("captured", "again"):
        assert runs[mode][0] == runs["eager"][0], mode
        assert all(torch.equal(a, b) for a, b in
                   zip(runs[mode][1], runs["eager"][1])), mode


@pytest.mark.cuda
def test_card_gradients_match_the_cpu(cuda):
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    params = lm.init(0, cfg, device="cpu")
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, seed=5, device="cpu")
    cpu = _port_loss_and_grads(params, cfg, ins)
    card_params = tree_map(lambda t: t.detach().to(cuda), params)
    card_ins = {k: v.to(cuda) for k, v in ins.items()}
    card_params = tree_map(lambda t: t.requires_grad_(), card_params)
    loss, _ = lm.loss_fn(card_params, cfg, card_ins["ids"],
                         card_ins["labels"])
    card = torch.autograd.grad(loss, tree_leaves(card_params),
                               materialize_grads=True)
    assert abs(float(loss.detach()) - cpu[0]) <= 1e-6 * abs(cpu[0])
    for got, want in zip(card, cpu[1]):
        assert _err(got.cpu().numpy(), want) <= TOL
