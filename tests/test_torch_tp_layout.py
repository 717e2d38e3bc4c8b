"""The TP head layout of ``repro_torch.models.lm`` (``cfg.tp > 1``)
against the JAX package's, on the CPU.

- ``_head_perm`` and every weight arrangement (``_arrange_wq``,
  ``_arrange_wq_bias``, ``_arrange_wkv``, ``_arrange_kv_bias``,
  ``_arrange_wo``, ``_eff_attn_params``) bit for bit the reference's on
  the same NumPy weights, at ``reduced()`` of every config and tp 2, 3 and
  8: tp 2 divides the reduced heads (the identity), tp 3 pads MHA heads
  (4 -> 6), tp 8 pads MHA (4 -> 8) and repeats GQA's 2 KV heads 4 times;
  a tp the KV heads cannot meet (GQA at 3) is refused by both.
- ``forward``, ``prefill`` and 3 decode steps at tp > 1 on the reference's
  weights (``lm_params_from_numpy``), within ``TOL`` x max|logit| of the
  reference at the same tp and of the port's own tp = 1 (the padded
  heads add exact zeros; the rest is float32 summation order).
- the loss's gradients on the published parameters: every leaf within
  ``TOL`` x max|g| of the reference's at the same tp, max|g| the largest
  of the whole gradient (a pad slot's gradient is dropped in both); and
  every leaf within ``LAYOUT_TOL`` x its own max|g| of the port's tp = 1
  gradient (measured: bit for bit where heads are padded, 6.3e-7 where KV
  heads are repeated, whose copies' gradients are summed). Against the
  reference a leaf's own max is too small a scale: zamba2's trailing
  Mamba ``dt_bias``, whose gradient is 1e-5 of the largest, lies 9.1e-5
  of its own max from the reference's at tp = 1 (the float32 limit
  ``tests/test_torch_lm_train.py`` holds it to) and 1.2e-4 at tp = 3, as
  the reference's own summation order moves with the layout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import dummy_inputs, get_config, list_archs  # noqa
from repro_torch.convert import lm_params_from_numpy                # noqa: E402
from repro_torch.models import lm                                   # noqa: E402
from repro_torch.optim import tree_leaves                           # noqa: E402

ARCHS = list_archs()
TPS = (2, 3, 8)
TOL = 1e-4
LAYOUT_TOL = 1e-5
BATCH, SEQ, DECODE = 2, 36, 3
GATE_X = 0.5
#: (config, tp) run end to end: MHA padding with QKV biases, GQA repeats,
#: the vlm's cross-attention, the hybrid's shared block, moe
MODEL_CASES = (("qwen1.5-4b", 3), ("mistral-nemo-12b", 8),
               ("llama-3.2-vision-11b", 8), ("zamba2-7b", 3),
               ("llama4-scout-17b-a16e", 8))


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import dummy_inputs as ref_dummy_inputs
    from repro.configs import get_config as ref_get_config
    from repro.models import lm as ref_lm
    return {"jax": jax, "jnp": jax.numpy, "get_config": ref_get_config,
            "dummy_inputs": ref_dummy_inputs, "lm": ref_lm}


def _tp(cfg, tp):
    return dataclasses.replace(cfg, tp=tp)


def _layout_or_none(cfg):
    try:
        return cfg.head_layout()
    except ValueError:
        return None


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_head_perm_is_the_references(jx, arch, tp):
    cfg = _tp(get_config(arch).reduced(), tp)
    rcfg = _tp(jx["get_config"](arch).reduced(), tp)
    layout = _layout_or_none(cfg)
    if layout is None:
        with pytest.raises(AssertionError):
            rcfg.head_layout()
        with pytest.raises(ValueError, match="incompatible"):
            lm.init(0, cfg, device="meta")
        return
    assert layout == rcfg.head_layout()
    assert lm._head_perm(cfg) == jx["lm"]._head_perm(rcfg)


@pytest.mark.parametrize("arch,tp", [
    (a, tp) for a in ARCHS for tp in TPS
    if _layout_or_none(_tp(get_config(a).reduced(), tp)) is not None])
def test_arrangements_are_the_references(jx, arch, tp):
    cfg = _tp(get_config(arch).reduced(), tp)
    rcfg = _tp(jx["get_config"](arch).reduced(), tp)
    jnp, ref = jx["jnp"], jx["lm"]
    rng = np.random.default_rng(tp)
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    w = {"q": rng.normal(size=(d, hq)), "bq": rng.normal(size=(hq,)),
         "k": rng.normal(size=(d, hkv)), "bk": rng.normal(size=(hkv,)),
         "o": rng.normal(size=(hq, d))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    pairs = [(lm._arrange_wq(t["q"], cfg), ref._arrange_wq(w["q"], rcfg)),
             (lm._arrange_wq_bias(t["bq"], cfg),
              ref._arrange_wq_bias(w["bq"], rcfg)),
             (lm._arrange_wkv(t["k"], cfg), ref._arrange_wkv(w["k"], rcfg)),
             (lm._arrange_kv_bias(t["bk"], cfg),
              ref._arrange_kv_bias(w["bk"], rcfg)),
             (lm._arrange_wo(t["o"], cfg), ref._arrange_wo(w["o"], rcfg))]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    attn = {"q": {"w": w["q"], "b": w["bq"]}, "k": {"w": w["k"], "b": w["bk"]},
            "v": {"w": w["k"] + 1, "b": w["bk"] + 1}, "o": {"w": w["o"]},
            "ln": {"g": np.ones((d,), np.float32)}}
    got = lm._eff_attn_params(
        {k: {n: torch.from_numpy(np.asarray(a)) for n, a in v.items()}
         for k, v in attn.items()}, cfg)
    want = ref._eff_attn_params(
        {k: {n: jnp.asarray(a) for n, a in v.items()}
         for k, v in attn.items()}, rcfg)
    for k in want:
        for n in want[k]:
            np.testing.assert_array_equal(got[k][n].numpy(),
                                          np.asarray(want[k][n]))
    eff, eff_kv, _, _ = cfg.head_layout()
    assert got["q"]["w"].shape == (d, eff * dh)
    assert got["k"]["w"].shape == (d, eff_kv * dh)


@pytest.fixture(scope="module")
def cases(jx):
    """Per (config, tp): the reference's weights as NumPy, its inputs, and
    its logits, prefill, decode steps and gradients at that tp."""
    jax, jnp, ref = jx["jax"], jx["jnp"], jx["lm"]
    out = {}
    for arch, tp in MODEL_CASES:
        rcfg = _tp(jx["get_config"](arch).reduced(), tp)
        params = jax.device_get(jax.jit(lambda k: ref.init(k, rcfg))(
            jax.random.PRNGKey(0)))
        if "crossed" in params:
            params["crossed"]["gate_x"] = np.full_like(
                params["crossed"]["gate_x"], GATE_X)
        ins = jx["dummy_inputs"](rcfg, "train", batch=BATCH, seq=SEQ)
        kw = {k: ins[k] for k in ("embeds", "image_embeds") if k in ins}
        ids = ins.get("ids")

        def run(p, ids, labels, kw):
            logits, _ = ref.forward(p, rcfg, ids, **kw)
            grads = jax.grad(lambda q: ref.loss_fn(q, rcfg, ids, labels,
                                                   **kw)[0])(p)
            last, cache = ref.prefill(p, rcfg, ids, max_seq=SEQ + DECODE,
                                      **kw)
            steps = []
            for i in range(DECODE):
                step_kw = {"image_embeds": kw.get("image_embeds")}
                if "embeds" in kw:
                    step_kw["embeds1"] = kw["embeds"][:, i:i + 1]
                    lg, cache = ref.decode_step(p, rcfg, cache, None,
                                                jnp.int32(SEQ + i), **step_kw)
                else:
                    lg, cache = ref.decode_step(p, rcfg, cache,
                                                ids[:, i:i + 1],
                                                jnp.int32(SEQ + i), **step_kw)
                steps.append(lg)
            return logits, grads, last, steps
        res = jax.device_get(jax.jit(run)(
            jax.tree.map(jnp.asarray, params), ids, ins["labels"], kw))
        out[(arch, tp)] = {"params": params, "ins": ins, "ref": res}
    return out


def _port_inputs(cfg, case):
    ins = dummy_inputs(cfg, "train", batch=BATCH, seq=SEQ, device="cpu")
    for k, v in case["ins"].items():            # the same draws
        np.testing.assert_array_equal(ins[k].numpy(), np.asarray(v))
    return ins


def _within(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch,tp", MODEL_CASES)
def test_forward_and_gradients_match_the_reference(cases, arch, tp):
    case = cases[(arch, tp)]
    cfg = _tp(get_config(arch).reduced(), tp)
    params = lm_params_from_numpy(case["params"], cfg, device="cpu")
    ins = _port_inputs(cfg, case)
    kw = {k: ins[k] for k in ("embeds", "image_embeds") if k in ins}
    logits, _ = lm.forward(params, cfg, ins.get("ids"), **kw)
    want_logits, want_grads = case["ref"][0], case["ref"][1]
    _within(logits, want_logits, "logits vs the reference")
    one, _ = lm.forward(params, _tp(cfg, 1), ins.get("ids"), **kw)
    _within(logits, one.detach().numpy(), "logits vs tp=1")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]

    def grads(c):
        loss, _ = lm.loss_fn(params, c, ins.get("ids"), ins["labels"], **kw)
        return torch.autograd.grad(loss, leaves, materialize_grads=True)
    got, one = grads(cfg), grads(_tp(cfg, 1))
    ref_grads = [np.asarray(w) for w in tree_leaves(want_grads)]
    assert len(got) == len(ref_grads)
    scale = max(float(np.abs(w).max()) for w in ref_grads)
    for g, g1, w in zip(got, one, ref_grads):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TOL * scale, ("gradient", err, scale)
        own = float(g1.abs().max())
        assert float((g - g1).abs().max()) <= LAYOUT_TOL * own


@pytest.mark.parametrize("arch,tp", MODEL_CASES)
def test_prefill_and_decode_match_the_reference(cases, arch, tp):
    case = cases[(arch, tp)]
    cfg = _tp(get_config(arch).reduced(), tp)
    params = lm_params_from_numpy(case["params"], cfg, device="cpu")
    ins = _port_inputs(cfg, case)
    kw = {k: ins[k] for k in ("embeds", "image_embeds") if k in ins}
    ids = ins.get("ids")
    with torch.inference_mode():
        last, cache = lm.prefill(params, cfg, ids, max_seq=SEQ + DECODE,
                                 **kw)
        _within(last, case["ref"][2], "prefill")
        for key in ("k", "v", "k_plain", "k_cross"):
            if key in cache:
                assert cache[key].shape[-2] == cfg.eff_kv_heads
        for i in range(DECODE):
            pos = torch.tensor(SEQ + i, dtype=torch.int32)
            if "embeds" in kw:
                lg, cache = lm.decode_step(params, cfg, cache, pos=pos,
                                           embeds1=kw["embeds"][:, i:i + 1])
            else:
                lg, cache = lm.decode_step(params, cfg, cache,
                                           ids[:, i:i + 1], pos)
            _within(lg, case["ref"][3][i], f"decode step {i}")
