"""The LM stack's dense, audio and vlm families in the port
(``repro_torch.configs``, ``models/{layers,attention,lm}.py``,
``convert.lm_params_from_numpy``, ``data/tokens.py``) against the JAX
package, on the CPU.

The same inputs (``dummy_inputs``, NumPy seeds) and the same weights (the
reference's ``lm.init`` through ``lm_params_from_numpy``) go through both
packages at ``reduced()`` of qwen1.5-0.5b (QKV bias, tied embeddings),
mistral-nemo-12b (GQA), musicgen-large (LayerNorm, GELU, frame embeddings)
and llama-3.2-vision-11b (cross-attention, its gate set non-zero: at init
``tanh(0)`` hides it). The prompt is 33 tokens and the forward 36, past
the reduced chunks of 32, so both the query and the key chunks are padded.

Tolerance: float32 throughout; logits, caches and attention outputs within
1e-4 x the reference's largest magnitude, argmax equal; the loss within
1e-5 relative. Each reference output is computed once per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import (ARCHS as REF_ARCHS,                      # noqa: E402
                           SHAPES as REF_SHAPES,
                           dummy_inputs as ref_dummy_inputs,
                           get_config as ref_get_config,
                           input_specs as ref_input_specs)
from repro.data.tokens import TokenStream as RefTokenStream         # noqa: E402
from repro.models import attention as ref_attention                 # noqa: E402
from repro.models import layers as ref_layers                       # noqa: E402
from repro.models import lm as ref_lm                               # noqa: E402

from repro_torch.configs import (ARCHS, SHAPES, dummy_inputs,        # noqa: E402
                                 get_config, input_specs, list_archs)
from repro_torch.convert import lm_params_from_numpy                # noqa: E402
from repro_torch.data import TokenStream                            # noqa: E402
from repro_torch.models import attention, layers, lm                # noqa: E402

ARCHS4 = ["qwen1.5-0.5b", "mistral-nemo-12b", "musicgen-large",
          "llama-3.2-vision-11b"]
PORTED = [a for a in sorted(ARCHS) if ARCHS[a].family in lm.FAMILIES]
S, EXTRA = 33, 3
TOL = 1e-4
GATE_X = 0.5


def _close(got, want, what, tol=TOL, argmax=False):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)
    if argmax:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                      err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_params(cfg):
    tree = jax.device_get(jax.jit(lambda key: ref_lm.init(key, cfg))(
        jax.random.PRNGKey(0)))
    if cfg.family == "vlm":
        tree["crossed"]["gate_x"] = np.full_like(tree["crossed"]["gate_x"],
                                                 GATE_X)
    return tree


def _run_ref(cfg, params, ins):
    """The reference's entry points, jitted (un-jitted they take several
    times as long here)."""
    p = jax.tree.map(jnp.asarray, params)
    ids, emb = ins.get("ids"), ins.get("embeds")
    img = ins.get("image_embeds")
    forward = jax.jit(lambda p, ids, emb, img: ref_lm.forward(
        p, cfg, ids, embeds=emb, image_embeds=img)[0])
    loss = jax.jit(lambda p, ids, labels, emb, img: ref_lm.loss_fn(
        p, cfg, ids, labels, embeds=emb, image_embeds=img)[0])
    prefill = jax.jit(lambda p, ids, emb, img: ref_lm.prefill(
        p, cfg, ids, embeds=emb, image_embeds=img, max_seq=S + EXTRA))
    step = jax.jit(lambda p, cache, ids1, emb1, pos, img: ref_lm.decode_step(
        p, cfg, cache, ids1, pos, embeds1=emb1, image_embeds=img))
    out = {"logits": forward(p, ids, emb, img),
           "loss": loss(p, ids, ins["labels"], emb, img)}
    audio = cfg.family == "audio"
    last, cache = prefill(p, None if audio else ids[:, :S],
                          emb[:, :S] if audio else None, img)
    out["prefill"], out["cache"] = last, jax.device_get(cache)
    steps = []
    for t in range(EXTRA):
        nxt = slice(S + t, S + t + 1)
        lg, cache = step(p, cache, None if audio else ids[:, nxt],
                         emb[:, nxt] if audio else None, jnp.int32(S + t),
                         img)
        steps.append(lg)
    out["steps"], out["final_cache"] = steps, jax.device_get(cache)
    return jax.device_get(out)


def _run_port(cfg, params, ins):
    ids, emb = ins.get("ids"), ins.get("embeds")
    img = ins.get("image_embeds")
    out = {"logits": lm.forward(params, cfg, ids, embeds=emb,
                                image_embeds=img)[0],
           "loss": lm.loss_fn(params, cfg, ids, ins["labels"], embeds=emb,
                              image_embeds=img)[0]}
    pre = ({"embeds": emb[:, :S]} if cfg.family == "audio"
           else {"ids": ids[:, :S]})
    last, cache = lm.prefill(params, cfg, pre.get("ids"),
                             embeds=pre.get("embeds"), image_embeds=img,
                             max_seq=S + EXTRA)
    out["prefill"] = last
    out["cache"] = {k: v.clone() for k, v in cache.items()}
    steps = []
    for t in range(EXTRA):
        kw = ({"embeds1": emb[:, S + t:S + t + 1]} if cfg.family == "audio"
              else {"ids1": ids[:, S + t:S + t + 1]})
        lg, cache = lm.decode_step(params, cfg, cache, pos=S + t,
                                   image_embeds=img, **kw)
        steps.append(lg)
    out["steps"], out["final_cache"] = steps, cache
    return out


@pytest.fixture(scope="module")
def runs():
    """arch -> (the reference's outputs, the port's), on the same weights
    and inputs."""
    out = {}
    with torch.inference_mode():
        for arch in ARCHS4:
            rcfg, cfg = ref_get_config(arch).reduced(), \
                get_config(arch).reduced()
            tree = _ref_params(rcfg)
            params = lm_params_from_numpy(tree, cfg, device="cpu")
            ref_ins = ref_dummy_inputs(rcfg, "train", 2, S + EXTRA, seed=5)
            ins = dummy_inputs(cfg, "train", 2, S + EXTRA, seed=5,
                               device="cpu")
            out[arch] = (_run_ref(rcfg, tree, ref_ins),
                         _run_port(cfg, params, ins))
    return out


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS4)
def test_forward_logits_match_reference(runs, arch):
    ref, port = runs[arch]
    _close(port["logits"], ref["logits"], f"{arch} forward", argmax=True)


@pytest.mark.parametrize("arch", ARCHS4)
def test_prefill_logits_and_cache_match_reference(runs, arch):
    ref, port = runs[arch]
    _close(port["prefill"], ref["prefill"], f"{arch} prefill", argmax=True)
    assert sorted(port["cache"]) == sorted(ref["cache"])
    for key, want in ref["cache"].items():
        _close(port["cache"][key], want, f"{arch} cache {key}")
        # rows past the prompt are zero, as the reference pads them
        if key.startswith(("k", "v")) and not key.startswith("img"):
            assert not port["cache"][key][..., S:, :, :].any(), key


@pytest.mark.parametrize("arch", ARCHS4)
def test_three_decode_steps_match_reference(runs, arch):
    ref, port = runs[arch]
    for t, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        _close(got, want, f"{arch} decode step {t}", argmax=True)
    for key, want in ref["final_cache"].items():
        _close(port["final_cache"][key], want, f"{arch} cache {key}")


@pytest.mark.parametrize("arch", ARCHS4)
def test_loss_matches_reference(runs, arch):
    ref, port = runs[arch]
    want = float(ref["loss"])
    assert abs(float(port["loss"]) - want) <= 1e-5 * abs(want), arch


@pytest.mark.parametrize("arch", ARCHS4)
def test_decode_steps_match_forward(runs, arch):
    """The serving path's own consistency: teacher-forced decode logits
    are the forward's, position by position (the reference's
    ``test_prefill_decode_matches_forward``)."""
    _, port = runs[arch]
    full = port["logits"]
    _close(port["prefill"], full[:, S - 1], f"{arch} prefill vs forward")
    for t, lg in enumerate(port["steps"]):
        _close(lg, full[:, S + t], f"{arch} step {t} vs forward",
               argmax=True)


# ---------------------------------------------------------------------------
# attention and layers against the reference
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # (b, sq, skv, h, hkv, causal, q_chunk, kv_chunk)
    "gqa-causal": (2, 64, 64, 4, 2, True, 16, 32),
    "mha-causal": (2, 64, 64, 4, 4, True, 16, 32),
    "noncausal-mqa": (2, 40, 24, 4, 1, False, 16, 16),
    "ragged-both-pads": (1, 35, 35, 4, 2, True, 16, 16),
    "ragged-noncausal": (2, 7, 37, 4, 2, False, 4, 16),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_reference(case):
    b, sq, skv, h, hkv, causal, qc, kc = ATTN_CASES[case]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, sq, h, 16)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, 16)).astype(np.float32)
    qp = np.arange(skv - sq, skv, dtype=np.int32)
    kp = np.arange(skv, dtype=np.int32)
    want = ref_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kp),
        causal=causal, q_chunk=qc, kv_chunk=kc)
    got = attention.chunked_attention(
        _t(q), _t(k), _t(v), q_positions=_t(qp), kv_positions=_t(kp),
        causal=causal, q_chunk=qc, kv_chunk=kc)
    _close(got, want, case)


def test_flash_lse_matches_reference():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 32, 4, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(32, dtype=np.int32)
    valid = np.ones(32, bool)
    _, want = ref_attention._flash_fwd_scan(
        *map(jnp.asarray, (q, k, v, pos, pos, valid)), True, 16, 16)
    _, got = attention._flash_fwd(*map(_t, (q, k, v, pos, pos, valid)),
                                  True, 16, 16)
    _close(got, want, "lse")


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_decode_attention_matches_reference(hkv):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, hkv, 16)).astype(np.float32)
    for pos in (0, 17, 39):
        want = ref_attention.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
        got = attention.decode_attention(_t(q), _t(k), _t(v),
                                         torch.tensor(pos))
        _close(got, want, f"decode hkv={hkv} pos={pos}")


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_apply_rope_matches_reference(positions):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = (np.arange(1000, 1012, dtype=np.int32) if positions == "1d"
           else rng.integers(0, 4096, (2, 12)).astype(np.int32))
    want = ref_attention.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = attention.apply_rope(_t(x), _t(pos), 1e6)
    _close(got, want, positions, tol=1e-5)


def test_norms_match_reference():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 32)) * 3 + 1).astype(np.float32)
    g, b = (rng.normal(size=32).astype(np.float32) for _ in range(2))
    _close(layers.rms_norm(_t(x), _t(g)),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(g)), "rms",
           tol=1e-6)
    # a population variance, as jnp.var's
    _close(layers.layer_norm(_t(x), _t(g), _t(b)),
           ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b)), "ln", tol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(5)
    p = jax.device_get(ref_layers.mlp_init(jax.random.PRNGKey(1), 16, 48,
                                           jnp.float32, kind=kind))
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    want = ref_layers.mlp_apply(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), kind)
    got = layers.mlp_apply(jax.tree.map(_t, p), _t(x), kind)
    _close(got, want, kind, tol=1e-5)


# ---------------------------------------------------------------------------
# configs, conversion, init, inputs
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_configs():
    assert list_archs() == sorted(REF_ARCHS)
    for name, ref in REF_ARCHS.items():
        port = ARCHS[name]
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced()), name
        assert port.n_params() == ref.n_params(), name
        assert port.n_active_params() == ref.n_active_params(), name
        assert port.jdtype == getattr(torch, ref.dtype)
    assert get_config("qwen1.5-0.5b-reduced") == \
        ARCHS["qwen1.5-0.5b"].reduced()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("heads,kv,tp", [
    (5, 5, 4), (10, 2, 4), (8, 2, 4), (32, 8, 16), (40, 8, 16),
    (20, 20, 16), (16, 16, 1), (6, 3, 4)])
def test_head_layout_matches_reference(heads, kv, tp):
    """The reference's cases (``tests/test_models_lm.py``) and the
    published configs' TP=16 regimes."""
    kw = dict(n_heads=heads, n_kv_heads=kv, d_head=8, d_model=8 * heads,
              tp=tp)
    ref = dataclasses.replace(ref_get_config("qwen1.5-4b").reduced(), **kw)
    port = dataclasses.replace(get_config("qwen1.5-4b").reduced(), **kw)
    try:
        want = ref.head_layout()
    except AssertionError:
        with pytest.raises(ValueError, match="incompatible"):
            port.head_layout()
        return
    assert port.head_layout() == want
    assert (port.eff_heads, port.eff_kv_heads) == want[:2]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def test_lm_params_from_numpy_is_bitwise_on_a_bf16_tree():
    rcfg = dataclasses.replace(ref_get_config("llama-3.2-vision-11b")
                               .reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b").reduced(),
                              dtype="bfloat16")
    tree = jax.device_get(jax.jit(lambda key: ref_lm.init(key, rcfg))(
        jax.random.PRNGKey(7)))
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    ref_leaves, port_leaves = dict(_leaves(tree)), dict(_leaves(params))
    assert sorted(ref_leaves) == sorted(port_leaves)
    for path, a in ref_leaves.items():
        t = port_leaves[path]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            np.asarray(a).view(np.uint16), err_msg=path)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_the_reference_layout(arch, dtype):
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    want = dict(_leaves(jax.eval_shape(
        lambda: ref_lm.init(jax.random.PRNGKey(0), rcfg))))
    got = dict(_leaves(lm.init(0, cfg, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert tuple(got[path].shape) == spec.shape, path
        assert got[path].dtype == getattr(torch, str(spec.dtype)), path


def test_init_is_seeded_with_the_reference_distributions():
    cfg = get_config("qwen1.5-0.5b").reduced()
    a, b = lm.init(3, cfg, device="cpu"), lm.init(3, cfg, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(_leaves(a), _leaves(b)))
    c = lm.init(4, cfg, device="cpu")
    assert not torch.equal(a["embed"]["w"], c["embed"]["w"])
    assert abs(float(a["embed"]["w"].std()) - 0.02) < 0.002
    w = a["blocks"]["mlp"]["down"]["w"]
    assert abs(float(w.std()) - (1 / cfg.d_ff) ** 0.5) < 0.01
    assert not a["blocks"]["attn"]["q"]["b"].any()
    assert torch.equal(a["ln_f"]["g"], torch.ones(cfg.d_model))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-large",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_input_specs_match_reference(arch, shape):
    want = dict(_leaves(ref_input_specs(ref_get_config(arch), shape)))
    got = dict(_leaves(input_specs(get_config(arch), shape)))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert got[path].device.type == "meta", path
        assert tuple(got[path].shape) == tuple(spec.shape), path
        assert got[path].dtype == getattr(torch, str(spec.dtype)), path


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS4)
def test_dummy_inputs_are_the_reference_numbers(arch, kind):
    want = dict(_leaves(jax.device_get(ref_dummy_inputs(
        ref_get_config(arch).reduced(), kind, 2, 6, seed=11))))
    got = dict(_leaves(dummy_inputs(get_config(arch).reduced(), kind, 2, 6,
                                    seed=11, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(a),
                                      err_msg=path)


def test_token_stream_is_the_reference_stream():
    kw = dict(vocab_size=512, seq_len=16, batch_size=3, seed=4)
    port, ref = iter(TokenStream(**kw)), iter(RefTokenStream(**kw))
    for _ in range(2):
        for a, b in zip(next(port), next(ref)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(TokenStream(**kw).batch(5), RefTokenStream(**kw).batch(5)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

def test_tensor_parallel_layouts_wait_for_the_mesh():
    """A tp the KV heads cannot meet (GQA, 2 KV heads, tp=3) is refused;
    a tp they meet runs (``tests/test_torch_tp_layout.py`` holds it
    against the reference)."""
    cfg = get_config("mistral-nemo-12b").reduced()
    with pytest.raises(ValueError, match="incompatible with tp=3"):
        lm.init(0, dataclasses.replace(cfg, tp=3), device="cpu")
    params = lm.init(0, dataclasses.replace(cfg, tp=8), device="cpu")
    cache = lm.init_cache(dataclasses.replace(cfg, tp=8), 1, 4, device="cpu")
    assert params["blocks"]["attn"]["k"]["w"].shape[-1] == 2 * cfg.head_dim
    assert cache["k"].shape[-2] == 8


def test_entry_points_want_a_card():
    cfg = get_config("qwen1.5-0.5b").reduced()
    if torch.cuda.is_available():
        assert lm.init(0, cfg)["embed"]["w"].device.type == "cuda"
        return
    for call in (lambda: lm.init(0, cfg),
                 lambda: lm.init_cache(cfg, 1, 4),
                 lambda: dummy_inputs(cfg, "prefill", 1, 4),
                 lambda: lm_params_from_numpy({"w": np.zeros(2)}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
