"""The LM half of the port's serving tier (``repro_torch.launch.serve``:
``LMServable``, ``generate``, ``make_serve_step``, the captured prefill and
decode step) and ``examples/serve_lm_torch.py``.

On the CPU: greedy ``generate`` token for token against the JAX package's
``repro.launch.serve.generate`` on the same weights (the reference's
``lm.init`` through ``lm_params_from_numpy``) at ``reduced()`` of
qwen1.5-0.5b, mistral-nemo-12b, musicgen-large, llama-3.2-vision-11b (its
cross-attention gate non-zero), grok-1, llama4-scout, rwkv6 and zamba2
(the prompt of 9 tokens is off both state-space chunks); the servable's buckets and stats
against the reference servable's under a ``VirtualClock``; the request-at-
a-time engine path; sampling above temperature 0 from an explicit
generator; the example.

On the card (``cuda`` marker; skipped here), per family: one capture per
(config, batch, capacity) for the decode step and per prompt length for
the prefill, none added by a second call; the captured steps bit for bit
the eager ``decode_step``; every cache leaf restored after the warm-ups. JAX is
imported inside the fixtures, so the ``cuda`` cases run where there is
none.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config                          # noqa: E402
from repro_torch.convert import lm_params_from_numpy                # noqa: E402
from repro_torch.launch import serve                                # noqa: E402
from repro_torch.launch.serve import (LMServable, ServingEngine,    # noqa: E402
                                      VirtualClock, generate,
                                      make_serve_step)
from repro_torch.models import lm                                   # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ["qwen1.5-0.5b", "mistral-nemo-12b", "musicgen-large",
         "llama-3.2-vision-11b", "grok-1-314b", "llama4-scout-17b-a16e",
         "rwkv6-3b", "zamba2-7b"]
#: one arch of each family, for the card's cases
FAMILY_ARCHS = ["qwen1.5-0.5b", "llama-3.2-vision-11b", "grok-1-314b",
                "llama4-scout-17b-a16e", "rwkv6-3b", "zamba2-7b"]
GATE_X = 0.5
B, S, NEW = 2, 9, 5


def _prompts(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _image(cfg, b=B):
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(1).normal(
        size=(b, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """arch -> (the reference's weights as NumPy, its greedy generate's
    tokens, its servable's stats under a VirtualClock)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import get_config as ref_get_config
    from repro.launch import serve as ref_serve
    from repro.models import lm as ref_lm
    out = {}
    for arch in ARCHS:
        cfg = ref_get_config(arch).reduced()
        tree = jax.device_get(jax.jit(lambda k: ref_lm.init(k, cfg))(
            jax.random.PRNGKey(0)))
        if cfg.family == "vlm":
            tree["crossed"]["gate_x"] = np.full_like(
                tree["crossed"]["gate_x"], GATE_X)
        img = _image(cfg)
        img = None if img is None else jnp.asarray(img)
        tokens, _ = ref_serve.generate(
            jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(_prompts(cfg)),
            max_new_tokens=NEW, image_embeds=img)
        out[arch] = (tree, np.asarray(tokens))
    cfg = ref_get_config("qwen1.5-0.5b").reduced()
    servable = ref_serve.LMServable(
        jax.tree.map(jnp.asarray, out["qwen1.5-0.5b"][0]), cfg,
        max_new_tokens=3, max_batch=4,
        clock=ref_serve.VirtualClock(tick_s=1e-3))
    engine = ref_serve.ServingEngine(servable)
    order = _bucket_stream(engine, jnp.asarray)
    out["servable"] = (servable.stats(), order)
    return out


def _port(ref, arch):
    cfg = get_config(arch).reduced()
    return cfg, lm_params_from_numpy(ref[arch][0], cfg, device="cpu")


def _bucket_stream(engine, asarray):
    """Two prompts of 8 and one of 6 (the reference's bucket test), then
    one of 6 again: the ids of each step's batch."""
    a = engine.submit(asarray(np.zeros((8,), np.int32)))
    b = engine.submit(asarray(np.arange(6, dtype=np.int32)))
    c = engine.submit(asarray(np.ones((8,), np.int32)))
    steps = [[r.id for r in engine.step()], [r.id for r in engine.step()]]
    engine.submit(asarray(np.full((6,), 3, np.int32)))
    steps.append([r.id for r in engine.step()])
    assert steps[0] == [a.id, c.id] and steps[1] == [b.id]
    return steps


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference_token_for_token(ref, arch):
    cfg, params = _port(ref, arch)
    img = _image(cfg)
    out, stats = generate(params, cfg, torch.from_numpy(_prompts(cfg)),
                          max_new_tokens=NEW, device="cpu",
                          image_embeds=None if img is None
                          else torch.from_numpy(img))
    assert out.dtype == torch.int32 and out.shape == (B, S + NEW)
    np.testing.assert_array_equal(out.numpy(), ref[arch][1], err_msg=arch)
    assert set(stats) == {"prefill_s", "decode_tok_per_s", "decode_s"}


def test_servable_buckets_and_stats_match_reference(ref):
    cfg, params = _port(ref, "qwen1.5-0.5b")
    servable = LMServable(params, cfg, max_new_tokens=3, max_batch=4,
                          clock=VirtualClock(tick_s=1e-3), device="cpu")
    engine = ServingEngine(servable)
    want_stats, want_order = ref["servable"]
    assert _bucket_stream(engine, torch.from_numpy) == want_order
    got = servable.stats()
    assert set(got) == set(want_stats)
    for key, want in want_stats.items():
        assert got[key] == pytest.approx(want, rel=1e-12), key
    assert servable.bucket_of(np.zeros(7)) == ("lm", 7)
    assert servable.bucket_of(torch.zeros(5)) == ("lm", 5)


def test_engine_path_matches_generate(ref):
    cfg, params = _port(ref, "mistral-nemo-12b")
    prompts = torch.from_numpy(_prompts(cfg))
    out, _ = generate(params, cfg, prompts, max_new_tokens=4, device="cpu")
    servable = LMServable(params, cfg, max_new_tokens=4, max_batch=2,
                          device="cpu")
    engine = ServingEngine(servable)
    reqs = [engine.submit(prompts[i]) for i in range(B)]
    engine.drain()
    assert torch.equal(torch.stack([r.result for r in reqs]), out)
    # a second call: the same tokens (greedy)
    again, _ = generate(params, cfg, prompts, max_new_tokens=4, device="cpu")
    assert torch.equal(again, out)


def test_make_serve_step_is_decode_step():
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init(0, cfg, device="cpu")
    ids = torch.from_numpy(_prompts(cfg, s=6))
    with torch.inference_mode():
        _, cache = lm.prefill(params, cfg, ids, max_seq=8)
        twin = {k: v.clone() for k, v in cache.items()}
        got, got_cache = make_serve_step(cfg)(params, cache, ids[:, :1],
                                              torch.tensor(6, dtype=torch.int32))
        want, _ = lm.decode_step(params, cfg, twin, ids[:, :1], 6)
    assert torch.equal(got, want)
    assert got_cache is cache                    # written in place
    assert all(torch.equal(cache[k], twin[k]) for k in cache)


def test_sampling_draws_from_the_given_generator():
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init(0, cfg, device="cpu")
    prompts = torch.from_numpy(_prompts(cfg))
    runs = [generate(params, cfg, prompts, max_new_tokens=6,
                     temperature=1.5, key=k, device="cpu")[0]
            for k in (7, 7, torch.Generator().manual_seed(7), 8)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], runs[3])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_servable_wants_its_weights_on_its_device():
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init(0, cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMServable(params, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate(params, cfg, torch.zeros((1, 4), dtype=torch.int32))
    else:
        with pytest.raises(ValueError, match="lie on"):
            LMServable(params, cfg)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama-3.2-vision-11b",
                                  "llama4-scout-17b-a16e", "rwkv6-3b",
                                  "zamba2-7b"])
def test_example_serves_on_the_cpu(capsys, arch):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import serve_lm_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    out, stats = serve_lm_torch.main(["--device", "cpu", "--batch", "2",
                                      "--prompt-len", "8", "--new", "4",
                                      "--arch", arch])
    assert out.shape == (2, 12) and stats["decode_tok_per_s"] > 0
    assert "generated token ids" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_one_capture_per_config_batch_and_capacity(cuda, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              name=f"capture-count-test-{arch}")
    params = lm.init(0, cfg)
    if cfg.family == "vlm":
        params["crossed"]["gate_x"].fill_(GATE_X)
    prompts = torch.from_numpy(_prompts(cfg))
    img = _image(cfg)
    img = None if img is None else torch.from_numpy(img)
    kw = {"image_embeds": None if img is None else img.to(cuda)}
    serve.clear_lm_captures()
    out, _ = generate(params, cfg, prompts, max_new_tokens=4, **kw)
    assert serve.lm_capture_counts() == {"prefill": 1, "step": 1,
                                         "sessions": 1}
    again, _ = generate(params, cfg, prompts, max_new_tokens=4, **kw)
    assert torch.equal(out, again)
    assert serve.lm_capture_counts()["step"] == 1
    # another capacity is another session; another prompt length of the
    # same capacity another prefill in the same session
    generate(params, cfg, prompts, max_new_tokens=6, **kw)
    generate(params, cfg, prompts[:, :7], max_new_tokens=6, **kw)
    assert serve.lm_capture_counts() == {"prefill": 3, "step": 2,
                                         "sessions": 2}
    with torch.inference_mode():
        cpu = generate(lm_params_from_numpy(
            {k: v for k, v in _numpy_tree(params).items()}, cfg,
            device="cpu"), cfg, prompts, max_new_tokens=4, device="cpu",
            image_embeds=img)[0]
    assert torch.equal(out.cpu(), cpu)
    serve.clear_lm_captures()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_captured_steps_are_the_eager_steps_bitwise(cuda, arch):
    cfg = get_config(arch).reduced()
    params = lm.init(0, cfg)
    if cfg.family == "vlm":
        params["crossed"]["gate_x"].fill_(GATE_X)
    prompts = torch.from_numpy(_prompts(cfg)).to(cuda)
    img = _image(cfg)
    img = None if img is None else torch.from_numpy(img).to(cuda)
    sess = serve._session(params, cfg, B, S + 4)
    last, cache = sess.prefill(prompts, img)
    with torch.inference_mode():
        want_last, eager = lm.prefill(params, cfg, prompts,
                                      image_embeds=img, max_seq=S + 4)
        assert torch.equal(last, want_last)
        assert all(torch.equal(cache[k], eager[k]) for k in eager)
        ids1 = prompts[:, :1]
        for t in range(3):
            pos = torch.tensor(S + t, dtype=torch.int32, device=cuda)
            got, cache = sess.decode(cache, ids1, pos)
            want, eager = lm.decode_step(params, cfg, eager, ids1, pos)
            assert torch.equal(got, want), t
        assert all(torch.equal(cache[k], eager[k]) for k in eager)
    serve.clear_lm_captures()
