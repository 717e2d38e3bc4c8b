"""The LM stack's moe, ssm and hybrid families in the port
(``models/{moe,rwkv,ssm}.py`` and their branches of ``models/lm.py``)
against the JAX package, on the CPU.

The same inputs (NumPy seeds, ``dummy_inputs``) and the same weights (the
reference's initializers through NumPy, ``lm_params_from_numpy`` for whole
models) go through both packages in float32 at ``reduced()`` of grok-1
(top-2), llama4-scout (top-1), rwkv6 and zamba2.

Tolerances: the family modules within rtol = atol = 2e-4, the reference's
own chunked-against-sequential bar (``tests/test_models_lm.py``); MoE
routing (top-k indices, the sort by expert, slots, keep mask) exactly
equal; whole models' logits, caches and states within 1e-4 x the
reference's largest magnitude, argmax equal.

The state-space families' prefill keeps the state after the chunk's pad
tokens (the reference's behaviour, which the port reproduces): prompts of
20 and 32 tokens for rwkv (chunk 16), 40 and 64 for zamba2 (chunk 32) pin
that off the chunk decode departs from ``forward`` in both packages, and
on the chunk it does not; and the hybrid's KV cache length.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (dummy_inputs, get_config,          # noqa: E402
                                 input_specs)
from repro_torch.convert import lm_params_from_numpy                # noqa: E402
from repro_torch.models import lm, moe, rwkv, ssm                   # noqa: E402

ARCHS = ["grok-1-314b", "llama4-scout-17b-a16e", "rwkv6-3b", "zamba2-7b"]
#: (arch, prompt length, capacity factor or None for the config's)
RUNS = [("grok-1-314b", 20, None), ("llama4-scout-17b-a16e", 20, None),
        ("llama4-scout-17b-a16e", 20, 1.25),
        ("rwkv6-3b", 20, None), ("rwkv6-3b", 32, None),
        ("zamba2-7b", 40, None), ("zamba2-7b", 64, None)]
RUN_IDS = [f"{a}-s{s}" + (f"-cf{cf}" if cf else "") for a, s, cf in RUNS]
EXTRA = 3
TOL = 1e-4
MOD_TOL = 2e-4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.configs import dummy_inputs as ref_dummy_inputs
    from repro.configs import input_specs as ref_input_specs
    from repro.models import lm as ref_lm
    from repro.models import moe as ref_moe
    from repro.models import rwkv as ref_rwkv
    from repro.models import ssm as ref_ssm
    return dict(jax=jax, jnp=jax.numpy, lm=ref_lm, moe=ref_moe,
                rwkv=ref_rwkv, ssm=ref_ssm, get_config=ref_get_config,
                dummy_inputs=ref_dummy_inputs, input_specs=ref_input_specs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what, tol=TOL, argmax=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)
    if argmax:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                      err_msg=what)


def _allclose(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=MOD_TOL,
                               atol=MOD_TOL, err_msg=what)


def _t(tree):
    """A NumPy tree (or array) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _cfgs(jx, arch, cf=None, dtype=None):
    rcfg, cfg = jx["get_config"](arch).reduced(), get_config(arch).reduced()
    kw = {}
    if cf is not None:
        kw["capacity_factor"] = cf
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# the family modules
# ---------------------------------------------------------------------------

def _rwkv_weights(jx, d=32, hs=8, ff=64, seed=3):
    p = jx["jax"].device_get(jx["rwkv"].rwkv_init(
        jx["jax"].random.PRNGKey(seed), d, hs, ff, jx["jnp"].float32))
    # non-zero bonus and mixes, so that each term is exercised
    rng = np.random.default_rng(seed)
    p["time"]["u"] = rng.normal(size=p["time"]["u"].shape).astype(np.float32)
    p["time"]["mix"] = rng.uniform(size=(5, d)).astype(np.float32)
    p["channel"]["mix"] = rng.uniform(size=(2, d)).astype(np.float32)
    p["time"]["ln_g"] = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    return p


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def test_rwkv_time_mix_matches_reference(jx):
    jnp = jx["jnp"]
    p = _rwkv_weights(jx)
    x = _x((2, 48, 32), 4)
    last = _x((2, 1, 32), 5)
    st0 = _x((2, 4, 8, 8), 6)
    pj = jx["jax"].tree.map(jnp.asarray, p["time"])
    for kw, tkw in (({}, {}),
                    ({"state": jnp.asarray(st0), "last_x": jnp.asarray(last)},
                     {"state": _t(st0), "last_x": _t(last)})):
        want = jx["rwkv"].rwkv_time_mix(pj, jnp.asarray(x), head_size=8, **kw)
        got = rwkv.rwkv_time_mix(_t(p["time"]), _t(x), head_size=8, **tkw)
        for g, w, name in zip(got, want, ("out", "state", "last_x")):
            _allclose(g, w, f"time mix {name} {sorted(kw)}")


def test_rwkv_steps_and_channel_mix_match_reference(jx):
    jnp = jx["jnp"]
    p = _rwkv_weights(jx)
    x1, last, st = _x((2, 1, 32), 7), _x((2, 1, 32), 8), _x((2, 4, 8, 8), 9)
    want = jx["rwkv"].rwkv_time_mix_step(
        jx["jax"].tree.map(jnp.asarray, p["time"]), jnp.asarray(x1),
        jnp.asarray(st), jnp.asarray(last), head_size=8)
    got = rwkv.rwkv_time_mix_step(_t(p["time"]), _t(x1), _t(st), _t(last),
                                  head_size=8)
    for g, w, name in zip(got, want, ("out", "state", "last_x")):
        _allclose(g, w, f"time mix step {name}")
    pc = jx["jax"].tree.map(jnp.asarray, p["channel"])
    x = _x((2, 16, 32), 10)
    for last_x in (None, last):
        want = jx["rwkv"].rwkv_channel_mix(
            pc, jnp.asarray(x),
            last_x=None if last_x is None else jnp.asarray(last_x))
        got = rwkv.rwkv_channel_mix(
            _t(p["channel"]), _t(x),
            last_x=None if last_x is None else _t(last_x))
        for g, w in zip(got, want):
            _allclose(g, w, "channel mix")
    want = jx["rwkv"].rwkv_channel_mix_step(pc, jnp.asarray(x1),
                                            jnp.asarray(last))
    got = rwkv.rwkv_channel_mix_step(_t(p["channel"]), _t(x1), _t(last))
    for g, w in zip(got, want):
        _allclose(g, w, "channel mix step")


def test_rwkv_chunked_equals_sequential(jx):
    """The reference's property, on the port alone."""
    p = _t(_rwkv_weights(jx)["time"])
    x = _t(_x((2, 48, 32), 4))
    y_chunk, st_c, _ = rwkv.rwkv_time_mix(p, x, head_size=8)
    st = torch.zeros((2, 4, 8, 8))
    lx = torch.zeros((2, 1, 32))
    ys = []
    for t in range(48):
        y1, st, lx = rwkv.rwkv_time_mix_step(p, x[:, t:t + 1], st, lx,
                                             head_size=8)
        ys.append(y1)
    _allclose(y_chunk, torch.cat(ys, dim=1), "chunked vs sequential out")
    _allclose(st_c, st, "chunked vs sequential state")


def _mamba_weights(jx, d=32, n=8, seed=0):
    p = jx["jax"].device_get(jx["ssm"].mamba_init(
        jx["jax"].random.PRNGKey(seed), d, n, jx["jnp"].float32))
    rng = np.random.default_rng(seed)
    h = p["A_log"].shape[0]
    for k in ("A_log", "dt_bias"):
        p[k] = rng.normal(size=h).astype(np.float32)
    p["D"] = (1 + 0.3 * rng.normal(size=h)).astype(np.float32)
    return p


def test_mamba_forward_matches_reference(jx):
    jnp = jx["jnp"]
    p = _mamba_weights(jx)
    pj = jx["jax"].tree.map(jnp.asarray, p)
    x = _x((2, 64, 32), 2)
    st0, cv0 = _x((2, 1, 64, 8), 3), _x((2, 3, 64 + 16), 4)
    for kw, tkw in (({}, {}),
                    ({"state": jnp.asarray(st0),
                      "conv_state": jnp.asarray(cv0)},
                     {"state": _t(st0), "conv_state": _t(cv0)})):
        want = jx["ssm"].mamba_forward(pj, jnp.asarray(x), ssm_state=8, **kw)
        got = ssm.mamba_forward(_t(p), _t(x), ssm_state=8, **tkw)
        for g, w, name in zip(got, want, ("y", "state", "conv")):
            _allclose(g, w, f"mamba forward {name} {sorted(kw)}")


def test_mamba_decode_step_matches_reference(jx):
    jnp = jx["jnp"]
    p = _mamba_weights(jx)
    x1, st, cv = _x((2, 1, 32), 5), _x((2, 1, 64, 8), 6), _x((2, 3, 80), 7)
    want = jx["ssm"].mamba_decode_step(
        jx["jax"].tree.map(jnp.asarray, p), jnp.asarray(x1), jnp.asarray(st),
        jnp.asarray(cv), ssm_state=8)
    got = ssm.mamba_decode_step(_t(p), _t(x1), _t(st), _t(cv), ssm_state=8)
    for g, w, name in zip(got, want, ("y", "state", "conv")):
        _allclose(g, w, f"mamba step {name}")


def test_mamba_chunked_equals_sequential(jx):
    p = _t(_mamba_weights(jx))
    x = _t(_x((2, 64, 32), 2))
    y_chunk, state_c, conv_c = ssm.mamba_forward(p, x, ssm_state=8)
    st = torch.zeros((2, 1, 64, 8))
    cv = torch.zeros((2, 3, 80))
    ys = []
    for t in range(64):
        y1, st, cv = ssm.mamba_decode_step(p, x[:, t:t + 1], st, cv,
                                           ssm_state=8)
        ys.append(y1)
    _allclose(y_chunk, torch.cat(ys, dim=1), "chunked vs sequential y")
    _allclose(state_c, st, "chunked vs sequential state")
    _allclose(conv_c, cv, "chunked vs sequential conv state")


def test_conv_rounds_each_tap_in_the_model_dtype():
    """bf16: the sum of the four products rounds after each op, as the
    reference's Python ``sum`` does."""
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(size=(1, 6, 8)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)
                         ).to(torch.bfloat16)
    y, state = ssm._conv({"conv_w": w}, u)
    up = torch.cat([torch.zeros((1, 3, 8), dtype=torch.bfloat16), u], dim=1)
    acc = up[:, 0:6] * w[0]
    for i in range(1, 4):
        acc = (acc + (up[:, i:i + 6] * w[i]))
    assert torch.equal(y, torch.nn.functional.silu(acc))
    assert torch.equal(state, u[:, -3:])


MOE_CASES = {
    # (top_k, capacity factor, expect drops)
    "top1-cf1.25": (1, 1.25, True),
    "top1-dropless": (1, 4.0, False),
    "top2-cf1.25": (2, 1.25, True),
    "top2-dropless": (2, 4.0, False),
}


def _moe_case(jx, top_k, seed=5, t=32, d=16, f=32, e=4):
    p = jx["jax"].device_get(jx["moe"].moe_init(
        jx["jax"].random.PRNGKey(seed), d, f, e, jx["jnp"].float32))
    # a skewed batch: the router prefers some experts, so capacity 1.25
    # drops tokens
    x = _x((t, d), seed, scale=1.0) + np.linspace(0, 1, d, dtype=np.float32)
    return p, x.astype(np.float32)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_routing_equals_reference_exactly(jx, case):
    jnp = jx["jnp"]
    top_k, cf, drops = MOE_CASES[case]
    p, x = _moe_case(jx, top_k)
    t, e = x.shape[0], p["gate"].shape[0]
    cap = moe.capacity(cf, t, top_k, e)
    assert cap == max(1, int(cf * t * top_k / e))
    want_xe, (st, sg, slot, keep) = jx["moe"]._route_local(
        jnp.asarray(x), jnp.asarray(p["router"]["w"]), top_k, cap, e)
    got_xe, meta, top_idx, logits = moe._route_local(
        _t(x), _t(p["router"]["w"]), top_k, cap, e)
    _, want_idx = jx["jax"].lax.top_k(jnp.asarray(x) @ p["router"]["w"],
                                      top_k)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(want_idx))
    for g, w, name in zip(meta, (st, sg, slot, keep),
                          ("token order", "gate", "slot", "keep")):
        if name == "gate":
            _allclose(g, w, name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert bool((~meta[3]).any()) == drops, case
    np.testing.assert_array_equal(got_xe.numpy(), np.asarray(want_xe))
    want = jx["moe"].moe_apply(jx["jax"].tree.map(jnp.asarray, p),
                               jnp.asarray(x), top_k=top_k,
                               capacity_factor=cf)
    got = moe.moe_apply(_t(p), _t(x), top_k=top_k, capacity_factor=cf)
    _allclose(got, want, f"moe_apply {case}")


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_top_k_breaks_ties_to_the_lower_index(jx, top_k):
    jnp = jx["jnp"]
    logits = np.array([[0.0, 1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                       [0.0, 0.0, 0.0, 3.0], [1.0, 0.0, 1.0, 1.0]],
                      np.float32)
    val, idx = moe._top_k(_t(logits), top_k)
    want_val, want_idx = jx["jax"].lax.top_k(jnp.asarray(logits), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_val))


def _recorded_routes(monkeypatch) -> list:
    """Each ``moe_apply`` call's routing from here on, as ``_route_local``
    returns it (the way ``chip_smoke.record_routes`` sees it):
    ``{"top_idx", "keep", "cap"}``."""
    rec, real = [], moe._route_local

    def recording(x, router_w, top_k, cap, e):
        out = real(x, router_w, top_k, cap, e)
        rec.append({"top_idx": out[2], "keep": out[1][3], "cap": cap})
        return out
    monkeypatch.setattr(moe, "_route_local", recording)
    return rec


def test_moe_records_routes_and_refuses_sharded_routing(jx, monkeypatch):
    """``moe_apply`` routes once a group through ``_route_local``, which a
    caller may wrap to record the routing: once a call unsharded; with
    ``shard_axes`` and 2 groups twice, each group of 16 tokens with its own
    capacity; 3 groups do not divide 32 tokens and are refused."""
    p, x = _moe_case(jx, 1)
    rec = _recorded_routes(monkeypatch)
    moe.moe_apply(_t(p), _t(x), top_k=1, capacity_factor=1.25)
    assert len(rec) == 1 and rec[0]["cap"] == 10
    assert tuple(rec[0]["top_idx"].shape) == (32, 1)
    moe.moe_apply(_t(p), _t(x), top_k=1, shard_axes=("data",), groups=2)
    assert [r["cap"] for r in rec[1:]] == [5, 5]
    assert [tuple(r["top_idx"].shape) for r in rec[1:]] == [(16, 1)] * 2
    with pytest.raises(ValueError, match="routing groups"):
        moe.moe_apply(_t(p), _t(x), top_k=1, shard_axes=("data",), groups=3)


# ---------------------------------------------------------------------------
# whole models against the reference
# ---------------------------------------------------------------------------

def _ref_params(jx, rcfg):
    jax = jx["jax"]
    return jax.device_get(jax.jit(lambda key: jx["lm"].init(key, rcfg))(
        jax.random.PRNGKey(0)))


def _run_ref(jx, rcfg, tree, ids, s):
    jax, jnp, ref_lm = jx["jax"], jx["jnp"], jx["lm"]
    p = jax.tree.map(jnp.asarray, tree)
    ids = jnp.asarray(ids)
    out = {"logits": jax.jit(lambda p, i: ref_lm.forward(p, rcfg, i)[0])(
        p, ids)}
    out["loss"] = jax.jit(lambda p, i: ref_lm.loss_fn(p, rcfg, i, i)[0])(
        p, ids)
    last, cache = jax.jit(lambda p, i: ref_lm.prefill(
        p, rcfg, i, max_seq=s + EXTRA))(p, ids[:, :s])
    out["prefill"], out["cache"] = last, jax.device_get(cache)
    step = jax.jit(lambda p, c, i, pos: ref_lm.decode_step(p, rcfg, c, i,
                                                           pos))
    steps = []
    for t in range(EXTRA):
        lg, cache = step(p, cache, ids[:, s + t:s + t + 1], jnp.int32(s + t))
        steps.append(lg)
    out["steps"], out["final_cache"] = steps, jax.device_get(cache)
    return jax.device_get(out)


def _run_port(cfg, params, ids, s):
    out = {"logits": lm.forward(params, cfg, ids)[0],
           "loss": lm.loss_fn(params, cfg, ids, ids)[0]}
    last, cache = lm.prefill(params, cfg, ids[:, :s], max_seq=s + EXTRA)
    out["prefill"] = last
    out["cache"] = {k: v.clone() for k, v in cache.items()}
    steps = []
    for t in range(EXTRA):
        lg, same = lm.decode_step(params, cfg, cache,
                                  ids[:, s + t:s + t + 1], pos=s + t)
        assert same is cache                      # written in place
        steps.append(lg)
    out["steps"], out["final_cache"] = steps, cache
    return out


@pytest.fixture(scope="module")
def runs(jx):
    """run id -> (the reference's outputs, the port's), on the same weights
    and inputs."""
    out, trees = {}, {}
    with torch.inference_mode():
        for (arch, s, cf), rid in zip(RUNS, RUN_IDS):
            rcfg, cfg = _cfgs(jx, arch, cf)
            if arch not in trees:
                trees[arch] = _ref_params(jx, rcfg)
            tree = trees[arch]
            params = lm_params_from_numpy(tree, cfg, device="cpu")
            ids = np.asarray(jx["dummy_inputs"](rcfg, "prefill", 2,
                                                s + EXTRA, seed=5)["ids"])
            port_ids = dummy_inputs(cfg, "prefill", 2, s + EXTRA, seed=5,
                                    device="cpu")["ids"]
            np.testing.assert_array_equal(port_ids.numpy(), ids)
            out[rid] = (_run_ref(jx, rcfg, tree, ids, s),
                        _run_port(cfg, params, port_ids, s))
    return out


def _state_close(got, want, what):
    """A cache leaf: float states and caches within TOL x max|reference|
    (an all-zero leaf exactly)."""
    if not np.abs(_np(want)).max():
        assert not _np(got).any(), what
        return
    _close(got, want, what)


@pytest.mark.parametrize("rid", RUN_IDS)
def test_forward_logits_match_reference(runs, rid):
    ref, port = runs[rid]
    _close(port["logits"], ref["logits"], f"{rid} forward", argmax=True)
    want = float(ref["loss"])
    assert abs(float(port["loss"]) - want) <= 1e-5 * abs(want), rid


@pytest.mark.parametrize("rid", RUN_IDS)
def test_prefill_logits_and_cache_match_reference(runs, rid):
    ref, port = runs[rid]
    _close(port["prefill"], ref["prefill"], f"{rid} prefill", argmax=True)
    assert sorted(port["cache"]) == sorted(ref["cache"])
    for key, want in ref["cache"].items():
        got = port["cache"][key]
        assert got.dtype == getattr(torch, str(want.dtype)), (rid, key)
        _state_close(got, want, f"{rid} cache {key}")


@pytest.mark.parametrize("rid", RUN_IDS)
def test_three_decode_steps_match_reference(runs, rid):
    ref, port = runs[rid]
    for t, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        _close(got, want, f"{rid} decode step {t}", argmax=True)
    for key, want in ref["final_cache"].items():
        _state_close(port["final_cache"][key], want, f"{rid} cache {key}")


def _departure(port_or_ref, s):
    """The largest |decode - forward| over the prefill and the steps, over
    max|forward|."""
    full = _np(port_or_ref["logits"])
    outs = [port_or_ref["prefill"]] + list(port_or_ref["steps"])
    err = max(float(np.abs(_np(o) - full[:, s - 1 + i]).max())
              for i, o in enumerate(outs))
    return err / float(np.abs(full).max())


@pytest.mark.parametrize("rid", RUN_IDS)
def test_decode_continues_forward_only_on_the_chunk(runs, rid):
    """Off the chunk the reference's prefill keeps the state after its pad
    tokens, so its decode departs from ``forward`` by the order of the
    logits themselves; the port's does the same (and equals the
    reference's, above). On the chunk, and for the attention families,
    decode continues ``forward``, unless MoE drops tokens: at capacity
    factor 1.25 the capacity follows each call's token count, so prefill
    and decode drop other tokens than ``forward`` does, in both packages."""
    arch, s, cf = RUNS[RUN_IDS.index(rid)]
    ref, port = runs[rid]
    chunk = {"rwkv6-3b": rwkv.CHUNK, "zamba2-7b": ssm.CHUNK}.get(arch)
    if cf is not None:
        assert _departure(port, s) > 1e-3, rid
        assert _departure(ref, s) > 1e-3, rid
        return
    # the prefill's last position comes before any pad: it is forward's
    _close(port["prefill"], port["logits"][:, s - 1], f"{rid} prefill")
    if chunk is None or s % chunk == 0:
        assert _departure(port, s) <= TOL, rid
        assert _departure(ref, s) <= TOL, rid
    else:
        assert _departure(port, s) > 0.1, rid
        assert _departure(ref, s) > 0.1, rid


def test_hybrid_cache_keeps_the_padded_prompt(runs):
    """At 40 tokens with capacity 43 the hybrid's keys and values hold 64
    rows (the prompt padded to the chunk), the pad tokens' among them, in
    both packages; at 64 with capacity 67, 67."""
    for rid, rows in (("zamba2-7b-s40", 64), ("zamba2-7b-s64", 67)):
        ref, port = runs[rid]
        for key in ("k", "v"):
            assert ref["cache"][key].shape[2] == rows, rid
            assert port["cache"][key].shape[2] == rows, rid
    ref, port = runs["zamba2-7b-s40"]
    assert np.abs(_np(port["cache"]["k"][:, :, 40:64])).max() > 0
    assert lm.kv_rows(get_config("zamba2-7b"), 40) == 64
    assert lm.kv_rows(get_config("rwkv6-3b"), 40) == 40


def test_moe_decode_drops_tokens_at_capacity_one(monkeypatch):
    """llama4-scout at the published capacity factor: a decode step over 2
    tokens has capacity max(1, int(1.25 · 2 / 4)) = 1, so two tokens routed
    to one expert drop one of them (the run above holds such steps equal to
    the reference's); at capacity factor n_experts nothing drops."""
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    ids = dummy_inputs(cfg, "prefill", 2, 40, seed=5, device="cpu")["ids"]
    drops = {}
    for cf in (1.25, float(cfg.n_experts)):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        params = lm.init(0, c, device="cpu")
        with torch.inference_mode():
            _, cache = lm.prefill(params, c, ids[:, :20], max_seq=40)
            with monkeypatch.context() as m:
                rec = _recorded_routes(m)
                for t in range(20, 39):
                    lm.decode_step(params, c, cache, ids[:, t:t + 1], t)
        assert {r["cap"] for r in rec} == {moe.capacity(cf, 2, 1, 4)}
        drops[cf] = sum(int((~r["keep"]).sum()) for r in rec)
    assert moe.capacity(1.25, 2, 1, 4) == 1
    assert drops[1.25] > 0 and drops[float(cfg.n_experts)] == 0, drops


# ---------------------------------------------------------------------------
# init, conversion, inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_is_bitwise_on_a_bf16_tree(jx, arch):
    """The stacked ``mamba``/``mamba_trail``/``shared_attn``, ``blocks``
    with ``time``/``channel``, and ``moe`` trees: leaf for leaf, bit for
    bit, the float32 leaves (router, decays, ``u``) kept float32."""
    rcfg, cfg = _cfgs(jx, arch, dtype="bfloat16")
    jax = jx["jax"]
    tree = jax.device_get(jax.jit(lambda key: jx["lm"].init(key, rcfg))(
        jax.random.PRNGKey(7)))
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    ref_leaves, port_leaves = dict(_leaves(tree)), dict(_leaves(params))
    assert sorted(ref_leaves) == sorted(port_leaves)
    n_f32 = 0
    for path, a in ref_leaves.items():
        a = np.asarray(a)
        t = port_leaves[path]
        assert tuple(t.shape) == a.shape, path
        if a.dtype == np.float32:
            n_f32 += 1
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), a, err_msg=path)
        else:
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16), err_msg=path)
    assert n_f32 > 0, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_in_the_reference_layout(jx, arch):
    rcfg, cfg = _cfgs(jx, arch, dtype="bfloat16")
    want = dict(_leaves(jx["jax"].eval_shape(
        lambda: jx["lm"].init(jx["jax"].random.PRNGKey(0), rcfg))))
    a, b = lm.init(2, cfg, device="cpu"), lm.init(2, cfg, device="cpu")
    got = dict(_leaves(a))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert tuple(got[path].shape) == spec.shape, path
        assert got[path].dtype == getattr(torch, str(spec.dtype)), path
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(_leaves(a), _leaves(b)))


def test_hybrid_init_stacks_super_layers_and_trail():
    cfg = get_config("zamba2-7b").reduced()          # 5 = 2 x 2 + 1
    p = lm.init(0, cfg, device="cpu")
    assert p["mamba"]["ln"]["g"].shape[:2] == (2, 2)
    assert p["mamba_trail"]["ln"]["g"].shape[0] == 1
    assert "mlp" in p["shared_attn"] and "moe" not in p["shared_attn"]
    # the layers differ: each was drawn on its own
    w = p["mamba"]["mamba"]["in_proj"]["w"]
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0, 0],
                                                                 w[1, 0])
    no_trail = dataclasses.replace(cfg, n_layers=4)
    assert lm.init(0, no_trail, device="cpu")["mamba_trail"]["ln"]["g"
                                                                  ].shape[0] == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_input_specs_match_reference(jx, arch, shape):
    want = dict(_leaves(jx["input_specs"](jx["get_config"](arch), shape)))
    got = dict(_leaves(input_specs(get_config(arch), shape)))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert got[path].device.type == "meta", path
        assert tuple(got[path].shape) == tuple(spec.shape), path
        assert got[path].dtype == getattr(torch, str(spec.dtype)), path


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dummy_inputs_are_the_reference_numbers(jx, arch, kind):
    want = dict(_leaves(jx["jax"].device_get(jx["dummy_inputs"](
        jx["get_config"](arch).reduced(), kind, 2, 6, seed=11))))
    got = dict(_leaves(dummy_inputs(get_config(arch).reduced(), kind, 2, 6,
                                    seed=11, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        assert got[path].dtype == getattr(torch, str(np.asarray(a).dtype)), \
            path
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(a),
                                      err_msg=path)


def test_session_capacity_rounds_the_hybrids_kv_rows():
    """A served hybrid's cache holds its capacity rounded up to the chunk,
    and a prefill into it keeps the padded prompt: the same first rows as
    a prefill of the reference's capacity."""
    cfg = get_config("zamba2-7b").reduced()
    params = lm.init(0, cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    rows = lm.kv_rows(cfg, 14)
    assert rows == 32
    with torch.inference_mode():
        cache = lm.init_cache(cfg, 2, rows, device="cpu")
        for t in cache.values():
            t.fill_(7)                 # stale state from an earlier batch
        last, same = lm.prefill(params, cfg, ids, max_seq=rows, cache=cache)
        want_last, want = lm.prefill(params, cfg, ids, max_seq=14)
    assert same is cache and torch.equal(last, want_last)
    for key in cache:
        assert torch.equal(cache[key], want[key]), key
    with pytest.raises(ValueError, match="holds 32"):
        lm.prefill(params, cfg, ids, max_seq=40, cache=cache)
