"""The port's AdamW, schedule and clipping (``repro_torch.optim``) against
the JAX package's ``repro.optim`` on the same trees and gradients.

Tolerances, and why:
- ``warmup_cosine``: within 1 float32 ulp (the port tables the schedule
  with the C library's float32 cosine, which XLA's CPU backend calls; it
  agrees bit for bit on every step here);
- ``clip_by_global_norm``: the global norm and the clipped leaves within
  ``rtol=1e-6``, not 1 ulp: the norm is a float32 sum of squares, and XLA
  picks its order by size and by whether the call is jitted (on a
  512-element leaf its eager and jitted sums lie 7 ulps apart), so no
  fixed order matches it everywhere (measured: 2 ulps at most here);
- five ``adamw_update`` steps: params and float32 moments within
  ``rtol=1e-6``, with ``atol=1e-6 * max|leaf|`` for the elements that an
  update carried near zero (the clipping scale follows the norm, and XLA
  may contract a multiply-add into an FMA); bfloat16 moments within one
  bfloat16 ulp (an ulp of float32 before the cast can round the other
  way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizer as ref                            # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,             # noqa: E402
                               adamw_update, clip_by_global_norm,
                               tree_leaves, tree_map, warmup_cosine)

SCHEDULES = [dict(lr=1e-3, warmup_steps=20, total_steps=200,
                  weight_decay=0.01),
             dict(lr=3e-4, warmup_steps=100, total_steps=1000),
             dict(lr=0.05, warmup_steps=7, total_steps=333, min_lr_frac=0.0),
             dict(lr=2e-3, warmup_steps=0, total_steps=50, min_lr_frac=0.3),
             dict(lr=1.0, warmup_steps=30, total_steps=10)]


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _tree(seed, scale=1.0):
    """A model-shaped tree of float32 NumPy leaves."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa
    return {"sa": [[{"w": mk(4, 16), "b": mk(16)}, {"w": mk(16, 32),
                                                    "b": mk(32)}],
                   [{"w": mk(32, 32), "b": mk(32)}]],
            "head": [{"w": mk(32, 256), "b": mk(256)},
                     {"w": mk(256, 10), "b": mk(10)}]}


def _torch_tree(tree):
    return tree_map(lambda a: torch.tensor(np.array(a)), tree)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_warmup_cosine_matches_reference_every_step(kw):
    rcfg, pcfg = ref.AdamWConfig(**kw), AdamWConfig(**kw)
    steps = range(0, pcfg.total_steps + 5)
    want = [np.asarray(ref.warmup_cosine(rcfg, jnp.int32(s))) for s in steps]
    got = [warmup_cosine(pcfg, torch.tensor(s, dtype=torch.int32)).numpy()
           for s in steps]
    assert _ulps(want, got) <= 1
    assert warmup_cosine(pcfg, 3).dtype == torch.float32


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_by_global_norm_matches_reference(seed, max_norm):
    tree = _tree(seed)
    want, wgn = ref.clip_by_global_norm(_jax_tree(tree), max_norm)
    got, gn = clip_by_global_norm(_torch_tree(tree), max_norm)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wgn), rtol=1e-6)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_clip_scales_to_the_norm_and_floors_zero_grads():
    g = {"a": torch.ones(4) * 3, "b": torch.ones(4) * 4}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(10.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in tree_leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    zero, gn0 = clip_by_global_norm({"a": torch.zeros(3)}, 1.0)
    assert float(gn0) == 0.0 and torch.equal(zero["a"], torch.zeros(3))


def test_tree_leaves_in_the_jax_order():
    tree = _tree(0)
    want = [np.asarray(x) for x in jax.tree.leaves(_jax_tree(tree))]
    got = [x.numpy() for x in tree_leaves(_torch_tree(tree))]
    assert len(want) == len(got)
    assert all(np.array_equal(w, g) for w, g in zip(want, got))


def test_adamw_init_layout():
    params = _torch_tree(_tree(0))
    for dt in ("float32", "bfloat16"):
        st = adamw_init(params, AdamWConfig(moment_dtype=dt))
        assert st["step"].dtype == torch.int32 and st["step"].ndim == 0
        for p, m, v in zip(tree_leaves(params), tree_leaves(st["m"]),
                           tree_leaves(st["v"])):
            assert m.shape == p.shape and m.dtype == getattr(torch, dt)
            assert not m.any() and not v.any()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_five_adamw_steps_match_reference(moments):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1,
              clip_norm=5.0, moment_dtype=moments)
    rcfg, pcfg = ref.AdamWConfig(**kw), AdamWConfig(**kw)
    jp, tp = _jax_tree(_tree(0)), _torch_tree(_tree(0))
    js, ts = ref.adamw_init(jp, rcfg), adamw_init(tp, pcfg)
    for step in range(5):
        grads = _tree(10 + step, scale=0.5 + step)    # clipped at step >= 1
        jp, js, jm = ref.adamw_update(jp, _jax_tree(grads), js, rcfg)
        tp, ts, tm = adamw_update(tp, _torch_tree(grads), ts, pcfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert _ulps(jm["lr"], tm["lr"].numpy()) == 0
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
    for w, g in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())
    for part in ("m", "v"):
        for w, g in zip(jax.tree.leaves(js[part]), tree_leaves(ts[part])):
            assert g.dtype == getattr(torch, moments)
            if moments == "float32":
                w = np.asarray(w)
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())
            else:        # one bfloat16 ulp: compare the 16-bit patterns
                a = np.asarray(w).view(np.uint16).astype(np.int32)
                b = g.view(torch.int16).numpy().view(np.uint16).astype(
                    np.int32)
                assert int(np.abs(a - b).max()) <= 1


def test_adamw_updates_in_place_under_no_grad():
    params = tree_map(lambda t: t.requires_grad_(), _torch_tree(_tree(0)))
    before = [p.detach().clone() for p in tree_leaves(params)]
    ids = [id(p) for p in tree_leaves(params)]
    cfg = AdamWConfig(lr=0.1, warmup_steps=0)
    st = adamw_init(params, cfg)
    m_ids = [id(m) for m in tree_leaves(st["m"])]
    out, st, metrics = adamw_update(params, _torch_tree(_tree(1)), st, cfg)
    assert [id(p) for p in tree_leaves(out)] == ids
    assert [id(m) for m in tree_leaves(st["m"])] == m_ids
    assert all(p.requires_grad and p.is_leaf for p in tree_leaves(out))
    assert all(not torch.equal(p.detach(), b)
               for p, b in zip(tree_leaves(out), before))
    assert set(metrics) == {"grad_norm", "lr"}


def _quadratic(step_fn, params, state, target, n=200):
    for _ in range(n):
        params, state = step_fn(params, state)
    return params


def test_adamw_converges_on_quadratic_as_the_reference():
    kw = dict(lr=0.1, weight_decay=0.0, warmup_steps=5, total_steps=200,
              clip_norm=10.0)
    target = np.random.default_rng(0).normal(size=(8,)).astype(np.float32)
    rcfg, pcfg = ref.AdamWConfig(**kw), AdamWConfig(**kw)
    jt, tt = jnp.asarray(target), torch.from_numpy(target)

    def jstep(p, s):
        p, s, _ = ref.adamw_update(p, {"w": 2 * (p["w"] - jt)}, s, rcfg)
        return p, s

    def tstep(p, s):
        p, s, _ = adamw_update(p, {"w": 2 * (p["w"] - tt)}, s, pcfg)
        return p, s

    jp = {"w": jnp.zeros((8,), jnp.float32)}
    tp = {"w": torch.zeros(8)}
    jp = _quadratic(jstep, jp, ref.adamw_init(jp, rcfg), jt)
    tp = _quadratic(tstep, tp, adamw_init(tp, pcfg), tt)
    assert float((tp["w"] - tt).abs().max()) < 1e-2
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-5, atol=1e-6)


def test_adamw_bf16_moments_track_fp32():
    cfg32 = AdamWConfig(lr=0.05, weight_decay=0.0, total_steps=100)
    cfg16 = AdamWConfig(lr=0.05, weight_decay=0.0, total_steps=100,
                        moment_dtype="bfloat16")
    target = torch.ones(16) * 3
    p32, p16 = {"w": torch.zeros(16)}, {"w": torch.zeros(16)}
    s32, s16 = adamw_init(p32, cfg32), adamw_init(p16, cfg16)
    assert s16["m"]["w"].dtype == torch.bfloat16
    for _ in range(100):
        p32, s32, _ = adamw_update(p32, {"w": 2 * (p32["w"] - target)}, s32,
                                   cfg32)
        p16, s16, _ = adamw_update(p16, {"w": 2 * (p16["w"] - target)}, s16,
                                   cfg16)
    assert float((p16["w"] - p32["w"]).abs().max()) < 0.05


def test_warmup_cosine_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(warmup_cosine(cfg, s)) for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, abs=0.01)
    assert lrs[-1] == pytest.approx(0.1, abs=0.01)
    assert float(warmup_cosine(cfg, 10_000)) == lrs[-1]
