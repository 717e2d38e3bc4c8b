"""``cfg.remat`` in the port (``models/lm.py::_layer``: the reference's
``jax.checkpoint`` of each scanned layer as a non-reentrant
``torch.utils.checkpoint``), on the CPU.

- every config's ``reduced()`` loss and every gradient with ``remat=True``
  bit for bit those with ``remat=False`` (the recompute repeats the same
  ops on the same inputs), and the step's peak of live bytes, counted on
  ``meta`` tensors (``hlo_analysis.StepCounter``), lower;
- the checkpointed layers are the reference's: the dense, moe and audio
  blocks, vlm's plain layers (not the crossed ones), the hybrid's Mamba2
  layers and trail (not the shared block), the RWKV6 blocks; none without
  grad mode (``prefill``) or without ``remat``;
- the reference's ``remat=True`` loss and gradients against the port's
  ``remat=True`` for a dense config (float32, within ``1e-6`` relative
  and ``1e-4 * max|g|``, as ``tests/test_torch_lm_train.py`` holds them
  without remat) and for rwkv6 in float64 (within ``F64_TOL * max|g|``:
  its float32 gradient is at its conditioning's limit, as that file
  explains).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (dummy_inputs, get_config,  # noqa: E402
                                 list_archs)
from repro_torch.convert import lm_params_from_numpy         # noqa: E402
from repro_torch.models import lm                            # noqa: E402
from repro_torch.optim import tree_leaves, tree_map          # noqa: E402

ARCHS = list_archs()
SEQ, BATCH = 36, 2
TOL = 1e-4
F64_TOL = 1e-10


def _cfg(arch: str, remat: bool, **over):
    return dataclasses.replace(get_config(arch).reduced(), remat=remat,
                               **over)


def _loss_and_grads(params, cfg, ins):
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = lm.loss_fn(params, cfg, ins.get("ids"), ins["labels"],
                         embeds=ins.get("embeds"),
                         image_embeds=ins.get("image_embeds"))
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(params),
                                              materialize_grads=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit_the_step_without(arch):
    cfg = _cfg(arch, False)
    params = lm.init(0, cfg, device="cpu")
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, device="cpu")
    loss, grads = _loss_and_grads(params, cfg, ins)
    loss_r, grads_r = _loss_and_grads(params, _cfg(arch, True), ins)
    assert torch.equal(loss, loss_r)
    assert len(grads) == len(grads_r)
    for a, b in zip(grads, grads_r):
        assert torch.equal(a, b)


def _meta_peak(arch: str, remat: bool) -> int:
    from repro_torch.launch.hlo_analysis import StepCounter
    cfg = _cfg(arch, remat)
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init(0, cfg, device="meta"))
    ins = {k: v.to("meta") for k, v in dummy_inputs(
        cfg, "train", BATCH, SEQ, device="cpu").items()}
    with StepCounter() as counter:
        counter.arguments(params, ins)
        loss, _ = lm.loss_fn(params, cfg, ins.get("ids"), ins["labels"],
                             embeds=ins.get("embeds"),
                             image_embeds=ins.get("image_embeds"))
        torch.autograd.grad(loss, tree_leaves(params),
                            materialize_grads=True)
    return counter.result()["peak_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_lowers_the_meta_peak(arch):
    assert _meta_peak(arch, True) < _meta_peak(arch, False)


#: per family, the layers the reference checkpoints at ``reduced()``
CHECKPOINTED = {"dense": lambda c: c.n_layers, "moe": lambda c: c.n_layers,
                "audio": lambda c: c.n_layers,
                "vlm": lambda c: c.n_layers - c.n_layers
                // c.cross_attn_interval,
                "hybrid": lambda c: c.n_layers,
                "ssm": lambda c: c.n_layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_checkpoints_the_references_layers(arch, monkeypatch):
    calls = []
    real = lm.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(kwargs)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(lm, "checkpoint", counted)
    cfg = _cfg(arch, True)
    params = lm.init(0, cfg, device="cpu")
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, device="cpu")
    _loss_and_grads(params, cfg, ins)
    assert len(calls) == CHECKPOINTED[cfg.family](cfg)
    assert all(k == {"use_reentrant": False, "preserve_rng_state": False}
               for k in calls)
    calls.clear()
    _loss_and_grads(params, _cfg(arch, False), ins)
    with torch.no_grad():
        pre = dummy_inputs(cfg, "prefill", BATCH, SEQ, device="cpu")
        lm.prefill(params, cfg, pre.get("ids"), embeds=pre.get("embeds"),
                   image_embeds=pre.get("image_embeds"))
    assert calls == []


# ---------------------------------------------------------------------------
# against the reference's jax.checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.configs import dummy_inputs as ref_dummy_inputs
    from repro.configs import get_config as ref_get_config
    from repro.models import lm as ref_lm
    return dict(jax=jax, jnp=jax.numpy, dummy_inputs=ref_dummy_inputs,
                get_config=ref_get_config, lm=ref_lm)


def _ref_loss_and_grads(ref, rcfg, tree, x64: bool):
    """The reference's loss and gradient leaves, jitted, with
    ``rcfg.remat``; ``x64``: in float64, its models' explicit ``float32``
    read as float64 (``tests/test_torch_lm_train.py``'s lifting)."""
    import repro.models.layers as ref_layers
    import repro.models.rwkv as ref_rwkv
    from test_torch_lm_train import _Float32IsFloat64
    jax, jnp = ref["jax"], ref["jnp"]
    rin = ref["dummy_inputs"](rcfg, "train", BATCH, SEQ, seed=5)
    dt = jnp.float64 if x64 else jnp.float32
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
        if x64:
            for mod in (ref["lm"], ref_layers, ref_rwkv):
                mp.setattr(mod, "jnp", _Float32IsFloat64(jnp))
        vg = jax.jit(jax.value_and_grad(lambda p, ids, lab: ref["lm"].loss_fn(
            p, rcfg, ids, lab)[0]))
        loss, g = vg(jax.tree.map(lambda a: jnp.asarray(a, dt), tree),
                     rin["ids"], rin["labels"])
        return float(loss), [np.asarray(x) for x in
                             jax.tree.leaves(jax.device_get(g))]


def _err(got, want) -> float:
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    return err / scale if scale else err


@pytest.mark.parametrize("arch,x64", [("qwen1.5-0.5b", False),
                                      ("rwkv6-3b", True)])
def test_remat_matches_the_references_remat(ref, arch, x64):
    jax = ref["jax"]
    dtype = "float64" if x64 else "float32"
    rcfg = dataclasses.replace(ref["get_config"](arch).reduced(),
                               remat=True, dtype=dtype)
    cfg = _cfg(arch, True, dtype=dtype)
    tree = jax.device_get(jax.jit(lambda key: ref["lm"].init(
        key, ref["get_config"](arch).reduced()))(jax.random.PRNGKey(0)))
    rloss, rg = _ref_loss_and_grads(ref, rcfg, tree, x64)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    if x64:
        params = tree_map(lambda t: t.double(), params)
    ins = dummy_inputs(cfg, "train", BATCH, SEQ, seed=5, device="cpu")
    loss, grads = _loss_and_grads(params, cfg, ins)
    assert abs(float(loss) - rloss) <= 1e-6 * abs(rloss)
    assert len(grads) == len(rg)
    for i, (got, want) in enumerate(zip(grads, rg)):
        assert got.shape == want.shape
        assert _err(got.numpy(), want) <= (F64_TOL if x64 else TOL), (
            i, _err(got.numpy(), want))
