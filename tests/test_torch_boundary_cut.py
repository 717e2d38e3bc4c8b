"""The reference's boundary cut of activations over 'model' in the port
(``models/lm.py::_boundary_tp`` and ``_layer``, ``launch/tp.py``'s
``TensorParallel.cut`` and ``gather_out``), on the CPU, in the one-process
emulation of the 'model' ranks (``launch.tp.EmulatedTP`` at tp 4).

The reference's ``_shard_batch`` pins each block-boundary activation's
d_model over 'model' where ``cfg.batch_axes`` is set, tp > 1 and tp divides
d_model. The port holds such a boundary as the ranks' slices and joins it
whole where a block reads it; neither direction sums anything, so:

- one layer of each family the reference scans (dense, moe, vlm's plain
  layers, the hybrid's Mamba2 layers, RWKV6), in TP form at ``reduced()``
  widths, with and without ``remat``: the output and every gradient with
  the cut bit for bit those without it, and a checkpointed layer keeps the
  ranks' slices ``(4, B, S, D/4)``, in a storage of their own, as its input;
- each family's whole loss and every gradient through ``EmulatedTP`` with
  the cut bit for bit those with the boundaries whole, every checkpointed
  layer's input cut;
- a d_model that tp does not divide, no ``batch_axes`` and a 'model' axis
  of one rank keep the boundaries whole;
- ``TensorParallel.cut`` copies (no view of the whole), one rank's slice
  is a quarter of the bytes, and its gradient is the slices' gradients
  joined.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import dummy_inputs, get_config        # noqa: E402
from repro_torch.launch.tp import EmulatedTP, TensorParallel    # noqa: E402
from repro_torch.models import lm, rwkv, ssm                    # noqa: E402
from repro_torch.optim import tree_leaves, tree_map             # noqa: E402

TP = 4
BATCH, SEQ = 2, 32
#: per family: (config, the stacked layers' path, the sub-blocks in TP form)
FAMILIES = {"dense": ("qwen1.5-0.5b", "blocks", ("attn", "mlp")),
            "moe": ("grok-1-314b", "blocks", ("attn", "moe")),
            "vlm_plain": ("llama-3.2-vision-11b", "plain", ("attn", "mlp")),
            "hybrid_mamba": ("zamba2-7b", "mamba", ("mamba",)),
            "rwkv6": ("rwkv6-3b", "blocks", ("time", "channel"))}


def _cfg(arch: str, **over):
    return dataclasses.replace(get_config(arch).reduced(), tp=TP,
                               batch_axes=("data",), remat=True, **over)


def _call(cfg):
    """One layer of ``cfg``'s scanned kind: ``fn(blk, x) -> (out, ...)``."""
    if cfg.family == "hybrid":
        return lambda blk, x: lm._mamba_layer(blk, cfg, x)
    if cfg.family == "ssm":
        return lambda blk, x: lm._rwkv_layer(blk, cfg, x)
    pos = torch.arange(SEQ, dtype=torch.int32)
    return lambda blk, x: lm.block_apply(blk, cfg, x, pos)


class _Kept:
    """``lm.checkpoint`` recording each layer's input (the activation it
    keeps) while the context is open."""

    def __init__(self, monkeypatch):
        self.inputs = []
        real = lm.checkpoint

        def kept(fn, blk, x, **kw):
            self.inputs.append(x)
            return real(fn, blk, x, **kw)
        monkeypatch.setattr(lm, "checkpoint", kept)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_a_cut_layer_is_bit_for_bit_the_uncut_layer(family, remat,
                                                    monkeypatch):
    arch, path, subs = FAMILIES[family]
    cfg = _cfg(arch)
    assert cfg.d_model % TP == 0
    params = lm.init(0, cfg, device="cpu")
    lead = (0,) * lm.STACK_DIMS[path]
    blk = tree_map(lambda t: t[lead].detach().requires_grad_(), params[path])
    par = EmulatedTP(cfg, {path: subs}, TP)
    cut = lm._boundary_tp(cfg, par)
    assert cut is par.tp
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(
        np.float32))
    leaves = tree_leaves(blk) + [x]
    kept = _Kept(monkeypatch)
    out = {}
    for name, c in (("whole", None), ("cut", cut)):
        y = lm._layer(_call(cfg), blk, par, path, remat, x, c)[0]
        out[name] = (y.detach(), torch.autograd.grad(
            y, leaves, g, materialize_grads=True))
    (y0, g0), (y1, g1) = out["whole"], out["cut"]
    assert torch.equal(y1, y0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    if not remat:
        assert kept.inputs == []
        return
    whole, sliced = kept.inputs
    assert whole is x
    assert tuple(sliced.shape) == (TP, BATCH, SEQ, cfg.d_model // TP)
    assert sliced.untyped_storage().data_ptr() != \
        x.untyped_storage().data_ptr()
    assert sliced.untyped_storage().nbytes() == \
        sliced.numel() * sliced.element_size()


def _loss_and_grads(params, cfg, batch, par):
    loss, _ = lm.loss_fn(params, cfg, batch.get("ids"), batch["labels"],
                         embeds=batch.get("embeds"),
                         image_embeds=batch.get("image_embeds"), par=par)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(params),
                                              materialize_grads=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_the_cut_model_is_bit_for_bit_the_uncut_model(family, monkeypatch):
    arch, path, subs = FAMILIES[family]
    cfg = _cfg(arch)
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init(0, cfg, device="cpu"))
    batch = dummy_inputs(cfg, "train", batch=BATCH, seq=SEQ, device="cpu")
    par = EmulatedTP(cfg, {path: subs, "embed": ("",)}, TP)
    kept = _Kept(monkeypatch)
    loss, grads = _loss_and_grads(params, cfg, batch, par)
    chunk = {"hybrid": ssm.CHUNK, "ssm": rwkv.CHUNK}.get(cfg.family, 1)
    s = -(-SEQ // chunk) * chunk
    assert len(kept.inputs) == cfg.n_layers - (
        cfg.n_layers // cfg.cross_attn_interval if family == "vlm_plain"
        else 0)
    assert all(tuple(t.shape) == (TP, BATCH, s, cfg.d_model // TP)
               for t in kept.inputs)
    monkeypatch.setattr(lm, "_boundary_tp", lambda cfg, par: None)
    kept.inputs.clear()
    loss0, grads0 = _loss_and_grads(params, cfg, batch, par)
    assert all(t.ndim == 3 for t in kept.inputs)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def test_an_indivisible_d_model_stays_whole(monkeypatch):
    """d_model 66 over 4 'model' ranks: the reference does not cut it, and
    neither does the port; the step runs with whole boundaries."""
    cfg = _cfg("qwen1.5-0.5b", d_model=66)
    par = EmulatedTP(cfg, {"blocks": ("attn", "mlp")}, TP)
    assert lm._boundary_tp(cfg, par) is None
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init(0, cfg, device="cpu"))
    batch = dummy_inputs(cfg, "train", batch=BATCH, seq=SEQ, device="cpu")
    kept = _Kept(monkeypatch)
    loss, _ = _loss_and_grads(params, cfg, batch, par)
    assert bool(torch.isfinite(loss))
    assert [tuple(t.shape) for t in kept.inputs] == \
        [(BATCH, SEQ, 66)] * cfg.n_layers


def test_the_cut_needs_batch_axes_and_a_model_axis():
    cfg = _cfg("qwen1.5-0.5b")
    blocks = {"blocks": ("attn", "mlp")}
    assert lm._boundary_tp(cfg, EmulatedTP(cfg, blocks, TP)) is not None
    unpinned = dataclasses.replace(cfg, batch_axes=())
    assert lm._boundary_tp(unpinned, EmulatedTP(unpinned, blocks, TP)) \
        is None
    one = dataclasses.replace(cfg, tp=1)
    assert lm._boundary_tp(one, EmulatedTP(one, blocks, 1)) is None
    assert lm._boundary_tp(cfg, None) is None
    # a ParamShards on a mesh whose 'model' axis has one rank, or none
    assert lm._boundary_tp(cfg, types.SimpleNamespace(tp=None)) is None


def test_cut_copies_and_its_gradient_is_the_slices_joined():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(2, 3, 8)).astype(np.float32))
    tp = TensorParallel(TP, range(TP))
    y = tp.cut(x)
    assert tuple(y.shape) == (TP, 2, 3, 2)
    assert y.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    for r in range(TP):
        assert torch.equal(y[r], x.detach()[..., 2 * r:2 * r + 2])
    z = tp.gather_out(y)
    assert torch.equal(z, x.detach())
    (gx,) = torch.autograd.grad((z * w).sum(), x)
    assert torch.equal(gx, w)
    mine = TensorParallel(TP, (1,)).cut(x.detach())
    assert tuple(mine.shape) == (1, 2, 3, 2)
    assert mine.untyped_storage().nbytes() == x.numel() * 4 // TP
    assert torch.equal(mine[0], x.detach()[..., 2:4])
