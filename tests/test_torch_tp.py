"""Tensor-parallel compute in one process (``repro_torch.launch.tp``,
``launch.sharding.gather_plan``, the TP forms in ``models/layers.py`` and
``models/lm.py``), on the CPU.

A layer at tp 16 runs as 16 rank slices through the sharded step's code
(``TensorParallel(16, range(16))``: the ranks' partial products summed in
rank order) and is held against the unsplit layer, forward and backward, in
float32, within 1e-5 of each result's largest value: the split only
reorders sums (measured: 7e-7). The unsplit layer is the port's own, which
``tests/test_torch_lm.py`` holds against the JAX package. The configs are
``reduced()`` widths with 20 MHA heads with QKV biases (qwen1.5-4b's heads:
the layout pads them to 32) and 40 query heads over 8 KV heads
(llama4-scout's: the layout repeats each KV head twice and pads the query
heads to 48).

The blocks that compute on 'model' shards since then (the MoE experts,
vlm's cross-attention, the hybrid's shared block, RWKV6, Mamba2) run at tp
2 and 4 in float64 against the unsplit block, each in a widened config
where a rank's shard falls inside a head, within 1e-9 of each result's
largest value; RWKV6's and Mamba2's padded heads give exactly zero.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import make_train_step                 # noqa: E402
from repro_torch.launch.mesh import MeshShape                   # noqa: E402
from repro_torch.launch.sharding import (gather_plan,           # noqa: E402
                                         state_pspecs)
from repro_torch.launch.tp import TensorParallel                # noqa: E402
from repro_torch.models import lm                               # noqa: E402
from repro_torch.optim import AdamWConfig, tree_leaves, tree_map  # noqa: E402

TP = 16
#: (config, heads, KV heads, the layout's counts at tp 16)
LAYOUTS = {"mha20": ("qwen1.5-4b", 20, 20, (32, 32)),
           "gqa40_8": ("mistral-nemo-12b", 40, 8, (48, 16))}
BOUND = 1e-5


def _layer(name: str):
    """One seeded layer of the ``reduced()`` config at tp 16, its biases
    non-zero, float32, and an input."""
    arch, heads, kv, _ = LAYOUTS[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), n_heads=heads,
                              n_kv_heads=kv, d_head=8, tp=TP, n_layers=1)
    p = lm.init(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    blk = tree_map(lambda t: torch.from_numpy(
        rng.normal(size=tuple(t.shape)).astype(np.float32)
        * float(t.std() if t.numel() > 1 and t.std() > 0 else 0.1)
    ).requires_grad_(), tree_map(lambda t: t[0], p["blocks"]))
    x = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)).requires_grad_()
    return cfg, blk, x


@pytest.mark.parametrize("name", LAYOUTS)
def test_tp16_rank_slices_sum_to_the_unsplit_layer(name):
    cfg, blk, x = _layer(name)
    assert cfg.head_layout()[:2] == LAYOUTS[name][3]
    if cfg.qkv_bias:
        assert all(float(blk["attn"][n]["b"].detach().abs().max()) > 0
                   for n in "qkv")
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    leaves = tree_leaves(blk) + [x]
    want, _ = lm.block_apply(blk, cfg, x, pos)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(want.shape)).astype(np.float32))
    want_grads = torch.autograd.grad(want, leaves, g)
    tp = TensorParallel(TP, range(TP))
    got, _ = lm.block_apply(lm.tp_block_params(blk, cfg, tp), cfg, x, pos)
    got_grads = torch.autograd.grad(got, leaves, g)
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max()) <= BOUND * float(want.abs().max())
    for a, b in zip(got_grads, want_grads):
        assert float((a - b).abs().max()) <= BOUND * float(b.abs().max())


def test_tp_heads_give_each_rank_its_run_of_the_layout():
    """``tp_heads`` of the whole layout's q projection, rank by rank, is
    the arranged projection's columns cut in 16 equal runs; KV heads
    likewise (each repeated in place, GQA)."""
    cfg, blk, _ = _layer("gqa40_8")
    tp = TensorParallel(TP, range(TP))
    for proj, kind, arrange in (("q", "q", lm._arrange_wq),
                                ("k", "kv", lm._arrange_wkv)):
        w = blk["attn"][proj]["w"].detach()
        got = lm.tp_heads(w, cfg, tp, kind, 1)
        want = arrange(w, cfg)
        assert torch.equal(torch.cat(list(got), dim=1), want)


def test_tensor_parallel_reduce_sums_the_ranks_in_order():
    t = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    tp = TensorParallel(4, range(4))
    assert float(tp.reduce(t)[0]) == float(((t[0] + t[1]) + t[2]) + t[3])
    assert float(tp.reduce(t, "max")[0]) == 1e8
    assert torch.equal(tp.split(torch.arange(8), 0),
                       torch.arange(8).reshape(4, 2))


class _Leaf:
    """A state leaf's global shape and DTensor placements, with no
    process group behind them."""

    def __init__(self, shape, spec, names):
        from torch.distributed.tensor import Replicate, Shard
        self.shape = tuple(shape)
        dims = {}
        for d, entry in enumerate(spec):
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                dims[names.index(a)] = d
        self.placements = tuple(Shard(dims[i]) if i in dims else Replicate()
                                for i in range(len(names)))


class _Mesh:
    def __init__(self, shape):
        self.mesh_dim_names = shape.axis_names
        self.sizes = shape.sizes

    def size(self, i):
        return self.sizes[i]


def test_gather_plan_computes_on_model_shards_and_gathers_the_rest():
    """The ``tp`` case's widths on a (4, 2) mesh, the batch over 'data':
    the MLP, embedding and head compute on their 'model' shards (gathered
    over 'data' only, summed there); q/k/v/o, whose shards fall inside a
    head, are gathered over both and read in parts ('model' summed too);
    the norms, replicated, are summed over 'data' after the backward."""
    cfg = dataclasses.replace(
        get_config("deepseek-7b").reduced(), batch_axes=("data",), tp=2,
        d_model=1024, d_head=128, n_heads=5, n_kv_heads=5, vocab_size=2048,
        d_ff=512, n_layers=3)
    mesh = MeshShape((4, 2), ("data", "model"))
    params = lm.init(0, cfg, device="meta")
    specs = state_pspecs(params, mesh)
    leaves = {k: _Leaf(t.shape, specs_k, mesh.axis_names)
              for k, t, specs_k in _walk(params, specs)}
    plans, blocks = gather_plan(cfg, _tree(leaves), _Mesh(mesh), {"data"})
    assert blocks == {"blocks": ("attn", "mlp"), "embed": ("",),
                      "lm_head": ("",)}
    q = plans["blocks/attn/q/w"]
    assert q.use == ("heads", "q", 1)
    assert q.gather == ((1, 1, True), (0, 0, True)) and q.reduce == ()
    assert plans["blocks/attn/o/w"].use == ("heads", "q", 0)
    gate = plans["blocks/mlp/gate/w"]
    assert gate.use == "shard" and gate.gather == ((0, 0, True),)
    assert plans["blocks/mlp/down/w"].gather == ((0, 1, True),)
    emb = plans["embed/w"]
    assert emb.use == "shard" and emb.gather == () and emb.reduce == (0,)
    ln = plans["blocks/ln2/g"]
    assert ln.use == "whole" and ln.gather == () and ln.reduce == (0,)


def _walk(params, specs, prefix=""):
    for k in params:
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(params[k], dict):
            yield from _walk(params[k], specs[k], key)
        else:
            yield key, params[k], specs[k]


def _tree(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("heads,kv,model", [(6, 6, 4), (8, 2, 4)])
def test_head_layout_that_does_not_divide_the_model_axis_raises(heads, kv,
                                                               model):
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(),
                              n_heads=heads, n_kv_heads=kv)
    mesh = MeshShape((2, model), ("data", "model"))
    with pytest.raises(ValueError, match=rf"{cfg.head_layout()[0]} query "
                                         rf"and {cfg.head_layout()[1]} KV "
                                         rf"heads .* 'model' size {model}"):
        make_train_step(cfg, AdamWConfig(), mesh=mesh)
    ok = dataclasses.replace(cfg, tp=model)       # the layout pads/repeats
    make_train_step(ok, AdamWConfig(), mesh=mesh)


#: (config, the sub-blocks that compute tensor-parallel, the batch size):
#: a tied embedding with QKV biases, the MoE family's attention, and vlm's
#: plain and crossed layers with ``img_proj``
MODELS = {
    "qwen1.5-0.5b": {"blocks": ("attn", "mlp"), "embed": ("",)},
    "grok-1-314b": {"blocks": ("attn",), "embed": ("",),
                    "lm_head": ("",)},
    "llama-3.2-vision-11b": {"plain": ("attn", "mlp"),
                             "crossed": ("attn", "mlp"), "embed": ("",),
                             "lm_head": ("",), "img_proj": ("",)},
}


@pytest.mark.parametrize("arch", MODELS)
def test_emulated_tp_loss_matches_the_unsplit_loss(arch):
    """A whole model's loss and every gradient through ``EmulatedTP`` (2
    'model' ranks in this process: the vocab-parallel lookup, logits and
    cross-entropy, the TP blocks, ``img_proj`` column-parallel) against
    ``lm.loss_fn`` unsplit, float32: the loss within 1e-6 relative, each
    gradient within 1e-5 of its largest value."""
    from repro_torch.configs import dummy_inputs
    from repro_torch.launch.tp import EmulatedTP
    cfg = get_config(arch).reduced()
    if cfg.qkv_bias:
        assert cfg.tie_embeddings
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init(0, cfg, device="cpu"))
    batch = dummy_inputs(cfg, "train", batch=2, seq=32, device="cpu")
    args = dict(embeds=batch.get("embeds"),
                image_embeds=batch.get("image_embeds"))
    leaves = tree_leaves(params)
    want, _ = lm.loss_fn(params, cfg, batch.get("ids"), batch["labels"],
                         **args)
    want_grads = torch.autograd.grad(want, leaves, materialize_grads=True)
    par = EmulatedTP(cfg, MODELS[arch], 2)
    got, _ = lm.loss_fn(params, cfg, batch.get("ids"), batch["labels"],
                        par=par, **args)
    got_grads = torch.autograd.grad(got, leaves, materialize_grads=True)
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
    for a, b in zip(got_grads, want_grads):
        assert float((a - b).abs().max()) <= BOUND * float(b.abs().max())


# ---------------------------------------------------------------------------
# the blocks that compute on 'model' shards since the MoE experts
# ---------------------------------------------------------------------------

#: per block: (config, overrides of ``reduced()``, the params' block path,
#: the sub-blocks split): each widened so that a rank's 'model' shard falls
#: inside a head at tp 2 and 4 (the MoE experts have none: their f cut in
#: 2 and 4): vlm's cross-attention with 6 query heads over 2 KV heads (the
#: layout repeats the KV heads at tp 4), the hybrid's shared block with 5
#: MHA heads (padded to 6 and 8), RWKV6 with 17 heads of 64 (padded to 18
#: and 20), Mamba2 with 5 heads of 64 (padded to 6 and 8)
BLOCKS = {
    "moe_experts": ("llama4-scout-17b-a16e", {"d_ff": 96}, "blocks",
                    ("moe",)),
    "cross_attn": ("llama-3.2-vision-11b", {"n_heads": 6, "n_kv_heads": 2},
                   "crossed", ("xattn",)),
    "shared_block": ("zamba2-7b", {"n_heads": 5, "n_kv_heads": 5,
                                   "d_head": 16}, "shared_attn",
                     ("attn", "mlp")),
    "rwkv6": ("rwkv6-3b", {"d_model": 17 * 64, "head_size": 64,
                           "n_heads": 17, "n_kv_heads": 17, "d_ff": 256},
              "blocks", ("time", "channel")),
    "mamba2": ("zamba2-7b", {"d_model": 160, "n_heads": 5, "n_kv_heads": 5,
                             "d_head": 32}, "mamba", ("mamba",)),
}
F64_BOUND = 1e-9


def _apply(name: str, blk, cfg, x, img):
    """The block's output on ``x`` (``img``: vlm's image embeddings)."""
    if name == "moe_experts":
        return lm._ffn(blk, cfg, x)
    if name == "cross_attn":
        return lm.cross_attn(blk["xattn"], cfg, x,
                             lm.project_image_kv(blk["xattn"], cfg, img))
    if name == "shared_block":
        pos = torch.arange(x.shape[1], dtype=torch.int32)
        return lm.block_apply(blk, cfg, x, pos)[0]
    if name == "rwkv6":
        return lm._rwkv_layer(blk, cfg, x)[0]
    return lm._mamba_layer(blk, cfg, x)[0]


def _f64_block(name: str, tp: int):
    """One layer of ``name``'s widened config at ``cfg.tp`` = ``tp``, its
    leaves seeded float64 (each at its leaf's spread), an input and vlm's
    image embeddings."""
    arch, over, top, _ = BLOCKS[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), tp=tp,
                              dtype="float64", **over)
    tree = lm.init(0, cfg, device="cpu")[top]
    for _ in range(lm.STACK_DIMS.get(top, 0)):
        tree = tree_map(lambda t: t[0], tree)
    rng = np.random.default_rng(1)

    def draw(t):
        spread = float(t.float().std()) if t.numel() > 1 else 0.0
        return torch.from_numpy(rng.normal(size=tuple(t.shape))
                                * (spread or 0.1)).requires_grad_()
    blk = tree_map(draw, tree)
    x = torch.from_numpy(rng.normal(size=(2, 32, cfg.d_model))
                         ).requires_grad_()
    img = torch.from_numpy(rng.normal(size=(2, cfg.n_image_tokens or 1,
                                            cfg.d_image or 1)))
    return cfg, blk, x, img


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", BLOCKS)
def test_block_rank_slices_sum_to_the_unsplit_block_in_float64(name, tp):
    """The block's TP form of ``tp`` ranks emulated in one process
    (``lm.tp_sub_params``, the ranks' parts summed in rank order) against
    the unsplit block at the same head layout, forward and every gradient,
    in float64: within 1e-9 of each result's largest value (the split only
    reorders sums; measured at most 4e-15)."""
    cfg, blk, x, img = _f64_block(name, tp)
    leaves = tree_leaves(blk) + [x]
    want = _apply(name, blk, cfg, x, img)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(want.shape)))
    want_grads = torch.autograd.grad(want, leaves, g, allow_unused=True,
                                     materialize_grads=True)
    par = TensorParallel(tp, range(tp))
    split = dict(blk, **{sub: lm.tp_sub_params(blk[sub], cfg, par, sub)
                         for sub in BLOCKS[name][3]})
    got = _apply(name, split, cfg, x, img)
    got_grads = torch.autograd.grad(got, leaves, g, allow_unused=True,
                                    materialize_grads=True)
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max()) <= F64_BOUND * float(
        want.abs().max())
    for a, b in zip(got_grads, want_grads):
        assert float((a - b).abs().max()) <= F64_BOUND * float(
            b.abs().max())


@pytest.mark.parametrize("name,leaf", [("rwkv6", ("time", "out", "w")),
                                       ("mamba2", ("mamba", "out_proj",
                                                   "w"))])
def test_padded_heads_give_exactly_zero(name, leaf):
    """At tp 4, RWKV6's 17 heads and Mamba2's 5 are padded at the end (to
    20 and 8): a pad head's output before the row-parallel projection is
    exactly zero (zero r, k, v and gate; ``_group_norm`` of a zero head is
    zero and ``_log_w`` of a zero row finite; a zero head's Mamba2 output
    and its square in the gated norm's sum are zero), so any values in the
    projection's pad rows leave the block's output bit for bit."""
    from repro_torch.models import rwkv
    zero = torch.zeros(2, 3, 4 * 16, dtype=torch.float64)
    assert torch.equal(rwkv._group_norm(zero, torch.ones(64), 16), zero)
    assert torch.isfinite(rwkv._log_w(zero)).all()
    cfg, blk, x, img = _f64_block(name, 4)
    par = TensorParallel(4, range(4))
    sub = leaf[0]
    split = dict(blk, **{s: lm.tp_sub_params(blk[s], cfg, par, s)
                         for s in BLOCKS[name][3]})
    want = _apply(name, split, cfg, x, img).detach()
    heads = lm._part_heads(cfg, "rwkv" if name == "rwkv6" else "ssm")
    perm = lm.pad_perm(heads, 4)
    per = len(perm) // 4
    w = split[sub][leaf[1]][leaf[2]].detach().clone()
    size = w.shape[1] // per
    pads = 0
    for r in range(4):
        for j, h in enumerate(perm[r * per:(r + 1) * per]):
            if h == heads:
                w[r, j * size:(j + 1) * size] = 7.0
                pads += 1
    assert pads == len(perm) - heads > 0
    split[sub] = dict(split[sub], **{leaf[1]: {leaf[2]: w}})
    assert torch.equal(_apply(name, split, cfg, x, img).detach(), want)
