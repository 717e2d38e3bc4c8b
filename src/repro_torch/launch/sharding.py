"""Logical sharding rules (params FSDP x TP, activations, caches) and their
placement over a ``DeviceMesh``: the port's counterpart of the JAX
package's ``launch/sharding.py``.

Strategy (DESIGN.md §4), the reference's rules word for word:
  * TP over 'model'  — head / d_ff / vocab dimensions;
  * FSDP over 'data' — the d_model (or other large non-TP) dimension of
    every big weight;
  * DP over 'pod' (+'data' for the batch dimension of activations);
  * small leaves (< _MIN_SHARD_SIZE elements) stay replicated;
  * decode caches: batch over ('pod','data') when divisible, otherwise the
    *sequence* dimension shards there; KV heads over 'model'.

Rules are name-based on the param tree path with a divisibility guard: a
dimension that does not divide its mesh axis stays unsharded.

A spec is a :class:`PartitionSpec`, a tuple with one entry per dim (an
axis name, a tuple of axis names, or None), equal entry for entry to the
reference's ``jax.sharding.PartitionSpec``. The rules read only the
mesh's axis sizes (``mesh.axis_sizes``), so a ``DeviceMesh`` and a
shape-only ``MeshShape`` give the same specs. :func:`named_shardings` turns
a spec into DTensor placements over a ``DeviceMesh`` (``Shard(d)`` on each
mesh dim that a dim's entry names, ``Replicate()`` on the others; a tuple
entry names mesh dims major to minor, as JAX's does); a
:class:`NamedSharding` cuts a rank's local shard out of a global tensor
(:meth:`NamedSharding.shard`) or wraps it as a ``DTensor``
(:meth:`NamedSharding.put`, the counterpart of ``jax.device_put``). There
is no GSPMD: a leaf is stored as its local shard, and code that computes on
it gathers it first. :func:`gather_plan` says, for the sharded train step
(``launch/train.py``), which mesh dims of each parameter leaf are gathered
where its block uses it and which the block computes on: attention and
the MLP, the MoE experts, vlm's cross-attention and ``img_proj``, the
hybrid's Mamba2 layers and shared block, RWKV6's time and channel mix,
the embedding and head, on their 'model' shards when all their weight
leaves are 'model'-sharded (a weight the rules shard on another dim than
the one a rank's part cuts, the MoE experts' and RWKV6's channel-mix
``down``-like leaves, is re-cut by one all-to-all), everything else
whole.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

from repro_torch.core.schedule import DevicePlan
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models import lm

__all__ = ["PartitionSpec", "NamedSharding", "param_pspecs", "input_pspecs",
           "cache_pspecs", "named_shardings", "state_pspecs",
           "replica_pspecs", "shard_batch", "shard_tree", "LeafPlan",
           "gather_plan", "check_head_layout"]


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of axis names or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

_MIN_SHARD_SIZE = 1 << 20          # replicate anything smaller (1M elems)

# suffix-regex -> spec for the LAST TWO dims (earlier dims get None)
_COL = ("data", "model")           # (d_in, d_out-ish): FSDP x TP
_ROW = ("model", "data")           # (d_out-ish, d_in): TP x FSDP
_RULES: list[tuple[str, tuple]] = [
    # embedding + head: vocab over 'model' ONLY (a 'data' split of their
    # d_model dim conflicts with the batch's 'data' split)
    (r"embed/w$", ("model", None)),            # (vocab, d_model)
    (r"lm_head/w$", (None, "model")),          # (d_model, vocab)
    (r"(q|k|v|r|g|w|gate|up|in_proj|img_proj)/w$", _COL),
    (r"(o|out|down|out_proj)/w$", _ROW),
    (r"router/w$", ("data", None)),
    (r"conv_w$", (None, "model")),
    (r"time/u$", (None, None)),
]


def _pspec_for(path: str, leaf, mesh) -> P:
    shape = tuple(leaf.shape)
    ndim = len(shape)
    sizes = axis_sizes(mesh)
    if math.prod(shape) < _MIN_SHARD_SIZE:
        return P()
    spec2 = None
    for pat, s in _RULES:
        if re.search(pat, path):
            spec2 = s
            break
    if spec2 is None:
        # fallback heuristic for any future large param
        spec2 = _COL if ndim >= 2 else ("model",)
    dims = [None] * ndim
    for rel, ax in zip(range(ndim - len(spec2), ndim), spec2):
        if ax is None or rel < 0:
            continue
        if ax in sizes and shape[rel] % sizes[ax] == 0:
            dims[rel] = ax
    return P(*dims)


def _tree_map(fn, tree, *rest, is_leaf=None, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists, tuples
    and :class:`DevicePlan` s (its orders and inverses), ``path`` the keys
    from the root; None stays None, as an empty JAX pytree does."""
    if tree is None or (is_leaf is not None and is_leaf(tree)):
        return None if tree is None else fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf,
                             path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, DevicePlan):
        parts = [_tree_map(fn, getattr(tree, name),
                           *(getattr(r, name) for r in rest),
                           is_leaf=is_leaf, path=path + (name,))
                 for name in ("orders", "inverses")]
        return DevicePlan(*parts, tree.layer_sizes, tree.intra,
                          tree.coordinated)
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest),
                                    is_leaf=is_leaf, path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _tree_pspecs(tree, fn):
    return _tree_map(lambda path, leaf: fn("/".join(path), leaf), tree)


def param_pspecs(params, mesh):
    """PartitionSpec tree for a param (or optimizer-state) tree."""
    return _tree_pspecs(params, lambda key, leaf: _pspec_for(key, leaf, mesh))


def state_pspecs(train_state, mesh):
    """Train state = {params, opt:{m,v,step}, ...}: moments inherit the
    param sharding; scalars replicated."""
    return _tree_pspecs(
        train_state,
        lambda key, leaf: (P() if len(leaf.shape) == 0
                           else _pspec_for(key, leaf, mesh)))


def input_pspecs(inputs: dict, mesh) -> dict:
    """Shardings for model inputs (ids/labels/embeds/image_embeds/decode
    cache/pos)."""
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    nb = math.prod(sizes[a] for a in ba)
    out = {}
    for name, spec in inputs.items():
        if name == "cache":
            out[name] = cache_pspecs(spec, mesh)
        elif name == "pos":
            out[name] = P()
        elif name in ("ids", "labels", "ids1", "embeds", "embeds1",
                      "image_embeds"):
            b = spec.shape[0]
            out[name] = P(ba if b % nb == 0 else None,
                          *([None] * (len(spec.shape) - 1)))
        else:
            raise KeyError(name)
    return out


def _cache_pspec(key: str, leaf, mesh) -> P:
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    nb = math.prod(sizes[a] for a in ba)
    tp = sizes.get("model", 1)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    if ndim == 0:
        return P()
    if key.split("/")[-1].startswith(("k", "v")):
        # (..., B, S, Hkv, D): batch over pod+data if divisible, else
        # sequence-parallel on the cache (long-context serving)
        b, s, h = shape[-4], shape[-3], shape[-2]
        lead = [None] * (ndim - 4)
        hax = "model" if h % tp == 0 else None
        if b % nb == 0:
            return P(*lead, ba, None, hax, None)
        if s % nb == 0:
            return P(*lead, None, ba, hax, None)
        return P(*lead, None, None, hax, None)
    # ssm / conv / shift states: (..., B, ...) — find the batch dim by the
    # structure: ssm (L.., B, H, P, N) / conv (L.., B, K, C) / last (L,B,1,D)
    if key.startswith(("ssm", "state")):
        lead = [None] * (ndim - 4)
        b, h = shape[-4], shape[-3]
        return P(*lead, ba if b % nb == 0 else None,
                 "model" if h % tp == 0 else None, None, None)
    if key.startswith("conv"):
        lead = [None] * (ndim - 3)
        b, c = shape[-3], shape[-1]
        return P(*lead, ba if b % nb == 0 else None, None,
                 "model" if c % tp == 0 else None)
    if key.startswith(("last", "img")):
        if key.startswith("img"):
            lead = [None] * (ndim - 4)
            b, h = shape[-4], shape[-2]
            return P(*lead, ba if b % nb == 0 else None, None,
                     "model" if h % tp == 0 else None, None)
        lead = [None] * (ndim - 3)
        b, d = shape[-3], shape[-1]
        return P(*lead, ba if b % nb == 0 else None, None,
                 "model" if d % tp == 0 else None)
    return P()


def cache_pspecs(cache, mesh):
    return _tree_pspecs(cache, lambda key, leaf: _cache_pspec(key, leaf, mesh))


class NamedSharding:
    """A :class:`PartitionSpec` over a ``DeviceMesh``: the DTensor
    placements it means, and this rank's shard of a global tensor."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)
        names = list(mesh.mesh_dim_names)
        self.shard_dims = [None] * len(names)     # mesh dim -> tensor dim
        for d, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"{spec}: the axes of dim {d} must follow "
                                 f"the mesh's order {tuple(names)}")
            for i in idx:
                self.shard_dims[i] = d

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Replicate() if d is None else Shard(d)
                     for d in self.shard_dims)

    def bounds(self, shape) -> list:
        """This rank's slice of a global tensor of ``shape``: ``(start,
        size)`` per dim, each mesh dim in order cutting the dim it shards
        into its size and taking the rank's coordinate."""
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        lo = [0] * len(shape)
        size = list(shape)
        for i, d in enumerate(self.shard_dims):
            if d is None:
                continue
            n = self.mesh.size(i)
            if size[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide mesh dim {i} of size {n}")
            size[d] //= n
            lo[d] += coord[i] * size[d]
        return list(zip(lo, size))

    def shard(self, x):
        """This rank's slice of the global ``x`` (a tensor or an array;
        basic slicing, so a view): :meth:`bounds`."""
        return x[tuple(slice(a, a + s) for a, s in self.bounds(x.shape))]

    def put(self, x):
        """The global ``x`` (every rank holds it) as a ``DTensor`` of a copy
        of this rank's shard on the mesh's device: no collective."""
        import torch
        from torch.distributed.tensor import DTensor
        local = torch.as_tensor(self.shard(x)).detach().to(
            self.mesh.device_type, copy=True).contiguous()
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements!r})"


def _is_spec(x) -> bool:
    return isinstance(x, P)


def named_shardings(pspecs, mesh):
    return _tree_map(lambda _, s: NamedSharding(mesh, s), pspecs,
                     is_leaf=_is_spec)


def shard_tree(tree, shardings):
    """``tree``'s global leaves as DTensors of this rank's shards, under the
    matching tree of :class:`NamedSharding` s (the counterpart of
    ``jax.device_put(tree, shardings)``)."""
    return _tree_map(lambda _, leaf, s: s.put(leaf), tree, shardings)


# ---------------------------------------------------------------------------
# where the sharded train step gathers and where it computes on shards
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafPlan:
    """How the sharded step brings one parameter leaf to its block.

    ``gather``: ``(mesh dim, tensor dim, summed)`` per mesh dim that is
    all-gathered before each use, minor mesh dims first, the tensor dim
    counted in one layer's slice; ``summed``: the gather's backward sums the
    ranks' gradients (a reduce-scatter: the batch's parts, or 'model' ranks
    that each read part of the leaf), else it keeps the rank's slice (the
    ranks computed the same). ``use``: ``"whole"``; ``"shard"`` (the block
    computes on the rank's 'model' shard); ``("recut", src, dst)`` (the
    block computes on the rank's part of dim ``dst``, which 'model' shards
    on ``src``: one all-to-all over 'model' after the gathers, its backward
    the inverse); ``("heads", kind, dim)`` (the rank's part of the whole
    leaf, ``lm.tp_heads``: heads of the TP head layout, RWKV6's or Mamba2's
    heads, Mamba2's packed leaves); or ``("arranged", proj, leaf)`` (an
    attention leaf of a block that computes whole, in a TP head layout that
    pads or repeats heads).
    ``reduce``: the mesh dims over whose ranks the leaf's gradient is
    summed after the backward (the batch's parts where the leaf is
    replicated; 'model' where a replicated leaf is read in parts)."""
    gather: tuple
    use: object
    reduce: tuple


def check_head_layout(cfg, mesh) -> None:
    """Raise ``ValueError`` when the TP head layout's query or KV heads do
    not split over the mesh's 'model' ranks (the families with attention;
    RWKV6's and Mamba2's heads are padded to any 'model' size)."""
    tp = axis_sizes(mesh).get("model", 1)
    if cfg.family == "ssm" or tp == 1:
        return
    eff, eff_kv, _, _ = cfg.head_layout()
    if eff % tp or eff_kv % tp:
        raise ValueError(
            f"{cfg.name}: the head layout's {eff} query and {eff_kv} KV heads "
            f"(cfg.tp={cfg.tp}) do not divide the mesh's 'model' size {tp}")


def _mdims(leaf) -> tuple:
    """A DTensor's tensor dim per mesh dim (None where replicated)."""
    return tuple(pl.dim if pl.is_shard() else None for pl in leaf.placements)


#: the paths whose trees are blocks (their leading layer dims): the
#: stacked layers and the hybrid's one shared block
_BLOCKS = dict(lm.STACK_DIMS, shared_attn=0)


def _cut(key: str, stack: int, dim: int, dims: dict, shapes: dict,
         model: int, tp: int) -> bool:
    """Whether the weight at ``key`` is 'model'-sharded so that a rank can
    compute on its part along ``dim`` (of one layer's slice): sharded on
    that dim, or on another and re-cut to it by an all-to-all (the dim a
    multiple of the 'model' size)."""
    d = dims[key][model]
    if d is None:
        return False
    return d == stack + dim or shapes[key][stack + dim] % tp == 0


def _tp_blocks(dims: dict, shapes: dict, model: int, tp: int) -> dict:
    """Per path, the sub-blocks that compute on 'model' shards: each one
    whose weight leaves (``lm.TP_LEAVES``' weights, ``lm.TP_WHOLE``) are all
    'model'-sharded (:func:`_cut`; a leaf under the rules' floor, or one
    whose dim does not divide, is whole, and so is its block)."""
    out = {}
    for top, stack in _BLOCKS.items():
        subs = []
        for sub in lm.TP_SUBS:
            cut = [_cut(f"{top}/{rest}", stack, dim, dims, shapes, model, tp)
                   for rest, (_, dim, weight) in lm.TP_LEAVES.items()
                   if weight and rest.startswith(f"{sub}/")
                   and f"{top}/{rest}" in dims]
            if cut and all(cut):
                subs.append(sub)
        if subs:
            out[top] = tuple(subs)
    for key, dim in lm.TP_WHOLE.items():
        if key in dims and dims[key][model] == dim:
            out[key.split("/")[0]] = ("",)
    return out


def _use(cfg, top: str, rest: str, blocks: dict, same: bool, mdim, tp: int):
    """A leaf's :attr:`LeafPlan.use` (``rest``: its path under ``top``;
    ``same``: the TP head layout is the published heads; ``mdim``: the dim
    of one layer's slice that 'model' shards, or None)."""
    subs = blocks.get(top, ())
    if "" in subs:
        return "shard"
    sub, _, tail = rest.partition("/")
    role = lm.TP_LEAVES.get(rest)
    if role is not None and sub in subs:
        kind, dim, _ = role
        if mdim == dim and lm.tp_aligned(cfg, tp, kind):
            return "shard"
        if kind is None and mdim is not None:
            return ("recut", mdim, dim)
        return ("heads", kind, dim)
    if not same and sub in ("attn", "xattn") and f"attn/{tail}" in (
            lm.TP_LEAVES):
        return ("arranged",) + tuple(tail.split("/"))
    return "whole"


def gather_plan(cfg, params, mesh, batch_dims) -> tuple:
    """``(plans, blocks)`` for the sharded step over ``params`` (a tree of
    DTensors): ``plans`` a :class:`LeafPlan` per leaf path, ``blocks`` per
    path the sub-blocks (``""``: the tree itself) that compute on 'model'
    shards. ``batch_dims``: the names of the mesh dims the batch is split
    over. With a 'model' axis of 1, every block computes whole. A stacked
    leaf whose layer dim is sharded (no config's, on any mesh: the rules
    shard a leaf's last two dims) raises ``ValueError``."""
    names = list(mesh.mesh_dim_names)
    model = names.index("model") if "model" in names else None
    tp = 1 if model is None else mesh.size(model)
    dims, shapes = {}, {}

    def read(path, leaf):
        dims["/".join(path)] = _mdims(leaf)
        shapes["/".join(path)] = tuple(leaf.shape)
    _tree_map(read, params)
    blocks = {} if tp == 1 else _tp_blocks(dims, shapes, model, tp)
    same = cfg.head_layout()[:2] == (cfg.n_heads, cfg.n_kv_heads)
    plans = {}
    for key, d in dims.items():
        top, rest = key.split("/", 1)
        stack = _BLOCKS.get(top, 0)
        mdim = None if model is None or d[model] is None else (
            d[model] - stack)
        use = _use(cfg, top, rest, blocks, same, mdim, tp)
        partial = isinstance(use, tuple) and use[0] == "heads"
        local = use == "shard" or (isinstance(use, tuple)
                                   and use[0] == "recut")
        gather, reduce = [], []
        for i in reversed(range(len(names))):
            summed = names[i] in batch_dims or (i == model and partial)
            if d[i] is None:
                if summed:
                    reduce.append(i)
            elif d[i] < stack:
                raise ValueError(f"{key}: mesh dim {names[i]!r} shards a "
                                 f"layer dim; the step gathers per layer")
            elif not (i == model and local):
                gather.append((i, d[i] - stack, summed))
        plans[key] = LeafPlan(tuple(gather), use, tuple(sorted(reduce)))
    return plans, blocks


# ---------------------------------------------------------------------------
# generic CompiledModel replication (serving tier)
# ---------------------------------------------------------------------------
#
# Replica fan-out needs exactly one rule: shard the leading (batch)
# dimension of every operand over the replica axis when it divides,
# replicate otherwise. Params stay with each rank's compiled model (small
# for PointNet++), so only the per-step operands — clouds, n_valid, a
# batched DevicePlan — are cut.

def replica_pspecs(tree, mesh, *, axis: str = "replica"):
    """PartitionSpec tree for batch operands on a 1-D replica mesh
    (:func:`repro_torch.launch.mesh.make_replica_mesh`): leading dim over
    ``axis`` when divisible by the replica count, else fully replicated
    (correct for stragglers like scalars and non-divisible batches)."""
    n = axis_sizes(mesh)[axis]

    def spec(_, leaf):
        shape = np.shape(leaf)
        if len(shape) >= 1 and shape[0] % n == 0:
            return P(axis, *([None] * (len(shape) - 1)))
        return P()
    return _tree_map(spec, tree)


def shard_batch(tree, mesh, *, axis: str = "replica"):
    """This rank's part of a tree of batch operands under
    :func:`replica_pspecs`: its slice of each leading dim that divides the
    replica count, the whole of each other leaf. The serving engine calls
    it on (clouds, n_valid, dplan) before its captured step, and each
    replica computes its slice of the batch."""
    specs = replica_pspecs(tree, mesh, axis=axis)
    return _tree_map(lambda _, leaf, s: NamedSharding(mesh, s).shard(leaf),
                     tree, specs)
