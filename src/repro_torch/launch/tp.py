"""Tensor parallelism over a mesh's 'model' axis and the sharded step's
per-layer parameter gathers: the collectives of ``launch/train.py``'s
sharded step that autograd differentiates.

Tensor parallelism is Megatron's, on the leaves as ``state_pspecs`` shards
them. A :class:`TensorParallel` names ``tp`` ranks of the 'model' axis and
the ones this process computes: its own on a mesh, every one of them in a
one-process emulation. A rank-local tensor carries those ranks on a leading
axis (of 1 on a mesh). Two conjugate ``torch.autograd.Function`` s join
rank-local and replicated values:

- :class:`_CopyIn` (a column-parallel input): forward the replicated input
  as each rank's copy, backward the sum of the ranks' gradients;
- :class:`_ReduceOut` (a row-parallel output): forward the sum of the
  ranks' partial products, backward the gradient as each rank's copy;
- :class:`_GatherOut` (a column-parallel output a replicated consumer
  reads): forward the ranks' columns joined, backward each rank's columns
  of the gradient;
- :class:`_Cut` (its converse: a replicated block-boundary activation held
  as the ranks' slices of d_model, the reference's ``_shard_batch`` cut
  over 'model', which :class:`_GatherOut` joins where a block reads it):
  forward each rank's slice, in a storage of its own, backward the ranks'
  slices of the gradient joined;
- :class:`_ReduceAll` (a sum over the ranks that each rank's own part
  reads: Mamba2's gated norm over the whole ``d_inner``): forward the sum,
  backward the sum of the ranks' gradients.

A sum over ranks adds the process's ranks in rank order and then, with a
process group, all-reduces over it; so one body serves NCCL ranks, gloo
ranks and the emulation (``chip_smoke.py``'s phase ``distributed``, and
``tests/test_torch_tp.py``).

:class:`ParamShards` is what the sharded step hands the model
(``lm.loss_fn(..., par=)``): each parameter leaf all-gathered where its
block uses it (a stacked leaf one layer at a time) over the mesh dims that
shard it, apart from 'model' where the block computes on the rank's shard
(or on its part of another dim, the shard re-cut by one all-to-all over
'model' after the other gathers: the MoE experts' ``down``, RWKV6's
channel-mix ``v``); in the layout the block computes in (the rank's heads,
columns, rows or vocabulary range on a leading rank axis of 1, the block's
dict marked ``"tp"``; an attention block that computes whole under a TP
head layout that pads or repeats heads, in that layout, its dict marked
``"arranged"``). The gather's backward reduce-scatters the gradient onto
the rank's shard, summing the ranks that computed on parts of it (the
batch's parts, and 'model' ranks that read parts of a whole leaf), or
keeps the rank's slice where the ranks computed the same thing. No
gathered tensor outlives its layer's forward: while the model runs, a
tensor that autograd saves for the backward and that lies in a gathered
(or arranged) tensor's storage is kept as the recipe that makes it again
(saved-tensor hooks, ZeRO-3's re-gather); a layer checkpointed under
``cfg.remat`` saves nothing through them (the checkpoint's own hooks are
the innermost), its gathers running again in its recompute instead.
:class:`GatherStats` counts the
bytes; with ``track_copies`` also those of the weights' copies (arranged,
cast or sliced ones, :class:`_Copies`) that autograd keeps until the
backward: the bf16 norm gains' float32 casts, say.

The sharded prefill and decode step (``launch/serve.py``) read the weights
through a forward-only :class:`ParamShards`: the same per-layer gathers
and the same blocks on 'model' shards, with no autograd Function, no
saved-tensor hooks and no re-gathers. Their decode cache is sharded by
``launch.sharding.cache_pspecs``; :class:`CacheShards` tells the model how
(``models/lm.py``): the cut that 'model' makes in each leaf (the KV heads,
the state-space families' heads and channels) and, for a batch that does
not split over the batch's mesh dims, the KV rows that each rank holds of
the sequence (:class:`SeqShards`).
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

__all__ = ["TensorParallel", "ParamShards", "GatherStats", "TokenSpan",
           "EmulatedTP", "CacheShards", "SeqShards", "batch_parts",
           "model_axis"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class TensorParallel:
    """``tp`` ranks of a 'model' axis, of which this process computes
    ``ranks`` (its own one on a mesh, with the axis's ``group``; all of
    them, with no group, in a one-process emulation)."""

    def __init__(self, tp: int, ranks, group=None):
        self.tp = int(tp)
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group

    @property
    def n(self) -> int:
        """The ranks this process computes: a rank-local tensor's leading
        axis."""
        return len(self.ranks)

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A rank-local ``t`` ``(n, ...)`` summed (or maximized) over all
        ``tp`` ranks -> ``(...)``: this process's ranks in rank order, then
        an all-reduce over the group."""
        acc = torch.clone(t[0], memory_format=torch.contiguous_format)
        for i in range(1, t.shape[0]):
            acc = acc + t[i] if op == "sum" else torch.maximum(acc, t[i])
        if self.group is not None:
            acc = acc.contiguous()
            dist.all_reduce(acc, op=_OPS[op], group=self.group)
        return acc

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """The replicated ``x`` as each rank's input ``(n, ...)``; its
        gradient the sum of the ranks' (:class:`_CopyIn`)."""
        return _CopyIn.apply(x, self)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' partials ``y`` ``(n, ...)`` summed over every rank;
        the gradient each rank's copy (:class:`_ReduceOut`)."""
        return _ReduceOut.apply(y, self)

    def reduce_all(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' partials ``t`` ``(n, ...)`` summed over every rank,
        the sum read by each rank's own part; the gradient the sum of the
        ranks' (:class:`_ReduceAll`)."""
        return _ReduceAll.apply(t, self)

    def join(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' parts ``t`` ``(n, ...)`` joined along ``dim`` of a
        part in rank order, over every rank: no gradient (a cache write)."""
        out = torch.cat(list(t), dim=dim)
        if self.group is not None:
            out = _all_gather(out, self.group, self.tp, dim % out.ndim)
        return out

    def gather_out(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' column blocks ``y`` ``(n, ..., c)`` joined along the
        last dim in rank order -> ``(..., tp·c)``; the gradient each rank's
        columns (:class:`_GatherOut`)."""
        return _GatherOut.apply(y, self)

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated ``x`` ``(..., D)`` held as this process's ranks'
        slices of its last dim ``(n, ..., D/tp)`` (:meth:`split`'s layout,
        a copy: no view keeps the whole alive); the gradient the ranks'
        slices joined over 'model' (:class:`_Cut`). :meth:`gather_out`
        joins it again."""
        return _Cut.apply(x, self)

    def split(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A whole ``t`` cut in ``tp`` equal chunks along ``dim``: this
        process's ranks' chunks on a new leading axis."""
        size = t.shape[dim] // self.tp
        return torch.stack([t.narrow(dim, r * size, size)
                            for r in self.ranks])


class _CopyIn(torch.autograd.Function):
    """Column-parallel input: forward an identity (each rank's copy of the
    replicated input), backward the sum over the ranks of the input's
    gradient (an all-reduce over 'model')."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.unsqueeze(0).expand(tp.n, *x.shape)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.reduce(grad), None


class _ReduceOut(torch.autograd.Function):
    """Row-parallel output: forward the sum over the ranks of their partial
    products (an all-reduce over 'model'), backward an identity (the
    gradient as each rank's copy)."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        return tp.reduce(y)

    @staticmethod
    def backward(ctx, grad):
        return grad.unsqueeze(0).expand(ctx.tp.n, *grad.shape), None


class _ReduceAll(torch.autograd.Function):
    """A sum over the ranks read by each rank's own computation: forward
    the sum of the ranks' partials (an all-reduce over 'model'), backward
    the gradients the ranks' parts sent it, summed (an all-reduce again;
    in one process autograd has summed them already), as each rank's
    copy."""

    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return tp.reduce(t)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        if tp.group is not None:
            grad = grad.contiguous()
            dist.all_reduce(grad, group=tp.group)
        return grad.unsqueeze(0).expand(tp.n, *grad.shape), None


class _GatherOut(torch.autograd.Function):
    """Column-parallel output, gathered: forward the ranks' columns joined
    (an all-gather over 'model'), backward each rank's columns of the
    gradient."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        out = torch.cat(list(y), dim=-1)
        if tp.group is not None:
            out = _all_gather(out, tp.group, tp.tp, out.ndim - 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.split(grad, grad.ndim - 1), None


class _Cut(torch.autograd.Function):
    """:class:`_GatherOut`'s converse, a replicated value cut: forward each
    rank's slice of the last dim, backward the ranks' slices of the
    gradient joined (an all-gather over 'model'). Exact where the gradient
    that reaches the whole is the same on every rank (a block-boundary
    activation: the residual path is replicated, and :class:`_CopyIn`
    sums the ranks' gradients), so each rank's slice of it is its part of
    that one gradient; nothing is summed either way."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.split(x, x.ndim - 1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.join(grad, -1), None


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def _all_gather(t: torch.Tensor, group, k: int, dim: int) -> torch.Tensor:
    """``t`` from each of the ``k`` ranks of ``group``, joined along
    ``dim`` in the group's rank order; over one rank, a copy (no collective
    call: a call costs the host more than the copy costs the card)."""
    if k == 1:
        return torch.clone(t, memory_format=torch.contiguous_format)
    out = torch.empty((k * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.unflatten(0, (k, t.shape[0])).movedim(0, dim).flatten(
        dim, dim + 1)


def _all_to_all(t: torch.Tensor, group, k: int, src: int,
                dst: int) -> torch.Tensor:
    """``t``, this rank's chunk of dim ``src`` over the ``k`` ranks of
    ``group`` (whole along ``dst``), re-cut: whole along ``src`` (the
    ranks' chunks in rank order), this rank's chunk of ``dst``. One
    all-to-all; over one rank, a copy."""
    if k == 1:
        return torch.clone(t, memory_format=torch.contiguous_format)
    send = t.unflatten(dst, (k, t.shape[dst] // k)).movedim(dst, 0
                                                             ).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, src).flatten(src, src + 1)


def _reduce_scatter(g: torch.Tensor, group, k: int, dim: int) -> torch.Tensor:
    """``g`` summed over the ``k`` ranks of ``group``; this rank's chunk of
    ``dim`` (over one rank, ``g``)."""
    if k == 1:
        return g
    parts = g.unflatten(dim, (k, g.shape[dim] // k)).movedim(dim, 0)
    out = torch.empty(parts.shape[1:], dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, parts.contiguous().flatten(0, 1),
                               group=group)
    return out


def _gathered(local: torch.Tensor, steps: tuple, transform):
    """``local`` all-gathered per ``steps`` (each ``(group, size, coord,
    dim, summed, to)``, minor mesh dims first; ``to`` not None: an
    all-to-all that re-cuts ``dim`` to ``to``), then ``transform`` ed."""
    t = local
    for group, k, _, dim, _, to in steps:
        t = (_all_gather(t, group, k, dim) if to is None
             else _all_to_all(t, group, k, dim, to))
    return t if transform is None else transform(t)


class _Gather(torch.autograd.Function):
    """A leaf's all-gather (:func:`_gathered`); it saves no gathered
    tensor. Backward: through ``transform`` (linear: its vector-Jacobian
    product read off a zero leaf of the gathered shape), then per step,
    major mesh dims first, a reduce-scatter where the step's ranks' gradients
    sum, the rank's slice where they are copies, and the inverse all-to-all
    of a re-cut."""

    @staticmethod
    def forward(ctx, local, steps, transform):
        ctx.steps, ctx.transform = steps, transform
        ctx.shape = list(local.shape)
        for _, k, _, dim, _, to in steps:
            ctx.shape[dim] *= k
            if to is not None:
                ctx.shape[to] //= k
        return _gathered(local, steps, transform)

    @staticmethod
    def backward(ctx, grad):
        if ctx.transform is not None:
            with torch.enable_grad():
                zero = torch.zeros((), dtype=grad.dtype, device=grad.device
                                   ).expand(ctx.shape).requires_grad_()
                (grad,) = torch.autograd.grad(ctx.transform(zero), zero,
                                              grad)
        for group, k, coord, dim, summed, to in reversed(ctx.steps):
            if to is not None:
                grad = _all_to_all(grad, group, k, to, dim)
            elif summed:
                grad = _reduce_scatter(grad, group, k, dim)
            else:
                size = grad.shape[dim] // k
                grad = grad.narrow(dim, coord * size, size)
        return grad, None, None


class GatherStats:
    """Bytes of gathered parameters in one step: ``gathered`` in all (the
    forward's gathers and the backward's re-gathers), ``alive`` now and
    ``peak`` the most alive at once. A gathered tensor counts until it is
    freed. With ``track_copies`` set, ``kept`` counts the bytes of the
    weights' copies that autograd keeps for the backward (:class:`_Copies`;
    slow: for tests and measurements), else it is None."""

    def __init__(self):
        self._lock = threading.Lock()
        self.track_copies = False
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.gathered = self.alive = self.peak = 0
            self.kept = 0 if self.track_copies else None

    def keep(self, n: int) -> None:
        with self._lock:
            self.kept += n

    def add(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        with self._lock:
            self.gathered += n
            self.alive += n
            self.peak = max(self.peak, self.alive)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        with self._lock:
            self.alive -= n

    def as_dict(self) -> dict:
        return {"gathered_bytes": self.gathered, "peak_alive_bytes": self.peak,
                "kept_copy_bytes": self.kept}


def _storage(t: torch.Tensor) -> tuple:
    """``t``'s storage, as a key: the storage itself (its address, unique
    while it lives), not its data's address, which every ``meta`` tensor
    shares (0)."""
    return t.device, t.untyped_storage()._cdata


class _Copies(TorchFunctionMode):
    """While the model's forward runs, the kind of each tensor's storage:
    ``"source"`` a parameter leaf as the model reads it, ``"gathered"`` a
    gathered one, ``"const"`` a constant (made from no tensor, or from
    constants), ``"copy"`` one made from parameters and constants alone (a
    weight's arranged, cast or sliced copy); a tensor made from anything
    else (the batch, an activation), and an empty buffer, is not marked. A
    view shares its base's kind, and an entry leaves with the tensor that
    made it. :meth:`kept` counts the bytes of a copy that autograd saves as
    it is. Every torch call of the forward passes through it."""

    def __init__(self, stats: GatherStats):
        super().__init__()
        self.stats = stats
        self._kinds = {}
        self._counted = set()

    def kind(self, t: torch.Tensor):
        if t.numel() == 0:
            return "const"
        entry = self._kinds.get(_storage(t))
        return None if entry is None or entry[0]() is None else entry[1]

    def mark(self, t: torch.Tensor, kind: str) -> None:
        if t.numel() == 0:
            return
        key, ref = _storage(t), weakref.ref(t)
        self._kinds[key] = (ref, kind)
        weakref.finalize(t, self._drop, key, ref)

    def _drop(self, key, ref) -> None:
        if self._kinds.get(key, (None,))[0] is ref:
            del self._kinds[key]

    def kept(self, t: torch.Tensor) -> None:
        key = _storage(t)
        if self.kind(t) == "copy" and key not in self._counted:
            self._counted.add(key)
            self.stats.keep(t.untyped_storage().nbytes())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if "empty" in getattr(func, "__name__", ""):
            return out          # a buffer: a collective may fill it
        ins = _tensors((args, kwargs))
        kinds = {self.kind(a) for a in ins}
        outs = _tensors(out)
        if _mutates(func, kwargs) and ins:
            outs += _tensors(kwargs.get("out", args[0]))
            if None in kinds:
                # an activation written into a marked tensor
                for t in outs:
                    self._kinds.pop(_storage(t), None)
                return out
        if None in kinds:
            return out
        kind = "copy" if kinds - {"const"} else "const"
        for t in outs:
            # a fresh storage, or a constant one written with weights
            if self.kind(t) in (None, "const"):
                self.mark(t, kind)
        return out


def _tensors(x) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _mutates(func, kwargs: dict) -> bool:
    """Whether ``func`` writes into its first argument (or ``out=``)."""
    name = getattr(func, "__name__", "")
    return ("out" in kwargs or name == "__setitem__"
            or (name.startswith("__i") and name.endswith("__"))
            or (name.endswith("_") and not name.endswith("__")))


class _Regather:
    """Saved-tensor hooks: a tensor autograd saves that lies in a live
    gathered tensor's storage is packed as that tensor's recipe and its
    view (size, stride, offset), and unpacked by running the recipe again.
    Entries leave with their tensors, so a storage address reused later
    matches nothing."""

    def __init__(self):
        self._live = {}
        self.copies = None

    def register(self, t: torch.Tensor, recipe) -> None:
        key = _storage(t)
        ref = weakref.ref(t)
        self._live[key] = (ref, recipe)
        weakref.finalize(t, self._drop, key, ref)

    def _drop(self, key, ref) -> None:
        if self._live.get(key, (None,))[0] is ref:
            del self._live[key]

    def pack(self, t: torch.Tensor):
        if t.numel() == 0:
            return t
        entry = self._live.get(_storage(t))
        if entry is None or entry[0]() is None:
            if self.copies is not None:
                self.copies.kept(t)
            return t
        return entry[1], tuple(t.shape), t.stride(), t.storage_offset()

    @staticmethod
    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        recipe, size, stride, offset = packed
        return recipe().as_strided(size, stride, offset)


class TokenSpan:
    """MoE routing groups that span a rank's batch part: the tokens
    all-gathered over the batch's mesh dims (``steps``, minor first; the
    backward a reduce-scatter, so each rank's rows get the sum of the
    ranks' contributions) and the rank's own rows of a result, the
    ``index``-th of ``parts`` equal row blocks."""

    def __init__(self, steps: tuple, index: int, parts: int):
        self.steps, self.index, self.parts = steps, index, parts

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.steps, None)

    def mine(self, y: torch.Tensor) -> torch.Tensor:
        rows = y.shape[0] // self.parts
        return y.narrow(0, self.index * rows, rows)


class EmulatedTP:
    """A 'model' axis of ``tp`` ranks emulated in one process over whole
    parameters (``lm.loss_fn(..., par=)``): the sub-blocks that ``blocks``
    names (``launch.sharding.gather_plan``'s) in the TP form of all ``tp``
    ranks, through the sharded step's code, every other leaf as it is; the
    block-boundary activations cut over the ``tp`` ranks where the sharded
    step cuts them (``lm._boundary_tp``), as every rank's slice ``(tp, B,
    S, D/tp)``. The unsharded step in the sharded step's tensor-parallel
    arithmetic."""

    def __init__(self, cfg, blocks: dict, tp: int):
        self.cfg, self.blocks = cfg, blocks
        self.tp = TensorParallel(tp, range(tp))

    def gather(self, tree, path: str):
        from repro_torch.models import lm
        subs = self.blocks.get(path, ())
        if "" in subs:      # embed (V, d); lm_head, img_proj (d, V)
            return {"w": self.tp.split(tree["w"], 0 if path == "embed"
                                       else 1), "tp": self.tp}
        out = dict(tree)
        for sub in subs:
            out[sub] = lm.tp_sub_params(tree[sub], self.cfg, self.tp, sub)
        return out


class ParamShards:
    """A rank's parameter shards as the model reads them in the sharded
    step: ``plans`` (``launch.sharding.gather_plan``: per leaf path the
    gather steps, as mesh dims, and the use), ``blocks`` (per path, the
    sub-blocks that compute on 'model' shards), ``tp`` (the 'model' axis's
    :class:`TensorParallel`, or None), ``span`` (a :class:`TokenSpan` for
    MoE routing that spans ranks, or None) and ``stats`` (the
    :class:`GatherStats` the gathers count into). With ``cache`` (a
    prefill's or a decode step's :class:`CacheShards`), the gathers run
    outside autograd (no re-gathers)."""

    def __init__(self, cfg, mesh, plans: dict, blocks: dict, *, tp, span,
                 stats: GatherStats, cache=None):
        self.cfg, self.plans, self.blocks = cfg, plans, blocks
        self.tp, self.span, self.stats = tp, span, stats
        self.cache = cache
        coord = mesh.get_coordinate()

        def steps(plan):
            out = tuple((mesh.get_group(i), mesh.size(i), coord[i], dim,
                         summed, None) for i, dim, summed in plan.gather)
            if isinstance(plan.use, tuple) and plan.use[0] == "recut":
                # the rank's 'model' cut moved from one dim to another by
                # an all-to-all, after the other dims' gathers
                i = mesh.mesh_dim_names.index("model")
                _, src, dst = plan.use
                out += ((mesh.get_group(i), mesh.size(i), coord[i], src,
                         False, dst),)
            return out
        self._steps = {k: steps(p) for k, p in plans.items()}
        # the attention dicts whose leaves come arranged in the head layout
        self._arranged = {k.rsplit("/", 2)[0] for k, p in plans.items()
                          if p.use[0] == "arranged"}
        self._regather = _Regather()

    @contextlib.contextmanager
    def saving(self):
        """The model's forward and backward under the re-gather hooks."""
        with torch.autograd.graph.saved_tensors_hooks(self._regather.pack,
                                                      self._regather.unpack):
            yield

    @contextlib.contextmanager
    def forward(self):
        """The model's forward (inside :meth:`saving`): with the stats'
        ``track_copies``, under :class:`_Copies`."""
        if not self.stats.track_copies:
            yield
            return
        self._regather.copies = _Copies(self.stats)
        try:
            with self._regather.copies:
                yield
        finally:
            self._regather.copies = None

    def gather(self, tree, path: str):
        """``tree`` (a layer's slices of the rank's stacked shards, or an
        unstacked leaf's tree) at ``path`` as its block computes on it."""
        out = self._walk(tree, path)
        for sub in self.blocks.get(path, ()):
            (out[sub] if sub else out)["tp"] = self.tp
        if self.span is not None and isinstance(out, dict) and "moe" in out:
            out["moe"]["span"] = self.span
        return out

    def _walk(self, tree, key: str):
        if isinstance(tree, dict):
            out = {k: self._walk(v, f"{key}/{k}") for k, v in tree.items()}
            if key in self._arranged:
                out["arranged"] = True
            return out
        return self._leaf(tree, key)

    def _transform(self, use):
        from repro_torch.models import lm
        if use == "whole":
            return None
        if use == "shard" or use[0] == "recut":
            return lambda w: w.unsqueeze(0)
        if use[0] == "arranged":
            _, proj, leaf = use
            return lambda w: lm.arrange_leaf(w, self.cfg, proj, leaf)
        _, kind, dim = use
        return lambda w: lm.tp_heads(w, self.cfg, self.tp, kind, dim)

    def _leaf(self, t: torch.Tensor, key: str) -> torch.Tensor:
        steps = self._steps[key]
        transform = self._transform(self.plans[key].use)
        if self.cache is not None:
            with torch.no_grad():
                out = _gathered(t, steps, transform)
            if steps:
                self.stats.add(out)
            return out
        copies = self._regather.copies
        if copies is not None:
            copies.mark(t, "source")
        src = t.detach()
        if not steps:
            if transform is None:
                return t
            out = transform(t)
            if _storage(out) != _storage(t):
                # a copy (arranged heads): made again for the backward
                def remake():
                    with torch.no_grad():
                        return transform(src)
                self._regather.register(out, remake)
            return out
        out = _Gather.apply(t, steps, transform)
        if copies is not None:
            copies.mark(out, "gathered")

        def recipe():
            with torch.no_grad():
                again = _gathered(src, steps, transform)
            self.stats.add(again)
            return again
        self._regather.register(out, recipe)
        self.stats.add(out)
        return out


class SeqShards:
    """A decode cache's KV rows cut over the batch's mesh dims (a batch
    that does not split over them: ``long_500k`` at batch 1): this rank
    holds rows ``[lo, lo + rows)`` of the sequence, and the ranks of
    ``groups`` (one process group per mesh dim) hold the others."""

    def __init__(self, groups: tuple, lo: int, rows: int):
        self.groups, self.lo, self.rows = tuple(groups), int(lo), int(rows)

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` all-reduced over the ranks that hold the other rows."""
        t = t.contiguous()
        for group in self.groups:
            dist.all_reduce(t, op=_OPS[op], group=group)
        return t


class CacheShards:
    """How a rank's decode cache shards cut the cache: ``dims`` per cache
    key the dim of one layer's slice (counted from the end) that the
    'model' axis cuts (None where no dim is cut), ``tp`` the 'model' axis's
    :class:`TensorParallel` (None on a mesh without 'model' ranks),
    ``seq`` a :class:`SeqShards` where the KV rows are cut over the batch's
    mesh dims."""

    def __init__(self, dims: dict, tp=None, seq=None):
        self.dims, self.tp, self.seq = dims, tp, seq

    def cut(self, key: str, t: torch.Tensor, like: torch.Tensor):
        """One layer's value ``t`` as the rank's shard of ``key`` holds it:
        where 'model' cuts a dim that ``t`` has whole (its size a ``tp``
        multiple of ``like``'s), the rank's part of it."""
        d = self.dims.get(key)
        if d is None or self.tp is None or t.shape[d] == like.shape[d]:
            return t
        size = like.shape[d]
        return t.narrow(d, self.tp.ranks[0] * size, size)

    def whole(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's shard ``t`` of one layer's slice of ``key``, whole
        (all-gathered over 'model' where 'model' cuts it)."""
        d = self.dims.get(key)
        if d is None or self.tp is None:
            return t
        return _all_gather(t, self.tp.group, self.tp.tp, t.ndim + d)

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' heads ``t`` ``(B, S, heads, D)`` joined over 'model'
        in rank order."""
        return _all_gather(t, self.tp.group, self.tp.tp, 2)


def batch_parts(cfg, mesh, split: bool) -> tuple:
    """``(lcfg, span, batch_dims, parts)`` for a step that every rank of
    ``mesh`` calls with the same global batch: ``split``, whether the batch
    is cut over the batch's mesh dims (``input_pspecs``); ``batch_dims``
    those mesh dims (indices; none when the batch is not cut) and ``parts``
    the pieces it is cut in; ``lcfg`` the config the rank runs (its MoE
    routing groups the ones its part holds) and ``span`` a
    :class:`TokenSpan` where a routing group spans ranks (else None).
    Routing groups are contiguous and batch-major: where they split over
    the parts, a rank routes the ones its part holds; where one spans ranks,
    every rank routes the gathered tokens of the whole batch as the
    reference does and keeps its own rows."""
    import dataclasses
    import math

    from repro_torch.launch.mesh import batch_axes
    names = mesh.mesh_dim_names
    batch_dims = [i for i, n in enumerate(names)
                  if split and n in batch_axes(mesh)]
    parts = math.prod(mesh.size(i) for i in batch_dims)
    coord = mesh.get_coordinate()
    groups = max(1, cfg.dp_shards) if cfg.batch_axes else 1
    span, lcfg = None, cfg
    if cfg.family == "moe" and groups % parts:
        index = 0
        for i in batch_dims:
            index = index * mesh.size(i) + coord[i]
        span = TokenSpan(tuple((mesh.get_group(i), mesh.size(i), coord[i], 0,
                                True, None) for i in reversed(batch_dims)),
                         index, parts)
    else:
        lcfg = dataclasses.replace(cfg, dp_shards=max(1, groups // parts))
    return lcfg, span, batch_dims, parts


def model_axis(mesh):
    """The mesh's 'model' axis as a :class:`TensorParallel` of this rank,
    or None (no 'model' axis, or one of size 1)."""
    names = mesh.mesh_dim_names
    if "model" not in names:
        return None
    i = names.index("model")
    if mesh.size(i) == 1:
        return None
    return TensorParallel(mesh.size(i), (mesh.get_coordinate()[i],),
                          mesh.get_group(i))
