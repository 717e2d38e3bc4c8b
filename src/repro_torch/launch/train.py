"""Training of the LM stack: the train state, the step function and the
fault-tolerant loop — the port's counterpart of the JAX package's
``launch/train.py``.

``make_train_step`` builds the step (the loss, its gradients by autograd,
int8 error-feedback compression when asked, AdamW) over a state held in
place: the parameters, AdamW's moments and step counter and the
compression residuals are updated in their own tensors, and the step
returns the same state with the step's metrics. On the card the first
``CudaGraphCall.WARMUP`` calls per state and batch shape run eagerly on a
side stream, as real steps (the capture's warm-ups: no copy of the state
is kept to undo them, 25 GB at one layer of llama4-scout's width); the
next call captures the whole step into one CUDA graph and every call from
then on replays it (``models/backend.py::StepGraphs``), as the reference
jits its step. On the CPU it runs eagerly.
Every gradient on the path sums in a fixed order (``models/lm.py``), so
two runs from one state give the same bits, captured or eager.

``make_train_step(..., mesh=)`` is the sharded step over a
``DeviceMesh``: each state leaf a ``DTensor`` of its shard per
``launch.sharding.state_pspecs`` (``shard_tree``), on every axis. A step
splits the batch per ``input_pspecs`` and runs the model on the rank's
part through ``launch.tp.ParamShards`` (``launch.sharding.gather_plan``
says where): each parameter leaf all-gathered where its block uses it, a
stacked leaf one layer at a time (ZeRO-3: the gathered weights are
gathered again for the backward, never kept), over the mesh dims that
shard it except 'model' where the block computes on the rank's shards.
On a mesh with 'model' > 1 attention (the rank's heads), the MLP (d_ff
columns and rows), the MoE experts (f), vlm's cross-attention (heads),
the hybrid's Mamba2 layers and shared block, RWKV6's time mix (heads) and
channel mix (d_ff), the embedding, head and cross-entropy (the rank's
vocabulary range) and vlm's ``img_proj`` (columns) compute
tensor-parallel where all of their weight leaves are 'model'-sharded;
everything else computes whole on every rank: the MoE router, and every
block with a leaf under the rules' 1M-element floor (all of them at
``reduced()``). With ``cfg.remat`` each checkpointed layer's gathers run
again in its recompute, which serves the backward: no re-gather. MoE
routing groups that split over the batch's parts are routed by the rank
that holds them; a group that spans ranks is routed on every rank over
the batch's gathered tokens, each rank keeping its own rows. The gathers' backward reduce-scatters the gradients onto the
shards (the sum over the batch's parts), a leaf replicated on a batch dim
is all-reduced there, the sum becomes the mean over the global batch, and
AdamW updates the shards, clipping by the global norm summed over the
ranks. Under GSPMD the reference's sharded step is its unsharded function;
so is this one's, up to the order of the sums over the batch's parts and
the 'model' ranks. It runs eagerly: the collectives are not captured.
``step.gather_stats`` (``launch.tp.GatherStats``) holds the last step's
gathered bytes and the most that were alive at once, and, with its
``track_copies`` set, the bytes of the weights' copies that autograd kept
for the backward.

``run_training`` is the loop the examples and tests drive: the seeded
``TokenStream`` data by default, checkpoints in the reference's format
(either package restores the other's; a restore writes into the live
tensors, which a captured step reads), a SIGTERM-safe preemption that
checkpoints and stops, and the straggler watchdog.
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.fault import GracefulShutdown, StragglerWatchdog
from repro_torch.models import lm
from repro_torch.models.backend import StepGraphs, resolve_device
from repro_torch.optim import (AdamWConfig, CompressionState, adamw_init,
                               adamw_update, compress_error_feedback,
                               global_norm, tree_leaves, tree_map)

__all__ = ["TrainLoopConfig", "make_train_step", "init_train_state",
           "run_training"]

#: a batch's entries, in the order a captured step takes them
BATCH_KEYS = ("ids", "labels", "embeds", "image_embeds")
#: the step's metrics, in the order a captured step returns them
METRICS = ("loss", "ppl", "grad_norm", "lr")


@dataclass
class TrainLoopConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    grad_compression: bool = False
    seed: int = 0


def init_train_state(seed: int, cfg, opt_cfg: AdamWConfig, *,
                     grad_compression: bool = False, device=None) -> dict:
    """``{"params", "opt"[, "comp_err"]}``: the port's seeded ``lm.init``
    on ``device`` (the card unless ``device="cpu"``), its leaves requiring
    grad; AdamW's zero moments and step; with ``grad_compression`` the
    zero float32 residuals."""
    params = tree_map(lambda t: t.requires_grad_(),
                      lm.init(seed, cfg, device=device))
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    if grad_compression:
        state["comp_err"] = CompressionState.init(params).error
    return state


def state_leaves(state: dict) -> list:
    """The tensors a step updates in place, in the checkpoint's order."""
    return [t.detach() for t in tree_leaves(state)]


def _step(cfg, opt_cfg: AdamWConfig, grad_compression: bool, state: dict,
          *batch, par=None):
    """One step on ``batch`` (tensors or None in :data:`BATCH_KEYS`' order),
    in place; the metrics as a tuple in :data:`METRICS`' order. ``par``:
    ``lm.loss_fn``'s (``launch.tp.EmulatedTP``: the step in the sharded
    step's tensor-parallel arithmetic, in one process)."""
    ids, labels, embeds, image_embeds = batch
    params = state["params"]
    loss, metrics = lm.loss_fn(params, cfg, ids, labels, embeds=embeds,
                               image_embeds=image_embeds, par=par)
    # a leaf the loss does not read (a cross layer's unused norm) gets
    # zeros, as the reference's grad gives it
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     materialize_grads=True))
    grads = tree_map(lambda _: next(grads), params)
    om = _update(state, grads, opt_cfg, grad_compression)
    return (loss.detach(), metrics["ppl"].detach(), om["grad_norm"],
            om["lr"])


def _update(state: dict, grads, opt_cfg: AdamWConfig,
            grad_compression: bool, *, amax_reduce=None, norm=None) -> dict:
    """A step's tail, in place on ``state`` (tensors, or a rank's local
    shards of them): int8 error-feedback compression of ``grads`` when
    asked, its residuals written back, then AdamW; AdamW's metrics. For
    shards, ``amax_reduce`` (:func:`compress_error_feedback`'s) gives each
    leaf one scale over its shards, and ``norm(grads)`` the global norm
    over the ranks."""
    if grad_compression:
        grads, comp = compress_error_feedback(
            grads, CompressionState(error=state["comp_err"]),
            amax_reduce=amax_reduce)
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), state["comp_err"],
                     comp.error)
    _, _, om = adamw_update(state["params"], grads, state["opt"], opt_cfg,
                            step_in_place=True,
                            grad_norm=None if norm is None else norm(grads))
    return om


def make_train_step(cfg, opt_cfg: AdamWConfig, *,
                    grad_compression: bool = False, mesh=None):
    """``step(state, batch) -> (state, metrics)``: ``batch`` a dict with
    ``labels`` and ``ids`` (or ``embeds``; ``image_embeds`` for vlm),
    arrays or tensors; ``state`` as :func:`init_train_state` gives it,
    updated in place and returned; ``metrics`` ``{"loss", "ppl",
    "grad_norm", "lr"}`` as 0-d tensors. On the card, per (state, batch
    shapes), the first ``CudaGraphCall.WARMUP`` calls run eagerly, the
    next captures the step into one CUDA graph, and each call from then on
    replays it over the state's own tensors (``step.graphs``).

    With ``mesh`` (a ``DeviceMesh``), the sharded step
    (:func:`_sharded_step`): ``state`` a tree of ``DTensor`` s, every rank
    of the mesh calling it with the same global batch; ``step.gather_stats``
    the last step's gathered bytes. A TP head layout whose query or KV heads
    do not split over the mesh's 'model' ranks raises ``ValueError``."""
    if mesh is not None:
        from repro_torch.launch.sharding import check_head_layout
        from repro_torch.launch.tp import GatherStats
        check_head_layout(cfg, mesh)
        stats = GatherStats()

        def sharded(state: dict, batch: dict):
            return _sharded_step(cfg, opt_cfg, grad_compression, mesh,
                                 state, batch, stats)
        sharded.gather_stats = stats
        return sharded
    graphs = StepGraphs()

    def step(state: dict, batch: dict):
        dev = state["opt"]["step"].device
        args = tuple(None if batch.get(k) is None
                     else torch.as_tensor(batch[k], device=dev)
                     for k in BATCH_KEYS)

        def train_step(*batch):
            return _step(cfg, opt_cfg, grad_compression, state, *batch)
        out = graphs(train_step, tree_leaves(state), args)
        return state, dict(zip(METRICS, out))

    step.graphs = graphs.graphs
    return step


def _leaf_paths(tree, prefix: str = "") -> list:
    """The paths of ``tree``'s leaves, in :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                     else k)]
    return [prefix]


def _sharded_step(cfg, opt_cfg: AdamWConfig, grad_compression: bool, mesh,
                  state: dict, batch: dict, stats):
    """One sharded step (module docstring) on ``state``'s DTensor shards,
    in place; ``(state, metrics)``, the metrics the global batch's. The
    gathered bytes go to ``stats``."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import (NamedSharding, gather_plan,
                                             input_pspecs)
    from repro_torch.launch.tp import ParamShards, batch_parts, model_axis
    leaves = tree_leaves(state)
    dev = leaves[0].to_local().device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
             if v is not None}
    specs = input_pspecs(batch, mesh)
    local = {k: NamedSharding(mesh, specs[k]).shard(v)
             for k, v in batch.items()}
    names = mesh.mesh_dim_names
    split = specs["labels"][0] is not None      # the batch is cut
    lcfg, span, batch_dims, parts = batch_parts(cfg, mesh, split)
    tp = model_axis(mesh)
    plans, blocks = gather_plan(cfg, state["params"], mesh,
                                {names[i] for i in batch_dims})
    stats.reset()
    shards = ParamShards(lcfg, mesh, plans, blocks, tp=tp, span=span,
                         stats=stats)
    params = tree_map(lambda d: d.to_local().detach().requires_grad_(),
                      state["params"])
    with shards.saving():
        with shards.forward():
            loss, _ = lm.loss_fn(params, lcfg, local.get("ids"),
                                 local["labels"], embeds=local.get("embeds"),
                                 image_embeds=local.get("image_embeds"),
                                 par=shards)
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    materialize_grads=True)
    del params, shards

    def all_reduce(t, dims=range(len(names)), op=dist.ReduceOp.SUM):
        """``t`` reduced over the mesh's ranks along ``dims``, in place."""
        for i in dims:
            dist.all_reduce(t, op=op, group=mesh.get_group(i))
        return t
    # the gathers' backward summed each leaf's gradient over the mesh dims
    # it is gathered on; sum it over the ones its plan reduces, then the
    # mean over the parts
    pleaves = tree_leaves(state["params"])
    out = []
    with torch.no_grad():
        for g, key in zip(grads, _leaf_paths(state["params"])):
            g = all_reduce(g.contiguous(), plans[key].reduce)
            out.append(g / parts if parts > 1 else g)
        loss = loss.detach()
        if parts > 1:
            loss = all_reduce(loss.clone(), batch_dims) / parts
        lstate = tree_map(lambda d: d.to_local(), state)
    del grads
    grads = iter(out)
    grads = tree_map(lambda _: next(grads), state["params"])
    # each leaf's squares counted once over the ranks: a shard held by
    # ``rep`` ranks (the mesh dims it is replicated on) is weighted 1/rep
    reps = [math.prod(mesh.size(i) for i, pl in enumerate(d.placements)
                      if pl.is_replicate()) for d in pleaves]
    om = _update(lstate, grads, opt_cfg, grad_compression,
                 amax_reduce=lambda t: all_reduce(t, op=dist.ReduceOp.MAX),
                 norm=lambda g: global_norm(
                     g, weights=[None if r == 1 else 1.0 / r for r in reps],
                     reduce=all_reduce))
    return state, {"loss": loss, "ppl": torch.exp(loss),
                   "grad_norm": om["grad_norm"], "lr": om["lr"]}


def _restore_into(ckpt_dir: str, state: dict) -> int:
    """The latest checkpoint under ``ckpt_dir`` copied into ``state``'s
    own tensors (a captured step reads those); its step."""
    restored, start, _ = restore_checkpoint(ckpt_dir, state)
    with torch.no_grad():
        for dst, src in zip(state_leaves(state), tree_leaves(restored)):
            dst.copy_(src)
    return start


def run_training(cfg, loop: TrainLoopConfig,
                 opt_cfg: AdamWConfig | None = None, *, data=None,
                 resume: bool = True, verbose: bool = True, device=None):
    """Single-host training loop (the examples' entry point), on
    ``device`` (the card unless ``device="cpu"``). ``data(step)`` gives a
    step's batch; by default the seeded ``TokenStream``. Preemption-safe:
    SIGTERM checkpoints and stops cleanly; a restart resumes from the
    latest step. Returns ``(history, state, watchdog)``, the history a list of
    per-step ``{"loss", "ppl", "grad_norm", "lr"}`` floats."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps,
                                     warmup_steps=max(1, loop.steps // 20))
    dev = resolve_device(device)
    state = init_train_state(loop.seed, cfg, opt_cfg,
                             grad_compression=loop.grad_compression,
                             device=dev)
    start = 0
    if resume and latest_step(loop.ckpt_dir) is not None:
        start = _restore_into(loop.ckpt_dir, state)
        if verbose:
            print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg,
                              grad_compression=loop.grad_compression)
    if data is None:
        stream = TokenStream(cfg.vocab_size, loop.seq_len, loop.batch_size,
                             seed=loop.seed)
        data = (lambda step: dict(zip(("ids", "labels"),
                                      map(torch.from_numpy,
                                          stream.batch(step)))))
    shutdown = GracefulShutdown()
    watchdog = StragglerWatchdog()
    history = []
    try:
        for step in range(start, loop.steps):
            watchdog.start_step()
            state, metrics = step_fn(state, data(step))
            # the reference's own host read of each step's metrics, after
            # the step (outside what a CUDA graph captures)
            metrics = {k: float(v) for k, v in metrics.items()}
            slow = watchdog.end_step(step)
            history.append(metrics)
            if verbose and (step % loop.log_every == 0 or slow):
                flag = " [STRAGGLER]" if slow else ""
                print(f"[train] step {step} loss={metrics['loss']:.4f} "
                      f"lr={metrics['lr']:.2e}{flag}")
            if (step + 1) % loop.ckpt_every == 0 or shutdown.requested:
                save_checkpoint(loop.ckpt_dir, step + 1, state,
                                keep=loop.keep, meta={"arch": cfg.name})
                if shutdown.requested:
                    if verbose:
                        print(f"[train] preempted at step {step + 1}; "
                              "checkpointed, exiting cleanly")
                    break
    finally:
        shutdown.restore()
    return history, state, watchdog
