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

``run_training`` is the loop the examples and tests drive: the seeded
``TokenStream`` data by default, checkpoints in the reference's format
(either package restores the other's; a restore writes into the live
tensors, which a captured step reads), a SIGTERM-safe preemption that
checkpoints and stops, and the straggler watchdog.
"""
from __future__ import annotations

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
                               tree_leaves, tree_map)

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
          *batch):
    """One step on ``batch`` (tensors or None in :data:`BATCH_KEYS`' order),
    in place; the metrics as a tuple in :data:`METRICS`' order."""
    ids, labels, embeds, image_embeds = batch
    params = state["params"]
    loss, metrics = lm.loss_fn(params, cfg, ids, labels, embeds=embeds,
                               image_embeds=image_embeds)
    # a leaf the loss does not read (a cross layer's unused norm) gets
    # zeros, as the reference's grad gives it
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     materialize_grads=True))
    grads = tree_map(lambda _: next(grads), params)
    if grad_compression:
        grads, comp = compress_error_feedback(
            grads, CompressionState(error=state["comp_err"]))
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), state["comp_err"],
                     comp.error)
    _, _, om = adamw_update(params, grads, state["opt"], opt_cfg,
                            step_in_place=True)
    return (loss.detach(), metrics["ppl"].detach(), om["grad_norm"],
            om["lr"])


def make_train_step(cfg, opt_cfg: AdamWConfig, *,
                    grad_compression: bool = False):
    """``step(state, batch) -> (state, metrics)``: ``batch`` a dict with
    ``labels`` and ``ids`` (or ``embeds``; ``image_embeds`` for vlm),
    arrays or tensors; ``state`` as :func:`init_train_state` gives it,
    updated in place and returned; ``metrics`` ``{"loss", "ppl",
    "grad_norm", "lr"}`` as 0-d tensors. On the card, per (state, batch
    shapes), the first ``CudaGraphCall.WARMUP`` calls run eagerly, the
    next captures the step into one CUDA graph, and each call from then on
    replays it over the state's own tensors (``step.graphs``)."""
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
