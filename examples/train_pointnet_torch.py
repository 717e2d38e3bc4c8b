"""Train PointNet++ (paper Model 0) with the PyTorch/CUDA port on the
synthetic ModelNet40-like dataset: the twin of ``examples/train_pointnet.py``.

Data pipeline -> ``compile_model(params, cfg)`` ('float' backend,
'baseline' schedule; FPS through K7 in every forward) -> the loss's
gradients by autograd -> AdamW (``repro_torch.optim``) -> a checkpoint in
the JAX package's format (``repro_torch.checkpoint``), in a
preemption-safe loop (``GracefulShutdown``, ``StragglerWatchdog``).

The model is compiled once: its float weights are the parameter tensors
themselves, which AdamW updates in place, so each step's forward reads
the last step's update. Float32 throughout, TF32 off, as the reference
computes. Each step runs eagerly; the reference jits its step.

``--points 1024`` trains model0 unreduced (512 and 128 centres); fewer
points scale the centres down in proportion (128 and 32 at the default
256, the reference's reduced cloud).

Run:  PYTHONPATH=src python examples/train_pointnet_torch.py [--steps 200]
      [--device cpu]
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch import PAPER_MODELS, compile_model
from repro_torch.checkpoint import save_checkpoint
from repro_torch.data import PointCloudDataset
from repro_torch.launch.fault import GracefulShutdown, StragglerWatchdog
from repro_torch.models.backend import resolve_device
from repro_torch.models.pointnet2 import init_params
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               tree_leaves, tree_map)


def train_config(points: int):
    """Model 0 at ``points`` points per cloud: unreduced at its own 1024,
    else each SA layer's centres scaled by ``points / 1024``."""
    cfg0 = PAPER_MODELS["model0"]
    if points == cfg0.n_points:
        return cfg0
    return dataclasses.replace(cfg0, n_points=points, layers=tuple(
        dataclasses.replace(spec, n_centers=max(
            1, spec.n_centers * points // cfg0.n_points))
        for spec in cfg0.layers))


def train_step(model, params, opt, opt_cfg, clouds, labels):
    """One step: the loss and its gradients, then AdamW in place. Returns
    ``(opt, loss, acc)``, the loss and accuracy as 0-d tensors."""
    loss, acc = model.loss_fn(clouds, labels)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    _, opt, _ = adamw_update(params, tree_map(lambda _: next(grads), params),
                             opt, opt_cfg)
    return opt, loss.detach(), acc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=256,
                    help="points per cloud (1024 is the paper's model0)")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "pointer_pointnet_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the data")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train and checkpoint; returns the history (per step: loss,
    accuracy, host-clock seconds) beside the final state, the compiled
    model and the checkpoint's path."""
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(args.device)
    cfg = train_config(args.points)
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=20,
                          weight_decay=0.01)
    params = tree_map(lambda t: t.to(dev).requires_grad_(),
                      init_params(cfg, seed=args.seed))
    opt = adamw_init(params, opt_cfg)
    model = compile_model(params, cfg, device=dev)
    data = PointCloudDataset(n_points=args.points, n_clouds=512,
                             seed=args.seed)

    shutdown = GracefulShutdown()
    watchdog = StragglerWatchdog()
    history = []
    t0 = time.perf_counter()
    try:
        for i, (clouds, labels) in enumerate(
                data.batches(args.batch, args.steps)):
            watchdog.start_step()
            t_step = time.perf_counter()
            opt, loss, acc = train_step(
                model, params, opt, opt_cfg,
                torch.from_numpy(clouds).to(dev),
                torch.from_numpy(labels).to(dev))
            loss_v, acc_v = float(loss), float(acc)    # ends the step
            history.append({"step": i, "loss": loss_v, "acc": acc_v,
                            "seconds": time.perf_counter() - t_step})
            watchdog.end_step(i)
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss={loss_v:.4f} acc={acc_v:.3f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if shutdown.requested:
                break
    finally:
        shutdown.restore()
    path = save_checkpoint(args.ckpt, len(history),
                           {"params": params, "opt": opt},
                           meta={"arch": "pointnet2-model0"})
    print(f"final acc={history[-1]['acc']:.3f}; checkpoint saved to "
          f"{args.ckpt} (chance = 0.025)")
    if watchdog.flagged_steps:
        print(f"stragglers flagged: {len(watchdog.flagged_steps)}")
    return {"config": cfg, "opt_config": opt_cfg, "history": history,
            "params": params, "opt": opt, "model": model, "ckpt": path,
            "stragglers": len(watchdog.flagged_steps)}


if __name__ == "__main__":
    main(sys.argv[1:])
