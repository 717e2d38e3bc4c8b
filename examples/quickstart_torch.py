"""Quickstart on the PyTorch/CUDA port: the paper in a minute, the twin of
``examples/quickstart.py``.

Builds a PointNet++ workload (paper Model 0), runs the four accelerator
design points through the port's simulator and prints the Fig. 7/8
headline numbers next to the paper's. Then the execution side, through
``repro_torch.compile_model``:

  compile : ``compile_model(params, config, backend='reram-fused',
            schedule='pointer')`` programs every MLP into crossbar plane
            tensors once and selects the paper's execution order.
  execute : each SA layer runs its centers in plan order through the
            gather kernel (K4/K5), and each MLP through one fused crossbar
            kernel call — the dataflow (K1, K2 or K3) chosen for the card
            by the cost model, beside the TPU's choice the JAX package
            makes. Logits do not depend on the order; the class agrees
            with the float model.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch import PAPER_MODELS, PlanPolicy, PointNetWorkload, \
    compile_model
from repro_torch.core import run_design
from repro_torch.models.pointnet2 import init_params


def main(device: str = "cuda") -> dict:
    """Print the quickstart's lines; returns what they show."""
    wl = PointNetWorkload.random(PAPER_MODELS["model0"], seed=0)
    base = run_design(wl, "baseline")
    print(f"{'design':12s} {'time(us)':>10s} {'speedup':>9s} "
          f"{'energy(uJ)':>11s} {'eff':>7s}")
    designs = {}
    for d in ("baseline", "pointer-1", "pointer-12", "pointer"):
        r = run_design(wl, d)
        designs[d] = (base.cycles / r.cycles, base.energy_j / r.energy_j)
        print(f"{d:12s} {r.time_us:10.1f} {designs[d][0]:8.1f}x "
              f"{r.energy_uj:11.1f} {designs[d][1]:6.1f}x")
    print(f"{'paper says':12s} {'':>10s} {'40.0x':>9s} {'':>11s} {'22.0x':>7s}"
          "   (model0)\n")

    cfg = PAPER_MODELS["model0"]
    params = init_params(cfg, seed=0)
    cloud = torch.as_tensor(wl.points[0], dtype=torch.float32)

    # the same schedule drives the execution path: plan-ordered gathers
    # elide DMAs, logits don't change
    elision = {}
    for mode in ("baseline", "pointer"):
        el = compile_model(params, cfg, schedule=mode, device=device).stats(
            wl.points[0], window=72)["dma"]
        elision[mode] = el["elision_rate"]
        print(f"aggregate-kernel DMA elision with {mode:9s} order "
              f"(72-row window): {el['elision_rate']:.1%} "
              f"({el['dma']} DMAs)")

    model_f = compile_model(params, cfg, device=device)       # float
    model_q = compile_model(params, cfg, backend="reram-fused",
                            schedule="pointer", device=device)
    logits_f = model_f.forward(cloud)
    logits_q = model_q.forward(cloud)
    st = model_q.stats(wl.points[0])
    per_matmul = sum(len(p) for p in params["sa"]) + len(params["head"])
    n_mlps = cfg.n_layers + 1
    choices = {k: f"{st['launch_plan'][k]['kernel']} "
                  f"'{st['launch_plan'][k]['mode']}' (TPU '{v['mode']}')"
               for k, v in st["fused_plan"].items()}
    agree = int(logits_f.argmax()) == int(logits_q.argmax())
    print(f"\nreram-fused backend: {st['program_bytes'] / 1024:.0f} KB "
          f"programmed once, {n_mlps} fused kernel calls per forward "
          f"(vs {per_matmul} per-matmul launches); dataflow per MLP for "
          f"the card {choices}; float argmax {int(logits_f.argmax())} "
          f"== fused argmax {int(logits_q.argmax())}: {agree}; "
          f"executed-gather elision {st['dma']['elision_rate']:.1%}")

    # the same decisions made by the cost model instead of by name: the
    # policy picks the intra order per workload (predicted DMA elisions,
    # on the host) and the dataflow per MLP (predicted device time)
    model_p = compile_model(params, cfg, backend="reram-fused",
                            policy=PlanPolicy(), device=device)
    picked = model_p.policy.select_intra(wl)
    clouds = torch.stack([cloud, cloud * 0.98])
    bat = model_p.batched_forward(clouds)
    policy_bitwise = bool(torch.equal(bat[0], model_q.forward(cloud)))
    print(f"policy compile: intra picked per workload = {picked!r}; "
          f"batched plan-driven forward = {cfg.n_layers} gather launches "
          f"for {clouds.shape[0]} clouds, row 0 bitwise-equal to the "
          f"per-cloud forward: {policy_bitwise}")

    # planning on the card: 'pointer' builds its plan on the device too,
    # so the whole call captures into one CUDA graph; a precommitted
    # policy plans there as well
    pre = compile_model(params, cfg, backend="reram-fused", device=device,
                        policy=PlanPolicy().precommit(wl))
    captured = model_q.jit_batched_forward(clouds)
    captured_bitwise = bool(torch.equal(captured, bat))
    precommitted_bitwise = bool(torch.equal(pre.jit_batched_forward(clouds),
                                            bat))
    print(f"planning on the device: schedule='pointer' "
          f"(device_planning={model_q.device_planning}) and the policy "
          f"precommitted to {pre.policy.intra_candidates[0]!r} "
          f"(device_planning={pre.device_planning}) — "
          f"jit_batched_forward({clouds.shape[0]} clouds) equals the "
          f"host-planned policy's logits bitwise: {captured_bitwise}, "
          f"{precommitted_bitwise}")
    return {"designs": designs, "elision": elision, "choices": choices,
            "argmax_agree": agree, "policy_bitwise": policy_bitwise,
            "captured_bitwise": captured_bitwise,
            "precommitted_bitwise": precommitted_bitwise,
            "picked": picked}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
