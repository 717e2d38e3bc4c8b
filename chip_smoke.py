#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — ``repro_torch.compile_model(params,
PAPER_MODELS[m], backend=..., schedule="pointer")`` then
``batched_forward`` on 8 clouds of 1024 points and ``forward`` on one — at
the full width and depth of model2 ('reram-fused', 'reram-fused-mtiled'
and the per-layer 'reram'), model1 and model0 ('reram-fused' and 'float'),
with random weights from a seed. The path plans on the card, the default:
P1 and P2 build each call's plan from its own geometry; 'reram-fused'
launches the Hopper dataflow choice (``PlanPolicy.select_launch``) per MLP
and batch size. Phases, each printing one JSON line:

1. device: the card's name and power limit; TF32 off for float32 matmuls
   and convolutions;
2. build: every CUDA kernel of the paths built from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started
   together; P4's ``gather_backward.cu`` among them);
   dataflow (first, so that model0's MLPs are K2's first launches in the
   process, one of them at exactly 48 KB of dynamic shared memory): K1, K2
   and K3 at every MLP of model0, model1 and model2 at batch 1 and 8, each
   bit for bit against the plain version, with its device time
   (``torch.profiler``) beside the TPU's choice, the Hopper choice and the
   policy's predicted time of each, and the shapes where the choice is more
   than 10% slower than the fastest kernel; summed over the grid, the
   Hopper choice's time over the fastest kernels' must not exceed the
   TPU's choice's; the cost model's constants refitted to the run's times
   (``fit_launch_model``) beside the package's;
3. kernel vs plain: each kernel against its plain torch version on the
   same inputs, bit for bit — K1 at model1's shapes, K4 and K5 (batch 8
   and 1) through the plan interface (the plan order and the geometry's
   own int64 indices) at model1's and model2's gathers; K1, K2 and K3
   at each of model2's three MLPs, a ragged one, ones wider than K1's
   stripe and K3's chunks and one of ten layers, each also against the
   others (one function, three dataflows); the s8 weight pre-pass of K1,
   K2 and K3 at every MLP of model1 and model2; K6 and its own pre-pass at
   every layer shape of the model2 'reram' path and at unaligned, split
   and odd shapes; K7's loop at both SA layers' FPS (8 x 1024 -> 512,
   8 x 512 -> 128, the real SA-2 input) and at SA-1 of ``forward``
   (1 x 1024 -> 512) under every tier of its plan (block, cluster,
   streamed) pinned, a ragged cloud with pad rows, grid and duplicated
   clouds (exact ties), a cloud with a NaN coordinate, and clouds past
   one block: N = 16385 and 65536 (clusters of 3 and 8), 131072 (the
   cluster tier's top, 16 blocks) under the chosen plan and the streamed
   tier pinned, and 300000 (streamed); and its single step at the same
   widths; P1 and P2 (phase ``kernel_vs_plain_plan``) against their plain
   versions on the CPU and the NumPy planner: P1 at 8 x 128, 1 x 128 and
   1 x 2048 points, P2 at the main path's 8 x (128 x 16 -> 512) walk, both
   also through model1's geometry of clustered, grid and duplicated clouds;
4. end to end: each model and backend with the 'pointer' schedule; launch
   counters reset just before each run and read just after, and held to
   the counts the path must launch (FPS: one launch per SA layer and
   call; P1 and P2 one each per call); the card's logits and geometry (FPS
   and kNN) held against the port's own CPU run on the first 2 clouds; the
   crossbar backends' logits bit for bit against the same model planning
   on the host (``device_planning=False``); ``jit_batched_forward`` (a
   captured CUDA graph) bit for bit against eager ``batched_forward`` over
   two replays on different clouds, ``jit_forward`` against ``forward``,
   and the kernels one replay launches (``torch.profiler``) holding FPS,
   P1, P2 and the gather;
   policy: model2 'reram-fused' under ``PlanPolicy().precommit(workload)``,
   planning on the card, eager and captured, bit for bit the 'pointer'
   schedule's logits, its launches held as the path's; a policy that is
   not precommitted plans on the host and refuses ``jit_batched_forward``
   (``TypeError``);
   reliability: model2 'reram-fused' at batch 8 under ECC at groups 16 and
   4 (``d_pad`` 1024 -> 1408 and 1792 at SA-2), K1, K2 and K3 on the widened
   programs bit for bit against plain and the unprotected outputs, logits
   bit for bit the unprotected model's; under ``FaultModel(p_stuck0=0.01,
   p_stuck1=0.01, seed=3)`` raw and under each ECC, the kernels against
   plain and every MLP bit for bit against the CPU on the same inputs, the
   whole logits bit for bit against the CPU run given the card's layer-0
   features (against the CPU's own run within the end-to-end tolerance,
   argmax equal, only where the card's layer-0 features differ);
   'reram'
   faulted, eager and captured, K6 against plain on every layer's faulted
   planes; the captured call's device time protected, faulted and not;
   one ``pareto.sweep`` of model0 (stuck rates 0, 0.001, 0.002, 0.005;
   'none'/'ecc' at group 4; 8 clouds), its points, front and time, ECC
   more accurate than raw at one rate and less at none;
   quickstart: ``examples/quickstart_torch.py``'s ``main()``, once;
5. times: each kernel, its plain version and a library yardstick, timed
   with CUDA events after warm-up at the main path's shapes, beside the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the peak rate, whichever is larger); for K1, K2, K3, K4, K5, K6, P1 and
   P2 also the profiler's device time of a call (mean of 5; and the library's
   where there is one: a short call leaves the card idle between
   back-to-back calls, so their event time measures the host), and the
   card's launch floor (an empty kernel's device time); in the times line
   only, for K1 and K2, a model of the bytes their code moves through
   device memory (re-reads taken to hit L2) and that model over the event
   time; K1, K2 and K3 at each model2 MLP;
   K7 at the two FPS calls of one ``batched_forward`` under the plan
   ``plan_fps`` chooses, with its time per sampling step, and each tier
   and block size at the main path's shapes beside the same loop with the
   relaxation left out (``chain_us_per_step``: the chain of dependent
   reductions alone, through ``fps_chain_run``, a measurement entry of
   ``csrc/fps.cu`` only this script binds), and past one block the
   cluster tier against the streamed tier at the same clouds; no PyTorch
   call computes FPS, the greedy order or the walk: no library time;
   ``batched_forward`` and ``forward`` end to end, on the host clock,
   eager and captured, and ``batched_forward`` planning on the host;
6. profile: one model1, one model2 and one model2 'reram'
   ``batched_forward`` in three modes — planning on the host (its host
   clock split into geometry, host planning and the rest), planning on the
   card eagerly, and captured — each with its host clock, its device time
   by kernel from ``torch.profiler`` and the device's busy share;
7. serve: the serving tier (``repro_torch.launch``) over a fresh model2
   'reram-fused' at full width and depth, shape buckets of 768 and 1024
   points and batches of 1, 2, 4 and 8: a pool stream (64 requests of 8
   clouds of 1024 and 700 points) saturated and paced, and a LiDAR stream
   (32 frames at 10 Hz, frame reuse), each under FIFO and EDF on the wall
   clock. Launch counters reset just before the runs and read just after,
   held to what the captures and the plan builds must launch; every served
   row bit for bit against ``forward`` on its bare cloud; at most one
   capture per bucket shape, none added by a second pass; plan-cache and
   frame hits; a hit step replays K7 twice, the gather twice and no P1 or
   P2 (``torch.profiler``), a miss launches P1 and P2 once each. Printed:
   throughput and p50/p99 per stream and scheduler, the served step at
   each batch bucket beside the bare captured call, the host's share of a
   served step, and a miss's plan build.

8. contracts: ``repro_torch.verify_contracts(..., check_graph=True)`` on
   every model and backend of phase 4, on the batch and on one cloud: one
   gather launch per SA layer (the batched kind with the whole batch), one
   fused call per MLP on the fused backends, no host round trip (the sync
   debug mode of CUDA) and no float64 result in the call, every fused
   launch within the shared memory a block may take, and the captured
   call's replay holding the same gathers, MLP pre-passes, FPS, P1 and P2;
   any violation raises;
9. train: ``examples/train_pointnet_torch.py``'s ``main()`` on model0
   unreduced (1024 points, batch 16, seed 0, 200 steps; 'float',
   'baseline', FPS through K7, the feature gathers' backward through P4),
   its whole step captured into one CUDA graph and replayed, twice: step
   0's loss and gradients against the port's CPU run on the same batch;
   the two runs bit for bit equal (every loss and accuracy, every
   parameter, moment and the step); every loss finite, the last 20 steps'
   mean loss below the first 20's, each checkpoint restored bit for bit;
   K7 and P4 at 2 launches a replayed step (``torch.profiler`` over one
   replay; the counters see the two warm-ups and the capture); 5 captured
   steps bit for bit the eager ones; P4 bit for bit against its plain
   version at the step's two SA-2 gathers. Printed: the captured step's
   median time, busy share and launches beside the eager step's, the eager
   step with autograd's scatter-add backward in P4's place, and the eager
   forward/backward/optimizer split (``torch.profiler``).

Then one ``{"kernels": [...]}`` line (``serve_launches``: a kernel's
launches in the serve phase's runs; ``train_launches``: K7's in the train
phase's run, ``train_launches_per_replay`` its launches in one replayed
step; P4's row, whose ``launches`` are its counter in the train phase's
run), the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any failure
raises, so the exit code is not 0 and the last line is never printed. It
needs a CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12

BATCH = 8
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def make_clouds(n_points: int, batch: int, seed: int) -> np.ndarray:
    """Deformed-ellipsoid surface clouds (the JAX package's
    ``PointNetWorkload.random`` recipe), float32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        c = rng.normal(size=(n_points, 3))
        c /= np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-9)
        c *= rng.uniform(np.array([[0.4, 0.3, 0.2]]),
                         np.array([[1.0, 0.8, 0.6]]))
        c += 0.1 * np.sin(5.0 * c[:, [1, 2, 0]])
        out.append(c)
    return np.stack(out).astype(np.float32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(smi: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import KERNEL_SOURCES, _build
    t0 = time.perf_counter()
    built = _build.build(KERNEL_SOURCES)
    if not _build.build_log("fps"):
        # a library without its ptxas report: rebuild it, so that K7's
        # registers are checked below
        _build._paths("fps")[0].unlink()
        built["fps"] = _build.build(["fps"])["fps"]
    seconds = time.perf_counter() - t0
    ptxas = {name: _ptxas_registers(_build.build_log(name))
             for name in KERNEL_SOURCES}
    _check_fps_registers(ptxas["fps"])
    emit({"phase": "build", "seconds": seconds, "built": built,
          "ptxas": ptxas, "tensor_core_instructions": _imma_counts()})


def _kernel_name(symbol: str) -> str:
    """A kernel's name and template arguments from its mangled symbol,
    namespaces dropped: ``wstat_mma_kernelILi4ELb0EE`` is
    ``wstat_mma_kernel<4, false>``."""
    import re
    if not symbol.startswith("_ZN"):
        return symbol
    pos, name = 3, symbol
    while pos < len(symbol) and symbol[pos].isdigit():
        n = re.match(r"\d+", symbol[pos:]).group()
        pos += len(n)
        name, pos = symbol[pos:pos + int(n)], pos + int(n)
    args = re.match(r"I(?:L[a-z]\d+E)+E", symbol[pos:])
    return name + (args.group() if args else "")


def _ptxas_registers(log: str) -> dict:
    """Registers and spills of each kernel in a ``-Xptxas -v`` log, by
    :func:`_kernel_name`."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln and "'" in ln:
            entry = _kernel_name(ln.split("'")[1])
        elif entry and ("registers" in ln or "spill" in ln):
            out.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    return out


def fps_kernel_names() -> set:
    """The mangled names (as :func:`_kernel_name` gives them) of every
    loop kernel ``csrc/fps.cu`` instantiates: each register-tier shape of
    ``FPS_PER_THREAD`` in the block and cluster tiers, and the streamed
    kernel, each with and without the relaxation."""
    from repro_torch.kernels.fps_update import (FPS_PER_THREAD,
                                                FPS_STREAM_THREADS)
    names = set()
    for chain in "01":
        names.add(f"fps_stream_kernelILi{FPS_STREAM_THREADS}ELb{chain}EE")
        for t, pers in FPS_PER_THREAD.items():
            for per in pers:
                for cl in "01":
                    names.add(f"fps_loop_kernelILi{t}ELi{per}ELb{cl}"
                              f"ELb{chain}EE")
    return names


def _check_fps_registers(kernels: dict) -> None:
    """K7's kernels take no more registers than ``plan_fps`` counts on
    (``FPS_REGS`` by points a thread, ``FPS_STREAM_REGS``) and spill none;
    every kernel of :func:`fps_kernel_names` must be in the report."""
    import re
    from repro_torch.kernels.fps_update import FPS_REGS, FPS_STREAM_REGS
    missing = fps_kernel_names() - {n for n, lines in kernels.items()
                                    if any("Used" in ln for ln in lines)}
    check(not missing, f"K7: no ptxas register report for "
                       f"{sorted(missing)}")
    for name, lines in kernels.items():
        m = re.match(r"fps_loop_kernelILi\d+ELi(\d+)E", name)
        if m:
            cap = FPS_REGS[int(m.group(1))]
        elif name.startswith("fps_stream_kernel"):
            cap = FPS_STREAM_REGS
        else:
            continue
        for ln in lines:
            used = re.match(r"Used (\d+) registers", ln)
            check(used is None or int(used.group(1)) <= cap,
                  f"K7 {name}: {ln}; the plan counts on {cap} registers")
            check("spill" not in ln or " 0 bytes spill stores" in ln,
                  f"K7 {name} spills: {ln}")


def _imma_counts() -> dict:
    """Integer tensor-core instructions (IMMA) in the SASS of K1, K2, K3 and
    K6, by the toolkit's ``cuobjdump``: the products must run on the tensor
    cores, and a count that cannot be taken fails the check."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in ("fused_mlp", "fused_mlp_mtiled", "fused_mlp_wstat",
                 "reram_mlp"):
        so = _build._paths(name)[0]
        try:
            sass = subprocess.run([tool, "-sass", str(so)],
                                  capture_output=True, text=True,
                                  timeout=120, check=True).stdout
        except (OSError, subprocess.SubprocessError) as e:
            check(False, f"{name}: cuobjdump could not list its SASS ({e})")
        out[name] = sum("IMMA" in ln for ln in sass.splitlines())
        check(out[name] > 0, f"{name}: no IMMA instruction in its SASS")
    return out


def _program_inputs(prog, m: int, seed: int):
    """Random float rows at an MLP's input width, quantized and padded as
    the path does it."""
    from repro_torch.kernels import fused_mlp
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((BATCH, m, prog.widths[0]), generator=g).cuda()
    return fused_mlp.prepare_input(x, prog)


def _ragged_program(widths=(130, 200, 70), seed=SEED + 1):
    from repro_torch.kernels import build_program
    rng = np.random.default_rng(seed)
    layers = [{"w": rng.normal(size=(k, n)).astype(np.float32),
               "b": rng.normal(size=(n,)).astype(np.float32)}
              for k, n in zip(widths[:-1], widths[1:])]
    return build_program(layers).cuda()


#: Beside model2's MLPs, K1, K2 and K3 are held at MLPs past their
#: on-chip limits: inputs wider than K1's 2048-byte stripe in both layers
#: (K runs in two ranges, the last 64 and 32 bytes; K2's two stripes do not
#: fit, so 'mtiled' runs K1; K3 narrows its chunk to 64 columns), wider
#: than K3's 64-column chunk (32 columns) and than its 32-column one (K3
#: runs K in ranges), and ten layers (K2 recomputes up to nine on chip).
RANGE_MLPS = {"wide": ((2100, 2080, 40), 200),
              "wide_4000": ((4000, 64, 40), 100),
              "wide_7000": ((7000, 40), 64),
              "deep": ((20,) + (48,) * 9 + (24,), 300)}

#: K6 beyond the model2 'reram' path's shapes: rows of 4 and 8 bytes
#: (model0's and model1's first layers: not 16-byte aligned), one row
#: with K split over 16 blocks, odd and narrow N, and K past one stripe.
K6_EXTRA_SHAPES = ((65536, 4, 64), (65536, 8, 128), (1, 1024, 256),
                   (130, 77, 5), (300, 64, 5), (3, 5000, 20))


def _check_combine(prog, m: int, what: str) -> dict:
    """The s8 weight pre-pass of K1/K2/K3 against its plain version, bit
    for bit over every layer's (k_lim, n_lim); returns its inputs for
    timing."""
    from repro_torch.kernels import fused_mlp, plan_launch
    geom = plan_launch(prog, m, "mtiled")
    got = fused_mlp.combine_weights_cuda(prog, geom)
    want = fused_mlp.combine_weights_plain(prog, geom)
    torch.cuda.synchronize()
    err = 0
    for l, (g, w) in enumerate(zip(fused_mlp.weight_regions(got, geom),
                                   fused_mlp.weight_regions(want, geom))):
        check(torch.equal(g, w), f"pre-pass {what} layer {l} bitwise")
        err = max(err, int((g.int() - w.int()).abs().max()))
    return {"prog": prog, "geom": geom, "max_abs_err": err}


def _gather_inputs(model, clouds: torch.Tensor):
    """The main path's gathers (real geometry, the plan built on the card):
    per SA layer features of the layer's width, the index-order neighbor
    and centre indices as the geometry gives them (int64; kNN's strided
    view), the plan order (int32), and the indices in plan order (int32,
    what the plain version is given)."""
    from repro_torch.kernels import aggregate
    from repro_torch.models import pointnet2 as pn
    cfg = model.config
    pts, ctr, nbr = pn.geometry_pass(cfg, clouds)
    dplan = model._traced_plan(pts, nbr)
    out = {}
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    for k, spec in enumerate(cfg.layers, start=1):
        order = dplan.order_of(k)
        nbr_o, ctr_o = aggregate.plan_ordered(nbr[k], ctr[k], order)
        n_in = clouds.shape[1] if k == 1 else cfg.layers[k - 2].n_centers
        feats = torch.randn((clouds.shape[0], n_in, spec.in_features),
                            generator=g).cuda()
        out[k] = {"feats": feats, "nbr": nbr[k], "ctr": ctr[k],
                  "order": order,
                  "nbr_o": nbr_o.to(torch.int32).contiguous(),
                  "ctr_o": ctr_o.to(torch.int32).contiguous()}
    return out


def _gather_cases(models, clouds) -> tuple[dict, dict]:
    """K4 (batch 8) and K5 (batch 1, the first cloud) through the plan
    interface at model1's and model2's gathers, each bit for bit against
    the plain version over the indices in plan order."""
    from repro_torch.kernels import aggregate
    k4, k5 = {}, {}
    for name in ("model1", "model2"):
        for layer, c in _gather_inputs(models[name], clouds).items():
            one = {key: v[:1] for key, v in c.items()}
            got = aggregate.aggregate_diff_cuda(c["feats"], c["nbr"],
                                                c["ctr"], c["order"])
            want = aggregate.aggregate_diff_batched_plain(
                c["feats"], c["nbr_o"], c["ctr_o"])
            got1 = aggregate.aggregate_diff_cuda(
                one["feats"], one["nbr"], one["ctr"], one["order"],
                counter="aggregate_diff")
            want1 = aggregate.aggregate_diff_plain(
                c["feats"][0], c["nbr_o"][0], c["ctr_o"][0])
            torch.cuda.synchronize()
            key = f"{name} sa{layer}"
            check(torch.equal(got, want), f"K4 {key} bitwise")
            check(torch.equal(got1[0], want1), f"K5 {key} bitwise")
            k4[key] = {"inputs": c, "max_abs_err":
                       float((got - want).abs().max())}
            k5[key] = {"inputs": one,
                       "max_abs_err": float((got1[0] - want1).abs().max())}
    return k4, k5


def phase_kernel_vs_plain(models, clouds) -> dict:
    """Each kernel against its plain version: K1 at model1's MLPs, K4 and
    K5 (through the plan interface) at model1's and model2's gathers."""
    from repro_torch.kernels import fused_mlp
    progs = models["model1"].backend.program
    mlp_cases = {
        "sa1": (progs["sa"][0], 512 * 16),
        "sa2": (progs["sa"][1], 128 * 16),
        "head": (progs["head"], 1),
        "ragged": (_ragged_program(), 257),
    }
    k1 = {}
    for i, (name, (prog, m)) in enumerate(mlp_cases.items()):
        x_p, sx = _program_inputs(prog, m, SEED + 10 + i)
        relu = name != "head"
        got = fused_mlp.fused_mlp_cuda(x_p, sx, prog, m_real=m,
                                       final_relu=relu)
        want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                         final_relu=relu)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.isfinite(got).all().item(), f"K1 {name} finite")
        check(torch.equal(got, want), f"K1 {name} bitwise (max err {err})")
        k1[name] = {"shape": [BATCH, m, list(prog.widths)],
                    "max_abs_err": err, "x_p": x_p, "sx": sx, "prog": prog,
                    "m": m, "relu": relu,
                    "combine": _check_combine(prog, m, f"model1 {name}")}
    k4, k5 = _gather_cases(models, clouds)
    emit({"phase": "kernel_vs_plain", "tolerance": "bitwise",
          "K1": {n: {"shape": v["shape"], "max_abs_err": v["max_abs_err"],
                     "combine_max_abs_err": v["combine"]["max_abs_err"]}
                 for n, v in k1.items()},
          "K4": {l: {"shape": list(v["inputs"]["feats"].shape)
                     + list(v["inputs"]["nbr"].shape[1:]),
                     "max_abs_err": v["max_abs_err"]} for l, v in k4.items()},
          "K5": {l: {"max_abs_err": v["max_abs_err"]}
                 for l, v in k5.items()}})
    return {"K1": k1, "K4": k4, "K5": k5}


def reram_layer_shapes(params, cfg, batch: int) -> list:
    """``(rows, k, n)`` of every K6 matmul of one 'reram' call on
    ``batch`` clouds: each MLP layer over all its rows."""
    rows = [s.n_centers * s.n_neighbors for s in cfg.layers] + [1]
    return [(batch * r, *lyr["w"].shape)
            for mlp, r in zip(params["sa"] + [params["head"]], rows)
            for lyr in mlp]


def phase_model2_kernels(model2, params2) -> dict:
    """K1, K2 and K3 at each model2 MLP (batch 8), the ragged MLP and those
    of :data:`RANGE_MLPS`, each bit for bit against the plain version and
    against each other; K6 and its pre-pass at every layer shape of the
    model2 'reram' path (one ``batched_forward`` and one ``forward``) and
    at :data:`K6_EXTRA_SHAPES`, against their plain versions."""
    from repro_torch.kernels import (encode_planes, fused_mlp,
                                     quantize_tensor, ref_reram_matmul_int,
                                     reram_mlp)
    progs = model2.backend.program
    mlps = {}
    for i, (name, (prog, m)) in enumerate({
            "sa1": (progs["sa"][0], 512 * 16),
            "sa2": (progs["sa"][1], 128 * 16),
            "head": (progs["head"], 1),
            "ragged": (_ragged_program(), 257),
            **{n: (_ragged_program(w, SEED + 3), m)
               for n, (w, m) in RANGE_MLPS.items()}}.items()):
        x_p, sx = _program_inputs(prog, m, SEED + 20 + i)
        relu = name != "head"
        want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                         final_relu=relu)
        row = {"shape": [BATCH, m, list(prog.widths)], "x_p": x_p, "sx": sx,
               "prog": prog, "m": m, "relu": relu,
               "combine": _check_combine(prog, m, f"model2 {name}")}
        for mode in ("whole", "mtiled", "wstat"):
            got = fused_mlp.KERNEL_OF_MODE[mode](x_p, sx, prog, m_real=m,
                                                 final_relu=relu)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()), f"{mode} {name} finite")
            check(torch.equal(got, want),
                  f"{mode} {name} bitwise vs plain (max err {err})")
            row[f"{mode}_max_abs_err"] = err
        mlps[name] = row
    k6 = []
    g = torch.Generator(device="cpu").manual_seed(SEED + 30)
    layers = [lyr for mlp in params2["sa"] + [params2["head"]] for lyr in mlp]
    shapes = reram_layer_shapes(params2, model2.config, BATCH)
    path = shapes + reram_layer_shapes(params2, model2.config, 1)
    for i, (m, k, n) in enumerate(path + list(K6_EXTRA_SHAPES)):
        if i < len(path):
            w = quantize_tensor(layers[i % len(layers)]["w"])[0]
        else:
            w = torch.randint(-128, 128, (k, n), generator=g)
        planes = encode_planes(w).cuda()
        x = torch.randint(-128, 128, (m, k), generator=g,
                          dtype=torch.int8).cuda()
        got = reram_mlp.reram_matmul_int_cuda(x, planes)
        want = ref_reram_matmul_int(x, planes)
        wt = reram_mlp.reram_combine_cuda(planes)
        wt_want = reram_mlp.reram_combine_plain(planes)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K6 {m}x{k}x{n} bitwise vs plain")
        check(torch.equal(wt, wt_want), f"K6 pre-pass {k}x{n} bitwise")
        k6.append({"shape": [m, k, n], "x": x, "planes": planes,
                   "batched": i < len(shapes),
                   "max_abs_err": float((got - want).abs().max()),
                   "combine_max_abs_err": int((wt.int() - wt_want.int())
                                              .abs().max())})
    emit({"phase": "kernel_vs_plain_model2", "tolerance": "bitwise",
          "fused_mlp": {n: {"shape": v["shape"],
                            **{f"{md}_max_abs_err": v[f"{md}_max_abs_err"]
                               for md in ("whole", "mtiled", "wstat")},
                            "combine_max_abs_err":
                                v["combine"]["max_abs_err"]}
                        for n, v in mlps.items()},
          "K6": [{"shape": c["shape"], "max_abs_err": c["max_abs_err"],
                  "combine_max_abs_err": c["combine_max_abs_err"]}
                 for c in k6]})
    return {"mlps": mlps, "K6": k6}


def _fps_cases(clouds_np) -> dict:
    """K7's inputs: the two FPS calls of the main path (SA-1 over the
    clouds, SA-2 over the 512 points SA-1 selected) and SA-1 of
    ``forward``, a ragged cloud with pad rows, clouds with exact ties, a
    cloud with a NaN coordinate, and clouds past one block (a cluster) and
    past a cluster's registers (streamed)."""
    from repro_torch.kernels.fps_update import fps_batched_plain
    from repro_torch.models.pointnet2 import gather_rows
    sa1 = torch.from_numpy(clouds_np).cuda()
    sa2 = gather_rows(sa1, fps_batched_plain(sa1, 512)).contiguous()
    rng = np.random.default_rng(SEED + 40)
    grid = np.stack(np.meshgrid(*[np.arange(11.0)] * 3),
                    -1).reshape(-1, 3)[:1000]
    dup = rng.normal(size=(2, 1024, 3))
    dup[:, 512:] = dup[:, :512]
    # a NaN, a negative NaN and a NaN with a payload
    nan = rng.normal(size=(2, 1024, 3)).astype(np.float32)
    nan[0, 341, 1] = np.nan
    nan[1, 200, 2] = -np.float32(np.nan)
    nan[1, 700, 0] = np.array([0x7F812345], np.uint32).view(np.float32)[0]

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    return {
        "sa1": (sa1, 512, 0, None), "sa2": (sa2, 128, 0, None),
        "sa1_forward": (sa1[:1].contiguous(), 512, 0, None),
        "ragged": (card(rng.normal(size=(3, 1000, 3))), 300, 3,
                   torch.tensor([1000, 993, 611], device="cuda")),
        "grid": (card(np.stack([grid, grid + 1.0])), 400, 0, None),
        "duplicated": (card(dup), 600, 5,
                       torch.tensor([1024, 900], device="cuda")),
        "nan": (card(nan), 300, 0, None),
        "n16385": (card(rng.normal(size=(2, 16385, 3))), 1024, 0, None),
        "n65536": (card(rng.normal(size=(1, 65536, 3))), 256, 0, None),
        "n131072": (card(rng.normal(size=(1, 131072, 3))), 256, 0, None),
        "n300000": (card(rng.normal(size=(1, 300000, 3))), 64, 0, None)}


#: The cases every tier runs pinned, bit for bit against the plain loop.
FPS_TIER_CASES = ("sa1", "sa2", "sa1_forward", "ragged", "nan")

#: The clouds past one block, each under the streamed tier pinned (8 and
#: 16 blocks of 1024 threads) beside ``plan_fps``'s plan.
FPS_LARGE_CASES = ("n16385", "n65536", "n131072", "n300000")


def fps_streamed_plans(n: int) -> dict:
    """The streamed tier over 8 and 16 blocks for a cloud of ``n``
    points: what the cluster tier is held and timed against past one
    block."""
    from repro_torch.kernels.fps_update import FpsPlan
    return {f"streamed{c}": FpsPlan("streamed", 1024, -(-n // (1024 * c)), c)
            for c in (8, 16)}


def _bind_fps_chain(lib) -> None:
    """Type ``fps_chain_run``: 3 pointers, batch, N and samples as int64,
    tier, threads, points a thread and cluster as int, the stream."""
    import ctypes
    f = lib.fps_chain_run
    f.restype = ctypes.c_int
    f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def fps_chain(pts, n_samples: int, plan=None):
    """``fps_chain_run`` of ``csrc/fps.cu``: the loop kernel under
    ``plan`` (``plan_fps``'s where None) with the relaxation left out, so
    a step is the chain of reductions, the barrier and the center's
    broadcast alone. Its indices mean nothing; no launch counter moves.
    The library does not bind it: it is this script's measurement."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fps_update import (FPS_TIERS, check_plan,
                                                plan_fps)
    batch, n, _ = pts.shape
    if plan is None:
        plan = plan_fps(batch, n, _build.sm_count(pts))
    check_plan(plan, n)
    lib = _build.library("fps")
    _bind_fps_chain(lib)
    out = torch.empty((batch, n_samples), dtype=torch.int64,
                      device=pts.device)
    dist = (torch.empty((batch, n), dtype=torch.float32, device=pts.device)
            if plan.tier == "streamed" else None)
    err = lib.fps_chain_run(
        pts.data_ptr(), out.data_ptr(),
        None if dist is None else dist.data_ptr(), batch, n, n_samples,
        FPS_TIERS.index(plan.tier), plan.threads, plan.per_thread,
        plan.cluster, _build.stream_of(pts))
    check(err == 0, f"fps_chain_run under {plan}: CUDA error {err}")
    return out


def fps_tier_plans(n: int) -> dict:
    """K7's plans for a cloud of ``n`` <= 1024 points: the block tier at
    128, 256 and 512 threads, the cluster tier over 2 and 8 blocks of 128
    threads, and the streamed tier over 2 blocks of 1024; each register
    tier at the fewest points a thread (a power of two) that hold the
    cloud."""
    from repro_torch.kernels.fps_update import FpsPlan

    def per(threads):
        return 1 << (-(-n // threads) - 1).bit_length()
    plans = {f"block{t}": FpsPlan("block", t, per(t), 1)
             for t in (128, 256, 512)}
    for c in (2, 8):
        plans[f"cluster{c}"] = FpsPlan("cluster", 128, per(128 * c), c)
    plans["streamed"] = FpsPlan("streamed", 1024, per(2048), 2)
    return plans


def phase_fps_vs_plain(clouds_np) -> dict:
    """K7 against its plain versions, bit for bit: the loop kernel under
    ``plan_fps``'s plan at every case of :func:`_fps_cases`, under every
    plan of :func:`fps_tier_plans` at the cases of
    :data:`FPS_TIER_CASES` and of :func:`fps_streamed_plans` at
    :data:`FPS_LARGE_CASES`, and the step kernel over the first 8 steps of
    FPS on the first cloud of each case."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fps_update import (
        fps_batched_cuda, fps_batched_plain, fps_update_cuda,
        fps_update_plain, plan_fps)
    cases = _fps_cases(clouds_np)
    out = {}
    for name, (pts, n_samples, start, nv) in cases.items():
        want = fps_batched_plain(pts, n_samples, start, nv)
        plans = {"chosen": None}
        if name in FPS_TIER_CASES:
            plans.update(fps_tier_plans(pts.shape[1]))
        if name in FPS_LARGE_CASES:
            plans.update(fps_streamed_plans(pts.shape[1]))
        errs = {}
        for label, plan in plans.items():
            got = fps_batched_cuda(pts, n_samples, start, nv, plan=plan)
            torch.cuda.synchronize()
            errs[label] = int((got - want).abs().max())
            check(torch.equal(got, want), f"K7 fps {name} under {label} "
                                          f"bitwise (max err "
                                          f"{errs[label]})")
            if nv is not None:
                check(bool((got < nv[:, None]).all()), f"K7 {name} pads")
        p_t = pts[0].T.contiguous()
        dist = torch.full((1, pts.shape[1]), float("inf"), device="cuda")
        step_err = 0.0
        for i in range(8):
            c = p_t[:, int(want[0, i]):int(want[0, i]) + 1].contiguous()
            d_got = fps_update_cuda(p_t, c, dist)
            dist = fps_update_plain(p_t, c, dist)
            torch.cuda.synchronize()
            # NaN where the plain step has NaN (the NaN cloud), equal
            # elsewhere
            nan = torch.isnan(dist)
            check(torch.equal(torch.isnan(d_got), nan)
                  and torch.equal(d_got[~nan], dist[~nan]),
                  f"K7 fps_update {name} step {i} bitwise")
            if bool((~nan).any()):
                step_err = max(step_err, float(
                    (d_got[~nan] - dist[~nan]).abs().max()))
        chosen = plan_fps(pts.shape[0], pts.shape[1], _build.sm_count(pts))
        out[name] = {"shape": list(pts.shape), "n_samples": n_samples,
                     "start": start, "n_valid": None if nv is None
                     else nv.tolist(), "chosen": chosen.__dict__,
                     "max_abs_err": max(errs.values()),
                     "max_abs_err_by_plan": errs,
                     "step_max_abs_err": step_err}
    emit({"phase": "kernel_vs_plain_fps", "tolerance": "bitwise",
          "K7": out})
    return {"cases": cases, "errors": out}


def _cloud_kinds(seed: int) -> dict:
    """1024-point clouds whose plans are full of exact ties: tight clusters
    (as the JAX package's device-planning tests make them), an integer
    grid, and every point four times."""
    rng = np.random.default_rng(seed)
    ctrs = rng.normal(size=(128, 3)) * 4.0
    clustered = (ctrs[rng.integers(0, 128, size=1024)]
                 + 0.25 * rng.normal(size=(1024, 3)))
    grid = np.stack(np.meshgrid(*[np.arange(11)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:1024]
    dup = np.repeat(rng.normal(size=(256, 3)), 4, axis=0)
    return {k: np.stack([v] * 2).astype(np.float32) for k, v in
            (("clustered", clustered), ("grid", grid), ("dup", dup))}


def _oracle_plan(cfg, pts_last: np.ndarray, nbrs) -> list:
    """The NumPy planner's completed orders of one cloud: the greedy chain
    over the last layer's float32 points, then the recursive walk."""
    from repro_torch.core import schedule as sched
    from repro_torch.core.workload import PointNetWorkload
    last = sched.greedy_nn_order(pts_last)
    sizes = [cfg.n_points] + [nb.shape[0] for nb in nbrs]
    wl = PointNetWorkload(config=cfg, points=[np.zeros((n, 3))
                                              for n in sizes],
                          centers=[None] * len(sizes),
                          neighbors=[None] + list(nbrs))
    plan = sched.coordinate_layers(wl, last)
    return [sched.complete_order(plan.order_of(k), nb.shape[0], k)
            for k, nb in enumerate(nbrs, start=1)]


def phase_plan_vs_plain(models, clouds_np) -> dict:
    """P1 and P2 on the card, bit for bit, against their plain versions run
    on the CPU and against the NumPy planner: P1 at the main path's 8 x 128
    and 1 x 128 last layers and at 2048 points; P2 at the main path's 8 x
    (128 x 16 -> 512) walk; both on clustered, grid and duplicated clouds
    through model1's geometry."""
    from repro_torch.core.schedule import device_build_plan, greedy_nn_order
    from repro_torch.kernels import plan_order
    from repro_torch.models import pointnet2 as pn
    cfg = models["model1"].config
    sets = {"main": clouds_np, **_cloud_kinds(SEED + 5)}
    p1, p2, cases = {}, {}, {}
    errors = {"P1": 0, "P2": 0}

    def err(got, want):
        return int((got.cpu().long() - want.long()).abs().max())
    for name, cl in sets.items():
        pts, _, nbr = pn.geometry_pass(cfg, torch.from_numpy(cl).cuda())
        last = plan_order.plan_greedy_cuda(pts[-1])
        orders, inverses = plan_order.plan_coordinate_cuda(nbr[1:], last)
        torch.cuda.synchronize()
        cpu_last = plan_order.plan_greedy_plain(pts[-1].cpu())
        cpu_o, cpu_i = plan_order.plan_coordinate_plain(
            [nb.cpu() for nb in nbr[1:]], cpu_last)
        errors["P1"] = max(errors["P1"], err(last, cpu_last))
        errors["P2"] = max([errors["P2"]] + [
            err(a, b) for a, b in zip(orders + inverses, cpu_o + cpu_i)])
        check(torch.equal(last.cpu(), cpu_last), f"P1 {name} bitwise")
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip(orders + inverses, cpu_o + cpu_i)),
              f"P2 {name} bitwise")
        host_pts = pts[-1].cpu().numpy()
        host_nbr = [nb.cpu().numpy() for nb in nbr[1:]]
        for b in range(cl.shape[0]):
            want = _oracle_plan(cfg, host_pts[b], [nb[b] for nb in host_nbr])
            check(np.array_equal(orders[-1][b].cpu().numpy(), want[-1]),
                  f"P1 {name} cloud {b} vs the NumPy planner")
            check(all(np.array_equal(o[b].cpu().numpy(), w)
                      for o, w in zip(orders, want)),
                  f"P2 {name} cloud {b} vs the NumPy planner")
        plan = device_build_plan(nbr[1:], pts[-1], intra="greedy",
                                 coordinated=True)
        check(all(torch.equal(plan.order_of(k), orders[k - 1])
                  for k in (1, 2)), f"device_build_plan {name}")
        p1[name] = list(pts[-1].shape)
        p2[name] = [list(nb.shape) for nb in nbr[1:]]
        if name == "main":
            cases["p1"] = pts[-1].contiguous()
            cases["p2"] = (list(nbr[1:]), last)
    # the forward's one cloud, and the most points one block holds
    big = torch.from_numpy(np.random.default_rng(SEED + 6).normal(
        size=(1, 2048, 3)).astype(np.float32)).cuda()
    for name, pts in (("forward", cases["p1"][:1].contiguous()),
                      ("n2048", big)):
        got = plan_order.plan_greedy_cuda(pts)
        torch.cuda.synchronize()
        want = plan_order.plan_greedy_plain(pts.cpu())
        errors["P1"] = max(errors["P1"], err(got, want))
        check(torch.equal(got.cpu(), want), f"P1 {name} bitwise")
        check(np.array_equal(got[0].cpu().numpy(),
                             greedy_nn_order(pts[0].cpu().numpy())),
              f"P1 {name} vs the NumPy planner")
        p1[name] = list(pts.shape)
    cases["p1_forward"] = cases["p1"][:1].contiguous()
    cases["p1_2048"] = big
    cases["errors"] = errors
    emit({"phase": "kernel_vs_plain_plan", "tolerance": "bitwise",
          "against": ["plain version on the CPU", "NumPy planner"],
          "P1": p1, "P2": p2, "max_abs_err": errors})
    return cases


def run_main_path(model, clouds) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One ``batched_forward`` and one ``forward``, launch counters reset
    just before and read just after."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    logits = model.batched_forward(clouds)
    single = model.forward(clouds[0])
    torch.cuda.synchronize()
    return launch_counts(), logits, single


#: Backends driven end to end, per model, and the MLP launches each path
#: must count in one ``batched_forward`` (batch 8) plus one ``forward``
#: (batch 1) (beside one gather and one FPS launch per SA layer and pass,
#: and one P1 and one P2 launch per pass). 'reram-fused' runs the Hopper
#: choice (``PlanPolicy.select_launch``): on model2 K3 ('wstat') for every
#: MLP; on model1 K3 but at SA-1 of ``forward`` (K1, 'whole'); on model0
#: K1 at both SA layers and K3 at the head. 'reram-fused-mtiled' pins K2
#: for every MLP; each K1, K2 or K3 call launches the s8 weight pre-pass
#: once (``fused_mlp_combine``) and one launch per layer; the per-layer
#: 'reram' backend launches K6 and its pre-pass once per layer, 8 layers.
PATHS = {
    "model2": {"reram-fused": {"fused_mlp_wstat": 6,
                               "fused_mlp_wstat_layer": 16,
                               "fused_mlp_combine": 6},
               "reram-fused-mtiled": {"fused_mlp_mtiled": 6,
                                      "fused_mlp_mtiled_layer": 16,
                                      "fused_mlp_combine": 6},
               "reram": {"reram_matmul_int": 16, "reram_combine": 16},
               # the served path (phase ``serve``): one served step is one
               # ``batched_forward`` under a stacked plan, per batch
               # bucket (K3 for every MLP at every bucket), and its
               # captures and plan builds set how many steps a run makes
               "serve": {b: {"fused_mlp_wstat": 3,
                             "fused_mlp_wstat_layer": 8,
                             "fused_mlp_combine": 3} for b in (1, 2, 4, 8)}},
    "model1": {"reram-fused": {"fused_mlp": 1, "fused_mlp_layer": 3,
                               "fused_mlp_wstat": 5,
                               "fused_mlp_wstat_layer": 13,
                               "fused_mlp_combine": 6}, "float": {}},
    "model0": {"reram-fused": {"fused_mlp": 4, "fused_mlp_layer": 12,
                               "fused_mlp_wstat": 2,
                               "fused_mlp_wstat_layer": 4,
                               "fused_mlp_combine": 6}, "float": {}},
}
MLP_COUNTERS = ("fused_mlp", "fused_mlp_layer", "fused_mlp_mtiled",
                "fused_mlp_mtiled_layer", "fused_mlp_wstat",
                "fused_mlp_wstat_layer", "fused_mlp_combine",
                "reram_matmul_int", "reram_combine")

#: The port's kernels by the names ``torch.profiler`` gives them.
PORT_KERNELS = ("fused_mlp_", "wstat_", "combine_", "aggregate_diff",
                "reram_matmul", "fps_", "greedy_kernel", "coordinate_kernel",
                "gather_rows_backward_kernel")

#: Kernels a captured ``batched_forward`` under the 'pointer' schedule must
#: replay: FPS, P1, P2 and the gather.
CAPTURED_KERNELS = ("fps_loop_kernel", "greedy_kernel", "coordinate_kernel",
                    "aggregate_diff_kernel")


def _captured_kernels(model, clouds) -> dict:
    """Kernel launches by name in one replay of ``model``'s captured
    ``batched_forward`` (``torch.profiler`` over the replay: the launch
    counters move while a graph is captured, not when it is replayed)."""
    model.jit_batched_forward(clouds)
    torch.cuda.synchronize()
    rows = _device_rows(lambda: model.jit_batched_forward(clouds))
    return {"kernel_launches": sum(r["count"] for r in rows),
            "device_ms": sum(r["device_ms"] for r in rows),
            "port_kernels": {r["kernel"]: r["count"]
                             for r in _port_rows(rows)}}


def phase_end_to_end(params, cfgs, clouds_np) -> dict:
    """Every path of :data:`PATHS` under the default, planning on the card;
    returns the launch counts of each. Per path: the launches; logits and
    geometry against the port's CPU run; the crossbar backends' logits bit
    for bit against the same model planning on the host; and the captured
    entry points bit for bit against eager calls, over two replays on
    different clouds."""
    import repro_torch
    from repro_torch.models import pointnet2 as pn
    clouds = torch.from_numpy(clouds_np).cuda()
    others = torch.from_numpy(make_clouds(1024, BATCH, SEED + 7)).cuda()
    results, counts_of = {}, {}
    for name, cfg in cfgs.items():
        L = cfg.n_layers
        ref_geom = pn.geometry_pass(cfg, torch.from_numpy(clouds_np[:2]))
        geom = pn.geometry_pass(cfg, clouds[:2])
        for k in range(1, L + 1):
            for part in (1, 2):
                check(torch.equal(geom[part][k].cpu(), ref_geom[part][k]),
                      f"{name} geometry layer {k} bitwise card vs CPU")
        for backend, mlp_counts in PATHS[name].items():
            if backend == "serve":          # driven by phase_serve
                continue
            model = repro_torch.compile_model(params[name], cfg,
                                              backend=backend,
                                              schedule="pointer")
            check(model.device_planning, f"{name}/{backend} plans on the "
                                         f"card by default")
            counts, logits, single = run_main_path(model, clouds)
            quantized = backend != "float"
            want = {"aggregate_diff_batched": L, "aggregate_diff": L,
                    "fps": 2 * L, "fps_update": 0, "plan_greedy": 2,
                    "plan_coordinate": 2,
                    **{c: mlp_counts.get(c, 0) for c in MLP_COUNTERS}}
            for key, n in want.items():
                check(counts[key] == n,
                      f"{name}/{backend}: {key} launched {counts[key]} "
                      f"times, expected {n}")
            counts_of[f"{name}/{backend}"] = counts
            host = repro_torch.compile_model(params[name], cfg,
                                             backend=backend,
                                             schedule="pointer",
                                             device_planning=False)
            host_logits = host.batched_forward(clouds)
            host_single = host.forward(clouds[0])
            host_equal = (torch.equal(host_logits, logits)
                          and torch.equal(host_single, single))
            if quantized:
                check(host_equal, f"{name}/{backend}: device-planned "
                                  f"logits != host-planned")
            replays = [model.jit_batched_forward(clouds),
                       model.jit_batched_forward(others)]
            eager_others = model.batched_forward(others)
            check(torch.equal(replays[0], logits)
                  and torch.equal(replays[1], eager_others),
                  f"{name}/{backend}: captured batched_forward != eager")
            check(torch.equal(model.jit_forward(clouds[0]), single),
                  f"{name}/{backend}: captured forward != eager")
            captured = _captured_kernels(model, clouds)
            for kname in CAPTURED_KERNELS:
                check(any(kname in k for k in captured["port_kernels"]),
                      f"{name}/{backend}: {kname} not in the captured "
                      f"call's replay")
            cpu = repro_torch.compile_model(params[name], cfg,
                                            backend=backend,
                                            schedule="pointer", device="cpu")
            ref = cpu.batched_forward(clouds_np[:2])
            got = logits[:2].cpu()
            # card vs CPU: lift_features' sin/cos may differ by an ulp,
            # which can move one requantized value by one step (the
            # crossbar backends); the float matmuls sum in another order
            # ('float')
            rel = 1e-2 if quantized else 1e-3
            tol = rel * float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(bool(torch.isfinite(logits).all()), f"{name} finite")
            check(tuple(logits.shape) == (BATCH, 40), f"{name} shape")
            check(err <= tol, f"{name}/{backend} card vs CPU err {err} > "
                              f"{tol}")
            check(torch.equal(got.argmax(1), ref.argmax(1)),
                  f"{name}/{backend} argmax card vs CPU")
            single_err = float((single.cpu() - logits[0].cpu()).abs().max())
            if quantized:
                check(single_err == 0.0, f"{name}/{backend}: forward != "
                                         f"batched_forward row 0")
            results[f"{name}/{backend}"] = {
                "launches": counts, "cpu_max_abs_err": err,
                "tolerance": tol, "forward_vs_batched_err": single_err,
                "device_vs_host_planned_bitwise": host_equal,
                "captured_vs_eager_bitwise": True,
                "captured_replay": captured,
                "argmax": logits.argmax(1).tolist()}
    emit({"phase": "end_to_end", "batch": BATCH, "results": results})
    return counts_of


def _int_mm_run(pairs):
    """A function that runs torch._int_mm over int8 ``(x, w)`` pairs, one
    call each, rows padded up to its minimum of 32 and widths up to
    multiples of 8."""
    mats = []
    for x, w in pairs:
        x = torch.nn.functional.pad(x, (0, -x.shape[1] % 8,
                                        0, max(0, 32 - x.shape[0])))
        w = torch.nn.functional.pad(w, (0, -w.shape[1] % 8,
                                        0, -w.shape[0] % 8))
        mats.append((x.contiguous(), w.contiguous()))

    def run():
        for x, w in mats:
            torch._int_mm(x, w)
    return run


def _int_mm_ms(pairs) -> float:
    return cuda_ms(_int_mm_run(pairs))


def _k1_library(prog, m: int):
    """torch._int_mm over the MLP's integer products (signed int8
    weights): the library yardstick for the fused MLP's integer product
    alone, no quantize/dequant."""
    ws = [w.to(torch.int8) for w in prog.int_weights()]
    return _int_mm_run([(torch.randint(-127, 128, (BATCH * m, w.shape[0]),
                                       dtype=torch.int8, device="cuda"), w)
                        for w in ws])


def _device_ms(fn, calls: int = 5) -> float:
    """Device time of one call of ``fn``, summed over its kernels by
    ``torch.profiler`` over ``calls`` calls and divided by them: where a
    call is too short to keep the card busy, the CUDA-event time of
    back-to-back calls measures the host. A session that records no
    kernel at all (seen once for a 2 µs launch) is profiled again, up to
    three times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        rows = _device_rows(fn, calls)
        if rows:
            break
    return sum(r["device_ms"] for r in rows) / calls


def _k1_bound(prog, m: int):
    """Bytes and int8 operations of one batched MLP call at its real
    widths: the int8 input rows, one int8 weight per real weight (the four
    2-bit planes hold 8 bits), the real-width bias and column mask, the
    weight and input scales, and the float32 output. Padding is no part of
    the function, so none of it is counted."""
    w = prog.widths
    n_weights = sum(a * b for a, b in zip(w[:-1], w[1:]))
    nbytes = (BATCH * m * w[0]                     # int8 input rows
              + n_weights                          # int8 weights
              + 4 * (2 * sum(w[1:])                # bias, column mask
                     + prog.n_layers + BATCH)      # w_scale, input scales
              + 4 * BATCH * m * w[-1])             # float32 output
    return nbytes, 2 * BATCH * m * n_weights


def _gather_bound(feats, nbr, ctr, order=None):
    """Bytes and float32 subtractions of one gather: the feature rows the
    indices refer to (each read once), the indices (at their own width)
    and the plan order, and the output."""
    b, m, k = nbr.shape
    c = feats.shape[2]
    rows = sum(int(torch.unique(torch.cat((nbr[i].reshape(-1),
                                           ctr[i]))).numel())
               for i in range(b))
    nbytes = (4 * rows * c + nbr.element_size() * b * m * k
              + ctr.element_size() * b * m + 4 * b * m * k * c
              + (0 if order is None else 4 * b * m))
    return nbytes, b * m * k * c


def _gather_library(feats, nbr, ctr):
    """index_select twice + one subtraction over flattened rows."""
    b, n, c = feats.shape
    flat = feats.reshape(b * n, c)
    base = (torch.arange(b, device=feats.device) * n)
    nbr_g = (nbr.long() + base[:, None, None]).reshape(-1)
    ctr_g = (ctr.long() + base[:, None]).reshape(-1)
    shape = tuple(nbr.shape) + (c,)

    def run():
        return (torch.index_select(flat, 0, nbr_g).view(shape)
                - torch.index_select(flat, 0, ctr_g).view(*shape[:2], 1, c))
    return run


def _model2_fused_rows(cases2, counts_of) -> list:
    """K2 at model2 SA-1 (launches: the 'reram-fused-mtiled' path's) and
    K3 at SA-2 (launches: the main path's), and K1, K2 and K3 side by side
    at each model2 MLP (batch 8) beside the TPU's and the Hopper
    choice."""
    from repro_torch.core.policy import DEFAULT_POLICY
    from repro_torch.kernels import fused_mlp, plan_fused_mlp
    per_mlp = {}
    for name in ("sa1", "sa2", "head"):
        c = cases2["mlps"][name]
        x_p, sx, prog, m, relu = c["x_p"], c["sx"], c["prog"], c["m"], c["relu"]
        row = {"tpu_choice": plan_fused_mlp(prog, m).mode,
               "hopper_choice": DEFAULT_POLICY.select_launch(
                   prog, m, batch=BATCH).mode}
        for mode in ("whole", "mtiled", "wstat"):
            kernel = fused_mlp.KERNEL_OF_MODE[mode]
            row[f"{mode}_ms"] = cuda_ms(lambda: kernel(
                x_p, sx, prog, m_real=m, final_relu=relu))
            row[f"{mode}_device_ms"] = _device_ms(lambda: kernel(
                x_p, sx, prog, m_real=m, final_relu=relu))
        row["plain_ms"] = cuda_ms(lambda: fused_mlp.fused_mlp_plain(
            x_p, sx, prog, m_real=m, final_relu=relu), iters=5)
        lib = _k1_library(prog, m)
        row["library_ms"] = cuda_ms(lib)
        row["library_device_ms"] = _device_ms(lib)
        row["bound_ms"], row["bound_by"] = bound(*_k1_bound(prog, m),
                                                 INT8_OPS_PER_S)
        per_mlp[name] = row
    rows = []
    for kname, mode, mlp, source, line, path in (
            ("K2 fused_mlp_mtiled", "mtiled", "sa1", "fused_mlp_mtiled.cu",
             360, "model2/reram-fused-mtiled"),
            ("K3 fused_mlp_wstat", "wstat", "sa2", "fused_mlp_wstat.cu",
             330, "model2/reram-fused")):
        r, counts = per_mlp[mlp], counts_of[path]
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/fused_mlp.py:{line}",
            "launches": counts[f"fused_mlp_{mode}"],
            "layer_launches": counts[f"fused_mlp_{mode}_layer"],
            "launches_on": path,
            "max_abs_err": max(v[f"{mode}_max_abs_err"]
                               for v in cases2["mlps"].values()),
            "ms": r[f"{mode}_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": "torch._int_mm per layer (integer product only)",
            "work": f"model2 {mlp.upper().replace('SA', 'SA-')} MLP, "
                    f"batch 8",
            "device_ms": r[f"{mode}_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "model2_mlps": per_mlp})
    return rows


def _combine_row(cases, counts_main) -> dict:
    """The s8 weight pre-pass of K1/K2/K3 at model1's three MLPs (one
    launch each, as one model1 ``batched_forward`` runs it)."""
    from repro_torch.kernels import fused_mlp
    from repro_torch.kernels.program import combine_bytes
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0}
    for name in ("sa1", "sa2", "head"):
        c = cases["K1"][name]["combine"]
        prog, geom = c["prog"], c["geom"]
        tot["ms"] += cuda_ms(lambda: fused_mlp.combine_weights_cuda(prog,
                                                                    geom))
        tot["plain_ms"] += cuda_ms(lambda: fused_mlp.combine_weights_plain(
            prog, geom), iters=5)
        tot["bytes"] += combine_bytes(prog, geom)
    bms, bby = bound(tot["bytes"], 0, INT8_OPS_PER_S)
    return {
        "name": "K1/K2/K3 combine_weights (s8 pre-pass)", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:94",
        "launches": counts_main["fused_mlp_combine"],
        "max_abs_err": max(cases["K1"][n]["combine"]["max_abs_err"]
                           for n in cases["K1"]),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": bms,
        "bound_by": bby, "library_ms": None,
        "library_call": "none (no one PyTorch call shifts, adds and "
                        "transposes the planes into s8)",
        "work": "the planes of model1's three MLPs into s8 weights, one "
                "launch each (part of every K1/K2/K3 call)"}


def _k6_bound(m: int, k: int, n: int):
    """Bytes and int8 operations of one K6 product: the int8 rows, one
    int8 weight per real weight (the four 2-bit planes hold 8 bits) and
    the int32 output."""
    return m * k + k * n + 4 * m * n, 2 * m * k * n


def _k6_rows(cases2, counts_of) -> list:
    """K6 over the 8 layer products of one model2 'reram'
    ``batched_forward`` (its pre-pass included), and its pre-pass alone
    over the same 8 layers' planes."""
    from repro_torch.kernels import combine_planes, ref_reram_matmul_int
    from repro_torch.kernels import reram_mlp
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms")
    tot = dict.fromkeys(keys, 0.0) | {"bytes": 0, "ops": 0}
    pre = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "bytes": 0}
    per_layer = []
    for c in cases2["K6"]:
        if not c["batched"]:
            continue
        x, planes = c["x"], c["planes"]
        m, k, n = c["shape"]
        w = combine_planes(planes).to(torch.int8).contiguous()
        lib = _int_mm_run([(x, w)])
        row = {"shape": [m, k, n],
               "ms": cuda_ms(lambda: reram_mlp.reram_matmul_int_cuda(
                   x, planes)),
               "plain_ms": cuda_ms(lambda: ref_reram_matmul_int(x, planes)),
               "library_ms": cuda_ms(lib),
               "device_ms": _device_ms(lambda: reram_mlp.reram_matmul_int_cuda(
                   x, planes)),
               "library_device_ms": _device_ms(lib)}
        nbytes, ops = _k6_bound(m, k, n)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, INT8_OPS_PER_S)
        per_layer.append(row)
        for key in keys:
            tot[key] += row[key]
        tot["bytes"] += nbytes
        tot["ops"] += ops
        pre["ms"] += cuda_ms(lambda: reram_mlp.reram_combine_cuda(planes))
        pre["device_ms"] += _device_ms(
            lambda: reram_mlp.reram_combine_cuda(planes))
        pre["plain_ms"] += cuda_ms(
            lambda: reram_mlp.reram_combine_plain(planes))
        pre["bytes"] += (planes.shape[0] + 1) * k * n
    bms, bby = bound(tot["bytes"], tot["ops"], INT8_OPS_PER_S)
    pre_bms, pre_bby = bound(pre["bytes"], 0, INT8_OPS_PER_S)
    counts = counts_of["model2/reram"]
    return [{
        "name": "K6 reram_matmul_int", "route": "cuda",
        "source": "src/repro_torch/csrc/reram_mlp.cu",
        "replaces": "src/repro/kernels/reram_mlp.py:83",
        "launches": counts["reram_matmul_int"],
        "max_abs_err": max(c["max_abs_err"] for c in cases2["K6"]),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": bms,
        "bound_by": bby, "library_ms": tot["library_ms"],
        "library_call": "torch._int_mm per layer (same int8 product)",
        "work": "the 8 layer products of one model2 'reram' "
                "batched_forward, batch 8 (s8 pre-pass included)",
        "device_ms": tot["device_ms"],
        "library_device_ms": tot["library_device_ms"],
        "per_layer": per_layer}, {
        "name": "K6 reram_combine (s8 pre-pass)", "route": "cuda",
        "source": "src/repro_torch/csrc/reram_mlp.cu",
        "replaces": "src/repro/kernels/reram_mlp.py:48",
        "launches": counts["reram_combine"],
        "max_abs_err": max(c["combine_max_abs_err"] for c in cases2["K6"]),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"], "bound_ms": pre_bms,
        "bound_by": pre_bby, "library_ms": None,
        "library_call": "none (no one PyTorch call shifts, adds and "
                        "transposes the planes into s8)",
        "work": "the planes of the 8 layers of one model2 'reram' "
                "batched_forward into s8 weights, one launch each (part of "
                "every K6 call)",
        "device_ms": pre["device_ms"]}]


def _fps_bound(batch: int, n: int, n_samples: int):
    """Bytes and float32 operations of one FPS call: the float32 points
    read once and the int64 indices written once; per step and point 3
    subtractions, 3 multiplications, 2 additions and the minimum (the
    argmax's comparisons are not counted)."""
    return batch * n * 12 + batch * n_samples * 8, 9 * batch * n * n_samples


def _k7_tiers(fps_cases) -> dict:
    """Each plan of :func:`fps_tier_plans` at the main path's three FPS
    shapes: the loop's time and time per step, and the same loop with the
    relaxation left out (``chain_us_per_step``); and past one block,
    ``plan_fps``'s plan beside the streamed tier over 8 and 16 blocks at
    each cloud of :data:`FPS_LARGE_CASES`."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fps_update import fps_batched_cuda, plan_fps
    out = {}
    for name in ("sa1", "sa2", "sa1_forward"):
        pts, n_samples, _, _ = fps_cases["cases"][name]
        rows = {}
        for label, plan in fps_tier_plans(pts.shape[1]).items():
            ms = cuda_ms(lambda: fps_batched_cuda(pts, n_samples, plan=plan))
            chain = cuda_ms(lambda: fps_chain(pts, n_samples, plan))
            rows[label] = {"plan": vars(plan), "ms": ms,
                           "us_per_step": 1e3 * ms / n_samples,
                           "chain_us_per_step": 1e3 * chain / n_samples}
        out[f"{name} {list(pts.shape)} -> {n_samples}"] = rows
    # past one block: the chosen plan against the streamed tier
    for name in FPS_LARGE_CASES:
        pts, n_samples, _, _ = fps_cases["cases"][name]
        plans = {"chosen": plan_fps(pts.shape[0], pts.shape[1],
                                    _build.sm_count(pts)),
                 **fps_streamed_plans(pts.shape[1])}
        rows = {}
        for label, plan in plans.items():
            ms = cuda_ms(lambda: fps_batched_cuda(pts, n_samples, plan=plan),
                         iters=5, warmup=1)
            chain = cuda_ms(lambda: fps_chain(pts, n_samples, plan), iters=5,
                            warmup=1)
            rows[label] = {"plan": vars(plan), "ms": ms,
                           "us_per_step": 1e3 * ms / n_samples,
                           "chain_us_per_step": 1e3 * chain / n_samples}
        out[f"{name} {list(pts.shape)} -> {n_samples}"] = rows
    return out


def _k7_row(fps_cases, counts_of) -> dict:
    """K7 at the two FPS calls of one model1/model2 ``batched_forward``
    (8 x 1024 -> 512 and 8 x 512 -> 128) under ``plan_fps``'s plans, its
    single step beside it, and every tier at the main path's shapes."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fps_update import (
        fps_batched_cuda, fps_batched_plain, fps_update_cuda, fps_update_plain,
        plan_fps)
    per_layer, tot = {}, {"ms": 0.0, "plain_ms": 0.0, "chain_ms": 0.0,
                          "bytes": 0, "ops": 0}
    for name in ("sa1", "sa2"):
        pts, n_samples, _, _ = fps_cases["cases"][name]
        b, n, _ = pts.shape
        plan = plan_fps(b, n, _build.sm_count(pts))
        row = {"shape": [b, n, n_samples], "plan": vars(plan),
               "ms": cuda_ms(lambda: fps_batched_cuda(pts, n_samples)),
               "chain_ms": cuda_ms(lambda: fps_chain(pts, n_samples)),
               "plain_ms": cuda_ms(lambda: fps_batched_plain(pts, n_samples),
                                   iters=3, warmup=1),
               "device_ms": _device_ms(lambda: fps_batched_cuda(pts,
                                                                n_samples))}
        row["us_per_step"] = 1e3 * row["ms"] / n_samples
        row["chain_us_per_step"] = 1e3 * row["chain_ms"] / n_samples
        nbytes, ops = _fps_bound(b, n, n_samples)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, FP32_OPS_PER_S)
        per_layer[name] = row
        for key in ("ms", "plain_ms", "chain_ms"):
            tot[key] += row[key]
        tot["bytes"] += nbytes
        tot["ops"] += ops
    bms, bby = bound(tot["bytes"], tot["ops"], FP32_OPS_PER_S)
    # the single step at SA-1's width, over the 8 clouds' first steps
    pts = fps_cases["cases"]["sa1"][0]
    p_t = pts[0].T.contiguous()
    c = p_t[:, :1].contiguous()
    dist = torch.full((1, p_t.shape[1]), float("inf"), device="cuda")
    n = p_t.shape[1]
    step = {"shape": [3, n],
            "ms": cuda_ms(lambda: fps_update_cuda(p_t, c, dist)),
            "plain_ms": cuda_ms(lambda: fps_update_plain(p_t, c, dist))}
    step["bound_ms"], step["bound_by"] = bound(12 * n + 12 + 8 * n, 9 * n,
                                               FP32_OPS_PER_S)
    errors = fps_cases["errors"]
    steps = sum(per_layer[k]["shape"][2] for k in per_layer)
    return {
        "name": "K7 fps", "route": "cuda",
        "source": "src/repro_torch/csrc/fps.cu",
        "replaces": "src/repro/kernels/fps_update.py:34",
        "launches": counts_of["model1/reram-fused"]["fps"],
        "max_abs_err": max(max(e["max_abs_err"], e["step_max_abs_err"])
                           for e in errors.values()),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": bms,
        "bound_by": bby, "library_ms": None,
        "library_call": "none (no one PyTorch call computes FPS or a "
                        "relaxation step)",
        "work": "model1/model2 SA-1 + SA-2 FPS, batch 8: the whole "
                "sampling loop in one launch each",
        "tier": {k: per_layer[k]["plan"]["tier"] for k in per_layer},
        "us_per_step": 1e3 * tot["ms"] / steps,
        "chain_us_per_step": 1e3 * tot["chain_ms"] / steps,
        "device_ms": sum(per_layer[k]["device_ms"] for k in per_layer),
        "per_layer": per_layer, "tiers": _k7_tiers(fps_cases),
        "fps_update_step": step}


def _launch_floor() -> dict:
    """The card's launch floor: an empty kernel (``torch.cuda._sleep(0)``,
    a spin of no cycles), its device time from ``torch.profiler`` and its
    time on CUDA events."""
    return {"device_ms": _device_ms(lambda: torch.cuda._sleep(0)),
            "ms": cuda_ms(lambda: torch.cuda._sleep(0))}


def _gather_rows(cases, counts_main, floor: dict) -> list:
    """K4 and K5 through the plan interface at the two gathers of one
    model1 ``batched_forward`` / ``forward`` (model2's beside them): CUDA
    events and device time, the plain version, and the library's two
    ``index_select`` and subtraction on events and on the device."""
    from repro_torch.kernels import aggregate
    rows = []
    for kname, key, where, counter in (
            ("K4 aggregate_diff_batched", "K4", "aggregate.py:100",
             "aggregate_diff_batched"),
            ("K5 aggregate_diff", "K5", "aggregate.py:51",
             "aggregate_diff")):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "device_ms": 0.0, "library_device_ms": 0.0, "bytes": 0,
               "ops": 0}
        per_layer = {}
        for layer, c in cases[key].items():
            x = c["inputs"]
            run = (lambda: aggregate.aggregate_diff_cuda(
                x["feats"], x["nbr"], x["ctr"], x["order"], counter=counter))
            lib = _gather_library(x["feats"], x["nbr_o"], x["ctr_o"])
            row = {"ms": cuda_ms(run),
                   "plain_ms": cuda_ms(
                       lambda: aggregate.aggregate_diff_batched_plain(
                           x["feats"], x["nbr_o"], x["ctr_o"])),
                   "library_ms": cuda_ms(lib), "device_ms": _device_ms(run),
                   "library_device_ms": _device_ms(lib)}
            nbytes, ops = _gather_bound(x["feats"], x["nbr"], x["ctr"],
                                        x["order"])
            row["bound_ms"], row["bound_by"] = bound(nbytes, ops,
                                                     FP32_OPS_PER_S)
            per_layer[layer] = row
            if layer.startswith("model1"):
                for k in ("ms", "plain_ms", "library_ms", "device_ms",
                          "library_device_ms"):
                    tot[k] += row[k]
                tot["bytes"] += nbytes
                tot["ops"] += ops
        bms, bby = bound(tot["bytes"], tot["ops"], FP32_OPS_PER_S)
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/aggregate.cu",
            "replaces": f"src/repro/kernels/{where}",
            "launches": counts_main[counter],
            "max_abs_err": max(c["max_abs_err"] for c in cases[key].values()),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": bms,
            "bound_by": bby, "library_ms": tot["library_ms"],
            "library_call": "index_select x2 + sub over indices already in "
                            "plan order (no one-call library op)",
            "work": ("model1 SA-1 + SA-2 gathers in plan order, batch "
                     + ("8" if key == "K4" else "1")),
            "device_ms": tot["device_ms"],
            "library_device_ms": tot["library_device_ms"],
            "per_layer": per_layer})
    rows[-1]["launch_floor"] = floor                # beside K5's time
    return rows


def _p1_bound(batch: int, n: int):
    """Bytes and float32 operations of P1 over ``batch`` clouds of ``n``
    points: the points read once, the int32 order written once; per step
    (n - 1 of them) and point the squared distance, 3 subtractions, 3
    multiplications and 2 additions (the key and argmin not counted)."""
    return batch * n * 12 + batch * n * 4, 8 * batch * n * (n - 1)


def _p2_bound(nbrs, last):
    """Bytes of P2: the last order and the walked rows of each layer's
    receptive fields (int64; every row of the main path is walked) read
    once, an int32 order and inverse per layer written once. No float
    operation."""
    batch = last.shape[0]
    nbytes = last.numel() * last.element_size()
    nbytes += sum(batch * nb.shape[1] * nb.shape[2] * nb.element_size()
                  for nb in nbrs[1:])
    nbytes += sum(2 * 4 * batch * nb.shape[1] for nb in nbrs)
    return nbytes, 0


def _plan_rows(plan_cases, counts_main) -> list:
    """P1 and P2 at the main path's shapes (the plan of one batch-8
    ``batched_forward``), beside their bounds and launches; P1 also at the
    forward's one cloud and at 2048 points, per step."""
    from repro_torch.kernels import plan_order
    pts = plan_cases["p1"]
    b, n, _ = pts.shape
    p1 = {"ms": cuda_ms(lambda: plan_order.plan_greedy_cuda(pts)),
          "plain_ms": cuda_ms(lambda: plan_order.plan_greedy_plain(pts),
                              iters=3, warmup=1),
          "device_ms": _device_ms(lambda: plan_order.plan_greedy_cuda(pts))}
    p1["bound_ms"], p1["bound_by"] = bound(*_p1_bound(b, n), FP32_OPS_PER_S)
    p1["us_per_step"] = 1e3 * p1["device_ms"] / (n - 1)
    extra = {}
    for label, key in (("1x128 (forward)", "p1_forward"),
                       ("1x2048", "p1_2048")):
        x = plan_cases[key]
        dev = _device_ms(lambda: plan_order.plan_greedy_cuda(x))
        extra[label] = {"ms": cuda_ms(lambda: plan_order.plan_greedy_cuda(x),
                                      iters=5, warmup=1),
                        "device_ms": dev,
                        "us_per_step": 1e3 * dev / (x.shape[1] - 1),
                        "bound_ms": bound(*_p1_bound(1, x.shape[1]),
                                          FP32_OPS_PER_S)[0]}
    nbrs, last = plan_cases["p2"]
    p2 = {"ms": cuda_ms(lambda: plan_order.plan_coordinate_cuda(nbrs, last)),
          "plain_ms": cuda_ms(lambda: plan_order.plan_coordinate_plain(
              nbrs, last), iters=5, warmup=1),
          "device_ms": _device_ms(
              lambda: plan_order.plan_coordinate_cuda(nbrs, last))}
    p2["bound_ms"], p2["bound_by"] = bound(*_p2_bound(nbrs, last),
                                           FP32_OPS_PER_S)
    return [
        {"name": "P1 plan_greedy", "route": "cuda",
         "source": "src/repro_torch/csrc/plan.cu",
         "replaces": "src/repro/core/schedule.py:628 (device_order_greedy, "
                     "a lax.fori_loop; no pallas_call)",
         "launches": counts_main["plan_greedy"],
         "max_abs_err": plan_cases["errors"]["P1"],
         "ms": p1["ms"], "plain_ms": p1["plain_ms"],
         "bound_ms": p1["bound_ms"], "bound_by": p1["bound_by"],
         "library_ms": None,
         "library_call": "none (no one PyTorch call computes a greedy "
                         "nearest-neighbour chain)",
         "work": f"the greedy order of one batch-8 batched_forward "
                 f"({b} x {n} points)",
         "device_ms": p1["device_ms"], "us_per_step": p1["us_per_step"],
         "other_shapes": extra},
        {"name": "P2 plan_coordinate", "route": "cuda",
         "source": "src/repro_torch/csrc/plan.cu",
         "replaces": "src/repro/core/schedule.py:689 (device_coordinate, a "
                     "lax.scan/lax.cond walk; no pallas_call)",
         "launches": counts_main["plan_coordinate"],
         "max_abs_err": plan_cases["errors"]["P2"],
         "ms": p2["ms"], "plain_ms": p2["plain_ms"],
         "bound_ms": p2["bound_ms"], "bound_by": p2["bound_by"],
         "library_ms": None,
         "library_call": "none (no one PyTorch call computes the walk)",
         "work": f"the coordination walk of one batch-8 batched_forward "
                 f"({last.shape[0]} x ({list(nbrs[-1].shape[1:])} -> "
                 f"{nbrs[0].shape[1]}))",
         "device_ms": p2["device_ms"]}]


def _wall_ms(fn, n: int = 5) -> list:
    """Host-clock times of ``n`` calls of ``fn``, each ended by a
    synchronize, after one call of warm-up."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return walls


def phase_times(cases, cases2, fps_cases, plan_cases, counts_of, models,
                hosts, clouds_np, smi) -> list:
    from repro_torch.kernels import fused_mlp
    counts_main = counts_of["model1/reram-fused"]
    kernels = []
    # K1: the three MLPs of one model1 batched_forward
    k1 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
          "ops": 0}
    per_mlp = {}
    for name in ("sa1", "sa2", "head"):
        c = cases["K1"][name]
        x_p, sx, prog, m, relu = c["x_p"], c["sx"], c["prog"], c["m"], c["relu"]
        run = (lambda: fused_mlp.fused_mlp_cuda(x_p, sx, prog, m_real=m,
                                                final_relu=relu))
        lib = _k1_library(prog, m)
        row = {
            "ms": cuda_ms(run),
            "plain_ms": cuda_ms(lambda: fused_mlp.fused_mlp_plain(
                x_p, sx, prog, m_real=m, final_relu=relu), iters=5),
            "library_ms": cuda_ms(lib),
            "device_ms": _device_ms(run),
            "library_device_ms": _device_ms(lib),
        }
        nbytes, ops = _k1_bound(prog, m)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, INT8_OPS_PER_S)
        per_mlp[name] = row
        for key in ("ms", "plain_ms", "library_ms", "device_ms",
                    "library_device_ms"):
            k1[key] = k1.get(key, 0) + row[key]
        k1["bytes"] += nbytes
        k1["ops"] += ops
    bms, bby = bound(k1["bytes"], k1["ops"], INT8_OPS_PER_S)
    kernels.append({
        "name": "K1 fused_mlp", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:391",
        "launches": counts_main["fused_mlp"],
        "layer_launches": counts_main["fused_mlp_layer"],
        "max_abs_err": max(cases["K1"][n]["max_abs_err"]
                           for n in cases["K1"]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": bms,
        "bound_by": bby, "library_ms": k1["library_ms"],
        "library_call": "torch._int_mm per layer (integer product only)",
        "work": "model1 SA-1 + SA-2 + head MLPs, batch 8 (s8 pre-pass "
                "included)",
        "device_ms": k1["device_ms"],
        "library_device_ms": k1["library_device_ms"],
        "per_mlp": per_mlp})
    kernels.append(_combine_row(cases, counts_main))
    kernels.extend(_model2_fused_rows(cases2, counts_of))
    floor = _launch_floor()
    kernels.extend(_gather_rows(cases, counts_main, floor))
    kernels.extend(_plan_rows(plan_cases, counts_main))
    kernels.extend(_k6_rows(cases2, counts_of))
    kernels.append(_k7_row(fps_cases, counts_of))
    # end to end, on the host clock: the default (planning on the card,
    # eager), the same call captured, and host planning
    e2e = {}
    clouds = torch.from_numpy(clouds_np).cuda()
    for name, model in models.items():
        walls = _wall_ms(lambda: model.batched_forward(clouds))
        row = {"batched_forward_ms_median": statistics.median(walls),
               "batched_forward_ms": walls,
               "clouds_per_s": BATCH / (statistics.median(walls) / 1e3),
               "captured_ms_median": statistics.median(
                   _wall_ms(lambda: model.jit_batched_forward(clouds))),
               "forward_ms_median": statistics.median(
                   _wall_ms(lambda: model.forward(clouds[0]))),
               "forward_captured_ms_median": statistics.median(
                   _wall_ms(lambda: model.jit_forward(clouds[0])))}
        if name in hosts:
            row["host_planned_ms_median"] = statistics.median(
                _wall_ms(lambda: hosts[name].batched_forward(clouds)))
        e2e[name] = row
    emit({"phase": "times", "nvidia_smi": smi, "batch": BATCH,
          "kernels": {k["name"]: {x: k[x] for x in
                                  ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "device_ms",
                                   "library_device_ms") if x in k}
                      for k in kernels},
          "modeled": _modeled_rows(cases, cases2, kernels),
          "model2_mlps": next(k["model2_mlps"] for k in kernels
                              if "model2_mlps" in k),
          "K6_per_layer": next(k["per_layer"] for k in kernels
                               if k["name"] == "K6 reram_matmul_int"),
          "K7": {k: kernels[-1][k] for k in (
              "tier", "us_per_step", "chain_us_per_step",
              "per_layer", "tiers", "fps_update_step")},
          "K4_K5_per_layer": {k["name"]: k["per_layer"] for k in kernels
                              if k["name"][:2] in ("K4", "K5")},
          "launch_floor": floor,
          "P1": next({x: k[x] for x in ("us_per_step", "other_shapes")}
                     for k in kernels if k["name"] == "P1 plan_greedy"),
          "end_to_end": e2e})
    return kernels


def _modeled_rows(cases, cases2, kernels) -> dict:
    """K1's and K2's modeled device-memory bytes
    (``kernels/program.py::launch_bytes``, the cost model's byte model)
    at each MLP timed above, and those bytes over the measured event time:
    a rate the design would reach if every re-read hit L2, not one the card
    was seen to move."""
    from repro_torch.kernels import launch_bytes
    k1 = next(k for k in kernels if k["name"] == "K1 fused_mlp")
    m2 = next(k for k in kernels if "model2_mlps" in k)["model2_mlps"]
    out = {}
    for key, case, mode, ms in (
            [(f"K1 model1 {n}", cases["K1"][n], "whole",
              k1["per_mlp"][n]["ms"]) for n in ("sa1", "sa2", "head")]
            + [(f"{kn} model2 {n}", cases2["mlps"][n], mode,
                m2[n][f"{mode}_ms"]) for n in ("sa1", "sa2", "head")
               for kn, mode in (("K1", "whole"), ("K2", "mtiled"))]):
        nbytes = launch_bytes(case["prog"], case["m"], mode, batch=BATCH)
        out[key] = {"modeled_bytes": nbytes,
                    "modeled_GBps": nbytes / ms / 1e6}
    return out


# ---------------------------------------------------------------------------
# the dataflow choice, the policy path and reliability
# ---------------------------------------------------------------------------

#: Batch sizes the dataflow phase times K1, K2 and K3 at.
DATAFLOW_BATCHES = (1, 8)

#: The kernel each dataflow runs (where K2's stripes do not fit on chip,
#: 'mtiled' runs K1).
KERNEL_NAMES = {"whole": "K1", "mtiled": "K2", "wstat": "K3"}


def _model_mlps(cfg, progs) -> dict:
    """Every MLP of a model's program: name -> (program, rows per cloud,
    final ReLU)."""
    out = {f"sa{i + 1}": (progs["sa"][i], s.n_centers * s.n_neighbors, True)
           for i, s in enumerate(cfg.layers)}
    out["head"] = (progs["head"], 1, False)
    return out


def _fused_all_modes(x_p, sx, prog, m: int, relu: bool, what: str) -> dict:
    """K1, K2 and K3 on the same inputs, each bit for bit against the plain
    version (and so against each other); returns the plain output."""
    from repro_torch.kernels import fused_mlp
    want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                     final_relu=relu)
    for mode in ("whole", "mtiled", "wstat"):
        got = fused_mlp.KERNEL_OF_MODE[mode](x_p, sx, prog, m_real=m,
                                             final_relu=relu)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{mode} {what} finite")
        check(torch.equal(got, want), f"{mode} {what} bitwise vs plain "
              f"(max err {float((got - want).abs().max())})")
    return want


def fit_launch_model(samples, hw) -> dict:
    """The per-launch constants of ``PlanPolicy.launch_cost`` that best fit
    measured device times: ``samples`` are ``(launch_work, ms)`` pairs, one
    per kernel call. For each ``block_overlap`` on a grid of 0.05 from 1
    to 4, the launch, slab, tile and requant costs are the least-squares
    solution on the relative error, with every block launch taken at its
    busiest SM's time and every grid-stride pass at its bytes over
    ``hw.hbm_gbps`` (the memory term binds at none of the dataflow grid's
    block launches); the overlap with the least residual wins. Returns
    the constants in cycles at ``hw.freq_ghz`` and the fit's root mean
    square relative error."""
    us_per_byte = 1e-3 / hw.hbm_gbps
    best = None
    for overlap in np.arange(1.0, 4.0001, 0.05):
        a_rows, y = [], []
        for work, ms in samples:
            us = ms * 1e3
            row, fixed = np.zeros(4), 0.0
            for w in work:
                row[0] += 1
                if not w.blocks:
                    fixed += w.bytes * us_per_byte
                    continue
                busy = max(1.0, -(-w.blocks // hw.sms) / overlap)
                row[1:] += busy * np.array([w.slabs, w.tiles, w.requant])
            a_rows.append(row / us)
            y.append((us - fixed) / us)
        a_m, y = np.array(a_rows), np.array(y)
        x = np.linalg.lstsq(a_m, y, rcond=None)[0]
        res = float(np.mean((a_m @ x - y) ** 2))
        if best is None or res < best[0]:
            best = (res, float(overlap), x)
    res, overlap, x = best
    cycles_per_us = hw.freq_ghz * 1e3
    return {"launch_cycles": x[0] * cycles_per_us,
            "slab_cycles": x[1] * cycles_per_us,
            "tile_cycles": x[2] * cycles_per_us,
            "requant_cycles": x[3] * cycles_per_us,
            "block_overlap": overlap, "rms_rel_err": res ** 0.5}


def _choice_over_fastest(rows, pick) -> float:
    """Summed device time of the kernels ``pick(row)`` names over that of
    the fastest kernel of each row."""
    return (sum(r[f"{pick(r)}_device_ms"] for r in rows)
            / sum(r[f"{r['fastest']}_device_ms"] for r in rows))


def phase_dataflow(params, cfgs, smi) -> None:
    """K1, K2 and K3 at every MLP of model0, model1 and model2 at batch 1
    and 8 (random rows at the MLP's input width): each bit for bit against
    the plain version, its device time (``torch.profiler``, mean of 5
    calls), and beside them the TPU's choice (``plan_fused_mlp``), the
    Hopper choice (``DEFAULT_POLICY.select_launch``) and the policy's
    predicted time of each mode; how far the choice is from the fastest
    measured kernel, summed over the grid beside the TPU's choice and each
    kernel everywhere (the Hopper choice must not be slower than the
    TPU's); and the cost model's constants refitted to this run's times
    (``fit_launch_model``) beside the package's."""
    from repro_torch.core.policy import DEFAULT_POLICY as policy
    from repro_torch.kernels import fused_mlp, launch_work, plan_fused_mlp
    from repro_torch.models.pointnet2 import build_model_program
    cycles_per_ms = policy.hw.freq_ghz * 1e6
    rows, samples = [], []
    t0 = time.perf_counter()
    for name, cfg in cfgs.items():
        progs = build_model_program(params[name])
        for mlp, (prog, m, relu) in _model_mlps(cfg, progs).items():
            prog = prog.cuda()
            for batch in DATAFLOW_BATCHES:
                g = torch.Generator(device="cpu").manual_seed(SEED + batch)
                x = torch.randn((batch, m, prog.widths[0]), generator=g)
                x_p, sx = fused_mlp.prepare_input(x.cuda(), prog)
                _fused_all_modes(x_p, sx, prog, m, relu,
                                 f"{name} {mlp} batch {batch}")
                tpu = plan_fused_mlp(prog, m).mode
                row = {"model": name, "mlp": mlp, "batch": batch,
                       "rows": m, "widths": list(prog.widths),
                       "tpu_choice": "whole" if tpu == "tiled" else tpu,
                       "hopper_choice": policy.select_launch(
                           prog, m, batch=batch).mode}
                for mode, kname in KERNEL_NAMES.items():
                    kernel = fused_mlp.KERNEL_OF_MODE[mode]
                    row[f"{kname}_device_ms"] = _device_ms(
                        lambda: kernel(x_p, sx, prog, m_real=m,
                                       final_relu=relu))
                    row[f"{kname}_predicted_ms"] = policy.launch_cost(
                        prog, m, mode, batch=batch) / cycles_per_ms
                    samples.append((launch_work(prog, m, mode, batch=batch,
                                                sms=policy.hw.sms),
                                    row[f"{kname}_device_ms"]))
                times = {k: row[f"{k}_device_ms"]
                         for k in KERNEL_NAMES.values()}
                row["fastest"] = min(times, key=times.get)
                chosen = KERNEL_NAMES[row["hopper_choice"]]
                row["choice_over_fastest"] = (times[chosen]
                                              / times[row["fastest"]])
                rows.append(row)
    summed = {"hopper_choice": _choice_over_fastest(
                  rows, lambda r: KERNEL_NAMES[r["hopper_choice"]]),
              "tpu_choice": _choice_over_fastest(
                  rows, lambda r: KERNEL_NAMES[r["tpu_choice"]]),
              **{f"{k}_everywhere": _choice_over_fastest(
                  rows, lambda r, k=k: k) for k in KERNEL_NAMES.values()}}
    check(summed["hopper_choice"] <= summed["tpu_choice"],
          f"the Hopper choice takes {summed['hopper_choice']:.3f}x the "
          f"fastest kernels summed over the grid, the TPU's "
          f"{summed['tpu_choice']:.3f}x")
    slow = [f"{r['model']} {r['mlp']} batch {r['batch']}" for r in rows
            if r["choice_over_fastest"] > 1.10]
    rel = [r[f"{k}_predicted_ms"] / r[f"{k}_device_ms"] - 1
           for r in rows for k in KERNEL_NAMES.values()]
    package = {k: getattr(policy.hw, k) for k in (
        "launch_cycles", "slab_cycles", "tile_cycles", "requant_cycles",
        "block_overlap")}
    emit({"phase": "dataflow", "nvidia_smi": smi, "tolerance": "bitwise",
          "rows": rows, "choice_over_10pct_slower": slow,
          "summed_over_fastest": summed,
          "cost_model": {"package": package,
                         "package_rms_rel_err": float(
                             np.mean(np.square(rel)) ** 0.5),
                         "refit": fit_launch_model(samples, policy.hw)},
          "seconds": time.perf_counter() - t0})


def phase_policy(params2, cfg2, clouds_np, pointer_model) -> None:
    """model2 'reram-fused' under a precommitted ``PlanPolicy``: it plans
    on the card (P1 when the policy picked 'greedy', P2), eager and
    captured, its logits bit for bit those of ``schedule="pointer"``, its
    launch counters held as the other paths'; a policy that is not
    precommitted plans on the host and refuses ``jit_batched_forward``
    with ``TypeError``."""
    import repro_torch
    from repro_torch.core.workload import PointNetWorkload
    clouds = torch.from_numpy(clouds_np).cuda()
    wl = PointNetWorkload.build(clouds_np[0].astype(np.float64), cfg2)
    policy = repro_torch.PlanPolicy().precommit(wl)
    intra = policy.intra_candidates[0]
    model = repro_torch.compile_model(params2, cfg2, backend="reram-fused",
                                      policy=policy)
    check(model.device_planning, "a precommitted policy plans on the card")
    counts, logits, single = run_main_path(model, clouds)
    L = cfg2.n_layers
    want = {"aggregate_diff_batched": L, "aggregate_diff": L, "fps": 2 * L,
            "plan_greedy": 2 if intra == "greedy" else 0,
            "plan_coordinate": 2,
            **{c: PATHS["model2"]["reram-fused"].get(c, 0)
               for c in MLP_COUNTERS}}
    for key, n in want.items():
        check(counts[key] == n, f"policy path: {key} launched "
                                f"{counts[key]} times, expected {n}")
    ref = pointer_model.batched_forward(clouds)
    check(torch.equal(logits, ref), "policy logits != 'pointer' logits")
    check(torch.equal(single, pointer_model.forward(clouds[0])),
          "policy forward != 'pointer' forward")
    captured = model.jit_batched_forward(clouds)
    check(torch.equal(captured, ref), "captured policy call != eager")
    check(model.captures == 1, f"{model.captures} captures for one shape")
    replay = _captured_kernels(model, clouds)
    for kname in CAPTURED_KERNELS:
        if kname == "greedy_kernel" and intra != "greedy":
            continue
        check(any(kname in k for k in replay["port_kernels"]),
              f"policy path: {kname} not in the captured replay")
    host = repro_torch.compile_model(params2, cfg2, backend="reram-fused",
                                     policy=repro_torch.PlanPolicy())
    check(not host.device_planning, "a policy that is not precommitted "
                                    "plans on the host")
    try:
        host.jit_batched_forward(clouds)
    except TypeError as e:
        refused = str(e)
    else:
        refused = None
    check(refused is not None, "jit_batched_forward of a host-planning "
                               "policy did not raise TypeError")
    check(torch.equal(host.batched_forward(clouds), ref),
          "host-planning policy logits != 'pointer' logits")
    emit({"phase": "policy", "intra": intra, "launches": counts,
          "bitwise_vs_pointer": True, "captured_bitwise": True,
          "captured_replay": replay, "not_precommitted_refuses": refused,
          "launch_plan": model.stats()["launch_plan"]})


#: The fault model of the reliability phase.
FAULTS = {"p_stuck0": 0.01, "p_stuck1": 0.01, "seed": 3}
#: The stuck-cell rates of its Pareto sweep of model0: below 1%, where ECC
#: at group 4 corrects most faults and the raw program already loses
#: agreement (above it both sit near chance over 8 clouds).
SWEEP_RATES = (0.0, 0.001, 0.002, 0.005)


def _mlp_outputs(model, cfg, inputs: dict, what: str) -> dict:
    """Every MLP of a fused model through K1, K2 and K3 on ``inputs``
    (name -> float rows), each bit for bit against the plain version;
    returns the outputs."""
    from repro_torch.kernels import fused_mlp
    out = {}
    for mlp, (prog, m, relu) in _model_mlps(
            cfg, model.backend.program).items():
        x_p, sx = fused_mlp.prepare_input(inputs[mlp], prog)
        out[mlp] = _fused_all_modes(x_p, sx, prog, m, relu,
                                    f"{what} {mlp}")
    return out


def _cpu_logits_on_card_features(cpu_model, clouds) -> torch.Tensor:
    """``cpu_model.batched_forward`` of the card's ``clouds`` (a CUDA
    tensor), its layer-0 features those the card computes
    (``lift_features``' sin/cos may round apart from the CPU's by an ulp):
    so the CPU run and the card see the same inputs."""
    from repro_torch.models import pointnet2 as pn
    real = pn.lift_features
    points = clouds.cpu()

    def lift(pts, n_features):
        if pts.shape == points.shape and torch.equal(pts, points):
            return real(clouds, n_features).cpu()
        return real(pts, n_features)
    pn.lift_features = lift
    try:
        return cpu_model.batched_forward(points)
    finally:
        pn.lift_features = real


def _captured_device_ms(model, clouds) -> float:
    model.jit_batched_forward(clouds)
    torch.cuda.synchronize()
    return _device_ms(lambda: model.jit_batched_forward(clouds))


def phase_reliability(params2, cfg2, params0, cfg0, clouds_np,
                      pointer_model) -> None:
    """model2 'reram-fused' (batch 8) protected with ECC at groups 16 and 4:
    K1, K2 and K3 on the widened programs bit for bit against the plain
    version and against the unprotected programs' outputs, and the logits
    bit for bit the unprotected model's; faulted (:data:`FAULTS`) raw and
    under each ECC, K1/K2/K3 against plain and the logits against the
    port's CPU run of the same model (the MLPs bit for bit on the same
    inputs; the logits bit for bit against the CPU run given the card's
    layer-0 features, and against the CPU's own run bit for bit, or within
    the end-to-end tolerance with argmax equal where the card's layer-0
    features differ from the CPU's); 'reram' faulted, eager and captured,
    K6 against plain on the
    faulted planes; the captured call's device time protected, faulted
    and unprotected; then one Pareto sweep of model0 at
    :data:`SWEEP_RATES`, ECC at group 4 at least as accurate as raw at
    every rate and more at one."""
    import repro_torch
    from repro_torch.kernels import (encode_planes, fused_mlp,
                                     launch_counts, quantize_tensor,
                                     ref_reram_matmul_int, reram_mlp,
                                     reset_launch_counts)
    from repro_torch.models import pointnet2 as pn
    from repro_torch.reliability import EccConfig, FaultModel, pareto
    clouds = torch.from_numpy(clouds_np).cuda()
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    inputs = {mlp: torch.randn((BATCH, m, prog.widths[0]), generator=g)
              for mlp, (prog, m, _) in _model_mlps(
                  cfg2, pointer_model.backend.program).items()}
    inputs_cuda = {k: v.cuda() for k, v in inputs.items()}
    base_logits = pointer_model.batched_forward(clouds)
    base_mlps = _mlp_outputs(pointer_model, cfg2, inputs_cuda,
                             "unprotected")
    base_ms = _captured_device_ms(pointer_model, clouds)
    fm = FaultModel(**FAULTS)
    out = {"phase": "reliability", "fault_model": FAULTS,
           "unprotected_captured_device_ms": base_ms, "ecc": {},
           "faulted": {}}

    def compile2(**kw):
        return repro_torch.compile_model(params2, cfg2, schedule="pointer",
                                         **kw)
    for group in (16, 4):
        model = compile2(backend="reram-fused", ecc=EccConfig(group))
        d_pads = {mlp: p.d_pad for mlp, (p, _, _) in _model_mlps(
            cfg2, model.backend.program).items()}
        mlps = _mlp_outputs(model, cfg2, inputs_cuda, f"ecc {group}")
        for mlp, y in mlps.items():
            check(torch.equal(y, base_mlps[mlp]),
                  f"ecc {group} {mlp}: protected != unprotected")
        logits = model.batched_forward(clouds)
        check(torch.equal(logits, base_logits),
              f"ecc {group}: logits != unprotected logits")
        check(torch.equal(model.jit_batched_forward(clouds), logits),
              f"ecc {group}: captured != eager")
        out["ecc"][group] = {
            "d_pad": d_pads, "bitwise_vs_unprotected": True,
            "captured_device_ms": _captured_device_ms(model, clouds),
            "reliability": model.stats()["reliability"]["ecc"]["per_mlp"]}
    in_f = cfg2.layers[0].in_features
    lift_bitwise = torch.equal(
        pn.lift_features(clouds[:2], in_f).cpu(),
        pn.lift_features(torch.from_numpy(clouds_np[:2]), in_f))
    out["layer0_features_bitwise_vs_cpu"] = lift_bitwise
    for label, ecc in (("raw", None), ("ecc16", EccConfig(16)),
                       ("ecc4", EccConfig(4))):
        model = compile2(backend="reram-fused", ecc=ecc, fault_model=fm)
        cpu = compile2(backend="reram-fused", ecc=ecc, fault_model=fm,
                       device="cpu")
        mlps = _mlp_outputs(model, cfg2, inputs_cuda, f"faulted {label}")
        for mlp, (prog, m, relu) in _model_mlps(
                cfg2, cpu.backend.program).items():
            x_p, sx = fused_mlp.prepare_input(inputs[mlp], prog)
            want = fused_mlp.fused_mlp_plain(x_p, sx, prog, m_real=m,
                                             final_relu=relu)
            check(torch.equal(mlps[mlp].cpu(), want),
                  f"faulted {label} {mlp}: card != CPU")
        logits = model.batched_forward(clouds)
        check(torch.equal(model.jit_batched_forward(clouds), logits),
              f"faulted {label}: captured != eager")
        # bit for bit against the CPU run on the same inputs, the card's
        # layer-0 features included
        check(torch.equal(logits[:2].cpu(),
                          _cpu_logits_on_card_features(cpu, clouds[:2])),
              f"faulted {label}: logits != the CPU's on the card's "
              f"layer-0 features")
        # against the CPU's own run: bit for bit where the card's layer-0
        # features equal the CPU's, else (sin/cos an ulp apart can move one
        # requantized value a step) within the end-to-end tolerance
        ref = cpu.batched_forward(clouds_np[:2])
        err = float((logits[:2].cpu() - ref).abs().max())
        tol = 0.0 if lift_bitwise else 1e-2 * float(ref.abs().max())
        check(err <= tol, f"faulted {label}: card vs CPU err {err} > {tol} "
                          f"(layer-0 features bitwise: {lift_bitwise})")
        check(torch.equal(logits[:2].cpu().argmax(1), ref.argmax(1)),
              f"faulted {label}: argmax card vs CPU")
        changed = int((logits.argmax(1) != base_logits.argmax(1)).sum())
        out["faulted"][label] = {
            "mlps_bitwise_vs_cpu": True,
            "logits_bitwise_vs_cpu_on_card_features": True,
            "logits_bitwise_vs_cpu": bool(torch.equal(logits[:2].cpu(),
                                                      ref)),
            "cpu_max_abs_err": err, "tolerance": tol,
            "argmax_changed_vs_ideal": changed,
            "captured_device_ms": _captured_device_ms(model, clouds)}
    # 'reram' faulted: K6 on the faulted planes of every layer, eager and
    # captured logits, launches
    reram = compile2(backend="reram", fault_model=fm)
    reset_launch_counts()
    logits = reram.batched_forward(clouds)
    single = reram.forward(clouds[0])
    torch.cuda.synchronize()
    counts = launch_counts()
    for key in ("reram_matmul_int", "reram_combine"):
        want = PATHS["model2"]["reram"][key]
        check(counts[key] == want, f"faulted 'reram': {key} launched "
                                   f"{counts[key]} times, expected {want}")
    check(torch.equal(reram.jit_batched_forward(clouds), logits),
          "faulted 'reram': captured != eager")
    check(torch.equal(reram.jit_forward(clouds[0]), single),
          "faulted 'reram': captured forward != eager")
    check(torch.equal(single, logits[0]),
          "faulted 'reram': forward != batched_forward row 0")
    cpu = compile2(backend="reram", fault_model=fm, device="cpu")
    ref = cpu.batched_forward(clouds_np[:2])
    err = float((logits[:2].cpu() - ref).abs().max())
    check(err <= 1e-2 * float(ref.abs().max()),
          f"faulted 'reram': card vs CPU err {err}")
    check(torch.equal(logits[:2].cpu().argmax(1), ref.argmax(1)),
          "faulted 'reram': argmax card vs CPU")
    k6 = 0
    gx = torch.Generator(device="cpu").manual_seed(SEED + 41)
    layers = [(key, l, lyr) for key, mlp in
              [(("sa", i), m) for i, m in enumerate(params2["sa"])]
              + [("head", params2["head"])] for l, lyr in enumerate(mlp)]
    for key, l, lyr in layers:
        draws = reram.backend.fault_draws(key, l)
        planes = fm.transform_planes(encode_planes(
            quantize_tensor(lyr["w"])[0]), draws).cuda()
        x = torch.randint(-128, 128, (257, lyr["w"].shape[0]),
                          generator=gx, dtype=torch.int8).cuda()
        got = reram_mlp.reram_matmul_int_cuda(x, planes)
        torch.cuda.synchronize()
        check(torch.equal(got, ref_reram_matmul_int(x, planes)),
              f"K6 faulted {key} layer {l} bitwise vs plain")
        k6 += 1
    out["reram_faulted"] = {
        "launches": {k: counts[k] for k in ("reram_matmul_int",
                                            "reram_combine")},
        "k6_layers_bitwise": k6, "cpu_max_abs_err": err,
        "captured_device_ms": _captured_device_ms(reram, clouds)}
    # one Pareto sweep of model0 on the card
    t1 = time.perf_counter()
    points = pareto.sweep(params0, cfg0, fault_rates=SWEEP_RATES,
                          protections=("none", "ecc"), ecc_group=4,
                          n_clouds=8, device="cuda")
    sweep_s = time.perf_counter() - t1
    front = pareto.pareto_front(points)
    # a fault-free model (protected or not) is the ideal one, bit for bit;
    # below 1% stuck cells ECC at group 4 keeps agreement where the raw
    # program loses it: at least as high at every rate, higher at one
    check(all(p.accuracy == 1.0 for p in points if p.fault_rate == 0.0),
          "a fault-free sweep point disagrees with the ideal model")
    acc = {(p.protection, p.fault_rate): p.accuracy for p in points}
    check(all(acc["ecc", r] >= acc["none", r] for r in SWEEP_RATES)
          and any(acc["ecc", r] > acc["none", r] for r in SWEEP_RATES),
          f"ECC at group 4 does not separate from raw: {acc}")
    out["pareto"] = {"seconds": sweep_s,
                     "points": [dict(p.__dict__) for p in points],
                     "front": [dict(p.__dict__) for p in front],
                     "archetypes": pareto.classify_archetypes(
                         points)["counts"]}
    out["seconds"] = time.perf_counter() - t0
    emit(out)


def phase_quickstart() -> None:
    """``examples/quickstart_torch.py``'s ``main()`` on the card, once."""
    import importlib.util
    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    t0 = time.perf_counter()
    got = module.main("cuda")
    check(got["argmax_agree"], "quickstart: float and fused argmax differ")
    for key in ("policy_bitwise", "captured_bitwise", "precommitted_bitwise"):
        check(got[key], f"quickstart: {key} is False")
    emit({"phase": "quickstart", "seconds": time.perf_counter() - t0,
          **{k: got[k] for k in ("designs", "elision", "choices",
                                 "picked")}})


# ---------------------------------------------------------------------------
# the serving tier
# ---------------------------------------------------------------------------

#: The served configuration: model2 'reram-fused' at full width and depth,
#: 1024-point and 700-point clouds in two point buckets.
SERVE_BUCKETS = {"points": (768, 1024), "batch": (1, 2, 4, 8)}
#: Poisson arrivals of the paced pool stream (requests/s): below the
#: card's batch-8 rate, so batches stay small and latency is the measure.
SERVE_PACED_HZ = 500.0
#: The kernel rows of the ``{"kernels": [...]}`` line a served step or a
#: plan-cache miss launches, by launch counter.
SERVE_KERNELS = {"K1/K2/K3 combine_weights (s8 pre-pass)":
                     "fused_mlp_combine",
                 "K3 fused_mlp_wstat": "fused_mlp_wstat",
                 "K4 aggregate_diff_batched": "aggregate_diff_batched",
                 "K7 fps": "fps", "P1 plan_greedy": "plan_greedy",
                 "P2 plan_coordinate": "plan_coordinate"}


def _serve_streams() -> dict:
    """name -> (arrivals, servable options, deadline of an item in us)."""
    from repro_torch.data import request_stream
    pool = list(request_stream(64, n_points=(1024, 700), pool=8,
                               repeat_p=0.7, seed=0))
    paced = list(request_stream(64, rate_hz=SERVE_PACED_HZ,
                                n_points=(1024, 700), pool=8,
                                repeat_p=0.7, seed=0))
    lidar = list(request_stream(32, rate_hz=10.0, n_points=(1024,), pool=4,
                                seed=0, mode="lidar"))
    urgent = (lambda it: 4_000 if it[2] % 4 == 0 else 50_000)
    return {"pool_saturated": ([(0.0,) + tuple(it[1:]) for it in pool],
                               False, urgent),
            "pool_paced": (paced, False, urgent),
            "lidar": (lidar, True, lambda it: 100_000)}


def _serve_run(model, arrivals, reuse, deadline, scheduler):
    from repro_torch.core.schedule import FrameTracker
    from repro_torch.launch import (PointCloudServable, ServingEngine,
                                    ShapeBuckets)
    servable = PointCloudServable(
        model, buckets=ShapeBuckets(**SERVE_BUCKETS),
        frame_reuse=FrameTracker(tol=1e-3) if reuse else False)
    engine = ServingEngine(servable, scheduler=scheduler)
    stats = engine.serve_stream(arrivals, deadline_us=deadline)
    return servable, engine, stats


def _stream_row(stats: dict) -> dict:
    return {k: stats[k] for k in (
        "n_requests", "wall_s", "throughput_rps", "p50_ms", "p99_ms",
        "mean_ms", "deadline_miss_rate", "batches", "jit_traces",
        "trace_shapes", "plan_cache", "frame_tracker") if k in stats}


def _served_bitwise(model, runs) -> int:
    """Every served row against ``forward`` on its bare cloud, bit for
    bit; returns how many rows were held."""
    from repro_torch.core.schedule import cloud_content_key
    refs, n = {}, 0
    for _, engine, _ in runs:
        for req in engine.completed:
            key = cloud_content_key(req.payload)
            if key not in refs:
                refs[key] = model.forward(req.payload)
            check(tuple(req.result.shape) == (40,)
                  and bool(torch.isfinite(req.result).all()),
                  f"served row {req.id}: shape or finiteness")
            check(torch.equal(req.result, refs[key]),
                  f"served row {req.id} != forward on its bare cloud")
            n += 1
    return n


def _hit_batch(servable, payloads) -> dict:
    """One served step whose plans are all cache hits: its replay's port
    kernels by name (``torch.profiler``), held to K7 twice, the gather
    twice and no P1 or P2."""
    misses = servable.plan_cache.misses
    rows = _device_rows(lambda: servable.run_batch(payloads))
    check(servable.plan_cache.misses == misses, "hit batch missed")
    names = {r["kernel"]: r["count"] for r in _port_rows(rows)}

    def count(part):
        return sum(c for k, c in names.items() if part in k)
    check(count("fps_loop_kernel") == 2,
          f"hit step: K7 launched {count('fps_loop_kernel')} times, not 2")
    check(count("aggregate_diff_kernel") == 2,
          f"hit step: gather launched {count('aggregate_diff_kernel')} "
          f"times, not 2")
    check(count("greedy_kernel") == 0 and count("coordinate_kernel") == 0,
          "hit step launched P1 or P2")
    return {"port_kernels": names,
            "device_ms": sum(r["device_ms"] for r in rows),
            "kernel_launches": sum(r["count"] for r in rows)}


def _miss_batch(model, servable, cloud) -> dict:
    """One served step of a cloud no cache holds, on a captured shape:
    the plan's build launches K7 twice, P1 and P2 once each, and the
    replayed step moves no counter."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    captures = model.captures
    reset_launch_counts()
    servable.run_batch([cloud])
    torch.cuda.synchronize()
    counts = launch_counts()
    check(model.captures == captures, "the miss step was not a replay")
    want = {"plan_greedy": 1, "plan_coordinate": 1, "fps": 2}
    for key, n in counts.items():
        check(n == want.get(key, 0),
              f"miss step: {key} launched {n} times, expected "
              f"{want.get(key, 0)}")
    return {k: n for k, n in counts.items() if n}


def _served_step_times(model, bare, servable, payloads) -> list:
    """Per batch bucket at 1024 points, all plans cache hits: the served
    step (``run_batch`` ended by a synchronize; host clock, median of 10)
    and its device time, beside the bare captured ``jit_batched_forward``
    (planning on the card) of ``bare`` at the same batch, device and host
    clock; and the served step's host work split into hashing, stacking,
    copying in, and replaying plus synchronizing."""
    from repro_torch.core.schedule import DevicePlan, cloud_content_key
    from repro_torch.models.backend import graph_key
    rows = []
    top = SERVE_BUCKETS["points"][-1]
    for b_real in SERVE_BUCKETS["batch"]:
        batch = [payloads[i % len(payloads)] for i in range(b_real)]
        b = max(2, b_real)
        padded = np.stack([batch[i % b_real] for i in range(b)])
        n_valid = np.full((b,), top, np.int32)
        served = _wall_ms(lambda: servable.run_batch(batch), n=10)
        step_rows = _device_rows(lambda: servable.run_batch(batch))
        clouds = torch.from_numpy(padded).cuda()
        cap_wall = _wall_ms(lambda: bare.jit_batched_forward(clouds), n=10)
        cap_rows = _device_rows(lambda: bare.jit_batched_forward(clouds))
        # the host's pieces of the same step
        plans = [servable.plan_cache.get(cloud_content_key(c))
                 for c in padded]
        x = model._input(padded)
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=x.device)
        dplan = DevicePlan.stack(plans)
        call = model._graphs[graph_key(model._batched_step, (x, nv, dplan))]

        def copy_in():
            xi = model._input(padded)
            nvi = torch.as_tensor(n_valid, dtype=torch.int32,
                                  device=x.device)
            call(xi, nvi, DevicePlan.stack(plans))

        def replay():
            call.graph.replay()
        split = {
            "hash_ms": _wall_ms(lambda: [cloud_content_key(c)
                                         for c in batch], n=10),
            "stack_ms": _wall_ms(lambda: DevicePlan.stack(plans), n=10),
            "copy_in_replay_sync_ms": _wall_ms(copy_in, n=10),
            "replay_sync_ms": _wall_ms(replay, n=10)}
        split = {k: statistics.median(v) for k, v in split.items()}
        split["copy_in_ms"] = (split.pop("copy_in_replay_sync_ms")
                               - split["replay_sync_ms"]
                               - split["stack_ms"])
        step_device = sum(r["device_ms"] for r in step_rows)
        med = statistics.median(served)
        rows.append({
            "batch": b_real, "batch_bucket": b, "served_ms_median": med,
            "served_ms": served, "served_device_ms": step_device,
            "served_requests_per_s": b_real / (med / 1e3),
            "captured_ms_median": statistics.median(cap_wall),
            "captured_device_ms": sum(r["device_ms"] for r in cap_rows),
            "host_split_ms": split,
            "host_share": 1.0 - step_device / med})
    return rows


def _miss_build_ms(model, payloads) -> dict:
    """A plan-cache miss's build (``build_device_plan``, eager: FPS, kNN,
    P1 and P2 on the card) per point bucket: host clock ended by a
    synchronize (median of 5) and device time."""
    out = {}
    for cloud in payloads:
        n = cloud.shape[0]
        bucket = next(p for p in SERVE_BUCKETS["points"] if n <= p)
        padded = np.zeros((bucket, 3), np.float32)
        padded[:n] = cloud
        build = (lambda: model.build_device_plan(padded, n_valid=n))
        rows = _device_rows(build)
        out[f"{n}_in_{bucket}"] = {
            "ms_median": statistics.median(_wall_ms(build)),
            "device_ms": sum(r["device_ms"] for r in rows),
            "kernel_launches": sum(r["count"] for r in rows)}
    return out


def phase_serve(params2, cfg2, bare, smi) -> dict:
    """The serving tier over model2 'reram-fused' at full width and depth
    (a fresh model, so its captures are the served path's alone): the pool
    stream (64 requests of 8 clouds, 1024 and 700 points, repeated with
    probability 0.7) saturated and paced at :data:`SERVE_PACED_HZ`, and
    the LiDAR stream (32 frames at 10 Hz, frame reuse at 1e-3), each under
    FIFO and EDF on the wall clock. Launch counters reset just before the
    six runs and read just after, held to the served steps' captures and
    the plan builds; every served row bit for bit against ``forward``;
    captures at most one per bucket shape, none added by a second pass of
    the six runs; plan-cache and frame hits; one hit step and one miss
    step by kernel. Then times: per stream and scheduler, throughput and
    p50/p99 of the second pass (the first pass's, which include the
    captures, beside them); per batch bucket the served step beside the
    bare captured call of ``bare``; a miss's plan build. Returns the
    served path's counts."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.backend import CudaGraphCall
    t0 = time.perf_counter()
    model = repro_torch.compile_model(params2, cfg2, backend="reram-fused",
                                      schedule="pointer")
    streams = _serve_streams()
    runs = {}
    reset_launch_counts()
    for name, (arrivals, reuse, deadline) in streams.items():
        for sched in ("fifo", "edf"):
            runs[f"{name}/{sched}"] = _serve_run(model, arrivals, reuse,
                                                 deadline, sched)
    torch.cuda.synchronize()
    counts = launch_counts()
    captures = model.captures
    builds = sum(r[0].plan_cache.misses for r in runs.values())
    # a capture calls the step WARMUP times on a side stream, then once
    # under capture; a replay moves no counter
    calls = (CudaGraphCall.WARMUP + 1) * captures
    per_step = PATHS["model2"]["serve"]
    want = {"fps": 2 * calls + 2 * builds, "plan_greedy": builds,
            "plan_coordinate": builds, "aggregate_diff_batched": 2 * calls}
    for key in model._graphs:        # (entry, operands, (clouds' shape, …))
        for c, n in per_step[key[2][0][0]].items():
            want[c] = want.get(c, 0) + (CudaGraphCall.WARMUP + 1) * n
    for key, n in counts.items():
        check(n == want.get(key, 0),
              f"serve: {key} launched {n} times, expected "
              f"{want.get(key, 0)} ({captures} captures, {builds} builds)")
    n_points, n_batch = (len(SERVE_BUCKETS["points"]),
                         len(SERVE_BUCKETS["batch"]))
    check(0 < captures <= n_points * n_batch,
          f"serve: {captures} captures for {n_points} x {n_batch} buckets")
    for name, (servable, _, stats) in runs.items():
        check(servable.jit_traces <= captures
              and stats["n_requests"] == len(streams[name.split("/")[0]][0]),
              f"serve {name}: step keys or requests")
        if name.startswith("pool"):
            check(stats["plan_cache"]["hits"] > 0, f"{name}: no cache hit")
        else:
            check(stats["frame_tracker"]["frame_hits"] > 0,
                  f"{name}: no frame hit")
    # the second pass: the same six runs on warm captures (fresh
    # servables, so cold plan caches); its stats are the times reported
    warm = {name: _serve_run(model, *streams[name.split("/")[0]],
                             name.split("/")[1]) for name in runs}
    check(model.captures == captures, "a second pass over the streams "
                                      "captured again")
    rows_held = _served_bitwise(model, [*runs.values(), *warm.values()])
    servable = warm["pool_saturated/fifo"][0]
    top = SERVE_BUCKETS["points"][-1]
    big = [c for _, c, _ in streams["pool_saturated"][0]
           if c.shape[0] == top]
    distinct = list({id(c): c for c in big}.values())
    hit = _hit_batch(servable, (distinct * 8)[:8])
    from repro_torch.data import synthetic_cloud
    miss = _miss_batch(model, servable, synthetic_cloud(5, top, seed=99))
    small = next(c for _, c, _ in streams["pool_saturated"][0]
                 if c.shape[0] < top)
    out = {"phase": "serve", "nvidia_smi": smi, "model": cfg2.name,
           "backend": "reram-fused", "buckets": SERVE_BUCKETS,
           "paced_hz": SERVE_PACED_HZ, "launches": counts,
           "captures": captures, "plan_builds": builds,
           "rows_bitwise": rows_held, "hit_step": hit, "miss_step": miss,
           "streams": {name: _stream_row(stats)
                       for name, (_, _, stats) in warm.items()},
           "first_pass_streams": {name: _stream_row(stats)
                                  for name, (_, _, stats) in runs.items()},
           "batch_buckets": _served_step_times(model, bare, servable,
                                               distinct),
           "miss_build": _miss_build_ms(model, [distinct[0], small])}
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return counts


# ---------------------------------------------------------------------------
# training and the launch contracts
# ---------------------------------------------------------------------------

#: The trainer's run on the card: model0 unreduced (1024 points), the
#: reference's batch and step count, the checkpoint under a scratch dir.
TRAIN_ARGS = {"points": 1024, "batch": 16, "steps": 200, "seed": SEED}
#: Steps of the trainer's run left out of its median step time (warm-up:
#: cuBLAS plans, the caching allocator).
TRAIN_WARMUP = 10
#: Calls of each training phase ``phase_train`` profiles.
TRAIN_PROFILE_CALLS = 5
#: Steps compared bit for bit, captured against eager.
TRAIN_COMPARE_STEPS = 5
#: Eager steps timed beside the captured run (after :data:`TRAIN_WARMUP`).
TRAIN_EAGER_STEPS = 50


def _trainer():
    import importlib.util
    path = ROOT / "examples" / "train_pointnet_torch.py"
    spec = importlib.util.spec_from_file_location("train_pointnet_torch",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _first_batch(args: dict):
    """The trainer's first batch: its dataset and its batch iterator."""
    from repro_torch.data import PointCloudDataset
    data = PointCloudDataset(n_points=args["points"], n_clouds=512,
                             seed=args["seed"])
    return next(data.batches(args["batch"], 1))


def _step0(trainer, args: dict, device: str) -> tuple:
    """Step 0's loss, accuracy and gradients (a list in the params tree's
    leaf order) on ``device``: the trainer's weights and first batch."""
    import repro_torch
    from repro_torch.models.pointnet2 import init_params
    from repro_torch.optim import tree_leaves, tree_map
    cfg = trainer.train_config(args["points"])
    params = tree_map(lambda t: t.to(device).requires_grad_(),
                      init_params(cfg, seed=args["seed"]))
    model = repro_torch.compile_model(params, cfg, device=device)
    clouds, labels = _first_batch(args)
    loss, acc = model.loss_fn(clouds, labels)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return (float(loss.detach()), float(acc),
            [g.detach().cpu() for g in grads])


def _argv(args: dict, ckpt: str) -> list:
    argv = ["--device", "cuda", "--ckpt", ckpt]
    for k, v in args.items():
        argv += [f"--{k}", str(v)]
    return argv


def _trainer_run(trainer, args: dict) -> tuple[dict, dict]:
    """The trainer's ``main()`` on the card (captured), its launch counts
    (reset just before, read just after), and its checkpoint restored bit
    for bit."""
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import tree_leaves
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        out = trainer.main(_argv(args, tmp))
        torch.cuda.synchronize()
        counts = launch_counts()
        tree = {"params": out["params"], "opt": out["opt"]}
        restored, step, meta = restore_checkpoint(tmp, tree)
        check(step == len(out["history"])
              and meta == {"arch": "pointnet2-model0"},
              "train: checkpoint step and meta")
        check(all(torch.equal(a.detach(), b) for a, b in
                  zip(tree_leaves(tree), tree_leaves(restored))),
              "train: checkpoint not restored bit for bit")
    return out, counts


def _state_leaves(run: dict) -> list:
    from repro_torch.optim import tree_leaves
    return [t.detach() for t in tree_leaves(run["params"])
            + tree_leaves(run["opt"])]


def _batches(run: dict, args: dict, n: int) -> list:
    return [(torch.from_numpy(c).cuda(), torch.from_numpy(l).cuda())
            for c, l in run["data"].batches(args["batch"], n)]


def _eager_step(trainer, run: dict):
    def step(clouds, labels):
        return trainer.train_step(run["model"], run["params"], run["opt"],
                                  run["opt_config"], clouds, labels)[1:]
    return step


def _captured_vs_eager(trainer, args: dict) -> dict:
    """:data:`TRAIN_COMPARE_STEPS` steps from seed 0, captured
    (``make_step``) and eager (``train_step``), on fresh states: every
    loss, accuracy and state tensor (parameters, moments, step) bit for
    bit."""
    n = TRAIN_COMPARE_STEPS
    out = {}
    for mode in ("eager", "captured"):
        run = trainer.setup(trainer.parse_args(_argv(args, "unused")))
        step = (_eager_step(trainer, run) if mode == "eager" else
                trainer.make_step(run["model"], run["params"], run["opt"],
                                  run["opt_config"]))
        out[mode] = ([tuple(float(v) for v in step(*b))
                      for b in _batches(run, args, n)], _state_leaves(run))
    check(out["captured"][0] == out["eager"][0],
          f"train: {n} captured steps' losses differ from the eager ones: "
          f"{out['captured'][0]} vs {out['eager'][0]}")
    check(all(torch.equal(a, b) for a, b in zip(out["captured"][1],
                                                  out["eager"][1])),
          f"train: the state after {n} captured steps differs from the "
          f"eager one")
    return {"steps": n, "losses": [l for l, _ in out["eager"][0]],
            "bitwise": True}


def _scatter_gather_rows(x, idx):
    """``gather_rows`` as it was before P4: ``take_along_dim`` with
    autograd's own backward (a scatter-add in no fixed order on the
    card). Only this script swaps it in, to time what P4 replaced."""
    lead = x.shape[:-2]
    flat = idx.reshape(*lead, -1).long()
    out = torch.take_along_dim(x, flat[..., None], dim=-2)
    return out.reshape(*idx.shape, x.shape[-1])


def _eager_times(trainer, args: dict, gather=None) -> dict:
    """Eager steps on the card from a fresh state, on the host clock (each
    ended by reading the loss, as the trainer's loop ends a step):
    :data:`TRAIN_EAGER_STEPS` after :data:`TRAIN_WARMUP`; and one more step
    profiled. ``gather`` replaces ``pointnet2.gather_rows`` for the run."""
    from repro_torch.models import pointnet2 as pn
    real = pn.gather_rows
    if gather is not None:
        pn.gather_rows = gather
    try:
        run = trainer.setup(trainer.parse_args(_argv(args, "unused")))
        step = _eager_step(trainer, run)
        batches = _batches(run, args, TRAIN_WARMUP + TRAIN_EAGER_STEPS + 1)
        ms = []
        for i, b in enumerate(batches[:-1]):
            t0 = time.perf_counter()
            float(step(*b)[0])
            if i >= TRAIN_WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
        rows = _device_rows(lambda: step(*batches[-1]))
    finally:
        pn.gather_rows = real
    med = statistics.median(ms)
    device = sum(r["device_ms"] for r in rows)
    return {"step_ms_median": med, "step_ms_min": min(ms),
            "step_ms_p90": float(np.percentile(ms, 90)),
            "device_ms": device, "device_busy_share": device / med,
            "launches": sum(r["count"] for r in rows),
            "k7_launches": _k7_count(rows), "p4_launches": _p4_count(rows)}


def _k7_count(rows) -> int:
    return sum(r["count"] for r in rows if "fps_loop_kernel" in r["kernel"]
               or "fps_stream_kernel" in r["kernel"])


def _p4_count(rows) -> int:
    return sum(r["count"] for r in rows
               if "gather_rows_backward_kernel" in r["kernel"])


def _train_split(trainer, out: dict, args: dict) -> dict:
    """Where an eager training step's time goes, on the trained model and
    the first batch: the forward (``loss_fn``), the backward
    (``torch.autograd.grad``, each call on a graph of its own) and the
    optimizer (``adamw_update``), each run alone :data:`TRAIN_PROFILE_CALLS`
    times under ``torch.profiler`` (device time and launches per call) and
    as many on the host clock after one more (:func:`_wall_ms`)."""
    from repro_torch.optim import adamw_update, tree_leaves, tree_map
    model, params, opt = out["model"], out["params"], out["opt"]
    clouds, labels = (torch.from_numpy(a).cuda() for a in _first_batch(args))
    leaves = tree_leaves(params)
    n = TRAIN_PROFILE_CALLS

    def forward():
        return model.loss_fn(clouds, labels)[0]

    graphs = iter([forward() for _ in range(2 * n + 1)])
    grads = iter(torch.autograd.grad(forward(), leaves))
    gtree = tree_map(lambda _: next(grads), params)
    split = {}
    for name, fn in (
            ("forward", forward),
            ("backward", lambda: torch.autograd.grad(next(graphs), leaves)),
            ("optimizer", lambda: adamw_update(params, gtree, opt,
                                               out["opt_config"]))):
        rows = _device_rows(fn, calls=n)
        split[name] = {
            "device_ms": sum(r["device_ms"] for r in rows) / n,
            "launches": sum(r["count"] for r in rows) / n,
            "host_ms_median": statistics.median(_wall_ms(fn, n))}
    return split


def _p4_inputs(trainer, args: dict) -> list:
    """P4's operands at the training path's two SA-2 gathers: the
    geometry of the trainer's first batch (centres ``(B, 128)`` and
    neighbours ``(B, 128, 16)`` into SA-1's 512 rows), and upstream
    gradients of SA-1's output width drawn from the seed."""
    from repro_torch.kernels.gather_backward import segments
    from repro_torch.models import pointnet2 as pn
    cfg = trainer.train_config(args["points"])
    clouds, _ = _first_batch(args)
    _, ctr, nbr = pn.geometry_pass(cfg, torch.from_numpy(clouds).cuda())
    n_rows, c = cfg.layers[0].n_centers, cfg.layers[0].mlp[-1]
    rng = np.random.default_rng(SEED)
    cases = []
    for name, idx in (("neighbours", nbr[2]), ("centres", ctr[2])):
        flat = idx.reshape(idx.shape[0], -1)
        g = torch.from_numpy(rng.normal(size=(flat.numel(), c)).astype(
            np.float32)).cuda()
        perm, starts = segments(flat, n_rows)
        cases.append({"name": name, "idx": flat, "grad": g, "perm": perm,
                      "starts": starts, "n_rows": n_rows})
    return cases


def _p4_bound(b: int, p: int, n_rows: int, c: int):
    """Bytes and float32 additions of P4 over ``b`` clouds of ``p``
    positions into ``n_rows`` rows of ``c``: the upstream gradient and the
    int64 indices read once, the gradient rows written once; one addition
    per gradient element."""
    return 4 * b * p * c + 8 * b * p + 4 * b * n_rows * c, b * p * c


def _p4_row(cases, train_launches: int, per_replay: int,
            eager_per_step: int) -> dict:
    """P4 at the training path's two SA-2 gathers: the kernel bit for bit
    against its plain version on the same operands, and the entry point's
    time (stable sort, segment search and kernel), the kernel's alone,
    the plain version's and ``torch.index_add`` (the scatter-add P4
    replaces, in no fixed order) beside the bound."""
    from repro_torch.kernels.gather_backward import (
        gather_rows_backward, gather_rows_backward_cuda,
        gather_rows_backward_plain)
    tot = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "device_ms": 0.0, "bytes": 0, "ops": 0}
    err, per = 0.0, {}
    for case in cases:
        g, perm, starts, idx = (case["grad"], case["perm"], case["starts"],
                                case["idx"])
        got = gather_rows_backward_cuda(g, perm, starts)
        want = gather_rows_backward_plain(g, perm, starts)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        check(torch.equal(got, want), f"P4 {case['name']}: kernel differs "
                                      f"from its plain version by {e}")
        err = max(err, e)
        b, p = idx.shape
        n_rows = case["n_rows"]
        c = g.shape[1]
        grad3 = g.view(b, p, c)
        keys = (idx + n_rows * torch.arange(b, device=idx.device)[:, None]
                ).reshape(-1)
        zeros = torch.zeros((b * n_rows, c), device=g.device)
        row = {"shape": [b, p, n_rows, c],
               "ms": cuda_ms(lambda: gather_rows_backward(grad3, idx,
                                                          n_rows)),
               "kernel_ms": cuda_ms(lambda: gather_rows_backward_cuda(
                   g, perm, starts)),
               "plain_ms": cuda_ms(lambda: gather_rows_backward_plain(
                   g, perm, starts), iters=3, warmup=1),
               "library_ms": cuda_ms(lambda: torch.index_add(zeros, 0, keys,
                                                             g)),
               "device_ms": _device_ms(lambda: gather_rows_backward(
                   grad3, idx, n_rows)),
               "max_segment": int((starts[1:] - starts[:-1]).max())}
        nbytes, ops = _p4_bound(b, p, n_rows, c)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, FP32_OPS_PER_S)
        per[case["name"]] = row
        for key in ("ms", "kernel_ms", "plain_ms", "library_ms",
                    "device_ms"):
            tot[key] += row[key]
        tot["bytes"] += nbytes
        tot["ops"] += ops
    bms, bby = bound(tot["bytes"], tot["ops"], FP32_OPS_PER_S)
    return {
        "name": "P4 gather_rows_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_backward.cu",
        "replaces": "src/repro/models/pointnet2.py:209 (the gradient of "
                    "features[nbr], an XLA scatter-add; no pallas_call) - "
                    "in the port autograd's scatter-add backward of "
                    "torch.take_along_dim",
        "launches": train_launches, "max_abs_err": err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": bms,
        "bound_by": bby, "library_ms": tot["library_ms"],
        "library_call": "torch.index_add into zeros (a scatter-add whose "
                        "order on the card is not fixed)",
        "work": "the backward of the two SA-2 feature gathers of a model0 "
                "training step, batch 16 (1024 points)",
        "kernel_ms": tot["kernel_ms"], "device_ms": tot["device_ms"],
        "launches_per_replay": per_replay,
        "eager_launches_per_step": eager_per_step, "per_gather": per}


def phase_train(smi: str) -> dict:
    """``examples/train_pointnet_torch.py``'s ``main()`` on the card, its
    step captured into one CUDA graph and replayed: model0 unreduced at
    1024 points, batch 16, seed 0, 200 steps, twice. Checks step 0's loss
    and gradients against the port's CPU run on the same batch (loss
    within 1e-6 relative, accuracy equal, every gradient leaf within
    1e-4 x max|g|); the two runs bit for bit equal (every loss and
    accuracy, every parameter, moment and the step); every loss finite and
    the mean of the last 20 below the first 20's; each checkpoint restored
    bit for bit; K7 and P4 at 2 launches a replayed step
    (``torch.profiler`` over one replay: a replay moves no counter, so the
    counters, reset just before a run and read just after, see the two
    warm-ups and the capture: 6 each); :data:`TRAIN_COMPARE_STEPS`
    captured steps bit for bit the eager ones. Prints the captured step's
    median time (host clock, after warm-up), busy share and launches beside
    the eager step's, the eager step with autograd's scatter-add backward
    in P4's place, and the eager forward/backward/optimizer split. Returns
    P4's kernel row and K7's launches in the run."""
    from repro_torch.models.backend import CudaGraphCall
    trainer = _trainer()
    args = TRAIN_ARGS
    t0 = time.perf_counter()
    card = _step0(trainer, args, "cuda")
    cpu = _step0(trainer, args, "cpu")
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    check(loss_rel <= 1e-6, f"train: step 0 loss card {card[0]} vs CPU "
                            f"{cpu[0]} ({loss_rel} relative)")
    check(card[1] == cpu[1], "train: step 0 accuracy card vs CPU")
    grad_err = max(float((g - c).abs().max()) / float(c.abs().max())
                   for g, c in zip(card[2], cpu[2]))
    check(grad_err <= 1e-4, f"train: step 0 gradient card vs CPU "
                            f"{grad_err} x max|g|")
    out, counts = _trainer_run(trainer, args)
    again, _ = _trainer_run(trainer, args)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == args["steps"], "train: every step ran")
    captures = 2 * (CudaGraphCall.WARMUP + 1)
    for name in ("fps", "gather_rows_backward"):
        check(counts[name] == captures,
              f"train: {name} counted {counts[name]} launches, expected "
              f"{captures} (2 a call, two warm-ups and the capture)")
    check(all(np.isfinite(losses)), "train: a loss is not finite")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    check(last < first, f"train: mean loss of the last 20 steps "
                        f"{last} not below the first 20's {first}")
    check([(h["loss"], h["acc"]) for h in hist]
          == [(h["loss"], h["acc"]) for h in again["history"]],
          "train: two runs from seed 0 part (losses or accuracies differ)")
    check(all(torch.equal(a, b) for a, b in zip(_state_leaves(out),
                                                _state_leaves(again))),
          "train: two runs from seed 0 end in different states")
    step_ms = [1e3 * h["seconds"] for h in hist[TRAIN_WARMUP:]]
    step_median = statistics.median(step_ms)
    clouds, labels = (torch.from_numpy(a).cuda() for a in _first_batch(args))
    replay = _device_rows(lambda: out["step"](clouds, labels))
    k7, p4 = _k7_count(replay), _p4_count(replay)
    check(k7 == 2 and p4 == 2, f"train: a replayed step launched K7 {k7} "
                               f"and P4 {p4} times, expected 2 each")
    compare = _captured_vs_eager(trainer, args)
    eager = _eager_times(trainer, args)
    check(eager["k7_launches"] == 2 and eager["p4_launches"] == 2,
          "train: an eager step launches K7 and P4 twice each")
    scatter = _eager_times(trainer, args, gather=_scatter_gather_rows)
    device = sum(r["device_ms"] for r in replay)
    captured = {"step_ms_median": step_median, "step_ms_min": min(step_ms),
                "step_ms_p90": float(np.percentile(step_ms, 90)),
                "device_ms": device, "device_busy_share": device / step_median,
                "launches": sum(r["count"] for r in replay),
                "k7_launches": k7, "p4_launches": p4,
                "port_kernels": _port_rows(replay),
                "top_kernels": replay[:10]}
    split = _train_split(trainer, out, args)
    p4_row = _p4_row(_p4_inputs(trainer, args), counts["gather_rows_backward"],
                     p4, eager["p4_launches"])
    emit({"phase": "train", "nvidia_smi": smi, "model": "model0",
          **args, "loss_first20": first, "loss_last20": last,
          "loss_final": losses[-1],
          "acc_last20": float(np.mean([h["acc"] for h in hist[-20:]])),
          "runs_bitwise_equal": 2,
          "step0": {"loss_card": card[0], "loss_cpu": cpu[0],
                    "loss_rel_err": loss_rel, "acc": card[1],
                    "grad_err_over_max": grad_err},
          "captured": captured, "eager": eager,
          "eager_scatter_add": scatter,
          "p4_adds_ms": {
              "host": eager["step_ms_median"] - scatter["step_ms_median"],
              "device": eager["device_ms"] - scatter["device_ms"]},
          "captured_vs_eager": compare,
          "counters": {k: counts[k] for k in ("fps", "gather_rows_backward")},
          "split": split, "stragglers": out["stragglers"],
          "seconds": time.perf_counter() - t0})
    return {"p4": p4_row, "k7_launches": counts["fps"],
            "k7_launches_per_replay": k7}


def phase_contracts(params, cfgs, clouds_np, smi) -> None:
    """``repro_torch.verify_contracts(..., check_graph=True)`` on every model
    and backend of :data:`PATHS` (the 'pointer' schedule, planning on the
    card), on the batch of 8 and on one cloud: the recorded call and the
    captured one (one replay's kernels by ``torch.profiler``). Any
    violation raises."""
    import repro_torch
    clouds = torch.from_numpy(clouds_np).cuda()
    t0 = time.perf_counter()
    rows = {}
    for name, cfg in cfgs.items():
        for backend in PATHS[name]:
            if backend == "serve":
                continue
            model = repro_torch.compile_model(params[name], cfg,
                                              backend=backend,
                                              schedule="pointer")
            for what, x in (("batch", clouds), ("cloud", clouds[0])):
                report = repro_torch.verify_contracts(model, x,
                                                      check_graph=True)
                report.raise_if_violated()
                info = report.info
                rows[f"{name}/{backend}/{what}"] = {
                    "gather_launches": info.gather_launches,
                    "mlp_launches": info.mlp_launches,
                    "launches": [l.name for l in info.launches],
                    "graph_kernel_launches": report.graph["kernel_launches"],
                    "smem_max": max((max(r["smem_bytes"], default=0)
                                     for r in report.smem_rows.values()),
                                    default=0)}
    emit({"phase": "contracts", "nvidia_smi": smi, "ok": True,
          "models": rows, "seconds": time.perf_counter() - t0})


def phase_profile(name: str, model, host, clouds_np, smi) -> None:
    """Where one batch-8 ``batched_forward`` of ``model`` spends its time,
    in three modes: planning on the host (``host``; its host clock split
    into geometry, host planning — geometry pulled with ``.cpu()``, NumPy
    Algorithm 1, plan lowered to the card — and the rest), planning on the
    card eagerly (the default), and that call captured into a CUDA graph
    (``jit_batched_forward``). For each: the host clock (median of 5), the
    device time by kernel from ``torch.profiler`` over one call, and the
    device's busy share of the unprofiled wall time; and the port's
    kernels in one ``forward``."""
    from repro_torch.models import pointnet2 as pn
    clouds = torch.from_numpy(clouds_np).cuda()
    cfg = model.config
    host.batched_forward(clouds)
    torch.cuda.synchronize()
    split = {"geometry_ms": [], "host_plan_ms": [], "total_ms": []}
    for _ in range(3):
        t0 = time.perf_counter()
        geom = pn.geometry_pass(cfg, clouds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host._device_plan_for(*geom)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.batched_forward(clouds)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split["geometry_ms"].append(1e3 * (t1 - t0))
        split["host_plan_ms"].append(1e3 * (t2 - t1))
        split["total_ms"].append(1e3 * (t3 - t2))
    med = {k: statistics.median(v) for k, v in split.items()}
    med["rest_ms"] = med["total_ms"] - med["geometry_ms"] - med["host_plan_ms"]
    modes = {}
    for mode, fn in (
            ("host_planned", lambda: host.batched_forward(clouds)),
            ("device_planned", lambda: model.batched_forward(clouds)),
            ("captured", lambda: model.jit_batched_forward(clouds))):
        wall = statistics.median(_wall_ms(fn))
        rows = _device_rows(fn)
        busy = sum(r["device_ms"] for r in rows)
        modes[mode] = {"wall_ms_median": wall, "device_busy_ms": busy,
                       "device_busy_share": busy / wall if rows else None,
                       "device_kernels": len(rows),
                       "kernel_launches": sum(r["count"] for r in rows),
                       "port_kernels": _port_rows(rows),
                       "top_kernels": rows[:12]}
    emit({"phase": "profile", "nvidia_smi": smi, "model": cfg.name,
          "path": name, "batch": BATCH, "host_clock_split_ms": med,
          "modes": modes,
          "forward_port_kernels": _port_rows(
              _device_rows(lambda: model.forward(clouds[0])))})


def _device_rows(fn, calls: int = 1) -> list:
    """Device time by kernel name over ``calls`` calls of ``fn``, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            rows.append({"kernel": e.key[:80], "count": e.count,
                         "device_ms": t / 1e3})
    return sorted(rows, key=lambda r: -r["device_ms"])


def _port_rows(rows) -> list:
    return [r for r in rows if any(name in r["kernel"]
                                   for name in PORT_KERNELS)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.models.pointnet2 import init_params

    smi = smi_line()
    info = phase_device(smi)
    phase_build()
    cfgs = {m: repro_torch.PAPER_MODELS[m] for m in PATHS}
    params = {m: init_params(cfg, seed=SEED) for m, cfg in cfgs.items()}
    clouds_np = make_clouds(1024, BATCH, SEED)
    # first, so that model0's MLPs are K2's first launches in the process
    # (a launch at exactly 48 KB of dynamic shared memory)
    phase_dataflow(params, cfgs, smi)

    def compile_path(name, backend, **kw):
        m = name.partition("/")[0]
        return repro_torch.compile_model(params[m], cfgs[m], backend=backend,
                                         schedule="pointer", **kw)
    models = {m: compile_path(m, "reram-fused") for m in cfgs}
    models["model2/reram"] = compile_path("model2", "reram")
    hosts = {name: compile_path(name, name.partition("/")[2]
                                or "reram-fused", device_planning=False)
             for name in ("model1", "model2", "model2/reram")}
    cases = phase_kernel_vs_plain(models, torch.from_numpy(clouds_np).cuda())
    cases2 = phase_model2_kernels(models["model2"], params["model2"])
    fps_cases = phase_fps_vs_plain(clouds_np)
    plan_cases = phase_plan_vs_plain(models, clouds_np)
    counts_of = phase_end_to_end(params, cfgs, clouds_np)
    phase_policy(params["model2"], cfgs["model2"], clouds_np,
                 models["model2"])
    phase_reliability(params["model2"], cfgs["model2"], params["model0"],
                      cfgs["model0"], clouds_np, models["model2"])
    phase_quickstart()
    kernels = phase_times(cases, cases2, fps_cases, plan_cases, counts_of,
                          models, hosts, clouds_np, smi)
    for name, host in hosts.items():
        phase_profile(name, models[name], host, clouds_np, smi)
    serve_counts = phase_serve(params["model2"], cfgs["model2"],
                               models["model2"], smi)
    phase_contracts(params, cfgs, clouds_np, smi)
    train = phase_train(smi)
    kernels.append(train["p4"])
    check(set(SERVE_KERNELS) <= {k["name"] for k in kernels},
          "a served kernel has no row")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
        if k["name"] in SERVE_KERNELS:
            k["serve_launches"] = serve_counts[SERVE_KERNELS[k["name"]]]
            check(k["serve_launches"] > 0,
                  f"{k['name']} never launched on the served path")
        if k["name"] == "K7 fps":
            k["train_launches"] = train["k7_launches"]
            k["train_launches_per_replay"] = train["k7_launches_per_replay"]
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
