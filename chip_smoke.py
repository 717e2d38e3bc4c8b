#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --profiler-loss   # why profiles settle first

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
   and convolutions, and bf16 GEMMs reducing in float32;
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
   steps bit for bit the eager ones; P4 at the step's two SA-2 gathers
   (``_p4_case``): the card's sort ``torch.equal`` to ``segments()``, the
   fused launch, the segment sum and the entry point bit for bit against
   the plain version. Printed: the captured step's
   median time, busy share and launches beside the eager step's, the eager
   step with autograd's scatter-add backward in P4's place, and the eager
   forward/backward/optimizer split (``torch.profiler``).
10. lm: the LM stack's serving path (no hand kernel: the reference's LM
   reaches no ``pallas_call``) on qwen1.5-0.5b at its published width and
   depth in bf16, the port's own weights from seed 0: ``generate`` on 4
   prompts of 1000 tokens with 64 new, greedy, through ``ServingEngine``,
   ``LMServable`` and the prefill and decode step captured as CUDA graphs;
   then one prompt of 2048 tokens. Prefill's logits and each teacher-forced
   decode step's against ``forward``'s within ``LM_BF16_BOUND`` of the
   largest logit, argmax equal where the top-2 gap exceeds twice that; 3
   captured decode steps bit for bit the eager ``decode_step`` on a copy of
   the cache; a second ``generate`` the same tokens with no new capture;
   the model in float32 against the port's CPU run on a 64-token prompt,
   and ``reduced()`` of every config of the six families (vlm's gate
   non-zero; moe's expert choices first, equal to the CPU's unless the
   router's margin there is below ``LM_ROUTE_TIE``) against ``forward`` and
   the CPU, within ``LM_F32_BOUND``.
   Printed: the prefill's host-clock and device time beside its operations
   bound, the decode step captured and eager, tokens/s at batch 4, one
   replayed step's device time, busy share and launches beside its bytes
   bound.
11. lm_families: the moe, ssm and hybrid families served the same way, one
   model at a time (captures cleared, weights freed and the allocator's
   cache emptied between them), bf16, the port's weights from seed 0:
   rwkv6-3b and zamba2-7b at their published width and depth,
   llama4-scout-17b-a16e at its published width cut to 8 of 48 layers
   (the 48 hold 203 GB). Per model: ``generate`` on 4 prompts of 1000
   tokens with 64 new, a second one the same with no new capture; 3
   captured decode steps bit for bit the eager ones; prefill and
   teacher-forced decode against ``forward`` (prefill and the first
   decode step within ``LM_BF16_BOUND``, every step within the family's
   ``LM_FAMILY_BF16_BOUND``) on 4 prompts of 1024 tokens (on both
   state-space chunks: off them the reference's decode itself departs
   from ``forward``), llama4-scout there at ``capacity_factor`` =
   ``n_experts`` (dropless), each expert choice that differs from
   ``forward``'s a near tie of the router (``LM_MOE_FLIP_MARGIN``), a row
   compared up to its first such choice below the last layer (the count
   of token-steps compared printed); at the published 1.25 the tokens
   dropped per layer by the prefill and by each decode step; each model
   also in float32 at the same width (llama4-scout at 2 layers), prefill
   and 63 decode steps on random tokens against ``forward``, within
   twice ``forward``'s own noise (``LM_F32_WIDE``: a row's logits alone
   against the batch's). Printed beside the bounds (``lm_prefill_flops``,
   ``lm_decode_bytes`` with the timed step's routed experts counted on
   the card): the prefill's and the decode step's times, device time,
   busy share and launches, and the peak of allocated memory.
12. distributed (after train, before lm): the distributed layer
   (``repro_torch.launch``: ``mesh``, ``sharding``, ``collectives``,
   ``pipeline``) over NCCL at world size 1 (the card machine has one
   card; multi-rank parity runs on gloo in ``tests/
   test_torch_distributed.py``), on ``make_test_mesh((1, 1))`` and
   ``make_replica_mesh(1)``. (a) The TP head layout at published width and
   depth: qwen1.5-4b from seed 0 at tp 16 (20 MHA heads padded to 32)
   against tp 1, 4 prompts of 1000 tokens, the prefill and 8
   teacher-forced captured decode steps within ``DIST_TP_BOUND``; tp 16's 8
   captured steps bit for bit eager ones. (b) ``make_train_step(...,
   mesh=)`` on qwen1.5-0.5b at published width and depth, 2 x 1024, state
   and batch placed by ``state_pspecs``/``input_pspecs``: 3 steps' losses
   and every leaf bit for bit the unsharded (captured) step's;
   ``compressed_psum``, ``pipeline_forward`` and ``overlapped_tp_matmul``
   on one rank bit for bit ``int8_dequantize(int8_quantize(x))``, the stage
   and the product; one eager sharded step counted under
   ``FlopCounterMode`` with the allocator's peak reset before it (phase
   ``dryrun`` reads it). (c) model2 'reram-fused' through
   ``PointCloudServable(mesh=make_replica_mesh(1))``: rows bit for bit
   ``mesh=None``'s on a fresh model, the launch counters equal and held to
   the captures and plan builds (``PATHS["model2"]["serve_replica"]``).
   (d) One published layer each (``DIST_EMU_LAYERS``: qwen1.5-4b's,
   llama4-scout's MoE layer with 4 GB of experts, a llama-3.2-vision
   crossed layer, a zamba2-7b Mamba2 layer and its shared block, an
   rwkv6-3b layer; the state-space and crossed ones in float32) at tp 16
   as 16 rank
   slices through the sharded step's tensor-parallel Functions
   (``launch/tp.py``), forward and backward, against the unsplit layer:
   the output and every gradient within ``DIST_EMU_BOUND``. (e) (a)'s
   qwen1.5-4b at tp 1 through the sharded prefill and decode step
   (``make_prefill`` / ``make_serve_step(..., mesh=)``, the weights placed
   by ``param_pspecs``, the cache by ``cache_pspecs``): the prefill of 4 x
   1000 tokens and 8 teacher-forced decode steps, logits and every cache
   leaf bit for bit ``lm.prefill`` / ``lm.decode_step``'s, both eager, their
   times side by side.
   Printed: prefill and decode times, peak memory and the KV caches'
   bytes at 32 heads against 20; the sharded step's time (per-layer
   gathers) beside the unsharded step's, captured and eager, and beside
   the earlier whole-model gather's; the gathered bytes a step, the
   device memory the sharded and the eager unsharded step each take beyond
   what was allocated before them, and the bytes of the weights' copies a
   sharded step keeps for its backward; (d)'s errors and times; (e)'s
   times and gathered bytes.
13. lm_train: LM training (``repro_torch.launch.train``; no hand kernel
   but P4, the embedding's and the MoE dispatch's gradient). (a)
   ``run_training`` on qwen1.5-0.5b at published width and depth, bf16,
   float32 moments, the published ``cfg.remat`` (each layer checkpointed
   and recomputed in the backward), the port's weights from seed 0, 2 x
   4096 tokens of one repeated ``TokenStream`` batch (seed 0), 4 steps:
   two eager warm-ups, then one CUDA graph a step; every loss finite, the
   last below step 0's; two runs bit for bit (every metric, every leaf); 4
   eager steps bit for bit the first 4 through ``make_train_step``; P4
   counted 3 times in a run (its warm-ups and the capture: 1 a step) and
   once in a replay (``torch.profiler``); 2 eager steps without remat,
   their losses bit for bit the run's, their peak memory and step times
   printed beside the run's and (a)'s eager steps with remat. (b)
   qwen1.5-0.5b at published width, 2 of 24 layers, float32, 2 x 256: the
   loss within 1e-6 relative and every gradient leaf within 1e-4 x max|g|
   of the port's CPU run. (c) every
   config at ``reduced()``, float32: the same against the CPU (moe's
   expert choices equal; rwkv6, at its float32 conditioning's limit, held
   to the float64 gradient instead), and 4 captured steps bit for bit the
   eager ones, twice. (d) bf16, 2 x 1024: rwkv6-3b at 2 of 32 layers,
   zamba2-7b at one ``attn_interval`` group (6 Mamba2 layers and the
   shared block), llama4-scout at 1 of 48 (bf16 moments: ``LM_TRAIN_WIDE``
   says why): 4 captured steps bit for bit the eager ones, twice, P4 per
   replay as ``PATHS["lm_train"]``. Printed: the step's host clock
   (median, min, p90) captured and eager, device time, busy share,
   launches and peak memory beside the bound (``lm_train_flops``: 6 x
   parameters x tokens of bf16 GEMMs at 989 TFLOP/s, attention's products
   over the chunk pairs the causal mask leaves apart: those of bf16
   operands at 989, those of a float32 operand at 67 TFLOP/s); P4's
   radix sort launched in (a)'s run and in its replay; P4 (``_p4_case``)
   at the embedding's gradient and at llama4-scout's MoE dispatch gather (2 x 1024 tokens of 5120): sort
   ``torch.equal`` to ``segments()``, sums bit for bit the plain version,
   times (entry, kernel, sort, ``index_add`` and their device times)
   beside the bound.

14. dryrun (last; its subprocesses start after every timed phase, so
   that no time is taken while they load the CPU): the dry run (``repro_torch.launch.dryrun``, no
   card): ``distributed`` (b)'s step counted on ``meta`` as rank 0 of a fake
   world of 1, its operations exactly the card's count and its peak bytes
   within ``DRYRUN_PEAK_BOUND`` of the card's, both printed, its roofline
   bound (H100 spec-sheet peaks) beside the step's measured eager time and
   the unsharded step's replay; qwen1.5-0.5b's ``train_4k`` and
   ``decode_32k`` cells on the 'single' production mesh through
   ``python -m repro_torch.launch.dryrun``, each ``ok``, their records
   printed.

Then one ``{"kernels": [...]}`` line (``serve_launches``: a kernel's
launches in the serve phase's runs; ``replica_launches``: in the
distributed phase's replica run; ``train_launches``: K7's in the train
phase's run, ``train_launches_per_replay`` its launches in one replayed
step; P4's row, whose ``launches`` are its counter in the train phase's
run, ``lm_train_launches`` and ``lm_train_launches_per_replay`` its
counts in the lm_train phase's full-width run, ``lm_embedding`` and
``lm_moe_dispatch`` its times there; the
row of P4's radix sort, its ``launches`` the sort's kernels in that run),
the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Any failure
raises, so the exit code is not 0 and the last line is never printed. It
needs a CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W) and
# the LM stack's bounds live in the port's roofline module.
from repro_torch.launch.hlo_analysis import (  # noqa: E402
    FP32_FLOPS as FP32_OPS_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_OPS_PER_S, _causal_chunk_pairs, lm_decode_bytes,
    lm_prefill_flops, lm_train_flops)

#: H100 SXM int8 dense tensor-core peak (NVIDIA data sheet, at 700 W)
INT8_OPS_PER_S = 1979e12

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
    # bf16 GEMMs accumulate in float32, as XLA's do (the lm phase)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction}
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
    # LM training (phase ``lm_train``): P4 launches in one training step of
    # each config it runs at published width: the embedding's gradient,
    # and per MoE layer the dispatch's three row gathers (llama4-scout at
    # 1 layer); a run counts them in its two eager warm-ups and the capture
    "lm_train": {"qwen1.5-0.5b": {"gather_rows_backward": 1},
                 "rwkv6-3b": {"gather_rows_backward": 1},
                 "zamba2-7b": {"gather_rows_backward": 1},
                 "llama4-scout-17b-a16e": {"gather_rows_backward": 4}},
}
# replica fan-out (phase ``distributed``): a served step per batch bucket on
# each replica's slice of the batch; on one card the one replica's slice is
# the whole batch, so the served path's counts
PATHS["model2"]["serve_replica"] = PATHS["model2"]["serve"]
MLP_COUNTERS = ("fused_mlp", "fused_mlp_layer", "fused_mlp_mtiled",
                "fused_mlp_mtiled_layer", "fused_mlp_wstat",
                "fused_mlp_wstat_layer", "fused_mlp_combine",
                "reram_matmul_int", "reram_combine")

#: The port's kernels by the names ``torch.profiler`` gives them.
PORT_KERNELS = ("fused_mlp_", "wstat_", "combine_", "aggregate_diff",
                "reram_matmul", "fps_", "greedy_kernel", "coordinate_kernel",
                "gather_rows_backward_kernel", "segments_")

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
            if backend.startswith("serve"):   # phases serve, distributed
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
    back-to-back calls measures the host."""
    fn()
    torch.cuda.synchronize()
    rows = _device_rows(fn, calls)
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


def _served_counts(model, builds: int, per_step: dict) -> dict:
    """The launches a served run on ``model`` must count: a capture calls
    the step ``CudaGraphCall.WARMUP`` times on a side stream, then once
    under capture (a replay moves no counter), each call ``per_step`` at
    its batch with K7 and the gather twice; each of ``builds`` plan-cache
    misses builds a plan (K7 twice, P1 and P2 once)."""
    from repro_torch.models.backend import CudaGraphCall
    calls = (CudaGraphCall.WARMUP + 1) * model.captures
    want = {"fps": 2 * calls + 2 * builds, "plan_greedy": builds,
            "plan_coordinate": builds, "aggregate_diff_batched": 2 * calls}
    for key in model._graphs:        # (entry, operands, (clouds' shape, …))
        for c, n in per_step[key[2][0][0]].items():
            want[c] = want.get(c, 0) + (CudaGraphCall.WARMUP + 1) * n
    return want


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
    want = _served_counts(model, builds, PATHS["model2"]["serve"])
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


#: P4's radix-sort counters (``launch_counts()``): its passes' two kernels
#: and the boundary pass
SEGMENTS_COUNTERS = ("segments_count", "segments_scatter", "segments_bounds")


def _segments_count(rows) -> int:
    """Launches of P4's radix sort (its passes and the boundary pass)."""
    return sum(r["count"] for r in rows if "segments_" in r["kernel"])


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
        cases.append({"name": name, "idx": flat, "grad": g,
                      "n_rows": n_rows})
    return cases


def _p4_bound(b: int, p: int, n_rows: int, c: int):
    """Bytes and float32 additions of P4 over ``b`` clouds of ``p``
    positions into ``n_rows`` rows of ``c``: the upstream gradient and the
    int64 indices read once, the gradient rows written once; one addition
    per gradient element."""
    return 4 * b * p * c + 8 * b * p + 4 * b * n_rows * c, b * p * c


#: The torch ops P4's entry may run on the card: allocations and views
P4_ENTRY_OPS = {"empty", "view", "_unsafe_view", "_reshape_alias", "alias",
                "as_strided", "detach"}


def _aten_ops(fn) -> list:
    """The aten ops ``fn()`` dispatches, by name (no device involved: a
    dispatch mode sees each op as it is called)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Log() as log:
        fn()
    return log.ops


#: P4's kernels, as the card names them
P4_KERNELS = ("gather_rows_backward_kernel",
              "gather_rows_backward_kernel_fused", "segments_count_kernel",
              "segments_scatter_kernel", "segments_bounds_kernel")


def _captured_nodes(fn) -> list:
    """The nodes of a CUDA graph capture of one call of ``fn``, in the
    order of ``cudaGraphDebugDotPrint``'s dump: a kernel of
    :data:`P4_KERNELS` by its name, any other node by its dump's first
    words. Unlike a profiler session, which late in the script may record
    nothing, the capture holds every launch of the call."""
    import re
    import tempfile
    import warnings
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.dot")
        with warnings.catch_warnings():  # its DEBUG notes, one a call
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        dot = pathlib.Path(path).read_text()
    graph.reset()
    names = "|".join(sorted(P4_KERNELS, key=len, reverse=True))
    nodes = []
    for block in re.split(r'\n\s*"[^"\n]+"\s*\[', dot)[1:]:
        m = re.search(names, block)
        nodes.append(m.group(0) if m else " ".join(block.split())[:80])
    return nodes


def _call_device_ms(fn, recorded=None, calls: int = 5):
    """Device time of one call of ``fn``: ``torch.profiler``'s total over
    ``calls`` calls, divided by the calls it recorded, ``recorded(rows)``
    (default: the most launches of one kernel, for a ``fn`` that launches
    each of its kernels once). A session may lose launches
    (:data:`PROFILE_SETTLE_S`), the more so as calls of microseconds take
    a fraction of a millisecond, and late in the script some recorded
    none: each session follows a call of ``fn`` outside it, and while the
    sessions miss calls another starts, past the third only while none
    recorded any (:data:`CALL_PROFILE_SETTLES_S`); the one that recorded
    the most counts. -> (ms or None where none recorded, its rows, its
    recorded calls)."""
    best, n = [], 0
    for i, settle in enumerate(CALL_PROFILE_SETTLES_S):
        if n >= calls or (n and i >= 3):
            break
        fn()
        rows = _device_rows(fn, calls=calls, settle=settle)
        got = (recorded(rows) if recorded
               else max((r["count"] for r in rows), default=0))
        if got > n:
            best, n = rows, got
    return (sum(r["device_ms"] for r in best) / n if n else None), best, n


def _p4_case(idx, g, n_rows: int, what: str) -> dict:
    """P4 on one gather's operands on the card (``idx`` int64 ``(L, P)``,
    ``g`` float32 ``(L * P, C)``): the radix sort ``torch.equal`` to
    ``segments()``, and bit for bit against the plain version the entry
    point, the kernel that sums (the fused launch, whose sort is in shared
    memory, where :func:`fused_fits`; else the segment sum on the sort's
    output) and the segment sum alone; then the times (CUDA events) of the
    entry, the kernel, the radix sort where the entry runs it, the plain
    version and ``segments()``, and ``torch.index_add`` (the scatter-add
    P4 replaces, in no fixed order), and the device times
    (``torch.profiler``) of the entry, the kernel and ``index_add``,
    beside the bound. The entry must run no torch op but allocations and
    views (:data:`P4_ENTRY_OPS`: no ``torch.sort``, ``searchsorted`` or
    ``arange``), a CUDA graph capture of it must hold its segment sum and
    no node but P4's kernels (:func:`_captured_nodes`), and its profile,
    where a session recorded it, no kernel but P4's."""
    from repro_torch.kernels import gather_backward as gb
    b, p = idx.shape
    c = g.shape[1]
    grad3 = g.view(b, p, c)
    perm, starts = gb.segments(idx, n_rows)
    want = gb.gather_rows_backward_plain(g, perm, starts)
    got = gb.gather_rows_backward(grad3, idx, n_rows).reshape(-1, c)
    summed = gb.gather_rows_backward_cuda(g, perm, starts)
    sp, ss = gb.segments_cuda(idx, n_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    check(torch.equal(got, want), f"P4 {what}: the entry point differs from "
                                  f"the plain version by {err}")
    check(torch.equal(summed, want), f"P4 {what}: the segment sum differs "
                                     f"from the plain version")
    check(torch.equal(sp, perm) and torch.equal(ss, starts),
          f"P4 {what}: the card's sort differs from segments()")
    fused = gb.fused_fits(b, p, n_rows)
    row = {"shape": [b, p, n_rows, c], "max_abs_err": err,
           "max_segment": int((starts[1:] - starts[:-1]).max()),
           "path": "fused" if fused else "radix"}
    if fused:
        kernel = functools.partial(gb.gather_rows_backward_fused_cuda, g,
                                   idx, n_rows)
        check(torch.equal(kernel(), want), f"P4 {what}: the fused launch "
                                           f"differs from the plain version")
    else:
        kernel = functools.partial(gb.gather_rows_backward_cuda, g, perm,
                                   starts)
        row["sort_ms"] = cuda_ms(lambda: gb.segments_cuda(idx, n_rows))
        row["sort_bytes"] = 16 * b * p + 8 * (b * n_rows + 1)
    zeros = torch.zeros((b * n_rows, c), device=g.device)
    keys = (idx + n_rows * torch.arange(b, device=idx.device)[:, None]
            ).reshape(-1)

    def entry():
        return gb.gather_rows_backward(grad3, idx, n_rows)

    def index_add():
        return torch.index_add(zeros, 0, keys, g)
    # the card's path runs no torch op but allocations and views (so no
    # torch.sort, searchsorted or arange), and a capture of it holds its
    # segment sum and no node but P4's kernels
    ops = sorted(set(_aten_ops(entry)))
    check(set(ops) <= P4_ENTRY_OPS, f"P4 {what}: the entry ran {ops}")
    nodes = _captured_nodes(entry)
    check(any(n.startswith("gather_rows_backward_kernel") for n in nodes)
          and all(n in P4_KERNELS for n in nodes),
          f"P4 {what}: a capture of the entry holds {nodes}")
    device_ms, rows, calls = _call_device_ms(entry, _p4_count)
    names = [r["kernel"] for r in rows]
    check(all(any(k in n for k in P4_KERNELS) for n in names),
          f"P4 {what}: the entry launched {names}")
    row.update({
        "entry_ops": ops, "captured_nodes": nodes, "device_ms": device_ms,
        "profiled_calls": calls,
        "entry_kernels": {r["kernel"]: r["count"] / calls for r in rows},
        "ms": cuda_ms(entry), "kernel_ms": cuda_ms(kernel),
        "sum_ms": cuda_ms(functools.partial(gb.gather_rows_backward_cuda, g,
                                            perm, starts)),
        # the call that made ``want`` was the plain version's warm-up
        "plain_ms": cuda_ms(lambda: gb.gather_rows_backward_plain(
            g, perm, starts), iters=1, warmup=0),
        "plain_sort_ms": cuda_ms(lambda: gb.segments(idx, n_rows)),
        "library_ms": cuda_ms(index_add),
        "kernel_device_ms": _call_device_ms(kernel, _p4_count)[0],
        "library_device_ms": _call_device_ms(index_add)[0]})
    nbytes, ops = _p4_bound(b, p, n_rows, c)
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops, FP32_OPS_PER_S)
    row["bytes"], row["ops"] = nbytes, ops
    return row


def _p4_row(cases, train_launches: int, per_replay: int,
            eager_per_step: int) -> dict:
    """P4 at the training path's two SA-2 gathers (:func:`_p4_case` each:
    the fused launch, sort and sum in one), summed over the two into the
    kernel row."""
    tot = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "device_ms": 0.0, "kernel_device_ms": 0.0,
           "library_device_ms": 0.0, "bytes": 0, "ops": 0}
    err, per = 0.0, {}
    for case in cases:
        row = _p4_case(case["idx"], case["grad"], case["n_rows"],
                       f"SA-2 {case['name']}")
        per[case["name"]] = row
        err = max(err, row["max_abs_err"])
        for key in tot:       # None: a profile that recorded nothing
            tot[key] = (None if tot[key] is None or row[key] is None
                        else tot[key] + row[key])
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
        "kernel_device_ms": tot["kernel_device_ms"],
        "library_device_ms": tot["library_device_ms"],
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


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

#: the lm phase's model: qwen1.5-0.5b at its published width and depth,
#: bf16, the port's own random weights from SEED
LM_ARCH = "qwen1.5-0.5b"
#: ``ArchConfig.n_params()`` of the published qwen1.5-0.5b
LM_PARAMS = 463_863_808
LM_BATCH = 4
#: not a multiple of q_chunk 512: the padded query chunk runs 2 blocks
#: (kv_chunk clamps to the prompt, so the keys are not padded here)
LM_PROMPT = 1000
LM_NEW = 64
#: 4 query chunks by 2 key chunks, no padding
LM_LONG_PROMPT = 2048
LM_LONG_NEW = 8
LM_F32_PROMPT = 64
LM_F32_NEW = 4
#: captured decode steps held bit for bit against eager ones
LM_BITWISE_STEPS = 3
#: decode steps timed back to back (host clock, one synchronize)
LM_TIMED_STEPS = 20
#: bf16 logits of the card (prefill, teacher-forced decode) against
#: ``forward``'s, as a fraction of the largest |logit| of the rows compared
LM_BF16_BOUND = 0.04
#: float32 logits against the port's CPU run, and prefill/decode against
#: ``forward``, as a fraction of the largest |logit|
LM_F32_BOUND = 1e-4
#: vlm's cross-attention gate on the card's reduced run (``tanh(0)`` at
#: init would hide the cross-attention)
LM_GATE_X = 0.5


def lm_prompts(cfg, batch: int, seq: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _to_cpu(tree):
    from repro_torch.optim import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def _lm_compare(pairs, bound: float, what: str) -> dict:
    """Each (logits, reference) pair within ``bound`` x max|reference| of
    all the pairs; argmax equal wherever the reference's top-2 gap exceeds
    twice that."""
    scale = max(float(r.float().abs().max()) for _, r in pairs)
    err = max(float((a.float() - r.float()).abs().max()) for a, r in pairs)
    checked = equal = 0
    for a, r in pairs:
        top2 = r.float().topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * bound * scale
        same = a.float().argmax(-1) == r.float().argmax(-1)
        checked += int(sure.sum())
        equal += int((same & sure).sum())
    check(err <= bound * scale, f"lm: {what}: logits {err} off, bound "
                                f"{bound} x {scale}")
    check(equal == checked, f"lm: {what}: argmax differs in "
                            f"{checked - equal} of {checked} rows")
    return {"err_over_max": err / scale, "max_abs_logit": scale,
            "rows_argmax_checked": checked}


def _lm_replay(sess, prompts, tokens):
    """The session's captured prefill and decode steps over ``prompts``
    then ``tokens`` (teacher-forced): the prefill's logits and each step's."""
    s, n = prompts.shape[1], tokens.shape[1] - prompts.shape[1]
    positions = torch.arange(s, s + n, dtype=torch.int32, device="cuda")
    last, cache = sess.prefill(prompts)
    steps = []
    for i in range(n - 1):
        lg, cache = sess.decode(cache, tokens[:, s + i:s + i + 1],
                                positions[i])
        steps.append(lg)
    return last, steps


def _lm_against_forward(params, cfg, sess, prompts, out, bound, what,
                        decode_bound=None):
    """Prefill's logits within ``bound``, the first teacher-forced decode
    step's within :data:`LM_BF16_BOUND` and each step's within
    ``decode_bound`` (``bound`` when None) against ``forward`` over the
    prompt and the generated tokens; the replay's argmaxes are the
    generated tokens. A moe config goes through
    :func:`_moe_against_forward`."""
    from repro_torch.models import lm
    if cfg.family == "moe":
        return _moe_against_forward(params, cfg, sess, prompts, out, bound,
                                    what, decode_bound)
    s = prompts.shape[1]
    last, steps = _lm_replay(sess, prompts, out)
    _check_replayed_tokens(last, steps, out, s, what)
    with torch.inference_mode():
        full, _ = lm.forward(params, cfg, out)
    decode = [(lg, full[:, s + i]) for i, lg in enumerate(steps)]
    res = {"prefill": _lm_compare([(last, full[:, s - 1])], bound,
                                  f"{what} prefill vs forward"),
           "first_decode": _lm_compare(decode[:1], LM_BF16_BOUND,
                                       f"{what} first decode step vs "
                                       f"forward"),
           "decode": _lm_compare(decode, decode_bound or bound,
                                 f"{what} decode vs forward")}
    res["decode"]["per_step_err_over_max"] = _per_step_err(decode)
    del full
    return res


def _per_step_err(pairs) -> list:
    """Each pair's largest |difference| over the largest |reference| of
    all the pairs."""
    scale = max(float(r.float().abs().max()) for _, r in pairs)
    return [float((a.float() - r.float()).abs().max()) / scale
            for a, r in pairs]


def _check_replayed_tokens(last, steps, out, s: int, what: str) -> None:
    check(torch.equal(last.argmax(-1).int(), out[:, s])
          and all(torch.equal(lg.argmax(-1).int(), out[:, s + 1 + i])
                  for i, lg in enumerate(steps)),
          f"lm: {what}: the replayed steps' argmaxes are not the "
          f"generated tokens")


@contextlib.contextmanager
def record_routes():
    """Within the block, each eager ``moe_apply`` call appends its routing
    to the yielded list, as ``moe._route_local`` returns it: ``{"logits"
    (T, E) float32, "top_idx" (T, k), "keep" (T·k,) bool in expert order,
    "cap"}`` (``_route_local`` is wrapped for the block; a captured graph
    calls nothing)."""
    from repro_torch.models import moe
    real, rec = moe._route_local, []

    def recording(x, router_w, top_k, cap, e):
        out = real(x, router_w, top_k, cap, e)
        rec.append({"logits": out[3], "top_idx": out[2], "keep": out[1][3],
                    "cap": cap})
        return out
    moe._route_local = recording
    try:
        yield rec
    finally:
        moe._route_local = real


#: a moe token whose expert choice on the serving path differs from
#: ``forward``'s at the same position is a near tie of the router: its
#: margin in ``forward`` (top-k-th logit over the next) must be below this
#: fraction of the layer's max |router logit|. bf16 rounding differs
#: between the serving path's GEMMs (4 rows a step) and the forward's, and
#: one flipped choice below the last layer changes that token's hidden
#: state from there on, so that row is compared no further
LM_MOE_FLIP_MARGIN = 0.02


def _route_flips(serving: list, fwd: list, tokens, rows, k: int,
                 live) -> list:
    """Per layer, the serving path's routes (``rows`` x positions from
    ``tokens`` on) against ``forward``'s (recorded over the whole sequence)
    at the same positions, for each ``live`` row whose choices differ: its
    first difference (lowest layer, then position; the later ones follow
    from it) or, where that is at the last layer, every difference (each
    changes its own position's logits only, and each is its own near tie),
    as ``{row, position, layer, last_layer, margin,
    max_abs_router_logit}``, the margin and scale ``forward``'s."""
    found = {}
    for layer, (a, b) in enumerate(zip(serving, fwd)):
        got = a["top_idx"].reshape(rows, -1, k)
        n = got.shape[1]
        want = b["top_idx"].reshape(rows, -1, k)[:, tokens:tokens + n]
        logits = b["logits"].reshape(rows, -1, b["logits"].shape[-1])[
            :, tokens:tokens + n]
        scale = float(b["logits"].abs().max())
        for row, pos in (got != want).any(dim=-1).nonzero().tolist():
            if not bool(live[row]) or (
                    row in found and found[row][0]["layer"] < layer):
                continue
            top = logits[row, pos].sort(descending=True).values
            found.setdefault(row, []).append(
                {"row": row, "position": tokens + pos, "layer": layer,
                 "last_layer": layer == len(serving) - 1,
                 "margin": float(top[k - 1] - top[k]),
                 "max_abs_router_logit": scale})
    return [f for row in found.values()
            for f in (row if row[0]["last_layer"] else row[:1])]


def _eager_against_forward(params, cfg, tokens, s: int, tie: float,
                           what: str, replay=None) -> dict:
    """Prefill over ``tokens[:, :s]`` and the teacher-forced decode steps
    over the rest, run eagerly under :func:`record_routes`, against
    ``forward`` over ``tokens``. For moe each expert choice is held to
    ``forward``'s (:func:`_route_flips`): a choice that differs must be a
    near tie (margin below ``tie`` x max|router logit|); one at the last
    layer leaves out that position's logits only, one below it the row
    from there on (its hidden states are another sequence's). With
    ``replay`` (the prefill's logits and each step's), each eager result
    must equal it bit for bit. Returns the compared pairs (``prefill``, a
    list; ``steps``, per step a pair or None), the flips, the rows
    compared per step and the token-steps compared of all."""
    from repro_torch.models import lm
    b, n = tokens.shape[0], tokens.shape[1] - s
    k = cfg.experts_per_token
    flips = []
    with torch.inference_mode():
        with record_routes() as fwd:
            full, _ = lm.forward(params, cfg, tokens)
        with record_routes() as pre:
            last, cache = lm.prefill(params, cfg, tokens[:, :s],
                                     max_seq=s + n)
        if replay is not None:
            check(torch.equal(last, replay[0]),
                  f"lm: {what}: the eager prefill differs from the replay")
        live = torch.ones(b, dtype=torch.bool, device=tokens.device)
        shown = live.clone()
        for f in _route_flips(pre, fwd, 0, b, k, live):
            flips.append(dict(f, step="prefill"))
            if not f["last_layer"] or f["position"] == s - 1:
                shown[f["row"]] = False
            if not f["last_layer"]:
                live[f["row"]] = False
        prefill = [(last[shown], full[shown, s - 1])] if shown.any() else []
        steps, held = [], []
        for i in range(n - 1):
            with record_routes() as rec:
                lg, cache = lm.decode_step(params, cfg, cache,
                                           tokens[:, s + i:s + i + 1], s + i)
            if replay is not None:
                check(torch.equal(lg, replay[1][i]),
                      f"lm: {what}: eager step {i} differs from the replay")
            shown = live.clone()
            for f in _route_flips(rec, fwd, s + i, b, k, live):
                flips.append(dict(f, step=i))
                shown[f["row"]] = False
                if not f["last_layer"]:
                    live[f["row"]] = False
            held.append(int(shown.sum()))
            steps.append((lg[shown], full[shown, s + i]) if shown.any()
                         else None)
        del cache, full
    for f in flips:
        check(f["margin"] < tie * f["max_abs_router_logit"],
              f"lm: {what}: {f} differs from forward's expert choice "
              f"beyond a near tie")
    return {"prefill": prefill, "steps": steps, "flips": flips,
            "rows_compared_per_step": held,
            "token_steps_compared": [sum(held), b * (n - 1)]}


def _moe_against_forward(params, cfg, sess, prompts, out, bound, what,
                         decode_bound=None) -> dict:
    """:func:`_lm_against_forward` for moe, aware of expert choices: the
    prefill and the teacher-forced steps run again eagerly, each bit for
    bit the replayed one, and are compared through
    :func:`_eager_against_forward` (near ties held to
    :data:`LM_MOE_FLIP_MARGIN`)."""
    s = prompts.shape[1]
    last, steps = _lm_replay(sess, prompts, out)
    _check_replayed_tokens(last, steps, out, s, what)
    run = _eager_against_forward(params, cfg, out, s, LM_MOE_FLIP_MARGIN,
                                 what, replay=(last, steps))
    decode = [p for p in run["steps"] if p is not None]
    check(bool(run["prefill"]) and bool(decode),
          f"lm: {what}: no row left to compare ({run['flips']})")
    res = {"prefill": _lm_compare(run["prefill"], bound,
                                  f"{what} prefill vs forward"),
           "decode": _lm_compare(decode, decode_bound or bound,
                                 f"{what} decode vs forward"),
           "route_flips": run["flips"],
           "rows_compared_per_step": run["rows_compared_per_step"],
           "token_steps_compared": run["token_steps_compared"]}
    if run["steps"][0] is not None:
        res["first_decode"] = _lm_compare(
            run["steps"][:1], LM_BF16_BOUND,
            f"{what} first decode step vs forward")
    return res


def _lm_captured_vs_eager(params, cfg, sess, tokens, s: int,
                          steps: int = LM_BITWISE_STEPS) -> int:
    """``steps`` captured decode steps against ``decode_step`` run eagerly
    on a copy of the same cache: logits and caches bit for bit."""
    from repro_torch.models import lm
    sess.prefill(tokens[:, :s])
    with torch.inference_mode():
        eager_cache = {k: v.clone() for k, v in sess.cache.items()}
        positions = torch.arange(s, s + steps, dtype=torch.int32,
                                 device="cuda")
        for i in range(steps):
            ids1 = tokens[:, s + i:s + i + 1]
            got, _ = sess.decode(sess.cache, ids1, positions[i])
            want, _ = lm.decode_step(params, cfg, eager_cache, ids1,
                                     positions[i])
            check(torch.equal(got, want),
                  f"lm: captured decode step {i} differs from eager")
        check(all(torch.equal(sess.cache[k], eager_cache[k])
                  for k in eager_cache),
              "lm: the captured steps' cache differs from eager's")
    return steps


def _lm_times(params, cfg, sess, prompts, tokens) -> dict:
    """Prefill (captured; host clock and device time), the decode step
    captured and eager (back to back, one synchronize), the replayed
    step's device time, busy share and launches."""
    from repro_torch.models import lm
    s = prompts.shape[1]
    ids1 = tokens[:, s:s + 1]
    pos = torch.tensor(s, dtype=torch.int32, device="cuda")
    prefill_wall = _wall_ms(lambda: sess.prefill(prompts))
    prefill_rows = _device_rows(lambda: sess.prefill(prompts))

    def steps(step):
        def run():
            for _ in range(LM_TIMED_STEPS):
                step().argmax(-1)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / LM_TIMED_STEPS

    captured = steps(lambda: sess.decode(sess.cache, ids1, pos)[0])
    with torch.inference_mode():
        cache = {k: v.clone() for k, v in sess.cache.items()}
        eager = steps(lambda: lm.decode_step(params, cfg, cache, ids1,
                                             pos)[0])
    del cache
    step_rows = _device_rows(lambda: sess.decode(sess.cache, ids1, pos))
    step_device = sum(r["device_ms"] for r in step_rows)
    prefill_device = sum(r["device_ms"] for r in prefill_rows)
    return {"prefill": {"host_ms_median": statistics.median(prefill_wall),
                        "host_ms": prefill_wall,
                        "device_ms": prefill_device,
                        "launches": sum(r["count"] for r in prefill_rows),
                        "top_kernels": prefill_rows[:8]},
            "decode": {"captured_ms_per_step": captured,
                       "eager_ms_per_step": eager,
                       "tokens_per_s": prompts.shape[0] / captured * 1e3,
                       "device_ms_per_step": step_device,
                       "busy_share": step_device / captured,
                       "launches_per_step": sum(r["count"]
                                                for r in step_rows),
                       "top_kernels": step_rows[:8]}}


def _lm_float32_vs_cpu() -> dict:
    """qwen1.5-0.5b in float32 on the card against the port's CPU run on
    one :data:`LM_F32_PROMPT`-token prompt: forward's logits, prefill's and
    :data:`LM_F32_NEW` - 1 teacher-forced decode steps'."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    params = lm.init(SEED, cfg)
    host = _to_cpu(params)
    prompt = torch.from_numpy(lm_prompts(cfg, 1, LM_F32_PROMPT, SEED + 1))
    out, _ = serve.generate(params, cfg, prompt, max_new_tokens=LM_F32_NEW)
    sess = serve._session(params, cfg, 1, LM_F32_PROMPT + LM_F32_NEW)
    last, steps = _lm_replay(sess, prompt.cuda(), out)
    tokens = out.cpu()
    with torch.inference_mode():
        full_card, _ = lm.forward(params, cfg, prompt.cuda())
        full_cpu, _ = lm.forward(host, cfg, prompt)
        last_cpu, cache = lm.prefill(host, cfg, prompt,
                                     max_seq=LM_F32_PROMPT + LM_F32_NEW)
        steps_cpu = []
        for i in range(LM_F32_NEW - 1):
            lg, cache = lm.decode_step(
                host, cfg, cache, tokens[:, LM_F32_PROMPT + i:
                                         LM_F32_PROMPT + i + 1],
                LM_F32_PROMPT + i)
            steps_cpu.append(lg)
    res = {"forward": _lm_compare([(full_card.cpu(), full_cpu)],
                                  LM_F32_BOUND, "float32 forward card vs "
                                                "CPU"),
           "prefill_decode": _lm_compare(
               [(a.cpu(), b) for a, b in zip([last] + steps,
                                             [last_cpu] + steps_cpu)],
               LM_F32_BOUND, "float32 prefill/decode card vs CPU")}
    del params, host, sess
    serve.clear_lm_captures()
    return res


#: a moe expert choice of the card may differ from the CPU's only where
#: the router's top-k margin is below this fraction of max|router logit|
LM_ROUTE_TIE = 1e-5


def _route_agreement(card: list, cpu: list, what: str) -> dict:
    """The expert choices of each recorded ``moe_apply`` call on the card
    against the CPU's: equal, or, where they differ, the CPU router's margin
    between its k-th and (k+1)-th logit below :data:`LM_ROUTE_TIE` x
    max|router logit| (each such case named)."""
    check(len(card) == len(cpu), f"lm: {what}: {len(card)} routed calls "
                                 f"on the card, {len(cpu)} on the CPU")
    rows = 0
    near_ties = []
    for call, (a, b) in enumerate(zip(card, cpu)):
        got, want = a["top_idx"].cpu(), b["top_idx"]
        rows += want.shape[0]
        differ = (got != want).any(dim=-1).nonzero().flatten().tolist()
        if not differ:
            continue
        logits = b["logits"]
        k = want.shape[1]
        top = logits.sort(dim=-1, descending=True).values
        scale = float(logits.abs().max())
        for row in differ:
            margin = float(top[row, k - 1] - top[row, k])
            check(margin < LM_ROUTE_TIE * scale,
                  f"lm: {what}: call {call} token {row} routes to "
                  f"{got[row].tolist()} on the card, {want[row].tolist()} "
                  f"on the CPU, with a router margin of {margin} "
                  f"(max |logit| {scale})")
            near_ties.append({"call": call, "token": row, "margin": margin,
                              "card": got[row].tolist(),
                              "cpu": want[row].tolist()})
    return {"calls": len(card), "tokens": rows, "near_ties": near_ties}


def _lm_reduced() -> dict:
    """``reduced()`` of every config on the card (the port's weights from
    SEED, vlm's gate at :data:`LM_GATE_X`): prefill and 3 decode steps
    against ``forward``, and all three against the port's CPU run on the
    same weights and inputs; for moe first each call's expert choices
    (:func:`_route_agreement`)."""
    from repro_torch.configs import dummy_inputs, get_config, list_archs
    from repro_torch.models import lm
    out = {}
    s, extra = 32, 3
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        if cfg.family not in lm.FAMILIES:
            continue
        params = lm.init(SEED, cfg)
        if cfg.family == "vlm":
            params["crossed"]["gate_x"].fill_(LM_GATE_X)
        runs = {}
        for dev, p in (("cuda", params), ("cpu", _to_cpu(params))):
            ins = dummy_inputs(cfg, "prefill", batch=2, seq=s + extra,
                               seed=5, device=dev)
            seq = ins.get("ids", ins.get("embeds"))
            img = ins.get("image_embeds")
            with torch.inference_mode(), record_routes() as routes:
                if cfg.family == "audio":
                    full, _ = lm.forward(p, cfg, embeds=seq)
                    last, cache = lm.prefill(p, cfg, embeds=seq[:, :s],
                                             max_seq=s + extra)
                else:
                    full, _ = lm.forward(p, cfg, seq, image_embeds=img)
                    last, cache = lm.prefill(p, cfg, seq[:, :s],
                                             image_embeds=img,
                                             max_seq=s + extra)
                steps = []
                for t in range(extra):
                    nxt = seq[:, s + t:s + t + 1]
                    kw = ({"embeds1": nxt} if cfg.family == "audio"
                          else {"ids1": nxt})
                    lg, cache = lm.decode_step(p, cfg, cache, pos=s + t,
                                               **kw)
                    steps.append(lg)
            runs[dev] = (full, last, steps, routes)
        full, last, steps, routes = runs["cuda"]
        cpu = runs["cpu"]
        out[arch] = {}
        if cfg.family == "moe":
            out[arch]["routes"] = _route_agreement(
                routes, cpu[3], f"{cfg.name} expert choices card vs CPU")
        out[arch]["vs_forward"] = _lm_compare(
            [(last, full[:, s - 1])] + [(lg, full[:, s + t])
                                        for t, lg in enumerate(steps)],
            LM_F32_BOUND, f"{cfg.name} prefill/decode vs forward")
        out[arch]["vs_cpu"] = _lm_compare(
            [(a.cpu(), b) for a, b in zip([full, last] + steps,
                                          [cpu[0], cpu[1]] + cpu[2])],
            LM_F32_BOUND, f"{cfg.name} card vs CPU")
    return out


def phase_lm(smi: str) -> dict:
    """The LM stack's serving path on the card: qwen1.5-0.5b at its
    published width and depth in bf16 (the port's own weights from SEED),
    ``generate`` on :data:`LM_BATCH` prompts of :data:`LM_PROMPT` tokens
    with :data:`LM_NEW` new ones, greedy, through ``ServingEngine``,
    ``LMServable`` and the captured prefill and decode step; then one
    prompt of :data:`LM_LONG_PROMPT`. Checks (each raises): prefill's and
    each teacher-forced decode step's logits against ``forward``'s within
    :data:`LM_BF16_BOUND`, argmax equal where the top-2 gap exceeds twice
    it; :data:`LM_BITWISE_STEPS` captured steps bit for bit the eager
    ones; a second ``generate`` the same tokens with no new capture; the
    float32 model against the port's CPU run and every reduced config (all
    six families; moe's expert choices first) against ``forward`` and the
    CPU within :data:`LM_F32_BOUND`. Prints the prefill's and the decode step's
    times beside their bounds, with the card's name and power limit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    check(cfg.n_params() == LM_PARAMS and cfg.dtype == "bfloat16",
          "lm: the config is not the published qwen1.5-0.5b")
    params = lm.init(SEED, cfg)
    prompts = torch.from_numpy(lm_prompts(cfg, LM_BATCH, LM_PROMPT, SEED))
    before = serve.lm_capture_counts()
    out, first = serve.generate(params, cfg, prompts, max_new_tokens=LM_NEW)
    captured = serve.lm_capture_counts()
    check(captured["prefill"] == before["prefill"] + 1
          and captured["step"] == before["step"] + 1,
          f"lm: generate captured {captured}, expected one prefill and one "
          f"step more than {before}")
    again, second = serve.generate(params, cfg, prompts,
                                   max_new_tokens=LM_NEW)
    check(torch.equal(out, again), "lm: a second generate gave other tokens")
    check(serve.lm_capture_counts() == captured,
          "lm: a second generate captured again")
    check(out.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
          and torch.equal(out[:, :LM_PROMPT].cpu(), prompts),
          "lm: generate's rows are not prompt + new tokens")
    sess = serve._session(params, cfg, LM_BATCH, LM_PROMPT + LM_NEW)
    dev_prompts = prompts.cuda()
    checks = {"main": _lm_against_forward(params, cfg, sess, dev_prompts,
                                          out, LM_BF16_BOUND, "main")}
    checks["captured_bitwise_steps"] = _lm_captured_vs_eager(
        params, cfg, sess, out, LM_PROMPT)
    times = _lm_times(params, cfg, sess, dev_prompts, out)
    long_prompt = torch.from_numpy(lm_prompts(cfg, 1, LM_LONG_PROMPT,
                                              SEED + 2))
    long_out, _ = serve.generate(params, cfg, long_prompt,
                                 max_new_tokens=LM_LONG_NEW)
    long_sess = serve._session(params, cfg, 1, LM_LONG_PROMPT + LM_LONG_NEW)
    checks["long"] = _lm_against_forward(params, cfg, long_sess,
                                         long_prompt.cuda(), long_out,
                                         LM_BF16_BOUND, "long prompt")
    del params, sess, long_sess
    serve.clear_lm_captures()
    checks["float32_vs_cpu"] = _lm_float32_vs_cpu()
    checks["reduced"] = _lm_reduced()
    positions = LM_PROMPT + LM_NEW
    decode_bytes = lm_decode_bytes(cfg, LM_BATCH, positions)
    prefill_flops = lm_prefill_flops(cfg, LM_BATCH, LM_PROMPT)
    bounds = {"decode_bytes": decode_bytes, "decode_positions": positions,
              "decode_ms": 1e3 * decode_bytes / HBM_BYTES_PER_S,
              "prefill_flops": prefill_flops,
              "prefill_ms": 1e3 * prefill_flops / BF16_OPS_PER_S}
    emit({"phase": "lm", "nvidia_smi": smi, "arch": LM_ARCH,
          "n_params": cfg.n_params(), "dtype": cfg.dtype,
          "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
          "generate": {"first": first, "second": second},
          **times, "bounds": bounds,
          "captures": captured, "checks": checks,
          "seconds": time.perf_counter() - t0})
    return {"bounds": bounds, **times}


#: the lm_families phase: (arch, layers kept or None for the published
#: depth, ``n_params()`` of the run's config). llama4-scout keeps 8 of its
#: 48 layers: the 48 hold 101.7 B parameters (203 GB in bf16), which no
#: single card holds; 8 leave room for two sessions' graph pools and the
#: dropless forward check beside the 37 GB of weights
LM_FAMILY_RUNS = (("rwkv6-3b", None, 3_061_841_920),
                  ("zamba2-7b", None, 6_749_630_976),
                  ("llama4-scout-17b-a16e", 8, 18_679_070_720))
#: prompts on both state-space chunks (16 and 32) for the check against
#: ``forward``: off the chunk the reference's decode departs from it
LM_CHUNK_PROMPT = 1024
#: bf16 teacher-forced decode logits against ``forward``'s per family, as
#: :data:`LM_BF16_BOUND` (which stays the prefill's bound): measured on the
#: card over 63 steps at 1024 tokens, H100 80GB HBM3 at 700 W, 27.6% for
#: rwkv6-3b (its recurrence carries the bf16 rounding of each step's
#: projections, the data-dependent decay's among them, on from step to
#: step: 2.0% at the first step, 13.9% at the eighth; float32 stays within
#: its own noise, ``LM_F32_WIDE``), 6.4% for
#: zamba2-7b (81 Mamba layers; 2.8% at the first step), 1.9% for
#: llama4-scout on the rows whose expert choices agree with forward's.
#: The first step alone stays within :data:`LM_BF16_BOUND` (measured 2.2%,
#: 3.3% and 2.0% of that step's max|logit|); the float32 check
#: (:data:`LM_F32_WIDE`) holds all 63 steps tightly
LM_FAMILY_BF16_BOUND = {"ssm": 0.35, "hybrid": 0.08, "moe": LM_BF16_BOUND}


#: float32 at the published width, every family, eagerly (through
#: :func:`_eager_against_forward`): prefill and 63 teacher-forced decode
#: steps against ``forward`` on ``batch`` prompts of
#: :data:`LM_CHUNK_PROMPT` random tokens followed by random tokens, every
#: step within ``noise_factor`` x ``forward``'s own noise: the largest
#: difference, at the same positions, between a row's logits computed
#: alone and in the batch (other GEMM shapes, other float32 rounding).
#: Measured on an H100 80GB HBM3 at 700 W, decode over noise 0.91
#: (rwkv6-3b, both about 1.2e-3 x max|logit|: its data-dependent decay
#: carries float32 rounding along, so an absolute bound of 1e-3 sits
#: inside its own noise), 1.02 (zamba2-7b, 2.5e-5) and 1.00 (llama4-scout,
#: 5.3e-6), and none grows over the 63 steps. A defect of the decode
#: path (a state kept in bf16, a stale shift row) stands far above it.
#: moe runs ``moe_layers`` of llama4-scout's layers (2 layers hold 25 GB
#: in float32), dropless, its expert choices held to ``forward``'s up to
#: :data:`LM_ROUTE_TIE`.
LM_F32_WIDE = {"batch": 2, "noise_factor": 2.0, "moe_layers": 2}


def _lm_float32_wide(cfg) -> dict:
    """:data:`LM_F32_WIDE` on ``cfg`` in float32."""
    import dataclasses
    from repro_torch.models import lm
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_layers=LM_F32_WIDE["moe_layers"],
                                  capacity_factor=float(cfg.n_experts))
    s, b = LM_CHUNK_PROMPT, LM_F32_WIDE["batch"]
    tokens = torch.from_numpy(lm_prompts(cfg, b, s + LM_NEW,
                                         SEED + 4)).cuda()
    params = lm.init(SEED, cfg)
    what = f"{cfg.name} float32, {cfg.n_layers} layers, vs forward"
    run = _eager_against_forward(params, cfg, tokens, s, LM_ROUTE_TIE, what)
    pairs = run["prefill"] + [p for p in run["steps"] if p is not None]
    scale = max(float(r.float().abs().max()) for _, r in pairs)
    with torch.inference_mode():
        both, _ = lm.forward(params, cfg, tokens)
        noise = max(float((lm.forward(params, cfg, tokens[r:r + 1])[0][
            0, s - 1:-1] - both[r, s - 1:-1]).abs().max())
            for r in range(b)) / scale
    del params, both
    torch.cuda.empty_cache()
    res = _lm_compare(pairs, LM_F32_WIDE["noise_factor"] * noise, what)
    res.update(n_layers=cfg.n_layers, capacity_factor=cfg.capacity_factor,
               forward_noise_over_max=noise,
               err_over_noise=res["err_over_max"] / noise,
               per_step_err_over_max=_per_step_err(pairs),
               route_flips=run["flips"],
               token_steps_compared=run["token_steps_compared"])
    return res


def _moe_routing(params, cfg, prompts, tokens) -> dict:
    """The published capacity factor's drops: an eager prefill of
    ``prompts`` and the teacher-forced decode steps over ``tokens`` under
    :func:`record_routes`; per layer the tokens dropped by the prefill and
    by each step, and the experts the first step (the timed one) routes a
    kept token to, summed over the layers."""
    from repro_torch.models import lm
    s, n = prompts.shape[1], tokens.shape[1] - prompts.shape[1]
    with torch.inference_mode():
        with record_routes() as pre:
            _, cache = lm.prefill(params, cfg, prompts, max_seq=s + n)
        steps = []
        for i in range(n - 1):
            with record_routes() as rec:
                lm.decode_step(params, cfg, cache,
                               tokens[:, s + i:s + i + 1], s + i)
            steps.append(rec)
    dropped = lambda recs: [int((~r["keep"]).sum()) for r in recs]

    def routed(recs) -> int:
        total = 0
        for r in recs:
            kept = torch.zeros(cfg.n_experts, dtype=torch.bool,
                               device=r["top_idx"].device)
            order = r["top_idx"].reshape(-1).argsort(stable=True)
            kept[r["top_idx"].reshape(-1)[order][r["keep"]]] = True
            total += int(kept.sum())
        return total
    per_step = [dropped(r) for r in steps]
    del cache
    return {"capacity_prefill": pre[0]["cap"], "capacity_step":
            steps[0][0]["cap"], "prefill_dropped_per_layer": dropped(pre),
            "step_dropped_per_layer": per_step,
            "steps_dropping": sum(any(d) for d in per_step),
            "tokens_dropped_in_steps": sum(map(sum, per_step)),
            "timed_step_routed_experts": routed(steps[0])}


def _lm_family(arch: str, layers, n_params: int, smi: str) -> dict:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    check(cfg.n_params() == n_params and cfg.dtype == "bfloat16",
          f"lm_families: {arch} is not the config this phase runs")
    params = lm.init(SEED, cfg)
    prompts = torch.from_numpy(lm_prompts(cfg, LM_BATCH, LM_PROMPT, SEED))
    before = serve.lm_capture_counts()
    out, first = serve.generate(params, cfg, prompts, max_new_tokens=LM_NEW)
    captured = serve.lm_capture_counts()
    check(captured["prefill"] == before["prefill"] + 1
          and captured["step"] == before["step"] + 1,
          f"lm_families: {arch}: generate captured {captured}, expected "
          f"one prefill and one step more than {before}")
    again, second = serve.generate(params, cfg, prompts,
                                   max_new_tokens=LM_NEW)
    check(torch.equal(out, again),
          f"lm_families: {arch}: a second generate gave other tokens")
    check(serve.lm_capture_counts() == captured,
          f"lm_families: {arch}: a second generate captured again")
    check(out.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
          and torch.equal(out[:, :LM_PROMPT].cpu(), prompts),
          f"lm_families: {arch}: generate's rows are not prompt + new "
          f"tokens")
    sess = serve._session(params, cfg, LM_BATCH, LM_PROMPT + LM_NEW)
    dev_prompts = prompts.cuda()
    checks = {"captured_bitwise_steps": _lm_captured_vs_eager(
        params, cfg, sess, out, LM_PROMPT)}
    times = _lm_times(params, cfg, sess, dev_prompts, out)
    routed = None
    if cfg.family == "moe":
        checks["published_capacity"] = _moe_routing(params, cfg, dev_prompts,
                                                    out)
        routed = checks["published_capacity"]["timed_step_routed_experts"]
    del sess
    serve.clear_lm_captures()
    # against forward: prompts on the chunks, moe dropless
    chk_cfg = cfg
    if cfg.family == "moe":
        chk_cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.n_experts))
    chk_prompts = torch.from_numpy(lm_prompts(cfg, LM_BATCH,
                                              LM_CHUNK_PROMPT, SEED + 3))
    chk_out, _ = serve.generate(params, chk_cfg, chk_prompts,
                                max_new_tokens=LM_NEW)
    chk_sess = serve._session(params, chk_cfg, LM_BATCH,
                              LM_CHUNK_PROMPT + LM_NEW)
    checks["vs_forward"] = _lm_against_forward(
        params, chk_cfg, chk_sess, chk_prompts.cuda(), chk_out,
        LM_BF16_BOUND, f"{arch} against forward",
        decode_bound=LM_FAMILY_BF16_BOUND[cfg.family])
    checks["vs_forward"]["capacity_factor"] = chk_cfg.capacity_factor
    del chk_sess
    serve.clear_lm_captures()
    positions = LM_PROMPT + LM_NEW
    decode_bytes = lm_decode_bytes(cfg, LM_BATCH, positions, routed)
    prefill_flops = lm_prefill_flops(cfg, LM_BATCH, LM_PROMPT)
    bounds = {"decode_bytes": decode_bytes, "decode_positions": positions,
              "decode_ms": 1e3 * decode_bytes / HBM_BYTES_PER_S,
              "prefill_flops": prefill_flops,
              "prefill_ms": 1e3 * prefill_flops / BF16_OPS_PER_S}
    if cfg.family == "moe":
        every = lm_decode_bytes(cfg, LM_BATCH, positions,
                                cfg.n_layers * cfg.n_experts)
        bounds["decode_all_experts_bytes"] = every
        bounds["decode_all_experts_ms"] = 1e3 * every / HBM_BYTES_PER_S
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    checks["float32_vs_forward"] = _lm_float32_wide(cfg)
    res = {"phase": "lm_families", "nvidia_smi": smi, "arch": arch,
           "family": cfg.family, "n_layers": cfg.n_layers,
           "published_layers": get_config(arch).n_layers,
           "n_params": cfg.n_params(), "dtype": cfg.dtype,
           "capacity_factor": cfg.capacity_factor,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW,
           "generate": {"first": first, "second": second},
           **times, "bounds": bounds, "captures": captured, "checks": checks,
           "max_memory_allocated_gb": peak_gb,
           "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def phase_lm_families(smi: str) -> dict:
    """The moe, ssm and hybrid families' serving path on the card, one
    model of :data:`LM_FAMILY_RUNS` at a time (module docstring, 11)."""
    return {arch: _lm_family(arch, layers, n, smi)
            for arch, layers, n in LM_FAMILY_RUNS}


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------

#: (a) the full-width run: qwen1.5-0.5b at published width and depth, bf16,
#: float32 moments, 2 sequences of the config's train_4k length, the
#: port's weights from SEED, one repeated ``TokenStream`` batch (seed SEED)
LM_TRAIN_BATCH = 2
LM_TRAIN_SEQ = 4096
LM_TRAIN_STEPS = 4
#: steps held bit for bit, eager against captured: the capture's two eager
#: warm-up steps, the capture and a replay
LM_TRAIN_COMPARE = 4
#: eager steps of (a)'s config without ``cfg.remat`` (the published config
#: sets it: each layer checkpointed), from the same seed: their losses bit
#: for bit the run's (remat recomputes the same values), their peak memory
#: and step times beside (a)'s eager steps with remat
LM_TRAIN_NOREMAT = 2
#: (b) gradients at published width against the CPU: qwen1.5-0.5b with
#: 2 of 24 layers, float32, 2 x 256 tokens
LM_TRAIN_GRAD_LAYERS = 2
LM_TRAIN_GRAD_SEQ = 256
#: (c) every config at ``reduced()``, float32: the CPU tests' inputs
#: (``dummy_inputs`` seed 5, 2 x 36), 4 steps (2 eager warm-ups, the
#: capture's replay and one more)
LM_TRAIN_REDUCED_SEQ = 36
LM_TRAIN_REDUCED_STEPS = 4
#: (d) the scans' and the dispatch's backward at published width, bf16,
#: 2 x 1024: (arch, fields replaced, moment dtype, ``n_params()``).
#: zamba2-7b keeps one ``attn_interval`` group (6 Mamba2 layers and the
#: shared block); llama4-scout one of its 48 layers, with bf16 moments:
#: its state (4.15 B parameters, their bf16 gradients and moments, 33 GB)
#: and the captured step's pool share one 80 GB card with what the earlier
#: phases leave. Two layers (6.22 B parameters, 50 GB of state) fit in a
#: process of their own (54.5 GB allocated at the peak, 83.6 GB reserved,
#: on an H100 80GB HBM3 at 700 W) but ran out of memory here, the cache
#: holding 17.6-17.8 GiB in free blocks too small for a 2.5-5 GiB request
LM_TRAIN_WIDE = (("rwkv6-3b", {"n_layers": 2}, "float32", 505_937_920),
                 ("zamba2-7b", {"n_layers": 6}, "float32", 902_654_976),
                 ("llama4-scout-17b-a16e", {"n_layers": 1}, "bfloat16",
                  4_145_233_920))
LM_TRAIN_WIDE_SEQ = 1024
#: captured steps of each (d) run: 2 eager warm-ups, the capture's replay,
#: then one replay timed
LM_TRAIN_WIDE_STEPS = 4


def _token_batch(cfg, batch: int, seq: int, step: int = 0) -> dict:
    from repro_torch.data import TokenStream
    ids, labels = TokenStream(cfg.vocab_size, seq, batch,
                              seed=SEED).batch(step)
    return {"ids": torch.from_numpy(ids).cuda(),
            "labels": torch.from_numpy(labels).cuda()}


def _leaves_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _train_steps(cfg, opt, batch: dict, n: int, captured: bool):
    """``n`` steps from a fresh seeded state on the card, each ended by
    reading its loss: captured (``make_train_step``: two eager warm-ups,
    the capture, replays) or eager (the step itself). -> (losses, the
    state, the step, host-clock ms per step)."""
    from repro_torch.launch import train
    state = train.init_train_state(SEED, cfg, opt, device="cuda")
    step = train.make_train_step(cfg, opt)
    args = tuple(batch.get(k) for k in train.BATCH_KEYS)
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        if captured:
            loss = step(state, batch)[1]["loss"]
        else:
            loss = train._step(cfg, opt, False, state, *args)[0]
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, state, step, ms


def _host_stats(ms) -> dict:
    return {"step_ms_median": statistics.median(ms), "step_ms_min": min(ms),
            "step_ms_p90": float(np.percentile(ms, 90))}


def _lm_train_full(smi: str) -> dict:
    """(a): ``run_training`` twice from the port's seed-0 weights, with
    the published ``cfg.remat`` (each layer checkpointed),
    :data:`LM_TRAIN_STEPS` steps on one repeated batch, the launch counters
    reset just before each run and read just after; then
    :data:`LM_TRAIN_COMPARE` eager steps against as many through
    ``make_train_step``; one replay profiled; :data:`LM_TRAIN_NOREMAT`
    captured steps without remat."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import TrainLoopConfig, run_training, train
    from repro_torch.models.backend import CudaGraphCall
    from repro_torch.optim import AdamWConfig
    cfg = get_config(LM_ARCH)
    check(cfg.n_params() == LM_PARAMS and cfg.dtype == "bfloat16",
          "lm_train: the config is not the published qwen1.5-0.5b")
    batch = _token_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    runs = []
    for _ in range(2):
        stamps = []

        def data(step):
            stamps.append(time.perf_counter())
            return batch
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            reset_launch_counts()
            hist, state, watchdog = run_training(
                cfg, TrainLoopConfig(steps=LM_TRAIN_STEPS,
                                     batch_size=LM_TRAIN_BATCH,
                                     seq_len=LM_TRAIN_SEQ, log_every=1000,
                                     ckpt_every=10 ** 9, ckpt_dir=tmp),
                data=data, verbose=False, device="cuda")
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts = launch_counts()
        runs.append({"hist": hist, "leaves": train.state_leaves(state),
                     "p4": counts["gather_rows_backward"],
                     "sort": sum(counts[k] for k in SEGMENTS_COUNTERS),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "ms": [1e3 * (b - a) for a, b in
                            zip(stamps, stamps[1:])],
                     "stragglers": len(watchdog.flagged_steps)})
        del state
        torch.cuda.empty_cache()
    a, b = runs
    losses = [h["loss"] for h in a["hist"]]
    check(len(losses) == LM_TRAIN_STEPS and all(np.isfinite(losses)),
          f"lm_train: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"lm_train: the loss after "
          f"{LM_TRAIN_STEPS} steps on one batch, {losses[-1]}, is not below "
          f"step 0's {losses[0]}")
    check(a["hist"] == b["hist"], "lm_train: two runs from seed 0 part "
                                  "(the metrics differ)")
    check(_leaves_equal(a["leaves"], b["leaves"]),
          "lm_train: two runs from seed 0 end in different states")
    warm = CudaGraphCall.WARMUP
    per_step = PATHS["lm_train"][LM_ARCH]["gather_rows_backward"]
    check(a["p4"] == (warm + 1) * per_step,
          f"lm_train: P4 counted {a['p4']} launches in the run, expected "
          f"{(warm + 1) * per_step} (the eager warm-ups and the capture)")
    del runs, b
    a.pop("leaves")
    torch.cuda.empty_cache()
    opt = AdamWConfig(total_steps=LM_TRAIN_STEPS, warmup_steps=1)
    n = LM_TRAIN_COMPARE
    # one state on the card at a time: the captured graph's pool holds
    # the whole step's activations
    e_loss, e_state, _, e_ms = _train_steps(cfg, opt, batch, n, False)
    e_leaves = [t.cpu() for t in train.state_leaves(e_state)]
    del e_state
    torch.cuda.empty_cache()
    c_loss, c_state, step, _ = _train_steps(cfg, opt, batch, n, True)
    check(c_loss == e_loss == losses[:n],
          f"lm_train: captured steps' losses {c_loss} differ from the eager "
          f"ones {e_loss} or the run's {losses[:n]}")
    check(_leaves_equal([t.cpu() for t in train.state_leaves(c_state)],
                        e_leaves),
          f"lm_train: the state after {n} captured steps differs from the "
          f"eager one")
    del e_leaves
    replay = _device_rows(lambda: step(c_state, batch))
    del c_state, step
    torch.cuda.empty_cache()
    p4 = _p4_count(replay)
    check(p4 == per_step, f"lm_train: a replayed step launched P4 {p4} "
                          f"times, expected {per_step}")
    sort = _segments_count(replay)
    check(sort > 0 and a["sort"] == (warm + 1) * sort,
          f"lm_train: P4's radix sort launched {sort} kernels a replayed "
          f"step and {a['sort']} in the run (eager warm-ups and capture)")
    check(cfg.remat, "lm_train: the published config does not set remat")
    torch.cuda.reset_peak_memory_stats()
    k = LM_TRAIN_NOREMAT
    nr_loss, nr_state, nr_step, nr_ms = _train_steps(
        dataclasses.replace(cfg, remat=False), opt, batch, k, False)
    nr_peak = torch.cuda.max_memory_allocated() / 1e9
    del nr_state, nr_step
    torch.cuda.empty_cache()
    check(nr_loss == losses[:k], f"lm_train: without remat the losses "
                                 f"{nr_loss} differ from the run's "
                                 f"{losses[:k]}")
    cap_ms = a["ms"][warm + 1:]          # the replays
    device = sum(r["device_ms"] for r in replay)
    return {"arch": LM_ARCH, "n_params": cfg.n_params(), "dtype": cfg.dtype,
            "moments": "float32", "batch": LM_TRAIN_BATCH,
            "seq": LM_TRAIN_SEQ, "steps": LM_TRAIN_STEPS, "losses": losses,
            "runs_bitwise_equal": 2, "captured_vs_eager_bitwise_steps": n,
            "eager_warmup_and_capture_ms": a["ms"][:warm + 1],
            "captured": {**_host_stats(cap_ms), "device_ms": device,
                         "device_busy_share":
                             device / statistics.median(cap_ms),
                         "launches": sum(r["count"] for r in replay),
                         "p4_launches": p4, "sort_launches": sort,
                         "top_kernels": replay[:12]},
            "eager": _host_stats(e_ms[warm:]),
            "p4_launches_in_run": a["p4"],
            "sort_launches_in_run": a["sort"],
            "max_memory_allocated_gb": a["peak_gb"],
            "remat": {"max_memory_allocated_gb": a["peak_gb"],
                      "captured_step_ms_median": statistics.median(cap_ms),
                      "eager_step_ms": e_ms,
                      "without": {"steps": k, "losses_bitwise_equal": k,
                                  "max_memory_allocated_gb": nr_peak,
                                  "eager_step_ms": nr_ms}},
            "stragglers": a["stragglers"],
            "bound": lm_train_flops(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)}


def _loss_and_grads(params, cfg, ins: dict):
    """The port's loss and gradient leaves on ``params``' device, the
    expert choices of each MoE call recorded."""
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves, tree_map
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    with record_routes() as routes:
        loss, _ = lm.loss_fn(params, cfg, ins.get("ids"), ins["labels"],
                             embeds=ins.get("embeds"),
                             image_embeds=ins.get("image_embeds"))
    grads = torch.autograd.grad(loss, tree_leaves(params),
                                materialize_grads=True)
    return float(loss.detach()), [g.cpu() for g in grads], routes


def _grad_err(got: list, want: list) -> float:
    """The largest per-leaf max |got - want| over max |want|."""
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        err = float((g.double() - w.double()).abs().max())
        worst = max(worst, err / scale if scale else err)
    return worst


def _against_cpu(cfg, params, ins: dict, what: str) -> dict:
    """Loss and every gradient leaf on the card against the port's CPU run
    on the same weights and inputs: the loss within 1e-6 relative, each
    leaf within 1e-4 x its max |g|; for moe the expert choices first. RWKV6
    in float32 sits at its conditioning's limit there (``tests/
    test_torch_lm_train.py``: the reference's own float32 gradient lies
    2.3e-4 x max|g| from its float64 one), so the ssm family's card
    gradient is held within 1e-4 x max|g| of the CPU's on float64 weights
    (the tests hold that one within 1e-10 of the reference's float64
    gradient)."""
    import dataclasses

    from repro_torch.optim import tree_map
    cpu_params = tree_map(lambda t: t.detach().cpu(), params)
    cpu_ins = {k: v.cpu() for k, v in ins.items()}
    card = _loss_and_grads(params, cfg, ins)
    cpu = _loss_and_grads(cpu_params, cfg, cpu_ins)
    rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    check(rel <= 1e-6, f"lm_train: {what}: loss card {card[0]} vs CPU "
                       f"{cpu[0]} ({rel} relative)")
    out = {"loss": card[0], "loss_rel_err": rel,
           "grad_err_over_max": _grad_err(card[1], cpu[1])}
    if cfg.family == "moe":
        out["routes"] = _route_agreement(card[2], cpu[2],
                                         f"{what} expert choices")
        check(not out["routes"]["near_ties"],
              f"lm_train: {what}: expert choices differ on the card")
    if cfg.family == "ssm":
        exact = _loss_and_grads(
            tree_map(lambda t: t.double(), cpu_params),
            dataclasses.replace(cfg, dtype="float64"), cpu_ins)[1]
        out["grad_err_vs_float64"] = _grad_err(card[1], exact)
        out["cpu_grad_err_vs_float64"] = _grad_err(cpu[1], exact)
        check(out["grad_err_vs_float64"] <= 1e-4,
              f"lm_train: {what}: card gradient {out['grad_err_vs_float64']}"
              f" x max|g| from the float64 one")
    else:
        check(out["grad_err_over_max"] <= 1e-4,
              f"lm_train: {what}: gradient card vs CPU "
              f"{out['grad_err_over_max']} x max|g|")
    return out


def _lm_train_grads(smi: str) -> dict:
    """(b): qwen1.5-0.5b at published width, 2 of 24 layers, float32,
    2 x 256 tokens, the port's seed-0 weights: loss and gradients on the
    card against the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=LM_TRAIN_GRAD_LAYERS, dtype="float32")
    params = lm.init(SEED, cfg, device="cpu")
    ins = _token_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_GRAD_SEQ)
    out = _against_cpu(cfg, _to_cuda(params), ins, f"{LM_ARCH} {LM_TRAIN_GRAD_LAYERS} "
                                       f"layers float32")
    return {"arch": LM_ARCH, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
            "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_GRAD_SEQ, **out}


def _to_cuda(tree):
    from repro_torch.optim import tree_map
    return tree_map(lambda t: t.cuda(), tree)


def _captured_twice(cfg, opt, batch: dict, n: int, what: str):
    """``n`` eager steps, then ``n`` captured twice, each from a fresh
    seeded state: every loss, and every leaf after them, bit for bit (the
    run before held on the host, one at a time). -> (the captured losses
    and step times, the last run's state and step)."""
    from repro_torch.launch.train import state_leaves
    held = None          # the run before: its losses and leaves, on the host
    for run, captured in enumerate((False, True, True)):
        losses, state, step, ms = _train_steps(cfg, opt, batch, n, captured)
        leaves = state_leaves(state)
        if held is not None:
            check(losses == held[0] and len(leaves) == len(held[1])
                  and all(torch.equal(h, t.cpu())
                          for h, t in zip(held[1], leaves)),
                  f"lm_train: {what}: " + (
                      f"{n} captured steps differ from the eager ones"
                      if run == 1 else "two captured runs part"))
        if run == 1:
            captured_ms = ms
        if run < 2:
            held = None
            held = (losses, [t.cpu() for t in leaves])
            del leaves, state, step
            torch.cuda.empty_cache()
    return {"losses": losses, "captured_ms": captured_ms}, state, step


def _lm_train_reduced(smi: str) -> dict:
    """(c): every config at ``reduced()``, float32, the port's seed-0
    weights (vlm's gate at :data:`LM_GATE_X`): loss and gradients against
    the CPU (moe's expert choices equal), then captured steps bit for bit
    the eager ones, twice."""
    from repro_torch.configs import dummy_inputs, get_config, list_archs
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        params = lm.init(SEED, cfg, device="cpu")
        if cfg.family == "vlm":
            params["crossed"]["gate_x"].fill_(LM_GATE_X)
        ins = dummy_inputs(cfg, "train", LM_TRAIN_BATCH,
                           LM_TRAIN_REDUCED_SEQ, seed=5, device="cuda")
        res = _against_cpu(cfg, _to_cuda(params), ins, cfg.name)
        runs, _, _ = _captured_twice(cfg, opt, ins, LM_TRAIN_REDUCED_STEPS,
                                     cfg.name)
        out[arch] = {**res, "losses": runs["losses"]}
    return out


def _lm_train_wide(smi: str) -> dict:
    """(d): the wide configs of :data:`LM_TRAIN_WIDE`, one at a time, bf16,
    2 x 1024 tokens of ``TokenStream``: eager steps, captured twice, bit
    for bit; the replays' host clock, one more replay profiled (device
    time, launches, P4's), and the peak of allocated memory."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.backend import CudaGraphCall
    from repro_torch.optim import AdamWConfig
    out = {}
    for arch, over, moments, n_params in LM_TRAIN_WIDE:
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 1e9
        cfg = dataclasses.replace(get_config(arch), **over)
        check(cfg.n_params() == n_params and cfg.dtype == "bfloat16",
              f"lm_train: {arch} is not the config this phase runs")
        torch.cuda.reset_peak_memory_stats()
        opt = AdamWConfig(total_steps=LM_TRAIN_WIDE_STEPS, warmup_steps=1,
                          moment_dtype=moments)
        batch = _token_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_WIDE_SEQ)
        runs, state, step = _captured_twice(cfg, opt, batch,
                                            LM_TRAIN_WIDE_STEPS, arch)
        check(all(np.isfinite(runs["losses"])),
              f"lm_train: {arch}: a loss is not finite")
        replay = _device_rows(lambda: step(state, batch))
        peak = torch.cuda.max_memory_allocated() / 1e9
        del state, step
        torch.cuda.empty_cache()
        p4 = _p4_count(replay)
        want = PATHS["lm_train"][arch]["gather_rows_backward"]
        check(p4 == want, f"lm_train: {arch}: a replayed step launched P4 "
                          f"{p4} times, expected {want}")
        replays = runs["captured_ms"][CudaGraphCall.WARMUP + 1:]
        device = sum(r["device_ms"] for r in replay)
        out[arch] = {"nvidia_smi": smi, "family": cfg.family,
                     "n_layers": cfg.n_layers,
                     "published_layers": get_config(arch).n_layers,
                     "n_params": n_params, "moments": moments,
                     "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_WIDE_SEQ,
                     "losses": runs["losses"], "runs_bitwise_equal": 2,
                     "captured_vs_eager_bitwise_steps": LM_TRAIN_WIDE_STEPS,
                     "captured": {**_host_stats(replays), "device_ms": device,
                                  "device_busy_share":
                                      device / statistics.median(replays),
                                  "launches": sum(r["count"]
                                                  for r in replay),
                                  "p4_launches": p4,
                                  "top_kernels": replay[:8]},
                     "max_memory_allocated_gb": peak,
                     "allocated_before_gb": before,
                     "bound": lm_train_flops(cfg, LM_TRAIN_BATCH,
                                             LM_TRAIN_WIDE_SEQ),
                     "seconds": time.perf_counter() - t0}
    return out


#: llama4-scout's dispatch gather in phase ``lm_train``'s (d): 2 x 1024
#: tokens, top-1, into the 2048 token rows of 5120 channels
P4_MOE_ARCH = "llama4-scout-17b-a16e"


def _p4_lm_cases() -> dict:
    """P4's LM operands: the full-width run's embedding gradient ((2 x
    4096, 1024) float32 rows of the step's ``TokenStream`` batch into
    qwen's 151936 vocabulary rows) and llama4-scout's MoE dispatch gather
    at (d)'s 2 x 1024 tokens (top-1: each token row once, in expert order,
    a permutation)."""
    from repro_torch.configs import get_config
    cfg, moe = get_config(LM_ARCH), get_config(P4_MOE_ARCH)
    rng = np.random.default_rng(SEED)
    ids = _token_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)["ids"]
    flat = ids.reshape(1, -1).long()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_WIDE_SEQ * moe.experts_per_token
    perm = torch.from_numpy(rng.permutation(tokens)).cuda()[None]

    def grad(n, c):
        return torch.from_numpy(rng.normal(size=(n, c)).astype(
            np.float32)).cuda()
    g = grad(flat.numel(), cfg.d_model)
    return {"embedding": (flat, g, cfg.vocab_size),
            "moe_dispatch": (perm, grad(tokens, moe.d_model), tokens)}


def _p4_lm_row(smi: str) -> dict:
    """P4 at the LM's gathers (:func:`_p4_lm_cases`, each through
    :func:`_p4_case`), and the radix sort's kernel row at the embedding:
    ``segments_cuda`` against ``segments()`` beside its bound (the indices
    read, perm and starts written) and ``torch.sort`` (the stable sort
    alone, no starts); its launches are set by the caller."""
    from repro_torch.kernels import gather_backward as gb
    cases = _p4_lm_cases()
    res = {name: _p4_case(*case, name) for name, case in cases.items()}
    emb = res["embedding"]
    flat, _, n_rows = cases["embedding"]
    keys = flat.reshape(-1)
    nbytes = emb["sort_bytes"]
    sms, sby = bound(nbytes, 0, FP32_OPS_PER_S)
    res["sort_row"] = {
        "name": "P4 segments (radix sort)", "route": "cuda",
        "source": "src/repro_torch/csrc/gather_backward.cu",
        "replaces": "no pallas_call: P4's own sort (the order of "
                    "src/repro/models/lm.py:411's scatter-add gradient)",
        "launches": None, "max_abs_err": 0.0, "ms": emb["sort_ms"],
        "plain_ms": emb["plain_sort_ms"], "bound_ms": sms, "bound_by": sby,
        "library_ms": cuda_ms(lambda: torch.sort(keys, stable=True)),
        "library_call": "torch.sort(keys, stable=True) (perm only)",
        "work": f"perm and starts of qwen's embedding gradient: "
                f"{flat.numel()} ids into {n_rows} rows",
        "device_ms": _call_device_ms(
            lambda: gb.segments_cuda(flat, n_rows),
            lambda rows: sum(r["count"] for r in rows
                             if "segments_bounds" in r["kernel"]))[0]}
    return res


def phase_lm_train(smi: str, dryrun: dict | None = None) -> dict:
    """LM training on the card (module docstring, 12): (a) the full-width
    run, P4 at the embedding's gradient, (b) its gradients against the CPU,
    (c) every reduced config, (d) the wide families. Once the parts whose
    host clock or event times are printed have run ((a) and P4's), phase
    ``dryrun``'s subprocesses start where ``dryrun`` is given
    (:func:`start_dryrun`, their handles put in it): (b) to (d) print
    device-bound replay times only.
    Returns P4's launches in (a)'s run and in one replay, and its row
    there."""
    t0 = time.perf_counter()
    res = {}
    for part, fn in (("full", _lm_train_full), ("p4_embedding", _p4_lm_row),
                     ("grads_vs_cpu", _lm_train_grads),
                     ("reduced", _lm_train_reduced),
                     ("wide", _lm_train_wide)):
        if part == "grads_vs_cpu" and dryrun is not None:
            dryrun.update(start_dryrun())
        t1 = time.perf_counter()
        res[part] = fn(smi)
        emit({"phase": "lm_train", "part": part, "nvidia_smi": smi,
              **res[part], "seconds": time.perf_counter() - t1})
    emit({"phase": "lm_train", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0})
    full = res["full"]
    return {"p4_launches": full["p4_launches_in_run"],
            "p4_launches_per_replay": full["captured"]["p4_launches"],
            "sort_launches": full["sort_launches_in_run"],
            "p4_embedding": res["p4_embedding"]}


# ---------------------------------------------------------------------------
# the distributed layer (NCCL at world size 1)
# ---------------------------------------------------------------------------

#: (a) the TP head layout at published width and depth: qwen1.5-4b (20
#: heads with QKV biases, MHA) at tp 16 pads its heads 20 -> 32
DIST_ARCH = "qwen1.5-4b"
#: ``ArchConfig.n_params()`` of the published qwen1.5-4b
DIST_PARAMS = 3_949_854_720
DIST_TP = 16
DIST_BATCH = 4
DIST_PROMPT = 1000
#: captured decode steps compared at tp 16 against tp 1, and held bit for
#: bit against eager ones
DIST_DECODE = 8
#: bf16 logits at tp 16 against tp 1 (prefill and each teacher-forced
#: decode step), as a fraction of the largest |logit|: the padded heads add
#: exact zeros, the rest is the GEMMs' and attention's order at other
#: shapes (measured 1.73% on an H100 80GB HBM3 at 700 W; the lm phase's
#: bound is 4%)
DIST_TP_BOUND = 0.03
#: (b) the storage-sharded step: qwen1.5-0.5b at published width and
#: depth, 2 x 1024 tokens, 3 steps against the unsharded step
DIST_TRAIN_BATCH = 2
DIST_TRAIN_SEQ = 1024
DIST_TRAIN_STEPS = 3
#: further steps of each, timed once the comparison is done (the captured
#: step's replays, the sharded step and the unsharded step run eagerly)
DIST_TRAIN_TIMED = 4
#: compressed_psum at world size 1 on a (rows, cols) float32 gradient;
#: pipeline_forward on 1 stage: M microbatches of (mb, d), stage tanh(h @ w)
DIST_PSUM_SHAPE = (4096, 1024)
DIST_PIPE = {"m": 4, "mb": 8, "d": 1024}
#: (b)'s 10 timed steps with the earlier sharded step body, which gathered
#: every parameter whole at the step's start: medians in ms (H100 80GB
#: HBM3, 700 W) of the sharded step, the unsharded step eager, and its
#: captured replay
DIST_WHOLE_GATHER_MS = {"sharded_step_ms": 235.5,
                        "unsharded_eager_step_ms": 226.5,
                        "unsharded_captured_step_ms": 146.3}
#: (d) the TP split at published width, emulated in one process: one
#: layer of qwen1.5-4b (bf16, seed-0 weights, QKV biases drawn from the
#: seed too: ``init``'s are zero) at tp 16 as 16 rank slices through the
#: sharded step's Functions, on this many tokens
DIST_EMU_BATCH, DIST_EMU_SEQ = 2, 1024
#: (d)'s bound on the split layer's output and every gradient (the
#: published leaves' and the input's) against the unsplit layer's, as a
#: fraction of each one's largest value; stated before the first run: bf16
#: partial products summed over 16 ranks round once per rank where the
#: unsplit GEMM rounds once
DIST_EMU_BOUND = DIST_TP_BOUND
#: (d)'s published layers, (arch, layer, dtype, ``n_params()``): qwen1.5-4b
#: (attention and MLP, 20 heads padded to 32), llama4-scout's MoE layer
#: (attention, 40 heads padded to 48 over 8 KV heads repeated to 16, and
#: 4 GB of experts cut on f), a llama-3.2-vision crossed layer (attention,
#: cross-attention over 2048 image tokens, 8 KV heads repeated to 16, and
#: MLP), a zamba2-7b Mamba2 layer (112 heads, 7 a rank) and its shared
#: block, an rwkv6-3b layer (40 heads padded to 48). The state-space
#: layers run in float32: in bf16 their scans are at their conditioning's
#: limit (phase ``lm_families``: rwkv6 35%, zamba2 8% of ``forward``'s own
#: noise apart), so a split's rounding would not tell a fault. So does the
#: crossed layer: in bf16 its gate's gradient, one bf16 scalar summed over
#: 2 x 1024 x 4096 terms that mostly cancel, landed 7 of its ulps (2.78%)
#: from the unsplit layer's, the other leaves within 1.41% (H100 80GB HBM3,
#: 700 W)
DIST_EMU_LAYERS = (("qwen1.5-4b", "block", "bfloat16", 3_949_854_720),
                   ("llama4-scout-17b-a16e", "block", "bfloat16",
                    101_729_566_720),
                   ("llama-3.2-vision-11b", "crossed", "float32",
                    10_127_147_008),
                   ("zamba2-7b", "mamba", "float32", 6_749_630_976),
                   ("zamba2-7b", "shared", "bfloat16", 6_749_630_976),
                   ("rwkv6-3b", "rwkv", "float32", 3_061_841_920))
#: (c) replica fan-out: model2 'reram-fused' behind one replica, batches
#: of these sizes (8 clouds of 1024 points, 3 of 700: run replicated when
#: they do not divide the replica count)
DIST_SERVE_BATCHES = ((8, 1024), (3, 700), (8, 1024))


def _nccl_world():
    """The default process group over NCCL at world size 1 (a free port on
    localhost); the caller destroys it."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    check(dist.get_backend() == "nccl", "distributed: no NCCL group")
    return dist


def _cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def _dist_tp_layout(mesh) -> dict:
    """(a): qwen1.5-4b from seed 0, ``generate`` at tp 1 (the tokens), then
    at tp 16 through its own captured session; the tp 16 prefill and
    :data:`DIST_DECODE` teacher-forced decode steps against tp 1's within
    :data:`DIST_TP_BOUND`; tp 16's captured steps bit for bit the eager
    ones; times, peak memory and the KV caches' bytes; then (e), the
    sharded prefill and decode step at tp 1 on ``mesh``
    (:func:`_dist_sharded_serve`), under ``"sharded_serve"``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg1 = get_config(DIST_ARCH)
    check(cfg1.n_params() == DIST_PARAMS and cfg1.dtype == "bfloat16"
          and cfg1.qkv_bias, "distributed: the config is not the "
                             "published qwen1.5-4b")
    cfg = dataclasses.replace(cfg1, tp=DIST_TP)
    eff, eff_kv, _, _ = cfg.head_layout()
    check((eff, eff_kv) == (32, 32), f"distributed: tp {DIST_TP} layout "
                                     f"{eff}/{eff_kv}, not 32/32")
    params = lm.init(SEED, cfg1)
    prompts = torch.from_numpy(lm_prompts(cfg1, DIST_BATCH, DIST_PROMPT,
                                          SEED))
    new = DIST_DECODE + 1
    out, _ = serve.generate(params, cfg1, prompts, max_new_tokens=new)
    dev_prompts = prompts.cuda()
    runs = {}
    for name, c in (("tp1", cfg1), ("tp16", cfg)):
        torch.cuda.reset_peak_memory_stats()
        serve.generate(params, c, prompts, max_new_tokens=new)
        sess = serve._session(params, c, DIST_BATCH, DIST_PROMPT + new)
        last, steps = _lm_replay(sess, dev_prompts, out)
        s, ids1 = DIST_PROMPT, out[:, DIST_PROMPT:DIST_PROMPT + 1]
        pos = torch.tensor(s, dtype=torch.int32, device="cuda")
        runs[name] = {
            "last": last.clone(), "steps": [lg.clone() for lg in steps],
            "prefill_ms": _wall_ms(lambda: sess.prefill(dev_prompts)),
            "decode_ms": _wall_ms(lambda: sess.decode(sess.cache, ids1,
                                                      pos)),
            "kv_cache_bytes": _cache_bytes(sess.cache),
            "kv_heads": int(sess.cache["k"].shape[-2]),
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sess": sess}
    tp1, tp16 = runs["tp1"], runs["tp16"]
    check(tp16["kv_heads"] == 32 and tp1["kv_heads"] == 20,
          "distributed: the caches' KV heads")
    pairs = [(tp16["last"], tp1["last"])] + list(zip(tp16["steps"],
                                                     tp1["steps"]))
    compare = _lm_compare(pairs, DIST_TP_BOUND, "tp 16 vs tp 1")
    compare["per_step_err_over_max"] = _per_step_err(pairs)
    bitwise = _lm_captured_vs_eager(params, cfg, tp16["sess"], out,
                                    DIST_PROMPT, steps=DIST_DECODE)
    res = {"arch": DIST_ARCH, "tp": DIST_TP, "heads": [cfg1.n_heads, eff],
           "kv_heads": [cfg1.n_kv_heads, eff_kv],
           "batch": DIST_BATCH, "prompt": DIST_PROMPT,
           "decode_steps": DIST_DECODE, "bound": DIST_TP_BOUND,
           "tp16_vs_tp1": compare, "captured_bitwise_steps": bitwise}
    for name, r in runs.items():
        res[name] = {"prefill_ms_median": statistics.median(r["prefill_ms"]),
                     "prefill_ms": r["prefill_ms"],
                     "decode_ms_median": statistics.median(r["decode_ms"]),
                     "decode_ms": r["decode_ms"],
                     "kv_cache_bytes": r["kv_cache_bytes"],
                     "peak_allocated_gb": r["peak_allocated_gb"]}
    res["kv_cache_ratio"] = tp16["kv_cache_bytes"] / tp1["kv_cache_bytes"]
    del runs, tp1, tp16
    serve.clear_lm_captures()
    gc.collect()
    torch.cuda.empty_cache()
    res["sharded_serve"] = _dist_sharded_serve(mesh, params, cfg1,
                                               dev_prompts, out)
    del params
    return res


def _dist_sharded_serve(mesh, params, cfg, prompts, out) -> dict:
    """(e): (a)'s qwen1.5-4b weights at tp 1 through the sharded prefill
    and decode step (``make_prefill`` / ``make_serve_step(..., mesh=)``) on
    the (1, 1) mesh, the weights placed by ``param_pspecs``: the prefill of
    :data:`DIST_BATCH` x :data:`DIST_PROMPT` tokens and :data:`DIST_DECODE`
    teacher-forced decode steps (``out``'s tokens), the logits and every
    cache leaf bit for bit the unsharded ``lm.prefill`` /
    ``lm.decode_step``'s; both eager, their times side by side, and the
    sharded calls' gathered bytes (copies at one rank)."""
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.launch.sharding import (named_shardings, param_pspecs,
                                             shard_tree)
    from repro_torch.models import lm
    cap = DIST_PROMPT + DIST_DECODE
    sparams = shard_tree(params, named_shardings(param_pspecs(params, mesh),
                                                 mesh))
    prefill = make_prefill(cfg, mesh=mesh)
    step = make_serve_step(cfg, mesh=mesh)
    with torch.no_grad():
        l0, c0 = lm.prefill(params, cfg, prompts, max_seq=cap)
        l1, c1 = prefill(sparams, prompts, max_seq=cap)
        check(torch.equal(l0, l1.to_local()) and all(
            torch.equal(c0[k], c1[k].to_local()) for k in c0),
            "distributed: the sharded prefill differs from lm.prefill")
        prefill_gathers = prefill.gather_stats.as_dict()
        dev_out = out.cuda()
        for t in range(DIST_DECODE):
            ids1 = dev_out[:, DIST_PROMPT + t:DIST_PROMPT + t + 1]
            pos = torch.tensor(DIST_PROMPT + t, dtype=torch.int32,
                               device="cuda")
            d0, _ = lm.decode_step(params, cfg, c0, ids1=ids1, pos=pos)
            d1, _ = step(sparams, c1, ids1, pos)
            check(torch.equal(d0, d1.to_local()),
                  f"distributed: sharded decode step {t} differs from "
                  "lm.decode_step")
        check(all(torch.equal(c0[k], c1[k].to_local()) for k in c0),
              "distributed: the sharded decode steps' cache differs")
        times = {
            "prefill_ms": _wall_ms(lambda: lm.prefill(params, cfg, prompts,
                                                      max_seq=cap)),
            "sharded_prefill_ms": _wall_ms(lambda: prefill(
                sparams, prompts, max_seq=cap)),
            "decode_ms": _wall_ms(lambda: lm.decode_step(
                params, cfg, c0, ids1=ids1, pos=pos)),
            "sharded_decode_ms": _wall_ms(lambda: step(sparams, c1, ids1,
                                                       pos))}
    res = {"arch": DIST_ARCH, "tp": 1, "batch": DIST_BATCH,
           "prompt": DIST_PROMPT, "decode_steps": DIST_DECODE,
           "bitwise": True, "prefill_gathers": prefill_gathers,
           "decode_gathers": step.gather_stats.as_dict()}
    res.update({k: {"median": statistics.median(v), "all": v}
                for k, v in times.items()})
    del sparams, c0, c1
    return res


def _dist_sharded_step(mesh) -> dict:
    """(b): :data:`DIST_TRAIN_STEPS` steps of qwen1.5-0.5b through
    ``make_train_step(..., mesh=)`` on the (1, 1) mesh, the state and batch
    placed by ``state_pspecs`` / ``input_pspecs``, against as many through
    the unsharded (captured) ``make_train_step`` from the same seed: losses
    and every leaf bit for bit (each sharded leaf gathered per layer, over
    mesh dims of 1: copies, the backward's re-gathers too); the eager times
    beside :data:`DIST_WHOLE_GATHER_MS` and the gather counter's bytes a
    step; the device memory each step takes beyond the state (the sharded
    step's and the eager unsharded step's) and the weights' copies that a
    sharded step keeps for its backward; ``compressed_psum``,
    ``pipeline_forward`` and
    ``overlapped_tp_matmul`` on one rank bit for bit their unsharded
    counterparts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.collectives import (compressed_psum,
                                                overlapped_tp_matmul)
    from repro_torch.launch.pipeline import pipeline_forward
    from repro_torch.launch.sharding import (input_pspecs, named_shardings,
                                             shard_tree, state_pspecs)
    from repro_torch.optim import (AdamWConfig, int8_dequantize,
                                   int8_quantize, tree_leaves)
    cfg = get_config(LM_ARCH)
    check(cfg.n_params() == LM_PARAMS, "distributed: the config is not the "
                                       "published qwen1.5-0.5b")
    opt = AdamWConfig()
    batch = _token_batch(cfg, DIST_TRAIN_BATCH, DIST_TRAIN_SEQ)
    losses, plain, plain_step, plain_ms = _train_steps(
        cfg, opt, batch, DIST_TRAIN_STEPS, True)
    state = train.init_train_state(SEED, cfg, opt, device="cuda")
    state = shard_tree(state, named_shardings(state_pspecs(state, mesh),
                                              mesh))
    step = train.make_train_step(cfg, opt, mesh=mesh)
    sharded, sharded_ms = [], []
    for _ in range(DIST_TRAIN_STEPS):
        t0 = time.perf_counter()
        sharded.append(float(step(state, batch)[1]["loss"]))
        sharded_ms.append(1e3 * (time.perf_counter() - t0))
    check(sharded == losses, f"distributed: sharded losses {sharded} != "
                             f"unsharded {losses}")
    check(_leaves_equal(train.state_leaves(plain),
                        [d.to_local() for d in tree_leaves(state)]),
          "distributed: a sharded state leaf differs from the unsharded "
          "step's")
    input_specs = input_pspecs(batch, mesh)
    # steady state, once the comparison is done: the captured step replays;
    # the unsharded step run eagerly parts the eager launches from what the
    # sharded step adds (the gathers, the reduce-scatter, the shards' norm)
    args = tuple(batch.get(k) for k in train.BATCH_KEYS)
    compared_gathers = step.gather_stats.as_dict()
    times = {"sharded_step_ms": _wall_ms(lambda: step(state, batch),
                                         n=DIST_TRAIN_TIMED),
             "unsharded_captured_step_ms": _wall_ms(
                 lambda: plain_step(plain, batch), n=DIST_TRAIN_TIMED),
             "unsharded_eager_step_ms": _wall_ms(
                 lambda: train._step(cfg, opt, False, plain, *args),
                 n=DIST_TRAIN_TIMED)}
    group = mesh.get_group("data")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(DIST_PSUM_SHAPE, generator=gen, device="cuda")
    check(torch.equal(compressed_psum(x, group),
                      int8_dequantize(*int8_quantize(x))),
          "distributed: compressed_psum on one rank is not "
          "int8_dequantize(int8_quantize(x))")
    m, mb, d = DIST_PIPE["m"], DIST_PIPE["mb"], DIST_PIPE["d"]
    w = torch.randn((d, d), generator=gen, device="cuda") / d ** 0.5
    xm = torch.randn((m, mb, d), generator=gen, device="cuda")

    def stage(w, h):
        return torch.tanh(h @ w)
    check(torch.equal(pipeline_forward(stage, w, xm, group),
                      torch.stack([stage(w, h) for h in xm])),
          "distributed: pipeline_forward on one stage is not the stage")
    check(torch.equal(overlapped_tp_matmul(xm[0], w, group), xm[0] @ w),
          "distributed: overlapped_tp_matmul on one rank is not x @ w")
    gathers = step.gather_stats.as_dict()
    profile = {"sharded_step": _host_and_device(lambda: step(state, batch)),
               "unsharded_eager_step": _host_and_device(
                   lambda: train._step(cfg, opt, False, plain, *args))}
    check(gathers == compared_gathers and gathers["gathered_bytes"] > 0,
          f"distributed: the gather counter {gathers} (compared steps "
          f"{compared_gathers})")
    memory = {"sharded_step": _step_memory(lambda: step(state, batch)),
              "unsharded_eager_step": _step_memory(
                  lambda: train._step(cfg, opt, False, plain, *args))}
    counted = _counted_step(lambda: step(state, batch), (state, batch))
    # one more step with the weights' copies counted (every torch call of
    # its forward through a Python mode: not timed)
    step.gather_stats.track_copies = True
    step(state, batch)
    copies = step.gather_stats.as_dict()
    check(copies["gathered_bytes"] == gathers["gathered_bytes"]
          and copies["kept_copy_bytes"] is not None,
          f"distributed: the counted step's gathers {copies}")
    del plain, state
    return {"arch": LM_ARCH, "layers": cfg.n_layers,
            "batch": DIST_TRAIN_BATCH, "seq": DIST_TRAIN_SEQ,
            "losses": losses, "bitwise_steps": DIST_TRAIN_STEPS,
            "compared_sharded_step_ms": sharded_ms,
            "compared_unsharded_step_ms": plain_ms,
            **{k: {"median": statistics.median(v), "all": v,
                   "whole_gather_median": DIST_WHOLE_GATHER_MS[k]}
               for k, v in times.items()},
            "gathers_per_step": gathers, "device_memory": memory,
            "kept_copy_bytes": copies["kept_copy_bytes"], "profile": profile,
            "counted_step": counted,
            "input_specs": {k: list(v) for k, v in input_specs.items()},
            "psum_shape": list(DIST_PSUM_SHAPE), "pipeline": DIST_PIPE}


def _counted_step(fn, arguments) -> dict:
    """One call of ``fn`` under ``FlopCounterMode``, the allocator's peak
    reset before it: its operations, the bytes allocated before it and the
    most during it, the bytes of ``arguments`` (the rank's state shards and
    batch, allocated before it) and ``step_peak_bytes``, the peak less what
    was allocated before plus the arguments: what phase ``dryrun``'s meta
    count of the same step calls its peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.hlo_analysis import tree_bytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    args = tree_bytes(arguments)
    return {"flops": int(counter.get_total_flops()),
            "allocated_before_bytes": before,
            "max_memory_allocated_bytes": peak, "argument_bytes": args,
            "step_peak_bytes": peak - before + args}


def _step_memory(fn) -> dict:
    """One call of ``fn``: the device memory allocated before it, the most
    allocated during it, and the difference, in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"before_bytes": before, "peak_bytes": peak,
            "step_bytes": peak - before}


def _host_and_device(fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (settled first): the
    host's operators by self time and the device's kernels by time, the
    largest ``top`` of each, and the totals."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    host = sorted((e for e in events if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and getattr(e, "self_device_time_total", 0) > 0]
    device.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall,
            "host_self_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
            "device_ms": sum(e.self_device_time_total for e in device) / 1e3,
            "kernel_launches": sum(e.count for e in device),
            "host_top": [{"op": e.key[:60], "count": e.count,
                          "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:top]],
            "device_top": [{"kernel": e.key[:60], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in device[:top]]}


def _emu_layer(arch: str, kind: str, dtype: str, gen):
    """One seeded layer of ``arch`` at published width and tp 16 for (d):
    ``(cfg, the layer's params, its sub-blocks that split, the call on an
    input x)``. qwen1.5-4b's QKV biases drawn from the seed (``init``'s are
    zero), vlm's gate set to :data:`LM_GATE_X` (0 would hide the
    cross-attention), the image embeddings drawn from the seed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(arch), tp=DIST_TP, dtype=dtype)
    pos = torch.arange(DIST_EMU_SEQ, dtype=torch.int32, device="cuda")
    if kind == "mamba":
        return (cfg, lm.mamba_block_init(gen, cfg), ("mamba",),
                lambda p, x: lm._mamba_layer(p, cfg, x)[0])
    if kind == "rwkv":
        return (cfg, lm.rwkv_block_init(gen, cfg), ("time", "channel"),
                lambda p, x: lm._rwkv_layer(p, cfg, x)[0])
    blk = lm.block_init(gen, cfg, cross=kind == "crossed")
    if cfg.qkv_bias:
        for name in "qkv":
            b = blk["attn"][name]["b"]
            b.copy_(0.02 * torch.randn(b.shape, generator=gen, device="cuda"))
    if kind != "crossed":
        return (cfg, blk, tuple(s for s in lm.TP_SUBS if s in blk),
                lambda p, x: lm.block_apply(p, cfg, x, pos)[0])
    blk["gate_x"].fill_(LM_GATE_X)
    img = torch.randn((DIST_EMU_BATCH, cfg.n_image_tokens, cfg.d_image),
                      generator=gen, device="cuda").to(cfg.jdtype)

    def crossed(p, x):
        kv = lm.project_image_kv(p["xattn"], cfg, img)
        return lm.block_apply(p, cfg, x, pos, img_kv=kv)[0]
    return cfg, blk, ("attn", "xattn", "mlp"), crossed


def _dist_tp_split() -> dict:
    """(d): one layer of each of :data:`DIST_EMU_LAYERS` at published
    width (seed-0 weights, :data:`DIST_EMU_BATCH` x :data:`DIST_EMU_SEQ`
    tokens) at tp 16 as 16 rank slices (``TensorParallel(16, range(16))``:
    the sharded step's column- and row-parallel Functions and all-to-all
    re-cuts' layouts, the ranks' partials summed in rank order), forward
    and backward, against the unsplit layer at the same head layout: the
    output and every gradient (the published leaves' and the input's)
    within :data:`DIST_EMU_BOUND` of each one's largest value; the times
    of both."""
    from repro_torch.launch.tp import TensorParallel
    from repro_torch.launch.train import _leaf_paths
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves, tree_map
    tp = TensorParallel(DIST_TP, range(DIST_TP))
    rows = {}
    for arch, kind, dtype, n_params in DIST_EMU_LAYERS:
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        cfg, blk, subs, call_layer = _emu_layer(arch, kind, dtype, gen)
        check(cfg.n_params() == n_params,
              f"distributed: {arch} is not the published config")
        blk = tree_map(lambda t: t.requires_grad_(), blk)
        x = torch.randn((DIST_EMU_BATCH, DIST_EMU_SEQ, cfg.d_model),
                        generator=gen, device="cuda").to(cfg.jdtype)
        x.requires_grad_()
        leaves = tree_leaves(blk) + [x]
        g = torch.randn(x.shape, generator=gen, device="cuda").to(cfg.jdtype)
        out, ms = {}, {}
        for name, split in (("unsplit", False), ("tp16", True)):
            def call():
                p = (dict(blk, **{s: lm.tp_sub_params(blk[s], cfg, tp, s)
                                  for s in subs}) if split else blk)
                y = call_layer(p, x)
                return y, torch.autograd.grad(y, leaves, g,
                                              materialize_grads=True)
            out[name] = call()
            ms[name] = _wall_ms(call, n=2)
        (y0, g0), (y1, g1) = out.pop("unsplit"), out.pop("tp16")

        def rel(a, b):
            a, b = a.detach().float(), b.detach().float()
            return float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
        errs = {"output": rel(y1, y0)}
        keys = [f"grad/{k}" for k in _leaf_paths(blk)] + ["grad/x"]
        errs.update({k: rel(a, b) for k, a, b in zip(keys, g1, g0)})
        del y0, g0, y1, g1, blk, x, g
        worst = max(errs, key=errs.get)
        check(errs[worst] <= DIST_EMU_BOUND,
              f"distributed: {arch} {kind} tp 16 split {worst} off by "
              f"{errs[worst]:.4f} of its largest value (bound "
              f"{DIST_EMU_BOUND})")
        eff, eff_kv, _, _ = cfg.head_layout()
        rows[f"{arch}/{kind}"] = {
            "arch": arch, "layer": kind, "sub_blocks": list(subs),
            "dtype": dtype, "tp": DIST_TP,
            "heads": [cfg.n_heads, eff], "kv_heads": [cfg.n_kv_heads,
                                                      eff_kv],
            "d_ff": cfg.d_ff, "batch": DIST_EMU_BATCH, "seq": DIST_EMU_SEQ,
            "bound": DIST_EMU_BOUND, "worst": [worst, errs[worst]],
            "err_over_max": errs,
            **{f"{k}_fwd_bwd_ms_median": statistics.median(v)
               for k, v in ms.items()},
            "fwd_bwd_ms": ms}
    return rows


def _dist_replicas(params2, cfg2) -> dict:
    """(c): model2 'reram-fused' served through
    ``PointCloudServable(mesh=make_replica_mesh(1))`` and, on a fresh model,
    through ``mesh=None``, the launch counters reset just before each and
    read just after: every row bit for bit, the same launches, each held to
    the captures and plan builds as phase ``serve`` holds them."""
    import repro_torch
    from repro_torch.data import synthetic_cloud
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import (PointCloudServable, ShapeBuckets,
                                    make_replica_mesh)
    mesh = make_replica_mesh(1)
    batches = [[synthetic_cloud(i % 5, n, seed=100 * j + i)
                for i in range(b)]
               for j, (b, n) in enumerate(DIST_SERVE_BATCHES)]
    out = {}
    for name, m in (("replica", mesh), ("plain", None)):
        model = repro_torch.compile_model(params2, cfg2,
                                          backend="reram-fused",
                                          schedule="pointer")
        servable = PointCloudServable(
            model, buckets=ShapeBuckets(**SERVE_BUCKETS), mesh=m)
        reset_launch_counts()
        rows = [torch.stack(servable.run_batch(b)) for b in batches]
        torch.cuda.synchronize()
        counts = launch_counts()
        want = _served_counts(model, servable.plan_cache.misses,
                              PATHS["model2"]["serve_replica" if m
                                             else "serve"])
        for key, n in counts.items():
            check(n == want.get(key, 0),
                  f"distributed {name}: {key} launched {n} times, expected "
                  f"{want.get(key, 0)}")
        out[name] = {"rows": rows, "counts": {k: n for k, n in
                                              counts.items() if n},
                     "captures": model.captures,
                     "trace_shapes": servable.trace_shapes}
    check(all(torch.equal(a, b) for a, b in zip(out["replica"]["rows"],
                                               out["plain"]["rows"])),
          "distributed: replica-served rows differ from mesh=None's")
    check(out["replica"]["counts"] == out["plain"]["counts"],
          f"distributed: replica launches {out['replica']['counts']} != "
          f"{out['plain']['counts']}")
    for key in ("fused_mlp_wstat", "aggregate_diff_batched", "fps",
                "plan_greedy", "plan_coordinate"):
        check(out["replica"]["counts"].get(key, 0) > 0,
              f"distributed: {key} never launched on the replica path")
    return {"replicas": 1, "batches": [list(b) for b in DIST_SERVE_BATCHES],
            "rows_bitwise": sum(r.shape[0] for r in out["replica"]["rows"]),
            "launches": out["replica"]["counts"],
            "captures": out["replica"]["captures"],
            "trace_shapes": out["replica"]["trace_shapes"]}


def phase_distributed(params2, cfg2, smi: str) -> dict:
    """The distributed layer on one card: NCCL at world size 1 over
    ``make_test_mesh((1, 1))`` and ``make_replica_mesh(1)``; (a) the TP head
    layout at published width and depth (:func:`_dist_tp_layout`), (b) the
    sharded train step (per-layer gathers) and the collectives
    (:func:`_dist_sharded_step`), (c) replica fan-out
    (:func:`_dist_replicas`), (d) the tensor-parallel split of a published
    layer at tp 16, emulated in one process (:func:`_dist_tp_split`). Any
    failure, of the group or a collective too, fails the phase: nothing
    falls back to gloo or the CPU. (e) the sharded prefill and decode step
    (:func:`_dist_sharded_serve`). Returns the replica path's launch counts
    and (b)'s results (phase ``dryrun`` reads its counted step)."""
    import gc

    from repro_torch.launch import make_test_mesh
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dist = _nccl_world()
    try:
        mesh = make_test_mesh((1, 1))
        res = {"phase": "distributed", "nvidia_smi": smi,
               "backend": dist.get_backend(),
               "world_size": dist.get_world_size(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        res["tp_layout"] = _dist_tp_layout(mesh)
        res["sharded_serve"] = res["tp_layout"].pop("sharded_serve")
        gc.collect()
        torch.cuda.empty_cache()
        res["sharded_step"] = _dist_sharded_step(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        res["replicas"] = _dist_replicas(params2, cfg2)
        gc.collect()
        torch.cuda.empty_cache()
        res["tp_split"] = _dist_tp_split()
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res["replicas"]["launches"], res["sharded_step"]


# ---------------------------------------------------------------------------
# the dry run (launch/dryrun.py): counts on meta tensors against the card
# ---------------------------------------------------------------------------

#: the step that phase ``distributed`` (b) counts on the card, counted on
#: ``meta`` as rank 0 of a fake world of 1: qwen1.5-0.5b, 2 x 1024, the
#: (1, 1) mesh, at tp 1 as (b) runs it
DRYRUN_STEP = ("qwen1.5-0.5b", 1024, 2)
#: the production cells run through the dry run's command line
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "decode_32k"))
#: the meta count's peak bytes against the card's peak allocated bytes in
#: the same step, as a fraction of the card's (stated before the first run)
DRYRUN_PEAK_BOUND = 0.10
#: seconds the dry run's subprocesses may take
DRYRUN_TIMEOUT_S = 300

_DRYRUN_STEP_CODE = """
import json, sys
from repro_torch.configs import Shape
from repro_torch.launch.dryrun import count_cell
arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
rec = count_cell(arch, Shape("chip_step", "train", seq, batch), (1, 1),
                 cfg_extra={"tp": 1}, limit_s=None)
print(json.dumps(rec))
"""


def start_dryrun() -> dict:
    """Phase ``dryrun``'s host work, started in subprocesses that run
    together on the CPU (after every host-clock time is taken: they would
    load the host that the eager steps' times depend on): the (1, 1) step of
    :data:`DRYRUN_STEP` counted on meta, and each of
    :data:`DRYRUN_CELLS` on the 'single' production mesh through
    ``python -m repro_torch.launch.dryrun``."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tempfile.mkdtemp(prefix="dryrun_")
    arch, seq, batch = DRYRUN_STEP
    procs = {"step": subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_STEP_CODE, arch, str(seq),
         str(batch)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    for arch, shape in DRYRUN_CELLS:
        procs[shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out,
             "--force"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return {"procs": procs, "out": out, "t0": time.perf_counter()}


def stop_dryrun(started: dict) -> None:
    """Kill any of :func:`start_dryrun`'s subprocesses still running."""
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def phase_dryrun(started: dict, sharded: dict, smi: str) -> None:
    """The dry run against the card: the meta count of the (1, 1) step
    (:data:`DRYRUN_STEP`) against phase ``distributed`` (b)'s count of the
    same step on the card: operations exactly equal (``FlopCounterMode``
    on both), the meta peak within :data:`DRYRUN_PEAK_BOUND` of the card's
    (``_counted_step``'s ``step_peak_bytes``), both printed; the roofline
    bound of the step (H100 spec-sheet peaks) beside its measured eager
    time and the unsharded step's replay; each production cell of
    :data:`DRYRUN_CELLS` ``ok`` through the command line, its record's
    memory, collectives and roofline printed."""
    import shutil
    t0 = time.perf_counter()
    logs = {}
    for name, proc in started["procs"].items():
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        check(proc.returncode == 0, f"dryrun: {name} exited "
                                    f"{proc.returncode}:\n{stderr[-3000:]}")
        logs[name] = stdout
    subprocess_s = time.perf_counter() - started["t0"]
    meta = json.loads(logs["step"].strip().splitlines()[-1])
    check(meta["ok"], f"dryrun: the meta count failed: {meta.get('error')}")
    card = sharded["counted_step"]
    flops = meta["cost"]["flops_per_device"]
    check(flops == card["flops"], f"dryrun: meta counts {flops} "
                                  f"operations, the card {card['flops']}")
    peak = meta["memory"]["peak_memory_in_bytes"]
    off = abs(peak - card["step_peak_bytes"]) / card["step_peak_bytes"]
    print(f"dryrun: peak bytes meta {peak}, card {card['step_peak_bytes']} "
          f"(max_memory_allocated {card['max_memory_allocated_bytes']}), "
          f"{off:.4f} apart, bound {DRYRUN_PEAK_BOUND}", flush=True)
    check(off <= DRYRUN_PEAK_BOUND,
          f"dryrun: the meta peak {peak} is {off:.4f} off the card's "
          f"{card['step_peak_bytes']} (bound {DRYRUN_PEAK_BOUND})")
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        path = os.path.join(started["out"], f"{arch}__{shape}__single.json")
        with open(path) as f:
            rec = json.load(f)
        check(rec["ok"], f"dryrun: {arch} x {shape}: {rec.get('error')}")
        cells[f"{arch}/{shape}"] = {
            k: rec[k] for k in ("chips", "build_s", "count_s", "memory",
                                "cost", "collectives", "roofline",
                                "gathers")}
        cells[f"{arch}/{shape}"]["log"] = logs[shape].strip()
    shutil.rmtree(started["out"], ignore_errors=True)
    roof = meta["roofline"]
    emit({"phase": "dryrun", "nvidia_smi": smi,
          "step": {"arch": DRYRUN_STEP[0], "seq": DRYRUN_STEP[1],
                   "batch": DRYRUN_STEP[2], "mesh": [1, 1],
                   "meta_flops": flops, "card_flops": card["flops"],
                   "meta_peak_bytes": peak,
                   "card_step_peak_bytes": card["step_peak_bytes"],
                   "card_max_memory_allocated_bytes":
                       card["max_memory_allocated_bytes"],
                   "card_allocated_before_bytes":
                       card["allocated_before_bytes"],
                   "argument_bytes": [meta["memory"]["argument_size_in_bytes"],
                                      card["argument_bytes"]],
                   "peak_off": off, "peak_bound": DRYRUN_PEAK_BOUND,
                   "meta_bytes": meta["cost"]["bytes_per_device"],
                   "meta_ops": meta["cost"]["ops_per_device"],
                   "roofline_bound_ms": 1e3 * roof["bound_step_time_s"],
                   "roofline": roof,
                   "sharded_eager_step_ms_median":
                       sharded["sharded_step_ms"]["median"],
                   "unsharded_captured_step_ms_median":
                       sharded["unsharded_captured_step_ms"]["median"],
                   "unsharded_eager_step_ms_median":
                       sharded["unsharded_eager_step_ms"]["median"],
                   "count_s": meta["count_s"]},
          "cells": cells, "hbm_per_chip_bytes":
              torch.cuda.get_device_properties(0).total_memory,
          "subprocess_s": subprocess_s,
          "seconds": time.perf_counter() - t0})


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
            if backend.startswith("serve"):
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


#: seconds the card is left idle at the start of each profiling session,
#: after a synchronize and before the profiled calls: the profiler drops
#: the device records of launches made in the first milliseconds of a
#: session (a replayed training step, profiled alone 900 times, lost its
#: first 1 to 171 of 586 launches in 11 sessions, with CPU and CUDA
#: activities or CUDA alone, ``acc_events`` or not, one replay or five, back
#: to back or 0.2 s apart; with a 5 ms pause first, in none of 600)
PROFILE_SETTLE_S = 0.02
#: ``TEARDOWN_CUPTI`` for the script's profiler sessions (where the caller
#: has not set it): "0" keeps CUPTI set up from one session to the next.
#: Torn down after each session (the profiler's default), CUPTI lost every
#: launch of the settled sessions of ``--profiler-loss`` (400 of 400; the
#: unsettled ones between them, none), and late in the script whole
#: sessions of P4's entry recorded nothing; kept, the settled sessions
#: lost none
CUPTI_TEARDOWN = "0"
#: settle of :func:`_call_device_ms`'s sessions, one after the other (late
#: in the script a session may record none of its launches, three in a row
#: now and then)
CALL_PROFILE_SETTLES_S = (PROFILE_SETTLE_S, 0.2, 0.2, 1.0, 1.0)


def _device_rows(fn, calls: int = 1,
                 settle: float = PROFILE_SETTLE_S) -> list:
    """Device time by kernel name over ``calls`` calls of ``fn``, from
    ``torch.profiler``, the session settled for ``settle`` seconds
    first."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(settle)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            rows.append({"kernel": e.key[:80], "count": e.count,
                         "device_ms": t / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def _port_rows(rows) -> list:
    return [r for r in rows if any(name in r["kernel"]
                                   for name in PORT_KERNELS)]


#: sessions of each kind :func:`profiler_loss` takes
PROFILER_LOSS_SESSIONS = 400


def profiler_loss(sessions: int = PROFILER_LOSS_SESSIONS) -> dict:
    """``python3 chip_smoke.py --profiler-loss``: the measurement behind
    :data:`PROFILE_SETTLE_S`. The card's SM clock before and after the
    process makes its CUDA context; then phase ``train``'s replayed step
    profiled alone ``sessions`` times unsettled and ``sessions`` times
    settled, alternating: per kind, the sessions whose K7 or P4 count is
    not 2 or that hold fewer launches than the most common count, and the
    launches each of them misses."""
    def clocks() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,pstate",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    res = {"sm_clock_before_context": clocks()}
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    res["sm_clock_after_context"] = clocks()
    phase_build()
    trainer = _trainer()
    out, _ = _trainer_run(trainer, TRAIN_ARGS)
    clouds, labels = (torch.from_numpy(a).cuda()
                      for a in _first_batch(TRAIN_ARGS))
    kinds = {"unsettled": 0.0, "settled": PROFILE_SETTLE_S}
    seen = {kind: [] for kind in kinds}
    for _ in range(sessions):
        for kind, settle in kinds.items():
            rows = _device_rows(lambda: out["step"](clouds, labels),
                                settle=settle)
            seen[kind].append((_k7_count(rows), _p4_count(rows),
                               sum(r["count"] for r in rows)))
    for kind, counts in seen.items():
        full = statistics.mode(n for _, _, n in counts)
        lost = [full - n for k7, p4, n in counts
                if (k7, p4) != (2, 2) or n < full]
        res[kind] = {"sessions": sessions, "launches": full,
                     "sessions_losing_launches": len(lost),
                     "launches_missing": lost}
    res["settle_s"] = PROFILE_SETTLE_S
    return res


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    os.environ.setdefault("TEARDOWN_CUPTI", CUPTI_TEARDOWN)
    if argv == ["--profiler-loss"]:
        emit({"profiler_loss": profiler_loss()})
        return 0
    if argv:
        print("usage: chip_smoke.py [--profiler-loss]",
              file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.models.pointnet2 import init_params

    smi = smi_line()
    info = phase_device(smi)
    phase_build()
    cfgs = {m: repro_torch.PAPER_MODELS[m] for m in PATHS
            if m in repro_torch.PAPER_MODELS}
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
    replica_counts, sharded = phase_distributed(params["model2"],
                                                cfgs["model2"], smi)
    phase_lm(smi)
    phase_lm_families(smi)
    dryrun = {}
    try:
        lm_train = phase_lm_train(smi, dryrun)
        phase_dryrun(dryrun, sharded, smi)
    finally:
        if dryrun:
            stop_dryrun(dryrun)
    check(set(SERVE_KERNELS) <= {k["name"] for k in kernels},
          "a served kernel has no row")
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
        if k["name"] in SERVE_KERNELS:
            k["serve_launches"] = serve_counts[SERVE_KERNELS[k["name"]]]
            check(k["serve_launches"] > 0,
                  f"{k['name']} never launched on the served path")
            k["replica_launches"] = replica_counts[SERVE_KERNELS[k["name"]]]
            check(k["replica_launches"] > 0,
                  f"{k['name']} never launched on the replica path")
        if k["name"] == "K7 fps":
            k["train_launches"] = train["k7_launches"]
            k["train_launches_per_replay"] = train["k7_launches_per_replay"]
        if k["name"] == "P4 gather_rows_backward":
            k["lm_train_launches"] = lm_train["p4_launches"]
            k["lm_train_launches_per_replay"] = \
                lm_train["p4_launches_per_replay"]
            for name, row in lm_train["p4_embedding"].items():
                if name != "sort_row":
                    k[f"lm_{name}"] = row
    kernels.append({**lm_train["p4_embedding"]["sort_row"],
                    "launches": lm_train["sort_launches"]})
    check(kernels[-1]["launches"] > 0,
          f"{kernels[-1]['name']} never launched on the path")
    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
