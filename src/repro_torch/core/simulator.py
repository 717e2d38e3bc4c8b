"""Trace-driven cycle/energy simulator of the Pointer back-end — the
port's copy of the JAX package's ``repro.core.simulator`` (NumPy), over
the port's host planner (``core/schedule.py``) and workload.

Reproduces the paper's evaluation (Figs. 7-10): three PointNet++ models
(Table 1) on four design points —

  baseline    MARS-like 32x32 MAC array, layer-by-layer, index order
  pointer-1   ReRAM MLP engine only                        (contribution 1)
  pointer-12  + inter-layer coordination                   (contribution 2)
  pointer     + topology-aware intra-layer reordering      (contribution 3)

The paper simulates only the back-end (feature processing); the front-end
(FPS/neighbor search) is pipelined with it and faster, so we do the same.

Dataflow assumptions (the paper's text pins the architecture but not every
micro-decision; each choice below is the one forced or suggested by the
stated 9 KB buffer — see DESIGN.md §8):

  * MAC baseline is neighborhood-fused (MARS-style): one center's K=16
    aggregated vectors stream through all MLP stages, reduced on the fly.
    The 9 KB buffer cannot double-buffer several neighborhoods of the larger
    models alongside weight tiles, so MLP weights stream from DRAM once per
    center (``mac_group`` centers per pass; default 1). This is exactly the
    "repeatedly loading the weight from DRAM" the paper describes.
  * ReRAM engine: weights resident in crossbars (zero weight traffic); one
    input vector initiates per ``reram_ii_cycles`` (bit-serial 8-bit DAC),
    MLP stages pipelined; different SA layers occupy different arrays and
    run in parallel (paper §3.1), so compute time under coordination is the
    max over layers rather than the sum.
  * Every produced output vector is written to DRAM exactly once (paper
    Fig. 9a: "feature vector writing remains unchanged") and also inserted
    into the on-chip buffer, where the next layer may hit it.
  * Compute and DRAM are double-buffered and overlap (``overlap=True``):
    total time is max(compute, DRAM) — both reported.
"""
from __future__ import annotations

from dataclasses import dataclass

from .buffer import BeladyBuffer, BufferModel
from .energy import DEFAULT_HW, HWParams
from .reram import map_mlp_to_arrays, _arrays_for
from .schedule import ExecutionPlan, MODE_PRESETS, build_plan
from .workload import PointNetWorkload

__all__ = ["SimResult", "simulate", "run_design", "DESIGN_POINTS"]

#: design point -> (engine, schedule preset)
DESIGN_POINTS: dict[str, tuple[str, str]] = {
    "baseline": ("mac", "baseline"),
    "pointer-1": ("reram", "pointer-1"),
    "pointer-12": ("reram", "pointer-12"),
    "pointer": ("reram", "pointer"),
    "pointer-morton": ("reram", "pointer-morton"),
}


@dataclass
class SimResult:
    design: str
    engine: str
    cycles: float               # with compute/DRAM overlap
    cycles_serial: float        # without overlap (upper bound)
    compute_cycles: float
    dram_cycles: float
    energy_j: float
    traffic: dict               # bytes: fetch / write / weight
    hit_rate: dict              # per SA layer (1-indexed)
    hits: dict
    misses: dict
    array_ops: int = 0
    macs: int = 0

    @property
    def time_us(self) -> float:
        return self.cycles / 1e3  # 1 GHz -> 1e3 cycles per us

    @property
    def energy_uj(self) -> float:
        return self.energy_j * 1e6

    @property
    def total_dram_bytes(self) -> float:
        return sum(self.traffic.values())


def simulate(workload: PointNetWorkload, plan: ExecutionPlan, *,
             engine: str = "reram", hw: HWParams = DEFAULT_HW,
             buffer_bytes: int | None = None, policy: str = "lru",
             overlap: bool = False, parallel_layers: bool = False,
             mac_group: int = 1, design: str = "custom") -> SimResult:
    if engine not in ("reram", "mac"):
        raise ValueError(f"unknown engine {engine!r}")
    cfg = workload.config
    cap = hw.buffer_bytes if buffer_bytes is None else int(buffer_bytes)

    if policy == "belady":
        ref = [(k - 1, int(j))
               for (k, i) in plan.trace
               for j in workload.neighbors[k][i]]
        buf = BeladyBuffer(cap, ref)
    else:
        buf = BufferModel(cap, policy=policy)

    L = cfg.n_layers
    fetch_bytes = 0
    write_bytes = 0
    weight_bytes = 0
    hits = {k: 0 for k in range(1, L + 1)}
    misses = {k: 0 for k in range(1, L + 1)}
    sram_bytes = 0
    dig_bytes = 0
    compute_by_layer = {k: 0.0 for k in range(1, L + 1)}
    macs = 0
    array_ops = 0

    # Per-layer static quantities.
    in_bytes = {k: cfg.layers[k - 1].in_features * hw.act_bytes
                for k in range(1, L + 1)}
    out_bytes = {k: cfg.layers[k - 1].out_features * hw.act_bytes
                 for k in range(1, L + 1)}
    layer_weights = {k: cfg.layers[k - 1].weights for k in range(1, L + 1)}
    mac_tiles = {k: sum((-(-n // hw.mac_width)) * (-(-m // hw.mac_width))
                        for (n, m) in cfg.layers[k - 1].mlp_shapes)
                 for k in range(1, L + 1)}
    arrays_per_vec = {k: sum(_arrays_for(n, m, hw)
                             for (n, m) in cfg.layers[k - 1].mlp_shapes)
                      for k in range(1, L + 1)}

    # MAC baseline streams each layer's weights once per ``mac_group``
    # centers; track position within the group per layer.
    group_ctr = {k: 0 for k in range(1, L + 1)}

    for (k, i) in plan.trace:
        spec = cfg.layers[k - 1]
        K = spec.n_neighbors
        # --- aggregation: fetch K neighbor feature vectors of layer k-1 ---
        for j in workload.neighbors[k][i]:
            key = (k - 1, int(j))
            if buf.access(key, in_bytes[k]):
                hits[k] += 1
                sram_bytes += in_bytes[k]
            else:
                misses[k] += 1
                fetch_bytes += in_bytes[k]
        dig_bytes += K * in_bytes[k]          # difference computation
        # --- feature computation ---
        if engine == "reram":
            compute_by_layer[k] += K * hw.reram_ii_cycles
            array_ops += K * arrays_per_vec[k]
        else:
            compute_by_layer[k] += K * mac_tiles[k]
            macs += K * spec.macs_per_vector
            if group_ctr[k] % max(1, mac_group) == 0:
                weight_bytes += layer_weights[k] * hw.weight_bytes
            group_ctr[k] += 1
        dig_bytes += K * out_bytes[k]         # max-pool reduction
        # --- write-back: once per produced vector; also buffered on-chip ---
        write_bytes += out_bytes[k]
        buf.insert((k, int(i)), out_bytes[k])
        sram_bytes += out_bytes[k]

    dram_total = fetch_bytes + write_bytes + weight_bytes
    dram_cycles = dram_total / hw.dram_bytes_per_cycle
    if engine == "reram" and plan.coordinated and parallel_layers:
        # different SA layers occupy different arrays (paper 3.1) and can
        # run concurrently; optimistic variant, reported as an ablation.
        compute_cycles = max(compute_by_layer.values())
    else:
        compute_cycles = sum(compute_by_layer.values())
    cycles_overlap = max(compute_cycles, dram_cycles)
    cycles_serial = compute_cycles + dram_cycles
    cycles = cycles_overlap if overlap else cycles_serial

    static_w = hw.static_w_reram if engine == "reram" else hw.static_w_mac
    energy = (dram_total * hw.e_dram_per_byte
              + sram_bytes * hw.e_sram_per_byte
              + dig_bytes * hw.e_dig_per_byte
              + macs * hw.e_mac
              + array_ops * hw.e_array_op
              + static_w * cycles / (hw.freq_ghz * 1e9))

    hit_rate = {k: (hits[k] / (hits[k] + misses[k])
                    if hits[k] + misses[k] else 0.0)
                for k in range(1, L + 1)}
    return SimResult(
        design=design, engine=engine,
        cycles=cycles,
        cycles_serial=cycles_serial,
        compute_cycles=compute_cycles, dram_cycles=dram_cycles,
        energy_j=energy,
        traffic=dict(fetch=fetch_bytes, write=write_bytes,
                     weight=weight_bytes),
        hit_rate=hit_rate, hits=hits, misses=misses,
        array_ops=array_ops, macs=macs)


def run_design(workload: PointNetWorkload, design: str,
               hw: HWParams = DEFAULT_HW, **kw) -> SimResult:
    """Run one of the paper's design points on a workload.

    Buffer policy defaults: the uncoordinated designs (baseline, Pointer-1)
    have a "simple buffer" (paper footnote 1) -> LRU; the coordinated
    designs carry a static execution plan, so the order generator manages
    the buffer as a scratchpad with plan-optimal replacement -> Belady.
    """
    engine, preset = DESIGN_POINTS[design]
    if engine == "reram":
        mapping = map_mlp_to_arrays(workload.config, hw)
        if not mapping.fits:
            raise ValueError(
                f"{workload.config.name}: needs {mapping.total_arrays} arrays"
                f" > budget {mapping.budget}")
    mode = MODE_PRESETS[preset]
    kw.setdefault("policy", "belady" if mode["coordinated"] else "lru")
    plan = build_plan(workload, **mode)
    return simulate(workload, plan, engine=engine, hw=hw, design=design, **kw)
