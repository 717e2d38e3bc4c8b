"""Accuracy / energy / area Pareto sweeps over ReRAM fault grids.

The port's counterpart of the JAX package's ``repro.reliability.pareto``.
:func:`sweep` compiles one model per (fault rate, protection) grid point —
the faults land on the compiled crossbar planes through
``compile_model(fault_model=...)``, so the kernels run them unchanged —
and scores each point on:

  accuracy    : agreement of the predicted class with the ideal compiled
                model on a deck of :func:`~repro_torch.data.synthetic_cloud`
                clouds;
  energy_j    : per-inference energy of the paper's simulator
                (:func:`~repro_torch.core.simulator.run_design`) plus the
                ECC scrub surcharge (:func:`~repro_torch.reliability.ecc.
                ecc_overhead`);
  area_arrays : 128x128 crossbar arrays of the mapped model
                (:func:`~repro_torch.core.reram.map_mlp_to_arrays`) plus
                the parity arrays ECC occupies.

:func:`pareto_front` keeps the non-dominated points,
:func:`classify_archetypes` names them, and
``PlanPolicy(reliability_target=...).select_protection(points)`` picks the
cheapest point meeting an accuracy bound. Same arguments, same frontier.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.energy import DEFAULT_HW, HWParams
from repro_torch.core.reram import map_mlp_to_arrays
from repro_torch.core.workload import PointNetConfig, PointNetWorkload
from repro_torch.data.pointcloud import synthetic_cloud
from repro_torch.reliability.ecc import EccConfig
from repro_torch.reliability.faults import FaultModel

__all__ = [
    "ArchetypeBands", "DesignPoint", "classify_archetypes", "pareto_front",
    "sweep",
]


@dataclass(frozen=True)
class DesignPoint:
    """One (fault rate, protection) grid point with its three scores;
    ``accuracy``/``energy_j`` are what ``PlanPolicy.select_protection``
    reads."""

    fault_rate: float
    protection: str            # 'none' | 'ecc'
    accuracy: float
    energy_j: float
    area_arrays: int
    ecc_group: int | None = None
    archetype: str | None = None


def _fault_model(rate: float, seed: int) -> FaultModel:
    """Grid knob -> fault model: ``rate`` is the total stuck-cell
    probability, split evenly between stuck-at-0 and stuck-at-1."""
    return FaultModel(p_stuck0=rate / 2, p_stuck1=rate / 2, seed=seed)


def sweep(params, config: PointNetConfig, *,
          fault_rates=(0.0, 0.01, 0.05),
          protections=("none", "ecc"),
          n_clouds: int = 8,
          seed: int = 0,
          backend: str = "reram-fused",
          design: str = "pointer",
          hw: HWParams = DEFAULT_HW,
          ecc_group: int = 16,
          n_classes: int = 40,
          device=None) -> list[DesignPoint]:
    """Run the fault-rate x protection grid and score every point.

    One ideal model is compiled once; each grid point compiles the same
    ``params`` with ``fault_model=`` (and ``ecc=`` for the protected arm)
    on ``device`` (the card by default) and measures agreement on the same
    ``n_clouds`` synthetic clouds, one ``batched_forward`` per model (its
    rows equal ``forward`` on each cloud, bit for bit, on the crossbar
    backends). ``backend`` must be a fused (program-carrying) entry — ECC
    lives on the programs. Deterministic in ``seed``."""
    from repro_torch.core.simulator import run_design  # deferred: layering
    from repro_torch.models.backend import compile_model

    clouds = np.stack([synthetic_cloud(i % n_classes,
                                       n_points=config.n_points,
                                       seed=seed + i)
                       for i in range(n_clouds)])

    def predictions(model):
        return model.batched_forward(clouds).argmax(dim=1).cpu().numpy()

    ref = predictions(compile_model(params, config, backend=backend,
                                    device=device))
    workload = PointNetWorkload.random(config, seed=seed)
    base_energy = run_design(workload, design, hw=hw).energy_j
    base_area = map_mlp_to_arrays(config, hw).total_arrays

    points: list[DesignPoint] = []
    for prot in protections:
        if prot not in ("none", "ecc"):
            raise ValueError(f"unknown protection {prot!r}; expected "
                             f"'none' or 'ecc'")
        ecc = EccConfig(group=ecc_group) if prot == "ecc" else None
        surcharge, extra_arrays = 0.0, 0
        if ecc is not None:
            # overheads depend only on the program layout, not the faults
            probe = compile_model(params, config, backend=backend,
                                  device=device, ecc=ecc)
            rel = probe.stats()["reliability"]["ecc"]
            surcharge, extra_arrays = (rel["scrub_energy_j"],
                                       rel["extra_arrays"])
        for rate in fault_rates:
            model = compile_model(params, config, backend=backend,
                                  device=device, ecc=ecc,
                                  fault_model=_fault_model(rate, seed))
            agree = int((predictions(model) == ref).sum())
            points.append(DesignPoint(
                fault_rate=float(rate), protection=prot,
                accuracy=agree / n_clouds,
                energy_j=base_energy + surcharge,
                area_arrays=base_area + extra_arrays,
                ecc_group=ecc_group if ecc is not None else None))
    return points


def pareto_front(points) -> list[DesignPoint]:
    """Non-dominated subset: maximize accuracy, minimize energy and area.
    A point survives unless some other point is at least as good on all
    three axes and strictly better on one."""
    pts = list(points)

    def dominated(p):
        return any(
            q.accuracy >= p.accuracy and q.energy_j <= p.energy_j
            and q.area_arrays <= p.area_arrays
            and (q.accuracy > p.accuracy or q.energy_j < p.energy_j
                 or q.area_arrays < p.area_arrays)
            for q in pts)

    return [p for p in pts if not dominated(p)]


@dataclass(frozen=True)
class ArchetypeBands:
    """Thresholds for :func:`classify_archetypes`: ``fortress_acc`` an
    absolute accuracy floor; the cost bands relative positions within the
    swept set (0 = cheapest seen, 1 = priciest)."""

    fortress_acc: float = 0.99   # near-ideal accuracy, whatever the cost
    efficient_acc: float = 0.90  # still-accurate floor for the cheap bands
    energy_band: float = 0.35    # relative energy below which a point is
                                 # 'cheap' (SpeedDemon/Efficiency side)
    area_band: float = 0.35      # relative area below which it is 'lean'


def _relative(values) -> list[float]:
    lo, hi = min(values), max(values)
    span = hi - lo
    return [0.0 if span == 0 else (v - lo) / span for v in values]


def classify_archetypes(points, bands: ArchetypeBands = ArchetypeBands()):
    """Name every swept design point: Fortress (accuracy >=
    ``fortress_acc``), Efficiency (accurate enough and cheap on energy),
    Frugal (accurate enough and lean on area), SpeedDemon (cheapest-energy
    band whatever the accuracy), else Unknown, in that precedence. Returns
    ``{"points": [DesignPoint(archetype=...)], "counts": {name: n}}``."""
    pts = list(points)
    if not pts:
        return {"points": [], "counts": {}}
    e_rel = _relative([p.energy_j for p in pts])
    a_rel = _relative([p.area_arrays for p in pts])
    labelled, counts = [], {}
    for p, er, ar in zip(pts, e_rel, a_rel):
        if p.accuracy >= bands.fortress_acc:
            name = "Fortress"
        elif p.accuracy >= bands.efficient_acc and er <= bands.energy_band:
            name = "Efficiency"
        elif p.accuracy >= bands.efficient_acc and ar <= bands.area_band:
            name = "Frugal"
        elif er <= bands.energy_band:
            name = "SpeedDemon"
        else:
            name = "Unknown"
        labelled.append(replace(p, archetype=name))
        counts[name] = counts.get(name, 0) + 1
    return {"points": labelled, "counts": counts}
