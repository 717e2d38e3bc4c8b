"""PlanPolicy — the cost model behind every scheduling decision.

The port's counterpart of the JAX package's ``repro.core.policy``. One
cost-model interface makes three decisions:

  * the TPU's fused dataflow (``predict_hbm_bytes``, ``fused_cost``,
    ``select_fused_plan``): the reference's roofline over its TPU
    accounting, kept so the port reports the reference's choice — under
    ``PlanPolicy(hw=TPU_ROOFLINE)`` it equals the reference's
    ``PlanPolicy()`` field for field;
  * the Hopper dataflow the port launches (``launch_cost``,
    ``select_launch``): K1 ('whole'), K2 ('mtiled') or K3 ('wstat'), ranked
    by the time their launches take on the card — what each block of each
    launch does and what the launch moves
    (:func:`~repro_torch.kernels.program.launch_work`) under ``self.hw``
    (the H100's by default, its per-block constants fitted to the
    kernels' measured times);
  * the intra-layer order (``predict_dma_elisions``, ``select_intra``,
    ``precommit``, ``build_plan``), by predicted DMA elisions of the
    plan-ordered gather, on the host planner.

And the protection level (``select_protection``) over swept reliability
design points. All of it is host arithmetic, made once at compile or plan
time.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .energy import DEFAULT_ROOFLINE, RooflineParams
from .schedule import ExecutionPlan, build_plan, complete_order
from .workload import PointNetWorkload

__all__ = ["DEFAULT_POLICY", "HOPPER_MODES", "PlanPolicy"]

#: The dataflows the port ranks on the card, in the reference's preference
#: order (its 'tiled' runs K1 as 'whole' does): K1, K3, K2.
HOPPER_MODES = ("whole", "wstat", "mtiled")


def _is_traced(points) -> bool:
    """True while a CUDA graph is being captured on the current stream —
    the port's counterpart of a JAX tracer: values cannot be read back to
    score candidates on the host."""
    return (isinstance(points, torch.Tensor) and points.is_cuda
            and torch.cuda.is_current_stream_capturing())


@dataclass(frozen=True)
class PlanPolicy:
    """Roofline cost models + the scheduling decisions they drive.

    hw            : roofline constants (bandwidth, clock, multiply-adds a
                    cycle, on-chip memory, and the hand kernels' launch and
                    per-block costs), defaults to the H100's
                    (:data:`~repro_torch.core.energy.DEFAULT_ROOFLINE`);
                    ``TPU_ROOFLINE`` reproduces the reference's TPU
                    choices.
    vmem_budget   : the on-chip budget the TPU's candidate dataflows must
                    fit (defaults to ``hw.vmem_bytes``).
    window        : working-set rows of the DMA-elision model (72 rows ~
                    the paper's 9 KB buffer at 128 B/row).
    intra_candidates / coordinated : the ordering design space
                    ``select_intra`` searches and the inter-layer
                    coordination it pairs the winner with.
    reliability_target : optional accuracy floor (agreement rate with the
                    ideal program, in [0, 1]) for ``select_protection``.
    """

    hw: RooflineParams = DEFAULT_ROOFLINE
    vmem_budget: int = 0            # 0 -> hw.vmem_bytes
    window: int = 72
    intra_candidates: tuple[str, ...] = ("index", "greedy", "morton")
    coordinated: bool = True
    reliability_target: float | None = None

    def __post_init__(self):
        if self.vmem_budget <= 0:
            object.__setattr__(self, "vmem_budget", self.hw.vmem_bytes)

    # -- the TPU's fused-dataflow cost model (the reference's) ---------------

    def predict_hbm_bytes(self, fused_plan, *, n_layers: int = 1) -> int:
        """HBM bytes one TPU fused launch moves under ``fused_plan``: plane
        tiles plus 'mtiled''s activation stripes, per layer, times
        ``n_layers``."""
        return n_layers * (fused_plan.plane_hbm_bytes_per_layer
                           + fused_plan.act_hbm_bytes_per_layer)

    def predict_compute_cycles(self, fused_plan, *,
                               n_layers: int = 1) -> float:
        """MXU-bound cycles of the same launch: ``m_pad x d_pad x d_pad``
        multiply-adds per layer and bit plane over
        ``hw.mxu_macs_per_cycle``."""
        macs = fused_plan.m_pad * fused_plan.d_pad * fused_plan.d_pad
        return (n_layers * fused_plan.n_planes * macs
                / self.hw.mxu_macs_per_cycle)

    def fused_cost(self, fused_plan, *, n_layers: int = 1) -> float:
        """Roofline cycles: ``max(compute-bound, memory-bound)``."""
        hbm_cycles = (self.predict_hbm_bytes(fused_plan, n_layers=n_layers)
                      / self.hw.hbm_bytes_per_cycle)
        return max(self.predict_compute_cycles(fused_plan,
                                               n_layers=n_layers),
                   hbm_cycles)

    def select_fused_plan(self, program, m_rows: int, **kw):
        """The reference's TPU launch geometry for ``program`` at
        ``m_rows`` rows under this policy:
        :func:`~repro_torch.kernels.program.plan_fused_mlp` with it plugged
        in."""
        from repro_torch.kernels.program import plan_fused_mlp
        return plan_fused_mlp(program, m_rows, policy=self, **kw)

    # -- the Hopper dataflow the port launches --------------------------------

    def predict_device_bytes(self, program, m_rows: int, mode: str, *,
                             batch: int = 1) -> int:
        """Device-memory bytes one call of ``mode``'s kernel moves
        (:func:`~repro_torch.kernels.program.launch_bytes`)."""
        from repro_torch.kernels.program import launch_bytes
        return launch_bytes(program, m_rows, mode, batch=batch)

    def launch_cost(self, program, m_rows: int, mode: str, *,
                    batch: int = 1) -> float:
        """Predicted cycles of one call of ``mode``'s kernel on ``batch``
        elements of ``m_rows`` rows, summed over its launches
        (:func:`~repro_torch.kernels.program.launch_work`): each takes
        ``hw.launch_cycles`` and the larger of its bytes over
        ``hw.hbm_bytes_per_cycle`` and its busiest SM's time — one block's
        slabs, epilogues and requantized inputs at ``hw``'s cycles each,
        times ``max(1, q / hw.block_overlap)`` for ``q`` blocks on that
        SM."""
        from repro_torch.kernels.program import launch_work
        hw = self.hw
        total = 0.0
        for w in launch_work(program, m_rows, mode, batch=batch, sms=hw.sms):
            block = (w.slabs * hw.slab_cycles + w.tiles * hw.tile_cycles
                     + w.requant * hw.requant_cycles)
            per_sm = -(-w.blocks // hw.sms)
            busy = block * max(1.0, per_sm / hw.block_overlap)
            total += hw.launch_cycles + max(
                w.bytes / hw.hbm_bytes_per_cycle, busy)
        return total

    def select_launch(self, program, m_rows: int, *, batch: int = 1):
        """The Hopper dataflow for ``program`` at ``m_rows`` rows a batch
        element: the :class:`~repro_torch.kernels.program.LaunchGeometry`
        of the one of :data:`HOPPER_MODES` with the least
        :meth:`launch_cost`, ties in that order. 'mtiled' competes only
        where K2's stripes fit on chip (elsewhere it runs K1). A function
        of shapes only."""
        from repro_torch.kernels.program import mtiled_on_chip, plan_launch
        best, best_cost = None, None
        for mode in HOPPER_MODES:
            geom = plan_launch(program, m_rows, mode)
            if mode == "mtiled" and not mtiled_on_chip(geom):
                continue
            cost = self.launch_cost(program, m_rows, mode, batch=batch)
            if best_cost is None or cost < best_cost:
                best, best_cost = geom, cost
        return best

    # -- intra-layer ordering cost model -------------------------------------

    def _plan_elisions(self, workload: PointNetWorkload, plan: ExecutionPlan,
                       window: int | None = None) -> int:
        """Total elisions of ``plan``'s orphan-completed, plan-ordered
        gather neighbor streams — exactly the streams the executed gather
        runs."""
        from repro_torch.kernels.ops import count_dma_elisions
        window = self.window if window is None else window
        elided = 0
        for k in range(1, workload.n_layers + 1):
            nb = np.asarray(workload.neighbors[k])
            order = complete_order(np.asarray(plan.order_of(k)),
                                   nb.shape[0], k)
            elided += count_dma_elisions(nb[order], window=window)["elided"]
        return elided

    def predict_dma_elisions(self, workload: PointNetWorkload, *,
                             intra: str, coordinated: bool | None = None,
                             window: int | None = None) -> int:
        """Total DMA elisions the plan-ordered gather neighbor streams of
        ``intra`` would produce on ``workload`` under a ``window``-row
        working set."""
        plan = build_plan(
            workload, intra=intra,
            coordinated=self.coordinated if coordinated is None
            else coordinated)
        return self._plan_elisions(workload, plan, window)

    def _select_plan(self, workload: PointNetWorkload) -> ExecutionPlan:
        """Build each candidate's plan once, score it, return the winner;
        ties keep candidate order, so 'index' wins when reordering buys
        nothing."""
        best_plan, best_elided = None, -1
        for cand in self.intra_candidates:
            plan = build_plan(workload, intra=cand,
                              coordinated=self.coordinated)
            e = self._plan_elisions(workload, plan)
            if e > best_elided:
                best_plan, best_elided = plan, e
        return best_plan

    def select_intra(self, workload: PointNetWorkload) -> str:
        """The intra mode among ``intra_candidates`` with the most
        predicted DMA elisions on ``workload``. A single-candidate policy
        (:meth:`precommit`'s result) answers without touching the
        geometry; a multi-candidate policy needs concrete coordinates and
        raises ``TypeError`` while a CUDA graph is being captured."""
        if len(self.intra_candidates) == 1:
            return self.intra_candidates[0]
        if any(_is_traced(p) for p in workload.points):
            raise TypeError(
                "PlanPolicy.select_intra scores candidate orders on "
                "concrete geometry and cannot run on traced values; "
                "precommit the decision first "
                "(policy.precommit(representative_workload)) or pass a "
                "single-candidate policy")
        return self._select_plan(workload).intra

    def precommit(self, workload: PointNetWorkload) -> "PlanPolicy":
        """Pin the intra decision at compile time: score the candidates on
        a representative ``workload`` once, on the host, and return a copy
        whose ``intra_candidates`` holds only the winner — so
        ``compile_model(policy=...)`` can plan on the card (P1, P2)."""
        return dataclasses.replace(
            self, intra_candidates=(self._select_plan(workload).intra,))

    def build_plan(self, workload: PointNetWorkload) -> ExecutionPlan:
        """The ordering decision end to end: the winning (coordinated)
        plan by predicted elisions."""
        return self._select_plan(workload)

    # -- protection-level decision --------------------------------------------

    def select_protection(self, points):
        """The cheapest protection level meeting ``reliability_target``:
        among swept design points (:class:`~repro_torch.reliability.
        DesignPoint` or any object with ``accuracy``/``energy_j``) whose
        accuracy meets the target, the one with the lowest energy (area
        breaks ties). With no target every point qualifies. Raises
        ``ValueError`` when no point meets the bound."""
        points = list(points)
        if not points:
            raise ValueError("select_protection needs at least one "
                             "candidate design point")
        target = self.reliability_target
        ok = [p for p in points
              if target is None or p.accuracy >= target]
        if not ok:
            best = max(p.accuracy for p in points)
            raise ValueError(
                f"no design point meets reliability_target="
                f"{target} (best accuracy among {len(points)} "
                f"candidates: {best:.4f}); sweep stronger protection "
                f"levels or lower the target")
        return min(ok, key=lambda p: (p.energy_j,
                                      getattr(p, "area_arrays", 0)))


DEFAULT_POLICY = PlanPolicy()
