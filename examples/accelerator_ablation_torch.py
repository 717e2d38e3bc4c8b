"""Full accelerator design-space study (paper ablations + beyond-paper) on
the port's simulator (``repro_torch.core.simulator``, NumPy: it runs on
the host); the twin of ``examples/accelerator_ablation.py``.

Sweeps: the 3 paper models x 5 schedules x 2 buffer policies x buffer
sizes; prints a compact table. This is Figs. 7-10 plus the beyond-paper
Morton/Belady variants in one place.

Run:  PYTHONPATH=src python examples/accelerator_ablation_torch.py
"""
from repro_torch.core import PAPER_MODELS, PointNetWorkload, run_design

DESIGNS = ["baseline", "pointer-1", "pointer-12", "pointer",
           "pointer-morton"]


def main():
    print(f"{'model':8s} {'design':15s} {'policy':7s} {'speedup':>8s} "
          f"{'E-eff':>7s} {'fetchKB':>8s} {'hitL1':>6s} {'hitL2':>6s}")
    rows = {}
    for name, cfg in PAPER_MODELS.items():
        wl = PointNetWorkload.random(cfg, seed=0)
        base = run_design(wl, "baseline")
        for d in DESIGNS:
            for policy in (["lru", "belady"] if d != "baseline" else ["lru"]):
                r = run_design(wl, d, policy=policy)
                rows[name, d, policy] = r
                print(f"{name:8s} {d:15s} {policy:7s} "
                      f"{base.cycles/r.cycles:7.1f}x "
                      f"{base.energy_j/r.energy_j:6.1f}x "
                      f"{r.traffic['fetch']/1024:8.1f} "
                      f"{r.hit_rate[1]:6.2f} {r.hit_rate[2]:6.2f}")
        print()
    print("buffer-size sweep (model0, pointer):")
    wl = PointNetWorkload.random(PAPER_MODELS["model0"], seed=0)
    for kb in (2, 4, 9, 18, 36, 72):
        r = run_design(wl, "pointer", buffer_bytes=kb * 1024)
        print(f"  {kb:3d}KB  hitL1={r.hit_rate[1]:.2f} "
              f"hitL2={r.hit_rate[2]:.2f} fetch={r.traffic['fetch']/1024:.0f}KB")
    return rows


if __name__ == "__main__":
    main()
