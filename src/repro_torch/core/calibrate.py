"""Fig. 10 calibration (documented in EXPERIMENTS.md).

The PyTorch port's own copy of ``repro.core.calibrate``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_decide.py`` holds
its results equal to the original's.

The paper reports *relative* end-to-end speedups only; absolute compute and
per-step software overheads in their ASTRA-SIM setup are not published.
We therefore fit three physical parameters:

  * ``compute_efficiency`` — achieved fraction of the 1 PFLOP/s NPU peak,
  * ``mesh_step_overhead`` — per ring-step processing delay on the mesh,
  * ``fred_step_overhead`` — per flow-step delay on the FRED fabric,

against the eight published speedups (4 workloads × FRED-C/D), then freeze
them for every simulator experiment.  A good joint fit with a single
parameter set is evidence the model captures the paper's mechanisms; the
residuals are reported, not hidden.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

PAPER_SPEEDUPS = {
    "ResNet-152": {"FRED-C": 1.41, "FRED-D": 1.76},
    "Transformer-17B": {"FRED-C": 1.75, "FRED-D": 1.87},
    "GPT-3": {"FRED-C": 1.34, "FRED-D": 1.34},
    "Transformer-1T": {"FRED-C": 1.40, "FRED-D": 1.40},
}


def simulate_speedups(eff: float, mesh_oh: float, fred_oh: float
                      ) -> Dict[str, Dict[str, float]]:
    import repro_torch.core.meshnet as meshnet
    import repro_torch.core.fabric as fabric
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.workloads import paper_workloads

    out = {}
    for w in paper_workloads():
        row = {}
        sims = {}
        for name in ("baseline", "FRED-C", "FRED-D"):
            sim = Simulator(name, compute_efficiency=eff)
            if sim.mesh is not None:
                sim.mesh.step_overhead = mesh_oh
            else:
                sim.fred.config = type(sim.fred.config)(
                    **{**sim.fred.config.__dict__, "step_overhead": fred_oh})
            sims[name] = sim.run(w).total
        base = sims["baseline"]
        out[w.name] = {"FRED-C": base / sims["FRED-C"],
                       "FRED-D": base / sims["FRED-D"]}
    return out


def loss(speedups) -> float:
    err = 0.0
    for wname, row in PAPER_SPEEDUPS.items():
        for cfg, target in row.items():
            err += (math.log(speedups[wname][cfg]) - math.log(target)) ** 2
    return err


def fit(verbose: bool = False) -> Tuple[Dict[str, float], float]:
    best, best_err = None, float("inf")
    for eff in (0.25, 0.35, 0.45, 0.6, 0.8, 1.0):
        for mesh_oh in (2e-7, 4e-7, 6e-7, 8e-7, 1.2e-6):
            for fred_oh in (5e-8, 1e-7, 2e-7, 4e-7):
                sp = simulate_speedups(eff, mesh_oh, fred_oh)
                e = loss(sp)
                if e < best_err:
                    best, best_err = {"compute_efficiency": eff,
                                      "mesh_step_overhead": mesh_oh,
                                      "fred_step_overhead": fred_oh}, e
                    if verbose:
                        print(f"eff={eff} mesh_oh={mesh_oh:.1e} "
                              f"fred_oh={fred_oh:.1e} err={e:.4f}")
    return best, best_err


# Frozen calibration (re-derive with ``python -m repro_torch.core.calibrate``).
CALIBRATED = {"compute_efficiency": 0.45,
              "mesh_step_overhead": 6e-7,
              "fred_step_overhead": 4e-7}


def main():
    best, err = fit(verbose=True)
    print("\nbest:", best, "err:", err)
    sp = simulate_speedups(**{k: v for k, v in zip(
        ("eff", "mesh_oh", "fred_oh"),
        (best["compute_efficiency"], best["mesh_step_overhead"],
         best["fred_step_overhead"]))})
    for w, row in sp.items():
        tgt = PAPER_SPEEDUPS[w]
        print(f"  {w:16s} C={row['FRED-C']:.2f} (paper {tgt['FRED-C']}) "
              f"D={row['FRED-D']:.2f} (paper {tgt['FRED-D']})")


if __name__ == "__main__":
    main()
