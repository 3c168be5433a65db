"""FRED switch: recursive Clos-style interconnect with reduction/distribution
micro-switches (paper Sec. IV, Fig. 7).

The PyTorch port's own copy of ``repro.core.switch``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

A ``FRED_m(P)`` switch has P input and P output ports.  It is built
recursively like an (m, n=2, r) Clos network:

  * P = 2r   → r input µswitches (2×2), m middle ``FRED_m(r)`` subnetworks,
               r output µswitches.
  * P = 2r+1 → same, but with ``FRED_m(r+1)`` middles and mux/demux wiring
               for the odd port (Chang & Melhem arbitrary-size Beneš).
  * Base cases: FRED_m(2) (single RD-µswitch) and FRED_m(3) (Fig. 7(d)).

µswitch types (Fig. 7(e-g)):
  * ``R``  — can reduce its two inputs into one output.
  * ``D``  — can broadcast one input to both outputs.
  * ``RD`` — both.

Input-stage µswitches are R (reduce on the way in), output-stage are D
(broadcast on the way out), base-case 2×2 are RD.  This module builds the
*structure* (for HW accounting, Table III) and provides per-switch routing
state used by ``core.routing``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class MicroSwitch:
    """One 2×2 µswitch."""
    kind: str          # "R" | "D" | "RD"
    stage: str         # "input" | "output" | "base"

    @property
    def can_reduce(self) -> bool:
        return self.kind in ("R", "RD")

    @property
    def can_distribute(self) -> bool:
        return self.kind in ("D", "RD")


@dataclasses.dataclass
class FredSwitch:
    """Recursive FRED_m(P) switch."""
    ports: int
    m: int
    input_switches: List[MicroSwitch]
    output_switches: List[MicroSwitch]
    middles: List["FredSwitch"]
    is_base: bool = False
    odd: bool = False

    # ---- construction -------------------------------------------------------
    @classmethod
    def build(cls, ports: int, m: int = 3) -> "FredSwitch":
        if ports < 2:
            raise ValueError("FRED switch needs ≥ 2 ports")
        if m < 2:
            raise ValueError("Clos middle count m must be ≥ 2 "
                             "(m=2 rearrangeable, m≥3 strict-sense for unicast)")
        if ports == 2:
            return cls(ports=2, m=m,
                       input_switches=[MicroSwitch("RD", "base")],
                       output_switches=[], middles=[], is_base=True)
        if ports == 3:
            # Fig. 7(d): 3-port base built from R/D/RD µswitches
            return cls(ports=3, m=m,
                       input_switches=[MicroSwitch("R", "base"),
                                       MicroSwitch("RD", "base")],
                       output_switches=[MicroSwitch("D", "base")],
                       middles=[], is_base=True)
        r = ports // 2
        odd = ports % 2 == 1
        sub = r + 1 if odd else r
        return cls(
            ports=ports, m=m,
            input_switches=[MicroSwitch("R", "input") for _ in range(r)],
            output_switches=[MicroSwitch("D", "output") for _ in range(r)],
            middles=[cls.build(sub, m) if sub > 1 else cls.build(2, m)
                     for _ in range(m)],
            odd=odd,
        )

    # ---- port → µswitch mapping ----------------------------------------------
    def input_switch_of(self, port: int) -> Optional[int]:
        """Index of the input µswitch handling ``port`` (None for the odd
        port, which connects through mux/demux directly to the middles)."""
        if self.odd and port == self.ports - 1:
            return None
        return port // 2

    def output_switch_of(self, port: int) -> Optional[int]:
        if self.odd and port == self.ports - 1:
            return None
        return port // 2

    def middle_port_of(self, port: int) -> int:
        """Port index on each middle subnetwork this port maps to."""
        if self.odd and port == self.ports - 1:
            return self.ports // 2          # the extra middle port
        return port // 2

    # ---- accounting (Table III) ----------------------------------------------
    def count_microswitches(self) -> Dict[str, int]:
        counts = {"R": 0, "D": 0, "RD": 0}
        for sw in self.input_switches + self.output_switches:
            counts[sw.kind] += 1
        for mid in self.middles:
            for k, v in mid.count_microswitches().items():
                counts[k] += v
        return counts

    def depth(self) -> int:
        if self.is_base:
            return 1
        return 2 + max(mid.depth() for mid in self.middles)


# --------------------------------------------------------------------------
# HW overhead model (Table III calibration)
# --------------------------------------------------------------------------

# Post-layout numbers from the paper (15 nm NanGate, 24 KB/port buffers):
#   FRED3(12) L1: 685 mm², 2.73 W;  FRED3(11): 678 mm², 2.50 W;
#   FRED3(10) L2: 814 mm², 2.28 W.
# The paper notes area is dominated by wafer-scale I/O (perimeter), not
# switch logic — we model area = a·P + b·µswitches and fit to Table III.

def hw_overhead(switch: FredSwitch, port_bw_gbps: float = 750.0
                ) -> Dict[str, float]:
    counts = switch.count_microswitches()
    n_micro = sum(counts.values())
    # fit: dominated by per-port I/O pads; logic term small
    area_mm2 = 52.0 * switch.ports + 1.2 * n_micro
    power_w = 0.18 * switch.ports + 0.012 * n_micro
    return {"ports": switch.ports, "microswitches": n_micro,
            "area_mm2": area_mm2, "power_w": power_w, **counts}
