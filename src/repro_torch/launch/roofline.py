"""Roofline terms of a step (counterpart of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs / (ranks x peak FLOP/s)
    memory     = HBM bytes / (ranks x HBM bytes/s)
    collective = collective wire bytes per rank / link bytes/s

FLOPs and bytes come from :mod:`repro_torch.launch.analytic_cost`, the
collective bytes from the collectives the step issued
(:mod:`repro_torch.launch.comm_count`, whose docstring has the ring
model). The hardware is an argument, :data:`H100_SXM` by default (989
TFLOP/s bf16, 3.35 TB/s HBM, 50 GB/s a GPU of InfiniBand NDR). The
reference's HLO-text parser has no counterpart: the port has no compiled
program to parse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cost_model import H100_SXM, HardwareSpec
from repro_torch.launch.comm_count import CollectiveStats


@dataclasses.dataclass
class Roofline:
    flops_total: float
    bytes_total: float
    collective_bytes_per_chip: float
    chips: int
    hw: HardwareSpec = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.flops_total / (self.chips * self.hw.peak_flops_bf16)

    @property
    def memory_s(self) -> float:
        return self.bytes_total / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def model_flops_fraction(self, model_flops: float) -> float:
        """MODEL_FLOPS / HLO_FLOPs — how much compiled compute is useful."""
        if self.flops_total <= 0:
            return 0.0
        return model_flops / self.flops_total

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_total": self.flops_total,
            "bytes_total": self.bytes_total,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips,
        }


def make_roofline(
    cost_analysis: Optional[dict],
    collectives: CollectiveStats,
    chips: int,
    hw: HardwareSpec = H100_SXM,
) -> Roofline:
    cost = cost_analysis or {}
    return Roofline(
        flops_total=float(cost.get("flops", 0.0)),
        bytes_total=float(cost.get("bytes accessed", 0.0)),
        collective_bytes_per_chip=collectives.wire_bytes_per_chip,
        chips=chips,
        hw=hw,
    )


def model_flops_estimate(n_params: int, tokens: int, *, train: bool) -> float:
    """6·N·D for training; 2·N·D for a forward/decode pass."""
    return (6.0 if train else 2.0) * n_params * tokens
