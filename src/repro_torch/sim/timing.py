"""Linear-overhead roofline timing model (paper Appendix A, Eq. 9).

    t_iter = W + H · n_active

W — base per-iteration cost (model-weight HBM read amortized over pipeline
stages and AllReduce overlap); H — per-active-sequence overhead (KV-cache
attention reads, sampling, scheduler bookkeeping).

Calibrations:

* ``A100_LLAMA3_70B`` — the paper's defaults (W=8.0 ms, H=0.65 ms), used to
  reproduce Tables 1–3.
* ``MI300X_QWEN3`` — §4.7 projection constants. The paper sizes the
  homogeneous MI300X fleet at 197 nodes for 10,000 req/s (Table 5); we
  back-derive (W, H) from that operating point and the 4× concurrency ratio
  (derivation in benchmarks/table5_mi300x.py).
* ``TPU_V5E_REF`` — our TPU adaptation: W from weight HBM read per chip
  (bytes/819 GB/s over the TP group), H from per-sequence KV read at the
  pool's mean context. Used by the serving engine's performance model.

The physics behind W and H on TPU v5e: a decode iteration must stream the
(TP-sharded) weights once (W) and each active sequence's KV pages once (H·n),
both bounded by HBM bandwidth — exactly the memory-roofline decomposition
used in EXPERIMENTS.md §Roofline for decode shapes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TimingModel:
    """t_iter = W + H·n_active, with a chunked-prefill token budget C."""

    name: str
    w_base: float  # seconds
    h_per_seq: float  # seconds
    prefill_chunk: int = 512  # C tokens per iteration (Appendix A)

    def iter_time(self, n_active: int) -> float:
        return self.w_base + self.h_per_seq * n_active

    def iter_time_batch(self, n_active: np.ndarray) -> np.ndarray:
        """Vectorized roofline: t_iter for a whole fleet of instances.

        Computed as ``W + H·n`` with the same float64 operation order as
        :meth:`iter_time` so the vectorized simulator backend reproduces the
        scalar backend's event times bit-for-bit.
        """
        return self.w_base + self.h_per_seq * n_active.astype(np.float64)

    def constants_f64(self) -> tuple[np.ndarray, np.ndarray]:
        """(W, H) as float64 scalars for device backends.

        Event times are IEEE-754 double accumulations of ``W + H·n`` terms;
        the torch backend (:mod:`repro_torch.sim.torch_engine`) must carry
        them at float64 (its op order is documented there).
        Handing the constants out pre-coerced keeps that dtype discipline in
        one place — a float32 W would silently poison every event time.
        """
        return np.float64(self.w_base), np.float64(self.h_per_seq)

    def iterations_for(self, l_in: int, l_out: int) -> int:
        """ceil(L_in/C) prefill iterations + L_out decode iterations."""
        return math.ceil(max(1, l_in) / self.prefill_chunk) + max(1, l_out)

    def service_time(self, l_in: int, l_out: int, n_active: int) -> float:
        """S = iters · t_iter at a given occupancy (Appendix A)."""
        return self.iterations_for(l_in, l_out) * self.iter_time(n_active)

    def throughput(self, mean_iters: float, n_slots: int) -> float:
        """μ = n_slots / E[S] at full occupancy (Appendix A calibration)."""
        return n_slots / (mean_iters * self.iter_time(n_slots))


#: Paper's calibration for Llama-3-70B on A100 (Appendix A).
A100_LLAMA3_70B = TimingModel(name="a100-llama3-70b", w_base=8.0e-3, h_per_seq=0.65e-3)

#: §4.7 projection constants (see benchmarks/table5_mi300x.py for derivation).
MI300X_QWEN3 = TimingModel(name="mi300x-qwen3-235b", w_base=1.6e-3, h_per_seq=0.062e-3)


def tpu_v5e_model(
    *,
    weight_bytes_total: float,
    tensor_parallel: int,
    kv_bytes_per_token: float,
    mean_context: float,
    hbm_bw: float = 819e9,
    overlap_factor: float = 0.55,
    sched_overhead: float = 0.25e-3,
) -> TimingModel:
    """Derive (W, H) for TPU v5e from first principles.

    W: one full weight read per iteration per chip, discounted by
    ``overlap_factor`` for collective/compute overlap (the XLA latency-hiding
    scheduler overlaps the TP all-reduces with the next layer's weight
    streams). H: one KV read of the sequence's mean context per step, plus
    fixed per-sequence scheduler/sampling overhead.
    """
    w = (weight_bytes_total / tensor_parallel) / hbm_bw * (1.0 + overlap_factor)
    h = (kv_bytes_per_token / tensor_parallel) * mean_context / hbm_bw
    return TimingModel(
        name=f"tpu-v5e(tp={tensor_parallel})",
        w_base=w,
        h_per_seq=h + sched_overhead / 1000.0,
    )
