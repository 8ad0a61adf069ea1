"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``flash_attention`` — prefill attention (``csrc/flash_attention.cu``),
  replacing ``repro.kernels.flash_attention.flash_attention_pallas``.
* ``paged_attention`` — decode attention over bf16/f32 or int8 KV pages
  (``csrc/paged_attention.cu``), replacing
  ``repro.kernels.paged_attention.paged_attention_pallas``.
* ``ssd_scan`` — the Mamba-2 SSD chunk scan (``csrc/ssd_scan.cu``),
  replacing ``repro.kernels.ssd_scan.ssd_scan_pallas``, and its backward
  (``csrc/ssd_scan_bwd.cu``; the reference differentiates its jnp
  ``ssd_chunked`` with ``jax.grad``).
* ``sim_decode`` — the fleet DES's fused decode-advance round
  (``csrc/sim_decode.cu``), replacing
  ``repro.kernels.sim_decode.decode_advance_pallas``.

The CUDA sources are compiled on first use (``_build``); CPU tensors take
the plain PyTorch versions.
"""
