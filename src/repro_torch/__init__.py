"""PyTorch/CUDA port of the reference package ``repro``.

Module paths mirror ``repro``. The port imports ``torch`` and never
``jax`` or ``repro``. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``, and raise when no GPU is present.
"""
