"""Correctly rounded fused multiply-add on plain tensors.

The reference's compiled paths (``jax.jit`` on XLA:CPU) contract a
multiply feeding an add into one fused multiply-add, in float32 and in
float64 alike: ``w + h*n`` rounds once, not twice. PyTorch has no ``fma``
operator, and its eager ops each round on their own, so the port writes
those fused products out with these helpers where it must be bit-identical
to the compiled reference (the EMA fold, the budget estimate, the DES event
times). Each call site names the reference expression it mirrors.

Only ``+``, ``-`` and ``*`` of one rounding each are used, so the result is
the same on any IEEE-754 device (CPU or CUDA); the algorithms are exact
barring overflow and underflow, which the simulator's magnitudes never
reach:

* float32: the product of two float32 values is exact in float64, and a
  float64 sum rounded to odd and then to float32 is the correctly rounded
  float32 sum (53 >= 24 + 2 bits);
* float64: Dekker's exact product, then Boldo and Melquiond's emulated FMA
  (exact sum of the addend and the product's high part, its error added to
  the product's low part rounded to odd, then one final rounding).
"""

from __future__ import annotations

import torch

_SPLIT = 134217729.0  # 2**27 + 1, Veltkamp's splitting constant for float64


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """s + e == a + b exactly, with s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """p + e == a * b exactly, with p = fl(a * b) (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Round-to-odd of the exact sum ``s + err`` (``s`` its float64
    round-to-nearest, ``s != 0``): the truncation toward zero with its last
    significand bit set, or ``s`` itself when the sum is exact. ``s`` lies
    past the exact value exactly when ``err`` and ``s`` differ in sign."""
    bits = s.view(torch.int64)
    odd = (bits - ((err < 0) != (s < 0)).to(torch.int64)) | 1
    return torch.where(err != 0, odd.view(torch.float64), s)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (inputs float32)."""
    p = a.double() * b.double()
    s, e = _two_sum(p, c.double())
    return _round_to_odd(s, e).float()


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float64 (inputs float64)."""
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(c, ph)
    vh, vl = _two_sum(tl, pl)
    return th + _round_to_odd(vh, vl)
