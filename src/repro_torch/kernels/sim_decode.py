"""Fused DES decode-advance round: the Hopper kernel ``csrc/sim_decode.cu``
and its plain PyTorch version.

Counterpart of ``repro.kernels.sim_decode`` (``decode_advance_pallas``, the
Pallas kernel with grid ``(I,)``, and its oracle ``decode_advance_jnp``).
One round of the torch DES tier (:mod:`repro_torch.sim.torch_engine`)
advances every ``(lane, pool, instance)`` row of the stacked ``(G, P, I, S)``
slot arrays of ``G`` grid lanes (``G = 1`` for a single fleet run; the
reference vmaps its kernel over the lanes of ``run_fleet_grid``); per row it

* feeds one prefill chunk to the oldest prefilling slot (first-index argmin
  of ``sq`` over ``occ & pre > 0``);
* computes the event-distance k-jump: the least of completion
  (``min rem``), truncation (``min c_max - ctx``) and the time limit
  (``ceil((t_limit - now) / t_it - 1e-9)``), clamped to ``[1, 2**30]``,
  forced to 1 with prefill or when the KV growth
  ``sum max(blocks_for(inp + gen + k) - blk, 0)`` exceeds ``free``;
* sets ``end = now + k * t_it`` with ``t_it = w + h * nact``, advances
  ``gen`` / ``rem`` / ``ft`` and stages ``trunc_new``, ``tr`` and ``comp``.

Event times are float64 and counters int32, with the reference's sentinels.
The reference's compiled tier runs this pass under ``jax.jit``, where XLA
contracts ``w + h * nact`` and ``now + k * t_it`` into fused multiply-adds
(one rounding each); both versions here do the same (:func:`fma64` in the
plain version, ``__fma_rn`` in the kernel), so they are bit-identical to the
compiled reference and to each other. With dyadic timing constants the two
roundings coincide, which is where the eager ``decode_advance_jnp`` agrees
too. ``c_max`` is a per-pool int32 tensor and ``t_limit`` one float64 per
lane, so one call covers every lane and every pool.

:func:`decode_advance` launches the kernel on CUDA tensors and runs
:func:`decode_advance_plain` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fma import fma64
from repro_torch.core.pools import KV_BLOCK_TOKENS
from repro_torch.kernels import _build

#: Sentinels for "no constraint" in masked min-reductions (int32-safe).
_BIG_I = 1 << 30
_BIG_F = 1.0e18

#: Output names, in the kernel's argument order.
OUTPUTS = ("pre", "dec", "k", "end", "gen", "rem", "ft", "trunc_new", "tr", "comp")


def blocks_for(tok: torch.Tensor) -> torch.Tensor:
    """KV blocks holding ``tok`` tokens (at least one), int32."""
    return torch.clamp((tok + (KV_BLOCK_TOKENS - 1)) // KV_BLOCK_TOKENS, min=1)


def decode_advance_plain(
    t_limit: torch.Tensor,  # (G,) f64 — each lane's sweep boundary (next arrival / inf)
    busy: torch.Tensor,  # (G, P, I) bool — due instances with active sequences
    now: torch.Tensor,  # (G, P, I) f64 — per-instance wake time (0 where not busy)
    nact: torch.Tensor,  # (G, P, I) i32 — active sequences per instance
    free: torch.Tensor,  # (G, P, I) i32 — free KV blocks per instance
    occ: torch.Tensor,  # (G, P, I, S) bool — slot occupied
    pre: torch.Tensor,  # (G, P, I, S) i32 — prefill tokens remaining
    sq: torch.Tensor,  # (G, P, I, S) i32 — admission sequence number
    inp: torch.Tensor,  # (G, P, I, S) i32 — input tokens
    gen: torch.Tensor,  # (G, P, I, S) i32 — generated tokens
    rem: torch.Tensor,  # (G, P, I, S) i32 — output tokens remaining
    blk: torch.Tensor,  # (G, P, I, S) i32 — KV blocks held
    ft: torch.Tensor,  # (G, P, I, S) f64 — first-token time (nan = not yet)
    tr: torch.Tensor,  # (G, P, I, S) bool — truncated flag
    c_max: torch.Tensor,  # (P,) i32 — each pool's context window
    *,
    w: float,
    h: float,
    chunk: int,
) -> dict[str, torch.Tensor]:
    """One fused decode-advance over the stacked slot arrays, in the
    reference jnp twin's op order; each lane's ``t_limit`` broadcasts over
    its rows. Without the lane axis (``(P, I, S)`` slots and a 0-d
    ``t_limit``) it is one lane's round, as the reference's kernel takes it.
    Returns the dict of :data:`OUTPUTS`:
    ``pre`` (post-chunk prefill), ``dec`` (decoding mask), ``k``/``end``
    (jump and end-of-round time per instance), advanced
    ``gen``/``rem``/``ft``/``tr``, ``trunc_new`` and ``comp``."""
    f64, i32 = torch.float64, torch.int32
    dev = occ.device
    wt = torch.tensor(w, dtype=f64, device=dev)
    ht = torch.tensor(h, dtype=f64, device=dev)
    t_it = fma64(ht, nact.to(f64), wt)  # w + h*nact, one rounding as in XLA
    bb = busy[..., None]
    cm = c_max.to(i32)[:, None, None]
    tl = t_limit[..., None, None]  # a lane's limit over its (P, I) rows

    # one prefill chunk to the oldest prefilling sequence
    pmask = occ & (pre > 0)
    has_pre = pmask.any(dim=-1) & busy
    # torch.argmin returns the first minimal index, as jnp.argmin does
    oldest = torch.argmin(torch.where(pmask, sq, _BIG_I), dim=-1)
    oh = torch.arange(occ.shape[-1], device=dev) == oldest[..., None]
    take = torch.clamp(torch.where(oh, pre, 0).sum(dim=-1, dtype=i32), max=chunk)
    pre_arr = pre - torch.where(oh & has_pre[..., None], take[..., None], 0)

    # event-distance k-jump
    dec = occ & (pre_arr == 0) & (rem > 0)
    ctx0 = inp + gen
    k_complete = torch.where(dec, rem, _BIG_I).amin(dim=-1)
    k_trunc = torch.where(dec, cm - ctx0, _BIG_I).amin(dim=-1)
    q = (tl - now) / t_it
    k_time = torch.where(torch.isfinite(q), torch.ceil(q - 1e-9), _BIG_F)
    k = torch.minimum(torch.minimum(k_complete, k_trunc).to(f64), k_time)
    k = torch.where(has_pre, 1.0, torch.clamp(k, min=1.0))
    k = torch.clamp(k, max=float(_BIG_I)).to(i32)

    ng = gen + torch.where(dec, k[..., None], 0)
    nd = torch.where(occ, blocks_for(inp + ng), 0)
    growth = torch.clamp(nd - blk, min=0).sum(dim=-1, dtype=i32)
    over = busy & (growth > free)
    k = torch.where(over, 1, k).to(i32)
    end = fma64(k.to(f64), t_it, now)  # now + k*t_it, one rounding as in XLA

    # advance + stage completion/truncation for the record scatter
    kcol = torch.where(dec, k[..., None], 0)
    gen_a = gen + kcol
    rem_a = rem - kcol
    ft_a = torch.where(dec & torch.isnan(ft), (now + t_it)[..., None], ft)
    trunc_n = dec & (inp + gen_a >= cm) & (rem_a > 0) & bb
    rem_a = torch.where(trunc_n, 0, rem_a)
    tr_a = tr | trunc_n
    comp = dec & (rem_a == 0) & bb
    return {
        "pre": pre_arr.to(i32),
        "dec": dec,
        "k": k,
        "end": end,
        "gen": gen_a.to(i32),
        "rem": rem_a.to(i32),
        "ft": ft_a,
        "trunc_new": trunc_n,
        "tr": tr_a,
        "comp": comp,
    }


_DTYPES = {
    "busy": torch.bool, "now": torch.float64, "nact": torch.int32,
    "free": torch.int32, "occ": torch.bool, "pre": torch.int32,
    "sq": torch.int32, "inp": torch.int32, "gen": torch.int32,
    "rem": torch.int32, "blk": torch.int32, "ft": torch.float64,
    "tr": torch.bool,
}


def _check(t_limit, rows, slots, c_max) -> tuple[int, int, int, int]:
    dev = t_limit.device
    tensors = [t_limit, c_max, *rows.values(), *slots.values()]
    if not (t_limit.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("all decode_advance operands must lie on one CUDA device")
    if slots["occ"].dim() != 4:
        raise ValueError(
            f"the slot arrays must be (G, P, I, S), got {tuple(slots['occ'].shape)}"
        )
    g, p, i, s = slots["occ"].shape
    if t_limit.dtype != torch.float64 or tuple(t_limit.shape) != (g,):
        raise TypeError(f"t_limit must be ({g},) float64, one time limit a lane")
    if c_max.dtype != torch.int32 or c_max.dim() != 1:
        raise TypeError("c_max must be a (P,) int32 tensor")
    if c_max.shape[0] != p:
        raise ValueError(f"c_max has {c_max.shape[0]} pools, the slots {p}")
    for name, t in {**rows, **slots}.items():
        if t.dtype != _DTYPES[name]:
            raise TypeError(f"{name} must be {_DTYPES[name]}, got {t.dtype}")
        want = (g, p, i) if name in rows else (g, p, i, s)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_advance needs contiguous operands")
    return g, p, i, s


def decode_advance(
    t_limit: torch.Tensor,
    busy: torch.Tensor,
    now: torch.Tensor,
    nact: torch.Tensor,
    free: torch.Tensor,
    occ: torch.Tensor,
    pre: torch.Tensor,
    sq: torch.Tensor,
    inp: torch.Tensor,
    gen: torch.Tensor,
    rem: torch.Tensor,
    blk: torch.Tensor,
    ft: torch.Tensor,
    tr: torch.Tensor,
    c_max: torch.Tensor,
    *,
    w: float,
    h: float,
    chunk: int,
) -> dict[str, torch.Tensor]:
    """The decode-advance round: the kernel on CUDA (one warp per
    ``(lane, pool, instance)`` row, four rows a CTA, one launch for every
    lane and pool; ``(G, P, I, S)`` slots and a ``(G,)`` ``t_limit``), the
    plain version on the CPU. ``t_limit`` stays on the device, so a launch
    needs no host sync."""
    if occ.device.type == "cpu":
        return decode_advance_plain(
            t_limit, busy, now, nact, free, occ, pre, sq, inp, gen, rem,
            blk, ft, tr, c_max, w=w, h=h, chunk=chunk,
        )
    rows = dict(busy=busy, now=now, nact=nact, free=free)
    slots = dict(occ=occ, pre=pre, sq=sq, inp=inp, gen=gen, rem=rem, blk=blk, ft=ft, tr=tr)
    g, p, i, s = _check(t_limit, rows, slots, c_max)
    dev = occ.device
    out = {
        "pre": torch.empty((g, p, i, s), dtype=torch.int32, device=dev),
        "dec": torch.empty((g, p, i, s), dtype=torch.bool, device=dev),
        "k": torch.empty((g, p, i), dtype=torch.int32, device=dev),
        "end": torch.empty((g, p, i), dtype=torch.float64, device=dev),
        "gen": torch.empty((g, p, i, s), dtype=torch.int32, device=dev),
        "rem": torch.empty((g, p, i, s), dtype=torch.int32, device=dev),
        "ft": torch.empty((g, p, i, s), dtype=torch.float64, device=dev),
        "trunc_new": torch.empty((g, p, i, s), dtype=torch.bool, device=dev),
        "tr": torch.empty((g, p, i, s), dtype=torch.bool, device=dev),
        "comp": torch.empty((g, p, i, s), dtype=torch.bool, device=dev),
    }
    fn = _build.kernel_fn("sim_decode")
    code = fn(
        t_limit.data_ptr(),
        *(t.data_ptr() for t in rows.values()),
        *(t.data_ptr() for t in slots.values()),
        c_max.data_ptr(),
        *(out[name].data_ptr() for name in OUTPUTS),
        g, p, i, s, float(w), float(h), int(chunk),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("sim_decode", code)
    decode_advance.launches += 1
    return out


#: Kernel launches since the last reset (plain-version calls not counted).
decode_advance.launches = 0


def random_state(
    seed: int,
    c_max: list[int],
    n_inst: int,
    n_slots: int,
    *,
    t_limit: float | list[float] | None = None,
    lanes: int | None = None,
    device: str | torch.device = "cpu",
) -> dict[str, torch.Tensor]:
    """A random slot state that respects the engine's invariants, for
    holding the kernel against its plain version (and the reference). Drawn
    with numpy from ``seed``; pools ``len(c_max)``, rows ``n_inst``, slots
    ``n_slots``. It has idle rows (``busy`` false with active sequences),
    rows with no free blocks (the growth over-check), slots one to forty
    tokens short of ``c_max`` (truncation), prefilling slots and first
    tokens still to come. ``t_limit`` defaults to 0.75 s past the latest
    wake; pass ``math.inf`` for the final sweep. Keys: ``t_limit`` and the
    decode inputs in :func:`decode_advance`'s order, then ``c_max``.

    Without ``lanes`` the state is one lane's, ``(P, I, S)`` with a 0-d
    ``t_limit``. With ``lanes=G`` it is ``(G, P, I, S)`` with a ``(G,)``
    ``t_limit``: by default lane ``g``'s limit is ``0.75 + 0.25 * g`` s past
    its latest wake, so every lane has its own; ``t_limit`` may also be one
    value for all lanes or a list of ``G``."""
    rng = np.random.default_rng(seed)
    lead = (len(c_max),) if lanes is None else (lanes, len(c_max))
    shape = lead + (n_inst, n_slots)
    cm = np.asarray(c_max, np.int64)[:, None, None]
    occ = rng.random(shape) < 0.7
    pre = np.where(occ & (rng.random(shape) < 0.3), rng.integers(1, 600, shape), 0)
    inp = np.where(occ, rng.integers(16, 1200, shape), 0)
    near = occ & (pre == 0) & (rng.random(shape) < 0.1)
    inp = np.where(near, cm - rng.integers(1, 41, shape), inp)
    gen = np.where(occ & (pre == 0) & ~near, rng.integers(0, 48, shape), 0)
    rem = np.where(occ, rng.integers(1, 120, shape), 0)
    blk = np.where(occ, (inp + gen) // KV_BLOCK_TOKENS + 1, 0)
    sq = np.stack(
        [rng.permutation(n_inst * n_slots) for _ in range(int(np.prod(lead)))]
    ).reshape(shape)
    nact = occ.sum(axis=-1)
    busy = (nact > 0) & (rng.random(shape[:-1]) < 0.8)
    now = np.where(busy, rng.uniform(0.5, 2.0, shape[:-1]), 0.0)
    free = np.where(rng.random(shape[:-1]) < 0.2, 0, rng.integers(0, 64, shape[:-1]))
    ft = np.where(occ & (gen > 0), rng.uniform(0.1, 1.0, shape), np.nan)
    if lanes is None:
        t_lim = float(now.max() + 0.75) if t_limit is None else float(t_limit)
    elif t_limit is None:
        t_lim = now.reshape(lanes, -1).max(axis=1) + 0.75 + 0.25 * np.arange(lanes)
    else:
        t_lim = np.broadcast_to(np.asarray(t_limit, np.float64), (lanes,)).copy()

    def t(x, dt):
        return torch.as_tensor(np.asarray(x), dtype=dt).to(device).contiguous()

    i32 = torch.int32
    return {
        "t_limit": t(t_lim, torch.float64),
        "busy": t(busy, torch.bool),
        "now": t(now, torch.float64),
        "nact": t(nact, i32),
        "free": t(free, i32),
        "occ": t(occ, torch.bool),
        "pre": t(pre, i32),
        "sq": t(sq, i32),
        "inp": t(inp, i32),
        "gen": t(gen, i32),
        "rem": t(rem, i32),
        "blk": t(blk, i32),
        "ft": t(ft, torch.float64),
        "tr": t(np.zeros(shape, bool), torch.bool),
        "c_max": t(c_max, i32),
    }
