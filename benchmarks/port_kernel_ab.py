"""Device times of the port's SSD scan and DES decode-advance kernels, from
one source tree, for comparing two commits on one card.

    python3 benchmarks/port_kernel_ab.py --src path/to/checkout/src

Builds ``ssd_scan`` and ``sim_decode`` from the tree's ``repro_torch``
(into its ``build/``), then times each at the shape its main path gives
it: the SSD scan at zamba2's prefill (B = 1, H = 80, P = N = 64, f32 x,
bf16 B/C) at L = 256 and 200, and the decode-advance round at the Table-2
fleet's stacked (P, I, S) = (2, 224, 128) (one lane, (1, 2, 224, 128), on
trees whose kernel takes the grid's lane axis). Each is read two ways, cold
(a 64 MB L2 flush before every launch, as ``chip_smoke.py`` reads it) and
warm (no flush; the DES reaches its round with the slot arrays in L2):

* ``*_ms``: CUDA events around each launch after a device sleep (the
  method of ``chip_smoke.time_ms``), with ``floor_ms``, the same reading
  for a one-element fill;
* ``*_dev_ms``: the kernel's own device time from ``torch.profiler``.

Prints one JSON line. To compare a parent and a change, run the script on
both trees in one session on one card, in turns (parent, change, change,
parent). Needs one NVIDIA GPU and ``nvcc``; imports no jax.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import torch

ITERS = 50


def time_ms(fn, flush: torch.Tensor) -> float:
    """Mean event time of ``fn`` over ITERS launches, each after ``flush``
    is zeroed and a ~1 ms device sleep."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(ITERS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(ITERS)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / ITERS


def device_ms(fn, flush: torch.Tensor, name: str) -> float:
    """Mean device time of the kernel whose name contains ``name`` over
    ITERS launches, each after ``flush`` is zeroed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if name in e.key]
    if not ev:
        raise SystemExit(f"port_kernel_ab: no device time recorded for {name}")
    return ev[0].self_device_time_total / ev[0].count / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the tree's src/ directory (holds repro_torch)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_ab: needs an NVIDIA GPU")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.sim_decode import decode_advance, random_state
    from repro_torch.kernels.ssd_scan import ssd_scan

    for name in ("ssd_scan", "sim_decode"):
        _build.build(name)
    dev = torch.device("cuda")
    cold = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    warm = torch.empty(1, dtype=torch.uint8, device=dev)
    one = torch.empty(1, device=dev)
    out: dict[str, float | str] = {"src": args.src, "card": torch.cuda.get_device_name(0)}
    out["floor_ms"] = time_ms(lambda: one.fill_(1.0), cold)

    gen = torch.Generator(device=dev).manual_seed(3)
    H, P, N = 80, 64, 64
    for L in (256, 200):
        dt = torch.rand((1, H, L), generator=gen, device=dev) * 0.19 + 0.01
        a = -(torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
        x = torch.randn((1, H, L, P), generator=gen, device=dev) * dt[..., None]
        log_a = (a[None, :, None] * dt).contiguous()
        bm = torch.randn((1, L, N), generator=gen, device=dev).to(torch.bfloat16)
        cm = torch.randn((1, L, N), generator=gen, device=dev).to(torch.bfloat16)

        def scan():
            return ssd_scan(x, log_a, bm, cm)

        out[f"ssd_L{L}_ms"] = time_ms(scan, cold)
        out[f"ssd_L{L}_dev_ms"] = device_ms(scan, cold, "ssd_scan")
        out[f"ssd_L{L}_warm_dev_ms"] = device_ms(scan, warm, "ssd_scan")

    lane = {"lanes": 1} if "lanes" in inspect.signature(random_state).parameters else {}
    st = random_state(0, [8192, 65_536], 224, 128, device=dev, **lane)
    ops = [st[k] for k in ("t_limit", "busy", "now", "nact", "free", "occ", "pre", "sq", "inp",
                           "gen", "rem", "blk", "ft", "tr", "c_max")]

    def round_():
        return decode_advance(*ops, w=8.0e-3, h=0.65e-3, chunk=512)

    out["sim_decode_ms"] = time_ms(round_, cold)
    out["sim_decode_warm_ms"] = time_ms(round_, warm)
    out["sim_decode_dev_ms"] = device_ms(round_, cold, "decode_advance")
    out["sim_decode_warm_dev_ms"] = device_ms(round_, warm, "decode_advance")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
