"""Device times of the port's SSD scan (forward and backward) and DES
decode-advance kernels, from one source tree, for comparing two commits on
one card.

    python3 benchmarks/port_kernel_ab.py --src path/to/checkout/src

Builds ``ssd_scan``, ``ssd_scan_bwd`` and ``sim_decode`` from the tree's
``repro_torch`` (into its ``build/``), then times each at the shape its
main path gives it: the SSD scan at zamba2's prefill (B = 1, H = 80, P = N
= 64, f32 x, bf16 B/C) at L = 256 and 200, its backward at zamba2's
training shape (B = 2, L = 2048) and at L = 256 and 200, and the
decode-advance round at the Table-2 fleet's stacked (P, I, S) = (2, 224,
128) (one lane, (1, 2, 224, 128), on trees whose kernel takes the grid's
lane axis). Each is read two ways, cold (a 64 MB L2 flush before every
launch, as ``chip_smoke.py`` reads it) and warm (no flush; the DES reaches
its round with the slot arrays in L2):

* ``*_ms``: CUDA events around each launch after a device sleep (the
  method of ``chip_smoke.time_ms``), with ``floor_ms``, the same reading
  for a one-element fill;
* ``*_dev_ms``: the kernel's own device time from ``torch.profiler``;
  for the backward, ``ssd_bwd_*_kernels``: each device kernel of one call
  and its ms (the mean over ITERS calls, cold);
* ``ssd_bwd_B2_L2048_by_group_ms``: on trees whose backward takes heads in
  groups (``bwd_group``), the call at the training shape (cold events) with
  GROUPS heads a CTA forced and with the wrapper's own choice.

``mma_sync_tflops`` is the card's mma.sync rate (TF32 m16n8k8 and bf16
m16n8k16, at 4, 8 and 16 warps an SM) from ``benchmarks/mma_sync_rate.cu``,
built with the tree's nvcc: the SSD kernels' products run that way. It
also prints ``ssd_fwd_digests``: SHA-256 digests of the forward's y and
final state at the fixed inputs of :func:`ssd_forward_digests` (the card
test ``test_ssd_forward_bits_match_the_tree_before_the_shared_header``
holds the forward to the digests of the tree before its fragment helpers
moved into ``csrc/mma_split.cuh``).

Prints one JSON line. To compare a parent and a change, run the script on
both trees in one session on one card, in turns (parent, change, change,
parent). Needs one NVIDIA GPU and ``nvcc``; imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import torch

ITERS = 50
#: Heads a CTA of the SSD backward's tensor-core chunk kernel timed beside
#: the wrapper's own choice.
GROUPS = (4, 8, 10)


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


def kernel_split_ms(fn, flush: torch.Tensor) -> dict[str, float]:
    """Each device kernel ``fn`` launches and its mean device ms a call over
    ITERS calls, each after ``flush`` is zeroed (the flush's own fill left
    out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        name = e.name()
        if "fill" in name.lower() or "memset" in name.lower():
            continue
        out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6 / ITERS
    return out


#: (B, L, H, P, N, x dtype, B/C dtype) of the forward's digests: zamba2's
#: widths with a ragged chunk (the N = 64 kernel), f32 B/C, bf16 x with
#: small widths, and N = 256 (the general-N kernel with one buffer).
DIGEST_CASES = (
    (1, 200, 8, 64, 64, torch.float32, torch.bfloat16),
    (1, 256, 8, 64, 64, torch.float32, torch.float32),
    (2, 130, 3, 16, 8, torch.bfloat16, torch.bfloat16),
    (1, 130, 4, 16, 256, torch.float32, torch.float32),
)


def ssd_forward_digests(ssd_scan, dev: torch.device) -> list[list[str]]:
    """SHA-256 (first 16 hex digits) of the bytes of y and of the final
    state that ``ssd_scan`` gives at each of DIGEST_CASES, from inputs drawn
    with numpy (seed 17), so every machine feeds the kernel the same bits."""
    out = []
    for B, L, H, P, N, xdt, bcdt in DIGEST_CASES:
        rng = np.random.default_rng(17)
        dt = rng.uniform(0.01, 0.2, (B, H, L)).astype(np.float32)
        a = -rng.uniform(0.5, 2.0, H).astype(np.float32)
        x = rng.standard_normal((B, H, L, P)).astype(np.float32) * dt[..., None]
        bm = rng.standard_normal((B, L, N)).astype(np.float32)
        cm = rng.standard_normal((B, L, N)).astype(np.float32)
        y, s = ssd_scan(torch.from_numpy(x).to(dev, xdt),
                        torch.from_numpy(a[None, :, None] * dt).to(dev),
                        torch.from_numpy(bm).to(dev, bcdt), torch.from_numpy(cm).to(dev, bcdt))
        out.append([hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                    .hexdigest()[:16] for t in (y, s)])
    return out


def mma_sync_tflops(nvcc: str, build_dir: Path) -> dict:
    """``benchmarks/mma_sync_rate.cu``'s JSON line: TFLOP/s of mma.sync by
    shape and warps an SM."""
    import subprocess

    exe = build_dir / "mma_sync_rate"
    build_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(Path(__file__).with_name("mma_sync_rate.cu"))], check=True)
    return json.loads(subprocess.run([str(exe)], capture_output=True, text=True,
                                     check=True).stdout)


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
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_backward

    for name in ("ssd_scan", "ssd_scan_bwd", "sim_decode"):
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

    for B, L in ((2, 2048), (1, 256), (1, 200)):
        dt = torch.rand((B, H, L), generator=gen, device=dev) * 0.19 + 0.01
        a = -(torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
        x = torch.randn((B, H, L, P), generator=gen, device=dev) * dt[..., None]
        log_a = (a[None, :, None] * dt).contiguous()
        bm = torch.randn((B, L, N), generator=gen, device=dev).to(torch.bfloat16)
        cm = torch.randn((B, L, N), generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn((B, H, L, P), generator=gen, device=dev)
        ds = torch.randn((B, H, P, N), generator=gen, device=dev)
        _, _, states = ssd_scan(x, log_a, bm, cm, return_states=True)

        def backward():
            return ssd_scan_backward(x, log_a, bm, cm, dy, ds, states)

        out[f"ssd_bwd_B{B}_L{L}_ms"] = time_ms(backward, cold)
        out[f"ssd_bwd_B{B}_L{L}_kernels"] = kernel_split_ms(backward, cold)
        choose = getattr(ssd_mod, "bwd_group", None)
        if (B, L) == (2, 2048) and choose is not None:
            own = choose(B, H, L, torch.cuda.get_device_properties(dev).multi_processor_count)
            by_group = {f"{own} (the wrapper's)": out[f"ssd_bwd_B{B}_L{L}_ms"]}
            try:
                for g in GROUPS:
                    ssd_mod.bwd_group = lambda *_, g=g: g
                    by_group[str(g)] = time_ms(backward, cold)
            finally:
                ssd_mod.bwd_group = choose
            out[f"ssd_bwd_B{B}_L{L}_by_group_ms"] = by_group
        del states, x, dy

    out["ssd_fwd_digests"] = ssd_forward_digests(ssd_scan, dev)
    out["mma_sync_tflops"] = mma_sync_tflops(_build.find_nvcc(), _build.BUILD_DIR)
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
