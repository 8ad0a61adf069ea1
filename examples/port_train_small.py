"""Train a ~100M-parameter model for a few hundred steps on the PyTorch
port, with checkpoints and (optionally) a mid-run simulated failure and
restart.

    PYTHONPATH=src python examples/port_train_small.py
    PYTHONPATH=src python examples/port_train_small.py --crash   # failure drill
    PYTHONPATH=src python examples/port_train_small.py --steps 4 --device cpu

The port of ``examples/train_small.py`` over
:func:`repro_torch.launch.train.train`: the same width-scaled granite-3-8b
(d_model 768, 12 layers, about 100M parameters) on the same synthetic
corpus, whose n-gram structure gives a real learning curve. ``--device``
defaults to ``cuda`` and raises without a GPU; pass ``cpu`` for the plain
kernels on the host.
"""

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

from repro_torch import configs as cfg_mod
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.fault import SimulatedFailure
from repro_torch.launch.train import train


def hundred_m_config() -> ArchConfig:
    base = get_config("granite-3-8b")
    return dataclasses.replace(
        base,
        name="granite-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab=32_768,
    )


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--crash", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_small"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # register the custom config so the generic launcher can find it
    cfg = hundred_m_config()
    cfg_mod.REGISTRY[cfg.name] = cfg

    kwargs = dict(
        steps=args.steps,
        seq_len=256,
        global_batch=8,
        reduced=False,
        peak_lr=6e-4,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        device=args.device,
    )
    if args.crash:
        try:
            train(cfg.name, simulate_failure_at=args.steps // 2, **kwargs)
        except SimulatedFailure as e:
            print(f"[example] {e} — restarting from latest checkpoint...")
        out = train(cfg.name, **kwargs)  # resumes automatically
    else:
        out = train(cfg.name, **kwargs)
    print(f"[example] final loss: {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
