"""Training CLI — a thin shell over :class:`repro_torch.train.Trainer`
(port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --full \\
      --steps 5 --batch 4 --seq 512 --weight-storage ship --weight-bits 8 \\
      --grad-bits 8 --moment-bits 8

runs on the card (``--device cpu`` runs the plain PyTorch path, for tests).
Checkpoint and fault-injection flags are accepted for the reference's
command lines and raise: the supervisor is not ported (ROADMAP A8).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import TokenStreamConfig
from repro_torch.kernels import registry
from repro_torch.optim import adamw
from repro_torch.quant import PrecisionPlan
from repro_torch.train import Trainer


def make_trainer(arch: str, *, reduced: bool = True, batch: int = 8, seq: int = 64,
                 steps: int = 50, lr: float = 1e-3, moment_bits: int = 0,
                 ckpt_dir: str | None = None, log_every: int = 10,
                 precision: PrecisionPlan | None = None,
                 error_feedback: bool = True, device=None, **cfg_overrides) -> Trainer:
    """The standard Trainer for an (arch, shape) run; ``cfg_overrides``
    replace ModelConfig fields (e.g. ``dtype``, ``n_layers``)."""
    precision = precision if precision is not None else PrecisionPlan()
    get = configs.get_reduced if reduced else configs.get_config
    cfg = get(arch, precision=precision, **cfg_overrides)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                decay_steps=steps, moment_bits=moment_bits)
    stream_cfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch)
    return Trainer(cfg, opt_cfg, stream_cfg=stream_cfg, ckpt_dir=ckpt_dir,
                   log_every=log_every, error_feedback=error_feedback, device=device)


def train(arch: str, *, steps: int = 50, kernel_backend: str | None = None, **kwargs):
    """Returns (final params, losses). ``kernel_backend`` pins the backend
    ('ref' / 'cuda') for this run only."""
    with registry.using(kernel_backend):
        trainer = make_trainer(arch, steps=steps, **kwargs)
        state, losses = trainer.run(steps)
    return state.params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-bits", type=int, default=0)
    ap.add_argument("--weight-bits", type=int, default=0)
    ap.add_argument("--weight-storage", default="fake", choices=("fake", "ship", "int"))
    ap.add_argument("--moment-bits", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--kernel-backend", default=None, choices=registry.available())
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' (the plain PyTorch path)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    precision = PrecisionPlan(model_bits=args.weight_bits,
                              model_storage=args.weight_storage,
                              grad_bits=args.grad_bits)
    with registry.using(args.kernel_backend):
        trainer = make_trainer(
            args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq,
            steps=args.steps, lr=args.lr, moment_bits=args.moment_bits,
            ckpt_dir=args.ckpt_dir, log_every=args.log_every, precision=precision,
            device=args.device)
        name = registry.resolve(None, trainer.device).name
        print(f"[train] {trainer.cfg.name} on {trainer.device}, kernel backend "
              f"{name} (available: {', '.join(registry.available())})", flush=True)
        _, losses = trainer.run(args.steps, fail_at=args.fail_at)
    print(f"[train] done: first loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
