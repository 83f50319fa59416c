"""End-to-end LM training with checkpoint and restart on the PyTorch
port (the smoke config of smollm-135m by default; ``--full`` trains the
real one), on the card unless ``--device cpu``.  On the card every
attention's forward and backward goes through K5.

The run stops after ``--restart-at`` steps, as a crashed job would, and
a fresh process's worth of state (new weights, a new trainer) restores
the checkpoint, the optimizer state and the stream's cursor and trains
the rest; the result equals an uninterrupted run's (``--restart-at 0``).

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu \\
        --steps 20 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs.registry import arch_module
from repro_torch.launch import steps as steps_mod
from repro_torch.train.data import LMStream
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--restart-at", type=int, default=None,
                    help="steps before the restart (default: half; 0: "
                         "no restart)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    args = ap.parse_args(argv)
    restart_at = args.steps // 2 if args.restart_at is None else \
        args.restart_at

    mod = arch_module("smollm-135m")
    cfg = mod.CONFIG if args.full else mod.SMOKE
    opt_cfg = OptConfig(lr=1e-3, warmup=20, total_steps=args.steps)
    tmp = None if args.ckpt_dir else tempfile.TemporaryDirectory(
        prefix="train_lm_ckpt_")
    ckpt_dir = args.ckpt_dir or tmp.name

    def trainer() -> Trainer:
        model = steps_mod.init_for("smollm-135m", cfg, 0, args.device)
        return Trainer(steps_mod.lm_loss(cfg), model, opt_cfg,
                       ckpt_dir=ckpt_dir, cfg=cfg, ckpt_every=50)

    def stream() -> LMStream:
        return LMStream(cfg, args.batch, args.seq, seed=0,
                        device=args.device)

    first = trainer()
    n = sum(p.numel() for p in first.model.parameters())
    print(f"{cfg.name}: {n/1e6:.1f}M params on {args.device}")
    if first.maybe_restore():
        print(f"resumed from step {first.step_num}")
    history, resumed_from = [], None
    if 0 < restart_at < args.steps and first.step_num < restart_at:
        history += first.fit(stream(), restart_at - first.step_num)[
            "history"]
        print(f"stopped at step {first.step_num}; restarting")
        first = trainer()                       # the relaunched process
        if not first.maybe_restore():
            raise SystemExit("the restart found no checkpoint")
        resumed_from = first.step_num
        print(f"resumed from step {resumed_from} (cursor {first.cursor})")
    report = first.fit(stream(), args.steps - first.step_num)
    history += report["history"]
    print(f"final loss {report['final_loss']:.4f} "
          f"({report['wall_s']:.1f}s)")
    state = {k: v.detach().cpu().clone()
             for k, v in first.model.state_dict().items()}
    if tmp is not None:
        tmp.cleanup()
    return dict(history=history, final_loss=report["final_loss"],
                steps=report["steps"], resumed_from=resumed_from,
                params=n, state=state)


if __name__ == "__main__":
    main()
