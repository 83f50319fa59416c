"""End-to-end training entry point, the counterpart of
``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --batch 4 --seq 4096 --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gatedgcn \\
      --steps 100 --gnn-nodes 2708 --gnn-edges 10556 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch bst \\
      --batch 65536 --steps 100

``--arch`` is an LM (``smollm-135m``, ``gemma3-1b``, ``gemma3-4b``,
``qwen2-moe-a2.7b``, ``phi3.5-moe-42b-a6.6b``: next-token batches of
``--batch`` x ``--seq`` from ``LMStream``) or one of the four GNNs:
``gatedgcn``, ``gat-cora``, ``schnet`` or ``dimenet`` (the molecular
nets get synthesized positions and atom types; DimeNet's triplet table
is built on the host once, with the batch), or the recsys ``bst``
(``--batch`` users a step from ``BSTStream``).  ``cover-edge-tc``, the
paper's triangle count, trains nothing: it exits, as the reference's
entry point does.  It trains on the card
unless ``--device cpu`` is given; without a card and without ``--device
cpu`` it raises.  On the card every attention's forward and backward
goes through K5 and every segment sum (a GNN's, an MoE combine, BST's
profile bags) through K4.

Fault tolerance: ``--max-restarts N`` wraps the fit loop — on watchdog
timeout or crash the loop reloads the latest checkpoint and resumes at
the stored data cursor.  Each attempt starts from the initial weights
(a copy kept when the model is built), since a step updates them in
place: a relaunch before the first checkpoint equals a clean run, as in
the reference, which rebuilds each ``Trainer`` from its untouched
``params``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import arch_module
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer


class FixedStream:
    """The same batch every step; ``cursor`` counts the batches served."""

    def __init__(self, batch):
        self.batch = batch
        self.cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        self.cursor += 1
        return (self.batch,)


def build_lm_pieces(cfg, args):
    """``(loss_fn(model, tokens, labels), stream)`` for an LM: the
    reference's ``build_lm_pieces``, on ``args.device``."""
    from repro_torch.train.data import LMStream

    stream = LMStream(cfg, args.batch, args.seq, seed=args.seed,
                      device=args.device)
    return steps_mod.lm_loss(cfg), stream


def build_gnn_pieces(arch: str, cfg, args):
    """``(loss_fn(model, batch), stream)`` for a GNN on ``args.device``:
    one synthetic batch (``configs.data.gnn_batch``) served every step:
    one graph, or ``--gnn-graphs`` small graphs of ``--gnn-nodes`` nodes
    and at most ``--gnn-edges`` edges each (the molecule shape)."""
    from repro_torch.configs.data import gnn_batch

    batch = gnn_batch(
        arch, cfg, n_nodes=args.gnn_nodes, n_edges_und=args.gnn_edges,
        d_feat=getattr(cfg, "d_in", 16), n_graphs=args.gnn_graphs,
        seed=args.seed, device=args.device,
    )
    return steps_mod.GNN_MODULES[arch].loss_fn, FixedStream(batch)


def build_bst_pieces(cfg, args):
    """``(loss_fn(model, history, target, profile_idx, profile_bag,
    labels), stream)`` for BST: ``args.batch`` users a step from
    ``BSTStream`` on ``args.device``, the reference's
    ``build_bst_pieces``."""
    from repro_torch.models.recsys import bst as bst_m
    from repro_torch.train.data import BSTStream

    stream = BSTStream(cfg, args.batch, seed=args.seed, device=args.device)
    return bst_m.loss_fn, stream


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="LM sequences or BST users a step")
    ap.add_argument("--seq", type=int, default=128,
                    help="LM tokens a sequence")
    ap.add_argument("--gnn-nodes", type=int, default=512)
    ap.add_argument("--gnn-edges", type=int, default=2048)
    ap.add_argument("--gnn-graphs", type=int, default=1,
                    help="batched small graphs (the molecule shape: 128 "
                         "graphs of 30 nodes and 64 edges); 1: one graph")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", choices=["adamw", "adafactor"], default="adamw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--watchdog-s", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain path")
    return ap.parse_args(argv)


def main(argv=None) -> dict | None:
    """Train ``--arch`` for ``--steps`` steps; returns the last fit's
    report (``None`` when a checkpoint already holds every step)."""
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    mod = arch_module(args.arch)
    if mod.FAMILY not in ("gnn", "lm", "recsys"):
        raise SystemExit(f"--arch {args.arch} is not trainable (family "
                         f"{mod.FAMILY}); see repro_torch.api.TriangleEngine "
                         f"/ examples/torch")
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    model = steps_mod.init_for(args.arch, cfg, args.seed, args.device)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{args.arch}: {n_params/1e6:.2f}M params "
          f"({'smoke' if args.smoke else 'full'} config) on {args.device}")
    if mod.FAMILY == "lm":
        loss, stream = build_lm_pieces(cfg, args)
    elif mod.FAMILY == "gnn":
        loss, stream = build_gnn_pieces(args.arch, cfg, args)
    else:
        loss, stream = build_bst_pieces(cfg, args)
    opt_cfg = OptConfig(kind=args.opt, lr=args.lr, warmup=10,
                        total_steps=args.steps)

    attempts = 0
    while True:
        model.load_state_dict(initial)  # undo a failed attempt's steps
        trainer = Trainer(
            loss, model, opt_cfg, ckpt_dir=args.ckpt_dir, cfg=cfg,
            ckpt_every=args.ckpt_every, watchdog_s=args.watchdog_s,
        )
        resumed = trainer.maybe_restore()
        if resumed:
            print(f"resumed from step {trainer.step_num} "
                  f"(cursor {trainer.cursor})")
        remaining = args.steps - trainer.step_num
        if remaining <= 0:
            print("nothing to do")
            return None
        try:
            report = trainer.fit(stream, remaining)
            print(f"done: {report['steps']} steps, "
                  f"final loss {report['final_loss']:.4f}, "
                  f"{report['wall_s']:.1f}s")
            return report
        except (TimeoutError, RuntimeError) as e:  # relaunch path
            attempts += 1
            print(f"step failure: {e} (attempt {attempts})")
            if attempts > args.max_restarts or args.ckpt_dir is None:
                raise


if __name__ == "__main__":
    main()
