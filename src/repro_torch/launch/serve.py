"""Serving driver: prefill + batched greedy decode with the KV cache, the
counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

It runs on the card unless ``--device cpu`` is given; without a card the
default raises.  Every attention call on the card goes through K5.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import arch_module
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import LMConfig, TransformerLM


@dataclasses.dataclass
class Served:
    """What :func:`serve` returns."""
    ids: torch.Tensor     # int64 [B, gen]: each step's greedy id
    logits: torch.Tensor  # [gen, B, V]: prefill's last position, then each
                          # decode step
    prefill_s: float      # seconds of the prefill
    decode_s: float       # seconds of the gen - 1 decode steps


def prompt_tokens(cfg: LMConfig, batch: int, prompt_len: int,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Uniform random prompt ids int64 [batch, prompt_len], drawn on the
    CPU from seed 1 whatever ``--seed`` is, as the reference's server
    does (the same ids on every device)."""
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen)
    return ids.to(resolve_device(device))


def serve(model: TransformerLM, tokens: torch.Tensor, gen: int, *,
          forced: torch.Tensor | None = None) -> Served:
    """Prefill ``tokens`` [B, P] into a cache of ``P + gen`` positions, then
    ``gen - 1`` greedy decode steps.  With ``forced`` [B, gen - 1] (or
    wider) the decode steps are fed those ids instead of the previous
    step's argmax (teacher forcing); ``ids`` stays each step's argmax.
    Times are host seconds around work that ends in a device sync."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1; got {gen}")
    dev = model.embed.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    p = tokens.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, p + gen)
    sync()
    prefill_s = time.perf_counter() - t0
    steps, out = [logits], [logits.argmax(-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        feed = out[-1] if forced is None else forced[:, i].to(dev)
        logits, cache = model.decode_step(cache, feed[:, None], p + i)
        steps.append(logits)
        out.append(logits.argmax(-1))
    sync()
    decode_s = time.perf_counter() - t0
    return Served(torch.stack(out, 1), torch.stack(steps), prefill_s,
                  decode_s)


def main(argv: list[str] | None = None) -> Served:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = arch_module(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    model = steps_mod.init_for(args.arch, cfg, args.seed, dev)
    tokens = prompt_tokens(cfg, args.batch, args.prompt_len, dev)
    res = serve(model, tokens, args.gen)
    n = (args.gen - 1) * args.batch
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s*1e3:.1f}ms; {args.gen-1} decode steps in "
          f"{res.decode_s*1e3:.1f}ms "
          f"({n/max(res.decode_s,1e-9):.1f} tok/s)")
    print("generated ids[0]:", res.ids[0].tolist())
    return res


if __name__ == "__main__":
    main()
