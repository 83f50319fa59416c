"""Training loop with the fault-tolerance contract wired in, the
counterpart of ``repro.train.trainer``:

  * checkpoint/restart (atomic checkpoints + manifest cursor via
    ``train.checkpoint``);
  * step-time watchdog: a straggling or hung step (> ``watchdog_s``)
    raises, and the launcher's retry loop relaunches from the last
    checkpoint;
  * a log line every ``log_every`` steps;
  * ``int8_compressed_psum``, the reference's int8 gradient reduction
    for data-parallel (replicated-parameter) families, over a shard
    group.

A step is the forward, ``loss.backward()`` and ``opt_update``
(``launch.steps.make_train_step``), in place on the model.  Reading the
loss back is the step's one host sync, so a step's seconds include its
device time.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.launch.steps import make_train_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, opt_init


#: 1 / 127 in float32
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def int8_compressed_psum(tree, shards):
    """Each leaf ``[local, ...]`` (one gradient a shard) quantised to int8
    with its shard's absmax scale, summed over ``shards`` in int32
    (``psum``) and dequantised with the largest shard's scale
    (``pmax``): the reference's arithmetic, bit for bit, including its
    shared scale.  That scale is exact only when every shard has the
    same absmax; otherwise the smaller shards' terms come back scaled up
    by max/own (ROADMAP, reference caveat 6).  Returns the replicated
    sums, float32, ``tree``'s structure without the shard axis."""

    def one(g):
        a = g.abs().amax(dim=tuple(range(1, g.dim()))) + 1e-12  # [local]
        a_b = a.reshape(-1, *([1] * (g.dim() - 1)))
        q = torch.clamp(torch.round(g / a_b * 127.0), -127, 127).to(
            torch.int8)
        qs = shards.psum(q.to(torch.int32))
        scale = shards.pmax(a)  # shared scale bound
        # XLA folds the reference's ``scale / 127.0`` into a product
        # with the float32 reciprocal; the same product keeps its bits
        return qs.to(torch.float32) * (scale * _INV_127)

    if isinstance(tree, dict):
        return {k: int8_compressed_psum(v, shards) for k, v in tree.items()}
    return one(tree)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,          # loss_fn(model, *batch) -> scalar
        model: nn.Module,
        opt_cfg: OptConfig,
        *,
        ckpt_dir: Optional[str] = None,
        cfg: Any = None,
        ckpt_every: int = 100,
        watchdog_s: float = 600.0,
        log_every: int = 10,
    ):
        self.model = model
        self.opt_cfg = opt_cfg
        self.opt_state = opt_init(opt_cfg, dict(model.named_parameters()))
        self.cfg = cfg
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.watchdog_s = watchdog_s
        self.log_every = log_every
        self.step_num = 0
        self.cursor = 0
        self._step = make_train_step(loss_fn, opt_cfg)

    def _state(self) -> dict:
        return {"params": self.model.state_dict(), "opt": self.opt_state}

    def _save(self) -> None:
        ckpt.save(self.ckpt_dir, self.step_num, self._state(), cfg=self.cfg,
                  data_cursor=self.cursor)

    # -- restart path ------------------------------------------------
    def maybe_restore(self) -> bool:
        if self.ckpt_dir is None or ckpt.latest_step(self.ckpt_dir) is None:
            return False
        state, manifest = ckpt.load(self.ckpt_dir, self._state(),
                                    cfg=self.cfg)
        self.model.load_state_dict(state["params"])
        self.opt_state = state["opt"]
        self.step_num = manifest["step"]
        self.cursor = manifest["data_cursor"]
        return True

    def fit(self, stream: Iterable, steps: int, *, log=print) -> dict:
        history, step_s = [], []
        it = iter(stream)
        if hasattr(stream, "cursor"):
            stream.cursor = self.cursor
        t_start = time.time()
        for _ in range(steps):
            batch = next(it)
            t0 = time.time()
            self.opt_state, metrics = self._step(self.model, self.opt_state,
                                                 *batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if dt > self.watchdog_s:
                raise TimeoutError(
                    f"step {self.step_num} took {dt:.0f}s > watchdog "
                    f"{self.watchdog_s}s — aborting for relaunch"
                )
            self.step_num += 1
            self.cursor = getattr(stream, "cursor", self.cursor + 1)
            if self.step_num % self.log_every == 0:
                log(f"step {self.step_num} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"{dt*1e3:.0f}ms")
            history.append(loss)
            step_s.append(dt)
            if (
                self.ckpt_dir is not None
                and self.step_num % self.ckpt_every == 0
            ):
                self._save()
        if self.ckpt_dir is not None:
            self._save()
        return {
            "steps": self.step_num,
            "final_loss": history[-1] if history else float("nan"),
            "history": history,
            "step_seconds": step_s,
            "wall_s": time.time() - t_start,
        }
