"""Fault-tolerant checkpointing, the counterpart of
``repro.train.checkpoint``.

  * **atomic**: write to ``step_XXXX.tmp`` -> fsync -> rename; a crash
    mid-write can never corrupt the latest checkpoint;
  * **manifest**: step, config digest and data-stream cursor, so a
    restart resumes the exact stream position and validates the config;
  * arrays are saved as numpy, keyed by their path in the state (a
    module's ``state_dict`` names under ``params/``, the optimizer
    state's under ``opt/``), and restored onto the device of the state
    they are loaded into;
  * retention: the ``keep`` most recent checkpoints are kept.

The reference's mesh shape and shardings (elastic restore onto another
mesh) have no meaning on one card and are left out.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    key = prefix[:-1]
    if isinstance(tree, torch.Tensor):
        return {key: tree.detach().cpu().numpy()}
    return {key: np.asarray(tree)}


def _unflatten_into(tree: Any, flat: dict[str, np.ndarray],
                    prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    shape = tuple(tree.shape) if isinstance(tree, torch.Tensor) else ()
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs {shape}")
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(tree.device, tree.dtype)
    return type(tree)(arr)


def config_digest(cfg: Any) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def save(
    ckpt_dir: str | Path,
    step: int,
    state: Any,
    *,
    cfg: Any = None,
    data_cursor: int = 0,
    keep: int = 3,
) -> Path:
    """Write ``state`` (nested dicts of tensors and numbers) as step
    ``step``; returns the checkpoint's path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    final = ckpt_dir / f"step_{step:08d}.npz"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)  # atomic on POSIX
    manifest = {
        "step": step,
        "file": final.name,
        "time": time.time(),
        "config_digest": config_digest(cfg) if cfg is not None else None,
        "data_cursor": data_cursor,
    }
    mtmp = ckpt_dir / "manifest.tmp"
    mtmp.write_text(json.dumps(manifest, indent=1))
    os.replace(mtmp, ckpt_dir / "manifest.json")
    # retention
    ckpts = sorted(ckpt_dir.glob("step_*.npz"))
    for old in ckpts[:-keep]:
        old.unlink()
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    m = Path(ckpt_dir) / "manifest.json"
    if not m.exists():
        return None
    return json.loads(m.read_text())["step"]


def load(
    ckpt_dir: str | Path,
    state_like: Any,
    *,
    cfg: Any = None,
) -> tuple[Any, dict]:
    """Restore the latest checkpoint into the structure of ``state_like``:
    new tensors on each leaf's device and in its dtype, numbers as its
    type.  Raises if it was written for another config."""
    ckpt_dir = Path(ckpt_dir)
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    if cfg is not None and manifest["config_digest"] is not None:
        if manifest["config_digest"] != config_digest(cfg):
            raise ValueError(
                "checkpoint was written by a different config "
                f"({manifest['config_digest']} != {config_digest(cfg)})"
            )
    with np.load(ckpt_dir / manifest["file"]) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(state_like, flat), manifest
