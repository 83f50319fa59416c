"""Step builders of the LM serving path, the counterparts of the LM part
of ``repro.launch.steps``: ``init_for``, ``lm_prefill_step`` and
``lm_decode_step``."""
from __future__ import annotations

import torch

from repro_torch.configs.registry import arch_module
from repro_torch.models import transformer as tfm


def init_for(arch: str, cfg: tfm.LMConfig, seed: int = 0,
             device: str | torch.device = "cuda") -> tfm.TransformerLM:
    """Random weights of ``cfg`` from ``seed``; ``arch`` must be one the
    port runs (``configs.registry``)."""
    mod = arch_module(arch)
    if mod.FAMILY != "lm":
        raise NotImplementedError(f"--arch {arch}: the port serves LMs only")
    return tfm.init_params(cfg, seed, device)


def lm_prefill_step(cfg: tfm.LMConfig, max_len: int):
    def step(model: tfm.TransformerLM, tokens: torch.Tensor):
        return model.prefill(tokens, max_len)
    return step


def lm_decode_step(cfg: tfm.LMConfig):
    def step(model: tfm.TransformerLM, cache, token: torch.Tensor,
             index: int):
        return model.decode_step(cache, token, index)
    return step
