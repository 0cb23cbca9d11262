"""Serving steps and a minimal batched engine.  Counterpart of
``repro.serve.engine``.

``ServeEngine`` runs greedy (or temperature) generation over a batch of
requests with a fixed-size cache: one prefill (kernel B4 or B5 in every
layer), then one decode step per new token.  It runs on ``cuda`` unless the
caller passes ``device="cpu"``, and raises without a GPU.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.process_object import resolve_device
from repro_torch.models import lm


def build_prefill_step(cfg: ModelConfig, max_seq: Optional[int] = None) -> Callable:
    def prefill_step(params, tokens):
        return lm.prefill(params, cfg, tokens, max_seq=max_seq)

    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens)

    return decode_step


class ServeEngine:
    """Batched generation with a fixed-size cache of ``max_seq`` positions."""

    def __init__(self, cfg: ModelConfig, params: lm.LM, max_seq: int = 256, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params.device != self.device:
            raise ValueError(f"ServeEngine: parameters are on {params.device}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self._prefill = build_prefill_step(cfg, max_seq)
        self._decode = build_decode_step(cfg)

    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int = 32, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompts: (B, S0) integers → (B, S0 + max_new_tokens) int64 on the
        engine's device.  Greedy unless ``temperature > 0`` and a
        ``generator`` (on the engine's device) is given."""
        prompts = torch.as_tensor(prompts, device=self.device).to(torch.int64)
        if self.cfg.family != "ssm" and prompts.shape[1] + max_new_tokens > self.max_seq:
            raise ValueError(f"ServeEngine: {prompts.shape[1]} + {max_new_tokens} tokens "
                             f"exceed max_seq {self.max_seq}")
        logits, cache = self._prefill(self.params, prompts)
        out = [prompts]
        tok = logits.argmax(dim=-1)[:, None]
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = self._decode(self.params, cache, tok)
            step_logits = logits[:, -1]
            if temperature > 0.0 and generator is not None:
                probs = torch.softmax(step_logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = step_logits.argmax(dim=-1)[:, None]
        return torch.cat(out, dim=1)
