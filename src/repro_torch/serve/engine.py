"""Batched serving engine: prefill + greedy/temperature decode loop
(counterpart of ``repro.serve.engine``).

The engine right-pads batched prompts into a rectangle, prefills by
stepping the decoder over it (prompt replay: a prompt shorter than the
longest sees pad zeros before it generates, as in the reference), then
decodes new tokens.  ``on_step`` is called after every decode step (not
after prefill steps) with the running stats, so a VM "measuring job" can
observe serving (paper C9) — see
:class:`repro_torch.serve.vmhook.FleetServeMonitor`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.config import ServeConfig
from repro_torch.models.model import Model


@dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params: Any,
        serve_cfg: ServeConfig = ServeConfig(),
        max_len: int = 512,
        on_step: Optional[Callable[[ServeStats], None]] = None,
    ):
        self.model = model
        self.params = params
        self.cfg = serve_cfg
        self.max_len = max_len
        self.stats = ServeStats()
        self.on_step = on_step

    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> list[list[int]]:
        """Greedy decoding when ``temperature`` is 0; otherwise samples from
        softmax(logits / temperature) with ``generator`` (a CPU generator,
        seeded 0 when None)."""
        B = len(prompts)
        max_prompt = max(len(p) for p in prompts)
        if max_prompt + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {max_prompt} + {max_new_tokens} new tokens exceed "
                             f"max_len {self.max_len}")
        dev = self.model.device
        cache = self.model.init_cache(B, self.max_len)

        pad = np.zeros((B, max_prompt), np.int64)
        for i, p in enumerate(prompts):
            pad[i, : len(p)] = p

        outs: list[list[int]] = [list(p) for p in prompts]
        last_logits = None
        tokens = torch.from_numpy(pad).to(dev)
        # Prefill by stepping the decoder over the padded rectangle.
        for t in range(max_prompt):
            last_logits, cache = self.model.decode_step(self.params, cache, tokens[:, t : t + 1])
            self.stats.prefill_tokens += B
            self.stats.steps += 1

        done = np.zeros(B, bool)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for _ in range(max_new_tokens):
            logits = last_logits[:, 0].to(torch.float32).cpu()
            if self.cfg.temperature > 0:
                probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].numpy()
            else:
                nxt = logits.numpy().argmax(axis=-1)
            for i in range(B):
                if not done[i]:
                    outs[i].append(int(nxt[i]))
                    if eos_id is not None and nxt[i] == eos_id:
                        done[i] = True
            if done.all():
                break
            step_tokens = torch.from_numpy(nxt.astype(np.int64)[:, None]).to(dev)
            last_logits, cache = self.model.decode_step(self.params, cache, step_tokens)
            self.stats.decode_tokens += int((~done).sum())
            self.stats.steps += 1
            if self.on_step is not None:
                self.on_step(self.stats)
        return outs
