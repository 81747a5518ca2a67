"""Model factory for the decoder LM (counterpart of ``repro.models.model``,
``family="dense"``).

``build_model(cfg)`` returns a ``Model`` with

  * ``init(seed) -> params``                 nested dict; ``layers`` is a list
  * ``forward(params, batch) -> (logits, aux)``   prefill
  * ``init_cache(batch, cache_len) -> KVCache``   decode state
  * ``decode_step(params, cache, tokens) -> (logits, cache)``

``device=None`` builds on CUDA and raises when there is none;
``device="cpu"`` builds on the CPU.  The other families of the JAX package
(moe, rwkv6, hybrid, encdec, vlm) raise: later slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.vm.machine import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.common import dtype_of, normal_init
from repro_torch.models.quantized import qlinear


class Model:
    """A dense decoder LM: pre-norm layers, untied or tied unembedding."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)

    # -- parameters ------------------------------------------------------------------

    def init(self, seed: int | torch.Generator = 0) -> dict:
        """Parameters drawn on the model's device from ``seed`` (an int or a
        ``torch.Generator`` on that device), in the reference's order."""
        cfg, dt = self.cfg, self.dtype
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        v = cfg.padded_vocab
        p = {"embed": {"tokens": normal_init(gen, (v, cfg.d_model), dt)}}
        if not cfg.tie_embeddings:
            p["lm_head"] = normal_init(gen, (cfg.d_model, v), dt)
        p["layers"] = [tf.init_decoder_layer(gen, cfg, dt) for _ in range(cfg.num_layers)]
        p |= tf.init_norm(cfg, "final", cfg.d_model, dt, self.device)
        return p

    def _embed(self, params, tokens):
        return params["embed"]["tokens"][tokens]

    def _unembed(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["tokens"].T
        return qlinear(x, params["lm_head"])

    # -- prefill -----------------------------------------------------------------------

    def forward(self, params, batch, *, attention=None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S).  Returns
        (logits (B, S, V), aux).  ``attention`` is passed to every layer
        (see ``transformer.self_attention_full``)."""
        x = self._embed(params, batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            x, a = tf.decoder_layer_full(lp, self.cfg, x, attention=attention)
            aux = aux + a
        x = tf.norm(self.cfg, x, params, "final")
        return self._unembed(params, x), aux

    # -- decode ------------------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int) -> KVCache:
        cfg = self.cfg
        length = cache_len if cfg.sliding_window is None else min(cache_len, cfg.sliding_window)
        cdt = torch.int8 if cfg.kv_cache_dtype == "int8" else self.dtype
        return KVCache.init(batch, length, cfg.num_kv_heads, cfg.head_dim, cdt, self.device,
                            layers=cfg.num_layers)

    def decode_step(self, params, cache: KVCache, tokens):
        """One token per row, ``tokens`` (B, 1), against ``cache``; the cache
        tensors are written in place and the returned cache is one further."""
        x = self._embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            x, _ = tf.decoder_layer_decode(lp, self.cfg, x, cache.layer(i))
        x = tf.norm(self.cfg, x, params, "final")
        return self._unembed(params, x), KVCache(cache.k, cache.v, cache.pos + 1)


def build_model(cfg: ModelConfig, device=None) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not in the PyTorch port yet; it builds "
            "family='dense' (ROADMAP.md queue 1)")
    return Model(cfg, device)
