"""Model factory (counterpart of ``repro.models.model``) for the families
the port builds: ``family="dense"`` and ``family="moe"`` (``Model``; moe
swaps each layer's MLP for ``moe_sorted``) and ``family="rwkv6"``
(``RWKV6Model``).

``build_model(cfg)`` returns a model with

  * ``init(seed) -> params``                 nested dict; ``layers`` is a list
  * ``forward(params, batch) -> (logits, aux)``   prefill
  * ``init_cache(batch, cache_len) -> cache``    decode state (a
    ``KVCache``, float or int8 by ``cfg.kv_cache_dtype``, or an
    ``RWKVState`` stacked over layers)
  * ``decode_step(params, cache, tokens) -> (logits, cache)``

``device=None`` builds on CUDA and raises when there is none;
``device="cpu"`` builds on the CPU.  The other families of the JAX package
(hybrid, encdec, vlm) raise: later slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.vm.machine import resolve_device
from repro_torch.models import rwkv6 as rw
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.common import dtype_of, normal_init
from repro_torch.models.quantized import qlinear


class Model:
    """A decoder LM of the dense or moe family: pre-norm layers, untied or
    tied unembedding."""

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
        p["layers"] = [self._init_layer(gen) for _ in range(cfg.num_layers)]
        p |= tf.init_norm(cfg, "final", cfg.d_model, dt, self.device)
        return p

    def _init_layer(self, gen) -> dict:
        return tf.init_decoder_layer(gen, self.cfg, self.dtype, moe=self.cfg.family == "moe")

    def _embed(self, params, tokens):
        return params["embed"]["tokens"][tokens]

    def _unembed(self, params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["tokens"].T
        return qlinear(x, params["lm_head"])

    # -- prefill -----------------------------------------------------------------------

    def forward(self, params, batch, *, attention=None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S).  Returns
        (logits (B, S, V), aux), aux the sum of the layers' MoE load-balance
        losses (0 for dense).  ``attention`` is passed to every layer
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
        return self._unembed(params, x), cache._replace(pos=cache.pos + 1)


class RWKV6Model(Model):
    """RWKV6: pre-norm time mix (the rwkv6_scan kernel) and channel mix per
    layer, an O(1) recurrent state instead of a KV cache."""

    def _init_layer(self, gen) -> dict:
        cfg, dt = self.cfg, self.dtype
        p = {"time": rw.init_time_mix(gen, cfg.d_model, dt),
             "chan": rw.init_channel_mix(gen, cfg.d_model, cfg.d_ff, dt)}
        p |= tf.init_norm(cfg, "ln1", cfg.d_model, dt, self.device)
        p |= tf.init_norm(cfg, "ln2", cfg.d_model, dt, self.device)
        return p

    def _layer(self, lp, x, state: rw.RWKVState, *, wkv=None, state_out=None):
        K = self.cfg.ssm_head_dim
        h = tf.norm(self.cfg, x, lp, "ln1")
        att, shift_t, s1 = rw.time_mix(lp["time"], h, state.shift_t, state.wkv, K, wkv=wkv,
                                       state_out=state_out)
        x = x + att
        h = tf.norm(self.cfg, x, lp, "ln2")
        ch, shift_c = rw.channel_mix(lp["chan"], h, state.shift_c)
        return x + ch, rw.RWKVState(s1, shift_t, shift_c)

    def _zero_state(self, batch: int, layers: tuple = ()) -> rw.RWKVState:
        cfg = self.cfg
        K = cfg.ssm_head_dim
        H = cfg.d_model // K
        zeros = lambda *shape, dt: torch.zeros((*layers, batch, *shape), dtype=dt,
                                               device=self.device)
        return rw.RWKVState(zeros(H, K, K, dt=torch.float32), zeros(cfg.d_model, dt=self.dtype),
                            zeros(cfg.d_model, dt=self.dtype))

    def forward(self, params, batch, *, wkv=None):
        """Full-sequence forward from a zero state.  ``wkv`` (the signature
        of ``rwkv6.chunked_wkv``) replaces the rwkv6_scan op in every
        layer; a check passes the plain version to hold the kernel's path
        against it."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        state0 = self._zero_state(tokens.shape[0])
        for lp in params["layers"]:
            x, _ = self._layer(lp, x, state0, wkv=wkv)
        x = tf.norm(self.cfg, x, params, "final")
        return self._unembed(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, batch: int, cache_len: int) -> rw.RWKVState:
        """The recurrent state of every layer, zero; ``cache_len`` is
        unused (the state does not grow)."""
        return self._zero_state(batch, (self.cfg.num_layers,))

    def decode_step(self, params, cache: rw.RWKVState, tokens):
        """One token per row, ``tokens`` (B, 1).  The cache is updated in
        place (the kernel writes each layer's new wkv state over the old
        one) and returned."""
        x = self._embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            state = rw.RWKVState(cache.wkv[i], cache.shift_t[i], cache.shift_c[i])
            x, new = self._layer(lp, x, state, state_out=cache.wkv[i])
            cache.shift_t[i].copy_(new.shift_t)
            cache.shift_c[i].copy_(new.shift_c)
        x = tf.norm(self.cfg, x, params, "final")
        return self._unembed(params, x), cache


_FAMILIES = {"dense": Model, "moe": Model, "rwkv6": RWKV6Model}


def build_model(cfg: ModelConfig, device=None) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not in the PyTorch port yet; it builds "
            f"{sorted(_FAMILIES)} (ROADMAP.md queue 1)")
    return _FAMILIES[cfg.family](cfg, device)
