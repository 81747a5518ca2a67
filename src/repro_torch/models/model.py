"""Model factory (counterpart of ``repro.models.model``) for every family
of the JAX package: ``family="dense"``, ``"moe"`` (each layer's MLP
swapped for ``moe_sorted``) and ``"vlm"`` (stub patch embeddings
projected and prepended) build ``Model``; ``"rwkv6"`` builds
``RWKV6Model``, ``"hybrid"`` ``Zamba2Model`` (Mamba2 layers and a
weight-shared attention block) and ``"encdec"`` ``WhisperModel``.

``build_model(cfg)`` returns a model with

  * ``init(seed) -> params``                 nested dict; ``layers`` is a list
  * ``forward(params, batch) -> (logits, aux)``   prefill
  * ``init_cache(batch, cache_len) -> cache``    decode state (a
    ``KVCache``, float or int8 by ``cfg.kv_cache_dtype``, an
    ``RWKVState`` stacked over layers, a ``ZambaCache`` or a
    ``WhisperCache``)
  * ``decode_step(params, cache, tokens) -> (logits, cache)``
  * ``input_specs(shape) -> batch``   meta tensors (the dry-run)

``device=None`` builds on CUDA and raises when there is none;
``device="cpu"`` builds on the CPU.  With ``cfg.remat`` (the default) a
forward over params that require grad (training) checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) where the reference wraps its
layer in ``jax.checkpoint``: the layer's activations are recomputed in the
backward instead of kept; serving, whose params carry no grad, runs the
layers as they are.  The frontends of the encdec and vlm
families are stubs, as in the reference: ``batch["frontend"]`` holds
precomputed frame or patch embeddings.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.vm.machine import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rw
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (
    act_fn,
    dtype_of,
    fanin_init,
    normal_init,
    sinusoidal_at,
    sinusoidal_positions,
)
from repro_torch.models.quantized import qlinear
from repro_torch.sharding import local
from repro_torch.sharding.api import logical
from repro_torch.utils.tree import tree_leaves


def _act(x):
    """The residual stream between layers: batch on the DP axes, its
    sequence on "model" under sequence parallelism (``act_seq``)."""
    return logical(x, "batch", "act_seq", "embed")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(B: int, S: int, with_labels: bool) -> dict:
    out = {"tokens": _meta((B, S), torch.int32)}
    if with_labels:
        out["labels"] = _meta((B, S), torch.int32)
    return out


def _remat(cfg: ModelConfig, fn, layers):
    """``fn``, checkpointed per call when ``cfg.remat`` and the ``layers``'
    params require grad (the layer's forward is recomputed in the
    backward; it draws no random numbers, so the RNG state is not kept)."""
    if cfg.remat and torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(layers)):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn


class Model:
    """A decoder LM of the dense, moe or vlm family: pre-norm layers, untied
    or tied unembedding; the vlm family prepends the projected
    ``batch["frontend"]`` patch embeddings in prefill."""

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
        return p | self._init_body(gen)

    def _init_body(self, gen) -> dict:
        """Everything after the embedding, in the reference's order."""
        cfg, dt = self.cfg, self.dtype
        p = {"layers": [self._init_layer(gen) for _ in range(cfg.num_layers)]}
        p |= tf.init_norm(cfg, "final", cfg.d_model, dt, self.device)
        if cfg.family == "vlm":
            p["vision_proj"] = {"w1": fanin_init(gen, (cfg.vision_dim, cfg.d_model), dt),
                                "w2": fanin_init(gen, (cfg.d_model, cfg.d_model), dt)}
        return p

    def _init_layer(self, gen) -> dict:
        return tf.init_decoder_layer(gen, self.cfg, self.dtype, moe=self.cfg.family == "moe")

    def _embed(self, params, tokens):
        table = params["embed"]["tokens"]
        if isinstance(table, DTensor):      # each rank looks up its vocab shard
            return logical(local.embed(table, tokens), "batch", "seq", "embed")
        return logical(table[tokens], "batch", "seq", "embed")

    def _unembed(self, params, x):
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"]["tokens"].T
        else:
            logits = qlinear(x, params["lm_head"])
        return logical(logits, "batch", "seq", "vocab")

    # -- prefill -----------------------------------------------------------------------

    def forward(self, params, batch, *, attention=None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S).  Returns
        (logits (B, S, V), aux), aux the sum of the layers' MoE load-balance
        losses (0 for dense).  ``attention`` is passed to every layer
        (see ``transformer.self_attention_full``).  For the vlm family a
        ``batch["frontend"]`` (B, T, vision_dim) goes through
        ``vision_proj`` in front of the tokens, and its T positions are
        dropped before the unembedding."""
        x = self._embed(params, batch["tokens"])
        front = batch.get("frontend") if self.cfg.family == "vlm" else None
        if front is not None:
            x = torch.cat([self._prefix(params, front), x], dim=1)
        x = _act(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layer = _remat(self.cfg, lambda lp, x: tf.decoder_layer_full(lp, self.cfg, _act(x),
                                                                     attention=attention),
                       params["layers"])
        for lp in params["layers"]:
            x, a = layer(lp, x)
            aux = aux + a
        x = tf.norm(self.cfg, x, params, "final")
        if front is not None:
            x = x[:, front.shape[1]:]
        return self._unembed(params, x), aux

    def _prefix(self, params, front):
        """vlm: the stub patch embeddings, projected to d_model."""
        vp = params["vision_proj"]
        return act_fn("gelu")(front.to(self.dtype) @ vp["w1"]) @ vp["w2"]

    # -- input specs (the dry-run) ---------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> dict:
        """The batch of a ``shape`` cell as meta tensors (shape and dtype
        only), equal to the reference's ``ShapeDtypeStruct``s: decode
        takes (B, 1) tokens; the vlm family's prompt leaves
        ``vision_tokens`` of the sequence to its stub patch embeddings."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _meta((B, 1), torch.int32)}
        out = {}
        if self.cfg.family == "vlm":
            S -= self.cfg.vision_tokens
            out["frontend"] = _meta((B, self.cfg.vision_tokens, self.cfg.vision_dim),
                                    torch.bfloat16)
        return out | _token_specs(B, S, shape.kind == "train")

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
        x = tf.residual(x, att)
        h = tf.norm(self.cfg, x, lp, "ln2")
        ch, shift_c = rw.channel_mix(lp["chan"], h, state.shift_c)
        return tf.residual(x, ch), rw.RWKVState(s1, shift_t, shift_c)

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
        x = _act(self._embed(params, tokens))
        state0 = self._zero_state(tokens.shape[0])
        layer = _remat(self.cfg, lambda lp, x: self._layer(lp, _act(x), state0, wkv=wkv)[0],
                       params["layers"])
        for lp in params["layers"]:
            x = layer(lp, x)
        x = tf.norm(self.cfg, x, params, "final")
        return self._unembed(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, batch: int, cache_len: int) -> rw.RWKVState:
        """The recurrent state of every layer, zero; ``cache_len`` is
        unused (the state does not grow)."""
        return self._zero_state(batch, (self.cfg.num_layers,))

    def decode_step(self, params, cache: rw.RWKVState, tokens, *, wkv=None):
        """One token per row, ``tokens`` (B, 1).  The cache is updated in
        place (the kernel writes each layer's new wkv state over the old
        one) and returned.  ``wkv``, as in ``forward``, replaces the
        rwkv6_scan op; its new state is copied into the cache."""
        x = self._embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            state = rw.RWKVState(cache.wkv[i], cache.shift_t[i], cache.shift_c[i])
            if wkv is None:
                x, new = self._layer(lp, x, state, state_out=cache.wkv[i])
            else:
                x, new = self._layer(lp, x, state, wkv=wkv)
                cache.wkv[i].copy_(new.wkv)
            cache.shift_t[i].copy_(new.shift_t)
            cache.shift_c[i].copy_(new.shift_c)
        x = tf.norm(self.cfg, x, params, "final")
        return self._unembed(params, x), cache


class ZambaCache(NamedTuple):
    mamba: list             # one MambaState a layer
    attn: list              # one KVCache an application of the shared block


class Zamba2Model(Model):
    """zamba2 (hybrid): pre-normed Mamba2 layers; after every
    ``attn_every``-th layer the weight-shared attention block runs over
    ``concat[x, x0]`` (x0 the embeddings) and adds its output to x.  As in
    the reference, ``params["layers"]`` is a list in both packages."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.every = cfg.attn_every or 6

    def _init_body(self, gen) -> dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        layers = []
        for _ in range(cfg.num_layers):
            lp = {"mamba": m2.init_mamba_params(gen, cfg, dt)}
            lp |= tf.init_norm(cfg, "ln1", cfg.d_model, dt, dev)
            layers.append(lp)
        shared = {"proj_in": fanin_init(gen, (2 * cfg.d_model, cfg.d_model), dt),
                  "attn": tf.init_attn_params(gen, cfg, dt),
                  "mlp": tf.init_mlp_params(gen, cfg, dt)}
        shared |= tf.init_norm(cfg, "lna", cfg.d_model, dt, dev)
        shared |= tf.init_norm(cfg, "lnm", cfg.d_model, dt, dev)
        return {"layers": layers, "shared": shared,
                **tf.init_norm(cfg, "final", cfg.d_model, dt, dev)}

    def _zero_state(self, batch: int) -> m2.MambaState:
        cfg = self.cfg
        inner, nheads = m2.dims(cfg)
        return m2.MambaState(
            ssd=torch.zeros((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                            dtype=torch.float32, device=self.device),
            conv=torch.zeros((batch, cfg.ssm_conv_width - 1, inner + 2 * cfg.ssm_state),
                             dtype=self.dtype, device=self.device))

    def _mamba_layer(self, lp, x, state):
        out, state = m2.mamba_block(lp["mamba"], self.cfg, tf.norm(self.cfg, x, lp, "ln1"), state)
        return tf.residual(x, out), state

    def _shared_in(self, sp, x, x0):
        # the residual stream's sequence gathered before the product, as at a norm
        xin = logical(torch.cat([x, x0], dim=-1), "batch", "seq", "embed") @ sp["proj_in"]
        return xin, tf.norm(self.cfg, xin, sp, "lna")

    def _shared_out(self, sp, x, xin, a):
        xin = xin + a
        xin = xin + tf.apply_mlp(sp["mlp"], self.cfg, tf.norm(self.cfg, xin, sp, "lnm"))
        return tf.residual(x, xin)

    def forward(self, params, batch, *, attention=None):
        """Prefill from zero states; the shared block's attention (flash
        unless ``attention`` replaces it) takes ``cfg.sliding_window``."""
        cfg, sp = self.cfg, params["shared"]
        x = x0 = _act(self._embed(params, batch["tokens"]))
        zero = self._zero_state(x.shape[0])
        mamba = _remat(cfg, lambda lp, x: self._mamba_layer(lp, _act(x), zero)[0],
                       params["layers"])
        for i, lp in enumerate(params["layers"]):
            x = mamba(lp, x)
            if (i + 1) % self.every == 0:
                xin, h = self._shared_in(sp, x, x0)
                a = tf.self_attention_full(sp["attn"], cfg, h, window=cfg.sliding_window,
                                           attention=attention)
                x = self._shared_out(sp, x, xin, a)
        x = tf.norm(cfg, x, params, "final")
        return self._unembed(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def init_cache(self, batch: int, cache_len: int) -> ZambaCache:
        cfg = self.cfg
        attn_len = min(cache_len, cfg.sliding_window or cache_len)
        cdt = torch.int8 if cfg.kv_cache_dtype == "int8" else self.dtype
        return ZambaCache(
            mamba=[self._zero_state(batch) for _ in range(cfg.num_layers)],
            attn=[KVCache.init(batch, attn_len, cfg.num_kv_heads, cfg.head_dim, cdt, self.device)
                  for _ in range(cfg.num_layers // self.every)])

    def decode_step(self, params, cache: ZambaCache, tokens):
        """One token per row; the shared block's window is
        ``cfg.sliding_window`` or its cache's length, as in the reference.
        Returns new Mamba states; the KV caches are written in place."""
        cfg, sp = self.cfg, params["shared"]
        x = x0 = self._embed(params, tokens)
        mamba, attn = [], list(cache.attn)
        app = 0
        for i, lp in enumerate(params["layers"]):
            x, state = self._mamba_layer(lp, x, cache.mamba[i])
            mamba.append(state)
            if (i + 1) % self.every == 0:
                c = attn[app]
                xin, h = self._shared_in(sp, x, x0)
                a, attn[app] = tf.self_attention_decode(sp["attn"], cfg, h, c,
                                                        window=cfg.sliding_window or c.k.shape[1])
                x = self._shared_out(sp, x, xin, a)
                app += 1
        x = tf.norm(cfg, x, params, "final")
        return self._unembed(params, x), ZambaCache(mamba=mamba, attn=attn)


class WhisperCache(NamedTuple):
    self_kv: KVCache        # over the decoder layers
    cross_k: torch.Tensor   # (L_dec, B, T_enc, KV, hd)
    cross_v: torch.Tensor


class WhisperModel(Model):
    """whisper (encdec): an encoder over the stub frame embeddings
    (``batch["frontend"]`` (B, T_enc, d_model)) with sinusoidal positions
    and non-causal self attention, and a decoder of causal self attention,
    cross attention over the encoder's output and the MLP; no RoPE.

    As in the reference, decoding never runs the encoder: ``init_cache``'s
    cross K/V are zeros and nothing writes them, so decode attends to
    zeros."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.n_enc = cfg.num_encoder_layers or cfg.num_layers
        self.t_enc = cfg.encoder_ctx or 1500

    def _init_body(self, gen) -> dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device

        def layer(*attn, norms):
            p = {name: tf.init_attn_params(gen, cfg, dt) for name in attn}
            p["mlp"] = tf.init_mlp_params(gen, cfg, dt)
            for n in norms:
                p |= tf.init_norm(cfg, n, cfg.d_model, dt, dev)
            return p

        p = {"enc_layers": [layer("attn", norms=("ln1", "ln2")) for _ in range(self.n_enc)],
             "layers": [layer("attn", "xattn", norms=("ln1", "lnx", "ln2"))
                        for _ in range(cfg.num_layers)]}
        p |= tf.init_norm(cfg, "enc_final", cfg.d_model, dt, dev)
        return p | tf.init_norm(cfg, "final", cfg.d_model, dt, dev)

    def encode(self, params, frontend, *, attention=None):
        """frontend: (B, T_enc, d_model) stub frame embeddings."""
        cfg = self.cfg
        x = frontend.to(self.dtype) + sinusoidal_positions(
            frontend.shape[1], cfg.d_model, self.dtype, self.device)

        def body(lp, x):
            x = _act(x)
            h = tf.norm(cfg, x, lp, "ln1")
            x = tf.residual(x, tf.self_attention_full(lp["attn"], cfg, h, causal=False,
                                                      use_rope=False, attention=attention))
            return tf.residual(x, tf.apply_mlp(lp["mlp"], cfg, tf.norm(cfg, x, lp, "ln2")))

        body = _remat(cfg, body, params["enc_layers"])
        for lp in params["enc_layers"]:
            x = body(lp, x)
        return tf.norm(cfg, x, params, "enc_final")

    def _dec_tail(self, lp, x, ek, ev):
        """The decoder layer after its self attention: cross attention over
        the encoder's K/V, then the MLP."""
        cfg = self.cfg
        x = tf.residual(x, tf.cross_attention(lp["xattn"], cfg, tf.norm(cfg, x, lp, "lnx"), ek, ev))
        return tf.residual(x, tf.apply_mlp(lp["mlp"], cfg, tf.norm(cfg, x, lp, "ln2")))

    def forward(self, params, batch, *, attention=None):
        """``batch["frontend"]`` (B, T_enc, d_model) and ``batch["tokens"]``
        (B, S).  The encoder's and the decoder's self attention take flash
        unless ``attention`` replaces it; cross attention stays plain.  As
        in the reference, the cross K/V carry no ``bk``/``bv``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        enc = self.encode(params, batch["frontend"], attention=attention)
        x = self._embed(params, tokens) + sinusoidal_positions(S, cfg.d_model, self.dtype,
                                                               self.device)
        kv = (B, -1, cfg.num_kv_heads, cfg.head_dim)

        def body(lp, x, enc):
            x = _act(x)
            h = tf.norm(cfg, x, lp, "ln1")
            x = tf.residual(x, tf.self_attention_full(lp["attn"], cfg, h, causal=True,
                                                      use_rope=False, attention=attention))
            ek = qlinear(enc, lp["xattn"]["wk"]).reshape(kv)
            ev = qlinear(enc, lp["xattn"]["wv"]).reshape(kv)
            return self._dec_tail(lp, x, ek, ev)

        body = _remat(cfg, body, params["layers"])
        for lp in params["layers"]:
            x = body(lp, x, enc)
        x = tf.norm(cfg, x, params, "final")
        return self._unembed(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Decode: (B, 1) tokens; otherwise the (B, T_enc, d_model) stub
        frame embeddings and (B, S) tokens (and labels to train)."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _meta((B, 1), torch.int32)}
        return {"frontend": _meta((B, self.t_enc, self.cfg.d_model), torch.bfloat16),
                **_token_specs(B, S, shape.kind == "train")}

    def init_cache(self, batch: int, cache_len: int) -> WhisperCache:
        cfg = self.cfg
        cdt = torch.int8 if cfg.kv_cache_dtype == "int8" else self.dtype
        self_kv = KVCache.init(batch, cache_len, cfg.num_kv_heads, cfg.head_dim, cdt,
                               self.device, layers=cfg.num_layers)
        cross = torch.zeros((cfg.num_layers, batch, self.t_enc, cfg.num_kv_heads, cfg.head_dim),
                            dtype=self.dtype, device=self.device)
        return WhisperCache(self_kv=self_kv, cross_k=cross, cross_v=cross)

    def decode_step(self, params, cache: WhisperCache, tokens):
        """One token per row at absolute position ``cache.self_kv.pos``;
        the self cache is written in place."""
        cfg = self.cfg
        pos = cache.self_kv.pos
        x = self._embed(params, tokens) + sinusoidal_at(pos, cfg.d_model, self.dtype, self.device)
        for i, lp in enumerate(params["layers"]):
            h = tf.norm(cfg, x, lp, "ln1")
            a, _ = tf.self_attention_decode(lp["attn"], cfg, h, cache.self_kv.layer(i),
                                            use_rope=False, window=None)
            x = self._dec_tail(lp, tf.residual(x, a), cache.cross_k[i], cache.cross_v[i])
        x = tf.norm(cfg, x, params, "final")
        return self._unembed(params, x), cache._replace(
            self_kv=cache.self_kv._replace(pos=pos + 1))


_FAMILIES = {"dense": Model, "moe": Model, "vlm": Model, "rwkv6": RWKV6Model,
             "hybrid": Zamba2Model, "encdec": WhisperModel}


def build_model(cfg: ModelConfig, device=None) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port builds {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family](cfg, device)
