"""Transformer layers (port of ``paddle_tpu/nn/transformer.py:25-320``):
``MultiHeadAttention`` with its ``Cache``, ``TransformerEncoderLayer`` /
``TransformerEncoder``, ``TransformerDecoderLayer`` /
``TransformerDecoder`` (post-LN, or pre-LN with ``normalize_before``)
and ``Transformer``.

Attention goes through ``ops.nn_functional.scaled_dot_product_attention``,
so the JAX package's crossovers and gates decide when a kernel runs: any
mask, or dropout while training, takes the plain math; an unmasked key
length of 256 or more with as many queries as keys takes the folded
kernel on the card (BERT at S=512), 512 or more the streaming one.

As in the JAX package, the layers' norms are ``LayerNorm(d_model)`` at
epsilon 1e-5 whatever the model around them says, the activation is
looked up by name among the functional ops (``"gelu"`` is the exact
form), and every layer after the first of an encoder or decoder is a
fresh instance of the first one's configuration with its own draws
(``_clone_layer``). Parameter names are the JAX ``state_dict`` keys
(``layers.0.self_attn.q_proj.weight``, ...), so a JAX model's weights
load with ``nn.layer.load_jax_state``.

Constructors take ``device`` (``None`` means CUDA and raises without a
GPU), ``dtype`` and ``generator``; ``Transformer`` draws from a
generator on its device seeded with 0 when given none.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as NF
from .common import Dropout, Linear
from .norm import LayerNorm
from .layer import Layer


def _activation(name: str):
    """The functional op named ``name`` (the JAX layers'
    ``F[self.activation]``)."""
    fn = getattr(NF, name, None)
    if fn is None or name.startswith("_"):
        raise ValueError(f"unknown activation {name!r}")
    return fn


class MultiHeadAttention(Layer):
    """Multi-head attention with separate q/k/v projections and an
    optional key/value cache for incremental decoding."""

    class Cache:
        """Keys and values ``[B, S, H, D]`` seen so far."""

        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=dev,
                  dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        # [B, S, E] -> [B, S, H, D]
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache: Optional["MultiHeadAttention.Cache"] = None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = MultiHeadAttention.Cache(k, v)
        out = NF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None:
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """With ``value`` None, an empty cache ``[B, 0, H, D]`` in
        ``key``'s dtype for incremental decoding; else the projected
        ``key`` and ``value`` (a cross-attention memory)."""
        if value is None:
            empty = torch.zeros((key.shape[0], 0, self.num_heads,
                                 self.head_dim), dtype=key.dtype,
                                device=key.device)
            return MultiHeadAttention.Cache(empty, empty)
        return MultiHeadAttention.Cache(self._shape(self.k_proj(key)),
                                        self._shape(self.v_proj(value)))


def _config(args):
    """A layer's constructor arguments (its ``locals()``), which
    ``_clone_layer`` passes to a fresh instance."""
    return {k: v for k, v in args.items() if k not in ("self", "__class__")}


class _Layer(Layer):
    """What the encoder and decoder layers share: their configuration,
    the attention blocks (``attentions``: their names), the feed-forward
    block, and ``norms`` layer norms each with its dropout."""

    def __init__(self, config, attentions, norms):
        super().__init__()
        c = self._config = config
        dev = resolve_device(c["device"])
        dropout = c["dropout"]
        attn_dropout = (dropout if c["attn_dropout"] is None
                        else c["attn_dropout"])
        act_dropout = (dropout if c["act_dropout"] is None
                       else c["act_dropout"])
        self.normalize_before = c["normalize_before"]
        kw = dict(weight_attr=c["weight_attr"], bias_attr=c["bias_attr"],
                  device=dev, dtype=c["dtype"], generator=c["generator"])
        d, ff = c["d_model"], c["dim_feedforward"]
        for name in attentions:
            setattr(self, name, MultiHeadAttention(d, c["nhead"],
                                                   attn_dropout, **kw))
        self.linear1 = Linear(d, ff, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(ff, d, **kw)
        for i in range(1, norms + 1):
            setattr(self, f"norm{i}", LayerNorm(d, device=dev,
                                                dtype=c["dtype"]))
            setattr(self, f"dropout{i}", Dropout(dropout))
        self.activation = c["activation"]
        self._act = _activation(self.activation)

    def _feed_forward(self, x):
        return self.linear2(self.dropout(self._act(self.linear1(x))))


class TransformerEncoderLayer(_Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_config(locals()), ("self_attn",), 2)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            attn_out = self.self_attn(src, src, src, attn_mask=src_mask)
        else:
            attn_out, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(attn_out)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = residual + self.dropout2(self._feed_forward(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerDecoderLayer(_Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_config(locals()), ("self_attn", "cross_attn"), 3)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt2 = self.self_attn(tgt, tgt, tgt, tgt_mask)
            new_cache = None
        else:
            tgt2, new_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt2)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt2 = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt2)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = residual + self.dropout3(self._feed_forward(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_cache,))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_c = mod(output, src_mask, cache[i])
                new_caches.append(new_c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_c = mod(output, memory, tgt_mask, memory_mask,
                                    cache[i])
                new_caches.append(new_c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """Encoder-decoder at Transformer-base by default (d_model 512, 8
    heads, 6 + 6 layers, FFN 2048); a final ``LayerNorm`` on each side
    when ``normalize_before``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = dict(device=dev, dtype=dtype, generator=generator)

        def final_norm():
            return (LayerNorm(d_model, device=dev, dtype=dtype)
                    if normalize_before else None)

        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                final_norm())
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                final_norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` float32: 0 on and below the diagonal,
        -inf above (on ``device``, CUDA by default)."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.zeros(keep.shape, device=keep.device).masked_fill(
            ~keep, float("-inf"))


def _clone_layer(layer: nn.Module) -> nn.Module:
    """Re-instantiate a layer from its configuration, drawing fresh
    parameters from the same generator (the reference re-instantiates
    rather than copying weights); a layer without one is deep-copied."""
    cfg = getattr(layer, "_config", None)
    if cfg is not None:
        return type(layer)(**cfg)
    return copy.deepcopy(layer)
