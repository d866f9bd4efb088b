"""BERT encoder family with masked-LM and classification heads (port of
``paddle_tpu/models/bert.py:24-169``).

Built on ``nn/transformer.py``'s encoder stack, post-LN, with the exact
(erf) GELU of ``hidden_act="gelu"``. Self-attention takes the JAX
package's gates: unmasked at S >= 256 it is the folded attention kernel
on the card (BERT-base at S=512: H=12, D=64, one K block), forward and
backward; a padding mask, or attention dropout in training, takes the
plain math.

``BertForPretraining`` runs the MLM transform and the tied vocabulary
head only on the ``masked_positions`` slots when they are given (the
reference's ``max_predictions_per_seq`` format); the head is a plain
product with the word embeddings and no bias. Parameter names are the
JAX ``state_dict`` keys, so a JAX model's weights load with
``nn.layer.load_jax_state``.

Models are built on ``device`` (``None`` means CUDA and raises without
a GPU) from ``generator`` (``None``: a generator on that device seeded
with 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import amp_cast
from ..device import resolve_device
from ..nn.common import Dropout, Embedding, Linear
from ..nn.norm import LayerNorm
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer
from ..ops import nn_functional as NF
from ..nn.layer import Layer


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=256, max_position_embeddings=128,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, **kw)


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)


def _placement(device, dtype, generator):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dict(device=dev, dtype=dtype, generator=generator)


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        kw = _placement(device, dtype, generator)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    device=kw["device"], dtype=dtype)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int32, device=input_ids.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int32,
                                         device=input_ids.device)
        emb = (self.word_embeddings(input_ids) +
               self.position_embeddings(position_ids) +
               self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertModel(Layer):
    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        c = config
        kw = _placement(device, dtype, generator)
        self.embeddings = BertEmbeddings(c, **kw)
        enc_layer = TransformerEncoderLayer(
            c.hidden_size, c.num_attention_heads, c.intermediate_size,
            dropout=c.hidden_dropout_prob, activation=c.hidden_act,
            attn_dropout=c.attention_probs_dropout_prob, **kw)
        self.encoder = TransformerEncoder(enc_layer, c.num_hidden_layers)
        self.pooler = Linear(c.hidden_size, c.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            # [B, S] padding mask -> additive [B, 1, 1, S]
            m = attention_mask[:, None, None, :].to(torch.float32)
            attention_mask = (1.0 - m) * -1e9
        seq_out = self.encoder(x, src_mask=attention_mask)
        pooled = torch.tanh(self.pooler(seq_out[:, 0]))
        return seq_out, pooled


class BertForPretraining(Layer):
    """MLM + NSP heads (the reference's pretraining benchmark)."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = config
        kw = _placement(device, dtype, generator)
        self.bert = BertModel(c, **kw)
        self.mlm_transform = Linear(c.hidden_size, c.hidden_size, **kw)
        self.mlm_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                  device=kw["device"], dtype=dtype)
        self.nsp_head = Linear(c.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, masked_positions=None,
                labels=None, next_sentence_labels=None,
                attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask=attention_mask)
        if masked_positions is not None:
            # the MLM transform and the vocabulary head run on the K
            # masked slots only; ``labels`` is the gathered [B, K] ids or
            # the full [B, S] labels, gathered here. With K == S the
            # shapes cannot tell them apart: labels are taken as already
            # gathered, never gathered twice
            pos = masked_positions.long()
            seq_out = torch.gather(
                seq_out, 1, pos[..., None].expand(-1, -1, seq_out.shape[-1]))
            k = pos.shape[1]
            if labels is not None and k != input_ids.shape[1] and \
                    tuple(labels.shape) == tuple(input_ids.shape):
                labels = torch.gather(labels, 1, pos)
        h = self.mlm_norm(NF.gelu(self.mlm_transform(seq_out)))
        h, w = amp_cast("matmul", h,
                        self.bert.embeddings.word_embeddings.weight)
        mlm_logits = torch.matmul(h, w.t())
        nsp_logits = self.nsp_head(pooled)
        if labels is None:
            return mlm_logits, nsp_logits
        loss = NF.cross_entropy(mlm_logits, labels, ignore_index=-100)
        if next_sentence_labels is not None:
            loss = loss + NF.cross_entropy(nsp_logits, next_sentence_labels)
        return loss


class BertForSequenceClassification(Layer):
    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _placement(device, dtype, generator)
        self.bert = BertModel(config, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return NF.cross_entropy(logits, labels)
