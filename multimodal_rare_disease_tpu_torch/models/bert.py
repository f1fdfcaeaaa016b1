"""BERT-base clinical text encoder: the counterpart of
`multimodal_rare_disease_tpu/models/bert.py`.

Word + position + segment embeddings → transformer layers (fused QKV,
additive −1e9 mask bias added to the scores in the compute dtype,
softmax in f32), post-LN by default or pre-LN with
`text_encoder.pre_layernorm` (the same two LayerNorms before their
sublayers, and a `final_ln` after the last layer) → CLS token or tanh
pooler. Classic rows take a
[B, T] attention mask; sequence-packed rows (inference/packing.py) take
`segment_ids` (block-diagonal bias), per-document `position_ids` and
`query_positions`. At inference the last layer computes only the
consumed positions (CLS, or one per packed document), unless the caller
asks for the per-layer hidden states or attention probabilities
(explainability), which need every position.

In train mode (`module.train()`) dropout acts at the JAX sites (the
attention probabilities, the attention output, the FFN output, the
embeddings and the encoder's output embedding), every position of the
last layer is computed, and no kernel runs: the JAX layer gates its
Pallas kernels on `not train` (`bert.py:330`, `:365` there), and the
CUDA kernels have no backward. In eval mode the sublayers dispatch to
the hand-written kernels exactly where the JAX layer dispatches to its
Pallas kernels (`bert.py:323-427` there):

- `fused_attn_out` on, in every layer that is not the CLS-only last
  one, unless the attention maps are returned: the attention output
  projection + residual + attention_ln run in K3 (`kernels/attn_out.py`),
  and the FFN sublayer, whose input is then already normalized, in K2
  (`kernels/ffn.py` without the input LN);
- otherwise, with `fused_ffn` on (the default): the unnormalized
  residual goes to K1 (`kernels/ffn.py` with attention_ln folded in).

Under pre-LN no kernel runs: the JAX layer gates K1 and K3 on
`not self.pre_ln` (`bert.py:330`, `:365` there), since neither kernel
computes the pre-LN sublayer. Attention has no kernel (the JAX package
deleted its Pallas one), so it is plain PyTorch in the JAX formulation.

Over a rank mesh's model axis (`parallel/tp.py::shard_model`) a layer
holds its Megatron shards: its share of the heads (q, k and v of each)
and of the attention output's input columns, and its share of the FFN's
inner dimension. In the classic sublayers each rank computes its heads
and its share of F, and a sum over the model axis joins the two
row-parallel products before their bias and the residual, the two sums
per layer that XLA inserts for the JAX layer. The kernels take whole
weights, as the Pallas calls do (XLA hands a custom call its operands
unsharded): K1 and K2 get W1 and W2 gathered over the model axis, K3 the
context and Wo, one layer's at a time, and each rank runs the kernel on
its own rows.

`quantized_inference` runs the four big products of each layer (qkv,
the attention output, the FFN's intermediate and output) in int8 in eval
mode (`models/quant.py`, the JAX `MaybeQuantDenseGeneral`), and, as the
JAX gates `not q8` do, turns K1, K2 and K3 off: the FFN is the classic
sublayer, and the CLS-only last layer takes its query rows from the
full-row qkv (the JAX quantized fallback). Train mode runs the float
path whatever the flag says. `flat_residual` keeps the residual stream
[B·T, H] between the layers of an unpacked forward that returns no
hidden states or attention maps (the JAX flat branches: attention
reshapes around its core, the CLS-only last layer takes rows [::T]); it
changes no value, and K1, or K3 then K2, run on the same rows.

Module and parameter names follow the flax tree (`layer{i}`, `qkv`,
`attention_ln`, ...), so `models/convert.py` maps checkpoints leaf by
leaf, whichever kernels a layer takes, with the int8 flag on or off.
Two inference-only knobs of the JAX module that compute the same values
and are not config fields (K/V lane padding, `ln_barrier`) are not
ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.kernels.attn_out import (
    fused_attn_out_ln,
)
from multimodal_rare_disease_tpu_torch.kernels.ffn import fused_ffn_ln
from multimodal_rare_disease_tpu_torch.models.layers import (
    Dropout,
    Embedding,
    Linear,
)
from multimodal_rare_disease_tpu_torch.models.quant import QuantLinear
from multimodal_rare_disease_tpu_torch.parallel.collectives import (
    all_gather,
    copy_to_model,
    reduce_from_model,
)

_BERT_LN_EPS = 1e-12


def _take_rows(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...], positions [B, P] → [B, P, ...]: x[b, positions[b, p]]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, positions]


class BertSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, device,
                 dropout: float = 0.0, quantized: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.quantized = quantized
        self.dropout = Dropout(dropout)  # on the probabilities
        self.head_dim = hidden_size // num_heads
        # fused QKV; output features ordered (3, heads, head_dim) like the
        # flax [H, 3, h, d] kernel
        self.qkv = QuantLinear(hidden_size, 3 * hidden_size, device,
                               quantized=quantized)
        self.output = QuantLinear(hidden_size, hidden_size, device,
                                  quantized=quantized)
        # the mesh's model axis when this module holds a share of the
        # heads (parallel/tp.py); num_heads is then the local count
        self.tp = None

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                cls_query_only: bool = False,
                query_positions: Optional[torch.Tensor] = None,
                return_unprojected: bool = False,
                output_attentions: bool = False):
        """hidden [B, T, H], or the flat stream [B·T, H] (B from bias);
        bias [B, 1, 1 or T, T] additive. Returns (out, probs): out in
        hidden's rank; probs, the softmax [B, heads, T, T] in f32 (the
        product with V takes it rounded to the compute dtype, as the JAX
        layer does), with `output_attentions`, else None. With
        `cls_query_only`, queries are computed only for position 0 or
        for `query_positions` [B, P] (K/V stay full-sequence) and the
        output is [B, P, H] ([B, H] from the flat stream). With
        `return_unprojected` it is (ctx [B, P or T, H], Wo [H_in, H_out],
        bo): the output projection left for K3 to apply (the JAX
        `return_unprojected`); over a model axis the context and Wo are
        gathered whole for it. Under `quantized` in eval mode the four
        products run in int8 (models/quant.py), and the CLS-only query
        comes from the full-row qkv (the JAX quantized fallback)."""
        flat = hidden.dim() == 2
        if flat:  # attention is the one sublayer that needs [B, T, ...]
            hidden = hidden.reshape(bias.shape[0], -1, hidden.shape[-1])
        b, t, _ = hidden.shape
        h, d = self.num_heads, self.head_dim
        q8 = self.quantized and not self.training
        hidden = copy_to_model(hidden, self.tp)
        if cls_query_only and not q8:
            w, bb = self.qkv.weight, self.qkv.bias
            hq = h * d  # this rank's q rows, then its k and v rows
            q_rows = (_take_rows(hidden, query_positions)
                      if query_positions is not None else hidden[:, :1])
            q = F.linear(q_rows, w[:hq], bb[:hq]).view(b, -1, h, d)
            kv = F.linear(hidden, w[hq:], bb[hq:]).view(b, t, 2, h, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            qkv = (self.qkv.q8(hidden) if q8 else self.qkv(hidden)
                   ).view(b, t, 3, h, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if cls_query_only:
                q = (_take_rows(q, query_positions)
                     if query_positions is not None else q[:, :1])
        if cls_query_only and bias.shape[2] > 1:
            # packed [B,1,T,T]: keep the restricted queries' rows
            bias = (_take_rows(bias[:, 0], query_positions)[:, None]
                    if query_positions is not None else bias[:, :, :1])
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d)
        scores = scores + bias
        probs32 = torch.softmax(scores.float(), dim=-1)
        probs = probs32.to(q.dtype)
        ctx = torch.einsum("bhts,bshd->bthd", self.dropout(probs), v)
        ctx = ctx.reshape(b, ctx.shape[1], h * d)
        if return_unprojected:
            out = (all_gather(ctx, self.tp, dim=-1),
                   all_gather(self.output.weight, self.tp, dim=1).t(),
                   self.output.bias)
        elif q8:  # row-parallel under a model axis: int32 partials summed
            out = self.output.q8(ctx)
        elif self.tp is None:
            out = self.output(ctx)
        else:  # row-parallel: the heads' partial products summed
            out = reduce_from_model(F.linear(ctx, self.output.weight),
                                    self.tp) + self.output.bias
        if flat and not return_unprojected:
            out = out.reshape(-1, out.shape[-1])
        return out, (probs32 if output_attentions else None)


class BertLayer(nn.Module):
    """Transformer layer: post-LN, or pre-LN with `pre_ln` (attention_ln
    before the attention, output_ln before the FFN, each sublayer added
    to the unnormalized residual). The residual stream is [B, T, H] or,
    flat, [B·T, H]."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, device, fused_ffn: bool = True,
                 fused_attn_out: bool = False, dropout: float = 0.0,
                 pre_ln: bool = False, quantized: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.fused_ffn = fused_ffn
        self.fused_attn_out = fused_attn_out
        self.pre_ln = pre_ln
        self.quantized = quantized
        self.dropout = Dropout(dropout)  # attention output, FFN output
        self.attention = BertSelfAttention(hidden_size, num_heads, device,
                                           dropout=dropout,
                                           quantized=quantized)
        self.attention_ln = nn.LayerNorm(hidden_size, eps=_BERT_LN_EPS,
                                         device=device)
        self.intermediate = QuantLinear(hidden_size, intermediate_size,
                                        device, quantized=quantized)
        self.output = QuantLinear(intermediate_size, hidden_size, device,
                                  quantized=quantized)
        self.output_ln = nn.LayerNorm(hidden_size, eps=_BERT_LN_EPS,
                                      device=device)
        # the mesh's model axis when this layer holds a share of the FFN's
        # inner dimension (parallel/tp.py)
        self.tp = None

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                cls_only: bool = False,
                query_positions: Optional[torch.Tensor] = None,
                output_attentions: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """→ (hidden, the attention probabilities with
        `output_attentions`, else None)."""
        # K3 runs on the full rows; the CLS-only last layer and a forward
        # that returns the attention maps keep the classic projection (the
        # JAX layer's `not cls_only` and `not output_attentions` gates);
        # no kernel runs in train mode, under pre-LN or quantized (its
        # `not train`, `not self.pre_ln` and `not q8` gates)
        q8 = self.quantized and not self.training
        use_k3 = (self.fused_attn_out and not self.training
                  and not self.pre_ln and not q8 and not cls_only
                  and not output_attentions)
        attn_in = self.attention_ln(hidden) if self.pre_ln else hidden
        attn_out, probs = self.attention(
            attn_in, bias, cls_query_only=cls_only,
            query_positions=query_positions, return_unprojected=use_k3,
            output_attentions=output_attentions)
        if cls_only:
            # the rest of the layer runs on the consumed positions only;
            # the flat stream [B·T, H] becomes [B, H] (rows [::T])
            if hidden.dim() == 2:
                hidden = hidden[::hidden.shape[0] // bias.shape[0]]
            else:
                hidden = (_take_rows(hidden, query_positions)
                          if query_positions is not None
                          else hidden[:, :1])
        if use_k3:
            # K3: attention_ln(x + ctx @ Wo + bo) in one pass
            ctx, wo, bo = attn_out
            hid = self.hidden_size
            hidden = fused_attn_out_ln(
                ctx.reshape(-1, hid), hidden.reshape(-1, hid), wo, bo,
                self.attention_ln.weight, self.attention_ln.bias,
                eps=_BERT_LN_EPS).reshape(hidden.shape)
            if self.fused_ffn:  # eval mode here: K3 is on
                return self._ffn_fused(hidden, input_ln=False), probs  # K2
            return self._ffn_classic(hidden), probs
        if self.pre_ln:
            hidden = hidden + self.dropout(attn_out)
            return hidden + self._ffn_out(self.output_ln(hidden)), probs
        if self.fused_ffn and not self.training and not q8:
            # K1 takes the unnormalized residual and applies attention_ln
            # itself (the JAX layer's pre_gamma dispatch)
            return self._ffn_fused(hidden + attn_out, input_ln=True), probs
        hidden = self.attention_ln(hidden + self.dropout(attn_out))
        return self._ffn_classic(hidden), probs

    def _ffn_fused(self, x: torch.Tensor, input_ln: bool) -> torch.Tensor:
        """The FFN sublayer in K1 (x unnormalized, attention_ln folded
        in) or K2 (x already normalized)."""
        ln0 = (dict(pre_gamma=self.attention_ln.weight,
                    pre_beta=self.attention_ln.bias) if input_ln else {})
        # over a model axis: this layer's W1, b1 and W2 gathered whole
        y = fused_ffn_ln(
            x.reshape(-1, self.hidden_size),
            all_gather(self.intermediate.weight, self.tp, dim=0).t(),
            all_gather(self.intermediate.bias, self.tp, dim=0),
            all_gather(self.output.weight, self.tp, dim=1).t(),
            self.output.bias,
            self.output_ln.weight, self.output_ln.bias, eps=_BERT_LN_EPS,
            **ln0)
        return y.reshape(x.shape)

    def _ffn_out(self, x: torch.Tensor) -> torch.Tensor:
        """W2 · GELU(x · W1 + b1) + b2, then dropout: no kernel (both
        products in int8 under `quantized` in eval mode). Over a model
        axis, column-parallel W1 and row-parallel W2, whose partial
        products are summed before b2."""
        x = copy_to_model(x, self.tp)
        if self.quantized and not self.training:
            inter = F.gelu(self.intermediate.q8(x).float()).to(x.dtype)
            return self.output.q8(inter)
        inter = F.gelu(self.intermediate(x).float()).to(x.dtype)
        if self.tp is None:
            return self.dropout(self.output(inter))
        out = reduce_from_model(F.linear(inter, self.output.weight), self.tp)
        return self.dropout(out + self.output.bias)

    def _ffn_classic(self, hidden: torch.Tensor) -> torch.Tensor:
        """The post-LN FFN sublayer without a kernel, on normalized rows."""
        return self.output_ln(hidden + self._ffn_out(hidden))


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 num_heads: int, intermediate_size: int,
                 max_position_embeddings: int, type_vocab_size: int, device,
                 fused_ffn: bool = True, fused_attn_out: bool = False,
                 dropout: float = 0.0, pre_ln: bool = False,
                 quantized: bool = False, flat_residual: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.flat_residual = flat_residual
        self.dropout = Dropout(dropout)  # on the embeddings
        self.word_embeddings = Embedding(vocab_size, hidden_size,
                                         device=device)
        self.position_embeddings = Embedding(max_position_embeddings,
                                             hidden_size, device=device)
        self.token_type_embeddings = Embedding(type_vocab_size, hidden_size,
                                               device=device)
        self.embeddings_ln = nn.LayerNorm(hidden_size, eps=_BERT_LN_EPS,
                                          device=device)
        for i in range(num_layers):
            self.add_module(f"layer{i}", BertLayer(
                hidden_size, num_heads, intermediate_size, device,
                fused_ffn=fused_ffn, fused_attn_out=fused_attn_out,
                dropout=dropout, pre_ln=pre_ln, quantized=quantized))
        # pre-LN stacks normalize once more before the readout
        self.final_ln = (nn.LayerNorm(hidden_size, eps=_BERT_LN_EPS,
                                      device=device) if pre_ln else None)
        self.pooler = Linear(hidden_size, hidden_size, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                cls_only_final: bool = False,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                query_positions: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False,
                output_attentions: bool = False
                ) -> Dict[str, Any]:
        """input_ids [B, T]. Classic rows: attention_mask [B, T] {0,1}.
        Packed rows: segment_ids [B, T] (0 = pad, 1.. = document),
        position_ids [B, T], query_positions [B, P]; `cls` is then
        [B, P, H]. With `cls_only_final` the last layer computes only
        the consumed positions, unless hidden states or attentions are
        asked for: `output_hidden_states` adds `hidden_states`, the
        embedding output and every layer's output, and
        `output_attentions` adds `attentions`, every layer's
        [B, heads, T, T] probabilities. With `flat_residual` the
        residual stream is [B·T, H] between the layers of an unpacked
        forward that returns neither (the same values), and comes back as
        [B, T', H]."""
        cls_only_final = (cls_only_final and not output_hidden_states
                          and not output_attentions)
        b, t = input_ids.shape
        dev = input_ids.device
        packed = segment_ids is not None
        positions = (position_ids if position_ids is not None
                     else torch.arange(t, device=dev)[None, :])
        hidden = (self.word_embeddings(input_ids)
                  + self.position_embeddings(positions))
        if token_type_ids is None:
            # single segment: every position embeds row 0 — broadcast it
            hidden = hidden + self.token_type_embeddings.weight[0]
        else:
            hidden = hidden + self.token_type_embeddings(token_type_ids)
        hidden = self.dropout(self.embeddings_ln(hidden))
        dtype = hidden.dtype

        if packed:
            # block-diagonal: a key is allowed iff same nonzero document
            same = segment_ids[:, :, None] == segment_ids[:, None, :]
            allowed = same & (segment_ids[:, None, :] != 0)
            bias = torch.where(allowed, 0.0, -1e9)[:, None]   # [B,1,T,T]
        else:
            bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        bias = bias.to(dtype)

        qpos = query_positions if packed else None
        flat = (self.flat_residual and not output_hidden_states
                and not output_attentions and not packed)
        if flat:
            hidden = hidden.reshape(b * t, hidden.shape[-1])
        all_hidden = [hidden] if output_hidden_states else None
        all_attn = [] if output_attentions else None
        for i in range(self.num_layers):
            hidden, probs = getattr(self, f"layer{i}")(
                hidden, bias,
                cls_only=cls_only_final and i == self.num_layers - 1,
                query_positions=qpos, output_attentions=output_attentions)
            if output_hidden_states:
                all_hidden.append(hidden)
            if output_attentions:
                all_attn.append(probs)

        if self.final_ln is not None:
            hidden = self.final_ln(hidden)
        if flat:  # T' = 1 after the CLS-only last layer
            hidden = hidden.reshape(b, -1, hidden.shape[-1])
        if packed and query_positions is not None:
            cls = hidden if cls_only_final else _take_rows(hidden,
                                                           query_positions)
        else:
            cls = hidden[:, 0]
        pooled = torch.tanh(self.pooler(cls))
        out = {"last_hidden_state": hidden, "cls": cls,
               "pooler_output": pooled}
        if output_hidden_states:
            out["hidden_states"] = tuple(all_hidden)
        if output_attentions:
            out["attentions"] = tuple(all_attn)
        return out


class TextEncoder(nn.Module):
    """BERT → embedding (CLS token, or tanh pooler with
    use_pooler_output) → dropout, with the optional projection + relu.
    At inference the last BERT layer computes only the consumed
    positions; in train mode every position (the JAX
    `cls_only_final=not train`)."""

    def __init__(self, cfg, device, projection_dim: int = 0):
        super().__init__()
        self.use_pooler_output = cfg.use_pooler_output
        self.bert = BertEncoder(
            cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.intermediate_size, cfg.max_position_embeddings,
            cfg.type_vocab_size, device, fused_ffn=cfg.fused_ffn,
            fused_attn_out=cfg.fused_attn_out, dropout=cfg.dropout,
            pre_ln=cfg.pre_layernorm, quantized=cfg.quantized_inference,
            flat_residual=cfg.flat_residual)
        self.drop = Dropout(cfg.dropout)
        self.projection = (Linear(cfg.hidden_size, projection_dim,
                                  device=device)
                           if projection_dim else None)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                query_positions: Optional[torch.Tensor] = None,
                output_hidden_states: bool = False,
                output_attentions: bool = False):
        """→ the embedding [B, D] (or [B, P, D] for packed rows); with
        either output flag, (embedding, the BERT output dict)."""
        out = self.bert(input_ids, attention_mask,
                        token_type_ids=token_type_ids,
                        cls_only_final=not self.training,
                        position_ids=position_ids, segment_ids=segment_ids,
                        query_positions=query_positions,
                        output_hidden_states=output_hidden_states,
                        output_attentions=output_attentions)
        emb = out["pooler_output"] if self.use_pooler_output else out["cls"]
        emb = self.drop(emb)
        if self.projection is not None:
            emb = torch.relu(self.projection(emb))
        if output_hidden_states or output_attentions:
            return emb, out
        return emb


def create_text_encoder(cfg, device, projection_dim: int = 0) -> TextEncoder:
    """cfg: a TextEncoderConfig (`config.py`)."""
    return TextEncoder(cfg, device, projection_dim=projection_dim)
