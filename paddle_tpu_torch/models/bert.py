"""BERT/Transformer encoder (mirrors ``paddle_tpu/models/bert.py``:
``BertConfig`` :16, ``BERT_BASE`` :53, ``BERT_TINY`` :54, ``encoder``
:154) with the same parameter names, so a checkpoint of either package
loads in the other.  ``fuse_attn="auto"`` routes by sequence length
against the port's own :func:`~paddle_tpu_torch.ops.cuda.flash_attention
.flash_min_t` (``PADDLE_TPU_FLASH_MIN_T``, default 512), read when the
program is built: the fused attention op at or above it, the unfused
matmul/softmax chain below.  ``fused_qkv`` (needs the ``slice`` layer)
and ``recompute`` (training) are not ported yet (ROADMAP.md), and the
pretraining head (``build_pretrain``) comes with the training slice."""

import math

from .. import layers
from ..initializer import TruncatedNormal
from ..ops.cuda.flash_attention import flash_min_t
from ..param_attr import ParamAttr


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 ffn=3072, max_seq=512, type_vocab=2, dropout=0.1,
                 attn_dropout=None, fuse_attn="auto", recompute=False,
                 fused_qkv=False, fused_ln=False):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.ffn = ffn
        self.max_seq = max_seq
        self.type_vocab = type_vocab
        self.dropout = dropout
        self.attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.fuse_attn = fuse_attn
        self.fused_qkv = fused_qkv
        self.fused_ln = fused_ln
        self.recompute = recompute


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, hidden=128, layers=2, heads=2,
                       ffn=512, max_seq=128)


def _attention(x, mask_bias, cfg, prefix):
    d = cfg.hidden
    dh = d // cfg.heads

    def proj(inp, size, name):
        return layers.fc(
            inp, size=size, num_flatten_dims=2,
            param_attr=ParamAttr(name=prefix + "." + name + ".w"),
            bias_attr=ParamAttr(name=prefix + "." + name + ".b"))

    def split_heads(t):
        t = layers.reshape(t, [0, 0, cfg.heads, dh])
        return layers.transpose(t, [0, 2, 1, 3])

    if getattr(cfg, "fused_qkv", False):
        raise NotImplementedError(
            "BertConfig(fused_qkv=True) needs the slice layer, which is not "
            "ported yet (ROADMAP.md, Queue A item 1: training)")
    q = split_heads(proj(x, d, "q"))
    k = split_heads(proj(x, d, "k"))
    v = split_heads(proj(x, d, "v"))
    fuse = cfg.fuse_attn
    if fuse == "auto":
        fuse = int(q.shape[2]) >= flash_min_t()
    if fuse:
        ctx = layers.fused_multihead_attention(
            q, k, v, bias=mask_bias, scale=1.0 / math.sqrt(dh),
            dropout_rate=cfg.attn_dropout or 0.0)
    else:
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=1.0 / math.sqrt(dh))
        if mask_bias is not None:
            scores = layers.elementwise_add(scores, mask_bias)
        probs = layers.softmax(scores)
        if cfg.attn_dropout:
            probs = layers.dropout(probs, cfg.attn_dropout,
                                   dropout_implementation="upscale_in_train")
        ctx = layers.matmul(probs, v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, d])
    return proj(ctx, d, "o")


def _sublayer_close(x, sub, cfg, ln_name):
    """``layer_norm(x + dropout(sub))``: the three-op chain, or the fused
    op with ``cfg.fused_ln`` — same math and parameter names."""
    if cfg.fused_ln:
        return layers.fused_dropout_add_ln(
            sub, x, dropout_prob=cfg.dropout or 0.0,
            param_attr=ParamAttr(name=ln_name + ".scale"),
            bias_attr=ParamAttr(name=ln_name + ".bias"))
    if cfg.dropout:
        sub = layers.dropout(sub, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(
        layers.elementwise_add(x, sub), begin_norm_axis=2,
        param_attr=ParamAttr(name=ln_name + ".scale"),
        bias_attr=ParamAttr(name=ln_name + ".bias"))


def _encoder_layer(x, mask_bias, cfg, prefix):
    attn = _attention(x, mask_bias, cfg, prefix + ".attn")
    x = _sublayer_close(x, attn, cfg, prefix + ".ln1")
    ff = layers.fc(x, size=cfg.ffn, num_flatten_dims=2, act="gelu",
                   param_attr=ParamAttr(name=prefix + ".ffn1.w"),
                   bias_attr=ParamAttr(name=prefix + ".ffn1.b"))
    ff = layers.fc(ff, size=cfg.hidden, num_flatten_dims=2,
                   param_attr=ParamAttr(name=prefix + ".ffn2.w"),
                   bias_attr=ParamAttr(name=prefix + ".ffn2.b"))
    return _sublayer_close(x, ff, cfg, prefix + ".ln2")


def encoder(input_ids, token_type_ids, attn_mask_bias, cfg, seq_len):
    """[B,T] ids → [B,T,D] hidden states (declares the ``pos_ids`` feed)."""
    if cfg.recompute:
        raise NotImplementedError(
            "BertConfig(recompute=True) comes with the training slice "
            "(ROADMAP.md)")
    init = TruncatedNormal(scale=0.02)
    word_emb = layers.embedding(
        input_ids, size=[cfg.vocab_size, cfg.hidden],
        param_attr=ParamAttr(name="bert.word_emb", initializer=init))
    pos_ids = layers.data("pos_ids", shape=[seq_len], dtype="int64")
    pos_emb = layers.embedding(
        pos_ids, size=[cfg.max_seq, cfg.hidden],
        param_attr=ParamAttr(name="bert.pos_emb", initializer=init))
    type_emb = layers.embedding(
        token_type_ids, size=[cfg.type_vocab, cfg.hidden],
        param_attr=ParamAttr(name="bert.type_emb", initializer=init))
    x = layers.elementwise_add(layers.elementwise_add(word_emb, pos_emb),
                               type_emb)
    x = layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name="bert.emb_ln.scale"),
        bias_attr=ParamAttr(name="bert.emb_ln.bias"))
    if cfg.dropout:
        x = layers.dropout(x, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    for i in range(cfg.layers):
        x = _encoder_layer(x, attn_mask_bias, cfg, "bert.layer%d" % i)
    return x
