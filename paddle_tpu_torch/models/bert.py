"""BERT/Transformer encoder and its masked-LM pretraining program
(mirrors ``paddle_tpu/models/bert.py``: ``BertConfig`` :16, ``BERT_BASE``
:53, ``BERT_TINY`` :54, ``encoder`` :154, ``default_max_pred`` :192,
``build_pretrain`` :199, ``make_fake_batch`` :303) with the same
parameter names, so a checkpoint of either package loads in the other.
``fuse_attn="auto"`` routes by sequence length against the port's own
:func:`~paddle_tpu_torch.ops.cuda.flash_attention.flash_min_t`
(``PADDLE_TPU_FLASH_MIN_T``, then the card's decision in the autotune
cache, then 512), read when the program is built: the fused attention op
at or above it, the unfused matmul/softmax chain below, which the fusion
pipeline's attention rewrite fuses when the threshold is lower at run
time.  ``build_pretrain(amp=True)`` runs the bf16 rewrite
(:mod:`paddle_tpu_torch.contrib.mixed_precision`): through the decorated
Adam when training, directly on the forward program otherwise.
``fused_qkv`` projects Q, K and V with one ``.qkv.w`` [D, 3D] and three
``slice``s (:73-81); ``recompute`` puts each encoder layer in a
``layers.recompute()`` region (:183-187)."""

import copy
import math

from .. import layers
from .. import optimizer
from ..contrib import mixed_precision
from ..framework import Program, program_guard
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
        # one [*, d] x [d, 3d] product instead of three [d, d] ones
        qkv = proj(x, 3 * d, "qkv")
        q = split_heads(layers.slice(qkv, [2], [0], [d]))
        k = split_heads(layers.slice(qkv, [2], [d], [2 * d]))
        v = split_heads(layers.slice(qkv, [2], [2 * d], [3 * d]))
    else:
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
        if cfg.recompute:
            with layers.recompute():
                x = _encoder_layer(x, attn_mask_bias, cfg,
                                   "bert.layer%d" % i)
        else:
            x = _encoder_layer(x, attn_mask_bias, cfg, "bert.layer%d" % i)
    return x


def default_max_pred(seq_len):
    """Masked positions the MLM head scores per sequence (shared by
    :func:`build_pretrain` and :func:`make_fake_batch`)."""
    return int(0.15 * seq_len) + 1


def build_pretrain(cfg=BERT_BASE, seq_len=128, lr=1e-4, amp=False,
                   train=True, max_pred=None):
    """Masked-LM pretraining program → ``(main, startup, feed_names,
    loss)``.  The masked positions (``mask_pos``, per sequence) are
    gathered before the vocab projection, which is tied to the word
    embedding; ``max_pred=0`` scores every position.  With
    ``train=False`` only the forward loss graph is built, dropout off."""
    if max_pred is None:
        max_pred = default_max_pred(seq_len)
    if not train:
        cfg = copy.copy(cfg)
        cfg.attn_dropout = 0.0
        cfg.dropout = 0.0
    main, startup = Program(), Program()
    with program_guard(main, startup):
        input_ids = layers.data("input_ids", shape=[seq_len], dtype="int64")
        token_type = layers.data("token_type_ids", shape=[seq_len],
                                 dtype="int64")
        # additive mask bias [B,1,1,T]: 0 keep, -1e4 drop
        mask_bias = layers.data("attn_mask_bias", shape=[1, 1, seq_len],
                                dtype="float32")
        n_pred = max_pred or seq_len
        mlm_labels = layers.data("mlm_labels", shape=[n_pred], dtype="int64")
        mlm_weights = layers.data("mlm_weights", shape=[n_pred],
                                  dtype="float32")
        if max_pred:
            for v in (mlm_labels, mlm_weights):
                v.feed_hint = (
                    "build_pretrain(max_pred=%d) expects GATHERED "
                    "masked-position feeds: mlm_labels/mlm_weights are "
                    "[batch, %d] and mask_pos is required.  To keep the "
                    "legacy all-position [batch, seq_len] layout, build "
                    "with max_pred=0." % (max_pred, n_pred))
            # per-sequence positions in [0, seq_len); the b*seq_len row
            # offset is added in the graph
            mask_pos = layers.data("mask_pos", shape=[n_pred], dtype="int64")
        x = encoder(input_ids, token_type, mask_bias, cfg, seq_len)
        word_emb = main.global_block().var("bert.word_emb")
        if max_pred:
            # row offsets [B,1]: cumsum of a T-filled column minus itself
            row_t = layers.fill_constant_batch_size_like(
                mlm_weights, shape=[-1, 1], dtype="int64",
                value=float(seq_len))
            offs = layers.elementwise_sub(layers.cumsum(row_t, axis=0), row_t)
            abs_pos = layers.elementwise_add(mask_pos, offs)
            x = layers.reshape(x, shape=[-1, cfg.hidden])
            x = layers.gather(x, layers.reshape(abs_pos, shape=[-1]))
            labels2 = layers.reshape(mlm_labels, shape=[-1, 1])
            w_flat = layers.reshape(mlm_weights, shape=[-1])
        else:
            labels2 = layers.unsqueeze(mlm_labels, [2])
            w_flat = mlm_weights
        logits = layers.matmul(x, word_emb, transpose_y=True)
        loss_tok = layers.softmax_with_cross_entropy(logits, labels2)
        loss_tok = layers.squeeze(loss_tok, [1 if max_pred else 2])
        num = layers.reduce_sum(layers.elementwise_mul(loss_tok, w_flat))
        den = layers.reduce_sum(w_flat)
        loss = layers.elementwise_div(num, den)
        if train:
            opt = optimizer.Adam(learning_rate=lr)
            if amp:
                opt = mixed_precision.decorate(opt)
            opt.minimize(loss)
        elif amp:
            mixed_precision.rewrite_program_bf16(main)
    feeds = ["input_ids", "token_type_ids", "attn_mask_bias", "pos_ids",
             "mlm_labels", "mlm_weights"]
    if max_pred:
        feeds.append("mask_pos")
    return main, startup, feeds, loss


def make_fake_batch(batch, seq_len, cfg, rng, max_pred=None):
    """A random MLM batch for :func:`build_pretrain`'s feeds, drawn from
    the numpy ``RandomState`` ``rng`` (the same draws as the
    reference)."""
    import numpy as np

    if max_pred is None:
        max_pred = default_max_pred(seq_len)
    ids = rng.randint(10, cfg.vocab_size, (batch, seq_len)).astype("int64")
    out = {"input_ids": ids,
           "token_type_ids": np.zeros((batch, seq_len), "int64"),
           "attn_mask_bias": np.zeros((batch, 1, 1, seq_len), "float32"),
           "pos_ids": np.tile(np.arange(seq_len, dtype="int64"), (batch, 1))}
    if max_pred:
        n_real = min(max_pred, max(1, int(0.15 * seq_len)))
        mask_pos = np.zeros((batch, max_pred), "int64")
        labels = np.zeros((batch, max_pred), "int64")
        weights = np.zeros((batch, max_pred), "float32")
        for b in range(batch):
            picks = rng.permutation(seq_len)[:n_real]
            mask_pos[b, :n_real] = picks
            labels[b, :n_real] = ids[b, picks]
            weights[b, :n_real] = 1.0
        out.update(mask_pos=mask_pos, mlm_labels=labels, mlm_weights=weights)
    else:
        out["mlm_labels"] = ids.copy()
        out["mlm_weights"] = (rng.rand(batch, seq_len) < 0.15).astype(
            "float32")
    return out
