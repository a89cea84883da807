"""Seq2seq NMT with beam-search decoding (mirrors
``paddle_tpu/models/machine_translation.py``: ``gru_cell`` :22,
``encode`` :41, ``build_train`` :60, ``build_train_dynamic`` :96 and
``build_infer`` :143).

The reference harness's ``machine_translation`` workload (after the
upstream ``benchmark/fluid/models/machine_translation.py`` and the book
test ``tests/book/test_machine_translation.py``): a GRU encoder-decoder
on padded fixed-length batches, its decoder cell a hand-written GRU step
whose parameters are named (``ParamAttr``), so the teacher-forced
trainers (a StaticRNN, or a DynamicRNN over length-masked targets) and
the beam-search decoder (``beam_search`` inside a ``While``, backtraced
by ``beam_search_decode``) share every weight, as the reference's train
and infer programs share theirs.  The programs are the reference's, op
for op.
"""

import paddle_tpu_torch as fluid
from paddle_tpu_torch.param_attr import ParamAttr


def _shared(name):
    return ParamAttr(name=name)


def gru_cell(x, h, size, prefix):
    """Minimal GRU step on [N, E+H] inputs with nameable (shared) params."""
    gates = fluid.layers.fc(
        fluid.layers.concat([x, h], axis=1), size=2 * size, act="sigmoid",
        param_attr=_shared(prefix + "_gate_w"),
        bias_attr=_shared(prefix + "_gate_b"))
    r, u = fluid.layers.split(gates, 2, dim=1)
    c = fluid.layers.fc(
        fluid.layers.concat([x, fluid.layers.elementwise_mul(r, h)], axis=1),
        size=size, act="tanh",
        param_attr=_shared(prefix + "_cand_w"),
        bias_attr=_shared(prefix + "_cand_b"))
    one_minus_u = fluid.layers.scale(u, scale=-1.0, bias=1.0)
    return fluid.layers.elementwise_add(
        fluid.layers.elementwise_mul(u, h),
        fluid.layers.elementwise_mul(one_minus_u, c))


def encode(src, vocab_size, emb_dim, hidden_dim):
    """src [B, Ts] int64 → context [B, H] (last encoder state)."""
    src_emb = fluid.layers.embedding(
        src, size=[vocab_size, emb_dim], param_attr=_shared("src_emb"))
    proj = fluid.layers.fc(
        src_emb, size=3 * hidden_dim, num_flatten_dims=2,
        param_attr=_shared("enc_proj_w"), bias_attr=_shared("enc_proj_b"))
    enc = fluid.layers.dynamic_gru(
        proj, size=hidden_dim, param_attr=_shared("enc_gru_w"),
        bias_attr=_shared("enc_gru_b"))  # [B, Ts, H]
    Ts = src.shape[1]
    last = fluid.layers.slice(enc, axes=[1], starts=[Ts - 1], ends=[Ts])
    context = fluid.layers.reshape(last, shape=[-1, enc.shape[2]])
    h0 = fluid.layers.fc(
        context, size=hidden_dim, act="tanh",
        param_attr=_shared("dec_init_w"), bias_attr=_shared("dec_init_b"))
    return context, h0


def build_train(vocab_size, emb_dim=32, hidden_dim=64, src_len=8, tgt_len=8,
                lr=1e-3, batch_size=None):
    """Teacher-forced trainer.  Returns (main, startup, feeds, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[src_len], dtype="int64")
        tgt_in = fluid.layers.data("tgt_in", shape=[tgt_len], dtype="int64")
        tgt_out = fluid.layers.data("tgt_out", shape=[tgt_len, 1],
                                    dtype="int64")
        context, h0 = encode(src, vocab_size, emb_dim, hidden_dim)

        tgt_emb = fluid.layers.embedding(
            tgt_in, size=[vocab_size, emb_dim], param_attr=_shared("tgt_emb"))
        # time-major for StaticRNN
        tgt_t = fluid.layers.transpose(tgt_emb, perm=[1, 0, 2])  # [T, B, E]

        rnn = fluid.layers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(tgt_t)              # [B, E]
            h = rnn.memory(init=h0)                  # [B, H]
            inp = fluid.layers.concat([x_t, context], axis=1)
            h_new = gru_cell(inp, h, hidden_dim, "dec_gru")
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        hiddens = rnn()                              # [T, B, H]

        logits = fluid.layers.fc(
            hiddens, size=vocab_size, num_flatten_dims=2,
            param_attr=_shared("out_w"), bias_attr=_shared("out_b"))
        labels_t = fluid.layers.transpose(tgt_out, perm=[1, 0, 2])  # [T,B,1]
        loss = fluid.layers.reduce_mean(
            fluid.layers.softmax_with_cross_entropy(logits, labels_t))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, [src, tgt_in, tgt_out], loss


def build_train_dynamic(vocab_size, emb_dim=32, hidden_dim=64, src_len=8,
                        tgt_len=8, lr=1e-3):
    """Teacher-forced trainer whose decoder is a DynamicRNN over padded
    variable-length targets (the reference book model's decoder shape:
    ``python/paddle/fluid/tests/book/test_machine_translation.py`` uses
    DynamicRNN over ragged LoD targets; here targets are padded [B,T]
    with an explicit `tgt_lens` feed and the loss is length-masked).

    Returns (main, startup, feed names, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[src_len], dtype="int64")
        tgt_in = fluid.layers.data("tgt_in", shape=[tgt_len], dtype="int64")
        tgt_out = fluid.layers.data("tgt_out", shape=[tgt_len, 1],
                                    dtype="int64")
        tgt_lens = fluid.layers.data("tgt_lens", shape=[], dtype="int64")
        context, h0 = encode(src, vocab_size, emb_dim, hidden_dim)

        tgt_emb = fluid.layers.embedding(
            tgt_in, size=[vocab_size, emb_dim], param_attr=_shared("tgt_emb"))

        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(tgt_emb, lengths=tgt_lens)  # [B, E]
            h = drnn.memory(init=h0)                          # [B, H]
            inp = fluid.layers.concat([x_t, context], axis=1)
            h_new = gru_cell(inp, h, hidden_dim, "dec_gru")
            drnn.update_memory(h, h_new)
            drnn.output(h_new)
        hiddens = drnn()                                      # [B, T, H]

        logits = fluid.layers.fc(
            hiddens, size=vocab_size, num_flatten_dims=2,
            param_attr=_shared("out_w"), bias_attr=_shared("out_b"))
        tok_loss = fluid.layers.softmax_with_cross_entropy(
            logits, tgt_out)                                  # [B, T, 1]
        mask = fluid.layers.cast(
            fluid.layers.sequence_mask(tgt_lens, maxlen=tgt_len), "float32")
        tok_loss = fluid.layers.elementwise_mul(
            fluid.layers.squeeze(tok_loss, axes=[2]), mask)
        loss = fluid.layers.elementwise_div(
            fluid.layers.reduce_sum(tok_loss),
            fluid.layers.reduce_sum(mask))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, [src, tgt_in, tgt_out, tgt_lens], loss


def build_infer(vocab_size, emb_dim=32, hidden_dim=64, src_len=8,
                batch_size=4, beam_size=3, max_len=10, start_id=1, end_id=2):
    """Beam-search decoder sharing all parameters with build_train.

    Returns (main, startup, feeds, sentence_ids [B,K,max_len],
    sentence_scores [B,K]).
    """
    B, K = batch_size, beam_size
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[B, src_len], dtype="int64",
                                append_batch_size=False)
        context, h0 = encode(src, vocab_size, emb_dim, hidden_dim)

        # beams: all start on beam 0 (dense-beam first-step convention)
        pre_ids = fluid.layers.fill_constant([B, K], "int32",
                                             float(start_id))
        zero_col = fluid.layers.fill_constant([B, 1], "float32", 0.0)
        ninf_cols = fluid.layers.fill_constant([B, K - 1], "float32", -1e9)
        pre_scores = fluid.layers.concat([zero_col, ninf_cols], axis=1)

        # per-beam state/context: [B, H] → [B*K, H]
        def tile_beams(x):
            x3 = fluid.layers.unsqueeze(x, axes=[1])          # [B, 1, H]
            x3 = fluid.layers.expand(x3, expand_times=[1, K, 1])
            return fluid.layers.reshape(x3, shape=[B * K, -1])

        h = tile_beams(h0)
        ctx_tiled = tile_beams(context)

        i = fluid.layers.fill_constant([1], "int32", 0)
        # arrays need a pre-loop write so their buffers are loop-carried
        # (first in-loop write is overwritten at i=0 on the first iteration)
        zero_ids = fluid.layers.fill_constant([B, K], "int32", 0.0)
        zero_scores = fluid.layers.fill_constant([B, K], "float32", 0.0)
        ids_array = fluid.layers.array_write(zero_ids, i, capacity=max_len)
        scores_array = fluid.layers.array_write(zero_scores, i,
                                                capacity=max_len)
        parents_array = fluid.layers.array_write(zero_ids, i,
                                                 capacity=max_len)
        limit = fluid.layers.fill_constant([1], "int32", float(max_len))
        cond = fluid.layers.less_than(i, limit)
        # beam-offset rows for regrouping gathered parents: [B, K]
        row_offset = fluid.layers.reshape(
            fluid.layers.range(0, B * K, K, "int32"), shape=[B, 1])

        w = fluid.layers.While(cond)
        with w.block():
            flat_ids = fluid.layers.reshape(pre_ids, shape=[B * K])
            emb = fluid.layers.embedding(
                flat_ids, size=[vocab_size, emb_dim],
                param_attr=_shared("tgt_emb"))
            inp = fluid.layers.concat([emb, ctx_tiled], axis=1)
            h_new = gru_cell(inp, h, hidden_dim, "dec_gru")
            logits = fluid.layers.fc(
                h_new, size=vocab_size,
                param_attr=_shared("out_w"), bias_attr=_shared("out_b"))
            logp = fluid.layers.log_softmax(logits)
            logp3 = fluid.layers.reshape(logp, shape=[B, K, vocab_size])

            sel_ids, sel_scores, parent = fluid.layers.beam_search(
                pre_ids, pre_scores, None, logp3, beam_size=K,
                end_id=end_id, is_accumulated=False,
                return_parent_idx=True)

            # reorder beam states by parent: global row = b*K + parent
            global_parent = fluid.layers.reshape(
                fluid.layers.elementwise_add(parent, row_offset),
                shape=[B * K])
            h_reordered = fluid.layers.gather(h_new, global_parent)

            fluid.layers.array_write(sel_ids, i, ids_array)
            fluid.layers.array_write(sel_scores, i, scores_array)
            fluid.layers.array_write(parent, i, parents_array)

            fluid.layers.assign(sel_ids, output=pre_ids)
            fluid.layers.assign(sel_scores, output=pre_scores)
            fluid.layers.assign(h_reordered, output=h)
            fluid.layers.increment(i, value=1.0, in_place=True)

            # stop early once every beam has emitted end_id
            end_const = fluid.layers.fill_constant([B, K], "int32",
                                                   float(end_id))
            alive = fluid.layers.cast(
                fluid.layers.not_equal(sel_ids, end_const), "int32")
            any_alive = fluid.layers.greater_than(
                fluid.layers.reduce_sum(alive),
                fluid.layers.fill_constant([1], "int32", 0.0))
            in_range = fluid.layers.less_than(i, limit)
            fluid.layers.assign(
                fluid.layers.logical_and(any_alive, in_range), output=cond)

        sent_ids, sent_scores = fluid.layers.beam_search_decode(
            ids_array, scores_array, parents_array, beam_size=K,
            end_id=end_id)
    return main, startup, [src], sent_ids, sent_scores
