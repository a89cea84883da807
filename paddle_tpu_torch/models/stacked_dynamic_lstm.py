"""Stacked dynamic-LSTM sentiment model (mirrors
``paddle_tpu/models/stacked_dynamic_lstm.py``, the reference harness's
``stacked_dynamic_lstm`` workload after the upstream
``benchmark/fluid/models/stacked_dynamic_lstm.py``): embedding → fc →
stacked LSTM layers, every other one reversed → length-masked max pools
→ fc head, on padded [B, T] batches with their lengths.  The program is
the reference's, op for op."""

import paddle_tpu_torch as fluid


def build(vocab_size=5149, seq_len=80, emb_dim=512, hidden_dim=512,
          stacked_num=3, class_dim=2, lr=1e-3):
    """Returns (main, startup, feed names, loss, acc)."""
    assert stacked_num % 2 == 1, "stacked_num must be odd (reference)"
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[seq_len], dtype="int64")
        lens = fluid.layers.data("lens", shape=[], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(
            words, size=[vocab_size, emb_dim],
            param_attr=fluid.ParamAttr(
                initializer=fluid.initializer.Uniform(-0.1, 0.1)))
        # dynamic_lstm takes pre-projected [B, T, 4*hidden] gates
        # (size = 4*hidden, the reference convention)
        fc1 = fluid.layers.fc(emb, size=hidden_dim * 4,
                              num_flatten_dims=2, act="tanh")
        lstm1, _ = fluid.layers.dynamic_lstm(
            fc1, size=hidden_dim * 4, seq_len=lens)
        inputs = [fc1, lstm1]
        for i in range(2, stacked_num + 1):
            fc = fluid.layers.fc(
                fluid.layers.concat(inputs, axis=2),
                size=hidden_dim * 4, num_flatten_dims=2, act="tanh")
            lstm, _ = fluid.layers.dynamic_lstm(
                fc, size=hidden_dim * 4, is_reverse=(i % 2) == 0,
                seq_len=lens)
            inputs = [fc, lstm]
        # sequence max-pools over the time dim, masked by length
        mask = fluid.layers.cast(
            fluid.layers.sequence_mask(lens, maxlen=seq_len), "float32")
        neg = fluid.layers.scale(
            fluid.layers.elementwise_sub(
                fluid.layers.unsqueeze(mask, [2]),
                fluid.layers.fill_constant([1], "float32", 1.0)),
            scale=1e9)

        def masked_max(x):
            return fluid.layers.reduce_max(
                fluid.layers.elementwise_add(x, neg), dim=[1])

        fc_last = masked_max(inputs[0])
        lstm_last = masked_max(inputs[1])
        logits = fluid.layers.fc(
            fluid.layers.concat([fc_last, lstm_last], axis=1),
            size=class_dim)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, ["words", "lens", "label"], loss, acc
