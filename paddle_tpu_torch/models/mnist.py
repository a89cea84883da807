"""MNIST models (mirrors ``paddle_tpu/models/mnist.py``, all of it; the
reference's ``benchmark/fluid/models/mnist.py`` and the book test
``tests/book/test_recognize_digits.py``; BASELINE config 1)."""

import paddle_tpu_torch as fluid


def mlp(img, label, hidden_sizes=(200, 200)):
    h = img
    for size in hidden_sizes:
        h = fluid.layers.fc(h, size=size, act="relu")
    logits = fluid.layers.fc(h, size=10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label)
    )
    acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return loss, acc, logits


def conv_net(img, label):
    """LeNet-style conv net (reference mnist.py cnn_model)."""
    conv1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu",
    )
    conv2 = fluid.nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu",
    )
    logits = fluid.layers.fc(conv2, size=10)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label)
    )
    acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return loss, acc, logits


def build(use_conv=False, lr=1e-3):
    """Returns (main, startup, feeds, loss, acc)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if use_conv:
            img = fluid.layers.data("img", shape=[1, 28, 28], dtype="float32")
        else:
            img = fluid.layers.data("img", shape=[784], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        model = conv_net if use_conv else mlp
        loss, acc, _ = model(img, label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, [img, label], loss, acc
