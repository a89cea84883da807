"""VGG-16 (mirrors ``paddle_tpu/models/vgg.py``, the whole file; the
reference's ``benchmark/fluid/models/vgg.py``).

The same model code as the reference's.  ``nets.img_conv_group`` gives
each conv a bias, so ``batch_norm`` is not the conv output's only reader
and the fusion's ``conv_bn_act`` family fuses no site, in either
package: the K4 epilogue does not run on VGG-16.  The head's
``batch_norm(fc1, data_layout="NHWC")`` normalises a 2-D tensor over its
last axis."""

import paddle_tpu_torch as fluid


def vgg16(input, class_dim, is_test=False, data_format="NCHW"):
    def conv_block(inp, num_filter, groups):
        return fluid.nets.img_conv_group(
            input=inp, conv_num_filter=[num_filter] * groups,
            pool_size=2, pool_stride=2, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            data_format=data_format,
        )

    c1 = conv_block(input, 64, 2)
    c2 = conv_block(c1, 128, 2)
    c3 = conv_block(c2, 256, 3)
    c4 = conv_block(c3, 512, 3)
    c5 = conv_block(c4, 512, 3)
    d1 = fluid.layers.dropout(c5, 0.5)
    fc1 = fluid.layers.fc(d1, size=512, act=None)
    bn = fluid.layers.batch_norm(fc1, act="relu", is_test=is_test,
                                 data_layout="NHWC")
    d2 = fluid.layers.dropout(bn, 0.5)
    fc2 = fluid.layers.fc(d2, size=512, act=None)
    return fluid.layers.fc(fc2, size=class_dim)


def build(dataset="cifar10", lr=1e-3, data_format="NCHW"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        size = 32 if dataset == "cifar10" else 224
        shape = ([3, size, size] if data_format == "NCHW"
                 else [size, size, 3])
        class_dim = 10 if dataset == "cifar10" else 1000
        img = fluid.layers.data("img", shape=shape, dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = vgg16(img, class_dim, data_format=data_format)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label)
        )
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, [img, label], loss, acc
