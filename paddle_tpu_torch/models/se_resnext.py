"""SE-ResNeXt (mirrors ``paddle_tpu/models/se_resnext.py``, the whole
file; the reference's ``benchmark/fluid/models/se_resnext.py``): grouped
bottleneck convolutions with squeeze-and-excitation gates.

The same model code as the reference's, so both packages build the same
program.  The builder is NCHW only: its conv → batch_norm sites (every
conv has ``bias_attr=False``) fuse into ``fused_conv_bn_act``, whose K4
epilogue takes only channels-last tensors, so here they run the op's
float epilogue, as the reference's NCHW sites do.  The grouped 3x3
convolutions are ``F.conv2d`` calls with ``groups`` (cuDNN on the
card)."""

import paddle_tpu_torch as fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = fluid.layers.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(conv, act=act, is_test=is_test)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = fluid.layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = fluid.layers.fc(pool, size=num_channels // reduction_ratio,
                              act="relu")
    excitation = fluid.layers.fc(squeeze, size=num_channels,
                                 act="sigmoid")
    # gate channels: [B, C] → [B, C, 1, 1]
    gate = fluid.layers.unsqueeze(
        fluid.layers.unsqueeze(excitation, [2]), [3])
    return fluid.layers.elementwise_mul(input, gate)


def bottleneck_block(input, num_filters, stride, cardinality,
                     reduction_ratio, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    ch_in = input.shape[1]
    if ch_in == num_filters * 2 and stride == 1:
        short = input
    else:
        short = conv_bn_layer(input, num_filters * 2, 1, stride=stride,
                              is_test=is_test)
    return fluid.layers.elementwise_add(short, scale, act="relu")


def se_resnext(input, class_dim=10, cardinality=8, reduction_ratio=16,
               depth=(1, 1, 1), num_filters=(32, 64, 128), is_test=False):
    """Compact SE-ResNeXt (the benchmark's 50/152 shape with configurable
    depth so the CPU tests stay fast)."""
    conv = conv_bn_layer(input, 32, 3, stride=1, act="relu",
                         is_test=is_test)
    for block, nf in zip(depth, num_filters):
        for i in range(block):
            conv = bottleneck_block(
                conv, nf, stride=2 if i == 0 else 1,
                cardinality=cardinality,
                reduction_ratio=reduction_ratio, is_test=is_test)
    pool = fluid.layers.pool2d(conv, pool_type="avg", global_pooling=True)
    drop = pool if is_test else fluid.layers.dropout(
        pool, 0.2, dropout_implementation="upscale_in_train")
    return fluid.layers.fc(drop, size=class_dim)


def build(image_shape=(3, 32, 32), class_dim=10, lr=1e-2, is_test=False,
          **net_kwargs):
    """Returns (main, startup, feeds, loss, acc)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=list(image_shape),
                                dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = se_resnext(img, class_dim, is_test=is_test, **net_kwargs)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        if not is_test:
            opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
            opt.minimize(loss)
    return main, startup, [img, label], loss, acc
