"""ResNet for cifar10 / ImageNet (mirrors ``paddle_tpu/models/resnet.py``,
the whole file: ``conv_bn_layer`` :17, ``basicblock`` :35, ``bottleneck``
:44, ``resnet_cifar10`` :64, ``_s2d_stem`` :81, ``resnet_imagenet`` :110,
``build`` :143; the reference's ``benchmark/fluid/models/resnet.py``).

The same model code as the reference's, on this package's layers, so
both packages build the same program.  ``data_format="NHWC"`` builds the
channels-last variant (the ``img`` feed is then [H, W, C]; conv filters
stay OIHW): there the fusion pipeline rewrites every conv → batch_norm
(→ relu) into ``fused_conv_bn_act``, whose epilogue is the K4 kernel.
``build(amp=True)`` needs the bf16 rewrite, which is not ported yet, and
raises ``NotImplementedError``."""

import paddle_tpu_torch as fluid


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False, data_format="NCHW"):
    conv = fluid.layers.conv2d(
        input=input, num_filters=ch_out, filter_size=filter_size,
        stride=stride, padding=padding, bias_attr=False,
        data_format=data_format,
    )
    return fluid.layers.batch_norm(conv, act=act, is_test=is_test,
                                   data_layout=data_format)


def _shortcut(input, ch_in, ch_out, stride, is_test, data_format="NCHW"):
    if stride != 1 or ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, data_format=data_format)
    return input


def basicblock(input, ch_in, ch_out, stride, is_test, data_format="NCHW"):
    short = _shortcut(input, ch_in, ch_out, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None,
                          is_test=is_test, data_format=data_format)
    return fluid.layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_in, ch_out, stride, is_test, data_format="NCHW"):
    short = _shortcut(input, ch_in, ch_out * 4, stride, is_test,
                      data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format)
    return fluid.layers.elementwise_add(short, conv3, act="relu")


def _layer_warp(block_func, input, ch_in, ch_out, count, stride, is_test,
                data_format="NCHW"):
    res = block_func(input, ch_in, ch_out, stride, is_test, data_format)
    for _ in range(1, count):
        res = block_func(res, ch_out, ch_out, 1, is_test, data_format)
    return res


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False,
                   data_format="NCHW"):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    res1 = _layer_warp(basicblock, conv1, 16, 16, n, 1, is_test,
                       data_format)
    res2 = _layer_warp(basicblock, res1, 16, 32, n, 2, is_test,
                       data_format)
    res3 = _layer_warp(basicblock, res2, 32, 64, n, 2, is_test,
                       data_format)
    pool = fluid.layers.pool2d(res3, pool_size=8, pool_type="avg",
                               pool_stride=1, data_format=data_format)
    return fluid.layers.fc(pool, size=class_dim)


def _s2d_stem(input, is_test, data_format):
    """The 7x7/s2 stem recast via space-to-depth (block 2): a dense
    4x4/s1 conv over 12 channels on the 112x112 grid.  A free
    [64, 12, 4, 4] filter strictly contains the original [64, 3, 7, 7]
    class (pad 7x7 -> 8x8 with a zero row/col, space-to-depth the
    filter), so training from scratch is equivalent; checkpoints are
    not weight-compatible with the conv7 stem, hence opt-in
    (stem="s2d").  Output matches conv7 exactly in shape: [*, 64, 112,
    112] via asymmetric (1, 2) spatial padding."""
    if data_format == "NCHW":
        x = fluid.layers.space_to_depth(input, 2)      # [N,12,112,112]
        x = fluid.layers.pad(x, [0, 0, 0, 0, 1, 2, 1, 2])
    else:
        # channels-last: s2d expressed as reshape+transpose (the
        # space_to_depth op is NCHW by reference parity)
        n, h, w, c = input.shape
        x = fluid.layers.reshape(
            input, [-1, h // 2, 2, w // 2, 2, c])
        x = fluid.layers.transpose(x, [0, 1, 3, 2, 4, 5])
        x = fluid.layers.reshape(x, [-1, h // 2, w // 2, 4 * c])
        x = fluid.layers.pad(x, [0, 0, 1, 2, 1, 2, 0, 0])
    return conv_bn_layer(x, 64, 4, 1, 0, is_test=is_test,
                         data_format=data_format)


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    data_format="NCHW", stem="conv7"):
    cfg = {
        18: ([2, 2, 2, 2], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    if stem == "s2d":
        conv1 = _s2d_stem(input, is_test, data_format)
    else:
        conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test,
                              data_format=data_format)
    pool1 = fluid.layers.pool2d(conv1, pool_size=3, pool_stride=2,
                                pool_padding=1, pool_type="max",
                                data_format=data_format)
    expansion = 4 if block_func is bottleneck else 1
    res = pool1
    ch_in = 64
    for i, count in enumerate(stages):
        ch_out = 64 * (2 ** i)
        stride = 1 if i == 0 else 2
        res = _layer_warp(block_func, res, ch_in, ch_out, count, stride,
                          is_test, data_format)
        ch_in = ch_out * expansion
    pool2 = fluid.layers.pool2d(res, pool_size=7, pool_type="avg",
                                global_pooling=True,
                                data_format=data_format)
    return fluid.layers.fc(pool2, size=class_dim)


def build(dataset="cifar10", depth=None, batch_lr=0.1, class_dim=None,
          is_test=False, amp=False, data_format="NCHW", stem="conv7"):
    """Returns (main, startup, feeds, loss, acc): the training program
    (Momentum, lr ``batch_lr``, momentum 0.9, Nesterov).  amp=True
    raises (not ported).  data_format="NHWC" builds the channels-last variant (the ``img``
    feed is then [H, W, C]).  stem="s2d" (imagenet only) uses the
    space-to-depth stem — see ``_s2d_stem``."""
    if amp:
        raise NotImplementedError(
            "resnet.build(amp=True) needs the bf16 rewrite "
            "(contrib/mixed_precision), which is not ported yet "
            "(ROADMAP.md, Queue A 2); build in float32 with amp=False")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if dataset == "cifar10":
            shape = ([3, 32, 32] if data_format == "NCHW"
                     else [32, 32, 3])
            img = fluid.layers.data("img", shape=shape, dtype="float32")
            logits_fn = lambda im: resnet_cifar10(  # noqa: E731
                im, class_dim or 10, depth or 20, is_test, data_format
            )
        else:
            shape = ([3, 224, 224] if data_format == "NCHW"
                     else [224, 224, 3])
            img = fluid.layers.data("img", shape=shape, dtype="float32")
            logits_fn = lambda im: resnet_imagenet(  # noqa: E731
                im, class_dim or 1000, depth or 50, is_test, data_format,
                stem,
            )
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = logits_fn(img)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label)
        )
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        opt = fluid.optimizer.Momentum(learning_rate=batch_lr, momentum=0.9,
                                       use_nesterov=True)
        opt.minimize(loss)
    return main, startup, [img, label], loss, acc
