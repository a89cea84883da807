"""Composed nets (mirrors ``paddle_tpu/nets.py``, the whole file:
``simple_img_conv_pool`` :9, ``img_conv_group`` :27, ``glu`` :61,
``scaled_dot_product_attention`` :68, ``sequence_conv_pool`` :97), built
from this package's layers, so both packages build the same program."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   data_format="NCHW"):
    tmp = input
    if not isinstance(conv_padding, list):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if not isinstance(conv_filter_size, list):
        conv_filter_size = [conv_filter_size] * len(conv_num_filter)
    if not isinstance(conv_with_batchnorm, list):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, list):
        conv_batchnorm_drop_rate = (
            [conv_batchnorm_drop_rate] * len(conv_num_filter)
        )
    for i in range(len(conv_num_filter)):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr, act=local_act,
            data_format=data_format,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act,
                                    data_layout=data_format)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, data_format=data_format,
    )


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    from .layers import ops

    return layers.elementwise_mul(a, ops.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention: split heads, scaled
    ``Q Kᵀ``, softmax (and dropout), ``· V``, merge heads."""
    d_key = queries.shape[-1] // num_heads

    def _split_heads(x):
        b, t, d = x.shape[0], x.shape[1], x.shape[2]
        x = layers.reshape(x, [0, 0, num_heads, d // num_heads])
        return layers.transpose(x, [0, 2, 1, 3])

    def _merge_heads(x):
        x = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(x, [0, 0, x.shape[2] * x.shape[3]])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scores = layers.matmul(q, k, transpose_y=True, alpha=d_key ** -0.5)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(
            weights, dropout_prob=dropout_rate,
            dropout_implementation="upscale_in_train",
        )
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None,
                       seq_len=None):
    """Sequence conv + pool of a padded [B, T, N] batch (and its
    optional ``seq_len``, the stand-in for LoD)."""
    conv = layers.sequence_conv(
        input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act, bias_attr=bias_attr,
        seq_len=seq_len)
    return layers.sequence_pool(conv, pool_type, seq_len=seq_len)
