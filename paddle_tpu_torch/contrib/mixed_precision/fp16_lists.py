"""The op lists of the bf16 rewrite: the port's own copy of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py`` (the same sets, so
both packages rewrite a program alike).

The low precision is bfloat16, not float16: it has float32's exponent
range, so no loss scaling is needed.  The white list runs the whole
compute body in bf16, the matmul-class ops and the elementwise, norm
and shape glue between them; the ops whose numerics need it (layer
norm's statistics, softmax, the cross entropy) upcast to float32 inside
their own lowerings.  The black list keeps float32 inputs."""

white_list = {
    # matmul-class
    "mul",
    "matmul",
    "conv2d",
    "depthwise_conv2d",
    "conv3d",
    "conv2d_transpose",
    "fused_dropout_add_ln",
    "fused_multihead_attention",
    # elementwise / activation glue
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "scale",
    "sum",
    "relu",
    "gelu",
    "tanh",
    "sigmoid",
    "swish",
    "leaky_relu",
    "dropout",
    # shape glue
    "reshape",
    "reshape2",
    "transpose",
    "transpose2",
    "concat",
    "split",
    "stack",
    "slice",
    "squeeze",
    "squeeze2",
    "unsqueeze",
    "unsqueeze2",
    "expand",
    "pad",
    # normalization / attention softmax / fused loss (f32 internals)
    "layer_norm",
    "softmax",
    "softmax_with_cross_entropy",
}

# numerically sensitive ops: float32 inputs
black_list = {
    "cross_entropy",
    "log_softmax",
    "mean",
    "reduce_mean",
    "reduce_sum",
    "batch_norm",
    "exp",
    "log",
    "squared_l2_norm",
}

# everything else follows its inputs
gray_list = set()


class AutoMixedPrecisionLists:
    """The default lists, with ``custom_white_list`` /
    ``custom_black_list`` added to them."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
