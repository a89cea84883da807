"""``nets`` of the PyTorch port against the reference: the five composed
nets (``simple_img_conv_pool``, ``img_conv_group``, ``glu``,
``scaled_dot_product_attention``, ``sequence_conv_pool``), built by the
same code in both packages on seeded feeds, with the reference's
parameters copied into the port.  The output within 1e-5 and the
gradients of ``sum(out * cot)`` with respect to the input and every
parameter within 1e-4, as ``test_torch_vision_ops.py`` holds the ops."""

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as tfluid
from test_torch_vision_ops import _compare, _x


def _seq_conv_pool(pool_type, with_len):
    def build(f, v):
        return f.nets.sequence_conv_pool(
            v["x"], num_filters=5, filter_size=3, pool_type=pool_type,
            seq_len=v.get("n") if with_len else None)
    return build


CASES = {
    "simple_img_conv_pool": (
        lambda f, v: f.nets.simple_img_conv_pool(
            v["x"], num_filters=4, filter_size=3, pool_size=2,
            pool_stride=2, conv_padding=1, act="relu"),
        {"x": _x(2, 3, 8, 8)}),
    "simple_img_conv_pool_avg_grouped": (
        lambda f, v: f.nets.simple_img_conv_pool(
            v["x"], num_filters=4, filter_size=3, pool_size=3,
            pool_stride=2, pool_padding=1, pool_type="avg", conv_groups=2),
        {"x": _x(2, 4, 9, 9)}),
    "img_conv_group_bn": (
        lambda f, v: f.nets.img_conv_group(
            v["x"], conv_num_filter=[4, 5], pool_size=2, pool_stride=2,
            conv_act="relu", conv_with_batchnorm=True),
        {"x": _x(2, 3, 8, 8)}),
    "img_conv_group_nhwc": (
        lambda f, v: f.nets.img_conv_group(
            v["x"], conv_num_filter=[4, 4], pool_size=2, pool_stride=2,
            conv_act="relu", conv_with_batchnorm=[True, False],
            data_format="NHWC"),
        {"x": _x(2, 8, 8, 3)}),
    "glu": (
        lambda f, v: f.nets.glu(v["x"], dim=-1),
        {"x": _x(3, 4, 10)}),
    "glu_axis1": (
        lambda f, v: f.nets.glu(v["x"], dim=1),
        {"x": _x(3, 6, 5)}),
    "scaled_dot_product_attention": (
        lambda f, v: f.nets.scaled_dot_product_attention(
            v["q"], v["k"], v["v"], num_heads=2),
        {"q": _x(2, 5, 8), "k": _x(2, 7, 8, seed=1),
         "v": _x(2, 7, 8, seed=2)}),
    "sequence_conv_pool_max": (
        _seq_conv_pool("max", True),
        {"x": _x(3, 6, 4), "n": np.asarray([6, 3, 1], "int64")}),
    "sequence_conv_pool_average_full": (
        _seq_conv_pool("average", False),
        {"x": _x(2, 5, 4)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_net_matches_reference(case):
    build, feeds = CASES[case]
    floats = [n for n, v in feeds.items() if v.dtype == np.float32]
    _compare(build, feeds, floats)


def test_every_reference_net_is_ported():
    assert sorted(tfluid.nets.__all__) == sorted(jfluid.nets.__all__)
    for name in jfluid.nets.__all__:
        assert callable(getattr(tfluid.nets, name))
