"""Vision ops (mirrors ``paddle_tpu/ops/vision.py``: ``space_to_depth``
:37, which ResNet's space-to-depth stem uses).  The rest of the
reference's vision ops are queued in ROADMAP.md."""

from .registry import register_op


@register_op("space_to_depth", inputs=["X"], outputs=["Out"])
def space_to_depth(ctx, attrs, X):
    """[N, C, H, W] → [N, C·b², H/b, W/b] (space_to_depth_op.cc)."""
    b = int(attrs.get("blocksize", 1))
    n, c, h, w = X.shape
    x = X.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)
