"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper (``csrc/flash_attention.cu``) and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:
the forward (``_flash_fwd`` :235, ``pallas_call`` :266, body
``_fwd_kernel`` :152) and the backward's dK/dV and dQ kernels
(``_flash_bwd`` :428, ``pallas_call`` :473 and :521).  FlashAttention-2
blocked online softmax over q/k/v ``[B·H, T, Dh]`` with an additive key
bias ``[B, Tk]`` broadcast over heads, an optional causal mask, f32
statistics, and the row max ``m`` and row sum ``l`` saved separately for
the backward.  Masked keys (causal, or past a ragged ``Tk``) contribute
nothing, so a row with no visible key (every key biased to -inf) returns
0 — the ``l == 0`` guard of the TPU kernel — and gets zero gradients.
Attention dropout is FA2's (``l`` sums the undropped probabilities, only
the PV numerator is masked), with the mask of :mod:`.dropout`.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch the
kernels for CUDA tensors (or raise) and run :func:`flash_attention_fwd_plain`
/ :func:`flash_attention_bwd_plain` for CPU tensors, and for ``meta``
tensors during shape inference.  :func:`flash_attention` is the
reference's public entry, a ``torch.autograd.Function`` over the two.
"""

import math
import os

import torch

from . import _lib
from . import dropout as _drop

NEG_INF = -1e30
MAX_HEAD_DIM = 128
KERNEL = "flash_attention_fwd"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_DQ = "flash_attention_bwd_dq"


def flash_min_t():
    """Sequence length from which ``models/bert.py`` (``fuse_attn="auto"``)
    builds ``fused_multihead_attention`` instead of the unfused
    matmul/softmax chain: ``PADDLE_TPU_FLASH_MIN_T``, default 512 — the
    reference's env name and default, resolved at build time."""
    env = os.environ.get("PADDLE_TPU_FLASH_MIN_T", "").strip()
    return int(env) if env else 512


def _as_bias2d(bias, batch, tk):
    if bias is None:
        return None
    if bias.dim() == 4:  # [B,1,1,Tk], the mask layout BERT feeds
        bias = bias.reshape(bias.shape[0], bias.shape[-1])
    if bias.dim() != 2 or bias.shape[1] != tk or bias.shape[0] == 0 \
            or batch % bias.shape[0] != 0:
        raise ValueError("flash attention bias must be [B, Tk] or "
                         "[B,1,1,Tk] with Tk=%d, got %s"
                         % (tk, tuple(bias.shape)))
    return bias


def _scores(q, k, bias, causal, sm_scale):
    """f32 scores with excluded keys at -inf."""
    bh, tq, _ = q.shape
    tk = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    if bias is not None:
        nheads = bh // bias.shape[0]
        s = s + bias.float().repeat_interleave(nheads, dim=0)[:, None, :]
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    return s


def _keep(q, k, dropout_rate, dropout_seed):
    if not dropout_rate:
        return None
    return _drop.attention_keep_mask(dropout_seed, dropout_rate, q.shape[0],
                                     q.shape[1], k.shape[1], q.device)


def flash_attention_fwd_plain(q, k, v, bias=None, causal=False, sm_scale=1.0,
                              dropout_rate=0.0, dropout_seed=None):
    """The forward kernel's function, unblocked: q [BH,Tq,Dh], k/v
    [BH,Tk,Dh], bias [B,Tk] f32 → (o [BH,Tq,Dh] in q's dtype, m [BH,Tq]
    f32, l [BH,Tq] f32).  Computed in f32 like the kernel, with the
    (dropped) p rounded to v's dtype before the PV product; a row that
    sees no key gives o = 0 and l = 1, as the kernel."""
    s = _scores(q, k, bias, causal, sm_scale)
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l = torch.where(l == 0, torch.ones_like(l), l)
    keep = _keep(q, k, dropout_rate, dropout_seed)
    if keep is not None:
        p = torch.where(keep, p * _drop.keep_scale(dropout_rate),
                        torch.zeros_like(p))
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l[..., None]
    return o.to(q.dtype), m, l


def flash_attention_bwd_plain(q, k, v, bias, o, m, l, do, causal=False,
                              sm_scale=1.0, dropout_rate=0.0,
                              dropout_seed=None):
    """The two backward kernels' function, unblocked → (dq, dk, dv) in
    q's dtype: p recomputed from the saved m and l, dP = dO V^T, the mask
    on p (for dV) and on dP, dS = p (dP - delta) with delta = rowsum(dO
    O); the dropped p and dS rounded to the operand dtype before their
    products, as the kernels."""
    s = _scores(q, k, bias, causal, sm_scale)
    p = torch.exp(s - m[..., None]) / l[..., None]
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    pv = p
    keep = _keep(q, k, dropout_rate, dropout_seed)
    if keep is not None:
        ks = _drop.keep_scale(dropout_rate)
        pv = torch.where(keep, p * ks, torch.zeros_like(p))
        dp = torch.where(keep, dp * ks, torch.zeros_like(dp))
    delta = (dof * o.float()).sum(dim=-1)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dv = torch.matmul(pv.to(v.dtype).float().transpose(1, 2), dof)
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * sm_scale
    dq = torch.matmul(ds, k.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q/k/v must be [B*H, T, Dh]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError("q %s / k %s / v %s shapes disagree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q/k/v dtypes differ: %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    devs = {t.device for t in (q, k, v) + ((bias,) if bias is not None else ())}
    if len(devs) != 1:
        raise ValueError("q/k/v/bias lie on different devices: %s" % devs)


def _kernel_common(kernel, q, k, bias, tensors):
    """Checks of a CUDA launch; returns (dtype code, heads)."""
    bh, tq, dh = q.shape
    tk = k.shape[1]
    if not 1 <= dh <= MAX_HEAD_DIM or bh == 0 or tq == 0 or tk == 0:
        raise ValueError("%s kernel takes non-empty q/k/v with 1 <= Dh <= "
                         "%d, got q %s, k %s" % (kernel, MAX_HEAD_DIM,
                                                 tuple(q.shape),
                                                 tuple(k.shape)))
    code = _lib.dtype_code(q, kernel)
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (kernel, name))
    heads = 1
    if bias is not None:
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            raise TypeError("%s: bias must be contiguous float32, got %s"
                            % (kernel, bias.dtype))
        heads = bh // bias.shape[0]
    return code, heads


def _prepare(q, k, v, bias, sm_scale, dropout_rate, dropout_seed):
    _check(q, k, v, bias)
    rate = _drop.check_rate(dropout_rate, dropout_seed)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[2])
    return _as_bias2d(bias, q.shape[0], k.shape[1]), float(sm_scale), rate


def flash_attention_fwd(q, k, v, bias=None, causal=False, sm_scale=None,
                        dropout_rate=0.0, dropout_seed=None):
    """q [BH,Tq,Dh], k/v [BH,Tk,Dh], bias [B,Tk] or [B,1,1,Tk] →
    (o, m, l).  CUDA tensors launch the kernel; CPU and meta tensors run
    the plain version."""
    bias, sm_scale, rate = _prepare(q, k, v, bias, sm_scale, dropout_rate,
                                    dropout_seed)
    if q.device.type != "cuda":
        return flash_attention_fwd_plain(q, k, v, bias, causal, sm_scale,
                                         rate, dropout_seed)
    code, heads = _kernel_common(KERNEL, q, k, bias,
                                 (("q", q), ("k", k), ("v", v)))
    bh, tq, dh = q.shape
    o = torch.empty_like(q)
    m = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    err = _lib.lib().pt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), m.data_ptr(), l.data_ptr(),
        bh, heads, tq, k.shape[1], dh, sm_scale, int(bool(causal)),
        *_drop.kernel_args(rate, dropout_seed), code,
        _lib.stream_handle(q.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return o, m, l


def _bwd_launch(kernel, fn_name, q, k, v, bias, do, m, l, delta, outs,
                causal, sm_scale, rate, seed):
    """Checks and launch of one backward kernel, writing ``outs``."""
    if q.device.type != "cuda":
        raise ValueError("%s takes CUDA tensors; flash_attention_bwd runs "
                         "the plain version on the CPU" % kernel)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do %s %s must be like q %s %s"
                         % (tuple(do.shape), do.dtype, tuple(q.shape),
                            q.dtype))
    code, heads = _kernel_common(
        kernel, q, k, bias,
        (("q", q), ("k", k), ("v", v), ("do", do), ("m", m), ("l", l),
         ("delta", delta)))
    bh, tq, dh = q.shape
    err = getattr(_lib.lib(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        *(t.data_ptr() for t in outs), bh, heads, tq, k.shape[1], dh,
        sm_scale, int(bool(causal)), *_drop.kernel_args(rate, seed), code,
        _lib.stream_handle(q.device))
    _lib.check(err, kernel)
    _lib.count_launch(kernel)


def flash_attention_bwd_dkv(q, k, v, bias, do, m, l, delta, causal=False,
                            sm_scale=None, dropout_rate=0.0,
                            dropout_seed=None):
    """The dK/dV kernel on CUDA tensors → (dk, dv); ``delta`` [BH, Tq] is
    rowsum(dO·O) in f32."""
    bias, sm_scale, rate = _prepare(q, k, v, bias, sm_scale, dropout_rate,
                                    dropout_seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(KERNEL_DKV, "pt_flash_attention_bwd_dkv", q, k, v, bias, do,
                m, l, delta, (dk, dv), causal, sm_scale, rate, dropout_seed)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, bias, do, m, l, delta, causal=False,
                           sm_scale=None, dropout_rate=0.0,
                           dropout_seed=None):
    """The dQ kernel on CUDA tensors → dq."""
    bias, sm_scale, rate = _prepare(q, k, v, bias, sm_scale, dropout_rate,
                                    dropout_seed)
    dq = torch.empty_like(q)
    _bwd_launch(KERNEL_DQ, "pt_flash_attention_bwd_dq", q, k, v, bias, do,
                m, l, delta, (dq,), causal, sm_scale, rate, dropout_seed)
    return dq


def flash_attention_bwd(q, k, v, bias, o, m, l, do, causal=False,
                        sm_scale=None, dropout_rate=0.0, dropout_seed=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd`'s o from the
    saved o, m, l and the output gradient do.  CUDA tensors launch the
    dK/dV and dQ kernels (delta = rowsum(dO·O) is a PyTorch reduction, as
    in the reference); CPU tensors run the plain version."""
    if q.device.type != "cuda":
        bias, sm_scale, rate = _prepare(q, k, v, bias, sm_scale,
                                        dropout_rate, dropout_seed)
        return flash_attention_bwd_plain(q, k, v, bias, o, m, l, do, causal,
                                         sm_scale, rate, dropout_seed)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (causal, sm_scale, dropout_rate, dropout_seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, do, m, l, delta, *args)
    dq = flash_attention_bwd_dq(q, k, v, bias, do, m, l, delta, *args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``_flash`` with its custom vjp (:669-694): the bias gets no
    gradient and the seed none either."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, rate, seed):
        o, m, l = flash_attention_fwd(q, k, v, bias, causal, sm_scale, rate,
                                      seed)
        ctx.save_for_backward(q, k, v, bias, o, m, l)
        ctx.args = (causal, sm_scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, o, m, l, do,
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    dropout_rate=0.0, dropout_seed=None):
    """Multi-head attention over ``[B, H, T, Dh]`` tensors (the reference's
    public ``flash_attention``); returns ``[B, H, Tq, Dh]``.  No gradient
    flows to ``bias``.  ``dropout_rate`` in [0, 1) applies attention
    dropout inside the kernels and then needs ``dropout_seed``, which the
    caller changes per step."""
    rate = _drop.check_rate(dropout_rate, dropout_seed)
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    if bias is not None:
        bias = _as_bias2d(bias.detach(), b * h, tk).float().contiguous()
    o = _FlashAttention.apply(
        q.reshape(b * h, tq, dh).contiguous(),
        k.reshape(b * h, tk, dh).contiguous(),
        v.reshape(b * h, tk, dh).contiguous(),
        bias, bool(causal), float(sm_scale), rate, dropout_seed)
    return o.reshape(b, h, tq, dh)
