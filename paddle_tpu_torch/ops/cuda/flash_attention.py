"""Flash attention forward: a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/flash_attention.py``
(``_flash_fwd`` at :235, ``pallas_call`` at :266, body ``_fwd_kernel`` at
:152): FlashAttention-2
blocked online softmax over q/k/v ``[B·H, T, Dh]`` with an additive key
bias ``[B, Tk]`` broadcast over heads, an optional causal mask, f32
statistics, and the row max ``m`` and row sum ``l`` saved separately for
the backward of the training slice.  Masked keys (causal, or past a
ragged ``Tk``) contribute nothing, so a row with no visible key (every
key biased to -inf) returns 0 — the ``l == 0`` guard of the TPU kernel.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors (or
raises) and runs :func:`flash_attention_fwd_plain` for CPU tensors and
for ``meta`` tensors during shape inference.  Dropout inside the kernel
comes with the training slice: a rate > 0 raises here.
"""

import math
import os

import torch

from . import _lib

NEG_INF = -1e30
MAX_HEAD_DIM = 128
KERNEL = "flash_attention_fwd"


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


def flash_attention_fwd_plain(q, k, v, bias=None, causal=False, sm_scale=1.0):
    """The kernel's function, unblocked: q [BH,Tq,Dh], k/v [BH,Tk,Dh],
    bias [B,Tk] f32 → (o [BH,Tq,Dh] in q's dtype, m [BH,Tq] f32,
    l [BH,Tq] f32).  Computed in f32 like the kernel, with p rounded to
    v's dtype before the PV product; a row that sees no key gives o = 0
    and l = 1, as the kernel."""
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
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l[..., None]
    return o.to(q.dtype), m, l


def _check(q, k, v, bias, dropout_rate):
    if dropout_rate:
        raise NotImplementedError(
            "in-kernel attention dropout comes with the training slice "
            "(ROADMAP.md, K1 backward); serving runs at rate 0")
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


def flash_attention_fwd(q, k, v, bias=None, causal=False, sm_scale=None,
                        dropout_rate=0.0):
    """q [BH,Tq,Dh], k/v [BH,Tk,Dh], bias [B,Tk] or [B,1,1,Tk] →
    (o, m, l).  CUDA tensors launch the kernel; CPU and meta tensors run
    the plain version."""
    _check(q, k, v, bias, dropout_rate)
    bh, tq, dh = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(dh)
    bias = _as_bias2d(bias, bh, tk)
    if q.device.type != "cuda":
        return flash_attention_fwd_plain(q, k, v, bias, causal, sm_scale)
    if not 1 <= dh <= MAX_HEAD_DIM or bh == 0 or tq == 0 or tk == 0:
        raise ValueError("flash_attention_fwd kernel takes non-empty q/k/v "
                         "with 1 <= Dh <= %d, got q %s, k %s"
                         % (MAX_HEAD_DIM, tuple(q.shape), tuple(k.shape)))
    code = _lib.dtype_code(q, KERNEL)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError("flash_attention_fwd: %s must be contiguous" % name)
    heads = 1
    if bias is not None:
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            raise TypeError("flash_attention_fwd: bias must be contiguous "
                            "float32, got %s" % bias.dtype)
        heads = bh // bias.shape[0]
    o = torch.empty_like(q)
    m = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    fn = _lib.lib().pt_flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             o.data_ptr(), m.data_ptr(), l.data_ptr(),
             bh, heads, tq, tk, dh, float(sm_scale), int(bool(causal)), code,
             _lib.stream_handle(q.device))
    _lib.check(err, KERNEL)
    _lib.count_launch(KERNEL)
    return o, m, l


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    dropout_rate=0.0):
    """Multi-head attention over ``[B, H, T, Dh]`` tensors (the reference's
    public ``flash_attention``); returns ``[B, H, Tq, Dh]``."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    o, _m, _l = flash_attention_fwd(
        q.reshape(b * h, tq, dh).contiguous(),
        k.reshape(b * h, tk, dh).contiguous(),
        v.reshape(b * h, tk, dh).contiguous(),
        bias, causal, sm_scale, dropout_rate)
    return o.reshape(b, h, tq, dh)
