"""Optimizer updates in place: hand-written CUDA kernels for Hopper
(``csrc/optimizer.cu``) and their plain PyTorch versions.

Mirrors the update ops of ``paddle_tpu/ops/optimizer_ops.py`` (``sgd``
:22, ``momentum`` :28-43, ``adam`` :46-77, ``fused_sgd`` :347-363,
``fused_adam`` :366-435), which XLA fuses into the jitted step and whose
buffers the step donates.  Here each update writes ParamOut into Param
and the moments, the velocity and the beta powers into their inputs:

- :func:`adam_`, :func:`momentum_`, :func:`sgd_`: one parameter, one
  launch (Adam a second, one-thread launch that advances the beta
  powers after the update, so no block reads an advanced power);
- :func:`multi_adam_`, :func:`multi_sgd_`: every member of a fused op in
  one launch per chunk of members (:data:`CHUNK`; each chunk counts as a
  launch), whose pointers go to the kernel as arguments by value; each
  member's bias correction from its own beta powers.  Nothing is
  concatenated.

LearningRate and the beta powers are read through device pointers, so a
CUDA graph captures an update as it is.  The state a kernel writes must be
contiguous; a gradient in another memory layout (cuDNN's channels-last
weight gradient of an NHWC convolution) is made contiguous first.  On the card a wrapper given CUDA
tensors launches its kernel (or raises); for CPU and meta tensors it
runs the plain version (``*_plain``, the functional bodies, which return
new tensors) and copies the results into the inputs, so the update is in
place on every device.  The kernels round as the plain versions' PyTorch
ops do, one rounding per op, so the two agree bit for bit on the card.
"""

import ctypes

import torch

from . import _lib

ADAM, MOMENTUM, SGD = "adam_update", "momentum_update", "sgd_update"
MULTI_ADAM, MULTI_SGD = "multi_tensor_adam", "multi_tensor_sgd"
# members of one multi-tensor launch (kMaxAdam, kMaxSgd in csrc)
CHUNK = {MULTI_ADAM: 56, MULTI_SGD: 128}


def _lr(lr, dtype):
    return lr.reshape(()).to(dtype)


def sgd_plain(param, grad, lr):
    """``param - lr * grad`` in the parameter's dtype (a new tensor)."""
    return param - _lr(lr, param.dtype) * grad.to(param.dtype)


def _mu(mu, dtype):
    """``mu`` rounded to the parameter's dtype, as the reference casts it
    (``optimizer_ops.py:36``), as a Python float."""
    return float(torch.tensor(float(mu), dtype=dtype))


def momentum_plain(param, grad, velocity, lr, mu=0.9, nesterov=False):
    """``v = mu * v + g``; Nesterov ``p - (g + mu * v) * lr``, else
    ``p - lr * v`` → (new param, new velocity), every op in the
    parameter's dtype."""
    mu = _mu(mu, param.dtype)
    lr = _lr(lr, param.dtype)
    g = grad.to(param.dtype)
    v = mu * velocity + g
    if nesterov:
        p = param - (g + mu * v) * lr
    else:
        p = param - lr * v
    return p, v


def adam_plain(param, grad, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999,
               eps=1e-8):
    """The reference's Adam in float32 → (param, m1, m2, b1p, b2p), new
    tensors in the inputs' dtypes.  ``b1p``/``b2p`` hold beta^t when
    read; ``lr_t = lr * sqrt(1 - b2p) / (1 - b1p)``, eps added to
    ``sqrt(m2)``."""
    lr = _lr(lr, torch.float32)
    g = grad.float()
    m1n = beta1 * m1.float() + (1 - beta1) * g
    m2n = beta2 * m2.float() + (1 - beta2) * torch.square(g)
    b1 = b1p.reshape(()).float()
    b2 = b2p.reshape(()).float()
    lr_t = lr * torch.sqrt(1 - b2) / (1 - b1)
    p = param.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return (p.to(param.dtype), m1n.to(m1.dtype), m2n.to(m2.dtype),
            (b1 * beta1).reshape(b1p.shape).to(b1p.dtype),
            (b2 * beta2).reshape(b2p.shape).to(b2p.dtype))


def _copy_into(dsts, srcs):
    for d, s in zip(dsts, srcs):
        d.copy_(s)


def _codes(kernel, *tensors):
    return [_lib.dtype_code(t, kernel) for t in tensors]


def _check(kernel, params, same_shape, scalars):
    """Every tensor on the parameter's CUDA device and contiguous; the
    ``same_shape`` ones of the parameter's element count; the ``scalars``
    of one element."""
    dev = params[0].device
    for t in list(params) + list(same_shape) + list(scalars):
        if t.device != dev:
            raise ValueError("%s: tensors on %s and %s"
                             % (kernel, dev, t.device))
        if not t.is_contiguous():
            raise ValueError("%s takes contiguous tensors" % kernel)
    n = params[0].numel()
    for t in same_shape:
        if t.numel() != n:
            raise ValueError("%s: %d elements against the parameter's %d"
                             % (kernel, t.numel(), n))
    for t in scalars:
        if t.numel() != 1:
            raise ValueError("%s: a scalar input has %d elements"
                             % (kernel, t.numel()))
    if n == 0:
        raise ValueError("%s takes a non-empty parameter" % kernel)


def sgd_(param, grad, lr):
    """SGD on ``param`` in place; returns ``param``."""
    if param.device.type != "cuda":
        param.copy_(sgd_plain(param, grad, lr))
        return param
    grad = grad.contiguous()
    _check(SGD, [param], [grad], [lr])
    err = _lib.lib().pt_sgd_update(
        param.data_ptr(), grad.data_ptr(), lr.data_ptr(), param.numel(),
        *_codes(SGD, param, grad, lr), _lib.stream_handle(param.device))
    _lib.check(err, SGD)
    _lib.count_launch(SGD)
    return param


def momentum_(param, grad, velocity, lr, mu=0.9, nesterov=False):
    """Momentum on ``param`` and ``velocity`` in place; returns them."""
    if param.device.type != "cuda":
        _copy_into((param, velocity),
                   momentum_plain(param, grad, velocity, lr, mu, nesterov))
        return param, velocity
    if velocity.dtype != param.dtype:
        raise TypeError("%s: the velocity is %s, the parameter %s"
                        % (MOMENTUM, velocity.dtype, param.dtype))
    grad = grad.contiguous()
    _check(MOMENTUM, [param], [grad, velocity], [lr])
    err = _lib.lib().pt_momentum_update(
        param.data_ptr(), grad.data_ptr(), velocity.data_ptr(),
        lr.data_ptr(), param.numel(), *_codes(MOMENTUM, param, grad, lr),
        _mu(mu, param.dtype), int(bool(nesterov)),
        _lib.stream_handle(param.device))
    _lib.check(err, MOMENTUM)
    _lib.count_launch(MOMENTUM)
    return param, velocity


def _adam_hyper(beta1, beta2, eps):
    # 1 - beta rounded from the double, as PyTorch casts a Python scalar
    return (float(beta1), 1.0 - float(beta1), float(beta2),
            1.0 - float(beta2), float(eps))


def adam_(param, grad, lr, m1, m2, b1p, b2p, beta1=0.9, beta2=0.999,
          eps=1e-8):
    """Adam on ``param``, the moments and the beta powers in place;
    returns them."""
    outs = (param, m1, m2, b1p, b2p)
    if param.device.type != "cuda":
        _copy_into(outs, adam_plain(param, grad, lr, m1, m2, b1p, b2p,
                                    beta1, beta2, eps))
        return outs
    if m1.dtype != m2.dtype:
        raise TypeError("%s: the moments are %s and %s"
                        % (ADAM, m1.dtype, m2.dtype))
    if b1p.dtype != b2p.dtype:
        raise TypeError("%s: the beta powers are %s and %s"
                        % (ADAM, b1p.dtype, b2p.dtype))
    grad = grad.contiguous()
    _check(ADAM, [param], [grad, m1, m2], [lr, b1p, b2p])
    err = _lib.lib().pt_adam_update(
        param.data_ptr(), grad.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        lr.data_ptr(), b1p.data_ptr(), b2p.data_ptr(), param.numel(),
        *_codes(ADAM, param, grad, m1, lr, b1p),
        *_adam_hyper(beta1, beta2, eps), _lib.stream_handle(param.device))
    _lib.check(err, ADAM)
    _lib.count_launch(ADAM)
    return outs


def _same(kernel, what, tensors):
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError("%s: the members' %s differ in dtype: %s"
                        % (kernel, what, sorted(map(str, dtypes))))
    return tensors[0]


def _array(ctype, values):
    """A host array for a C entry point, as one pointer argument (the
    entry point copies it into the launches' arguments) and the array,
    which must live until the call returns."""
    arr = (ctype * len(values))(*values)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _ptrs(tensors):
    return _array(ctypes.c_void_p, [t.data_ptr() for t in tensors])


def _count_chunks(kernel, members):
    for _ in range(-(-members // CHUNK[kernel])):
        _lib.count_launch(kernel)


def _distinct(kernel, what, tensors):
    ptrs = [t.data_ptr() for t in tensors]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("%s: two members share a %s tensor; each is "
                         "written once" % (kernel, what))


def _check_members(kernel, params, *others, scalars=()):
    if not params:
        raise ValueError("%s takes at least one member" % kernel)
    for i, p in enumerate(params):
        _check(kernel, [p], [o[i] for o in others],
               [s[i] for s in scalars])


def multi_sgd_(params, grads, lr):
    """SGD on every member in place (one launch per chunk); returns the
    parameters."""
    if params[0].device.type != "cuda":
        for p, g in zip(params, grads):
            p.copy_(sgd_plain(p, g, lr))
        return list(params)
    grads = [g.contiguous() for g in grads]
    _check_members(MULTI_SGD, params, grads)
    _check(MULTI_SGD, [params[0]], [], [lr])
    _distinct(MULTI_SGD, "parameter", params)
    arrays = [_ptrs(params), _ptrs(grads),
              _array(ctypes.c_longlong, [p.numel() for p in params])]
    err = _lib.lib().pt_multi_sgd_update(
        *[a[0] for a in arrays], len(params), lr.data_ptr(),
        *_codes(MULTI_SGD, _same(MULTI_SGD, "parameters", params),
                _same(MULTI_SGD, "gradients", grads), lr),
        _lib.stream_handle(params[0].device))
    _lib.check(err, MULTI_SGD)
    _count_chunks(MULTI_SGD, len(params))
    return list(params)


def multi_adam_(params, grads, lr, m1s, m2s, b1ps, b2ps, beta1=0.9,
                beta2=0.999, eps=1e-8):
    """Adam on every member in place, each with its own beta powers (one
    update launch and one beta-power launch per chunk); returns the five
    lists."""
    outs = [list(params), list(m1s), list(m2s), list(b1ps), list(b2ps)]
    if params[0].device.type != "cuda":
        for i, p in enumerate(params):
            _copy_into([o[i] for o in outs],
                       adam_plain(p, grads[i], lr, m1s[i], m2s[i], b1ps[i],
                                  b2ps[i], beta1, beta2, eps))
        return outs
    grads = [g.contiguous() for g in grads]
    _check_members(MULTI_ADAM, params, grads, m1s, m2s,
                   scalars=(b1ps, b2ps))
    _check(MULTI_ADAM, [params[0]], [], [lr])
    for what, ts in (("parameter", params), ("moment", list(m1s) + list(m2s)),
                     ("beta power", list(b1ps) + list(b2ps))):
        _distinct(MULTI_ADAM, what, ts)
    moment = _same(MULTI_ADAM, "moments", list(m1s) + list(m2s))
    power = _same(MULTI_ADAM, "beta powers", list(b1ps) + list(b2ps))
    arrays = [_ptrs(ts) for ts in (params, grads, m1s, m2s, b1ps, b2ps)]
    arrays.append(_array(ctypes.c_longlong, [p.numel() for p in params]))
    err = _lib.lib().pt_multi_adam_update(
        *[a[0] for a in arrays], len(params), lr.data_ptr(),
        *_codes(MULTI_ADAM, _same(MULTI_ADAM, "parameters", params),
                _same(MULTI_ADAM, "gradients", grads), moment, lr, power),
        *_adam_hyper(beta1, beta2, eps), _lib.stream_handle(params[0].device))
    _lib.check(err, MULTI_ADAM)
    _count_chunks(MULTI_ADAM, len(params))
    return outs
