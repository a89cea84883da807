"""Weight-decay regularization, as far as ``Optimizer.apply_gradients``
needs it without a regularizer (mirrors ``paddle_tpu/regularizer.py``
``append_regularization_ops`` :56).  ``L1Decay``/``L2Decay`` are not
ported yet: asking for one raises (ROADMAP.md, Queue A)."""

__all__ = ["append_regularization_ops"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    """The no-regularizer path: the pairs unchanged; an optimizer or a
    parameter with a regularizer raises."""
    regularized = [p.name for p, _g in parameters_and_grads
                   if getattr(p, "regularizer", None) is not None]
    if regularization is not None or regularized:
        raise NotImplementedError(
            "weight-decay regularizers are not ported yet (ROADMAP.md, "
            "Queue A: clipping and regularizers); asked for by %s"
            % ("the optimizer" if regularization is not None
               else ", ".join(regularized)))
    return list(parameters_and_grads)
