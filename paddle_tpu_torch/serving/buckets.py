"""Shape buckets: the serving-side batch-shape discipline.

A copy of ``paddle_tpu/serving/buckets.py`` (the port imports nothing of
the reference package).  Serving traffic runs through a SMALL FIXED SET
of padded batch sizes: a request batch of ``n`` rows is padded up to the
smallest bucket ``>= n`` (by repeating its last row — always a valid row,
so int id feeds stay in-vocab) and the real rows are sliced back out of
the fetch results.  The reference bounds its jit cache this way; the
port keeps the same discipline so the two serve identical batch shapes
(and a CUDA-graph step, a later slice, needs it too).

The bucket set comes from, in priority order: an explicit argument, the
``PADDLE_TPU_SERVING_BUCKETS`` env override (``"1,2,4,8"``), or a
derivation from observed traffic (:func:`derive_buckets`).
"""

import os

import numpy as np

__all__ = [
    "BUCKETS_ENV",
    "BUCKET_CAP_ENV",
    "SEQ_BUCKETS_ENV",
    "DEFAULT_BUCKETS",
    "ShapeBuckets",
    "bucket_cap",
    "derive_buckets",
    "parse_buckets",
    "resolve_buckets",
]

BUCKETS_ENV = "PADDLE_TPU_SERVING_BUCKETS"
BUCKET_CAP_ENV = "PADDLE_TPU_SERVING_BUCKET_CAP"
# optional second bucket axis: padded sequence (prompt) lengths for
# decode tenants — each (batch, seq) pair is one jit signature
SEQ_BUCKETS_ENV = "PADDLE_TPU_SERVING_SEQ_BUCKETS"
DEFAULT_BUCKETS = (1, 2, 4, 8)


def bucket_cap(default=8):
    """Maximum number of buckets (== maximum distinct batch shapes per
    feed shape family).  Env-overridable via ``PADDLE_TPU_SERVING_BUCKET_CAP``."""
    try:
        cap = int(os.environ.get(BUCKET_CAP_ENV, default))
    except ValueError:
        cap = default
    return max(1, cap)


def parse_buckets(spec):
    """``"1,2,4,8"`` (or an iterable of ints) → sorted unique tuple."""
    if isinstance(spec, str):
        parts = [p for p in spec.replace(";", ",").split(",") if p.strip()]
        sizes = [int(p) for p in parts]
    else:
        sizes = [int(s) for s in spec]
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError("bucket sizes must be positive ints, got %r"
                         % (spec,))
    return tuple(sorted(set(sizes)))


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def derive_buckets(observed_sizes, cap=None, max_batch=None):
    """Derive a bucket set from observed request batch sizes.

    Each observed size is rounded up to the next power of two (padding
    waste < 2x worst case), then the unique sizes are thinned to ``cap``
    by keeping the smallest and largest and a geometric subsample in
    between — the ends bound waste for the extreme sizes, the interior
    keeps the padding ratio roughly uniform.
    """
    cap = bucket_cap() if cap is None else max(1, int(cap))
    sizes = sorted({_pow2_at_least(int(s)) for s in observed_sizes
                    if int(s) >= 1})
    if max_batch is not None:
        sizes = [s for s in sizes if s <= max_batch] or \
            [_pow2_at_least(int(max_batch))]
    if not sizes:
        return DEFAULT_BUCKETS[:cap]
    if len(sizes) <= cap:
        return tuple(sizes)
    # geometric subsample keeping both ends
    idx = np.unique(np.round(
        np.linspace(0, len(sizes) - 1, cap)).astype(int))
    return tuple(sizes[i] for i in idx)


def resolve_buckets(explicit=None, observed=None, cap=None, seq=None,
                    seq_observed=None):
    """Bucket-set precedence: explicit arg > env override > derived from
    observed traffic > :data:`DEFAULT_BUCKETS`.  Always returns a sorted
    tuple of at most ``cap`` sizes (explicit/env sets larger than the
    cap are rejected — a silent truncation would change which shapes
    compile).

    With a sequence-length axis requested — ``seq`` (explicit sizes),
    the ``PADDLE_TPU_SERVING_SEQ_BUCKETS`` env, or ``seq_observed``
    (observed prompt lengths) — the return value is the PAIR
    ``(batch_sizes, seq_sizes)``: a decode tenant's jit signatures
    cover (batch, prompt-length), one compile per pair.  With no seq
    signal at all the single-axis return is unchanged — existing
    callers never see the pair."""
    cap = bucket_cap() if cap is None else max(1, int(cap))
    if explicit is not None:
        sizes = parse_buckets(explicit)
    else:
        env = os.environ.get(BUCKETS_ENV)
        if env:
            sizes = parse_buckets(env)
        elif observed:
            sizes = derive_buckets(observed, cap=cap)
        else:
            sizes = DEFAULT_BUCKETS
    if len(sizes) > cap:
        raise ValueError(
            "bucket set %r exceeds the cap of %d buckets (raise %s or "
            "thin the set — every bucket is one jit signature)"
            % (sizes, cap, BUCKET_CAP_ENV))
    seq_env = os.environ.get(SEQ_BUCKETS_ENV)
    if seq is None and not seq_env and not seq_observed:
        return sizes
    if seq is not None:
        seq_sizes = parse_buckets(seq)
    elif seq_env:
        seq_sizes = parse_buckets(seq_env)
    else:
        seq_sizes = derive_buckets(seq_observed, cap=cap)
    if len(sizes) * len(seq_sizes) > cap * cap:
        raise ValueError(
            "bucket grid %r x %r exceeds %d signatures (every "
            "(batch, seq) pair is one jit compile)"
            % (sizes, seq_sizes, cap * cap))
    return sizes, seq_sizes


class ShapeBuckets:
    """The fixed bucket set plus the pad/slice mechanics.

    ``seq_sizes`` adds the optional second axis (padded prompt lengths
    for decode tenants); it stays None — and every existing behavior is
    untouched — unless a seq signal is given."""

    def __init__(self, sizes=None, observed=None, cap=None,
                 seq_sizes=None, seq_observed=None):
        resolved = resolve_buckets(explicit=sizes, observed=observed,
                                   cap=cap, seq=seq_sizes,
                                   seq_observed=seq_observed)
        if isinstance(resolved[0], tuple):
            self.sizes, self.seq_sizes = resolved
        else:
            self.sizes, self.seq_sizes = resolved, None

    @property
    def max_rows(self):
        return self.sizes[-1]

    def bucket_for(self, rows):
        """Smallest bucket that fits ``rows``; None when ``rows`` exceeds
        the largest bucket (the caller splits the batch)."""
        for s in self.sizes:
            if s >= rows:
                return s
        return None

    def bucket_for_seq(self, length):
        """Smallest sequence-length bucket that fits ``length``; None
        when it exceeds the largest (the caller truncates or rejects).
        Raises if no seq axis was configured."""
        if self.seq_sizes is None:
            raise ValueError(
                "no sequence-length axis configured (pass seq_sizes/"
                "seq_observed or set %s)" % SEQ_BUCKETS_ENV)
        for s in self.seq_sizes:
            if s >= length:
                return s
        return None

    @staticmethod
    def pad_seq(array, length, bucket, axis=1, value=0):
        """Pad ``array`` (dim ``axis`` == ``length``) up to ``bucket``
        along the sequence axis with ``value`` (decode programs mask by
        prompt_len, so the pad content never matters); no-op when
        already full."""
        if length == bucket:
            return array
        widths = [(0, 0)] * array.ndim
        widths[axis] = (0, bucket - length)
        return np.pad(array, widths, constant_values=value)

    @staticmethod
    def pad_rows(array, rows, bucket):
        """Pad ``array`` (leading dim == ``rows``) up to ``bucket`` rows
        by repeating the last real row; no-op when already full."""
        if rows == bucket:
            return array
        pad = np.repeat(array[rows - 1:rows], bucket - rows, axis=0)
        return np.concatenate([array[:rows], pad], axis=0)

    def pad_feed(self, feed, rows, bucket):
        """Pad every batch-leading array in a name→array feed dict."""
        return {n: self.pad_rows(v, rows, bucket)
                if getattr(v, "ndim", 0) >= 1 and v.shape[0] == rows
                else v
                for n, v in feed.items()}

    @staticmethod
    def slice_rows(outputs, start, stop, bucket):
        """Extract one request's rows from padded fetch results.  Outputs
        whose leading dim is not the bucket size (a scalar score, a
        reduced stat) are returned whole to every request."""
        out = []
        for o in outputs:
            if getattr(o, "ndim", 0) >= 1 and o.shape[0] == bucket:
                out.append(o[start:stop])
            else:
                out.append(o)
        return out

    def __repr__(self):
        return "ShapeBuckets(%s)" % (list(self.sizes),)
