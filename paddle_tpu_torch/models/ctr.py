"""CTR models: Wide&Deep and DeepFM (mirrors ``paddle_tpu/models/ctr.py``,
all of it; BASELINE config 5, the reference's ``dist_ctr.py`` model).

Each categorical slot is a padded [B, L] int64 tensor (0 is the padding
id).  On device tables every slot is a ``lookup_table`` with
``padding_idx=0`` whose gradient is a dense table gradient; where the
table's width passes the fusion's ``embedding_gather`` gate (a
lane-aligned dim, a slab of at least 4096 bytes: DeepFM's dim-128
``fm_emb_*`` tables) the lookup becomes ``fused_embedding_gather``, the
K3 forward and backward kernels; the dim-1 ``fm_first_*`` tables and
Wide&Deep's dim-16 tables stay plain lookups, in both packages.
``is_distributed=True`` is accepted and changes nothing on one card, as
in the reference on one device.  ``use_host_table`` keeps DeepFM's
tables in host memory (:mod:`paddle_tpu_torch.host_table`), trained by
their own sparse SGD at ``host_lr``.

The ``run_*`` recipes run on the card unless ``place`` is
``CPUPlace()``."""

import numpy as np

import paddle_tpu_torch as fluid

from ..layers import ops as _ops


def _host_slot_embed_sum(slot, vocab, dim, name, lr=0.01):
    """A slot's host-table embedding summed over its ids, masked so that
    padding id 0 adds nothing (the device path's ``padding_idx=0``)."""
    slab = fluid.layers.host_embedding(slot, size=[vocab, dim], name=name,
                                       lr=lr)
    zero = fluid.layers.fill_constant([1], "int64", 0)
    mask = fluid.layers.cast(fluid.layers.not_equal(slot, zero), "float32")
    masked = fluid.layers.elementwise_mul(
        slab, fluid.layers.unsqueeze(mask, [2]))
    return fluid.layers.reduce_sum(masked, dim=1)  # [B, dim]


def _slot_embed_sum(slot, vocab, dim, name, is_sparse=True,
                    is_distributed=False):
    emb = fluid.layers.embedding(
        slot, size=[vocab, dim], is_sparse=is_sparse,
        is_distributed=is_distributed, padding_idx=0,
        param_attr=fluid.ParamAttr(
            name=name,
            initializer=fluid.initializer.Uniform(-0.01, 0.01)))
    return fluid.layers.reduce_sum(emb, dim=1)  # [B, dim]


def wide_deep(slots, dense, label, vocab=100000, embed_dim=16,
              hidden=(400, 400, 400), is_distributed=False, is_sparse=True):
    """Wide (linear over slots) + Deep (MLP over embeddings + dense)."""
    deep_in = [
        _slot_embed_sum(s, vocab, embed_dim, "deep_emb_%d" % i,
                        is_sparse=is_sparse, is_distributed=is_distributed)
        for i, s in enumerate(slots)]
    if dense is not None:
        deep_in.append(dense)
    x = fluid.layers.concat(deep_in, axis=1)
    for h in hidden:
        x = fluid.layers.fc(x, size=h, act="relu")
    deep_logit = fluid.layers.fc(x, size=1)
    wide_terms = [
        _slot_embed_sum(s, vocab, 1, "wide_emb_%d" % i,
                        is_sparse=is_sparse, is_distributed=is_distributed)
        for i, s in enumerate(slots)]
    wide_logit = fluid.layers.sums(wide_terms)
    if dense is not None:
        wide_logit = fluid.layers.elementwise_add(
            wide_logit, fluid.layers.fc(dense, size=1))
    logit = fluid.layers.elementwise_add(deep_logit, wide_logit)
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(
            logit, fluid.layers.cast(label, "float32")))
    return loss, _ops.sigmoid(logit)


def deepfm(slots, label, vocab=100000, embed_dim=16, hidden=(400, 400),
           is_distributed=False, use_host_table=False, host_lr=0.01):
    """DeepFM: first-order linear + second-order FM interactions + deep
    MLP, all sharing the slot embeddings."""
    embs = []     # [B, dim] per slot (summed over its ids)
    firsts = []   # [B, 1] per slot
    for i, s in enumerate(slots):
        if use_host_table:
            embs.append(_host_slot_embed_sum(
                s, vocab, embed_dim, "fm_emb_%d" % i, lr=host_lr))
            firsts.append(_host_slot_embed_sum(
                s, vocab, 1, "fm_first_%d" % i, lr=host_lr))
            continue
        e = fluid.layers.embedding(
            s, size=[vocab, embed_dim], is_sparse=True, padding_idx=0,
            is_distributed=is_distributed,
            param_attr=fluid.ParamAttr(
                name="fm_emb_%d" % i,
                initializer=fluid.initializer.Uniform(-0.01, 0.01)))
        embs.append(fluid.layers.reduce_sum(e, dim=1))  # [B, dim]
        firsts.append(_slot_embed_sum(s, vocab, 1, "fm_first_%d" % i,
                                      is_distributed=is_distributed))
    first_order = fluid.layers.sums(firsts)  # [B, 1]
    # FM second order: 0.5 * ((sum v)^2 - sum v^2), summed over dim
    stacked = fluid.layers.stack(embs, axis=1)  # [B, S, dim]
    sum_v = fluid.layers.reduce_sum(stacked, dim=1)
    sum_sq = fluid.layers.reduce_sum(
        fluid.layers.elementwise_mul(stacked, stacked), dim=1)
    second = fluid.layers.reduce_sum(
        fluid.layers.elementwise_sub(
            fluid.layers.elementwise_mul(sum_v, sum_v), sum_sq),
        dim=1, keep_dim=True)
    second = fluid.layers.scale(second, scale=0.5)
    x = fluid.layers.concat(embs, axis=1)
    for h in hidden:
        x = fluid.layers.fc(x, size=h, act="relu")
    deep_logit = fluid.layers.fc(x, size=1)
    logit = fluid.layers.sums([first_order, second, deep_logit])
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(
            logit, fluid.layers.cast(label, "float32")))
    return loss, _ops.sigmoid(logit)


def build(model="wide_deep", num_slots=8, slot_len=4, dense_dim=13,
          vocab=100000, lr=1e-3, is_distributed=False,
          use_host_table=False, host_lr=0.01, embed_dim=16):
    """Returns (main, startup, feed_vars, loss, prob)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        slots = [fluid.layers.data("slot_%d" % i, shape=[slot_len],
                                   dtype="int64")
                 for i in range(num_slots)]
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        feeds = list(slots) + [label]
        if model == "wide_deep":
            if use_host_table:
                raise ValueError(
                    "use_host_table is implemented for model='deepfm' "
                    "only; wide_deep still uses device tables")
            dense = fluid.layers.data("dense", shape=[dense_dim],
                                      dtype="float32")
            feeds.append(dense)
            loss, prob = wide_deep(slots, dense, label, vocab,
                                   is_distributed=is_distributed)
        else:
            loss, prob = deepfm(slots, label, vocab, embed_dim=embed_dim,
                                is_distributed=is_distributed,
                                use_host_table=use_host_table,
                                host_lr=host_lr)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, feeds, loss, prob


def _fixed_feed(seed, num_slots, slot_len, vocab, batch):
    rng = np.random.RandomState(seed)
    feed = {"slot_%d" % i:
            rng.randint(0, vocab, (batch, slot_len)).astype("int64")
            for i in range(num_slots)}
    feed["label"] = rng.randint(0, 2, (batch, 1)).astype("int64")
    return feed


def run_deepfm_device_table_steps(steps=5, num_slots=4, slot_len=3,
                                  vocab=100000, batch=16, embed_dim=128,
                                  seed=8, place=None):
    """DeepFM on device tables (dim 128: the lookups become
    ``fused_embedding_gather``), ``steps`` Adam steps on one seeded batch
    → (the losses, the FusionReport of the program that ran)."""
    from ..executor import Scope, scope_guard
    from ..static_analysis import fusion

    fluid.unique_name.switch()
    main, startup, feeds, loss, prob = build(
        model="deepfm", num_slots=num_slots, slot_len=slot_len,
        vocab=vocab, embed_dim=embed_dim, use_host_table=False)
    _, report = fusion.resolve_fused_program(main, targets=[loss.name])
    feed = _fixed_feed(seed, num_slots, slot_len, vocab, batch)
    exe = fluid.Executor(place)
    losses = []
    with scope_guard(Scope()):
        exe.run(startup)
        for _ in range(steps):
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(())))
    return losses, report


def run_deepfm_host_table_steps(steps=5, data_parallel=False, places=None,
                                num_slots=4, slot_len=3, vocab=100000,
                                batch=16, host_lr=0.05, seed=8, place=None):
    """DeepFM on host tables, ``steps`` steps on one seeded batch → the
    losses; ``data_parallel`` runs through
    ``CompiledProgram.with_data_parallel`` over ``places``."""
    from .. import host_table
    from ..executor import Scope, scope_guard

    host_table.reset_tables()
    fluid.unique_name.switch()
    main, startup, feeds, loss, prob = build(
        model="deepfm", num_slots=num_slots, slot_len=slot_len,
        vocab=vocab, use_host_table=True, host_lr=host_lr)
    feed = _fixed_feed(seed, num_slots, slot_len, vocab, batch)
    exe = fluid.Executor(place)
    losses = []
    with scope_guard(Scope()):
        exe.run(startup)
        target = main
        if data_parallel:
            target = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, places=places)
        for _ in range(steps):
            (lv,) = exe.run(target, feed=feed, fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(())))
        for i in range(num_slots):
            host_table.get_table("fm_emb_%d" % i).join()
            host_table.get_table("fm_first_%d" % i).join()
    return losses
