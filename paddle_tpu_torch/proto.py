"""Program serialization (mirrors ``paddle_tpu/proto.py``).

The same JSON-shaped dict, ProgramDesc ⊃ BlockDesc ⊃ {VarDesc, OpDesc},
and the same keys, so a program exported by the reference package loads
here unchanged and the other way round."""

import json

import numpy as np

from .framework import Program, Parameter

FORMAT_VERSION = 1


def _attr_to_jsonable(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _attr_from_jsonable(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    return v


def program_to_dict(program):
    blocks = []
    for b in program.blocks:
        vars_ = []
        for v in b.vars.values():
            vars_.append({
                "name": v.name,
                "shape": list(v.shape) if v.shape is not None else None,
                "dtype": v.dtype,
                "lod_level": v.lod_level,
                "persistable": v.persistable,
                "stop_gradient": v.stop_gradient,
                "is_data": v.is_data,
                "is_parameter": isinstance(v, Parameter),
                "trainable": getattr(v, "trainable", False),
                "need_check_feed": getattr(v, "need_check_feed", False),
                "feed_hint": getattr(v, "feed_hint", None),
            })
        ops = []
        for op in b.ops:
            ops.append({
                "type": op.type,
                "inputs": op.inputs,
                "outputs": op.outputs,
                "attrs": {k: _attr_to_jsonable(v) for k, v in op.attrs.items()},
            })
        blocks.append({
            "idx": b.idx,
            "parent_idx": b.parent_idx,
            "vars": vars_,
            "ops": ops,
        })
    return {"version": FORMAT_VERSION, "blocks": blocks,
            "random_seed": program.random_seed}


def program_from_dict(d):
    from .framework import Block, Operator, Variable

    p = Program()
    p.random_seed = d.get("random_seed", 0)
    p.blocks = []
    for bd in d["blocks"]:
        p.blocks.append(Block(p, bd["idx"], bd.get("parent_idx", -1)))
    for bd, b in zip(d["blocks"], p.blocks):
        for vd in bd["vars"]:
            if vd.get("is_parameter"):
                v = Parameter(
                    b, shape=vd["shape"], dtype=vd["dtype"], name=vd["name"],
                    trainable=vd.get("trainable", True),
                )
            else:
                v = Variable(
                    b, name=vd["name"], shape=vd["shape"], dtype=vd["dtype"],
                    lod_level=vd.get("lod_level", 0),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    is_data=vd.get("is_data", False),
                    # saves without the key: data vars always check feeds
                    need_check_feed=vd.get(
                        "need_check_feed", vd.get("is_data", False)),
                )
                v.feed_hint = vd.get("feed_hint")
            b.vars[v.name] = v
        for od in bd["ops"]:
            b.ops.append(Operator(
                b, od["type"],
                {k: list(v) for k, v in od["inputs"].items()},
                {k: list(v) for k, v in od["outputs"].items()},
                {k: _attr_from_jsonable(v) for k, v in od["attrs"].items()},
            ))
    p.current_block_idx = 0
    p._bump_version()
    return p


def save_program(program, path):
    with open(path, "w") as f:
        json.dump(program_to_dict(program), f)


def load_program(path):
    with open(path) as f:
        return program_from_dict(json.load(f))
