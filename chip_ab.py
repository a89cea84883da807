#!/usr/bin/env python3
"""Compare two checkouts of the port on one card, in turns.

    python3 chip_ab.py PARENT_DIR EXPR [EXPR ...]

Runs the ``EXPR`` arguments four times, each time in a fresh process:
with the ``paddle_tpu_torch`` package of ``PARENT_DIR`` ("parent"), of
this checkout ("change"), of this checkout again, and of ``PARENT_DIR``
again, so both versions meet the same card, clocks and neighbours.  The
measurement code is always this checkout's ``chip_smoke.py``, bound to
``c``; each process first runs ``c.phase_environment()`` (bound to
``env``) and ``c.phase_build()``, which builds that package's kernels
from its own ``csrc/``, with TF32 off as in ``chip_smoke.main``.  For
example::

    python3 chip_ab.py .smoke_tmp/parent "c.phase_train(env)"
    python3 chip_ab.py .smoke_tmp/parent \\
        "c.emit(c.profile_ln_bwd(torch, c._gen(torch)))"

Every line a run prints goes to standard output with its label in front
(``parent`` or ``change``).  Exits non-zero if any run failed.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

_RUN = """
import importlib.util, sys
sys.path.insert(0, {tree!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {smoke!r})
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
env = c.phase_environment()
c.phase_build()
for expr in {exprs!r}:
    eval(expr)
"""


def run(tree, label, exprs):
    code = _RUN.format(tree=os.path.abspath(tree),
                       smoke=os.path.join(HERE, "chip_smoke.py"),
                       exprs=list(exprs))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            cwd=os.path.abspath(tree),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        print(label, line.rstrip("\n"), flush=True)
    return proc.wait()


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, exprs = argv[0], argv[1:]
    if not os.path.isdir(os.path.join(parent, "paddle_tpu_torch", "csrc")):
        print("chip_ab: %s holds no paddle_tpu_torch/csrc" % parent,
              file=sys.stderr)
        return 2
    rcs = [run(tree, label, exprs)
           for tree, label in ((parent, "parent"), (HERE, "change"),
                               (HERE, "change"), (parent, "parent"))]
    print("chip_ab: exit codes (parent, change, change, parent) %s" % rcs)
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
