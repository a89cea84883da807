"""Build, load and count the package's hand-written CUDA kernels.

Every ``paddle_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together), linked
into one shared library with a plain C interface, and loaded with
``ctypes``.  The library lives under ``paddle_tpu_torch/_build/<hash>/``,
keyed by a hash of the sources and flags, and is built at first use
only: importing this module compiles nothing, so CPU-only hosts (which
have no ``nvcc``) import the package freely.  Several processes may
load it at once (the ranks of a data-parallel job on one host): the
build holds an exclusive ``fcntl`` lock on ``_build/<hash>.lock``, the
first holder compiles into a temporary directory and renames the
finished library into place, and the others wait on the lock and load
what it built.

Each C entry point launches on the stream it is given and returns the
``cudaGetLastError()`` code of its launch; :func:`check` raises on a
non-zero code.  :data:`_LAUNCHES` holds one plain integer per kernel,
raised by one where the wrapper launches its kernel and nowhere else.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "fused_dropout_add_ln_fwd",
           "fused_dropout_add_ln_bwd", "embedding_gather_fwd",
           "flash_decode_fwd", "paged_flash_decode_fwd",
           "bn_act_epilogue_fwd", "bn_act_epilogue_bwd",
           "block_quantize", "block_dequantize")
_LAUNCHES = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
# the dropout arguments of every kernel that drops: mode, seed,
# threshold, keep scale (csrc/dropout.cuh)
_DROP = (_I, _U, _U, _F)
_SIGNATURES = {
    # q, k, v, bias, o, m, l, BH, H, Tq, Tk, Dh, scale, causal, dropout,
    # dtype, stream
    "pt_flash_attention_fwd": (_P,) * 7 + (_I,) * 5 + (_F, _I) + _DROP
    + (_I, _P),
    # q, k, v, bias, dout, m, l, delta, dk, dv, BH, H, Tq, Tk, Dh, scale,
    # causal, dropout, dtype, stream
    "pt_flash_attention_bwd_dkv": (_P,) * 10 + (_I,) * 5 + (_F, _I) + _DROP
    + (_I, _P),
    # q, k, v, bias, dout, m, l, delta, dq, then as dK/dV
    "pt_flash_attention_bwd_dq": (_P,) * 9 + (_I,) * 5 + (_F, _I) + _DROP
    + (_I, _P),
    # x, res, gamma, beta, out, y, mean, rstd, N, D, eps, dropout, dtype,
    # stream
    "pt_fused_add_ln_fwd": (_P,) * 8 + (_L, _I, _F) + _DROP + (_I, _P),
    # dout, y, gamma, mean, rstd, dx, dres, part_g, part_b, dgamma, dbeta,
    # N, D, partial rows, dropout, dtype, stream
    "pt_fused_add_ln_bwd": (_P,) * 11 + (_L, _I, _I) + _DROP + (_I, _P),
    # N, D, dtype → rows of the backward's partials (negated cudaError_t
    # on failure)
    "pt_fused_add_ln_bwd_blocks": (_L, _I, _I),
    # table, ids, out, n, V, D, padding_idx, ids_are_int64, dtype, stream
    "pt_embedding_gather_fwd": (_P, _P, _P, _L, _L, _I, _L, _I, _I, _P),
    # q, k, v, lengths, o, ws, counters, rows, H, Tmax, Dh, lengths'
    # stride, chunk, scale, dtype, stream
    "pt_flash_decode_fwd": (_P,) * 7 + (_I,) * 6 + (_F, _I, _P),
    # q, k, v, lengths, table, o, ws, counters, rows, H, N, BL, MB, Dh,
    # lengths' stride, chunk, scale, dtype, stream
    "pt_paged_flash_decode_fwd": (_P,) * 8 + (_I,) * 8 + (_F, _I, _P),
    # paged, Dh, dtype → blocks an SM holds (negated cudaError_t)
    "pt_flash_decode_blocks_per_sm": (_I, _I, _I),
    # y, gamma, beta, mean, rstd, out, rows, C, act, dtype, stream
    "pt_bn_act_fwd": (_P,) * 6 + (_L, _I, _I, _I, _P),
    # rows, C, dtype → row tiles of the backward's partials
    "pt_bn_act_bwd_tiles": (_L, _I, _I),
    # dout, y, gamma, beta, mean, rstd, dy, part, dgamma, dbeta, dmean,
    # drstd, rows, C, act, dtype, stream
    "pt_bn_act_bwd": (_P,) * 12 + (_L, _I, _I, _I, _P),
    # x, q, scales, nblocks, block, stream
    "pt_block_quantize": (_P, _P, _P, _L, _I, _P),
    # q, scales, out, nblocks, block, dtype, stream
    "pt_block_dequantize": (_P, _P, _P, _L, _I, _I, _P),
}

def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "paddle_tpu_torch are built from csrc/ at first use on a GPU host")


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path():
    return os.path.join(BUILD_ROOT, source_hash(), "libpaddle_tpu_kernels.so")


def build(verbose=False):
    """Compile every ``csrc/*.cu`` (in parallel) and link them into the
    shared library; return its path.  A finished build is reused."""
    return build_once(library_path(),
                      lambda work: _compile(work, verbose))


def build_once(out, make):
    """``out`` if it exists, else ``make(work)``'s file renamed to it.

    ``make`` builds into the fresh directory ``work`` and returns the
    path of what it built there, a sibling of ``out``'s directory.  An
    exclusive lock on that directory's name plus ``.lock`` serialises
    builders across processes: the first builds, the rest wait and find
    ``out`` done.  The rename is atomic, so a reader that takes no lock
    still sees all of the file or none of it."""
    if os.path.exists(out):
        return out
    root = os.path.dirname(os.path.dirname(out))
    os.makedirs(root, exist_ok=True)
    with open(os.path.dirname(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out
            work = tempfile.mkdtemp(prefix="build-", dir=root)
            try:
                built = make(work)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                os.replace(built, out)
            finally:
                shutil.rmtree(work, ignore_errors=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _compile(work, verbose):
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    procs = []
    for src in cus:
        obj = os.path.join(work, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs = []
    for src, _obj, p in procs:
        text = p.communicate()[0].decode(errors="replace")
        logs.append(text)
        if p.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (src, text))
    so = os.path.join(work, "libpaddle_tpu_kernels.so")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", so] + [o for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n%s"
                           % link.stdout.decode(errors="replace"))
    if verbose:
        print("".join(logs))
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(code, kernel):
    if code != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (kernel, code))


def count_launch(kernel):
    _LAUNCHES[kernel] += 1


def launch_counts():
    return dict(_LAUNCHES)


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def stream_handle(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t, kernel):
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError("%s takes float32 or bfloat16 tensors, got %s"
                        % (kernel, t.dtype))
    return codes[t.dtype]
