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
non-zero code.

Launch counts.  A wrapper calls :func:`count_launch` where it launches
its kernel and nowhere else: :data:`_LAUNCHES` counts the launches that
run at once, :data:`_CAPTURED` those recorded into a CUDA graph being
captured, which run only when the graph is replayed.  A replay calls no
wrapper: :func:`graph_kernel_nodes` reads a captured graph's kernel
nodes through libcuda by device function name (:data:`KERNEL_FUNCTIONS`),
and the executor adds them to :data:`_REPLAYED` on every replay
(:func:`count_replay`).  :func:`launch_counts` is each kernel's launches
that ran, the sum of the two; :func:`launch_counts_by_source` keeps them
apart.
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
           "embedding_gather_bwd", "flash_decode_fwd",
           "paged_flash_decode_fwd", "bn_act_epilogue_fwd",
           "bn_act_epilogue_bwd", "block_quantize", "block_dequantize",
           "adam_update", "momentum_update", "sgd_update",
           "multi_tensor_adam", "multi_tensor_sgd")
_LAUNCHES = dict.fromkeys(KERNELS, 0)
_CAPTURED = dict.fromkeys(KERNELS, 0)
_REPLAYED = dict.fromkeys(KERNELS, 0)

# each kernel's device functions (the K2 and K4 backward wrappers' second
# launch, the partials' sum, is not counted, nor K3 backward's second, the
# long rows' sums (embedding_bwd_long_kernel), nor the Adam updates' second
# launch, which advances the beta powers: adam_pow_kernel,
# multi_adam_pow_kernel)
KERNEL_FUNCTIONS = {
    "flash_attention_fwd": ("flash_fwd_kernel",),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel",),
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel",),
    "fused_dropout_add_ln_fwd": ("add_ln_fwd_kernel",),
    "fused_dropout_add_ln_bwd": ("add_ln_bwd_kernel",),
    "embedding_gather_fwd": ("gather_kernel",),
    "embedding_gather_bwd": ("embedding_bwd_rows_kernel",),
    "flash_decode_fwd": ("decode_kernel",),
    "paged_flash_decode_fwd": ("paged_decode_kernel",),
    "bn_act_epilogue_fwd": ("bn_act_fwd_kernel",),
    "bn_act_epilogue_bwd": ("bn_act_bwd_kernel",),
    "block_quantize": ("quantize_kernel",),
    "block_dequantize": ("dequantize_kernel", "dequantize_vec_kernel"),
    "adam_update": ("adam_update_kernel",),
    "momentum_update": ("momentum_update_kernel",),
    "sgd_update": ("sgd_update_kernel",),
    "multi_tensor_adam": ("multi_adam_kernel",),
    "multi_tensor_sgd": ("multi_sgd_kernel",),
}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
# the dropout arguments of every kernel that drops: mode, the step's
# device pointer (null when it does not drop), salt, threshold, keep
# scale (csrc/dropout.cuh)
_DROP = (_I, _P, _U, _U, _F)
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
    # gamma/beta dtype, stream
    "pt_fused_add_ln_fwd": (_P,) * 8 + (_L, _I, _F) + _DROP + (_I, _I, _P),
    # dout, y, gamma, mean, rstd, dx, dres, part_g, part_b, dgamma, dbeta,
    # N, D, partial rows, dropout, dtype, gamma dtype, stream
    "pt_fused_add_ln_bwd": (_P,) * 11 + (_L, _I, _I) + _DROP
    + (_I, _I, _P),
    # N, D, dtype → rows of the backward's partials (negated cudaError_t
    # on failure)
    "pt_fused_add_ln_bwd_blocks": (_L, _I, _I),
    # table, ids, out, n, V, D, padding_idx, ids_are_int64, dtype, stream
    "pt_embedding_gather_fwd": (_P, _P, _P, _L, _L, _I, _L, _I, _I, _P),
    # n, rows → the backward's int32 workspace words (negated
    # cudaError_t on failure; returns a long long)
    "pt_embedding_gather_bwd_workspace": (_L, _L),
    # dout, ids, out, ws, n, rows, D, padding_idx, ids_are_int64, dtype,
    # stream
    "pt_embedding_gather_bwd": (_P,) * 4 + (_L, _L, _I, _L, _I, _I, _P),
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
    # p, g, m1, m2, lr, b1p, b2p, n, p/g/m/lr/pow dtypes, beta1, 1 - beta1,
    # beta2, 1 - beta2, eps, stream
    "pt_adam_update": (_P,) * 7 + (_L,) + (_I,) * 5 + (_F,) * 5 + (_P,),
    # p, g, v, lr, n, p/g/lr dtypes, mu, nesterov, stream
    "pt_momentum_update": (_P,) * 4 + (_L, _I, _I, _I, _F, _I, _P),
    # p, g, lr, n, p/g/lr dtypes, stream
    "pt_sgd_update": (_P,) * 3 + (_L, _I, _I, _I, _P),
    # arrays of p, g, m1, m2, b1p, b2p pointers and of sizes, count, lr,
    # dtypes and hyperparameters as pt_adam_update, stream
    "pt_multi_adam_update": (_P,) * 7 + (_I, _P) + (_I,) * 5 + (_F,) * 5
    + (_P,),
    # arrays of p and g pointers and of sizes, count, lr, p/g/lr dtypes,
    # stream
    "pt_multi_sgd_update": (_P,) * 3 + (_I, _P, _I, _I, _I, _P),
}

# entry points that return something other than an int
_RESTYPES = {"pt_embedding_gather_bwd_workspace": ctypes.c_longlong}


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
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = handle
    return _lib


def check(code, kernel):
    if code != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (kernel, code))


def count_launch(kernel):
    import torch

    if torch.cuda.is_current_stream_capturing():
        _CAPTURED[kernel] += 1
    else:
        _LAUNCHES[kernel] += 1


def count_replay(nodes):
    """Count one replay of a captured graph whose kernel nodes are
    ``nodes`` (:func:`graph_kernel_nodes`)."""
    for k, n in nodes.items():
        _REPLAYED[k] += n


def launch_counts():
    """Each kernel's launches that ran: at once from its wrapper, or as a
    node of a replayed CUDA graph."""
    return {k: _LAUNCHES[k] + _REPLAYED[k] for k in KERNELS}


def launch_counts_by_source():
    """``{"wrapper": …, "graph_nodes": …, "captured": …}``: the launches
    that ran at once, the kernel nodes that replays ran, and the launches
    recorded into captured graphs."""
    return {"wrapper": dict(_LAUNCHES), "graph_nodes": dict(_REPLAYED),
            "captured": dict(_CAPTURED)}


def reset_launch_counts():
    for counts in (_LAUNCHES, _CAPTURED, _REPLAYED):
        for k in counts:
            counts[k] = 0


def kernel_of(function_name):
    """The kernel (a :data:`KERNELS` name) whose device function this is,
    from its mangled or demangled name, or None.  The package's kernels
    live in anonymous namespaces (``csrc/*.cu``)."""
    import re

    mangled = "_GLOBAL__N_" in function_name
    for k, names in KERNEL_FUNCTIONS.items():
        for n in names:
            # mangled: the identifier after its length; demangled: the
            # identifier before its template or parameter list
            if (mangled and "%d%s" % (len(n), n) in function_name) \
                    or re.search(r"\(anonymous namespace\)::%s(?=[<(])" % n,
                                 function_name):
                return k
    return None


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
    _fields_ = [("func", _P), ("grid", _U * 3), ("block", _U * 3),
                ("shared_mem", _U), ("params", _P), ("extra", _P),
                ("kern", _P), ("ctx", _P)]


_libcuda = None


def _cu():
    global _libcuda
    if _libcuda is None:
        cu = ctypes.CDLL("libcuda.so.1")
        for name, argtypes in (
                ("cuGraphGetNodes", (_P, ctypes.POINTER(_P),
                                     ctypes.POINTER(ctypes.c_size_t))),
                ("cuGraphNodeGetType", (_P, ctypes.POINTER(_I))),
                ("cuGraphKernelNodeGetParams_v2",
                 (_P, ctypes.POINTER(_KernelNodeParams))),
                ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), _P)),
                ("cuKernelGetName", (ctypes.POINTER(ctypes.c_char_p), _P))):
            fn = getattr(cu, name)
            fn.argtypes = list(argtypes)
            fn.restype = _I
        _libcuda = cu
    return _libcuda


def _cu_check(code, call):
    if code != 0:
        raise RuntimeError("%s failed: CUresult %d" % (call, code))


def graph_kernel_functions(graph):
    """The device function name, as libcuda gives it, of every kernel
    node of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``)."""
    cu = _cu()
    g = _P(graph.raw_cuda_graph())
    num = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(g, None, ctypes.byref(num)),
              "cuGraphGetNodes")
    nodes = (_P * num.value)()
    _cu_check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(num)),
              "cuGraphGetNodes")
    names = []
    kind = _I()
    params = _KernelNodeParams()
    name = ctypes.c_char_p()
    for node in nodes[:num.value]:
        _cu_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        _cu_check(cu.cuGraphKernelNodeGetParams_v2(node,
                                                   ctypes.byref(params)),
                  "cuGraphKernelNodeGetParams")
        if params.func:
            _cu_check(cu.cuFuncGetName(ctypes.byref(name), params.func),
                      "cuFuncGetName")
        else:
            _cu_check(cu.cuKernelGetName(ctypes.byref(name), params.kern),
                      "cuKernelGetName")
        names.append(name.value.decode(errors="replace"))
    return names


def graph_kernel_nodes(graph):
    """``{kernel: nodes}``: the kernel nodes of a captured graph
    (:func:`graph_kernel_functions`) whose device function is one of
    :data:`KERNELS`'; every replay of the graph runs each of them
    once."""
    counts = {}
    for fn in graph_kernel_functions(graph):
        k = kernel_of(fn)
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    return counts


def kernel_dtype(function_name):
    """The element type a device function of :data:`KERNELS` was
    instantiated for, from its name: ``"bfloat16"`` or ``"float32"`` by
    its first floating template argument (``__nv_bfloat16`` / ``float``),
    or None when it has none (the gather moves raw words)."""
    import re

    types = {"__nv_bfloat16": "bfloat16", "float": "float32"}
    for names in KERNEL_FUNCTIONS.values():
        for n in names:
            key = "%d%sI" % (len(n), n)
            at = function_name.find(key)
            if at >= 0:  # mangled: walk the template arguments
                rest = function_name[at + len(key):]
                while rest and rest[0] != "E":
                    if rest.startswith("13__nv_bfloat16"):
                        return "bfloat16"
                    if rest[0] == "f":
                        return "float32"
                    if rest[0] == "L":  # a literal: L<type><value>E
                        rest = rest[rest.index("E") + 1:]
                        continue
                    m = re.match(r"\d+", rest)  # a named type, by length
                    rest = rest[len(m.group()) + int(m.group()):] if m \
                        else rest[1:]
                return None
            m = re.search(r"(?:::|\b)%s<([^>]*)>" % n, function_name)
            if m:  # demangled
                return next((types[a.strip()] for a in m.group(1).split(",")
                             if a.strip() in types), None)
    return None


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
