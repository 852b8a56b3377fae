"""Build, load and count the hand-written Hopper kernels in ``csrc/``.

The Triton kernel (csrc/rmsnorm_triton.py) is compiled by Triton at its
first launch (ops/rmsnorm.py); it is counted here like the others. All CUDA
sources compile with nvcc into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), loaded with
ctypes: one nvcc per source, all started together, then one link. The
build happens at first use, never at import: hosts without a card import
every module of the port and run the plain versions instead.

The library lands in ``build/kernels/<hash>/`` at the root of the checkout
(ignored by git); the hash covers the sources and the nvcc flags, so an edit
to a source rebuilds it and an unchanged tree reuses it across processes.

Counters: ``LAUNCHES[name]`` grows by one each time a wrapper launches its
kernel; ``PLAIN_CALLS[name]`` each time the plain PyTorch version runs;
``KIND_LAUNCHES["block_sparse_attn[<kind>]"]`` counts the chunked-CSR
attention's launches by mask kind (each kind is its own kernel instance;
``band_sink_perm`` is placement-free SVG1's dual per-head spec), and
``KIND_LAUNCHES["<kernel>[stats]"]`` the launches of ``block_sparse_attn`` and
``block_sparse_attn_runs`` that also return the (m, l) softmax stats. A
run that resets them and then reads them shows which path the work took.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
]

KERNELS = ("block_sparse_attn", "rope", "block_sparse_attn_runs", "kmeans_wide", "kmeans_variants", "rmsnorm",
           "dense_qsplit")
LAUNCHES = {name: 0 for name in KERNELS}
PLAIN_CALLS = {name: 0 for name in KERNELS}
KIND_LAUNCHES: collections.Counter = collections.Counter()

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, meta, slab_meta, aux, order, BH, Sq, Skv, D, R, nQ, L, block_q,
    # mask_kind, band_width, sink_size, video_len, frame_size, num_frames, n_items, q_scale, m_out, l_out, stream
    "svt_block_sparse_attn": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    # D -> dynamic shared memory of one chunked-CSR attention CTA (bytes)
    "svt_block_sparse_attn_smem": [_I],
    # x, cos, sin, out, BH, S, D, stream
    "svt_rope": [_P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, o, meta, aux, order, BH, Sq, Skv, D, R, nQ, L, block_q, block_kv,
    # mask_kind, band_width, sink_size, q_scale, m_out, l_out, stream
    "svt_block_sparse_attn_runs": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _P, _P, _P],
    # q, k, v, o, BH, S, D, bq, qsplit, q_scale, stream
    "svt_dense_qsplit": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # D, qsplit -> dynamic shared memory of one K7 CTA (bytes)
    "svt_dense_qsplit_smem": [_I, _I],
    # x, c, labels, sums, counts, overflow, work, B, N, K, D, variant, stream
    "svt_kmeans_lloyd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # B, N, K, D, variant -> bytes of the pass's workspace (a long long)
    "svt_kmeans_lloyd_workspace": [_I, _I, _I, _I, _I],
}
_RESTYPES = {"svt_kmeans_lloyd_workspace": ctypes.c_longlong}


_COUNT_LOCK = threading.Lock()  # ring ranks may run as threads of one process (parallel/comm.py)


def launched(name: str, *kinds: str) -> None:
    """Count one launch of kernel `name`, and one under each KIND_LAUNCHES key in `kinds`."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        for k in kinds:
            KIND_LAUNCHES[k] += 1


def plain_call(name: str) -> None:
    """Count one run of kernel `name`'s plain version."""
    with _COUNT_LOCK:
        PLAIN_CALLS[name] += 1


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for name in d:
            d[name] = 0
    KIND_LAUNCHES.clear()


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit (set CUDA_HOME)")
    return found


def build() -> str:
    """Compile csrc/ into the shared library if its hash is new; return its
    path. Each .cu compiles in its own nvcc process, all at once; nvcc's
    -Xptxas -v reports (registers, spills) land in ptxas.log beside it."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libsvt_kernels.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o") for s in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for s, o in zip(cus, objs)]
    logs = []
    for s, p in zip(cus, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(s)} ({p.returncode}):\n{out}\n{err}")
        logs.append(err)
    tmp = f"{lib}.{tag}"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    for o in objs:
        os.remove(o)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write("".join(logs))
    os.replace(tmp, lib)  # atomic: concurrent processes never load a half-written file
    return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_TRACKED = re.compile(r"(bsa_kernel|bsa_stats_kernel|bsa_dual_kernel|runs_kernel|runs_stats_kernel|dense_kernel|"
                      r"kmeans_assign_kernel)ILi(\d+)E(?:Li(\d+)E)?")


def ptxas_report(log: str) -> list[dict]:
    """The Hopper kernels' entries in nvcc's -Xptxas -v output: one dict
    {kernel, D, kind, registers, spill_stores, spill_loads, static_smem} for
    each bsa_kernel<D, KIND> and bsa_stats_kernel<D, KIND> (K1, without and
    with the (m, l) stats), bsa_dual_kernel<D, MODE> (K1's dual per-head
    spec; `kind` holds the MODE: 0, or 4 with the stats), runs_kernel<D> and
    runs_stats_kernel<D> (K3/K4), dense_kernel<D, MODE> (K7; `kind`
    holds the MODE) and kmeans_assign_kernel<D, V> (K5 and K8's variants;
    `kind` holds V: 0 = A, K5's own) instance."""
    rows, cur = [], None
    for line in log.splitlines():
        if (e := _ENTRY.search(line)) is not None:
            a = _TRACKED.search(e.group(1))
            cur = None if a is None else {"kernel": a.group(1), "D": int(a.group(2)),
                                          "kind": None if a.group(3) is None else int(a.group(3)),
                                          "registers": None, "spill_stores": None, "spill_loads": None,
                                          "static_smem": 0}
            if cur is not None:
                rows.append(cur)
        elif cur is not None and (s := _SPILL.search(line)) is not None:
            cur["spill_stores"], cur["spill_loads"] = int(s.group(1)), int(s.group(2))
        elif cur is not None and (u := _USED.search(line)) is not None:
            cur["registers"] = int(u.group(1))
            if (sm := _SMEM.search(line)) is not None:
                cur["static_smem"] = int(sm.group(1))
    return rows


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        cdll = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _LIB = cdll
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
