"""Hand-written CUDA C++ kernels for Hopper (sm_90a).

Each kernel package ships:
  ref.py    — the plain PyTorch version of the function (CPU tests, and the
              on-card yardstick the kernel is held against),
  kernel.py — the ctypes binding and launch of the CUDA kernel,
  ops.py    — the dispatch: a CPU tensor goes to ``ref``, a CUDA tensor
              launches the kernel (or raises); each public op carries a
              ``launches`` counter bumped where it launches its kernel.

Kernels: kg_scan (fused masked triple-pattern scan with its int32 prefix
sum, or its compaction) and kg_join (merge-join candidate ranges and their
compaction of the join's pairs; the expand join's compatibility matrix and
its compaction of the compatible pairs, from ``csrc/kg_compat.cu``)
behind the query engine; jaccard (the WawPart
query-distance matrix); embedding_bag (the xDeepFM row gather, and the
weighted bag sum as an op) and cin (the fused xDeepFM CIN layer);
flash_attention (the dense transformer's attention at prefill and
decode); segment_spmm (the GNNs' scatter-sum of edge messages into
receiver nodes). Their sources live in
``src/repro_torch/csrc/``.

The sources are compiled at first CUDA use by ``nvcc`` into shared
libraries with a plain C interface under ``build/repro_torch/`` at the
repository root, one library per source, all sources compiled in
parallel; ``csrc/wgmma.cuh`` holds the Hopper helpers (wgmma, mbarriers,
bulk and tensor copies) that cin and jaccard include, ``csrc/lookback.cuh``
the decoupled look-back that kg_scan, kg_join and kg_compat share. Nothing here is
imported or compiled when the package is imported, so the CPU-only test
suite never needs a CUDA toolchain.

Only segment_spmm has a backward (`segment_spmm.ops.SegmentSum`: the
kernel forward, the plain gather that is a segment sum's transpose
backward); it is the one kernel on a training forward. The others write
their outputs through ``ctypes`` into tensors autograd knows nothing of,
so each raises on the card when autograd would record it
(`forbid_backward`) rather than train with a gradient quietly missing.

A tensor on PyTorch's ``meta`` device is a third case, beside the CPU and
the card: the op returns meta outputs of the shapes and dtypes its plain
version returns, launches nothing, bumps no ``launches`` counter, and adds
the kernel's own work to `meta_cost` (operations and bytes by the formulas
of the kernels' bounds in ``chip_smoke.py``), which the dry run
(`repro_torch.launch.dryrun`) reads. Where the work depends on the data
(which rows a gather names, which pairs of a join are live) the meta count
takes every row and pair.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("kg_scan.cu", "kg_join.cu", "kg_compat.cu", "jaccard.cu",
           "embedding_bag.cu", "cin.cu", "flash_attention.cu",
           "segment_spmm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of repro_torch are compiled at first use")
    return found


def _lib_path(source: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1((CSRC / source).read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(sources: tuple[str, ...] = SOURCES) -> float:
    """Compile every missing library (one nvcc per source, all started
    together) and load them. Returns the wall seconds spent; a library
    whose source is unchanged is reused from ``build/repro_torch/``."""
    t0 = time.perf_counter()
    with _lock:
        todo = [s for s in sources if s not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src}:\n{log.decode()}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for src in todo:
            _libs[src] = ctypes.CDLL(str(_lib_path(src)))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library for one source, building it on first use."""
    lib = _libs.get(source)
    if lib is None:
        build((source,))
        lib = _libs[source]
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {status})")


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes pointer (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def require(t, name: str, dtype, ndim: int | None = None) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity (and rank)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")


def needs_backward(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and
    one of them (None skipped) requires grad."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def forbid_backward(name: str, plain: str, *tensors) -> None:
    """Raise when `needs_backward` holds for a kernel with no backward."""
    if needs_backward(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad with grad mode on; train through the plain route "
            f"({plain}), or run under torch.no_grad()")


def lead_strides(t, tail: int, lead: tuple) -> tuple:
    """t's strides over ``lead`` as it broadcasts there (0 where it has no
    dim or a dim of 1); ``tail`` trailing dims are not leading ones."""
    if t is None:
        return (0,) * len(lead)
    shape, stride = t.shape[:t.dim() - tail], t.stride()
    skip = len(lead) - len(shape)
    if skip < 0:
        raise ValueError(f"{tuple(t.shape)} does not broadcast to leading "
                         f"dims {lead}")
    out = [0] * skip
    for i, size in enumerate(shape):
        if size != 1 and size != lead[skip + i]:
            raise ValueError(f"{tuple(t.shape)} does not broadcast to "
                             f"leading dims {lead}")
        out.append(0 if size == 1 else stride[i])
    return tuple(out)



def is_meta(t) -> bool:
    """Whether ``t`` is a tensor on the meta device."""
    return t is not None and t.device.type == "meta"


class MetaCost:
    """The kernels' work on meta tensors since the last `reset`: ``ops``
    (floating-point or integer operations), ``bytes`` (each input read
    once, each output written once) and ``calls`` by kernel name."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.ops = 0
        self.bytes = 0
        self.calls: Counter = Counter()

    def add(self, name: str, *, ops: int, n_bytes: int) -> None:
        self.ops += int(ops)
        self.bytes += int(n_bytes)
        self.calls[name] += 1


meta_cost = MetaCost()


def nbytes(t) -> int:
    """A tensor's elements times their size (0 for None)."""
    return 0 if t is None else t.numel() * t.element_size()
