"""Build and load the port's CUDA kernels: ``nvcc`` by hand, ``ctypes`` to bind.

The sources under ``repro_torch/csrc/`` have a plain C interface and include
no PyTorch header, so each compiles in seconds.  At first use every source
compiles to an object file in parallel (one ``nvcc`` each, all started
together), the objects link into one shared library for ``sm_90a``, and
``ctypes`` loads it.  The library's name carries a digest of the sources and
flags, so an edited source builds anew and an unchanged one is reused.

The build directory is ``repro_torch/_build/`` inside the checkout (listed in
``.gitignore``).  Nothing here runs at import time: the CPU tests import
every module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("mvau.cu", "mvau_planes.cu", "mvau_planes24.cu", "gap.cu",
           "qmatmul.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each kernel in this process: every wrapper adds one where it
# launches its kernel and nowhere else (chip_smoke.py reads these to show
# the main path went through the kernels).  ``mvau_int_gap`` counts the
# launches of the integer conv MVAU that carry the GlobalAccPool epilogue
# (``mvau.mvau_int_conv_gap``), ``mvau_int_planes`` those of the plane
# route (uint8 codes, or 9- to 24-bit codes as byte planes, on the int8
# tensor cores; ``mvau_int_planes2`` and ``mvau_int_planes6`` those of its
# two-product (16-bit codes x int8 weights) and six-product (24-bit codes x
# 16-bit weights) kinds), ``mvau_int_wide`` those that run on the CUDA-core
# route (int32 codes past it) and ``mvau_int_small_m`` those of the GEMM
# form at decode shapes (``mvau_small_m_kernel``); each of them is an ``mvau_int`` launch
# too.  ``qmatmul_rows`` counts the
# launches of qmatmul's many-row route (``qmm_rows_kernel``), each of them
# a ``qmatmul`` launch too.  A launch made while a CUDA graph
# captures is recorded in that graph instead (:class:`GraphState`), and
# every replay of the graph adds its record here: the counts stay "kernels
# that ran".
launch_counts: Dict[str, int] = {"mvau_int": 0, "mvau_int_gap": 0,
                                  "mvau_int_planes": 0,
                                  "mvau_int_planes2": 0,
                                  "mvau_int_planes6": 0, "mvau_int_wide": 0,
                                  "mvau_int_small_m": 0, "mvau": 0, "gap": 0,
                                  "qmatmul": 0, "qmatmul_rows": 0}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in launch_counts:
            launch_counts[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (a captured graph's record) to :data:`launch_counts`."""
    with _COUNT_LOCK:
        for k, v in counts.items():
            launch_counts[k] += v


def count_launch(*names: str) -> None:
    """One launch of each kernel in ``names``: into the record of the graph
    this thread is capturing, else into :data:`launch_counts`."""
    state = getattr(_LOCAL, "graph", None)
    if state is not None and state.capturing:
        for name in names:
            state.launches[name] = state.launches.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        for name in names:
            launch_counts[name] += 1


# Tile counters of the split-K kernels (mvau, mvau_int, qmatmul): zeroed
# once, and every launch leaves them zeroed (the last block of a tile resets
# its counter), so launches in stream order may share one buffer.  Eager
# launches share one buffer per device, on PyTorch's current stream.  A
# graph being captured, and the eager runs that warm it, use a buffer of
# their own (:class:`GraphState`): two graphs replayed at once, or a replay
# beside an eager launch on another stream, never touch the same counters.
_TILE_COUNTS: Dict[object, object] = {}
_LOCAL = threading.local()


class GraphState:
    """What one CUDA graph owns of the kernels' shared state: its split-K
    tile counters, and the launches recorded while it was captured.

    Inside :meth:`warming` (the eager runs before the capture) the counters
    grow to the largest launch; inside :meth:`capture` they are fixed (a
    capture cannot allocate them) and launches go to :attr:`launches`."""

    def __init__(self):
        self.counters = None
        self.capturing = False
        self.launches: Dict[str, int] = {}

    @contextlib.contextmanager
    def _scope(self, capturing: bool):
        prev = getattr(_LOCAL, "graph", None)
        _LOCAL.graph, self.capturing = self, capturing
        try:
            yield self
        finally:
            _LOCAL.graph, self.capturing = prev, False

    def warming(self):
        """This thread's launches use the graph's counters (grown as needed)
        and count as launches."""
        return self._scope(False)

    def capture(self):
        """This thread's launches use the graph's counters (fixed) and are
        recorded in :attr:`launches`."""
        return self._scope(True)

    def tile_counters(self, dev, tiles: int):
        import torch

        if self.counters is None or self.counters.numel() < tiles:
            if self.capturing:
                raise RuntimeError(
                    f"a launch inside a CUDA graph capture needs {tiles} "
                    "split-K tile counters, more than the eager warm-up "
                    "runs sized the graph's buffer for")
            self.counters = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                        device=dev)
        return self.counters


def tile_counters(dev, tiles: int):
    """An int32 tensor of at least ``tiles`` zeroed counters on ``dev``:
    the graph's own while this thread warms or captures one, else the
    device's."""
    state = getattr(_LOCAL, "graph", None)
    if state is not None:
        return state.tile_counters(dev, tiles)
    import torch

    counts = _TILE_COUNTS.get(dev)
    if counts is None or counts.numel() < tiles:
        counts = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
        _TILE_COUNTS[dev] = counts
    return counts


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float          # 0.0 when an up-to-date library was reused
    built: bool
    ptxas: str              # -Xptxas -v report: registers, shared memory, spills


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode())
        h.update((CSRC_DIR / src).read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> BuildInfo:
    """Compile (or reuse) the kernel library; returns where it is and what
    the build cost."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    lib = BUILD_DIR / f"librepro_kernels-{digest}.so"
    log = BUILD_DIR / f"ptxas-{digest}.log"
    if lib.exists() and not force:
        return BuildInfo(lib, 0.0, False,
                         log.read_text() if log.exists() else "")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs: List[subprocess.Popen] = []
    objs: List[Path] = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}-{digest}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC_DIR / src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = []
    failed = []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        reports.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(reports))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    ptxas = "\n".join(reports)
    log.write_text(ptxas)
    return BuildInfo(lib, time.perf_counter() - t0, True, ptxas)


class KernelLibrary:
    """The loaded shared library with typed entry points."""

    def __init__(self, info: BuildInfo):
        self.info = info
        lib = ctypes.CDLL(str(info.path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.mvau_int = lib.repro_mvau_int
        self.mvau_int.argtypes = [p, p, i, p, p] + [i] * 6 + [p, p, p]
        self.mvau_int_small_m = lib.repro_mvau_int_small_m
        self.mvau_int_small_m.argtypes = [p, p, i, p, p] + [i] * 5 + [p]
        self.empty_launch = lib.repro_empty_launch
        self.empty_launch.argtypes = [i, i, p]
        self.mvau_int_conv = lib.repro_mvau_int_conv
        self.mvau_int_conv.argtypes = [p, p, i, p, p] + [i] * 11 + [p, p, p]
        self.mvau_int_conv_gap = lib.repro_mvau_int_conv_gap
        self.mvau_int_conv_gap.argtypes = ([p, p, i, p, p, p] + [i] * 11
                                           + [p, p, p])
        self.mvau_int_planes_conv = lib.repro_mvau_int_planes_conv
        self.mvau_int_planes_conv.argtypes = ([p, i, p, i, p, p, p]
                                              + [i] * 11 + [p, p, p])
        self.mvau_core_conv = lib.repro_mvau_core_conv
        self.mvau_core_conv.argtypes = ([p, i, p, i, p, p] + [i] * 10
                                        + [f, f, f, i, p, p, p])
        self.mvau_i8 = lib.repro_mvau_i8
        self.mvau_i8.argtypes = [p, p, p, p, i, i, i, i, f, f, f, p]
        self.gap = lib.repro_gap
        self.gap.argtypes = [p, p, i, p, i, i, i, p]
        self.qmatmul = lib.repro_qmatmul
        self.qmatmul.argtypes = [p, i, p, i, p, p, p, p] + [i] * 7 + [p]
        self.qmatmul_rows = lib.repro_qmatmul_rows
        self.qmatmul_rows.argtypes = [p, i, p, i, p, p] + [i] * 4 + [p]
        for fn in (self.mvau_int, self.mvau_int_small_m, self.empty_launch,
                   self.mvau_int_conv, self.mvau_int_conv_gap,
                   self.mvau_int_planes_conv, self.mvau_core_conv, self.mvau_i8, self.gap, self.qmatmul,
                   self.qmatmul_rows):
            fn.restype = ctypes.c_int
        self._lib = lib


_LOCK = threading.Lock()
_LIBRARY: Optional[KernelLibrary] = None


def library() -> KernelLibrary:
    """Build on first use, then return the loaded library."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            _LIBRARY = KernelLibrary(build())
        return _LIBRARY


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError != 0)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {rc}")
