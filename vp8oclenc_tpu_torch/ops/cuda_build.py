"""Build and load the hand-written CUDA kernels of csrc/.

Each csrc/<name>.cu is compiled on first use by nvcc for sm_90a into a
shared library with a plain C interface,
vp8oclenc_tpu_torch/_build/<name>.so, and loaded with ctypes.  Pointers and
the CUDA stream are passed as c_void_p; every C launcher returns
cudaGetLastError(), which `check` turns into an exception.  `build_all`
starts one nvcc per source at once, so a cold build costs the slowest
source, not their sum.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("intra", "loopfilter", "search", "ssim", "transform", "probe")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "intra": {
        "vp8_luma_wavefront": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "vp8_chroma_wavefront": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "vp8_trial_luma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "vp8_luma_smem": [_I],
        "vp8_chroma_smem": [_I],
    },
    "loopfilter": {
        "vp8_loop_filter": [_P] * 16 + [_I, _I, _P],
        "vp8_filter_smem": [_I],
        "vp8_filter_ring": [_I],
    },
    "search": {
        "vp8_fullpel_search": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P],
        "vp8_qpel_search": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    },
    "ssim": {
        "vp8_mb_ssim": [_P, _P, _I, _I, _P],
    },
    "transform": {
        "vp8_inter_pass": [_P] * 6 + [_I] * 11 + [_P],
        "vp8_trial_chroma_merge": [_P] + [_I] * 6 + [_P],
    },
    # not a kernel of the encoder: the integer-rate probe of chip_smoke.py
    "probe": {
        "vp8_int_rate": [_P, _I, _I, _I, _I, _I, _P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _so(name: str) -> str:
    return os.path.join(BUILD_DIR, name + ".so")


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or a shared header."""
    so = _so(name)
    deps = [name + ".cu"] + [f for f in os.listdir(SRC_DIR)
                             if f.endswith(".cuh")]
    return not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(os.path.join(SRC_DIR, f)) for f in deps)


def _start(name: str, tmpdir: str):
    """nvcc of csrc/<name>.cu, or of the .cu file at the path `name`, into
    tmpdir/<name>.so, started."""
    src = name if name.endswith(".cu") else os.path.join(SRC_DIR,
                                                         name + ".cu")
    base = os.path.splitext(os.path.basename(src))[0]
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", SRC_DIR, "-o", os.path.join(tmpdir, base + ".so"), src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict:
    """Compile every stale source in parallel.  Returns {name: nvcc output}
    (empty for a library that was already built); raises if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if _stale(n)]
    logs = {n: "" for n in names}
    if not todo:
        return logs
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        procs = {n: _start(n, td) for n in todo}
        failed = []
        for n, p in procs.items():
            out, _ = p.communicate()
            logs[n] = out
            if p.returncode != 0:
                failed.append(n)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        for n in todo:    # rename inside one filesystem: atomic per library
            os.replace(os.path.join(td, n + ".so"), _so(n))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = ctypes.CDLL(_so(name))
            for fn, args in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")
