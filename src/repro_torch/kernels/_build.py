"""Build and load the CUDA kernels of ``kernels/csrc`` at first use.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (H100); the objects are linked into one shared
library with a plain C interface, ``libaco_kernels.so``, loaded with
``ctypes``.  The library lands in ``kernels/build/<digest>/``, where the
digest covers the sources and the flags, so an edited source is never
served by a stale build.  A build goes to a private directory first and
is renamed into place, so concurrent first uses do not collide.

Each C function launches on the stream it is given and returns a CUDA
status code; ``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "libaco_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "aco_choice_info": [_P, _P, _P, _I, _I, _F, _F, _I, _P],
    "aco_tour_select": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "aco_fused_select": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I,
                         _P],
    "aco_fused_select_quant": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                               _F, _F, _I, _I, _P],
    "aco_pheromone_update": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong,
                             _F, _P],
    "aco_pheromone_update_tours": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "aco_two_opt_best": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P],
    "aco_sparse_select": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                          _I, _P],
    "aco_sparse_select_quant": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _F, _F, _I, _P],
    "aco_sparse_walk": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the one on ``PATH``, or
    the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def build() -> tuple[Path, float]:
    """Compile (if needed) -> (library path, seconds spent building)."""
    out = lib_path()
    if out.exists():
        return out, 0.0
    t0 = time.perf_counter()
    out.parent.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [cc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                               + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [cc, *ARCH, "-shared", *(str(o) for _, o, _ in procs), "-o",
             str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stderr}")
        (Path(tmp) / "build.log").write_text("\n".join(log))
        os.replace(Path(tmp) / "build.log", out.parent / "build.log")
        os.replace(tmp_lib, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.aco_error_string.argtypes = [ctypes.c_int]
    lib.aco_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a kernel's C function returned a CUDA error."""
    if code != 0:
        msg = lib.aco_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(code {code})")


def require(name: str, t, dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (one of
    a tuple of dtypes), of ``shape`` and on ``device`` where given."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on "
                         f"{t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def launch(name: str, device, *args) -> None:
    """Call the library's ``aco_<name>`` with ``args`` and PyTorch's current
    stream on ``device`` (that device made current); raise on its code."""
    import torch
    lib = load()
    with torch.cuda.device(device):
        s = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        check(lib, getattr(lib, "aco_" + name)(*args, s), name)
