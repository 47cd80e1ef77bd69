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

The build root (``kernels/build`` by default) can be moved before the
library is first loaded (``set_build_root``; the program cache's
``enable_persistent_cache``), so processes that share a directory build
once.  Loading and the per-pattern device caches are safe to use from
several threads (a background warm beside the serving thread).

Each launcher counts its launches through ``count``.  While this thread
records a CUDA-graph capture (``recording_launches``) a launch is noted in
the capture's record instead, since the kernel runs only when the graph is
replayed; ``add_launches`` adds a record at each replay.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
    "aco_choice_info": [_P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P],
    "aco_tour_select": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "aco_fused_select": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I,
                         _P],
    "aco_fused_select_quant": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                               _F, _F, _I, _I, _P],
    "aco_fused_walk": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                       _I, _I, _F, _F, _I, _P, _P, _P],
    "aco_fused_walk_quant": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                             _I, _F, _F, _I, _I, _F, _F, _I, _P, _P, _P],
    "aco_pheromone_update": [_P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong,
                             _F, _P],
    "aco_pheromone_update_tours": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                                   _P, _F, _P],
    "aco_two_opt_best": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P],
    "aco_sparse_select": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                          _I, _P],
    "aco_sparse_select_quant": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _F, _F, _I, _P],
    "aco_sparse_walk": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                        _I, _F, _F, _F, _F, _P],
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


_LOCK = threading.Lock()
_LIB = None
# the loaded library's path and the seconds its build took in this process
# (0.0 when the build root already held it)
LOADED: dict = {}


def set_build_root(root) -> Path:
    """Build and load the library under ``root`` from now on; raises once
    the library is loaded from another root (a process holds one
    library)."""
    global BUILD_ROOT
    root = Path(root).resolve()
    with _LOCK:
        if _LIB is not None and root != BUILD_ROOT:
            raise RuntimeError(
                f"the kernel library is already loaded from {BUILD_ROOT}; "
                f"set the build root to {root} before the first launch")
        BUILD_ROOT = root
    return root


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            path, seconds = build()
            lib = ctypes.CDLL(str(path))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.aco_error_string.argtypes = [ctypes.c_int]
            lib.aco_error_string.restype = ctypes.c_char_p
            LOADED.update(path=str(path), build_s=seconds)
            _LIB = lib
    return _LIB


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


_CACHED: dict = {}


def _cached(dtype_name: str, values: tuple, device: str):
    """``values`` as a device tensor, copied once per (values, device) and
    then served from the cache (which is never evicted: a CUDA graph may
    hold its pointer)."""
    key = (dtype_name, values, device)
    t = _CACHED.get(key)
    if t is None:
        import torch
        with _LOCK:
            t = _CACHED.get(key)
            if t is None:
                t = torch.tensor(values, dtype=getattr(torch, dtype_name),
                                 device=device)
                _CACHED[key] = t
    return t


def _flags(values: tuple, device: str):
    return _cached("uint8", values, device)


def _counts(values: tuple, device: str):
    return _cached("int32", values, device)


_RECORDING = threading.local()
_COUNT_LOCK = threading.Lock()


def count(fn, slots=None) -> None:
    """Add one launch of ``fn`` (and ``slots`` instances served) to its
    counts, or to this thread's capture record while one is open."""
    rec = getattr(_RECORDING, "record", None)
    if rec is not None:
        got = rec.setdefault(fn, [0, 0])
        got[0] += 1
        got[1] += slots or 0
        return
    add_launches({fn: (1, slots or 0)})


def add_launches(record: dict) -> None:
    """Add a record's launches (and instances served) to the launchers'
    counts: a graph replay launches what its capture recorded."""
    with _COUNT_LOCK:
        for fn, (launches, slots) in record.items():
            fn.launches += launches
            if hasattr(fn, "slot_launches"):
                fn.slot_launches += slots


class recording_launches:
    """Within the block, this thread's launches go to the yielded record
    ({launcher: [launches, instances]}) and not to the counts."""

    def __enter__(self) -> dict:
        self.record: dict = {}
        _RECORDING.record = self.record
        return self.record

    def __exit__(self, *exc) -> None:
        _RECORDING.record = None


def count_array(n_actual: int, batch: int, device):
    """A host ``n_actual`` as the (batch,) int32 tensor on ``device`` that
    the launchers read per instance (copied once per value, then
    cached)."""
    return _counts((int(n_actual),) * batch, str(device))


def slot_ints(n_actual, batch: int) -> list:
    """A batch's n_actual (None, a host int, a sequence or a (B,) tensor)
    as B host values (None = unmasked)."""
    if n_actual is None or isinstance(n_actual, int):
        return [n_actual] * batch
    if hasattr(n_actual, "tolist"):
        return [int(v) for v in n_actual.tolist()]
    return [None if v is None else int(v) for v in n_actual]


def n_actual_arg(name: str, n_actual, batch: int, n: int, device) -> tuple:
    """A launcher's ``n_actual`` as the C interface takes it: (host count,
    device pointer or None).  A (batch,) int32 tensor on ``device`` is read
    on the card only (its values are the caller's to check); a host int
    must lie in [1, n]; None is n, every city real."""
    import torch
    if isinstance(n_actual, torch.Tensor):
        require(f"{name} n_actual", n_actual, torch.int32, (batch,), device)
        return n, n_actual.data_ptr()
    if n_actual is None:
        return n, None
    if not 1 <= int(n_actual) <= n:
        raise ValueError(f"{name}: n_actual {n_actual} not in [1, {n}]")
    return int(n_actual), None


def active_flags(active, batch: int, device) -> tuple:
    """``active``, a host sequence of ``batch`` flags, as a (batch,) uint8
    tensor on ``device`` (copied once per pattern, then cached) and the
    number of flags set; ``(None, batch)`` for None (every instance)."""
    if active is None:
        return None, batch
    values = tuple(1 if a else 0 for a in active)
    if len(values) != batch:
        raise ValueError(f"{len(values)} active flags for {batch} instances")
    return _flags(values, str(device)), sum(values)


def launch(name: str, device, *args) -> None:
    """Call the library's ``aco_<name>`` with ``args`` and PyTorch's current
    stream on ``device`` (that device made current); raise on its code."""
    import torch
    lib = load()
    with torch.cuda.device(device):
        s = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        check(lib, getattr(lib, "aco_" + name)(*args, s), name)
