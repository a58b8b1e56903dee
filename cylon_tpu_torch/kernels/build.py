"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into an
object (one ``nvcc`` per source, all started together), and the objects
link into ONE shared library with a plain C interface, loaded with
``ctypes``. Nothing includes PyTorch's headers, so a build takes seconds.

The build runs at first use, into ``cylon_tpu_torch/_build/`` (listed in
``.gitignore``), from the sources in the package only. The library's file
name carries a hash of the sources and flags, so an edited source builds
anew and a stale library is never loaded.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    "cylon_row_hash": ([_P, _P, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_uint, ctypes.c_uint, _P, _P], ctypes.c_int),
    "cylon_scan_tile": ([], ctypes.c_int),
    "cylon_scan32": ([_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      _P, _P], ctypes.c_int),
    "cylon_pair_scan_tile": ([ctypes.c_longlong], ctypes.c_longlong),
    "cylon_pair_scan_split": ([], ctypes.c_longlong),
    "cylon_pair_scan_scratch": ([ctypes.c_longlong], ctypes.c_longlong),
    "cylon_pair_max_scan": ([_P, _P, _P, _P, ctypes.c_longlong, _P,
                             ctypes.c_longlong, ctypes.c_uint, _P],
                            ctypes.c_int),
    "cylon_bucket_build": ([_P, ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_longlong, ctypes.c_int, _P,
                            ctypes.c_longlong, _P, ctypes.c_longlong, _P,
                            ctypes.c_longlong, _P, ctypes.c_longlong, _P,
                            _P, _P], ctypes.c_int),
    "cylon_bucket_probe": ([_P, ctypes.c_longlong, _P, _P, _P, _P,
                            ctypes.c_int, ctypes.c_int, _P,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, _P, _P], ctypes.c_int),
    "cylon_gather_rows": ([_P, ctypes.c_longlong, ctypes.c_int, _P,
                           ctypes.c_int, ctypes.c_longlong, _P, _P],
                          ctypes.c_int),
}

_lock = threading.Lock()
_lib = None
#: what the last build in this process did: seconds and library path
last_build: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build on a machine with the CUDA "
            "toolkit")
    return found


def build() -> Path:
    """Compile the library if no build of the current sources exists;
    return its path."""
    lib_path = BUILD_DIR / f"libcylon_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [compiler, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{lib_path.stem}_{tag}.so"
    link = subprocess.run(
        [compiler, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *map(str, objs)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError("link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink(missing_ok=True)
    last_build.update(seconds=time.perf_counter() - t0, path=str(lib_path))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    PyTorch has no CUDA)."""
    import torch

    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


#: per thread, the tally of the graph this thread is capturing
#: (:func:`graph_tally`); absent outside one
_TALLY = threading.local()


def graph_tally():
    """A context in which this thread's launches into a graph it
    captures are tallied by wrapper name in the dict it yields, not
    counted in the wrappers' ``launches`` (a capture runs nothing; the
    replays count them). Other threads, which may launch meanwhile, keep
    counting their own."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        prev = getattr(_TALLY, "counts", None)
        _TALLY.counts = {}
        try:
            yield _TALLY.counts
        finally:
            _TALLY.counts = prev

    return scope()


def count(wrapper, n: int = 1) -> None:
    """Count ``n`` launches of ``wrapper``'s kernel, made by this call:
    into the capturing thread's :func:`graph_tally` while it captures,
    else into ``wrapper.launches``."""
    tally = getattr(_TALLY, "counts", None)
    if tally is not None and capturing():
        tally[wrapper.__name__] = tally.get(wrapper.__name__, 0) + n
    else:
        wrapper.launches += n


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
