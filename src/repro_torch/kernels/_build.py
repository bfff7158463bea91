"""Build and load the port's CUDA kernels.

All kernels live in ``csrc/*.cu`` behind a plain C interface.  At first
use they are compiled for ``sm_90a`` by ``nvcc`` — one ``nvcc -c`` per
source, all started together, then one link into a single shared
library — under ``kernels/_build/`` (ignored by git), keyed by a hash of
the sources and flags so an edited source rebuilds.  The library is
loaded with ``ctypes``; every entry point returns ``cudaGetLastError()``
and the Python wrappers raise when it is not 0.

Nothing here runs at import time: modules import this one freely and the
build happens inside the first wrapper call that needs the card.
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
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-lineinfo", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", *ARCH_FLAGS]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}        # seconds, library path, ptxas report


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """Compile every source in parallel, then link ``out`` atomically."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        compiler = nvcc()
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = []
        failed = []
        for src, obj, p in procs:
            log, _ = p.communicate()
            report.append(f"== {src.name}\n{log}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(report))
        lib_tmp = tmp / out.name
        link = subprocess.run(
            [compiler, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)
        (BUILD_DIR / (out.stem + ".log")).write_text("\n".join(report))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info["seconds"] = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / f"libmemos_kernels_{_digest()}.so"
            if not out.exists():
                _build(out)
            else:
                build_info.setdefault("seconds", 0.0)
            build_info["library"] = str(out)
            log = BUILD_DIR / (out.stem + ".log")
            build_info["ptxas"] = log.read_text() if log.exists() else ""
            _lib = ctypes.CDLL(str(out))
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """One C entry point with its argument types declared (pointers and
    streams as ``c_void_p`` so ctypes never truncates them)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def current_stream(index: int) -> int:
    """The raw handle of card ``index``'s current CUDA stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it but without
    building a Stream object on every launch.  Every wrapper passes its
    kernel this handle."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


_mapped: dict[int, int] = {}    # pinned allocation base -> device address


def device_address(t) -> int:
    """The address a kernel uses for tensor ``t``: its data pointer on
    the card, or, for pinned host memory, the device address CUDA
    mapped for it (``cudaHostGetDevicePointer`` on the allocation base,
    plus the view's offset).  Raises for host memory that is not pinned
    and mapped: no copy ever stands in for it."""
    if t.device.type == "cuda":
        return t.data_ptr()
    if t.device.type != "cpu" or not t.is_pinned():
        raise ValueError(f"a {t.device} tensor that is not pinned host "
                         f"memory has no device address")
    base = t.untyped_storage().data_ptr()
    dev = _mapped.get(base)
    if dev is None:
        out = ctypes.c_void_p()
        fn = function("host_device_pointer",
                      [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)])
        err = fn(base, ctypes.byref(out))
        if err != 0 or not out.value:
            raise RuntimeError(f"pinned host memory at {base:#x} is not "
                               f"mapped for the card: cudaError {err}")
        dev = _mapped[base] = out.value
    return dev + (t.data_ptr() - base)
