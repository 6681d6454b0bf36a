"""Build and load the port's hand-written CUDA kernels.

Each kernel source in `ray_tpu_torch/csrc/` is one `.cu` file with a
plain C interface (no PyTorch headers). It is compiled by `nvcc` into
its own shared library for Hopper (`sm_90a`) at first use and loaded
with `ctypes`; a small file builds in seconds, where a PyTorch
extension build takes minutes. Kernels whose entry points live in one
source share its one library. Libraries land in `ray_tpu_torch/_build/`
(listed in `.gitignore`) under a name that hashes the source and the
flags, so an edited source never loads a stale library. Compilation
writes a temporary file and renames it into place, so two processes
building at once never load a half-written library.

Nothing here runs at import: `nvcc` is looked up and started only when
a wrapper first launches its kernel on a CUDA tensor, or when
`build_all` is called (it starts one `nvcc` per source, all at once).
A worker process of the multi-process runtime (`WORKER_ENV` set) builds
nothing: it loads the libraries its driver built, and a library that is
not there fails the worker's task.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Set by the runtime's head in every worker process it starts.
WORKER_ENV = "RAY_TPU_TORCH_WORKER"
# Serializes first-use builds and loads: two kernels of one source, first
# launched from two threads at once, run one nvcc between them.
_BUILD_LOCK = threading.Lock()


def find_nvcc() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit
    PyTorch found; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME:
        candidates.append(os.path.join(cpp_extension.CUDA_HOME, "bin",
                                       "nvcc"))
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use")


class CudaKernel:
    """One kernel: its source, its C entry point, a launch count.

    `launches` is an integer that the kernel's Python wrapper adds one
    to (under a lock: actor threads launch concurrently) each time it
    launches the kernel, and nowhere else, so a run can show which
    kernels its path went through.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    # -- build -----------------------------------------------------------
    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / (f"lib{self.source.stem}-"
                            f"{digest.hexdigest()[:16]}.so")

    def compile_command(self, out: Path, verbose: bool = False) -> List[str]:
        cmd = [find_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        return cmd + ["-o", str(out), str(self.source)]

    def start_build(self, verbose: bool = False
                    ) -> Optional[subprocess.Popen]:
        """Start `nvcc` for this library; None if it is already built."""
        if self.library_path().exists():
            return None
        if os.environ.get(WORKER_ENV):
            raise RuntimeError(
                f"CUDA kernel {self.name}: {self.library_path().name} is "
                "not built; a worker process loads the kernel libraries "
                "its driver built and builds none itself")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library_path().with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(
            self.compile_command(tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> str:
        """Wait for `start_build`'s nvcc; returns its output, raises with
        it if the compile failed."""
        if proc is None:
            return ""
        out, _ = proc.communicate()
        if proc.returncode != 0:
            proc.tmp_path.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} "
                f"(exit {proc.returncode}):\n{out}")
        os.replace(proc.tmp_path, self.library_path())
        return out

    # -- load ------------------------------------------------------------
    def fn(self):
        """The C entry point, building the library first if needed."""
        if self._fn is None:
            with _BUILD_LOCK:
                if self._fn is None:
                    self.finish_build(self.start_build())
                    lib = ctypes.CDLL(str(self.library_path()))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    err = getattr(lib, "kernel_error_string")
                    err.argtypes = [ctypes.c_int]
                    err.restype = ctypes.c_char_p
                    self._error_string = err
                    self._lib = lib
                    self._fn = fn
        return self._fn

    def mapped_address(self, host_ptr: int) -> int:
        """The device-mapped address of the pinned host memory at
        `host_ptr`, through which this kernel writes a host output
        (`host_device_pointer` in the kernel's source). Raises for memory
        the card cannot map (pageable), before any launch."""
        self.fn()
        lookup = self._lib.host_device_pointer
        lookup.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lookup.restype = ctypes.c_int
        out = ctypes.c_void_p()
        code = lookup(host_ptr, ctypes.byref(out))
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(
                f"CUDA kernel {self.name}: the host buffer at "
                f"{host_ptr:#x} is not mapped for the card (pinned memory "
                f"is): {msg} (cudaError {code})")
        return out.value

    def launch(self, *args) -> None:
        """Call the entry point (it launches on the given stream and
        returns `cudaGetLastError()`); raise on a refused launch, count
        the launch otherwise."""
        code = self.fn()(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: {msg} "
                f"(cudaError {code})")
        with self._lock:
            self.launches += 1


def build_all(kernels: Iterable[CudaKernel], verbose: bool = False
              ) -> Dict[str, str]:
    """Build every kernel library not yet built, one `nvcc` per source,
    all started together. Returns {source file name: compiler output}
    (with `verbose=True`, ptxas's register/shared-memory/spill report
    for every entry point in the source)."""
    procs = {}
    with _BUILD_LOCK:
        for k in kernels:
            path = k.library_path()
            if path not in procs:
                procs[path] = (k, k.start_build(verbose))
        return {k.source.name: k.finish_build(p)
                for k, p in procs.values()}


def device_stream_handle(index: int) -> int:
    """The raw `cudaStream_t` of PyTorch's current stream on CUDA device
    `index`, as a Python int for ctypes. PyTorch's CUDA builds answer
    this in one call (`_cuda_getCurrentRawStream`, what its own compiled
    kernels launch on); without it, through a `torch.cuda.Stream`."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def stream_handle(tensor) -> int:
    """The raw `cudaStream_t` of PyTorch's current stream on the
    tensor's device, as a Python int for ctypes."""
    return device_stream_handle(tensor.get_device())
