"""Build the CUDA sources with nvcc, load them with ctypes, launch them.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/dkg_tpu_torch/<stem>-<digest>.so csrc/<stem>.cu

The library lands in ``build/dkg_tpu_torch/`` under the repository root,
named by a digest of the compiler flags and every file in ``csrc/``, so
an edited source never loads a stale build.  Builds happen at first use;
:func:`build` starts one ``nvcc`` per source, all at once.  A source may
also be built with extra ``-D`` defines (``defines``, e.g. another group
size for ``ops/horner_bench.py``): each set is a library of its own.

A :class:`Kernel` is one C entry point.  Every entry returns
``cudaGetLastError()`` after its launch, and the kernel raises if that is
not 0.  Pointers and the stream travel as ``c_void_p`` and sizes as
``c_int64``, so nothing is cut to 32 bits.  ``launches`` counts the
launches that reached the card, exactly under threads (the ceremony
service launches from several workers at once): the count is bumped under
the kernel's own lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "dkg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("field_kernels.cu", "point_kernels.cu", "edwards_kernels.cu", "double_kernels.cu",
           "bucket_kernels.cu", "bls_kernels.cu", "mxu_kernels.cu", "ladder_kernels.cu", "chain_kernels.cu",
           "inv_kernels.cu", "pippenger_kernels.cu")

_LOCK = threading.Lock()
_LIBS: dict[tuple, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # source (and defines) -> nvcc's output (registers, spills)

PTR = ctypes.c_void_p
I64 = ctypes.c_int64
INT = ctypes.c_int


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is installed")


def library_path(source: str, defines: tuple = ()) -> pathlib.Path:
    h = hashlib.blake2b(" ".join(NVCC_FLAGS + tuple(defines)).encode(), digest_size=8)
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    h.update(source.encode())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()}.so"


def label(source: str, defines: tuple = ()) -> str:
    """``source``, with its extra defines if it has any."""
    return " ".join((source, *defines))


def build(sources=SOURCES, variants=()) -> dict[str, pathlib.Path]:
    """Compile every source that has no library yet, all in parallel, and
    every (source, defines) pair of ``variants``.

    Raises with nvcc's output if any build fails."""
    with _LOCK:
        return _build_locked([(s, ()) for s in sources] + list(variants))


def _build_locked(jobs) -> dict[str, pathlib.Path]:
    paths = {label(s, d): library_path(s, d) for s, d in jobs}
    todo = {(s, tuple(d)) for s, d in jobs if not paths[label(s, d)].exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for src, defines in todo:
        out = paths[label(src, defines)]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(CSRC / src)]
        procs[label(src, defines)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``source`` (built with ``defines``), built on
    first use."""
    key = (source, tuple(defines))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            path = _build_locked([key])[label(*key)]
            lib = ctypes.CDLL(str(path))
            lib.dkg_error_string.argtypes = [ctypes.c_int]
            lib.dkg_error_string.restype = ctypes.c_char_p
            _LIBS[key] = lib
        return lib


class Kernel:
    """One C entry point of a CUDA source, with its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list, defines: tuple = ()):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.defines = tuple(defines)
        self._argtypes = argtypes
        self._fn = None
        self._count_lock = threading.Lock()
        self.launches = 0
        #: launches by the route a wrapper names, of ``launches`` (a
        #: "convoy": more than one weight or digit block in the launch)
        self.route_launches: dict = {}

    def variant(self, *defines: str) -> Kernel:
        """The same entry point from the source built with extra defines."""
        return Kernel(f"{self.name} {' '.join(defines)}", self.source, self.symbol, self._argtypes, defines)

    def __call__(self, *args, route: str | None = None) -> None:
        if self._fn is None:
            fn = getattr(load(self.source, self.defines), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = load(self.source, self.defines).dkg_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {rc} ({msg})")
        with self._count_lock:  # a bare += loses counts between threads
            self.launches += 1
            if route is not None:
                self.route_launches[route] = self.route_launches.get(route, 0) + 1


def check_operands(operands: list) -> torch.device:
    """Every ``(tensor, tail)`` of ``operands`` ends in its tail (no size-1
    axis broadcast into it) and is int32 on one CUDA device; returns it."""
    dev = operands[0][0].device
    for t, tail in operands:
        if t.dim() < len(tail) or tuple(t.shape[t.dim() - len(tail):]) != tuple(tail):
            raise ValueError(f"kernel operand of shape {tuple(t.shape)} does not end in {tuple(tail)}")
    for t, _ in operands:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operands are int32 limbs, got {t.dtype}")
    return dev


def rows(t: torch.Tensor, batch: tuple, tail: tuple) -> tuple[torch.Tensor, int]:
    """``t`` (a batch broadcast to ``batch``, then ``tail``) as contiguous
    rows ``(R, *tail)`` and the count of consecutive batch entries that
    share a row: the batch axes over which ``t`` is broadcast at the end
    share one row, so nothing is copied along them (R = 1 for a ``t``
    shared by the whole batch)."""
    lead = (1,) * (len(batch) - (t.dim() - len(tail))) + tuple(t.shape[: t.dim() - len(tail)])
    k = len(batch)
    while k > 0 and lead[k - 1] == 1:
        k -= 1
    per_row = 1
    for d in batch[k:]:
        per_row *= d
    r = t.reshape(lead + tuple(tail)).expand(tuple(batch[:k]) + lead[k:] + tuple(tail))
    r = r.reshape((-1,) + tuple(tail)).contiguous()
    if r.data_ptr() % 16:
        r = r.clone()
    return r, per_row


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (the
    kernels load a point's limbs four at a time)."""
    return t.clone(memory_format=torch.contiguous_format) if t.data_ptr() % 16 else t


def lanes(operands: list, out_tail: tuple) -> tuple[list, torch.Tensor, int]:
    """Operands as a launch takes them: ``operands`` is a list of
    ``(tensor, tail)`` pairs (a point's tail is (C, L), a scalar's (L,), a
    per-lane int's ()).  Every tensor must end in its tail (no size-1 axis
    broadcast into it) and be int32 on one CUDA device.
    Returns each operand broadcast to the common batch and contiguous
    (lane i of it starts at i * its tail size), the uninitialised int32
    output ``batch + out_tail``, and the number of lanes."""
    dev = check_operands(operands)
    batch = torch.broadcast_shapes(*(t.shape[: t.dim() - len(tail)] for t, tail in operands))
    flat = [t.expand(batch + tail).contiguous() for t, tail in operands]
    out = torch.empty(batch + out_tail, dtype=torch.int32, device=dev)
    return flat, out, out.numel() // max(1, torch.Size(out_tail).numel())


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
