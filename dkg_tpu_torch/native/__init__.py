"""ctypes bindings for the native host arithmetic runtime.

Counterpart of ``dkg_tpu/native/__init__.py`` over the port's own copy of
its C++ source (``dkg_native.cpp`` beside this file): batched field ops
over a fixed prime (64-bit limbs, Barrett), batched point addition and
scalar multiplication on twisted Edwards (a = -1) and short Weierstrass
(a = 0) curves, and ChaCha20.  ``NativeCurve.scalar_mul_ct`` is the
constant-structure Montgomery ladder every secret scalar of the port's
host groups goes through (``groups.host``): a fixed iteration count, a
branchless masked swap, limb helpers with no value-dependent branch or
early exit.  ``scalar_mul`` is the variable-time ladder, for public
scalars only.

The library is built with ``g++ -O3`` at first use into
``build/dkg_tpu_torch/`` under the repository root, named by a digest of
the compiler command and the source, so an edited source never loads a
stale build; the write is atomic (a temporary name, then a rename), so
processes that build at once each load a whole library.  A build that
fails raises :class:`NativeBuildError` with the compiler's log: there is
no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

MAXL = 8
SRC = pathlib.Path(__file__).resolve().parent / "dkg_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "dkg_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """g++ could not build the native runtime (the message holds its log)."""


class FieldCtxStruct(ctypes.Structure):
    _fields_ = [
        ("nlimbs", ctypes.c_uint64),
        ("p", ctypes.c_uint64 * (MAXL + 1)),
        ("mu", ctypes.c_uint64 * (MAXL + 2)),
    ]


class EdCtxStruct(ctypes.Structure):
    _fields_ = [("f", FieldCtxStruct), ("d2", ctypes.c_uint64 * MAXL)]


class WsCtxStruct(ctypes.Structure):
    _fields_ = [("f", FieldCtxStruct), ("b3", ctypes.c_uint64 * MAXL)]


def library_path(source: pathlib.Path | None = None, build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Where the library of ``source`` lands: ``build_dir`` (default
    BUILD_DIR) / libdkg_native-<digest of the flags and the source>.so."""
    source = SRC if source is None else pathlib.Path(source)
    build_dir = BUILD_DIR if build_dir is None else pathlib.Path(build_dir)
    h = hashlib.blake2b(" ".join(CXX_FLAGS).encode(), digest_size=8)
    h.update(source.read_bytes())
    return build_dir / f"libdkg_native-{h.hexdigest()}.so"


def build(source: pathlib.Path | None = None, build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Compile ``source`` (default: the port's ``dkg_native.cpp``) unless
    its library exists; returns the library's path.  Raises
    NativeBuildError with g++'s output if the build fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC if source is None else source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if it cannot be)."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    vp, u64, size = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t
    for name, argtypes in {
        "f_add_batch": [vp, u64p, u64p, u64p, size],
        "f_sub_batch": [vp, u64p, u64p, u64p, size],
        "f_mul_batch": [vp, u64p, u64p, u64p, size],
        "f_pow": [vp, u64p, u64p, u64, u64p],
        "ed_add_batch": [vp, u64p, u64p, u64p, size],
        "ed_scalar_mul_batch": [vp, u64p, u64, u64p, u64p, size],
        "ed_scalar_mul_ct_batch": [vp, u64p, u64, u64, u64p, u64p, size],
        "ws_add_batch": [vp, u64p, u64p, u64p, size],
        "ws_scalar_mul_batch": [vp, u64p, u64, u64p, u64p, size],
        "ws_scalar_mul_ct_batch": [vp, u64p, u64, u64, u64p, u64p, size],
        "chacha20_xor": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p, size],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


# ---------------------------------------------------------------------------
# int <-> 64-bit limb conversion
# ---------------------------------------------------------------------------


def limbs64(x: int, n: int) -> np.ndarray:
    """x as n little-endian 64-bit limbs; ValueError if it does not fit."""
    out = np.zeros(n, np.uint64)
    for i in range(n):
        out[i] = x & 0xFFFFFFFFFFFFFFFF
        x >>= 64
    if x:
        raise ValueError("does not fit")
    return out


def from_limbs64(a) -> int:
    acc = 0
    for i, v in enumerate(np.asarray(a, np.uint64).tolist()):
        acc |= int(v) << (64 * i)
    return acc


def nlimbs64(modulus: int) -> int:
    return (modulus.bit_length() + 63) // 64


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class NativeField:
    """Batched field ops over a fixed prime (64-bit-limb Barrett)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.n = nlimbs64(modulus)
        if self.n > MAXL:
            raise ValueError("modulus too wide for native runtime")
        ctx = FieldCtxStruct()
        ctx.nlimbs = self.n
        for i, v in enumerate(limbs64(modulus, self.n + 1)):
            ctx.p[i] = int(v)
        mu = (1 << (128 * self.n)) // modulus
        for i, v in enumerate(limbs64(mu, self.n + 2)):
            ctx.mu[i] = int(v)
        self._ctx = ctx

    def encode(self, vals) -> np.ndarray:
        vals = np.atleast_1d(np.asarray(vals, dtype=object))
        out = np.zeros((len(vals), self.n), np.uint64)
        for i, v in enumerate(vals):
            out[i] = limbs64(int(v) % self.modulus, self.n)
        return out

    def decode(self, arr) -> list[int]:
        arr = np.asarray(arr, np.uint64).reshape(-1, self.n)
        return [from_limbs64(row) for row in arr]

    def _binop(self, name, a, b):
        lib = _load()
        a = np.ascontiguousarray(a, np.uint64)
        b = np.ascontiguousarray(b, np.uint64)
        out = np.empty_like(a)
        getattr(lib, name)(ctypes.byref(self._ctx), _u64p(a), _u64p(b), _u64p(out), a.size // self.n)
        return out

    def add(self, a, b):
        return self._binop("f_add_batch", a, b)

    def sub(self, a, b):
        return self._binop("f_sub_batch", a, b)

    def mul(self, a, b):
        return self._binop("f_mul_batch", a, b)

    def pow(self, a, e: int):
        """a^e for a public exponent e (the loop follows e's bits)."""
        lib = _load()
        a = np.ascontiguousarray(a, np.uint64).reshape(self.n)
        el = np.ascontiguousarray(limbs64(e, (e.bit_length() + 63) // 64 or 1))
        out = np.empty(self.n, np.uint64)
        lib.f_pow(ctypes.byref(self._ctx), _u64p(a), _u64p(el), len(el), _u64p(out))
        return out

    def inv(self, a):
        return self.pow(a, self.modulus - 2)


class NativeCurve:
    """Batched point ops: ``"edwards"`` (a = -1, 4 coordinates, ``const``
    is 2d) or ``"weierstrass_a0"`` (3 coordinates, ``const`` is 3b)."""

    def __init__(self, kind: str, modulus: int, const: int):
        self.kind = kind
        self.field = NativeField(modulus)
        n = self.field.n
        if kind == "edwards":
            ctx = EdCtxStruct()
            tgt = ctx.d2
        elif kind == "weierstrass_a0":
            ctx = WsCtxStruct()
            tgt = ctx.b3
        else:
            raise ValueError(kind)
        ctx.f = self.field._ctx
        for i, v in enumerate(limbs64(const % modulus, n)):
            tgt[i] = int(v)
        self._ctx = ctx
        self.ncoords = 4 if kind == "edwards" else 3
        self._prefix = "ed" if kind == "edwards" else "ws"

    def encode_points(self, pts) -> np.ndarray:
        out = np.zeros((len(pts), self.ncoords, self.field.n), np.uint64)
        for i, p in enumerate(pts):
            for c in range(self.ncoords):
                out[i, c] = limbs64(int(p[c]) % self.field.modulus, self.field.n)
        return out

    def decode_points(self, arr) -> list[tuple]:
        arr = np.asarray(arr, np.uint64).reshape(-1, self.ncoords, self.field.n)
        return [tuple(from_limbs64(row[c]) for c in range(self.ncoords)) for row in arr]

    def add(self, p, q):
        lib = _load()
        p = np.ascontiguousarray(p, np.uint64)
        q = np.ascontiguousarray(q, np.uint64)
        out = np.empty_like(p)
        getattr(lib, f"{self._prefix}_add_batch")(ctypes.byref(self._ctx), _u64p(p), _u64p(q), _u64p(out),
                                                 p.size // (self.ncoords * self.field.n))
        return out

    def _scalar_mul_impl(self, suffix, scalars, points, scalar_modulus, extra):
        """The marshalling the two ladders share: they differ by the C
        function's suffix and the extra arguments before the points."""
        lib = _load()
        sl = nlimbs64(scalar_modulus)
        ss = np.zeros((len(scalars), sl), np.uint64)
        for i, s in enumerate(scalars):
            ss[i] = limbs64(int(s) % scalar_modulus, sl)
        points = np.ascontiguousarray(points, np.uint64)
        out = np.empty_like(points)
        getattr(lib, f"{self._prefix}_scalar_mul{suffix}")(
            ctypes.byref(self._ctx), _u64p(ss), sl, *extra, _u64p(points), _u64p(out), len(scalars))
        return out

    def scalar_mul(self, scalars, points, scalar_modulus: int):
        """Variable-time double-and-add from the top set bit; PUBLIC scalars only."""
        return self._scalar_mul_impl("_batch", scalars, points, scalar_modulus, ())

    def scalar_mul_ct(self, scalars, points, scalar_modulus: int):
        """The constant-structure Montgomery ladder over the scalar field's
        whole bit length: the secret-scalar path.  Limb for limb the
        Python ladder ``groups.host._scalar_mul_ladder``."""
        return self._scalar_mul_impl("_ct_batch", scalars, points, scalar_modulus, (scalar_modulus.bit_length(),))


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
    """RFC 8439 ChaCha20 keystream (32-byte key, 12-byte nonce, block
    counter from ``counter``) XORed into ``data``."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("chacha20 needs a 32-byte key and a 12-byte nonce")
    lib = _load()
    out = ctypes.create_string_buffer(len(data))
    lib.chacha20_xor(key, nonce, counter, bytes(data), out, len(data))
    return out.raw
