"""Fixed-base window tables for the generator g and the Pedersen base h,
kept in the process and on disk.

Counterpart of ``dkg_tpu/groups/precompute.py``.  The deal is
fixed-base bound: every coefficient commitment is g·a + h·b through window
tables (``groups.device.fixed_base_mul``), and g and h never change for a
ceremony environment, so the tables are a durable artifact:

* an in-process cache keyed ``(curve, base, window)`` (and the device, for
  the tensors): a second ceremony in a process pays no table cost;
* a disk cache: a second process pays one validated ``np.load`` in place
  of a build.  Files are written atomically (temp file and
  ``os.replace``) and carry a BLAKE2b digest over a header (format
  version, curve, window, base key, shape, dtype) and the table bytes; a
  missing, truncated, mis-shaped or tampered file is treated as absent
  and the table rebuilt (counted in ``disk_rejects``).  The cache is an
  optimisation, never a trust root.  The file name, format and digest are
  the JAX package's, so a file either package writes loads in the other,
  bit for bit.  An unwritable cache directory degrades to a build in
  every process, as there.

The table is a fixed-window comb, ``T[w][d] = d·(2**c)^w·B``: k = Σ_w
d_w·(2**c)^w·B is NW gathered mixed adds and no doublings
(:func:`comb_mul`).  A table of at most 8 bits missing from both caches
is built where it will be read: on a card by
``groups.device.fixed_base_table_dev`` (one ``pt_ladder_mul_add`` over
every entry, then one ``affine_canon``), elsewhere on the host
(``groups.device.fixed_table_host``); both give the same limbs, which are
what is persisted.  Wider ones are composed on the table's device from the
half-width table (``groups.device._compose_table_dev``, one ``pt_add``
over every entry, then one ``affine_canon``) and kept in the process only.

:func:`stats` counts builds (on the host or the card), disk loads and rejects, and process-cache
hits, with their seconds: ``dkg.ceremony`` records the delta of one
ceremony's tables in its trace (``table_cache``).  One re-entrant lock
serialises the builds, so N threads warming the same table make one
build or load and N - 1 ``proc_hits``.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import tempfile
import threading
import time

import numpy as np
import torch

from ..fields import host as fh
from ..utils import envknobs
from . import device as gd

base_key = gd.base_key
base_key_to_point = gd.base_key_to_point

_FORMAT_VERSION = 1

# in-process device-table cache: (curve, base_key, window, device) -> tensor
_TABLES: dict = {}
# in-process host-table cache (the persisted artifact): (curve, base_key, window) -> ndarray
_HOST: dict = {}

# One re-entrant lock (base_table -> host_table nests): builds are rare
# and cache hits pay only an uncontended acquire.
_BUILD_LOCK = threading.RLock()

_STATS = {
    "builds": 0,  # host tables computed from scratch
    "build_s": 0.0,
    "disk_loads": 0,  # host tables loaded (and validated) from disk
    "load_s": 0.0,
    "disk_rejects": 0,  # on-disk files that failed validation
    "proc_hits": 0,  # served from the in-process caches
}


def stats() -> dict:
    """Snapshot of the cache counters (a copy, safe to diff)."""
    return dict(_STATS)


def reset(clear_disk: bool = False) -> None:
    """Drop the in-process caches and zero the counters.  With
    ``clear_disk`` also remove the table files in :func:`cache_dir`."""
    with _BUILD_LOCK:
        _TABLES.clear()
        _HOST.clear()
        for k in _STATS:
            _STATS[k] = 0 if isinstance(_STATS[k], int) else 0.0
    if clear_disk:
        d = cache_dir()
        if d.is_dir():
            for f in d.glob("*.npz"):
                try:
                    f.unlink()
                except OSError:
                    pass


def cache_dir() -> pathlib.Path:
    """Where table files live: ``DKG_TPU_TABLE_CACHE`` if set, else
    ``dkg_tpu_fb_tables/`` in the system temp directory."""
    env = envknobs.string("DKG_TPU_TABLE_CACHE", "fixed-base table cache directory")
    if env is not None:
        return pathlib.Path(env)
    return pathlib.Path(tempfile.gettempdir()) / "dkg_tpu_fb_tables"


def _table_path(cs: gd.CurveSpec, key: tuple, window: int) -> pathlib.Path:
    kh = hashlib.blake2b(repr(key).encode(), digest_size=8).hexdigest()
    return cache_dir() / f"fb_v{_FORMAT_VERSION}_{cs.name}_w{window}_{kh}.npz"


def _digest(cs: gd.CurveSpec, key: tuple, window: int, table: np.ndarray) -> bytes:
    header = f"{_FORMAT_VERSION}|{cs.name}|{window}|{key!r}|{table.shape}|{table.dtype}"
    return hashlib.blake2b(header.encode() + table.tobytes(), digest_size=32).digest()


def _load_disk(cs: gd.CurveSpec, key: tuple, window: int) -> np.ndarray | None:
    """Validated load: any failure (missing, truncated, wrong shape or
    dtype, digest mismatch) returns None and the caller rebuilds; a file
    that exists but fails counts in ``disk_rejects``."""
    path = _table_path(cs, key, window)
    try:
        with np.load(path, allow_pickle=False) as z:
            table = np.asarray(z["table"])
            digest = np.asarray(z["digest"]).tobytes()
    except Exception:  # noqa: BLE001 -- every unreadable file means: rebuild
        if path.exists():
            _STATS["disk_rejects"] += 1
        return None
    expect = (gd.n_windows(cs, window), 1 << window, cs.ncoords, cs.field.limbs)
    if table.shape != expect or table.dtype != np.uint32 or digest != _digest(cs, key, window, table):
        _STATS["disk_rejects"] += 1
        return None
    return table


def _persist(cs: gd.CurveSpec, key: tuple, window: int, table: np.ndarray) -> None:
    """Atomic best-effort write (temp file and rename); an unwritable
    cache directory degrades to building in every process, never an
    error."""
    path = _table_path(cs, key, window)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd_, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd_, "wb") as fh_:
                np.savez(fh_, table=table,
                         digest=np.frombuffer(_digest(cs, key, window, table), dtype=np.uint8))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError:
        pass


def host_table(cs: gd.CurveSpec, key: tuple, window: int = gd.FIXED_WINDOW) -> np.ndarray:
    """(NW, 2**window, C, L) uint32 host table for the base ``key``
    (:func:`base_key`), through the caches: the process's, then a
    validated disk file, else a build (``groups.device.fixed_table_host``)
    that is then persisted."""
    ck = (cs.name, key, window)
    with _BUILD_LOCK:
        hit = _HOST.get(ck)
        if hit is not None:
            _STATS["proc_hits"] += 1
            return hit
        t0 = time.perf_counter()
        table = _load_disk(cs, key, window)
        if table is not None:
            _STATS["disk_loads"] += 1
            _STATS["load_s"] += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            table = gd.fixed_table_host(cs, key, window)
            _STATS["builds"] += 1
            _STATS["build_s"] += time.perf_counter() - t0
            _persist(cs, key, window, table)
        _HOST[ck] = table
        return table


# The card's default window is FIXED_WINDOW (8) on every curve, decided on
# the card (PERF.md §7; H100, chip_smoke.py's tables phase): window 16
# halves pt_fixed_base (secp256k1 3.97 -> 2.00 ms at the deal's 350,208
# lanes, BLS12-381 12.39 -> 6.36, ristretto255 0.24 -> 0.11 at 22,016), but
# its two composes (2.59 / 6.34 / 2.90 ms a base) cost a first run as much
# or more than a ceremony's four launches save, and a table takes 201 MB
# (268 on ristretto255, 302 on BLS12-381) against window 8's 1.6-2.4 MB.


def _default_window() -> int:
    """The validated DKG_TPU_FB_WINDOW override (4, 8 or 16), else
    ``FIXED_WINDOW``."""
    window = envknobs.pos_int("DKG_TPU_FB_WINDOW", "fixed-base window width in bits: 4, 8 or 16")
    if window is None:
        return gd.FIXED_WINDOW
    if window not in (4, 8, 16):
        raise ValueError(f"DKG_TPU_FB_WINDOW={window}: expected a fixed-base window width of 4, 8 or 16 bits")
    return window


def _builds_on_card(device) -> bool:
    """Whether a missing table of at most 8 bits builds where ``device``
    is (a card) rather than on the host."""
    return torch.device(device).type == "cuda"


def _narrow_table(cs: gd.CurveSpec, key: tuple, window: int, device: str) -> torch.Tensor:
    """A table of at most 8 bits on ``device``.  Off a card, the host
    table (:func:`host_table`).  On a card, a validated disk file uploaded,
    else a build there (``groups.device.fixed_base_table_dev``: one
    ``pt_ladder_mul_add`` and one ``affine_canon``) that is then
    persisted; the file is the host build's, limb for limb."""
    if not _builds_on_card(device):
        return fh.to_tensor(host_table(cs, key, window), device)
    t0 = time.perf_counter()
    table = _load_disk(cs, key, window)
    if table is not None:
        _STATS["disk_loads"] += 1
        _STATS["load_s"] += time.perf_counter() - t0
        return fh.to_tensor(table, device)
    t0 = time.perf_counter()
    built = gd.fixed_base_table_dev(cs, base_key_to_point(cs, key), window, device=device)
    host = fh.from_tensor(built)
    _STATS["builds"] += 1
    _STATS["build_s"] += time.perf_counter() - t0
    _persist(cs, key, window, host)
    return built


def base_table(cs: gd.CurveSpec, base, window: int | None = None, *, device) -> torch.Tensor:
    """The window table of a fixed host point ``base`` on ``device``,
    through the caches, kept per (curve, base, window, device); ``window``
    defaults to :func:`_default_window`.  Up to 8 bits the table is
    :func:`_narrow_table`'s; wider ones are composed on ``device`` from
    the half-width table (one ``pt_add`` over every entry and one
    ``affine_canon``)."""
    if window is None:
        window = _default_window()
    key = base_key(cs, base)
    dev = str(torch.device(device))
    ck = (cs.name, key, window, dev)
    with _BUILD_LOCK:
        hit = _TABLES.get(ck)
        if hit is not None:
            _STATS["proc_hits"] += 1
            return hit
        if window > 8:
            table = gd.composed_table(cs, lambda half: base_table(cs, base, half, device=dev), window)
        else:
            table = _narrow_table(cs, key, window, dev)
        _TABLES[ck] = table
        return table


def generator_table(cs: gd.CurveSpec, window: int | None = None, *, device) -> torch.Tensor:
    """:func:`base_table` for the curve generator g."""
    return base_table(cs, gd.gen_host(cs), window, device=device)


def comb_mul(cs: gd.CurveSpec, table: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Batched fixed-base k·B over a comb table: NW gathered mixed adds,
    no doublings, in one ``pt_fixed_base`` launch
    (``groups.device.fixed_base_mul``); the window width is the table's
    entry count."""
    return gd.fixed_base_mul(cs, table, k)
