"""Durable per-party checkpoint log: a copy of
``dkg_tpu/net/checkpoint.py``'s :class:`PartyWal` (less ``reset``, which
only ``run_party`` calls), :func:`wal_path`, :func:`service_wal_path`
and :func:`default_checkpoint_dir`.

Before each step's publish a party appends one record (the exact wire
payload and what it needs to resume; ``utils.serde``'s epoch records for
the epoch manager).  A restarted process replays the log, re-publishes
the recorded steps (first-publish-wins makes that idempotent), re-reads
closed rounds from the channel's retained mailboxes and continues live
from the first unfinished step.  Write-*ahead*, because a step that
consumes the caller's ``rng`` would publish different bytes if
recomputed after a crash: equivocation under first-publish-wins.

File format (version 1)::

    header  b"DKGWAL" <u8 version>
    record  <u32 body_len> <body> <16-byte BLAKE2b-128(body)>

Appends are a single ``os.write`` on an ``O_APPEND`` descriptor followed
by ``fsync``; the file is created ``0600`` because record bodies carry
secret share material.  Replay is torn-tail tolerant: the first
truncated or checksum-failing record ends it and the valid prefix is
returned; a fully unusable log (bad header, unreadable file) replays to
nothing and the party runs fresh.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import struct
from typing import Optional, Union

from ..utils import envknobs

WAL_MAGIC = b"DKGWAL"
WAL_VERSION = 1
_HEADER = WAL_MAGIC + bytes([WAL_VERSION])
_DIGEST_LEN = 16  # BLAKE2b-128: torn/corrupt tail detection, not authentication


def _digest(body: bytes) -> bytes:
    return hashlib.blake2b(body, digest_size=_DIGEST_LEN).digest()


def default_checkpoint_dir() -> Optional[str]:
    """Operator override for where party WALs live (None = caller's
    choice); set ``DKG_TPU_CHECKPOINT_DIR`` (utils.envknobs: empty value
    means unset)."""
    return envknobs.string(
        "DKG_TPU_CHECKPOINT_DIR", "directory for party checkpoint WALs"
    )


def wal_path(directory: Union[str, os.PathLike], index: int) -> pathlib.Path:
    """Canonical WAL location for party ``index`` (1-based) under
    ``directory`` — one file per party so concurrent parties never share
    a descriptor."""
    return pathlib.Path(directory) / f"party{index:04d}.wal"


def service_wal_path(directory: Union[str, os.PathLike]) -> pathlib.Path:
    """Canonical WAL location for a ceremony-service journal
    (``service.durable``) under ``directory``: one journal a server
    process, so kill-and-restart recovery is a single replay."""
    return pathlib.Path(directory) / "service.wal"


class PartyWal:
    """Append-only, checksummed, fsync'd record log at ``path``.

    Every append is atomic in practice (one ``O_APPEND`` write and an
    fsync) and every replay is torn-tail tolerant.
    """

    def __init__(self, path: Union[str, os.PathLike]) -> None:
        self.path = pathlib.Path(path)

    # -- writing ------------------------------------------------------------

    def append(self, body: bytes) -> None:
        """Durably append one record: length prefix, body, checksum —
        written as ONE os.write so a crash leaves either nothing or a
        torn tail that replay discards, then fsync'd before returning
        (the caller may publish the bytes only after this returns)."""
        frame = struct.pack("<I", len(body)) + body + _digest(body)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600
        )
        try:
            if os.fstat(fd).st_size == 0:
                frame = _HEADER + frame
            os.write(fd, frame)
            os.fsync(fd)
        finally:
            os.close(fd)

    def rewrite(self, bodies: list[bytes]) -> None:
        """Atomically replace the log with exactly ``bodies`` (header and
        checksummed frames), through a temp file, fsync and
        ``os.replace``: the service journal compacts through this on
        recovery, so a torn tail never shadows the appends after it."""
        frames = [_HEADER]
        for body in bodies:
            frames.append(struct.pack("<I", len(body)) + body + _digest(body))
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(self.path.name + ".tmp")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, b"".join(frames))
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self.path)

    # -- reading ------------------------------------------------------------

    def replay(self) -> list[bytes]:
        """All intact record bodies, in append order.  NEVER raises: a
        missing/unreadable file or bad header replays to ``[]``; the
        first truncated or checksum-failing record ends the replay and
        the valid prefix is returned (torn-tail tolerance)."""
        try:
            data = self.path.read_bytes()
        except OSError:
            return []
        if not data.startswith(_HEADER):
            return []
        out: list[bytes] = []
        pos = len(_HEADER)
        while pos < len(data):
            if pos + 4 > len(data):
                break  # torn length prefix
            (ln,) = struct.unpack("<I", data[pos : pos + 4])
            end = pos + 4 + ln + _DIGEST_LEN
            if end > len(data):
                break  # torn body/checksum
            body = data[pos + 4 : pos + 4 + ln]
            if data[pos + 4 + ln : end] != _digest(body):
                break  # corrupt record: discard it and everything after
            out.append(body)
            pos = end
        return out
