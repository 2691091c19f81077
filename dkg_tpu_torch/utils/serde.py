"""Deterministic binary serialization: wire messages, phase snapshots
and WAL records.

A copy of ``dkg_tpu/utils/serde.py`` over the port's wire types
(``dkg.broadcast``, ``dkg.committee``, ``crypto.elgamal``), the same
bytes for the same objects:

* :class:`Writer` / :class:`Reader`: fixed-width little-endian integers,
  u32-length-prefixed byte strings, the group's fixed-size point and
  scalar encodings; any malformed input raises ValueError;
* the codecs of hybrid ciphertexts, ``EncryptedShares``, DLEQ proofs
  and ``ProofOfMisbehaviour``, and of the five broadcasts
  (``encode_phase1..5`` / ``decode_phase1..5``, a decode of bad bytes
  giving None) with the ``*_wire_bytes`` sizes;
* :func:`checkpoint` / :func:`restore` of a committee phase object and
  its whole state, so a party can stop after any phase and resume;
* the WAL records of ``net.checkpoint``: :class:`RoundRecord` (magic
  b"DKGR") for the ceremony's rounds and :class:`EpochRecord` (b"DKGE")
  for the epoch manager's steps.

No pickle: decoding untrusted bytes never executes anything.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

from ..crypto.correct_decryption import CorrectHybridDecrKeyZkp
from ..crypto.dleq import DleqZkp
from ..crypto.elgamal import HybridCiphertext, Keypair, SymmetricKey
from ..dkg import broadcast as bc
from ..dkg import committee as cm
from ..dkg.errors import DkgError, DkgErrorKind
from ..dkg.procedure_keys import MemberCommunicationKey, MemberCommunicationPublicKey

_ERR_CODES = {k: i for i, k in enumerate(DkgErrorKind)}
_ERR_FROM = {i: k for k, i in _ERR_CODES.items()}

MAGIC = b"DKGT"
VERSION = 1


class Writer:
    """Builds one message.  A point written twice is encoded once (a
    sealed pair's two halves carry the same KEM point ``e1``): the
    host's ristretto255 encoding costs an inverse square root a point."""

    def __init__(self, group):
        self.g = group
        self.buf = bytearray()
        self._encoded: dict = {}

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)

    def u32(self, v: int):
        self.buf += struct.pack("<I", v)

    def raw(self, b: bytes):
        self.buf += b

    def lp(self, b: bytes):
        self.u32(len(b))
        self.raw(b)

    def point(self, p):
        key = tuple(p)
        enc = self._encoded.get(key)
        if enc is None:
            enc = self._encoded[key] = self.g.encode(p)
        self.raw(enc)

    def scalar(self, s: int):
        self.raw(self.g.scalar_to_bytes(s))

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Reader:
    """Reads one message; equal point encodings decode once, to one
    tuple."""

    class Bad(ValueError):
        pass

    def __init__(self, group, data: bytes):
        self.g = group
        self.data = data
        self.pos = 0
        self._decoded: dict = {}
        self._point_len = len(group.encode(group.identity()))
        self._scalar_len = group.scalar_field.nbytes

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise Reader.Bad("truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def lp(self) -> bytes:
        return self.take(self.u32())

    def point(self):
        enc = bytes(self.take(self._point_len))
        p = self._decoded.get(enc)
        if p is None:
            p = self.g.decode(enc)
            if p is None:
                raise Reader.Bad("invalid point encoding")
            self._decoded[enc] = p
        return p

    def scalar(self) -> int:
        s = self.g.scalar_from_bytes(self.take(self._scalar_len))
        if s is None:
            raise Reader.Bad("non-canonical scalar")
        return s

    def done(self):
        if self.pos != len(self.data):
            raise Reader.Bad("trailing bytes")


# ---------------------------------------------------------------------------
# wire-message codecs
# ---------------------------------------------------------------------------


def _w_hybrid(w: Writer, c: HybridCiphertext):
    w.point(c.e1)
    w.lp(c.ciphertext)


def _r_hybrid(r: Reader) -> HybridCiphertext:
    return HybridCiphertext(r.point(), r.lp())


def _w_shares(w: Writer, es: bc.EncryptedShares):
    w.u16(es.recipient_index)
    _w_hybrid(w, es.share_ct)
    _w_hybrid(w, es.randomness_ct)


def _r_shares(r: Reader) -> bc.EncryptedShares:
    return bc.EncryptedShares(r.u16(), _r_hybrid(r), _r_hybrid(r))


def _w_dleq(w: Writer, p: DleqZkp):
    w.scalar(p.challenge)
    w.scalar(p.response)


def _r_dleq(r: Reader) -> DleqZkp:
    return DleqZkp(r.scalar(), r.scalar())


def _w_proof(w: Writer, p: bc.ProofOfMisbehaviour):
    w.point(p.symm_key_share.point)
    w.point(p.symm_key_rand.point)
    _w_dleq(w, p.proof_share.proof)
    _w_dleq(w, p.proof_rand.proof)


def _r_proof(r: Reader) -> bc.ProofOfMisbehaviour:
    return bc.ProofOfMisbehaviour(
        SymmetricKey(r.point()),
        SymmetricKey(r.point()),
        CorrectHybridDecrKeyZkp(_r_dleq(r)),
        CorrectHybridDecrKeyZkp(_r_dleq(r)),
    )


def phase1_wire_bytes(group, n: int, t: int) -> int:
    """Exact encoded size of one fault-free ``BroadcastPhase1`` for
    (group, n, t): the analytic twin of :func:`encode_phase1`."""
    point = len(group.encode(group.identity()))
    scalar = group.scalar_field.nbytes
    # HybridCiphertext: e1 point + u32-length-prefixed stream ciphertext
    # (ChaCha20: ciphertext length == plaintext scalar length)
    hybrid = point + 4 + scalar
    # u16 coeff count + (t+1) commitment points, then u16 share count +
    # n entries of (u16 recipient + share ct + randomness ct)
    return 2 + (t + 1) * point + 2 + n * (2 + 2 * hybrid)


def phase3_wire_bytes(group, n: int, t: int) -> int:
    """Exact encoded size of one ``BroadcastPhase3`` (the bare
    commitments every qualified dealer reveals): u16 count + (t+1)
    points.  Published by every party in every ceremony, faults or
    not."""
    point = len(group.encode(group.identity()))
    return 2 + (t + 1) * point


def party_wire_bytes(group, n: int, t: int) -> int:
    """Payload bytes ONE party publishes across a fault-free ceremony:
    its phase-1 dealing plus its phase-3 bare commitments; rounds 2, 4,
    and 5 publish empty payloads (no complaints, no disclosures)."""
    return phase1_wire_bytes(group, n, t) + phase3_wire_bytes(group, n, t)


def ceremony_wire_bytes(group, n: int, t: int) -> int:
    """Total payload bytes published across one fault-free ceremony (all
    n parties), framing excluded."""
    return n * party_wire_bytes(group, n, t)


def encode_phase1(group, b: bc.BroadcastPhase1) -> bytes:
    w = Writer(group)
    w.u16(len(b.committed_coefficients))
    for p in b.committed_coefficients:
        w.point(p)
    w.u16(len(b.encrypted_shares))
    for es in b.encrypted_shares:
        _w_shares(w, es)
    return w.bytes()


def decode_phase1(group, data: bytes) -> Optional[bc.BroadcastPhase1]:
    try:
        r = Reader(group, data)
        coeffs = tuple(r.point() for _ in range(r.u16()))
        shares = tuple(_r_shares(r) for _ in range(r.u16()))
        r.done()
        return bc.BroadcastPhase1(coeffs, shares)
    except (ValueError, struct.error):  # Reader.Bad is a ValueError
        return None


def encode_phase2(group, b: bc.BroadcastPhase2) -> bytes:
    w = Writer(group)
    w.u16(len(b.misbehaving_parties))
    for m in b.misbehaving_parties:
        w.u16(m.accused_index)
        w.u8(_ERR_CODES[m.error])
        _w_proof(w, m.proof)
    return w.bytes()


def decode_phase2(group, data: bytes) -> Optional[bc.BroadcastPhase2]:
    try:
        r = Reader(group, data)
        ms = []
        for _ in range(r.u16()):
            idx = r.u16()
            err = _ERR_FROM.get(r.u8())
            if err is None:
                raise Reader.Bad("unknown error code")
            ms.append(bc.MisbehavingPartiesRound1(idx, err, _r_proof(r)))
        r.done()
        return bc.BroadcastPhase2(tuple(ms))
    except (ValueError, struct.error):  # Reader.Bad is a ValueError
        return None


def encode_phase3(group, b: bc.BroadcastPhase3) -> bytes:
    w = Writer(group)
    w.u16(len(b.committed_coefficients))
    for p in b.committed_coefficients:
        w.point(p)
    return w.bytes()


def decode_phase3(group, data: bytes) -> Optional[bc.BroadcastPhase3]:
    try:
        r = Reader(group, data)
        coeffs = tuple(r.point() for _ in range(r.u16()))
        r.done()
        return bc.BroadcastPhase3(coeffs)
    except (ValueError, struct.error):  # Reader.Bad is a ValueError
        return None


def encode_phase4(group, b: bc.BroadcastPhase4) -> bytes:
    w = Writer(group)
    w.u16(len(b.misbehaving_parties))
    for m in b.misbehaving_parties:
        w.u16(m.accused_index)
        w.scalar(m.share)
        w.scalar(m.randomness)
    return w.bytes()


def decode_phase4(group, data: bytes) -> Optional[bc.BroadcastPhase4]:
    try:
        r = Reader(group, data)
        ms = tuple(
            bc.MisbehavingPartiesRound3(r.u16(), r.scalar(), r.scalar())
            for _ in range(r.u16())
        )
        r.done()
        return bc.BroadcastPhase4(ms)
    except (ValueError, struct.error):  # Reader.Bad is a ValueError
        return None


def encode_phase5(group, b: bc.BroadcastPhase5) -> bytes:
    w = Writer(group)
    w.u16(len(b.disclosed_shares))
    for d in b.disclosed_shares:
        w.u16(d.accused_index)
        w.u16(d.holder_index)
        w.scalar(d.share)
    return w.bytes()


def decode_phase5(group, data: bytes) -> Optional[bc.BroadcastPhase5]:
    try:
        r = Reader(group, data)
        ds = tuple(
            bc.DisclosedShare(r.u16(), r.u16(), r.scalar()) for _ in range(r.u16())
        )
        r.done()
        return bc.BroadcastPhase5(ds)
    except (ValueError, struct.error):  # Reader.Bad is a ValueError
        return None


# ---------------------------------------------------------------------------
# phase snapshots (checkpoint / resume)
# ---------------------------------------------------------------------------

_PHASES = {
    "phase1": cm.DkgPhase1,
    "phase2": cm.DkgPhase2,
    "phase3": cm.DkgPhase3,
    "phase4": cm.DkgPhase4,
    "phase5": cm.DkgPhase5,
}
_PHASE_NAMES = {v: k for k, v in _PHASES.items()}


def checkpoint(group, phase) -> bytes:
    """Serialize a phase object (+ its full state) to bytes."""
    st: cm._State = phase._state
    w = Writer(group)
    w.raw(MAGIC)
    w.u8(VERSION)
    name = _PHASE_NAMES[type(phase)].encode()
    w.lp(name)
    w.u16(st.env.threshold)
    w.u16(st.env.nr_members)
    w.point(st.env.commitment_key.h)
    w.u16(st.index)
    w.scalar(st.comm_key.sk)
    for pk in st.members_pks:
        w.point(pk.point)
    w.u16(len(st.bare_coeff_points))
    for p in st.bare_coeff_points:
        w.point(p)
    for p in st.randomized_coeff_points:
        w.point(p)

    def w_coeff_map(m: dict):
        w.u16(len(m))
        for j in sorted(m):
            w.u16(j)
            w.u16(len(m[j]))
            for p in m[j]:
                w.point(p)

    w.u16(len(st.received_shares))
    for j in sorted(st.received_shares):
        w.u16(j)
        s, r = st.received_shares[j]
        w.scalar(s)
        w.scalar(r)
    w_coeff_map(st.randomized_coeffs)
    w_coeff_map(st.bare_coeffs)
    for q in st.qualified:
        w.u8(q)
    for group_set in (st.reconstructable, st.phase3_accused):
        w.u16(len(group_set))
        for j in sorted(group_set):
            w.u16(j)
    has_final = st.final_share is not None
    w.u8(1 if has_final else 0)
    if has_final:
        w.scalar(st.final_share)
    return w.bytes()


def restore(group, data: bytes):
    """Rebuild the phase object from a checkpoint; raises ValueError on
    malformed input."""
    from ..crypto.commitment import CommitmentKey

    r = Reader(group, data)
    if r.take(4) != MAGIC:
        raise ValueError("bad magic")
    if r.u8() != VERSION:
        raise ValueError("unsupported version")
    name = r.lp().decode()
    if name not in _PHASES:
        raise ValueError("unknown phase")
    t = r.u16()
    n = r.u16()
    ck = CommitmentKey(r.point())
    env = cm.Environment(group, t, n, ck)
    index = r.u16()
    sk = r.scalar()
    comm_key = MemberCommunicationKey(Keypair.from_secret(group, sk))
    pks = [MemberCommunicationPublicKey(r.point()) for _ in range(n)]
    st = cm._State(env, index, comm_key, pks)
    ncoeff = r.u16()
    st.bare_coeff_points = tuple(r.point() for _ in range(ncoeff))
    st.randomized_coeff_points = tuple(r.point() for _ in range(ncoeff))

    def r_coeff_map() -> dict:
        out = {}
        for _ in range(r.u16()):
            j = r.u16()
            out[j] = tuple(r.point() for _ in range(r.u16()))
        return out

    st.received_shares = {}
    for _ in range(r.u16()):
        j = r.u16()
        st.received_shares[j] = (r.scalar(), r.scalar())
    st.randomized_coeffs = r_coeff_map()
    st.bare_coeffs = r_coeff_map()
    st.qualified = [r.u8() for _ in range(n)]
    st.reconstructable = {r.u16() for _ in range(r.u16())}
    st.phase3_accused = {r.u16() for _ in range(r.u16())}
    if r.u8():
        st.final_share = r.scalar()
        st.public_share = group.scalar_mul(st.final_share, group.generator())
    r.done()
    return _PHASES[name](st)


# ---------------------------------------------------------------------------
# WAL round records (net.checkpoint — durable crash recovery)
# ---------------------------------------------------------------------------

RECORD_MAGIC = b"DKGR"

# Record kinds: a *state* record snapshots the phase object that drives
# the next round; a *terminal* record pins an error-path publish (e.g.
# complaint evidence broadcast alongside a DkgError) so a crash during
# the drain can never recompute — and equivocate on — committed bytes.
_REC_STATE = 1
_REC_TERMINAL = 2


@dataclass(frozen=True)
class RoundRecord:
    """One replayed WAL record of a ceremony round (see net.checkpoint).

    ``payload`` is the exact wire bytes published for ``round_no``
    (possibly empty).  State records carry ``phase`` (the restored
    DkgPhase* for the next round); terminal records carry ``error`` and
    ``drain_from`` instead.  ``present`` is the sender set observed in
    ``fetch(round_no - 1)`` (None for round 1): re-decoding those same
    mailbox entries is deterministic, so the mask alone reconstructs the
    original decode view even if stragglers landed later.
    """

    round_no: int
    payload: bytes
    phase: object | None
    error: Optional[DkgError]
    drain_from: int
    present: Optional[tuple[int, ...]]
    quarantined_delta: int
    timed_out: bool


def encode_round_record(
    group,
    round_no: int,
    payload: bytes,
    phase=None,
    *,
    error: Optional[DkgError] = None,
    drain_from: int = 0,
    present: Optional[tuple[int, ...]] = None,
    quarantined_delta: int = 0,
    timed_out: bool = False,
) -> bytes:
    """Serialize one WAL round record (exactly one of phase/error set)."""
    if (phase is None) == (error is None):
        raise ValueError("round record needs exactly one of phase or error")
    w = Writer(group)
    w.raw(RECORD_MAGIC)
    w.u8(VERSION)
    w.u8(round_no)
    w.lp(payload)
    if error is None:
        w.u8(_REC_STATE)
        w.lp(checkpoint(group, phase))
    else:
        w.u8(_REC_TERMINAL)
        w.u8(_ERR_CODES[error.kind])
        w.u16(0 if error.index is None else error.index)
        w.u8(1 if error.index is not None else 0)
        w.lp(error.detail.encode())
        w.u8(drain_from)
    w.u8(1 if present is not None else 0)
    if present is not None:
        w.u16(len(present))
        for j in present:
            w.u16(j)
    w.u32(quarantined_delta)
    w.u8(1 if timed_out else 0)
    return w.bytes()


def decode_round_record(group, data: bytes) -> RoundRecord:
    """Rebuild one WAL round record; raises ValueError on malformed
    input (a replay loop treats that as a torn tail)."""
    r = Reader(group, data)
    if r.take(4) != RECORD_MAGIC:
        raise ValueError("bad record magic")
    if r.u8() != VERSION:
        raise ValueError("unsupported record version")
    round_no = r.u8()
    payload = r.lp()
    kind = r.u8()
    phase = None
    error = None
    drain_from = 0
    if kind == _REC_STATE:
        phase = restore(group, r.lp())
    elif kind == _REC_TERMINAL:
        err_kind = _ERR_FROM.get(r.u8())
        if err_kind is None:
            raise ValueError("unknown error code in terminal record")
        index = r.u16()
        has_index = r.u8()
        detail = r.lp().decode()
        drain_from = r.u8()
        error = DkgError(err_kind, index if has_index else None, detail)
    else:
        raise ValueError("unknown record kind")
    present: Optional[tuple[int, ...]] = None
    if r.u8():
        present = tuple(r.u16() for _ in range(r.u16()))
    quarantined_delta = r.u32()
    timed_out = bool(r.u8())
    r.done()
    return RoundRecord(
        round_no, payload, phase, error, drain_from,
        present, quarantined_delta, timed_out,
    )


# ---------------------------------------------------------------------------
# WAL epoch records (epoch.manager: proactive refresh / resharing)
# ---------------------------------------------------------------------------

EPOCH_RECORD_MAGIC = b"DKGE"

# Epoch-op steps (one WAL record per step, written BEFORE the step's
# publish — the same write-ahead contract as round records): 1 = deal,
# 2 = complaints, 3 = confirm.  The step-3 record optionally pins the
# resulting EpochState bytes (absent for leavers, who deal but hold no
# share in the new committee).
EPOCH_STEP_DEAL = 1
EPOCH_STEP_COMPLAINTS = 2
EPOCH_STEP_CONFIRM = 3


@dataclass(frozen=True)
class EpochRecord:
    """One replayed epoch WAL record (see epoch.manager).

    ``payload`` is the exact wire bytes published for this step (empty
    for steps the party does not publish, e.g. a joiner's deal step).
    ``present`` is the sender set observed in the PREVIOUS step's fetch
    (None for the deal step) — re-decoding those mailbox entries is
    deterministic, so the mask reconstructs the original view.
    ``state_bytes`` is the serialized EpochState the confirm step
    produced (None otherwise); the epoch layer owns its codec — this
    record treats both byte fields as opaque, which is what keeps
    pre-epoch readers able to skip these records by magic alone.
    """

    op_seq: int
    step: int
    kind: int
    payload: bytes
    present: Optional[tuple[int, ...]]
    state_bytes: Optional[bytes]


def encode_epoch_record(
    group,
    op_seq: int,
    step: int,
    kind: int,
    payload: bytes,
    *,
    present: Optional[tuple[int, ...]] = None,
    state_bytes: Optional[bytes] = None,
) -> bytes:
    """Serialize one epoch WAL record (magic b"DKGE", version-tagged)."""
    w = Writer(group)
    w.raw(EPOCH_RECORD_MAGIC)
    w.u8(VERSION)
    w.u16(op_seq)
    w.u8(step)
    w.u8(kind)
    w.lp(payload)
    w.u8(1 if present is not None else 0)
    if present is not None:
        w.u16(len(present))
        for j in present:
            w.u16(j)
    w.u8(1 if state_bytes is not None else 0)
    if state_bytes is not None:
        w.lp(state_bytes)
    return w.bytes()


def decode_epoch_record(group, data: bytes) -> EpochRecord:
    """Rebuild one epoch WAL record; raises ValueError on malformed
    input (torn tail, same contract as decode_round_record)."""
    r = Reader(group, data)
    if r.take(4) != EPOCH_RECORD_MAGIC:
        raise ValueError("bad epoch record magic")
    if r.u8() != VERSION:
        raise ValueError("unsupported epoch record version")
    op_seq = r.u16()
    step = r.u8()
    kind = r.u8()
    if step not in (EPOCH_STEP_DEAL, EPOCH_STEP_COMPLAINTS, EPOCH_STEP_CONFIRM):
        raise ValueError("unknown epoch record step")
    payload = r.lp()
    present: Optional[tuple[int, ...]] = None
    if r.u8():
        present = tuple(r.u16() for _ in range(r.u16()))
    state_bytes: Optional[bytes] = None
    if r.u8():
        state_bytes = r.lp()
    r.done()
    return EpochRecord(op_seq, step, kind, payload, present, state_bytes)
