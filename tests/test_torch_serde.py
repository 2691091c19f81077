"""utils/serde.py of dkg_tpu_torch against dkg_tpu's: every message codec,
phase snapshot and WAL record byte for byte on the same objects, round
trips, and the same rejections of truncated and trailing bytes.

The wire objects come from one run of the JAX package's host committee
(no compile) at ristretto255 (4, 1): dealer 3 cheats party 1 in round 1
(a real complaint with its proof), dealer 4 lies about its bare
commitments in round 3 (real round-4 complaints and round-5
disclosures); they cross to the port through ``to_port``.  Each phase is
snapshotted as it is reached.
"""

import random

import pytest

from dkg_tpu.dkg import broadcast as jbc
from dkg_tpu.dkg import committee as jcm
from dkg_tpu.dkg import errors as jerr
from dkg_tpu.groups import host as jgh
from dkg_tpu.utils import serde as jser
from dkg_tpu_torch.dkg import errors as terr
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.utils import serde as tser
from test_torch_complaints import _cheat, _dealing
from torch_port_util import one_thread, to_jax, to_port  # noqa: F401

G, TG = jgh.RISTRETTO255, tgh.RISTRETTO255
N, T, CHEAT, LIAR = 4, 1, 3, 4


@pytest.fixture(scope="module")
def run():
    """The JAX package's phases 1-5 with a round-1 cheat and a round-3
    liar: broadcasts by round, and each phase's checkpoint bytes taken
    when the phase was reached (party 1's)."""
    env, keys, pks, dealt = _dealing("jax", N, T, 0x5E7D, b"serde-parity")
    rng = random.Random(0x5E7E)
    snaps = {"phase1": jser.checkpoint(G, dealt[0][0])}
    b1 = [b for _, b in dealt]
    b1[CHEAT - 1] = _cheat(env, pks, [1], b1[CHEAT - 1], rng)
    f1 = [jcm.FetchedPhase1.from_broadcast(env, j + 1, b1[j]) for j in range(N)]
    r2 = [p.proceed(f1, rng) for p, _ in dealt]
    snaps["phase2"] = jser.checkpoint(G, r2[0][0])
    c2 = [jcm.FetchedComplaints2(i + 1, b) for i, (_, b) in enumerate(r2)]
    r3 = [p.proceed(c2, f1) for p, _ in r2]
    snaps["phase3"] = jser.checkpoint(G, r3[0][0])
    b3 = [b for _, b in r3]
    lie = b3[LIAR - 1].committed_coefficients
    b3[LIAR - 1] = jbc.BroadcastPhase3((G.add(lie[0], G.generator()),) + tuple(lie[1:]))
    f3 = [jcm.FetchedPhase3.from_broadcast(env, j + 1, b3[j]) for j in range(N)]
    r4 = [p.proceed(f3) for p, _ in r3]
    snaps["phase4"] = jser.checkpoint(G, r4[0][0])
    c4 = [jcm.FetchedComplaints4(i + 1, b) for i, (_, b) in enumerate(r4)]
    r5 = [p.proceed(c4) for p, _ in r4]
    snaps["phase5"] = jser.checkpoint(G, r5[0][0])
    f5 = [jcm.FetchedPhase5(i + 1, b) for i, (_, b) in enumerate(r5)]
    master = r5[0][0].finalise(f5)[0][0]
    msgs = {1: b1, 2: [b for _, b in r2 if b is not None], 3: b3, 4: [b for _, b in r4 if b is not None],
            5: [b for _, b in r5 if b is not None]}
    assert msgs[2] and msgs[2][0].misbehaving_parties and msgs[4] and msgs[5]
    return {"msgs": msgs, "snaps": snaps, "f5": f5, "master": master, "phase5": r5[0][0]}


CODECS = {k: (getattr(jser, f"encode_phase{k}"), getattr(jser, f"decode_phase{k}"),
              getattr(tser, f"encode_phase{k}"), getattr(tser, f"decode_phase{k}")) for k in range(1, 6)}


@pytest.mark.parametrize("k", range(1, 6))
def test_phase_codecs_equal_and_round_trip(run, k):
    j_enc, j_dec, t_enc, t_dec = CODECS[k]
    for b in run["msgs"][k]:
        data = j_enc(G, b)
        assert t_enc(TG, to_port(b)) == data
        got = t_dec(TG, data)
        assert got is not None and to_jax(got) == j_dec(G, data)
        assert t_enc(TG, got) == data


@pytest.mark.parametrize("k", range(1, 6))
def test_phase_decoders_reject_what_the_jax_package_rejects(run, k):
    """Every truncation and one trailing byte decode to None in both
    packages; so does a corrupted point encoding (phases 1 and 3)."""
    j_enc, j_dec, _, t_dec = CODECS[k]
    data = j_enc(G, run["msgs"][k][0])
    cuts = range(len(data)) if len(data) < 200 else [*range(40), *range(40, len(data), 37)]
    for cut in cuts:
        assert t_dec(TG, data[:cut]) is None and j_dec(G, data[:cut]) is None, cut
    assert t_dec(TG, data + b"\0") is None and j_dec(G, data + b"\0") is None
    if k in (1, 3):
        bad = data[:2] + b"\xff" * 32 + data[34:]  # the first commitment point
        assert t_dec(TG, bad) is None and j_dec(G, bad) is None


@pytest.mark.parametrize("curve", ["ristretto255", "secp256k1", "bls12_381_g1"])
def test_wire_sizes(run, curve):
    jg, tg = jgh.ALL_GROUPS[curve], tgh.ALL_GROUPS[curve]
    for n, t in ((4, 1), (256, 85), (1024, 341)):
        for name in ("phase1_wire_bytes", "phase3_wire_bytes", "party_wire_bytes", "ceremony_wire_bytes"):
            assert getattr(tser, name)(tg, n, t) == getattr(jser, name)(jg, n, t), (name, n, t)
    if curve == "ristretto255":
        fault_free = run["msgs"][1][0]
        assert tser.phase1_wire_bytes(TG, N, T) == len(tser.encode_phase1(TG, to_port(fault_free)))


@pytest.mark.parametrize("name", ["phase1", "phase2", "phase3", "phase4", "phase5"])
def test_checkpoint_restore_byte_equal(run, name):
    """The port restores the JAX package's snapshot to its own phase object
    and snapshots it to the same bytes; malformed snapshots raise."""
    data = run["snaps"][name]
    phase = tser.restore(TG, data)
    assert type(phase).__name__ == f"DkgPhase{name[-1]}"
    assert tser.checkpoint(TG, phase) == data
    with pytest.raises(ValueError):
        tser.restore(TG, data[:-1])
    with pytest.raises(ValueError):
        tser.restore(TG, b"XXXX" + data[4:])


def test_restored_phase5_finalises_to_the_same_master(run):
    phase = tser.restore(TG, run["snaps"]["phase5"])
    out, _ = phase.finalise([to_port(f) for f in run["f5"]])
    master, share = out
    assert TG.encode(master.point) == G.encode(run["master"].point)
    assert share.value == run["phase5"]._state.final_share


def test_round_records_byte_equal(run):
    snap = run["snaps"]["phase3"]
    j_phase, t_phase = jser.restore(G, snap), tser.restore(TG, snap)
    cases = [
        (dict(phase=j_phase), dict(phase=t_phase)),
        (dict(phase=j_phase, present=(1, 2, 4), quarantined_delta=3, timed_out=True),
         dict(phase=t_phase, present=(1, 2, 4), quarantined_delta=3, timed_out=True)),
        (dict(error=jerr.DkgError(jerr.DkgErrorKind.NOT_ENOUGH_MEMBERS, 2, "two left"), drain_from=4),
         dict(error=terr.DkgError(terr.DkgErrorKind.NOT_ENOUGH_MEMBERS, 2, "two left"), drain_from=4)),
        (dict(error=jerr.DkgError(jerr.DkgErrorKind.ZKP_VERIFICATION_FAILED)),
         dict(error=terr.DkgError(terr.DkgErrorKind.ZKP_VERIFICATION_FAILED))),
    ]
    for jk, tk in cases:
        data = jser.encode_round_record(G, 3, b"payload", **jk)
        assert tser.encode_round_record(TG, 3, b"payload", **tk) == data
        rec = tser.decode_round_record(TG, data)
        want = jser.decode_round_record(G, data)
        assert (rec.round_no, rec.payload, rec.drain_from, rec.present, rec.quarantined_delta, rec.timed_out) == (
            want.round_no, want.payload, want.drain_from, want.present, want.quarantined_delta, want.timed_out)
        assert (rec.error is None) == (want.error is None) and (rec.phase is None) == (want.phase is None)
        if rec.error is not None:
            assert to_jax(rec.error) == want.error
        else:
            assert tser.checkpoint(TG, rec.phase) == snap
        for cut in (0, 5, len(data) // 2, len(data) - 1):
            with pytest.raises(ValueError):
                tser.decode_round_record(TG, data[:cut])
    with pytest.raises(ValueError):
        tser.encode_round_record(TG, 1, b"", phase=None)


def test_epoch_records_byte_equal():
    cases = [
        (1, tser.EPOCH_STEP_DEAL, 1, b"deal", {}),
        (2, tser.EPOCH_STEP_COMPLAINTS, 2, b"", {"present": (1, 3)}),
        (7, tser.EPOCH_STEP_CONFIRM, 1, b"c" * 16, {"present": (), "state_bytes": b"\x01\x02"}),
    ]
    for op, step, kind, payload, kw in cases:
        data = jser.encode_epoch_record(G, op, step, kind, payload, **kw)
        assert tser.encode_epoch_record(TG, op, step, kind, payload, **kw) == data
        assert tser.decode_epoch_record(TG, data) == tser.EpochRecord(
            op, step, kind, payload, kw.get("present"), kw.get("state_bytes"))
        for cut in range(len(data)):
            with pytest.raises(ValueError):
                tser.decode_epoch_record(TG, data[:cut])
        with pytest.raises(ValueError):
            tser.decode_epoch_record(TG, data + b"\0")
    bad_step = bytearray(jser.encode_epoch_record(G, 1, 1, 1, b""))
    bad_step[7] = 9
    with pytest.raises(ValueError, match="step"):
        tser.decode_epoch_record(TG, bytes(bad_step))


def test_reader_rejects_non_canonical_scalars_and_points():
    fs = TG.scalar_field
    w = tser.Writer(TG)
    w.raw(fs.modulus.to_bytes(fs.nbytes, "little"))
    with pytest.raises(ValueError, match="scalar"):
        tser.Reader(TG, w.bytes()).scalar()
    with pytest.raises(ValueError, match="point"):
        tser.Reader(TG, b"\x01" + b"\0" * 31).point()  # odd s
    r = tser.Reader(TG, TG.encode(TG.generator()) * 2)
    assert r.point() is r.point()  # equal encodings decode once
    r.done()
