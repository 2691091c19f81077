"""The epoch subsystem of dkg_tpu_torch against dkg_tpu's, on the CPU (the
kernels' plain versions): epoch state, messages and confirm digest byte
for byte; the in-process lane equal to dkg_tpu.epoch.inprocess from the
same ``random.Random`` (ristretto255 (5, 2) then (4, 1), the shapes of
tests/test_epoch.py); ``deal_chunked`` equal to one-shot ``deal``; the
dealing legs against the JAX package's host group at (4, 1) (its device
legs compile for minutes); the WAL, the in-process channel and the knobs
with tests/test_epoch.py's checks.  Exact equality throughout.
"""

import itertools
import random
from types import SimpleNamespace

import pytest
import torch

from dkg_tpu.epoch import inprocess as jinp
from dkg_tpu.epoch import messages as jem
from dkg_tpu.epoch import state as jst
from dkg_tpu.groups import host as jgh
from dkg_tpu.net import checkpoint as jck
from dkg_tpu.poly import host as jph
from dkg_tpu.utils import metrics as jmet
from dkg_tpu.utils import serde as jser
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg import hybrid_batch as thb
from dkg_tpu_torch.dkg.procedure_keys import MemberCommunicationKey
from dkg_tpu_torch.epoch import (EPOCH_ROUND_BASE, KIND_REFRESH, KIND_RESHARE, ROUNDS_PER_OP, EpochError,
                                 EpochManager, EpochState, epoch_rounds, genesis_from_party_result)
from dkg_tpu_torch.epoch import dealing as tdl
from dkg_tpu_torch.epoch import inprocess as tinp
from dkg_tpu_torch.epoch import messages as tem
from dkg_tpu_torch.epoch import state as tst
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.groups import precompute as tgp
from dkg_tpu_torch.net import InProcessChannel, PartyWal
from dkg_tpu_torch.poly import device as tpd
from dkg_tpu_torch.utils import metrics as tmet
from dkg_tpu_torch.utils import serde as tser
from test_torch_complaints import _dealing
from torch_port_util import one_thread, to_port  # noqa: F401

G, TG = jgh.RISTRETTO255, tgh.RISTRETTO255
FS, TFS = G.scalar_field, TG.scalar_field
CS = tgd.RISTRETTO255


def _points(k: int) -> tuple:
    return tuple(TG.scalar_mul(i, TG.generator()) for i in range(1, k + 1))


def _observer(epoch: int = 0, n: int = 3, t: int = 1) -> EpochState:
    return EpochState(epoch=epoch, n=n, t=t, index=None, share=None, commitments=None)


def _manager(**kw) -> EpochManager:
    return EpochManager(None, TG, _observer(), None, [], None, device="cpu", **kw)


# ---------------------------------------------------------------------------
# state, messages, digest: byte for byte
# ---------------------------------------------------------------------------


def test_epoch_rounds():
    assert (EPOCH_ROUND_BASE, ROUNDS_PER_OP) == (6, 3)
    assert [epoch_rounds(op) for op in (1, 2, 7)] == [(6, 7, 8), (9, 10, 11), (24, 25, 26)]


def test_state_and_confirm_digest_byte_equal():
    rng = random.Random(0xE90C)
    states = [
        dict(epoch=3, n=5, t=2, index=4, share=FS.rand_int(rng), commitments=_points(3)),
        dict(epoch=1, n=3, t=1, index=None, share=None, commitments=None),
        dict(epoch=2, n=7, t=3, index=None, share=None, commitments=_points(4)),
    ]
    for kw in states:
        data = jst.encode_epoch_state(G, jst.EpochState(**kw))
        assert tst.encode_epoch_state(TG, EpochState(**kw)) == data
        got = tst.decode_epoch_state(TG, data)
        assert tst.encode_epoch_state(TG, got) == data
        assert got.holds_share == (kw["share"] is not None)
        with pytest.raises(ValueError):
            tst.decode_epoch_state(TG, data[:-1])
    cs = _points(2)
    for kind, epoch, n, t, comm in [(KIND_REFRESH, 1, 5, 2, cs), (KIND_RESHARE, 1, 5, 2, cs),
                                    (KIND_REFRESH, 2, 6, 3, cs[:1]), (KIND_REFRESH, 1, 5, 2, cs[::-1])]:
        assert tst.confirm_digest(TG, kind, epoch, n, t, comm) == jst.confirm_digest(G, kind, epoch, n, t, comm)


def test_genesis_requires_an_ok_result_with_commitments():
    env = SimpleNamespace(nr_members=3, threshold=1)
    st = genesis_from_party_result(env, SimpleNamespace(ok=True, index=2, share=SimpleNamespace(value=7),
                                                        commitments=_points(2)))
    assert (st.epoch, st.n, st.t, st.index, st.share) == (0, 3, 1, 2, 7)
    for bad in [SimpleNamespace(ok=False, index=1, share=None, commitments=None),
                SimpleNamespace(ok=True, index=1, share=None, commitments=_points(2)),
                SimpleNamespace(ok=True, index=1, share=SimpleNamespace(value=7), commitments=None)]:
        with pytest.raises(EpochError) as ei:
            genesis_from_party_result(env, bad)
        assert ei.value.kind == "NO_GENESIS"


@pytest.fixture(scope="module")
def sealed():
    """Real sealed shares: the JAX package's host dealing at (4, 1)."""
    _, _, _, dealt = _dealing("jax", 4, 1, 0xE9D1, b"epoch-messages")
    return dealt[0][1].encrypted_shares


def test_messages_byte_equal_and_rejected_alike(sealed):
    deal = dict(kind=KIND_RESHARE, epoch=2, commitments=_points(3), encrypted_shares=sealed,
                prev_commitments=_points(2))
    cases = [
        (jem.EpochDeal(**deal), tem.EpochDeal(**{**deal, "encrypted_shares": to_port(sealed)}),
         jem.encode_epoch_deal, tem.encode_epoch_deal, jem.decode_epoch_deal, tem.decode_epoch_deal),
        (jem.EpochComplaints(KIND_REFRESH, 1, (2, 4)), tem.EpochComplaints(KIND_REFRESH, 1, (2, 4)),
         jem.encode_epoch_complaints, tem.encode_epoch_complaints, jem.decode_epoch_complaints,
         tem.decode_epoch_complaints),
        (jem.EpochConfirm(KIND_RESHARE, 4, bytes(range(16))), tem.EpochConfirm(KIND_RESHARE, 4, bytes(range(16))),
         jem.encode_epoch_confirm, tem.encode_epoch_confirm, jem.decode_epoch_confirm, tem.decode_epoch_confirm),
    ]
    for j_obj, t_obj, j_enc, t_enc, j_dec, t_dec in cases:
        data = j_enc(G, j_obj)
        assert t_enc(TG, t_obj) == data
        got = t_dec(TG, data)
        assert t_enc(TG, got) == data and got.kind == t_obj.kind and got.epoch == t_obj.epoch
        cuts = range(len(data)) if len(data) < 100 else range(0, len(data), 17)
        for cut in [*cuts, len(data) + 1]:
            bad = data[:cut] if cut < len(data) else data + b"\0"
            with pytest.raises(ValueError):
                j_dec(G, bad)
            with pytest.raises(ValueError):
                t_dec(TG, bad)
        kind9 = bytes([9]) + data[1:]
        with pytest.raises(ValueError, match="kind"):
            t_dec(TG, kind9)
    assert tem.decode_epoch_deal(TG, tem.encode_epoch_deal(TG, cases[0][1])).shares_for(3).recipient_index == 3
    with pytest.raises(ValueError, match="16 bytes"):
        tem.decode_epoch_confirm(TG, tem.encode_epoch_confirm(TG, tem.EpochConfirm(KIND_REFRESH, 1, b"short")))


# ---------------------------------------------------------------------------
# the in-process lane against the JAX package's
# ---------------------------------------------------------------------------


def _sharing(n: int, t: int, seed: int):
    rng = random.Random(seed)
    coeffs = [FS.rand_int(rng) for _ in range(t + 1)]

    def f(x):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % FS.modulus
        return acc

    return coeffs[0], [f(i) for i in range(1, n + 1)]


def test_inprocess_equals_the_jax_package():
    """refresh at (5, 2), then reshare to (4, 1), both packages from the
    same seeds: equal share vectors, and every (t+1)-subset of each
    interpolates to the secret."""
    secret, shares = _sharing(5, 2, 0x0A11)
    jr = jinp.refresh_shares(FS, 5, 2, shares, random.Random(1))
    tr = tinp.refresh_shares(TFS, 5, 2, shares, random.Random(1), device="cpu")
    assert tr == jr and tr != shares
    js = jinp.reshare_shares(FS, 5, 2, jr, 4, 1, random.Random(2))
    ts_ = tinp.reshare_shares(TFS, 5, 2, tr, 4, 1, random.Random(2), device="cpu")
    assert ts_ == js
    for vec, n, t in ((tr, 5, 2), (ts_, 4, 1)):
        for sub in itertools.combinations(range(1, n + 1), t + 1):
            assert jph.lagrange_interpolation(FS, 0, [vec[i - 1] for i in sub], list(sub)) == secret


@pytest.mark.parametrize("args", [
    ("refresh", (5, 2, "short")),
    ("reshare", (5, 2, "all", 2, 2)),  # n' < t' + 1
    ("reshare", (2, 2, "t", 4, 1)),  # n < t + 1
    ("reshare", (5, 2, "short", 4, 1)),
])
def test_inprocess_raises_what_the_jax_package_raises(args):
    op, (n, t, which, *new) = args
    _, shares = _sharing(5, 2, 3)
    vec = {"short": shares[:-1], "all": shares, "t": shares[:t]}[which]
    j_fn, t_fn = (jinp.refresh_shares, tinp.refresh_shares) if op == "refresh" else (jinp.reshare_shares,
                                                                                     tinp.reshare_shares)
    with pytest.raises(ValueError) as je:
        j_fn(FS, n, t, vec, *new, random.Random(0))
    with pytest.raises(ValueError) as te:
        t_fn(TFS, n, t, vec, *new, random.Random(0), device="cpu")
    assert str(te.value) == str(je.value)


def test_fold_is_the_sequential_sum():
    m = tfh.to_tensor(tfh.encode(TFS, [[FS.modulus - 1 - i * j for j in range(3)] for i in range(7)]), "cpu")
    want = [sum(FS.modulus - 1 - i * j for i in range(7)) % FS.modulus for j in range(3)]
    assert [int(v) for v in tfh.decode(TFS, tfh.from_tensor(tinp._fold_dealers(TFS, m)))] == want


# ---------------------------------------------------------------------------
# deal_chunked and the dealing legs
# ---------------------------------------------------------------------------


def test_deal_chunked_equals_one_shot_deal():
    cfg = tce.CeremonyConfig("ristretto255", 4, 1)
    rng = random.Random(0xDC)
    a = tfh.to_tensor(tfh.encode(TFS, [[FS.rand_int(rng) for _ in range(2)] for _ in range(4)]), "cpu")
    b = tfh.to_tensor(tfh.encode(TFS, [[FS.rand_int(rng) for _ in range(2)] for _ in range(4)]), "cpu")
    g_table = tgp.generator_table(CS, device="cpu")
    h_table = tgp.base_table(CS, TG.scalar_mul(5, TG.generator()), device="cpu")
    want = tce.deal(cfg, a, b, g_table, h_table)
    for chunk in (None, 0, 1, 2, 3, 4, 9):
        got = tce.deal_chunked(cfg, a, b, g_table, h_table, chunk=chunk)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), chunk
    with pytest.raises(ValueError):
        tce.deal_chunked(cfg, a, b, g_table, h_table, chunk=-1)


@pytest.fixture(scope="module")
def committee():
    rng = random.Random(0xC0)
    keys = [MemberCommunicationKey.generate(TG, rng) for _ in range(4)]
    return keys, [k.public() for k in keys]


def test_deal_epoch_poly_against_the_host_group(committee):
    """Bare commitments g·c and KEM points g·r on dkg_tpu's host group, the
    coefficients redrawn in the JAX package's order (the constant, t
    draws, then n of r); every recipient's share opens to f(i), one
    recipient's through open_my_shares."""
    keys, pks = committee
    cfg = tdl.epoch_cfg(TG, 4, 1)
    comm, enc = tdl.deal_epoch_poly(TG, cfg, 1234, random.Random(7), pks, device="cpu")
    rng = random.Random(7)
    coeffs = [1234] + [FS.rand_int(rng) for _ in range(1)]
    rs = [FS.rand_int(rng) for _ in range(4)]
    assert [G.encode(p) for p in comm] == [G.encode(G.scalar_mul(c, G.generator())) for c in coeffs]
    assert [e.recipient_index for e in enc] == [1, 2, 3, 4]
    for e, r in zip(enc, rs):
        assert G.encode(e.share_ct.e1) == G.encode(G.scalar_mul(r, G.generator()))
    f = [(coeffs[0] + coeffs[1] * i) % FS.modulus for i in range(1, 5)]
    for i, e in enumerate(enc):
        assert thb.open_share(TG, keys[i].sk, (e.share_ct, e.randomness_ct)) == (f[i], 0)
    deal = tem.EpochDeal(KIND_RESHARE, 1, comm, enc, ())
    assert tdl.open_my_shares(TG, cfg, keys[2].sk, {5: deal}, 3, device="cpu") == {5: f[2]}


def test_check_bare_shares_flags_exactly_the_forged_rows():
    rng = random.Random(0xCB)
    polys = [[FS.rand_int(rng) for _ in range(2)] for _ in range(3)]
    comms = [tuple(TG.scalar_mul(c, TG.generator()) for c in p) for p in polys]
    rows = [(d, i) for d in range(3) for i in (1, 4)]
    shares = [(polys[d][0] + polys[d][1] * i) % FS.modulus for d, i in rows]
    forged = {1, 4}
    shares = [(s + 1) % FS.modulus if k in forged else s for k, s in enumerate(shares)]
    ok = tdl.check_bare_shares(TG, [i for _, i in rows], shares, [comms[d] for d, _ in rows], device="cpu")
    assert ok.dtype == bool and [k for k, v in enumerate(ok) if not v] == sorted(forged)
    assert tdl.check_bare_shares(TG, [], [], [], device="cpu").shape == (0,)


def test_check_reshare_constants_flags_exactly_the_wrong_constant():
    secret, shares = _sharing(4, 1, 0xCC)
    slope = (shares[1] - shares[0]) % FS.modulus  # the degree-1 aggregate's other coefficient
    prev = tuple(TG.scalar_mul(c, TG.generator()) for c in (secret, slope))
    claimed = [TG.scalar_mul(s, TG.generator()) for s in shares]
    claimed[2] = TG.add(claimed[2], TG.generator())
    ok = tdl.check_reshare_constants(TG, prev, [1, 2, 3, 4], claimed, device="cpu")
    assert ok.tolist() == [True, True, False, True]
    assert tdl.check_reshare_constants(TG, prev, [], [], device="cpu").shape == (0,)


def test_combine_reshare_commitments_equals_the_host_sum():
    rng = random.Random(0xCD)
    idx = [1, 3, 4]
    tuples = [tuple(G.scalar_mul(FS.rand_int(rng), G.generator()) for _ in range(2)) for _ in idx]
    lam = tpd.lagrange_at_zero_coeffs(TFS, tfh.to_tensor(tfh.encode(TFS, idx), "cpu"))
    got = tdl.combine_reshare_commitments(TG, lam, tuples)
    lam_h = [jph.lagrange_coefficient(FS, 0, k, idx) for k in range(len(idx))]
    want = [G.msm(lam_h, [tp[lvl] for tp in tuples]) for lvl in range(2)]
    assert [G.encode(p) for p in got] == [G.encode(p) for p in want]
    assert [int(v) for v in tfh.decode(TFS, tfh.from_tensor(lam))] == lam_h


# ---------------------------------------------------------------------------
# WAL, channel, knobs, manager validation
# ---------------------------------------------------------------------------


def test_wal_bytes_equal_and_replay_skips_foreign_records_and_torn_tail(tmp_path):
    bodies = [tser.RECORD_MAGIC + b"ceremony-opaque-body", b"DKGZ" + b"future-layer-body",
              tser.encode_epoch_record(TG, 1, tser.EPOCH_STEP_DEAL, KIND_REFRESH, b"d1"),
              tser.encode_epoch_record(TG, 1, tser.EPOCH_STEP_COMPLAINTS, KIND_REFRESH, b"c1", present=(1, 2))]
    wal, jwal = PartyWal(tmp_path / "p.wal"), jck.PartyWal(tmp_path / "j.wal")
    for body in bodies:
        wal.append(body)
        jwal.append(body)
    assert (tmp_path / "p.wal").read_bytes() == (tmp_path / "j.wal").read_bytes()
    assert wal.replay() == bodies
    mgr = _manager(checkpoint=wal)
    assert set(mgr._replayed) == {1}
    assert set(mgr._replayed[1]) == {tser.EPOCH_STEP_DEAL, tser.EPOCH_STEP_COMPLAINTS}
    assert mgr._replayed[1][tser.EPOCH_STEP_COMPLAINTS].present == (1, 2)
    raw = (tmp_path / "p.wal").read_bytes()
    (tmp_path / "p.wal").write_bytes(raw[:-7])
    assert PartyWal(tmp_path / "p.wal").replay() == bodies[:3]
    assert set(_manager(checkpoint=tmp_path / "p.wal")._replayed[1]) == {tser.EPOCH_STEP_DEAL}
    (tmp_path / "p.wal").write_bytes(b"garbage")
    assert PartyWal(tmp_path / "p.wal").replay() == []
    assert jser.decode_epoch_record(G, bodies[3]).present == (1, 2)


def test_in_process_channel_keeps_the_first_publication():
    chan = InProcessChannel()
    chan.publish(6, 1, b"first")
    chan.publish(6, 1, b"first")  # a retry: no evidence
    assert chan.equivocation_evidence() == {}
    chan.publish(6, 1, b"second")
    chan.publish(6, 2, b"")
    assert chan.fetch(6, 2, timeout=0.1) == {1: b"first", 2: b""}
    assert chan.equivocation_evidence() == {(6, 1): (b"first", b"second")}
    assert chan.fetch(7, 1, timeout=0.05) == {}


def test_epoch_env_knobs_validated(monkeypatch):
    monkeypatch.setenv("DKG_TPU_EPOCH_DEADLINE_S", "2.5")
    monkeypatch.setenv("DKG_TPU_EPOCH_MAX_CHURN", "3")
    mgr = _manager()
    assert mgr.timeout == 2.5 and mgr.max_churn == 3
    for bad in ("not-a-number", "-1", "inf", "nan"):
        monkeypatch.setenv("DKG_TPU_EPOCH_DEADLINE_S", bad)
        with pytest.raises(ValueError, match="DKG_TPU_EPOCH_DEADLINE_S"):
            _manager()
    monkeypatch.setenv("DKG_TPU_EPOCH_DEADLINE_S", "2.5")
    monkeypatch.setenv("DKG_TPU_EPOCH_MAX_CHURN", "-2")
    with pytest.raises(ValueError, match="DKG_TPU_EPOCH_MAX_CHURN"):
        _manager()
    monkeypatch.setenv("DKG_TPU_EPOCH_MAX_CHURN", "0")
    mgr = _manager(timeout=1.0, max_churn=9)
    assert mgr.timeout == 1.0 and mgr.max_churn == 9
    monkeypatch.setenv("DKG_TPU_EPOCH_DEADLINE_S", "")
    monkeypatch.delenv("DKG_TPU_EPOCH_MAX_CHURN")
    mgr = _manager()
    assert mgr.timeout == 30.0 and mgr.max_churn is None


def test_reshare_validates_the_committee_before_any_round(committee):
    _, pks = committee
    mgr = _manager(timeout=0.1, max_churn=0)
    for new, t, kind in [(pks[:3], 2, "BAD_COMMITTEE"), (pks[:3], 0, "BAD_COMMITTEE"),
                         ([pks[0], pks[0], pks[1]], 1, "BAD_COMMITTEE"), (pks[:3], 1, "CHURN_LIMIT")]:
        with pytest.raises(EpochError) as ei:
            mgr.reshare(new, t)
        assert ei.value.kind == kind
    with pytest.raises(EpochError) as ei:
        mgr.refresh()
    assert ei.value.kind == "NO_GENESIS"
    keys = committee[0]
    st = EpochState(epoch=0, n=2, t=1, index=2, share=5, commitments=_points(2))
    with pytest.raises(EpochError) as ei:
        EpochManager(None, TG, st, keys[0], pks[:2], None, timeout=0.1, device="cpu")
    assert ei.value.kind == "BAD_COMMITTEE"


def test_metrics_registry_renders_what_the_jax_package_renders():
    """The manager's series, and a label that needs escaping, give the JAX
    registry's exposition text and counters and histograms."""
    regs = jmet.MetricsRegistry(), tmet.MetricsRegistry()
    for reg in regs:
        reg.inc("epoch_ops_total", kind="refresh", status="ok")
        reg.inc("epoch_ops_total", kind="reshare", status="CHURN_LIMIT")
        reg.inc("epoch_quarantined_total", 3)
        for v in (0.0004, 0.3, 7.0, 99.0):
            reg.observe("epoch_op_seconds", v, kind="refresh")
        reg.inc("odd", label='a"b\\c\nd')
    want, got = (reg.prometheus_text() for reg in regs)
    assert got == want
    j, t = (reg.snapshot() for reg in regs)
    assert (t["counters"], t["histograms"]) == (j["counters"], j["histograms"])
    regs[1].reset()
    assert regs[1].snapshot() == {"counters": {}, "histograms": {}}
