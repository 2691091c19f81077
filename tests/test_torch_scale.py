"""The memory-bounded layer of the ceremony: dkg_tpu_torch on the CPU
against dkg_tpu, by exact equality, at the secp256k1 (n=4, t=1) shape of
test_torch_ceremony.py.

``utils.scanchunk.map_chunked``; the chunk defaults from a given memory
size; ``deal_chunked`` (two passes) at chunks 1 and 3 against the JAX
package's ``deal_chunked``; the transcript digest by dealer chunk, and A's
rows made in the commitments pass, against the JAX package's
``transcript_digest_device``; ``_point_rlc`` in 3-column chunks under all
three schedules against its unchunked self and the JAX package's host
group; ``run(chunk=..., rlc_chunk=...)`` against the JAX package's round
1 and host oracles (rho, ok, final shares, master, bare0), its trace's
phase names against the JAX engine's; ``aggregate_shares`` and
``master_key_from_bare`` with two dealers disqualified against the JAX
package's.  The JAX side compiles only its ``deal`` (~9 s; the digest
runs its host leg, the rest its host groups): its eager ``_point_rlc``
under DKG_TPU_RLC_CHUNK takes 30-50 s a schedule, and its jitted
``verify_batch`` ~50 s."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import one_thread, to_np, to_torch  # noqa: F401

from dkg_tpu.dkg import ceremony as jce
from dkg_tpu.fields import host as jfh
from dkg_tpu.groups import host as jgh
from dkg_tpu.utils.tracing import CeremonyTrace as JaxTrace
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.utils import scanchunk
from dkg_tpu_torch.utils.tracing import CeremonyTrace

CURVE, N, T, SEED, SHARED = "secp256k1", 4, 1, 5, b"torch-parity"
ROUND1 = ("bare", "randomized", "shares", "hidings")


# ---------------------------------------------------------------------------
# map_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,chunk,calls", [
    (10, 3, [(0, 3), (3, 3), (6, 3), (9, 1)]),  # a ragged tail call
    (9, 3, [(0, 3), (3, 3), (6, 3)]),
    (10, 0, [(0, 10)]),  # 0: one direct call
    (10, None, [(0, 10)]),
    (10, 10, [(0, 10)]),  # >= total: one direct call
    (10, 25, [(0, 10)]),
])
def test_map_chunked_calls_and_writes_in_place(total, chunk, calls, monkeypatch):
    """Sequential calls over the offsets, the outputs (a tuple, one on
    another axis) written into tensors allocated once: torch.cat is never
    called, and a direct call's outputs come back as they are."""
    seen = []
    direct = {}

    def call(off, w):
        seen.append((off, w))
        out = (torch.arange(off, off + w), torch.arange(2 * w).reshape(2, w) + 100 * off)
        direct.setdefault("out", out)
        return out

    def no_cat(*a, **k):
        raise AssertionError("map_chunked concatenated its parts")

    monkeypatch.setattr(torch, "cat", no_cat)
    first, second = scanchunk.map_chunked(total, chunk, lambda off, w: call(off, w)[:1] + (call(off, w)[1].T,))
    assert seen[::2] == calls
    assert torch.equal(first, torch.arange(total))
    assert second.shape == (total, 2)
    for off, w in calls:
        assert torch.equal(second[off : off + w], (torch.arange(2 * w).reshape(2, w) + 100 * off).T)
    seen.clear()
    alone = scanchunk.map_chunked(total, chunk, lambda off, w: call(off, w)[1], axis=-1)
    assert alone.shape == (2, total)
    if len(calls) == 1:
        assert alone is direct["out"][1] or torch.equal(alone, direct["out"][1])


def test_map_chunked_refuses_a_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        scanchunk.map_chunked(4, -1, lambda off, w: torch.zeros(w))
    with pytest.raises(ValueError, match="width"):
        scanchunk.map_chunked(4, 2, lambda off, w: torch.zeros(w + 1))


# ---------------------------------------------------------------------------
# chunk defaults
# ---------------------------------------------------------------------------

GIB = 1 << 30


@pytest.mark.parametrize("curve,n,t,free,commit,commit_a0,shares,digest", [
    # an H100 80GB's ~79 GiB free: every n <= 1024 path is one pass
    ("secp256k1", 1024, 341, 79 * GIB, 8192, 4096, 32768, 2048),
    ("bls12_381_g1", 1024, 341, 79 * GIB, 8192, 2048, 32768, 2048),
    ("ristretto255", 256, 85, 79 * GIB, 32768, 8192, 131072, 8192),
    # config 4 on that card: the a0 flow and the digest chunk
    ("secp256k1", 4096, 1365, 79 * GIB, 2048, 1024, 8192, 512),
    # config 5 after its 10.7 GiB of coefficients: E's 25.8 GB charged
    # to the commitments pass, s and r's 34.4 GB to the shares pass
    ("bls12_381_g1", 16384, 5461, 68 * GIB, 512, 128, 2048, 128),
    # config 5 when its digest starts: 66.7 GiB resident
    ("bls12_381_g1", 16384, 5461, 12 * GIB, 128, 16, 512, 128),
    # a small card: the budget floors at DEAL_BUDGET_MIN, 1 GiB
    ("bls12_381_g1", 16384, 5461, 2 * GIB, 128, 16, 512, 32),
])
def test_chunk_defaults_from_a_memory_size(curve, n, t, free, commit, commit_a0, shares, digest):
    """Each pass's default dealer chunk from a free-memory size: the budget
    (free less the pass's outputs, within [1, 4] GiB, the digest's and the
    digesting commitments pass's within [1, 8]) over a dealer's temp bytes, floored to a power of two; on the
    CPU None resolves to one pass."""
    cfg = tce.CeremonyConfig(curve, n, t)
    assert tce._deal_chunk_default(cfg, n, free) == commit
    assert tce._deal_chunk_default(cfg, n, free, a0=True) == commit_a0
    assert tce._shares_chunk_default(cfg, n, free) == shares
    assert tce._digest_chunk_default(cfg, free) == digest
    assert tce._resolve_chunk(None, "cpu", lambda: 1) == 0 and tce._resolve_chunk(5, "cpu", lambda: 1) == 5
    with pytest.raises(ValueError, match="chunk"):
        tce._resolve_chunk(-1, "cpu", lambda: 1)


H100_TOTAL = 85_017_214_976  # an H100 80GB HBM3's total_memory, 79.18 GiB


@pytest.mark.parametrize("curve,n,t,total,keeps", [
    ("secp256k1", 1024, 341, H100_TOTAL, True),
    ("bls12_381_g1", 1024, 341, H100_TOTAL, True),
    ("ristretto255", 256, 85, H100_TOTAL, True),
    ("secp256k1", 4096, 1365, H100_TOTAL, False),
    ("bls12_381_g1", 16384, 5461, H100_TOTAL, False),
    # a 2 GiB card: the 1 GiB floor's 256-dealer chunk at n = 1024
    ("bls12_381_g1", 1024, 341, 2 * GIB, False),
    ("ristretto255", 256, 85, 2 * GIB, True),
])
def test_whole_a_follows_the_card_total(curve, n, t, total, keeps):
    """run(chunk=None) keeps A whole (and returns ``bare``) from n, t and
    the card's whole memory alone, so the result's keys never follow the
    free memory: on an 80 GB H100 every n <= 1024 path, not config 4 or 5."""
    assert tce._keeps_a(tce.CeremonyConfig(curve, n, t), total) is keeps


# ---------------------------------------------------------------------------
# dealing, digest and the RLC by chunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_round1():
    """The JAX package's (4, 1) ceremony coefficients, tables and round 1."""
    jc = jce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED))
    out = jce.deal_chunked(jc.cfg, jc.coeffs_a, jc.coeffs_b, jc.g_table, jc.h_table, chunk=0)
    return jc, [np.asarray(x) for x in out]


@pytest.mark.parametrize("chunk", [1, 3])
def test_deal_chunked_matches_jax(jax_round1, chunk):
    """Both passes in chunks of 1 and of 3 dealers (a ragged tail of 1)."""
    jc, want = jax_round1
    cfg = tce.CeremonyConfig(CURVE, N, T)
    args = [to_torch(np.asarray(x)) for x in (jc.coeffs_a, jc.coeffs_b, jc.g_table, jc.h_table)]
    got = tce.deal_chunked(cfg, *args, chunk=chunk)
    assert len(got) == 4
    assert all(np.array_equal(to_np(g), w) for g, w in zip(got, want))


@pytest.mark.parametrize("chunk", [3])
def test_chunked_digest_matches_jax(jax_round1, chunk, monkeypatch):
    """transcript_digest_device over dealer chunks gives the JAX package's
    digest bytes (its host leg, bit-equal to its device leg); A's rows made
    in the commitments pass (deal_commitments_a0) fold to the same."""
    jc, r1 = jax_round1
    monkeypatch.setenv("DKG_TPU_DIGEST", "host")
    want = jce.transcript_digest_device(jc.cfg, *r1)
    cfg = tce.CeremonyConfig(CURVE, N, T)
    tens = [to_torch(x) for x in r1]
    assert tce.transcript_digest_device(cfg, *tens, chunk=chunk) == want
    assert tce.transcript_digest_device(cfg, *tens, chunk=chunk, digest="host") == want
    args = [to_torch(np.asarray(x)) for x in (jc.coeffs_a, jc.coeffs_b, jc.g_table, jc.h_table)]
    a0, e, rows_a = tce.deal_commitments_a0(cfg, *args, chunk)
    assert np.array_equal(to_np(a0), r1[0][:, 0]) and np.array_equal(to_np(e), r1[1])
    rows = tce.transcript_rows_chunked(cfg, None, e, tens[2], tens[3], chunk, rows_a=rows_a)
    assert tce._fold_digest_device(cfg, *rows) == want


@pytest.mark.parametrize("mode", tce.RLC_MODES)
def test_point_rlc_column_chunks(mode):
    """_point_rlc over 7 columns in chunks of 3 (two full and a ragged
    one) equals its one-chunk run limb for limb, and each column the sum
    Σ_j w_j·P_j by the JAX package's host group, in affine form."""
    cs = tgd.ALL_CURVES[CURVE]
    g = jgh.ALL_GROUPS[CURVE]
    rng = random.Random(0x51C)
    m, cols, nbits = 4, 7, 16
    pts = [[g.scalar_mul(rng.randrange(1, 1000), g.generator()) for _ in range(cols)] for _ in range(m)]
    points = tgd.from_host(cs, [p for row in pts for p in row], device="cpu").reshape(m, cols, cs.ncoords, -1)
    ws = [rng.randrange(1 << nbits) for _ in range(m)]
    weights = to_torch(jfh.encode(cs.scalar, ws))
    got = tce._point_rlc(cs, weights, points, nbits, mode, chunk=3)
    assert torch.equal(got, tce._point_rlc(cs, weights, points, nbits, mode, chunk=0))
    for c, pt in enumerate(tgd.to_host(cs, got)):
        want = g.identity()
        for j in range(m):
            want = g.add(want, g.scalar_mul(ws[j], pts[j][c]))
        assert g.eq(pt, want)


# ---------------------------------------------------------------------------
# the chunked run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunked_run():
    """The port's (4, 1) ceremony in the chunked flow: dealer chunks of 3
    (a ragged tail of 1), RLC columns one at a time, traced."""
    tc = tce.BatchedCeremony(CURVE, N, T, SHARED, random.Random(SEED), device="cpu")
    trace = CeremonyTrace()
    return tc, tc.run(chunk=3, rlc_chunk=1, trace=trace), trace


def test_run_chunked_matches_jax(jax_round1, chunked_run, monkeypatch):
    """rho from the JAX package's digest of its round 1, every check ok,
    bare0 its A[:, 0], E, s and r its own, the final shares Σ_j f_j(i) and
    the master g·Σ_j a_j0 by its host ints and group; A is never whole."""
    jc, r1 = jax_round1
    _, out, _ = chunked_run
    monkeypatch.setenv("DKG_TPU_DIGEST", "host")
    assert np.array_equal(to_np(out["rho"]), np.asarray(jce.derive_rho(jc.cfg, *r1, 128)))
    assert out["ok"].tolist() == [True] * N and out["complaints"] == [] and out["qualified"].all()
    assert "bare" not in out and np.array_equal(to_np(out["bare0"]), r1[0][:, 0])
    for k, want in zip(ROUND1[1:], r1[1:]):
        assert np.array_equal(to_np(out[k]), want), k
    q = jc.cfg.cs.scalar.modulus
    a = jfh.decode(jc.cfg.cs.scalar, np.asarray(jc.coeffs_a))
    finals = jfh.decode(jc.cfg.cs.scalar, to_np(out["final_shares"]))
    for i in range(1, N + 1):
        assert int(finals[i - 1]) == sum(int(a[j, l]) * i ** l for j in range(N) for l in range(T + 1)) % q
    g = jgh.ALL_GROUPS[CURVE]
    master = tgd.to_host(tgd.ALL_CURVES[CURVE], out["master"][None])[0]
    assert g.eq(master, g.scalar_mul(sum(int(v) for v in a[:, 0]) % q, g.generator()))


def test_run_trace_phases_match_jax(jax_round1, chunked_run, monkeypatch):
    """run(trace=...) records the JAX engine's phases, fiat_shamir's
    sub-timings and meta curve / n / t / digest_dispatch / table_cache (the
    JAX run's heavy programs stubbed to its round 1: only its orchestration
    and host digest run)."""
    jc, r1 = jax_round1
    _, out, trace = chunked_run
    monkeypatch.setenv("DKG_TPU_DIGEST", "host")
    monkeypatch.setattr(jce, "deal_chunked", lambda *a, **k: tuple(jnp.asarray(x) for x in r1))
    monkeypatch.setattr(jce, "verify_batch", lambda *a, **k: jnp.ones((N,), bool))
    monkeypatch.setattr(jce, "aggregate_shares", lambda cfg, s, q: s[0])
    monkeypatch.setattr(jce, "master_key_from_bare", lambda cfg, a, q: a[0, 0])
    jtrace = JaxTrace()
    jc.run(trace=jtrace)
    assert set(trace.timings_s) == set(jtrace.timings_s) == set(out["phase_seconds"])
    assert {k: set(v) for k, v in trace.subtimings_s.items()} == {k: set(v) for k, v in jtrace.subtimings_s.items()}
    assert set(trace.meta) == set(jtrace.meta)
    assert set(trace.meta["table_cache"]) == set(jtrace.meta["table_cache"])
    assert all(trace.meta[k] == jtrace.meta[k] for k in ("curve", "n", "t"))
    assert trace.meta["digest_dispatch"] == "device" and trace.timings_s["tables"] == out["phase_seconds"]["tables"]


def test_two_disqualified_dealers_match_jax(chunked_run):
    """aggregate_shares (one mod_madd_dot with 0/1 weights, here its plain
    version) and master_key_from_bare on a0 over the chunked run's tensors
    with dealers 1 and 3 disqualified: the JAX package's masked sums."""
    _, out, _ = chunked_run
    cfg, jcfg = tce.CeremonyConfig(CURVE, N, T), jce.CeremonyConfig(CURVE, N, T)
    qual = np.array([True, False, True, False])
    got = tce.aggregate_shares(cfg, out["shares"], torch.from_numpy(qual))
    want = jce.aggregate_shares(jcfg, jnp.asarray(to_np(out["shares"])), jnp.asarray(qual))
    assert np.array_equal(to_np(got), np.asarray(want))
    cs, g = tgd.ALL_CURVES[CURVE], jgh.ALL_GROUPS[CURVE]
    a0 = tgd.to_host(cs, out["bare0"])
    master = tgd.to_host(cs, tce.master_key_from_bare(cfg, out["bare0"], torch.from_numpy(qual))[None])[0]
    assert g.eq(master, g.add(a0[0], a0[2]))


def test_chunked_flow_takes_no_tamper_and_from_arrays_takes_tensors(chunked_run):
    """tamper with a chunk raises; from_arrays takes int32 limb tensors on
    the ceremony's device as they are, and refuses limbs out of range."""
    tc, _, _ = chunked_run
    with pytest.raises(ValueError, match="tamper"):
        tc.run(tamper=lambda *r: r, chunk=2)
    c = tce.BatchedCeremony.from_arrays(CURVE, N, T, SHARED, tc.coeffs_a, tc.coeffs_b, device="cpu")
    assert c.coeffs_a is tc.coeffs_a and c.coeffs_b is tc.coeffs_b
    bad = tc.coeffs_a.clone()
    bad[0, 0, 0] = -1
    with pytest.raises(ValueError, match="limbs"):
        tce.BatchedCeremony.from_arrays(CURVE, N, T, SHARED, bad, tc.coeffs_b, device="cpu")
