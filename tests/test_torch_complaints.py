"""The port's batched round 2 and complaint court against the JAX package's
serial host paths, on the CPU (the port's plain versions).

The dealing comes from the JAX package's host ``DistributedKeyGeneration``
(no compile), carried across with ``to_port``; the port's own host init
from the same seed gives the same broadcasts, which the first test pins.
"""

import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

from dkg_tpu.crypto import elgamal as jel
from dkg_tpu.dkg import broadcast as jbc
from dkg_tpu.dkg import committee as jcm
from dkg_tpu.dkg import complaints_batch as jcb
from dkg_tpu.dkg import procedure_keys as jpk
from dkg_tpu.dkg.errors import DkgErrorKind as JKind
from dkg_tpu.groups import host as jgh
from dkg_tpu_torch.dkg import committee as tcm
from dkg_tpu_torch.dkg import complaints_batch as tcb
from dkg_tpu_torch.dkg import errors as terr
from dkg_tpu_torch.dkg import procedure_keys as tpk
from dkg_tpu_torch.dkg import storm_bench
from dkg_tpu_torch.dkg.committee_batch import batched_share_verification
from dkg_tpu_torch.fields import host as tfh
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.utils.tracing import CeremonyTrace
from torch_port_util import one_thread, to_jax, to_port  # noqa: F401

G = jgh.RISTRETTO255
CS = tgd.RISTRETTO255


def _dealing(pkg: str, n: int, t: int, seed: int, shared: bytes, members=None):
    """(env, sorted keys, sorted public keys, [(phase 1, broadcast)]) of
    ``pkg``'s host init for ``members`` (default all), from one seed."""
    cm, pkm, gh = (jcm, jpk, jgh) if pkg == "jax" else (tcm, tpk, tgh)
    group = gh.RISTRETTO255
    rng = random.Random(seed)
    env = cm.Environment.init(group, t, n, shared)
    keys = [pkm.MemberCommunicationKey.generate(group, rng) for _ in range(n)]
    pks = pkm.sort_committee(group, [k.public() for k in keys])
    by_enc = {k.public().sort_key(group): k for k in keys}
    keys = [by_enc[p.sort_key(group)] for p in pks]
    members = range(1, n + 1) if members is None else members
    dealt = [cm.DistributedKeyGeneration.init(env, rng, keys[i - 1], [k.public() for k in keys], i)
             for i in members]
    return env, keys, pks, dealt


def _cheat(env, pks, victims, b, rng):
    """The JAX package's ``_cheating_broadcast``: decodable shares off the
    dealer's commitments, re-sealed to each victim."""
    fs = G.scalar_field
    enc = list(b.encrypted_shares)
    for v in victims:
        s_ct, r_ct = jel.seal_pair(G, pks[v - 1].point, fs.rand_int(rng).to_bytes(fs.nbytes, "little"),
                                   fs.rand_int(rng).to_bytes(fs.nbytes, "little"), rng)
        enc[v - 1] = jbc.EncryptedShares(v, s_ct, r_ct)
    return jbc.BroadcastPhase1(b.committed_coefficients, tuple(enc))


@pytest.fixture(scope="module")
def dealing8():
    """ristretto255 (8, 3) round 1 in both packages from one seed."""
    j = _dealing("jax", 8, 3, 0x5E41, b"batched-r2")
    t = _dealing("port", 8, 3, 0x5E41, b"batched-r2")
    return j, t


def _round2(dealing8, mutate, proofs_seed: int):
    """Both round 2s on ``mutate``d JAX broadcasts: the JAX package's
    serial ``DkgPhase1.proceed`` a party, the port's
    ``batched_share_verification`` (plain versions on the CPU)."""
    (j_env, j_keys, j_pks, j_dealt), (t_env, _, _, t_dealt) = dealing8
    broadcasts = mutate([b for _, b in j_dealt], j_env, j_pks)
    j_fetched = [jcm.FetchedPhase1.from_broadcast(j_env, i + 1, b) for i, b in enumerate(broadcasts)]
    t_fetched = [tcm.FetchedPhase1.from_broadcast(t_env, i + 1, to_port(b)) for i, b in enumerate(broadcasts)]
    j_phases = [copy.deepcopy(p) for p, _ in j_dealt]
    t_phases = [copy.deepcopy(p) for p, _ in t_dealt]
    serial = [p.proceed(j_fetched, random.Random(proofs_seed)) for p in j_phases]
    trace = CeremonyTrace()
    batched = batched_share_verification(t_phases, t_fetched, random.Random(proofs_seed + 1), device="cpu",
                                         trace=trace)
    assert set(trace.subtimings_s["verify"]) == {"triage", "kem", "dem", "recheck", "assembly"}
    return broadcasts, j_phases, t_phases, serial, batched


def _complaints(b):
    return [] if b is None else [(m.accused_index, m.error.name) for m in b.misbehaving_parties]


def _same_round2(j_phases, t_phases, serial, batched):
    for i, ((s_nxt, s_b), (b_nxt, b_b)) in enumerate(zip(serial, batched)):
        assert type(s_nxt).__name__ == type(b_nxt).__name__, i
        if not isinstance(b_nxt, tcm.DkgPhase2):
            assert (s_nxt.kind.name, s_nxt.index) == (b_nxt.kind.name, b_nxt.index), i
        st_s, st_b = j_phases[i]._state, t_phases[i]._state
        assert st_s.qualified == st_b.qualified, i
        assert st_s.received_shares == st_b.received_shares, i
        assert st_s.randomized_coeffs == st_b.randomized_coeffs, i
        assert _complaints(s_b) == _complaints(b_b), i


def test_host_init_broadcasts_equal(dealing8):
    (_, j_keys, _, j_dealt), (_, t_keys, _, t_dealt) = dealing8
    assert [to_port(k) for k in j_keys] == t_keys
    assert [to_port(b) for _, b in j_dealt] == [b for _, b in t_dealt]


def test_batched_round2_matches_serial_under_mixed_faults(dealing8):
    """A cheating dealer (3, to parties 1 and 6), a silent one (5) and a
    truncated ciphertext (dealer 7 to party 2): the same outcomes, state,
    complaints and order as the serial round, and the batched evidence is
    upheld by the JAX package's verifier."""
    def mutate(bs, env, pks):
        rng = random.Random(0x77)
        bs[2] = _cheat(env, pks, [1, 6], bs[2], rng)
        bs[4] = None
        enc = list(bs[6].encrypted_shares)
        es = enc[1]
        enc[1] = jbc.EncryptedShares(2, jel.HybridCiphertext(es.share_ct.e1, es.share_ct.ciphertext[:-3]),
                                     es.randomness_ct)
        bs[6] = jbc.BroadcastPhase1(bs[6].committed_coefficients, tuple(enc))
        return bs

    broadcasts, j_phases, t_phases, serial, batched = _round2(dealing8, mutate, 77)
    _same_round2(j_phases, t_phases, serial, batched)
    (j_env, _, j_pks, _), _ = dealing8
    assert _complaints(batched[0][1]) == [(3, "SHARE_VALIDITY_FAILED")]
    assert _complaints(batched[5][1]) == [(3, "SHARE_VALIDITY_FAILED")]
    assert _complaints(batched[1][1]) == [(7, "DECODING_TO_SCALAR_FAILED")]
    for i, (_, b) in enumerate(batched):
        assert i == 4 or not t_phases[i]._state.qualified[4]
        for m in ([] if b is None else b.misbehaving_parties):
            assert to_jax(m).verify(G, j_env.commitment_key, i + 1, j_pks[i], broadcasts[m.accused_index - 1])


def test_batched_round2_error_branches(dealing8):
    """Misaddressed data is FETCHED_INVALID_DATA at the same index with the
    same partial state; four cheats (> t = 3) at party 6 abort with
    MISBEHAVIOUR_HIGHER_THRESHOLD and the evidence still published."""
    def misaddress(bs, env, pks):
        enc = list(bs[1].encrypted_shares)
        enc[2] = jbc.EncryptedShares(4, enc[2].share_ct, enc[2].randomness_ct)
        bs[1] = jbc.BroadcastPhase1(bs[1].committed_coefficients, tuple(enc))
        return bs

    _, j_phases, t_phases, serial, batched = _round2(dealing8, misaddress, 7)
    _same_round2(j_phases, t_phases, serial, batched)
    err, bcast = batched[2]
    assert isinstance(err, terr.DkgError) and err.kind == terr.DkgErrorKind.FETCHED_INVALID_DATA and err.index == 2
    assert bcast is None

    def storm(bs, env, pks):
        rng = random.Random(0x66)
        for d in (1, 2, 4, 7):
            bs[d - 1] = _cheat(env, pks, [6], bs[d - 1], rng)
        return bs

    _, j_phases, t_phases, serial, batched = _round2(dealing8, storm, 5)
    _same_round2(j_phases, t_phases, serial, batched)
    err, bcast = batched[5]
    assert err.kind == terr.DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD
    assert [m.accused_index for m in bcast.misbehaving_parties] == [1, 2, 4, 7]
    assert all(isinstance(r[0], tcm.DkgPhase2) for i, r in enumerate(batched) if i != 5)
    assert batched_share_verification([], [], random.Random(0), device="cpu") == []


def _flip(b, recipients):
    es = list(b.encrypted_shares)
    for r in recipients:
        old = es[r - 1]
        bad = dataclasses.replace(old.share_ct, ciphertext=bytes([old.share_ct.ciphertext[0] ^ 1])
                                  + old.share_ct.ciphertext[1:])
        es[r - 1] = jbc.EncryptedShares(old.recipient_index, bad, old.randomness_ct)
    return dataclasses.replace(b, encrypted_shares=tuple(es))


def test_court_matches_serial_on_genuine_false_and_ghost():
    """test_complaints_batch.py's triples: a genuine complaint, a false
    one against an honest dealer, one against a dealer that never dealt."""
    env, keys, pks, dealt = _dealing("jax", 4, 1, 0xC0817, b"complaints-batch")
    broadcasts = [b for _, b in dealt]
    broadcasts[1] = _flip(broadcasts[1], [1])
    fetched = [jcm.FetchedPhase1.from_broadcast(env, j + 1, broadcasts[j]) for j in range(4)]
    rng = random.Random(0x11)
    _, complaint_b = copy.deepcopy(dealt[0][0]).proceed(fetched, rng)
    genuine = complaint_b.misbehaving_parties[0]
    false_c = jbc.MisbehavingPartiesRound1(3, JKind.SHARE_VALIDITY_FAILED,
                                           jbc.ProofOfMisbehaviour.generate(G, broadcasts[2].shares_for(1), keys[0],
                                                                            rng))
    ghost = jbc.MisbehavingPartiesRound1(4, JKind.SHARE_VALIDITY_FAILED, false_c.proof)
    triples = [(1, pks[0], genuine), (1, pks[0], false_c), (1, pks[0], ghost)]
    by_sender = {1: broadcasts[0], 2: broadcasts[1], 3: broadcasts[2]}
    want = jcb.adjudicate_round1_serial(G, env.commitment_key, triples, by_sender)
    assert want == [True, False, False]
    t_env, t_triples, t_by = to_port(env), to_port(triples), to_port(by_sender)
    timings: dict = {}
    got = tcb.adjudicate_round1_batch(tgh.RISTRETTO255, CS, t_env.commitment_key, t_triples, t_by, timings,
                                      device="cpu")
    assert got == want and set(timings) == {"dleq_s", "decrypt_s", "recheck_s"}
    assert tcb.adjudicate_round1_serial(tgh.RISTRETTO255, t_env.commitment_key, t_triples, t_by) == want
    timings = {}
    assert tcb.adjudicate_round1(tgh.RISTRETTO255, CS, t_env.commitment_key, t_triples, t_by, timings,
                                 device="cpu") == want
    assert set(timings) == {"serial_s"}


def test_court_storm_n16():
    """scripts/storm_bench.py's storm at n = 16, k = 5: dealer 1's payloads
    to accusers 2..6 corrupted, five genuine complaints and a false one
    (accuser 7); the port's batch court against the JAX package's serial
    one."""
    n, k = 16, 5
    env, keys, pks, dealt = _dealing("jax", n, k, 0x5702, b"storm-bench", members=[1])
    rng = random.Random(0x5703)
    tampered = _flip(dealt[0][1], range(2, k + 2))
    triples = [(a, pks[a - 1], jbc.MisbehavingPartiesRound1(
        1, JKind.SHARE_VALIDITY_FAILED, jbc.ProofOfMisbehaviour.generate(G, tampered.shares_for(a), keys[a - 1], rng)))
        for a in list(range(2, k + 2)) + [k + 2]]
    by_sender = {1: tampered}
    want = jcb.adjudicate_round1_serial(G, env.commitment_key, triples, by_sender)
    assert want == [True] * k + [False]
    got = tcb.adjudicate_round1_batch(tgh.RISTRETTO255, CS, to_port(env).commitment_key, to_port(triples),
                                      to_port(by_sender), device="cpu")
    assert got == want


def test_storm_bench_storm_upheld_by_the_jax_serial_court():
    """The port's storm builder (on CPU tensors) at n = 8, k = 3: the JAX
    package's serial court upholds the three genuine complaints and
    rejects the false one, as do both of the port's courts."""
    n, k = 8, 3
    rng = random.Random(0x5704)
    env = tcm.Environment.init(tgh.RISTRETTO255, k, n, b"storm-bench")
    keys, pks, sorted_keys = storm_bench.committee_keys(tgh.RISTRETTO255, n, rng)
    tampered, triples = storm_bench.build_storm(env, keys, pks, sorted_keys, rng, k, device="cpu")
    want = [True] * k + [False]
    assert jcb.adjudicate_round1_serial(G, to_jax(env).commitment_key, to_jax(triples), {1: to_jax(tampered)}) == want
    assert tcb.adjudicate_round1_serial(tgh.RISTRETTO255, env.commitment_key, triples, {1: tampered}) == want
    assert tcb.adjudicate_round1_batch(tgh.RISTRETTO255, CS, env.commitment_key, triples, {1: tampered},
                                       device="cpu") == want


def test_check_randomized_shares_lane_by_lane():
    """check_randomized_shares_batch and _limbs against the JAX package's
    host check_randomized_share at each lane: honest pairs, a share off by
    one, a swapped hiding, other dealers' commitments, indices 1..9; and
    k = 0."""
    rng = random.Random(0xC4EC)
    fs = G.scalar_field
    ck = jcm.Environment.init(G, 2, 9, b"recheck").commitment_key
    dealers = []
    for _ in range(3):
        a = [fs.rand_int(rng) for _ in range(3)]
        b = [fs.rand_int(rng) for _ in range(3)]
        comm = tuple(G.add(G.scalar_mul(x, G.generator()), G.scalar_mul(y, ck.h)) for x, y in zip(a, b))
        dealers.append((a, b, comm))
    idx, shares, rands, coeffs = [], [], [], []
    for lane in range(12):
        a, b, comm = dealers[lane % 3]
        x = 1 + lane % 9
        s = sum(c * x**k for k, c in enumerate(a)) % fs.modulus
        r = sum(c * x**k for k, c in enumerate(b)) % fs.modulus
        if lane % 4 == 1:
            s = (s + 1) % fs.modulus
        elif lane % 4 == 2:
            s, r = r, s
        elif lane == 7:
            comm = dealers[(lane + 1) % 3][2]
        idx.append(x)
        shares.append(s)
        rands.append(r)
        coeffs.append(comm)
    want = [jbc.check_randomized_share(G, ck, x, s, r, c) for x, s, r, c in zip(idx, shares, rands, coeffs)]
    assert 0 < sum(want) < len(want)
    t_ck = to_port(ck)
    got = tcb.check_randomized_shares_batch(tgh.RISTRETTO255, CS, t_ck, idx, shares, rands, coeffs, device="cpu")
    assert got.dtype == bool and got.tolist() == want
    cpts = tgd.from_host(CS, [p for c in coeffs for p in c], device="cpu").reshape(len(idx), 3, 4, 16)
    lim = tcb.check_randomized_shares_limbs(
        tgh.RISTRETTO255, CS, t_ck, torch.tensor(idx, dtype=torch.int32),
        tfh.to_tensor(tfh.encode(fs, shares), "cpu"), tfh.to_tensor(tfh.encode(fs, rands), "cpu"), cpts, 4)
    assert lim.tolist() == want
    empty = tcb.check_randomized_shares_batch(tgh.RISTRETTO255, CS, t_ck, [], [], [], [], device="cpu")
    assert isinstance(empty, np.ndarray) and empty.shape == (0,)
