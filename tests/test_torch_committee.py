"""The port's committee wire protocol against the JAX package's, on the CPU.

Host code first: the same ``random.Random`` state gives both packages the
same keys, committee order and round-1 broadcasts (``to_port`` carries
the JAX package's wire objects across, field by field); proofs made in
one package verify in the other; every rejection branch of both
complaint types gives the same DkgError kind, index and detail; the
whole phases 1-5 flow with a round-1 and a round-3 cheat gives the same
complaints, qualified sets, final shares and master key.  Then the
batched dealing round: the JAX package's ``batched_dealing`` at (4, 1) on
ristretto255 (one module fixture, the shape ``test_committee_batch.py``
compiles) against the port's on CPU tensors, byte for byte.
"""

import copy
import dataclasses
import random

import pytest

from dkg_tpu.crypto import commitment as jcom
from dkg_tpu.crypto import elgamal as jel
from dkg_tpu.crypto.correct_decryption import CorrectHybridDecrKeyZkp as JZkp
from dkg_tpu.dkg import broadcast as jbc
from dkg_tpu.dkg import committee as jcm
from dkg_tpu.dkg import errors as jerr
from dkg_tpu.dkg import procedure_keys as jpk
from dkg_tpu.dkg.committee_batch import batched_dealing as jax_batched_dealing
from dkg_tpu.groups import host as jgh
from dkg_tpu.poly.host import lagrange_interpolation as jlagrange
from dkg_tpu.utils.tracing import CeremonyTrace as JTrace
from dkg_tpu_torch.crypto import commitment as tcom
from dkg_tpu_torch.crypto import elgamal as tel
from dkg_tpu_torch.crypto.correct_decryption import CorrectHybridDecrKeyZkp as TZkp
from dkg_tpu_torch.dkg import broadcast as tbc
from dkg_tpu_torch.dkg import committee as tcm
from dkg_tpu_torch.dkg import errors as terr
from dkg_tpu_torch.dkg import procedure_keys as tpk
from dkg_tpu_torch.dkg.committee_batch import batched_dealing as port_batched_dealing
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.utils.tracing import CeremonyTrace as TTrace
from torch_port_util import one_thread, to_jax, to_port  # noqa: F401

PKGS = {"jax": (jgh, jcm, jpk, jbc, jel, jerr), "port": (tgh, tcm, tpk, tbc, tel, terr)}


def _committee(pkg: str, curve: str, n: int, t: int, seed: int, shared: bytes = b"torch-committee"):
    """(env, keys in sorted order, sorted public keys, [(phase 1, broadcast)])
    of package ``pkg``: n keys, then every party's init, from one seed."""
    gh, cm, pkm, _, _, _ = PKGS[pkg]
    group = gh.ALL_GROUPS[curve]
    rng = random.Random(seed)
    env = cm.Environment.init(group, t, n, shared)
    keys = [pkm.MemberCommunicationKey.generate(group, rng) for _ in range(n)]
    pks = pkm.sort_committee(group, [k.public() for k in keys])
    by_enc = {k.public().sort_key(group): k for k in keys}
    keys = [by_enc[p.sort_key(group)] for p in pks]
    dealt = [cm.DistributedKeyGeneration.init(env, rng, keys[i], [k.public() for k in keys], i + 1)
             for i in range(n)]
    return env, keys, pks, dealt


def _state_fields(phase):
    st = phase._state
    return (st.index, st.bare_coeff_points, st.randomized_coeff_points, dict(st.received_shares),
            dict(st.randomized_coeffs), dict(st.bare_coeffs), list(st.qualified), set(st.reconstructable),
            set(st.phase3_accused), st.final_share, st.public_share)


@pytest.mark.parametrize("curve,n,t", [("ristretto255", 4, 1), ("secp256k1", 3, 1)])
def test_keys_committee_order_and_init_broadcasts_equal(curve, n, t):
    j_env, j_keys, j_pks, j_dealt = _committee("jax", curve, n, t, 0xC0)
    t_env, t_keys, t_pks, t_dealt = _committee("port", curve, n, t, 0xC0)
    assert to_port(j_env) == t_env
    assert [to_port(k) for k in j_keys] == t_keys
    assert [to_port(p) for p in j_pks] == t_pks
    for (jp, jb), (tp, tb) in zip(j_dealt, t_dealt):
        assert to_port(jb) == tb and to_jax(tb) == jb
        assert _state_fields(jp) == _state_fields(tp)
    # the index is checked, not trusted
    with pytest.raises(ValueError, match="sorted position"):
        tcm.DistributedKeyGeneration.init(t_env, random.Random(1), t_keys[0], [k.public() for k in t_keys], 2)


def test_scalar_codec_elgamal_and_commitments_equal():
    rng_j, rng_t = random.Random(3), random.Random(3)
    for curve in ("ristretto255", "secp256k1", "bls12_381_g1"):
        jg, tg = jgh.ALL_GROUPS[curve], tgh.ALL_GROUPS[curve]
        fs = jg.scalar_field
        for v in (0, 1, fs.modulus - 1, fs.modulus + 5, 12345):
            assert tg.scalar_to_bytes(v) == jg.scalar_to_bytes(v)
            assert tg.scalar_from_bytes(jg.scalar_to_bytes(v)) == jg.scalar_from_bytes(jg.scalar_to_bytes(v))
        assert tg.scalar_from_bytes(b"\x01" * 5) is None
        assert tg.scalar_from_bytes(b"\xff" * fs.nbytes) == jg.scalar_from_bytes(b"\xff" * fs.nbytes)
        assert tg.hash_to_scalar(b"m", b"dom") == jg.hash_to_scalar(b"m", b"dom")
        kp_j, kp_t = jel.Keypair.generate(jg, rng_j), tel.Keypair.generate(tg, rng_t)
        assert to_port(kp_j) == kp_t and tel.Keypair.from_secret(tg, kp_t.sk) == kp_t
        ct_j = jel.encrypt(jg, kp_j.pk, 7, rng_j)
        ct_t = tel.encrypt(tg, kp_t.pk, 7, rng_t)
        assert (ct_t.e1, ct_t.e2) == (ct_j.e1, ct_j.e2)
        assert tg.eq(tel.decrypt_point(tg, kp_t.sk, ct_t + ct_t), tg.scalar_mul(14, tg.generator()))
        assert tg.eq(tel.decrypt_point(tg, kp_t.sk, 3 * ct_t - ct_t), tg.scalar_mul(14, tg.generator()))
        with pytest.raises(TypeError):
            dataclasses.replace(ct_t, group=None) + ct_t
        hc_j, hc_t = jel.hybrid_encrypt(jg, kp_j.pk, b"payload", rng_j), tel.hybrid_encrypt(tg, kp_t.pk, b"payload",
                                                                                              rng_t)
        assert to_port(hc_j) == hc_t and tel.hybrid_decrypt(tg, kp_t.sk, hc_t) == b"payload"
        ck_j, ck_t = jcom.CommitmentKey.generate(jg, b"ck"), tcom.CommitmentKey.generate(tg, b"ck")
        c_j, o_j = jcom.commit(jg, ck_j, 11, rng_j)
        c_t, o_t = tcom.commit(tg, ck_t, 11, rng_t)
        assert c_t == c_j and to_port(o_j) == o_t
        assert tcom.verify(tg, ck_t, c_t, o_t) and not tcom.verify(tg, ck_t, c_t, tcom.Open(12, o_t.r))


def test_proofs_cross_packages():
    """A port proof verifies in the JAX package and a JAX one in the port;
    from the same rng both packages make the same proof."""
    env, keys, pks, dealt = _committee("port", "ristretto255", 4, 1, 0xA1)
    j_env, j_keys, _, j_dealt = _committee("jax", "ristretto255", 4, 1, 0xA1)
    g, jg = env.group, j_env.group
    es = dealt[1][1].shares_for(1)
    t_pom = tbc.ProofOfMisbehaviour.generate(g, es, keys[0], random.Random(9))
    j_pom = jbc.ProofOfMisbehaviour.generate(jg, j_dealt[1][1].shares_for(1), j_keys[0], random.Random(9))
    assert to_port(j_pom) == t_pom
    for zkp, c, key in ((t_pom.proof_share, es.share_ct, t_pom.symm_key_share),
                        (t_pom.proof_rand, es.randomness_ct, t_pom.symm_key_rand)):
        assert isinstance(zkp, TZkp) and zkp.verify(g, c, pks[0].point, key)
        assert to_jax(zkp).verify(jg, to_jax(c), pks[0].point, to_jax(key))
        assert not zkp.verify(g, c, pks[1].point, key)
    k = tel.recover_symmetric_key(g, keys[2].sk, es.share_ct)
    j_zkp = JZkp.generate(jg, to_jax(es.share_ct), pks[2].point, to_jax(k), keys[2].sk, random.Random(4))
    assert to_port(j_zkp).verify(g, es.share_ct, pks[2].point, k)
    assert to_port(j_zkp) == TZkp.generate(g, es.share_ct, pks[2].point, k, keys[2].sk, random.Random(4))
    # a complaint made in one package is upheld in the other
    bad = dataclasses.replace(dealt[1][1], encrypted_shares=(dataclasses.replace(
        es, share_ct=dataclasses.replace(es.share_ct, ciphertext=bytes([es.share_ct.ciphertext[0] ^ 1])
                                         + es.share_ct.ciphertext[1:])),) + dealt[1][1].encrypted_shares[1:])
    comp = tbc.MisbehavingPartiesRound1(2, terr.DkgErrorKind.SHARE_VALIDITY_FAILED,
                                        tbc.ProofOfMisbehaviour.generate(g, bad.shares_for(1), keys[0],
                                                                         random.Random(5)))
    assert comp.verify(g, env.commitment_key, 1, pks[0], bad)
    assert to_jax(comp).verify(jg, j_env.commitment_key, 1, to_jax(pks[0]), to_jax(bad))
    assert not comp.verify(g, env.commitment_key, 1, pks[0], dealt[1][1])
    assert terr.DkgError.from_proof(terr.ProofError("dleq")).kind == terr.DkgErrorKind.ZKP_VERIFICATION_FAILED


def _round1_case(pkg: str, case: str):
    """One round-2 complaint scenario of package ``pkg``: (check result,
    verify result), from one seed."""
    gh, cm, pkm, bc, el, err = PKGS[pkg]
    group = gh.RISTRETTO255
    fs = group.scalar_field
    rng = random.Random(0xE44)
    ck = cm.Environment.init(group, 2, 5, b"errors-test").commitment_key
    accuser = pkm.MemberCommunicationKey.generate(group, rng)
    other = pkm.MemberCommunicationKey.generate(group, rng)
    a = [fs.rand_int(rng) for _ in range(3)]
    b = [fs.rand_int(rng) for _ in range(3)]
    comm = tuple(group.add(group.scalar_mul(x, group.generator()), group.scalar_mul(y, ck.h)) for x, y in zip(a, b))
    share, rand = sum(a) % fs.modulus, sum(b) % fs.modulus  # f(1), f'(1)
    payload = {"false_claim": (share, rand), "bad_share": ((share + 1) % fs.modulus, rand),
               "out_of_range": (None, rand)}.get(case, (share, rand))
    s_bytes = (group.scalar_to_bytes(payload[0]) if payload[0] is not None
               else (fs.modulus + 3).to_bytes(fs.nbytes, "little"))
    s_ct, r_ct = el.seal_pair(group, accuser.public().point, s_bytes, group.scalar_to_bytes(payload[1]), rng)
    if case == "two_kem":
        s_ct = el.hybrid_encrypt_with_random(group, accuser.public().point, group.scalar_to_bytes(share + 1),
                                             fs.rand_int(rng))
        r_ct = el.hybrid_encrypt_with_random(group, accuser.public().point, group.scalar_to_bytes(rand),
                                             fs.rand_int(rng))
    if case == "truncated":
        s_ct = dataclasses.replace(s_ct, ciphertext=s_ct.ciphertext[:-3])
    recipient = 2 if case == "misaddressed" else 1
    b1 = bc.BroadcastPhase1(comm, (bc.EncryptedShares(recipient, s_ct, r_ct),))
    prover = other if case == "wrong_key" else accuser
    es = b1.encrypted_shares[0]
    proof = bc.ProofOfMisbehaviour.generate(group, es, prover, rng)
    complaint = bc.MisbehavingPartiesRound1(1, err.DkgErrorKind.SHARE_VALIDITY_FAILED, proof)
    return complaint.check(group, ck, 1, accuser.public(), b1), complaint.verify(group, ck, 1, accuser.public(), b1)


def _same_error(got, want) -> bool:
    if want is None:
        return got is None
    return (got is not None and got.kind.name == want.kind.name and got.index == want.index
            and got.detail == want.detail)


@pytest.mark.parametrize("case", ["misaddressed", "wrong_key", "false_claim", "bad_share", "out_of_range",
                                  "truncated", "two_kem"])
def test_round1_complaint_check_branches(case):
    """Each branch of MisbehavingPartiesRound1.check, in both packages: no
    ciphertext for the accuser, proofs under the wrong key (both
    INVALID_PROOF_OF_MISBEHAVIOUR, with their details), an honest share
    (FALSE_CLAIMED_INEQUALITY), and upheld: a share off the commitments, a
    value not below the order, a truncated ciphertext, a two-KEM pair."""
    want = _round1_case("jax", case)
    got = _round1_case("port", case)
    assert got[1] == want[1]
    assert _same_error(got[0], want[0]), (got, want)
    assert (want[0] is None) == (case in ("bad_share", "out_of_range", "truncated", "two_kem"))


@pytest.mark.parametrize("case", ["false_equality", "false_inequality", "upheld", "silent"])
def test_round3_complaint_check_branches(case):
    """Each branch of MisbehavingPartiesRound3.check, in both packages."""
    out = {}
    for pkg in ("jax", "port"):
        gh, cm, _, bc, _, _ = PKGS[pkg]
        group = gh.SECP256K1
        fs = group.scalar_field
        rng = random.Random(0x33)
        ck = cm.Environment.init(group, 2, 5, b"round3").commitment_key
        a = [fs.rand_int(rng) for _ in range(3)]
        b = [fs.rand_int(rng) for _ in range(3)]
        x = 4
        comm = tuple(group.add(group.scalar_mul(u, group.generator()), group.scalar_mul(v, ck.h)) for u, v in zip(a, b))
        share = sum(u * x**k for k, u in enumerate(a)) % fs.modulus
        rand = sum(v * x**k for k, v in enumerate(b)) % fs.modulus
        bare = tuple(group.scalar_mul(u, group.generator()) for u in a)
        lying = tuple(group.scalar_mul(u + 1, group.generator()) for u in a)
        complaint = bc.MisbehavingPartiesRound3(1, (share + 1) % fs.modulus if case == "false_equality" else share,
                                                rand)
        bare_of = {"false_equality": bare, "false_inequality": bare, "upheld": lying, "silent": None}[case]
        out[pkg] = (complaint.check(group, ck, x, comm, bare_of), complaint.verify(group, ck, x, comm, bare_of))
    assert out["port"][1] == out["jax"][1] == (case in ("upheld", "silent"))
    assert _same_error(out["port"][0], out["jax"][0])


def _whole_flow(pkg: str):
    """Phases 1-5 at ristretto255 (6, 2): dealer 3 seals shares off its
    commitments to parties 1 and 5 (round-2 complaints), dealer 4 publishes
    wrong bare commitments (round-4 complaints, its secret reconstructed).
    Returns what every party saw and decided."""
    _, cm, _, bc, el, _ = PKGS[pkg]
    env, keys, pks, dealt = _committee(pkg, "ristretto255", 6, 2, 0xF10)
    group = env.group
    fs = group.scalar_field
    rng = random.Random(0xF11)
    b1 = [b for _, b in dealt]
    enc = list(b1[2].encrypted_shares)
    for v in (1, 5):
        s_ct, r_ct = el.seal_pair(group, pks[v - 1].point, group.scalar_to_bytes(fs.rand_int(rng)),
                                  group.scalar_to_bytes(fs.rand_int(rng)), rng)
        enc[v - 1] = bc.EncryptedShares(v, s_ct, r_ct)
    b1[2] = bc.BroadcastPhase1(b1[2].committed_coefficients, tuple(enc))
    f1 = [cm.FetchedPhase1.from_broadcast(env, j + 1, b1[j]) for j in range(6)]
    r2 = [p.proceed(f1, rng) for p, _ in dealt]
    c2 = [cm.FetchedComplaints2(i + 1, b) for i, (_, b) in enumerate(r2)]
    r3 = [p.proceed(c2, f1) for p, _ in r2]
    b3 = [b for _, b in r3]
    b3[3] = bc.BroadcastPhase3((group.add(b3[3].committed_coefficients[0], group.generator()),)
                               + tuple(b3[3].committed_coefficients[1:]))
    r4 = [p.proceed([cm.FetchedPhase3.from_broadcast(env, j + 1, b3[j]) for j in range(6)]) for p, _ in r3]
    r5 = [p.proceed([cm.FetchedComplaints4(i + 1, b) for i, (_, b) in enumerate(r4)]) for p, _ in r4]
    final = [p.finalise([cm.FetchedPhase5(i + 1, b) for i, (_, b) in enumerate(r5)])[0] for p, _ in r5]
    return {
        "complaints2": [None if b is None else [(m.accused_index, m.error.name) for m in b.misbehaving_parties]
                        for _, b in r2],
        "qualified": [p.qualified_set for p, _ in r5],
        "complaints4": [None if b is None else [(m.accused_index, m.share, m.randomness)
                                                 for m in b.misbehaving_parties] for _, b in r4],
        "reconstructable": [sorted(p._state.reconstructable) for p, _ in r5],
        "disclosed": [None if b is None else [dataclasses.astuple(d) for d in b.disclosed_shares] for _, b in r5],
        "final_shares": [s.value for _, s in final],
        "masters": [group.encode(m.point) for m, _ in final],
        "public_shares": [group.encode(p.public_share.point) for p, _ in r5],
        "secret_ok": final[0][0].check_reproduced_by(group, jlagrange(
            fs, 0, [final[i][1].value for i in (0, 1, 4)], [1, 2, 5])) is None,
    }


def test_whole_protocol_with_round1_and_round3_cheats():
    want = _whole_flow("jax")
    got = _whole_flow("port")
    assert got == want
    assert got["complaints2"][0] == [(3, "SHARE_VALIDITY_FAILED")] and got["complaints2"][4] == [(3, "SHARE_VALIDITY_FAILED")]
    assert all(q[2] == 0 for q in got["qualified"])
    assert got["reconstructable"][0] == [4] and got["secret_ok"]
    assert len(set(got["masters"][i] for i in (0, 1, 2, 4, 5))) == 1


def test_error_paths_and_master_key_checks():
    env, keys, pks, dealt = _committee("port", "ristretto255", 4, 1, 0xB0)
    group = env.group
    with pytest.raises(ValueError):
        tcm.Environment.init(group, 3, 4, b"x")  # not an honest majority
    with pytest.raises(ValueError):
        tcm.Environment.init(group, 0, 4, b"x")
    # a wrong-shaped broadcast is a silent dropout
    b = dealt[1][1]
    assert tcm.FetchedPhase1.from_broadcast(env, 2, tbc.BroadcastPhase1(b.committed_coefficients[:1],
                                                                          b.encrypted_shares)).broadcast is None
    assert tcm.FetchedPhase3.from_broadcast(env, 2, tbc.BroadcastPhase3(())).broadcast is None
    fs = group.scalar_field
    sk = fs.rand_int(random.Random(1))
    mk = tpk.MasterPublicKey.from_shares(group, [tpk.MemberPublicShare(group.scalar_mul(sk, group.generator()))])
    assert mk.check_consistent(group, [mk.point]) is None and mk.check_reproduced_by(group, sk) is None
    err = mk.check_consistent(group, [mk, group.generator()])
    assert err.kind == terr.DkgErrorKind.INCONSISTENT_MASTER_KEY and err.index == 1
    assert mk.check_reproduced_by(group, sk + 1).kind == terr.DkgErrorKind.INCONSISTENT_MASTER_KEY
    # more complaints than t abort with the evidence still published; misaddressed data is an error
    phases = [copy.deepcopy(p) for p, _ in dealt]
    fetched = [tcm.FetchedPhase1.from_broadcast(env, j + 1, dealt[j][1]) for j in range(4)]
    misaddressed = list(fetched)
    es = dealt[2][1].encrypted_shares
    misaddressed[2] = tcm.FetchedPhase1(3, tbc.BroadcastPhase1(dealt[2][1].committed_coefficients,
                                                                (dataclasses.replace(es[0], recipient_index=2),)
                                                                + es[1:]))
    res, bcast = phases[0].proceed(misaddressed, random.Random(2))
    assert isinstance(res, terr.DkgError) and res.kind == terr.DkgErrorKind.FETCHED_INVALID_DATA and res.index == 3
    assert bcast is None and str(res).startswith("fetched data")
    j_env, _, _, j_dealt = _committee("jax", "ristretto255", 4, 1, 0xB0)
    j_res, _ = copy.deepcopy(j_dealt[0][0]).proceed([jcm.FetchedPhase1.from_broadcast(j_env, f.sender_index,
                                                                                       to_jax(f.broadcast))
                                                     for f in misaddressed], random.Random(2))
    assert isinstance(j_res, jerr.DkgError) and (j_res.kind.name, j_res.index) == (res.kind.name, res.index)


def test_ceremony_trace_as_dict_equal():
    traces = {}
    for name, cls in (("jax", JTrace), ("port", TTrace)):
        tr = cls(meta={"n": 5, "units": 20})
        tr.record("deal", 0.5)
        tr.record("deal", 0.25)
        tr.record("seal", 2.0)
        tr.record_sub("verify", "kem", 0.125)
        tr.record_sub("verify", "kem", 0.125)
        tr.bump("pairs_sealed", 25)
        tr.bump("net.wire_bytes_out", 4000)
        tr.bump("net.wire_bytes_in")
        traces[name] = tr
    assert traces["port"].as_dict() == traces["jax"].as_dict()
    assert traces["port"].json() == traces["jax"].json()
    assert TTrace().as_dict() == JTrace().as_dict()


@pytest.fixture(scope="module")
def jax_dealing():
    """The JAX package's batched_dealing at ristretto255 (4, 1), compiled
    once for the module, with its rng and keys."""
    rng = random.Random(0xBA7D)
    group = jgh.RISTRETTO255
    env = jcm.Environment.init(group, 1, 4, b"committee-batch")
    keys = [jpk.MemberCommunicationKey.generate(group, rng) for _ in range(4)]
    state = rng.getstate()
    dealt = jax_batched_dealing(env, rng, keys)
    return env, keys, state, dealt


@pytest.mark.parametrize("members", [None, [2, 4]], ids=["all", "subset"])
def test_batched_dealing_equals_the_jax_package(jax_dealing, members):
    """The port's batched_dealing on CPU tensors gives the JAX package's
    broadcasts and phase states, byte for byte, from the same rng state;
    a member subset deals those members' rows of the same draws' order."""
    env, keys, state, j_dealt = jax_dealing
    rng = random.Random()
    rng.setstate(state)
    trace = TTrace()
    t_dealt = port_batched_dealing(to_port(env), rng, [to_port(k) for k in keys], members, trace=trace,
                                   device="cpu")
    if members is None:
        assert len(t_dealt) == 4 and trace.counters["pairs_sealed"] == 16
        assert set(trace.timings_s) == {"deal", "seal"}
        for (jp, jb), (tp, tb) in zip(j_dealt, t_dealt):
            assert to_port(jb) == tb and to_jax(tb) == jb
            assert _state_fields(jp) == _state_fields(tp)
    else:
        # the subset's rows are the first two of the draws, not the full dealing's rows 2 and 4
        assert [p._state.index for p, _ in t_dealt] == members
        for p, b in t_dealt:
            assert len(b.committed_coefficients) == 2 and len(b.encrypted_shares) == 4
            st = p._state
            mine = b.shares_for(st.index)
            assert st.received_shares[st.index] == tpk.decrypt_shares(tgh.RISTRETTO255, _sorted_key(keys, st.index),
                                                                        mine.share_ct, mine.randomness_ct)
        # the phases proceed on the host: every share verifies
        t_env = to_port(env)
        fetched = [tcm.FetchedPhase1.from_broadcast(t_env, p._state.index, b) for p, b in t_dealt]
        for p, _ in t_dealt:
            res, bcast = copy.deepcopy(p).proceed(fetched, random.Random(1))
            assert isinstance(res, tcm.DkgPhase2) and bcast is None


def _sorted_key(keys, index: int):
    """The port key of sorted position ``index`` among the JAX package's keys."""
    group = tgh.RISTRETTO255
    port = [to_port(k) for k in keys]
    order = tpk.sort_committee(group, [k.public() for k in port])
    return next(k for k in port if group.eq(k.public().point, order[index - 1].point))
