"""Rounds 1 and 2 of the wire protocol for many co-located parties at
once, on the card.

A JAX-free counterpart of ``dkg_tpu/dkg/committee_batch.py``.
``DistributedKeyGeneration.init`` and ``DkgPhase1.proceed``
(``committee.py``) are one party's host path.  When a host drives many
parties (the sharded deployment, or a simulation), both rounds batch:

* :func:`batched_dealing`: every local dealer's commitments (two
  ``fixed_base_mul``) and share matrix (``eval_many``) through
  ``ceremony.deal``, the KEM of every (dealer, recipient) pair on the
  card and the DEM on the host (``hybrid_batch.seal_shares_pipeline``),
  packaged as round-1 messages (``hybrid_batch.broadcasts_from_batch``);
* :func:`batched_share_verification`: the KEM recovery sk_i·e1 of every
  pair as one ``scalar_mul`` (a table a lane), the DEM through the
  batched BLAKE2b KDF and ChaCha20, and every commitment check as one
  ``complaints_batch.check_randomized_shares_limbs``.

Each gives what the per-party host path gives: the same ``rng`` draws in
the same order, the same phase objects, state, complaints, errors and
threshold abort, so phases 2-5 then proceed on the host as for any party.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..crypto.blake2 import kdf_batch
from ..crypto.chacha import chacha20_xor_batch
from ..crypto.elgamal import PERSON_RAND, PERSON_SHARE
from ..fields import host as fh
from ..groups import device as gd
from ..groups import precompute as gp
from ..utils.tracing import CeremonyTrace, phase_span
from .broadcast import BroadcastPhase1, BroadcastPhase2, MisbehavingPartiesRound1, ProofOfMisbehaviour
from .ceremony import CeremonyConfig, deal, resolve_device
from .committee import DkgPhase1, DkgPhase2, Environment, FetchedPhase1, _State
from .complaints_batch import check_randomized_shares_limbs
from .errors import DkgError, DkgErrorKind
from .hybrid_batch import _host_points, broadcasts_from_batch, seal_shares_pipeline
from .procedure_keys import MemberCommunicationKey, decode_scalar_pair, sort_committee


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def batched_dealing(env: Environment, rng, comm_keys: list[MemberCommunicationKey], members: list[int] | None = None,
                    trace: CeremonyTrace | None = None, *, device="cuda") -> list[tuple[DkgPhase1, BroadcastPhase1]]:
    """Round-1 dealing for the local parties ``members`` (1-based sorted
    indices; by default every member), on ``device``.  ``comm_keys`` holds
    the whole committee's keys in any order; each local party's must be
    there.  ``rng`` draws every local dealer's sharing coefficients, then
    every hiding coefficient, then the KEM randomness of every pair, as
    the JAX package draws them.

    Returns one (phase 1, broadcast) pair a local party, in ``members``
    order, as per-party ``DistributedKeyGeneration.init`` calls would.
    ``trace`` records ``deal`` (polynomials and commitments) and ``seal``
    (KEM and DEM, with a ``pairs_sealed`` counter), each ended by a device
    synchronise."""
    group = env.group
    cs = gd.ALL_CURVES[group.name]
    fs = group.scalar_field
    n, t = env.nr_members, env.threshold
    if len(comm_keys) != n:
        raise ValueError("committee size does not match environment")
    dev = resolve_device(device)
    pks = sort_committee(group, [k.public() for k in comm_keys])
    key_by_enc = {k.public().sort_key(group): k for k in comm_keys}
    sorted_keys = [key_by_enc[p.sort_key(group)] for p in pks]
    if members is None:
        members = list(range(1, n + 1))
    m = len(members)

    cfg = CeremonyConfig(group.name, n, t)
    g_table = gp.generator_table(cs, device=dev)
    h_table = gp.base_table(cs, env.commitment_key.h, device=dev)
    coeffs_a = fh.to_tensor(fh.encode(fs, [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(m)]), dev)
    coeffs_b = fh.to_tensor(fh.encode(fs, [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(m)]), dev)
    with phase_span(trace, "deal"):
        bare_dev, rand_dev, shares_dev, hidings_dev = deal(cfg, coeffs_a, coeffs_b, g_table, h_table)
        _sync(dev)

    pks_dev = gd.from_host(cs, [p.point for p in pks], device=dev)
    r_enc = fh.to_tensor(fh.encode(fs, [[fs.rand_int(rng) for _ in range(n)] for _ in range(m)]), dev)
    with phase_span(trace, "seal"):
        sealed = seal_shares_pipeline(group, cfg, shares_dev, hidings_dev, pks_dev, r_enc, g_table)
        if trace is not None:
            trace.bump("pairs_sealed", m * n)
    broadcasts = broadcasts_from_batch(group, cfg, rand_dev, sealed)

    shares_host = fh.decode(fs, fh.from_tensor(shares_dev))
    hidings_host = fh.decode(fs, fh.from_tensor(hidings_dev))
    bare_np = fh.from_tensor(bare_dev)
    out = []
    for d, my in enumerate(members):
        state = _State(env, my, sorted_keys[my - 1], pks)
        state.bare_coeff_points = tuple(_host_points(cs, bare_np[d]))
        state.randomized_coeff_points = broadcasts[d].committed_coefficients
        state.bare_coeffs[my] = state.bare_coeff_points
        state.randomized_coeffs[my] = state.randomized_coeff_points
        state.received_shares[my] = (int(shares_host[d, my - 1]), int(hidings_host[d, my - 1]))
        out.append((DkgPhase1(state), broadcasts[d]))
    return out


def _dem_open(kem_enc: np.ndarray, halves: list[tuple[int, bytes, bytes]]) -> list[bytes]:
    """The plaintexts of hybrid ciphertext halves (KEM row of ``kem_enc``,
    KDF tag, ciphertext): the per-pair DEM (``hybrid_decrypt_with_key``) as
    one ``kdf_batch`` and one ``chacha20_xor_batch`` for each tag and
    ciphertext length, the same bytes."""
    out: list[bytes] = [b""] * len(halves)
    groups: dict[tuple[bytes, int], list[int]] = {}
    for h, (_, person, ct) in enumerate(halves):
        groups.setdefault((person, len(ct)), []).append(h)
    for (person, length), rows in groups.items():
        if length == 0:
            continue
        key, nonce = kdf_batch(kem_enc[[halves[h][0] for h in rows]], person)
        data = np.frombuffer(b"".join(halves[h][2] for h in rows), dtype=np.uint8).reshape(len(rows), length)
        pt = chacha20_xor_batch(key, nonce, data)
        for r, h in enumerate(rows):
            out[h] = pt[r].tobytes()
    return out


def batched_share_verification(phase1s: list[DkgPhase1], fetched: list[FetchedPhase1], rng, *, device="cuda",
                               trace: CeremonyTrace | None = None
                               ) -> list[tuple["DkgPhase2 | DkgError", BroadcastPhase2 | None]]:
    """Round-2 share verification for many co-located parties at once, on
    ``device``.

    Exactly per-party ``DkgPhase1.proceed(fetched, rng)``: the same state
    mutations, complaints (in fetched sender order), errors and threshold
    abort; the complaints' proof nonces drawn from ``rng`` in stage order
    (undecodable pairs, then failed checks).  Five stages:

    1. host triage in fetched order: dropouts disqualified, misaddressed
       data an error, one KEM recovery queued a distinct e1 of a pair;
    2. every KEM point sk_i·e1 as one ``scalar_mul`` (a table a lane);
    3. the DEM: the KEM points' encodings as one ``encode_batch``, the KDF
       and ChaCha20 batched (:func:`_dem_open`), each pair decoded by
       ``decode_scalar_pair``; an undecodable pair is a complaint;
    4. every commitment check g·s + h·s' == Σ_l x_i^l·E_{j,l} as one
       ``check_randomized_shares_limbs`` over per-lane coefficients (each
       dealer's commitments sent to the device once, then gathered a lane);
    5. each party's result.

    ``fetched`` is the broadcast channel's view every local party
    consumes.  ``trace`` records the phase ``verify`` with the stages'
    host seconds as its sub-timings (``triage``, ``kem``, ``dem``,
    ``recheck``, ``assembly``), the device stages ended by a synchronise."""
    if not phase1s:
        return []
    dev = resolve_device(device)
    sts = [p._state for p in phase1s]
    env, group = sts[0].env, sts[0].group
    cs = gd.ALL_CURVES[group.name]
    fs = group.scalar_field
    sender_order = [f.sender_index for f in fetched]
    clock = [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        if trace is not None:
            trace.record_sub("verify", name, now - clock[0])
        clock[0] = now

    with phase_span(trace, "verify"):
        # --- stage 1: host triage in fetched order
        kem_sks: list[int] = []
        kem_pts: list[tuple] = []
        jobs: list[tuple[int, int, object, int, int]] = []
        errors: list[DkgError | None] = [None] * len(sts)
        for i, st in enumerate(sts):
            for f in fetched:
                j = f.sender_index
                if j == st.index:
                    continue
                if f.broadcast is None:
                    st.disqualify(j)  # silent dropout
                    continue
                mine = f.broadcast.shares_for(st.index)
                if mine is None or mine.recipient_index != st.index:
                    errors[i] = DkgError(DkgErrorKind.FETCHED_INVALID_DATA, index=j)
                    break
                k1 = len(kem_sks)
                kem_sks.append(st.comm_key.sk)
                kem_pts.append(mine.share_ct.e1)
                if group.eq(mine.share_ct.e1, mine.randomness_ct.e1):
                    k2 = k1  # the sealed-pair layout: one KEM point for both halves
                else:
                    k2 = len(kem_sks)
                    kem_sks.append(st.comm_key.sk)
                    kem_pts.append(mine.randomness_ct.e1)
                jobs.append((i, j, mine, k1, k2))
        stage("triage")

        # --- stage 2: every KEM point as one device batch
        kem_dev = None
        if kem_sks:
            kem_dev = gd.scalar_mul(cs, fh.to_tensor(fh.encode(fs, kem_sks), dev),
                                    gd.from_host(cs, kem_pts, device=dev))
            _sync(dev)
        stage("kem")

        # --- stage 3: the DEM; undecodable pairs become complaints
        complaint_at: dict[tuple[int, int], MisbehavingPartiesRound1] = {}
        share_jobs: list[tuple[int, int, object, int, int]] = []
        if jobs:
            kem_enc = gd.encode_batch(cs, kem_dev)
            halves = []
            for _, _, mine, k1, k2 in jobs:
                halves.append((k1, PERSON_SHARE, mine.share_ct.ciphertext))
                halves.append((k2, PERSON_RAND if k2 == k1 else PERSON_SHARE, mine.randomness_ct.ciphertext))
            plain = _dem_open(kem_enc, halves)
            for q, (i, j, mine, _, _) in enumerate(jobs):
                st = sts[i]
                (s, r), kind = decode_scalar_pair(group, plain[2 * q], plain[2 * q + 1])
                if s is None or r is None:
                    st.disqualify(j)
                    complaint_at[(i, j)] = MisbehavingPartiesRound1(
                        j, kind or DkgErrorKind.SCALAR_OUT_OF_BOUNDS,
                        ProofOfMisbehaviour.generate(group, mine, st.comm_key, rng))
                    continue
                share_jobs.append((i, j, mine, s, r))
        stage("dem")

        # --- stage 4: every commitment check as one device batch
        if share_jobs:
            by_sender = {f.sender_index: f.broadcast for f in fetched}
            row_of: dict[int, int] = {}
            for _, j, *_ in share_jobs:
                row_of.setdefault(j, len(row_of))
            flat = [c for j in row_of for c in by_sender[j].committed_coefficients]
            comm = gd.from_host(cs, flat, device=dev).reshape(len(row_of), env.threshold + 1, cs.ncoords,
                                                              cs.field.limbs)
            rows = torch.tensor([row_of[x[1]] for x in share_jobs], dtype=torch.int64, device=dev)
            cpts = comm.index_select(0, rows)  # (k, t+1, C, L): each lane's dealer, read in place
            s_limbs = fh.to_tensor(fh.encode(fs, [x[3] for x in share_jobs]), dev)
            r_limbs = fh.to_tensor(fh.encode(fs, [x[4] for x in share_jobs]), dev)
            idx = torch.tensor([sts[x[0]].index for x in share_jobs], dtype=torch.int32, device=dev)
            nbits = max(2, int(env.nr_members).bit_length())
            ok = check_randomized_shares_limbs(group, cs, env.commitment_key, idx, s_limbs, r_limbs, cpts, nbits)
            del cpts
            for (i, j, mine, s, r), good in zip(share_jobs, ok):
                st = sts[i]
                if bool(good):
                    st.received_shares[j] = (s, r)
                    st.randomized_coeffs[j] = tuple(by_sender[j].committed_coefficients)
                else:
                    st.disqualify(j)
                    complaint_at[(i, j)] = MisbehavingPartiesRound1(
                        j, DkgErrorKind.SHARE_VALIDITY_FAILED,
                        ProofOfMisbehaviour.generate(group, mine, st.comm_key, rng))
        stage("recheck")

        # --- stage 5: each party's result, complaints in fetched sender order
        results: list[tuple[DkgPhase2 | DkgError, BroadcastPhase2 | None]] = []
        for i, st in enumerate(sts):
            if errors[i] is not None:
                results.append((errors[i], None))
                continue
            comps = tuple(complaint_at[(i, j)] for j in sender_order if (i, j) in complaint_at)
            broadcast = BroadcastPhase2(comps) if comps else None
            if len(comps) > env.threshold:
                results.append((DkgError(DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD), broadcast))
            else:
                results.append((DkgPhase2(st), broadcast))
        stage("assembly")
    return results
