"""The complaint court: round-2 complaints adjudicated in batch on the card.

A JAX-free counterpart of ``dkg_tpu/dkg/complaints_batch.py``.  The host
state machine checks complaints one at a time
(``MisbehavingPartiesRound1.verify``): two DLEQ verifications and a
Pedersen share re-check each.  Under a storm of k complaints, the most
the threshold admits, :func:`adjudicate_round1_batch` verifies every
complaint's two DLEQ proofs as one ``dleq_batch.verify_batch`` (one
per-row ``groups.device.msm``) and every re-check as one
:func:`check_randomized_shares_limbs`; only the BLAKE2b transcripts, the
DEM re-decryption and the bookkeeping stay on the host.  Its verdicts
are the serial court's, complaint by complaint.

:func:`check_randomized_shares_limbs` is the one device implementation
of g·s + h·s' == Σ_l x^l·E_l: two ``pt_fixed_base`` launches, one
``pt_add`` and one ``pt_ladder_horner`` over per-lane coefficients
(k, t+1, C, L).  The batched round 2 (``committee_batch``) runs it too.

:func:`adjudicate_round1` routes by the device it is given: the batch
court on the card, the serial court on the CPU, where the serial court
is the faster one, in the JAX package (its ``STORM.json``) and in the
port (``python3 -m dkg_tpu_torch.dkg.storm_bench --device cpu`` times
both on the same storm).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..crypto import dleq_batch
from ..crypto.commitment import CommitmentKey
from ..fields import host as fh
from ..groups import device as gd
from ..groups import precompute as gp
from .broadcast import BroadcastPhase1, MisbehavingPartiesRound1
from .ceremony import resolve_device
from .procedure_keys import MemberCommunicationPublicKey


def check_randomized_shares_batch(group, cs, ck: CommitmentKey, indices: list[int], shares: list[int],
                                  rands: list[int], coeffs_list: list[tuple], *, device="cuda") -> np.ndarray:
    """g·s + h·s' == Σ_l idx^l·E_l for k independent checks of host ints
    and host points, on ``device``: bool (k,)."""
    if not indices:
        return np.zeros((0,), dtype=bool)
    dev = resolve_device(device)
    fs = group.scalar_field
    k, tp1 = len(indices), len(coeffs_list[0])
    s_limbs = fh.to_tensor(fh.encode(fs, shares), dev)
    r_limbs = fh.to_tensor(fh.encode(fs, rands), dev)
    flat = [c for coeffs in coeffs_list for c in coeffs]
    cpts = gd.from_host(cs, flat, device=dev).reshape(k, tp1, cs.ncoords, cs.field.limbs)
    idx = torch.tensor(indices, dtype=torch.int32, device=dev)
    nbits = max(2, int(max(indices)).bit_length())
    return check_randomized_shares_limbs(group, cs, ck, idx, s_limbs, r_limbs, cpts, nbits)


def check_randomized_shares_limbs(group, cs, ck: CommitmentKey, idx: torch.Tensor, s_limbs: torch.Tensor,
                                  r_limbs: torch.Tensor, cpts: torch.Tensor, nbits: int) -> np.ndarray:
    """The device core of the check on limb tensors, where they lie: idx
    (k,) int32 recipient indices below 2**nbits, s_limbs and r_limbs (k, L),
    cpts (k, t+1, C, L) each lane's dealer commitments, read in place by
    the Horner launch -> bool (k,)."""
    dev = s_limbs.device
    g_tab = gp.generator_table(cs, device=dev)
    h_tab = gp.base_table(cs, ck.h, device=dev)
    lhs = gd.add(cs, gd.fixed_base_mul(cs, g_tab, s_limbs), gd.fixed_base_mul(cs, h_tab, r_limbs))
    rhs = gd.eval_point_poly(cs, cpts, idx, nbits)
    return gd.eq(cs, lhs, rhs).cpu().numpy()


def adjudicate_round1_serial(group, ck: CommitmentKey,
                             fetched_complaints: list[tuple[int, MemberCommunicationPublicKey,
                                                            MisbehavingPartiesRound1]],
                             round1_by_sender: dict[int, BroadcastPhase1 | None]) -> list[bool]:
    """The serial host court: one ``MisbehavingPartiesRound1.verify`` a
    (accuser index, accuser key, complaint) triple; a complaint against a
    dealer that never dealt is rejected."""
    verdicts = []
    for accuser_idx, accuser_pk, m in fetched_complaints:
        b = round1_by_sender.get(m.accused_index)
        verdicts.append(False if b is None else m.verify(group, ck, accuser_idx, accuser_pk, b))
    return verdicts


def adjudicate_round1(group, cs, ck: CommitmentKey,
                      fetched_complaints: list[tuple[int, MemberCommunicationPublicKey, MisbehavingPartiesRound1]],
                      round1_by_sender: dict[int, BroadcastPhase1 | None], timings: dict | None = None, *,
                      device="cuda") -> list[bool]:
    """The court for ``device``: :func:`adjudicate_round1_batch` on the
    card, :func:`adjudicate_round1_serial` on the CPU (``timings`` then
    gains ``serial_s`` alone).  The verdicts are the same either way."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        t0 = time.perf_counter()
        out = adjudicate_round1_serial(group, ck, fetched_complaints, round1_by_sender)
        if timings is not None:
            timings["serial_s"] = time.perf_counter() - t0
        return out
    return adjudicate_round1_batch(group, cs, ck, fetched_complaints, round1_by_sender, timings=timings, device=dev)


def adjudicate_round1_batch(group, cs, ck: CommitmentKey,
                            fetched_complaints: list[tuple[int, MemberCommunicationPublicKey,
                                                           MisbehavingPartiesRound1]],
                            round1_by_sender: dict[int, BroadcastPhase1 | None], timings: dict | None = None, *,
                            device="cuda") -> list[bool]:
    """Every (accuser index, accuser key, complaint) triple at once: a
    complaint is upheld iff the accused dealt to the accuser, both
    disclosed-key proofs verify, and the pair decrypted again is not a
    pair of scalars or fails the commitment check.

    ``timings``, if given, gains the host seconds of each stage:
    ``dleq_s`` (the batched proof verification), ``decrypt_s`` (the host
    DEM re-decryption) and ``recheck_s`` (the batched re-check)."""
    dev = resolve_device(device)
    k = len(fetched_complaints)
    verdicts = [False] * k
    # stage 1: the DLEQ statements of complaints whose accused dealt to the accuser
    dleq_stmts, dleq_proofs, owner = [], [], []
    located = {}
    gpt = group.generator()
    for i, (accuser_idx, accuser_pk, m) in enumerate(fetched_complaints):
        b = round1_by_sender.get(m.accused_index)
        shares = b.shares_for(accuser_idx) if b is not None else None
        if shares is None:
            continue  # rejected here
        located[i] = shares
        dleq_stmts.append((gpt, shares.share_ct.e1, accuser_pk.point, m.proof.symm_key_share.point))
        dleq_proofs.append(m.proof.proof_share.proof)
        owner.append(i)
        dleq_stmts.append((gpt, shares.randomness_ct.e1, accuser_pk.point, m.proof.symm_key_rand.point))
        dleq_proofs.append(m.proof.proof_rand.proof)
        owner.append(i)
    t0 = time.perf_counter()
    ok = dleq_batch.verify_batch(group, cs, dleq_proofs, dleq_stmts, device=dev)
    if timings is not None:
        timings["dleq_s"] = time.perf_counter() - t0
    proof_ok = {i: True for i in located}
    for j, i in enumerate(owner):
        proof_ok[i] = proof_ok[i] and bool(ok[j])

    # stage 2: decrypt the survivors again; their pairs to the batched re-check
    t0 = time.perf_counter()
    recheck = []  # (i, accuser index, s, r, coeffs)
    for i, shares in located.items():
        if not proof_ok[i]:
            continue
        accuser_idx, _, m = fetched_complaints[i]
        s, r = m.proof.decrypt_scalars(group, shares)
        if s is None or r is None:
            verdicts[i] = True  # the plaintext is not a scalar: upheld
            continue
        recheck.append((i, accuser_idx, s, r, round1_by_sender[m.accused_index].committed_coefficients))
    if timings is not None:
        timings["decrypt_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if recheck:
        share_ok = check_randomized_shares_batch(group, cs, ck, [x[1] for x in recheck], [x[2] for x in recheck],
                                                 [x[3] for x in recheck], [x[4] for x in recheck], device=dev)
        for (i, *_), good in zip(recheck, share_ok):
            verdicts[i] = not bool(good)  # upheld iff the check fails
    if timings is not None:
        timings["recheck_s"] = time.perf_counter() - t0
    return verdicts
