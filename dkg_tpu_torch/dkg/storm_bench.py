"""Time the two complaint courts on a storm of accusations: the serial
host court against the batch court, on the same triples.

Run from the root of a checkout:

    python3 -m dkg_tpu_torch.dkg.storm_bench [--n 16] [--k 5] [--reps 3] [--device cuda|cpu]

The storm is ``scripts/storm_bench.py``'s, over the port, on ristretto255
at n members and threshold k: dealer 1 wire-deals to everyone
(``batched_dealing``), its share ciphertexts to accusers 2 .. k + 1 get a
flipped byte, each accuser files a genuine ``ProofOfMisbehaviour`` and
accuser k + 2 a false one against an honest payload.  Each rep times
``adjudicate_round1_serial`` and ``adjudicate_round1_batch`` on
``--device`` by the host clock, checks both give [True] * k + [False],
and the script prints one JSON line: the device, n, k and per rep each
court's seconds and the batch court's stages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time

import torch

from ..groups import device as gd
from ..groups import host as gh
from . import broadcast as bc
from . import committee as cm
from . import committee_batch as cmb
from . import complaints_batch as court
from . import procedure_keys as pkeys
from .ceremony import resolve_device
from .errors import DkgErrorKind


def committee_keys(group, n: int, rng) -> tuple:
    """n communication keys from ``rng``, the sorted committee's public keys
    and the keys in that order."""
    keys = [pkeys.MemberCommunicationKey.generate(group, rng) for _ in range(n)]
    pks = pkeys.sort_committee(group, [k.public() for k in keys])
    by_enc = {k.public().sort_key(group): k for k in keys}
    return keys, pks, [by_enc[p.sort_key(group)] for p in pks]


def flip_byte(b: bc.BroadcastPhase1, recipients) -> bc.BroadcastPhase1:
    """``b`` with the first byte of the share ciphertext to each recipient
    flipped (scripts/storm_bench.py's tampering)."""
    es = list(b.encrypted_shares)
    for r in recipients:
        old = es[r - 1]
        bad = dataclasses.replace(old.share_ct, ciphertext=bytes([old.share_ct.ciphertext[0] ^ 1])
                                  + old.share_ct.ciphertext[1:])
        es[r - 1] = bc.EncryptedShares(old.recipient_index, bad, old.randomness_ct)
    return dataclasses.replace(b, encrypted_shares=tuple(es))


def build_storm(env, keys, pks, sorted_keys, rng, k: int, *, device="cuda") -> tuple:
    """scripts/storm_bench.py's ``build_storm`` over the port: dealer 1
    wire-deals to everyone on ``device``, its share ciphertexts to accusers
    2 .. k + 1 get a flipped byte, each accuser files a genuine complaint,
    and accuser k + 2 a false one.  Returns (the tampered broadcast, the
    (accuser, accuser key, complaint) triples)."""
    group = env.group
    ((_, broadcast),) = cmb.batched_dealing(env, rng, keys, members=[1], device=device)
    accusers = list(range(2, k + 2))
    tampered = flip_byte(broadcast, accusers)
    triples = []
    for a in accusers + [k + 2]:
        proof = bc.ProofOfMisbehaviour.generate(group, tampered.shares_for(a), sorted_keys[a - 1], rng)
        triples.append((a, pks[a - 1], bc.MisbehavingPartiesRound1(1, DkgErrorKind.SHARE_VALIDITY_FAILED, proof)))
    return tampered, triples


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    group, cs = gh.RISTRETTO255, gd.RISTRETTO255
    rng = random.Random(f"{args.seed}-storm")
    env = cm.Environment.init(group, args.k, args.n, b"storm-bench")
    keys, pks, sorted_keys = committee_keys(group, args.n, rng)
    tampered, triples = build_storm(env, keys, pks, sorted_keys, rng, args.k, device=dev)
    by_sender = {1: tampered}
    want = [True] * args.k + [False]
    reps = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        serial = court.adjudicate_round1_serial(group, env.commitment_key, triples, by_sender)
        serial_s = time.perf_counter() - t0
        stages: dict = {}
        t0 = time.perf_counter()
        batch = court.adjudicate_round1_batch(group, cs, env.commitment_key, triples, by_sender, stages, device=dev)
        batch_s = time.perf_counter() - t0
        if serial != want or batch != want:
            raise AssertionError(f"verdicts: serial {serial}, batch {batch}, want {want}")
        reps.append({"serial_s": serial_s, "batch_s": batch_s, "batch_stages_s": stages})
    print(json.dumps({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "threads": torch.get_num_threads(), "n": args.n, "k": args.k, "complaints": len(triples),
                      "reps": reps}))


if __name__ == "__main__":
    main()
