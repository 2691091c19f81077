"""Drive the PyTorch/CUDA port of the batched ceremony on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels of dkg_tpu_torch/csrc, one nvcc per source,
   all started together, and prints the build time and what ptxas says
   about registers and spills.  Meanwhile a spawned worker process runs
   the storm's ceremonies (step 12), which compute on the host only.
3. Holds every kernel and variant against its plain PyTorch version on
   the card, bit for bit: at random inputs (2**15 lanes with field edge
   values and edge projective scalings in the first lanes, points on the
   curve; the bucket kernels at windows 4 and 8 over identity points,
   digit-0 lanes, digits shared by the batch or one block per row, and a
   point count past one digit tile (on the Weierstrass bucket_accumulate,
   off every path, held to pt_bucket_sum); mod_mul and mxu_mod_mul over
   both fields of their family), and at the shapes its ceremony path gives
   it, where both are also timed (CUDA events over TIMING_REPS wrapper
   calls, SLOW_REPS for a call of SLOW_MS or more, the operands' broadcast
   copies included; the bucket kernels' plain versions, m or 2 (2**c - 1)
   sequential steps, once, the Weierstrass bucket_accumulate's (off every
   path) on the first 128 of its m points, the kernel held at the full
   shape to its route, as its row's plain_cut says, pt_bucket_close's with
   its random case of the same window in the same pass, as its row's
   plain_folded says;
   some other plain versions on the first rows of the path's shape, as
   each row's plain_rows says).  Each kernel line ends with
   the seconds its checks took.  Every
   curve's window step (the Edwards one a single launch too) is held and
   timed at the Straus RLC's k = 4, the Pippenger combine's k = 8 and the
   KEM's n * n lanes at k = 4; each curve's pt_double, on no path, at its
   Straus window step's shape.  The multi-step kernels of the main path
   (pt_ladder_horner: eval_point_poly's T Horner steps in one launch;
   mod_madd_horner and mod_madd_dot: eval_many and _field_dot in one
   launch each) are held at the path's full shape against their one-step
   route (T, or m, launches of pt_ladder_mul_add or mod_madd), both routes
   timed on the card in the same run, and against their plain versions at
   random lanes and, at the path's shape, on its first rows (the first 2
   coefficients of the point Horner, 8 dealers of the field Horner).  So
   are the chained point kernels (pt_fixed_base: every window of
   fixed_base_mul in one launch; pt_tree_sum: a whole tree reduction in
   one launch, the Straus windows' entries read in place), at the deal's
   and the verifier's lanes and at a Straus window's and the master key's
   tree, against their one-step routes (32 gathered pt_madd with their
   selects; a pt_add launch a tree level with its gather), and against
   their plain versions at random inputs (2**15 lanes or columns) and at
   edges: digit-0 windows and the identity's table at 2**15 and 1000
   lanes, m in {1, 2, 3, 5, 1000} over 4 columns and over one, direct and
   gathered (1000 lanes and one column run in a group where the curve's
   kernel has one), and m past the chunk cap (two launches).  And so are
   the two one-launch kernels of the canonical affine form and the KEM:
   mod_batch_inv (a whole Montgomery-trick batch inversion, at the
   ceremony's commitments laid out as affine_canon lays them and at a
   default seal chunk's 4096 KEM points, against the JAX package's 256-row
   chain of mod_mul launches; edges: 1, p - 1, 2, p - 2, a repeated
   element, a zero column, k = 1) and pt_scalar_mul (every window of
   scalar_mul, at the seal's n * n KEM lanes over the recipients' tables
   read in place, at a default seal chunk's 4096 KEM lanes and at a
   recipient's n opens, against 64 gathered
   pt_window_step launches; edges: k = 0, 1, order - 1, zero digit
   windows, the identity, a table a lane, one shared table, a table a
   recipient).  And the gemm family's whole batch inversion,
   mxu_batch_inv (every multiply the fused multiply-reduce with its fold
   on the tensor cores, a warp's 32 columns in lockstep), at the
   commitments laid out as affine_canon(mul="gemm") lays them, against the
   route it replaces (the 256-row chain of mxu_mod_mul launches) and at
   mod_batch_inv's edges and a column count that is not a multiple of 32;
   and the Pippenger RLC's
   pt_bucket_sum (the scatter from sorted bucket lists, the commitments
   read in place in their (n, t+1) order) and pt_bucket_close (the whole
   suffix sum of a (column, window)), against their routes
   (bucket_accumulate; 2 (2**c - 1) pt_add launches) and at edges (c = 4
   and 8, identity points, all digits zero, one bucket holding every
   point, m = 1, B = 1 and 33, bucket_accumulate's layout).
3b. The fixed-base tables on each path's curve, in a cache directory of
   their own (every process cache emptied at the end, so each path's first
   run acquires its tables as a first process would): g's window-8 table
   built on the card through precompute.base_table (fixed_base_table_dev:
   one pt_ladder_mul_add, scalar_mul_small over (NW, 256) lanes, and one
   affine_canon; exact launches) equal limb for limb to the host table;
   g's and h's window-16 tables composed on the card (one pt_add over
   1,048,576 lanes, one affine_canon, h's half table built there first;
   exact launches) held to the host ladder at every digit-0 and top-digit entry
   and 256 (g) / 64 (h) seeded ones; fixed_base_mul at windows 8 and 16
   over the deal's n (t + 1) lanes equal after affine_canon; pt_fixed_base
   at windows 8 and 16 at the deal's and the verifier's lanes, the
   compose's pt_add (its plain version on 65,536 lanes) and
   scalar_mul_small's pt_ladder_mul_add timed against their plain versions
   and bounds, and a window-16 table's compose and affine_canon timed;
   then the tables' acquisition on a first run (build and persist), from
   the disk file and from the process cache, with stats() and
   run(trace=)'s table_cache meta, on ristretto255 as three whole
   ceremonies whose outputs are equal.
4. Runs each main path on the card, with every kernel's launch count set
   to 0 just before and read just after; every kernel of the path must
   be > 0, and eval_point_poly, eval_many, _field_dot and aggregate_shares
   one launch each (1 pt_ladder_horner, 2 mod_madd_horner, 3 mod_madd_dot; the one-step
   mod_madd 0), each table the run builds on the card one
   pt_ladder_mul_add and one canonical affine form (the Straus run
   builds h's, at least one; the later runs none), each fixed_base_mul one
   pt_fixed_base (4; pt_madd 0), each tree reduction one pt_tree_sum
   (Straus: 32 windows and the master key, 33; Pippenger: 1) and pt_add
   the table build, E and the left side (16; Pippenger 2, with one
   pt_bucket_sum, one pt_bucket_close and no bucket_accumulate),
   pt_window_step one a window of the point RLC (32; Pippenger 128 / c),
   each canonical affine form one mod_batch_inv (2) and its coordinates'
   mod_mul (4, 6 on ristretto255, with gd.eq's 4 more; under mul="gemm"
   one mxu_batch_inv each (2), no mod_batch_inv, and the coordinates'
   mxu_mod_mul, 4 or 6):
   - BatchedCeremony("secp256k1", 1024, 341) (BASELINE.md config 3);
   - BatchedCeremony("ristretto255", 256, 85) (BASELINE.md config 2);
   - BatchedCeremony("bls12_381_g1", 1024, 341) (BASELINE.md config 5,
     its n = 16384 cut to config 3's committee);
   each with the Straus point RLC (named; the JAX package's default) and
   the device transcript digest with mod_mul's multiply (the defaults),
   then again with run(rlc="pippenger") (the default),
   whose scatter and close are pt_bucket_sum and
   pt_bucket_close, and with run(mul="gemm"), whose canonical affine form
   inverts through mxu_batch_inv and multiplies through mxu_mod_mul.  Checks ok, the master key, some commitments and shares
   against host big-int oracles, that the other runs' outputs equal the
   Straus run's, and that no plain field multiply reached a CUDA tensor.
   Once per path, on the Straus run's round-1 tensors, the device digest
   under each multiply (each launching its own kernel family and no
   other) and the host leg give the same three (n, 8) row arrays and the
   run's rho.  On the BLS12-381 path only (the earlier paths skip these
   repeated passes to keep the command's time) it also splits both legs
   of the fiat_shamir phase step by step and runs the Pippenger path (the
   default) twice more under torch.profiler for device time by kernel and
   the busy share (a call's mean).
   On each Straus run also: eval_many by matmul_mod (torch._int_mm) and
   _field_dot's one-row matmul_mod bit-equal to mod_madd_horner's and
   mod_madd_dot's outputs, both routes timed by CUDA events with
   _int_mm's share; and run(chunk=96, rlc_chunk=16), the chunked flow (A
   never whole, bare0 its first column), equal to the one-pass run in the
   transcript digest bytes, rho, ok, final shares and master, launching
   exactly as its chunks say.  After the three paths, the scale phase:
   X1, secp256k1 n = 4096, t = 1365 (BASELINE.md config 4) on card-made
   coefficients in one pass and in the default chunks, identical, then a
   tampered share failing its recipient alone; X2, BLS12-381 G1 n = 16384,
   t = 5461 (config 5 at its own size) in the default chunked flow: ok for
   all, the master key, 4 x 4 shares and hidings, bare0 and 8 commitments
   against host big ints, the tampered share, the deal's two routes on a
   64 x 1024 block, phase seconds, launches and peak device memory.
5. The dealing round's share encryption on each Straus run's shares and
   hidings (hybrid_batch: the KEM c1 = g·r and kem = r·pk on the card,
   the DEM on the host): recipient keys and randomness from the path's
   seeded random.Random; the KEM's pieces timed by CUDA events;
   seal_shares_pipeline at its default chunk, each seal kernel launched
   exactly as its chunks say (counts set to 0 just before, read just
   after), and on ristretto255 also unchunked, the two outputs equal (on
   secp256k1 and BLS12-381 the unchunked seal is left out for the
   command's time); 64 sampled KEM points against the host ladder, the
   batch DEM against the per-pair leg on min(n, 1024 // n) dealers, recipients 1, n and two others opening
   every dealer's share and hiding, a tampered ciphertext not opening to
   its share, and no plain multiply on the card; each chunk of a seal
   (one unchunked) launches exactly 1 pt_fixed_base (c1), 0 pt_madd, 14
   pt_add (the KEM's table build), 1 pt_scalar_mul and 0 pt_window_step
   (the KEM), and the KEM points' encodings: on the Weierstrass curves 1
   mod_batch_inv and 2 mod_mul (their canonical affine form), on
   ristretto255 526 mod_mul (the batched ristretto255 encoding,
   groups/ristretto_device.py) and no mod_batch_inv.
6. Threshold signing (dkg_tpu_torch.sign) on each Straus run's final
   shares, quorum Q1 the parties 1 .. t + 1 (342 signers on secp256k1
   and BLS12-381, 86 on ristretto255), Q2 the last t + 1, each stage with
   every launch count set to 0 just before and read just after and its
   host seconds printed: 256 messages hashed to the curve, Q1's public keys
   (one pt_fixed_base), the partial grid (256 x 342 lanes in one
   pt_scalar_mul, each message's table read in place by its signers), the
   aggregate (λ_i(0) on the card as mod_mul launches, one pt_bucket_sum and
   one pt_bucket_close), the folded signature of SignCache's sigma (one
   pt_scalar_mul); the aggregate equals the folded signature, Q2's
   aggregate (as group elements: limb for limb on the Weierstrass curves,
   by encoding on ristretto255) and, on messages 0, 127 and 255,
   secret·H(m) by the host ladder.  Then a proved grid of 4 messages
   (1368 cells, 344 on ristretto255): proofs (the announcements one
   pt_scalar_mul), verify_partials (one per-row m = 2 gd.msm) all true,
   rlc_verify one pass; one forged response rejected by verify_partials at
   its cell alone and blamed alone by rlc_verify within its pass bound;
   rlc_verify_convoy over the grid and Q2's in one pass.  The exact counts
   the shapes fix are checked, no plain multiply may reach the card, and
   gd.msm's Straus and Pippenger schedules are timed (CUDA events) and
   held equal at verify_partials's and rlc_verify's MSM shapes.
7. On each Straus path's tensors: the point RLC D of verify_batch under
   the three schedules (straus, bits, pippenger), equal in canonical
   affine form and timed; and the verify phase under Straus and under
   Pippenger, profiled for device time by kernel and the busy share (two
   calls in one session, the numbers a call's mean).
8. Runs a tampered (n=16, t=5) ceremony on each curve under each of the
   Straus and Pippenger schedules: one corrupted share must fail its
   recipient's batch check, blame its dealer, and leave the master key of
   the qualified set.
9. The committee wire protocol (dkg.committee, committee_batch,
   complaints_batch), each stage with every launch count set to 0 just
   before and read just after, its host seconds printed beside the card's
   name and power limit, and the path's kernels each launched:
   - W1, ristretto255 n = 256, t = 85 (BASELINE.md config 2):
     batched_dealing for every member (65,536 pairs sealed); one dealer's
     share ciphertexts to three recipients get a flipped byte, one dealer
     seals shares off its commitments to two, one goes silent; then
     batched_share_verification for all 256 parties (one scalar_mul of
     65,025 KEM recoveries, a table a lane; one re-check over 65,025 x 86
     per-lane coefficients).  Exactly the tampered pairs complain, each
     with the kind the serial DkgPhase1.proceed gives on a deep copy of
     the party's phase, and the batch court upholds them; the silent
     dealer is out everywhere; every other pair holds the dealt share.
     The KEM recovery's scalar_mul and the re-check's pt_ladder_horner
     are timed alone (device ms) on the path's own inputs and held exact
     against their plain versions on 4 of those lanes (plain_rows; the
     plain versions on the host, where their small ops run faster); the
     exact launch counts of both rounds are held;
   - W2, the court under a storm at n = 1024, t = 341
     (scripts/storm_bench.py's shape, built by
     dkg_tpu_torch/dkg/storm_bench.py as that script builds it): 341
     genuine complaints and one false one, adjudicate_round1_batch's
     verdicts [True] * 341 + [False], the serial court agreeing on 17 of
     them; complaints per second and the court's three stages;
   - W3, phases 1-5 at n = 8, t = 3 on each curve: a round-2 cheat
     disqualified, a round-3 liar's secret reconstructed, every honest
     master key equal and reproduced by the secret interpolated from
     t + 1 final shares.
10. Epochs (dkg_tpu_torch.epoch), each stage with every launch count set
   to 0 just before and read just after, its exact counts held:
   - E1, the in-process lane on each Straus run's own final shares:
     refresh_shares (one mod_madd_horner), reshare_shares to n' = n/2,
     t' = (n' - 1) // 3 (one mod_madd_horner, λ_i(0)'s mod_mul and one
     more); the secret interpolated on the host from random (t+1)- and
     (t'+1)-subsets is the ceremony's, g times it the master; t' + 1
     reshared shares sign 16 messages, each aggregate secret·H(m);
   - E2, the dealing legs at W1's committee (ristretto255 n = 256, t =
     85) on the ristretto255 path's epoch 0: 256 refresh deals
     (deal_epoch_poly, 65,536 sealed pairs, each deal encoded and decoded),
     one resealed share flagged by check_bare_shares alone; members 1, 86,
     171 and 256 open and check all 256 rows, their new shares lie on the
     new aggregate, which keeps the master; 86 reshare deals, one forged
     constant flagged by check_reshare_constants alone,
     combine_reshare_commitments over 86 x 86 points keeps the master and
     holds member 1's reshared share;
   - E3, the EpochManager at n = 8, t = 3 on each curve: genesis from the
     committee phases 1-5, every party a thread over one InProcessChannel
     with a PartyWal, a refresh and a reshare with one leaver and one
     joiner; every master the ceremony's, the leaver without state, the
     rest at epoch 2 agreeing on the commitments; one party rebuilt from
     its WAL replays both operations to the same states;
   - encode_batch's card leg (default on a card tensor) at 65,536
     ristretto255 points against its host leg on the first 8,192 (a
     Python inverse square root a point): byte-equal, the identities all
     zero, the card the faster a point (both timed); ristretto_decode_batch on
     the card against the host's validity and points; W1's seal and DEM
     seconds beside them.
11. The ceremony service (dkg_tpu_torch.service) on one WarmRuntime,
   secp256k1, rho_bits 64, every stage's host seconds and launches printed:
   - S1, scripts/fleet_bench.py's 1000-ceremony mix (its MIX, seed 1)
     through CeremonyScheduler(concurrency=4, batch_max=8) after warmup of
     each bucket's widths: every outcome done and all qualified, every
     master g·Σ_j a_j0 and every real final share Σ_j f_j(i) by host big
     ints, one ceremony per (bucket, width) equal to the unpadded
     BatchedCeremony's master, and each convoy launching pt_fixed_base 4,
     mod_madd_horner 2, mod_madd_dot 3, pt_bucket_sum, pt_bucket_close,
     pt_ladder_horner and pt_tree_sum 1 whatever its width (counts set to
     0 just before, read just after); ceremonies/s, p50 and p99 of submit
     to completed_at, convoys by width, peak device memory;
   - S4, on S1's scheduler: 256 unproved messages from 4 submitter
     threads over two S1 ceremonies through sign_submit / sign_wait, every
     signature secret·H(m) on the host; refresh, then reshare to (12, 3),
     each signing again with the master and signatures unchanged;
   - S2, warm run_convoy at widths 1, 2, 4, 8 of the buckets (16, 5),
     (32, 8), (64, 16): ceremonies/s and launches a convoy, mod_madd_dot 3
     and pt_bucket_sum 1 at every width, every lane its width-1 run;
   - S3, scripts/service_storm.py's legs at its defaults: 200 requests,
     a fault-free pass, then 10 poisoned, 2 transient, 2 slow and a worker
     crash (survival and blame accuracy 1.0, every healthy master the
     fault-free pass's, every poisoned outcome typed); a forged DLEQ
     response blamed to its cell, the forger alone quarantined, the
     substitute quorum's signature bytes the honest one's; a corrupted WAL
     tail re-served, a crash-looping record poisoned (REPLAY_LIMIT).
   The kernels line holds mod_madd_dot (three scalar fields) and
   pt_bucket_sum (three curves) with a convoy axis too: CONVOY_K = 8
   ceremonies at each path's n and, on secp256k1, S1's (16, 5) bucket at
   width 8, each in one launch against CONVOY_K launches of the
   shared-block kernel and its plain version (on the first ceremony, or
   the first 4 columns of each), and at edges (k = 1, k = 3, an all-zero
   block, B/k = 1 and 33, m = 37).
12. scripts/chaos_storm.py's storm, ristretto255 n = 6, t = 2, base seed
   0xC7A05, each ceremony over its own TcpHub on 127.0.0.1 (no in-process
   fallback): 8 ceremonies under random_plan with one restart each (a
   party crashed mid-round and re-spawned from its WAL), per-round timeout
   1.0 s, run in the worker process started at step 2 (the wire protocol
   computes on the host); then the epoch storm (--churn 1: a refresh and a
   1-leave/1-join reshare under random_epoch_plan with one restart,
   timeout 10.0 s) on the first 2 seeds, the EpochManagers on the card.
   Every honest party ok on one master key, every restarted party
   resumed to it, the epoch masters unchanged across the refresh and the
   reshare, the leavers left, the joiners' shares verify against the new
   commitments on the host; the epoch storms' launches printed (each of
   mod_madd_horner, pt_fixed_base, pt_ladder_horner and pt_scalar_mul > 0).
13. Prints one JSON line of per-kernel numbers (launches: the count the
   first main path that launched the kernel read, Straus before the seal
   before signing before Pippenger before gemm before the committee,
   epoch, service and storm phases (pt_ladder_mul_add's: the table the
   first Straus run builds on the card), or the 0 every path read
   (a signing, committee, epoch or storm phase's count is its
   stages' sum; a convoy row's, its kernel's launches by the convoy route
   in S1's (16, 5) convoys or in its others); device_ms: a wrapper
   call's device time, its kernels timed back to back; plain_rows:
   the leading rows of the path's shape on which plain_ms was timed, null
   for all of them; for the multi-step kernels also the one-step route's
   device ms (for pt_bucket_sum bucket_accumulate's, for pt_bucket_close
   the pt_add launches', for mxu_batch_inv the mxu_mod_mul chain's) and
   ptxas's registers and spill bytes, per group size for the chained ones),
   the card line again, and last {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero without the last line;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import dataclasses
import functools
import json
import multiprocessing
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from dkg_tpu_torch import sign as ts
from dkg_tpu_torch.crypto import device_hash as dh
from dkg_tpu_torch.crypto import dleq_batch
from dkg_tpu_torch.crypto.blake2s import row_digests_np
from dkg_tpu_torch.crypto.elgamal import seal_pair
from dkg_tpu_torch.dkg import broadcast as bc
from dkg_tpu_torch.dkg import ceremony as cer
from dkg_tpu_torch.dkg import committee as cm
from dkg_tpu_torch.dkg import committee_batch as cmb
from dkg_tpu_torch.dkg import complaints_batch as court
from dkg_tpu_torch.dkg import hybrid_batch as hb
from dkg_tpu_torch.dkg.storm_bench import build_storm, committee_keys, flip_byte
from dkg_tpu_torch.dkg.errors import DkgErrorKind
from dkg_tpu_torch.epoch import KIND_REFRESH, KIND_RESHARE, EpochManager, EpochState, genesis_from_party_result
from dkg_tpu_torch.epoch import dealing, inprocess
from dkg_tpu_torch.epoch import messages as em
from dkg_tpu_torch.epoch import state as est
from dkg_tpu_torch.fields import device as fd
from dkg_tpu_torch.fields import host as fh
from dkg_tpu_torch.fields import matmul as fmm
from dkg_tpu_torch.fields.spec import int_to_limbs
from dkg_tpu_torch.groups import device as gd
from dkg_tpu_torch.groups import host as gh
from dkg_tpu_torch.groups import precompute as gp
from dkg_tpu_torch.groups import ristretto_device as rd
from dkg_tpu_torch.net import InProcessChannel, PartyResult, TcpHub, TcpHubChannel, wal_path
from dkg_tpu_torch.net import faults as nf
from dkg_tpu_torch.ops import bucket_kernels as bk
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import mxu_kernels as mk
from dkg_tpu_torch.ops import point_kernels as pk
from dkg_tpu_torch.poly import device as pd
from dkg_tpu_torch.poly.host import lagrange_interpolation
from dkg_tpu_torch import service as svc
from dkg_tpu_torch.service import engine as se
from dkg_tpu_torch.service.durable import ServiceJournal
from dkg_tpu_torch.sign import partial as tsp
from dkg_tpu_torch.sign import verify as sv
from dkg_tpu_torch.utils.metrics import REGISTRY
from dkg_tpu_torch.utils.tracing import CeremonyTrace

DEV = "cuda"  # every tensor of the script lives here


@dataclasses.dataclass(frozen=True)
class Path:
    """One main path: a ceremony the port runs end to end on the card."""

    curve: str
    n: int
    t: int
    shared: bytes
    kernels: tuple  # the build.Kernel objects the path must launch
    rlc: str = "straus"  # the point RLC's schedule
    mul: str = "classic"  # the canonical affine form's multiply

    @property
    def cs(self) -> gd.CurveSpec:
        return gd.ALL_CURVES[self.curve]

    @property
    def index_bits(self) -> int:
        return self.n.bit_length()

    @property
    def tag(self) -> str:
        return f"{self.curve} n={self.n} t={self.t} rlc={self.rlc} mul={self.mul}"

    def pippenger(self) -> Path:
        """The same ceremony with the Pippenger point RLC, which adds the
        curve's pt_bucket_sum and pt_bucket_close to the path."""
        return dataclasses.replace(self, rlc="pippenger",
                                   kernels=self.kernels + (bk.sum_kernel_for(self.cs), bk.close_kernel_for(self.cs)))

    def exact_launches(self) -> dict:
        """Launch counts a run of the ceremony must read exactly: the point
        Horner, the two scalar RLCs and the final shares' sum one launch
        each, the deal's two Horners one each, and none of their one-step
        kernels; the four
        fixed_base_mul one pt_fixed_base each, and no pt_madd; one
        pt_tree_sum a Straus window (RHO_BITS / 4 of them) and one for the
        master key; pt_add the 14 table adds, E = A + B and the left side,
        or under Pippenger E and the left side alone, with one pt_bucket_sum
        (no bucket_accumulate) and one pt_bucket_close; pt_window_step one a
        window of the point RLC; the digest's two canonical affine forms
        (:func:`canon_launches`) and gd.eq's four mod_mul."""
        cs = self.cs
        canon = canon_launches(cs, self.mul, 2)  # the digest's A and E
        mul = fk.mul_kernel_for(cs.field).name
        canon[mul] = canon.get(mul, 0) + 4  # and verify_batch's gd.eq, four products
        buckets = {bk.kernel_for(cs).name: 0, bk.sum_kernel_for(cs).name: 0, bk.close_kernel_for(cs).name: 0}
        if self.rlc == "straus":
            trees, adds, steps = -(-RHO_BITS // gd.WINDOW) + 1, 14 + 2, -(-RHO_BITS // gd.WINDOW)
        else:
            c = gd.pippenger_window(self.n, cs.name)
            trees, adds, steps = 1, 2, -(-RHO_BITS // c)
            buckets.update({bk.sum_kernel_for(cs).name: 1, bk.close_kernel_for(cs).name: 1})
        return {**buckets, pk.kernel_for("pt_ladder_horner", cs).name: 1, fk.horner_kernel_for(cs.scalar).name: 2,
                fk.dot_kernel_for(cs.scalar).name: 3, pk.kernel_for("pt_ladder_mul_add", cs).name: 0,
                fk._FIELDS[cs.scalar][0].name: 0, pk.kernel_for("pt_fixed_base", cs).name: 4,
                pk.kernel_for("pt_madd", cs).name: 0, pk.kernel_for("pt_tree_sum", cs).name: trees,
                pk.kernel_for("pt_add", cs).name: adds, pk.kernel_for("pt_window_step", cs).name: steps, **canon}

    def verify_kernels(self) -> tuple:
        """The path's kernels that its verify phase launches: all but the
        deal's field Horner and the digest's batch inversion, and under
        Pippenger the tree sum (the master key's, in the finalise phase)."""
        skip = {fk.horner_kernel_for(self.cs.scalar), fk.batch_inv_kernel_for(self.cs.field),
                mk.batch_inv_kernel_for(self.cs.field)}
        if self.rlc == "pippenger":
            skip.add(pk.kernel_for("pt_tree_sum", self.cs))
        return tuple(k for k in self.kernels if k not in skip)

    def gemm(self) -> Path:
        """The same ceremony with the canonical affine form's multiplies
        through the fused multiply-reduce, which adds the base field's
        mxu_batch_inv and mxu_mod_mul and drops mod_batch_inv (point
        equality keeps mod_mul's)."""
        F = self.cs.field
        inv = fk.batch_inv_kernel_for(F)
        return dataclasses.replace(self, mul="gemm", kernels=tuple(k for k in self.kernels if k is not inv)
                                   + (mk.batch_inv_kernel_for(F), mk.kernel_for(F)))


def canon_launches(cs, mul: str, calls: int) -> dict:
    """Launches of ``calls`` affine_canon calls: one batch inversion each
    (mod_batch_inv under "classic", mxu_batch_inv under "gemm", none of
    the other) and the affine coordinates' multiplies (x·zi, y·zi, and on
    Edwards t = x·y: mod_mul, or mxu_mod_mul)."""
    F = cs.field
    coords = 3 if cs.kind == "edwards" else 2
    classic = {fk.batch_inv_kernel_for(F).name: calls, fk.mul_kernel_for(F).name: coords * calls,
               mk.batch_inv_kernel_for(F).name: 0}
    if mul == "classic":
        return classic
    return {fk.batch_inv_kernel_for(F).name: 0, mk.batch_inv_kernel_for(F).name: calls,
            mk.kernel_for(F).name: coords * calls}


def ristretto_encode_launches() -> int:
    """mod_mul launches of one ristretto_encode_batch: the inverse square
    root's power (p - 5)/8, a squaring a bit below the top and a multiply
    a set bit below it, and the 25 other products of the encoding."""
    e = (gh.P - 5) // 8
    return (e.bit_length() - 1) + (bin(e).count("1") - 1) + 25


def encode_launches(cs, calls: int) -> dict:
    """Launches of ``calls`` encode_batch calls on the card: on Edwards the
    batched ristretto255 encoding (ristretto_encode_launches() mod_mul
    each, no batch inversion); on Weierstrass one canonical affine form
    each (:func:`canon_launches`)."""
    if cs.kind != "edwards":
        return canon_launches(cs, "classic", calls)
    F = cs.field
    return {fk.batch_inv_kernel_for(F).name: 0, fk.mul_kernel_for(F).name: ristretto_encode_launches() * calls,
            mk.batch_inv_kernel_for(F).name: 0}


SECP = Path("secp256k1", 1024, 341, b"chip-smoke",  # BASELINE.md config 3
            (fk.MOD_MADD_HORNER, fk.MOD_MADD_DOT, fk.MOD_MUL, fk.MOD_BATCH_INV, pk.PT_ADD, pk.PT_FIXED_BASE,
             pk.PT_TREE_SUM, pk.PT_WINDOW_STEP, pk.PT_LADDER_HORNER))
R255 = Path("ristretto255", 256, 85, b"chip-smoke-r255",  # BASELINE.md config 2
            (fk.MOD_MADD_HORNER_ED, fk.MOD_MADD_DOT_ED, fk.MOD_MUL_ED, fk.MOD_BATCH_INV_ED, pk.ED_PT_ADD,
             pk.ED_PT_FIXED_BASE, pk.ED_PT_TREE_SUM, pk.ED_PT_WINDOW_STEP, pk.ED_PT_LADDER_HORNER))
BLS = Path("bls12_381_g1", 1024, 341, b"chip-smoke-bls",  # BASELINE.md config 5 at config 3's n, t
           (fk.MOD_MADD_HORNER_BLS, fk.MOD_MADD_DOT_BLS, fk.MOD_MUL_BLS, fk.MOD_BATCH_INV_BLS, pk.BLS_PT_ADD,
            pk.BLS_PT_FIXED_BASE, pk.BLS_PT_TREE_SUM, pk.BLS_PT_WINDOW_STEP, pk.BLS_PT_LADDER_HORNER))
PATHS = (SECP, R255, BLS)
# paths that also split the fiat_shamir phase's two legs and run once more
# under the profiler; the earlier paths skip those repeated passes (never
# a check) to keep the command's time
REPEATED_PASSES = (BLS,)
TAMPER_N, TAMPER_T = 16, 5
RANDOM_LANES = 1 << 15  # not below any group threshold (2**15): one thread a lane
CONVOY_K = 8  # the convoy kernel rows' width at the paths' n: the service's largest convoy
# wrapper calls timed a kernel row (CUDA events, and again behind a spin);
# a call of SLOW_MS or more, SLOW_REPS
TIMING_REPS, SLOW_MS, SLOW_REPS = 10, 20.0, 3
RHO_BITS = 128  # BatchedCeremony.run's default

# Peak rates of an H100 SXM at its 700 W limit (NVIDIA data sheet and
# Hopper whitepaper): HBM3 bytes, and 32-bit integer multiplies (132 SMs
# x 64 INT32 lanes x 1.98 GHz boost).
BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core operations (a product-add is two)

# 32x32->64-bit multiply-adds per lane of the kernels in csrc/ (field.cuh,
# point.cuh, edwards.cuh), each counted as two 32-bit multiplies (the low
# and the high half of the product).  Field multiplies: secp256k1 p 86
# (64 schoolbook + 22 fold), a multiply by 3b = 21 12, secp256k1 n 134,
# ed25519 p 73 (64 + 9 fold), ristretto255 l and BLS12-381 r 189
# (64 + 81 + 44 Barrett), BLS12-381 p 403 (144 + 169 + 90 Barrett); its
# multiply by 3b = 12 is four adds, no multiply.
_FMUL, _FSMALL, _ED_FMUL, _BLS_FMUL = 86, 12, 73, 403
WS_ADD, WS_MADD, WS_DOUBLE = 12 * _FMUL + 2 * _FSMALL, 11 * _FMUL + 2 * _FSMALL, 8 * _FMUL + _FSMALL
ED_ADD, ED_MADD, ED_DOUBLE = 9 * _ED_FMUL, 8 * _ED_FMUL, 8 * _ED_FMUL
BLS_ADD, BLS_MADD, BLS_DOUBLE = 12 * _BLS_FMUL, 11 * _BLS_FMUL, 8 * _BLS_FMUL
POINT_COSTS = {  # curve -> multiply-adds of (add, madd, double)
    "secp256k1": (WS_ADD, WS_MADD, WS_DOUBLE),
    "ristretto255": (ED_ADD, ED_MADD, ED_DOUBLE),
    "bls12_381_g1": (BLS_ADD, BLS_MADD, BLS_DOUBLE),
}
MADD_FIELD = {"secp256k1_scalar": 134, "secp256k1_base": 86, "ed25519_scalar": 189, "ed25519_base": 73,
              "bls12_381_scalar": 189, "bls12_381_base": 403}  # mod_madd's and mod_mul's multiply-adds


def mxu_ops(fs) -> tuple[int, int]:
    """The fused multiply-reduce of csrc/mxu.cuh per lane: 32-bit multiplies
    (L**2 16x16-bit column products, n_split x L fold and L + 1 quotient
    products) and the fold's (3L + 1) x 2L byte products."""
    L, mr = fs.limbs, fs.mulred
    return L * L + mr.n_split * L + L + 1, (3 * L + 1) * 2 * L

PDIR = "dkg_tpu/ops/pallas_point.py"
SOURCES = {
    "mod_madd": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "mod_madd[ed25519]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "pt_add": ("point_kernels.cu", PDIR + ":258"),
    "pt_madd": ("point_kernels.cu", PDIR + ":281"),
    "pt_window_step": ("point_kernels.cu", PDIR + ":328"),
    "pt_ladder_mul_add": ("point_kernels.cu", PDIR + ":356"),
    "pt_add[edwards]": ("edwards_kernels.cu", PDIR + ":258"),
    "pt_madd[edwards]": ("edwards_kernels.cu", PDIR + ":281"),
    "pt_window_step[edwards]": ("edwards_kernels.cu", PDIR + ":328"),
    "pt_ladder_mul_add[edwards]": ("edwards_kernels.cu", PDIR + ":356"),
    "pt_double": ("double_kernels.cu", PDIR + ":304"),
    "pt_double[edwards]": ("double_kernels.cu", PDIR + ":304"),
    "bucket_accumulate": ("bucket_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249"),
    "bucket_accumulate[edwards]": ("bucket_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249"),
    "mod_madd[bls12_381]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "pt_add[bls12_381]": ("bls_kernels.cu", PDIR + ":258"),
    "pt_madd[bls12_381]": ("bls_kernels.cu", PDIR + ":281"),
    "pt_double[bls12_381]": ("bls_kernels.cu", PDIR + ":304"),
    "pt_window_step[bls12_381]": ("bls_kernels.cu", PDIR + ":328"),
    "pt_ladder_mul_add[bls12_381]": ("bls_kernels.cu", PDIR + ":356"),
    "bucket_accumulate[bls12_381]": ("bls_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249"),
    "mod_mul": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:266"),
    "mod_mul[ed25519]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:266"),
    "mod_mul[bls12_381]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:266"),
    "mxu_mod_mul": ("mxu_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:184"),
    "mxu_mod_mul[ed25519]": ("mxu_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:184"),
    "mxu_mod_mul[bls12_381]": ("mxu_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:184"),
    # the multi-step kernels: the TPU kernel's step composed T (or m) times in one launch
    "pt_ladder_horner": ("ladder_kernels.cu", PDIR + ":356"),
    "pt_ladder_horner[edwards]": ("ladder_kernels.cu", PDIR + ":356"),
    "pt_ladder_horner[bls12_381]": ("ladder_kernels.cu", PDIR + ":356"),
    "mod_madd_horner": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "mod_madd_horner[ed25519]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "mod_madd_horner[bls12_381]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "mod_madd_dot": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "mod_madd_dot[ed25519]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "mod_madd_dot[bls12_381]": ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    # the chained point kernels: the TPU kernel's step composed over a whole call
    "pt_fixed_base": ("chain_kernels.cu", PDIR + ":281"),
    "pt_fixed_base[edwards]": ("chain_kernels.cu", PDIR + ":281"),
    "pt_fixed_base[bls12_381]": ("chain_kernels.cu", PDIR + ":281"),
    "pt_tree_sum": ("chain_kernels.cu", PDIR + ":258"),
    "pt_tree_sum[edwards]": ("chain_kernels.cu", PDIR + ":258"),
    "pt_tree_sum[bls12_381]": ("chain_kernels.cu", PDIR + ":258"),
    "pt_scalar_mul": ("chain_kernels.cu", PDIR + ":328"),
    "pt_scalar_mul[edwards]": ("chain_kernels.cu", PDIR + ":328"),
    "pt_scalar_mul[bls12_381]": ("chain_kernels.cu", PDIR + ":328"),
    "mod_batch_inv": ("inv_kernels.cu", "dkg_tpu/ops/pallas_field.py:266"),
    "mod_batch_inv[ed25519]": ("inv_kernels.cu", "dkg_tpu/ops/pallas_field.py:266"),
    "mod_batch_inv[bls12_381]": ("inv_kernels.cu", "dkg_tpu/ops/pallas_field.py:266"),
    "mxu_batch_inv": ("mxu_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:184"),
    "mxu_batch_inv[ed25519]": ("mxu_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:184"),
    "mxu_batch_inv[bls12_381]": ("mxu_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:184"),
    "pt_bucket_sum": ("pippenger_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249"),
    "pt_bucket_sum[edwards]": ("pippenger_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249"),
    "pt_bucket_sum[bls12_381]": ("pippenger_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249"),
    # the convoy-axis cases of the service's stacked verify: one launch a convoy
    **{f"{op}{suffix}": src for op, src in (
        ("mod_madd_dot", ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301")),
        ("mod_madd_dot[ed25519]", ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301")),
        ("mod_madd_dot[bls12_381]", ("field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301")),
        ("pt_bucket_sum", ("pippenger_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249")),
        ("pt_bucket_sum[edwards]", ("pippenger_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249")),
        ("pt_bucket_sum[bls12_381]", ("pippenger_kernels.cu", "dkg_tpu/ops/pallas_mxu.py:249")))
       for suffix in (" convoy",) + ((" convoy (16,5)",) if op in ("mod_madd_dot", "pt_bucket_sum") else ())},
    "pt_bucket_close": ("pippenger_kernels.cu", PDIR + ":258"),
    "pt_bucket_close[edwards]": ("pippenger_kernels.cu", PDIR + ":258"),
    "pt_bucket_close[bls12_381]": ("pippenger_kernels.cu", PDIR + ":258"),
}
# ptxas's entries of each multi-step kernel, by label: every string must
# be in the mangled name, and none that starts with "!" (the field
# kernels' template argument is the field id of csrc/field.cuh, mangled
# ILi<id>E; the chained kernels' last one the threads a lane, Li<tpi>EEEv:
# Li1EEEv at one thread a lane, another where the kernel has a group
# variant)
PTXAS_ENTRIES = {
    "pt_ladder_horner": {"": ("pt_ladder_horner_kernel", "Secp256k1")},
    "pt_ladder_horner[edwards]": {"": ("pt_ladder_horner_kernel", "Edwards25519")},
    "pt_ladder_horner[bls12_381]": {"": ("pt_ladder_horner_kernel", "Bls12381")},
    "mod_madd_horner": {"": ("mod_madd_horner_kernel", "ILi1E")},
    "mod_madd_horner[ed25519]": {"": ("mod_madd_horner_kernel", "ILi3E")},
    "mod_madd_horner[bls12_381]": {"": ("mod_madd_horner_kernel", "ILi5E")},
    "mod_madd_dot": {"": ("mod_madd_dot_kernel", "ILi1E")},
    "mod_madd_dot[ed25519]": {"": ("mod_madd_dot_kernel", "ILi3E")},
    "mod_madd_dot[bls12_381]": {"": ("mod_madd_dot_kernel", "ILi5E")},
    "mod_batch_inv": {"": ("mod_batch_inv_kernel", "ILi0E")},
    "mod_batch_inv[ed25519]": {"": ("mod_batch_inv_kernel", "ILi2E")},
    "mod_batch_inv[bls12_381]": {"": ("mod_batch_inv_kernel", "ILi4E")},
    "mxu_batch_inv": {"": ("mxu_batch_inv_kernel", "ILi16E")},
    "mxu_batch_inv[ed25519]": {"": ("mxu_batch_inv_kernel", "ILi16E")},
    "mxu_batch_inv[bls12_381]": {"": ("mxu_batch_inv_kernel", "ILi24E")},
    **{f"{op}{suffix}": {"one thread": (f"{op}_kernel", tag, "Li1EEEv"),
                         **({"group": (f"{op}_kernel", tag, "!Li1EEEv")} if group else {})}
       for op, suffix, tag, group in (
           ("pt_fixed_base", "", "Secp256k1", True), ("pt_fixed_base", "[edwards]", "Edwards25519", False),
           ("pt_fixed_base", "[bls12_381]", "Bls12381", True), ("pt_tree_sum", "", "Secp256k1", False),
           ("pt_tree_sum", "[edwards]", "Edwards25519", False), ("pt_tree_sum", "[bls12_381]", "Bls12381", True),
           ("pt_scalar_mul", "", "Secp256k1", True), ("pt_scalar_mul", "[edwards]", "Edwards25519", True),
           ("pt_scalar_mul", "[bls12_381]", "Bls12381", True))},
    # pt_bucket_close is built at one setting a curve: groups of 4 threads on
    # secp256k1 and BLS12-381, one thread on ristretto255
    "pt_bucket_close": {"group": ("pt_bucket_close_kernel", "Secp256k1")},
    "pt_bucket_close[edwards]": {"one thread": ("pt_bucket_close_kernel", "Edwards25519")},
    "pt_bucket_close[bls12_381]": {"group": ("pt_bucket_close_kernel", "Bls12381")},
    # pt_bucket_sum's template argument is its one-thread kind (LaneWs<curve>, LaneEd)
    **{f"pt_bucket_sum{suffix}": {"one thread": ("pt_bucket_sum_kernel", tag)}
       for suffix, tag in (("", "Secp256k1"), ("[edwards]", "LaneEd"), ("[bls12_381]", "Bls12381"))},
}
KERNELS = (*fk.KERNELS, *pk.KERNELS, *bk.KERNELS, *mk.KERNELS)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def ptxas_entries(log: str) -> dict:
    """ptxas -v's lines per kernel entry: mangled name -> (registers, spill
    store bytes)."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif entry and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif entry and "Used" in line and "registers" in line:
            out[entry] = (int(line.split("Used")[1].split("registers")[0]), spill)
            entry = None
    return out


def ptxas_of(name: str) -> dict | None:
    """Registers and spill stores of a multi-step kernel's entry (of each,
    by label, where it has several)."""
    labels = PTXAS_ENTRIES.get(name)
    if labels is None:
        return None
    entries = ptxas_entries(build.BUILD_LOGS.get(SOURCES[name][0], ""))
    out = {}
    for label, keys in labels.items():
        found = [v for e, v in entries.items()
                 if all((k[1:] not in e) if k.startswith("!") else (k in e) for k in keys)]
        check(len(found) == 1, f"ptxas: {len(found)} entries of {name} {label} in the build log")
        out[label] = {"registers": found[0][0], "spill_store_bytes": found[0][1]}
    return out[""] if list(out) == [""] else out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warm_up: bool = True) -> tuple[float, object]:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call unless ``warm_up`` is false; and the last
    call's result."""
    if warm_up:
        fn()
        sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        res = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, res


# ---------------------------------------------------------------------------
# inputs from a numpy seed
# ---------------------------------------------------------------------------


def edge_ints(fs) -> list:
    """0, 1, m - 1, and values within 2**32 of 2**255 and of 2**256 - 1,
    reduced mod m; for a field wider than 16 limbs (BLS12-381 p), also
    m - 2 and values near 2**(16L - 1) and 2**(16L) - 1."""
    m = fs.modulus
    near = [(1 << 255) + d for d in (-(1 << 32), -1, 0, 1, 1 << 32)]
    near += [(1 << 256) - 1 - d for d in (0, 1, 1 << 32)]
    top = 16 * fs.limbs
    if top > 256:
        near += [m - 2, (1 << (top - 1)) - 1, 1 << (top - 1), (1 << top) - 1, (1 << top) - (1 << 32)]
    return [0, 1, m - 1] + [v % m for v in near]


def rand_field(rng, fs, batch: tuple, operand: int | None = 0) -> torch.Tensor:
    """Canonical random elements (..., L).  With ``operand`` set, the first
    lanes hold edge values: operands 0 and 1 run through every pair of
    edges, later operands cycle through them."""
    limbs = rng.integers(0, 1 << 16, size=batch + (fs.limbs,), dtype=np.int64)
    limbs[..., -1] %= fs.modulus >> (16 * (fs.limbs - 1))  # top limb below m's: value < m
    if operand is not None:
        edges = fh.encode(fs, edge_ints(fs))
        e = len(edges)
        flat = limbs.reshape(-1, fs.limbs)
        for i in range(min(e * e, len(flat))):
            j = (i // e, i % e)[operand] if operand < 2 else (i * (operand + 2)) % e
            flat[i] = edges[j]
    return torch.from_numpy(limbs.astype(np.int32)).to(DEV)


def nonzero_field(rng, fs, batch: tuple) -> torch.Tensor:
    """Random non-zero canonical elements (..., L)."""
    x = rand_field(rng, fs, batch, operand=None)
    x[..., 0] |= 1
    return x


def point_pool(rng, cs, k: int = 64) -> torch.Tensor:
    """k affine multiples of the generator (Z = 1), from host big-int
    scalar mults."""
    group = gh.ALL_GROUPS[cs.name]
    g = gp.base_key_to_point(cs, cs.gen_affine)
    pts = [gp.base_key_to_point(cs, gp.base_key(cs, group.scalar_mul(int(rng.integers(1, 1 << 62)), g)))
           for _ in range(k)]
    return gd.from_host(cs, pts, device=DEV)


def rand_points(rng, cs, pool, batch: tuple, affine: bool = False) -> torch.Tensor:
    """On-curve points drawn from ``pool``, every 7th lane the identity.
    Projective ones are rescaled by a random non-zero lambda, the first
    lanes by the base field's non-zero edge values; affine ones stay
    affine (Weierstrass: no identity lanes, the mixed add does not take
    them; Edwards: the identity (0, 1, 1, 0))."""
    pts = pool[torch.from_numpy(rng.integers(0, len(pool), size=batch)).to(DEV)]
    flat = pts.view(-1, cs.ncoords, cs.field.limbs)
    ident = gd.identity(cs, device=DEV)
    if affine:
        if cs.kind == "edwards":
            flat[3::7] = ident
        return pts
    lam = rand_field(rng, cs.field, batch, operand=None)
    lam[..., 0] |= 1  # non-zero, and still < p (the top limb is below p's)
    lam_flat = lam.view(-1, cs.field.limbs)
    edges = fh.to_tensor(fh.encode(cs.field, [v for v in edge_ints(cs.field) if v]), DEV)
    k = min(len(edges), len(lam_flat))
    lam_flat[:k] = edges[:k]
    flat[3::7] = ident
    return torch.stack([fd.mul(cs.field, pts[..., c, :], lam) for c in range(cs.ncoords)], dim=-2)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    """One kernel or variant: its wrapper and plain version, argument lists
    at random lanes, the arguments at its path's shapes, and the
    multiply-adds those need."""

    path: Path
    wrapper: object
    plain: object
    rand_args: list  # of (label, wrapper, plain, args)
    main_args: list
    muladds: int  # 32x32->64-bit multiply-adds, two 32-bit multiplies each
    int32_muls: int = 0  # single 32-bit multiplies besides
    int8_products: int = 0  # byte product-adds (the fused multiply-reduce's fold)
    plain_reps: int = 2  # timed calls of the plain version at main_args (1: no warm-up either)
    plain_rows: int | None = None  # hold and time the plain version on main_args' first rows only
    # (what, fn): hold and time the plain version on fn(*main_args), a shorter sequential chain
    # (the wrapper rerun on the same arguments); the kernel at main_args is held to its route
    plain_cut: tuple | None = None
    rows_rerun: bool = False  # the output's rows are not the input's: rerun the wrapper on the rows
    # (cases, join, split): random cases (label, wrapper, args) whose inputs
    # join main_args' in one pass of the plain version, so that its
    # sequential steps run once: plain(*join(plain_args, [args, ...])), then
    # split(result, plain_args, [args, ...]) -> (the path shape's part,
    # [each case's part]); plain_ms is that pass's
    folded: tuple | None = None
    # another row's name: this row's main_args (cut to plain_rows) join that
    # row's plain pass as one of its folded cases, labelled with this row's
    # name; this row reports that pass's plain_ms and runs no plain of its own
    plain_in: str | None = None
    route: object = None  # the one-step route at main_args (T or m launches), held and timed beside
    nbytes: int | None = None  # bytes the call must move, where not every byte of main_args


def ladder_muladds(xs, double: int, add: int) -> int:
    """x of the ladder is public, so x·P + A needs only bit_length(x) - 1
    doublings and popcount(x) adds (popcount(x) - 1 inside x·P, one for
    A); the kernel itself runs a fixed index_bits double-and-adds a lane."""
    return sum(max(x.bit_length() - 1, 0) * double + bin(x).count("1") * add for x in xs)


def one_step_ladder(cs, nbits: int):
    """eval_point_poly's one-step route: T pt_ladder_mul_add launches."""
    def route(coeffs, x):
        acc = gd.identity(cs, x.shape, device=x.device)
        for l in reversed(range(coeffs.shape[-3])):
            acc = pk.pt_ladder_mul_add(cs, acc, coeffs[..., l, :, :], x, nbits)
        return acc
    return route


def one_step_horner(fs):
    """eval_many's one-step route: T mod_madd launches."""
    def route(coeffs, xs):
        acc = fd.zeros(fs, torch.broadcast_shapes(coeffs.shape[:-2], xs.shape[:-2]) + xs.shape[-2:-1],
                       device=xs.device)
        for l in reversed(range(coeffs.shape[-2])):
            acc = fk.mod_madd(fs, acc, xs, coeffs[..., l, None, :])
        return acc
    return route


def one_step_dot(fs):
    """_field_dot's one-step route: m mod_madd launches."""
    def route(w, v):
        acc = fd.zeros(fs, v.shape[1:-1], device=v.device)
        for j in range(v.shape[0]):
            acc = fk.mod_madd(fs, w[j], v[j], acc)
        return acc
    return route


def field_fns(fs):
    """(wrapper, plain) of mod_madd over ``fs``."""
    return (lambda a, b, c: fk.mod_madd(fs, a, b, c), lambda a, b, c: fk.mod_madd_plain(fs, a, b, c))


def mul_fns(fs, gemm: bool):
    """(wrapper, plain) of mod_mul (or, with ``gemm``, mxu_mod_mul) over ``fs``."""
    if gemm:
        return (lambda a, b: mk.mxu_mod_mul(fs, a, b), lambda a, b: fd._mul_gemm(fs, a, b))
    return (lambda a, b: fk.mod_mul(fs, a, b), lambda a, b: fd.mul(fs, a, b))


def horner_fns(fs):
    """(wrapper, plain) of mod_madd_horner over ``fs``."""
    return (lambda c, x: fk.mod_madd_horner(fs, c, x), lambda c, x: fk.mod_madd_horner_plain(fs, c, x))


def dot_fns(fs):
    """(wrapper, plain) of mod_madd_dot over ``fs``."""
    return (lambda w, v: fk.mod_madd_dot(fs, w, v), lambda w, v: fk.mod_madd_dot_plain(fs, w, v))


def point_fns(cs, op: str, *extra):
    """(wrapper, plain) of the point kernel ``op`` on ``cs``, with its
    trailing int arguments."""
    return (lambda *a: getattr(pk, op)(cs, *a, *extra),
            lambda *a: getattr(pk, op + "_plain")(cs, *a, *extra))


def fixed_base_fns(cs):
    """(wrapper, plain) of pt_fixed_base on ``cs``, scalars first."""
    return (lambda k, table: pk.pt_fixed_base(cs, table, k), lambda k, table: pk.pt_fixed_base_plain(cs, table, k))


def scalar_mul_fns(cs):
    """(wrapper, plain) of pt_scalar_mul on ``cs``, scalars first."""
    return (lambda k, tab: pk.pt_scalar_mul(cs, tab, k), lambda k, tab: pk.pt_scalar_mul_plain(cs, tab, k))


def scalar_mul_layouts_fns(cs):
    """(wrapper, plain) of pt_scalar_mul on ``cs`` over three layouts of
    the same scalars k (1000, L) and tables tab (1000, 16, C, L): a table
    a lane, table 3 shared by every lane, and tables 0..9 each read by 100
    dealers' lanes; the plain version over every lane's own table, once."""
    def wrapper(k, tab):
        return torch.cat([pk.pt_scalar_mul(cs, tab, k), pk.pt_scalar_mul(cs, tab[3], k),
                          pk.pt_scalar_mul(cs, tab[:10], k.reshape(100, 10, -1)).flatten(0, 1)])

    def plain(k, tab):
        return pk.pt_scalar_mul_plain(cs, *reversed(scalar_mul_lanes(k, tab)))
    return wrapper, plain


def scalar_mul_lanes(k, tab) -> tuple:
    """scalar_mul_layouts_fns' three layouts as (scalars, tables), every
    lane with its own table."""
    return k.repeat(3, 1), torch.cat([tab, tab[3].expand(tab.shape), tab[:10].repeat(100, 1, 1, 1)])


def _table_lanes(k: torch.Tensor, tab: torch.Tensor) -> tuple:
    """Scalars (..., L) over tables (..., 16, C, L) broadcast to them as
    (lanes, L) and (lanes, 16, C, L), a table a lane."""
    return k.reshape(-1, k.shape[-1]), tab.expand(k.shape[:-1] + tab.shape[-3:]).reshape((-1,) + tab.shape[-3:])


def scalar_mul_join(plain_args: list, folded: list) -> list:
    """The path's scalars over tables broadcast to them, the layouts' lanes
    (the first folded case) and other rows' path shapes (the rest, each
    scalars over broadcast tables) as one (scalars, tables) call, a table a
    lane."""
    (k, tab), (k_r, tab_r), rest = plain_args, folded[0], folded[1:]
    parts = [_table_lanes(k, tab), scalar_mul_lanes(k_r, tab_r), *(_table_lanes(*args) for args in rest)]
    return [torch.cat([ks for ks, _ in parts]), torch.cat([tabs for _, tabs in parts])]


def scalar_mul_split(out: torch.Tensor, plain_args: list, folded: list) -> tuple:
    """scalar_mul_join's plain result -> (the path shape's part, [the
    layouts' part, then each other row's, in its scalars' shape])."""
    shapes = [plain_args[0].shape[:-1], torch.Size([3 * folded[0][0].shape[0]])]
    shapes += [args[0].shape[:-1] for args in folded[1:]]
    pieces = torch.split(out, [sh.numel() for sh in shapes])
    parts = [piece.reshape(sh + out.shape[-2:]) for piece, sh in zip(pieces, shapes)]
    return parts[0], [parts[1].flatten(0, -3)] + parts[2:]


def fixed_base_muladds(cs, k: torch.Tensor, madd: int) -> int:
    """Mixed adds fixed_base_mul's k need: on Weierstrass curves one a
    non-zero 8-bit digit (a zero digit's entry is the identity, which
    keeps the sum), on Edwards one a window."""
    digits = pk.window_digits(k, gd.FIXED_WINDOW)
    return madd * int(digits.numel() if cs.kind == "edwards" else (digits != 0).sum())


def tree_fns(cs, gathered: bool):
    """(wrapper, plain) of pt_tree_sum on ``cs`` over the ceremony's layout:
    points (m, cols, C, L), or with ``gathered`` per-point tables
    (m, cols, E, C, L) and digits (m,) shared by the columns."""
    if gathered:
        return (lambda tab, d: pk.pt_tree_sum(cs, tab.movedim(0, -4), d),
                lambda tab, d: pk.pt_tree_sum_plain(cs, tab.movedim(0, -4), d))
    return (lambda p: pk.pt_tree_sum(cs, p.movedim(0, -3)),
            lambda p: pk.pt_tree_sum_plain(cs, p.movedim(0, -3)))


def tree_adds(m: int) -> int:
    """Adds of the pairwise tree over m points, the identity pads' included."""
    adds = 0
    while m > 1:
        m = (m + 1) // 2
        adds += m
    return adds


def bucket_fns(cs, window: int, nw: int):
    """(wrapper, plain) of bucket_accumulate on ``cs`` at one window width."""
    return (lambda p, d: bk.bucket_accumulate(cs, p, d, window, nw),
            lambda p, d: bk.bucket_accumulate_plain(cs, p, d, 1 << window))


def bucket_sum_fns(cs, window: int):
    """(wrapper, plain) of pt_bucket_sum on ``cs`` at one window width."""
    return (lambda p, d: bk.pt_bucket_sum(cs, p, d, window),
            lambda p, d: bk.pt_bucket_sum_plain(cs, p, *bk.bucket_lists(d, window)))


def dot_convoy_fns(fs):
    """(wrapper, plain) of mod_madd_dot over a convoy, values (k, m, K...,
    L) first, then weights (k', m, L) cut to the values' k (a row cut of the
    values takes the same ceremonies' weights)."""
    return (lambda v, w: fk.mod_madd_dot(fs, w[: v.shape[0]], v),
            lambda v, w: fk.mod_madd_dot_plain(fs, w[: v.shape[0]], v))


def bucket_sum_convoy_fns(cs, window: int):
    """(wrapper, plain) of pt_bucket_sum over a convoy: points held (B/k, k,
    m, C, L), read as (k, B/k, m, C, L); digits (k, m, nw), a block a
    ceremony shared by its B/k columns."""
    return (lambda p, d: bk.pt_bucket_sum(cs, p.movedim(0, 1), d, window),
            lambda p, d: bk.pt_bucket_sum_plain(cs, p.movedim(0, 1), *bk.bucket_lists(d, window)))


def bucket_close_fns(cs):
    """(wrapper, plain) of pt_bucket_close on ``cs``."""
    return (lambda b: bk.pt_bucket_close(cs, b), lambda b: bk.pt_bucket_close_plain(cs, b))


def close_layouts_fns(cs):
    """(wrapper, plain) of pt_bucket_close on ``cs`` over two layouts of
    nb = 2**c - 1 buckets a window: ``wide`` (33, 2, nb + 1, C, L), held as
    bucket_accumulate holds them (bucket 0 skipped by a view), and ``row``
    (3, nb, C, L), one row of 3 windows; the plain version over all 69
    windows at once, so that its 2 nb sequential steps run once."""
    def wrapper(wide, row):
        tail = wide.shape[-2:]
        return torch.cat([bk.pt_bucket_close(cs, wide[..., 1:, :, :]).reshape((-1,) + tail),
                          bk.pt_bucket_close(cs, row)])

    def plain(wide, row):
        nb, tail = row.shape[-3], row.shape[-2:]
        return bk.pt_bucket_close_plain(cs, torch.cat([wide[..., 1:, :, :].reshape((-1, nb) + tail), row]))
    return wrapper, plain


def close_join(plain_args: list, folded: list) -> list:
    """The path's buckets (..., nw, nb, C, L) and close_layouts_fns'
    (wide, row) as one (windows, nb, C, L) operand of the plain close."""
    (b,), ((wide, row),) = plain_args, folded
    nb, tail = b.shape[-3], b.shape[-2:]
    return [torch.cat([b.reshape((-1, nb) + tail), wide[..., 1:, :, :].reshape((-1, nb) + tail), row])]


def close_split(out: torch.Tensor, plain_args: list, folded: list) -> tuple:
    """close_join's plain result -> (the path shape's part, [the random
    case's part, as close_layouts_fns' plain gives it])."""
    b = plain_args[0]
    k = b.shape[:-3].numel()
    return out[:k].reshape(b.shape[:-3] + out.shape[-2:]), [out[k:]]


def _ones_below(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x (k, columns, L) with rows k .. rows - 1 of ones: a column's other
    elements keep their inverses (a column holding a zero still reads 0)."""
    pad = torch.zeros((rows - x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    pad[..., 0] = 1
    return torch.cat([x, pad])


def columns_join(plain_args: list, folded: list) -> list:
    """Batch inversions (rows, columns, L) side by side, a case of fewer
    rows padded with ones to the path shape's: each column is its own chain
    of the plain version."""
    rows = plain_args[0].shape[0]
    return [torch.cat([plain_args[0]] + [_ones_below(args[0], rows) for args in folded], dim=-2)]


def columns_split(out: torch.Tensor, plain_args: list, folded: list) -> tuple:
    """columns_join's plain result -> (the path shape's columns, [each
    case's, its own rows])."""
    widths = [plain_args[0].shape[-2]] + [args[0].shape[-2] for args in folded]
    main, *parts = torch.split(out, widths, dim=-2)
    return main, [part[: args[0].shape[0]] for part, args in zip(parts, folded)]


def fold_rows(rand: list, rows: int) -> tuple:
    """(the random cases of ``rand`` whose operand has at most ``rows``
    rows, the rest) of a batch inversion's random cases."""
    same = [(label, wrapper, args) for label, wrapper, _, args in rand if args[0].shape[0] <= rows]
    return same, [c for c in rand if c[3][0].shape[0] > rows]


def close_route(cs, buckets: torch.Tensor) -> torch.Tensor:
    """The bucket close's old route: 2 (2**c - 1) pt_add launches."""
    run = tot = gd.identity(cs, buckets.shape[:-3], device=buckets.device)
    for e in reversed(range(buckets.shape[-3])):
        run = pk.pt_add(cs, run, buckets[..., e, :, :])
        tot = pk.pt_add(cs, tot, run)
    return tot


# random scatter passes per curve: (window, digits shared by the batch,
# batch rows, m, nw); m = 515 crosses the kernel's 512-point digit tile at
# window 4, nw = 30 leaves the last 8-window block part empty
BUCKET_RANDOM = {
    "secp256k1": ((4, True, 3, 515, 64), (8, False, 5, 37, 32)),
    "ristretto255": ((4, False, 5, 37, 30), (8, True, 3, 37, 32)),
    "bls12_381_g1": ((4, True, 3, 37, 64), (8, False, 5, 37, 32)),
}
# points on which the Weierstrass bucket_accumulate's plain version (off
# every path since pt_bucket_sum: m sequential steps, 44-60 s at m = 1024
# on a slow host) is held and timed; the kernel at the path's full shape is
# held exactly to pt_bucket_sum there (its route), which is held to its own
# plain version.  The Edwards one (verify_partials' per-row digits) is held
# on all its points
BUCKET_PLAIN_POINTS = 128


def rand_digits(rng, shape: tuple, window: int) -> torch.Tensor:
    """Random window digits (..., m, nw), with digit-0 lanes: the first
    point's in every window, the second's in every other window."""
    d = rng.integers(0, 1 << window, size=shape).astype(np.int32)
    d[..., 0, :] = 0
    d[..., 1, ::2] = 0
    return torch.from_numpy(d).to(DEV)


def kernel_cases(rng) -> dict:
    cases = {}
    R = (RANDOM_LANES,)
    lanes = f"{RANDOM_LANES} lanes"
    for path in PATHS:
        cs, n, t = path.cs, path.n, path.t
        pool = point_pool(rng, cs)
        S = cs.scalar
        add_c, madd_c, dbl_c = POINT_COSTS[cs.name]

        def points(batch, affine=False):
            return rand_points(rng, cs, pool, batch, affine)

        def name(op):
            return pk.kernel_for(op, cs).name

        # eval_many's Horner step: acc (n, n, L), x (n, L), coefficient (n, 1, L)
        cases[fk._FIELDS[S][0].name] = Case(
            path, *field_fns(S),
            [(f"{lanes} of {fs.name}", *field_fns(fs), [rand_field(rng, fs, R, o) for o in range(3)])
             for fs in (S, cs.field)],
            [rand_field(rng, S, (n, n)), rand_field(rng, S, (n,)), rand_field(rng, S, (n, 1))],
            MADD_FIELD[S.name] * n * n)
        # _field_dot's step on the one-step route: w_j (L,), v_j (n, L), acc (n, L)
        cases[fk._FIELDS[S][0].name + " field_dot step"] = Case(
            path, *field_fns(S), [],
            [rand_field(rng, S, (1,)).reshape(S.limbs), rand_field(rng, S, (n,)), rand_field(rng, S, (n,))],
            MADD_FIELD[S.name] * n)
        # eval_many at the deal's shape in one launch: coefficients (n, t+1, L),
        # x = 1..n shared; at random lanes over both fields of the family
        # (per-row coefficients with shared xs, and the other way round)
        xs_main = fd.zeros(S, (n,), device=DEV)
        xs_main[:, 0] = torch.arange(1, n + 1, dtype=torch.int32, device=DEV)
        horner_rand = []
        for fs in (S, cs.field):
            horner_rand.append((f"{lanes} of {fs.name}, per-row coefficients", *horner_fns(fs),
                                [rand_field(rng, fs, (256, 3), 0), rand_field(rng, fs, (256,), 1)]))
            horner_rand.append((f"{lanes} of {fs.name}, per-row points", *horner_fns(fs),
                                [rand_field(rng, fs, (4,), 1), rand_field(rng, fs, (256, 256), 0)]))
        cases[fk.horner_kernel_for(S).name] = Case(
            path, *horner_fns(S), horner_rand, [rand_field(rng, S, (n, t + 1)), xs_main],
            MADD_FIELD[S.name] * n * n * (t + 1), plain_reps=1, plain_rows=8, route=one_step_horner(S))
        # the scalar RLC Σ_j rho_j s_ji in one launch: weights (n, L) with
        # RHO_BITS bits, values (n, n, L); at random lanes over both fields
        rho_main = rand_field(rng, S, (n,), operand=None)
        rho_main[:, RHO_BITS // 16:] = 0
        cases[fk.dot_kernel_for(S).name] = Case(
            path, *dot_fns(S),
            [(f"{lanes} of {fs.name}", *dot_fns(fs), [rand_field(rng, fs, (5,), 0), rand_field(rng, fs, (5, R[0]), 1)])
             for fs in (S, cs.field)],
            [rho_main, rand_field(rng, S, (n, n))],
            MADD_FIELD[S.name] * n * n, plain_reps=1, route=one_step_dot(S))
        # the service's stacked verify (dkg_tpu_torch/service/engine.py
        # _verify_stack): its scalar RLCs over a convoy of CONVOY_K ceremonies
        # at the path's n, each with its own RHO_BITS weights, in one launch
        # (a weight block a ceremony), against CONVOY_K launches of the
        # shared-block kernel (its route) and its plain version on the first
        # ceremony; on secp256k1 also at S1's (16, 5) bucket at width 8.  At
        # random inputs: k = 1, k = 3 with m = 37 (not a multiple of a warp)
        # and an all-zero weight block, K = 1
        dot_convoy = dot_convoy_fns(S)
        w3 = rand_field(rng, S, (3, 37), 0)
        w3[1] = 0
        dot_rand = [("k=1, m=37, 1000 lanes", *dot_convoy,
                     [rand_field(rng, S, (1, 37, 1000), 1), rand_field(rng, S, (1, 37), 0)]),
                    ("k=3, m=37, an all-zero weight block, (4, 5) lanes", *dot_convoy,
                     [rand_field(rng, S, (3, 37, 4, 5), 1), w3]),
                    ("k=3, K=1", *dot_convoy, [rand_field(rng, S, (3, 5, 1)), rand_field(rng, S, (3, 5))])]
        for suffix, kk, nn in ((" convoy", CONVOY_K, n), (" convoy (16,5)", SVC_BATCH_MAX, 16)):
            if nn != n and path is not SECP:
                continue
            rho_k = rand_field(rng, S, (kk, nn), operand=None)
            rho_k[..., (RHO_BITS if nn == n else SVC_RHO_BITS) // 16:] = 0
            cases[fk.dot_kernel_for(S).name + suffix] = Case(
                path, *dot_convoy, dot_rand if nn == n else [], [rand_field(rng, S, (kk, nn, nn)), rho_k],
                MADD_FIELD[S.name] * kk * nn * nn, plain_reps=1, plain_rows=1,
                route=lambda v, w, fs=S: torch.stack([fk.mod_madd_dot(fs, w[i], v[i]) for i in range(w.shape[0])]))
        # E = A + h·b over every dealer's t+1 coefficients
        cases[name("pt_add")] = Case(
            path, *point_fns(cs, "pt_add"),
            [(lanes, *point_fns(cs, "pt_add"), [points(R), points(R)])],
            [points((n, t + 1)), points((n, t + 1))],
            add_c * n * (t + 1))
        # fixed_base_mul in one launch over g's table: at the deal's shape
        # (every dealer's t+1 coefficients) and, in its own row, the
        # verifier's n lanes; at random lanes (field edges first: digit-0
        # windows) and over the identity's table (every entry Z = 0, or the
        # Edwards identity), with scalars whose every other byte is 0, at
        # 2**15 lanes (one thread a lane) and at 1000 (in a group, where
        # the curve's kernel has one)
        g_table = gp.generator_table(cs, device=DEV)
        ident_table = gd.identity(cs, g_table.shape[:2], device=DEV).contiguous()
        fixed = fixed_base_fns(cs)
        k_sparse = rand_field(rng, S, R)
        k_sparse[..., :] &= 0xFF00
        # the one-step route: 32 gathered pt_madd launches with their selects
        fixed_route = lambda k, table, cs=cs: pk.pt_fixed_base_plain(cs, table, k, madd=pk.pt_madd)  # noqa: E731
        for suffix, batch in (("", (n, t + 1)), (" verify", (n,))):
            k_main = rand_field(rng, S, batch)
            cases[name("pt_fixed_base") + suffix] = Case(
                path, *fixed,
                [] if suffix else [(f"{lanes}, g's table", *fixed, [rand_field(rng, S, R), g_table]),
                                   (f"{lanes}, the identity's table", *fixed, [k_sparse, ident_table]),
                                   ("1000 lanes, g's table", *fixed, [rand_field(rng, S, (1000,)), g_table]),
                                   ("1000 lanes, the identity's table", *fixed, [k_sparse[:1000], ident_table])],
                [k_main, g_table], fixed_base_muladds(cs, k_main, madd_c), plain_reps=1,
                plain_rows=8 if not suffix else None, route=fixed_route)
        # a Straus window's tree sum: the entries of the n (t+1) points'
        # 16-entry tables (n, t+1, 16; built as the ceremony builds them, 14
        # pt_add launches) under n digits shared by the t+1 columns, read
        # in place (the bound counts the gathered entries' bytes); in its own
        # row the master key's (one column of n points); at random inputs
        # (2**15 columns of 3 points) and at the edges m = 1, 2, 3, 5, 1000
        # (direct and gathered, over 4 columns at one thread a lane and over
        # one, in a group where the curve's kernel has one) and m = 1500,
        # past the 1024-point chunk (two launches)
        W = cs.ncoords * cs.field.limbs
        tree_d, tree_g = tree_fns(cs, False), tree_fns(cs, True)
        tree_rand = [(f"{RANDOM_LANES} columns of 3 points", *tree_d, [points((3, RANDOM_LANES))])]
        for m in (1, 2, 3, 5, 1000):
            dig = torch.from_numpy(rng.integers(0, 16, size=(m,)).astype(np.int32)).to(DEV)
            dig[0] = 0
            for cols in (4, 1):
                label = f"m={m}, {cols} column{'s' if cols > 1 else ''}"
                tree_rand += [(label, *tree_d, [points((m, cols))]),
                              (f"{label} gathered", *tree_g, [points((m, cols, 16)), dig])]
        tree_rand.append(("m=1500, 3 columns, two launches", *tree_d, [points((1500, 3))]))
        digits_main = torch.from_numpy(rng.integers(0, 16, size=(n,)).astype(np.int32)).to(DEV)
        cases[name("pt_tree_sum")] = Case(
            path, *tree_g, tree_rand, [gd._build_table(cs, points((n, t + 1))), digits_main],
            add_c * (t + 1) * tree_adds(n),
            plain_reps=1, nbytes=4 * (n * (t + 1) * W + n + (t + 1) * W),
            route=lambda tab, d, cs=cs: pk.pt_tree_sum_plain(cs, tab.movedim(0, -4), d, add=pk.pt_add))
        cases[name("pt_tree_sum") + " master"] = Case(
            path, *tree_d, [], [points((n,))], add_c * tree_adds(n), plain_reps=1,
            route=lambda p, cs=cs: pk.pt_tree_sum_plain(cs, p, add=pk.pt_add))
        # one window of fixed_base_mul's one-step route (off every path since
        # pt_fixed_base) over every dealer's t+1 coefficients
        cases[name("pt_madd")] = Case(
            path, *point_fns(cs, "pt_madd"),
            [(lanes, *point_fns(cs, "pt_madd"), [points(R), points(R, True)])],
            [points((n, t + 1)), points((n, t + 1), True)],
            madd_c * n * (t + 1))
        # the Pippenger point RLC's scatter: the t+1 columns of n points
        # under the digits of n shared RHO_BITS-wide weights, at the window
        # msm_pippenger picks for m = n; every point is added into one
        # bucket of each window
        window = gd.pippenger_window(n, cs.name)
        nw = min(gd.n_windows(cs, window), -(-RHO_BITS // window))
        rho = rand_field(rng, S, (n,), operand=None)
        rho[:, RHO_BITS // 16:] = 0
        bucket_rand = []
        for w, shared, rows, m, bnw in BUCKET_RANDOM[cs.name]:
            digits = rand_digits(rng, (m, bnw) if shared else (rows, m, bnw), w)
            label = f"window {w}, ({rows}, {m}) points, {'shared' if shared else 'per-row'} ({m}, {bnw}) digits"
            if cs.name != "ristretto255" and shared and m > BUCKET_PLAIN_POINTS:
                # off every path: m sequential plain steps are the costliest
                # check of the script, so the tile crossing is held to
                # pt_bucket_sum (buckets from 1 on), held to its own plain
                # version; bucket 0 is held at the other cases
                fns = (lambda p, d, w=w, k=bnw, cs=cs: bk.bucket_accumulate(cs, p, d, w, k)[..., 1:, :, :],
                       lambda p, d, w=w, cs=cs: bk.pt_bucket_sum(cs, p, d, w))
                label += " held to pt_bucket_sum"
            else:
                fns = bucket_fns(cs, w, bnw)
            bucket_rand.append((label, *fns, [points((rows, m)), digits]))
        cases[bk.kernel_for(cs).name] = Case(
            path, *bucket_fns(cs, window, nw), bucket_rand,
            [points((t + 1, n)), pk.window_digits(rho, window)[:, :nw].contiguous()],
            add_c * (t + 1) * n * nw, plain_reps=1,
            plain_cut=None if cs.name == "ristretto255" else (
                f"the first {BUCKET_PLAIN_POINTS} of {n} points",
                lambda p, d: (p[:, :BUCKET_PLAIN_POINTS], d[:BUCKET_PLAIN_POINTS])))
        # its redesign for the RLC's shared digits, pt_bucket_sum: the same
        # commitments held as the ceremony holds them, (n, t+1), read as
        # (t+1, n) through strides, against its route (bucket_accumulate's
        # buckets from 1 on); every row of every non-zero digit's bucket
        # takes one add.  At random inputs, at c = 4 and 8: identity points
        # (every 7th), digit-0 points, an empty bucket, all digits zero, one
        # bucket holding every point, m = 1, B = 1 and B = 33 (not a multiple
        # of a warp), points in either layout
        digits_main = pk.window_digits(rho, window)[:, :nw].contiguous()
        sum_fns = bucket_sum_fns(cs, window)
        sum_rand = []
        for w in (4, 8):
            rows_m = points((37, 33))
            d = rand_digits(rng, (37, 3), w)
            d[:, 1] = 5  # window 1: one bucket holding every point
            sum_rand += [(f"window {w}, (33, 37) points in the (m, B) layout, shared (37, 3) digits",
                          *bucket_sum_fns(cs, w), [rows_m.movedim(0, 1), d]),
                         (f"window {w}, (1, 37) points, all digits zero", *bucket_sum_fns(cs, w),
                          [points((1, 37)), torch.zeros_like(d)]),
                         (f"window {w}, (5, 1) points", *bucket_sum_fns(cs, w),
                          [points((5, 1)), torch.tensor([[1, 3, 0]], dtype=torch.int32, device=DEV)])]
        cases[bk.sum_kernel_for(cs).name] = Case(
            path, *sum_fns, sum_rand, [points((n, t + 1)).movedim(0, 1), digits_main],
            add_c * (t + 1) * int((digits_main != 0).sum()), plain_reps=1, plain_rows=32,
            route=lambda p, d, cs=cs, w=window, k=nw: bk.bucket_accumulate(cs, p, d, w, k)[..., 1:, :, :])
        # the stacked verify's point RLC scatter in one launch: CONVOY_K
        # ceremonies' commitments (affine: 2.8 M points, no rescaling's
        # temporaries) held (t+1, k, n) (the copy the convoy's
        # (k, t+1, n) view makes is in the time), a digit block a ceremony
        # from its own RHO_BITS weights shared by its t+1 columns, against
        # CONVOY_K launches of the shared-block kernel (its route) and its
        # plain version on the first 4 columns of every ceremony; on
        # secp256k1 also at S1's (16, 5) bucket at width 8 (c = 4).  At random
        # inputs: k = 1, k = 3 with one column a ceremony (B/k = 1), m = 37
        # (not a multiple of a warp) and an all-zero digit block, B/k = 33
        conv_rand = []
        for w in (4, 8):
            d3 = rand_digits(rng, (3, 37, 3), w)
            d3[1] = 0  # a zero weight window in every column of ceremony 1
            conv_rand += [(f"window {w}, k=1, B/k=5, m=37", *bucket_sum_convoy_fns(cs, w),
                           [points((5, 1, 37)), rand_digits(rng, (1, 37, 3), w)]),
                          (f"window {w}, k=3, B/k=1, m=37, an all-zero digit block", *bucket_sum_convoy_fns(cs, w),
                           [points((1, 3, 37)), d3]),
                          (f"window {w}, k=3, B/k=33, m=37", *bucket_sum_convoy_fns(cs, w),
                           [points((33, 3, 37)), rand_digits(rng, (3, 37, 2), w)])]
        for suffix, kk, nn, tt in ((" convoy", CONVOY_K, n, t), (" convoy (16,5)", SVC_BATCH_MAX, 16, 5)):
            if nn != n and path is not SECP:
                continue
            bits = RHO_BITS if nn == n else SVC_RHO_BITS
            cwin = gd.pippenger_window(nn, cs.name)
            cnw = min(gd.n_windows(cs, cwin), -(-bits // cwin))
            rho_k = rand_field(rng, S, (kk, nn), operand=None)
            rho_k[..., bits // 16:] = 0
            dig_k = pk.window_digits(rho_k, cwin)[..., :cnw].contiguous()
            cases[bk.sum_kernel_for(cs).name + suffix] = Case(
                path, *bucket_sum_convoy_fns(cs, cwin), conv_rand if nn == n else [],
                [points((tt + 1, kk, nn), affine=True), dig_k], add_c * (tt + 1) * int((dig_k != 0).sum()), plain_reps=1,
                plain_rows=4 if nn == n else None, rows_rerun=True,
                route=lambda p, d, cs=cs, w=cwin: torch.stack(
                    [bk.pt_bucket_sum(cs, p[:, i], d[i], w) for i in range(d.shape[0])]))
        # the bucket close in one launch: the t+1 columns' nw windows of
        # 2**c - 1 buckets in pt_bucket_sum's layout, against its route (2
        # (2**c - 1) pt_add launches) and its plain version at the path's
        # full shape; at random inputs, at c = 4 and 8, identity
        # buckets among them, B = 33 in bucket_accumulate's layout (bucket 0
        # skipped by a view) and one row of 3 windows
        nb = (1 << window) - 1
        close_rand = [(f"window {w}, (33, 2) windows in bucket_accumulate's layout and one row of 3",
                       *close_layouts_fns(cs), [points((33, 2, 1 << w)), points((3, (1 << w) - 1))])
                      for w in (4, 8)]
        # the random case of the path's window joins the path shape's plain
        # pass: 2 nb sequential steps once, not twice
        f_label, f_wrapper, _, f_args = close_rand.pop((4, 8).index(window))
        cases[bk.close_kernel_for(cs).name] = Case(
            path, *bucket_close_fns(cs), close_rand, [points((nw, nb, t + 1)).movedim(2, 0)],
            add_c * (t + 1) * nw * 2 * nb, plain_reps=1, route=lambda b, cs=cs: close_route(cs, b),
            folded=([(f_label, f_wrapper, f_args)], close_join, close_split))
        # one Horner step of eval_point_poly: acc (n,), D_l one point, x = 1..n
        x_rand = torch.from_numpy(rng.integers(0, 1 << path.index_bits, size=R).astype(np.int32)).to(DEV)
        x_main = torch.arange(1, n + 1, dtype=torch.int32, device=DEV)
        ladder = point_fns(cs, "pt_ladder_mul_add", path.index_bits)
        cases[name("pt_ladder_mul_add")] = Case(
            path, *ladder,
            [(lanes, *ladder, [points(R), points(R), x_rand])],
            [points((n,)), points(()), x_main],
            ladder_muladds(range(1, n + 1), dbl_c, add_c))
        # eval_point_poly at the batch verifier's shape in one launch: D
        # (t+1 shared points), x = 1..n; at random lanes with per-lane
        # coefficients (T = 2) and shared ones (T = 3), x = 0 and 2^nbits - 1
        # in the first lanes
        x_edge = x_rand.clone()
        x_edge[:2] = torch.tensor([0, (1 << path.index_bits) - 1], dtype=torch.int32)
        horner = point_fns(cs, "pt_ladder_horner", path.index_bits)
        cases[name("pt_ladder_horner")] = Case(
            path, *horner,
            [(f"{lanes}, per-lane T=2", *horner, [points(R + (2,)), x_edge]),
             (f"{lanes}, shared T=3", *horner, [points((3,)), x_edge])],
            [points((t + 1,)), x_main],
            (t + 1) * ladder_muladds(range(1, n + 1), dbl_c, add_c), plain_reps=1, plain_rows=2,
            rows_rerun=True, route=one_step_ladder(cs, path.index_bits))
        # one window step over the t+1 columns, the Straus RLC's (k = 4)
        # and, in its own row, the Pippenger combine's at k = 8 (c = 8 at
        # n = 1024; ristretto255's n = 256 combine runs c = 4, the Straus
        # row's shape); and in a third row the KEM's scalar_mul step over
        # all n * n pairs (k = 4), its plain version timed once
        for k, suffix, m in ((gd.WINDOW, "", t + 1), (8, " k=8", t + 1), (gd.WINDOW, " KEM", n * n)):
            step = point_fns(cs, "pt_window_step", k)
            rand = [] if suffix == " KEM" else [(f"{lanes}, k={k}", *step, [points(R), points(R)])]
            cases[name("pt_window_step") + suffix] = Case(
                path, *step, rand, [points((m,)), points((m,))], (k * dbl_c + add_c) * m,
                plain_reps=1 if suffix == " KEM" else 2)
        # pt_double at k = 1 and 4, off every path (each window step is one
        # pt_window_step launch), timed at the Straus window step's shape:
        # 4 doublings over t+1 columns
        dbl_rand = [(f"{lanes}, k={k}", *point_fns(cs, "pt_double", k), [points(R)]) for k in (1, 4)]
        cases[name("pt_double")] = Case(
            path, *point_fns(cs, "pt_double", gd.WINDOW), dbl_rand, [points((t + 1,))],
            gd.WINDOW * dbl_c * (t + 1))
        # the canonical affine form of the n(t+1) commitments A (and E): x·zi
        # over all of them (the row), and one step of the batch inversion's
        # chain over one of its 256 rows; each kernel over both fields of
        # its family at random lanes
        F, lanes_all = cs.field, n * (t + 1)
        for gemm in (False, True):
            kname = (mk.kernel_for(F) if gemm else fk.mul_kernel_for(F)).name
            mul_rand = [(f"{lanes} of {fs.name}", *mul_fns(fs, gemm),
                         [rand_field(rng, fs, R, 0), rand_field(rng, fs, R, 1)]) for fs in (F, S)]
            for suffix, m in (("", lanes_all), (" batch_inv step", -(-lanes_all // 256))):
                int32_muls, int8 = mxu_ops(F) if gemm else (0, 0)
                cases[kname + suffix] = Case(
                    path, *mul_fns(F, gemm), mul_rand if not suffix else [],
                    [rand_field(rng, F, (m,)), rand_field(rng, F, (m,))],
                    0 if gemm else MADD_FIELD[F.name] * m, int32_muls * m, int8 * m)
        # the canonical affine form's whole batch inversion in one launch:
        # the n(t+1) commitments' non-zero Z as affine_canon lays them out,
        # (INV_ROWS, lanes / INV_ROWS), and in its own row a default seal
        # chunk's 4096 KEM points, against the one-step route (the JAX
        # package's 256 rows, each multiply one mod_mul launch); at random
        # inputs the edges: 1, p - 1, 2 and p - 2 down a column, a column of
        # one repeated element, a column holding a zero (it reads 0), k = 1,
        # and 2**15 lanes at INV_ROWS rows
        inv = (lambda x, F=F: fk.mod_batch_inv(F, x), lambda x, F=F: fd.batch_inv(F, x))
        p_ = F.modulus
        ends = fh.to_tensor(fh.encode(F, [1, p_ - 1, 2, p_ - 2]), DEV).reshape(4, 1, F.limbs)
        cols = nonzero_field(rng, F, (gd.INV_ROWS, 8))
        cols[:, 1] = cols[0, 1]
        cols[3, 2] = 0
        inv_rand = [("1, p - 1, 2, p - 2 down a column", *inv, [ends]),
                    (f"{gd.INV_ROWS} rows: a repeated element, a zero", *inv, [cols]),
                    ("k = 1, 1000 columns", *inv, [nonzero_field(rng, F, (1, 1000))]),
                    (f"{lanes} at {gd.INV_ROWS} rows", *inv, [nonzero_field(rng, F, (gd.INV_ROWS, R[0] // gd.INV_ROWS))])]
        chain_muls = fk.chain_multiplies(*fk.inv_chain(F))
        # the random cases (of INV_ROWS rows or fewer, padded with ones) join
        # the path shape's plain pass (a column a chain): its sequential
        # multiplies run once
        inv_same, inv_rest = fold_rows(inv_rand, gd.INV_ROWS)
        main_name = fk.batch_inv_kernel_for(F).name
        x_seal = nonzero_field(rng, F, (gd.INV_ROWS, 4096 // gd.INV_ROWS))
        # the seal chunk's row is held in the main row's plain pass: one
        # column chain a column, so its sequential multiplies run once
        inv_same.append((main_name + " seal chunk", inv[0], [x_seal]))
        for suffix, x in (("", nonzero_field(rng, F, (gd.INV_ROWS, lanes_all // gd.INV_ROWS))), (" seal chunk", x_seal)):
            m = x.shape[:-1].numel()
            cases[main_name + suffix] = Case(
                path, *inv, inv_rest if not suffix else [], [x],
                MADD_FIELD[F.name] * (3 * (m - 1) + chain_muls), plain_reps=1,
                route=lambda x, F=F: fd.batch_inv(F, x.reshape(256, -1, F.limbs),
                                                  mul=fk.mod_mul).reshape(x.shape),
                folded=None if suffix else (inv_same, columns_join, columns_split),
                plain_in=main_name if suffix else None)
        # mul="gemm"'s whole batch inversion in one launch, every multiply the
        # tensor-core multiply-reduce: the n(t+1) commitments' non-zero Z as
        # affine_canon lays them out, (GEMM_INV_ROWS, lanes / GEMM_INV_ROWS),
        # against the route it replaces (the JAX package's 256 rows, each
        # multiply one mxu_mod_mul launch); at random inputs the edges of
        # mod_batch_inv's (1, p - 1, 2, p - 2 down a column, a repeated
        # element, a zero column, k = 1) and a column count that is not a
        # multiple of a warp (padded with ones), and 2**15 lanes
        ginv = (lambda x, F=F: mk.mxu_batch_inv(F, x), lambda x, F=F: mk.mxu_batch_inv_plain(F, x))
        grows = gd.GEMM_INV_ROWS
        gcols = nonzero_field(rng, F, (grows, 40))
        gcols[:, 1] = gcols[0, 1]
        gcols[3, 2] = 0
        ginv_rand = [("1, p - 1, 2, p - 2 down a column", *ginv, [ends]),
                     (f"{grows} rows, 40 columns: a repeated element, a zero", *ginv, [gcols]),
                     ("k = 1, 1000 columns", *ginv, [nonzero_field(rng, F, (1, 1000))]),
                     (f"{lanes} at {grows} rows", *ginv, [nonzero_field(rng, F, (grows, R[0] // grows))])]
        g32, g8 = mxu_ops(F)
        gmuls = 3 * (lanes_all - 1) + chain_muls
        ginv_same, ginv_rest = fold_rows(ginv_rand, grows)
        cases[mk.batch_inv_kernel_for(F).name] = Case(
            path, *ginv, ginv_rest, [nonzero_field(rng, F, (grows, -(-lanes_all // grows)))],
            0, g32 * gmuls, g8 * gmuls, plain_reps=1,
            route=lambda x, F=F: fd.batch_inv(F, x.reshape(256, -1, F.limbs),
                                              mul=mk.mxu_mod_mul).reshape(x.shape),
            folded=(ginv_same, columns_join, columns_split))
        # every window of scalar_mul in one launch: the seal's KEM (n x n
        # scalars over the n recipients' 16-entry tables, each table read in
        # place by its n dealers) and, in their own rows, a default seal
        # chunk's KEM (4096 // n dealers, 4096 lanes: groups of threads, as
        # the opens) and a recipient's opens (one key's n lanes, a table a
        # lane), against the one-step route (64 gathered pt_window_step
        # launches); the KEM's plain version on its first 4 dealers, the
        # chunk's on its first.  At random inputs the edges (scalars 0, 1,
        # order - 1 and others first, then ones with zero digit windows; the
        # identity every 7th point) in three calls, held at once in the KEM
        # row's plain call over the lanes' own tables: 1000 lanes with a table a
        # lane, with one table shared by all, and 100 dealers x 10
        # recipients' tables
        smul = scalar_mul_fns(cs)
        k_edge = rand_field(rng, S, (1000,))
        k_edge[100:300] &= 0x0F0F
        lane_tables = gd._build_table(cs, points((1000,)))
        # held in the KEM row's plain pass: its 64 window steps run once
        smul_rand = [("1000 lanes with a table a lane, with one shared table and with a table a recipient",
                      scalar_mul_layouts_fns(cs)[0], [k_edge, lane_tables])]
        step_c = gd.WINDOW * dbl_c + add_c
        nw = gd.n_windows(cs)
        kem_tables = gd._build_table(cs, points((n,)))
        sk = rand_field(rng, S, (1,), operand=None).expand(n, S.limbs)
        rows_smul = (("", rand_field(rng, S, (n, n)), 4),
                     (" seal chunk", rand_field(rng, S, (max(1, 4096 // n), n)), 1),
                     (" open", sk, None))
        # the seal chunk's and the opens' rows are held in the KEM row's
        # plain pass (their path shapes, the chunk's first row, as lanes of
        # it): the 64 sequential window steps run once for all three
        kem_name = name("pt_scalar_mul")
        smul_rand += [(kem_name + suffix, smul[0], [k if rows is None else k[:rows], kem_tables])
                      for suffix, k, rows in rows_smul[1:]]
        for suffix, k_main, plain_rows in rows_smul:
            cases[kem_name + suffix] = Case(
                path, *smul, [], [k_main, kem_tables],
                step_c * nw * (k_main.numel() // S.limbs), plain_reps=1, plain_rows=plain_rows,
                route=lambda k, tab, cs=cs: pk.pt_scalar_mul_plain(cs, tab, k, step=pk.pt_window_step),
                folded=None if suffix else (smul_rand, scalar_mul_join, scalar_mul_split),
                plain_in=kem_name if suffix else None)
    return cases


def held(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    sync()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
    return err


def check_kernels(rng) -> dict:
    out = {}
    shared = {}  # row name -> (plain_ms, the plain part) of a row held in another row's plain pass
    cases = kernel_cases(rng)
    for name, case in cases.items():
        t_case, err = time.perf_counter(), 0
        for label, wrapper, plain, args in case.rand_args:
            err = max(err, held(f"{name} {label}", wrapper(*args), plain(*args)))
        # a call of SLOW_MS or more is timed over SLOW_REPS calls, not TIMING_REPS
        first_ms, _ = cuda_ms(lambda: case.wrapper(*case.main_args), reps=1)
        reps = TIMING_REPS if first_ms < SLOW_MS else SLOW_REPS
        ms, res = cuda_ms(lambda: case.wrapper(*case.main_args), reps=reps, warm_up=False)
        dev_ms = device_ms(lambda: case.wrapper(*case.main_args), reps=reps)
        rows = case.plain_rows
        plain_args = case.main_args if rows is None else [case.main_args[0][:rows], *case.main_args[1:]]
        if case.plain_cut is not None:
            plain_args = case.plain_cut[1](*case.main_args)
        plain_in, folded = plain_args, []
        if case.folded is not None:
            folded, join, split = case.folded
            plain_in = join(plain_args, [args for _, _, args in folded])
        if case.plain_in is not None:  # held in that row's plain pass
            plain_ms, want = shared[name]
        else:
            plain_ms, want = cuda_ms(lambda: case.plain(*plain_in), reps=case.plain_reps,
                                     warm_up=case.plain_reps > 1)
        if folded:
            want, parts = split(want, plain_args, [args for _, _, args in folded])
            for (label, wrapper, args), part in zip(folded, parts):
                if label in cases:  # another row's path shape: held in its own turn
                    shared[label] = (plain_ms, part)
                else:
                    err = max(err, held(f"{name} {label}", wrapper(*args), part))
        got = (case.wrapper(*plain_args) if case.plain_cut is not None or (rows is not None and case.rows_rerun)
               else res if rows is None else res[:rows])
        err = max(err, held(name, got, want))
        route = {}
        if case.route is not None:
            err = max(err, held(f"{name} against its one-step route", res, case.route(*case.main_args)))
            # T or m launches with their broadcast copies: a longer spin (about
            # 0.4 s) covers their enqueue
            route = {"one_step_device_ms": device_ms(lambda: case.route(*case.main_args), reps=1,
                                                     spin=800_000_000),
                     "ptxas": ptxas_of(name)}
        nbytes = case.nbytes
        if nbytes is None:
            nbytes = sum(a.numel() * a.element_size() for a in case.main_args) + res.numel() * 4
        bytes_ms = 1e3 * nbytes / BYTES_PER_S
        ops_ms = (1e3 * (2 * case.muladds + case.int32_muls) / INT32_MUL_PER_S
                  + 1e3 * 2 * case.int8_products / INT8_OPS_PER_S)
        out[name] = {
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "plain_rows": rows, "plain_cut": case.plain_cut and case.plain_cut[0],
            "plain_folded": [label for label, *_ in folded] or None, "plain_in": case.plain_in,
            "timing_reps": reps, **route,
        }
        labels = [lbl for lbl, *_ in case.rand_args] + [f"{lbl} (in the path shape's plain pass)" for lbl, *_ in folded]
        rand = f"at random inputs ({'; '.join(labels)}) and " if labels else ""
        print(f"kernel {name}: exact {rand}at "
              f"{case.path.curve} n={case.path.n} shape {tuple(res.shape)}"
              f"{'' if rows is None else f' (plain on the first {rows} rows)'}"
              f"{'' if case.plain_cut is None else f' (plain on {case.plain_cut[0]})'}"
              f"{'' if case.plain_in is None else f' (plain in the pass of {case.plain_in})'}; {ms:.4f} ms "
              f"(device {dev_ms:.4f} ms), "
              f"plain {plain_ms:.2f} ms, bound {out[name]['bound_ms']:.6f} ms "
              f"({out[name]['bound_by']})"
              + (f"; equal to its one-step route, device {route['one_step_device_ms']:.4f} ms; ptxas "
                 + json.dumps(route["ptxas"]) if route else "")
              + f"; {time.perf_counter() - t_case:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# the ceremonies against host oracles
# ---------------------------------------------------------------------------


def host_point(cs, pt: torch.Tensor) -> tuple:
    return gd.to_host(cs, pt.reshape(1, cs.ncoords, -1))[0]


def eval_host(q: int, coeffs_row, x: int) -> int:
    acc = 0
    for c in reversed(coeffs_row):
        acc = (acc * x + int(c)) % q
    return acc


class PlainMuls:
    """Counts the plain field multiplies (``fd.mul``, ``fd._mul_gemm``) that
    reach a CUDA tensor while the block runs: a kernel wrapper runs them
    only on CPU tensors, so on a path of the card the count must stay 0."""

    def __enter__(self):
        self.count = 0
        self._orig = {name: getattr(fd, name) for name in ("mul", "_mul_gemm")}

        def counted(fn):
            def wrapped(fs, a, b):
                if a.device.type == "cuda" or b.device.type == "cuda":
                    self.count += 1
                return fn(fs, a, b)
            return wrapped

        for name, fn in self._orig.items():
            setattr(fd, name, counted(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(fd, name, fn)


def main_path(path: Path, seed: int, first: bool = False) -> tuple[cer.BatchedCeremony, dict, dict]:
    """Run the path's ceremony with every launch count set to 0 just
    before and read just after, and hold its outputs to host oracles.  A
    table missing from the caches is built on the card inside the run
    (:func:`table_build_exact` each, counted by precompute.stats()); the
    ``first`` run of a path must build one (h's: g's comes from the disk
    file the kernel checks wrote).  Returns the ceremony, its outputs and
    the launch counts."""
    cs, n, t = path.cs, path.n, path.t
    group = gh.ALL_GROUPS[path.curve]
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = gp.stats()["builds"]
    with PlainMuls() as plain:
        c = cer.BatchedCeremony(path.curve, n, t, path.shared, random.Random(seed), device=DEV)
        out = c.run(rlc=path.rlc, mul=path.mul)
        sync()
    launches = {k.name: k.launches for k in KERNELS}
    builds = gp.stats()["builds"] - before
    check(builds >= 1 or not first, f"{path.tag}: the first run built no table on the card ({c.table_stats})")
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor on the {path.tag} path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tag = path.tag
    print(f"main path {tag}: phases " + json.dumps({k: round(v, 6) for k, v in out["phase_seconds"].items()})
          + f", peak device memory {peak_gib:.2f} GiB", flush=True)
    print(f"main path {tag}: launches " + json.dumps(launches), flush=True)
    for k in path.kernels:
        check(launches[k.name] > 0, f"kernel {k.name} was not launched on the {tag} path")
    exact = path.exact_launches()
    if builds:
        exact = merged(exact, scaled(table_build_exact(cs), builds))
    check(all(launches[k] == v for k, v in exact.items()),
          f"{tag}: launch counts {({k: launches[k] for k in exact})}, want {exact}")
    print(f"main path {tag}: eval_point_poly, eval_many, _field_dot, each fixed_base_mul and each tree "
          f"reduction one launch each, each of the {builds} tables built on the card one pt_ladder_mul_add and "
          f"one canonical affine form (table_cache {json.dumps(c.table_stats)}) "
          + json.dumps({k: launches[k] for k in exact}) + f"; {plain.count} plain multiplies on the card",
          flush=True)

    q = cs.scalar.modulus
    gen = gp.base_key_to_point(cs, cs.gen_affine)
    check("error" not in out and out["complaints"] == [], "the honest ceremony blamed a dealer")
    check(out["ok"].shape == (n,) and bool(out["ok"].all()), "a batch check failed")
    check(tuple(out["bare"].shape) == (n, t + 1, cs.ncoords, cs.field.limbs)
          and tuple(out["shares"].shape) == (n, n, cs.scalar.limbs), "round-1 tensors have the wrong shape")
    a = fh.decode(cs.scalar, fh.from_tensor(c.coeffs_a))  # (n, t+1) ints
    secret = sum(int(v) for v in a[:, 0]) % q
    check(group.eq(host_point(cs, out["master"]), group.scalar_mul(secret, gen)), "master key != g·(Σ_j a_j0)")
    for j, l in ((0, 0), (n - 1, t)):
        check(group.eq(host_point(cs, out["bare"][j, l]), group.scalar_mul(int(a[j, l]), gen)),
              f"bare commitment A[{j}, {l}] != g·a")
    col = [sum(int(v) for v in a[:, l]) % q for l in range(t + 1)]
    finals = fh.decode(cs.scalar, fh.from_tensor(out["final_shares"]))
    shares = fh.decode(cs.scalar, fh.from_tensor(out["shares"][:, [0, n // 2, n - 1]]))
    for k, i in enumerate((1, n // 2 + 1, n)):
        check(int(finals[i - 1]) == eval_host(q, col, i), f"final share of party {i} != Σ_j f_j({i})")
        for j in (0, n - 1):
            check(int(shares[j, k]) == eval_host(q, a[j], i), f"share s[{j}, {i - 1}] != f_{j}({i})")
    print(f"main path {tag}: ok for all recipients; master key, commitments and shares match "
          "the host oracles", flush=True)
    return c, out, launches


OUTPUTS = ("bare", "randomized", "shares", "hidings", "rho", "ok", "qualified", "final_shares", "master")


def same_outputs(tag: str, got: dict, want: dict) -> None:
    """Every output tensor of two runs of one ceremony is equal."""
    for k in OUTPUTS:
        check(torch.equal(got[k], want[k]), f"{tag}: output {k} differs from the Straus run's")
    check(got["complaints"] == want["complaints"], f"{tag}: complaints differ from the Straus run's")


ROUND1 = ("bare", "randomized", "shares", "hidings")


def host_leg(cfg, out, split: bool) -> tuple:
    """The host leg's three (n, 8) row arrays on the run's round-1 tensors;
    with ``split``, step by step on the host clock, printed."""
    if not split:
        return cer._dealer_rows(cfg, *(out[k] for k in ROUND1), digest="host")
    n = cfg.n
    t = [time.perf_counter()]
    a, e, s, r = (fh.from_tensor(out[k]) for k in ROUND1)
    t.append(time.perf_counter())
    a, e = gd.affine_canon_host(cfg.cs, a), gd.affine_canon_host(cfg.cs, e)
    t.append(time.perf_counter())
    sr = np.concatenate([s.reshape(n, -1), r.reshape(n, -1)], axis=-1)
    rows = tuple(row_digests_np(x.reshape(n, -1), domain=d) for d, x in ((1, a), (2, e), (3, sr)))
    t.append(time.perf_counter())
    cer.fiat_shamir_rho(cfg, cer._fold_digest_device(cfg, *rows), RHO_BITS)
    t.append(time.perf_counter())
    steps = ("device to host", "canonical affine A, E", "BLAKE2s rows", "fold and rho")
    print(f"fiat_shamir host leg {cfg.curve} (host clock, s): " + json.dumps(
        {k: round(t[i + 1] - t[i], 6) for i, k in enumerate(steps)}), flush=True)
    return rows


def device_leg_split(cfg, out) -> None:
    """The device leg (mod_mul's multiply) step by step on the run's round-1
    tensors: CUDA events around each step and the host clock, each step
    ended by a synchronise."""
    k = cfg.n
    a, e, s, r = (out[key] for key in ROUND1)
    gemm_ms, gemm_canon = cuda_ms(lambda: [gd.affine_canon(cfg.cs, x, mul="gemm") for x in (a, e)], reps=1,
                                  warm_up=False)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    sync()
    t = [time.perf_counter()]
    events[0].record()
    canon = [gd.affine_canon(cfg.cs, x) for x in (a, e)]
    events[1].record()
    sync()
    t.append(time.perf_counter())
    check(all(torch.equal(x, y) for x, y in zip(canon, gemm_canon)), "affine_canon differs under mul=gemm")
    sr = torch.cat([s.reshape(k, -1), r.reshape(k, -1)], dim=-1)
    rows = [dh.to_numpy(dh.row_digests(x.reshape(k, -1), domain=d))
            for d, x in ((1, canon[0]), (2, canon[1]), (3, sr))]
    events[2].record()
    sync()
    t.append(time.perf_counter())
    rho = cer.fiat_shamir_rho(cfg, cer._fold_digest_device(cfg, *rows), RHO_BITS)
    events[3].record()
    sync()
    t.append(time.perf_counter())
    check(np.array_equal(rho, fh.from_tensor(out["rho"])), "the split device leg's rho differs from the run's")
    steps = ("canonical affine A, E", "BLAKE2s rows", "fold and rho")
    print(f"fiat_shamir device leg {cfg.curve}: CUDA events (ms) " + json.dumps(
        {k: round(events[i].elapsed_time(events[i + 1]), 3) for i, k in enumerate(steps)})
        + "; host clock (s) " + json.dumps({k: round(t[i + 1] - t[i], 6) for i, k in enumerate(steps)})
        + f"; canonical affine A, E under mul=gemm {gemm_ms:.3f} ms (CUDA events)", flush=True)


def digest_legs(path: Path, c: cer.BatchedCeremony, out: dict) -> None:
    """On the Straus run's round-1 tensors: the device leg under each
    multiply, with every launch count set to 0 just before, must launch its
    own kernel family and not the other, and no plain multiply may reach a
    CUDA tensor; both give the host leg's three (n, 8) row arrays, and those
    the run's rho.  On REPEATED_PASSES, each leg is also split step by step."""
    cfg, F = c.cfg, path.cs.field
    rows = {}
    for mul, own, other in (("classic", fk.mul_kernel_for(F), mk.kernel_for(F)),
                            ("gemm", mk.kernel_for(F), fk.mul_kernel_for(F))):
        for k in KERNELS:
            k.launches = 0
        with PlainMuls() as plain:
            rows[mul] = cer._dealer_rows(cfg, *(out[k] for k in ROUND1), digest="device", mul=mul)
            sync()
        check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the digest")
        check(own.launches > 0 and other.launches == 0,
              f"digest mul={mul}: {own.name} launched {own.launches}, {other.name} {other.launches} times")
        want = canon_launches(path.cs, mul, 2)
        check(all(k.launches == want[k.name] for k in KERNELS if k.name in want),
              f"digest mul={mul}: launches {({k.name: k.launches for k in KERNELS if k.name in want})}, want {want}")
        print(f"digest {path.curve} mul={mul}: launches " + json.dumps(want) + f", none of {other.name}, "
              "no plain multiply on the card", flush=True)
    rows["host"] = host_leg(cfg, out, path in REPEATED_PASSES)
    for leg, arrays in rows.items():
        check(len(arrays) == 3 and all(x.shape == (cfg.n, 8) and x.dtype == np.uint32 for x in arrays),
              f"{leg} leg: row digests have the wrong shape")
        check(all(np.array_equal(x, y) for x, y in zip(arrays, rows["host"])), f"{leg} leg's rows != the host leg's")
    rho = cer.fiat_shamir_rho(cfg, cer._fold_digest_device(cfg, *rows["host"]), RHO_BITS)
    check(np.array_equal(rho, fh.from_tensor(out["rho"])), "the host leg's rho differs from the run's")
    print(f"digest {path.curve} n={cfg.n}: the device leg's three (n, 8) row arrays under mul=classic and "
          "mul=gemm equal the host leg's, and give the run's rho", flush=True)
    if path in REPEATED_PASSES:
        device_leg_split(cfg, out)


# profiler kernel names -> kernel names: the first entry whose every
# string is in the name wins.  The Weierstrass point and bucket kernels
# are templates (csrc/point_kernels.cuh, bucket.cuh) whose name carries
# the curve (Secp256k1, Bls12381) as its template argument, mangled or
# not; "pt_add_kernel" is also inside "ed_pt_add_kernel" (and
# "pt_window_step_kernel" inside "ed_pt_window_step_kernel"), so the
# Edwards kernels come first, and "mod_mul_kernel" is inside "mxu_mod_mul_kernel".
# The field kernels' names carry a field id or limb count: "madd", "mul",
# "mxu", "batch_inv" and "mxu_batch_inv" stand for the path's own family of
# mod_madd, mod_mul, mxu_mod_mul, mod_batch_inv and
# mxu_batch_inv.
PROFILE_GROUPS = (
    (("ed_pt_add_kernel",), "pt_add[edwards]"), (("ed_pt_madd_kernel",), "pt_madd[edwards]"),
    (("ed_pt_double_kernel",), "pt_double[edwards]"), (("ed_pt_ladder_kernel",), "pt_ladder_mul_add[edwards]"),
    (("ed_pt_window_step_kernel",), "pt_window_step[edwards]"),
    (("bucket_kernel", "EdCurve"), "bucket_accumulate[edwards]"),
    *(((f"{fn}_kernel", tag), op + suffix)
      for tag, suffix in (("Secp256k1", ""), ("Bls12381", "[bls12_381]"))
      for fn, op in (("pt_add", "pt_add"), ("pt_madd", "pt_madd"), ("pt_double", "pt_double"),
                     ("pt_window_step", "pt_window_step"), ("pt_ladder", "pt_ladder_mul_add"),
                     ("pt_ladder_horner", "pt_ladder_horner"), ("bucket", "bucket_accumulate"))),
    (("pt_ladder_horner_kernel", "Edwards25519"), "pt_ladder_horner[edwards]"),
    *(((f"{op}_kernel", tag), op + suffix)
      for tag, suffix in (("Secp256k1", ""), ("Bls12381", "[bls12_381]"), ("Edwards25519", "[edwards]"))
      for op in ("pt_fixed_base", "pt_tree_sum")),
    *(((f"{op}_kernel", tag), op + suffix)
      for tag, suffix in (("Secp256k1", ""), ("Bls12381", "[bls12_381]"), ("Edwards25519", "[edwards]"))
      for op in ("pt_scalar_mul", "pt_bucket_sum", "pt_bucket_close")),
    (("pt_bucket_sum_kernel", "LaneEd"), "pt_bucket_sum[edwards]"),
    (("mod_batch_inv_kernel",), "batch_inv"), (("mxu_batch_inv_kernel",), "mxu_batch_inv"),
    (("mxu_mod_mul_kernel",), "mxu"), (("mod_mul_kernel",), "mul"), (("mod_madd_kernel",), "madd"),
    (("mod_madd_horner_kernel",), "madd_horner"), (("mod_madd_dot_kernel",), "madd_dot"),
    (("Memcpy DtoH",), "copy to host"),
)


def device_ms(fn, reps: int, spin: int = 50_000_000) -> float:
    """Mean device ms per call of ``fn`` with the host out of the way: a
    spin kernel (``spin`` cycles, about 25 ms by default) holds the stream
    while the host enqueues all ``reps`` calls, so the CUDA events around
    them time the calls' kernels back to back (the wrappers' broadcast
    copies included)."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(path: Path, label: str, fn, kernels: tuple | None = None, calls: int = 1) -> None:
    """``fn()``, ``calls`` times, under torch.profiler: device time by
    kernel a call (everything not ours is PyTorch's own ops: the plain
    tensor code and the wrappers' broadcast copies) and the device's busy
    share of the wall time.  Every kernel of the path (or of ``kernels``)
    must show device time."""
    from torch.profiler import ProfilerActivity, profile

    F, S = path.cs.field, path.cs.scalar
    family = {"madd": fk._FIELDS[S][0].name, "mul": fk.mul_kernel_for(F).name, "mxu": mk.kernel_for(F).name,
              "batch_inv": fk.batch_inv_kernel_for(F).name, "mxu_batch_inv": mk.batch_inv_kernel_for(F).name,
              "madd_horner": fk.horner_kernel_for(S).name, "madd_dot": fk.dot_kernel_for(S).name}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    dev: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((family.get(g, g) for keys, g in PROFILE_GROUPS if all(k in e.name for k in keys)),
                     "torch ops")
        dev[group] = dev.get(group, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    busy = sum(dev.values())
    check(all(dev.get(k.name, 0) > 0 for k in (path.kernels if kernels is None else kernels)),
          f"profile saw {dev}")
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.2f} %), device ms "
          + json.dumps({k: round(v, 3) for k, v in sorted(dev.items())})
          + ("" if calls == 1 else f", each a call's mean over {calls} calls"), flush=True)


def profile_main_path(path: Path, seed: int) -> None:
    """The main path (its default schedule) twice more under
    torch.profiler, in one session: late
    in the process the profiler dropped the records of the session's first
    kernels (the deal's), as it did the verify phase's."""
    c = cer.BatchedCeremony(path.curve, path.n, path.t, path.shared, random.Random(seed), device=DEV)
    profiled(path, f"{path.curve} n={path.n} ceremony rlc={path.rlc}", lambda: c.run(rlc=path.rlc), calls=2)


def rlc_schedules(path: Path, c: cer.BatchedCeremony, out: dict) -> None:
    """verify_batch's point RLC D = Σ_j rho_j E_j on the path's tensors
    under each schedule of _point_rlc, timed by CUDA events: equal in
    canonical affine form.  Then the verify phase under Straus and under
    Pippenger, each profiled."""
    cs = path.cs
    affine, ms = {}, {}
    for mode in cer.RLC_MODES:
        ms[mode], d = cuda_ms(lambda: cer._point_rlc(cs, out["rho"], out["randomized"], RHO_BITS, mode),
                              reps=1, warm_up=False)
        check(tuple(d.shape) == (path.t + 1, cs.ncoords, cs.field.limbs), f"D under {mode} has shape {tuple(d.shape)}")
        affine[mode] = gd.affine_canon_host(cs, fh.from_tensor(d))
    for mode in cer.RLC_MODES[1:]:
        check(np.array_equal(affine[mode], affine["straus"]), f"{path.curve}: D under {mode} != D under straus")
    print(f"point RLC {path.curve} n={path.n} t={path.t}: D equal in canonical affine form under "
          f"{', '.join(cer.RLC_MODES)}; ms (CUDA events, one call) " + json.dumps(ms), flush=True)
    for p in (path, path.pippenger()):
        def verify(p=p):
            ok = cer.verify_batch(c.cfg, out["randomized"], out["shares"], out["hidings"], out["rho"], RHO_BITS,
                                  c.g_table, c.h_table, p.rlc)
            check(bool(ok.all()), f"{p.tag}: a batch check failed")
        # twice in one session: late in the process the profiler dropped the
        # records of a session's first kernels (the phase's two mod_madd_dot
        # launches), behind a spin, a discarded warm-up step and idle host
        # time alike
        profiled(p, f"{path.curve} n={path.n} verify phase rlc={p.rlc}", verify, p.verify_kernels(), calls=2)


# ---------------------------------------------------------------------------
# the dealing round's share encryption
# ---------------------------------------------------------------------------

SEAL_SAMPLES = 64  # pairs whose KEM point is held to the host big-int ladder
SEAL_OPENERS = 4  # recipients who open their column: 1, n and two seeded others
SEAL_SCALAR_PAIRS = 1024  # pairs held to the per-pair DEM (its dealers' rows; more would cost the command's time)


class HostSeconds:
    """Host seconds spent in some module functions while the block runs,
    by name: the DEM's steps inside ``seal_shares_batch``."""

    def __init__(self, *targets):
        self.targets = targets  # (module, function name) pairs

    def __enter__(self):
        self.seconds = {name: 0.0 for _, name in self.targets}
        self._orig = [(mod, name, getattr(mod, name)) for mod, name in self.targets]

        def timed(name, fn):
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds[name] += time.perf_counter() - t0
            return wrapped

        for mod, name, fn in self._orig:
            setattr(mod, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def seal_kernels(cs) -> tuple:
    """The kernels one seal launches: c1's fixed-base windows, scalar_mul's
    table adds and windows, and the KEM encoding's multiplies (with, on
    Weierstrass, its canonical affine form's batch inversion)."""
    inv = () if cs.kind == "edwards" else (fk.batch_inv_kernel_for(cs.field),)
    return (pk.kernel_for("pt_fixed_base", cs), pk.kernel_for("pt_add", cs), pk.kernel_for("pt_scalar_mul", cs),
            *inv, fk.mul_kernel_for(cs.field))


def seal_exact(cs, chunks: int) -> dict:
    """Launch counts a seal in ``chunks`` chunks must read exactly: a chunk's
    c1 one pt_fixed_base (no pt_madd), its KEM one pt_scalar_mul (no
    pt_window_step), and its encoding :func:`encode_launches`; the KEM's
    per-key table 14 pt_add (built once a chunk, over the same keys)."""
    return {pk.kernel_for("pt_fixed_base", cs).name: chunks, pk.kernel_for("pt_madd", cs).name: 0,
            pk.kernel_for("pt_add", cs).name: 14 * chunks, pk.kernel_for("pt_scalar_mul", cs).name: chunks,
            pk.kernel_for("pt_window_step", cs).name: 0, **encode_launches(cs, chunks)}


def seal_phase(path: Path, c: cer.BatchedCeremony, out: dict, seed: int) -> dict:
    """The dealing round's share encryption on the Straus run's shares and
    hidings: recipient keys and KEM randomness from the path's seeded
    random.Random, as bench.py's seal leg draws them; the KEM's pieces
    timed by CUDA events; seal_shares_pipeline at its default chunk and
    unchunked (equal outputs; the unchunked run, with every launch count
    set to 0 just before and read just after, is the path's seal and must
    launch each of its kernels); then the checks: 64 sampled KEM points
    against the host ladder, the batch DEM's pairs against the per-pair
    leg's on a dealer subset, four recipients' opens against the dealt
    values, a tampered ciphertext, and no plain multiply on the card.
    Returns the seal's launch counts."""
    cs, n, cfg = path.cs, path.n, c.cfg
    fs, group = cs.scalar, gh.ALL_GROUPS[path.curve]
    tag = f"seal {path.curve} n={n}"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = random.Random(f"{seed}-seal-{path.curve}")
    sks = [fs.rand_int(rng) for _ in range(n)]
    r_ints = [[fs.rand_int(rng) for _ in range(n)] for _ in range(n)]
    with PlainMuls() as plain:
        pks = gd.fixed_base_mul(cs, c.g_table, fh.to_tensor(fh.encode(fs, sks), DEV))
        r_enc = fh.to_tensor(fh.encode(fs, r_ints), DEV)
        shares, hidings = out["shares"], out["hidings"]
        sync()
        # the KEM's pieces, each one pass between CUDA events after a warm-up
        # pass (the first pass at these sizes also grows the allocator)
        c1_ms, c1 = cuda_ms(lambda: gd.fixed_base_mul(cs, c.g_table, r_enc), reps=1)
        kem_ms, kem = cuda_ms(lambda: gd.scalar_mul(cs, r_enc, pks), reps=1)
        canon_ms, _ = cuda_ms(lambda: gd.encode_batch_device(cs, kem), reps=1)
        kem_dev = device_ms(lambda: gd.scalar_mul(cs, r_enc, pks), reps=2)
        print(f"{tag}: KEM of {n * n} pairs, CUDA events (ms): c1 = fixed_base_mul {c1_ms:.3f}, "
              f"scalar_mul {kem_ms:.3f} (device {kem_dev:.3f}), encode_batch's device leg {canon_ms:.3f}",
              flush=True)
        sealed, wall = {}, {}
        for chunk in (None, 0):
            for k in KERNELS:
                k.launches = 0
            with HostSeconds((hb, "seal_shares_batch"), (gd, "encode_batch"), (hb, "kdf_batch"),
                             (hb, "chacha20_xor_batch"), (hb, "_host_points")) as host:
                t0 = time.perf_counter()
                sealed[chunk] = hb.seal_shares_pipeline(group, cfg, shares, hidings, pks, r_enc, c.g_table,
                                                        chunk=chunk)
                sync()
                wall[chunk] = time.perf_counter() - t0
            seconds = dict(host.seconds)
            # the rest of seal_shares_batch: the HybridCiphertext objects and byte rows
            seconds["packing"] = seconds.pop("seal_shares_batch") - sum(seconds.values())
            launches = {k.name: k.launches for k in KERNELS if k.launches}
            dealers = max(1, 4096 // n)
            label = "unchunked" if chunk == 0 else f"chunk={dealers} dealers"
            print(f"{tag}: seal_shares_pipeline {label}: wall {wall[chunk]:.6f} s, "
                  f"{n * n / wall[chunk]:.1f} pairs sealed per s; host s " + json.dumps(
                      {k: round(v, 6) for k, v in seconds.items()})
                  + "; launches " + json.dumps(launches), flush=True)
            exact = seal_exact(cs, 1 if chunk == 0 else -(-n // dealers))
            check(all(launches.get(k, 0) == v for k, v in exact.items()),
                  f"{tag} {label}: launch counts {({k: launches.get(k, 0) for k in exact})}, want {exact}")
        for k in seal_kernels(cs):
            check(launches.get(k.name, 0) > 0, f"kernel {k.name} was not launched in the {tag} seal")
        check(len(sealed[0]) == n and all(len(row) == n for row in sealed[0]), f"{tag}: sealed matrix shape")
        check(sealed[None] == sealed[0], f"{tag}: the chunked pipeline's pairs differ from the unchunked one's")

        # 64 sampled KEM points against the host ladder
        pairs = [(rng.randrange(n), rng.randrange(n)) for _ in range(SEAL_SAMPLES)]
        idx = torch.tensor([d * n + i for d, i in pairs], device=DEV)
        got = gd.encode_batch(cs, kem.reshape(n * n, cs.ncoords, -1)[idx])
        gen = group.generator()
        for (d, i), enc in zip(pairs, got):
            want = group.encode(group.scalar_mul(r_ints[d][i], group.scalar_mul(sks[i], gen)))
            check(enc.tobytes() == want, f"{tag}: the KEM point of pair ({d}, {i}) != r·pk")
        # the batch DEM against the per-pair leg on a dealer subset
        m_sc = min(n, max(1, SEAL_SCALAR_PAIRS // n))
        t0 = time.perf_counter()
        scalar = hb.seal_shares(group, cfg, shares[:m_sc], hidings[:m_sc], c1[:m_sc], kem[:m_sc])
        scalar_s = time.perf_counter() - t0
        check(scalar == sealed[0][:m_sc], f"{tag}: the batch DEM's pairs differ from seal_shares' on {m_sc} dealers")
        # four recipients open their columns
        openers = [0, n - 1, *rng.sample(range(1, n - 1), SEAL_OPENERS - 2)]
        dealt_s = fh.decode(fs, fh.from_tensor(shares[:, openers]))
        dealt_h = fh.decode(fs, fh.from_tensor(hidings[:, openers]))
        t0 = time.perf_counter()
        for col, i in enumerate(openers):
            opened = hb.open_shares_batch(group, cfg, sks[i], [sealed[0][d][i] for d in range(n)], device=DEV)
            want = [(int(dealt_s[d, col]), int(dealt_h[d, col])) for d in range(n)]
            check(opened == want, f"{tag}: recipient {i + 1} did not open the dealt shares")
        open_s = time.perf_counter() - t0
        # a tampered ciphertext does not open to the dealt share
        d, i = rng.randrange(n), openers[2]
        share_ct, hiding_ct = sealed[0][d][i]
        bad = hb.HybridCiphertext(share_ct.e1, bytes([share_ct.ciphertext[0] ^ 1]) + share_ct.ciphertext[1:])
        got_s, _ = hb.open_share(group, sks[i], (bad, hiding_ct))
        check(got_s is None or got_s != int(dealt_s[d, 2]), f"{tag}: a tampered ciphertext opened to the share")
        sync()
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    print(f"{tag}: {SEAL_SAMPLES} sampled KEM points equal r·pk on the host; the batch DEM equals seal_shares "
          f"on {m_sc} dealers ({scalar_s:.6f} s, {m_sc * n / scalar_s:.1f} pairs per s); recipients "
          f"{[i + 1 for i in openers]} opened every dealer's share and hiding ({open_s:.6f} s); a tampered "
          f"ciphertext did not; no plain multiply on the card; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# threshold signing over the ceremony's shares
# ---------------------------------------------------------------------------

SIGN_B = 256  # the unproved batch: partial_sign's default message chunk
SIGN_PROVED_B = 4  # the proved grid's messages (a quarter of scripts/sign_bench.py's 16, for the command's time)
SIGN_SAMPLES = (0, 127, 255)  # messages held to secret·H(m) on the host ladder
SIGN_FORGED = {"secp256k1": (3, 100), "ristretto255": (3, 40), "bls12_381_g1": (3, 100)}  # the forged cell


def staged(record: dict, name: str, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after (a device synchronise ends it): its result; ``record[name]`` gets
    (host seconds, {kernel: launches})."""
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = fn()
    sync()
    record[name] = (time.perf_counter() - t0, {k.name: k.launches for k in KERNELS if k.launches})
    return res


def lagrange_launches(fs, m: int) -> int:
    """mod_mul launches of poly.device.lagrange_at_zero_coeffs over m nodes:
    two products of m - 1 steps, a batch inversion (m - 1 forward, 2 (m -
    1) back, and pow_const's Fermat chain of p - 2: a squaring a bit below
    the top and a multiply a set bit below it), and one last product."""
    e = fs.modulus - 2
    return 5 * (m - 1) + (e.bit_length() - 1) + (bin(e).count("1") - 1) + 1


def sign_exact(path: Path, m: int) -> dict:
    """Launch counts the signing stages must read exactly, over m signers:
    public keys one pt_fixed_base; a grid or a folded batch its table's 14
    pt_add and one pt_scalar_mul; prove two of each (the grid, the
    announcements); the aggregate λ_i(0)'s mod_mul, one pt_bucket_sum, one
    pt_bucket_close and a pt_window_step a window; each leaves in one
    canonical affine form (one mod_batch_inv, 2 or 3 mod_mul).
    verify_partials's per-row m = 2 MSM under gd.msm's default: Straus
    (the 14 table adds, a pt_tree_sum and a pt_window_step a window) on
    the Weierstrass curves, Pippenger on ristretto255 (one
    bucket_accumulate, one pt_bucket_close, a pt_window_step a window)."""
    cs = path.cs
    name = {op: pk.kernel_for(op, cs).name for op in ("pt_add", "pt_scalar_mul", "pt_window_step", "pt_fixed_base",
                                                       "pt_madd", "pt_tree_sum")}
    bsum, bclose, bacc = bk.sum_kernel_for(cs).name, bk.close_kernel_for(cs).name, bk.kernel_for(cs).name
    mul = fk.mul_kernel_for(cs.field).name
    canon = canon_launches(cs, "classic", 1)
    grid = {name["pt_add"]: 14, name["pt_scalar_mul"]: 1, name["pt_window_step"]: 0, **canon}
    c = gd.pippenger_window(m, cs.name)
    agg = {bsum: 1, bclose: 1, bacc: 0, name["pt_window_step"]: gd.n_windows(cs, c), **canon}
    agg[mul] += lagrange_launches(cs.scalar, m)
    nw = gd.n_windows(cs, gd.WINDOW)
    if cs.kind == "edwards":
        verify = {bacc: 1, bclose: 1, bsum: 0, name["pt_tree_sum"]: 0, name["pt_window_step"]: nw}
    else:
        verify = {name["pt_add"]: 14, name["pt_tree_sum"]: nw, name["pt_window_step"]: nw, bacc: 0}
    return {"hash": {}, "public keys": {name["pt_fixed_base"]: 1, name["pt_madd"]: 0, **canon}, "partials": grid,
            "aggregate": agg, "folded": grid,
            "prove": {name["pt_add"]: 28, name["pt_scalar_mul"]: 2, name["pt_window_step"]: 0, **canon},
            "verify_partials": verify}


def z_tampered(ps, bi: int, si: int):
    """Cell (bi, si)'s DLEQ response z + 1: the forgery the hash screen lets
    through, for the group check to find."""
    q = gd.ALL_CURVES[ps.curve].scalar.modulus
    m = len(ps.indices)
    proofs = list(ps.proofs)
    cell = proofs[bi * m + si]
    proofs[bi * m + si] = dataclasses.replace(cell, response=(cell.response + 1) % q)
    return dataclasses.replace(ps, proofs=proofs)


def same_element(cs, a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two canonical affine batches hold the same group elements: limb for
    limb on the Weierstrass curves; by encoding on ristretto255, whose
    Edwards representatives may differ by torsion (H(m)'s, times two
    integer scalars equal mod the group order only)."""
    if cs.kind != "edwards":
        return torch.equal(a, b)
    return np.array_equal(gd.encode_batch(cs, a), gd.encode_batch(cs, b))


def sign_schedules(path: Path, psp) -> None:
    """gd.msm's two schedules at the two MSM shapes of the proved grid's
    checks, timed by CUDA events (a warm-up call, then the mean of 3) and
    equal in canonical affine form: verify_partials's per-row (k, 2, m =
    2) MSM and rlc_verify's one (5k + 1)-point MSM."""
    cs, group = path.cs, gh.ALL_GROUPS[path.curve]
    shapes = {"verify_partials": dleq_batch.msm_operands(group, cs, psp.proofs, tsp.verify_statements(psp), DEV)}
    scalars, points = sv._combine(group, sv._cell_rows(psp), random.Random(0))
    shapes["rlc_verify"] = (fh.to_tensor(fh.encode(cs.scalar, scalars), DEV), gd.from_host(cs, points, device=DEV))
    for label, (sc, pts) in shapes.items():
        ms, canon = {}, {}
        for mode in ("straus", "pippenger"):
            ms[mode], res = cuda_ms(lambda: gd.msm(cs, sc, pts, mode), reps=3)
            canon[mode] = gd.affine_canon(cs, res)
        check(torch.equal(canon["straus"], canon["pippenger"]), f"{path.curve} {label}: the MSM schedules disagree")
        print(f"sign {path.curve}: gd.msm at {label}'s shape (scalars {tuple(sc.shape)}), ms (CUDA events, a call) "
              + json.dumps(ms) + f"; equal in canonical affine form; default "
              + ("pippenger" if cs.kind == "edwards" else "straus"), flush=True)


def sign_phase(path: Path, c: cer.BatchedCeremony, out: dict, seed: int) -> dict:
    """Threshold signing on the ceremony's own final shares: quorum Q1 the
    parties 1 .. t + 1, Q2 the last t + 1.  The unproved batch of SIGN_B
    messages (hash, public keys, partials, aggregate with λ_i(0) derived on
    the card, the folded signature), held to the folded signature, to Q2's
    aggregate and, on three messages, to secret·H(m) on the host ladder;
    then the proved grid of SIGN_PROVED_B messages: prove, verify_partials
    and rlc_verify honest (all true, one pass), one forged response (the
    only cell verify_partials rejects, the only one rlc_verify blames
    within its pass bound), and rlc_verify_convoy over it and a second
    honest grid (one pass).  Each stage with every launch count set to 0
    just before and read just after; no plain multiply on the card.
    Returns the stages' launches, summed."""
    cs, n, t = path.cs, path.n, path.t
    group, q = gh.ALL_GROUPS[path.curve], cs.scalar.modulus
    tag = f"sign {path.curve} n={n} t={t}"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    finals = [int(v) for v in fh.decode(cs.scalar, fh.from_tensor(out["final_shares"]))]
    a = fh.decode(cs.scalar, fh.from_tensor(c.coeffs_a))
    secret = sum(int(v) for v in a[:, 0]) % q
    q1, q2 = list(range(1, t + 2)), list(range(n - t, n + 1))
    m = len(q1)
    msgs = [b"chip-smoke sign message %04d" % i for i in range(SIGN_B)]
    rec: dict = {}
    exact = sign_exact(path, m)
    forged_cell = SIGN_FORGED[path.curve]
    with PlainMuls() as plain:
        pts, h_dev = staged(rec, "hash", lambda: ts.hash_to_curve_batch(path.curve, msgs, device=DEV))
        pks = staged(rec, "public keys", lambda: ts.public_keys(path.curve, [finals[i - 1] for i in q1], device=DEV))
        ps = staged(rec, "partials", lambda: ts.partial_sign(path.curve, [finals[i - 1] for i in q1], q1, pts, pks=pks,
                                                             device=DEV))
        agg = staged(rec, "aggregate", lambda: ts.aggregate(ps))
        cache = ts.SignCache()
        mat = cache.ceremony("chip-smoke", 0, path.curve, out["final_shares"])
        folded = staged(rec, "folded", lambda: ts.folded_collect(
            path.curve, [ts.sign_folded(path.curve, cache.fold_limbs(mat, q1), h_dev)]))
        lam_ms, _ = cuda_ms(lambda: pd.lagrange_at_zero_coeffs(cs.scalar, fh.to_tensor(fh.encode(cs.scalar, q1), DEV)),
                            reps=1)
        check(tuple(agg.shape) == (SIGN_B, cs.ncoords, cs.field.limbs), f"{tag}: aggregate shape {tuple(agg.shape)}")
        check(same_element(cs, folded, agg), f"{tag}: sign_folded != the aggregate")
        ps2 = ts.partial_sign(path.curve, [finals[i - 1] for i in q2], q2, pts, device=DEV)
        check(same_element(cs, ts.aggregate(ps2), agg), f"{tag}: Q2's aggregate != Q1's")
        enc = ts.signature_encode(path.curve, agg)
        agg_host = gd.to_host(cs, agg[list(SIGN_SAMPLES)])
        for i, p in zip(SIGN_SAMPLES, agg_host):
            check(enc[i] == group.encode(group.scalar_mul(secret, pts[i])), f"{tag}: signature {i} != secret·H(m)")
            check(enc[i] == group.encode(p), f"{tag}: signature_encode {i} != the group's encoding")
        del ps, ps2

        sub = pts[:SIGN_PROVED_B]
        rng = random.Random(f"{seed}-sign-{path.curve}")
        psp = staged(rec, "prove", lambda: ts.partial_sign(path.curve, [finals[i - 1] for i in q1], q1, sub, rng=rng,
                                                           prove=True, pks=pks, device=DEV))
        ok = staged(rec, "verify_partials", lambda: ts.verify_partials(psp))
        check(ok.shape == (SIGN_PROVED_B, m) and bool(ok.all()), f"{tag}: verify_partials rejected an honest cell")
        honest = staged(rec, "RLC honest", lambda: ts.rlc_verify(psp, rng=rng))
        check(honest.ok and honest.passes == 1 and honest.grid == SIGN_PROVED_B * m, f"{tag}: rlc_verify {honest}")
        forged = z_tampered(psp, *forged_cell)
        bad = ts.verify_partials(forged)
        check(not bad[forged_cell] and int((~bad).sum()) == 1, f"{tag}: verify_partials on the forged grid")
        blame = staged(rec, "RLC blame", lambda: ts.rlc_verify(forged, rng=rng))
        check(blame.bad_cells == (forged_cell,) and blame.passes <= blame.pass_bound(), f"{tag}: rlc_verify {blame}")
        psp2 = ts.partial_sign(path.curve, [finals[i - 1] for i in q2], q2, sub, rng=rng, prove=True, device=DEV)
        convoy = staged(rec, "RLC convoy", lambda: ts.rlc_verify_convoy([psp, psp2], rng=rng))
        check(convoy.ok and convoy.passes == 1 and convoy.grid_ok == (True, True), f"{tag}: convoy {convoy}")
        sync()
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag}: stages (host s) " + json.dumps({k: round(v[0], 6) for k, v in rec.items()})
          + f"; peak device memory {peak_gib:.2f} GiB", flush=True)
    print(f"{tag}: launches " + json.dumps({k: v[1] for k, v in rec.items()}), flush=True)
    for stage, want in exact.items():
        got = rec[stage][1]
        check(all(got.get(k, 0) == v for k, v in want.items()) and (want or not got),
              f"{tag} {stage}: launch counts {got}, want {want}")
    for k in (pk.kernel_for("pt_scalar_mul", cs), pk.kernel_for("pt_fixed_base", cs), bk.sum_kernel_for(cs),
              bk.close_kernel_for(cs), fk.mul_kernel_for(cs.scalar)):
        check(sum(v[1].get(k.name, 0) for v in rec.values()) > 0, f"kernel {k.name} was not launched in the {tag} phase")
    print(f"{tag}: {SIGN_B} messages x {m} signers ({SIGN_B * m} lanes) aggregate = folded = Q2's aggregate; "
          f"messages {list(SIGN_SAMPLES)} = secret·H(m); λ_i(0) on the card {lagrange_launches(cs.scalar, m)} mod_mul "
          f"launches, {lam_ms:.3f} ms (CUDA events); proved grid {SIGN_PROVED_B} x {m}: all verified, rlc_verify one "
          f"pass, forged cell {forged_cell} the only one rejected and blamed in {blame.passes} passes (bound "
          f"{blame.pass_bound()}), convoy one pass; exact counts " + json.dumps(exact)
          + f"; no plain multiply on the card; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    sign_schedules(path, psp)
    totals: dict = {}
    for _, launches in rec.values():
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def tampered(curve: str, seed: int, rlc: str) -> None:
    n, t, dealer, recipient = TAMPER_N, TAMPER_T, 3, 7
    cs = gd.ALL_CURVES[curve]
    fs, group = cs.scalar, gh.ALL_GROUPS[curve]

    def tamper(a, e, s, r):
        s = s.clone()
        s[dealer, recipient] = fd.add(fs, s[dealer, recipient], fd.ones(fs, device=s.device))
        return a, e, s, r

    c = cer.BatchedCeremony(curve, n, t, b"chip-smoke-tamper", random.Random(seed), device=DEV)
    out = c.run(tamper=tamper, rlc=rlc)
    ok = out["ok"].cpu().tolist()
    check(ok == [i != recipient for i in range(n)], f"{curve} tampered batch checks {ok}")
    check(out["complaints"] == [(recipient + 1, dealer + 1)], f"{curve} complaints {out['complaints']}")
    qual = out["qualified"].cpu().tolist()
    check(qual == [j != dealer for j in range(n)], f"{curve} qualified {qual}")
    a = fh.decode(fs, fh.from_tensor(c.coeffs_a))
    secret = sum(int(a[j, 0]) for j in range(n) if j != dealer) % fs.modulus
    gen = gp.base_key_to_point(cs, cs.gen_affine)
    check(group.eq(host_point(cs, out["master"]), group.scalar_mul(secret, gen)),
          f"{curve} tampered ceremony's master key != g·(Σ over the qualified set)")
    print(f"tampered {curve} (n={n}, t={t}, rlc={rlc}): recipient {recipient + 1} failed its batch check, dealer "
          f"{dealer + 1} blamed, master key of the qualified set matches", flush=True)


# ---------------------------------------------------------------------------
# the memory-bounded layer: matmul routes, forced chunks, X1 and X2
# ---------------------------------------------------------------------------

FORCED_CHUNK, FORCED_RLC_CHUNK = 96, 16  # dealers a chunk and RLC columns a chunk of the forced-chunk runs
MATMUL_REPS = 3  # CUDA-event calls of each eval_many / _field_dot route


class IntMmTimer:
    """CUDA events around every int8 product of ``fields.matmul`` (its
    ``_int8_dot``, ``torch._int_mm`` with its zero padding) while the block
    runs: the device ms they took, summed."""

    def __enter__(self):
        self.pairs, self._orig = [], fmm._int8_dot

        def timed(a, b):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(a, b)
            end.record()
            self.pairs.append((start, end))
            return out

        fmm._int8_dot = timed
        return self

    def __exit__(self, *exc):
        fmm._int8_dot = self._orig

    @property
    def ms(self) -> float:
        sync()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def matmul_routes(path: Path, c: cer.BatchedCeremony, out: dict) -> None:
    """eval_many's Vandermonde route (matmul_mod over torch._int_mm) at the
    deal's shape and _field_dot's one-row route at the scalar RLC's, each
    bit-equal to the kernel route (mod_madd_horner, mod_madd_dot) and to the
    run's shares; both routes timed by CUDA events (MATMUL_REPS calls after
    a warm-up), with _int_mm's share of the matmul route."""
    cs, n = path.cs, path.n
    S = cs.scalar
    xs = cer._index_limbs(S, n, DEV)
    coeffs = c.coeffs_a
    horner_ms, horner = cuda_ms(lambda: pd.eval_many(S, coeffs, xs), reps=MATMUL_REPS)
    mm_ms, mm = cuda_ms(lambda: pd.eval_many(S, coeffs, xs, matmul=True), reps=MATMUL_REPS)
    with IntMmTimer() as deal_mm:
        pd.eval_many(S, coeffs, xs, matmul=True)
    check(torch.equal(mm, horner) and torch.equal(horner, out["shares"]),
          f"{path.curve}: eval_many by matmul_mod != mod_madd_horner's shares")
    dot_ms, dot = cuda_ms(lambda: cer._field_dot(S, out["rho"], out["shares"]), reps=MATMUL_REPS)
    dmm_ms, dmm = cuda_ms(lambda: cer._field_dot(S, out["rho"], out["shares"], matmul=True), reps=MATMUL_REPS)
    with IntMmTimer() as dot_mm:
        cer._field_dot(S, out["rho"], out["shares"], matmul=True)
    check(torch.equal(dmm, dot), f"{path.curve}: _field_dot by matmul_mod != mod_madd_dot's")
    print(f"matmul routes {path.curve} n={n} t={path.t}: eval_many bit-equal to mod_madd_horner, {mm_ms:.3f} ms "
          f"by matmul_mod ({deal_mm.ms:.3f} ms of it torch._int_mm, {len(deal_mm.pairs)} calls) against "
          f"{horner_ms:.3f} ms; _field_dot bit-equal to mod_madd_dot, {dmm_ms:.3f} ms by matmul_mod "
          f"({dot_mm.ms:.3f} ms of it torch._int_mm) against {dot_ms:.3f} ms (CUDA events, a call's mean over "
          f"{MATMUL_REPS})", flush=True)


def chunked_run(path: Path, c: cer.BatchedCeremony, out: dict) -> None:
    """The path's ceremony with FORCED_CHUNK dealers a chunk and
    FORCED_RLC_CHUNK RLC columns a chunk: the chunked flow (A never whole,
    bare0 its first column) gives the one-pass run's transcript digest byte
    for byte, and its rho, ok, final shares and master; its launches are
    the chunks' (:func:`flow_launches`)."""
    for k in KERNELS:
        k.launches = 0
    got = c.run(rlc=path.rlc, mul=path.mul, chunk=FORCED_CHUNK, rlc_chunk=FORCED_RLC_CHUNK)
    sync()
    launches = {k.name: k.launches for k in KERNELS}
    check("bare" not in got and torch.equal(got["bare0"], out["bare"][:, 0]), f"{path.tag}: chunked bare0")
    check(got["transcript"] == out["transcript"], f"{path.tag}: the chunked digest differs from the one-pass one")
    for k in ("rho", "ok", "qualified", "final_shares", "master", "randomized", "shares", "hidings"):
        check(torch.equal(got[k], out[k]), f"{path.tag}: chunked output {k} differs from the one-pass run's")
    want = flow_launches(path, got["chunks"])
    check(all(launches[k] == v for k, v in want.items()),
          f"{path.tag} chunked: launches {({k: launches[k] for k in want})}, want {want}")
    print(f"chunked run {path.tag}: chunks {json.dumps(got['chunks'])}, digest, rho, ok, final shares and master "
          f"equal to the one-pass run's; launches " + json.dumps(want) + "; phases "
          + json.dumps({k: round(v, 6) for k, v in got["phase_seconds"].items()}), flush=True)


def tree_passes(m: int) -> int:
    """pt_tree_sum's launches for a tree over m points: one while a column
    fits a block's 2**TREE_CHUNK_LOG leaves, then one more a level of
    chunk tops (point_kernels.tree_sum_passes)."""
    chunks = ((m - 1) >> pk.tree_levels(m, pk.TREE_CHUNK_LOG)) + 1
    return 1 if chunks == 1 else 1 + tree_passes(chunks)


def flow_launches(path: Path, chunks: dict) -> dict:
    """Launch counts of run() under ``chunks`` (its resolved dealer chunks,
    0 for one pass, and the RLC's column chunk): each commitments chunk two
    pt_fixed_base and one pt_add (E = A + h·b), with A's canonical form (one
    batch inversion, its coordinates' mod_mul) when A is never whole; each
    shares chunk two mod_madd_horner; each digest chunk E's canonical form
    (and A's when A is whole); each RLC column chunk one pt_bucket_sum, one
    pt_bucket_close and its window steps (Straus: its table adds, a tree
    sum and a window step a window); then as one pass: two pt_fixed_base,
    one pt_add and four mod_mul (the left side, gd.eq), three mod_madd_dot,
    one pt_ladder_horner, the master key's tree sum (one launch up to 1024
    dealers, :func:`tree_passes`)."""
    cs, n, t = path.cs, path.n, path.t

    def count(chunk, total):
        return 1 if not chunk or chunk >= total else -(-total // chunk)

    kc, ks, kd = count(chunks["deal"], n), count(chunks["shares"], n), count(chunks["digest"], n)
    kr = count(chunks["rlc"], t + 1)
    master = tree_passes(n)  # the master key's tree over n points
    a_whole = kc == 1
    canon = canon_launches(cs, path.mul, kd * (2 if a_whole else 1) + (0 if a_whole else kc))
    mul = fk.mul_kernel_for(cs.field).name
    canon[mul] = canon.get(mul, 0) + 4
    buckets = {bk.kernel_for(cs).name: 0, bk.sum_kernel_for(cs).name: 0, bk.close_kernel_for(cs).name: 0}
    if path.rlc == "straus":
        nd = -(-RHO_BITS // gd.WINDOW)
        trees, adds, steps = kr * nd * tree_passes(n) + master, kr * 14 + kc + 1, kr * nd
    else:
        trees, adds, steps = master, kc + 1, kr * -(-RHO_BITS // gd.pippenger_window(n, cs.name))
        buckets.update({bk.sum_kernel_for(cs).name: kr, bk.close_kernel_for(cs).name: kr})
    return {**buckets, pk.kernel_for("pt_ladder_horner", cs).name: 1, fk.horner_kernel_for(cs.scalar).name: 2 * ks,
            fk.dot_kernel_for(cs.scalar).name: 3, pk.kernel_for("pt_ladder_mul_add", cs).name: 0,
            fk._FIELDS[cs.scalar][0].name: 0, pk.kernel_for("pt_fixed_base", cs).name: 2 * kc + 2,
            pk.kernel_for("pt_madd", cs).name: 0, pk.kernel_for("pt_tree_sum", cs).name: trees,
            pk.kernel_for("pt_add", cs).name: adds, pk.kernel_for("pt_window_step", cs).name: steps, **canon}


# X1: BASELINE.md config 4 (the north-star ceremony of BASELINE.json) on
# one card; X2: config 5, the threshold-BLS committee, at its own size.
X1 = Path("secp256k1", 4096, 1365, b"chip-smoke-x1", SECP.kernels, rlc="pippenger").pippenger()
X2 = Path("bls12_381_g1", 16384, 5461, b"chip-smoke-x2", BLS.kernels, rlc="pippenger").pippenger()
X_TAMPER = {"secp256k1": (5, 777), "bls12_381_g1": (5, 9001)}  # (dealer, recipient) of the tampered share
X1_COMMITMENTS = ((0, 0), (4095, 1365))  # bare commitments A[j, l] of X1's one-pass run held to g·a on the host
X2_DEALERS, X2_RECIPIENTS = (0, 1, 8191, 16383), (1, 2, 8192, 16384)  # shares held to the host Horner
X2_ROUTE_DEALERS, X2_ROUTE_POINTS = 64, 1024  # the block on which X2's two eval_many routes are timed
X2_COMMITMENTS = ((0, 0), (0, 5461), (1, 1), (4096, 17), (8191, 2730), (12000, 4000), (16383, 0), (16383, 5461))


def card_coeffs(fs, n: int, t: int, gen: torch.Generator) -> torch.Tensor:
    """(n, t+1, L) int32 limbs made on the card from a seeded generator,
    each element below the order (its top limb below the order's)."""
    limbs = torch.randint(0, 1 << 16, (n, t + 1, fs.limbs), generator=gen, device=DEV, dtype=torch.int32)
    limbs[..., -1] %= fs.modulus >> (16 * (fs.limbs - 1))
    return limbs


def scale_run(path: Path, c: cer.BatchedCeremony, label: str, **kw) -> tuple[dict, dict, float]:
    """c.run(rlc="pippenger", **kw) with every launch count set to 0 just
    before and read just after; each kernel of the path must launch, and
    exactly as its chunks say (:func:`flow_launches`).  Returns the
    outputs, the launches and the peak device GiB."""
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with PlainMuls() as plain:
        out = c.run(rlc="pippenger", **kw)
        sync()
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tag = f"{path.curve} n={path.n} t={path.t} {label}"
    check(plain.count == 0, f"{tag}: {plain.count} plain field multiplies reached a CUDA tensor")
    for k in path.kernels:
        check(launches[k.name] > 0, f"kernel {k.name} was not launched on the {tag} run")
    want = flow_launches(path, out["chunks"])
    check(all(launches[k] == v for k, v in want.items()),
          f"{tag}: launches {({k: launches[k] for k in want})}, want {want}")
    check(bool(out["ok"].all()) and out["complaints"] == [], f"{tag}: a batch check failed")
    print(f"scale {tag}: chunks {json.dumps(out['chunks'])}, phases "
          + json.dumps({k: round(v, 6) for k, v in out["phase_seconds"].items()})
          + f", peak device memory {peak:.2f} GiB; launches " + json.dumps(want), flush=True)
    return out, launches, peak


def tampered_verify(path: Path, c: cer.BatchedCeremony, out: dict) -> float:
    """One share s[j0, i0] + 1, in place: verify_batch with the run's rho
    fails at recipient i0 alone; the share is put back.  Returns its host
    seconds."""
    j0, i0 = X_TAMPER[path.curve]
    fs, s = path.cs.scalar, out["shares"]
    orig = s[j0, i0].clone()
    bumped = (int(fh.decode(fs, fh.from_tensor(orig))) + 1) % fs.modulus
    s[j0, i0] = fh.to_tensor(fh.encode(fs, bumped), DEV)
    t0 = time.perf_counter()
    ok = cer.verify_batch(c.cfg, out["randomized"], s, out["hidings"], out["rho"], RHO_BITS, c.g_table, c.h_table,
                          "pippenger").cpu()
    seconds = time.perf_counter() - t0
    s[j0, i0] = orig
    check(not bool(ok[i0]) and int(ok.sum()) == path.n - 1,
          f"{path.curve} n={path.n}: a tampered share s[{j0}, {i0}] failed {(~ok).nonzero().flatten().tolist()}")
    print(f"scale {path.curve} n={path.n}: s[{j0}, {i0}] + 1 fails recipient {i0 + 1}'s batch check alone "
          f"({seconds:.3f} s, host clock)", flush=True)
    return seconds


def x1_phase(seed: int, card: str) -> dict:
    """X1: secp256k1 n = 4096, t = 1365 on card-made coefficients, in one
    pass (chunk=0) and in the default chunked flow: rho, ok (all true),
    final shares, master and the transcript digest identical; the master
    and two bare commitments A[j, l] against the host; then the tampered
    share."""
    t_phase = time.perf_counter()
    path = X1
    cs, n, t = path.cs, path.n, path.t
    gen = torch.Generator(device=DEV).manual_seed(seed + 4096)
    coeffs = [card_coeffs(cs.scalar, n, t, gen) for _ in range(2)]
    c = cer.BatchedCeremony.from_arrays(path.curve, n, t, path.shared, *coeffs, device=DEV)
    one, launches, _ = scale_run(path, c, "one pass", chunk=0)
    chunked, _, _ = scale_run(path, c, "default chunks")
    check(one["chunks"]["deal"] == 0 and 0 < chunked["chunks"]["deal"] < n, f"X1 chunks {chunked['chunks']}")
    check(chunked["transcript"] == one["transcript"], "X1: the chunked digest differs from the one-pass digest")
    for k in ("rho", "ok", "final_shares", "master", "randomized", "shares", "hidings"):
        check(torch.equal(chunked[k], one[k]), f"X1: {k} differs between the one-pass and the chunked flow")
    check("bare" not in chunked and torch.equal(chunked["bare0"], one["bare"][:, 0]), "X1: bare0")
    group, q = gh.ALL_GROUPS[path.curve], cs.scalar.modulus
    gen_pt = gp.base_key_to_point(cs, cs.gen_affine)
    a0 = fh.decode(cs.scalar, fh.from_tensor(c.coeffs_a[:, 0]))
    check(group.eq(host_point(cs, one["master"]), group.scalar_mul(sum(int(v) for v in a0) % q, gen_pt)),
          "X1: master key != g·(Σ_j a_j0)")
    for (j, l), a_jl in zip(X1_COMMITMENTS, fh.decode(cs.scalar, fh.from_tensor(
            c.coeffs_a[[j for j, _ in X1_COMMITMENTS], [l for _, l in X1_COMMITMENTS]]))):
        check(group.eq(host_point(cs, one["bare"][j, l]), group.scalar_mul(int(a_jl), gen_pt)),
              f"X1: bare commitment A[{j}, {l}] != g·a")
    del chunked
    tampered_verify(path, c, one)
    print(f"X1 {path.curve} n={n} t={t}: the one-pass and the chunked flow identical (digest, rho, ok, final "
          f"shares, master); the master and A{list(X1_COMMITMENTS)} match the host; "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launches


def x2_phase(seed: int, card: str) -> dict:
    """X2: BLS12-381 G1 n = 16384, t = 5461 (BASELINE.md config 5) in the
    default chunked flow, Pippenger RLC, device digest: ok for all, the
    master key, 4 x 4 shares and hidings, bare0 and 8 commitments E[j, l]
    against host big ints; the tampered share; peak memory."""
    t_phase = time.perf_counter()
    path = X2
    cs, n, t = path.cs, path.n, path.t
    fs, q = cs.scalar, cs.scalar.modulus
    group = gh.ALL_GROUPS[path.curve]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed + 16384)
    coeffs = [card_coeffs(fs, n, t, gen) for _ in range(2)]
    # what the host checks read, copied before the run
    a_rows = [fh.decode(fs, fh.from_tensor(x[list(X2_DEALERS)])) for x in coeffs]
    a_col0 = fh.decode(fs, fh.from_tensor(coeffs[0][:, 0]))
    sampled = [(int(fh.decode(fs, fh.from_tensor(coeffs[0][j, l]))), int(fh.decode(fs, fh.from_tensor(coeffs[1][j, l]))))
               for j, l in X2_COMMITMENTS]
    c = cer.BatchedCeremony.from_arrays(path.curve, n, t, path.shared, *coeffs, device=DEV)
    del coeffs
    out, launches, peak = scale_run(path, c, "default chunks", digest="device")
    check(out["chunks"]["deal"] and out["chunks"]["deal"] < n and "bare" not in out, f"X2 chunks {out['chunks']}")
    t0 = time.perf_counter()
    gen_pt = gp.base_key_to_point(cs, cs.gen_affine)
    check(group.eq(host_point(cs, out["master"]), group.scalar_mul(sum(int(v) for v in a_col0) % q, gen_pt)),
          "X2: master key != g·(Σ_j a_j0)")
    for k, key in enumerate(("shares", "hidings")):
        got = fh.decode(fs, fh.from_tensor(out[key][list(X2_DEALERS)][:, [i - 1 for i in X2_RECIPIENTS]]))
        for a, j in enumerate(X2_DEALERS):
            for b, i in enumerate(X2_RECIPIENTS):
                check(int(got[a, b]) == eval_host(q, a_rows[k][a], i), f"X2: {key}[{j}, {i - 1}] != f_{j}({i})")
    h = c.ck.h
    for (j, l), (av, bv) in zip(X2_COMMITMENTS, sampled):
        want = group.add(group.scalar_mul(av, gen_pt), group.scalar_mul(bv, h))
        check(group.eq(host_point(cs, out["randomized"][j, l]), want), f"X2: E[{j}, {l}] != g·a + h·b")
        if l == 0:
            check(group.eq(host_point(cs, out["bare0"][j]), group.scalar_mul(av, gen_pt)), f"X2: bare0[{j}] != g·a")
    host_s = time.perf_counter() - t0
    tampered_verify(path, c, out)
    # the deal's two routes at X2's T on its first X2_ROUTE_DEALERS dealers
    # and X2_ROUTE_POINTS recipients (one of eval_many's Vandermonde chunks)
    d, p_ = X2_ROUTE_DEALERS, X2_ROUTE_POINTS
    xs, rows = cer._index_limbs(fs, p_, DEV), c.coeffs_a[:d]
    horner_ms, horner = cuda_ms(lambda: pd.eval_many(fs, rows, xs), reps=1)
    mm_ms, mm = cuda_ms(lambda: pd.eval_many(fs, rows, xs, matmul=True), reps=1)
    check(torch.equal(mm, horner) and torch.equal(horner, out["shares"][:d, :p_]),
          "X2: eval_many by matmul_mod != mod_madd_horner's shares")
    print(f"X2 deal routes on {d} dealers x {p_} points, T = {t + 1}: mod_madd_horner {horner_ms:.3f} ms, "
          f"matmul_mod {mm_ms:.3f} ms (CUDA events, one call after a warm-up call), bit-equal", flush=True)
    del horner, mm
    free, total = torch.cuda.mem_get_info()
    print(f"X2 {path.curve} n={n} t={t}: ok for all {n}; master key, {len(X2_DEALERS)} x {len(X2_RECIPIENTS)} shares "
          f"and hidings, {len(X2_COMMITMENTS)} commitments E[j, l] and bare0 match the host ({host_s:.1f} s); peak "
          f"device memory {peak:.2f} GiB of mem_get_info's total {total / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    del out, c
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the committee wire protocol: batched rounds 1-2, the court, phases 1-5
# ---------------------------------------------------------------------------

W1_N, W1_T = 256, 85  # BASELINE.md config 2 (the ristretto255 path's committee), STORM.json's committee
W1_LOCAL = 256  # parties verified on this host: all of them (64 would be the sharded deployment's cut)
W1_FLIPPED, W1_FLIPPED_TO = 7, (1, 100, 200)  # a flipped ciphertext byte to three recipients
W1_CHEAT, W1_CHEAT_TO = 40, (2, 256)  # shares inconsistent with the commitments, to two recipients
W1_SILENT = 150  # a dealer that goes silent
W1_SAMPLES = 64  # dealt shares held to the host Horner
W1_PLAIN_ROWS = 4  # lanes of the KEM recovery and the re-check held against their plain versions
W2_N, W2_T = 1024, 341  # scripts/storm_bench.py's default shape: t genuine complaints and one false
W2_SERIAL = 16  # leading genuine triples the serial court re-adjudicates (with the false one)
W3_N, W3_T = 8, 3  # the whole protocol, phases 1-5, on each curve
W3_CHEAT, W3_CHEAT_TO, W3_BARE_LIAR = 3, (1, 6), 5


def committee_kernels(cs) -> tuple:
    """The kernels batched_dealing and batched_share_verification launch on
    a curve: the deal's commitments and share matrix, the seal's KEM and its
    encoding, the KEM recovery, its encoding and the commitment re-check
    (the encodings' batch inversion on Weierstrass only)."""
    return (pk.kernel_for("pt_fixed_base", cs), pk.kernel_for("pt_add", cs), pk.kernel_for("pt_scalar_mul", cs),
            pk.kernel_for("pt_ladder_horner", cs), fk.horner_kernel_for(cs.scalar), fk.mul_kernel_for(cs.field),
            *seal_kernels(cs)[3:-1])


def plain_scalar_mul(cs, k: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """gd.scalar_mul's plain version: each lane's 16-entry table by plain
    adds, its windows by pt_scalar_mul_plain."""
    entries = [pk.identity_plain(cs, p.shape[:-2], p.device), p]
    for _ in range(14):
        entries.append(pk.pt_add_plain(cs, entries[-1], p))
    return pk.pt_scalar_mul_plain(cs, torch.stack(entries, dim=-3), k)


def dealing_exact(cs, chunks: int) -> dict:
    """Launch counts batched_dealing (and, at one chunk, one
    epoch.dealing.deal_epoch_poly) must read: ceremony.deal's two
    fixed_base_mul (one pt_fixed_base each), E = A + B (one pt_add) and
    two eval_many (one mod_madd_horner each), then the seal in ``chunks``
    chunks (:func:`seal_exact`)."""
    want = seal_exact(cs, chunks)
    fixed, add = pk.kernel_for("pt_fixed_base", cs).name, pk.kernel_for("pt_add", cs).name
    want[fixed] += 2
    want[add] += 1
    want[fk.horner_kernel_for(cs.scalar).name] = 2
    want[pk.kernel_for("pt_ladder_mul_add", cs).name] = 0
    return want


def verification_exact(cs) -> dict:
    """Launch counts batched_share_verification must read: the KEM recovery
    one scalar_mul (14 pt_add for the per-lane tables, one pt_scalar_mul)
    and one encoding (:func:`encode_launches`); the re-check two pt_fixed_base, one
    pt_add, one pt_ladder_horner and gd.eq's four mod_mul."""
    want = encode_launches(cs, 1)
    want[fk.mul_kernel_for(cs.field).name] += 4
    return {**want, pk.kernel_for("pt_add", cs).name: 15, pk.kernel_for("pt_scalar_mul", cs).name: 1,
            pk.kernel_for("pt_window_step", cs).name: 0, pk.kernel_for("pt_fixed_base", cs).name: 2,
            pk.kernel_for("pt_madd", cs).name: 0, pk.kernel_for("pt_ladder_horner", cs).name: 1,
            pk.kernel_for("pt_ladder_mul_add", cs).name: 0}


def court_exact(cs) -> dict:
    """Launch counts adjudicate_round1_batch must read on ristretto255:
    dleq_batch.verify_batch's per-row m = 2 MSM under gd.msm's default
    there, Pippenger (one bucket_accumulate, one pt_bucket_close, a
    pt_window_step a window); the re-check two pt_fixed_base and one
    pt_ladder_horner."""
    return {bk.kernel_for(cs).name: 1, bk.close_kernel_for(cs).name: 1, bk.sum_kernel_for(cs).name: 0,
            pk.kernel_for("pt_window_step", cs).name: gd.n_windows(cs, gd.WINDOW),
            pk.kernel_for("pt_fixed_base", cs).name: 2, pk.kernel_for("pt_ladder_horner", cs).name: 1}


def warm_tables(cs, env) -> None:
    """Acquire the environment's g and h tables before the stages whose
    launches are held exactly: a table missing from the caches is built on
    the card (one pt_ladder_mul_add and one canonical affine form, which
    the main paths count), not part of a stage's own work."""
    gp.generator_table(cs, device=DEV)
    gp.base_table(cs, env.commitment_key.h, device=DEV)


def held_launches(tag: str, got: dict, want: dict) -> None:
    check(all(got.get(k, 0) == v for k, v in want.items()), f"{tag}: launch counts "
          f"{({k: got.get(k, 0) for k in want})}, want {want}")


def cheating_broadcast(group, pks, victims, b: bc.BroadcastPhase1, rng) -> bc.BroadcastPhase1:
    """``b`` with random but decodable shares sealed to the victims under
    the dealer's own commitments (tests/test_committee_batch.py's
    ``_cheating_broadcast``)."""
    fs = group.scalar_field
    enc = list(b.encrypted_shares)
    for v in victims:
        share_ct, rand_ct = seal_pair(group, pks[v - 1].point, int(fs.rand_int(rng)).to_bytes(fs.nbytes, "little"),
                                      int(fs.rand_int(rng)).to_bytes(fs.nbytes, "little"), rng)
        enc[v - 1] = bc.EncryptedShares(v, share_ct, rand_ct)
    return bc.BroadcastPhase1(b.committed_coefficients, tuple(enc))


def complaints_of(result) -> list:
    """(accused, kind) of a round-2 result's complaints, in order."""
    b = result[1]
    return [] if b is None else [(m.accused_index, m.error) for m in b.misbehaving_parties]


def dealt_matrix(cs, cfg, state, t: int, m: int) -> tuple:
    """The (m, n) share and hiding ints batched_dealing dealt from
    ``rng`` state ``state``: its coefficient draws replayed, the matrix by
    ceremony.deal_shares on the card."""
    rng = random.Random()
    rng.setstate(state)
    fs = cs.scalar
    a = [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(m)]
    b = [[fs.rand_int(rng) for _ in range(t + 1)] for _ in range(m)]
    s, r = cer.deal_shares(cfg, fh.to_tensor(fh.encode(fs, a), DEV), fh.to_tensor(fh.encode(fs, b), DEV))
    return a, fh.decode(fs, fh.from_tensor(s)), fh.decode(fs, fh.from_tensor(r))


def rounds_1_2(card: str, seed: int) -> dict:
    """W1: ristretto255 at n = 256, t = 85.  batched_dealing deals for every
    member (65,536 pairs sealed); dealer W1_FLIPPED's share ciphertexts to
    three recipients get a flipped byte, dealer W1_CHEAT seals shares
    inconsistent with its commitments to two, dealer W1_SILENT goes
    silent; batched_share_verification then runs for the W1_LOCAL parties
    (all 255 other dealers each).  Exactly the tampered pairs complain,
    each with the kind the serial DkgPhase1.proceed gives on a deep copy of
    the party's phase (fetched: the tampered dealer), and the batch court
    upholds each; the silent dealer is disqualified by every party, every
    other pair's received share equals the dealt matrix's entry (which
    itself equals the host Horner on W1_SAMPLES pairs).  Returns the
    stages' launches, summed."""
    group, cs = gh.RISTRETTO255, gd.RISTRETTO255
    n, t = W1_N, W1_T
    tag = f"committee W1 ristretto255 n={n} t={t}"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = random.Random(f"{seed}-committee-w1")
    env = cm.Environment.init(group, t, n, b"chip-smoke-committee")
    warm_tables(cs, env)
    keys, pks, sorted_keys = committee_keys(group, n, rng)
    trace = CeremonyTrace(meta={"n": n, "t": t})
    rec: dict = {}
    before_deal = rng.getstate()
    with PlainMuls() as plain:
        dealt = staged(rec, "dealing", lambda: cmb.batched_dealing(env, rng, keys, trace=trace, device=DEV))
        broadcasts = [b for _, b in dealt]
        broadcasts[W1_FLIPPED - 1] = flip_byte(broadcasts[W1_FLIPPED - 1], W1_FLIPPED_TO)
        broadcasts[W1_CHEAT - 1] = cheating_broadcast(group, pks, W1_CHEAT_TO, broadcasts[W1_CHEAT - 1], rng)
        broadcasts[W1_SILENT - 1] = None
        fetched = [cm.FetchedPhase1.from_broadcast(env, j + 1, broadcasts[j]) for j in range(n)]
        local = [p for p, _ in dealt[:W1_LOCAL]]
        tampered = {(v, W1_FLIPPED) for v in W1_FLIPPED_TO} | {(v, W1_CHEAT) for v in W1_CHEAT_TO}
        serial = {(v, j): copy.deepcopy(local[v - 1]) for v, j in tampered if v <= W1_LOCAL}
        results = staged(rec, "verification", lambda: cmb.batched_share_verification(
            local, fetched, random.Random(f"{seed}-w1-proofs"), device=DEV, trace=trace))
        # the KEM recovery's scalar_mul and the re-check's Horner, alone at their
        # shapes, each output kept at W1_PLAIN_ROWS lanes spread over the
        # parties (x from 1 to n) and dealers, with those lanes' inputs, on the
        # host: the plain versions' small ops run faster there than as launches
        lanes = [(p._state.index, j) for p in local for j in range(1, n + 1)
                 if j != p._state.index and broadcasts[j - 1] is not None]
        rows = torch.linspace(0, len(lanes) - 1, W1_PLAIN_ROWS, device=DEV).long()
        nbits = max(2, n.bit_length())
        sk_limbs = fh.to_tensor(fh.encode(cs.scalar, [sorted_keys[i - 1].sk for i, _ in lanes]), DEV)
        e1 = gd.from_host(cs, [broadcasts[j - 1].shares_for(i).share_ct.e1 for i, j in lanes], device=DEV)
        kem_ms = device_ms(lambda: gd.scalar_mul(cs, sk_limbs, e1), reps=1)
        kem_got = gd.scalar_mul(cs, sk_limbs, e1).index_select(0, rows).cpu()
        kem_in = (sk_limbs.index_select(0, rows).cpu(), e1.index_select(0, rows).cpu())
        del sk_limbs, e1
        dealers = sorted({j for _, j in lanes})
        comm = gd.from_host(cs, [c for j in dealers for c in broadcasts[j - 1].committed_coefficients],
                            device=DEV).reshape(len(dealers), t + 1, cs.ncoords, cs.field.limbs)
        row = {j: r for r, j in enumerate(dealers)}
        cpts = comm.index_select(0, torch.tensor([row[j] for _, j in lanes], device=DEV))
        xs = torch.tensor([i for i, _ in lanes], dtype=torch.int32, device=DEV)
        horner_ms = device_ms(lambda: gd.eval_point_poly(cs, cpts, xs, nbits), reps=1)
        horner_got = gd.eval_point_poly(cs, cpts, xs, nbits).index_select(0, rows).cpu()
        horner_in = (cpts.index_select(0, rows).cpu(), xs.index_select(0, rows).cpu())
        del cpts, comm
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        sync()
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    # both launches at the path's shapes against their plain versions on those lanes, exact
    t0 = time.perf_counter()
    held(f"{tag} KEM recovery scalar_mul ({len(lanes)} lanes)", kem_got, plain_scalar_mul(cs, *kem_in))
    kem_plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    held(f"{tag} re-check pt_ladder_horner ({len(lanes)} lanes)", horner_got,
         pk.pt_ladder_horner_plain(cs, *horner_in, nbits))
    horner_plain_s = time.perf_counter() - t0
    held_launches(f"{tag} dealing", rec["dealing"][1], dealing_exact(cs, -(-n // max(1, 4096 // n))))
    held_launches(f"{tag} verification", rec["verification"][1], verification_exact(cs))

    # exactly the tampered pairs complain, each with the serial kind
    got = {}
    for p, res in zip(local, results):
        check(isinstance(res[0], cm.DkgPhase2), f"{tag}: party {p._state.index} got {res[0]}")
        for j, kind in complaints_of(res):
            got[(p._state.index, j)] = kind
    want_pairs = {x for x in tampered if x[0] <= W1_LOCAL}
    check(set(got) == want_pairs, f"{tag}: complaints at {sorted(got)}, want {sorted(want_pairs)}")
    for (v, j), phase in serial.items():
        s_res = phase.proceed([fetched[j - 1]], random.Random(0))
        check(complaints_of(s_res) == [(j, got[(v, j)])], f"{tag}: party {v} on dealer {j}: batched kind "
              f"{got[(v, j)]}, serial {complaints_of(s_res)}")
        if j == W1_CHEAT:
            check(got[(v, j)] == DkgErrorKind.SHARE_VALIDITY_FAILED, f"{tag}: the cheat's kind {got[(v, j)]}")
    triples = [(p._state.index, pks[p._state.index - 1], m) for p, res in zip(local, results)
               if res[1] is not None for m in res[1].misbehaving_parties]
    verdicts = court.adjudicate_round1_batch(group, cs, env.commitment_key, triples,
                                                {j + 1: broadcasts[j] for j in range(n)}, device=DEV)
    check(verdicts == [True] * len(triples), f"{tag}: the court's verdicts on the complaints {verdicts}")

    # the silent dealer is out everywhere; every other pair holds the dealt share
    coeffs, dealt_s, dealt_h = dealt_matrix(cs, cer.CeremonyConfig("ristretto255", n, t), before_deal, t, n)
    smp = random.Random(seed)
    for _ in range(W1_SAMPLES):
        j, i = smp.randrange(n), smp.randrange(n)
        check(int(dealt_s[j, i]) == eval_host(cs.scalar.modulus, coeffs[j], i + 1), f"{tag}: dealt s[{j}, {i}]")
    for p in local:
        st = p._state
        i = st.index
        check(st.qualified[W1_SILENT - 1] == 0 or i == W1_SILENT, f"{tag}: party {i} kept the silent dealer")
        for j in range(1, n + 1):
            if j == W1_SILENT and i != j:
                check(j not in st.received_shares, f"{tag}: party {i} holds a share of the silent dealer")
                continue
            if (i, j) in tampered:
                check(j not in st.received_shares and st.qualified[j - 1] == 0, f"{tag}: party {i} kept {j}")
                continue
            check(st.received_shares.get(j) == (int(dealt_s[j - 1, i - 1]), int(dealt_h[j - 1, i - 1])),
                  f"{tag}: party {i}'s share from dealer {j} != the dealt matrix's")
    stages = {"deal": trace.timings_s["deal"], "seal": trace.timings_s["seal"],
              **{f"verify {k}": v for k, v in trace.subtimings_s["verify"].items()}}
    print(f"{tag} ({card}): stages (host s) " + json.dumps({k: round(v, 6) for k, v in stages.items()})
          + f"; dealing {rec['dealing'][0]:.6f} s, verification {rec['verification'][0]:.6f} s for {len(local)} "
          f"parties ({len(lanes)} pairs); KEM recovery scalar_mul {kem_ms:.3f} device ms ({len(lanes)} lanes, a table "
          f"a lane); re-check pt_ladder_horner {horner_ms:.3f} device ms ({len(lanes)} x {t + 1} per-lane "
          f"coefficients); both exact against their plain versions on plain_rows = {W1_PLAIN_ROWS} of those lanes "
          f"(x = {horner_in[1].tolist()}; on the host, plain scalar_mul {kem_plain_s:.3f} s, plain "
          f"pt_ladder_horner {horner_plain_s:.3f} s); peak device memory {peak_gib:.2f} GiB", flush=True)
    print(f"{tag}: launches " + json.dumps({k: v[1] for k, v in rec.items()}), flush=True)
    print(f"{tag}: complaints exactly at the tampered pairs " + json.dumps(
        {f"{v}<-{j}": got[(v, j)].name for v, j in sorted(got)}) + ", the serial kinds, all upheld by the batch "
          f"court; dealer {W1_SILENT} disqualified by every party; every other pair holds the dealt share; no plain "
          f"multiply on the card; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rec, stages


def storm(card: str, seed: int) -> dict:
    """W2: the complaint court under a storm at n = 1024, t = 341
    (scripts/storm_bench.py's default shape): t genuine complaints and one
    false, adjudicated by adjudicate_round1_batch (a warm-up call, then the
    timed one); verdicts [True] * t + [False], and the serial court agrees
    on the first W2_SERIAL triples and the false one."""
    group, cs = gh.RISTRETTO255, gd.RISTRETTO255
    n, t = W2_N, W2_T
    tag = f"committee W2 storm ristretto255 n={n} t={t}"
    rng = random.Random(f"{seed}-committee-w2")
    env = cm.Environment.init(group, t, n, b"chip-smoke-storm")
    t0 = time.perf_counter()
    keys, pks, sorted_keys = committee_keys(group, n, rng)
    keys_s = time.perf_counter() - t0
    rec: dict = {}
    with PlainMuls() as plain:
        t0 = time.perf_counter()
        tampered, triples = build_storm(env, keys, pks, sorted_keys, rng, t, device=DEV)
        build_s = time.perf_counter() - t0
        by_sender = {1: tampered}
        court.adjudicate_round1_batch(group, cs, env.commitment_key, triples, by_sender, device=DEV)
        timings: dict = {}
        verdicts = staged(rec, "court", lambda: court.adjudicate_round1_batch(
            group, cs, env.commitment_key, triples, by_sender, timings, device=DEV))
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    held_launches(f"{tag} court", rec["court"][1], court_exact(cs))
    check(verdicts == [True] * t + [False], f"{tag}: verdicts {verdicts.count(True)} upheld, last {verdicts[-1]}")
    sub = triples[:W2_SERIAL] + triples[-1:]
    t0 = time.perf_counter()
    serial = court.adjudicate_round1_serial(group, env.commitment_key, sub, by_sender)
    serial_s = time.perf_counter() - t0
    check(serial == verdicts[:W2_SERIAL] + verdicts[-1:], f"{tag}: the serial court's verdicts {serial}")
    court_s = rec["court"][0]
    print(f"{tag} ({card}): {len(triples)} complaints adjudicated in {court_s:.6f} s, "
          f"{len(triples) / court_s:.2f} complaints per s (the JAX package's STORM.json, a CPU run at n = 256, "
          f"t = 85: 1.5 per s batched, 37.75 serial); stages (host s) "
          + json.dumps({k: round(v, 6) for k, v in timings.items()})
          + f"; keys {keys_s:.3f} s, deal and {len(triples)} proofs {build_s:.3f} s; the serial court on "
          f"{len(sub)} triples {serial_s:.3f} s ({len(sub) / serial_s:.2f} per s), the same verdicts; launches "
          + json.dumps(rec["court"][1]), flush=True)
    return rec


def whole_protocol(curve: str, card: str, seed: int) -> dict:
    """W3: phases 1-5 at n = 8, t = 3 on ``curve``: batched_dealing,
    batched_share_verification with dealer W3_CHEAT cheating two parties,
    DkgPhase2.proceed (the complaints upheld, the cheat disqualified by
    everyone), DkgPhase3 with dealer W3_BARE_LIAR publishing wrong bare
    commitments (every other party's round-4 complaint upheld), its secret
    reconstructed from disclosed shares in DkgPhase5.finalise.  Every
    honest party's master key is equal and reproduced by the secret
    interpolated from t + 1 final shares on the host."""
    group, cs = gh.ALL_GROUPS[curve], gd.ALL_CURVES[curve]
    n, t = W3_N, W3_T
    tag = f"committee W3 {curve} n={n} t={t}"
    rng = random.Random(f"{seed}-committee-w3-{curve}")
    env = cm.Environment.init(group, t, n, b"chip-smoke-w3")
    warm_tables(cs, env)
    keys, pks, _ = committee_keys(group, n, rng)
    rec: dict = {}
    seconds: dict = {}

    def timed(name: str, fn):
        t0 = time.perf_counter()
        res = fn()
        seconds[name] = time.perf_counter() - t0
        return res

    with PlainMuls() as plain:
        dealt = staged(rec, "dealing", lambda: cmb.batched_dealing(env, rng, keys, device=DEV))
        b1 = [b for _, b in dealt]
        b1[W3_CHEAT - 1] = cheating_broadcast(group, pks, W3_CHEAT_TO, b1[W3_CHEAT - 1], rng)
        fetched = [cm.FetchedPhase1.from_broadcast(env, j + 1, b1[j]) for j in range(n)]
        round2 = staged(rec, "verification", lambda: cmb.batched_share_verification([p for p, _ in dealt], fetched,
                                                                                   rng, device=DEV))
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    check([i + 1 for i, r in enumerate(round2) if r[1] is not None] == list(W3_CHEAT_TO)
          and all(complaints_of(round2[v - 1]) == [(W3_CHEAT, DkgErrorKind.SHARE_VALIDITY_FAILED)]
                  for v in W3_CHEAT_TO), f"{tag}: round-2 complaints {[complaints_of(r) for r in round2]}")
    c2 = [cm.FetchedComplaints2(i + 1, r[1]) for i, r in enumerate(round2)]
    phase2 = timed("phase 2", lambda: [r[0].proceed(c2, fetched) for r in round2])
    check(all(isinstance(p[0], cm.DkgPhase3) and p[0]._state.qualified[W3_CHEAT - 1] == 0 for p in phase2),
          f"{tag}: the cheat stayed qualified")
    b3 = [b for _, b in phase2]
    liar = b3[W3_BARE_LIAR - 1].committed_coefficients
    b3[W3_BARE_LIAR - 1] = bc.BroadcastPhase3((group.add(liar[0], group.generator()),) + tuple(liar[1:]))
    f3 = [cm.FetchedPhase3.from_broadcast(env, j + 1, b3[j]) for j in range(n)]
    phase3 = timed("phase 3", lambda: [p.proceed(f3) for p, _ in phase2])
    accusers = [i + 1 for i, (_, b) in enumerate(phase3) if b is not None]
    want_accusers = [i for i in range(1, n + 1) if i != W3_BARE_LIAR]
    check(accusers == want_accusers and all(
        [m.accused_index for m in phase3[i - 1][1].misbehaving_parties] == [W3_BARE_LIAR] for i in accusers),
        f"{tag}: round-4 complaints from {accusers}")
    c4 = [cm.FetchedComplaints4(i + 1, b) for i, (_, b) in enumerate(phase3)]
    phase4 = timed("phase 4", lambda: [p.proceed(c4) for p, _ in phase3])
    honest = [i for i in want_accusers if i != W3_CHEAT]
    check(all(isinstance(phase4[i - 1][0], cm.DkgPhase5)
              and phase4[i - 1][0]._state.reconstructable == {W3_BARE_LIAR} for i in honest),
          f"{tag}: the liar is not to be reconstructed everywhere")
    f5 = [cm.FetchedPhase5(i + 1, b) for i, (_, b) in enumerate(phase4)]
    final = timed("phase 5", lambda: [p.finalise(f5)[0] for p, _ in phase4])
    masters = [final[i - 1][0] for i in honest]
    check(masters[0].check_consistent(group, masters[1:]) is None, f"{tag}: the honest master keys differ")
    xs = honest[: t + 1]
    secret = lagrange_interpolation(group.scalar_field, 0, [final[i - 1][1].value for i in xs], xs)
    check(masters[0].check_reproduced_by(group, secret) is None, f"{tag}: g·(interpolated secret) != the master key")
    print(f"{tag} ({card}): stages (host s) " + json.dumps(
        {"dealing": round(rec["dealing"][0], 6), "verification": round(rec["verification"][0], 6),
         **{k: round(v, 6) for k, v in seconds.items()}}) + f"; round-2 complaints of {list(W3_CHEAT_TO)} upheld, "
          f"dealer {W3_CHEAT} disqualified; dealer {W3_BARE_LIAR}'s round-4 complaints upheld, its secret "
          f"reconstructed; {len(honest)} honest master keys equal, reproduced by the secret interpolated from parties "
          f"{xs}; launches " + json.dumps({k: v[1] for k, v in rec.items()}), flush=True)
    held_launches(f"{tag} dealing", rec["dealing"][1], dealing_exact(cs, 1))
    held_launches(f"{tag} verification", rec["verification"][1], verification_exact(cs))
    return rec


def committee_phase(seed: int) -> tuple[dict, dict]:
    """The wire protocol on the card, W1 to W3, with every launch count set
    to 0 just before each stage and read just after: every kernel of the
    path must be launched.  Returns the stages' launches, summed, and W1's
    stage seconds."""
    card = card_line()
    totals: dict = {}
    w1, w1_stages = rounds_1_2(card, seed)
    recs = [w1, storm(card, seed)]
    recs += [whole_protocol(curve, card, seed) for curve in (p.curve for p in PATHS)]
    for rec in recs:
        for _, launches in rec.values():
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
    r255 = gd.RISTRETTO255
    path_kernels = [k for p in PATHS for k in committee_kernels(p.cs)]
    path_kernels += [bk.kernel_for(r255), bk.close_kernel_for(r255), pk.kernel_for("pt_window_step", r255)]
    for k in path_kernels:
        check(totals.get(k.name, 0) > 0, f"kernel {k.name} was not launched in the committee phase")
    print("committee phase: launches, W1-W3 summed " + json.dumps(totals), flush=True)
    return totals, w1_stages


# ---------------------------------------------------------------------------
# epochs: the in-process lane, the dealing legs, the EpochManager; and the
# two legs of the ristretto255 encodings
# ---------------------------------------------------------------------------

EPOCH_SIGN_B = 16  # messages the reshared quorum signs
E2_OPENERS = (1, 86, 171, 256)  # members who open and check every deal of W1's committee
E2_TAMPERED = (40, 86)  # (dealer, recipient): a share sealed off the dealer's commitments
E2_BAD_CONSTANT = 30  # the reshare dealer whose constant term is wrong
E3_N, E3_T = 8, 3  # W3's committee: the EpochManager end to end on each curve
E3_LEAVER, E3_RESUMED = 2, 3  # the party that leaves at the reshare; the party rebuilt from its WAL
ENCODE_POINTS = 1 << 16  # W1's 65,536 sealed pairs: the shape the card's encode_batch leg is timed at
ENCODE_HOST_POINTS = 1 << 13  # the first points, where both legs are timed and held byte-equal (the host leg
                                # takes one Python inverse square root a point)


@dataclasses.dataclass(frozen=True)
class Epoch0:
    """A path's ceremony as epoch 0: the final shares (ints, party i + 1's
    at i), the aggregate bare commitments (host points) and the secret."""

    finals: list
    commitments: tuple
    secret: int


def epoch0(path: Path, c: cer.BatchedCeremony, out: dict) -> Epoch0:
    """The Straus run's epoch-0 state: the commitments the pointwise sum of
    the qualified dealers' A (one pt_tree_sum on the card, outside every
    counted stage), A_0 of it the master key."""
    cs = path.cs
    q = cs.scalar.modulus
    qual = out["qualified"].cpu().tolist()
    a = fh.decode(cs.scalar, fh.from_tensor(c.coeffs_a))
    secret = sum(int(a[j, 0]) for j in range(path.n) if qual[j]) % q
    bare = out["bare"][torch.tensor(qual, device=out["bare"].device)]
    agg = tuple(gd.to_host(cs, pk.pt_tree_sum(cs, bare.transpose(0, 1).contiguous())))
    check(gh.ALL_GROUPS[path.curve].eq(agg[0], host_point(cs, out["master"])), f"{path.tag}: Σ A_j0 != the master key")
    finals = [int(v) for v in fh.decode(cs.scalar, fh.from_tensor(out["final_shares"]))]
    return Epoch0(finals, agg, secret)


def merged(*counts: dict) -> dict:
    out: dict = {}
    for d in counts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def scaled(counts: dict, times: int) -> dict:
    return {k: v * times for k, v in counts.items()}


def held_exactly(tag: str, got: dict, want: dict) -> None:
    """``got`` holds exactly the non-zero counts of ``want``: no other
    kernel was launched."""
    want = {k: v for k, v in want.items() if v}
    check(got == want, f"{tag}: launch counts {got}, want {want}")


def open_exact(cs) -> dict:
    """One open_my_shares: the KEM recovery's scalar_mul (14 table adds, one
    pt_scalar_mul) and its encode_batch."""
    return merged({pk.kernel_for("pt_add", cs).name: 14, pk.kernel_for("pt_scalar_mul", cs).name: 1},
                  encode_launches(cs, 1))


def check_exact(cs, fixed: bool = True) -> dict:
    """One check_bare_shares (fixed: g·s by one pt_fixed_base) or
    check_reshare_constants: one pt_ladder_horner and gd.eq's four
    mod_mul."""
    return {pk.kernel_for("pt_fixed_base", cs).name: int(fixed), pk.kernel_for("pt_ladder_horner", cs).name: 1,
            fk.mul_kernel_for(cs.field).name: 4}


def combine_exact(cs, m: int) -> dict:
    """combine_reshare_commitments over m dealers: one scalar_mul (14 table
    adds, one pt_scalar_mul), then m - 1 pt_add."""
    return {pk.kernel_for("pt_add", cs).name: 14 + m - 1, pk.kernel_for("pt_scalar_mul", cs).name: 1}


def epoch_lane(path: Path, e0: Epoch0, card: str, seed: int) -> dict:
    """E1: the in-process lane on the path's own final shares:
    refresh_shares, then reshare_shares to n' = n/2, t' = (n' - 1) // 3.
    The secret interpolated on the host at 0 from a random (t+1)-subset of
    the refreshed shares and from a random (t'+1)-subset of the reshared
    ones is the ceremony's, and g times it the master key; t' + 1 reshared
    shares sign EPOCH_SIGN_B messages, and each Lagrange aggregate is
    secret·H(m) on the host: it verifies under the unchanged master key
    g·secret.  Exact launches: one
    mod_madd_horner an eval_many, λ_i(0)'s lagrange_launches mod_mul and
    the weights' one."""
    cs, n, t = path.cs, path.n, path.t
    fs, group = cs.scalar, gh.ALL_GROUPS[path.curve]
    n2 = n // 2
    t2 = (n2 - 1) // 3
    tag = f"epoch E1 {path.curve} n={n} t={t} -> n'={n2} t'={t2}"
    rng = random.Random(f"{seed}-epoch-lane-{path.curve}")
    rec: dict = {}
    q1 = list(range(1, t2 + 2))
    msgs = [b"chip-smoke epoch message %02d" % i for i in range(EPOCH_SIGN_B)]
    with PlainMuls() as plain:
        refreshed = staged(rec, "refresh", lambda: inprocess.refresh_shares(fs, n, t, e0.finals, rng, device=DEV))
        reshared = staged(rec, "reshare", lambda: inprocess.reshare_shares(fs, n, t, refreshed, n2, t2, rng,
                                                                           device=DEV))
        shares = [reshared[i - 1] for i in q1]
        pts, _ = staged(rec, "hash", lambda: ts.hash_to_curve_batch(path.curve, msgs, device=DEV))
        ps = staged(rec, "partials", lambda: ts.partial_sign(path.curve, shares, q1, pts, device=DEV))
        agg = staged(rec, "aggregate", lambda: ts.aggregate(ps))
        enc = ts.signature_encode(path.curve, agg)
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    horner, mul = fk.horner_kernel_for(fs).name, fk.mul_kernel_for(fs).name
    held_exactly(f"{tag} refresh", rec["refresh"][1], {horner: 1})
    held_exactly(f"{tag} reshare", rec["reshare"][1], {horner: 1, mul: lagrange_launches(fs, n) + 1})
    exact = sign_exact(path, len(q1))
    # partial_sign with no public keys given derives them: one more pt_fixed_base and canonical form
    exact["partials"] = merged(exact["public keys"], exact["partials"])
    for stage in ("hash", "partials", "aggregate"):
        got = rec[stage][1]
        check(all(got.get(k, 0) == v for k, v in exact[stage].items()) and (exact[stage] or not got),
              f"{tag} {stage}: launch counts {got}, want {exact[stage]}")
    check(sum(a != b for a, b in zip(refreshed, e0.finals)) == n, f"{tag}: a refresh left a share as it was")
    pick = random.Random(f"{seed}-epoch-subsets-{path.curve}")
    xs_old = sorted(pick.sample(range(1, n + 1), t + 1))
    xs_new = sorted(pick.sample(range(1, n2 + 1), t2 + 1))
    s_old = lagrange_interpolation(fs, 0, [refreshed[i - 1] for i in xs_old], xs_old)
    s_new = lagrange_interpolation(fs, 0, [reshared[i - 1] for i in xs_new], xs_new)
    check(s_old == e0.secret and s_new == e0.secret, f"{tag}: the interpolated secrets differ from the ceremony's")
    check(group.eq(group.scalar_mul(s_new, group.generator()), e0.commitments[0]), f"{tag}: g·secret != the master")
    for i in range(EPOCH_SIGN_B):
        check(enc[i] == group.encode(group.scalar_mul(e0.secret, pts[i])), f"{tag}: signature {i} != secret·H(m)")
    print(f"{tag} ({card}): stages (host s) " + json.dumps({k: round(v[0], 6) for k, v in rec.items()})
          + "; launches " + json.dumps({k: v[1] for k, v in rec.items()}) + f"; every share changed; the secret "
          f"from {t + 1} refreshed shares and from {t2 + 1} reshared ones is the ceremony's, g·secret the master; "
          f"{len(q1)} reshared shares signed {EPOCH_SIGN_B} messages, each aggregate "
          "secret·H(m); exact launch counts; no plain multiply on the card", flush=True)
    return rec


def deal_codec(curve: str, deal: em.EpochDeal) -> tuple:
    """A deal through its wire codec, in a worker process: (the payload,
    the decoded EpochDeal, encode s, decode s)."""
    group = gh.ALL_GROUPS[curve]
    t0 = time.perf_counter()
    payload = em.encode_epoch_deal(group, deal)
    t1 = time.perf_counter()
    decoded = em.decode_epoch_deal(group, payload)
    return payload, decoded, t1 - t0, time.perf_counter() - t1


def codec_pool() -> concurrent.futures.ProcessPoolExecutor:
    """A few worker processes (spawned) for the deals' codec, which encodes
    and decodes every point on the host, an inverse square root each: off
    the dealer loop it hides behind the card's deals.  The driving process
    keeps two of its cores, since the workers slow its launches."""
    return concurrent.futures.ProcessPoolExecutor(max_workers=max(1, min(4, len(os.sched_getaffinity(0)) - 2)),
                                                  mp_context=multiprocessing.get_context("spawn"))


def seal_deals(group, cfg, kind: int, epoch: int, constants: dict, pks: list, seed: str, prev: tuple,
               seconds: dict, pool: concurrent.futures.Executor) -> dict:
    """One deal_epoch_poly a dealer (``constants``: dealer -> constant term,
    its rng seeded from ``seed`` and the dealer), in turn on the card, each
    deal encoded with encode_epoch_deal and decoded with decode_epoch_deal
    in ``pool`` while the next deals: {dealer: the decoded EpochDeal}.
    ``seconds`` gains the deals' host seconds, the codec's (summed over the
    workers) and the wait for the last codec after the last deal; the
    first payload is decoded and encoded again here."""
    futures = {}
    for j, const in constants.items():
        t0 = time.perf_counter()
        comm, enc = dealing.deal_epoch_poly(group, cfg, const, random.Random(f"{seed}-{j}"), pks, device=DEV)
        seconds["deal"] = seconds.get("deal", 0.0) + time.perf_counter() - t0
        futures[j] = pool.submit(deal_codec, group.name, em.EpochDeal(kind, epoch, comm, enc, prev))
    t0 = time.perf_counter()
    deals = {}
    for j, fut in futures.items():
        payload, deals[j], enc_s, dec_s = fut.result()
        seconds["encode"] = seconds.get("encode", 0.0) + enc_s
        seconds["decode"] = seconds.get("decode", 0.0) + dec_s
        if "bytes" not in seconds:  # the first deal's bytes round-trip here too
            check(em.encode_epoch_deal(group, em.decode_epoch_deal(group, payload)) == payload,
                  "an epoch deal's bytes do not round-trip")
            seconds["bytes"] = len(payload)
    seconds["codec wait"] = time.perf_counter() - t0
    return deals


def epoch_dealing(e0: Epoch0, card: str, seed: int) -> dict:
    """E2: the dealing legs at W1's committee (ristretto255 n = 256,
    t = 85), on the ristretto255 path's epoch 0 and 256 seeded keys.
    Refresh: every member deals a zero-constant polynomial (256
    deal_epoch_poly calls, 65,536 sealed pairs), each deal encoded and
    decoded (in worker processes while the card deals on); dealer E2_TAMPERED[0]'s share to member E2_TAMPERED[1] is
    resealed off its commitments.  Members E2_OPENERS open all 256 deals
    and check their 256 rows: only the tampered row is flagged.  Their new
    shares (old + the included dealers' shares) lie on the new aggregate
    commitments, which give one confirm digest and keep the master.  The
    script takes members 1 .. t + 1's refreshed shares from the dealers'
    replayed coefficients (one eval_many), the openers' equal to what they
    opened.  Reshare: those t + 1 members deal shares of their shares to
    the same keys; check_reshare_constants over the 86 dealers flags
    exactly E2_BAD_CONSTANT's forged constant; combine_reshare_commitments
    over the honest deals keeps the master; member 1 opens the reshare
    deals and its Lagrange-combined share lies on the combined
    commitments.  Each stage with exact launch counts."""
    group, cs, n, t = gh.RISTRETTO255, gd.RISTRETTO255, R255.n, R255.t
    fs, q = cs.scalar, cs.scalar.modulus
    tag = f"epoch E2 ristretto255 n={n} t={t}"
    t_phase = time.perf_counter()
    rng = random.Random(f"{seed}-epoch-e2")
    _, pks, keys = committee_keys(group, n, rng)
    cfg = dealing.epoch_cfg(group, n, t)
    rec: dict = {}
    refresh_s: dict = {}
    reshare_s: dict = {}
    bad_j, victim = E2_TAMPERED
    with PlainMuls() as plain, codec_pool() as pool:
        deals = staged(rec, "refresh deals", lambda: seal_deals(
            group, cfg, KIND_REFRESH, 1, {j: 0 for j in range(1, n + 1)}, pks, f"{seed}-e2-refresh", (), refresh_s,
            pool))
        es = list(deals[bad_j].encrypted_shares)
        share_ct, rand_ct = seal_pair(group, pks[victim - 1].point, group.scalar_to_bytes(fs.rand_int(rng)),
                                      group.scalar_to_bytes(0), rng)
        es[victim - 1] = bc.EncryptedShares(victim, share_ct, rand_ct)
        deals[bad_j] = dataclasses.replace(deals[bad_j], encrypted_shares=tuple(es))
        js = sorted(deals)
        opened, flagged = {}, {}
        for m in E2_OPENERS:
            opened[m] = staged(rec, f"open {m}", lambda: dealing.open_my_shares(group, cfg, keys[m - 1].sk, deals, m,
                                                                               device=DEV))
            check(all(opened[m][j] is not None for j in js), f"{tag}: member {m} could not open a share")
            ok = staged(rec, f"check {m}", lambda: dealing.check_bare_shares(
                group, [m] * n, [opened[m][j] for j in js], [deals[j].commitments for j in js], device=DEV))
            flagged[m] = [j for j, good in zip(js, ok) if not good]
        included = [j for j in js if j != bad_j]
        new_comm = tuple(functools.reduce(group.add, [e0.commitments[lvl]] + [deals[j].commitments[lvl]
                                                                             for j in included])
                         for lvl in range(t + 1))
        new_shares = {m: (e0.finals[m - 1] + sum(opened[m][j] for j in included)) % q for m in E2_OPENERS}
        on_comm = staged(rec, "confirm check", lambda: dealing.check_bare_shares(
            group, list(E2_OPENERS), [new_shares[m] for m in E2_OPENERS], [new_comm] * len(E2_OPENERS), device=DEV))
        digest = est.confirm_digest(group, KIND_REFRESH, 1, n, t, new_comm)
        # members 1 .. t + 1's refreshed shares from the dealers' replayed coefficients
        coeffs = []
        for j in included:
            r = random.Random(f"{seed}-e2-refresh-{j}")
            coeffs.append([0] + [fs.rand_int(r) for _ in range(t)])
        xs = fh.to_tensor(fh.encode(fs, list(range(1, t + 2))), DEV)
        deltas = fh.decode(fs, fh.from_tensor(pd.eval_many(fs, fh.to_tensor(fh.encode(fs, coeffs), DEV), xs)))
        refreshed = {i: (e0.finals[i - 1] + sum(int(v) for v in deltas[:, i - 1])) % q for i in range(1, t + 2)}
        check(all(refreshed[m] == new_shares[m] for m in E2_OPENERS if m <= t + 1),
              f"{tag}: an opener's refreshed share != the replayed dealers' sum")

        rdeals = staged(rec, "reshare deals", lambda: seal_deals(
            group, cfg, KIND_RESHARE, 2, refreshed, pks, f"{seed}-e2-reshare", new_comm, reshare_s, pool))
        idxs = sorted(rdeals)
        claimed = [rdeals[i].commitments[0] for i in idxs]
        claimed[idxs.index(E2_BAD_CONSTANT)] = group.add(claimed[idxs.index(E2_BAD_CONSTANT)], group.generator())
        ok_c = staged(rec, "reshare constants", lambda: dealing.check_reshare_constants(group, new_comm, idxs, claimed,
                                                                                       device=DEV))
        xs_old = fh.to_tensor(fh.encode(fs, idxs), DEV)
        lam = staged(rec, "lagrange", lambda: pd.lagrange_at_zero_coeffs(fs, xs_old))
        comm2 = staged(rec, "combine", lambda: dealing.combine_reshare_commitments(
            group, lam, [rdeals[i].commitments for i in idxs]))
        opened2 = staged(rec, "reshare open 1", lambda: dealing.open_my_shares(group, cfg, keys[0].sk, rdeals, 1,
                                                                              device=DEV))
        lam_h = [int(v) for v in fh.decode(fs, fh.from_tensor(lam))]
        share2 = sum(l_i * opened2[i] for l_i, i in zip(lam_h, idxs)) % q
        on_comm2 = dealing.check_bare_shares(group, [1], [share2], [comm2], device=DEV)
        sync()
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    check(all(flagged[m] == ([bad_j] if m == victim else []) for m in E2_OPENERS),
          f"{tag}: flagged rows {flagged}, want dealer {bad_j} at member {victim} alone")
    check(bool(on_comm.all()) and group.eq(new_comm[0], e0.commitments[0]),
          f"{tag}: an opener's refreshed share is off the new aggregate, or it moved the master")
    check([i for i, good in zip(idxs, ok_c) if not good] == [E2_BAD_CONSTANT], f"{tag}: reshare constants {ok_c}")
    check(group.eq(comm2[0], e0.commitments[0]) and bool(on_comm2.all()),
          f"{tag}: the combined commitments moved the master or member 1's reshared share is off them")
    held_exactly(f"{tag} refresh deals", rec["refresh deals"][1], scaled(dealing_exact(cs, 1), n))
    held_exactly(f"{tag} reshare deals", rec["reshare deals"][1], scaled(dealing_exact(cs, 1), t + 1))
    for m in E2_OPENERS:
        held_exactly(f"{tag} open {m}", rec[f"open {m}"][1], open_exact(cs))
        held_exactly(f"{tag} check {m}", rec[f"check {m}"][1], check_exact(cs))
    held_exactly(f"{tag} reshare open 1", rec["reshare open 1"][1], open_exact(cs))
    held_exactly(f"{tag} confirm check", rec["confirm check"][1], check_exact(cs))
    held_exactly(f"{tag} reshare constants", rec["reshare constants"][1], check_exact(cs, fixed=False))
    held_exactly(f"{tag} lagrange", rec["lagrange"][1], {fk.mul_kernel_for(fs).name: lagrange_launches(fs, t + 1)})
    held_exactly(f"{tag} combine", rec["combine"][1], combine_exact(cs, t + 1))
    print(f"{tag} ({card}): stages (host s) " + json.dumps({k: round(v[0], 6) for k, v in rec.items()})
          + "; refresh deals' steps (host s) " + json.dumps({k: round(v, 6) for k, v in refresh_s.items()})
          + "; reshare deals' steps " + json.dumps({k: round(v, 6) for k, v in reshare_s.items()}), flush=True)
    print(f"{tag}: launches " + json.dumps({k: v[1] for k, v in rec.items()}), flush=True)
    print(f"{tag}: {n} refresh deals ({n * n} sealed pairs) encoded and decoded; members {list(E2_OPENERS)} opened "
          f"and checked all {n} rows, dealer {bad_j}'s resealed share flagged at member {victim} alone; their new "
          f"shares lie on the new aggregate (confirm digest {digest.hex()}), the master kept; {t + 1} reshare deals, dealer "
          f"{E2_BAD_CONSTANT}'s forged constant flagged alone, the combined commitments ({t + 1} x {t + 1} points) "
          f"keep the master and hold member 1's reshared share; exact launch counts; no plain multiply on the "
          f"card; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rec


class TurnTaking:
    """An InProcessChannel whose parties take turns: each party's thread
    holds ``lock`` while it computes and lets it go only while it waits in
    a fetch.  Threads of one process that all run many small tensor ops
    hand the interpreter lock back and forth at every op, which made each
    several times slower than the same work done in turn."""

    def __init__(self, chan: InProcessChannel):
        self.chan, self.lock = chan, threading.Lock()

    def publish(self, round_no: int, sender: int, payload: bytes) -> None:
        self.chan.publish(round_no, sender, payload)

    def fetch(self, round_no: int, expected: int, timeout: float = 30.0) -> dict:
        self.lock.release()
        try:
            return self.chan.fetch(round_no, expected, timeout)
        finally:
            self.lock.acquire()


def genesis(env, keys: list, rng) -> list:
    """Phases 1-5 of the committee protocol on the card (batched_dealing,
    batched_share_verification, then phases 2-5 on the host), no faults:
    one duck-typed party result each, with the aggregate commitments the
    pointwise sum of the qualified dealers' bare_coeffs (net/party.py's
    rule) and the master key."""
    group, n = env.group, env.nr_members
    dealt = cmb.batched_dealing(env, rng, keys, device=DEV)
    fetched = [cm.FetchedPhase1.from_broadcast(env, j + 1, b) for j, (_, b) in enumerate(dealt)]
    round2 = cmb.batched_share_verification([p for p, _ in dealt], fetched, rng, device=DEV)
    c2 = [cm.FetchedComplaints2(i + 1, b) for i, (_, b) in enumerate(round2)]
    phase2 = [p.proceed(c2, fetched) for p, _ in round2]
    f3 = [cm.FetchedPhase3.from_broadcast(env, j + 1, b) for j, (_, b) in enumerate(phase2)]
    phase3 = [p.proceed(f3) for p, _ in phase2]
    c4 = [cm.FetchedComplaints4(i + 1, b) for i, (_, b) in enumerate(phase3)]
    phase4 = [p.proceed(c4) for p, _ in phase3]
    f5 = [cm.FetchedPhase5(i + 1, b) for i, (_, b) in enumerate(phase4)]
    results = []
    for i, (p, _) in enumerate(phase4):
        (master, share), _ = p.finalise(f5)
        st = p._state
        qual = [j for j in range(1, n + 1) if st.qualified[j - 1]]
        agg = tuple(functools.reduce(group.add, [st.bare_coeffs[j][lvl] for j in qual])
                    for lvl in range(env.threshold + 1))
        results.append(types.SimpleNamespace(ok=True, index=i + 1, share=share, commitments=agg, master=master))
    return results


def manager_exact(cs, n_old: int, n_new: int, reshare: bool) -> dict:
    """Launches of one EpochManager operation over the whole committee:
    n_old deals; for each of the n_new new members one open and one
    check_bare_shares, and on a reshare check_reshare_constants, λ_i(0)
    twice over the n_old included dealers (lagrange_at_zero_coeffs and
    lagrange_at_zero, which adds one product) and the combine."""
    per_member = merged(open_exact(cs), check_exact(cs))
    if reshare:
        mul = fk.mul_kernel_for(cs.scalar).name
        per_member = merged(per_member, check_exact(cs, fixed=False), combine_exact(cs, n_old),
                            {mul: 2 * lagrange_launches(cs.scalar, n_old) + 1})
    return merged(scaled(dealing_exact(cs, 1), n_old), scaled(per_member, n_new))


def epoch_manager_run(curve: str, card: str, seed: int) -> dict:
    """E3: the EpochManager end to end at W3's size (n = 8, t = 3) on
    ``curve``: genesis from the committee phases 1-5, then every party a
    thread over one shared InProcessChannel (in turn, TurnTaking), each
    with its PartyWal in a temporary directory: one refresh, then a reshare
    with party E3_LEAVER leaving and one joiner.  Every master observed is
    the ceremony's, the leaver ends with no state, everyone else at epoch 2
    with a share, and the new committee agrees on its commitments; then
    party E3_RESUMED is rebuilt from its WAL and replays both operations to
    the same states.  The operations' and the replay's launch counts are
    held exactly."""
    group, cs = gh.ALL_GROUPS[curve], gd.ALL_CURVES[curve]
    n, t = E3_N, E3_T
    tag = f"epoch E3 {curve} n={n} t={t}"
    t_phase = time.perf_counter()
    rng = random.Random(f"{seed}-epoch-e3-{curve}")
    env = cm.Environment.init(group, t, n, b"chip-smoke-e3")
    _, pks, keys = committee_keys(group, n, rng)
    joiner = committee_keys(group, 1, rng)[2][0]
    new_pks = [p for i, p in enumerate(pks) if i + 1 != E3_LEAVER] + [joiner.public()]
    rec: dict = {}
    with PlainMuls() as plain, tempfile.TemporaryDirectory() as wal_dir:
        results = staged(rec, "genesis", lambda: genesis(env, keys, rng))
        masters = {group.encode(r.master.point) for r in results}
        chan = TurnTaking(InProcessChannel())
        outs: dict = {}

        def founding(i: int) -> None:
            with chan.lock:
                try:
                    mgr = EpochManager(chan, group, genesis_from_party_result(env, results[i]), keys[i], pks,
                                       random.Random(f"{seed}-e3-party-{i}"), timeout=600.0,
                                       checkpoint=wal_path(wal_dir, i + 1), max_churn=None, device=DEV)
                    outs[i + 1] = (mgr.refresh(), mgr.reshare(new_pks, t))
                except Exception as exc:  # noqa: BLE001 -- reported by the check below
                    outs[i + 1] = exc

        def joining() -> None:
            with chan.lock:
                try:
                    observer = EpochState(epoch=1, n=n, t=t, index=None, share=None, commitments=None)
                    mgr = EpochManager(chan, group, observer, joiner, pks, random.Random(f"{seed}-e3-joiner"),
                                       timeout=600.0, first_fetch_timeout=900.0,
                                       checkpoint=wal_path(wal_dir, n + 1), max_churn=None, ops_done=1, device=DEV)
                    outs[n + 1] = (None, mgr.reshare(new_pks, t))
                except Exception as exc:  # noqa: BLE001 -- reported by the check below
                    outs[n + 1] = exc

        def run_all() -> None:
            threads = [threading.Thread(target=founding, args=(i,)) for i in range(n)]
            threads.append(threading.Thread(target=joining))
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=1200.0)
            check(not any(th.is_alive() for th in threads), f"{tag}: a party is still running")

        staged(rec, "refresh and reshare", run_all)
        errors = {i: o for i, o in outs.items() if isinstance(o, Exception)}
        check(not errors and len(outs) == n + 1, f"{tag}: parties failed {errors}")
        i = E3_RESUMED
        resumed = EpochManager(chan.chan, group, genesis_from_party_result(env, results[i - 1]), keys[i - 1], pks,
                               random.Random("a fresh rng: the WAL holds every draw"), timeout=600.0,
                               checkpoint=wal_path(wal_dir, i), max_churn=None, device=DEV)
        replayed = staged(rec, "WAL replay", lambda: (resumed.refresh(), resumed.reshare(new_pks, t)))
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    check(len(masters) == 1, f"{tag}: the ceremony's parties disagree on the master key")
    master = masters.pop()
    for i, (s1, s2) in sorted(outs.items()):
        if i <= n:
            check(s1.epoch == 1 and s1.holds_share and group.encode(s1.master) == master, f"{tag}: party {i} refresh")
        if i == E3_LEAVER:
            check(s2 is None, f"{tag}: the leaver holds a state {s2}")
            continue
        check(s2 is not None and s2.epoch == 2 and s2.holds_share and group.encode(s2.master) == master,
              f"{tag}: party {i} reshare state {s2}")
    agreed = {tuple(group.encode(c) for c in s2.commitments) for _, s2 in outs.values() if s2 is not None}
    check(len(agreed) == 1, f"{tag}: the new committee holds {len(agreed)} commitment tuples")
    want = [est.encode_epoch_state(group, s) for s in outs[E3_RESUMED]]
    check([est.encode_epoch_state(group, s) for s in replayed] == want and resumed.resumed_steps == 6,
          f"{tag}: party {E3_RESUMED} rebuilt from its WAL reached another state ({resumed.resumed_steps} steps)")
    ops = merged(manager_exact(cs, n, n, False), manager_exact(cs, n, n, True))
    held_exactly(f"{tag} refresh and reshare", rec["refresh and reshare"][1], ops)
    replay = merged(scaled(merged(open_exact(cs), check_exact(cs)), 2), check_exact(cs, fixed=False),
                    combine_exact(cs, n), {fk.mul_kernel_for(cs.scalar).name: 2 * lagrange_launches(cs.scalar, n) + 1})
    held_exactly(f"{tag} WAL replay", rec["WAL replay"][1], replay)
    print(f"{tag} ({card}): stages (host s) " + json.dumps({k: round(v[0], 6) for k, v in rec.items()})
          + "; launches " + json.dumps({k: v[1] for k, v in rec.items() if k != "genesis"})
          + f"; {n} founding parties and a joiner as threads over one InProcessChannel with a PartyWal each: the "
          f"refresh and the reshare kept the master, party {E3_LEAVER} left with no state, the rest at epoch 2 with "
          f"a share and one commitment tuple; party {E3_RESUMED} rebuilt from its WAL replayed "
          f"{resumed.resumed_steps} steps to the same states; exact launch counts; no plain multiply on the card; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rec


def ristretto_decode_launches() -> int:
    """mod_mul launches of one ristretto_decode_batch: the inverse square
    root's power as in ristretto_encode_launches, and 22 other products."""
    return ristretto_encode_launches() - 3


def encode_legs(card: str, seed: int) -> dict:
    """encode_batch's two legs on ristretto255 (g times seeded scalars by
    one pt_fixed_base, projective; lane 0 the identity, lane 1 it scaled):
    the card leg (ristretto_encode_batch, then one transfer) timed on the
    host clock at W1's 65,536 points, then both legs (the host leg: the
    points copied to the host, then one encoding a point) timed on the
    host clock around the whole call on the first 8,192, byte-equal there,
    the identities all zero.  The card leg is the default on a card
    tensor, so it must be the faster at that size.  Then ristretto_decode_batch on
    the card over those encodings and six candidates the host decoder
    judges (s = p, s = 2**256 - 1, odd s = 1, and 2, 4, 6): every valid
    flag equals the host's, the decoded points re-encode on the card to the
    input bytes, and 1024 of them equal the host decode (the host decodes
    one point at a time)."""
    cs, group = gd.RISTRETTO255, gh.RISTRETTO255
    fs, F = cs.scalar, cs.field
    tag = f"encodings ristretto255 at {ENCODE_POINTS} points"
    rng = random.Random(f"{seed}-encode-legs")
    rec: dict = {}
    with PlainMuls() as plain:
        k = fh.to_tensor(fh.encode(fs, [fs.rand_int(rng) for _ in range(ENCODE_POINTS)]), DEV)
        pts = gd.fixed_base_mul(cs, gp.generator_table(cs, device=DEV), k)
        lam = fd.constant(F, rng.randrange(2, F.modulus), device=DEV)
        pts[0] = gd.identity(cs, device=DEV)
        pts[1] = torch.stack([fd.zeros(F, device=DEV), lam, lam, fd.zeros(F, device=DEV)])
        sync()
        card = staged(rec, "card leg", lambda: gd.encode_batch(cs, pts))
        t0 = time.perf_counter()
        card = gd.encode_batch(cs, pts)
        card_s = time.perf_counter() - t0
        enc_ms = device_ms(lambda: rd.ristretto_encode_batch(pts), reps=3, spin=400_000_000)
        t0 = time.perf_counter()
        card_cut = gd.encode_batch(cs, pts[:ENCODE_HOST_POINTS])
        card_cut_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = gd.encode_batch(cs, pts[:ENCODE_HOST_POINTS].cpu())
        host_s = time.perf_counter() - t0
        bad = [gh.P, (1 << 256) - 1, 1, 2, 4, 6]
        raw = np.ascontiguousarray(card).view("<u2").astype(np.uint32)
        cand = np.concatenate([raw, np.stack([int_to_limbs(v, F.limbs) for v in bad])])
        s = fh.to_tensor(cand, DEV)
        dec, valid = staged(rec, "decode", lambda: rd.ristretto_decode_batch(s))
        dec_ms = device_ms(lambda: rd.ristretto_decode_batch(s), reps=3, spin=400_000_000)
        again = gd.encode_batch(cs, dec[:ENCODE_POINTS])
        valid = valid.cpu().tolist()
        sample = sorted(rng.sample(range(ENCODE_POINTS), min(1024, ENCODE_POINTS)))
        dec_host = gd.to_host(cs, dec[torch.tensor(sample, device=DEV)])
    check(plain.count == 0, f"{plain.count} plain field multiplies reached a CUDA tensor in the {tag} phase")
    check(card.shape == (ENCODE_POINTS, 32) and np.array_equal(card_cut, host)
          and np.array_equal(card[:ENCODE_HOST_POINTS], host), f"{tag}: the two legs' bytes differ")
    check(not card[:2].any(), f"{tag}: the identity's encodings are not all zero")
    check(card_cut_s < host_s, f"{tag}: the card leg ({card_cut_s:.6f} s) is the default but not the faster "
          f"(host {host_s:.6f} s, both on {ENCODE_HOST_POINTS} points)")
    want_bad = [group.decode(int(v).to_bytes(32, "little")) is not None for v in bad]
    check(valid == [True] * ENCODE_POINTS + want_bad, f"{tag}: decode validity {valid[ENCODE_POINTS:]}, "
          f"{ENCODE_POINTS - sum(valid[:ENCODE_POINTS])} valid lanes flagged")
    check(np.array_equal(again, card), f"{tag}: the decoded points do not re-encode to their bytes")
    check(all(group.eq(p, group.decode(card[i].tobytes())) for i, p in zip(sample, dec_host)),
          f"{tag}: a decoded point != the host decode")
    mul = fk.mul_kernel_for(F).name
    held_exactly(f"{tag} card leg", rec["card leg"][1], {mul: ristretto_encode_launches()})
    held_exactly(f"{tag} decode", rec["decode"][1], {mul: ristretto_decode_launches()})
    print(f"{tag} ({card_line()}): encode_batch card leg {card_s:.6f} s (ristretto_encode_batch device "
          f"{enc_ms:.3f} ms, {ristretto_encode_launches()} mod_mul launches); on the first {ENCODE_HOST_POINTS} "
          f"points card leg {card_cut_s:.6f} s, host leg {host_s:.6f} s ({host_s / card_cut_s:.1f}x), byte-equal, "
          f"the identities all zero; the card leg is the default; "
          f"ristretto_decode_batch device {dec_ms:.3f} ms ({ristretto_decode_launches()} mod_mul launches), every "
          f"validity the host's ({sum(want_bad)} of {len(bad)} candidates valid), the points re-encode to their "
          f"bytes, {len(sample)} equal the host decode", flush=True)
    return {"card_s": card_s, "card_cut_s": card_cut_s, "host_s": host_s, "encode_ms": enc_ms,
            "decode_ms": dec_ms, **rec}


def epoch_phase(seed: int, epoch0s: dict, w1_stages: dict) -> dict:
    """Epochs on the card, after the committee phase: E1 on each path's own
    final shares, E2 at W1's committee, E3 on each curve, and the two
    encode_batch legs, with W1's seal and DEM seconds (this routing's
    target) printed beside them.  Returns the stages' launches, summed."""
    card = card_line()
    recs = [epoch_lane(path, epoch0s[path.curve], card, seed) for path in PATHS]
    recs.append(epoch_dealing(epoch0s["ristretto255"], card, seed))
    recs += [epoch_manager_run(path.curve, card, seed) for path in PATHS]
    legs = encode_legs(card, seed)
    recs.append({k: legs[k] for k in ("card leg", "decode")})
    totals: dict = {}
    for rec in recs:
        for _, launches in rec.values():
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
    path_kernels = [k for p in PATHS for k in (*committee_kernels(p.cs), fk.horner_kernel_for(p.cs.scalar),
                                                fk.mul_kernel_for(p.cs.scalar))]
    for k in path_kernels:
        check(totals.get(k.name, 0) > 0, f"kernel {k.name} was not launched in the epoch phase")
    print(f"epoch phase ({card}): W1's seal {w1_stages['seal']:.6f} s and DEM (verify dem) "
          f"{w1_stages['verify dem']:.6f} s host, with the card's ristretto255 encodings; the encode_batch legs at "
          f"{ENCODE_POINTS} points: card {legs['card_s']:.6f} s; on the first {ENCODE_HOST_POINTS}: card "
          f"{legs['card_cut_s']:.6f} s, host {legs['host_s']:.6f} s", flush=True)
    print("epoch phase: launches, E1-E3 and the encodings summed " + json.dumps(totals), flush=True)
    return totals


# ---------------------------------------------------------------------------
# the ceremony service (dkg_tpu_torch.service): S1-S4
# ---------------------------------------------------------------------------

SVC_CURVE = "secp256k1"
# scripts/fleet_bench.py's workload at its defaults: MIX, 1000 ceremonies,
# seed 1, rho_bits 64, concurrency 4, batch_max 8
FLEET_MIX = ((16, 5, 896), (24, 8, 56), (32, 8, 24), (48, 16, 16), (64, 16, 8))
FLEET_CEREMONIES, FLEET_SEED, SVC_RHO_BITS, SVC_CONCURRENCY, SVC_BATCH_MAX = 1000, 1, 64, 4, 8
STACK_BUCKETS = ((16, 5), (32, 8), (64, 16))  # S2: the three buckets of the mix
STACK_WIDTHS = (1, 2, 4, 8)
# scripts/service_storm.py's legs at its defaults: 200 requests over its
# SHAPES, 10 poisoned on (16, 5), seed 7, concurrency 4, batch_max 8
STORM_SHAPES = ((16, 5), (16, 5), (16, 5), (16, 5), (24, 8))
STORM_REQUESTS, STORM_POISON, STORM_SEED = 200, 10, 7
SVC_SIGN_MSGS, SVC_SIGN_SUBMITTERS = 256, 4  # S4


def service_kernels(cs) -> tuple:
    """The kernels a convoy of ``cs`` launches, each at least once."""
    return (pk.kernel_for("pt_fixed_base", cs), pk.kernel_for("pt_add", cs), fk.horner_kernel_for(cs.scalar),
            fk.dot_kernel_for(cs.scalar), bk.sum_kernel_for(cs), bk.close_kernel_for(cs),
            pk.kernel_for("pt_window_step", cs), pk.kernel_for("pt_ladder_horner", cs),
            pk.kernel_for("pt_tree_sum", cs), fk.batch_inv_kernel_for(cs.field), fk.mul_kernel_for(cs.field))


def convoy_exact(cs, convoys: int) -> dict:
    """Launches a width-independent convoy makes, times ``convoys``: the
    deal's 2 pt_fixed_base and 2 mod_madd_horner, the verify's 2
    mod_madd_dot (a weight block a ceremony), 1 pt_bucket_sum (a digit
    block a ceremony), 1 pt_bucket_close, 1 pt_ladder_horner and 2
    pt_fixed_base, the final shares' 1 mod_madd_dot, the masters' 1
    pt_tree_sum."""
    per = {pk.kernel_for("pt_fixed_base", cs): 4, fk.horner_kernel_for(cs.scalar): 2, fk.dot_kernel_for(cs.scalar): 3,
           bk.sum_kernel_for(cs): 1, bk.close_kernel_for(cs): 1, pk.kernel_for("pt_ladder_horner", cs): 1,
           pk.kernel_for("pt_tree_sum", cs): 1}
    return {k.name: v * convoys for k, v in per.items()}


def counts_zero() -> None:
    for k in KERNELS:
        k.launches = 0
        k.route_launches = {}


def counts_read() -> dict:
    return {k.name: k.launches for k in KERNELS if k.launches}


class ConvoyLog:
    """A fault plan that injects nothing: it records each convoy start's
    bucket, width and request seeds (the scheduler calls ``on_start`` for
    every start, retries and bisections included)."""

    def __init__(self):
        self.lock, self.starts = threading.Lock(), []

    def on_start(self, reqs) -> None:
        b = reqs[0].bucket()
        with self.lock:
            self.starts.append(((b.n, b.t), len(reqs), tuple(r.seed for r in reqs)))

    def on_finish(self, reqs) -> None:
        pass


def fleet_workload() -> list:
    """scripts/fleet_bench.py build_workload at its defaults."""
    scale = FLEET_CEREMONIES / sum(c for _, _, c in FLEET_MIX)
    reqs = [svc.CeremonyRequest(SVC_CURVE, n, t, seed=FLEET_SEED * 1_000_000 + n * 1_000 + i, rho_bits=SVC_RHO_BITS)
            for n, t, count in FLEET_MIX for i in range(round(count * scale))]
    random.Random(FLEET_SEED).shuffle(reqs)
    return reqs


def host_oracle(req) -> tuple[bytes, list, int]:
    """A request's master key g·Σ_j a_j0 (encoded), its real recipients'
    final shares Σ_j f_j(i) and its secret Σ_j a_j0, by host big ints from
    its seeded coefficients (drawn in BatchedCeremony's order)."""
    group = gh.ALL_GROUPS[req.curve]
    fs = group.scalar_field
    q = fs.modulus
    rng = se.rng_for(req)
    a = [[fs.rand_int(rng) for _ in range(req.t + 1)] for _ in range(req.n)]
    col = [sum(row[l] for row in a) % q for l in range(req.t + 1)]
    master = group.encode(group.scalar_mul(col[0], group.generator()))
    return master, [eval_host(q, col, i) for i in range(1, req.n + 1)], col[0]


def run_scheduler(runtime, reqs, **kw):
    """Submit ``reqs`` to a CeremonyScheduler (the scripts' concurrency and
    batch_max unless given), wait for all: (scheduler, ids, outcomes, t0,
    seconds).  The scheduler is left open."""
    kw = {"concurrency": SVC_CONCURRENCY, "batch_max": SVC_BATCH_MAX, "queue_depth": len(reqs), **kw}
    sch = svc.CeremonyScheduler(runtime=runtime, **kw)
    t0 = time.monotonic()
    ids = [sch.submit(r) for r in reqs]
    outs = [sch.result(i, timeout=900) for i in ids]
    return sch, ids, outs, t0, time.monotonic() - t0


def warm_buckets(runtime, reqs, widths_of) -> float:
    """``runtime.warmup`` of each bucket of ``reqs`` at ``widths_of(bucket)``."""
    t0 = time.perf_counter()
    first = {}
    for r in reqs:
        first.setdefault(r.bucket(), r)
    for b, r in sorted(first.items(), key=lambda kv: kv[0].n):
        runtime.warmup(r, widths=tuple(widths_of(b)))
    sync()
    return time.perf_counter() - t0


def fleet_stage(runtime, card: str) -> tuple:
    """S1: scripts/fleet_bench.py's 1000-ceremony mix through the scheduler
    after warmup of each bucket's widths.  Every outcome done and all
    qualified, every master and real final share equal to the host big-int
    oracle, one ceremony per (bucket, width) equal to the unpadded
    BatchedCeremony's master; each kernel of the convoy launched exactly
    as often a convoy whatever its width, mod_madd_dot and pt_bucket_sum
    by their convoy route in each convoy wider than 1.  Returns (the open
    scheduler, ids, outcomes, requests, launches, the convoy kernel rows'
    launches, the host oracle's secrets)."""
    reqs = fleet_workload()
    warm_s = warm_buckets(runtime, reqs, lambda b: sorted({min(w, svc.buckets.width_cap(b)) for w in (SVC_BATCH_MAX, 1)},
                                                          reverse=True))
    log = ConvoyLog()
    counts_zero()
    torch.cuda.reset_peak_memory_stats()
    with PlainMuls() as plain:
        sch, ids, outs, t0, total = run_scheduler(runtime, reqs, fault_plan=log)
        sync()
    launches = counts_read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(plain.count == 0, f"S1: {plain.count} plain field multiplies reached a CUDA tensor")
    statuses: dict = {}
    for o in outs:
        statuses[o.status] = statuses.get(o.status, 0) + 1
    check(statuses == {"done": len(reqs)}, f"S1: statuses {statuses}")
    t_check = time.perf_counter()
    oracle = {}
    for r, o in zip(reqs, outs):
        master, finals, secret = host_oracle(r)
        oracle[o.ceremony_id] = secret
        check(all(o.qualified) and len(o.qualified) == r.n, f"S1: {o.ceremony_id} qualified {o.qualified}")
        check(o.master == master, f"S1: {o.ceremony_id} ({r.n}, {r.t}) master != g·Σ_j a_j0")
        got = [int(v) for v in fh.decode(gh.ALL_GROUPS[r.curve].scalar_field, o.final_shares)]
        check(got == finals, f"S1: {o.ceremony_id} final shares != Σ_j f_j(i)")
    oracle_s = time.perf_counter() - t_check
    widths: dict = {}
    picked: dict = {}
    by_seed = {r.seed: (r, o) for r, o in zip(reqs, outs)}
    for bucket, width, seeds in log.starts:
        widths[f"{bucket[0]}x{bucket[1]} w{width}"] = widths.get(f"{bucket[0]}x{bucket[1]} w{width}", 0) + 1
        picked.setdefault((bucket, width), by_seed[seeds[0]])
    for (bucket, width), (r, o) in sorted(picked.items()):
        check(svc.engine.run_single_reference(r, device=DEV) == o.master,
              f"S1: {o.ceremony_id} at bucket {bucket} width {width} != the unpadded BatchedCeremony's master")
    convoys = len(log.starts)
    cs = gd.ALL_CURVES[SVC_CURVE]
    for k in service_kernels(cs):
        check(launches.get(k.name, 0) > 0, f"kernel {k.name} was not launched in S1")
    exact = convoy_exact(cs, convoys)
    check(all(launches.get(k, 0) == v for k, v in exact.items()),
          f"S1: launches {({k: launches.get(k, 0) for k in exact})}, want {exact} over {convoys} convoys")
    # the convoy route's launches (more than one block a launch), split by
    # bucket over the convoys wider than 1: the (16, 5) ones to the kernels
    # line's "convoy (16,5)" rows, the rest to its "convoy" rows
    wide: dict = {}
    for bucket, width, _ in log.starts:
        if width > 1:
            wide[bucket] = wide.get(bucket, 0) + 1
    small = wide.get((16, 5), 0)
    convoy_rows = {}
    for kern, per in ((fk.dot_kernel_for(cs.scalar), 3), (bk.sum_kernel_for(cs), 1)):
        got = kern.route_launches.get("convoy", 0)
        check(got == per * sum(wide.values()),
              f"S1: {kern.name} convoy-route launches {got}, want {per} a convoy over {wide}")
        convoy_rows[f"{kern.name} convoy (16,5)"] = per * small
        convoy_rows[f"{kern.name} convoy"] = got - per * small
    lat = sorted(o.completed_at - t0 for o in outs)
    print(f"service S1 ({card}): {len(reqs)} {SVC_CURVE} ceremonies (scripts/fleet_bench.py's mix, seed "
          f"{FLEET_SEED}, rho_bits {SVC_RHO_BITS}, concurrency {SVC_CONCURRENCY}, batch_max {SVC_BATCH_MAX}) in "
          f"{total:.6f} s: {len(reqs) / total:.3f} ceremonies/s, p50 {lat[len(lat) // 2]:.6f} s, p99 "
          f"{lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.6f} s (submit -> completed_at); warmup {warm_s:.3f} s; "
          f"convoys {convoys} " + json.dumps(widths) + f"; peak device memory {peak_gib:.3f} GiB; every outcome done, "
          f"all qualified, masters and final shares = the host oracles ({oracle_s:.1f} s), {len(picked)} "
          f"(bucket, width) samples = the unpadded BatchedCeremony; exact launches " + json.dumps(exact), flush=True)
    print("service S1: launches " + json.dumps(launches) + "; by the convoy route " + json.dumps(convoy_rows),
          flush=True)
    return sch, ids, outs, reqs, launches, convoy_rows, oracle


def stack_stage(runtime, card: str) -> None:
    """S2: warm run_convoy at widths 1, 2, 4, 8 of the three buckets:
    ceremonies/s and exact launches a convoy by kernel; a width-k convoy
    launches mod_madd_dot and pt_bucket_sum as often as a width-1 convoy,
    and every lane equals its width-1 run."""
    cs = gd.ALL_CURVES[SVC_CURVE]
    dot, bsum = fk.dot_kernel_for(cs.scalar).name, bk.sum_kernel_for(cs).name
    table = {}
    for n, t in STACK_BUCKETS:
        reqs = [svc.CeremonyRequest(SVC_CURVE, n, t, seed=5_000_000 + 1_000 * n + i, rho_bits=SVC_RHO_BITS)
                for i in range(max(STACK_WIDTHS))]
        singles = [svc.engine.run_convoy(runtime, [r])[0] for r in reqs]
        per_width = {}
        for w in STACK_WIDTHS:
            svc.engine.run_convoy(runtime, reqs[:w])  # warm at this width
            sync()
            counts_zero()
            t0 = time.perf_counter()
            outs = svc.engine.run_convoy(runtime, reqs[:w])
            sync()
            dt = time.perf_counter() - t0
            launches = counts_read()
            convoy = [fk.dot_kernel_for(cs.scalar).route_launches.get("convoy", 0),
                      bk.sum_kernel_for(cs).route_launches.get("convoy", 0)]
            check(convoy == ([3, 1] if w > 1 else [0, 0]),
                  f"S2: ({n}, {t}) width {w}: convoy-route launches {convoy} ({dot}, {bsum})")
            for o, s in zip(outs, singles):
                check(o.status == "done" and o.master == s.master and o.qualified == s.qualified
                      and np.array_equal(o.final_shares, s.final_shares),
                      f"S2: ({n}, {t}) width {w}: lane {o.ceremony_id} != its width-1 run")
            per_width[w] = (dt, launches)
        one = per_width[1][1]
        for w, (_, launches) in per_width.items():
            check(launches.get(dot) == one.get(dot) == 3 and launches.get(bsum) == one.get(bsum) == 1,
                  f"S2: ({n}, {t}) width {w}: {dot} {launches.get(dot)}, {bsum} {launches.get(bsum)} a convoy")
        table[f"{n}x{t}"] = {w: {"seconds": dt, "ceremonies_per_s": w / dt, "launches": launches}
                             for w, (dt, launches) in per_width.items()}
        print(f"service S2 ({card}): bucket ({n}, {t}) warm run_convoy, host s / ceremonies per s by width: "
              + ", ".join(f"w{w} {dt:.6f} / {w / dt:.3f}" for w, (dt, _) in per_width.items())
              + f"; every lane = its width-1 run; {dot} 3 and {bsum} 1 a convoy at every width (by the convoy "
                "route above width 1)", flush=True)
    print("service S2: launches a convoy " + json.dumps({b: {w: v["launches"] for w, v in row.items()}
                                                          for b, row in table.items()}), flush=True)


def storm_workload() -> list:
    """scripts/service_storm.py build_workload at its defaults."""
    reqs = [svc.CeremonyRequest(SVC_CURVE, *STORM_SHAPES[i % len(STORM_SHAPES)], seed=STORM_SEED * 1_000_000 + i,
                                rho_bits=SVC_RHO_BITS, tag=f"req-{i}") for i in range(STORM_REQUESTS)]
    random.Random(STORM_SEED).shuffle(reqs)
    return reqs


def storm_stage(runtime, card: str) -> dict:
    """S3: scripts/service_storm.py's three legs.  Convoy: a fault-free
    pass, then the fault plan (10 poisoned, 2 transient, 2 slow, a worker
    crash at start 7): survival and blame accuracy 1.0, every healthy
    master bit-identical to the fault-free pass, every poisoned outcome
    typed.  Sign: a forged DLEQ response blamed to its cell within the
    pass bound; the forging signer alone quarantined; the substitute
    quorum's signatures the honest quorum's bytes.  Recovery: a corrupted
    WAL tail re-served off the intact prefix; a crash-looping record
    poisoned with REPLAY_LIMIT.  Returns the legs' launches, summed."""
    reqs = storm_workload()
    rec: dict = {}
    poison_shape = (16, 5)
    ladder = {r.bucket() for r in reqs if (r.n, r.t) == poison_shape}

    def widths(b):
        cap = min(SVC_BATCH_MAX, svc.buckets.width_cap(b))
        return [w for w in svc.buckets.WIDTHS if w <= cap] if b in ladder else [next(
            w for w in svc.buckets.WIDTHS if w <= cap)]
    warm_s = warm_buckets(runtime, reqs, widths)

    def clean_pass():
        sch, ids, outs, _, dt = run_scheduler(runtime, reqs)
        sch.close()
        return ids, outs, dt
    ids, clean, clean_s = staged(rec, "clean pass", clean_pass)
    check(all(o.status == "done" for o in clean), "S3: the fault-free pass failed a request")
    rng = random.Random(STORM_SEED + 1)
    poison_tags = rng.sample([r.tag for r in reqs if (r.n, r.t) == poison_shape], k=STORM_POISON)
    plan = (svc.ServiceFaultPlan(seed=STORM_SEED).poison(*poison_tags).transient(times=2).slow(0.05, times=2)
            .crash_worker(at_start=7))
    REGISTRY.reset()
    sch, ids2, stormy, _, storm_s = staged(rec, "storm pass", lambda: run_scheduler(runtime, reqs, fault_plan=plan))
    check(ids2 == ids, "S3: ceremony ids differ between the two passes")
    clean_by = dict(zip(ids, clean))
    storm_by = dict(zip(ids, stormy))
    truth = {c for c, r in zip(ids, reqs) if r.tag in plan.poisoned_tags}
    blamed = {c for c in ids if storm_by[c].status == "poisoned"}
    healthy = [c for c in ids if c not in truth]
    healthy_done = [c for c in healthy if storm_by[c].status == "done"]
    identical = [c for c in healthy_done if storm_by[c].master == clean_by[c].master]
    typed = [c for c in blamed if storm_by[c].error.startswith("PoisonedRequest")]
    counters = REGISTRY.snapshot()["counters"]
    survival = len(healthy_done) / max(1, len(healthy))
    accuracy = len(truth & blamed) / len(truth | blamed) if truth | blamed else 1.0
    check(survival == 1.0 and accuracy == 1.0 and len(identical) == len(healthy) and len(typed) == len(blamed)
          and not [c for c in ids if storm_by[c].status not in ("done", "poisoned")],
          f"S3 convoy leg: survival {survival}, blame accuracy {accuracy}, {len(identical)} of {len(healthy)} "
          f"healthy bit-identical, {len(typed)} of {len(blamed)} typed")
    convoy = {"survival_rate": survival, "blame_accuracy": accuracy, "healthy_bit_identical": len(identical),
              "poisoned": len(blamed), "bisections": counters.get("service_convoy_bisections_total", 0),
              "retries": counters.get("service_retries_total", 0),
              "worker_restarts": counters.get("service_worker_restarts_total", 0),
              "requeued": counters.get("service_requeued_total", 0), "injected": plan.as_dict()["injected"]}
    check(convoy["worker_restarts"] >= 1 and convoy["retries"] >= 1 and convoy["bisections"] >= 1,
          f"S3 convoy leg: the faults were not all exercised {convoy}")
    print(f"service S3 ({card}): convoy leg ({STORM_REQUESTS} requests, {STORM_POISON} poisoned, 2 transient, 2 slow, "
          f"a worker crash; warmup {warm_s:.3f} s, clean {clean_s:.6f} s, storm {storm_s:.6f} s) "
          + json.dumps(convoy), flush=True)

    held = [c for c, r in zip(ids, reqs) if c in healthy_done and (r.n, r.t) == poison_shape]
    try:
        sign = staged(rec, "sign leg", lambda: storm_sign_leg(sch, held[0]))
    finally:
        sch.close()
    print(f"service S3 ({card}): sign leg " + json.dumps(sign), flush=True)
    recovery = staged(rec, "recovery leg", lambda: storm_recovery_leg(runtime))
    print(f"service S3 ({card}): recovery leg " + json.dumps(recovery), flush=True)
    print(f"service S3: stages (host s) " + json.dumps({k: round(v[0], 6) for k, v in rec.items()})
          + "; launches " + json.dumps({k: v[1] for k, v in rec.items()}), flush=True)
    totals: dict = {}
    for _, launches in rec.values():
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def storm_sign_leg(sch, cid: str) -> dict:
    """The storm's sign leg: direct rlc_verify blame on a host sharing (2
    messages x 6 signers), then through the scheduler an honest quorum, a
    one-shot forger and a follow-up with the quarantine standing."""
    group = gh.ALL_GROUPS[SVC_CURVE]
    q = group.scalar_field.modulus
    msgs = [b"svcstorm message 0", b"svcstorm message 1"]
    n, t = 16, 5
    rng = random.Random(STORM_SEED + 2)
    coeffs = [group.scalar_field.rand_int(rng) for _ in range(t + 1)]
    indices = list(range(1, t + 2))
    h_points, _ = ts.hash_to_curve_batch(SVC_CURVE, msgs, device=DEV)
    ps = ts.partial_sign(SVC_CURVE, [eval_host(q, coeffs, i) for i in indices], indices, h_points, rng=rng,
                         prove=True, device=DEV)
    cell = (1, 2)
    m = len(ps.indices)
    proofs = list(ps.proofs)
    p = proofs[cell[0] * m + cell[1]]
    proofs[cell[0] * m + cell[1]] = dataclasses.replace(p, response=(p.response + 1) % q)
    report = ts.rlc_verify(dataclasses.replace(ps, proofs=proofs), rng=random.Random(STORM_SEED))
    sigs0 = sch.sign(cid, msgs, seed=STORM_SEED + 11)
    state = {"signer": None}

    def forge_once(grid):
        if state["signer"] is not None:
            return grid
        state["signer"] = grid.indices[1]
        gp_ = list(grid.proofs)
        bad = gp_[1]
        gp_[1] = dataclasses.replace(bad, response=(bad.response + 1) % q)
        return dataclasses.replace(grid, proofs=gp_)

    sigs1 = sch.sign(cid, msgs, seed=STORM_SEED + 12, tamper=forge_once)
    sigs2 = sch.sign(cid, msgs, seed=STORM_SEED + 13)
    quarantined = sorted(sch.quarantined(cid))
    leg = {"grid": report.grid, "blamed_cells": [list(c) for c in report.bad_cells],
           "blamed_cells_exact": report.bad_cells == (cell,), "passes": report.passes,
           "pass_bound": report.pass_bound(), "substitute_sig_bit_identical": sigs1 == sigs0 and sigs2 == sigs0,
           "quarantined": quarantined, "quarantined_exact": quarantined == [state["signer"]]}
    check(leg["blamed_cells_exact"] and report.passes <= report.pass_bound() and leg["substitute_sig_bit_identical"]
          and leg["quarantined_exact"], f"S3 sign leg: {leg}")
    return leg


def storm_recovery_leg(runtime) -> dict:
    """The storm's recovery leg: 4 durable ceremonies journalled, the WAL
    tail corrupted, a fresh scheduler re-serving every terminal outcome
    bit-identically; a pending record stamped with max_replays replays
    comes back poisoned (REPLAY_LIMIT)."""
    tmp = tempfile.mkdtemp(prefix="svcstorm-wal-")
    wal_a = os.path.join(tmp, "a")
    reqs = [svc.CeremonyRequest(SVC_CURVE, 16, 5, seed=STORM_SEED * 2_000_000 + i, rho_bits=SVC_RHO_BITS,
                                durable=True) for i in range(4)]
    with svc.CeremonyScheduler(concurrency=2, queue_depth=8, batch_max=4, runtime=runtime, wal_dir=wal_a) as sch:
        cids = [sch.submit(r) for r in reqs]
        outs = {c: sch.result(c, timeout=600) for c in cids}
    check(all(o.status == "done" for o in outs.values()), "S3 recovery leg: a durable ceremony failed")
    svc.corrupt_journal(wal_a, seed=STORM_SEED)
    sch2 = svc.CeremonyScheduler(concurrency=1, queue_depth=8, batch_max=1, runtime=runtime, wal_dir=wal_a)
    reserved = [c for c in cids if sch2.poll(c) == "done" and sch2.result(c).master == outs[c].master]
    sch2.close()
    wal_b = os.path.join(tmp, "b")
    jreq = svc.CeremonyRequest(SVC_CURVE, 16, 5, seed=STORM_SEED * 3_000_000, rho_bits=SVC_RHO_BITS, durable=True)
    jcid = svc.engine.request_id(jreq, 0)
    j = ServiceJournal(wal_b)
    j.record_request(jcid, 0, jreq)
    for count in range(1, 4):
        j.record_replay(jcid, count)
    sch3 = svc.CeremonyScheduler(concurrency=1, queue_depth=8, batch_max=1, runtime=runtime, wal_dir=wal_b,
                                 max_replays=3)
    poisoned = sch3.poll(jcid) == "poisoned"
    error = sch3.result(jcid).error if poisoned else None
    sch3.close()
    shutil.rmtree(tmp, ignore_errors=True)
    leg = {"durable": len(cids), "terminal_reserved": len(reserved), "crash_loop_poisoned": poisoned,
           "crash_loop_error": error}
    check(len(reserved) == len(cids) and poisoned and "REPLAY_LIMIT" in (error or ""), f"S3 recovery leg: {leg}")
    return leg


def sign_lane_stage(sch, reqs, ids, outs, oracle: dict, card: str) -> dict:
    """S4 on S1's scheduler: SVC_SIGN_MSGS unproved messages from
    SVC_SIGN_SUBMITTERS threads over two S1 ceremonies coalesce through
    sign_submit / sign_wait, every signature secret·H(m) on the host; then
    refresh and reshare of one ceremony, which signs again with its master
    and signatures unchanged.  Returns the stages' launches, summed."""
    group = gh.ALL_GROUPS[SVC_CURVE]
    rec: dict = {}
    picks = [next(i for i, r in zip(ids, reqs) if (r.n, r.t) == shape) for shape in ((16, 5), (24, 8))]
    per = SVC_SIGN_MSGS // SVC_SIGN_SUBMITTERS
    msgs = {s: [b"service sign lane %d %04d" % (s, i) for i in range(per)] for s in range(SVC_SIGN_SUBMITTERS)}
    cid_of = {s: picks[s % 2] for s in msgs}
    tickets, lock = {}, threading.Lock()

    def submitter(s):
        tk = sch.sign_submit(cid_of[s], msgs[s], prove=False)
        with lock:
            tickets[s] = tk

    def lane():
        threads = [threading.Thread(target=submitter, args=(s,)) for s in msgs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return {s: sch.sign_wait(tk, timeout=600) for s, tk in tickets.items()}
    before = REGISTRY.snapshot()["counters"]
    sigs = staged(rec, "sign lane", lane)
    flushes = {k: v - before.get(k, 0) for k, v in REGISTRY.snapshot()["counters"].items()
               if k.startswith("sign_flush_total") and v - before.get(k, 0)}
    t_check = time.perf_counter()
    for s, got in sigs.items():
        secret = oracle[cid_of[s]]
        pts, _ = ts.hash_to_curve_batch(SVC_CURVE, msgs[s], device="cpu")
        check(len(got) == per and all(g == group.encode(group.scalar_mul(secret, h)) for g, h in zip(got, pts)),
              f"S4: submitter {s}'s signatures != secret·H(m)")
    check_s = time.perf_counter() - t_check
    cid = picks[0]
    probe = msgs[0][:16]
    before_sigs = sigs[0][:16]
    epoch = staged(rec, "refresh", lambda: sch.refresh(cid, seed=41))
    after_refresh = staged(rec, "sign after refresh", lambda: sch.sign(cid, probe, prove=False))
    out = next(o for i, o in zip(ids, outs) if i == cid)
    n_new, t_new = 12, 3
    new_cid = staged(rec, "reshare", lambda: sch.reshare(cid, n_new, t_new, seed=42))
    after_reshare = staged(rec, "sign after reshare", lambda: sch.sign(new_cid, probe, prove=False))
    new_out = sch.result(new_cid)
    check(epoch == 1 and after_refresh == before_sigs and after_reshare == before_sigs
          and new_out.master == out.master and new_out.n == n_new and new_out.epoch == 2,
          f"S4: epochs: refresh epoch {epoch}, reshared master kept {new_out.master == out.master}, "
          f"signatures kept {after_refresh == before_sigs}, {after_reshare == before_sigs}")
    print(f"service S4 ({card}): {SVC_SIGN_MSGS} unproved messages from {SVC_SIGN_SUBMITTERS} submitters over "
          f"two S1 ceremonies ({', '.join(picks)}) through sign_submit / sign_wait: flushes " + json.dumps(flushes)
          + f"; every signature = secret·H(m) on the host ({check_s:.1f} s); refresh (epoch 1) and reshare to "
          f"({n_new}, {t_new}) keep the master and the signatures; stages (host s) "
          + json.dumps({k: round(v[0], 6) for k, v in rec.items()}) + "; launches "
          + json.dumps({k: v[1] for k, v in rec.items()}), flush=True)
    totals: dict = {}
    for _, launches in rec.values():
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def service_phase(card: str) -> tuple:
    """S1-S4 on one WarmRuntime on the card.  Returns S1's launches and
    its convoy-route launches by kernels-line row; every stage's are
    printed."""
    t_phase = time.perf_counter()
    runtime = svc.WarmRuntime(device=DEV)
    sch, ids, outs, reqs, launches, convoy_rows, oracle = fleet_stage(runtime, card)
    try:
        sign_lane_stage(sch, reqs, ids, outs, oracle, card)
    finally:
        sch.close()
    stack_stage(runtime, card)
    storm_stage(runtime, card)
    print(f"service phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, convoy_rows


# ---------------------------------------------------------------------------
# the fixed-base tables: built on the card, composed at window 16, from disk
# ---------------------------------------------------------------------------

TABLE_SEEDED = 256  # seeded (w, d) entries of g's window-16 table held to the host ladder (h's: 64)
TABLE_PLAIN_LANES = 1 << 16  # lanes of the compose's pt_add held and timed against its plain version
FIXED_PLAIN_DEALERS = 8  # dealers' rows of the deal's lanes held and timed against pt_fixed_base's plain version


def table_build_exact(cs) -> dict:
    """Launches of fixed_base_table_dev at a window of at most 8: one
    pt_ladder_mul_add (scalar_mul_small) and one canonical affine form."""
    return merged({pk.kernel_for("pt_ladder_mul_add", cs).name: 1}, canon_launches(cs, "classic", 1))


def compose_exact(cs) -> dict:
    """Launches of a window-16 table: one pt_add over every entry, one
    canonical affine form."""
    return merged({pk.kernel_for("pt_add", cs).name: 1}, canon_launches(cs, "classic", 1))


def shape_row(name: str, lanes: int, fn, plain_ms: float, nbytes: int, muladds: int) -> dict:
    """A kernel at one of this phase's shapes: ms a wrapper call (CUDA
    events) and device ms (behind a spin), beside its plain version's ms
    (timed by the caller, who holds the kernel to it) and the bound from
    ``nbytes`` and ``muladds``."""
    first, _ = cuda_ms(fn, reps=1)
    reps = TIMING_REPS if first < SLOW_MS else SLOW_REPS
    ms, _ = cuda_ms(fn, reps=reps, warm_up=False)
    dev = device_ms(fn, reps=reps)
    bytes_ms, ops_ms = 1e3 * nbytes / BYTES_PER_S, 1e3 * 2 * muladds / INT32_MUL_PER_S
    return {"name": name, "lanes": lanes, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def gathered_entries(k: torch.Tensor, window: int) -> int:
    """Distinct table entries a fixed_base_mul over a window-``window``
    table gathers for the scalars k: each (window, digit) pair that k's
    digits name, once (at most the whole table)."""
    digits = pk.window_digits(k, window).long()
    pairs = torch.arange(digits.shape[-1], device=digits.device) * (1 << window) + digits
    return int(torch.unique(pairs).numel())


def window_muladds(cs, k: torch.Tensor, window: int) -> int:
    """Mixed adds a fixed_base_mul over a window-``window`` table needs for
    k: one a non-zero digit on Weierstrass curves, one a window on Edwards."""
    digits = pk.window_digits(k, window)
    madd = POINT_COSTS[cs.name][1]
    return madd * int(digits.numel() if cs.kind == "edwards" else (digits != 0).sum())


def host_entries(cs, base, entries: list) -> np.ndarray:
    """T[w][d] = d·2**(16 w)·B for each (w, d) on the host ladder, as
    canonical affine limbs."""
    group = gh.ALL_GROUPS[cs.name]
    bases, pt = {}, base
    for w in range(max(w for w, _ in entries) + 1):
        bases[w] = pt
        for _ in range(16):
            pt = group.add(pt, pt)
    pts = [group.scalar_mul(d, bases[w]) for w, d in entries]
    return gd.affine_canon_host(cs, fh.encode(cs.field, np.asarray(pts, dtype=object)))


def table_entries(nw: int, seeded: int, rng) -> list:
    """Every window's digit-0 and top-digit entry, then ``seeded`` seeded
    (w, d)."""
    return ([(w, 0) for w in range(nw)] + [(w, (1 << 16) - 1) for w in range(nw)]
            + [(int(rng.integers(nw)), int(rng.integers(1 << 16))) for _ in range(seeded)])


def tables_curve(path: Path, card: str, rng) -> None:
    """One curve's tables, every cache empty: g's window-8 table built on
    the card (precompute.base_table, one build) equal to the host table;
    g's and h's window-16 tables composed on the card (h's half built there
    first) and held to the host ladder; fixed_base_mul at windows 8 and 16
    over the deal's and the verifier's lanes, equal after affine_canon,
    timed; and the kernel rows at this phase's shapes."""
    cs, n, t = path.cs, path.n, path.t
    tag = f"tables {path.curve}"
    group = gh.ALL_GROUPS[path.curve]
    g, h = gd.gen_host(cs), cer.CommitmentKey.generate(group, path.shared).h
    rec: dict = {}
    builds = gp.stats()["builds"]
    t8 = staged(rec, "g window 8 on the card", lambda: gp.base_table(cs, g, 8, device=DEV))
    check(gp.stats()["builds"] == builds + 1, f"{tag}: g's window-8 table was not built ({gp.stats()})")
    check(torch.equal(t8.cpu(), fh.to_tensor(gd.fixed_table_host(cs, gd.base_key(cs, g), 8), "cpu")),
          f"{tag}: the window-8 table built on the card differs from the host table")
    held_exactly(f"{tag} window-8 build", rec["g window 8 on the card"][1], table_build_exact(cs))
    tables16 = {}
    for label, base, seeded, half_built in (("g", g, TABLE_SEEDED, 0), ("h", h, TABLE_SEEDED // 4, 1)):
        tab = staged(rec, f"{label} window 16 composed", lambda base=base: gp.base_table(cs, base, 16, device=DEV))
        held_exactly(f"{tag} {label} window-16 compose", rec[f"{label} window 16 composed"][1],
                     merged(compose_exact(cs), scaled(table_build_exact(cs), half_built)))
        check(tuple(tab.shape) == (16, 1 << 16, cs.ncoords, cs.field.limbs), f"{tag}: window-16 shape {tuple(tab.shape)}")
        entries = table_entries(tab.shape[0], seeded, rng)
        got = tab[torch.tensor([w for w, _ in entries], device=DEV), torch.tensor([d for _, d in entries], device=DEV)]
        check(np.array_equal(fh.from_tensor(got), host_entries(cs, base, entries)),
              f"{tag}: {label}'s window-16 table differs from the host ladder")
        tables16[label] = tab
    g8 = t8
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 31)))
    k = card_coeffs(cs.scalar, n, t, gen).reshape(-1, cs.scalar.limbs)  # the deal's n (t + 1) lanes
    kv = k[:n]  # the verifier's n lanes
    outs = {w: gd.fixed_base_mul(cs, tab, k) for w, tab in ((8, g8), (16, tables16["g"]))}
    check(torch.equal(gd.affine_canon(cs, outs[8]), gd.affine_canon(cs, outs[16])),
          f"{tag}: fixed_base_mul at windows 8 and 16 differ after affine_canon")
    plain_k = k[: FIXED_PLAIN_DEALERS * (t + 1)]
    fb = pk.kernel_for("pt_fixed_base", cs).name
    rows, point = [], cs.ncoords * cs.field.limbs * 4
    for w, tab in ((8, g8), (16, tables16["g"])):
        plain_ms, want = cuda_ms(lambda tab=tab: pk.pt_fixed_base_plain(cs, tab, plain_k), reps=1, warm_up=False)
        check(torch.equal(outs[w][: len(plain_k)], want), f"{tag}: pt_fixed_base at window {w} differs from its plain version")
        for lanes_k, what in ((k, "deal"), (kv, "verifier")):
            rows.append(shape_row(f"{fb} window {w} {what}", len(lanes_k), lambda tab=tab, kk=lanes_k: pk.pt_fixed_base(cs, tab, kk),
                                  plain_ms, gathered_entries(lanes_k, w) * point + lanes_k.numel() * 4
                                  + len(lanes_k) * point, window_muladds(cs, lanes_k, w)))
    half = g8
    # a window-16 table's device work, the half table already on the card: the compose and its canonical form
    compose_ms, again = cuda_ms(lambda: gd.composed_table(cs, lambda _: half, 16), reps=3)
    check(torch.equal(again, tables16["g"]), f"{tag}: a second compose of g's window-16 table differs")
    del again
    lo, hi = half[0::2][:, None], half[1::2][:, :, None]  # (16, 1, 256, C, L), (16, 256, 1, C, L)
    composed = pk.pt_add(cs, lo, hi).reshape(-1, cs.ncoords, cs.field.limbs)
    full = (composed.shape[0] // 256 // 256, 256, 256, cs.ncoords, cs.field.limbs)
    cut = slice(0, TABLE_PLAIN_LANES)
    lo_c = lo.expand(full).reshape(composed.shape)[cut]
    hi_c = hi.expand(full).reshape(composed.shape)[cut]
    plain_ms, want = cuda_ms(lambda: pk.pt_add_plain(cs, lo_c, hi_c), reps=1, warm_up=False)
    check(torch.equal(composed[cut], want), f"{tag}: pt_add at the compose's lanes")
    add = POINT_COSTS[cs.name][0]
    rows.append(shape_row(f"{pk.kernel_for('pt_add', cs).name} compose", composed.shape[0],
                          lambda: pk.pt_add(cs, lo, hi), plain_ms, (composed.numel() + half.numel()) * 4,
                          add * composed.shape[0]))
    nw = gd.n_windows(cs, 8)
    bases = gd.from_host(cs, [group.scalar_mul(1 << (8 * w), g) for w in range(nw)], device=DEV)[:, None]
    bases = bases.expand(nw, 256, cs.ncoords, cs.field.limbs)
    digits = torch.arange(256, dtype=torch.int32, device=DEV).expand(nw, 256)
    ident = gd.identity(cs, (nw, 256), device=DEV)
    lad = pk.kernel_for("pt_ladder_mul_add", cs).name
    plain_ms, want = cuda_ms(lambda: pk.pt_ladder_mul_add_plain(cs, bases, ident, digits, 8), reps=1, warm_up=False)
    check(torch.equal(pk.pt_ladder_mul_add(cs, bases, ident, digits, 8), want), f"{tag}: {lad} at the table's lanes")
    dbl = POINT_COSTS[cs.name][2]
    rows.append(shape_row(f"{lad} scalar_mul_small", nw * 256, lambda: pk.pt_ladder_mul_add(cs, bases, ident, digits, 8),
                          plain_ms, ((2 * nw * 256 + nw) * cs.ncoords * cs.field.limbs + 256) * 4,
                          nw * ladder_muladds(list(range(256)), dbl, add)))
    for r in rows:
        print(f"{tag} ({card}): {r['name']} over {r['lanes']} lanes: {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), "
              f"plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
    print(f"{tag} ({card}): a window-16 table's compose and affine_canon, the half table on the card: "
          f"{compose_ms:.4f} ms a base (CUDA events, 3 calls)", flush=True)
    print(f"{tag} ({card}): stages (host s) " + json.dumps({k_: round(v[0], 6) for k_, v in rec.items()})
          + "; launches " + json.dumps({k_: v[1] for k_, v in rec.items()})
          + f"; g's window-8 table built on the card equal to the host table limb for limb; g's and h's window-16 "
          f"tables (one pt_add over 1,048,576 lanes, one affine_canon each) held to the host ladder at every digit-0 "
          f"and top-digit entry and {TABLE_SEEDED} / {TABLE_SEEDED // 4} seeded entries; fixed_base_mul at windows "
          f"8 and 16 over the deal's {len(k)} lanes equal after affine_canon", flush=True)
    del outs, composed, lo_c, hi_c, tables16, t8


def table_acquire(cs, h) -> tuple[float, dict]:
    """A ceremony's table acquisition (BatchedCeremony._setup's): g's and
    h's tables at the default window, ended by a device synchronise; its
    host seconds and the precompute counters' delta."""
    before = gp.stats()
    t0 = time.perf_counter()
    gp.generator_table(cs, device=DEV)
    gp.base_table(cs, h, device=DEV)
    sync()
    after = gp.stats()
    return time.perf_counter() - t0, {k: after[k] - before[k] for k in after if isinstance(after[k], int)}


def tables_disk(path: Path, card: str, seed: int, ceremonies: bool) -> dict:
    """The tables of path's ceremony on a first run (a fresh cache
    directory: build and persist), on a warm one (process caches dropped:
    a disk load) and from the process cache.  With ``ceremonies`` each is a
    whole ceremony, run(trace=)'s table_cache meta saying which route ran,
    the later two's outputs equal to the first's; else the acquisition
    alone (:func:`table_acquire`)."""
    tag = f"tables {path.curve} disk cache"
    group = gh.ALL_GROUPS[path.curve]
    h = cer.CommitmentKey.generate(group, path.shared).h
    runs = {}
    with tempfile.TemporaryDirectory(prefix="dkg-fb-disk-", dir=os.environ["DKG_TPU_TABLE_CACHE"]) as d:
        old = os.environ["DKG_TPU_TABLE_CACHE"]
        os.environ["DKG_TPU_TABLE_CACHE"] = d  # no file of this run's yet: the first acquisition builds
        try:
            gp.reset()
            for label, drop in (("first", False), ("disk", True), ("process", False)):
                if drop:
                    gp.reset()
                if ceremonies:
                    trace = CeremonyTrace()
                    c = cer.BatchedCeremony(path.curve, path.n, path.t, path.shared, random.Random(seed), device=DEV)
                    out = c.run(rlc="pippenger", trace=trace)
                    sync()
                    runs[label] = (c.table_seconds, dict(trace.meta["table_cache"]), gp.stats(), out)
                    del c
                else:
                    runs[label] = (*table_acquire(path.cs, h), gp.stats(), None)
        finally:
            gp.reset()
            os.environ["DKG_TPU_TABLE_CACHE"] = old
    first, disk, proc = runs["first"], runs["disk"], runs["process"]
    check(first[1]["builds"] == 2 and first[1]["disk_loads"] == 0, f"{tag}: the first run's tables {first[1]}")
    check(disk[1]["disk_loads"] >= 1 and disk[1]["builds"] == 0 and disk[1]["disk_rejects"] == 0,
          f"{tag}: the warm run's tables {disk[1]}")
    check(proc[1]["proc_hits"] == 2 and proc[1]["builds"] == 0 and proc[1]["disk_loads"] == 0,
          f"{tag}: the third run's tables {proc[1]}")
    if ceremonies:
        for label in ("disk", "process"):
            same_outputs(f"{tag} ({label})", runs[label][3], first[3])
    what = (f"{path.tag}: three ceremonies' tables phase" if ceremonies
            else f"{path.curve}: the tables' acquisition (g and h at the default window)")
    print(f"{tag} ({card}): {what} (host s) first run {first[0]:.6f} (table_cache {json.dumps(first[1])}), "
          f"from disk {disk[0]:.6f} ({json.dumps(disk[1])}), from the process cache {proc[0]:.6f} "
          f"({json.dumps(proc[1])}); stats() after the disk run {json.dumps(disk[2])}"
          + ("; every output of the two later ceremonies equal to the first's" if ceremonies else ""), flush=True)
    return {label: v[0] for label, v in runs.items()}


def tables_phase(seed: int, card: str) -> None:
    """The tables on each path's curve (:func:`tables_curve`,
    :func:`tables_disk`), in a cache directory of their own, every
    process cache emptied at the end, so each path's first run acquires its
    tables as a first process would (g's from the disk file the kernel
    checks wrote, h's built on the card)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 16)
    old = os.environ.get("DKG_TPU_TABLE_CACHE")
    with tempfile.TemporaryDirectory(prefix="dkg-fb-phase-") as d:
        os.environ["DKG_TPU_TABLE_CACHE"] = d
        try:
            for path in PATHS:
                gp.reset()
                tables_curve(path, card, rng)
                tables_disk(path.pippenger(), card, seed, ceremonies=path is R255)
        finally:
            gp.reset()
            os.environ["DKG_TPU_TABLE_CACHE"] = old
    print(f"tables phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the chaos storm over a TCP hub (scripts/chaos_storm.py's configuration)
# ---------------------------------------------------------------------------

STORM_CURVE = "ristretto255"
STORM_N, STORM_T = 6, 2  # chaos_storm.py's --n, --t
STORM_SEED = 0xC7A05  # its --seed
STORM_TIMEOUT = 1.0  # its ceremony rounds' fetch timeout
STORM_CEREMONIES = 8  # its --ceremonies
STORM_RESTARTS = 1  # --restarts 1: one more party a ceremony crashes mid-round and resumes from its WAL
EPOCH_STORMS = 2  # --churn 1 on the first 2 seeds (its default count is 8: the one cut, for the command's time)
EPOCH_CHURN = 1
EPOCH_TIMEOUT = 10.0  # its epoch rounds' fetch timeout
BYTE_FAULTS = ("garbage", "truncate", "bitflip", "equivocate", "duplicate", "drop")


def random_plan(seed: int, n: int, t: int, timeout: float, restarts: int = 0) -> nf.FaultPlan:
    """chaos_storm.py's random_plan: a fault schedule touching at most t of
    the n parties, plus up to ``restarts`` mid-round crash-restarts on
    other parties."""
    rng = random.Random(seed)
    plan = nf.FaultPlan(seed)
    faulty = rng.sample(range(1, n + 1), rng.randint(1, t))
    liveness_used = False
    for sender in faulty:
        style = rng.random()
        if style < 0.25 and not liveness_used:
            liveness_used = True
            if rng.random() < 0.5:
                plan.crash_after(sender=sender, round_no=rng.randint(1, 4))
            else:
                plan.delay(rng.randint(1, 5), sender, seconds=timeout * 2.5)
        else:
            for _ in range(rng.randint(1, 2)):
                kind = rng.choice(BYTE_FAULTS)
                getattr(plan, kind)(rng.randint(1, 5), sender)
    if restarts:
        candidates = [p for p in range(1, n + 1) if p not in faulty]
        for sender in rng.sample(candidates, min(restarts, len(candidates))):
            plan.restart(sender=sender, round_no=rng.randint(1, 5))
    return plan


def random_epoch_plan(seed: int, n: int, t: int, restarts: int = 0, refreshes: int = 1) -> nf.FaultPlan:
    """chaos_storm.py's random_epoch_plan: byte faults on the epoch deal
    rounds only, restarts on refresh rounds every founding party fetches."""
    rng = random.Random(seed ^ 0xE70C)
    plan = nf.FaultPlan(seed)
    deal_rounds = [6 + 3 * op for op in range(refreshes + 1)]
    faulty = rng.sample(range(1, n + 1), rng.randint(1, t))
    for sender in faulty:
        for _ in range(rng.randint(1, 2)):
            kind = rng.choice(BYTE_FAULTS)
            getattr(plan, kind)(rng.choice(deal_rounds), sender)
    if restarts:
        refresh_rounds = list(range(6, 6 + 3 * refreshes))
        candidates = [p for p in range(1, n + 1) if p not in faulty]
        for sender in rng.sample(candidates, min(restarts, len(candidates))):
            plan.restart(sender=sender, round_no=rng.choice(refresh_rounds))
    return plan


def storm_ceremony(seed: int, wal_root: str) -> dict:
    """One ceremony of the storm over its own TcpHub on 127.0.0.1, every
    party a thread with its TcpHubChannel and WAL: the honest parties end
    ok on one master key, the restarted ones on the same."""
    group = gh.ALL_GROUPS[STORM_CURVE]
    env, keys, pks = nf.make_committee(group, STORM_N, STORM_T, seed, shared_string=f"chaos-{seed:x}".encode())
    plan = random_plan(seed, STORM_N, STORM_T, STORM_TIMEOUT, restarts=STORM_RESTARTS)
    hub = TcpHub().start()
    try:
        t0 = time.perf_counter()
        results = nf.run_with_faults(env, keys, pks, plan, lambda i: TcpHubChannel(*hub.address),
                                     timeout=STORM_TIMEOUT, seed=seed,
                                     checkpoint_dir=os.path.join(wal_root, f"c{seed:x}"))
        wall = time.perf_counter() - t0
        evidence = hub.channel.equivocation_evidence()
    finally:
        hub.stop()
    honest = nf.honest_results(results, plan)
    masters = {group.encode(r.master.point) for r in honest if r.ok}
    restarted = [results[s - 1] for s in sorted(plan._restarts)]
    tag = f"storm ceremony {seed:#x}"
    check(bool(honest) and all(r.ok for r in honest), f"{tag}: an honest party failed {results}")
    check(len(masters) == 1, f"{tag}: the honest parties hold {len(masters)} master keys")
    check(all(isinstance(r, PartyResult) and r.ok and r.resumes >= 1 and group.encode(r.master.point) in masters
              for r in restarted), f"{tag}: a restarted party did not resume to the agreed key {restarted}")
    kinds = sorted({f["kind"] for f in plan.as_dict()["faults"]})
    return {"seed": seed, "wall_s": wall, "honest": len(honest), "restarted": len(restarted), "faults": kinds,
            "crashes": len(plan._crash_after), "equivocations": len(evidence),
            "quarantined": sum(r.quarantined for r in results if isinstance(r, PartyResult))}


def epoch_storm(seed: int, wal_root: str) -> dict:
    """One ceremony, a refresh and a 1-leave/1-join reshare under
    random_epoch_plan over a TcpHub, the epoch operations on the card: every
    honest party and the joiner end without error, the leaver left, every
    master observed after each operation is the ceremony's, and the
    joiner's share verifies against the new commitments on the host."""
    group = gh.ALL_GROUPS[STORM_CURVE]
    n = STORM_N
    env, keys, pks = nf.make_committee(group, n, STORM_T, seed, shared_string=f"chaos-epoch-{seed:x}".encode())
    churn = nf.churn_schedule(seed, n, EPOCH_CHURN)
    plan = random_epoch_plan(seed, n, STORM_T, restarts=STORM_RESTARTS)
    hub = TcpHub().start()
    try:
        t0 = time.perf_counter()
        outcomes = nf.run_epochs_with_faults(env, keys, pks, plan, lambda i: TcpHubChannel(*hub.address),
                                             churn=churn, timeout=EPOCH_TIMEOUT, seed=seed,
                                             checkpoint_dir=os.path.join(wal_root, f"e{seed:x}"), device=DEV)
        sync()
        wall = time.perf_counter() - t0
    finally:
        hub.stop()
    tag = f"epoch storm {seed:#x}"
    founding, joiners = outcomes[:n], outcomes[n:]
    faulty = {s for (_, s) in plan._faults}
    honest = [o for o in founding if o.party not in faulty]
    base = {group.encode(o.base.master.point) for o in honest if isinstance(o.base, PartyResult) and o.base.ok}
    check(len(base) == 1 and all(isinstance(o.base, PartyResult) and o.base.ok for o in honest),
          f"{tag}: the honest parties' ceremony {[o.base for o in honest]}")
    check(all(o.error is None for o in honest + joiners), f"{tag}: errors {[(o.party, o.error) for o in outcomes]}")
    check(all(o.left for o in honest if o.party in churn.leavers), f"{tag}: a leaver holds a state")
    stay = [o for o in honest + joiners if o.party not in churn.leavers]
    check(all(o.state is not None and o.state.epoch == 2 for o in stay), f"{tag}: a member did not reach epoch 2")
    masters = {m for o in honest + joiners for m in o.masters}
    check(masters == base, f"{tag}: the masters changed across the refresh and the reshare")
    for o in joiners:
        st = o.state
        acc = group.identity()
        for c in reversed(st.commitments):
            acc = group.add(group.scalar_mul(st.index, acc), c)
        check(group.eq(group.scalar_mul(st.share, group.generator()), acc),
              f"{tag}: joiner {o.party}'s share does not verify against the new commitments")
    restarted = sorted(plan._restarts)
    check(all(founding[s - 1].resumes >= 1 and founding[s - 1].error is None for s in restarted),
          f"{tag}: a restarted party did not resume")
    return {"seed": seed, "wall_s": wall, "leavers": list(churn.leavers), "restarted": restarted,
            "faults": sorted({f["kind"] for f in plan.as_dict()["faults"]}), "honest": len(honest)}


def storm_ceremonies(wal_root: str) -> tuple:
    """The storm's STORM_CEREMONIES ceremonies, one after another: their
    records, host seconds and launches (none: the wire protocol's parties
    compute on the host)."""
    counts_zero()
    t0 = time.perf_counter()
    runs = [storm_ceremony(STORM_SEED + c, wal_root) for c in range(STORM_CEREMONIES)]
    return runs, time.perf_counter() - t0, counts_read()


def storm_start() -> tuple:
    """Start the storm's ceremonies in a spawned worker process: they touch
    no card and run beside the kernels' build on a core of their own.
    Returns what :func:`storm_phase` collects."""
    wal = tempfile.TemporaryDirectory(prefix="dkg-storm-wal-")
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(storm_ceremonies, wal.name), wal


def storm_phase(card: str, started: tuple) -> dict:
    """scripts/chaos_storm.py's storm on the card's machine: its 8
    ceremonies (one restart each) over a TcpHub on 127.0.0.1, on the host in
    the worker :func:`storm_start` began, then here the epoch storm on the
    first 2 seeds, its epoch operations on the card.  No in-process
    fallback: a hub that cannot bind fails the phase.  Returns the epoch
    storms' launches."""
    t_phase = time.perf_counter()
    pool, future, wal = started
    try:
        runs, ceremonies_s, ceremonies_launched = future.result(timeout=900)
    finally:
        pool.shutdown()
    check(not ceremonies_launched, f"storm: the ceremonies launched kernels {ceremonies_launched}")
    wait_s = time.perf_counter() - t_phase
    rec: dict = {}
    try:
        epochs = staged(rec, "epoch storms", lambda: [epoch_storm(STORM_SEED + c, wal.name)
                                                      for c in range(EPOCH_STORMS)])
    finally:
        wal.cleanup()
    got = rec["epoch storms"][1]
    cs = gd.ALL_CURVES[STORM_CURVE]
    for op in ("pt_fixed_base", "pt_ladder_horner", "pt_scalar_mul"):
        check(got.get(pk.kernel_for(op, cs).name, 0) > 0, f"storm: the epoch storms launched no {op}")
    check(got.get(fk.horner_kernel_for(cs.scalar).name, 0) > 0, "storm: the epoch storms launched no mod_madd_horner")
    print(f"storm phase ({card}): {STORM_CURVE} n={STORM_N} t={STORM_T} seed {STORM_SEED:#x}, TcpHub on 127.0.0.1: "
          f"{len(runs)} ceremonies (timeout {STORM_TIMEOUT} s, --restarts {STORM_RESTARTS}; in a worker process "
          f"beside the build, {ceremonies_s:.6f} s there, {wait_s:.6f} s waited for here) "
          + json.dumps(runs) + f"; epoch storms (--churn {EPOCH_CHURN}, timeout {EPOCH_TIMEOUT} s) "
          + json.dumps(epochs) + "; stages (host s) " + json.dumps({k: round(v[0], 6) for k, v in rec.items()})
          + "; launches " + json.dumps({k: v[1] for k, v in rec.items()})
          + "; every honest party ok on one master key, every restarted party resumed to it, the epoch masters "
          f"unchanged across the refresh and the reshare, the joiners' shares verify; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()

    def stamp(what: str) -> None:  # the command's host seconds so far, at each stage's end
        print(f"elapsed {time.perf_counter() - t0:.1f} s: {what}", flush=True)

    # the fixed-base tables' disk cache lives in a directory of this run's, removed at its end
    table_cache = tempfile.TemporaryDirectory(prefix="dkg-fb-run-")
    os.environ["DKG_TPU_TABLE_CACHE"] = table_cache.name

    storm = storm_start()  # the storm's host-only ceremonies, in a worker beside the build
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(build.SOURCES)}", flush=True)
    for src, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "entry function" in line or "spill" in line or "registers" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)

    rng = np.random.default_rng(args.seed)
    numbers = check_kernels(rng)
    stamp("kernels against their plain versions")
    launches = {}  # kernel name -> the first non-zero count a main path read, else 0

    def keep(path_launches: dict) -> None:
        for name, count in path_launches.items():
            if not launches.get(name):
                launches[name] = count

    tables_phase(args.seed, card)
    stamp("tables")

    epoch0s = {}  # curve -> the Straus run's outcome as epoch 0, for the epoch phase
    for path in PATHS:
        c, out, path_launches = main_path(path, args.seed, first=True)
        keep(path_launches)
        epoch0s[path.curve] = epoch0(path, c, out)
        digest_legs(path, c, out)
        matmul_routes(path, c, out)
        chunked_run(path, c, out)
        stamp(f"{path.curve}: Straus run, digest legs, matmul routes and the forced-chunk run")
        keep(seal_phase(path, c, out, args.seed))
        stamp(f"{path.curve}: seal")
        keep(sign_phase(path, c, out, args.seed))
        stamp(f"{path.curve}: signing")
        pip = path.pippenger()
        if path in REPEATED_PASSES:
            profile_main_path(pip, args.seed)
        _, pip_out, pip_launches = main_path(pip, args.seed)
        same_outputs(pip.tag, pip_out, out)
        keep(pip_launches)
        print(f"main path {pip.tag}: every output equals the Straus run's; verify phase (host clock, s) "
              f"straus {out['phase_seconds']['verify']:.6f}, pippenger {pip_out['phase_seconds']['verify']:.6f}",
              flush=True)
        del pip_out
        gemm = path.gemm()
        _, gemm_out, gemm_launches = main_path(gemm, args.seed)
        same_outputs(gemm.tag, gemm_out, out)
        keep(gemm_launches)
        print(f"main path {gemm.tag}: every output equals the Straus run's; fiat_shamir (host clock, s) "
              f"classic {out['phase_seconds']['fiat_shamir']:.6f}, gemm {gemm_out['phase_seconds']['fiat_shamir']:.6f}",
              flush=True)
        del gemm_out
        rlc_schedules(path, c, out)
        stamp(f"{path.curve}: Pippenger and gemm runs, RLC schedules")
        del c, out
    keep(x1_phase(args.seed, card))
    stamp("X1: secp256k1 n=4096")
    keep(x2_phase(args.seed, card))
    stamp("X2: BLS12-381 G1 n=16384")
    for i, path in enumerate(PATHS):
        for rlc in ("straus", "pippenger"):
            tampered(path.curve, args.seed + 1 + i, rlc)
    stamp("tampered runs")
    committee_launches, w1_stages = committee_phase(args.seed)
    keep(committee_launches)
    stamp("committee wire protocol")
    keep(epoch_phase(args.seed, epoch0s, w1_stages))
    stamp("epochs")
    service_launches, convoy_rows = service_phase(card)
    keep(service_launches)
    stamp("ceremony service")
    keep(storm_phase(card, storm))
    stamp("chaos storm")

    rows = []
    for name, rec in numbers.items():
        if name not in SOURCES:
            continue  # a second shape of a kernel that has its row (the k = 8 window steps)
        source, replaces = SOURCES[name]
        # a convoy row's launches: its kernel's by the convoy route in S1, the
        # fleet mix (secp256k1 only), in the (16, 5) convoys or the others
        count = convoy_rows.get(name, 0) if " convoy" in name else launches[name]
        rows.append({"name": name, "route": "cuda", "source": "dkg_tpu_torch/csrc/" + source,
                     "replaces": replaces, "launches": count, **rec})
    print(json.dumps({"kernels": rows}), flush=True)
    table_cache.cleanup()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
