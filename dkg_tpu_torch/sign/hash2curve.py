"""Hash-to-curve for message digests: H(m) as a group element.

Counterpart of ``dkg_tpu/sign/hash2curve.py``, two legs with the same
points:

* :func:`hash_to_curve_host`, the per-message oracle, the group's
  ``hash_to_group`` (try-and-increment with cofactor clearing on the
  Weierstrass curves, ristretto255's one-way map); variable-time, as
  H(m) is public;
* :func:`hash_to_curve_batch`: on the Weierstrass curves the candidate
  digests of a block of counters for every pending message go through
  ``crypto.blake2.blake2b_batch`` in one call, consumed in the host
  loop's counter order, so the points are the oracle's; ristretto255
  has no search to batch and maps each message through the oracle.  The
  points' canonical affine limbs then go to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto.blake2 import blake2b_batch
from ..dkg.ceremony import resolve_device
from ..fields import host as fh
from ..groups import device as gd
from ..groups import host as gh
from ..groups.host import _person

#: Domain tag for signing digests, apart from the commitment key's.
SIGN_DOMAIN = b"dkg_tpu.sign.h2c"

#: Counters hashed a batched round: a round finds no quadratic residue
#: for a message with probability about 2**-8.
_CTR_BLOCK = 8


def hash_to_curve_host(group, msg: bytes, domain: bytes = SIGN_DOMAIN):
    """H(msg) as a host point tuple."""
    return group.hash_to_group(msg, domain)


def _batch_weierstrass(group, msgs, domain) -> list:
    """Counter-batched try-and-increment: the oracle's points."""
    nb = group.base_field.nbytes + 16
    person = _person(domain)
    found: list = [None] * len(msgs)
    by_len: dict[int, list[int]] = {}  # blake2b_batch hashes rows of one length
    for i, m in enumerate(msgs):
        by_len.setdefault(len(m), []).append(i)
    for mlen, idxs in by_len.items():
        pending, ctr0 = list(idxs), 0
        while pending:
            rows = np.zeros((len(pending), _CTR_BLOCK, mlen + 4), np.uint8)
            rows[:, :, :mlen] = np.stack([np.frombuffer(msgs[i], dtype=np.uint8) for i in pending])[:, None]
            ctrs = np.arange(ctr0, ctr0 + _CTR_BLOCK, dtype="<u4").view(np.uint8).reshape(_CTR_BLOCK, 4)
            rows[:, :, mlen:] = ctrs
            digests = blake2b_batch(rows.reshape(-1, mlen + 4), digest_size=nb, person=person)
            still = []
            for r, i in enumerate(pending):
                for k in range(_CTR_BLOCK):
                    x = int.from_bytes(digests[r * _CTR_BLOCK + k].tobytes(), "little") % group.prime
                    y = group.lift_x(x, 0)
                    if y is None:
                        continue
                    pt = group.mul_int(group.cofactor, (x, y, 1))
                    if group.eq(pt, group.identity()):
                        continue
                    found[i] = pt
                    break
                else:
                    still.append(i)
            pending = still
            ctr0 += _CTR_BLOCK
    return found


def hash_to_curve_batch(curve: str, msgs: list[bytes], domain: bytes = SIGN_DOMAIN, *,
                        device="cuda") -> tuple[list, torch.Tensor]:
    """H(m) for a message batch: (host point tuples, their canonical affine
    limbs (B, C, L) on ``device``), the points :func:`hash_to_curve_host`
    gives message by message."""
    dev = resolve_device(device)
    cs, group = gd.ALL_CURVES[curve], gh.ALL_GROUPS[curve]
    if isinstance(group, gh.WeierstrassGroup):
        pts = _batch_weierstrass(group, msgs, domain)
    else:
        pts = [group.hash_to_group(m, domain) for m in msgs]
    canon = gd.affine_canon_host(cs, fh.from_tensor(gd.from_host(cs, pts, device="cpu")))
    return pts, fh.to_tensor(canon, dev)
