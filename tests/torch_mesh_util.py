"""Rank bodies of the party-mesh tests: run by ``hostmesh.spawn`` in
processes of their own, so they import the port only (no jax, no
dkg_tpu) and live outside the test modules, which do.

Tamper plans are global (dealer, recipient) pairs; each rank bumps the
shares of its own dealers.  A ceremony that aborts comes back as
``{"error": kind, "detail": ...}``."""

import torch

from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg.errors import DkgError
from dkg_tpu_torch.fields import device as tfd
from dkg_tpu_torch.parallel import mesh as pm


def tamper_for(cfg, mesh, plan):
    """A tamper hook adding one to s[dealer, recipient] for the rank's
    dealers of ``plan``; None for an empty plan."""
    if not plan:
        return None
    fs = cfg.cs.scalar
    start, stop = mesh.span(cfg.n)

    def tamper(a, e, s, r):
        s = s.clone()
        for dealer, recipient in plan:
            if start <= dealer < stop:
                j = dealer - start
                s[j, recipient] = tfd.add(fs, s[j, recipient], tfd.ones(fs, device=s.device))
        return a, e, s, r

    return tamper


def run_plans(mesh, curve, n, t, coeffs_a, coeffs_b, g_table, h_table, plans, rho_bits=128, seal=None):
    """``run_sharded_ceremony`` once per tamper plan on this rank (the
    first with ``seal``); returns a list of result dicts without events,
    or the error of an aborted run."""
    cfg = tce.CeremonyConfig(curve, n, t)
    outs = []
    for k, plan in enumerate(plans):
        try:
            out = pm.run_sharded_ceremony(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table, rho_bits,
                                          tamper=tamper_for(cfg, mesh, plan), seal=seal if k == 0 else None)
        except DkgError as exc:
            outs.append({"error": exc.kind.value, "detail": exc.detail})
            continue
        del out["events"]
        outs.append(out)
    return outs


def mesh_checks(mesh, curve, n, t, coeffs_a, coeffs_b, g_table, h_table, plans, seal):
    """:func:`run_plans`, and on the honest round: the digest of the
    rank's blocks and of all n dealers' (replicated) tensors, a mixed
    layout's error, and the verify/finalise at a one-recipient chunk
    against the default chunk."""
    cfg = tce.CeremonyConfig(curve, n, t)
    outs = run_plans(mesh, curve, n, t, coeffs_a, coeffs_b, g_table, h_table, plans, seal=seal)
    a, e, s, r = pm.sharded_deal(cfg, mesh, coeffs_a, coeffs_b, g_table, h_table)
    full = tce.deal(cfg, coeffs_a, coeffs_b, g_table, h_table)
    extra = {"sharded": tce.sharded_transcript_digest(cfg, mesh, a, e, s, r),
             "replicated": tce.sharded_transcript_digest(cfg, mesh, *full)}
    try:
        tce.sharded_transcript_digest(cfg, mesh, full[0], e, s, r)
        extra["mixed"] = None
    except ValueError as exc:
        extra["mixed"] = str(exc)
    rho = torch.from_numpy(tce.fiat_shamir_rho(cfg, extra["sharded"], 128).astype("int32"))
    a0 = a[:, 0].contiguous()
    one = pm.sharded_verify_finalise(cfg, mesh, a0, e, s, r, g_table, h_table, rho, 128, chunk=1)
    whole = pm.sharded_verify_finalise(cfg, mesh, a0, e, s, r, g_table, h_table, rho, 128)
    extra["chunked_equal"] = all(torch.equal(x, y) for x, y in zip(one, whole))
    extra["collectives"] = {k: dict(v) for k, v in mesh.stats.items()}
    return outs, extra


def failing_rank(mesh, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective it never
    joins."""
    if mesh.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    return mesh.all_gather(torch.zeros(1))
