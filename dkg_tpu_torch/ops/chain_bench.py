"""Time the chained point kernels (``pt_fixed_base``, ``pt_tree_sum``,
``pt_scalar_mul``) at one thread a lane and in a group, in each build,
against their one-step routes at the ceremony paths' shapes, and hold
every build at the edges.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 -m dkg_tpu_torch.ops.chain_bench

It builds ``csrc/chain_kernels.cu`` once per entry of ``VARIANTS`` (other
group sizes through ``-DDKG_CHAIN_TPI_SECP=...`` / ``_BLS`` / ``_ED``,
or the one-thread kernels' blocks an SM through
``-DDKG_CHAIN_TPI1_BLOCKS``; the first entry is the source's defaults),
all builds in parallel, and makes each path's inputs from a fixed numpy
seed.  A call's lane runs on one thread or in a group as the wrapper's
lane rule says (``point_kernels.FIXED_BASE_GROUP_BELOW``,
``TREE_GROUP_BELOW``); the bench swaps those tables to force either, on
the curves whose kernel has a group variant.  In every build and setting
each kernel is first held against its plain version at the edges: the
tree at m = 1, 2, 3 and 5 over 4 columns, direct and gathered; the fixed
base over digit-0 windows and over the identity's table; the scalar
multiply at k = 0, 1, order - 1 and scalars with all-zero digit windows,
over the identity's table, a table shared by every lane and a table a
lane.  ``pt_fixed_base`` then runs over the generator's table at the
deal's lanes (n (t+1) scalars) and the verifier's (n); ``pt_tree_sum`` at
a Straus window's shape (t+1 columns of n table entries under shared
digits, read in place) and the master key's (one column of n points);
``pt_scalar_mul`` at the seal's KEM (n**2 scalars over n recipients'
tables, each read in place by its n dealers), a default seal chunk's KEM
(4096 // n dealers' n scalars each, 4096 lanes) and a recipient's opens
(n lanes, a table a lane).
Each is timed REPS calls back to back behind a spin kernel by CUDA events
(device ms a call), its output held equal to the one-step route's limb
for limb, and the route (the plain versions' loops over ``pt_madd`` /
``pt_add`` / ``pt_window_step``: 32 gathered mixed adds with their
selects; a tree level's add with its gather and pads; 64 gathered window
steps) timed the same way.  It prints ptxas's lines
per build and one JSON line: the card and per path and shape the route's
ms and each build and setting's.  Any output that differs raises.
"""

from __future__ import annotations

import contextlib
import json
import subprocess

import numpy as np
import torch

from ..fields import host as fh
from ..groups import device as gd
from ..groups import precompute as gp
from . import build
from . import point_kernels as pk

# (curve, n, t)
PATHS = (("secp256k1", 1024, 341), ("bls12_381_g1", 1024, 341), ("ristretto255", 256, 85))
ONE, GROUP = "one thread", "group"
CURVES = tuple(c for c, _, _ in PATHS)

# (label, extra defines, the settings timed per curve): the defaults at
# one thread and in the curve's group, smaller groups (BLS12-381 p's 12
# words take 2 or 4: a group divides a warp), and the one-thread kernels
# made to fit three or four blocks an SM (170 or 128 registers a thread)
VARIANTS = (
    ("default", (), {c: (ONE, GROUP) for c in CURVES}),
    ("groups of 4", ("DKG_CHAIN_TPI_SECP=4", "DKG_CHAIN_TPI_ED=4"), {"secp256k1": (GROUP,), "ristretto255": (GROUP,)}),
    ("groups of 2", ("DKG_CHAIN_TPI_SECP=2", "DKG_CHAIN_TPI_BLS=2", "DKG_CHAIN_TPI_ED=2"),
     {c: (GROUP,) for c in CURVES}),
    ("3 blocks an SM", ("DKG_CHAIN_TPI1_BLOCKS=3",), {c: (ONE,) for c in CURVES}),
    ("4 blocks an SM", ("DKG_CHAIN_TPI1_BLOCKS=4",), {c: (ONE,) for c in CURVES}),
)
REPS = 5
SOURCE = "chain_kernels.cu"
ROUTE_SOURCES = ("point_kernels.cu", "bls_kernels.cu", "edwards_kernels.cu")
# the lane-rule tables, by op
RULES = {"pt_fixed_base": pk.FIXED_BASE_GROUP_BELOW, "pt_tree_sum": pk.TREE_GROUP_BELOW,
         "pt_scalar_mul": pk.SCALAR_MUL_GROUP_BELOW}
EDGE_M = (1, 2, 3, 5)


def device_ms(fn, reps: int = REPS, spin: int = 200_000_000) -> float:
    """Device ms a call of ``fn``: a spin kernel holds the stream while the
    host enqueues the calls, so the events time their kernels back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def settings(op: str, cs, wanted) -> tuple:
    """The settings of ``wanted`` that ``op`` has on ``cs``: a group only
    where its kernel builds one."""
    key = (cs.kind, cs.field.name, cs.const)
    return tuple(s for s in wanted if s == ONE or key in RULES[op])


@contextlib.contextmanager
def forced(op: str, cs, kernel, setting: str):
    """``op``'s calls on ``cs`` through ``kernel`` (a build), every lane on
    one thread or in a group whatever the call's shape."""
    key = (cs.kind, cs.field.name, cs.const)
    rule, base = RULES[op], pk._VARIANTS[op][key]
    had = rule.get(key)
    rule[key] = 1 << 62 if setting == GROUP else 0
    pk._VARIANTS[op][key] = kernel
    try:
        yield
    finally:
        pk._VARIANTS[op][key] = base
        if had is None:
            del rule[key]
        else:
            rule[key] = had


def rand_below(rng, modulus: int, limbs: int, shape: tuple, device) -> torch.Tensor:
    """Random limbs (*shape, limbs) of values below the modulus's top limb."""
    v = rng.integers(0, 1 << 16, size=shape + (limbs,))
    v[..., -1] %= modulus >> (16 * (limbs - 1))
    return torch.from_numpy(v.astype(np.int32)).to(device)


def shapes(rng, curve: str, n: int, t: int, device) -> dict:
    """Each timed shape of the path: name -> (op, kernel call, route call)."""
    cs = gd.ALL_CURVES[curve]
    table = gp.generator_table(cs, device=device)
    S, F = cs.scalar, cs.field
    out = {}
    for label, lanes in (("fixed_base deal", n * (t + 1)), ("fixed_base verify", n)):
        k = rand_below(rng, S.modulus, S.limbs, (lanes,), device)
        out[label] = ("pt_fixed_base", lambda k=k: pk.pt_fixed_base(cs, table, k),
                      lambda k=k: pk.pt_fixed_base_plain(cs, table, k, madd=pk.pt_madd))
    entries = rand_below(rng, F.modulus, F.limbs, (t + 1, n, 16, cs.ncoords), device)
    digits = torch.from_numpy(rng.integers(0, 16, size=(n,)).astype(np.int32)).to(device)
    out["tree_sum straus window"] = ("pt_tree_sum", lambda: pk.pt_tree_sum(cs, entries, digits),
                                     lambda: pk.pt_tree_sum_plain(cs, entries, digits, add=pk.pt_add))
    master = rand_below(rng, F.modulus, F.limbs, (n, cs.ncoords), device)
    out["tree_sum master key"] = ("pt_tree_sum", lambda: pk.pt_tree_sum(cs, master),
                                  lambda: pk.pt_tree_sum_plain(cs, master, add=pk.pt_add))
    keys = rand_below(rng, F.modulus, F.limbs, (n, 16, cs.ncoords), device)  # n recipients' tables
    r = rand_below(rng, S.modulus, S.limbs, (n, n), device)
    r_chunk = r[:max(1, 4096 // n)]  # a default seal chunk's dealers (hybrid_batch.seal_shares_pipeline)
    sk = rand_below(rng, S.modulus, S.limbs, (1,), device).expand(n, S.limbs)
    for label, k in (("scalar_mul KEM", r), ("scalar_mul seal chunk", r_chunk), ("scalar_mul open", sk)):
        out[label] = ("pt_scalar_mul", lambda k=k: pk.pt_scalar_mul(cs, keys, k),
                      lambda k=k: pk.pt_scalar_mul_plain(cs, keys, k, step=pk.pt_window_step))
    return out


def edge_cases(rng, curve: str, device) -> dict:
    """Inputs at the edges, per op: (label, call, plain on the CPU)."""
    cs = gd.ALL_CURVES[curve]
    S, F = cs.scalar, cs.field
    table = gp.generator_table(cs, device=device)
    ident = gd.identity(cs, table.shape[:2], device=device).contiguous()
    k = rand_below(rng, S.modulus, S.limbs, (40,), device)
    k[:8] = 0
    k[8:16] &= 0xFF00
    fixed = [(f"{name}, {len(k)} lanes with digit-0 windows", lambda tab=tab: pk.pt_fixed_base(cs, tab, k),
              lambda tab=tab: pk.pt_fixed_base_plain(cs, tab.cpu(), k.cpu()))
             for name, tab in (("g's table", table), ("the identity's table", ident))]
    tree = []
    for m in EDGE_M:
        pts = rand_below(rng, F.modulus, F.limbs, (m, 4, cs.ncoords), device)
        tabs = rand_below(rng, F.modulus, F.limbs, (m, 4, 16, cs.ncoords), device)
        dig = torch.from_numpy(rng.integers(0, 16, size=(m,)).astype(np.int32)).to(device)
        tree += [(f"m={m} direct", lambda p=pts: pk.pt_tree_sum(cs, p.movedim(0, -3)),
                  lambda p=pts: pk.pt_tree_sum_plain(cs, p.movedim(0, -3).cpu())),
                 (f"m={m} gathered", lambda tb=tabs, d=dig: pk.pt_tree_sum(cs, tb.movedim(0, -4), d),
                  lambda tb=tabs, d=dig: pk.pt_tree_sum_plain(cs, tb.movedim(0, -4).cpu(), d.cpu()))]
    pts = rand_below(rng, F.modulus, F.limbs, (6, cs.ncoords), device)
    lane_tables = gd._build_table(cs, pts)  # (6, 16, C, L), a table a lane
    shared = lane_tables[1]
    ident_tables = gd._build_table(cs, gd.identity(cs, (6,), device=device).contiguous())
    ks = rand_below(rng, S.modulus, S.limbs, (6,), device)
    ks[0], ks[1] = 0, 0
    ks[1, 0] = 1
    ks[2] = fh.to_tensor(fh.encode(S, S.modulus - 1), device)
    ks[3] &= 0xF0F0  # every other digit window 0
    ks[4] &= 0x0F00
    scalar = [(f"{name}, k = 0, 1, order - 1 and zero digit windows",
               lambda tab=tab: pk.pt_scalar_mul(cs, tab, ks), lambda tab=tab: pk.pt_scalar_mul_plain(cs, tab.cpu(), ks.cpu()))
              for name, tab in (("a table a lane", lane_tables), ("a shared table", shared),
                                ("the identity's tables", ident_tables))]
    return {"pt_fixed_base": fixed, "pt_tree_sum": tree, "pt_scalar_mul": scalar}


def main() -> None:
    build.build((SOURCE, *ROUTE_SOURCES), [(SOURCE, d) for _, d, _ in VARIANTS[1:]])
    for label, d, _ in VARIANTS:
        for line in build.BUILD_LOGS.get(build.label(SOURCE, d), "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"ptxas {label}: {line.strip()}", flush=True)
    rng = np.random.default_rng(12)
    res, held = {}, 0
    for curve, n, t in PATHS:
        cs = gd.ALL_CURVES[curve]
        base = {op: pk.kernel_for(op, cs) for op in RULES}
        edges = {op: [(label, call, plain()) for label, call, plain in cases]
                 for op, cases in edge_cases(rng, curve, "cuda").items()}
        for vlabel, d, wanted in VARIANTS:
            for op, cases in edges.items():
                kernel = base[op].variant(*d) if d else base[op]
                for setting in settings(op, cs, wanted.get(curve, ())):
                    with forced(op, cs, kernel, setting):
                        for label, call, want in cases:
                            if not torch.equal(call().cpu(), want):
                                raise RuntimeError(f"{curve} {op} {vlabel} {setting}: {label} differs from "
                                                   "the plain version")
                            held += 1
        for label, (op, call, route) in shapes(rng, curve, n, t, "cuda").items():
            want = route()
            row = {"one_step_ms": device_ms(route, reps=2, spin=800_000_000)}
            for vlabel, d, wanted in VARIANTS:
                kernel = base[op].variant(*d) if d else base[op]
                for setting in settings(op, cs, wanted.get(curve, ())):
                    with forced(op, cs, kernel, setting):
                        if not torch.equal(call(), want):
                            raise RuntimeError(f"{curve} {label}: {vlabel} {setting} differs from the one-step route")
                        row[f"{vlabel} {setting}"] = device_ms(call)
            res[f"{curve} {label}"] = row
            print(f"{curve} {label}: " + json.dumps(row), flush=True)
    print(f"edges held: {held} calls (every build and setting; the tree at m = {EDGE_M} over 4 columns, direct "
          "and gathered; the fixed base over digit-0 windows and the identity's table; the scalar multiply at "
          "k = 0, 1, order - 1 and zero digit windows over a table a lane, a shared table and the identity's)",
          flush=True)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
