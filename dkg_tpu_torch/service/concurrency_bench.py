"""The ceremony service's worker count on one warm runtime.

Runs ``scripts/fleet_bench.py``'s workload (its ``MIX``, shuffled by seed
1, rho_bits 64, ``batch_max`` 8) through :class:`CeremonyScheduler` once
for each ``--concurrency`` in turn, on one :class:`WarmRuntime` warmed at
each bucket's widths, and prints a JSON line a pass: seconds,
ceremonies/s, p50 and p99 of submit to ``completed_at``, convoys by
bucket and width.  Every outcome must be ``done``.  With ``--profile N``,
one more pass over the first N requests at concurrency 1 under
``torch.profiler``: the device's busy share of its wall.

    python3 -m dkg_tpu_torch.service.concurrency_bench \\
        [--concurrency 4 1 1 4] [--ceremonies 1000] [--profile 200] [--device cuda]

Nothing runs at import.  On the card, build the kernels first
(``ops.build.build``, which this does).
"""

from __future__ import annotations

import argparse
import json
import random
import time

#: scripts/fleet_bench.py's MIX: (n, t, count) of 1000 ceremonies
MIX = ((16, 5, 896), (24, 8, 56), (32, 8, 24), (48, 16, 16), (64, 16, 8))
SEED, RHO_BITS, BATCH_MAX = 1, 64, 8


def workload(curve: str, ceremonies: int) -> list:
    """fleet_bench's requests, scaled to ``ceremonies``, shuffled by SEED."""
    from .engine import CeremonyRequest

    scale = ceremonies / sum(c for _, _, c in MIX)
    reqs = [CeremonyRequest(curve, n, t, seed=SEED * 1_000_000 + n * 1_000 + i, rho_bits=RHO_BITS)
            for n, t, count in MIX for i in range(round(count * scale))]
    random.Random(SEED).shuffle(reqs)
    return reqs


class _Widths:
    """A fault plan that injects nothing: counts convoy starts by bucket
    and width."""

    def __init__(self):
        self.counts: dict = {}

    def on_start(self, reqs) -> None:
        b = reqs[0].bucket()
        key = f"{b.n}x{b.t} w{len(reqs)}"
        self.counts[key] = self.counts.get(key, 0) + 1

    def on_finish(self, reqs) -> None:
        pass


def one_pass(runtime, reqs: list, concurrency: int) -> dict:
    from .scheduler import CeremonyScheduler

    widths = _Widths()
    with CeremonyScheduler(concurrency=concurrency, batch_max=BATCH_MAX, queue_depth=len(reqs),
                           runtime=runtime, fault_plan=widths) as sch:
        t0 = time.monotonic()
        ids = [sch.submit(r) for r in reqs]
        outs = [sch.result(i, timeout=900) for i in ids]
        total = time.monotonic() - t0
    bad = [o.status for o in outs if o.status != "done"]
    if bad:
        raise RuntimeError(f"concurrency {concurrency}: {len(bad)} outcomes not done ({sorted(set(bad))})")
    lat = sorted(o.completed_at - t0 for o in outs)
    return {"concurrency": concurrency, "seconds": total, "ceremonies_per_s": len(reqs) / total,
            "p50_s": lat[len(lat) // 2], "p99_s": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "convoys": widths.counts}


def main(argv=None) -> None:
    import torch

    from ..ops import build
    from . import buckets
    from .engine import WarmRuntime

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--concurrency", type=int, nargs="+", default=[4, 1, 1, 4])
    ap.add_argument("--ceremonies", type=int, default=1000)
    ap.add_argument("--profile", type=int, default=200, help="requests of the profiled pass (0: none)")
    ap.add_argument("--curve", default="secp256k1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        t0 = time.perf_counter()
        build.build()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    runtime = WarmRuntime(device=args.device)
    reqs = workload(args.curve, args.ceremonies)
    t0 = time.perf_counter()
    first = {}
    for r in reqs:
        first.setdefault(r.bucket(), r)
    for b, r in sorted(first.items(), key=lambda kv: kv[0].n):
        runtime.warmup(r, widths=tuple(sorted({min(w, buckets.width_cap(b)) for w in (BATCH_MAX, 1)}, reverse=True)))
    print(f"warmup {time.perf_counter() - t0:.3f} s", flush=True)
    for conc in args.concurrency:
        print("pass " + json.dumps(one_pass(runtime, reqs, conc)), flush=True)
    if args.profile and cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_pass(runtime, reqs[: args.profile], 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        print(f"profiled pass, concurrency 1, {args.profile} requests: wall {wall:.3f} s, device busy "
              f"{busy:.3f} s ({100 * busy / wall:.2f} %)", flush=True)


if __name__ == "__main__":
    main()
