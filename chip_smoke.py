"""Drive the PyTorch/CUDA port of the batched ceremony on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels of dkg_tpu_torch/csrc, one nvcc per source,
   all started together, and prints the build time and what ptxas says
   about registers and spills.
3. Holds every kernel against its plain PyTorch version on the card, bit
   for bit: at 2**16 random lanes, and at the shapes the ceremony gives
   it, where both are also timed (CUDA events over repeated wrapper
   calls, the operands' broadcast copies included).
4. Runs the main path, BatchedCeremony("secp256k1", 1024, 341).run() on
   the card, with every kernel's launch count set to 0 just before and
   read just after; every count must be > 0.  Checks ok, the master key,
   some commitments and shares against host big-int oracles.
   Then splits the fiat_shamir phase, and runs the main path once more
   under torch.profiler for device time by kernel and the busy share.
5. Runs a tampered (n=16, t=5) ceremony: one corrupted share must fail
   its recipient's batch check, blame its dealer, and leave the master
   key of the qualified set.
6. Prints one JSON line of per-kernel numbers, the card line again, and
   last {"ok": true, "device": {...}}.

Any failure raises, so the script exits non-zero without the last line;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from dkg_tpu_torch.crypto.blake2s import row_digests_np
from dkg_tpu_torch.dkg import ceremony as cer
from dkg_tpu_torch.fields import device as fd
from dkg_tpu_torch.fields import host as fh
from dkg_tpu_torch.groups import device as gd
from dkg_tpu_torch.groups import host as gh
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import point_kernels as pk

N, T = 1024, 341  # the main path: BASELINE.md config 3, secp256k1 n=1024 t=341
INDEX_BITS = N.bit_length()
RANDOM_LANES = 1 << 16

# Peak rates of an H100 SXM at its 700 W limit (NVIDIA data sheet and
# Hopper whitepaper): HBM3 bytes, and 32-bit integer multiplies (132 SMs
# x 64 INT32 lanes x 1.98 GHz boost).
BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9

# 32x32->64-bit multiply-adds per lane of the kernels in csrc/: a base
# field multiply is 86 (64 schoolbook + 22 fold), a multiply by 3b = 21 is
# 12, a scalar-field multiply-add 134 (64 + 70).  Each counts as two 32-bit
# multiplies (the low and the high half of the product).
_FMUL, _FSMALL = 86, 12
_ADD = 12 * _FMUL + 2 * _FSMALL
_MADD = 11 * _FMUL + 2 * _FSMALL
_DOUBLE = 8 * _FMUL + _FSMALL
MULADDS = {
    "mod_madd": 134,
    "pt_add": _ADD,
    "pt_madd": _MADD,
    "pt_window_step": 4 * _DOUBLE + _ADD,
}


def muladds(name: str, main_args: list, lanes: int) -> int:
    """Multiply-adds the function needs on these inputs.  x of the ladder
    is public, so x·P + A needs only bit_length(x) - 1 doublings and
    popcount(x) adds (popcount(x) - 1 inside x·P, one for A); the kernel
    itself runs a fixed INDEX_BITS double-and-adds a lane."""
    if name != "pt_ladder_mul_add":
        return MULADDS[name] * lanes
    xs = main_args[2].cpu().tolist()
    return sum(max(x.bit_length() - 1, 0) * _DOUBLE + bin(x).count("1") * _ADD for x in xs)
KERNELS = (fk.MOD_MADD, *pk.KERNELS)
REPLACES = {
    "mod_madd": ("dkg_tpu_torch/csrc/field_kernels.cu", "dkg_tpu/ops/pallas_field.py:301"),
    "pt_add": ("dkg_tpu_torch/csrc/point_kernels.cu", "dkg_tpu/ops/pallas_point.py:258"),
    "pt_madd": ("dkg_tpu_torch/csrc/point_kernels.cu", "dkg_tpu/ops/pallas_point.py:281"),
    "pt_window_step": ("dkg_tpu_torch/csrc/point_kernels.cu", "dkg_tpu/ops/pallas_point.py:328"),
    "pt_ladder_mul_add": ("dkg_tpu_torch/csrc/point_kernels.cu", "dkg_tpu/ops/pallas_point.py:356"),
}

CS = gd.SECP256K1
G = gh.SECP256K1


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# inputs from a numpy seed
# ---------------------------------------------------------------------------


def rand_field(rng, fs, batch: tuple, edges: bool = True) -> torch.Tensor:
    """Canonical random elements (..., L); with ``edges`` the first lanes
    are 0, 1 and p-1."""
    limbs = rng.integers(0, 1 << 16, size=batch + (fs.limbs,), dtype=np.int64)
    limbs[..., -1] = np.minimum(limbs[..., -1], 0xFFFE)  # < 2**256 - 2**240 < p, n
    if edges:
        flat = limbs.reshape(-1, fs.limbs)
        for i, v in enumerate((0, 1, fs.modulus - 1)[: len(flat)]):
            flat[i] = fh.encode(fs, v)
    return torch.from_numpy(limbs.astype(np.int32)).cuda()


def point_pool(rng, k: int = 64) -> torch.Tensor:
    """k affine multiples of G (Z = 1), from host big-int scalar mults."""
    pts = []
    for _ in range(k):
        x, y = G.to_affine(G.scalar_mul(int(rng.integers(1, 1 << 62)), G.generator()))
        pts.append((x, y, 1))
    return gd.from_host(CS, pts, device="cuda")


def rand_points(rng, pool, batch: tuple, affine: bool = False) -> torch.Tensor:
    """On-curve points drawn from ``pool``; projective ones rescaled by a
    random non-zero lambda, every 7th lane the identity (0, lambda, 0)."""
    pts = pool[torch.from_numpy(rng.integers(0, len(pool), size=batch)).cuda()]
    if affine:
        return pts
    lam = rand_field(rng, CS.field, batch, edges=False)
    lam[..., 0] |= 1  # non-zero, and still < p (the top limb is < 0xFFFF)
    pts = torch.stack([fd.mul(CS.field, pts[..., c, :], lam) for c in range(3)], dim=-2)
    flat = pts.view(-1, 3, CS.field.limbs)
    flat[3::7, 0] = 0
    flat[3::7, 2] = 0
    return pts


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def held(name: str, wrapper, plain, args) -> int:
    got, want = wrapper(*args), plain(*args)
    sync()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
    return err


def kernel_cases(rng, pool):
    """Per kernel: (wrapper, plain, args at 2**16 random lanes, args at the main path's shapes)."""
    S = CS.scalar
    R = (RANDOM_LANES,)
    x_rand = torch.from_numpy(rng.integers(0, 1 << INDEX_BITS, size=R).astype(np.int32)).cuda()
    x_main = torch.arange(1, N + 1, dtype=torch.int32, device="cuda")
    return {
        "mod_madd": (
            lambda a, b, c: fk.mod_madd(S, a, b, c),
            lambda a, b, c: fk.mod_madd_plain(S, a, b, c),
            [rand_field(rng, S, R) for _ in range(3)],
            # eval_many's Horner step: acc (n, n, L), x (n, L), coefficient (n, 1, L)
            [rand_field(rng, S, (N, N)), rand_field(rng, S, (N,)), rand_field(rng, S, (N, 1))],
        ),
        "pt_add": (
            lambda p, q: pk.pt_add(CS, p, q),
            lambda p, q: pk.pt_add_plain(CS, p, q),
            [rand_points(rng, pool, R), rand_points(rng, pool, R)],
            # E = A + h·b over every dealer's t+1 coefficients
            [rand_points(rng, pool, (N, T + 1)), rand_points(rng, pool, (N, T + 1))],
        ),
        "pt_madd": (
            lambda p, q: pk.pt_madd(CS, p, q),
            lambda p, q: pk.pt_madd_plain(CS, p, q),
            [rand_points(rng, pool, R), rand_points(rng, pool, R, affine=True)],
            # one fixed_base_mul window over every dealer's t+1 coefficients
            [rand_points(rng, pool, (N, T + 1)), rand_points(rng, pool, (N, T + 1), affine=True)],
        ),
        "pt_window_step": (
            lambda a, e: pk.pt_window_step(CS, a, e, gd.WINDOW),
            lambda a, e: pk.pt_window_step_plain(CS, a, e, gd.WINDOW),
            [rand_points(rng, pool, R), rand_points(rng, pool, R)],
            # one Straus window of the point RLC over the t+1 columns
            [rand_points(rng, pool, (T + 1,)), rand_points(rng, pool, (T + 1,))],
        ),
        "pt_ladder_mul_add": (
            lambda p, a, x: pk.pt_ladder_mul_add(CS, p, a, x, INDEX_BITS),
            lambda p, a, x: pk.pt_ladder_mul_add_plain(CS, p, a, x, INDEX_BITS),
            [rand_points(rng, pool, R), rand_points(rng, pool, R), x_rand],
            # one Horner step of eval_point_poly: acc (n,), D_l one point, x = 1..n
            [rand_points(rng, pool, (N,)), rand_points(rng, pool, ()), x_main],
        ),
    }


def check_kernels(rng) -> dict:
    pool = point_pool(rng)
    out = {}
    for name, (wrapper, plain, rand_args, main_args) in kernel_cases(rng, pool).items():
        if name == "mod_madd":  # the base field's template too, at random lanes
            args = [rand_field(rng, CS.field, (RANDOM_LANES,)) for _ in range(3)]
            held(name + "[base]", lambda a, b, c: fk.mod_madd(CS.field, a, b, c),
                 lambda a, b, c: fk.mod_madd_plain(CS.field, a, b, c), args)
        err = max(held(name, wrapper, plain, rand_args), held(name, wrapper, plain, main_args))
        ms = cuda_ms(lambda: wrapper(*main_args), reps=10)
        plain_ms = cuda_ms(lambda: plain(*main_args), reps=2)
        res = wrapper(*main_args)
        lanes = res.numel() // (CS.scalar.limbs if name == "mod_madd" else 3 * CS.field.limbs)
        nbytes = sum(a.numel() * a.element_size() for a in main_args) + res.numel() * 4
        ops = 2 * muladds(name, main_args, lanes)
        bytes_ms, ops_ms = 1e3 * nbytes / BYTES_PER_S, 1e3 * ops / INT32_MUL_PER_S
        out[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "lanes": lanes,
        }
        print(f"kernel {name}: exact at {RANDOM_LANES} random lanes and {lanes} main-path lanes; "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']})", flush=True)
    return out


# ---------------------------------------------------------------------------
# the ceremonies against host oracles
# ---------------------------------------------------------------------------


def host_point(pt: torch.Tensor) -> tuple:
    return gd.to_host(CS, pt.reshape(1, 3, -1))[0]


def eval_host(coeffs_row, x: int) -> int:
    q = CS.scalar.modulus
    acc = 0
    for c in reversed(coeffs_row):
        acc = (acc * x + int(c)) % q
    return acc


def main_path(seed: int) -> tuple[dict, dict]:
    for k in KERNELS:
        k.launches = 0
    c = cer.BatchedCeremony("secp256k1", N, T, b"chip-smoke", random.Random(seed), device="cuda")
    out = c.run()
    sync()
    launches = {k.name: k.launches for k in KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print("main path: phases " + json.dumps({k: round(v, 6) for k, v in out["phase_seconds"].items()})
          + f", peak device memory {peak_gib:.2f} GiB", flush=True)
    print("main path: launches " + json.dumps(launches), flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    q = CS.scalar.modulus
    check("error" not in out and out["complaints"] == [], "the honest ceremony blamed a dealer")
    check(out["ok"].shape == (N,) and bool(out["ok"].all()), "a batch check failed")
    check(tuple(out["bare"].shape) == (N, T + 1, 3, 16) and tuple(out["shares"].shape) == (N, N, 16),
          "round-1 tensors have the wrong shape")
    a = fh.decode(CS.scalar, fh.from_tensor(c.coeffs_a))  # (n, t+1) ints
    secret = sum(int(v) for v in a[:, 0]) % q
    check(G.eq(host_point(out["master"]), G.scalar_mul(secret, G.generator())),
          "master key != g·(Σ_j a_j0)")
    for j, l in ((0, 0), (N - 1, T)):
        check(G.eq(host_point(out["bare"][j, l]), G.scalar_mul(int(a[j, l]), G.generator())),
              f"bare commitment A[{j}, {l}] != g·a")
    col = [sum(int(v) for v in a[:, l]) % q for l in range(T + 1)]
    finals = fh.decode(CS.scalar, fh.from_tensor(out["final_shares"]))
    shares = fh.decode(CS.scalar, fh.from_tensor(out["shares"][:, [0, N // 2, N - 1]]))
    for k, i in enumerate((1, N // 2 + 1, N)):
        check(int(finals[i - 1]) == eval_host(col, i), f"final share of party {i} != Σ_j f_j({i})")
        for j in (0, N - 1):
            check(int(shares[j, k]) == eval_host(a[j], i), f"share s[{j}, {i - 1}] != f_{j}({i})")
    print("main path: ok for all recipients; master key, commitments and shares match "
          "the host oracles", flush=True)
    fiat_shamir_breakdown(c.cfg, out)
    return launches, out["phase_seconds"]


def fiat_shamir_breakdown(cfg, out) -> None:
    """Host-clock split of the fiat_shamir phase, its steps redone on the
    main path's round-1 tensors."""
    t = [time.perf_counter()]
    a, e, s, r = (fh.from_tensor(out[k]) for k in ("bare", "randomized", "shares", "hidings"))
    t.append(time.perf_counter())
    a, e = gd.affine_canon_host(CS, a), gd.affine_canon_host(CS, e)
    t.append(time.perf_counter())
    sr = np.concatenate([s.reshape(N, -1), r.reshape(N, -1)], axis=-1)
    rows = [row_digests_np(x.reshape(N, -1), domain=d) for d, x in ((1, a), (2, e), (3, sr))]
    t.append(time.perf_counter())
    cer.fiat_shamir_rho(cfg, cer._fold_digest_device(cfg, *rows), 128)
    t.append(time.perf_counter())
    check(all(x.shape == (N, 8) for x in rows), "row digests have the wrong shape")
    steps = ("device to host", "canonical affine A, E", "BLAKE2s rows", "fold and rho")
    print("fiat_shamir breakdown (host clock, s): " + json.dumps(
        {k: round(t[i + 1] - t[i], 6) for i, k in enumerate(steps)}), flush=True)


PROFILE_GROUPS = (
    ("mod_madd_kernel", "mod_madd"), ("pt_add_kernel", "pt_add"), ("pt_madd_kernel", "pt_madd"),
    ("pt_window_step_kernel", "pt_window_step"), ("pt_ladder_kernel", "pt_ladder_mul_add"),
    ("Memcpy DtoH", "copy to host"),
)


def profile_main_path(seed: int) -> None:
    """The main path once more under torch.profiler: device time by kernel
    (everything not ours is PyTorch's own ops: the plain tensor code and
    the wrappers' broadcast copies) and the device's busy share of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    c = cer.BatchedCeremony("secp256k1", N, T, b"chip-smoke", random.Random(seed), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c.run()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device_ms: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for key, g in PROFILE_GROUPS if key in e.name), "torch ops")
        device_ms[group] = device_ms.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(device_ms.values())
    check(all(device_ms.get(g, 0) > 0 for _, g in PROFILE_GROUPS[:5]), f"profile saw {device_ms}")
    print(f"profile: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall_ms:.2f} %), "
          "device ms " + json.dumps({k: round(v, 3) for k, v in sorted(device_ms.items())}), flush=True)


def tampered(seed: int) -> None:
    n, t, dealer, recipient = 16, 5, 3, 7
    fs = CS.scalar

    def tamper(a, e, s, r):
        s = s.clone()
        s[dealer, recipient] = fd.add(fs, s[dealer, recipient], fd.ones(fs, device=s.device))
        return a, e, s, r

    c = cer.BatchedCeremony("secp256k1", n, t, b"chip-smoke-tamper", random.Random(seed), device="cuda")
    out = c.run(tamper=tamper)
    ok = out["ok"].cpu().tolist()
    check(ok == [i != recipient for i in range(n)], f"tampered batch checks {ok}")
    check(out["complaints"] == [(recipient + 1, dealer + 1)], f"complaints {out['complaints']}")
    qual = out["qualified"].cpu().tolist()
    check(qual == [j != dealer for j in range(n)], f"qualified {qual}")
    a = fh.decode(fs, fh.from_tensor(c.coeffs_a))
    secret = sum(int(a[j, 0]) for j in range(n) if j != dealer) % fs.modulus
    check(G.eq(host_point(out["master"]), G.scalar_mul(secret, G.generator())),
          "tampered ceremony's master key != g·(Σ over the qualified set)")
    print(f"tampered (n={n}, t={t}): recipient {recipient + 1} failed its batch check, dealer "
          f"{dealer + 1} blamed, master key of the qualified set matches", flush=True)


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
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(build.SOURCES)}", flush=True)
    for src, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "entry function" in line or "spill" in line or "registers" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)

    rng = np.random.default_rng(args.seed)
    numbers = check_kernels(rng)
    launches, _ = main_path(args.seed)
    profile_main_path(args.seed)
    tampered(args.seed + 1)

    rows = []
    for name, rec in numbers.items():
        source, replaces = REPLACES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], **{k: v for k, v in rec.items() if k != "lanes"}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
