"""Field specifications for the PyTorch limb arithmetic.

A field element is ``L`` little-endian 16-bit limbs, the layout of the
JAX package (``dkg_tpu/fields/spec.py``), so tensors compare limb for
limb across the two.  The port stores limbs in ``int32`` tensors: every
limb is < 2**16, so the values are exact, and PyTorch's CPU build has
signed ``add`` and ``>>`` where it has none for ``uint32``.  The CUDA
kernels read the same memory as ``uint32_t``.

What the ported ceremonies need is here: the moduli of secp256k1,
ristretto255 and BLS12-381 G1 (its 381-bit base field takes L = 24
limbs), the Barrett constants the plain multiply uses, the constants of
the fused multiply-reduce (:class:`MulReduceSpec`, with their admission
proof), those of the linear-fold and pseudo-Mersenne reductions
(:class:`LinearReduceSpec`, :attr:`FieldSpec.fold_limbs`), and the limb
conversions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """Little-endian 16-bit limb decomposition of a non-negative int."""
    if x < 0:
        raise ValueError("int_to_limbs expects non-negative input")
    out = np.zeros(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x != 0:
        raise ValueError(f"value does not fit in {n_limbs} limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs` (accepts any 1-D integer array)."""
    acc = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        acc += int(limb) << (LIMB_BITS * i)
    return acc


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field with its limb-representation parameters."""

    name: str
    modulus: int
    limbs: int  # number of 16-bit limbs; modulus < 2**(16*limbs)

    def __post_init__(self):
        if self.modulus >= 1 << (LIMB_BITS * self.limbs):
            raise ValueError("modulus does not fit in the limb budget")
        # Barrett needs the top limb of p non-zero (p >= b**(L-1)).
        if self.modulus < 1 << (LIMB_BITS * (self.limbs - 1)):
            raise ValueError("modulus too small for limb count (Barrett)")

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def nbytes(self) -> int:
        """Canonical little-endian encoding length."""
        return (self.bits + 7) // 8

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.limbs)

    @functools.cached_property
    def p_limbs_ext(self) -> np.ndarray:
        """p padded to L+1 limbs (Barrett remainders live mod b**(L+1))."""
        return int_to_limbs(self.modulus, self.limbs + 1)

    @functools.cached_property
    def barrett_mu(self) -> np.ndarray:
        """floor(b**(2L) / p) as L+1 limbs."""
        mu = (1 << (2 * LIMB_BITS * self.limbs)) // self.modulus
        return int_to_limbs(mu, self.limbs + 1)

    @functools.cached_property
    def mulred(self) -> "MulReduceSpec | None":
        """Constants of the fused multiply-reduce (``fields.device._mul_gemm``
        and the ``mxu_mod_mul`` kernel), or ``None`` when the field fails
        admission.

        The *unnormalized* schoolbook product columns fold directly: each
        high column P_c (c >= L, < 2**22) splits into three bytes with
        residues 2**(16c + 8t) mod p, plus the spill digit P_{L-1} >> 16
        with residue 2**(16L) mod p: 3L+1 digits against one byte matrix,
        then scan-free column folds and a quotient table.  Every bound is
        proved with exact Python ints in :func:`_build_mulred`."""
        return _build_mulred(self)

    @functools.cached_property
    def linred(self) -> "LinearReduceSpec | None":
        """Constants of the linear-fold reduction (``fields.device.
        linear_reduce``), or ``None`` when the field fails admission.

        Reduction mod p is linear over limb values, so the high half of a
        normalized 2L-limb value folds in one step: its 2L bytes d_k
        against D_k = 2**(8k + 16L) mod p, a (2L, 2L) byte matrix whose
        column sums stay below 2**22; then the scan-free column folds
        through c = b**L mod p and the quotient table of
        :class:`MulReduceSpec`.  Every bound is proved with exact Python
        ints in :func:`_build_linred`."""
        return _build_linred(self)

    @functools.cached_property
    def fold_limbs(self) -> np.ndarray | None:
        """The pseudo-Mersenne fold constant c = b**L mod p as lc limbs, or
        ``None`` when the field is not fold-friendly (lc > 4, or two folds
        do not land below 3p).  The base fields of secp256k1 (c = 2**32 +
        977) and ed25519 (c = 38) admit it."""
        c = (1 << (LIMB_BITS * self.limbs)) % self.modulus
        lc = max(1, (c.bit_length() + LIMB_BITS - 1) // LIMB_BITS)
        if lc > 4 or 2 * lc + 1 > self.limbs:
            return None
        bound = (1 << (LIMB_BITS * self.limbs)) + (1 << (LIMB_BITS * (2 * lc + 1)))
        if bound > 3 * self.modulus:
            return None
        return int_to_limbs(c, lc)

    def rand_int(self, rng) -> int:
        """Uniform field element by rejection sampling from ``rng.getrandbits``
        (the same draw sequence as the JAX package, so one
        ``random.Random(seed)`` gives both packages the same values)."""
        while True:
            x = rng.getrandbits(self.bits)
            if x < self.modulus:
                return x


@dataclasses.dataclass(frozen=True)
class LinearReduceSpec:
    """Constants of the linear-fold reduction, every bound proved with exact
    integer arithmetic in :func:`_build_linred`.  ``fold8`` holds bytes,
    as uint8 (the JAX package keeps them as float32 for its matrix unit)."""

    fold8: np.ndarray  # (2L, 2L) uint8: fold8[k, m] = byte m of D_k
    c_limbs: np.ndarray  # (L,) uint32: c = b**L mod p
    n_split: int  # scan-free column-fold iterations
    shift_e: int  # quotient index = value >> (16*(L-1) + shift_e)
    qtable: np.ndarray  # (u_max+1,) uint32: floor(u * 2**s / p)
    np_limbs: np.ndarray  # (L+1,) uint32: b**(L+1) - p  (adds as "-p")


@dataclasses.dataclass(frozen=True)
class MulReduceSpec:
    """Constants of the fused multiply-reduce, every bound proved with
    exact integer arithmetic in :func:`_build_mulred`.

    Digit order (the plain version and the kernel build the digits in
    exactly this order): for the unnormalized product columns P_c,

    * digits [0, L)   -- byte 0 of P_c, c = L .. 2L-1
    * digits [L, 2L)  -- byte 1 of P_c, c = L .. 2L-1
    * digits [2L, 3L) -- byte 2 of P_c (< 2**6), c = L .. 2L-1
    * digit  3L       -- P_{L-1} >> 16 (< 2**6), residue b**L mod p

    ``foldm`` holds bytes, as uint8: the JAX package keeps the same values
    as float32 for its matrix unit; the port folds them as integers."""

    foldm: np.ndarray  # (3L+1, 2L) uint8: foldm[i, m] = byte m of R_i
    c_limbs: np.ndarray  # (L,) uint32: c = b**L mod p
    n_split: int  # scan-free column-fold iterations
    shift_e: int  # quotient index = value >> (16*(L-1) + shift_e)
    qtable: np.ndarray  # (u_max+1,) uint32: floor(u * 2**s / p)
    np_limbs: np.ndarray  # (L+1,) uint32: b**(L+1) - p  (adds as "-p")


def _fold_tail(fs: FieldSpec, colb: list) -> tuple | None:
    """Replay the scan-free column folds and derive the quotient table over
    exact per-column integer bounds ``colb``.

    Returns ``(n_split, shift_e, qtable, np_limbs, c)``, or ``None`` when
    an invariant fails (inadmissible rather than silently wrong)."""
    L, p, b = fs.limbs, fs.modulus, 1 << LIMB_BITS
    col_cap = (1 << 32) - (1 << LIMB_BITS)  # columns stay inside uint32
    if max(colb) > col_cap:
        return None

    # scan-free column folds: the top spill times c = b**L mod p
    c = (1 << (LIMB_BITS * L)) % p
    c_l = [int(v) for v in int_to_limbs(c, L)]
    vb = sum(cb << (LIMB_BITS * j) for j, cb in enumerate(colb))
    n_split, best = 0, (vb, list(colb))
    for it in range(1, 65):
        lob = [min(cb, b - 1) for cb in colb]
        hib = [cb >> LIMB_BITS for cb in colb]
        topb = hib[L - 1]
        colb = [lob[j] + (hib[j - 1] if j else 0) + topb * c_l[j] for j in range(L)]
        if max(colb) > col_cap:
            return None
        vb = sum(cb << (LIMB_BITS * j) for j, cb in enumerate(colb))
        if vb >= best[0]:
            break
        n_split, best = it, (vb, list(colb))
    vb = best[0]
    if vb >= 1 << (LIMB_BITS * (L + 1)):  # must normalize into L+1 limbs
        return None

    # quotient table over the top ~12 bits: with u = floor(v / 2**s) and
    # 2**s <= p the true quotient is qtable[u] or qtable[u] + 1, which one
    # conditional subtraction fixes
    u_full_bits = (vb >> (LIMB_BITS * (L - 1))).bit_length()
    shift_e = max(0, u_full_bits - 12)
    s = LIMB_BITS * (L - 1) + shift_e
    if (1 << s) > p:
        return None
    u_max = vb >> s
    if u_max >= 1 << 13:
        return None
    qtable = np.array([(u << s) // p for u in range(u_max + 1)], np.uint32)
    q_max = vb // p
    if (b - 1) + q_max * (b - 1) > col_cap:  # final-fold column bound
        return None
    np_limbs = int_to_limbs((1 << (LIMB_BITS * (L + 1))) - p, L + 1)
    return n_split, shift_e, qtable, np_limbs, c


def _build_linred(fs: FieldSpec) -> LinearReduceSpec | None:
    """Derive and prove the linear-fold constants: the algorithm of
    ``fields.device.linear_reduce`` replayed over exact per-column integer
    upper bounds (its input a normalized 2L-limb value)."""
    L, p, b = fs.limbs, fs.modulus, 1 << LIMB_BITS
    d_consts = [(1 << (8 * k + LIMB_BITS * L)) % p for k in range(2 * L)]
    fold8 = np.zeros((2 * L, 2 * L), np.uint8)
    for k, dk in enumerate(d_consts):
        for m in range(2 * L):
            fold8[k, m] = (dk >> (8 * m)) & 0xFF
    f8i = fold8.astype(np.int64)
    if int((255 * f8i.sum(axis=0)).max()) >= 1 << 24:  # fold column sums
        return None
    s16 = [int(255 * f8i[:, 2 * j].sum() + 256 * 255 * f8i[:, 2 * j + 1].sum()) for j in range(L)]
    tail = _fold_tail(fs, [(b - 1) + s for s in s16])  # + the input's low limb
    if tail is None:
        return None
    n_split, shift_e, qtable, np_limbs, c = tail
    return LinearReduceSpec(fold8=fold8, c_limbs=int_to_limbs(c, L), n_split=n_split, shift_e=shift_e,
                            qtable=qtable, np_limbs=np_limbs)


def _build_mulred(fs: FieldSpec) -> MulReduceSpec | None:
    """Derive and prove the fused multiply-reduce constants.

    The algorithm is replayed over exact per-column integer upper bounds.
    Its input is the unnormalized schoolbook product of two canonical
    elements: column P_c sums at most ``n_lo(c) + n_lo(c-1)`` terms of
    < 2**16 (the low and high halves of the 16x16 partial products), so
    P_c < 2**22 for L <= 24.  The fold sums (digit cap x byte) stay below
    2**24, so a uint32 (or float32) accumulator is exact."""
    L, b = fs.limbs, 1 << LIMB_BITS
    p = fs.modulus

    def n_lo(c: int) -> int:
        if c < 0 or c > 2 * L - 2:
            return 0
        return L - abs(c - (L - 1))

    pcap = [(n_lo(c) + n_lo(c - 1)) * (b - 1) for c in range(2 * L)]
    if max(pcap) >= 1 << 24:
        return None

    # digit caps and residues, in the MulReduceSpec digit order
    d_caps: list[int] = []
    residues: list[int] = []
    for t in range(3):
        for c in range(L, 2 * L):
            d_caps.append(min(0xFF, pcap[c] >> (8 * t)))
            residues.append((1 << (LIMB_BITS * c + 8 * t)) % p)
    d_caps.append(pcap[L - 1] >> LIMB_BITS)
    residues.append((1 << (LIMB_BITS * L)) % p)

    foldm = np.zeros((3 * L + 1, 2 * L), np.uint8)
    for i, r in enumerate(residues):
        for m in range(2 * L):
            foldm[i, m] = (r >> (8 * m)) & 0xFF
    fmi = foldm.astype(np.int64)
    caps = np.array(d_caps, np.int64)
    if int((caps[:, None] * fmi).sum(axis=0).max()) >= 1 << 24:  # fold column sums
        return None
    s16 = [int((caps * fmi[:, 2 * j]).sum() + 256 * (caps * fmi[:, 2 * j + 1]).sum()) for j in range(L)]
    # kept low part: full columns P_j for j < L-1, P_{L-1} mod 2**16
    keep = [pcap[j] for j in range(L - 1)] + [b - 1]
    tail = _fold_tail(fs, [k + s for k, s in zip(keep, s16)])
    if tail is None:
        return None
    n_split, shift_e, qtable, np_limbs, c = tail
    return MulReduceSpec(foldm=foldm, c_limbs=int_to_limbs(c, L), n_split=n_split, shift_e=shift_e,
                         qtable=qtable, np_limbs=np_limbs)


P25519 = FieldSpec("ed25519_base", (1 << 255) - 19, 16)
L25519 = FieldSpec(
    "ed25519_scalar",
    (1 << 252) + 27742317777372353535851937790883648493,
    16,
)
SECP256K1_P = FieldSpec("secp256k1_base", (1 << 256) - (1 << 32) - 977, 16)
SECP256K1_N = FieldSpec(
    "secp256k1_scalar",
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    16,
)

BLS12_381_P = FieldSpec(
    "bls12_381_base",
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    24,
)
BLS12_381_R = FieldSpec(
    "bls12_381_scalar",
    0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    16,
)

ALL_FIELDS = {
    fs.name: fs for fs in (P25519, L25519, SECP256K1_P, SECP256K1_N, BLS12_381_P, BLS12_381_R)
}
