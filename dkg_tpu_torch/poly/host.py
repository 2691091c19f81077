"""Host-side secret-sharing polynomials over a scalar field.

A JAX-free copy of ``dkg_tpu/poly/host.py``: the big-int oracle of
:mod:`.device` and the Lagrange coefficients ``sign.aggregate_host`` and
``sign.cache.SignCache`` derive on the host.  ``Polynomial`` (random
generation, Horner evaluation, ``at_zero``, add, mul), the typed
duplicate-node guard, scalar Lagrange coefficients and interpolation,
and full interpolation, with the JAX package's results.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.spec import FieldSpec


@dataclass(frozen=True)
class Polynomial:
    """coeffs[k] is the x**k coefficient; degree = len(coeffs)-1."""

    fs: FieldSpec
    coeffs: tuple

    @classmethod
    def random(cls, fs: FieldSpec, degree: int, rng) -> "Polynomial":
        """Uniform degree-``degree`` polynomial (reference:
        polynomial.rs:59-65 — t+1 random coefficients)."""
        return cls(fs, tuple(fs.rand_int(rng) for _ in range(degree + 1)))

    @classmethod
    def from_ints(cls, fs: FieldSpec, coeffs) -> "Polynomial":
        return cls(fs, tuple(int(c) % fs.modulus for c in coeffs))

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def evaluate(self, x: int) -> int:
        """Horner evaluation (reference: polynomial.rs:68-74)."""
        p, acc = self.fs.modulus, 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % p
        return acc

    def at_zero(self) -> int:
        """Constant term = the shared secret (reference: polynomial.rs:77-79)."""
        return self.coeffs[0]

    def __add__(self, other: "Polynomial") -> "Polynomial":
        p = self.fs.modulus
        n = max(len(self.coeffs), len(other.coeffs))
        a = list(self.coeffs) + [0] * (n - len(self.coeffs))
        b = list(other.coeffs) + [0] * (n - len(other.coeffs))
        return Polynomial(self.fs, tuple((x + y) % p for x, y in zip(a, b)))

    def __mul__(self, other: "Polynomial") -> "Polynomial":
        """Schoolbook product (reference: polynomial.rs:145-160)."""
        p = self.fs.modulus
        out = [0] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            for j, b in enumerate(other.coeffs):
                out[i + j] = (out[i + j] + a * b) % p
        return Polynomial(self.fs, tuple(out))


class DuplicateEvaluationPoints(ValueError):
    """Two Lagrange interpolation nodes coincide (mod p).

    The basis denominators prod (x_j - x_i) contain a zero factor, so
    the Fermat/Montgomery inversions silently return garbage instead of
    failing — every interpolation entry point (host and device) raises
    this typed error up front instead."""


def check_distinct_nodes(fs: FieldSpec, xs) -> None:
    """Raise :class:`DuplicateEvaluationPoints` unless all nodes are
    distinct mod p."""
    p = fs.modulus
    seen: dict[int, int] = {}
    for k, x in enumerate(xs):
        r = int(x) % p
        if r in seen:
            raise DuplicateEvaluationPoints(
                f"duplicate evaluation point x={r} at positions "
                f"{seen[r]} and {k}"
            )
        seen[r] = k


def lagrange_coefficient(fs: FieldSpec, eval_point: int, i: int, xs) -> int:
    """lambda_i(eval_point) = prod_{j != i} (x_j - e)/(x_j - x_i)
    (reference: polynomial.rs:162-170)."""
    check_distinct_nodes(fs, xs)
    p = fs.modulus
    num, den = 1, 1
    for j, xj in enumerate(xs):
        if j == i:
            continue
        num = num * (xj - eval_point) % p
        den = den * (xj - xs[i]) % p
    return num * pow(den, p - 2, p) % p


def lagrange_interpolation(fs: FieldSpec, eval_point: int, ys, xs) -> int:
    """Interpolate the unique degree-(m-1) polynomial through (xs, ys) and
    evaluate it at ``eval_point`` (reference: polynomial.rs:172-184).
    Protocol use: share reconstruction at 0 (committee.rs:784-789)."""
    if len(xs) != len(ys):
        raise ValueError("xs and ys must have equal length")
    check_distinct_nodes(fs, xs)
    p = fs.modulus
    acc = 0
    for i, yi in enumerate(ys):
        acc = (acc + yi * lagrange_coefficient(fs, eval_point, i, xs)) % p
    return acc


def interpolate(fs: FieldSpec, xs, ys) -> Polynomial:
    """Full polynomial interpolation (reference: polynomial.rs:92-110)."""
    if len(xs) != len(ys) or not xs:
        raise ValueError("need equal-length non-empty xs, ys")
    check_distinct_nodes(fs, xs)
    p = fs.modulus
    result = Polynomial(fs, (0,))
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = Polynomial(fs, (yi % p,))
        for j, xj in enumerate(xs):
            if j == i:
                continue
            inv = pow((xi - xj) % p, p - 2, p)
            # factor (x - x_j)/(x_i - x_j)
            term = term * Polynomial(fs, ((-xj) * inv % p, inv))
        result = result + term
    return result
