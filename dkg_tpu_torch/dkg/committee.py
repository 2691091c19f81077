"""The GJKR committee state machine, phases 1-5: the wire protocol a
committee runs when its members do not trust one another.

A JAX-free copy of ``dkg_tpu/dkg/committee.py``, host code over the
port's host groups: dealing (``DistributedKeyGeneration.init``), share
verification with evidence-carrying complaints (``DkgPhase1.proceed``),
the qualified set and the bare commitments (``DkgPhase2.proceed``), their
re-verification (``DkgPhase3.proceed``), round-4 adjudication and share
disclosure (``DkgPhase4.proceed``), and the master key with the Lagrange
reconstruction of a disqualified-late party's secret
(``DkgPhase5.finalise``).  Each transition returns
``(next phase or DkgError, broadcast or None)``: errors are values,
since a failing party may still have evidence to publish.  Other
parties' messages come in as ``Fetched*`` views; the network is the
caller's.  ``dkg/committee_batch.py`` runs rounds 1 and 2 for many
co-located parties on the card with the same results.

The JAX package's fixes of reference quirks come across: phase 2 checks
the threshold against the members actually qualified, reconstruction
needs t + 1 disclosed points, and ``init`` checks the caller's index
against the sorted committee instead of trusting it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..crypto.commitment import CommitmentKey
from ..crypto.elgamal import seal_pair
from ..poly.host import Polynomial, lagrange_interpolation
from .broadcast import (BroadcastPhase1, BroadcastPhase2, BroadcastPhase3, BroadcastPhase4, BroadcastPhase5,
                        DisclosedShare, EncryptedShares, MisbehavingPartiesRound1, MisbehavingPartiesRound3,
                        ProofOfMisbehaviour, check_bare_share, check_randomized_share)
from .errors import DkgError, DkgErrorKind
from .procedure_keys import (MasterPublicKey, MemberCommunicationKey, MemberCommunicationPublicKey,
                             MemberPublicShare, MemberSecretShare, decrypt_shares_detailed, sort_committee)


@dataclass(frozen=True)
class Environment:
    """The ceremony's parameters."""

    group: object
    threshold: int
    nr_members: int
    commitment_key: CommitmentKey

    @classmethod
    def init(cls, group, threshold: int, nr_members: int, shared_string: bytes) -> "Environment":
        if threshold < 1 or nr_members < 1:
            raise ValueError("threshold and committee size must be positive")
        if not threshold < (nr_members + 1) / 2:  # honest majority
            raise ValueError("threshold must satisfy t < (n+1)/2")
        return cls(group, threshold, nr_members, CommitmentKey.generate(group, shared_string))


# ---------------------------------------------------------------------------
# other parties' broadcasts as a phase consumes them
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FetchedPhase1:
    """One counterparty's round-1 message; a None payload (missing, or of
    the wrong shape) is a silent dropout."""

    sender_index: int
    broadcast: Optional[BroadcastPhase1]

    @classmethod
    def from_broadcast(cls, env: Environment, sender_index: int, b: Optional[BroadcastPhase1]) -> "FetchedPhase1":
        if b is not None and (len(b.committed_coefficients) != env.threshold + 1
                              or len(b.encrypted_shares) != env.nr_members):
            b = None
        return cls(sender_index, b)


@dataclass(frozen=True)
class FetchedComplaints2:
    accuser_index: int
    broadcast: Optional[BroadcastPhase2]


@dataclass(frozen=True)
class FetchedPhase3:
    sender_index: int
    broadcast: Optional[BroadcastPhase3]

    @classmethod
    def from_broadcast(cls, env: Environment, sender_index: int, b: Optional[BroadcastPhase3]) -> "FetchedPhase3":
        if b is not None and len(b.committed_coefficients) != env.threshold + 1:
            b = None
        return cls(sender_index, b)


@dataclass(frozen=True)
class FetchedComplaints4:
    accuser_index: int
    broadcast: Optional[BroadcastPhase4]


@dataclass(frozen=True)
class FetchedPhase5:
    sender_index: int
    broadcast: Optional[BroadcastPhase5]


class _State:
    """A party's mutable protocol state."""

    def __init__(self, env: Environment, index: int, comm_key: MemberCommunicationKey,
                 members_pks: list[MemberCommunicationPublicKey]):
        self.env = env
        self.index = index  # 1-based position in the sorted committee
        self.comm_key = comm_key
        self.members_pks = members_pks
        # own dealing
        self.bare_coeff_points: tuple = ()  # A_l = g·a_l
        self.randomized_coeff_points: tuple = ()  # E_l = g·a_l + h·b_l
        # per-sender data gathered across rounds (1-based keys)
        self.received_shares: dict[int, tuple[int, int]] = {}
        self.randomized_coeffs: dict[int, tuple] = {}
        self.bare_coeffs: dict[int, tuple] = {}
        self.qualified: list[int] = [1] * env.nr_members
        self.reconstructable: set[int] = set()
        self.phase3_accused: set[int] = set()
        self.final_share: Optional[int] = None
        self.public_share: Optional[tuple] = None

    @property
    def group(self):
        return self.env.group

    def qualified_count(self) -> int:
        return sum(self.qualified)

    def disqualify(self, index: int) -> None:
        self.qualified[index - 1] = 0


class DistributedKeyGeneration:
    """The entry point: round-1 dealing, giving phase 1."""

    @staticmethod
    def init(env: Environment, rng, comm_key: MemberCommunicationKey,
             committee_pks: list[MemberCommunicationPublicKey], my: int) -> tuple["DkgPhase1", BroadcastPhase1]:
        """Deal as party ``my`` (1-based, checked against this key's place
        in the sorted committee): the sharing and hiding polynomials drawn
        from ``rng``, their commitments, and each member's pair sealed under
        one KEM point, r drawn from ``rng`` in recipient order."""
        group = env.group
        if len(committee_pks) != env.nr_members:
            raise ValueError("committee size does not match environment")
        pks = sort_committee(group, committee_pks)
        if not group.eq(pks[my - 1].point, comm_key.public().point):
            raise ValueError("`my` does not match this key's sorted position")

        state = _State(env, my, comm_key, pks)
        t = env.threshold
        fs = group.scalar_field
        sharing = Polynomial.random(fs, t, rng)  # f
        hiding = Polynomial.random(fs, t, rng)  # f'

        bare, randomized = [], []
        for a_l, b_l in zip(sharing.coeffs, hiding.coeffs):
            apub = group.scalar_mul(a_l, group.generator())
            bare.append(apub)
            randomized.append(group.add(group.scalar_mul(b_l, env.commitment_key.h), apub))
        state.bare_coeff_points = tuple(bare)
        state.randomized_coeff_points = tuple(randomized)
        state.randomized_coeffs[my] = tuple(randomized)
        state.bare_coeffs[my] = tuple(bare)

        encrypted = []
        for i in range(1, env.nr_members + 1):
            s_i = sharing.evaluate(i)
            r_i = hiding.evaluate(i)
            if i == my:
                state.received_shares[my] = (s_i, r_i)
            share_ct, rand_ct = seal_pair(group, pks[i - 1].point, group.scalar_to_bytes(s_i),
                                          group.scalar_to_bytes(r_i), rng)
            encrypted.append(EncryptedShares(i, share_ct, rand_ct))
        return DkgPhase1(state), BroadcastPhase1(tuple(randomized), tuple(encrypted))


class DkgPhase1:
    """``proceed``: round-2 share verification."""

    def __init__(self, state: _State):
        self._state = state

    def proceed(self, fetched: list[FetchedPhase1], rng) -> tuple["DkgPhase2 | DkgError", Optional[BroadcastPhase2]]:
        """Open and check every other dealer's pair, in fetched order: a
        silent dealer is disqualified; a pair not addressed to us is an
        error; an undecodable pair or one the commitments reject
        disqualifies its dealer and files a complaint with evidence (its
        proofs' nonces drawn from ``rng``).  More than t complaints abort,
        the complaints still published."""
        st = self._state
        group, env = st.group, st.env
        complaints: list[MisbehavingPartiesRound1] = []

        for f in fetched:
            j = f.sender_index
            if j == st.index:
                continue
            if f.broadcast is None:
                st.disqualify(j)  # silent dropout
                continue
            mine = f.broadcast.shares_for(st.index)
            if mine is None or mine.recipient_index != st.index:
                return DkgError(DkgErrorKind.FETCHED_INVALID_DATA, index=j), None
            (s, r), bad_kind = decrypt_shares_detailed(group, st.comm_key, mine.share_ct, mine.randomness_ct)
            if s is None or r is None:
                st.disqualify(j)
                complaints.append(MisbehavingPartiesRound1(j, bad_kind or DkgErrorKind.SCALAR_OUT_OF_BOUNDS,
                                                           ProofOfMisbehaviour.generate(group, mine, st.comm_key,
                                                                                        rng)))
                continue
            coeffs = f.broadcast.committed_coefficients
            if not check_randomized_share(group, env.commitment_key, st.index, s, r, coeffs):
                st.disqualify(j)
                complaints.append(MisbehavingPartiesRound1(j, DkgErrorKind.SHARE_VALIDITY_FAILED,
                                                           ProofOfMisbehaviour.generate(group, mine, st.comm_key,
                                                                                        rng)))
                continue
            st.received_shares[j] = (s, r)
            st.randomized_coeffs[j] = tuple(coeffs)

        broadcast = BroadcastPhase2(tuple(complaints)) if complaints else None
        if len(complaints) > env.threshold:
            return DkgError(DkgErrorKind.MISBEHAVIOUR_HIGHER_THRESHOLD), broadcast
        return DkgPhase2(st), broadcast


class DkgPhase2:
    """``proceed``: round 3, the qualified set from the round-2
    complaints, the final share, and the bare commitments published."""

    def __init__(self, state: _State):
        self._state = state

    def proceed(self, complaints: list[FetchedComplaints2],
                round1_broadcasts: list[FetchedPhase1]) -> tuple["DkgPhase3 | DkgError", Optional[BroadcastPhase3]]:
        st = self._state
        group, env = st.group, st.env
        by_sender = {f.sender_index: f.broadcast for f in round1_broadcasts}

        # one upheld complaint disqualifies the accused
        for fc in complaints:
            if fc.broadcast is None:
                continue
            accuser_pk = st.members_pks[fc.accuser_index - 1]
            for m in fc.broadcast.misbehaving_parties:
                accused_b = by_sender.get(m.accused_index)
                if accused_b is None:
                    st.disqualify(m.accused_index)  # never dealt: already out by silence
                    continue
                if m.verify(group, env.commitment_key, fc.accuser_index, accuser_pk, accused_b):
                    st.disqualify(m.accused_index)

        if st.qualified_count() < env.threshold + 1:
            return DkgError(DkgErrorKind.NOT_ENOUGH_MEMBERS), None

        fs_mod = group.scalar_field.modulus
        total = 0
        for j in range(1, env.nr_members + 1):
            if st.qualified[j - 1] and j in st.received_shares:
                total = (total + st.received_shares[j][0]) % fs_mod
        st.final_share = total
        st.public_share = group.scalar_mul(total, group.generator())
        return DkgPhase3(st), BroadcastPhase3(st.bare_coeff_points)


class DkgPhase3:
    """``proceed``: round 4, every qualified dealer's share re-checked
    against its bare commitments."""

    def __init__(self, state: _State):
        self._state = state

    def proceed(self, fetched: list[FetchedPhase3]) -> tuple["DkgPhase4 | DkgError", Optional[BroadcastPhase4]]:
        st = self._state
        group = st.group
        complaints: list[MisbehavingPartiesRound3] = []
        by_sender = {f.sender_index: f.broadcast for f in fetched}

        for j in range(1, st.env.nr_members + 1):
            if j == st.index or not st.qualified[j - 1]:
                continue
            if j not in st.received_shares:
                continue
            s, r = st.received_shares[j]
            b = by_sender.get(j)
            if b is None:
                # a qualified dealer went silent: disclose its share
                complaints.append(MisbehavingPartiesRound3(j, s, r))
                st.phase3_accused.add(j)
                continue
            coeffs = b.committed_coefficients
            st.bare_coeffs[j] = tuple(coeffs)
            if not check_bare_share(group, st.index, s, coeffs):
                complaints.append(MisbehavingPartiesRound3(j, s, r))
                st.phase3_accused.add(j)

        broadcast = BroadcastPhase4(tuple(complaints)) if complaints else None
        if st.qualified_count() - len(st.phase3_accused) < st.env.threshold + 1:
            return DkgError(DkgErrorKind.NOT_ENOUGH_MEMBERS), broadcast
        return DkgPhase4(st), broadcast


class DkgPhase4:
    """``proceed``: round 5, the round-4 complaints adjudicated; an upheld
    accused stays in the key but its secret is reconstructed, and every
    party discloses the shares it holds of it."""

    def __init__(self, state: _State):
        self._state = state

    def proceed(self, complaints: list[FetchedComplaints4]) -> tuple["DkgPhase5 | DkgError", Optional[BroadcastPhase5]]:
        st = self._state
        group, env = st.group, st.env

        for fc in complaints:
            if fc.broadcast is None:
                continue
            for m in fc.broadcast.misbehaving_parties:
                j = m.accused_index
                if not st.qualified[j - 1]:
                    continue
                randomized = st.randomized_coeffs.get(j)
                if randomized is None:
                    continue
                if m.verify(group, env.commitment_key, fc.accuser_index, randomized, st.bare_coeffs.get(j)):
                    st.reconstructable.add(j)

        st.reconstructable |= st.phase3_accused
        if st.qualified_count() - len(st.reconstructable) < env.threshold + 1:
            return DkgError(DkgErrorKind.NOT_ENOUGH_MEMBERS), None

        disclosures = tuple(DisclosedShare(j, st.index, st.received_shares[j][0])
                            for j in sorted(st.reconstructable) if j in st.received_shares)
        return DkgPhase5(st), BroadcastPhase5(disclosures) if disclosures else None


class DkgPhase5:
    """``finalise``: the master key, with the Lagrange reconstruction of
    each reconstructable party's secret from t + 1 disclosed shares."""

    def __init__(self, state: _State):
        self._state = state

    def finalise(self, fetched: list[FetchedPhase5]
                 ) -> tuple[tuple[MasterPublicKey, MemberSecretShare] | DkgError, None]:
        st = self._state
        group, env = st.group, st.env
        fs = group.scalar_field

        # accused -> {holder index: share}
        points: dict[int, dict[int, int]] = {j: {} for j in st.reconstructable}
        for j in st.reconstructable:
            if j in st.received_shares:
                points[j][st.index] = st.received_shares[j][0]
        for f in fetched:
            if f.broadcast is None:
                continue
            for d in f.broadcast.disclosed_shares:
                if d.accused_index in points:
                    points[d.accused_index][d.holder_index] = d.share

        master = group.identity()
        for j in range(1, env.nr_members + 1):
            if not st.qualified[j - 1]:
                continue
            if j in st.reconstructable:
                xs = sorted(points[j])
                ys = [points[j][x] for x in xs]
                if len(xs) < env.threshold + 1:  # a degree-t polynomial needs t + 1 points
                    return DkgError(DkgErrorKind.INSUFFICIENT_SHARES_FOR_RECOVERY, index=j), None
                recovered = lagrange_interpolation(fs, 0, ys, xs)
                master = group.add(master, group.scalar_mul(recovered, group.generator()))
            else:
                coeffs = st.bare_coeffs.get(j)
                if coeffs is None:
                    return DkgError(DkgErrorKind.NOT_ENOUGH_MEMBERS, index=j), None
                master = group.add(master, coeffs[0])  # A_{j,0} = g·a_{j,0}

        assert st.final_share is not None
        return (MasterPublicKey(master), MemberSecretShare(st.final_share)), None

    @property
    def public_share(self) -> MemberPublicShare:
        return MemberPublicShare(self._state.public_share)

    @property
    def qualified_set(self) -> list[int]:
        return list(self._state.qualified)
