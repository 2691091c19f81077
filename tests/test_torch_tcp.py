"""The TCP hub (``dkg_tpu_torch.net.channel``) against the JAX package's,
on 127.0.0.1: a port ``TcpHubChannel`` talks to a JAX ``TcpHub`` and a JAX
channel to a port hub, byte for byte.  Publish and fetch, equivocation
evidence, ``PayloadTooLarge`` on both guard paths, a truncated stream,
junk frames, the retry budget and the ceremony-wide clamp, mirroring
``tests/test_net.py``; then a whole ceremony of each package's parties
over the other package's hub.
"""

from __future__ import annotations

import io
import random
import socket
import struct
import threading
import time

import pytest
from torch_port_util import one_thread  # noqa: F401

from dkg_tpu.net import channel as jch
from dkg_tpu.net import faults as jfaults
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.net import channel as tch
from dkg_tpu_torch.net import faults as tfaults

# (hub module, channel module): each direction of the interop
DIRECTIONS = {"port-channel-jax-hub": (jch, tch), "jax-channel-port-hub": (tch, jch)}


@pytest.fixture(params=list(DIRECTIONS))
def pair(request):
    hub_mod, chan_mod = DIRECTIONS[request.param]
    hub = hub_mod.TcpHub().start()
    yield hub_mod, chan_mod, hub
    hub.stop()


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_concurrent_publish_fetch_across_packages(pair):
    _, chan_mod, hub = pair
    host, port = hub.address
    n_workers = 6
    results, errors = [None] * n_workers, []

    def worker(i):
        try:
            chan = chan_mod.TcpHubChannel(host, port)
            for r in (1, 2):
                chan.publish(r, i, b"w%d-r%d" % (i, r) * (i + 1))
            chan.publish(3, i, b"")  # the protocol's explicit empty broadcast
            results[i] = {r: chan.fetch(r, expected=n_workers, timeout=10.0) for r in (1, 2, 3)}
        except Exception as exc:  # noqa: BLE001 -- surfaced by the assert
            errors.append((i, exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors
    for per_round in results:
        for r in (1, 2):
            assert per_round[r] == {j: b"w%d-r%d" % (j, r) * (j + 1) for j in range(n_workers)}
        assert per_round[3] == {j: b"" for j in range(n_workers)}


def test_equivocation_evidence_across_packages(pair):
    _, chan_mod, hub = pair
    host, port = hub.address
    a, b = chan_mod.TcpHubChannel(host, port), chan_mod.TcpHubChannel(host, port)
    a.publish(3, 5, b"one")
    b.publish(3, 5, b"two")  # conflicting second publish
    b.publish(3, 5, b"two")  # identical retry: not another attempt
    a.publish(4, 2, b"same")
    a.publish(4, 2, b"same")  # a duplicate is no equivocation
    assert a.fetch(3, 1, timeout=0.5) == {5: b"one"}
    assert b.equivocation_counts() == {(3, 5): 2}
    assert hub.channel.equivocation_evidence() == {(3, 5): (b"one", b"two")}


def test_payload_too_large_on_both_guard_paths(pair, monkeypatch):
    """The client guard raises before packing, carrying the size; the hub
    refuses to frame an oversized payload that entered through its backing
    channel (the client sees a transport error), and serves on."""
    hub_mod, chan_mod, hub = pair
    monkeypatch.setattr(chan_mod, "WIRE_MAX_PAYLOAD", 64)
    monkeypatch.setattr(hub_mod, "WIRE_MAX_PAYLOAD", 64)
    host, port = hub.address
    chan = chan_mod.TcpHubChannel(host, port, attempts=2, backoff_ms=1, io_timeout_s=1.0, rng=random.Random(9))
    with pytest.raises(chan_mod.PayloadTooLarge, match="65 bytes") as exc:
        chan.publish(1, 1, b"x" * 65)
    assert exc.value.size == 65 and exc.value.where == "client publish"
    chan.publish(1, 1, b"y" * 64)
    assert chan.fetch(1, expected=1, timeout=2.0) == {1: b"y" * 64}
    hub.channel.publish(2, 2, b"z" * 65)
    with pytest.raises(chan_mod.TransportError):
        chan.fetch(2, expected=1, timeout=2.0)
    chan.publish(3, 1, b"ok")
    assert chan.fetch(3, expected=1, timeout=2.0) == {1: b"ok"}


def test_truncated_stream_is_typed():
    with pytest.raises(tch.TruncatedStream) as exc_info:
        tch._read_exact(io.BytesIO(b"abc"), 8)
    assert isinstance(exc_info.value, tch.TransportError) and not isinstance(exc_info.value, EOFError)
    assert tch._read_exact(io.BytesIO(b"abcd"), 4) == b"abcd"
    with pytest.raises(tch.TransportError, match="error ack"):
        tch._read_ack(io.BytesIO(b"\x00"))


@pytest.mark.parametrize("hub_mod", [tch, jch], ids=["port-hub", "jax-hub"])
def test_junk_frames_get_an_error_byte(hub_mod):
    """Unknown opcode, a short frame, a half-closed header: each answered
    with the error byte within the frame timeout; a port client reads it
    as a retryable failure, and the hub serves on."""
    hub = hub_mod.TcpHub(frame_timeout_s=1.0).start()
    try:
        host, port = hub.address
        t0 = time.monotonic()
        with socket.create_connection((host, port), timeout=5.0) as s:
            s.sendall(bytes([0xFF]) + b"junk")
            assert s.recv(1) == b"\x00"
        with socket.create_connection((host, port), timeout=5.0) as s:
            s.sendall(bytes([1]) + struct.pack("<III", 1, 1, 100) + b"short")
            assert s.recv(1) == b"\x00"
        with socket.create_connection((host, port), timeout=5.0) as s:
            s.sendall(bytes([1]) + b"\x01\x00")
            s.shutdown(socket.SHUT_WR)
            assert s.recv(1) == b"\x00"
        assert time.monotonic() - t0 < 4.0
        chan = tch.TcpHubChannel(host, port, attempts=2, backoff_ms=1, rng=random.Random(4))
        with pytest.raises(tch.RetryBudgetExceeded, match="error ack"):
            chan._rpc(bytes([0xFE]), tch._read_ack, 5.0)
        chan.publish(1, 7, b"still alive")
        assert chan.fetch(1, 1, timeout=1.0) == {7: b"still alive"}
    finally:
        hub.stop()


def test_retries_through_a_late_jax_hub():
    """The port channel retries a refused publish until a JAX hub binds."""
    port, box = _free_port(), {}

    def start_hub_late():
        time.sleep(0.4)
        box["hub"] = jch.TcpHub(port=port).start()

    th = threading.Thread(target=start_hub_late)
    th.start()
    try:
        chan = tch.TcpHubChannel("127.0.0.1", port, attempts=30, backoff_ms=40, io_timeout_s=5.0,
                                 rng=random.Random(1))
        chan.publish(1, 1, b"made it")
        th.join(timeout=10)
        assert chan.stats["retries"] > 0
        assert box["hub"].channel.fetch(1, 1, timeout=1.0) == {1: b"made it"}
    finally:
        th.join(timeout=10)
        if "hub" in box:
            box["hub"].stop()


def test_retry_budget_and_ceremony_clamp():
    """Nothing listening: RetryBudgetExceeded after attempts - 1 retries.
    A ceremony budget clamps two empty fetches of a port hub to one shared
    deadline, and a silent server's publish and evidence to ~the floor."""
    chan = tch.TcpHubChannel("127.0.0.1", _free_port(), attempts=2, backoff_ms=1, io_timeout_s=0.5,
                             rng=random.Random(2))
    with pytest.raises(tch.RetryBudgetExceeded):
        chan.publish(1, 1, b"x")
    assert chan.stats["retries"] == 1
    hub = tch.TcpHub().start()
    try:
        chan = tch.TcpHubChannel(*hub.address, budget_s=0.6)
        t0 = time.monotonic()
        assert chan.fetch(1, expected=5, timeout=10.0) == {} and chan.fetch(2, expected=5, timeout=10.0) == {}
        assert time.monotonic() - t0 < 5.0 and chan.stats["budget_clamps"] == 2
    finally:
        hub.stop()
    srv = socket.socket()  # accepts connections, never replies
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    try:
        chan = tch.TcpHubChannel(*srv.getsockname(), attempts=3, backoff_ms=1, io_timeout_s=30.0, budget_s=0.5,
                                 rng=random.Random(3))
        t0 = time.monotonic()
        with pytest.raises(tch.RetryBudgetExceeded):
            chan.publish(1, 1, b"x")
        with pytest.raises(tch.RetryBudgetExceeded):
            chan.equivocation_counts()
        assert time.monotonic() - t0 < 10.0
        assert chan.stats["budget_clamps"] >= 2 and chan.stats["retries"] == 0
    finally:
        srv.close()


def test_net_knobs_validated(monkeypatch):
    monkeypatch.setenv("DKG_TPU_NET_ATTEMPTS", "0")
    with pytest.raises(ValueError, match="DKG_TPU_NET_ATTEMPTS"):
        tch.TcpHubChannel("127.0.0.1", 1)
    monkeypatch.delenv("DKG_TPU_NET_ATTEMPTS")
    monkeypatch.setenv("DKG_TPU_NET_TIMEOUT_S", "-3")
    with pytest.raises(ValueError, match="DKG_TPU_NET_TIMEOUT_S"):
        tch.TcpHubChannel("127.0.0.1", 1)
    monkeypatch.delenv("DKG_TPU_NET_TIMEOUT_S")
    monkeypatch.setenv("DKG_TPU_NET_BACKOFF_MS", "0")
    monkeypatch.setenv("DKG_TPU_NET_BUDGET_S", "90")
    chan = tch.TcpHubChannel("127.0.0.1", 1)
    assert chan._backoff_s == 0.0 and chan._budget_s == 90.0


@pytest.mark.parametrize("parties", ["port", "jax"])
def test_ceremony_over_the_other_package_hub(parties):
    """n = 3, t = 1 on ristretto255: the port's parties over a JAX hub, the
    JAX package's over a port hub; every party ok, one master key."""
    if parties == "port":
        faults, hub_mod, chan_mod, group = tfaults, jch, tch, tgh.RISTRETTO255
    else:
        from dkg_tpu.groups import host as jgh

        faults, hub_mod, chan_mod, group = jfaults, tch, jch, jgh.RISTRETTO255
    env, keys, pks = faults.make_committee(group, 3, 1, 0x7C9)
    hub = hub_mod.TcpHub().start()
    try:
        results = faults.run_with_faults(env, keys, pks, faults.FaultPlan(1),
                                         lambda i: chan_mod.TcpHubChannel(*hub.address), timeout=20.0, seed=3)
    finally:
        hub.stop()
    assert all(r.ok for r in results), [getattr(r, "error", r) for r in results]
    assert len({group.encode(r.master.point) for r in results}) == 1
