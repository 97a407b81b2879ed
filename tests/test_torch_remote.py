"""The multi-host plane of ``tests/test_remote.py`` on the port.

Port copies of the reference's ten tests, on ``infernos_tpu_torch.cluster
.remote``: ``call``/``ask`` mailbox semantics, callbacks and actor handles
crossing back, unknown actors, the LT bridge with its STT actor in another
process, fail-fast on a dead link, ``PeerLink`` redial with ``on_down`` /
``on_up``, send backpressure, the heartbeat and its legacy grace.

The peer is ``python -c`` of the port's ``ActorServer``; it imports the
actors it spawns (``tests.test_torch_remote:Pong``) by path and loads no
``jax`` or reference module.  One peer serves the tests that leave no
state behind; the death and redial tests each get their own.  Waits are on
events, with deadlines set from runs of the file beside one busy process
per core; the heartbeat is off on the test links, as in the reference (a
starved peer misses ``dead_after_s``).
Ports: SIP 25073 and 25083, RTP 40650-40950 (no other test file uses them).
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from infernos_tpu_torch.bench.phone import FarEnd
from infernos_tpu_torch.cluster import remote
from infernos_tpu_torch.cluster.actors import Actor, spawn, stop_all
from infernos_tpu_torch.media.rtp import RTPPacket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIP_PORT, BOB_PORT, RTP_PORTS = 25073, 25083, (40650, 40950)

CHILD_SRC = r"""
import sys
import torch
from infernos_tpu_torch.cluster import remote

torch.set_num_threads(2)
srv = remote.ActorServer(("127.0.0.1", 0))
print(f"PORT {srv.laddr[1]}", flush=True)
sys.stdin.readline()  # parent closes stdin to stop us
"""


class _ChildProc:
    """A peer process exposing an ActorServer; actors spawn on demand."""

    def __init__(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CHILD_SRC], env=env, cwd=REPO,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        assert line.startswith("PORT "), line
        self.port = int(line.split()[1])
        # heartbeat off: a loaded test host starves this process for
        # >dead_after_s during model starts (production keeps it on)
        self.conn = remote.connect(("127.0.0.1", self.port), heartbeat_s=0)

    def close(self):
        self.conn.close()
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module")
def shared_child():
    c = _ChildProc()
    yield c
    c.close()


@pytest.fixture
def child(shared_child):
    """The module's peer, for tests that leave no state behind in it."""
    assert not shared_child.conn.closed.is_set()
    return shared_child


@pytest.fixture
def own_child():
    c = _ChildProc()
    yield c
    c.close()


class Pong(Actor):
    def __init__(self):
        self.got = []
        self.got_evt = threading.Event()

    def ping(self, x):
        self.got.append(x)
        self.got_evt.set()
        return x * 2

    def call_me_back(self, cb, value):
        cb(value + 1)

    def poke_actor(self, handle, tag):
        # a proxied ActorHandle argument: call back into the peer's actor
        handle.call("ping", tag)


def test_remote_ask_call_roundtrip(child):
    h = child.conn.spawn_remote("tests.test_torch_remote:Pong", name="pong")
    assert h.ask_sync("ping", 21) == 42
    h.call("ping", 7)  # fire-and-forget
    # the mailbox is serial: an ask after the call answers after it ran
    assert h.ask_sync("ping", 1) == 2
    h.stop()


def test_remote_callback_crosses_back(child):
    h = child.conn.spawn_remote("tests.test_torch_remote:Pong", name="pong2")
    got = []
    evt = threading.Event()
    h.call("call_me_back", lambda v: (got.append(v), evt.set()), 41)
    assert evt.wait(30.0)
    assert got == [42]
    h.stop()


def test_remote_actor_handle_proxying(child):
    """Passing a LOCAL ActorHandle to a remote actor lets the remote side
    call back into this process's actor."""
    local = spawn(Pong, name="local-pong")
    try:
        h = child.conn.spawn_remote("tests.test_torch_remote:Pong", name="pong3")
        h.call("poke_actor", local, "hello")
        assert local._actor.got_evt.wait(30.0)
        assert "hello" in local._actor.got
        h.stop()
    finally:
        stop_all()


def test_remote_unknown_actor_errors(child):
    h = remote.RemoteActorHandle(child.conn, "nope")
    with pytest.raises(RuntimeError):
        h.ask_sync("x", timeout=10.0)


class _HearingFarEnd(FarEnd):
    """A ``FarEnd`` whose ``heard`` event is set once it has received more
    than 800 samples with one over 1e-3 (the reference test's condition,
    read as each packet arrives instead of polled)."""

    def __init__(self, port):
        self.heard = threading.Event()
        self._n, self._loud = 0, False
        super().__init__(port=port)

    def _rtp_in(self, data, addr, rtime):
        n = len(self.rx_packets)
        super()._rtp_in(data, addr, rtime)
        if len(self.rx_packets) > n:
            audio = self.codec.decode(RTPPacket.parse(data).payload)
            self._n += len(audio)
            self._loud = self._loud or bool(np.abs(audio).max() > 1e-3)
            if self._n > 800 and self._loud:
                self.heard.set()


@pytest.mark.e2e
def test_lt_call_with_remote_stt(child, tmp_path):
    """The full LT two-leg bridge with the STT actor living in ANOTHER
    process: Alice speaks, the remote STT transcribes, Bob hears TTS."""
    from infernos_tpu_torch.bench.phone import FakePhone
    from infernos_tpu_torch.config import InfernConfig
    from infernos_tpu_torch.main import build_cluster
    from test_torch_e2e_calls import _speechy

    stt = child.conn.spawn_remote(
        "infernos_tpu_torch.cluster.model_actors:STTActor", True,
        name="stt-far", device="cpu")
    stt.ask_sync("start", timeout=600.0)

    cfg_text = textwrap.dedent(f"""
        sip:
          settings:
            bind: 127.0.0.1:{SIP_PORT}
          profiles:
            inbound:
              sink: apps/live_translator/l1
            bob:
              sip_server: 127.0.0.1:{BOB_PORT}
        rtp:
          settings:
            min_port: {RTP_PORTS[0]}
            max_port: {RTP_PORTS[1]}
        apps:
          live_translator:
            profiles:
              l1:
                stt_langs: ['en', 'pt']
                tts_langs: ['pt', 'en']
                outbound: sip/bob;cld=900
    """)
    p = tmp_path / "lt.yaml"
    p.write_text(cfg_text)
    iconf = InfernConfig(str(p))
    bob = _HearingFarEnd(port=BOB_PORT)
    alice = None
    try:
        build_cluster(iconf, tiny=True, bind_ip="127.0.0.1", stt_actr=stt,
                      device="cpu")
        alice = FakePhone()
        alice.call(iconf.sip_conf.bind)
        assert alice.uac.connected
        assert bob.answered.wait(60.0), "outbound leg never reached Bob"
        alice.stream_bg(_speechy(1.2, seed=7), then_silence=True)
        heard = bob.heard.wait(240.0)
        alice.stop_streaming()
        assert heard, "no TTS audio reached Bob via remote STT"
        audio = bob.rx_audio()
        assert len(audio) > 800 and np.abs(audio).max() > 1e-3
        alice.hangup()
    finally:
        if alice:
            alice.close()
        bob.close()
        stop_all()
        stt.stop()


class Sleeper(Actor):
    def nap(self, seconds):
        time.sleep(seconds)
        return "rested"


def test_link_death_fails_futures_fast(own_child):
    """Kill the TCP link mid-call: in-flight asks fail fast with
    ConnectionError, not hang."""
    h = own_child.conn.spawn_remote("tests.test_torch_remote:Sleeper", name="sleeper")
    fut = h.ask("nap", 30.0)
    time.sleep(0.2)
    t0 = time.monotonic()
    own_child.conn.close()
    with pytest.raises((ConnectionError, RuntimeError)):
        fut.result(timeout=5.0)
    assert time.monotonic() - t0 < 2.0, "future did not fail fast"
    # sends on the dead link raise immediately instead of silently dropping
    with pytest.raises(ConnectionError):
        h.call("nap", 0.0)


def test_peerlink_reconnects_and_reregisters(own_child):
    """Kill and restore the link mid-call: on_down fires (owner EOSes),
    the link redials, on_up re-registers, and calls flow again."""
    ups, downs = [], []
    up_evt, down_evt = threading.Event(), threading.Event()

    def on_up(link):
        ups.append(time.monotonic())
        up_evt.set()

    def on_down(link):
        downs.append(time.monotonic())
        down_evt.set()

    link = remote.PeerLink(("127.0.0.1", own_child.port), on_up=on_up,
                           on_down=on_down, retry_min_s=0.1, heartbeat_s=0)
    try:
        assert len(ups) == 1  # initial connect counts as up
        h = link.handle("pong-rl")
        link.conn().spawn_remote("tests.test_torch_remote:Pong", name="pong-rl")
        assert h.ask_sync("ping", 5) == 10

        # sever the link (simulates a network blip; server side survives)
        up_evt.clear()
        link.conn().sock.shutdown(2)
        assert down_evt.wait(30.0), "on_down never fired"
        # during downtime: fail fast, not hang
        t0 = time.monotonic()
        try:
            h.ask_sync("ping", 1, timeout=5.0)
        except (ConnectionError, RuntimeError):
            pass
        assert time.monotonic() - t0 < 3.0

        assert up_evt.wait(30.0), "link did not reconnect"
        assert len(ups) == 2
        # re-registered surface works on the NEW connection
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                assert h.ask_sync("ping", 3, timeout=10.0) == 6
                break
            except (ConnectionError, RuntimeError):
                time.sleep(0.1)
        else:
            raise AssertionError("calls never recovered after reconnect")
    finally:
        link.close()


def test_send_backpressure_closes_stuck_link():
    """A peer that never drains trips the bounded queue -> ConnectionError,
    and the link is closed (undrainable == dead for real-time traffic)."""
    import socket as _socket

    srv = _socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = _socket.create_connection(srv.getsockname())
    peer, _ = srv.accept()  # never reads
    conn = remote.Connection(cli, name="stuck", send_queue=4,
                             send_timeout=0.3, heartbeat_s=0)
    try:
        big = b"x" * (1 << 20)
        with pytest.raises(ConnectionError):
            for _ in range(200):  # fill socket buffer + queue
                conn._send({"op": "call", "actor": "x", "method": "m",
                            "args": (big,), "kw": {}})
        assert conn.closed.is_set()
    finally:
        conn.close()
        peer.close()
        srv.close()


def test_heartbeat_detects_dead_peer():
    """A peer that stops responding is declared dead within dead_after_s."""
    import socket as _socket

    srv = _socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = _socket.create_connection(srv.getsockname())
    peer, _ = srv.accept()  # accepts but never answers pings
    conn = remote.Connection(cli, name="mute", heartbeat_s=0.2,
                             dead_after_s=0.8)
    try:
        assert conn.closed.wait(5.0), "dead peer not detected"
    finally:
        conn.close()
        peer.close()
        srv.close()


def test_heartbeat_legacy_grace(monkeypatch):
    """INFERNOS_HB_LEGACY_GRACE: a never-ponged (legacy-revision) peer is
    NOT torn down on rx silence during a mixed-version rollout window."""
    import socket as _socket

    monkeypatch.setenv("INFERNOS_HB_LEGACY_GRACE", "1")
    srv = _socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = _socket.create_connection(srv.getsockname())
    peer, _ = srv.accept()  # legacy peer: silent but TCP-alive
    conn = remote.Connection(cli, name="legacy", heartbeat_s=0.2,
                             dead_after_s=0.6)
    try:
        assert not conn.closed.wait(2.0), "legacy peer torn down under grace"
    finally:
        conn.close()
        peer.close()
        srv.close()
