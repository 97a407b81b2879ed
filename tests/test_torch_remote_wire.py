"""The port's multi-host plane against the reference's, on the wire.

- Plain-data frames (an ``ask`` with numpy and scalar arguments, a
  ``result`` of each kind, ``ping``, ``pong``, ``stop_actor``) are the same
  bytes on the socket from both packages' ``Connection``s (the pickle and
  its 4-byte big-endian length), and each package's ``_Unpickler`` reads
  the other's.
- The same ``ask`` / ``call`` / callback / handle-proxy / unknown-actor
  sequence against a ``Pong``-like actor gives the same results through
  both planes (an ``ActorServer`` and a ``connect`` of each package in
  this process).
- An STT session served from a peer process (``chip_smoke.Peer``, the
  tiny-real ``STTActor`` on the CPU) sends and receives no
  ``torch.Tensor`` in any frame, and the pickler refuses a tensor and a
  module; the tokens that come back through the wire for fixed utterances
  equal those of the reference's ``STTActor`` in this process on the same
  tiny-real weights and audio (fp32, exact).
"""

import dataclasses
import io
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import chip_smoke as cs
import infernos_tpu.serving.sessions as jses
from infernos_tpu.audio.chunk import AudioChunk as JChunk
from infernos_tpu.cluster import actors as jactors
from infernos_tpu.cluster import remote as jremote
from infernos_tpu.cluster.model_actors import STTActor as JSTTActor
import infernos_tpu_torch.serving.sessions as pses
from infernos_tpu_torch.audio.chunk import AudioChunk
from infernos_tpu_torch.cluster import actors as pactors
from infernos_tpu_torch.cluster import remote as premote

SAYINGS = (("please help now", 5), ("quero ajuda hoje", 7), ("want help today", 21))

FRAMES = (
    {"op": "ask", "id": 7, "actor": "stt:c1", "method": "stt_session_soundin",
     "args": (np.linspace(-1, 1, 480, dtype=np.float32), 3, 2.5, "pt", None, True,
              (1, 2), [np.int64(50258), 0.125]),
     "kw": {"lang": "en", "ids": np.arange(6, dtype=np.int64).reshape(2, 3)}},
    {"op": "call", "actor": "tts:c1:en", "method": "tts_session_end", "args": (11,), "kw": {}},
    {"op": "result", "id": 7, "ok": True, "value": {"tokens": [1, 2, 3], "p": 0.5}},
    {"op": "result", "id": 8, "ok": False, "error": "RuntimeError('no CUDA device')"},
    {"op": "ping"},
    {"op": "pong"},
    {"op": "stop_actor", "actor": "stt:c1"},
)


def _wire_bytes(mod, msg) -> bytes:
    """``msg`` as ``mod``'s ``Connection`` puts it on a socket."""
    a, b = socket.socketpair()
    conn = mod.Connection(a, name="wire", heartbeat_s=0)
    try:
        conn._send(msg)
        hdr = b""
        while len(hdr) < 4:
            hdr += b.recv(4 - len(hdr))
        n = struct.unpack("!I", hdr)[0]
        body = b""
        while len(body) < n:
            body += b.recv(n - len(body))
        return hdr + body
    finally:
        conn.close()
        b.close()


def _same(x, y):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return (type(x) is type(y) and x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y))
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(_same(a, b) for a, b in zip(x, y)))
    return type(x) is type(y) and x == y


@pytest.mark.parametrize("i", range(len(FRAMES)), ids=[f["op"] for f in FRAMES])
def test_plain_frames_are_the_same_bytes_and_read_across(i):
    msg = FRAMES[i]
    ref, port = _wire_bytes(jremote, msg), _wire_bytes(premote, msg)
    assert port == ref
    assert struct.unpack("!I", port[:4])[0] == len(port) - 4
    for reader in (jremote, premote):
        for data in (ref, port):
            back = reader._Unpickler(io.BytesIO(data[4:]), None).load()
            assert _same(back, msg), (reader.__name__, back)


class JPong(jactors.Actor):
    def __init__(self):
        self.got = []
        self.got_evt = threading.Event()

    def ping(self, x):
        self.got.append(x)
        self.got_evt.set()
        return x * 2

    def echo(self, *a, **kw):
        return a, kw

    def call_me_back(self, cb, value):
        cb(value + 1)

    def poke_actor(self, handle, tag):
        handle.call("ping", tag)


class PPong(pactors.Actor):
    __init__, ping, echo = JPong.__init__, JPong.ping, JPong.echo
    call_me_back, poke_actor = JPong.call_me_back, JPong.poke_actor


def _sequence(remote, actors, pong):
    """The reference test's sequence through one package's plane, both ends
    in this process; returns what each step gave."""
    srv = remote.ActorServer(("127.0.0.1", 0))
    conn = remote.connect(srv.laddr, heartbeat_s=0)
    out = []
    try:
        h = conn.spawn_remote(f"test_torch_remote_wire:{pong.__name__}", name="wire-pong",
                              timeout=30.0)
        out.append(type(h).__name__)
        out.append(h.ask_sync("ping", 21))
        h.call("ping", 7)
        out.append(h.ask_sync("ping", 1))
        a, kw = h.ask_sync("echo", np.arange(4, dtype=np.float32), 2.5, tag="x")
        out.append((a[0].tolist(), a[1], kw))
        got, evt = [], threading.Event()
        h.call("call_me_back", lambda v: (got.append(v), evt.set()), 41)
        assert evt.wait(30.0)
        out.append(got)
        local = actors.spawn(pong, name="wire-local")
        h.call("poke_actor", local, "hello")
        assert local._actor.got_evt.wait(30.0)
        out.append(local._actor.got)
        try:
            remote.RemoteActorHandle(conn, "nope").ask_sync("x", timeout=10.0)
        except RuntimeError as e:
            out.append(str(e))
        out.append(actors.lookup("wire-pong")._actor.got)
    finally:
        conn.close()
        srv.close()
        actors.stop_all()
    return out


def test_same_sequence_through_both_planes():
    ref = _sequence(jremote, jactors, JPong)
    port = _sequence(premote, pactors, PPong)
    assert port == ref
    assert ref[:3] == ["RemoteActorHandle", 42, 2] and ref[4] == [42]
    assert ref[5] == ["hello"] and ref[-1] == [21, 7, 1]


def _tensors(obj, seen=None):
    """The ``torch.Tensor``s anywhere inside ``obj``."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif hasattr(obj, "__dict__") and not callable(obj):
        items = list(vars(obj).values())
    else:
        return []
    return [t for it in items for t in _tensors(it, seen)]


def _transcripts(actor, ses, chunk_cls):
    sid = actor.ask_sync("new_stt_session", False, timeout=60.0)
    out = []
    for text, seed in SAYINGS:  # each after the last: the same batches
        done = threading.Event()
        actor.call("stt_session_soundin", sid, ses.STTRequest(
            chunk=chunk_cls(cs.render_speech(text, seed), 8000),
            text_cb=lambda res, done=done: (out.append(res), done.set()), lang="en"))
        assert done.wait(300.0), "STT actor did not answer"
    actor.ask_sync("stt_session_end", sid, timeout=60.0)
    return [(r.text, list(r.tokens)) for r in out]


def test_remote_stt_session_carries_no_tensor_and_matches_the_reference(monkeypatch):
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "tiny-real")
    peer = cs.Peer({"INFERNOS_MODEL_MODE": "tiny-real", "OMP_NUM_THREADS": "2"},
                   heartbeat_s=0)
    ref = jactors.spawn(JSTTActor, name="wire-j-stt")
    try:
        conn = peer.conn
        sent, received = [], []
        send, dispatch = conn._send, conn._dispatch

        def record_send(msg):
            sent.append(msg)
            return send(msg)

        def record_dispatch(msg):
            received.append(msg)
            return dispatch(msg)

        conn._send, conn._dispatch = record_send, record_dispatch
        far = conn.spawn_remote("infernos_tpu_torch.cluster.model_actors:STTActor",
                                name="wire-stt", device="cpu", timeout=60.0)
        far.ask_sync("start", timeout=600.0)
        ref.ask_sync("start", timeout=600.0)
        got = _transcripts(far, pses, AudioChunk)
        want = _transcripts(ref, jses, JChunk)
        assert got == want
        assert all(text for text, _ in got)

        ops = {m["op"] for m in sent} | {m["op"] for m in received}
        assert {"spawn", "ask", "call", "result", "cb"} <= ops
        assert [m for m in sent + received if _tensors(m)] == []
        results = [m["args"][0] for m in received if m["op"] == "cb"]
        assert [list(r.tokens) for r in results] == [t for _, t in want]
        assert all(isinstance(r.no_speech_prob, float) for r in results)

        for bad in (torch.zeros(3), torch.nn.Linear(2, 2)):
            with pytest.raises(TypeError, match="does not cross the wire"):
                far.call("stt_session_end", bad)
        assert far.ask_sync("stt_session_end", None, timeout=60.0) is None
    finally:
        ref.stop()
        jactors.stop_all()
        peer.close()
