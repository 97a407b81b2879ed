"""The port's daemon entry point, ``python -m infernos_tpu_torch``.

- A usage error exits 2.
- Without a card and without ``INFERNOS_DEVICE=cpu`` it exits non-zero
  with ``default_device``'s message before it reads the config's apps,
  binds a socket or spawns an actor; without ``-f`` the daemon child logs
  that message (the parent has returned 0 at the fork).
- With ``INFERNOS_DEVICE=cpu -t`` it comes up in the foreground and
  forked, answers a SIP OPTIONS, and exits 0 on SIGTERM; so does it with
  an ``ai_attendant`` profile (STT, TTS and LLM actors).
Ports: SIP 25090-25093, RTP 35000-35800 (no other test file uses them;
test_torch_boundaries.py takes SIP 25094 and RTP 35900-35990).  The forked
daemon outlives the test's process (it calls setsid), so the test kills it
by its pid file on every way out, and asks OPTIONS until a deadline; should
a daemon of an earlier, cut run still hold SIP 25092, it serves on the first
free port of 25100-25109 instead (reserved for this file).
"""

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch import main as pmain
from infernos_tpu_torch.cluster import actors

ROOT = Path(__file__).resolve().parents[1]
NO_CARD = "no CUDA device"


def _config(tmp_path, sip_port, rtp_min, app="live_translator"):
    profile = {"live_translator": "stt_langs: ['en', 'pt']\n"
                                  "                tts_langs: ['pt', 'en']",
               "ai_attendant": "stt_lang: en\n                tts_lang: en"}[app]
    p = tmp_path / f"{app}.yaml"
    p.write_text(textwrap.dedent(f"""
        sip:
          settings:
            bind: 127.0.0.1:{sip_port}
          profiles:
            inbound:
              sink: apps/{app}/c1
        rtp:
          settings:
            min_port: {rtp_min}
            max_port: {rtp_min + 200}
        apps:
          {app}:
            profiles:
              c1:
                {profile}
    """))
    return p


def _env(**kw):
    env = dict(os.environ)
    env.pop("INFERNOS_DEVICE", None)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(kw)
    return env


def _wait_log(path, text, proc=None, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        log = path.read_text() if path.exists() else ""
        if text in log:
            return log
        if proc is not None and proc.poll() is not None:
            break
        time.sleep(0.2)
    pytest.fail(f"{text!r} not in the daemon log:\n{path.read_text() if path.exists() else ''}")


def _port_free(port):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def _free_sip_port(first, spare=range(25100, 25110)):
    """``first`` if nothing holds it, else the first free port of ``spare``."""
    return next(p for p in (first, *spare) if _port_free(p))


def _options_until(port, timeout=60.0):
    """The status code of the first SIP OPTIONS to 127.0.0.1:``port`` that is
    answered (each ask waits 2 s), asking again until ``timeout``; None if
    none is."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code = cs.sip_options(("127.0.0.1", port))
        if code is not None:
            return code
        time.sleep(0.5)
    return None


def _gone(pid, timeout=30.0):
    """Whether ``pid`` has exited (a zombie that no one reaps counts)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X"):
                    return True
        except FileNotFoundError:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.1)


@pytest.mark.parametrize("argv", [["prog"], ["prog", "-z", "c.yaml"],
                                  ["prog", "a.yaml", "b.yaml"]])
def test_usage_error_exits_2(argv, capsys):
    assert pmain.main(argv) == 2
    assert "usage:" in capsys.readouterr().err


def test_no_card_foreground_exits_before_anything(tmp_path, monkeypatch, capsys):
    """In process: ``default_device`` fails first, so neither the config
    nor the cluster is touched and no actor exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    called = []
    monkeypatch.setattr(pmain, "InfernConfig", lambda *a: called.append(a))
    monkeypatch.setattr(pmain, "build_cluster", lambda *a, **k: called.append(a))
    cfg = _config(tmp_path, 25090, 35000)
    assert pmain.main(["prog", "-f", str(cfg)]) == 1
    assert NO_CARD in capsys.readouterr().err
    assert called == [] and actors.lookup("sip") is None and actors.lookup("rtp") is None


def test_no_card_daemon_exits_nonzero(tmp_path):
    cfg = _config(tmp_path, 25090, 35000)
    proc = subprocess.run([sys.executable, "-m", "infernos_tpu_torch", "-f", str(cfg)],
                          cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and NO_CARD in proc.stderr
    assert _port_free(25090)

    # forked: the parent returns 0; the daemon child logs why it stopped
    log, pidf = tmp_path / "d.log", tmp_path / "d.pid"
    proc = subprocess.run([sys.executable, "-m", "infernos_tpu_torch", "-L", str(log),
                           "-i", str(pidf), str(cfg)], cwd=tmp_path,
                          env=_env(CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert proc.returncode == 0
    _wait_log(log, NO_CARD)
    assert _gone(int(pidf.read_text()))
    assert _port_free(25090)


def test_cpu_daemon_foreground_answers_and_stops(tmp_path):
    cfg = _config(tmp_path, 25091, 35200)
    log = tmp_path / "fg.log"
    with open(log, "w") as sink:
        proc = subprocess.Popen([sys.executable, "-m", "infernos_tpu_torch", "-f", "-t",
                                 str(cfg)], cwd=tmp_path, env=_env(INFERNOS_DEVICE="cpu"),
                                stdout=sink, stderr=subprocess.STDOUT)
    try:
        _wait_log(log, "infernos_tpu_torch up", proc)
        assert cs.sip_options(("127.0.0.1", 25091)) == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cpu_daemon_forked_answers_and_stops(tmp_path):
    """The non-``-f`` path: the grandchild serves after the two forks."""
    port = _free_sip_port(25092)
    cfg = _config(tmp_path, port, 35400)
    log, pidf = tmp_path / "bg.log", tmp_path / "bg.pid"
    try:
        proc = subprocess.run([sys.executable, "-m", "infernos_tpu_torch", "-t", "-L",
                               str(log), "-i", str(pidf), str(cfg)], cwd=tmp_path,
                              env=_env(INFERNOS_DEVICE="cpu"), timeout=120)
        assert proc.returncode == 0
        _wait_log(log, "infernos_tpu_torch up")
        pid = int(pidf.read_text())
        assert _options_until(port) == 200
        os.kill(pid, signal.SIGTERM)
        assert _gone(pid, 60.0), log.read_text()
        assert "shutting down" in log.read_text()
    finally:
        # the pid file is written before the daemon boots: a daemon left
        # booting or serving by a failure above is killed here, not left
        # holding its ports for the next run
        left = pidf.read_text().strip() if pidf.exists() else ""
        if left and not _gone(int(left), 0.0):
            os.kill(int(left), signal.SIGKILL)


def test_cpu_daemon_serves_an_ai_attendant_profile(tmp_path):
    cfg = _config(tmp_path, 25093, 35600, app="ai_attendant")
    log = tmp_path / "aia.log"
    with open(log, "w") as sink:
        proc = subprocess.Popen([sys.executable, "-m", "infernos_tpu_torch", "-f", "-t",
                                 str(cfg)], cwd=tmp_path, env=_env(INFERNOS_DEVICE="cpu"),
                                stdout=sink, stderr=subprocess.STDOUT)
    try:
        text = _wait_log(log, "infernos_tpu_torch up", proc)
        assert "LLMActor started" in text and "AIAActor c1 ready" in text
        assert cs.sip_options(("127.0.0.1", 25093)) == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
