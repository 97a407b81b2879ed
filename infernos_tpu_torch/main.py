"""CLI daemon entry point.

Capability parity with ``Infernos.py:28-92``: ``python -m infernos_tpu_torch
[-f] [-L logfile] [-i pidfile] [-t] config.yaml`` -- parse flags, daemonize
unless foreground, build the validated config, spawn the actor graph
(RTP -> apps -> SIP), and block for the process lifetime.

Port of ``infernos_tpu/main.py``.  What differs, and why:

- The daemon serves on the card.  ``INFERNOS_DEVICE`` names another
  device (``cpu``), the counterpart of the ``JAX_PLATFORMS=cpu`` the
  reference honours; without it and without a card the daemon exits
  non-zero before it binds a socket or spawns an actor.  There is no
  degraded boot: the reference's fallback to the CPU when its accelerator
  is dead (``ensure_backend_or_degrade``) would hide the card.
- Nothing touches the card before the daemonizing forks: a CUDA context
  does not survive a ``fork``.
- The XLA compile cache has no counterpart: the kernels are built once per
  checkout by ``ops/build.py``.
"""

from __future__ import annotations

import getopt
import os
import signal
import sys
import threading
from typing import Dict, List, Optional

from .cluster.actors import ActorHandle, spawn, stop_all
from .cluster.rtp_actor import RTPActor
from .config import InfernConfig
from .config.config import AIAProfileConf, LTProfileConf
from .utils.logging import get_logger
from .utils.platform import default_device, model_start_timeout

log = get_logger("main")

USAGE = "usage: {} [-f] [-L logfile] [-i pidfile] [-t] config.yaml"


def build_cluster(iconf: InfernConfig, tiny: bool = False,
                  bind_ip: Optional[str] = None,
                  stt_actr: Optional[ActorHandle] = None,
                  start_kwargs: Optional[dict] = None,
                  device=None) -> Dict[str, ActorHandle]:
    """Spawn and wire the full actor graph from a validated config.

    ``stt_actr``: pre-existing STT actor handle to share instead of
    starting one per app -- typically a ``cluster.remote.RemoteActorHandle``
    placing the STT leg in another process or on another host (the
    reference's Ray cross-host placement, SURVEY.md section 2.9), started
    there on its own card.  ``device``: where the models and the VAD run;
    None means the card (``utils.platform.default_device``), which raises
    without one before anything is spawned.
    """
    from .apps.ai_attendant import AIAActor
    from .apps.live_translator import LTActor
    from .sip.agent import SIPAgent

    dev = default_device(device)
    handles: Dict[str, ActorHandle] = {}
    rtp_actr = spawn(
        RTPActor,
        min_port=iconf.rtp_conf.min_port,
        max_port=iconf.rtp_conf.max_port,
        bind_ip=bind_ip or iconf.sip_conf.bind[0],
        device=dev,
        name="rtp",
    )
    handles["rtp"] = rtp_actr

    app_actors: Dict[str, ActorHandle] = {}
    for key, prof in iconf.apps.items():
        if isinstance(prof, LTProfileConf):
            h = spawn(LTActor, prof, tiny=tiny, device=dev, name=key)
        elif isinstance(prof, AIAProfileConf):
            h = spawn(AIAActor, prof, tiny=tiny, device=dev, name=key)
        else:
            continue
        app_actors[key] = h
        handles[key] = h

    sip_actr = spawn(SIPAgent, iconf, rtp_actr, app_actors, name="sip",
                     max_concurrency=2)
    handles["sip"] = sip_actr
    # fail fast if the signaling plane could not bind (a half-up daemon that
    # loads models but serves no calls is worse than a crash)
    sip_actr.ask_sync("ready_check", timeout=30)
    for key, h in app_actors.items():
        prof = iconf.apps[key]
        # the app start is a SEQUENCE of model-actor starts, each entitled
        # to the full per-model budget: LT starts one TTS per language +
        # STT; AIA starts TTS + STT + LLM
        if isinstance(prof, LTProfileConf):
            n_models = len(getattr(prof, "tts_langs", None) or ("en",)) + 1
        else:
            n_models = 3
        h.ask_sync("start", h, sip_actr, rtp_actr, stt_actr=stt_actr,
                   **(start_kwargs or {}),
                   timeout=(n_models + 1) * model_start_timeout())
    return handles


def main(argv: List[str]) -> int:
    foreground = False
    logfile: Optional[str] = None
    pidfile: Optional[str] = None
    tiny = bool(os.environ.get("INFERNOS_TINY"))
    try:
        opts, args = getopt.getopt(argv[1:], "fL:i:t")
    except getopt.GetoptError:
        print(USAGE.format(argv[0]), file=sys.stderr)
        return 2
    for o, a in opts:
        if o == "-f":
            foreground = True
        elif o == "-L":
            logfile = a
        elif o == "-i":
            pidfile = a
        elif o == "-t":
            tiny = True
    if len(args) != 1:
        print(USAGE.format(argv[0]), file=sys.stderr)
        return 2

    if not foreground:
        # daemonize (reference uses sippy.misc.daemonize, Infernos.py:57-58)
        # before anything touches the card: a CUDA context does not survive
        # a fork
        if os.fork() > 0:
            return 0
        os.setsid()
        if os.fork() > 0:
            os._exit(0)
        sink = open(logfile, "a") if logfile else open(os.devnull, "w")
        os.dup2(sink.fileno(), 1)
        os.dup2(sink.fileno(), 2)
    if pidfile:
        with open(pidfile, "w") as f:
            f.write(str(os.getpid()))

    try:
        dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    except RuntimeError as e:
        print(f"infernos_tpu_torch: {e} (INFERNOS_DEVICE=cpu asks for the "
              f"CPU)", file=sys.stderr, flush=True)
        return 1
    log.info("compute device: %s", dev)
    # SIGTERM/SIGINT from here on end the daemon cleanly, also mid-boot
    stopper = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stopper.set())
    signal.signal(signal.SIGINT, lambda *a: stopper.set())
    iconf = InfernConfig(args[0])
    build_cluster(iconf, tiny=tiny, device=dev)
    log.info("infernos_tpu_torch up; SIP on %s:%d", *iconf.sip_conf.bind)

    # operator surface: /metrics endpoint (config `metrics: {port: N}` or
    # INFERNOS_METRICS_PORT) + SIGUSR1 snapshot dump (always on)
    from .utils.metrics_export import MetricsServer, install_sigusr1_dump

    install_sigusr1_dump()
    msrv = None
    mport = iconf.metrics_port or int(
        os.environ.get("INFERNOS_METRICS_PORT", 0) or 0)
    if mport:
        msrv = MetricsServer(port=mport, host=iconf.metrics_bind).start()

    stopper.wait()
    log.info("shutting down")
    if msrv is not None:
        msrv.close()
    stop_all()
    return 0


def cli() -> None:
    """console_scripts entry point (pyproject [project.scripts])."""
    raise SystemExit(main(sys.argv))


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
