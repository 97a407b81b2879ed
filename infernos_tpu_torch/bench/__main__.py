"""Flagship benchmark: ramped full-pipeline LiveTranslator calls on the card.

    python -m infernos_tpu_torch.bench

The north-star metric, concurrent two-leg LiveTranslator calls per card at
a p95 turn latency of 3.5 s, is measured by ``bench.ltbench --ramp
--full``: N concurrent two-leg calls over real SIP/RTP on loopback through
the whole pipeline (trained-VAD ingest, tiered Whisper-large-v3 STT, T2T,
SpeechT5 + HiFi-GAN + AmendNet TTS, the native pacer), ramped until the
p95 turn-latency SLA breaks.  Then the TTS paced-calls bench
(``bench.ttsmain``) as a component capacity probe, and loopback QA on the
trained tiny pair (``bench.loopback``) as the realness check.

Each bench runs in its own subprocess under a hard wall-clock cap, so the
benches' device memory stays apart and a wedged child cannot hang the
run.  Prints JSON lines; the last is the result:
  {"metric": "lt_calls_per_chip", "value": N, "detail": {"tts_paced": ...,
   "loopback_similarity": ...}, ...}
taking the TTS metric as the headline when the LT ramp passed no level.

Env knobs: BENCH_LT=0 (skip the LT ramp), BENCH_LT_LEVELS, BENCH_LT_SLA,
BENCH_LOOPBACK=0 (skip loopback QA), BENCH_SLOTS / BENCH_UTTER /
BENCH_SECONDS (TTS bench), INFERNOS_STT_MAX_NEW (default 24 here: a
representative decode length -- zero weights never emit EOS),
INFERNOS_TTS_SLOTS (default 32), INFERNOS_STT_SLOTS (default 24).

Port of the repository's root ``bench.py``.  It runs on the card, or on
the CPU when ``INFERNOS_DEVICE=cpu`` asks for it, and raises without a
card before it starts a child.  The reference's accelerator-tunnel
preflight and claim cooldowns have no counterpart, and the result carries
no figure recorded on other hardware.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STDERR_TAIL = 4000  # bytes of a failed child's standard error to print


def _last_json_line(text: str):
    """The last line of ``text`` that parses as a JSON object, or None."""
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def _run_capped(argv, env, timeout, publish_progress=False):
    """Run a child with stdout/stderr captured to FILES and a hard wall-clock
    cap that can never block this process.

    ``subprocess.run(capture_output=True, timeout=...)`` is not safe here:
    after the timeout it kills the child and then blocks in
    ``communicate()`` until the pipes close, which a child stuck in the
    kernel never does.  Files instead of pipes mean nothing needs
    draining: on timeout, kill the child's process group, wait briefly,
    then abandon the handle and read the files.  With
    ``publish_progress`` the child's freshest JSON line is printed as it
    appears, so a killed run still ends on its best completed level.

    Returns (stdout_text, stderr_text, returncode_or_None).
    """
    with tempfile.NamedTemporaryFile(prefix="bench_out_", delete=False) as fo, \
            tempfile.NamedTemporaryFile(prefix="bench_err_", delete=False) as fe:
        out_path, err_path = fo.name, fe.name
    rc = None
    with open(out_path, "wb") as out_f, open(err_path, "wb") as err_f:
        proc = subprocess.Popen(argv, cwd=REPO, env=env,
                                stdout=out_f, stderr=err_f,
                                stdin=subprocess.DEVNULL,
                                start_new_session=True)
        deadline = time.monotonic() + timeout
        last_published = None
        try:
            while True:
                step = min(15.0, max(0.0, deadline - time.monotonic()))
                try:
                    rc = proc.wait(timeout=step or 0.001)
                    break
                except subprocess.TimeoutExpired:
                    if publish_progress:
                        with open(out_path, "rb") as pf:
                            line = _last_json_line(pf.read().decode("utf-8", "replace"))
                        if line is not None and line != last_published:
                            print(json.dumps(line), flush=True)
                            last_published = line
                    if time.monotonic() >= deadline:
                        raise
        except subprocess.TimeoutExpired:
            try:  # the whole session: the child's own children too
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                rc = proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                rc = None  # unkillable (stuck in the kernel): abandon it

    def _read(path):
        try:
            with open(path, "rb") as f:
                return f.read().decode("utf-8", "replace")
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass
    return _read(out_path), _read(err_path), rc


def _run(args, env_extra=None, timeout=3600, publish_progress=False):
    """Run one bench child (``python`` + ``args``) under ``timeout``.
    Returns its last JSON line (or None) and its exit code; when the child
    fails or prints no result, the tail of its standard error goes to ours."""
    env = dict(os.environ)
    env.update(env_extra or {})
    stdout, stderr, rc = _run_capped([sys.executable] + args, env, timeout,
                                     publish_progress=publish_progress)
    result = _last_json_line(stdout)
    if result is None or rc != 0:
        sys.stderr.write(f"bench: {' '.join(args)} exited {rc}; its standard "
                         f"error ends:\n{stderr[-STDERR_TAIL:]}\n")
        sys.stderr.flush()
    return result, rc


def flagship_result(lt, tts, loopback) -> dict:
    """The flagship line: the LT ramp's when it passed a level (value
    above 0), else the TTS paced bench's, else a zero with the error."""
    if lt is not None and lt.get("value", 0) > 0:
        result = {**lt, "detail": {**lt.get("detail", {}), "tts_paced": tts}}
    elif tts is not None:
        result = {**tts, "detail": {**tts.get("detail", {}), "lt_ramp_attempt": lt}}
    else:
        result = {"metric": "lt_calls_per_chip", "value": 0,
                  "unit": "concurrent two-leg LT calls",
                  "detail": {"error": "both benches failed"}}
    if loopback is not None:
        result["detail"]["loopback_similarity"] = {
            k: loopback.get(k) for k in ("value", "detail")}
    return result


def main() -> None:
    from ..utils.platform import default_device

    default_device(os.environ.get("INFERNOS_DEVICE") or None)
    # a parseable line first: the last JSON line is the result, so a run
    # killed before any bench finished still ends on a line (value 0)
    print(json.dumps({"metric": "lt_calls_per_chip", "value": 0,
                      "unit": "concurrent two-leg LT calls",
                      "detail": {"error": "bench interrupted before any "
                                          "sub-bench completed"}}), flush=True)
    # -- the LT ramp first: it is the headline metric
    lt = None
    if os.environ.get("BENCH_LT", "1") not in ("", "0"):
        env_extra = {
            "INFERNOS_STT_MAX_NEW": os.environ.get("INFERNOS_STT_MAX_NEW", "24"),
            # TTS 32 (the step kernel's most) and STT 24 short-tier slots
            "INFERNOS_TTS_SLOTS": os.environ.get("INFERNOS_TTS_SLOTS", "32"),
            "INFERNOS_STT_SLOTS": os.environ.get("INFERNOS_STT_SLOTS", "24"),
        }
        lt, _ = _run(["-m", "infernos_tpu_torch.bench.ltbench", "--ramp", "--full",
                      "--turns", "2", "--sla", os.environ.get("BENCH_LT_SLA", "3.5")],
                     env_extra=env_extra, timeout=3600, publish_progress=True)
        if lt is not None:
            print(json.dumps(lt), flush=True)

    # -- the TTS paced-calls component bench
    tts, _ = _run(["-m", "infernos_tpu_torch.bench.ttsmain"], timeout=3600)

    # -- loopback QA on the trained tiny pair: the whole bank of voices x 8
    # prompts; the (voice, prompt) checkpoint lets an interrupted sweep
    # resume, and every completed voice prints an aggregate line
    loopback = None
    if os.environ.get("BENCH_LOOPBACK", "1") not in ("", "0"):
        loopback, _ = _run(["-m", "infernos_tpu_torch.bench.loopback",
                            "--speakers", "32", "--prompts", "8", "--checkpoint",
                            os.path.join(tempfile.gettempdir(),
                                         "infernos_loopback_bank.json")],
                           timeout=2400)
    print(json.dumps(flagship_result(lt, tts, loopback)), flush=True)


if __name__ == "__main__":
    main()
