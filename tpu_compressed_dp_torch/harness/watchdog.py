"""Heartbeat watchdog: the check and relaunch halves.

PyTorch-port counterpart of the JAX package's ``tools/watchdog.py``, with
its CLI names, defaults and exit codes, over the port's
``utils/resilience`` (the port imports nothing of the JAX package).

``--check`` reads the liveness file a harness writes under ``--heartbeat``
(payload: ``ts``, ``step``, ``last_good_step``, the telemetry snapshot —
step rate, p95 step latency — and the checkpoint, control and straggler
fields) and exits nonzero when the run is unhealthy:

  exit 0  healthy
  exit 1  unhealthy (stale / wedged / stalled / slow tail / checkpoint
          stale / stream stale / straggler; reasons on stdout)
  exit 2  heartbeat missing or unreadable

Checks (``utils/resilience.check_heartbeat``): **stale** (``ts`` older than
``--max_age``), **wedged** (``step - last_good_step > --max_wedge``: every
step vetoed by the step guard), **stalled** (telemetry ``steps_per_sec``
below ``--min_step_rate``), **slow tail** (telemetry ``step_p95_ms`` above
``--max_step_p95_ms``), **checkpoint-stale** (``ckpt_age_s`` plus the
heartbeat's own age above ``--max_ckpt_age``), **stream-stale**
(``stream_lag_s``, the delta stream's time since its last segment, written
by the harness's ``StreamWriter`` or by ``harness/stream_serve.py``, plus
the heartbeat's own age above ``--max_stream_lag``) and **straggler**
(``straggler_skew_s``, the flight recorder's live cross-rank step-time
skew, above ``--max_straggler_skew``).

``--relaunch`` supervises the training command given after ``--``: it runs
the same check every ``--interval`` seconds (after a ``--grace`` warm-up)
and on an unhealthy or missing verdict kills the child (if still alive),
waits out an exponential backoff (``--backoff`` doubling per consecutive
restart, capped at :data:`BACKOFF_CAP_S`) and respawns it, up to
``--max_relaunches`` consecutive restarts (a healthy check refills the
budget).  A clean exit (0) ends supervision.  A child that exits
``PREEMPT_EXIT`` (75) respawns at once, with no backoff and no budget
burnt, unless more than ``--max_preempts`` such exits fall within
``--preempt_window`` seconds: a preempt storm, handled like an unhealthy
verdict.

With ``--elastic_dir`` every spawn exports ``TCDP_RESTART_COUNT`` (the
child's heartbeat incarnation) and, when the rendezvous directory holds a
committed world epoch, ``TCDP_RENDEZVOUS_EPOCH`` / ``TCDP_RENDEZVOUS_ADDR``
(``utils/resilience.spawn_supervised``), so a restarted worker parks in the
running world's join barrier and is readmitted at the survivors' next
epoch boundary instead of forming a fresh world (``train/rendezvous.py``,
``train/elastic.py``).  A child that parks past its join deadline exits
nonzero; the backoff is the retry loop.

Usage::

    python -m tpu_compressed_dp_torch.harness.watchdog --check --heartbeat hb.json \\
        --max_age 120 --max_wedge 200 --min_step_rate 0.01
    python -m tpu_compressed_dp_torch.harness.watchdog --relaunch \\
        --heartbeat hb.json.rank2 --elastic_dir /shared/elastic --interval 5 \\
        --grace 60 --max_relaunches 3 -- \\
        python -m tpu_compressed_dp_torch.harness.dawn --elastic \\
            --elastic_dir /shared/elastic --heartbeat hb.json \\
            --coordinator host:port --num_processes 3 --process_id 2 ...
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

from tpu_compressed_dp_torch.utils.resilience import (PREEMPT_EXIT, check_heartbeat,
                                                      read_heartbeat, spawn_supervised)

__all__ = ["BACKOFF_CAP_S", "run_check", "kill_child", "supervise", "run_relaunch", "main"]

#: the backoff's ceiling in seconds (the JAX ``--backoff_cap`` default)
BACKOFF_CAP_S = 300.0


def run_check(args) -> int:
    """The heartbeat verdict: 0 healthy, 1 unhealthy (by the thresholds the
    namespace carries; one it lacks or leaves ``None`` is not checked), 2
    missing or unreadable."""
    # single read: the verdict and the printed payload agree even if the
    # harness's atomic os.replace lands mid-check
    hb = read_heartbeat(args.heartbeat)
    if hb is None:
        print(f"watchdog: MISSING {args.heartbeat}")
        return 2
    problems = check_heartbeat(
        args.heartbeat, max_age_s=args.max_age,
        max_wedge_steps=getattr(args, "max_wedge", None),
        min_steps_per_sec=getattr(args, "min_step_rate", None),
        max_step_p95_ms=getattr(args, "max_step_p95_ms", None),
        max_ckpt_age_s=getattr(args, "max_ckpt_age", None),
        max_stream_lag_s=getattr(args, "max_stream_lag", None),
        max_straggler_skew_s=getattr(args, "max_straggler_skew", None), hb=hb)
    for pr in problems:
        print(f"watchdog: UNHEALTHY: {pr}")
    if problems:
        return 1
    rate = (hb.get("telemetry") or {}).get("steps_per_sec")
    print(f"watchdog: healthy (step={hb.get('step')}, last_good_step={hb.get('last_good_step')}"
          + (f", {rate:.3g} steps/s" if isinstance(rate, (int, float)) else "") + ")")
    return 0


def kill_child(child, term_timeout_s: float = 10.0) -> None:
    """Terminate a (possibly wedged) child: SIGTERM, bounded wait, SIGKILL.
    A no-op when the child already exited."""
    if child.poll() is not None:
        return
    child.terminate()
    try:
        child.wait(timeout=term_timeout_s)
    except Exception:
        child.kill()
        child.wait()


def supervise(spawn: Callable[[], "subprocess.Popen"],
              check: Callable[[], int],
              *,
              interval_s: float,
              grace_s: float,
              max_relaunches: int,
              backoff_s: float = 5.0,
              sleep: Callable[[float], None] = time.sleep,
              kill: Callable[..., None] = kill_child,
              log: Callable[[str], None] = print,
              max_checks: Optional[int] = None,
              preempt_exit_code: Optional[int] = PREEMPT_EXIT,
              max_preempts: Optional[int] = 8,
              preempt_window_s: float = 600.0) -> int:
    """The relaunch decision loop, with every side effect injectable so the
    unit test can drive it against a fake child and a scripted check
    sequence (tests/test_torch_elastic.py).

    Protocol per tick: sleep ``interval_s``; a child that exited cleanly
    (rc 0) ends supervision with 0; a child that exited with
    ``preempt_exit_code`` (the harness's emergency save after a SIGTERM)
    respawns at once, with no backoff, no budget burnt and no check spent;
    otherwise, past the grace period, consult ``check`` (0 healthy / 1
    unhealthy / 2 missing).  Healthy resets the consecutive-restart counter
    (and so the backoff).  Unhealthy or missing: if the consecutive budget
    is spent, give up (the child's exit code, else 1); otherwise kill
    whatever is left of the child, back off ``backoff_s * 2^consecutive``
    capped at :data:`BACKOFF_CAP_S`, respawn, and re-enter the grace period
    (no checks for ``grace_s``: a fresh process needs time to write its
    first heartbeat).

    Preempt-storm guard: more than ``max_preempts`` preempt exits within a
    sliding ``preempt_window_s`` (``None`` disables the cap) take the
    unhealthy path instead, so a scheduler preempting in a tight loop
    cannot respawn the child forever.  The window's clock is the
    supervisor's own slept time (deterministic under an injected
    ``sleep``)."""
    child = spawn()
    consecutive = 0
    since_launch = 0.0
    slept = 0.0
    preempts: "collections.deque[float]" = collections.deque()
    checks = 0
    try:
        while True:
            sleep(interval_s)
            slept += interval_s
            since_launch += interval_s
            if child.poll() is not None and child.returncode == 0:
                log("watchdog: child exited cleanly; supervision done")
                return 0
            storm = False
            if (child.poll() is not None and preempt_exit_code is not None
                    and child.returncode == preempt_exit_code):
                preempts.append(slept)
                while preempts and slept - preempts[0] > preempt_window_s:
                    preempts.popleft()
                if max_preempts is None or len(preempts) <= max_preempts:
                    log(f"watchdog: child preempted (exit {preempt_exit_code}); relaunching "
                        "immediately")
                    child = spawn()
                    since_launch = 0.0
                    continue
                storm = True
                log(f"watchdog: preempt storm: {len(preempts)} preempt exits within "
                    f"{preempt_window_s:g}s (cap {max_preempts}); treating as unhealthy")
            if not storm and since_launch < grace_s:
                continue  # fresh (re)launch: let the heartbeat appear
            rc = 1 if storm else check()
            checks += 1
            if rc == 0:
                consecutive = 0
            else:
                if consecutive >= max_relaunches:
                    died_rc = child.poll()
                    kill(child)
                    # a positive rc is the child's own failure code;
                    # killed-by-us (negative) or alive-but-wedged reports 1
                    code = died_rc if died_rc is not None and died_rc > 0 else 1
                    log(f"watchdog: giving up after {consecutive} consecutive relaunches "
                        f"(exit {code})")
                    return int(code)
                delay = min(backoff_s * (2.0 ** consecutive), BACKOFF_CAP_S)
                log(f"watchdog: unhealthy (check rc={rc}); relaunch "
                    f"#{consecutive + 1}/{max_relaunches} after {delay:.0f}s backoff")
                kill(child)
                sleep(delay)
                slept += delay
                child = spawn()
                consecutive += 1
                since_launch = 0.0
            if max_checks is not None and checks >= max_checks:
                # test hook: bounded supervision
                kill(child)
                return 0
    except BaseException:
        # Ctrl-C or an unexpected check/spawn error must not orphan the
        # training child: a detached run keeps writing the heartbeat, and a
        # restarted watchdog would then supervise a process it never spawned
        kill(child)
        raise


def run_relaunch(args, cmd: List[str]) -> int:
    if not cmd:
        print("watchdog: --relaunch needs the training command after `--`")
        return 2

    # seed from our own environment so a re-executed watchdog keeps the
    # child's incarnation monotone instead of resetting it to 0
    launches = {"n": int(os.environ.get("TCDP_RESTART_COUNT", "0") or 0)}

    def spawn():
        # TCDP_RESTART_COUNT seeds the child Heartbeat's incarnation
        # (strictly larger per respawn, so a relaunched worker's heartbeats
        # are told apart from its previous life's stale file); with
        # --elastic_dir the committed-epoch hint lands the child in the
        # RUNNING world's join barrier (train/rendezvous.maybe_rejoin_from_env)
        child = spawn_supervised(cmd, restart_count=launches["n"], elastic_dir=args.elastic_dir,
                                 log=lambda s: print(f"watchdog: {s}"))
        launches["n"] += 1
        print(f"watchdog: launching: {' '.join(cmd)}")
        return child

    return supervise(spawn, lambda: run_check(args), interval_s=args.interval,
                     grace_s=args.grace, max_relaunches=args.max_relaunches,
                     backoff_s=args.backoff,
                     max_preempts=None if args.max_preempts <= 0 else args.max_preempts,
                     preempt_window_s=args.preempt_window)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true", help="one-shot health check (exit 0/1/2)")
    mode.add_argument("--relaunch", action="store_true",
                      help="supervise the command after `--`: restart it on an unhealthy or "
                           "missing heartbeat with exponential backoff")
    p.add_argument("--heartbeat", type=str, required=True,
                   help="heartbeat JSON path (harness --heartbeat; <path>.rank<r> for one "
                        "rank of a multi-process or --elastic run)")
    p.add_argument("--max_age", type=float, default=60.0,
                   help="seconds before a heartbeat counts as stale (choose > the harness "
                        "--heartbeat_interval)")
    p.add_argument("--max_wedge", type=int, default=None,
                   help="max steps last_good_step may trail step (default: no wedge check)")
    p.add_argument("--min_step_rate", type=float, default=None,
                   help="min telemetry steps/s (default: no stall check)")
    p.add_argument("--max_step_p95_ms", type=float, default=None,
                   help="max telemetry p95 step latency in ms (default: no tail check)")
    p.add_argument("--max_ckpt_age", type=float, default=None,
                   help="max seconds since the last durable checkpoint (ckpt_age_s plus the "
                        "heartbeat's age; default: no checkpoint check)")
    p.add_argument("--max_stream_lag", type=float, default=None,
                   help="max seconds since the last delta-stream segment (stream_lag_s plus "
                        "the heartbeat's age; default: no stream-staleness check)")
    p.add_argument("--max_straggler_skew", type=float, default=None,
                   help="max cross-rank step-time skew in seconds (straggler_skew_s; "
                        "default: no straggler check)")
    p.add_argument("--interval", type=float, default=30.0,
                   help="relaunch: seconds between health checks")
    p.add_argument("--grace", type=float, default=120.0,
                   help="relaunch: seconds after a (re)launch before checks resume (first "
                        "heartbeat + start-up time)")
    p.add_argument("--max_relaunches", type=int, default=5,
                   help="relaunch: consecutive restarts before giving up (a healthy check "
                        "refills the budget)")
    p.add_argument("--backoff", type=float, default=5.0,
                   help="relaunch: initial backoff seconds (doubles per consecutive restart)")
    p.add_argument("--max_preempts", type=int, default=8,
                   help="relaunch: more than this many preempt exits within "
                        "--preempt_window seconds count as unhealthy; <= 0 disables the cap")
    p.add_argument("--preempt_window", type=float, default=600.0,
                   help="relaunch: the sliding window of --max_preempts, in seconds")
    p.add_argument("--elastic_dir", type=str, default=None,
                   help="relaunch: the run's shared rendezvous/gossip directory (harness "
                        "--elastic_dir); exports the committed world epoch + coordinator "
                        "address to the child so a restarted worker REJOINS the running "
                        "world instead of forming a fresh one")
    argv = list(sys.argv[1:] if argv is None else argv)
    # split at the FIRST `--`: the left side is parsed STRICTLY (a misspelled
    # watchdog flag is an argparse error, never folded into the child
    # command), the right side is the training command verbatim
    if "--" in argv:
        cut = argv.index("--")
        argv, cmd = argv[:cut], argv[cut + 1:]
    else:
        cmd = []
    args = p.parse_args(argv)
    if args.check:
        if cmd:
            p.error("--check takes no training command (drop the `-- ...`)")
        return run_check(args)
    return run_relaunch(args, cmd)


if __name__ == "__main__":
    sys.exit(main())
