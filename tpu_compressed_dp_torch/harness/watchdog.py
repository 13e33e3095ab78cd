"""Heartbeat watchdog: the relaunch loop an elastic rejoin needs.

PyTorch-port counterpart of the ``--relaunch`` mode of the JAX package's
``tools/watchdog.py``, with its CLI names, over the port's
``utils/resilience`` (the port imports nothing of the JAX package).

``--relaunch`` supervises the training command given after ``--``: every
``--interval`` seconds (after a ``--grace`` warm-up) it reads the liveness
file the harness writes under ``--heartbeat``; a record older than
``--max_age`` seconds, or a missing one, kills the child (if still alive),
waits out an exponential backoff (``--backoff`` doubling per consecutive
restart, capped at :data:`BACKOFF_CAP_S`) and respawns it, up to
``--max_relaunches`` consecutive restarts (a fresh heartbeat refills the
budget).  A clean exit (0) ends supervision.

With ``--elastic_dir`` every spawn exports ``TCDP_RESTART_COUNT`` (the
child's heartbeat incarnation) and, when the rendezvous directory holds a
committed world epoch, ``TCDP_RENDEZVOUS_EPOCH`` / ``TCDP_RENDEZVOUS_ADDR``
(``utils/resilience.spawn_supervised``), so a restarted worker parks in the
running world's join barrier and is readmitted at the survivors' next
epoch boundary instead of forming a fresh world (``train/rendezvous.py``,
``train/elastic.py``).  A child that parks past its join deadline exits
nonzero; the backoff is the retry loop.

The JAX tool's ``--check`` mode, its preempt-storm guard and its other
health thresholds read telemetry that the port does not write yet
(ROADMAP.md queue 1, items 13-14); they are not part of this CLI.

Usage::

    python -m tpu_compressed_dp_torch.harness.watchdog --relaunch \\
        --heartbeat hb.json.rank2 --elastic_dir /shared/elastic --interval 5 \\
        --grace 60 --max_relaunches 3 -- \\
        python -m tpu_compressed_dp_torch.harness.dawn --elastic \\
            --elastic_dir /shared/elastic --heartbeat hb.json \\
            --coordinator host:port --num_processes 3 --process_id 2 ...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

from tpu_compressed_dp_torch.utils.resilience import (check_heartbeat, read_heartbeat,
                                                      spawn_supervised)

__all__ = ["BACKOFF_CAP_S", "run_check", "kill_child", "supervise", "run_relaunch", "main"]

#: the backoff's ceiling in seconds (the JAX ``--backoff_cap`` default)
BACKOFF_CAP_S = 300.0


def run_check(args) -> int:
    """The heartbeat verdict: 0 fresh, 1 stale (older than ``args.max_age``),
    2 missing or unreadable."""
    # single read: the verdict and the printed payload agree even if the
    # harness's atomic os.replace lands mid-check
    hb = read_heartbeat(args.heartbeat)
    if hb is None:
        print(f"watchdog: MISSING {args.heartbeat}")
        return 2
    problems = check_heartbeat(args.heartbeat, max_age_s=args.max_age, hb=hb)
    for pr in problems:
        print(f"watchdog: UNHEALTHY: {pr}")
    return 1 if problems else 0


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
              max_checks: Optional[int] = None) -> int:
    """The relaunch decision loop, with every side effect injectable so the
    unit test can drive it against a fake child and a scripted check
    sequence (tests/test_torch_elastic.py).

    Protocol per tick: sleep ``interval_s``; a child that exited cleanly
    (rc 0) ends supervision with 0; otherwise, past the grace period,
    consult ``check`` (0 healthy / 1 unhealthy / 2 missing).  Healthy
    resets the consecutive-restart counter (and so the backoff).  Unhealthy
    or missing: if the consecutive budget is spent, give up (the child's
    exit code, else 1); otherwise kill whatever is left of the child, back
    off ``backoff_s * 2^consecutive`` capped at :data:`BACKOFF_CAP_S`,
    respawn, and re-enter the grace period (no checks for ``grace_s``: a
    fresh process needs time to write its first heartbeat)."""
    child = spawn()
    consecutive = 0
    since_launch = 0.0
    checks = 0
    try:
        while True:
            sleep(interval_s)
            since_launch += interval_s
            if child.poll() is not None and child.returncode == 0:
                log("watchdog: child exited cleanly; supervision done")
                return 0
            if since_launch < grace_s:
                continue  # fresh (re)launch: let the heartbeat appear
            rc = check()
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
                     backoff_s=args.backoff)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--relaunch", action="store_true", required=True,
                   help="supervise the command after `--`: restart it on a stale or missing "
                        "heartbeat with exponential backoff")
    p.add_argument("--heartbeat", type=str, required=True,
                   help="heartbeat JSON path (harness --heartbeat; <path>.rank<r> for one "
                        "rank of a multi-process or --elastic run)")
    p.add_argument("--max_age", type=float, default=60.0,
                   help="seconds before a heartbeat counts as stale (choose > the harness "
                        "--heartbeat_interval)")
    p.add_argument("--interval", type=float, default=30.0,
                   help="seconds between health checks")
    p.add_argument("--grace", type=float, default=120.0,
                   help="seconds after a (re)launch before checks resume (first heartbeat + "
                        "start-up time)")
    p.add_argument("--max_relaunches", type=int, default=5,
                   help="consecutive restarts before giving up (a healthy check refills the "
                        "budget)")
    p.add_argument("--backoff", type=float, default=5.0,
                   help="initial backoff seconds (doubles per consecutive restart)")
    p.add_argument("--elastic_dir", type=str, default=None,
                   help="the run's shared rendezvous/gossip directory (harness "
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
    return run_relaunch(p.parse_args(argv), cmd)


if __name__ == "__main__":
    sys.exit(main())
