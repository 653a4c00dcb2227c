"""Elastic training supervisor for the port's trainer: crash-detect + resume
(counterpart of scripts/train_supervisor.py, with the same flags and the
same ``{"supervisor": ...}`` JSON event lines).

The trainer checkpoints the full learner state after every segment and
records completed-segment progress atomically, so this supervisor treats the
training process as preemptible: it launches ``python -m
carle_tpu_torch.train_mcl`` as a child, and on any abnormal exit (crash, OOM
kill, preemption) relaunches it with ``--resume-from <models dir>
--skip-segments <completed>``: the run continues from the last completed
segment instead of restarting.

Restarted continuation is semantic, not bit-exact (the action stream
restarts from the seed); the learned state (parameters, Adam moments,
accumulation counters) is exact.

Fault injection for tests and demos: ``--inject-kill-after-segments N``
SIGKILLs the first child as soon as its progress file reaches N segments.
Unknown flags, ``--device`` among them, pass through to the trainer.

    python scripts/train_supervisor_torch.py --instances 8 --epochs 2 \
        --log-dir ./logs/mcl [--max-restarts 5] [--device cpu] [any train_mcl flag]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_progress(path: str) -> int:
    try:
        with open(path) as f:
            return int(json.load(f).get("completed_segments", 0))
    except (OSError, ValueError):
        return 0


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Crash-resilient wrapper around python -m "
                    "carle_tpu_torch.train_mcl; unknown flags pass through.")
    parser.add_argument("--log-dir", default="./logs/mcl")
    parser.add_argument("--max-restarts", type=int, default=5)
    parser.add_argument("--backoff-seconds", type=float, default=5.0,
                        help="base for exponential backoff between restarts")
    parser.add_argument("--inject-kill-after-segments", type=int, default=None,
                        help="TESTING: SIGKILL the first child once progress "
                             "reaches N segments")
    parser.add_argument("--poll-seconds", type=float, default=0.5)
    parser.add_argument("--resume", action="store_true",
                        help="honor an existing progress.json in --log-dir "
                             "and continue that run; without this flag a "
                             "leftover progress file from a PREVIOUS run is "
                             "cleared so the new run trains from segment 0 "
                             "(otherwise it would silently fast-forward "
                             "past every segment and 'succeed' untrained)")
    args, train_args = parser.parse_known_args()

    # These flags are the supervisor's own recovery machinery: a user copy in
    # the pass-through args would win in the child (argparse last-wins) and
    # silently disable crash recovery — the child would write progress where
    # the supervisor never looks, so every restart would begin at segment 0.
    owned = {"--progress-file", "--skip-segments", "--resume-from"}
    # prefix match, not equality: argparse abbreviation would resolve
    # e.g. '--progress' to --progress-file in the child and still win
    names = {a.split("=", 1)[0] for a in train_args if a.startswith("--")}
    clash = sorted(n for n in names
                   if any(o.startswith(n) or n == o for o in owned))
    if clash:
        parser.error(
            f"{', '.join(clash)} are managed by the supervisor (they are how "
            "crash recovery works) and cannot be passed through; set "
            "--log-dir instead")

    progress_file = os.path.join(args.log_dir, "progress.json")
    models_dir = os.path.join(args.log_dir, "models")
    os.makedirs(args.log_dir, exist_ok=True)
    if not args.resume and os.path.exists(progress_file):
        stale = read_progress(progress_file)
        os.remove(progress_file)
        print(json.dumps({"supervisor": "cleared_stale_progress",
                          "completed_segments": stale}), flush=True)

    restarts = 0
    injected = False
    while True:
        completed = read_progress(progress_file)
        cmd = [sys.executable, "-m", "carle_tpu_torch.train_mcl",
               "--log-dir", args.log_dir,
               "--progress-file", progress_file] + train_args
        if completed > 0:
            cmd += ["--skip-segments", str(completed),
                    "--resume-from", models_dir]
        print(json.dumps({"supervisor": "launch", "attempt": restarts + 1,
                          "skip_segments": completed}), flush=True)
        child = subprocess.Popen(cmd, cwd=REPO)

        while child.poll() is None:
            time.sleep(args.poll_seconds)
            if (args.inject_kill_after_segments is not None and not injected
                    and read_progress(progress_file)
                    >= args.inject_kill_after_segments):
                injected = True
                print(json.dumps({"supervisor": "inject_kill",
                                  "pid": child.pid}), flush=True)
                child.send_signal(signal.SIGKILL)

        code = child.returncode
        if code == 0:
            print(json.dumps({"supervisor": "done", "restarts": restarts,
                              "completed_segments":
                                  read_progress(progress_file)}), flush=True)
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            print(json.dumps({"supervisor": "gave_up", "exit_code": code,
                              "restarts": restarts - 1}), flush=True)
            return 1
        delay = args.backoff_seconds * (2 ** (restarts - 1))
        print(json.dumps({"supervisor": "restart", "exit_code": code,
                          "restarts": restarts,
                          "backoff_s": delay}), flush=True)
        time.sleep(delay)


if __name__ == "__main__":
    sys.exit(main())
