"""Runs trainer jobs a few at a time against one deadline, then gathers
their records: the call script of the learning runs on the card.

    python3 tests/run_slots.py --jobs jobs.jsonl --slots 4 --deadline 2400 \\
        --out records/call1 --log-dir /tmp/runs

Each line of ``--jobs`` is a JSON object ``{"name": ..., "argv": [...]}``
with an optional ``"cwd"`` and ``"limit"`` (seconds); the runner appends
``--log-dir <log-dir> --run-name <name>`` to ``argv``, runs it with
``OMP_NUM_THREADS=1`` under ``timeout -s INT`` (the job's limit or the time
left, whichever is less; a job is not started with under a minute left),
writes its output to ``<out>/<name>.out``, samples ``nvidia-smi`` every
minute into ``<out>/smi-samples.txt``, copies each run's
``metrics.jsonl``, ``logger`` and ``ckpt_meta.json`` into
``<out>/runs/<name>/`` when the job ends and every minute while it runs
(so a call cut at its time limit keeps what its runs logged), and prints
``tests/learning_curves.py`` of every run at the end. Imports only the
standard library.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

HERE = pathlib.Path(__file__).resolve().parent
KEEP = ("metrics.jsonl", "logger", "ckpt_meta.json")


def sample_smi(path: pathlib.Path, stop: threading.Event) -> None:
    while not stop.is_set():
        if shutil.which("nvidia-smi") is None:
            return
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
             "power.limit,utilization.gpu,memory.used", "--format=csv,noheader"],
            capture_output=True, text=True).stdout
        with open(path, "a") as f:
            f.write(out)
        stop.wait(60)


def gather(log_dir: str, out: pathlib.Path, name: str):
    """Copy run `name`'s records into out/runs/name; its metrics.jsonl
    there, or None."""
    dst = out / "runs" / name
    for run_dir in glob.glob(os.path.join(log_dir, "*", name)):
        dst.mkdir(parents=True, exist_ok=True)
        for k in KEEP:
            if os.path.exists(os.path.join(run_dir, k)):
                shutil.copy(os.path.join(run_dir, k), dst / k)
    return str(dst / "metrics.jsonl") if (dst / "metrics.jsonl").exists() \
        else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--deadline", type=float, required=True,
                    help="seconds from the start")
    ap.add_argument("--out", required=True)
    ap.add_argument("--log-dir", required=True)
    ap.add_argument("--at", nargs="*", default=["50", "100", "200", "300",
                                                "400"])
    args = ap.parse_args(argv)
    t0 = time.time()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(args.jobs) as f:
        jobs = [json.loads(line) for line in f if line.strip()]
    stop = threading.Event()
    smi = threading.Thread(target=sample_smi,
                           args=(out / "smi-samples.txt", stop), daemon=True)
    smi.start()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    running = {}
    pending = list(jobs)
    synced = time.time()
    while pending or running:
        if time.time() - synced > 60:
            for name in running:
                gather(args.log_dir, out, name)
            synced = time.time()
        for name, (proc, fh) in list(running.items()):
            if proc.poll() is not None:
                fh.close()
                gather(args.log_dir, out, name)
                print(f"END {name} rc={proc.returncode} at "
                      f"{time.time() - t0:.0f} s", flush=True)
                del running[name]
        while pending and len(running) < args.slots:
            job = pending.pop(0)
            left = args.deadline - (time.time() - t0)
            if left < 60:
                print(f"SKIP {job['name']} ({left:.0f} s left)", flush=True)
                continue
            limit = int(min(job.get("limit", left), left))
            cmd = (["timeout", "-s", "INT", str(limit)] + job["argv"]
                   + ["--log-dir", args.log_dir, "--run-name", job["name"]])
            fh = open(out / f"{job['name']}.out", "w")
            running[job["name"]] = (subprocess.Popen(
                cmd, cwd=job.get("cwd"), env=env, stdout=fh,
                stderr=subprocess.STDOUT), fh)
            print(f"START {job['name']} limit {limit} s at "
                  f"{time.time() - t0:.0f} s", flush=True)
        time.sleep(2)
    stop.set()
    files = [f for f in (gather(args.log_dir, out, job["name"])
                         for job in jobs) if f]
    if files:
        subprocess.run([sys.executable, str(HERE / "learning_curves.py"),
                        *files, "--at", *args.at])
    return 0


if __name__ == "__main__":
    sys.exit(main())
