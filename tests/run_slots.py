"""Runs trainer jobs a few at a time against one deadline, then gathers
their records: the call script of the learning runs on the card.

    python3 tests/run_slots.py --jobs jobs.jsonl --slots 4 --deadline 2400 \\
        --out records/call1 --log-dir /tmp/runs

Each line of ``--jobs`` is a JSON object ``{"name": ..., "argv": [...]}``
with an optional ``"cwd"``, ``"limit"`` (seconds) and ``"end_after":
[bar, hold]`` (the job is ended, as at its limit, once its newest
evaluation lies ``hold`` iterations past its first success rate of at
least ``bar`` in this call's log); the runner appends
``--log-dir <log-dir> --run-name <name>`` to ``argv``, runs it with
``OMP_NUM_THREADS=1`` under ``timeout -s INT`` (the job's limit or the time
left, whichever is less; a job is not started with under a minute left),
writes its output to ``<out>/<name>.out``, samples ``nvidia-smi`` and the
host every minute into ``<out>/smi-samples.txt`` (lines starting
``host``: once the CPUs this process may use, the machine's, the cgroup's
CPU quota and the CPU model, then each minute ``/proc/loadavg``, the
trainer processes running, the CPU seconds each used a second since the
last sample and the milliseconds of a fixed Python loop), copies each
run's ``metrics.jsonl``, ``logger`` and ``ckpt_meta.json`` into
``<out>/runs/<name>/`` when the job ends and every minute while it runs
(so a call cut at its time limit keeps what its runs logged), and prints
``tests/learning_curves.py`` of every run at the end. Imports only the
standard library and ``tests/learning_curves.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import threading
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from learning_curves import first_at, load, summary  # noqa: E402

KEEP = ("metrics.jsonl", "logger", "ckpt_meta.json")
TRAINER = b"active_tracking_rl_torch.run.train"
CLK_TCK = os.sysconf("SC_CLK_TCK")


def _read(path: str, default: str = "?") -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return default


def host_facts() -> str:
    """Once a call: the CPUs this process may use (``nproc``), the
    machine's, the cgroup's CPU quota and the CPU model."""
    model = next((ln.split(":", 1)[1].strip() for ln in
                  _read("/proc/cpuinfo", "").splitlines()
                  if ln.startswith("model name")), "?")
    quota = _read("/sys/fs/cgroup/cpu.max", "")
    if not quota:
        quota = (_read("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") + "/"
                 + _read("/sys/fs/cgroup/cpu/cpu.cfs_period_us"))
    return (f"host nproc={len(os.sched_getaffinity(0))} "
            f"cpus={os.cpu_count()} cpu.max={quota.replace(' ', '/')} "
            f"model={model}\n")


def trainers() -> dict:
    """CPU seconds used so far by each trainer process (``python -m
    active_tracking_rl_torch.run.train``) running on the host, by pid;
    their ``timeout`` wrappers are not counted."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            if not (TRAINER in argv and os.path.basename(argv[0])
                    .startswith(b"python")):
                continue
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            out[pid] = (int(fields[11]) + int(fields[12])) / CLK_TCK
        except (OSError, IndexError, ValueError):
            continue
    return out


def spin_ms(n: int = 200_000) -> float:
    """Milliseconds this process takes for a fixed loop of Python: the
    speed of one of the host's cores as a trainer's launch loop sees it."""
    t0 = time.perf_counter()
    sum(i * i for i in range(n))
    return (time.perf_counter() - t0) * 1e3


def host_line(before) -> tuple:
    """One minute's host line, and the readings the next one starts from:
    each trainer's CPU seconds and the clock."""
    used, wall = trainers(), time.time()
    busy = ",".join(f"{(t - before[0][p]) / (wall - before[1]):.2f}"
                    for p, t in sorted(used.items()) if p in before[0])
    return (f"host {time.strftime('%Y/%m/%d %H:%M:%S')} "
            f"loadavg {_read('/proc/loadavg')} trainers={len(used)} "
            f"trainer_cpu={busy or '?'} spin_ms={spin_ms():.1f}\n",
            (used, wall))


def sample_smi(path: pathlib.Path, stop: threading.Event) -> None:
    """The host's facts once, then each minute the card's
    ``nvidia-smi`` line (where there is one) and the host's line, until
    `stop` is set (one sample when it is set already)."""
    with open(path, "a") as f:
        f.write(host_facts())
    times = (trainers(), time.time())
    while True:
        out = ""
        if shutil.which("nvidia-smi") is not None:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
                 "power.limit,utilization.gpu,memory.used",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout
        line, times = host_line(times)
        with open(path, "a") as f:
            f.write(out + line)
        if stop.wait(60):
            return


def bar_held(metrics: str, bar: float, hold: int) -> bool:
    """Whether the log's newest evaluation lies `hold` iterations past its
    first success rate of at least `bar`."""
    evals = summary(load(metrics))["evals"]
    first = first_at(evals, bar)
    return first is not None and evals[-1][0] >= first + hold


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
    jobs_by_name = {job["name"]: job for job in jobs}
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
            for name, (proc, _) in running.items():
                got = gather(args.log_dir, out, name)
                end = jobs_by_name[name].get("end_after")
                if got and end and proc.poll() is None and bar_held(
                        got, *end):
                    print(f"BAR {name}: S >= {end[0]} held {end[1]} "
                          f"iterations; ending it", flush=True)
                    proc.send_signal(signal.SIGINT)
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
