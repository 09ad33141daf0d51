"""The papers100M- and uk-union-scale runs in order, each a process of its
own, with its wall time and peak resident memory:

    python -m fgnn_tpu_torch.tools.scale_runs [--steps NAME ...]
        [--num-node N] [--data-root DIR] [--out-dir DIR]

First it prints the host (``free -g``, ``df -h`` of the data root,
``nproc``, the CPU model) and the card (nvidia-smi's ``name,
power.limit``). Then the steps, by name:

  p100m_gen     ``papers100m_rehearsal --gen-only`` (the graph, saved)
  p100m_hbm     its ``--mode hbm``, 3 epochs
  p100m_cache   its ``--mode cache``, 3 epochs (PRESAMPLE 15%)
  t1_graphsage  ``exp.table1_papers100m --rows hbm cache`` (GraphSAGE)
  t1_gcn        the same rows for GCN [5, 10, 15]
  t1_pinsage    the hbm row for PinSAGE
  t1_devhost    the dev and host rows (GraphSAGE)
  uk_gen        ``ukunion_rehearsal --gen-only``
  uk_run        its 2 arch0 epochs, then the process's resident memory,
                anonymous and file-backed

Both rehearsal modes run with ``--check-step``: before their epochs, one
step's feature gather is held against its plain version, bit for bit, at
full size (the mock gather from the 1M-row table; the combine over the
16.7M-row cache). Peak memory is the ``ru_maxrss`` that ``wait4`` reports for the step's
process, its own children included; a memmapped file's pages count where
the process touched them. Each step's output goes to
``<out-dir>/<step>.log``, the summary to ``<out-dir>/summary.json``. A step
runs only if the data root has the disk its dataset needs; one that does
not fit is recorded with the limit that stopped it.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

from ..exp.runner import card_meta
from .papers100m_rehearsal import stamp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = ("p100m_gen", "p100m_hbm", "p100m_cache", "t1_graphsage",
         "t1_gcn", "t1_pinsage", "t1_devhost", "uk_gen", "uk_run")
# disk each dataset needs: int32 indices and int64 indptr, with the mock
# table and labels for papers100M (14.5 edges a node)
P100M_BYTES_PER_NODE = 14.6 * 4 + 8 + 4
UK_BYTES = 2_300_000_000 * 4 + 77_000_001 * 8

# the uk-union epochs, then the process's resident memory split into
# anonymous and file-backed pages: the memmapped indices count as the
# latter, a copy of them would count as the former
UK_RUN = ("import sys; from fgnn_tpu_torch.tools import ukunion_rehearsal "
          "as u; rc = u.main(sys.argv[1:]); print(''.join(ln for ln in "
          "open('/proc/self/status') if ln.startswith(('VmHWM', 'VmRSS', "
          "'RssAnon', 'RssFile')))); sys.exit(rc)")


def shell(cmd: str) -> str:
    r = subprocess.run(cmd, shell=True, capture_output=True, text=True,
                       timeout=120)
    return (r.stdout + r.stderr).strip()


def free_bytes(path: str) -> int:
    while not os.path.exists(path):
        path = os.path.dirname(path)
    return shutil.disk_usage(path).free


def run(name: str, argv, log_dir: str, env: dict, timeout: int) -> dict:
    """``argv`` in a process of its own from the repository's root, its
    output in ``<name>.log``: rc, wall seconds and peak resident GiB."""
    path = os.path.join(log_dir, f"{name}.log")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        # a session of its own: a step past its time is killed with the
        # processes it started
        proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT, start_new_session=True)
        deadline = time.monotonic() + timeout
        while True:
            pid, status, ru = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                break
            if time.monotonic() > deadline:
                os.killpg(proc.pid, signal.SIGKILL)
                pid, status, ru = os.wait4(proc.pid, 0)
                break
            time.sleep(0.5)
    proc.returncode = os.waitstatus_to_exitcode(status)
    out = {"rc": proc.returncode,
           "wall_s": round(time.perf_counter() - t0, 2),
           "peak_rss_gib": round(ru.ru_maxrss / 2**20, 3), "log": path}
    with open(path) as f:
        text = f.read()
    print(f"[{name}] rc {out['rc']}, {out['wall_s']} s, peak RSS "
          f"{out['peak_rss_gib']} GiB", flush=True)
    for line in text.splitlines()[-40:]:
        if " INFO " not in line:
            print(f"  {line}", flush=True)
    out.update(parse(text))
    return out


_EPOCH = re.compile(r"^\[epoch (\d+)\] (\{.*\})$")
_FLOAT = r"([0-9.]+)"


def parse(text: str) -> dict:
    """The numbers of a step's log: epoch dicts, init and build seconds,
    hit rates and ``test_result:`` lines."""
    out = {}
    epochs = []
    for line in text.splitlines():
        m = _EPOCH.match(line)
        if m:
            epochs.append(ast.literal_eval(m.group(2)))
        for key, pat in (("init_s", r"^\[init\] engine up in " + _FLOAT),
                         ("init_s", r"^# engine init: " + _FLOAT),
                         ("build_s", r"^\[gen\] \d+ nodes / \d+ edges .* in "
                          + _FLOAT),
                         ("build_s", r"^# generated \d+ edges in " + _FLOAT),
                         ("load_s", r"^\[gen\] loaded .* in " + _FLOAT)):
            m = re.match(pat, line)
            if m:
                out[key] = float(m.group(1))
        m = re.match(r"^test_result:([^=]+)=(.*)$", line)
        if m:
            out[m.group(1)] = m.group(2)
        if line.startswith("[check] "):
            out["check"] = line[len("[check] "):]
    for r in epochs:
        if r.get("feature_bytes"):
            r["hit_rate"] = 1 - r["miss_bytes"] / r["feature_bytes"]
        if r.get("sampled_edges"):
            r["edges_per_s"] = r["sampled_edges"] / r["epoch_time"]
    if epochs:
        out["epochs"] = epochs
    return out


def main(argv=None) -> int:
    import tempfile

    p = argparse.ArgumentParser()
    p.add_argument("--steps", nargs="+", default=list(STEPS), choices=STEPS)
    p.add_argument("--num-node", type=int, default=111_059_956)
    p.add_argument("--data-root",
                   default=os.path.join(tempfile.gettempdir(), "fgnn_tpu_torch"),
                   help="where the datasets go (outside the repository)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=int, default=1800,
                   help="seconds a step may take")
    p.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out",
                                                     "scale_runs"))
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    p100m_need = int(args.num_node * P100M_BYTES_PER_NODE)
    data_root = args.data_root
    os.makedirs(data_root, exist_ok=True)

    host = {**card_meta(), "free -g": shell("free -g"),
            "df -h": shell(f"df -h {data_root}"), "nproc": shell("nproc")}
    for k, v in host.items():
        print(f"# {k}: {v}" if "\n" not in v else f"# {k}:\n{v}", flush=True)

    # the processes read the bytecode this checkout's first one compiles
    env = dict(os.environ)
    env["PYTHONPYCACHEPREFIX"] = os.path.join(ROOT, "fgnn_tpu_torch",
                                              "_build", "pycache")
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    py = [sys.executable, "-m"]
    p100m = os.path.join(data_root, "p100m_ds")
    uk = os.path.join(data_root, "ukunion_ds")
    reh = py + ["fgnn_tpu_torch.tools.papers100m_rehearsal", "--device",
                args.device, "--num-node", str(args.num_node),
                "--cache-dir", p100m]
    t1 = py + ["fgnn_tpu_torch.exp.table1_papers100m", "--device", args.device,
               "--num-node", str(args.num_node), "--cache-dir", p100m,
               "--out-dir", os.path.join(args.out_dir, "table1_papers100m")]
    uk_args = ["--device", args.device, "--dir", uk]
    plan = {
        "p100m_gen": reh + ["--gen-only"],
        "p100m_hbm": reh + ["--mode", "hbm", "--check-step"],
        "p100m_cache": reh + ["--mode", "cache", "--check-step"],
        "t1_graphsage": t1 + ["--rows", "hbm", "cache"],
        "t1_gcn": t1 + ["--rows", "hbm", "cache", "--model", "gcn"],
        "t1_pinsage": t1 + ["--rows", "hbm", "--model", "pinsage"],
        "t1_devhost": t1 + ["--rows", "dev", "host"],
        "uk_gen": py + ["fgnn_tpu_torch.tools.ukunion_rehearsal", "--gen-only",
                        *uk_args],
        "uk_run": [sys.executable, "-c", UK_RUN, *uk_args],
    }
    summary = {"host": host, "num_node": args.num_node, "steps": {}}
    t_start = time.perf_counter()
    for name in args.steps:
        if name == "p100m_gen" and not os.path.exists(
                os.path.join(p100m, stamp(args.num_node), "indices.npy")):
            if free_bytes(p100m) < p100m_need:
                summary["steps"][name] = {"skipped": (
                    f"disk: {free_bytes(p100m)} bytes free at {p100m}, "
                    f"{p100m_need} needed")}
                print(f"[{name}] skipped: {summary['steps'][name]}",
                      flush=True)
                continue
        if name == "uk_gen" and not os.path.exists(os.path.join(uk, "DONE")):
            if free_bytes(uk) < UK_BYTES:
                summary["steps"][name] = {"skipped": (
                    f"disk: {free_bytes(uk)} bytes free at {uk}, "
                    f"{UK_BYTES} needed")}
                print(f"[{name}] skipped: {summary['steps'][name]}",
                      flush=True)
                continue
        r = run(name, plan[name], args.out_dir, env, args.timeout)
        if name.startswith("t1_"):
            path = os.path.join(args.out_dir, "table1_papers100m",
                                "table1_papers100m.json")
            if os.path.exists(path):
                with open(path) as f:
                    r["table"] = json.load(f)["results"]
        summary["steps"][name] = r
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(f"# scale runs: {time.perf_counter() - t_start:.1f} s", flush=True)
    for name, r in summary["steps"].items():
        brief = {k: r[k] for k in ("rc", "wall_s", "peak_rss_gib", "build_s",
                                   "load_s", "init_s", "check", "skipped")
                 if k in r}
        print(f"{name}: {json.dumps(brief)}", flush=True)
        for e in r.get("epochs", []):
            print("  " + json.dumps({k: e[k] for k in (
                "epoch", "epoch_time", "loss", "num_step", "sampled_edges",
                "edges_per_s", "hit_rate") if k in e}), flush=True)
    return int(any(r.get("rc") for r in summary["steps"].values()))


if __name__ == "__main__":
    sys.exit(main())
