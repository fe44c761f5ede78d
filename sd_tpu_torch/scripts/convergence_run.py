"""The convergence run (port of ``tools/convergence_run.py``).

Trains the ColoredShapes probe (``configs/sd_tpu/convergence-shapes.yaml``:
class-conditional pixel-space diffusion, 8 classes at 32²) through the
training CLI, ``python -m sd_tpu_torch.scripts.train``, twice:

- run A uninterrupted to ``--steps``;
- run B to the same step, sent SIGUSR1 (the "melk" save of ``last.pt``) once
  it passes half of them, then SIGKILL (no save on the way out), then
  resumed from its directory to the end.

It reports the smoothed loss curve of run A, the image logger's grids, and
the largest difference between the two runs' final checkpoints in three
parts: the UNet's weights, the EMA shadow and the optimizer state. The gates
are ``tools/convergence_run.py``'s: a smoothed loss reduction above 50% and
a difference of exactly 0 in the weights; the exit code is 1 otherwise.
Exactness comes from the trainer's draws, seeded by (seed, step), and the
loader's fast-forward to the restored (epoch, position)
(``training/trainer.py::Trainer.fit``).

    python -m sd_tpu_torch.scripts.convergence_run [--steps 2250] [--out logs/convergence]
        [--workdir logs/convergence_runs] [--device cuda|cpu] [key=value ...]

The runs train on ``--device`` (the card by default; a run that asks for it
and finds none fails); ``key=value`` items go to both runs as dotlist
overrides (a smaller model or image, for instance). ``--out`` receives
``resume_report.json``, ``REPORT.md``, run A's ``metrics.jsonl`` as
``metrics_runA.jsonl`` and its grids. A run on the card prints its kernel
launches (``train.py``'s ``LAUNCHES_LINE``); the report holds run A's and
the resumed run's, the killed run's are not counted.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch

from sd_tpu_torch.scripts.train import LAUNCHES_LINE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG = os.path.join(REPO, "configs/sd_tpu/convergence-shapes.yaml")
# poll intervals of the waits, seconds
POLL_S = 0.5


def launch(logroot: str, name: str, max_steps: int, device: str, dotlist: Sequence[str] = (),
           resume: Optional[str] = None, wait: bool = True):
    """Start the training CLI on the probe (a new run ``<logroot>/<time>_<name>``,
    or ``resume`` continued), its output to ``<logroot>/<name>.log``. With
    ``wait``, returns the run's output once it ends and raises if it failed;
    else returns the process."""
    cmd = [sys.executable, "-m", "sd_tpu_torch.scripts.train", "-t", "--max_steps",
           str(max_steps), "-s", "23", "--log_every", "25", "--ckpt_every", "1000000",
           "--device", device]
    cmd += ["-r", resume] if resume else ["--base", CFG, "-l", logroot, "-n", name]
    cmd += list(dotlist)
    log_path = os.path.join(logroot, f"{name}.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    if not wait:
        return proc
    proc.wait()
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        sys.stderr.write(text[-4000:])
        raise RuntimeError(f"run {name} failed rc={proc.returncode}")
    return text


def run_launches(text: str) -> Optional[dict]:
    """The kernel launches a run's output reports, or None (a run off the card)."""
    lines = [line for line in text.splitlines() if line.startswith(LAUNCHES_LINE)]
    return json.loads(lines[-1][len(LAUNCHES_LINE):]) if lines else None


def find_logdir(logroot: str, name: str, wait_s: float = 0) -> str:
    """Locate the run's logdir; with ``wait_s``, poll until the CLI creates it."""
    t0 = time.time()
    while True:
        cands = sorted(glob.glob(os.path.join(logroot, f"*_{name}")))
        if cands:
            return cands[-1]
        if time.time() - t0 >= wait_s:
            raise AssertionError(f"no logdir *_{name} under {logroot}")
        time.sleep(POLL_S)


def read_metrics(logdir: str) -> list:
    rows = []
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            rows.append(json.loads(line))
    return [r for r in rows if "train/loss" in r]


def wait_for_step(logdir: str, step: int, proc, timeout: float = 3600) -> int:
    """Poll metrics.jsonl until the run passes ``step``."""
    t0 = time.time()
    path = os.path.join(logdir, "metrics.jsonl")
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError("run exited before reaching kill step")
        if os.path.exists(path):
            try:
                rows = read_metrics(logdir)
            except (json.JSONDecodeError, OSError):
                rows = []
            if rows and rows[-1]["step"] >= step:
                return rows[-1]["step"]
        time.sleep(POLL_S)
    raise TimeoutError(f"never reached step {step}")


def checkpoint_path(logdir: str) -> str:
    return os.path.join(logdir, "checkpoints", "last.pt")


def wait_for_melk_ckpt(logdir: str, min_step: int, timeout: float = 300) -> int:
    """The step of the run's ``last.pt`` once one at ``min_step`` or later is
    there (``utils/checkpoint.py`` writes it atomically)."""
    path = checkpoint_path(logdir)
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path):
            step = int(torch.load(path, map_location="cpu", weights_only=True)["meta"]["step"])
            if step >= min_step:
                return step
        time.sleep(POLL_S)
    raise TimeoutError("melk checkpoint never appeared")


def load_params(logdir: str):
    """The run's final trainer state and metadata, on the CPU."""
    blob = torch.load(checkpoint_path(logdir), map_location="cpu", weights_only=True)
    return blob["state"], blob["meta"]


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over two nested trees of tensors and numbers,
    which must have the same structure."""
    worst = 0.0
    stack = [(a, b)]
    while stack:
        x, y = stack.pop()
        if isinstance(x, dict):
            assert set(x) == set(y), f"tree mismatch {set(x) ^ set(y)}"
            stack.extend((x[k], y[k]) for k in x)
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y)
            stack.extend(zip(x, y))
        elif x is None:
            assert y is None
        elif isinstance(x, torch.Tensor):
            assert x.shape == y.shape, (x.shape, y.shape)
            if x.numel():
                worst = max(worst, (x.double() - y.double()).abs().max().item())
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            worst = max(worst, abs(float(x) - float(y)))
    return worst


def smooth(vals, w=10):
    out = []
    for i in range(len(vals)):
        lo = max(0, i - w + 1)
        out.append(sum(vals[lo:i + 1]) / (i + 1 - lo))
    return out


def loss_summary(losses) -> dict:
    """``tools/convergence_run.py``'s loss-curve summary of run A's losses."""
    sm = smooth(losses, w=10)
    head, tail = sm[min(3, len(sm) - 1)], sm[-1]
    # monotonic-on-smoothed check with small tolerance
    viol = sum(1 for i in range(4, len(sm)) if sm[i] > sm[i - 1] * 1.02)
    return {"loss_first_smoothed": round(head, 5), "loss_final_smoothed": round(tail, 5),
            "loss_reduction_pct": round(100 * (1 - tail / head), 2),
            "smoothed_monotonic_violations_pct": round(100 * viol / max(len(sm) - 4, 1), 2)}


def device_name(device: str) -> str:
    return torch.cuda.get_device_name(0) if device.startswith("cuda") else device


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2250)
    ap.add_argument("--out", default=os.path.join(REPO, "logs/convergence"))
    ap.add_argument("--workdir", default=os.path.join(REPO, "logs/convergence_runs"))
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    dotlist = [a for a in rest if "=" in a and not a.startswith("-")]
    if len(dotlist) != len(rest):
        ap.error(f"unrecognized arguments: {' '.join(a for a in rest if a not in dotlist)}")
    S = args.steps

    # ---- run A: uninterrupted (reused if a completed one already exists,
    # so that a rerun after a failure in run B's phase skips it)
    dt_a, dir_a, out_a = 0.0, None, ""
    try:
        cand = find_logdir(args.workdir, "runa")
        rows = read_metrics(cand)
        if rows and rows[-1]["step"] >= S and os.path.exists(checkpoint_path(cand)):
            dir_a = cand
            print(f"[A] reusing completed run at {dir_a}")
    except (AssertionError, OSError):
        pass
    if dir_a is None:
        shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    if dir_a is None:
        print(f"[A] uninterrupted {S}-step run through the training CLI ({args.device})...",
              flush=True)
        t0 = time.time()
        out_a = launch(args.workdir, "runa", S, args.device, dotlist)
        dir_a = find_logdir(args.workdir, "runa")
        dt_a = time.time() - t0
    rows_a = read_metrics(dir_a)
    print(f"[A] done in {dt_a:.0f}s, {len(rows_a)} loss points, "
          f"final loss {rows_a[-1]['train/loss']:.4f}", flush=True)

    # ---- run B: SIGUSR1 melk at ~S/2, then HARD kill, then resume
    print(f"[B] launching, will SIGUSR1 at ~step {S // 2} then SIGKILL...", flush=True)
    for d in glob.glob(os.path.join(args.workdir, "*_runb")):
        shutil.rmtree(d, ignore_errors=True)
    proc = launch(args.workdir, "runb", S, args.device, dotlist, wait=False)
    try:
        dir_b = find_logdir(args.workdir, "runb", wait_s=300)
        reached = wait_for_step(dir_b, S // 2, proc)
        os.kill(proc.pid, signal.SIGUSR1)
        melk_step = wait_for_melk_ckpt(dir_b, reached)
        if proc.poll() is not None or melk_step >= S:
            raise RuntimeError(
                f"run B ended (step {melk_step} of {S}) before it could be killed: its last.pt "
                f"is the save on exit, not the SIGUSR1 save; give it more --steps")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    if proc.returncode != -signal.SIGKILL:
        raise RuntimeError(f"run B exited with {proc.returncode} instead of being killed")
    print(f"[B] melk checkpoint at step {melk_step}; process SIGKILLed. "
          f"Resuming to {S}...", flush=True)
    out_b = launch(args.workdir, "runb-resume", S, args.device, dotlist, resume=dir_b)
    rows_b = read_metrics(dir_b)

    # ---- compare the final trainer states bit for bit
    tree_a, meta_a = load_params(dir_a)
    tree_b, meta_b = load_params(dir_b)
    if not meta_a["step"] == meta_b["step"] == S:
        raise RuntimeError(f"the runs ended at steps {meta_a['step']} and {meta_b['step']}, "
                           f"not {S}")
    d_params = max_abs_diff(tree_a["unet"], tree_b["unet"])
    d_ema = (max_abs_diff(tree_a["ema"], tree_b["ema"])
             if tree_a.get("ema") is not None else None)
    d_opt = max_abs_diff(tree_a["optimizer"], tree_b["optimizer"])
    print(f"resume equivalence: max|params_A - params_B| = {d_params:.3e}, "
          f"ema = {d_ema}, opt = {d_opt}", flush=True)

    # ---- loss-curve summary
    summary = loss_summary([r["train/loss"] for r in rows_a])

    # ---- gather grids
    grids = {}
    img_dir = os.path.join(dir_a, "images")
    for f in sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []:
        if f.startswith("train_samples") or f.startswith("train_inputs"):
            shutil.copy(os.path.join(img_dir, f), os.path.join(args.out, f))
            grids.setdefault(f.split("_step")[0], []).append(f)
    shutil.copy(os.path.join(dir_a, "metrics.jsonl"),
                os.path.join(args.out, "metrics_runA.jsonl"))

    rates = [r["train/it_per_sec"] for r in rows_a if "train/it_per_sec" in r]
    config = os.path.relpath(CFG, REPO)
    report = {
        "config": config,
        "dotlist": dotlist,
        "steps": S,
        "device": device_name(args.device),
        "runA_seconds": round(dt_a, 1),
        "runA_ms_per_step": round(1e3 / rates[-1], 3) if rates else None,
        **summary,
        "melk_step": melk_step,
        "kill": "SIGUSR1 (melk save) + SIGKILL (no exception-path save)",
        "resume_max_abs_diff": {"params": d_params, "ema": d_ema, "opt_state": d_opt},
        "runB_losses_match_runA": [r["train/loss"] for r in rows_b][-3:] ==
                                  [r["train/loss"] for r in rows_a][-3:],
        "grids": grids,
        "launches": {"runA": run_launches(out_a), "runB_resumed": run_launches(out_b)},
    }
    with open(os.path.join(args.out, "resume_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    head, tail = summary["loss_first_smoothed"], summary["loss_final_smoothed"]
    with open(os.path.join(args.out, "REPORT.md"), "w") as f:
        f.write(
            "# Training-convergence demonstration (sd_tpu_torch)\n\n"
            f"One run through `python -m sd_tpu_torch.scripts.train` ({report['device']}, "
            f"seed 23) on the deterministic class-conditional ColoredShapes distribution "
            f"(`{config}`{', ' + ' '.join(dotlist) if dotlist else ''}), {S} steps.\n\n"
            f"- smoothed train loss: {head:.4f} -> {tail:.4f} "
            f"({summary['loss_reduction_pct']}% reduction; "
            f"{summary['smoothed_monotonic_violations_pct']}% of smoothed points rise >2% — "
            f"see metrics_runA.jsonl)\n"
            f"- sample grids: `train_samples_step*.png` (start / middle / end; inputs "
            f"alongside)\n"
            f"- kill/resume: SIGUSR1 melk checkpoint at step {melk_step}, then SIGKILL; the "
            f"resumed run's final params match the uninterrupted run with max|diff| = "
            f"{d_params:.3e} (ema {d_ema}, optimizer state {d_opt})\n\n"
            "Exact-resume mechanics: the train step's draws from a generator seeded by "
            "(seed, step), and the loader's fast-forward to the restored (epoch, position) "
            "(`sd_tpu_torch/training/trainer.py::Trainer.fit`).\n")
    print(json.dumps(report, indent=1))
    ok = summary["loss_reduction_pct"] > 50 and d_params == 0.0
    print("CONVERGENCE+RESUME:", "PASS" if ok else "CHECK REPORT", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
