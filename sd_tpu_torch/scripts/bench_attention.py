"""Time K1 and K3 and the paths they run on, for one tree of the repository.

    PYTHONPATH=<tree> python3 sd_tpu_torch/scripts/bench_attention.py [label] \
        [--cluster | --cluster-device]

``sd_tpu_torch`` is imported from ``PYTHONPATH``, so the same script times
another tree of the repository (a parent commit unpacked under the
git-ignored ``build/``) as well as this one; ``chip_smoke.py`` is read from
this file's repository for its shapes and timing helpers. On the card, with
its name and power limit, it prints:

- K1 at every ``FLASH_SHAPES`` shape and K3 at every ``BWD_SHAPES`` shape,
  ms per call (CUDA events, 20 calls after 3 warm-up), beside
  ``scaled_dot_product_attention``'s forward, or its forward+backward minus
  its forward;
- SD v1 serving (512², PLMS 50, guidance 7.5, bf16, seeded random weights):
  one warm-up request, then ``REQUESTS`` requests at batch 1 (seconds per
  request, ms per UNet evaluation: sampling seconds over S+1) and one at
  batch 8 (images/s); then ``PROFILED`` UNet evaluations at B=2 and at B=16
  under ``torch.profiler``: wall and device-busy ms per evaluation, the
  card's idle share and the device time by ``profile_train``'s kernel groups;
- SD v1 training at batch 4 as ``python -m sd_tpu_torch.scripts.train``
  builds it: ms per step (host clock after a sync), the median of
  ``TRAIN_STEPS`` steps after 2 warm-up steps;

then one JSON line of all of it, last. With ``--cluster`` it prints instead
what K1's and K3's cluster plans (576 < d <= 4096 and 128 < d <= 2048) and
their older plans above them (K1's stream plan, K3's slice plan) run on:

- K1 at ``CLUSTER_K1_SHAPES`` and K3 at ``CLUSTER_K3_SHAPES``, ``REPEATS``
  timings of each (CUDA events, 20 calls after 3 warm-up), beside sdpa's,
  the plain version's (K3: the plain backward's) and the bound;
- the two first-stage training steps at full width, as the ``first_stage``
  leg of ``dryrun_multigpu`` builds them on synthetic images: the kl-f8
  VAE-GAN at batch 12 (256²) and the VQ-f4 VQ-GAN at 8 (256²), ms per step
  (host clock after a sync, the median of ``TRAIN_STEPS`` steps after 2
  warm-up steps), then ``PROFILED_STEPS`` VAE-GAN steps under
  ``torch.profiler``: the device time by kernel group and K1's and K3's
  shares of the device-busy time;
- cin256-v2 through ``sample_diffusion``'s build and sampler at the smoke's
  settings (batch 4 with guidance, 256², DDIM ``CIN256_STEPS``): samples/s
  of ``REQUESTS`` runs after one warm-up run.

With ``--cluster-device``, in a process of its own (one profiler session a
process), the device ms per call of each of those K1 and K3 shapes from
``torch.profiler``: the events' time includes the host's call, which is
longer than the kernel at the smallest shapes.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
REQUESTS = 2
PROFILED = 3
PAUSE_S = 0.2
TRAIN_STEPS = 5
REPEATS = 3
PROFILED_STEPS = 2
PROFILED_CALLS = 20


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_kernels(smoke) -> dict:
    from sd_tpu_torch.ops.cuda import flash_attention, flash_attention_bwd
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    out = {"K1": {}, "K3": {}}
    for shape in smoke.FLASH_SHAPES:
        q, k, v = (randn(*shape) for _ in range(3))
        scale = shape[-1] ** -0.5
        out["K1"]["x".join(map(str, shape))] = {
            "ms": smoke.time_ms(lambda: flash_attention(q, k, v, scale)),
            "sdpa_ms": smoke.time_ms(lambda: smoke.sdpa(q, k, v, scale))}
    for shape in smoke.BWD_SHAPES:
        q, k, v, do = (randn(*shape) for _ in range(4))
        scale = shape[-1] ** -0.5
        o, lse = _launch_forward(q, k, v, scale, with_lse=True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            fwd_ms = smoke.time_ms(lambda: smoke.sdpa(*leaves, scale))
        both_ms = smoke.time_ms(lambda: torch.autograd.grad(smoke.sdpa(*leaves, scale), leaves,
                                                            do.transpose(1, 2)))
        out["K3"]["x".join(map(str, shape))] = {
            "ms": smoke.time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, scale)),
            "sdpa_ms": both_ms - fwd_ms}
    return out


def time_serving(smoke) -> dict:
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8="off",
                                     safety=False, fused_conv="auto", conv_impl="auto")

    def request(batch: int, seed: int) -> dict:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        pipe([smoke.PROMPT] * batch, gen, height=512, width=512, steps=smoke.STEPS,
             guidance_scale=7.5)
        return pipe.last_timings

    request(1, 0)
    seconds, unet_ms = [], []
    for r in range(REQUESTS):
        t = request(1, r)
        seconds.append(t["total_s"])
        unet_ms.append(t["sample_s"] * 1e3 / (smoke.STEPS + 1))
    t8 = request(smoke.BATCH8, 0)
    split = profile_unet(pipe.ldm, (2, 2 * smoke.BATCH8))
    del pipe
    smoke.free_memory()
    return {"s_per_request_b1": seconds, "ms_per_unet_eval_b1": unet_ms,
            "images_per_s_b8": smoke.BATCH8 / t8["total_s"],
            "ms_per_unet_eval_b8": t8["sample_s"] * 1e3 / (smoke.STEPS + 1),
            "unet_eval_split": split}


def profile_unet(ldm, batches) -> dict:
    """PROFILED UNet evaluations at each batch in ``batches``, at 64x64
    latents and 77 context tokens as the sampler makes them: wall ms per
    evaluation (host clock after a sync, profiler off), device-busy ms, the
    card's idle share and the device ms by kernel group (profiler on). One
    profiler session covers every batch, with a pause after each batch, and
    the kernels are split at those pauses: a second session in one process
    once recorded no device events on an H100."""
    from sd_tpu_torch.scripts.profile_train import _busy_us, group_of

    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {b: (torch.randn((b, 4, 64, 64), generator=g, device="cuda").to(torch.bfloat16),
                  torch.full((b,), 500, device="cuda", dtype=torch.long),
                  torch.randn((b, 77, 768), generator=g, device="cuda").to(torch.bfloat16))
              for b in batches}
    wall_ms = {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        for b in batches:
            ldm.apply_model(*inputs[b])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                ldm.apply_model(*inputs[b])
            torch.cuda.synchronize()
            wall_ms[b] = (time.perf_counter() - t0) * 1e3 / PROFILED
        with torch.profiler.profile(activities=activities) as prof:
            for b in batches:
                for _ in range(PROFILED):
                    ldm.apply_model(*inputs[b])
                torch.cuda.synchronize()
                time.sleep(PAUSE_S)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                     key=lambda e: e.time_range.start)
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i].time_range.start
                  - kernels[i - 1].time_range.end)[len(kernels) - len(batches):]
    cuts = [0, *sorted(gaps), len(kernels)]
    out = {}
    for b, lo, hi in zip(batches, cuts, cuts[1:]):
        part = kernels[lo:hi]
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in part]) / 1e3 / PROFILED
        groups = {}
        for e in part:
            key = group_of(e.name)
            groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED
        out[f"B={b}"] = {"wall_ms": wall_ms[b], "busy_ms": busy,
                         "idle_share": 1 - busy / wall_ms[b],
                         "kernels": len(part) / PROFILED,
                         "group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    return out


def time_training() -> dict:
    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training.trainer import step_seed

    harness, state, data = build_trainer(parse_args(
        ["--logdir", tempfile.mkdtemp(prefix="bench_attention_"), "--seed", "0"]))
    trainer = harness.trainer_obj
    batches = iter(data.train_dataloader())
    times = []
    for i in range(2 + TRAIN_STEPS):
        t0 = time.perf_counter()
        generator = torch.Generator("cuda").manual_seed(step_seed(0, state.step))
        trainer.train_step(state, next(batches), generator)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return {"ms_per_train_step": float(np.median(times)), "train_step_ms": times}


def cluster_shapes(smoke) -> tuple:
    """The K1 and K3 shapes of the cluster plans and of the plans above
    them: K1's SPLIT_FLASH_SHAPES, cin256-v2's d = 960 site and the head
    dims above 1024 of HEAD_DIM_FLASH_SHAPES; K3's first-stage shapes (one
    process and two ranks, the VQ-GAN's at 8) and HEAD_DIM_BWD_SHAPES."""
    k1 = (smoke.SPLIT_FLASH_SHAPES + [s for s in smoke.WIDE_FLASH_SHAPES if s[3] > 576]
          + [s for s in smoke.HEAD_DIM_FLASH_SHAPES if s[3] > 1024])
    k3 = (smoke.VAE_BWD_SHAPES + smoke.DP_VAE_BWD_SHAPES
          + [s for s in smoke.TRAIN_VQ_BWD_SHAPES if s[3] > 128] + smoke.HEAD_DIM_BWD_SHAPES)
    return k1, k3


def time_cluster_kernels(smoke) -> dict:
    """K1 and K3 at the cluster plans' shapes: REPEATS timings of each,
    sdpa's (K3: forward+backward minus forward), the plain version's and
    the bound."""
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_bwd,
                                       flash_attention_bwd_plain, flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    k1_shapes, k3_shapes = cluster_shapes(smoke)
    out = {"K1": {}, "K3": {}}
    for shape in k1_shapes:
        b, n, h, d = shape
        q, k, v = (randn(*shape) for _ in range(3))
        scale = d ** -0.5
        out["K1"]["x".join(map(str, shape))] = {
            "ms": [smoke.time_ms(lambda: flash_attention(q, k, v, scale))
                   for _ in range(REPEATS)],
            "sdpa_ms": smoke.time_ms(lambda: smoke.sdpa(q, k, v, scale)),
            "plain_ms": smoke.time_ms(lambda: flash_attention_plain(q, k, v, scale), iters=5),
            **smoke.bound(4 * b * h * n * n * d, 4 * b * n * h * d * 2)}
        print(f"[K1] {shape}: {out['K1']['x'.join(map(str, shape))]}", flush=True)
        smoke.free_memory()
    for shape in k3_shapes:
        b, n, h, d = shape
        q, k, v, do = (randn(*shape) for _ in range(4))
        scale = d ** -0.5
        o, lse = _launch_forward(q, k, v, scale, with_lse=True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.no_grad():
            fwd_ms = smoke.time_ms(lambda: smoke.sdpa(*leaves, scale))
        both_ms = smoke.time_ms(lambda: torch.autograd.grad(smoke.sdpa(*leaves, scale), leaves,
                                                            do.transpose(1, 2)))
        out["K3"]["x".join(map(str, shape))] = {
            "ms": [smoke.time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, scale))
                   for _ in range(REPEATS)],
            "sdpa_ms": both_ms - fwd_ms,
            "plain_ms": smoke.time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, scale),
                                      iters=5),
            **smoke.bound(10 * b * h * n * n * d, 8 * b * n * h * d * 2 + b * h * n * 4)}
        print(f"[K3] {shape}: {out['K3']['x'.join(map(str, shape))]}", flush=True)
        del leaves
        smoke.free_memory()
    return out


def time_cluster_device(smoke) -> dict:
    """Device ms per call of K1 and K3 at the cluster plans' shapes, from
    one torch.profiler session: ``PROFILED_CALLS`` calls a shape, a pause
    after each shape, the kernels split at the pauses. At the small shapes
    the CUDA events of ``time_cluster_kernels`` read the host's call rate."""
    from sd_tpu_torch.ops.cuda import flash_attention, flash_attention_bwd
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    k1_shapes, k3_shapes = cluster_shapes(smoke)
    calls = []
    for shape in k1_shapes:
        q, k, v = (randn(*shape) for _ in range(3))
        calls.append(("K1", shape, lambda q=q, k=k, v=v, sc=shape[3] ** -0.5:
                      flash_attention(q, k, v, sc)))
    for shape in k3_shapes:
        q, k, v, do = (randn(*shape) for _ in range(4))
        sc = shape[3] ** -0.5
        o, lse = _launch_forward(q, k, v, sc, with_lse=True)
        calls.append(("K3", shape, lambda q=q, k=k, v=v, o=o, do=do, lse=lse, sc=sc:
                      flash_attention_bwd(q, k, v, o, do, lse, sc)))
    for _, _, fn in calls:
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _, _, fn in calls:
            for _ in range(PROFILED_CALLS):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAUSE_S)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                     key=lambda e: e.time_range.start)
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i].time_range.start
                  - kernels[i - 1].time_range.end)[len(kernels) - len(calls):]
    cuts = [0, *sorted(gaps), len(kernels)]
    out = {"K1": {}, "K3": {}}
    for (which, shape, _), lo, hi in zip(calls, cuts, cuts[1:]):
        out[which]["x".join(map(str, shape))] = sum(
            e.time_range.elapsed_us() for e in kernels[lo:hi]) / 1e3 / PROFILED_CALLS
    print(f"[device ms] {out}", flush=True)
    return out


def time_first_stage(smoke) -> dict:
    """ms per step of the kl-f8 VAE-GAN (batch 12) and the VQ-f4 VQ-GAN
    (batch 8) at 256², then the VAE-GAN's device time by kernel group."""
    from types import SimpleNamespace

    from sd_tpu_torch.scripts.dryrun_multigpu import _first_stage_setup
    from sd_tpu_torch.scripts.profile_train import _busy_us, group_of
    from sd_tpu_torch.training.trainer import step_seed

    device = torch.device("cuda")
    opt = SimpleNamespace(tiny=False, steps=2 + TRAIN_STEPS + PROFILED_STEPS)
    out = {}
    for kind in ("kl", "vq"):
        trainer, state, data = _first_stage_setup(opt, device, kind, None, False)
        loader = data.train_dataloader()

        def step(i):
            generator = torch.Generator(device).manual_seed(step_seed(0, i))
            trainer.train_step(state, loader.batch(i), generator)

        times = []
        for i in range(2 + TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        row = {"ms_per_step": float(np.median(times)), "step_ms": times}
        if kind == "kl":
            activities = [torch.profiler.ProfilerActivity.CPU,
                          torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=activities) as prof:
                for i in range(2 + TRAIN_STEPS, 2 + TRAIN_STEPS + PROFILED_STEPS):
                    step(i)
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"]
            busy = _busy_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
            groups = {}
            for e in events:
                key = group_of(e.name)
                groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
            row.update(busy_ms_per_step=busy / PROFILED_STEPS,
                       group_ms_per_step={k: v / PROFILED_STEPS for k, v in
                                          sorted(groups.items(), key=lambda kv: -kv[1])},
                       k3_share=groups.get("K3 flash_attention_bwd", 0.0) / busy if busy else None,
                       k1_share=groups.get("K1 flash_attention", 0.0) / busy if busy else None)
        out[kind] = row
        print(f"[first stage {kind}] {row}", flush=True)
        del trainer, state, data, loader
        smoke.free_memory()
    return out


def time_cin256(smoke) -> dict:
    """cin256-v2's samples/s through sample_diffusion's build and sampler at
    the smoke's settings."""
    from sd_tpu_torch.scripts import sample_diffusion as cli

    with tempfile.TemporaryDirectory(prefix="bench_cin256_") as d:
        opt = cli.parse_args(["-c", smoke.CIN256_CONFIG] + smoke.CIN256_ARGS + ["-l", d])
        ldm, hw, channels = cli.build_model(opt)
        cli.sample(ldm, hw, channels, opt)
        rates = []
        for _ in range(REQUESTS):
            rates += cli.sample(ldm, hw, channels, opt)["samples_per_s"]
    del ldm
    smoke.free_memory()
    return {"samples_per_s": rates}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device is available")
    import sd_tpu_torch

    args = [a for a in sys.argv[1:] if not a.startswith("--cluster")]
    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"label": args[0] if args else "",
              "package": str(Path(sd_tpu_torch.__file__).parent), "card": smi}
    print(smi, flush=True)
    if "--cluster-device" in sys.argv[1:]:
        result["cluster_device_ms"] = time_cluster_device(smoke)
        print(json.dumps(result))
        return
    if "--cluster" in sys.argv[1:]:
        result["cluster_kernels"] = time_cluster_kernels(smoke)
        result["first_stage"] = time_first_stage(smoke)
        result["cin256"] = time_cin256(smoke)
        print(json.dumps(result))
        return
    result["kernels"] = time_kernels(smoke)
    print(json.dumps(result["kernels"]), flush=True)
    result["serving"] = time_serving(smoke)
    print(json.dumps(result["serving"]), flush=True)
    result["training"] = time_training()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
