"""Multi-rank dry run of the port's parallelism (the counterpart of
``__graft_entry__.py::dryrun_multichip``), one process a rank:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m sd_tpu_torch.scripts.dryrun_multigpu [--backend nccl|gloo] [--device cuda|cpu] \\
        [--tiny] [--legs train,hsdp,pipeline,sample,fit,tp] [--batch B] [--steps S]

``--device`` defaults to ``cuda`` and ``--backend`` to the device's
(``nccl`` for ``cuda``, ``gloo`` for ``cpu``); ``--backend gloo --device
cuda`` puts every rank on one card (NCCL refuses that). SD v1 at full width
(seeded random weights) unless ``--tiny``. The legs, each of which raises
where its check fails:

- ``train`` (``sd_tpu``'s legs 1 and 2): S steps of the LDM trainer under
  DDP with ZeRO-1 (AdamW's moments and the EMA shadow partitioned) at a
  global batch B (B / N a rank, ``--accumulate`` micro-batches), a finite
  loss every step and each rank holding at most its share of the moments
  plus the largest parameter; then rank 0 runs the same S steps in one
  process at batch B (no DDP, no ZeRO) and compares (``compare_training``):
  on the CPU AdamW's first moments within ``MOMENT_TOL`` of their scale and
  the parameters and the EMA shadow within ``sd_tpu``'s 5e-5 (max abs)
  wherever the gradient is not rounding noise, on the card the relative L2
  of the first moments within ``CARD_MOMENT_TOL`` and of the parameters'
  deltas within ``CARD_DELTA_TOL``. Per step: the ms (host clock after a sync) and the
  K1, K2 and K3 launches; the peak memory of the rank;
- ``hsdp`` (leg 3): a ``(data, model)`` mesh with ``model`` = 2, the UNet
  under ``torch.distributed.fsdp.fully_shard`` over it (HSDP: the weights
  sharded over ``model``, replicated over ``data``; ``sd_tpu``'s
  ``zero_sharding(params, axis="model")``), the same steps, a finite loss,
  and after ``train`` the parameters against the one-process run. gloo
  takes only broadcast and all-reduce on CUDA tensors, not FSDP's
  all-gather and reduce-scatter: on gloo over the card the leg says so and
  does not run;
- ``pipeline`` (leg 5): ``Txt2ImgPipeline`` with a mesh against the same
  pipeline in this one process, max uint8 difference <= 1;
- ``sample``: ``sharded_sample`` (PLMS 50, guidance 7.5, a global batch of
  8) against rank 0 sampling the batch alone from the same x_T; relative L2
  of the latents within ``SAMPLE_TOL`` (fp32 on the CPU) or
  ``CARD_SAMPLE_TOL`` (bf16 on the card); the K1 and K2 launches a rank;
- ``fit``: ``Trainer.fit``'s ms a step (the training loop around the
  step, its per-step checks included), S steps at a global batch B under
  DDP + ZeRO-1 over every rank and, on rank 0, in one process, in the order
  one, DDP, DDP, one; each timed from the entry of its second step to the
  end of its last, with no sync between but the loop's own. The saves are
  skipped: the leg times the steps;
- ``tp``: the UNet tensor-parallel over all ranks against the replicated
  UNet: one evaluation at B=2 (on the CPU in fp32 within 2e-5, with the
  gradients too; on the card in bf16 within ``CARD_TP_TOL``, relative L2),
  one all-reduce a row-parallel boundary, and a rank's K1 and K2 launches
  equal to the replicated evaluation's.

Each rank prints one line ``DRYRUN {json}`` with its numbers (launch
counters are per process). ``sd_tpu``'s leg 4, an XLA ahead-of-time
compile at the flagship shapes, has no eager counterpart: the legs run SD v1
at full width on the card instead.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sd_tpu_torch.core.draws import RowDraws
from sd_tpu_torch.parallel.mesh import (BACKENDS, init_distributed, make_mesh, rank,
                                        world_size, zero_owners)

LEGS = ("train", "hsdp", "pipeline", "sample", "fit", "tp")
# sd_tpu's dryrun bound (fp32 on the CPU: the all-reduce sums in another order)
CPU_TOL = 5e-5
# AdamW's first moments (the gradients' running mean, where a sum in place of
# a mean or a rank's rows missing would show), each tensor's largest gap over
# its scale (at least a thousandth of the largest moment), fp32 on the CPU
MOMENT_TOL = 1e-3
# a weight whose gradient's RMS stays below this is rounding noise (a bias
# that the next GroupNorm subtracts again, as at the tiny UNet's one channel
# a group): AdamW moves it by about lr either way, so its value after the
# steps says nothing, and only the first moments are compared there
NOISE_RMS = 1e-6
# on the card, against one process, the relative L2 of AdamW's first moments
# (the gradients) and of the parameters' deltas after the steps: cuDNN's bf16
# conv gives a row a result that depends on its batch slot, and AdamW's first
# step is lr·sign(g), so an element whose gradient is near 0 may step the
# other way. SD v1, 2 ranks on one H100 against one process at batch 4, 2
# steps, read 2.9e-3 and 4.25e-2 in a probe (one rank over NCCL: 0 and 0)
CARD_MOMENT_TOL = 2e-2
CARD_DELTA_TOL = 0.10
# sharded sampling against one process: fp32 CPU, and the card's bf16
# (the agreement gate of chip_smoke.py)
SAMPLE_TOL = 1e-5
CARD_SAMPLE_TOL = 0.10
# the tensor-parallel UNet against the replicated one: sd_tpu's 2e-5 in fp32
# on the CPU; bf16 on the card, relative L2 (the partial sums round apart)
CPU_TP_TOL = 2e-5
# SD v1 in bf16 over 2 ranks on an H100 read 1.62e-2 in a probe: each
# row-parallel layer's partial products round to bf16 before the sum
CARD_TP_TOL = 5e-2
LR = 1e-4
SEED = 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=BACKENDS,
                   help="default: nccl for cuda, gloo for cpu")
    p.add_argument("--tiny", action="store_true", help="the tiny model instead of SD v1")
    p.add_argument("--legs", default="train,hsdp,pipeline",
                   help=f"comma-separated, of {', '.join(LEGS)}")
    p.add_argument("--batch", type=int, default=4, help="the global batch of train and hsdp")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--accumulate", type=int, default=1)
    opt = p.parse_args(argv)
    opt.legs = [leg for leg in opt.legs.split(",") if leg]
    unknown = set(opt.legs) - set(LEGS)
    if unknown:
        p.error(f"unknown legs {sorted(unknown)}")
    return opt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Dict[str, int]:
    """K1's, K2's and K3's launch counters (this process's)."""
    from sd_tpu_torch.ops import cuda

    return {"K1": cuda.flash_attention.launches, "K2": cuda.geglu_ff.launches,
            "K3": cuda.flash_attention_bwd.launches}


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective), or the tensor, detached, on
    its device (the comparisons run there)."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _train_run(opt, device, group, shards: int, shard: int, hsdp_mesh=None) -> Dict[str, Any]:
    """``opt.steps`` LDM steps at the global batch over ``shards`` loader
    shards: under DDP + ZeRO-1 where ``group`` is given, under HSDP where
    ``hsdp_mesh`` is, else one process. Returns the numbers and, on rank 0
    of the job, the parameters and the EMA shadow before and after."""
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.training.trainer import DataModuleFromConfig, step_seed
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    if device.type == "cuda":  # the run's own peak: above what an earlier run left
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    cfg = train_config(opt.tiny)
    ldm = build_latent_diffusion(cfg["model"], device=device, dtype=torch.float32,
                                 seed=SEED)
    unet = ldm.model.diffusion_model
    keep = rank() == 0
    # on the host, so that the copy adds nothing to the run's device memory
    before = {n: _full(p).cpu() for n, p in unet.named_parameters()} if keep else None
    if hsdp_mesh is not None:
        from torch.distributed.fsdp import fully_shard

        fully_shard(unet, mesh=hsdp_mesh)
    parallel = {} if group is None else dict(data_group=group, zero=True)
    trainer, state = create_train_state(ldm, LR, use_ema=True,
                                        accumulate_grad_batches=opt.accumulate, **parallel)
    data = DataModuleFromConfig(opt.batch // shards, cfg["data"]["params"]["train"],
                                num_shards=shards, shard_index=shard)
    loader = data.train_dataloader()
    out: Dict[str, Any] = {"ms": [], "launches": [], "loss": []}
    for step in range(opt.steps):
        generator = torch.Generator(device).manual_seed(step_seed(SEED, step))
        if hsdp_mesh is not None and shards > 1:  # FSDP syncs; the draws are the rank's rows
            generator = RowDraws(generator, shard, shards, strided=True)
        batch = loader.batch(step)
        _sync(device)
        counts, t0 = _launches(), time.perf_counter()
        aux = trainer.train_step(state, batch, generator)
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({k: v - counts[k] for k, v in _launches().items()})
        loss = float(aux["loss"])
        out["loss"].append(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"step {step + 1}: loss {loss}")
    if device.type == "cuda":
        out["peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    if group is not None:
        zero = state.optimizer
        owners = zero_owners(zero)
        sizes = [p.numel() * p.element_size() for g in zero.param_groups for p in g["params"]]
        mine = sum(s for s, o in zip(sizes, owners) if o == rank(group))
        share, largest = sum(sizes) / world_size(group), max(sizes)
        out["zero"] = {"owned_bytes": mine, "share_bytes": share, "largest_bytes": largest,
                       "ema_tensors": len(state.ema.shadow), "tensors": len(sizes)}
        if mine > share + largest:
            raise AssertionError(f"ZeRO-1: rank {rank()} owns {mine} bytes of moments, above "
                                 f"its share {share} plus the largest parameter {largest}")
        if world_size(group) > 1 and not len(state.ema.shadow) < len(sizes):
            raise AssertionError("ZeRO-1: the EMA shadow is not partitioned")
    names = [n for n, _ in unet.named_parameters()]
    after = {n: _full(p) for n, p in unet.named_parameters()}
    shadow = {n: _full(s) for n, s in state.ema.full_shadow().items() if n in after}
    moments = optimizer_moments(state.optimizer, names)
    if keep:
        out.update(before=before, after=after, shadow=shadow, moments=moments)
    del trainer, state, ldm, unet, after, shadow, moments
    _free(device)
    return out


def optimizer_moments(optimizer, names: Sequence[str]) -> Optional[Dict[str, tuple]]:
    """``{name: (exp_avg, exp_avg_sq, step)}`` of the first ``len(names)``
    parameters of an AdamW (a DTensor's gathered), on their device; every
    rank calls it. Under ZeRO-1 each pair is broadcast from its owner and
    rank 0 alone returns them (the others None)."""
    params = [p for g in optimizer.param_groups for p in g["params"]][:len(names)]
    if not hasattr(optimizer, "consolidate_state_dict"):
        return {n: (_full(optimizer.state[p]["exp_avg"]), _full(optimizer.state[p]["exp_avg_sq"]),
                    float(optimizer.state[p]["step"])) for n, p in zip(names, params)}
    group = optimizer.process_group
    me, out = rank(group), {}
    for n, p, owner in zip(names, params, zero_owners(optimizer)):
        st = optimizer.optim.state[p] if owner == me else None
        pair = [_full(st[k]) if st else torch.empty_like(p) for k in ("exp_avg", "exp_avg_sq")]
        step = torch.tensor([float(st["step"]) if st else 0.0], device=p.device)
        for t in (*pair, step):
            dist.broadcast(t, src=dist.get_global_rank(group, owner), group=group)
        if me == 0:
            out[n] = (*pair, float(step))
    return out if me == 0 else None


def moments_of(optimizer_sd: Dict[str, Any], names: Sequence[str]) -> Dict[str, tuple]:
    """:func:`optimizer_moments` of a single-process optimizer ``state_dict``
    (a checkpoint's), its parameters in ``names``' order."""
    st = optimizer_sd["state"]
    return {n: (_full(st[i]["exp_avg"]), _full(st[i]["exp_avg_sq"]), float(st[i]["step"]))
            for i, n in enumerate(names)}


def compare_training(got: Dict[str, Any], ref: Dict[str, Any], on_cpu: bool) -> Dict[str, Any]:
    """Two training runs from the same weights and data (``after``,
    ``moments``, optional ``before`` and ``shadow``: name → tensor). On the
    CPU: AdamW's first moments within MOMENT_TOL of their scale, and the
    parameters and the EMA shadow within CPU_TOL wherever the gradient is not
    rounding noise (NOISE_RMS); on the card, the relative L2 of the first
    moments within CARD_MOMENT_TOL and of the parameters' deltas within
    CARD_DELTA_TOL. Returns the numbers and ``ok``."""
    scale = max(float(m.abs().max()) for m, _, _ in ref["moments"].values())
    moment_err = num_m = den_m = 0.0
    max_abs = ema_abs = num_d = den_d = 0.0
    noise = 0
    for n, (m_ref, v_ref, step) in ref["moments"].items():
        m_got = got["moments"][n][0]
        moment_err = max(moment_err, float((m_got - m_ref).abs().max())
                         / max(float(m_ref.abs().max()), 1e-3 * scale))
        num_m += float((m_got - m_ref).double().square().sum())
        den_m += float(m_ref.double().square().sum())
        if "before" in ref:
            dev = ref["after"][n].device
            d_ref = ref["after"][n] - ref["before"][n].to(dev)
            d_got = got["after"][n] - got["before"][n].to(dev)
            num_d += float((d_got - d_ref).double().square().sum())
            den_d += float(d_ref.double().square().sum())
        if float((v_ref / (1 - 0.999 ** step)).sqrt().max()) < NOISE_RMS:
            noise += 1
            continue
        max_abs = max(max_abs, float((got["after"][n] - ref["after"][n]).abs().max()))
        if n in ref.get("shadow", {}):
            ema_abs = max(ema_abs, float((got["shadow"][n] - ref["shadow"][n]).abs().max()))
    res = {"moment_err": moment_err, "moment_rel_l2": (num_m / den_m) ** 0.5 if den_m else 0.0,
           "max_abs": max_abs, "ema_max_abs": ema_abs, "noise_tensors": noise,
           "delta_rel_l2": (num_d / den_d) ** 0.5 if den_d else 0.0}
    if on_cpu:
        res["ok"] = bool(moment_err < MOMENT_TOL and max_abs < CPU_TOL and ema_abs < CPU_TOL)
    else:
        res["ok"] = bool(res["moment_rel_l2"] < CARD_MOMENT_TOL
                         and res["delta_rel_l2"] < CARD_DELTA_TOL)
    return res


def _compare(got: Dict[str, Any], ref: Dict[str, Any], device: torch.device,
             label: str) -> Dict[str, Any]:
    """:func:`compare_training` of a parallel run against one process's,
    logged; raises where it fails."""
    res = compare_training(got, ref, device.type == "cpu")
    bound = (f"first moments < {MOMENT_TOL} of their scale, parameters and EMA max abs < "
             f"{CPU_TOL} but at {res['noise_tensors']} tensors of rounding-noise gradient"
             if device.type == "cpu" else
             f"relative L2 of the first moments < {CARD_MOMENT_TOL} and of the deltas < "
             f"{CARD_DELTA_TOL}")
    print(f"[dryrun {label}] against one process: first moments {res['moment_err']:.3e} of "
          f"their scale (relative L2 {res['moment_rel_l2']:.3e}), parameters max abs "
          f"{res['max_abs']:.3e}, EMA max abs {res['ema_max_abs']:.3e}, deltas relative L2 "
          f"{res['delta_rel_l2']:.3e} ({bound}) {'ok' if res['ok'] else 'FAIL'}", flush=True)
    if not res["ok"]:
        raise AssertionError(f"{label}: the parallel run differs from one process: {res}")
    return res


def leg_train(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    n = world_size()
    run = _train_run(opt, device, dist.group.WORLD, n, rank())
    res = {k: run[k] for k in ("ms", "launches", "loss", "zero", "peak_gib") if k in run}
    if rank() == 0:
        ref = _train_run(opt, device, None, 1, 0)
        shared["reference"] = ref
        res["reference_ms"] = ref["ms"]
        res["reference_peak_gib"] = ref.get("peak_gib")
        res.update(_compare(run, ref, device, "train"))
    dist.barrier()
    return res


# FSDP's collectives that gloo does not take on CUDA tensors (it takes
# broadcast and all-reduce there; a probe of all_gather_into_tensor on an H100
# with torch 2.11 ended both ranks with SIGSEGV, so the leg does not try)
GLOO_CUDA_REFUSES = "all_gather_into_tensor and reduce_scatter_tensor"


def leg_hsdp(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    n = world_size()
    if n % 2:
        print(f"[dryrun hsdp] needs an even number of ranks, not {n}: not run", flush=True)
        return {"ran": False, "reason": f"{n} ranks"}
    if dist.get_backend() == "gloo" and device.type == "cuda":
        print(f"[dryrun hsdp] gloo takes no {GLOO_CUDA_REFUSES} on CUDA tensors, which FSDP "
              f"needs: HSDP does not run on gloo over the card (it runs on the CPU)",
              flush=True)
        return {"ran": False, "refused": GLOO_CUDA_REFUSES}
    mesh = make_mesh(n // 2, 2, device.type)
    run = _train_run(opt, device, None, n // 2, mesh.get_local_rank("data"), hsdp_mesh=mesh)
    res = {"ran": True, "mesh": [n // 2, 2], "loss": run["loss"], "ms": run["ms"]}
    if rank() == 0 and "reference" in shared:
        res.update(_compare(run, shared["reference"], device, "hsdp"))
    dist.barrier()
    return res


def _fit_run(opt, device, group) -> float:
    """``Trainer.fit`` over ``opt.steps`` steps at the global batch, in one
    process or under DDP + ZeRO-1 over ``group``: the ms a step from the
    entry of the second step to the end of the last (module docstring)."""
    import tempfile
    from unittest import mock

    from sd_tpu_torch.training import trainer as trainer_mod
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    cfg = train_config(opt.tiny)
    ldm = build_latent_diffusion(cfg["model"], device=device, dtype=torch.float32,
                                 seed=SEED)
    shards, shard = (1, 0) if group is None else (world_size(group), rank(group))
    parallel = {} if group is None else dict(data_group=group, zero=True)
    trainer, state = create_train_state(ldm, LR, use_ema=True,
                                        accumulate_grad_batches=opt.accumulate, **parallel)
    data = trainer_mod.DataModuleFromConfig(opt.batch // shards, cfg["data"]["params"]["train"],
                                            num_shards=shards, shard_index=shard)
    entries, step = [], trainer.train_step

    def timed_step(state_, batch, generator):
        entries.append(time.perf_counter())
        return step(state_, batch, generator)

    trainer.train_step = timed_step
    with tempfile.TemporaryDirectory() as logdir, \
            mock.patch.object(trainer_mod, "save_last", lambda *args: None):
        trainer_mod.Trainer(trainer, logdir, max_steps=opt.steps, ckpt_every=10**9,
                            log_every=10**9, seed=SEED).fit(state, data)
        _sync(device)
        end = time.perf_counter()
    del trainer, state, ldm, data
    _free(device)
    return (end - entries[1]) * 1e3 / (len(entries) - 1)


def leg_fit(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    if opt.steps < 2:
        raise ValueError("fit: --steps must be at least 2 (the first step is not timed)")
    res: Dict[str, Any] = {"ms": [], "single_ms": []}
    for kind in ("single", "ddp", "ddp", "single"):
        if kind == "ddp":
            res["ms"].append(_fit_run(opt, device, dist.group.WORLD))
        elif rank() == 0:
            res["single_ms"].append(_fit_run(opt, device, None))
        dist.barrier()
    if rank() == 0:
        res["overhead"] = float(np.mean(res["ms"]) / np.mean(res["single_ms"]) - 1)
        print(f"[dryrun fit] Trainer.fit, {opt.steps - 1} steps timed at batch {opt.batch}: "
              f"DDP + ZeRO-1 over {world_size()} ranks "
              f"{', '.join(f'{v:.1f}' for v in res['ms'])} ms a step, one process "
              f"{', '.join(f'{v:.1f}' for v in res['single_ms'])} "
              f"({100 * res['overhead']:+.1f}%)", flush=True)
    return res


def _pipeline(opt, device):
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    pipe, _ = build_txt2img_pipeline(tiny=opt.tiny, device=device, seed=SEED, safety=False,
                                     watermark=False)
    return pipe


def leg_pipeline(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    import dataclasses

    pipe = _pipeline(opt, device)
    n = world_size()
    prompts = [f"a test shape {i}" for i in range(2 * n)]
    hw = 64 if opt.tiny else 512
    kw = dict(height=hw, width=hw, steps=2, sampler="plms")
    single = pipe(prompts, torch.Generator(device).manual_seed(5), **kw)
    mesh = make_mesh(n, 1, device.type)
    sharded = dataclasses.replace(pipe, mesh=mesh)(prompts, torch.Generator(device)
                                                   .manual_seed(5), **kw)
    diff = int(np.abs(single.astype(np.int32) - sharded.astype(np.int32)).max())
    print(f"[dryrun pipeline] {len(prompts)} prompts over {n} ranks against one process: max "
          f"uint8 difference {diff} (bound 1) {'ok' if diff <= 1 else 'FAIL'}", flush=True)
    if sharded.shape != single.shape or diff > 1:
        raise AssertionError(f"pipeline: sharded {sharded.shape} against {single.shape}, max "
                             f"uint8 difference {diff}")
    return {"max_u8_diff": diff, "images": list(sharded.shape)}


@torch.inference_mode()
def leg_sample(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    from sd_tpu_torch.parallel.sharded_sampling import sharded_sample
    from sd_tpu_torch.samplers.common import randn
    from sd_tpu_torch.samplers.plms import plms_sample

    pipe = _pipeline(opt, device)
    ldm = pipe.ldm
    batch, steps, scale = 8, 50, 7.5
    cond = pipe.encode_prompts([f"a photograph of object {i}" for i in range(batch)])
    uncond = pipe.encode_prompts([""] * batch)
    hw = 64 if opt.tiny else 512
    shape = (batch, pipe.latent_channels, hw // pipe.downsample, hw // pipe.downsample)
    mesh = make_mesh(world_size(), 1, device.type)
    kw = dict(num_steps=steps, guidance_scale=scale)
    _sync(device)
    counts, t0 = _launches(), time.perf_counter()
    z = sharded_sample(mesh, plms_sample, ldm.apply_model, ldm.schedule, shape, cond,
                       generator=torch.Generator(device).manual_seed(11), uncond=uncond, **kw)
    _sync(device)
    res = {"s": time.perf_counter() - t0,
           "launches": {k: v - counts[k] for k, v in _launches().items()}}
    if rank() == 0:
        x_T = randn(shape, torch.Generator(device).manual_seed(11), device)
        t0 = time.perf_counter()
        ref = plms_sample(ldm.apply_model, ldm.schedule, x_T, cond, uncond=uncond, **kw)
        _sync(device)
        res["single_s"] = time.perf_counter() - t0
        rel = float((z.float() - ref.float()).norm() / ref.float().norm())
        tol = SAMPLE_TOL if device.type == "cpu" else CARD_SAMPLE_TOL
        res["rel_l2"] = rel
        print(f"[dryrun sample] PLMS {steps}, guidance {scale}, batch {batch} over "
              f"{world_size()} ranks against one process: latents relative L2 {rel:.3e} "
              f"(bound {tol}) {'ok' if rel < tol else 'FAIL'}", flush=True)
        if not (np.isfinite(rel) and rel < tol):
            raise AssertionError(f"sharded_sample: relative L2 {rel} against one process")
    del pipe, ldm
    _free(device)
    dist.barrier()
    return res


def leg_tp(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    from sd_tpu_torch.parallel.tp import (RowParallelConv3x3, RowParallelLinear,
                                          parallelize_unet, reduce_tp_gradients,
                                          tp_all_reduce)
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    cfg = train_config(opt.tiny)["model"]
    on_cpu = device.type == "cpu"
    dtype = torch.float32 if on_cpu else torch.bfloat16
    unet = build_latent_diffusion(cfg, device=device, dtype=dtype,
                                  seed=SEED).model.diffusion_model
    p = cfg["params"]["unet_config"]["params"]
    g = torch.Generator(device).manual_seed(3)
    hw = p["image_size"]
    x = torch.randn((2, p["in_channels"], hw, hw), generator=g, device=device).to(dtype)
    t = torch.tensor([3, 500], device=device)
    ctx = torch.randn((2, 77 if not opt.tiny else 8, p["context_dim"]), generator=g,
                      device=device).to(dtype)

    def run(model):
        """One evaluation (and on the CPU the gradients of sum(out²))."""
        model.zero_grad(set_to_none=True)
        with torch.set_grad_enabled(on_cpu):
            _sync(device)
            counts = _launches()
            out = model(x, t, context=ctx)
            _sync(device)
            launches = {k: v - counts[k] for k, v in _launches().items()}
            if on_cpu:
                out.float().square().sum().backward()
        return out.detach().float(), launches

    unet.eval().requires_grad_(on_cpu)
    ref, ref_launches = run(unet)
    ref_grads = {n: q.grad.clone() for n, q in unet.named_parameters()} if on_cpu else {}
    mesh = make_mesh(1, world_size(), device.type)
    layout = parallelize_unet(unet, mesh, num_heads=p["num_heads"])
    boundaries = sum(isinstance(m, (RowParallelLinear, RowParallelConv3x3))
                     for m in unet.modules())
    tp_all_reduce.calls = 0
    out, launches = run(unet)
    calls = tp_all_reduce.calls
    err = float((out - ref).abs().max())
    rel = float((out - ref).norm() / ref.norm())
    res = {"max_abs": err, "rel_l2": rel, "all_reduces": calls, "boundaries": boundaries,
           "launches": launches, "replicated_launches": ref_launches,
           "sharded_tensors": sum(d is not None for d in layout.plan.values())}
    if on_cpu:
        reduce_tp_gradients(unet, layout)
        grad_err = 0.0
        for n, q in unet.named_parameters():
            want, dim = ref_grads[n], layout.plan[n]
            if dim is not None:
                parts = want.chunk(2, dim) if "ff.net.0.proj." in n else (want,)
                k = parts[0].shape[dim] // layout.size
                want = torch.cat([w.narrow(dim, layout.rank * k, k) for w in parts], dim)
            scale = max(1.0, float(want.abs().max()))
            grad_err = max(grad_err, float((q.grad - want).abs().max()) / scale)
        res["grad_max_abs"] = grad_err
        ok = err < CPU_TP_TOL * max(1.0, float(ref.abs().max())) and grad_err < CPU_TP_TOL
        bound = f"max abs < {CPU_TP_TOL} of the scale, gradients too"
    else:
        ok = rel < CARD_TP_TOL
        bound = f"relative L2 < {CARD_TP_TOL}"
    ok = ok and calls == boundaries and launches == ref_launches and boundaries > 0
    print(f"[dryrun tp] UNet over {layout.size} ranks, {res['sharded_tensors']} tensors "
          f"sharded: max abs {err:.3e}, relative L2 {rel:.3e} ({bound}); {calls} all-reduces "
          f"for {boundaries} row-parallel boundaries; launches {launches}, replicated "
          f"{ref_launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"tp: {res}")
    del unet
    _free(device)
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = parse_args(argv)
    backend = opt.backend or ("nccl" if torch.device(opt.device).type == "cuda" else "gloo")
    device = init_distributed(backend, opt.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    result: Dict[str, Any] = {"rank": rank(), "world": world_size(), "backend": backend,
                              "device": str(device)}
    shared: Dict[str, Any] = {}
    legs = {"train": leg_train, "hsdp": leg_hsdp, "pipeline": leg_pipeline,
            "sample": leg_sample, "fit": leg_fit, "tp": leg_tp}
    try:
        for leg in opt.legs:
            t0 = time.perf_counter()
            result[leg] = legs[leg](opt, device, shared)
            result[leg]["leg_s"] = time.perf_counter() - t0
            print(f"[dryrun {leg}] rank {rank()}: {result[leg]['leg_s']:.1f} s", flush=True)
        print("DRYRUN " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
