"""Multi-rank dry run of the port's parallelism (the counterpart of
``__graft_entry__.py::dryrun_multichip``), one process a rank:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m sd_tpu_torch.scripts.dryrun_multigpu [--backend nccl|gloo] [--device cuda|cpu] \\
        [--tiny] [--legs train,first_stage,hsdp,pipeline,sample,fit,fit_first_stage,tp] \\
        [--batch B] [--steps S]

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
  K1, K2 and K3 launches; the peak memory of the rank; after the steps the
  checkpoint's gather of the ZeRO-1 AdamW timed (``time_save``: at one
  rank twice, in turns with ``consolidate_state_dict``'s pickling gather,
  equal to the bit);
- ``first_stage``: S steps of the kl-f8 VAE-GAN
  (``sd_tpu_torch/configs/autoencoder_kl_32x32x4.yaml``) and of the VQ-f4
  VQ-GAN (``sd_tpu_torch/configs/vq-f4.yaml``), full width at 256² and
  ``disc_start`` 0, at their files' batches (12 and 8) as global batches
  of synthetic images (``--tiny``: the tiny KL config at 32² and
  ``TINY_VQ_CONFIG`` at 24², a global batch of 4), under DDP (+ ZeRO-1 over
  both Adams from 2 ranks); then rank 0 runs the same steps in one process
  as the reference of N ranks (``VAEGANTrainer(shards=N)``: each rank's
  d_weight and batch statistics are its own, so N ranks are not one
  process at N·B) and compares (``compare_training`` over both optimizers,
  at Adam's beta2 of 0.9), with the logvar and the discriminator's running
  statistics (rank 0's, which DDP broadcasts) beside them; at one rank
  every gap must be 0. Every rank must hold the same logvar. Per step and
  rank: the ms, the K1/K3 launches; the peak memory of the rank;
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
- ``fit_first_stage``: ``fit`` for the kl-f8 VAE-GAN of ``first_stage``
  (its global batch of 12, DDP + ZeRO-1 over both Adams);
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
import pathlib
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sd_tpu_torch.core.draws import RowDraws
from sd_tpu_torch.parallel.mesh import (BACKENDS, all_gather_rows, init_distributed,
                                        make_mesh, optimizer_state_dict, rank, world_size,
                                        zero_owners)

LEGS = ("train", "first_stage", "hsdp", "pipeline", "sample", "fit", "fit_first_stage", "tp")
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
# the first_stage leg's models: config, global batch
REPO = pathlib.Path(__file__).resolve().parents[2]
FIRST_STAGE = {"kl": ("sd_tpu_torch/configs/autoencoder_kl_32x32x4.yaml", 12),
               "vq": ("sd_tpu_torch/configs/vq-f4.yaml", 8)}
TINY_FIRST_STAGE = {"kl": ("configs/sd_tpu/tiny-autoencoder-kl.yaml", 4), "vq": (None, 4)}
# the tiny VQ first stage (f2, 3 latent channels, 64 codes; attention at the
# mid-blocks only, as vq-f4's), at 24²
TINY_VQ_CONFIG = {
    "base_learning_rate": 4.5e-6, "target": "ldm.models.autoencoder.VQModel",
    "params": {"embed_dim": 3, "n_embed": 64,
               "ddconfig": dict(double_z=False, z_channels=3, resolution=24, in_channels=3,
                                out_ch=3, ch=32, ch_mult=[1, 2], num_res_blocks=1,
                                attn_resolutions=[], dropout=0.0),
               "lossconfig": {"target": "taming.modules.losses.vqperceptual."
                                        "VQLPIPSWithDiscriminator",
                              "params": {"disc_start": 0, "disc_weight": 0.75,
                                         "codebook_weight": 1.0}}}}
# Adam's beta2 for the first stage (the reference's betas 0.5, 0.9)
FIRST_STAGE_BETA2 = 0.9
# the discriminator's running statistics against the reference's, relative
# L2: fp32 on the CPU (the ranks' weights round apart from the reference's
# after a step); bf16 on the card, as CARD_MOMENT_TOL
STATS_TOL = 1e-5


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
        out["zero"] = zero_share(state.optimizer, group)
        out["zero"].update(ema_tensors=len(state.ema.shadow))
        out["save"] = time_save(state.optimizer, device)
        if world_size(group) > 1 and not len(state.ema.shadow) < out["zero"]["tensors"]:
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


def zero_share(zero, group) -> Dict[str, Any]:
    """The bytes of a ZeRO-1 optimizer's parameters this rank owns the
    moments of, its share and the largest parameter; raises where it owns
    more than its share plus the largest."""
    owners = zero_owners(zero)
    sizes = [p.numel() * p.element_size() for g in zero.param_groups for p in g["params"]]
    mine = sum(s for s, o in zip(sizes, owners) if o == rank(group))
    share, largest = sum(sizes) / world_size(group), max(sizes)
    if mine > share + largest:
        raise AssertionError(f"ZeRO-1: rank {rank()} owns {mine} bytes of moments, above "
                             f"its share {share} plus the largest parameter {largest}")
    return {"owned_bytes": mine, "share_bytes": share, "largest_bytes": largest,
            "tensors": len(sizes)}


def equal_state(a: Any, b: Any) -> bool:
    """Whether two state dicts are equal to the bit: the same keys and
    structure, and every tensor of the same dtype, device and shape with
    equal elements."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            equal_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            equal_state(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype and a.device == b.device
                and a.shape == b.shape and torch.equal(a, b))
    return a == b


def time_save(zero, device: torch.device) -> Dict[str, Any]:
    """The checkpoint's gather of a ZeRO-1 optimizer (``optimizer_state_dict``,
    tensor broadcasts to rank 0's CPU) timed on every rank, host clock after
    a sync. At one rank it is timed twice in turns with
    ``consolidate_state_dict`` + ``state_dict``, the pickling way it
    replaced: both cold (the gather's result alive while the other is
    taken, so neither finds pinned host memory freed by the other) and
    checked equal to the bit, then both warm in the other order. At more
    ranks the gather is timed once and that way is not run (SD v1's AdamW
    over gloo took 455 s)."""
    def timed(fn):
        _sync(device)
        t0 = time.perf_counter()
        value = fn()
        _sync(device)
        return value, time.perf_counter() - t0

    def consolidated():
        zero.consolidate_state_dict(to=0)
        out = zero.state_dict()
        zero._all_state_dicts = []  # the state dict keeps the tensors
        return out

    gather = lambda: optimizer_state_dict(zero)
    new, cold = timed(gather)
    res: Dict[str, Any] = {"gather_s": [cold]}
    one = world_size(zero.process_group) == 1
    if one:
        old, cold = timed(consolidated)
        res["consolidate_s"] = [cold]
        res["equal"] = equal_state(new, old)
        if not res["equal"]:
            raise AssertionError("the tensor gather's state dict differs from "
                                 "consolidate_state_dict's")
        del new, old
        gc.collect()
        res["consolidate_s"].append(timed(consolidated)[1])
        gc.collect()
        res["gather_s"].append(timed(gather)[1])
    print(f"[dryrun save] rank {rank()}: the ZeRO-1 optimizer's state gathered to rank 0's CPU "
          f"by tensors in {' and '.join(f'{t:.2f}' for t in res['gather_s'])} s"
          + (f"; consolidate_state_dict + state_dict in "
             f"{' and '.join(f'{t:.2f}' for t in res['consolidate_s'])} s (cold, then warm; "
             f"the warm ones in the other order), equal to the bit" if one else ""), flush=True)
    return res


def optimizer_moments(optimizer, names: Sequence[str]) -> Optional[Dict[str, tuple]]:
    """``{name: (exp_avg, exp_avg_sq, step)}`` of the first ``len(names)``
    parameters of an AdamW (a DTensor's gathered), on their device; every
    rank calls it. Under ZeRO-1 it is the checkpoint's gather
    (``optimizer_state_dict``, each parameter's moments broadcast by its
    owner), and rank 0 alone returns them (the others None)."""
    device = optimizer.param_groups[0]["params"][0].device
    sd = optimizer_state_dict(optimizer, device=device)
    return None if sd is None else moments_of(sd, names)


def moments_of(optimizer_sd: Dict[str, Any], names: Sequence[str]) -> Dict[str, tuple]:
    """:func:`optimizer_moments` of a single-process optimizer ``state_dict``
    (a checkpoint's), its parameters in ``names``' order."""
    st = optimizer_sd["state"]
    return {n: (_full(st[i]["exp_avg"]), _full(st[i]["exp_avg_sq"]), float(st[i]["step"]))
            for i, n in enumerate(names)}


def compare_training(got: Dict[str, Any], ref: Dict[str, Any], on_cpu: bool,
                     beta2: float = 0.999) -> Dict[str, Any]:
    """Two training runs from the same weights and data (``after``,
    ``moments``, optional ``before`` and ``shadow``: name → tensor). On the
    CPU: AdamW's first moments within MOMENT_TOL of their scale, and the
    parameters and the EMA shadow within CPU_TOL wherever the gradient is not
    rounding noise (NOISE_RMS); on the card, the relative L2 of the first
    moments within CARD_MOMENT_TOL and of the parameters' deltas within
    CARD_DELTA_TOL. ``beta2`` is the optimizer's (AdamW's 0.999, the first
    stage's Adam 0.9), for the gradient's RMS. Returns the numbers and
    ``ok``."""
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
        if float((v_ref / (1 - beta2 ** step)).sqrt().max()) < NOISE_RMS:
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
             label: str, beta2: float = 0.999) -> Dict[str, Any]:
    """:func:`compare_training` of a parallel run against one process's,
    logged; raises where it fails."""
    res = compare_training(got, ref, device.type == "cpu", beta2)
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
    res = {k: run[k] for k in ("ms", "launches", "loss", "zero", "save", "peak_gib") if k in run}
    if rank() == 0:
        ref = _train_run(opt, device, None, 1, 0)
        shared["reference"] = ref
        res["reference_ms"] = ref["ms"]
        res["reference_peak_gib"] = ref.get("peak_gib")
        res.update(_compare(run, ref, device, "train"))
    dist.barrier()
    return res


def _first_stage_config(opt, kind: str):
    """The ``kind`` first stage's model config node and its global batch."""
    from sd_tpu_torch.utils.config import load_yaml

    path, batch = (TINY_FIRST_STAGE if opt.tiny else FIRST_STAGE)[kind]
    return (TINY_VQ_CONFIG if path is None else load_yaml(str(REPO / path))["model"]), batch


def _first_stage_setup(opt, device, kind: str, group, zero: bool, ref_shards: int = 1):
    """``(trainer, state, data)`` of the ``kind`` first stage at its global
    batch (disc_start 0) on synthetic images at its resolution: under DDP
    over ``group`` on the rank's loader shard (and ZeRO-1 with ``zero``), or
    in one process as the reference of ``ref_shards`` ranks. The LR is the
    CLI's, the base LR times the global batch."""
    from sd_tpu_torch.training.trainer import DataModuleFromConfig
    from sd_tpu_torch.training.vae_gan import build_vae_gan

    cfg, batch = _first_stage_config(opt, kind)
    base_lr = cfg.get("params", {}).get("base_learning_rate", cfg.get("base_learning_rate"))
    parallel = dict(shards=ref_shards) if group is None else dict(data_group=group, zero=zero)
    trainer, state = build_vae_gan(cfg, device, SEED, base_lr * batch, disc_start=0, **parallel)
    images = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
              "params": {"size": cfg["params"]["ddconfig"]["resolution"],
                         "length": batch * max(opt.steps, 2)}}
    shards, shard = (1, 0) if group is None else (world_size(group), rank(group))
    data = DataModuleFromConfig(batch // shards, images, num_shards=shards, shard_index=shard)
    return trainer, state, data


def _first_stage_run(opt, device, kind: str, group, ref_shards: int = 1) -> Dict[str, Any]:
    """``opt.steps`` VAE-GAN steps of the ``kind`` first stage under DDP over
    ``group`` (ZeRO-1 from 2 ranks) on the rank's loader shard, or in one
    process as the reference of ``ref_shards`` ranks. Returns the numbers
    and, on rank 0 of the job, the parameters before and after (both
    optimizers', prefixed ``ae.`` and ``disc.``), the moments, the logvar
    and the discriminator's running statistics."""
    from sd_tpu_torch.training.trainer import step_seed

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    n = world_size(group) if group is not None else 1
    trainer, state, data = _first_stage_setup(opt, device, kind, group, n > 1, ref_shards)
    keep = rank() == 0
    named = {f"{part}.{k}": p for part, module in (("ae", state.ae), ("disc", state.disc))
             for k, p in module.named_parameters()}
    before = {k: p.detach().cpu().clone() for k, p in named.items()} if keep else None
    loader = data.train_dataloader()
    out: Dict[str, Any] = {"ms": [], "launches": [], "loss": [], "d_weight": [],
                           "disc_loss": []}
    for step in range(opt.steps):
        generator = torch.Generator(device).manual_seed(step_seed(SEED, step))
        batch = loader.batch(step)
        _sync(device)
        counts, t0 = _launches(), time.perf_counter()
        aux = trainer.train_step(state, batch, generator)
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({k: v - counts[k] for k, v in _launches().items()})
        for key, name in (("loss", "total_loss"), ("d_weight", "d_weight"),
                          ("disc_loss", "disc_loss")):
            out[key].append(float(aux[name]))
        if not all(np.isfinite(out[key][-1]) for key in ("loss", "d_weight", "disc_loss")):
            raise AssertionError(f"{kind} step {step + 1}: {aux}")
    if device.type == "cuda":
        out["peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    if n > 1:
        out["zero"] = {name: zero_share(opt_, group) for name, opt_ in
                       (("ae", state.ae_opt), ("disc", state.disc_opt))}
    if state.logvar is not None:
        out["logvar"] = state.logvar.item()
    if state.logvar is not None and group is not None:
        # every rank's logvar, in rank order, on every rank
        ranks = all_gather_rows(state.logvar.detach().reshape(1), group).tolist()
        if len(set(ranks)) != 1:
            raise AssertionError(f"{kind}: the ranks' logvars differ: {ranks}")
    moments = {}
    for part, module, optimizer in (("ae", state.ae, state.ae_opt),
                                    ("disc", state.disc, state.disc_opt)):
        names = [k for k, _ in module.named_parameters()]
        got = optimizer_moments(optimizer, names)
        if got is not None:
            moments.update({f"{part}.{k}": v for k, v in got.items()})
    if keep:
        out.update(before=before, after={k: _full(p) for k, p in named.items()},
                   moments=moments,
                   stats={k: v.detach().clone() for k, v in state.disc.state_dict().items()
                          if "running" in k})
    del trainer, state, data, named, moments
    _free(device)
    return out


def _first_stage_gaps(run: Dict[str, Any], ref: Dict[str, Any], device: torch.device,
                      kind: str, n: int) -> Dict[str, Any]:
    """The DDP run against the reference of n ranks: ``compare_training``
    over both optimizers, the logvar's gap, and the relative L2 of the
    running statistics (rank 0's against shard 0's); at one rank every gap
    must be 0. Logged; raises where a gap is out of bounds."""
    res = _compare(run, ref, device, f"first_stage {kind}", FIRST_STAGE_BETA2)
    num = sum(float((run["stats"][k] - v).double().square().sum()) for k, v in ref["stats"].items())
    den = sum(float(v.double().square().sum()) for v in ref["stats"].values())
    res["stats_rel_l2"] = (num / den) ** 0.5
    res["logvar_gap"] = abs(run["logvar"] - ref["logvar"]) if "logvar" in ref else 0.0
    gaps = ("moment_rel_l2", "delta_rel_l2", "max_abs", "stats_rel_l2", "logvar_gap")
    tol = STATS_TOL if device.type == "cpu" else CARD_MOMENT_TOL
    ok = res["stats_rel_l2"] < tol and (n > 1 or all(res[k] == 0 for k in gaps))
    print(f"[dryrun first_stage {kind}] against the reference of {n} rank(s): running "
          f"statistics relative L2 {res['stats_rel_l2']:.3e} (bound {tol}), logvar gap "
          f"{res['logvar_gap']:.3e}{'; at one rank every gap must be 0' if n == 1 else ''} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"first_stage {kind}: {res}")
    return res


def leg_first_stage(opt, device, shared: Dict[str, Any],
                    kinds: Sequence[str] = tuple(FIRST_STAGE)) -> Dict[str, Any]:
    n = world_size()
    res = {}
    for kind in kinds:
        run = _first_stage_run(opt, device, kind, dist.group.WORLD)
        res[kind] = {k: run[k] for k in ("ms", "launches", "loss", "d_weight", "disc_loss",
                                         "zero", "peak_gib", "logvar") if k in run}
        res[kind]["batch"] = _first_stage_config(opt, kind)[1]
        if rank() == 0:
            ref = _first_stage_run(opt, device, kind, None, ref_shards=n)
            res[kind].update(reference_ms=ref["ms"], reference_peak_gib=ref.get("peak_gib"),
                             reference_loss=ref["loss"],
                             **_first_stage_gaps(run, ref, device, kind, n))
            del ref
        del run
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


def _ldm_setup(opt, device, group):
    """``(trainer, state, data)`` of SD v1 (or the tiny model) at the global
    batch, in one process or under DDP + ZeRO-1 over ``group``."""
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.training.trainer import DataModuleFromConfig
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    cfg = train_config(opt.tiny)
    ldm = build_latent_diffusion(cfg["model"], device=device, dtype=torch.float32,
                                 seed=SEED)
    shards, shard = (1, 0) if group is None else (world_size(group), rank(group))
    parallel = {} if group is None else dict(data_group=group, zero=True)
    trainer, state = create_train_state(ldm, LR, use_ema=True,
                                        accumulate_grad_batches=opt.accumulate, **parallel)
    data = DataModuleFromConfig(opt.batch // shards, cfg["data"]["params"]["train"],
                                num_shards=shards, shard_index=shard)
    return trainer, state, data


def _kl_setup(opt, device, group):
    """The kl-f8 VAE-GAN of the first_stage leg, in one process or under
    DDP + ZeRO-1 over ``group``."""
    return _first_stage_setup(opt, device, "kl", group, True)


def _fit_run(opt, device, group, setup) -> float:
    """``Trainer.fit`` over ``opt.steps`` steps of ``setup(opt, device,
    group)``'s trainer, in one process or under DDP + ZeRO-1 over ``group``:
    the ms a step from the entry of the second step to the end of the last
    (module docstring)."""
    import tempfile
    from unittest import mock

    from sd_tpu_torch.training import trainer as trainer_mod

    trainer, state, data = setup(opt, device, group)
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
    del trainer, state, data
    _free(device)
    return (end - entries[1]) * 1e3 / (len(entries) - 1)


def _alternate_fit(opt, device, setup, label: str) -> Dict[str, Any]:
    """:func:`_fit_run` in the order one process, DDP, DDP, one process."""
    if opt.steps < 2:
        raise ValueError("fit: --steps must be at least 2 (the first step is not timed)")
    res: Dict[str, Any] = {"ms": [], "single_ms": []}
    for kind in ("single", "ddp", "ddp", "single"):
        if kind == "ddp":
            res["ms"].append(_fit_run(opt, device, dist.group.WORLD, setup))
        elif rank() == 0:
            res["single_ms"].append(_fit_run(opt, device, None, setup))
        dist.barrier()
    if rank() == 0:
        res["overhead"] = float(np.mean(res["ms"]) / np.mean(res["single_ms"]) - 1)
        print(f"[dryrun {label}] Trainer.fit, {opt.steps - 1} steps timed: DDP + ZeRO-1 over "
              f"{world_size()} ranks {', '.join(f'{v:.1f}' for v in res['ms'])} ms a step, one "
              f"process {', '.join(f'{v:.1f}' for v in res['single_ms'])} "
              f"({100 * res['overhead']:+.1f}%)", flush=True)
    return res


def leg_fit(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    return _alternate_fit(opt, device, _ldm_setup, f"fit at batch {opt.batch}")


def leg_fit_first_stage(opt, device, shared: Dict[str, Any]) -> Dict[str, Any]:
    batch = _first_stage_config(opt, "kl")[1]
    return _alternate_fit(opt, device, _kl_setup, f"fit_first_stage kl at batch {batch}")


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
    legs = {"train": leg_train, "first_stage": leg_first_stage, "hsdp": leg_hsdp,
            "pipeline": leg_pipeline, "sample": leg_sample, "fit": leg_fit,
            "fit_first_stage": leg_fit_first_stage, "tp": leg_tp}
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
