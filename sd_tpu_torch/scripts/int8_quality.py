"""The int8 quality gate on a trained model (port of ``tools/int8_quality.py``).

Samples a model that the convergence run trained
(``sd_tpu_torch/scripts/convergence_run.py``: ColoredShapes, a ground truth
known per class) twice on the card from one seed: in bf16 and in the int8
serving mode ``all`` (``ops/quant.py``). It reports, for both arms, each
class's colour fidelity (the foreground's mean RGB against the class's
colour) and the background's, and the PSNR between the two sample sets,
and writes a side-by-side grid. The gate is agreement: PSNR at least 30 dB,
and the int8 arm's foreground colour error no more than the bf16 arm's plus
0.05. The two arms must differ: identical arms would mean the int8 path did
not run, and the PSNR would be vacuous.

The probe's sites are narrow, so only the int8 conv engages there: K4 needs
an FF inner width of 2560 and K5 2048 keys (``int8_mode_label`` says what
ran, in the report). ``--flagship`` runs the other leg instead: the SD v1
UNet at full width from seeded random bf16 weights, DDIM with guidance 7.5
for 2 samples, int8 ``all`` against bf16, where every int8 kernel runs at
its shapes; its gate is a relative L2 of the latents below
``AGREEMENT_TOL``, the serving mode's agreement gate.

    python -m sd_tpu_torch.scripts.int8_quality [--run <logdir>] [--per-class 2]
        [--out logs/convergence]
    python -m sd_tpu_torch.scripts.int8_quality --flagship [--steps 8]

The int8 mode runs only for bf16 tensors on a CUDA device: elsewhere the
script exits non-zero before it samples.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.scripts.convergence_run import REPO, device_name

# int8 (or a conv mode) against bf16 latents after the whole trajectory:
# the largest relative L2 the serving modes may drift
AGREEMENT_TOL = 0.10
RUNS = os.path.join(REPO, "logs/convergence_runs")


def find_run(workdir: str = RUNS) -> str:
    cands = sorted(glob.glob(os.path.join(workdir, "*_runa")))
    if not cands:
        raise FileNotFoundError(f"no convergence run under {workdir}; run python -m "
                                f"sd_tpu_torch.scripts.convergence_run")
    return cands[-1]


def check_agreement(label: str, got: torch.Tensor, want: torch.Tensor,
                    versus: str = "bf16") -> float:
    """Raise unless ``got`` is within ``AGREEMENT_TOL`` of ``want`` (relative
    L2 in fp32) and not identical to it; returns the relative L2."""
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    same = torch.equal(got, want)
    print(f"[{label}] agreement against {versus}: relative L2 {rel:.5f} (bound "
          f"{AGREEMENT_TOL}); identical: {same}", flush=True)
    if not (np.isfinite(rel) and rel < AGREEMENT_TOL) or same:
        raise AssertionError(f"[{label}] disagrees with {versus}: relative L2 {rel} (or "
                             f"identical to it)")
    return rel


def sample_set(ldm, cond, shape, generator: Optional[torch.Generator] = None,
               **draws) -> np.ndarray:
    """The full clipped ancestral chain, the reference's pixel-space sampling
    convention (``ddpm.py::p_sample_loop`` with ``clip_denoised=True``), its
    draws from ``generator`` (or ``x_T=`` and ``noise=`` given); NHWC
    float32 images in [-1, 1]. The probe trains in pixel space, where an
    unclipped x0 can leave [-1, 1] and the data's manifold."""
    from sd_tpu_torch.samplers.ancestral import p_sample_loop

    with torch.no_grad():
        z = p_sample_loop(ldm.apply_model, ldm.schedule, shape, cond=cond, generator=generator,
                          clip_denoised=True, **draws)
        imgs = ldm.decode_first_stage(z)
    return imgs.float().permute(0, 2, 3, 1).cpu().numpy()


def color_report(imgs, labels) -> dict:
    """Foreground color fidelity vs the parametric class colors."""
    from sd_tpu_torch.data.synthetic import ColoredShapes

    colors = ColoredShapes._COLORS
    ok, bg_errs, fg_errs = 0, [], []
    for img, lab in zip(imgs, labels):
        lum = img.max(-1) - (-0.95)
        fg = lum > 0.5
        bg_errs.append(float(np.abs(img[~fg] - (-0.95)).mean())
                       if (~fg).any() else 0.0)
        if not fg.any():
            fg_errs.append(2.0)
            continue
        mean_rgb = img[fg].mean(0)
        true = colors[lab // 4]
        fg_errs.append(float(np.abs(mean_rgb - true).mean()))
        nearest = int(np.argmin(np.abs(colors - mean_rgb).mean(1)))
        ok += int(nearest == lab // 4)
    return {
        "color_top1_acc": round(ok / len(imgs), 4),
        "fg_color_mae": round(float(np.mean(fg_errs)), 4),
        "bg_mae": round(float(np.mean(bg_errs)), 4),
    }


def require_int8_device(device) -> None:
    """Exit unless the int8 mode can run on ``device``: its gate takes bf16
    tensors on a CUDA device only, so elsewhere both arms would be bf16."""
    from sd_tpu_torch.ops.quant import int8_mode_label, parse_int8

    if int8_mode_label(parse_int8("all"), device) == "bf16":
        raise SystemExit(f"int8_quality: the int8 mode runs only for bf16 tensors on a CUDA "
                         f"device (ops/quant.py::int8_device_ok); on {device} both arms would "
                         f"run bf16 and the agreement would mean nothing")


def flagship_agreement(steps: int, out_dir: str, device: str = "cuda") -> dict:
    """bf16 against int8 ``all`` at SD v1's full width (seeded random bf16
    weights): 2 samples at 64² latents, DDIM ``steps`` with guidance 7.5 from
    one x_T and one pair of random contexts; K1, K2, K4 and K5 run at the
    sites they serve. Returns the report; raises past ``AGREEMENT_TOL``."""
    from sd_tpu_torch.ops.quant import int8_mode_label
    from sd_tpu_torch.samplers.ddim import ddim_sample
    from sd_tpu_torch.utils.config import SD_V1_MODEL_CONFIG, build_latent_diffusion

    require_int8_device(device)
    ldm = build_latent_diffusion(SD_V1_MODEL_CONFIG, device=device, dtype=torch.bfloat16,
                                 seed=7)
    b = 2
    g = torch.Generator(device).manual_seed(7)
    cond = (0.02 * torch.randn(b, 77, 768, generator=g, device=device)).bfloat16()
    uncond = (0.02 * torch.randn(b, 77, 768, generator=g, device=device)).bfloat16()
    x_T = torch.randn(b, 4, 64, 64, generator=g, device=device)

    def run_arm(mode: str) -> torch.Tensor:
        ldm.set_int8_mode(mode)
        with torch.no_grad():
            z = ddim_sample(ldm.apply_model, ldm.schedule, x_T, cond=cond, num_steps=steps,
                            uncond=uncond, guidance_scale=7.5)
        return z.float().cpu()

    z_bf16 = run_arm("off")
    z_int8 = run_arm("all")
    label = int8_mode_label(ldm.int8_mode, device)
    rel = check_agreement(f"int8_quality --flagship {label}", z_int8, z_bf16)
    peak = float(z_bf16.max() - z_bf16.min())
    mse = float(((z_bf16 - z_int8) ** 2).mean())
    rep = {
        "steps": steps,
        "mode": label,
        "device": device_name(device),
        "latent_rel_l2": round(rel, 5),
        "latent_psnr_db": round(10 * float(np.log10(peak**2 / max(mse, 1e-12))), 2),
        "bf16_latent_std": round(float(z_bf16.std()), 4),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "int8_flagship_agreement.json"), "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep, indent=1), flush=True)
    return rep


def quality(run: str, out_dir: str, per_class: int = 2, device: str = "cuda") -> dict:
    """Both arms of the trained run ``run``; returns the report with
    ``"pass"``, the gate's verdict."""
    from sd_tpu_torch.ops.quant import int8_mode_label
    from sd_tpu_torch.utils.checkpoint import run_config_path
    from sd_tpu_torch.utils.config import build_latent_diffusion_from_run, load_yaml
    from sd_tpu_torch.utils.image import make_grid, save_image

    require_int8_device(device)
    # the current weights, not the EMA shadow: at the reference's 0.9999
    # decay a few-thousand-step toy run leaves the shadow near the random
    # init (the image logger samples the current weights too); the frozen
    # ClassEmbedder is drawn again from the run's seed on its device type
    ldm, meta = build_latent_diffusion_from_run(run, device=device, dtype=torch.bfloat16,
                                                use_ema=False)
    n_cls = ldm.cond_stage_model.embedding.num_embeddings
    labels = np.repeat(np.arange(n_cls), per_class)
    with torch.no_grad():
        cond = ldm.get_learned_conditioning(torch.as_tensor(labels, device=device))
    mp = load_yaml(run_config_path(run))["model"]["params"]
    shape = (len(labels), mp["channels"], mp["image_size"], mp["image_size"])

    def arm(mode: str) -> np.ndarray:
        ldm.set_int8_mode(mode)
        return sample_set(ldm, cond, shape, torch.Generator(device).manual_seed(1234))

    imgs_bf16 = arm("off")
    imgs_int8 = arm("all")
    label = int8_mode_label(ldm.int8_mode, device)
    if np.array_equal(imgs_bf16, imgs_int8):
        raise AssertionError("bf16 and int8 arms are bitwise identical: the int8 path did not "
                             "run, and the PSNR gate would be vacuous")
    mse = float(np.mean((imgs_bf16 - imgs_int8) ** 2))
    psnr = 10 * np.log10(4.0 / max(mse, 1e-12))  # [-1,1] range -> peak 2
    rep = {
        "run": run,
        "step": meta.get("step"),
        "sampler": "ancestral-1000 clip_denoised (ddpm.py::p_sample_loop)",
        "samples": int(len(labels)),
        "device": device_name(device),
        "mode": label,
        "bf16": color_report(imgs_bf16, labels),
        "int8": color_report(imgs_int8, labels),
        "int8_vs_bf16_psnr_db": round(float(psnr), 2),
    }
    # The gate is AGREEMENT with bf16, not toy-model sample fidelity: whatever
    # the probe draws, the int8 path must draw the same thing
    rep["pass"] = bool(rep["int8_vs_bf16_psnr_db"] >= 30.0
                       and rep["int8"]["fg_color_mae"] <= rep["bf16"]["fg_color_mae"] + 0.05)
    os.makedirs(out_dir, exist_ok=True)
    both = np.concatenate([imgs_bf16, imgs_int8])
    grid = make_grid(np.clip((both + 1) / 2, 0, 1), n_rows=len(labels))
    save_image((grid * 255).astype(np.uint8), os.path.join(out_dir, "int8_vs_bf16_samples.png"))
    with open(os.path.join(out_dir, "int8_quality.json"), "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep, indent=1), flush=True)
    return rep


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default=None, help="a convergence run's logdir (default: the "
                    "newest run A under logs/convergence_runs)")
    ap.add_argument("--per-class", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8, help="--flagship's DDIM steps")
    ap.add_argument("--out", default=os.path.join(REPO, "logs/convergence"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flagship", action="store_true",
                    help="run the SD v1 agreement leg instead (the ff and attn int8 kernels, "
                         "which the probe's sites are too narrow to take)")
    args = ap.parse_args(argv)
    if args.flagship:
        flagship_agreement(args.steps, args.out, args.device)
        print("INT8 FLAGSHIP AGREEMENT: PASS", flush=True)
        return 0
    require_int8_device(args.device)  # before it looks for a run
    rep = quality(args.run or find_run(), args.out, args.per_class, args.device)
    print("INT8 QUALITY:", "PASS" if rep["pass"] else "CHECK REPORT", flush=True)
    return 0 if rep["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
