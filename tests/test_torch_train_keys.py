"""LDM training under every conditioning key on the CPU against sd_tpu's
``LDMTrainer.loss_fn``, in fp32, on tiny models over a tiny VQ first stage
(f2, 3 latent channels, so no posterior draw): None (unconditional),
``concat`` (the LR image through a ``torch.nn.Identity`` cond stage, as
``bsr_sr``), ``hybrid`` (a dict of ``c_concat`` and ``c_crossattn`` through
an Identity cond stage) and ``adm`` (class ids as the UNet's ``y``). The
same weights (sd_tpu's, carried across), batch, t and noise (sd_tpu's own
draws) go into both. Then ``scripts/train.py --base`` trains each key for
which a dataset yields the conditioning (None and ``adm`` on synthetic
images, ``concat`` on ``ImageNetSRTrain`` pairs of a synthetic tree); no
dataset yields ``hybrid``'s dict, in the port, ``sd_tpu`` or the reference.

Tolerance: the loss rtol 1e-5 (fp32 through the VQ encoder and the UNet),
as tests/test_torch_train_config.py. The gradients of that loss are
tests/test_torch_train_config.py's concern; here the concatenated
channels are checked to carry gradient.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sd_tpu.training.diffusion_loss import LDMTrainer as JaxLDMTrainer
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from sd_tpu_torch.training.diffusion_loss import create_train_state
from sd_tpu_torch.utils.config import build_latent_diffusion
from torch_parity import jax_ldm, ldm_state_dict, nchw, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


DDCONFIG = dict(double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
IDENTITY = {"target": "torch.nn.Identity"}
B = 2


def _model_cfg(key):
    """A tiny LDM over the VQ stage for ``key``: its UNet's inputs, cond
    stage and cond_stage_key."""
    unet = dict(image_size=16, in_channels=3, out_channels=3, model_channels=32,
                attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                num_head_channels=8)
    p = dict(linear_start=0.0015, linear_end=0.0195, timesteps=1000, image_size=16, channels=3,
             first_stage_config={"target": "ldm.models.autoencoder.VQModelInterface",
                                 "params": {"embed_dim": 3, "n_embed": 16,
                                            "ddconfig": DDCONFIG,
                                            "lossconfig": IDENTITY}},
             cond_stage_config="__is_unconditional__")
    if key == "concat":
        unet["in_channels"] = 6
        p.update(conditioning_key="concat", cond_stage_key="LR_image",
                 cond_stage_config=IDENTITY)
    elif key == "hybrid":
        unet.update(in_channels=6, use_spatial_transformer=True, context_dim=16, num_heads=4)
        p.update(conditioning_key="hybrid", cond_stage_key="hybrid", cond_stage_config=IDENTITY)
    elif key == "adm":
        unet["num_classes"] = 5
        p.update(conditioning_key="adm", cond_stage_key="class_label",
                 cond_stage_config=IDENTITY)
    p["unet_config"] = {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
                        "params": unet}
    return {"base_learning_rate": 1e-4, "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
            "params": p}


def _batch(key, rng):
    batch = {"image": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)}
    lr = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    if key == "concat":
        batch["LR_image"] = lr
    elif key == "hybrid":
        batch["hybrid"] = {"c_concat": [lr],
                           "c_crossattn": [rng.standard_normal((B, 4, 16)).astype(np.float32)]}
    elif key == "adm":
        batch["class_label"] = np.array([1, 4])
    return batch


@pytest.mark.parametrize("key", [None, "concat", "hybrid", "adm"], ids=str)
def test_ldm_loss_under_each_conditioning_key_matches_sd_tpu(key):
    cfg = _model_cfg(key)
    rng = np.random.default_rng(0)
    jldm = dataclasses.replace(jax_ldm(cfg, rng),
                               cond_stage_key=cfg["params"].get("cond_stage_key", "caption"))
    assert jldm.conditioning_key == key
    sd = ldm_state_dict(cfg, jldm)
    ldm = build_latent_diffusion(cfg, device="cpu", state_dict={
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    trainer, state = create_train_state(ldm, 1e-4, use_ema=False)
    assert ldm.conditioning_key == key
    batch = _batch(key, rng)

    jtrainer = JaxLDMTrainer(ldm=jldm, optimizer=optax.adamw(1e-4), use_ema=False)
    params = jtrainer.init_state().params
    k = jax.random.PRNGKey(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want, _ = jax.jit(jtrainer.loss_fn)(params, jbatch, k)
    _, k_t, k_noise = jax.random.split(k, 3)  # the VQ stage draws nothing from k_enc
    t = np.asarray(jax.random.randint(k_t, (B,), 0, 1000))
    z, cond = trainer.latents_and_cond(batch)
    noise = np.asarray(jax.random.normal(k_noise, (B, 16, 16, 3)))
    loss, aux = trainer.loss_at(z, cond, torch.from_numpy(t.copy()), nchw(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    if key in ("concat", "hybrid"):  # the condition's input channels carry gradient
        grad = trainer.unet.input_blocks[0][0].weight.grad
        assert grad[:, 3:].abs().max() > 1e-3 * grad.abs().max()
    # and a whole step
    logs = trainer.train_step(state, batch, torch.Generator().manual_seed(1))
    assert state.step == 1 and np.isfinite(float(logs["loss"]))


def _imagenet_tree(root):
    from PIL import Image

    for s, syn in enumerate(["n01", "n02"]):
        (root / syn).mkdir(parents=True)
        for i in range(2):
            arr = (np.random.default_rng(10 * s + i).random((40, 36, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / syn / f"{i}.JPEG")
    (root / "filelist.txt").write_text("n01/0.JPEG\nn01/1.JPEG\nn02/0.JPEG\nn02/1.JPEG\n")


@pytest.mark.parametrize("key", [None, "concat", "adm"], ids=str)
def test_train_cli_trains_each_conditioning_key(tmp_path, key):
    synthetic = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
                 "params": {"size": 32, "length": 4, "n_classes": 5}}
    if key == "concat":
        pytest.importorskip("cv2")
        _imagenet_tree(tmp_path / "imagenet")
        data = {"target": "ldm.data.imagenet.ImageNetSRTrain",
                "params": {"data_root": str(tmp_path / "imagenet"), "size": 32,
                           "degradation": "bsrgan_light", "downscale_f": 2}}
    else:
        data = synthetic
    cfg = {"model": _model_cfg(key), "data": {"params": {"batch_size": B, "train": data,
                                                         "num_workers": 4, "wrap": False}}}
    path = tmp_path / "ldm.yaml"
    path.write_text(json.dumps(cfg))
    harness, state, loaded = build_trainer(parse_args(
        ["--base", str(path), "-t", "--device", "cpu", "-l", str(tmp_path / "logs"),
         "--max_steps", "2", "--log_every", "1"]))
    assert harness.trainer_obj.ldm.conditioning_key == key
    harness.fit(state, loaded)
    assert state.step == 2
    images = sorted(p.name for p in (tmp_path / "logs").glob("*/images/*.png"))
    # the image logger samples for an unconditional model and a conditional one
    assert any("samples" in name for name in images), images
