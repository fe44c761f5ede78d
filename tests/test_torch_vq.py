"""The port's VQ first stage against sd_tpu's on the CPU in fp32.

The tiny VQ model (f2, 3 latent channels, 64 codes) with each ``attn_type``
(``vanilla``; ``linear``, the VAE's ``LinearAttention``; ``none``, here with
resampling without convs): the latent before quantization, the code indices
(equal), the quantized latent, the decode through the codebook and past it,
and ``decode_code``, each comparison one jitted JAX program, tolerance rtol
1e-4, atol 1e-4 of the output's scale (tests/test_torch_models.py's). The
converter inverts sd_tpu's ``port_vq_model``. A synthetic reference-layout
checkpoint of a tiny VQ concat LDM (the first stage also the cond stage,
so its weights stand under both names) loads strictly into the port and
through sd_tpu's porters, and both give the same ε and the same decodes.
The full-width configs build on the meta device with sd_tpu's parameter
counts, and the training CLI builds a VQ first stage's VQ-GAN trainer
(refusing a config without a training loss).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models import unet as junet
from sd_tpu.models import vae as jvae
from sd_tpu.utils import config as jconfig
from sd_tpu.utils import port as jport
from sd_tpu_torch.models.vae import VQModel
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.config import (build_latent_diffusion, load_yaml,
                                       tiny_inpaint_model_config)
from sd_tpu_torch.utils.port import load_torch_state_dict
from sd_tpu_torch.utils.testing import load_numpy_state_dict, random_state_dict
from torch_parity import jax_ldm, ldm_state_dict, nchw, random_params, to_nhwc, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def ddconfig(attn_type="vanilla", **kw):
    return dict(double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0,
                attn_type=attn_type, **kw)


N_EMBED = 64


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("attn_type", ["vanilla", "linear", "none"])
def test_vq_model_matches_sd_tpu(attn_type):
    dd = ddconfig(attn_type, **({"resamp_with_conv": False} if attn_type == "none" else {}))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jmodel = jvae.VQModel(ddconfig=dd, n_embed=N_EMBED, embed_dim=3)
    params = random_params(jmodel, np.random.default_rng(1), jnp.zeros((1, 32, 32, 3)))
    # codes at the latents' scale, so that each latent has near rivals
    params["quantize"]["embedding"] = np.random.default_rng(2).standard_normal(
        (N_EMBED, 3)).astype(np.float32)

    def run(p, x):
        v = {"params": p}
        h = jmodel.apply(v, x, method=jmodel.encode_pre_quant)
        z_q, _, idx = jmodel.apply(v, h, method=jmodel.quantize_latent)
        return (h, idx, z_q, jmodel.apply(v, h, method=jmodel.decode),
                jmodel.apply(v, h, True, method=jmodel.decode),
                jmodel.apply(v, idx, method=jmodel.decode_code))

    want = jax.jit(run)(params, jnp.asarray(x))
    model = load_numpy_state_dict(VQModel(dd, N_EMBED, 3), convert.vq_state_dict(params, dd))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(np.shape(a))) for a in jax.tree.leaves(params))
    with torch.no_grad():
        h = model.encode_pre_quant(nchw(x))
        z_q, loss, idx = model.encode(nchw(x))
        got = (h, idx, z_q, model.decode(h), model.decode(h, force_not_quantize=True),
               model.decode_code(idx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    assert len(np.unique(idx.numpy())) > 8 and loss.item() > 0
    for name, g, w in zip(("pre-quant", "z_q", "decode", "decode unquantized", "decode_code"),
                          got[:1] + got[2:], want[:1] + want[2:]):
        assert g.shape[0] == 2, name
        _close(to_nhwc(g), w)


def test_converter_inverts_port_vq_model():
    dd = ddconfig()
    sd = random_state_dict(VQModel(dd, N_EMBED, 3), np.random.default_rng(5))
    back = convert.vq_state_dict(jvae.port_vq_model(sd, dd), dd)
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def tiny_vq_concat_config():
    """The tiny concat model over a VQ first stage: x (3) + the masked
    image's latent (3) + the mask (1) into the UNet."""
    cfg = tiny_inpaint_model_config()
    p = cfg["params"]
    p["channels"], p["scale_factor"] = 3, 1.0
    p["unet_config"]["params"].update(in_channels=7, out_channels=3)
    p["first_stage_config"] = {"target": "ldm.models.autoencoder.VQModelInterface",
                               "params": {"embed_dim": 3, "n_embed": N_EMBED,
                                          "ddconfig": ddconfig()}}
    return cfg


def test_vq_concat_checkpoint_loads_strictly_and_matches_sd_tpu(tmp_path):
    cfg = tiny_vq_concat_config()
    jldm = jax_ldm(cfg, np.random.default_rng(3))
    # codes at the latents' scale: no latent within a rounding of a tie
    jldm.first_stage_params["quantize"]["embedding"] = np.random.default_rng(2).standard_normal(
        (N_EMBED, 3)).astype(np.float32)
    sd = ldm_state_dict(cfg, jldm)
    assert "first_stage_model.quantize.embedding.weight" in sd
    assert sd["model.diffusion_model.input_blocks.3.1.qkv.weight"].shape == (192, 64, 1)
    assert sd["cond_stage_model.quantize.embedding.weight"] is sd[
        "first_stage_model.quantize.embedding.weight"]
    # what a reference checkpoint holds beside the modules
    sd.update({"betas": np.linspace(1e-4, 2e-2, 1000, dtype=np.float32),
               "model_ema.decay": np.float32(0.9999), "model_ema.num_updates": np.int64(7)})
    path = str(tmp_path / "vq_concat.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)

    ldm = build_latent_diffusion(cfg, device="cpu", state_dict=load_torch_state_dict(path))
    assert ldm.conditioning_key == "concat" and ldm.cond_stage_is_first_stage
    ref = jconfig.build_latent_diffusion(cfg, state_dict=jport.load_torch_state_dict(path))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    c = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 21], np.int32)

    def run(p, x, t, c):
        m = ref.bind_params(p)
        # sd_tpu's flag is inverted: its default (True) quantizes
        return (m.apply_model(x, t, {"c_concat": [c]}), m.decode_first_stage(x),
                m.decode_first_stage(x, force_not_quantize=False))

    want = jax.jit(run)(ref.runtime_params(), jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    with torch.no_grad():
        got = (ldm.apply_model(nchw(x), torch.from_numpy(t), {"c_concat": [nchw(c)]}),
               ldm.decode_first_stage(nchw(x)),
               ldm.decode_first_stage(nchw(x), force_not_quantize=True))
    for g, w in zip(got, want):
        _close(to_nhwc(g), w)
    assert not np.allclose(want[1], want[2])  # the codebook moved the decode


@pytest.mark.parametrize("name", ["inpainting_big", "celebahq-ldm-vq-4"])
def test_full_width_config_builds_on_meta(name):
    """Both published configs at full width, on the meta device: no
    refusal, the reference's key layout, and sd_tpu's parameter counts."""
    cfg = load_yaml(os.path.join(_REPO, "sd_tpu_torch", "configs", f"{name}.yaml"))["model"]
    ldm = build_latent_diffusion(cfg, device="meta")
    sd = ldm.state_dict()
    assert sd["first_stage_model.quantize.embedding.weight"].shape == (8192, 3)
    assert (any(k.startswith("cond_stage_model.") for k in sd)
            == (name == "inpainting_big"))
    unet_p = cfg["params"]["unet_config"]["params"]
    jmodel = junet.UNetModel(junet.UNetConfig.from_dict(unet_p))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, unet_p["in_channels"])),
        jnp.zeros((1,), jnp.int32)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in ldm.model.diffusion_model.parameters()) == n_jax


def test_training_a_vq_first_stage_is_refused(tmp_path):
    """The training CLI trains a VQ first stage with the VQ loss (VQ
    first-stage training is ported), and refuses one whose lossconfig is
    the inference configs' ``torch.nn.Identity``: there is no loss to train."""
    from sd_tpu_torch.scripts.train import build_trainer, parse_args

    images = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
              "params": {"size": 32, "length": 2}}

    def build(lossconfig):
        cfg = {"model": {"target": "ldm.models.autoencoder.VQModel",
                         "params": {"embed_dim": 3, "n_embed": N_EMBED, "ddconfig": ddconfig(),
                                    "lossconfig": lossconfig}},
               "data": {"params": {"batch_size": 1, "train": images}}}
        path = tmp_path / "vq.yaml"
        path.write_text(json.dumps(cfg))
        return build_trainer(parse_args(["--base", str(path), "-t", "--device", "cpu", "-l",
                                         str(tmp_path / "logs")]))

    harness, state, _ = build({"target": "ldm.modules.losses.vqperceptual."
                                         "VQLPIPSWithDiscriminator",
                               "params": {"disc_start": 0, "codebook_weight": 0.5}})
    assert isinstance(state.ae, VQModel) and harness.trainer_obj.codebook_weight == 0.5
    with pytest.raises(ValueError, match="torch.nn.Identity"):
        build({"target": "torch.nn.Identity"})