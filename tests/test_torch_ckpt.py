"""Checkpoint loading in the port against sd_tpu's, on the CPU in fp32.

One synthetic checkpoint in the reference's layout (the tiny model's
sd_tpu parameters through sd_tpu_torch.utils.convert under
``model.diffusion_model.``, ``first_stage_model.`` and
``cond_stage_model.transformer.``, plus an EMA shadow of other values
under ``model_ema.``, the schedule buffers and CLIP's ``position_ids``, as
``sd-v1-4-full-ema.ckpt`` holds them) goes into both packages: sd_tpu
through ``load_torch_state_dict`` and ``build_latent_diffusion(state_dict=)``
(which always takes ViT-L/14's text config, so the tiny CLIP goes through
its ``port_clip_text`` with the tiny config), the port through its own
``build_latent_diffusion``. Their PLMS latents agree to rtol 1e-3 (atol 1e-3 of the latents'
scale), the slice test's tolerance. Also: the EMA demangling, the
refusals, the port's own run directory, and the YAML/JSON config reader.
"""

import dataclasses
import gzip
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from sd_tpu.models.clip import CLIPTextModel as JaxCLIP
from sd_tpu.models.clip import port_clip_text
from sd_tpu.samplers.plms import plms_sample as jax_plms_sample
from sd_tpu.utils import config as jconfig
from sd_tpu.utils import port as jport
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.data.tokenizer import HashTokenizer
from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
from sd_tpu_torch.samplers.plms import plms_sample
from sd_tpu_torch.utils.config import (
    SD_V1_MODEL_CONFIG,
    build_latent_diffusion,
    build_latent_diffusion_from_run,
    load_yaml,
    tiny_sd_model_config,
)
from sd_tpu_torch.utils.port import demangle_ema_keys, load_torch_state_dict
from torch_parity import ldm_state_dict, nchw, tiny_jax_ldm, to_nhwc, torch_threads

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = "model.diffusion_model."


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(cfg, config path, checkpoint path, its state_dict) of the tiny model."""
    cfg = tiny_sd_model_config()
    rng = np.random.default_rng(0)
    sd = ldm_state_dict(cfg, tiny_jax_ldm(cfg, rng))
    for k in [k for k in sd if k.startswith(UNET)]:
        mangled = ("diffusion_model." + k[len(UNET):]).replace(".", "")
        sd[f"model_ema.{mangled}"] = (sd[k] + 0.05 * rng.standard_normal(sd[k].shape)
                                      ).astype(np.float32)
    sd["model_ema.decay"] = np.array(0.9999, np.float32)
    sd["model_ema.num_updates"] = np.array(1234, np.int64)
    schedule = DiffusionSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        sd[name] = getattr(schedule, name)
    sd["cond_stage_model.transformer.text_model.embeddings.position_ids"] = np.arange(8)[None]
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    d = tmp_path_factory.mktemp("reference")
    ckpt = str(d / "tiny.ckpt")
    torch.save({"state_dict": sd, "global_step": 7}, ckpt)
    config = str(d / "tiny.json")
    with open(config, "w") as f:
        json.dump({"model": cfg}, f)
    return cfg, config, ckpt, sd


def _sd_tpu_ldm(cfg, ckpt):
    sd = jport.load_torch_state_dict(ckpt)
    jldm = jconfig.build_latent_diffusion(
        cfg, state_dict={k: v for k, v in sd.items() if not k.startswith("cond_stage_model.")})
    clip_cfg = JaxCLIPConfig(**cfg["params"]["cond_stage_config"]["params"])
    return dataclasses.replace(
        jldm, cond_stage_model=JaxCLIP(clip_cfg),
        cond_stage_params=port_clip_text(sd, clip_cfg,
                                         prefix="cond_stage_model.transformer.text_model."))


def test_checkpoint_samples_like_sd_tpu(reference):
    cfg, _, ckpt, sd = reference
    ldm = build_latent_diffusion(cfg, device="cpu", state_dict=load_torch_state_dict(ckpt))
    # a .ckpt loads the model keys, not the EMA keys
    for k, v in ldm.model.diffusion_model.state_dict().items():
        assert torch.equal(v, sd[UNET + k]), k
    jldm = _sd_tpu_ldm(cfg, ckpt)

    tok = HashTokenizer(64)
    tokens = tok(["a painting of a virus monster playing guitar", "a red cube"],
                 context_length=8)
    empty = tok(["", ""], context_length=8)
    x_T = np.random.default_rng(1).standard_normal((2, 16, 16, 4)).astype(np.float32)
    encode = jax.jit(jldm.get_learned_conditioning)
    want = jax.jit(lambda c, u, x: jax_plms_sample(
        jldm.apply_model, jldm.schedule, x.shape, c, jax.random.PRNGKey(0), num_steps=5,
        uncond=u, guidance_scale=7.5, x_T=x)[0])(encode(jnp.asarray(tokens)),
                                                  encode(jnp.asarray(empty)), jnp.asarray(x_T))
    with torch.no_grad():
        enc = lambda t: ldm.get_learned_conditioning(torch.from_numpy(t).long())
        got = plms_sample(ldm.apply_model, ldm.schedule, nchw(x_T), enc(tokens), num_steps=5,
                          uncond=enc(empty), guidance_scale=7.5)
    want = np.asarray(want)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_ema_keys_demangle_like_sd_tpu(reference):
    _, _, ckpt, sd = reference
    got = demangle_ema_keys(load_torch_state_dict(ckpt))
    want = jport.demangle_ema_keys(jport.load_torch_state_dict(ckpt))
    assert sorted(got) == sorted(want) == sorted(k for k in sd if k.startswith(UNET))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
        assert not torch.equal(v, sd[k])


def test_refusals(reference, tmp_path, monkeypatch):
    _, config, ckpt, _ = reference
    monkeypatch.delenv("SD_TPU_BPE_VOCAB", raising=False)
    with pytest.raises(SystemExit, match="BPE"):
        build_txt2img_pipeline(config=config, ckpt=ckpt, device="cpu", safety=False)
    (tmp_path / "run" / "checkpoints").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        build_txt2img_pipeline(ckpt=str(tmp_path / "run"), device="cpu", safety=False)
    # with a vocabulary, the checkpoint loads, and the CLIP tokenizer reads it
    merges = ["#version: 0.2", "a b", "ab c</w>"] + [f"{c} {c}" for c in "defgh"] * 10000
    vocab = tmp_path / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges))
    monkeypatch.setenv("SD_TPU_BPE_VOCAB", str(vocab))
    pipe, _ = build_txt2img_pipeline(config=config, ckpt=ckpt, device="cpu", safety=False)
    ids = pipe.tokenizer(["abc"])
    assert ids.shape == (1, 8) and ids[0, 1] == 512 + 1 and ids[0, 2] == ids[0, 0] + 1
    assert (pipe.downsample, pipe.latent_channels) == (2, 4)


def test_run_directory_loads_ema_or_current_params(tmp_path):
    from sd_tpu_torch.scripts.train import main as train

    logdir = str(tmp_path / "run")
    train(["--tiny", "--device", "cpu", "--max_steps", "2", "--logdir", logdir])
    blob = torch.load(os.path.join(logdir, "checkpoints", "last.pt"), weights_only=True)
    state = blob["state"]
    assert blob["meta"]["frozen_device"] == "cpu"

    ldm, meta = build_latent_diffusion_from_run(logdir, device="cpu")
    current, _ = build_latent_diffusion_from_run(logdir, device="cpu", use_ema=False)
    assert meta["params_source"] == "EMA" and meta["step"] == 2
    moved = 0
    for k, v in ldm.model.diffusion_model.state_dict().items():
        assert torch.equal(v, state["ema"]["shadow"][k]), k
        assert torch.equal(current.model.diffusion_model.state_dict()[k], state["unet"][k]), k
        moved += not torch.equal(v, state["unet"][k])
    assert moved > 0
    # the frozen stages are the trainer's: drawn again from the seed
    fresh = build_latent_diffusion(tiny_sd_model_config(), device="cpu", seed=23)
    for k, v in ldm.first_stage_model.state_dict().items():
        assert torch.equal(v, fresh.first_stage_model.state_dict()[k]), k

    pipe, _ = build_txt2img_pipeline(ckpt=logdir, device="cpu", watermark=False)
    images = pipe(["a red cube"], torch.Generator().manual_seed(0), height=64, width=64,
                  steps=3, sampler="dpm")
    assert images.shape == (1, 64, 64, 3) and pipe.last_safety_flags == [False]

    blob["meta"]["frozen_device"] = "cuda"
    torch.save(blob, os.path.join(logdir, "checkpoints", "last.pt"))
    with pytest.raises(ValueError, match="frozen stages on cuda"):
        build_latent_diffusion_from_run(logdir, device="cpu")


def test_config_files_build_the_same_model(tmp_path):
    import yaml

    assert load_yaml(os.path.join(_REPO, "configs/stable-diffusion/v1-inference.yaml"))[
        "model"] == SD_V1_MODEL_CONFIG
    cfg = tiny_sd_model_config()
    (tmp_path / "tiny.json").write_text(json.dumps({"model": cfg}))
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump({"model": cfg}))
    built = [build_latent_diffusion(load_yaml(str(tmp_path / name))["model"], device="cpu",
                                    seed=5).state_dict() for name in ("tiny.json", "tiny.yaml")]
    assert built[0].keys() == built[1].keys()
    assert all(torch.equal(built[0][k], built[1][k]) for k in built[0])


# ------------------------------------------------------------- tokenizer

UNICODE_TEXTS = [
    "Café naïve résumé, déjà vu", "café with a combining accent", "東京タワーの夜景 and 北京",
    "a cat 🐱 wearing a hat 🎩🎩", "x² + y³ = z⁴ and H₂O", "Chapter Ⅻ, Ⅳ and ⅷ",
    "it's 42 o'clock, they'll see what we've done", "½ cup, ① first, Ⓐ", "ÅNGSTRÖM &amp; ǅ",
    "ﬁne   spaces\tand\nnewlines", "ΑΒΓ δεζ кириллица",
]


def _merges(texts):
    """A synthetic merges table over byte-level symbols: every other word
    of ``texts`` merged left to right into one token, the others half way."""
    from sd_tpu_torch.data.tokenizer import _clean, _clip_pattern, bytes_to_unicode

    enc, merges = bytes_to_unicode(), []
    words = [w for text in texts for w in _clip_pattern().findall(_clean(text))]
    for i, word in enumerate(words):
        symbols = [enc[b] for b in word.encode("utf-8")]
        symbols[-1] += "</w>"
        keep = max(1, len(symbols) // 2) if i % 2 else 1
        while len(symbols) > keep:
            pair = (symbols[0], symbols[1])
            if pair not in merges:
                merges.append(pair)
            symbols = ["".join(pair)] + symbols[2:]
    return merges


def test_clip_tokenizer_matches_sd_tpu(tmp_path):
    from sd_tpu.data.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
    from sd_tpu_torch.data.tokenizer import CLIPTokenizer

    merges = _merges(UNICODE_TEXTS)
    gz = tmp_path / "bpe.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + [" ".join(m) for m in merges]))
    vocab = CLIPTokenizer(merges).encoder
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(["#version: 0.2"]
                                                   + [" ".join(m) for m in merges]))
    pairs = [(CLIPTokenizer.from_openai_gz(str(gz)), JaxCLIPTokenizer.from_openai_gz(str(gz)))]
    hf = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    pairs.append((CLIPTokenizer.from_hf_files(*hf), JaxCLIPTokenizer.from_hf_files(*hf)))
    for got, want in pairs:
        for text in UNICODE_TEXTS:
            assert got.encode(text) == want.encode(text), text
            assert got.decode(got.encode(text)) == want.decode(want.encode(text)), text
        np.testing.assert_array_equal(got(UNICODE_TEXTS, context_length=12),
                                      want(UNICODE_TEXTS, context_length=12))
    # the merges took: a fully merged word is one token, a half merged one more
    assert len(pairs[0][0].encode("café")) == 1 < len(pairs[0][0].encode("naïve")) < 6


# ------------------------------------------ int8 gates at other widths


def test_int8_gates_send_other_widths_to_the_plain_product(tmp_path, monkeypatch):
    """A YAML config can build widths K4 and K6 refuse (C % 32 != 0 or
    C > 1280): their site gates must say no there, so that the sites take
    the plain product. On the CPU the int8 mode runs where
    ``int8_device_ok`` is patched to say yes, and the wrappers are patched
    to refuse those widths as the card's launches do."""
    import yaml

    from sd_tpu_torch.ops import attention, quant

    # the package exports functions of the modules' names
    ff_mod = importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")
    dense_mod = importlib.import_module("sd_tpu_torch.ops.cuda.int8_dense")

    monkeypatch.setattr(quant, "int8_device_ok", lambda x: True)
    mode = quant.parse_int8("ff,proj")
    x = torch.zeros(1024, 64)
    assert ff_mod.int8_ff_supported(mode, x, 2560)
    for c in (48, 1312):
        assert not ff_mod.int8_ff_supported(mode, torch.zeros(1024, c), 2560)

    def refusing(real):
        def wrapper(x, *args, **kwargs):
            if not dense_mod.int8_width_ok(x.shape[-1]):
                raise ValueError(f"the card's kernel refuses C={x.shape[-1]}")
            wrapper.calls += 1
            return real(x, *args, **kwargs)
        wrapper.calls = 0
        return wrapper

    monkeypatch.setattr(attention, "int8_dense", refusing(attention.int8_dense))
    monkeypatch.setattr(attention, "geglu_ff_int8", refusing(attention.geglu_ff_int8))
    with torch.no_grad():
        for c, heads in ((64, 2), (1312, 4)):
            attn = attention.CrossAttention(c, heads=heads, dim_head=c // heads)
            ff = attention.FeedForward(c, mult=max(4, 2560 // c))  # inner >= 2560
            for site in (attn, ff):
                quant.set_int8_mode(site, mode)
                quant.prequantize_weights(site)
            before = attention.int8_dense.calls, attention.geglu_ff_int8.calls
            attn(torch.randn(2, 512, c))
            ff(torch.randn(2, 512, c))
            took = (attention.int8_dense.calls - before[0],
                    attention.geglu_ff_int8.calls - before[1])
            assert took == ((2, 1) if c == 64 else (0, 0)), (c, took)

    # a model from a YAML config whose second level is 1312 wide
    cfg = tiny_sd_model_config()
    cfg["params"]["unet_config"]["params"]["channel_mult"] = [1, 41]
    path = tmp_path / "wide.yaml"
    path.write_text(yaml.safe_dump({"model": cfg}))
    pipe, _ = build_txt2img_pipeline(config=str(path), device="cpu", safety=False,
                                     watermark=False, int8="ff,proj")
    pipe.tokenizer = lambda texts: HashTokenizer(64)(texts, context_length=8)
    images = pipe(["a red cube"], torch.Generator().manual_seed(0), height=32, width=32,
                  steps=2)
    assert images.shape == (1, 32, 32, 3)
    # its attention sites are all 1312 wide: none took K6
    assert pipe.ldm.int8_mode.buckets == {"ff", "proj"} and attention.int8_dense.calls == 2
