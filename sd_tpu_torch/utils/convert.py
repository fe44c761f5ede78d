"""``sd_tpu`` parameter trees → the port's ``state_dict``.

The exact inverse of ``sd_tpu``'s torch porters (``port_unet`` with its
legacy attention, class embedding and codebook head,
``port_encoder``/``port_decoder``/``port_autoencoder_kl``/``port_vq_model``,
``port_clip_text``,
``port_transformer_wrapper``/``port_bert_embedder``, ``port_lpips``), and
the same for what ``sd_tpu`` builds but does not port (``ClassEmbedder``,
the discriminator with its BatchNorm statistics, the VAE's linear
attention, the classifier's ``EncoderUNetModel`` and its
``AttentionPool2d``, CLIP's ``text_projection``, the first-stage extras of
``models/vae_extras.py``; ``TimestepVAEModel`` in the layout
``port_timestep_model`` reads): flax
``{kernel, bias}``/``{scale, bias}`` leaves become ``weight``/``bias`` under
the CompVis and HF names, conv kernels go HWIO → OIHW, Dense kernels
``[in, out]`` → Linear ``[out, in]``, and Dense layers that stand for 1x1
convs → ``[out, in, 1, 1]``. Inputs are nested dicts of arrays (numpy, or
anything ``np.asarray`` takes); outputs are flat dicts of numpy arrays, ready
for ``load_state_dict`` after ``torch.from_numpy``. This is how the tests put
the same weights into both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from sd_tpu_torch.models.clip import CLIPTextConfig
from sd_tpu_torch.models.unet import UNetConfig, build_unet_plan

__all__ = ["unet_state_dict", "vae_state_dict", "vq_state_dict", "vae_encoder_state_dict",
           "vae_decoder_state_dict", "clip_text_state_dict", "clip_text_projection_state_dict",
           "class_embedder_state_dict",
           "transformer_embedder_state_dict", "spatial_rescaler_state_dict", "lpips_state_dict",
           "discriminator_state_dict", "encoder_unet_state_dict",
           "attention_pool_state_dict", "vae_resnet_block_state_dict",
           "latent_rescaler_state_dict", "simple_decoder_state_dict",
           "upsample_decoder_state_dict", "merged_rescale_encoder_state_dict",
           "merged_rescale_decoder_state_dict", "first_stage_post_processor_state_dict",
           "timestep_model_state_dict"]

StateDict = Dict[str, np.ndarray]


def _put(sd: StateDict, prefix: str, leaves: Mapping[str, Any]) -> None:
    for name, value in leaves.items():
        # an empty top-level prefix leaves a leading dot on nested names
        sd[f"{prefix}.{name}".lstrip(".")] = np.asarray(value)


def _linear(p) -> Dict[str, Any]:
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _conv(p) -> Dict[str, Any]:
    out = {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _conv1x1(p) -> Dict[str, Any]:
    out = {"weight": np.asarray(p["kernel"]).T[:, :, None, None]}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _conv1d(p) -> Dict[str, Any]:
    """A Dense standing for a width-1 ``Conv1d`` → ``[out, in, 1]``."""
    out = {"weight": np.asarray(p["kernel"]).T[:, :, None]}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _norm(p) -> Dict[str, Any]:
    return {"weight": p["scale"], "bias": p["bias"]}


# ---------------------------------------------------------------- UNet


def _res(sd: StateDict, p, prefix: str) -> None:
    _put(sd, f"{prefix}.in_layers.0", _norm(p["in_norm"]["GroupNorm_0"]))
    _put(sd, f"{prefix}.in_layers.2", _conv(p["in_conv"]))
    _put(sd, f"{prefix}.emb_layers.1", _linear(p["emb_proj"]))
    _put(sd, f"{prefix}.out_layers.0", _norm(p["out_norm"]["GroupNorm_0"]))
    _put(sd, f"{prefix}.out_layers.3", _conv(p["out_conv"]))
    if "skip" in p:
        _put(sd, f"{prefix}.skip_connection", _conv(p["skip"]))


def _transformer_block(sd: StateDict, p, prefix: str) -> None:
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            _put(sd, f"{prefix}.{attn}.{proj}", _linear(p[attn][proj]))
        _put(sd, f"{prefix}.{attn}.to_out.0", _linear(p[attn]["to_out"]))
    _put(sd, f"{prefix}.ff.net.0.proj", _linear(p["ff"]["proj_in"]["proj"]))
    _put(sd, f"{prefix}.ff.net.2", _linear(p["ff"]["proj_out"]))
    for norm in ("norm1", "norm2", "norm3"):
        _put(sd, f"{prefix}.{norm}", _norm(p[norm]["LayerNorm_0"]))


def _unet_layer(sd: StateDict, desc: Dict, p, prefix: str) -> None:
    kind = desc["kind"]
    if kind == "conv_in":
        _put(sd, prefix, _conv(p))
    elif kind == "res":
        _res(sd, p, prefix)
    elif kind == "spatial_transformer":
        _put(sd, f"{prefix}.norm", _norm(p["norm"]["GroupNorm_0"]))
        _put(sd, f"{prefix}.proj_in", _conv1x1(p["proj_in"]))
        _put(sd, f"{prefix}.proj_out", _conv1x1(p["proj_out"]))
        for d in range(desc["depth"]):
            _transformer_block(sd, p[f"blocks_{d}"], f"{prefix}.transformer_blocks.{d}")
    elif kind == "attention":
        _put(sd, f"{prefix}.norm", _norm(p["norm"]["GroupNorm_0"]))
        _put(sd, f"{prefix}.qkv", _conv1d(p["qkv"]))
        _put(sd, f"{prefix}.proj_out", _conv1d(p["proj_out"]))
    elif kind in ("downsample", "upsample"):
        if p is not None:  # None: resampling without a conv
            _put(sd, f"{prefix}.{'op' if kind == 'downsample' else 'conv'}", _conv(p["conv"]))
    else:
        raise ValueError(kind)


def unet_state_dict(params: Mapping, cfg: UNetConfig) -> StateDict:
    """``sd_tpu`` UNetModel params → the port's ``UNetModel`` state_dict."""
    plan = build_unet_plan(cfg)
    sd: StateDict = {}
    _put(sd, "time_embed.0", _linear(params["time_embed_0"]))
    _put(sd, "time_embed.2", _linear(params["time_embed_2"]))
    if "label_emb" in params:
        sd["label_emb.weight"] = np.asarray(params["label_emb"]["embedding"])
    for i, block in enumerate(plan["input_blocks"]):
        for j, desc in enumerate(block):
            _unet_layer(sd, desc, params.get(f"input_blocks_{i}_{j}"), f"input_blocks.{i}.{j}")
    for j, desc in enumerate(plan["middle_block"]):
        _unet_layer(sd, desc, params[f"middle_block_{j}"], f"middle_block.{j}")
    for i, block in enumerate(plan["output_blocks"]):
        for j, desc in enumerate(block):
            _unet_layer(sd, desc, params.get(f"output_blocks_{i}_{j}"),
                        f"output_blocks.{i}.{j}")
    if cfg.n_embed is not None:
        # sd_tpu builds only the codebook head; the port's `out`, which the
        # reference keeps unused beside it, is not in these params
        _put(sd, "id_predictor.0", _norm(params["id_norm"]["GroupNorm_0"]))
        _put(sd, "id_predictor.1", _conv1x1(params["id_predictor"]))
    else:
        _put(sd, "out.0", _norm(params["out_norm"]["GroupNorm_0"]))
        _put(sd, "out.2", _conv(params["out_conv"]))
    return sd


def _encoder_unet_layer(sd: StateDict, p, prefix: str) -> None:
    """A layer of ``sd_tpu``'s ``EncoderUNetModel``, told apart by its
    parameters: a ResBlock, a legacy attention block, a downsample's conv,
    or the input conv."""
    if "in_norm" in p:
        _res(sd, p, prefix)
    elif "qkv" in p:
        _unet_layer(sd, {"kind": "attention"}, p, prefix)
    elif "conv" in p:
        _put(sd, f"{prefix}.op", _conv(p["conv"]))
    else:
        _put(sd, prefix, _conv(p))


def attention_pool_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` AttentionPool2d params → the port's: the positional
    embedding transposed to ``[C, N + 1]``, the projections as width-1
    ``Conv1d``s."""
    sd: StateDict = {"positional_embedding": np.asarray(params["positional_embedding"]).T}
    _put(sd, "qkv_proj", _conv1d(params["qkv_proj"]))
    _put(sd, "c_proj", _conv1d(params["c_proj"]))
    return sd


def encoder_unet_state_dict(params: Mapping, pool: str) -> StateDict:
    """``sd_tpu`` EncoderUNetModel params → the port's ``EncoderUNetModel``
    state_dict (the reference's names), the head of ``pool`` included."""
    sd: StateDict = {}
    _put(sd, "time_embed.0", _linear(params["time_embed_0"]))
    _put(sd, "time_embed.2", _linear(params["time_embed_2"]))
    for name, p in params.items():
        for part in ("input_blocks", "middle_block"):
            if name.startswith(part + "_"):
                _encoder_unet_layer(sd, p, f"{part}.{name[len(part) + 1:].replace('_', '.')}")
    if pool == "adaptive":
        _put(sd, "out.0", _norm(params["out_norm"]["GroupNorm_0"]))
        _put(sd, "out.3", _conv(params["out_conv"]))
    elif pool == "attention":
        _put(sd, "out.0", _norm(params["out_norm"]["GroupNorm_0"]))
        _put(sd, "out.2", attention_pool_state_dict(params["out_pool"]))
    else:
        _put(sd, "out.0", _linear(params["out_fc1"]))
        if pool == "spatial_v2":
            _put(sd, "out.1", _norm(params["out_norm"]["GroupNorm_0"]))
        _put(sd, f"out.{3 if pool == 'spatial_v2' else 2}", _linear(params["out_fc2"]))
    return sd


# ----------------------------------------------------------------- VAE


def _vae_res(sd: StateDict, p, prefix: str) -> None:
    """A VAEResnetBlock, with its ``temb_proj`` and its 1x1 or 3x3 shortcut
    where it has them."""
    _put(sd, f"{prefix}.norm1", _norm(p["norm1"]["GroupNorm_0"]))
    _put(sd, f"{prefix}.conv1", _conv(p["conv1"]))
    _put(sd, f"{prefix}.norm2", _norm(p["norm2"]["GroupNorm_0"]))
    _put(sd, f"{prefix}.conv2", _conv(p["conv2"]))
    if "temb_proj" in p:
        _put(sd, f"{prefix}.temb_proj", _linear(p["temb_proj"]))
    for skip in ("nin_shortcut", "conv_shortcut"):
        if skip in p:
            _put(sd, f"{prefix}.{skip}", _conv(p[skip]))


def vae_resnet_block_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` VAEResnetBlock params → the port's ``VAEResnetBlock``."""
    sd: StateDict = {}
    _vae_res(sd, params, "")
    return sd


def _vae_attn(sd: StateDict, p, prefix: str) -> None:
    """The vanilla block, or the linear one (``to_qkv``, ``to_out``); None
    (``attn_type: none``) has no weights."""
    if p is None:
        return
    if "to_qkv" in p:
        _put(sd, f"{prefix}.to_qkv", _conv1x1(p["to_qkv"]))
        _put(sd, f"{prefix}.to_out", _conv1x1(p["to_out"]))
        return
    _put(sd, f"{prefix}.norm", _norm(p["norm"]["GroupNorm_0"]))
    for name in ("q", "k", "v", "proj_out"):
        _put(sd, f"{prefix}.{name}", _conv1x1(p[name]))


def _resample_conv(sd: StateDict, p, prefix: str) -> None:
    if p is not None:  # None: resampling without a conv
        _put(sd, prefix, _conv(p["conv"]))


def _ends_and_mid(sd: StateDict, p, prefix: str) -> None:
    """``conv_in``, ``conv_out``, ``norm_out`` and the ``mid`` blocks, shared
    by the Encoder, the Decoder and TimestepVAEModel."""
    _put(sd, f"{prefix}.conv_in", _conv(p["conv_in"]))
    _put(sd, f"{prefix}.conv_out", _conv(p["conv_out"]))
    _put(sd, f"{prefix}.norm_out", _norm(p["norm_out"]["GroupNorm_0"]))
    _vae_res(sd, p["mid_block_1"], f"{prefix}.mid.block_1")
    _vae_attn(sd, p.get("mid_attn_1"), f"{prefix}.mid.attn_1")
    _vae_res(sd, p["mid_block_2"], f"{prefix}.mid.block_2")


def _down_levels(sd: StateDict, p, ddconfig: Mapping, prefix: str) -> None:
    """``down.{i}.block.{j}``/``.attn.{j}``/``.downsample.conv``."""
    num_res = len(ddconfig["ch_mult"])
    for i in range(num_res):
        for j in range(ddconfig["num_res_blocks"]):
            _vae_res(sd, p[f"down_{i}_block_{j}"], f"{prefix}.down.{i}.block.{j}")
            if f"down_{i}_attn_{j}" in p:
                _vae_attn(sd, p[f"down_{i}_attn_{j}"], f"{prefix}.down.{i}.attn.{j}")
        if i != num_res - 1:
            _resample_conv(sd, p.get(f"down_{i}_downsample"),
                           f"{prefix}.down.{i}.downsample.conv")


def _up_levels(sd: StateDict, p, ddconfig: Mapping, prefix: str) -> None:
    """``up.{i}.block.{j}``/``.attn.{j}``/``.upsample.conv``
    (``num_res_blocks + 1`` blocks a level)."""
    for i in range(len(ddconfig["ch_mult"])):
        for j in range(ddconfig["num_res_blocks"] + 1):
            _vae_res(sd, p[f"up_{i}_block_{j}"], f"{prefix}.up.{i}.block.{j}")
            if f"up_{i}_attn_{j}" in p:
                _vae_attn(sd, p[f"up_{i}_attn_{j}"], f"{prefix}.up.{i}.attn.{j}")
        if i != 0:
            _resample_conv(sd, p.get(f"up_{i}_upsample"), f"{prefix}.up.{i}.upsample.conv")


def _decoder(sd: StateDict, dec, ddconfig: Mapping, prefix: str) -> None:
    """A Decoder's params (``sd_tpu``'s names) under ``prefix``."""
    _ends_and_mid(sd, dec, prefix)
    _up_levels(sd, dec, ddconfig, prefix)


def _encoder(sd: StateDict, enc, ddconfig: Mapping, prefix: str) -> None:
    """An Encoder's params (``sd_tpu``'s names) under ``prefix``."""
    _ends_and_mid(sd, enc, prefix)
    _down_levels(sd, enc, ddconfig, prefix)


def vae_decoder_state_dict(params: Mapping, ddconfig: Mapping) -> StateDict:
    """``sd_tpu`` AutoencoderKL params → the port's ``AutoencoderKL`` (decode
    half) state_dict: ``decoder.*`` and ``post_quant_conv.*``."""
    sd: StateDict = {}
    _decoder(sd, params["decoder"], ddconfig, "decoder")
    _put(sd, "post_quant_conv", _conv1x1(params["post_quant_conv"]))
    return sd


def vae_encoder_state_dict(params: Mapping, ddconfig: Mapping) -> StateDict:
    """``sd_tpu`` AutoencoderKL params → the port's ``AutoencoderKL`` encode
    half: ``encoder.*`` and ``quant_conv.*``."""
    sd: StateDict = {}
    _encoder(sd, params["encoder"], ddconfig, "encoder")
    _put(sd, "quant_conv", _conv1x1(params["quant_conv"]))
    return sd


def vae_state_dict(params: Mapping, ddconfig: Mapping) -> StateDict:
    """``sd_tpu`` AutoencoderKL params → the port's whole ``AutoencoderKL``
    state_dict."""
    return {**vae_encoder_state_dict(params, ddconfig),
            **vae_decoder_state_dict(params, ddconfig)}


def vq_state_dict(params: Mapping, ddconfig: Mapping) -> StateDict:
    """``sd_tpu`` VQModel params → the port's ``VQModel`` state_dict: the
    autoencoder's and ``quantize.embedding.weight``."""
    return {**vae_state_dict(params, ddconfig),
            "quantize.embedding.weight": np.asarray(params["quantize"]["embedding"])}


# ---------------------------------------------------------------- CLIP


def clip_text_state_dict(params: Mapping, cfg: CLIPTextConfig) -> StateDict:
    """``sd_tpu`` CLIPTextModel params → the port's ``CLIPTextModel``
    state_dict (``text_model.*``, the HF names)."""
    sd: StateDict = {
        "text_model.embeddings.token_embedding.weight":
            np.asarray(params["token_embedding"]["embedding"]),
        "text_model.embeddings.position_embedding.weight":
            np.asarray(params["position_embedding"]),
    }
    _put(sd, "text_model.final_layer_norm", _norm(params["final_layer_norm"]))
    for i in range(cfg.num_hidden_layers):
        p, prefix = params[f"layers_{i}"], f"text_model.encoder.layers.{i}"
        _put(sd, f"{prefix}.layer_norm1", _norm(p["layer_norm1"]))
        _put(sd, f"{prefix}.layer_norm2", _norm(p["layer_norm2"]))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put(sd, f"{prefix}.self_attn.{proj}", _linear(p["self_attn"][proj]))
        _put(sd, f"{prefix}.mlp.fc1", _linear(p["mlp"]["fc1"]))
        _put(sd, f"{prefix}.mlp.fc2", _linear(p["mlp"]["fc2"]))
    return sd


def clip_text_projection_state_dict(params: Mapping, cfg: CLIPTextConfig) -> StateDict:
    """``sd_tpu`` CLIPTextModelWithProjection params → the port's (HF's
    names: ``text_model.*`` and the bias-free ``text_projection.weight``,
    ``[projection_dim, hidden]``)."""
    return {**clip_text_state_dict(params["text_model"], cfg),
            "text_projection.weight": np.asarray(params["text_projection"]).T}


# ------------------------------------------------------ trainable cond stages


def class_embedder_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` ClassEmbedder params → the port's ``ClassEmbedder``."""
    return {"embedding.weight": np.asarray(params["embedding"]["embedding"])}


def spatial_rescaler_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` SpatialRescaler params → the port's: its Dense
    ``channel_mapper`` as the 1x1 conv (nothing without one)."""
    sd: StateDict = {}
    if "channel_mapper" in params:
        _put(sd, "channel_mapper", _conv1x1(params["channel_mapper"]))
    return sd


def transformer_embedder_state_dict(params: Mapping, n_layer: int) -> StateDict:
    """``sd_tpu`` TransformerEmbedder params, or a BERTEmbedder's (which hold
    them under ``transformer``) → the port's ``TransformerEmbedder`` /
    ``BERTEmbedder`` (``transformer.*``, x-transformers' names)."""
    p = params.get("transformer", params)
    sd: StateDict = {
        "transformer.token_emb.weight": np.asarray(p["token_emb"]["embedding"]),
        "transformer.pos_emb.emb.weight": np.asarray(p["pos_emb"]),
    }
    _put(sd, "transformer.norm", _norm(p["norm"]["LayerNorm_0"]))
    for i in range(n_layer):
        layer = p[f"layers_{i}"]
        attn = f"transformer.attn_layers.layers.{2 * i}"
        ff = f"transformer.attn_layers.layers.{2 * i + 1}"
        _put(sd, f"{attn}.0", _norm(layer["norm1"]["LayerNorm_0"]))
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            _put(sd, f"{attn}.1.{proj}", _linear(layer[proj]))
        _put(sd, f"{ff}.0", _norm(layer["norm2"]["LayerNorm_0"]))
        _put(sd, f"{ff}.1.net.0.0", _linear(layer["ff_in"]))
        _put(sd, f"{ff}.1.net.2", _linear(layer["ff_out"]))
    return sd


# ------------------------------------------------------ first-stage losses


def lpips_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` LPIPS params → the port's ``LPIPS`` (``vgg.features.{i}``
    at torchvision's indices, ``lin{i}.model.1``)."""
    sd: StateDict = {}
    layer = 0
    for conv in range(13):
        _put(sd, f"vgg.features.{layer}", _conv(params["vgg"][f"conv_{conv}"]))
        # a conv and its ReLU, and a max pool after convs 1, 3, 6 and 9
        layer += 3 if conv in (1, 3, 6, 9) else 2
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = np.asarray(params[f"lin_{i}"]["kernel"]).T[:, :, None, None]
    return sd


def discriminator_state_dict(params: Mapping, batch_stats: Mapping, n_layers: int = 3
                             ) -> StateDict:
    """``sd_tpu`` NLayerDiscriminator params and BatchNorm statistics → the
    port's ``NLayerDiscriminator`` (taming's ``main.{i}``)."""
    sd: StateDict = {}
    _put(sd, "main.0", _conv(params["conv_0"]))
    for n in range(1, n_layers + 1):
        _put(sd, f"main.{3 * n - 1}", _conv(params[f"conv_{n}"]))
        bn = f"main.{3 * n}"
        _put(sd, bn, _norm(params[f"bn_{n}"]))
        sd[f"{bn}.running_mean"] = np.asarray(batch_stats[f"bn_{n}"]["mean"])
        sd[f"{bn}.running_var"] = np.asarray(batch_stats[f"bn_{n}"]["var"])
        sd[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
    _put(sd, f"main.{3 * n_layers + 2}", _conv(params["head"]))
    return sd


# ------------------------------------------------------ first-stage extras


def _latent_rescaler(sd: StateDict, p, prefix: str) -> None:
    _put(sd, f"{prefix}.conv_in", _conv(p["conv_in"]))
    for name, part in (("res1", "res_block1"), ("res2", "res_block2")):
        i = 0
        while f"{name}_{i}" in p:
            _vae_res(sd, p[f"{name}_{i}"], f"{prefix}.{part}.{i}")
            i += 1
    _vae_attn(sd, p["attn"], f"{prefix}.attn")
    _put(sd, f"{prefix}.conv_out", _conv1x1(p["conv_out"]))


def latent_rescaler_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` LatentRescaler params → the port's (``res_block1.{i}``,
    ``attn``, ``res_block2.{i}``, the 1x1 ``conv_out``)."""
    sd: StateDict = {}
    _latent_rescaler(sd, params, "")
    return sd


def simple_decoder_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` SimpleDecoder params → the port's ``model.0`` to ``model.5``,
    ``norm_out``, ``conv_out``."""
    sd: StateDict = {}
    _put(sd, "model.0", _conv1x1(params["conv_in"]))
    for i in (1, 2, 3):
        _vae_res(sd, params[f"block_{i}"], f"model.{i}")
    _put(sd, "model.4", _conv1x1(params["conv_mid"]))
    _put(sd, "model.5.conv", _conv(params["upsample"]["conv"]))
    _put(sd, "norm_out", _norm(params["norm_out"]["GroupNorm_0"]))
    _put(sd, "conv_out", _conv(params["conv_out"]))
    return sd


def upsample_decoder_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` UpsampleDecoder params → the port's ``res_blocks.{i}.{j}``,
    ``upsample_blocks.{i}.conv``, ``norm_out``, ``conv_out``."""
    sd: StateDict = {}
    for name, p in params.items():
        if name.startswith("res_"):
            i, j = name.split("_")[1:]
            _vae_res(sd, p, f"res_blocks.{i}.{j}")
        elif name.startswith("upsample_"):
            _put(sd, f"upsample_blocks.{name.split('_')[1]}.conv", _conv(p["conv"]))
    _put(sd, "norm_out", _norm(params["norm_out"]["GroupNorm_0"]))
    _put(sd, "conv_out", _conv(params["conv_out"]))
    return sd


def merged_rescale_encoder_state_dict(params: Mapping, num_res_blocks: int,
                                      ch_mult) -> StateDict:
    """``sd_tpu`` MergedRescaleEncoder params → the port's ``encoder.*`` and
    ``rescaler.*``."""
    sd: StateDict = {}
    _encoder(sd, params["encoder"], {"ch_mult": ch_mult, "num_res_blocks": num_res_blocks},
             "encoder")
    _latent_rescaler(sd, params["rescaler"], "rescaler")
    return sd


def merged_rescale_decoder_state_dict(params: Mapping, num_res_blocks: int,
                                      ch_mult) -> StateDict:
    """``sd_tpu`` MergedRescaleDecoder (or Upsampler) params → the port's
    ``rescaler.*`` and ``decoder.*``."""
    sd: StateDict = {}
    _latent_rescaler(sd, params["rescaler"], "rescaler")
    _decoder(sd, params["decoder"], {"ch_mult": ch_mult, "num_res_blocks": num_res_blocks},
             "decoder")
    return sd


def first_stage_post_processor_state_dict(params: Mapping) -> StateDict:
    """``sd_tpu`` FirstStagePostProcessor params → the port's ``proj_norm``,
    ``proj`` and ``model.{i}``."""
    sd: StateDict = {}
    _put(sd, "proj_norm", _norm(params["proj_norm"]["GroupNorm_0"]))
    _put(sd, "proj", _conv(params["proj"]))
    i = 0
    while f"block_{i}" in params:
        _vae_res(sd, params[f"block_{i}"], f"model.{i}")
        i += 1
    return sd


def timestep_model_state_dict(params: Mapping, cfg: Mapping) -> StateDict:
    """``sd_tpu`` TimestepVAEModel params → the port's (the reference
    ``Model``'s names, the layout ``port_timestep_model`` reads):
    ``temb.dense.{0,1}``, ``down.{i}.block.{j}``/``.attn.{j}``/
    ``.downsample.conv``, ``mid.*``, ``up.{i}.block.{j}``/``.attn.{j}``/
    ``.upsample.conv``, ``conv_in``, ``norm_out``, ``conv_out``. ``cfg``:
    ``ch_mult`` and ``num_res_blocks``."""
    sd: StateDict = {}
    _ends_and_mid(sd, params, "")
    for i in (0, 1):
        _put(sd, f"temb.dense.{i}", _linear(params[f"temb_dense_{i}"]))
    _down_levels(sd, params, cfg, "")
    _up_levels(sd, params, cfg, "")
    return sd
