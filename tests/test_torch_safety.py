"""The port's safety checker against sd_tpu's on the CPU in fp32.

The preprocessing (antialiased bicubic resize to 224², CLIP's
normalisation) against ``jax.image.resize`` at 512 → 224 (downsampling)
and 64 → 224 (the tiny model's images): atol 1e-4 of outputs up to about
2.2. The port builds the resize weights in float64; JAX builds them in
float32, whose sample positions near 512 round by up to 3e-5. One HF-layout
``StableDiffusionSafetyChecker`` ``state_dict`` (the port's untrained tower,
2 layers of width 64, seeded) goes into both packages: the image embeddings
agree to rtol 1e-4 (atol 1e-4 of their scale), and the flags are equal at
thresholds that flag none, all, and some images (each threshold halfway
between two images' cosines, so no rounding can flip it). The placeholder
image is equal bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models.clip_vision import CLIPVisionConfig as JaxVisionConfig
from sd_tpu.models.clip_vision import clip_image_preprocess as jax_preprocess
from sd_tpu.models.clip_vision import port_clip_vision
from sd_tpu.pipelines import safety as jsafety
from sd_tpu_torch.models.clip_vision import clip_image_preprocess
from sd_tpu_torch.pipelines.safety import (
    UNTRAINED_CONFIG,
    SafetyChecker,
    placeholder_image,
    port_safety_checker,
)


def _images(seed, b, hw):
    return np.random.default_rng(seed).integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw", [512, 64])
def test_preprocess_matches_jax_image_resize(hw):
    x = np.random.default_rng(hw).uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    got = clip_image_preprocess(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _jax_checker(sd, thresholds):
    cfg = JaxVisionConfig(**vars(UNTRAINED_CONFIG))
    vision = port_clip_vision(sd, cfg, prefix="vision_model.vision_model.",
                              projection_key="visual_projection.weight")
    arr = lambda k: jnp.asarray(sd[k].numpy())
    return jsafety.SafetyChecker(
        vision_params=vision, concept_embeds=arr("concept_embeds"),
        concept_thresholds=jnp.asarray(thresholds[0]),
        special_care_embeds=arr("special_care_embeds"),
        special_care_thresholds=jnp.asarray(thresholds[1]), config=cfg)


def test_checker_matches_sd_tpu():
    sd = SafetyChecker.random_init(seed=3).state_dict()
    sd["vision_model.vision_model.embeddings.position_ids"] = torch.arange(50)[None]
    checker = port_safety_checker(sd, UNTRAINED_CONFIG)
    images = _images(0, 4, 64)

    got = checker.image_embeds(torch.from_numpy(images)).numpy()
    jc = _jax_checker(sd, (np.full(17, 2.0, np.float32), np.full(3, 2.0, np.float32)))
    x = jax_preprocess(jnp.asarray(images, jnp.float32) / 255.0 * 2.0 - 1.0)
    want = np.asarray(jc.model.apply({"params": jc.vision_params}, x)["image_embeds"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    def cos(embeds):
        e = got / np.linalg.norm(got, axis=-1, keepdims=True)
        c = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
        return e @ c.T

    concept, special = cos(sd["concept_embeds"].numpy()), cos(sd["special_care_embeds"].numpy())
    # some images: concept 0 fires for the images above the batch's median
    # cosine, special-care concept 1 for those above its own (the other
    # concepts and special concepts never)
    some_c, some_s = np.full(17, 2.0, np.float32), np.full(3, 2.0, np.float32)
    some_c[0] = np.sort(concept[:, 0])[1:3].mean()
    some_s[1] = np.sort(special[:, 1])[1:3].mean()
    cases = {"none": (np.full(17, 2.0), np.full(3, 2.0)),
             "all": (np.full(17, -2.0), np.full(3, -2.0)), "some": (some_c, some_s)}
    for name, (thr_c, thr_s) in cases.items():
        with torch.no_grad():
            checker.concept_embeds_weights.copy_(torch.from_numpy(np.float32(thr_c)))
            checker.special_care_embeds_weights.copy_(torch.from_numpy(np.float32(thr_s)))
        flags = checker.nsfw_scores(torch.from_numpy(images)).numpy()
        jc = _jax_checker(sd, (np.float32(thr_c), np.float32(thr_s)))
        want_flags = np.asarray(jc.nsfw_scores(jnp.asarray(images)))
        np.testing.assert_array_equal(flags, want_flags, err_msg=name)
        checked, flags = checker(images)
        want_checked, _ = jc(images)
        np.testing.assert_array_equal(checked, want_checked, err_msg=name)
        if name == "some":
            assert 0 < flags.sum() < len(flags)


def test_untrained_checker_flags_nothing():
    checker = SafetyChecker.untrained()
    assert checker.vision_model.config == UNTRAINED_CONFIG
    flags = checker.nsfw_scores(torch.from_numpy(_images(1, 3, 64)))
    assert flags.dtype == torch.bool and not flags.any()


@pytest.mark.parametrize("hw", [(64, 64), (512, 512), (40, 72)])
def test_placeholder_image_is_sd_tpu_s(hw):
    np.testing.assert_array_equal(placeholder_image(*hw), jsafety.placeholder_image(*hw))
