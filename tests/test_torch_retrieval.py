"""Retrieval-augmented diffusion (knn2img) in the port against sd_tpu on the
CPU.

- ``build_index``, ``Searcher`` and ``knn_conditioning`` against
  ``sd_tpu/pipelines/retrieval.py`` on one seeded database of npz parts:
  the index files, the neighbours' indices equal, the scores, neighbour and
  query embeddings within 1e-5 (fp32 products summed in other orders);
  token 0 of the context is the query as given, not normalized again.
- ``CLIPTextModelWithProjection`` (2 layers, width 32) against sd_tpu's
  from the same parameters: its normalized output within 1e-5, and HF's
  ``text_projection.weight`` name.
- The slice: the tiny crossattn LDM (context 24) with the same weights
  through knn conditioning and DDIM at guidance 5 from the same x_T,
  latents within 1e-4 of the scale of sd_tpu's (fp32 both).
- Both CLIs with ``--tiny --device cpu``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from sd_tpu.models.clip import CLIPTextModelWithProjection as JaxCLIPProj
from sd_tpu.pipelines import retrieval as jret
from sd_tpu.samplers import ddim as jddim
from sd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModelWithProjection
from sd_tpu_torch.pipelines.retrieval import Searcher, build_index, knn_conditioning
from sd_tpu_torch.samplers.ddim import ddim_sample
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.config import build_latent_diffusion, tiny_knn_model_config
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import jax_ldm, ldm_state_dict, nchw, random_params, to_nhwc, torch_threads

D = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def database(tmp_path_factory):
    """Three npz parts of a seeded 300 x 24 database (one under another key
    than ``embedding``), and both packages' indexes of them."""
    root = tmp_path_factory.mktemp("db")
    rng = np.random.default_rng(0)
    parts = []
    for i in range(3):
        path = str(root / f"part{i}.npz")
        key = "clip" if i == 1 else "embedding"
        np.savez(path, **{key: rng.standard_normal((100, D)).astype(np.float32)})
        parts.append(path)
    return {"parts": parts, "port": build_index(parts, str(root / "port" / "index.npz")),
            "ref": jret.build_index(parts, str(root / "ref" / "index.npz"))}


def test_build_index_matches(database):
    got = np.load(database["port"])["embedding"]
    want = np.load(database["ref"])["embedding"]
    assert got.shape == (300, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_searcher_matches(database):
    queries = np.random.default_rng(1).standard_normal((4, D)).astype(np.float32)
    got = Searcher(database["port"], device="cpu")(queries, k=5)
    want = jret.Searcher(database["ref"])(queries, k=5)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["nn_indices"], want["nn_indices"])
    for key in ("scores", "nn_embeddings", "q_embeddings"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
    # a directory of parts, normalized once at load
    by_dir = Searcher(os.path.dirname(database["port"]), device="cpu")(queries, k=5)
    np.testing.assert_array_equal(by_dir["nn_indices"], want["nn_indices"])


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_searcher_leaves_the_callers_array(kind):
    """The database is normalized in place only where the Searcher owns it:
    an array or tensor the caller passed keeps its values."""
    db = np.random.default_rng(4).standard_normal((50, D)).astype(np.float32)
    given = db.copy() if kind == "numpy" else torch.from_numpy(db.copy())
    searcher = Searcher(given, device="cpu")
    np.testing.assert_array_equal(np.asarray(given), db)
    want = db / (np.linalg.norm(db, axis=-1, keepdims=True) + 1e-8)
    np.testing.assert_allclose(searcher.embeddings.numpy(), want, rtol=0, atol=1e-6)


def test_knn_conditioning_matches(database):
    q = 3.0 * np.random.default_rng(2).standard_normal((2, 1, D)).astype(np.float32)
    cond, uncond = knn_conditioning(q, Searcher(database["port"], device="cpu"), k=4)
    jcond, juncond = jret.knn_conditioning(q, jret.Searcher(database["ref"]), k=4)
    assert cond.shape == (2, 5, D) and not uncond.any()
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cond[:, 0].numpy(), q[:, 0])  # as given
    assert np.asarray(juncond).shape == tuple(uncond.shape)


def test_clip_text_projection():
    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=8, projection_dim=16,
               eos_token_id=63)
    jmodel = JaxCLIPProj(JaxCLIPConfig(**cfg))
    ids = np.array([[62, 5, 9, 63, 63, 63, 63, 63], [62, 1, 2, 3, 4, 63, 63, 63]], np.int32)
    params = random_params(jmodel, np.random.default_rng(3), jnp.asarray(ids))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    sd = convert.clip_text_projection_state_dict(params, CLIPTextConfig(**cfg))
    assert sd["text_projection.weight"].shape == (16, 32)
    model = load_numpy_state_dict(CLIPTextModelWithProjection(CLIPTextConfig(**cfg)), sd)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_knn2img_slice(database):
    """Query → neighbours → context → DDIM 4 at guidance 5, both packages
    from the same weights and x_T."""
    cfg = tiny_knn_model_config()
    jldm = jax_ldm(cfg, np.random.default_rng(4))
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                ldm_state_dict(cfg, jldm))
    q = np.random.default_rng(5).standard_normal((2, D)).astype(np.float32)
    cond, uncond = knn_conditioning(q, Searcher(database["port"], device="cpu"), k=3)
    jcond, juncond = jret.knn_conditioning(q, jret.Searcher(database["ref"]), k=3)
    shape = (2, 16, 16, 4)
    x_T = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    steps = 4

    def run(p, c, u, x):
        m = jldm.bind_params(p)
        return jddim.ddim_sample(m.apply_model, m.schedule, shape, c, jax.random.PRNGKey(0),
                                 num_steps=steps, uncond=u, guidance_scale=5.0, x_T=x)[0]

    want = np.asarray(jax.jit(run)(jldm.runtime_params(), jcond, juncond, jnp.asarray(x_T)))
    with torch.no_grad():
        got = ddim_sample(ldm.apply_model, ldm.schedule, nchw(x_T), cond, num_steps=steps,
                          uncond=uncond, guidance_scale=5.0)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_clis_tiny_on_cpu(database, tmp_path, monkeypatch):
    from sd_tpu_torch.scripts import knn2img, train_searcher

    index = train_searcher.main(["-d", os.path.dirname(database["parts"][0]),
                                 "-t", str(tmp_path / "index.npz")])
    np.testing.assert_allclose(np.load(index)["embedding"],
                               np.load(database["ref"])["embedding"], rtol=0, atol=1e-6)
    out = knn2img.main(["--tiny", "--device", "cpu", "--database", index, "--use_neighbors",
                        "--knn", "3", "--ddim_steps", "3", "--n_samples", "2", "--outdir",
                        str(tmp_path / "out")])
    assert out["cond"].shape == (2, 4, D)
    assert [os.path.basename(p) for p in out["paths"]] == ["00000.png", "00001.png"]
    assert all(os.path.getsize(p) > 0 for p in out["paths"])
    assert torch.isfinite(out["latents"]).all()
    plain = knn2img.main(["--tiny", "--device", "cpu", "--ddim_steps", "2", "--plms",
                          "--outdir", str(tmp_path / "plain")])
    assert plain["cond"].shape == (1, 1, D)
    monkeypatch.delenv("SD_TPU_BPE_VOCAB", raising=False)
    with pytest.raises(SystemExit, match="BPE vocab"):
        knn2img.main(["--device", "cpu", "--ckpt", str(tmp_path / "missing.ckpt")])
