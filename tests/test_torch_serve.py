"""The port's serving daemon on the CPU: its bucket grammar against
sd_tpu's ``scripts/serve.py`` (loaded by path), an in-process tiny
``Server`` (DDIM 2 steps with the default untrained safety checker and
watermark, max batch 2, two buckets) and one ``--stdio`` subprocess.

The server draws each request's x_T from a CPU generator seeded with the
request's seed, so a (prompt, seed) pair gives the same PNG served alone
(padded with seed 0's draw) and as the second of a coalesced pair: the
test asks for equality bit for bit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from sd_tpu_torch.scripts import serve

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUCKET_SPECS = [[], ["256x256@20"], ["@20"], ["384x256"], ["320"], ["512x512@50"],
                ["256x256@20", "256x256@20", "@30", "640x384@10"]]


def _jax_serve():
    spec = importlib.util.spec_from_file_location(
        "reference_serve", os.path.join(_REPO, "scripts", "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("specs", BUCKET_SPECS)
def test_parse_buckets_matches_sd_tpu(specs):
    opt = argparse.Namespace(H=512, W=512, steps=50, bucket=specs or None)
    assert serve.parse_buckets(opt) == _jax_serve().parse_buckets(opt)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("serve")
    (outdir / "000041.png").write_bytes(b"an earlier run's image")
    (outdir / "notes.txt").write_text("not an image")
    opt = serve.parse_args(["--tiny", "--device", "cpu", "--sampler", "ddim", "--steps", "2",
                            "--max-batch", "2", "--bucket", "32x32", "--batch-window", "0",
                            "--outdir", str(outdir)])
    server = serve.Server(opt)
    yield server
    server.close()
    assert not server._worker.is_alive()
    assert server.handle({"prompt": "late"}) == {
        "ok": False, "error": "the server's worker thread has stopped"}


def _png(path):
    return np.asarray(Image.open(path))


def test_server_buckets_numbering_and_refusals(server):
    assert server.opt.buckets == [(64, 64, 2), (32, 32, 2)]  # clamped to the tiny model
    assert server.exec_count == 0  # reset after the warm-up
    resp = server.handle({"prompt": "a red cube", "seed": 1})
    assert resp["ok"] and resp["bucket"] == {"H": 64, "W": 64, "steps": 2}
    # after 000041 and the warm-up's 2 x 2 images
    assert [os.path.basename(p) for p in resp["paths"]] == ["000046.png"]
    assert _png(resp["paths"][0]).shape == (64, 64, 3)
    assert resp["safety_flagged"] == [False] and resp["batched_requests"] == 1
    small = server.handle({"prompt": "a red cube", "seed": 1, "height": 32, "width": 32})
    assert small["ok"] and _png(small["paths"][0]).shape == (32, 32, 3)
    assert small["exec_id"] == resp["exec_id"] + 1
    clamped = server.handle({"prompt": "a blue ball", "n": 5})
    assert clamped["ok"] and clamped["n_clamped"] == 2 and len(clamped["paths"]) == 2
    cold = server.handle({"prompt": "x", "steps": 7})
    assert not cold["ok"] and "no warm bucket 64x64@7" in cold["error"]
    unknown = server.handle({"prompt": "x", "guidance_scale": 3.0})
    assert not unknown["ok"] and "['guidance_scale']" in unknown["error"]
    assert unknown["config"]["buckets"] == ["64x64@2", "32x32@2"]


def test_server_coalesces_and_keeps_each_seed(server):
    alone = server.handle({"prompt": "a red cube", "seed": 7})
    server.opt.batch_window = 5000.0  # the pair fills the batch well before this
    try:
        out = [None, None]
        first = threading.Thread(target=lambda: out.__setitem__(
            0, server.handle({"prompt": "a blue ball", "seed": 3})))
        first.start()
        time.sleep(0.5)  # the worker holds the first request, waiting for more
        out[1] = server.handle({"prompt": "a red cube", "seed": 7})
        first.join()
    finally:
        server.opt.batch_window = 0.0
    assert all(r["ok"] for r in out)
    assert out[0]["exec_id"] == out[1]["exec_id"] == alone["exec_id"] + 1
    assert out[0]["batched_requests"] == out[1]["batched_requests"] == 2
    np.testing.assert_array_equal(_png(out[1]["paths"][0]), _png(alone["paths"][0]))
    assert not np.array_equal(_png(out[0]["paths"][0]), _png(alone["paths"][0]))


def test_a_failing_batch_answers_not_ok_and_the_server_goes_on(server):
    def broken(*args, **kwargs):
        raise RuntimeError("planted fault")

    server.pipe.sample_latents = broken
    try:
        failed = server.handle({"prompt": "a red cube"})
    finally:
        del server.pipe.sample_latents
    assert failed == {"ok": False, "error": "RuntimeError: planted fault"}
    assert server.handle({"prompt": "a red cube"})["ok"]


@pytest.mark.parametrize("max_batch", [1, 2])
def test_cudnn_is_off_only_where_requests_can_share_an_execution(server, max_batch):
    import torch

    seen = []
    sample = server.pipe.sample_latents

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.enabled)
        return sample(*args, **kwargs)

    saved = server.opt.max_batch
    server.opt.max_batch = max_batch
    server.pipe.sample_latents = recording
    try:
        resp = server.handle({"prompt": "a red cube", "seed": 4})
    finally:
        del server.pipe.sample_latents
        server.opt.max_batch = saved
    assert resp["ok"] and seen == [max_batch == 1]
    assert torch.backends.cudnn.enabled


def test_stdio_daemon_answers_one_request(tmp_path):
    request = json.dumps({"prompt": "a red cube", "seed": 2})
    proc = subprocess.run(
        [sys.executable, "-m", "sd_tpu_torch.scripts.serve", "--tiny", "--device", "cpu",
         "--stdio", "--steps", "2", "--no-warmup", "--outdir", str(tmp_path)],
        input=f"{request}\n\nnot json\nquit\n", cwd=_REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert lines[0]["ok"] and lines[0]["paths"] == [str(tmp_path / "000000.png")]
    assert lines[1]["ok"] is False and lines[1]["error"].startswith("JSONDecodeError")
    assert len(lines) == 2 and "serve: ready" in proc.stderr
