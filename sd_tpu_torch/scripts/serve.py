"""txt2img serving daemon of the PyTorch port (the counterpart of
``scripts/serve.py``).

    python -m sd_tpu_torch.scripts.serve --stdio                 # JSONL on stdin/stdout
    python -m sd_tpu_torch.scripts.serve --http 8000 --ckpt ...  # HTTP POST /txt2img
    python -m sd_tpu_torch.scripts.serve --tiny --device cpu --stdio

Requests are JSON objects, ``{"prompt": "...", "seed": 1234, "n": 1,
"negative_prompt": "...", "steps": 20, "height": 256, "width": 256}``; a
request naming any other field is refused. ``steps``/``height``/``width``
must name a warm bucket: the ``--H``/``--W``/``--steps`` configuration is
bucket 0 and each ``--bucket HxW@STEPS`` adds one; the sampler, guidance
scale and batch are fixed at startup. ``n`` is clamped to ``--max-batch``.
At startup one padded batch runs per bucket (it builds the kernels at first
use and fills the port's caches). A worker thread owns the device:
requests that arrive within ``--batch-window`` ms of the first, for the
same bucket, share one execution padded to ``--max-batch``, and each keeps
its seed, because each request's initial latents ``x_T`` are drawn from a
CPU generator seeded with its own seed (the padding from seed 0), so a
(prompt, seed) pair gives the same image whatever shares its batch. For
that, where ``--max-batch`` is above 1, the executions run without cuDNN:
on an H100 its bf16 3x3 convs give an image a result that depends on its
slot in the batch, while PyTorch's own conv computes each image alone
(``chip_smoke.py``'s ``[serve daemon]`` checks both). At ``--max-batch 1``
a request is always alone in its execution, and cuDNN stays on. A
response carries the written PNG paths (numbered after the largest numeric
name already in ``--outdir``), the safety checker's flags, the effective
configuration, the bucket, ``exec_id`` and ``batched_requests``; a batch
that fails answers ``{"ok": false, "error": ...}`` to each of its requests
and the loop goes on. The safety checker and the invisible watermark (on
the host, after the padding is sliced off, where min(H, W) >= 32) run by
default. ``--device`` defaults to ``cuda``; a run that asks for the card
and finds none fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--stdio", action="store_true",
                   help="serve JSONL requests on stdin, responses on stdout")
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="serve HTTP POST /txt2img on this port of 127.0.0.1")
    p.add_argument("--outdir", type=str, default="outputs/serve")
    p.add_argument("--H", "--height", dest="H", type=int, default=512)
    p.add_argument("--W", "--width", dest="W", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="plms")
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--max-batch", dest="max_batch", type=int, default=1,
                   help="fixed serving batch; requests are padded to it")
    p.add_argument("--bucket", action="append", default=None, metavar="HxW@STEPS",
                   help="another warm serving bucket (repeatable), e.g. --bucket 256x256@20; "
                        "'@STEPS' alone keeps the default resolution, 'HxW' alone keeps --steps")
    p.add_argument("--batch-window", dest="batch_window", type=float, default=10.0,
                   help="ms to wait coalescing concurrent requests into one execution")
    p.add_argument("--config", type=str, default=None,
                   help="model config (default: the run's for a run-directory --ckpt, else "
                        "SD v1's, configs/stable-diffusion/v1-inference.yaml)")
    p.add_argument("--ckpt", type=str, help="a reference .ckpt, or a training run's logdir")
    p.add_argument("--tiny", action="store_true", help="use the tiny random-weight model")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip the warm-up batch of each bucket at startup")
    p.add_argument("--no-watermark", dest="watermark", action="store_false")
    p.add_argument("--no-safety", dest="safety", action="store_false")
    p.add_argument("--safety_ckpt", type=str, default=os.environ.get("SD_TPU_SAFETY_CKPT"))
    return p.parse_args(argv)


def parse_buckets(opt) -> List[tuple]:
    """Warm serving buckets ``[(H, W, steps), ...]``: ``--H``/``--W``/``--steps``
    first, then each ``--bucket`` not already listed ('256x256@20'; '@20'
    keeps the default resolution, '256x256' keeps --steps, '256' is 256x256)."""
    buckets = [(opt.H, opt.W, opt.steps)]
    for spec in opt.bucket or []:
        hw, _, st = spec.partition("@")
        h, w = opt.H, opt.W
        if hw:
            hs, _, ws = hw.partition("x")
            h, w = int(hs), int(ws or hs)
        steps = int(st) if st else opt.steps
        if (h, w, steps) not in buckets:
            buckets.append((h, w, steps))
    return buckets


def build_pipeline(opt):
    """The pipeline for ``opt`` (without the watermark, which ``Server``
    applies after slicing off the padding); sets ``opt.buckets``, clamped to
    the tiny model's resolution with ``--tiny``."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    opt.buckets = parse_buckets(opt)
    pipe, tiny_hw = build_txt2img_pipeline(
        tiny=opt.tiny, config=opt.config, ckpt=opt.ckpt, safety=opt.safety,
        safety_ckpt=opt.safety_ckpt, watermark=False, device=opt.device,
        min_hw=min(min(h, w) for h, w, _ in opt.buckets))
    if tiny_hw:
        clamped = []
        for h, w, s in opt.buckets:
            b = (min(h, tiny_hw), min(w, tiny_hw), s)
            if b not in clamped:
                clamped.append(b)
        opt.buckets = clamped
        opt.H, opt.W = opt.buckets[0][:2]
    return pipe


_STOP = object()  # queued by Server.close: the worker's last item


@contextlib.contextmanager
def without_cudnn():
    """cuDNN off within the block (a process-wide switch: the server's
    worker is the only thread that runs device work while it is off)."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


class Server:
    """Warm buckets, one worker thread on the device, and request
    coalescing. ``exec_count`` counts executions since the warm-up;
    ``close()`` stops the worker."""

    FIELDS = {"prompt", "seed", "n", "negative_prompt", "height", "width", "steps"}

    def __init__(self, opt):
        self.opt = opt
        self.device = torch.device(opt.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise SystemExit("--device cuda: no CUDA device is available")
            if self.device.index is None:  # the worker's current device: the caller's
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.pipe = build_pipeline(opt)
        os.makedirs(opt.outdir, exist_ok=True)
        # numbering continues after the largest numeric name, so a restart
        # never overwrites a path already handed to a client
        stems = [int(os.path.splitext(f)[0]) for f in os.listdir(opt.outdir)
                 if os.path.splitext(f)[0].isdigit()]
        self.count = max(stems) + 1 if stems else 0
        self.exec_count = 0
        self._queue: queue.Queue = queue.Queue()
        self._pending = None  # a request held over as the head of the next batch
        self._worker = threading.Thread(target=self._work, daemon=True)
        self._worker.start()
        if opt.warmup:
            for bucket in opt.buckets:
                t0 = time.perf_counter()
                self._run_batch([{"prompt": "warmup", "n": opt.max_batch, "seed": 0,
                                  "negative": None, "bucket": bucket, "event": None,
                                  "resp": {}}])
                h, w, s = bucket
                print(f"serve: warm bucket {h}x{w}@{s} (first batch "
                      f"{time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)
            self.exec_count = 0

    def handle(self, req: dict) -> dict:
        """Queue one request and wait for its response."""
        unsupported = sorted(set(req) - self.FIELDS)
        if unsupported:
            return {"ok": False,
                    "error": f"unsupported request fields {unsupported}; this server pins the "
                             f"sampling configuration at startup",
                    "config": self.effective_config()}
        d_h, d_w, d_s = self.opt.buckets[0]
        bucket = (int(req.get("height", d_h)), int(req.get("width", d_w)),
                  int(req.get("steps", d_s)))
        if bucket not in self.opt.buckets:
            return {"ok": False,
                    "error": f"no warm bucket {bucket[0]}x{bucket[1]}@{bucket[2]}; configure "
                             f"it at startup with --bucket",
                    "config": self.effective_config()}
        n_req = int(req.get("n", 1))
        n = max(1, min(n_req, self.opt.max_batch))
        item = {"prompt": req.get("prompt", ""), "n": n, "seed": int(req.get("seed", 42)),
                "negative": req.get("negative_prompt"), "bucket": bucket,
                "event": threading.Event(), "resp": {}}
        self._queue.put(item)
        while not item["event"].wait(1.0):
            if not self._worker.is_alive():
                return {"ok": False, "error": "the server's worker thread has stopped"}
        resp = item["resp"]
        if n != n_req:
            resp["n_clamped"] = n
        return resp

    def _work(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            first = self._pending or self._queue.get()
            self._pending = None
            if first is _STOP:
                return
            batch, slots = [first], first["n"]
            deadline = time.monotonic() + self.opt.batch_window / 1000.0
            while slots < self.opt.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if (nxt is _STOP or slots + nxt["n"] > self.opt.max_batch
                        or nxt["bucket"] != first["bucket"]):
                    self._pending = nxt
                    break
                batch.append(nxt)
                slots += nxt["n"]
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — the serve loop must survive
                for it in batch:
                    it["resp"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    if it["event"] is not None:
                        it["event"].set()

    def close(self) -> None:
        """Serve the requests queued so far, then stop the worker thread (and
        with it the server's hold on the device's memory)."""
        self._queue.put(_STOP)
        self._worker.join()

    def _noise(self, seed: int, n: int, h: int, w: int) -> torch.Tensor:
        """``x_T [n, h/f, w/f, C]`` drawn from a CPU generator seeded ``seed``."""
        pipe = self.pipe
        shape = (n, h // pipe.downsample, w // pipe.downsample, pipe.latent_channels)
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed))

    def _run_batch(self, batch: List[dict]) -> None:
        from sd_tpu_torch.utils.image import save_image

        opt = self.opt
        h, w, steps = batch[0]["bucket"]
        prompts, negs, noises = [], [], []
        for it in batch:
            prompts += [it["prompt"]] * it["n"]
            negs += [it["negative"] or ""] * it["n"]
            noises.append(self._noise(it["seed"], it["n"], h, w))
        pad = opt.max_batch - len(prompts)
        if pad:
            prompts += [""] * pad
            negs += [""] * pad
            noises.append(self._noise(0, pad, h, w))
        t0 = time.perf_counter()
        # inference mode is per thread: the pipeline's methods enter it, and
        # so does everything this thread does around them
        slots = without_cudnn() if opt.max_batch > 1 else contextlib.nullcontext()
        with torch.inference_mode(), slots:
            imgs = self.pipe(prompts, torch.Generator().manual_seed(batch[0]["seed"]),
                             negative_prompts=negs, height=h, width=w, steps=steps,
                             guidance_scale=opt.scale, sampler=opt.sampler,
                             x_T=torch.cat(noises).to(self.device))
        dt = time.perf_counter() - t0
        self.exec_count += 1
        flags = self.pipe.last_safety_flags
        off = 0
        for it in batch:
            n = it["n"]
            sl = imgs[off:off + n]
            if opt.watermark and min(h, w) >= 32:
                from sd_tpu_torch.utils.watermark import embed_watermark_batch

                sl = embed_watermark_batch(np.asarray(sl))
            paths = []
            for img in sl:
                path = os.path.join(opt.outdir, f"{self.count:06}.png")
                save_image(img, path)
                paths.append(path)
                self.count += 1
            it["resp"] = {
                "ok": True, "paths": paths, "seconds": round(dt, 3),
                "safety_flagged": [] if flags is None else flags[off:off + n],
                "config": self.effective_config(),
                "bucket": {"H": h, "W": w, "steps": steps},
                "exec_id": self.exec_count, "batched_requests": len(batch)}
            off += n
            if it["event"] is not None:
                it["event"].set()

    def effective_config(self) -> dict:
        opt = self.opt
        return {"H": opt.H, "W": opt.W, "steps": opt.steps, "sampler": opt.sampler,
                "scale": opt.scale, "max_batch": opt.max_batch,
                "batch_window_ms": opt.batch_window,
                "buckets": [f"{h}x{w}@{s}" for h, w, s in opt.buckets]}


def serve_stdio(server: Server) -> None:
    """One JSON response line per JSON request line, until ``quit`` or EOF."""
    print("serve: ready", file=sys.stderr, flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line == "quit":
            break
        try:
            resp = server.handle(json.loads(line))
        except Exception as e:  # noqa: BLE001 — protocol boundary
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), flush=True)


def http_server(server: Server, port: int):
    """A ``ThreadingHTTPServer`` on 127.0.0.1:``port`` (0: any free port)
    answering POST /txt2img; each handler thread waits on its request's slot
    while the worker coalesces. The caller runs ``serve_forever()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/txt2img":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                resp = server.handle(json.loads(self.rfile.read(length) or b"{}"))
            except Exception as e:  # noqa: BLE001 — protocol boundary
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            body = json.dumps(resp).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_http(server: Server, port: int) -> None:
    httpd = http_server(server, port)
    print(f"serve: http on :{httpd.server_address[1]}", file=sys.stderr, flush=True)
    httpd.serve_forever()


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = parse_args(argv)
    server = Server(opt)
    if opt.http:
        serve_http(server, opt.http)
    else:
        serve_stdio(server)


if __name__ == "__main__":
    main()
