"""Retrieval-augmented generation, RDM / knn2img (port of
``sd_tpu/pipelines/retrieval.py``).

The "index" is the L2-normalized CLIP image-embedding matrix, normalized
once when it is loaded; search is one exact fp32 product of the normalized
queries with it and ``torch.topk`` on an explicit device (the card by
default), as ``sd_tpu`` searches with one matmul and ``top_k`` outside any
Pallas kernel. TF32 is off for the product: near-equal scores would change
order. The flow (the reference's ``knn2img.py``): a CLIP-text query, its
top-k neighbour embeddings, the cross-attention context ``[query,
neighbours]``, then an LDM sampler.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, Union

import numpy as np
import torch

__all__ = ["Searcher", "build_index", "knn_conditioning"]


def _normalize(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def _read_embeddings(path: str) -> np.ndarray:
    """The ``embedding`` array of an ``.npz``, or else its first array."""
    with np.load(path) as arr:
        key = "embedding" if "embedding" in arr else list(arr.keys())[0]
        return arr[key].astype(np.float32)


def build_index(embedding_files: Iterable[str], out_path: str) -> str:
    """``train_searcher``: pool the embedding ``.npz`` parts (in sorted
    order), L2-normalize, store one ``embedding`` matrix at ``out_path``.
    Exact search needs no partitioning or tuning."""
    parts = [_read_embeddings(f) for f in sorted(embedding_files)]
    db = _normalize(np.concatenate(parts, axis=0))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, embedding=db)
    print(f"Index with {db.shape[0]} x {db.shape[1]} embeddings -> {out_path}")
    return out_path


class Searcher:
    """Exact top-k over a normalized embedding database.

    ``database``: an ``.npz`` path (``embedding``), a directory of them, or
    an array ``[N, D]``. The normalized database is held on ``device`` in
    fp32.
    """

    def __init__(self, database: Union[str, np.ndarray, torch.Tensor],
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Searcher: device cuda, but no CUDA device is available")
        if isinstance(database, str):
            if os.path.isdir(database):
                emb = np.concatenate([np.load(f)["embedding"] for f in
                                      sorted(glob.glob(os.path.join(database, "*.npz")))])
            else:
                emb = np.load(database)["embedding"]
            emb = torch.from_numpy(np.asarray(emb, np.float32)).to(self.device)
        else:
            src = torch.as_tensor(database)
            emb = src.float().to(self.device)
            if emb.data_ptr() == src.data_ptr():  # the caller's own memory: normalize a copy
                emb = emb.clone()
        # normalized in place on the device (the load peaks at one copy of the
        # database), as sd_tpu's _normalize on the host: x / (|x| + eps)
        self.embeddings = emb.div_(torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)

    def __call__(self, queries, k: int = 10) -> Dict[str, np.ndarray]:
        """queries ``[B, D]`` → ``nn_embeddings [B, k, D]``, ``q_embeddings``
        (the normalized queries), ``nn_indices`` and ``scores`` (cosine), as
        numpy arrays: the reference Searcher's return contract."""
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            scores = q @ self.embeddings.T                      # [B, N] cosine, fp32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
        top_scores, idx = torch.topk(scores, k, dim=-1)
        nn_emb = self.embeddings[idx]                           # [B, k, D]
        return {"nn_embeddings": nn_emb.cpu().numpy(), "q_embeddings": q.cpu().numpy(),
                "nn_indices": idx.cpu().numpy(), "scores": top_scores.cpu().numpy()}


def knn_conditioning(text_embedding, searcher: Searcher, k: int = 10):
    """The RDM's cross-attention context ``[B, 1 + k, D]``: the query as
    given (not normalized again) in token 0, then its k neighbours; the
    unconditional context is zeros. Returns fp32 tensors on the CPU."""
    q = torch.as_tensor(np.asarray(text_embedding, np.float32))
    if q.ndim == 3:  # [B, 1, D], a pooled embedding as a sequence
        q = q[:, 0]
    nn = torch.from_numpy(searcher(q.numpy(), k=k)["nn_embeddings"])
    cond = torch.cat([q[:, None, :], nn], dim=1)
    return cond, torch.zeros_like(cond)
