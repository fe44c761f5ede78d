"""Build the retrieval index of the PyTorch port from CLIP-embedding ``.npz``
parts, with the flags of ``scripts/train_searcher.py``.

    python -m sd_tpu_torch.scripts.train_searcher -d embeddings/ -t index.npz

Exact top-k search needs no partitioning or tuning, so "training" pools the
parts (``embedding``, or else each file's first array; a directory's
``*.npz`` in sorted order), L2-normalizes the rows and writes one
``embedding`` matrix to ``--target_path``, which ``knn2img --database``
reads. Runs on the host.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--database", type=str, required=True,
                   help="directory of *.npz embedding parts (or one file)")
    p.add_argument("-t", "--target_path", type=str, required=True,
                   help="output index npz path")
    opt = p.parse_args(argv)

    from sd_tpu_torch.pipelines.retrieval import build_index

    if os.path.isdir(opt.database):
        files = sorted(glob.glob(os.path.join(opt.database, "*.npz")))
    else:
        files = [opt.database]
    if not files:
        raise SystemExit(f"no npz files under {opt.database}")
    return build_index(files, opt.target_path)


if __name__ == "__main__":
    main()
