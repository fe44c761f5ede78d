"""Host-parallel data prefetch (the port's copy of
``sd_tpu/utils/prefetch.py``, the reference's ``ldm/util.py``
``parallel_data_prefetch``): fan a function over chunks of data across
processes or threads and gather the results in input order."""

from __future__ import annotations

import multiprocessing as mp
from queue import Queue
from threading import Thread
from typing import Callable, List

import numpy as np

__all__ = ["parallel_data_prefetch"]


def _runner(func, q, idx, data):
    try:
        q.put([idx, func(data)])
    except Exception as e:
        q.put([idx, e])
    finally:
        q.put("Done")


def parallel_data_prefetch(
    func: Callable, data, n_proc: int = 8, target_data_type: str = "ndarray",
    cpu_intensive: bool = True,
):
    """Apply ``func`` to ``data`` split into ``n_proc`` chunks in parallel.

    ``data`` may be an ndarray, list, or dict-of-values (like the reference);
    returns concatenated results in input order.
    """
    assert target_data_type in ("ndarray", "list")
    if isinstance(data, np.ndarray) and target_data_type == "list":
        raise ValueError("list expected but function got ndarray.")
    if isinstance(data, dict):
        data = list(data.values())
    if isinstance(data, np.ndarray):
        chunks = np.array_split(data, n_proc)
    else:
        data = list(data)
        step = -(-len(data) // n_proc)
        chunks = [data[i * step:(i + 1) * step] for i in range(n_proc)]
        chunks = [c for c in chunks if c]

    if cpu_intensive:
        q: "mp.Queue" = mp.Queue()
        make = lambda i, part: mp.Process(target=_runner, args=(func, q, i, part))
    else:
        q = Queue()
        make = lambda i, part: Thread(target=_runner, args=(func, q, i, part))

    procs = [make(i, part) for i, part in enumerate(chunks)]
    gather: List = [None] * len(procs)
    try:
        for p in procs:
            p.start()
        done = 0
        while done < len(procs):
            item = q.get()
            if item == "Done":
                done += 1
                continue
            idx, res = item
            if isinstance(res, Exception):
                raise res
            gather[idx] = res
    finally:
        for p in procs:
            if hasattr(p, "terminate") and p.is_alive():
                p.terminate()
            p.join()

    if target_data_type == "ndarray":
        if gather and not isinstance(gather[0], np.ndarray):
            return np.concatenate([np.asarray(g) for g in gather])
        return np.concatenate([g for g in gather if g is not None])
    out: List = []
    for g in gather:
        if g is not None:
            out.extend(g)
    return out
