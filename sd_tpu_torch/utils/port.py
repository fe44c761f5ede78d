"""Reading reference checkpoints (port of ``load_torch_state_dict`` and
``demangle_ema_keys`` from ``sd_tpu/utils/port.py``).

The port's modules carry the checkpoint's own names, so a reference
``state_dict`` needs no layout flips: only the file reader and the EMA key
demangling. Both return tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

__all__ = ["load_torch_state_dict", "demangle_ema_keys"]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The flat ``state_dict`` of a Lightning/torch ``.ckpt`` or ``.pt``
    (its ``state_dict`` entry where it has one), on the CPU.

    The file is read with ``weights_only=False``, as the reference and
    ``sd_tpu`` read it: its pickle runs, so load only files you trust.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def demangle_ema_keys(sd: Mapping[str, torch.Tensor],
                      model_prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """The EMA weights under their model names.

    ``LitEma`` keeps one buffer per parameter with the dots stripped:
    ``model.diffusion_model.input_blocks.0.0.weight`` is stored as
    ``model_ema.diffusion_modelinput_blocks00weight``. The dotted names are
    recovered by matching against the model keys in ``sd``; the result is
    keyed by the full model key (``model.<dotted>``), ready to overwrite
    those entries.
    """
    mangled_to_dotted = {k[len(model_prefix):].replace(".", ""): k
                         for k in sd if k.startswith(model_prefix)}
    out = {}
    for k, v in sd.items():
        if not k.startswith("model_ema."):
            continue
        mangled = k[len("model_ema."):]
        if mangled in ("decay", "num_updates"):
            continue
        dotted = mangled_to_dotted.get(mangled)
        if dotted is not None:
            out[dotted] = v
    return out
