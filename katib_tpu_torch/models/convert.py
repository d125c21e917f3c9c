"""Carry the JAX package's LM parameters into the port's ``TransformerLM``.

The input is the flax parameter tree of the JAX package's ``TransformerLM``
(``katib_tpu/models/transformer.py``) with numpy arrays as leaves; the
output is a ``state_dict`` for this package's ``TransformerLM``. Layout changes: flax kernels are [in, out] and torch
weights [out, in]; the attention's ``DenseGeneral`` kernels [E, 3, H, D] and
[H, D, E] are flattened to [3*H*D, E] and [E, H*D].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def lm_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "params" in params and "embed" not in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {"embed": _t(params["embed"])}
    layers = sorted(
        (int(name[len("block"):]) for name in params if name.startswith("block")),
    )
    for i in layers:
        src = params[f"block{i}"]
        dst = f"blocks.{i}."
        if "moe" in src:
            raise NotImplementedError("mixture-of-experts blocks are a later slice of the port")
        out[dst + "ln1.scale"] = _t(src["ln1"]["scale"])
        out[dst + "ln2.scale"] = _t(src["ln2"]["scale"])
        qkv = np.asarray(src["attn"]["qkv"]["kernel"])  # [E, 3, H, D]
        out[dst + "attn.qkv.weight"] = _t(qkv.reshape(qkv.shape[0], -1).T)
        o = np.asarray(src["attn"]["out"]["kernel"])    # [H, D, E]
        out[dst + "attn.out.weight"] = _t(o.reshape(-1, o.shape[-1]).T)
        for name in ("up", "gate", "down"):
            out[dst + f"mlp.{name}.weight"] = _t(np.asarray(src["mlp"][name]["kernel"]).T)
    out["ln_f.scale"] = _t(params["ln_f"]["scale"])
    return out
