"""Carry flax parameters into the torch modules.

A flax tree ``{"SAGEConv_0": {"fc_self": {"kernel", "bias"}, ...}, ...}``
becomes a ``state_dict`` ``{"layers.0.fc_self.weight", ...}``: a numbered
submodule ``Name_i`` becomes ``layers.i``, a Dense ``kernel [in, out]``
becomes a Linear ``weight [out, in]``. The leaves may be NumPy or JAX
arrays; this module only needs NumPy.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, tree):
        for key, val in tree.items():
            m = re.fullmatch(r"[A-Za-z]+_(\d+)", key)
            name = f"layers.{m.group(1)}" if m else key
            path = prefix + [name]
            if isinstance(val, Mapping):
                walk(path, val)
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                path[-1] = "weight"
                arr = arr.T
            out[".".join(path)] = torch.tensor(arr)

    walk([], params)
    return out
