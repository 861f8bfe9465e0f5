"""Weight bridge: the JAX package's params, handed over as a nested dict of
numpy arrays, become the port's tensors name for name.

numpy has no bfloat16; JAX hands bf16 leaves over as ``ml_dtypes.bfloat16``
arrays, which go through a ``uint16`` view and come back with
``.view(torch.bfloat16)`` (the bits are the same IEEE bf16 in both)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import map_plan


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.array(a, order="C")      # own, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    return map_plan(lambda a: tensor_from_numpy(a, device), tree)
