"""Weight conversion from the JAX package's parameter trees.

``params_from_numpy`` takes the reference ``Model.init_params`` output, with
every leaf already converted to a numpy array by the caller, and returns the
port's flat dict with the same keys and layer-stacked layouts;
``nn_params_from_numpy`` does the same for the NN library's
``Sequential.init`` output (a list with one tuple of arrays per layer). So
the two packages run on identical weights. JAX bfloat16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not take: they go
through float32 first, which is exact, then to the target dtype.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    host = np.asarray(arr)
    if host.dtype.kind == "V" or host.dtype.name == "bfloat16":
        host = host.astype(np.float32)
    t = torch.from_numpy(np.array(host, copy=True))   # writable, owned
    if t.is_floating_point():
        t = t.to(torch.float32).to(dtype)
    return t.to(device)


def params_from_numpy(tree: Mapping[str, np.ndarray], dtype: torch.dtype,
                      device) -> Dict[str, torch.Tensor]:
    return {key: _tensor(arr, dtype, device) for key, arr in tree.items()}


def nn_params_from_numpy(params: Sequence[Sequence[np.ndarray]], dtype: torch.dtype,
                         device) -> List[Tuple[torch.Tensor, ...]]:
    """The reference ``Sequential.init`` output (one tuple of arrays per
    layer, empty for a layer without parameters) as the port's."""
    return [tuple(_tensor(arr, dtype, device) for arr in layer) for layer in params]
