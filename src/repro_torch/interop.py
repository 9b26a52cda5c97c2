"""Weight conversion from the JAX package's parameter tree.

``params_from_numpy`` takes the reference ``Model.init_params`` output, with
every leaf already converted to a numpy array by the caller, and returns the
port's flat dict with the same keys and layer-stacked layouts, so the two
packages run on identical weights. JAX bfloat16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not take: they go
through float32 first, which is exact, then to the target dtype.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_numpy(tree: Mapping[str, np.ndarray], dtype: torch.dtype,
                      device) -> Dict[str, torch.Tensor]:
    out = {}
    for key, arr in tree.items():
        host = np.asarray(arr)
        if host.dtype.kind == "V" or host.dtype.name == "bfloat16":
            host = host.astype(np.float32)
        t = torch.from_numpy(np.array(host, copy=True))   # writable, owned
        if t.is_floating_point():
            t = t.to(torch.float32).to(dtype)
        out[key] = t.to(device)
    return out
