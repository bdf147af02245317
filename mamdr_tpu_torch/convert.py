"""Parameter trees between the two frameworks, keyed by the flax names.

The port's parameter trees are nested dicts with the flax paths
(``model/dnn/Dense_0/Dense_0/kernel``) and the flax layouts (kernels
``[in, out]``, biases ``[out]``), so conversion is a leaf-wise copy with no
renaming or transposing. Inputs are nested dicts of numpy arrays (e.g.
``jax.device_get`` of a flax tree); this module imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mamdr_tpu_torch.utils import trees


def params_from_jax(tree_of_numpy: Any) -> Any:
    """Nested dict of arrays -> nested dict of CPU tensors (copies, same dtypes)."""
    return trees.tree_map(lambda x: torch.tensor(np.asarray(x)), tree_of_numpy)


def params_to_numpy(port_params: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays (host copies)."""
    return trees.tree_map(lambda t: t.detach().cpu().numpy(), port_params)
