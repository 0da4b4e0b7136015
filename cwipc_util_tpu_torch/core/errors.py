"""Error model for cwipc_util_tpu_torch.

Same class and semantics as the JAX package's ``CwipcError``
(cwipc_util_tpu/core/errors.py): every error of the framework, a failed
kernel build or launch included, raises it.
"""


class CwipcError(RuntimeError):
    """Exception raised for errors from the cwipc framework."""
    pass
