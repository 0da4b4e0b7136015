"""Version of the cwipc_util_tpu_torch framework (the JAX package's version
string, so both packages report one version)."""

__version__ = "0.1.0"
