"""cwipc_util_tpu_torch.scripts: the commands of `python -m cwipc_util_tpu_torch`."""
