"""cwipc_util_tpu_torch.net: the pipeline ABCs and the in-process sinks and sources."""
