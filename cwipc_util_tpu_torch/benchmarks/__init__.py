"""cwipc_util_tpu_torch.benchmarks subpackage."""
