"""cwipc_util_tpu_torch.io: PLY files, cwipcdump files and packets."""
