from repro_torch.kernels.exp_delta.ops import decode, encode  # noqa: F401
