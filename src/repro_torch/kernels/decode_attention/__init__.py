"""repro_torch.kernels.decode_attention"""
