"""repro_torch.kernels.flash_attention"""
