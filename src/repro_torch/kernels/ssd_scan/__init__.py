"""repro_torch.kernels.ssd_scan"""
