"""repro_torch.perf"""
