"""The benchmark of the PyTorch and CUDA port (``repro_torch``): DNNScaler's
served path on one card.  ``python3 -m bench.run --help``; see README.md."""
