"""The benchmark of the PyTorch and CUDA port of TaCo (``repro_torch``)."""
