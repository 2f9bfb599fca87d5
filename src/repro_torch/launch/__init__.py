"""Entry points of the port (mirrors ``repro.launch``):
``python -m repro_torch.launch.serve_ann`` serves a TaCo index through the
ANN serving engine on the card; ``python -m repro_torch.launch.serve``
serves LM requests through the slot engine."""
