"""Entry points of the port (mirrors ``repro.launch``):
``python -m repro_torch.launch.serve_ann`` serves a TaCo index through the
serving engine on the card."""
