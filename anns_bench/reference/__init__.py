"""The plain PyTorch reference of TaCo: no code of the program under test."""
