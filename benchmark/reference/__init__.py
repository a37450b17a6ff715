"""The plain reference: DIN, its training step and Adam in plain PyTorch
(`din.py`), and the serving path's candidate set and features from the
data files (`catalog.py`). Nothing here imports the program."""
