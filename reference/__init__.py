"""Plain PyTorch references of the models the benchmark runs, importing
nothing of the program."""
