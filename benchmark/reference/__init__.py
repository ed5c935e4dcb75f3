"""The plain reference: the same pose-graph problem solved again in plain
PyTorch from the map's arrays. It imports nothing of the program."""
