"""The plain reference of the train step (plain PyTorch and numpy). It
imports nothing of the program."""
