"""The plain reference: PyTorch and NumPy only, float32 with TF32 off.  It
imports nothing of the program and takes nothing the program made: the
benchmark hands it the same seeded weights and inputs it hands the
program."""
