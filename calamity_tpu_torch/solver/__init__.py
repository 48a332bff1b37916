"""Packing (FitSpec), the descent loop and the optimizers."""
