"""The port's benchmark: one cell a run, driven by the files beside it."""
