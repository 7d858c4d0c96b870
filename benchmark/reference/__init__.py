"""The plain reference: NumPy over the benchmark's own inputs (gen/) and
the program's outputs as read from the store. It imports nothing of the
program and takes nothing the program derived."""
