"""Frozen input generators of the benchmark: the cluster and the pod mixes,
drawn from the run's seed. They describe inputs as plain data (numbers,
label dicts, selector dicts); lib/adapter.py turns them into the program's
objects, and reference/ reads them as they are."""
