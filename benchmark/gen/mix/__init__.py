"""One pod generator per module, found by the name a configuration gives
under `pods.generator`."""
