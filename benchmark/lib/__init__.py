"""The harness's general code: what every cell shares."""
