"""One traffic loop per module, found by the `loop` a traffic mix's data
file names: `setup(w, span)` warms up the cell's own shapes, and
`window(w, seconds, span)` offers the mix for `seconds` and returns what
the metrics read ("attempted", "bound", and the loop's own entries)."""
