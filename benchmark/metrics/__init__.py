"""One reader per metric, end-to-end or per-layer, in a file named after
the metric; the shared arithmetic of the kernels' rooflines in
roofline.py."""
