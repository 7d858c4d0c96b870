"""Seconds the submitter spent in the store's creates, summed over the
window's episodes (harness clock around the create loop)."""


def read(run):
    return sum(e["create_s"] for e in run.res["episodes"])
