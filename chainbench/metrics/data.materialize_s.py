"""Set-up seconds of the egs: supervision compiled in forked workers
(`ChainDataset.precompile`) and every batch placed on the card once
(`MaterializedBatches(..., device=True)`), on the host clock."""

LAYER = "Host data"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    p = run["session"].phases
    return p["egs_s"] + p["place_s"]
