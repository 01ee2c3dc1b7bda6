"""Set-up seconds of the trainer and its captured steps: the host clock
around the warm-up steps, which capture every graph the window replays
(and take the first steps' readings)."""

LAYER = "Captured step"
UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run["session"].phases["capture_s"]
