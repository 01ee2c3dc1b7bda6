"""The host's pace: the median wall time between successive steps of the
window as `Trainer.fit` records it (`timings["step_s"]`, host clock, no
synchronize)."""

LAYER = "Trainer"
UNIT = "ms"
MOVES = "audio_s_per_s"


def read(run):
    return run["window"]["host_ms"]
