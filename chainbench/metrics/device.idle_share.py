"""The share of the traced window in which no kernel, copy or fill ran on
the card (1 - the union of their intervals / the window)."""

LAYER = "Device"
UNIT = "%"
MOVES = "audio_s_per_s"


def read(run):
    trace = run["trace"]
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
