"""cuBLAS matrix-product device milliseconds a step in the traced window,
by kernel name (cuBLAS names its Hopper bfloat16 kernels nvjet_*)."""

LAYER = "Trunks"
UNIT = "ms"
MOVES = "audio_s_per_s"
PATTERNS = ("gemm", "sm90", "nvjet")


def read(run):
    trace = run["trace"]
    _, seconds = trace.matching(PATTERNS)
    return seconds / trace.steps * 1e3 if seconds else None
