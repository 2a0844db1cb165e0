"""The share of the denoise window in which no operation ran on the device
(the union of the trace's device intervals against the window), in percent."""

LAYER = "device"
MOVES = "denoise_step_s"


def read(rec):
    if rec.get("entry") != "denoise" or rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
