"""The share of the training window in which no operation ran on the device
(the union of the trace's device intervals against the window), in
percent. The traced run passes the trainer its `on_micro_step`, which
synchronises the device around each phase, so the share holds those
waits."""

LAYER = "device"
MOVES = "train_step_s"


def read(rec):
    if rec.get("entry") != "train" or rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
