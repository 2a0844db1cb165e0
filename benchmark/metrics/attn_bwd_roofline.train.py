"""The summed least time of every attention backward the window's steps made
through the flash kernels (`benchmark.flops.attention_bwd_bound` of each
call's shape: the fused backward with its delta preprocess) over the device
time of the `attention_bwd` class, in percent. Nothing to read where no
backward kernel ran."""

LAYER = "attention kernels"
MOVES = "train_step_s"


def read(rec):
    spent = rec["device_s"].get("attention_bwd", 0.0)
    if rec.get("entry") != "train" or spent <= 0:
        return None
    return 100.0 * rec["attn_bwd_bound_s"] / spent
