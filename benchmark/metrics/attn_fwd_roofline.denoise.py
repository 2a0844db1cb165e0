"""The summed least time of every forward attention call the window's passes
made through the flash kernels (`benchmark.flops.attention_fwd_bound` of
each call's shape) over the device time of the `attention` class, in
percent. Nothing to read where no attention kernel ran."""

LAYER = "attention kernels"
MOVES = "denoise_step_s"


def read(rec):
    spent = rec["device_s"].get("attention", 0.0)
    if rec.get("entry") != "denoise" or spent <= 0:
        return None
    return 100.0 * rec["attn_fwd_bound_s"] / spent
