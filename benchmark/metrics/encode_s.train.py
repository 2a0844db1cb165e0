"""Seconds a training step spends in the frozen encodes (UMT5, the Wan VAE of
the clip and of its first frame, the DAC): the mean over the window's steps
of `LoRATrainer.train`'s `on_micro_step` record `encode_s`, which the
trainer times with the device synchronised around it (traced run only)."""

LAYER = "encoders"
MOVES = "train_step_s"


def read(rec):
    if rec.get("entry") != "train" or "encode_s" not in rec:
        return None
    return rec["encode_s"]
