"""Seconds a training step spends in the optimizer (clipping and AdamW over the
LoRA factors): the mean over the window's steps of `LoRATrainer.train`'s
`on_micro_step` record `optimizer_s`, which the trainer times with the
device synchronised around it (traced run only)."""

LAYER = "trainer, optimizer"
MOVES = "train_step_s"


def read(rec):
    if rec.get("entry") != "train" or "optimizer_s" not in rec:
        return None
    return rec["optimizer_s"]
