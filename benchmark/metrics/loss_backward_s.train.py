"""Seconds a training step spends in the LoRA-merged loss and its backward
through the dual tower: the mean over the window's steps of
`LoRATrainer.train`'s `on_micro_step` record `loss_backward_s`, which the
trainer times with the device synchronised around it (traced run only)."""

LAYER = "training step"
MOVES = "train_step_s"


def read(rec):
    if rec.get("entry") != "train" or "loss_backward_s" not in rec:
        return None
    return rec["loss_backward_s"]
