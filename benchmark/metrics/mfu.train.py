"""The training window's model FLOPs (`benchmark.flops.train_step_flops` for
each optimizer step it completed: the towers' and the bridge's forward,
input gradients, the LoRA targets' weight gradients, attention's backward;
not the encoders, not the recompute) over its seconds at the bf16 peak, in
percent. The encoders' time stays in the seconds."""

LAYER = "model step: towers, bridge"
MOVES = "train_step_s"


def read(rec):
    if rec.get("entry") != "train" or rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * rec["peak_flops"])
