"""The denoise window's model FLOPs (`benchmark.flops.pass_flops` for each
pass it ran: the towers and the bridge) over its seconds at the bf16 peak,
in percent."""

LAYER = "model step: towers, bridge"
MOVES = "denoise_step_s"


def read(rec):
    if rec.get("entry") != "denoise" or rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * rec["peak_flops"])
