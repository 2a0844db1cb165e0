"""Device milliseconds per denoise step in operations of neither the `gemm`
class nor an attention class (`attention`, `attention_bwd`): norms, RoPE,
modulation, gated residuals, casts and copies."""

LAYER = "elementwise chains"
MOVES = "denoise_step_s"


def read(rec):
    if rec.get("entry") != "denoise" or rec["busy_s"] <= 0 or rec["steps"] == 0:
        return None
    other = sum(s for cls, s in rec["device_s"].items()
                if cls != "gemm" and not cls.startswith("attention"))
    return 1e3 * other / rec["steps"]
