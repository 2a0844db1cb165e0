"""Device milliseconds per denoise step in kernels of the `gemm` class
(`kernel_classes/gemm.json`): the linears over cuBLAS."""

LAYER = "linears"
MOVES = "denoise_step_s"


def read(rec):
    if rec.get("entry") != "denoise" or rec["busy_s"] <= 0 or rec["steps"] == 0:
        return None
    return 1e3 * rec["device_s"].get("gemm", 0.0) / rec["steps"]
