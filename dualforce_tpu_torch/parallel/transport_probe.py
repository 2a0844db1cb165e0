"""Which transport two ranks that share one card can use.

    python -m dualforce_tpu_torch.parallel.transport_probe

Spawns two processes bound to `cuda:0` twice: once under NCCL (one
all-reduce; NCCL is expected to refuse two ranks on one device), once under
gloo, where it tries each collective the port's helpers use on CUDA tensors
(bf16 and fp32) and on CPU ones. Prints one JSON object: NCCL's outcome and,
per gloo operation, "ok" or the error's first line. `parallel.mesh` stages
through page-locked host memory every gloo operation that does not take
CUDA tensors here (`GLOO_CUDA_OPS`).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _first_line(e: BaseException) -> str:
    return (f"{type(e).__name__}: " + str(e).strip().splitlines()[0])[:300] if str(e) \
        else type(e).__name__


def _gloo_ops(rank: int, device: str):
    def make(dtype=torch.float32, n=8):
        return torch.arange(n, dtype=dtype, device=device) + rank

    def p2p():
        t, r = make(), make()
        peer = 1 - rank
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                         dist.P2POp(dist.irecv, r, peer)]):
            w.wait()

    return {
        "all_reduce": lambda: dist.all_reduce(make()),
        "broadcast": lambda: dist.broadcast(make(), 0),
        "all_gather": lambda: dist.all_gather([make(), make()], make()),
        "all_gather_bf16": lambda: dist.all_gather([make(torch.bfloat16)] * 2,
                                                   make(torch.bfloat16)),
        "all_gather_uint8": lambda: dist.all_gather([make(torch.uint8)] * 2,
                                                    make(torch.uint8)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(make(n=16), make()),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(make(n=4), make()),
        "all_to_all_single": lambda: dist.all_to_all_single(make(), make()),
        "send_recv": p2p,
    }


def _worker(rank: int, backend: str, port: int, out: str) -> None:
    torch.cuda.set_device(0)
    result = {}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=60))
        if backend == "nccl":
            t = torch.ones(4, device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            result["nccl_all_reduce"] = "ok"
        else:
            for where in ("cuda", "cpu"):
                for name, fn in _gloo_ops(rank, where).items():
                    try:
                        fn()
                        if where == "cuda":
                            torch.cuda.synchronize()
                        result[f"{name}[{where}]"] = "ok"
                    except Exception as e:  # noqa: BLE001: the probe records each failure
                        result[f"{name}[{where}]"] = _first_line(e)
                        dist.barrier()
    except Exception as e:  # noqa: BLE001
        result[f"{backend}_error"] = _first_line(e)
    with open(f"{out}.{backend}.{rank}", "w") as f:
        json.dump(result, f)
    os._exit(0)       # a refused NCCL communicator may not tear down cleanly


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("transport_probe: CUDA is not available", file=sys.stderr)
        return 1
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "cards": torch.cuda.device_count()}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe")
        for backend in ("nccl", "gloo"):
            ctx = mp.get_context("spawn")
            port = _port()
            procs = [ctx.Process(target=_worker, args=(r, backend, port, out))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(180)
                if p.is_alive():
                    p.kill()
                    p.join()
            for r in range(2):
                path = f"{out}.{backend}.{r}"
                if os.path.exists(path):
                    with open(path) as f:
                        report[f"{backend}_rank{r}"] = json.load(f)
                else:
                    report[f"{backend}_rank{r}"] = "no result (killed after 180 s)"
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
