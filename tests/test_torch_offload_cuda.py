"""Host masters, staging and fp8 storage on the card.

Skips where there is no CUDA device. It imports no JAX, so on a machine with
the card it runs without the repository's JAX test configuration:
`python -m pytest --noconftest tests/test_torch_offload_cuda.py`. Every
check is exact: staging copies bytes.
"""

import gc

import pytest
import torch

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch import offload
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.models.factory import init_pipeline_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tensors(module):
    return list(module.parameters()) + list(module.buffers())


def test_host_init_is_page_locked_and_equals_resident_init(cuda):
    cfg = tiny_test_config()
    resident = init_pipeline_params(cfg, device=cuda, dtype=torch.bfloat16, seed=7)
    host = init_pipeline_params(cfg, device=cuda, dtype=torch.bfloat16, seed=7, host=True)
    for name, m in host.items():
        assert all(t.device.type == "cpu" and t.is_pinned() for t in _tensors(m)), name
        want = resident[name].state_dict()
        for k, v in m.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k].cpu()), (name, k)


def test_staged_copy_round_trip_and_release(cuda):
    cfg = tiny_test_config()
    mods = init_pipeline_params(cfg, device=cuda, dtype=torch.float8_e4m3fn, seed=8,
                                with_vaes=False, host=True)
    master = mods["video_dit"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with offload.staged(master, cuda) as copy:
        assert torch.cuda.memory_allocated() - before >= offload.nbytes(master)
        for (k, v), (_, c) in zip(master.state_dict().items(), copy.state_dict().items()):
            assert c.is_cuda and c.dtype == v.dtype, k
            assert torch.equal(c.view(torch.uint8).cpu(), v.view(torch.uint8)), k
        kept = list(copy.parameters())
    assert all(p.untyped_storage().nbytes() == 0 for p in kept)
    del copy, kept
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_page_locked_buffer_is_released(cuda, monkeypatch):
    """The lock lasts as long as a view of the buffer does, and is released
    (`cudaHostUnregister` on its address) when the last one goes."""
    cudart = torch.cuda.cudart()
    real, calls = cudart.cudaHostUnregister, []
    monkeypatch.setattr(cudart, "cudaHostUnregister", lambda p: calls.append(p) or real(p))
    buf = offload._page_locked(64 << 20)
    view = buf[4096:8192]
    ptr = buf.data_ptr()
    assert buf.is_pinned() and ptr % 4096 == 0
    del buf
    gc.collect()
    assert view.is_pinned() and calls == []
    del view
    gc.collect()
    assert calls == [ptr]


def test_fp8_linear_keeps_no_upcast_copy(cuda):
    """An `Fp8Linear` holds one byte per weight and its call leaves no bf16
    copy behind."""
    fp8 = tnn.cast_modules_fp8(torch.nn.Sequential(
        torch.nn.Linear(4096, 4096, device=cuda, dtype=torch.bfloat16)))
    assert isinstance(fp8[0], tnn.Fp8Linear)
    assert offload.nbytes(fp8) == 4096 * 4096 + 2 * 4096     # fp8 weight, bf16 bias
    x = torch.randn(2, 128, 4096, device=cuda, dtype=torch.bfloat16)
    fp8(x)                  # the first product allocates cuBLAS's workspace
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = fp8(x)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    del y
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
