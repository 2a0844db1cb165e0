"""The name of a built kernel library (`_build.build_key`), on the CPU.

The key hashes the nvcc flags, the source and every header under `csrc/`, so
an edited header builds each source anew instead of reusing a stale library.
No nvcc is needed: the key is computed from bytes alone.
"""

from dualforce_tpu_torch.ops import _build
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _csrc(tmp_path):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text('#include "common.cuh"\nint b;\n')
    (tmp_path / "common.cuh").write_text("#pragma once\nint shared;\n")
    return tmp_path


def test_build_key_is_stable_and_per_source(tmp_path):
    csrc = _csrc(tmp_path)
    key = _build.build_key("a", csrc)
    assert key == _build.build_key("a", csrc)
    assert len(key) == 16 and int(key, 16) >= 0
    assert key != _build.build_key("b", csrc)


def test_build_key_changes_with_a_header(tmp_path):
    csrc = _csrc(tmp_path)
    before = {name: _build.build_key(name, csrc) for name in ("a", "b")}
    (csrc / "common.cuh").write_text("#pragma once\nint shared2;\n")
    after = {name: _build.build_key(name, csrc) for name in ("a", "b")}
    assert all(after[name] != before[name] for name in before)
    (csrc / "extra.cuh").write_text("int extra;\n")          # a new header counts too
    assert _build.build_key("a", csrc) != after["a"]


def test_build_key_changes_with_the_source_and_flags(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path)
    key = _build.build_key("a", csrc)
    (csrc / "a.cu").write_text('#include "common.cuh"\nint a2;\n')
    edited = _build.build_key("a", csrc)
    assert edited != key
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.build_key("a", csrc) != edited


def test_build_key_of_the_port_sources():
    """Every source of the port gets a key, with the real headers in it."""
    for name in ("flash_fwd", "flash_bwd", "sage_fwd"):
        assert len(_build.build_key(name)) == 16
