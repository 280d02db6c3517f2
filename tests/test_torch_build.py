"""Library names of ``kernels/build.py``: a library is named by a hash of
its source, every header the source includes and the flags, so an edited
header can never load a stale build."""
from repro_torch.kernels import build


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """An edited header, even one included through another header, names a
    new library; a header the source does not include changes nothing."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert build.library_path("k") != first
    assert first.name.startswith("libk-") and first.parent == build.BUILD_DIR


def test_tensor_core_kernels_share_the_hopper_header():
    for name in ("conv2d_gemm", "flash_attention"):
        srcs = build._sources(build.CSRC / f"{name}.cu", {})
        assert build.CSRC / "hopper.cuh" in srcs
