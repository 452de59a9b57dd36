"""The kernel builder's library name follows every source it compiles.

``kernels/build.py`` names each library by a hash of its ``.cu`` file, the
local headers that file includes (followed through headers) and the
``nvcc`` flags, so that an edit to a shared header rebuilds every library
that includes it.  CPU only: nothing is compiled.
"""
from repro_torch.kernels import build


def _csrc(tmp_path, header="// v1\n"):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "common.cuh"\nint k() { return 1; }\n')
    (d / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                  + header)
    (d / "inner.cuh").write_text("// inner v1\n")
    (d / "unused.cuh").write_text("// not included\n")
    return d


def test_library_path_follows_included_headers(tmp_path):
    d = _csrc(tmp_path)
    first = build._library_path("k", d)
    assert build._library_path("k", d) == first          # stable
    assert [f.name for f in build._sources(d / "k.cu")] == [
        "k.cu", "common.cuh", "inner.cuh"]
    (d / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                  "// v2\n")
    second = build._library_path("k", d)
    assert second != first
    (d / "inner.cuh").write_text("// inner v2\n")       # through a header
    assert build._library_path("k", d) != second


def test_library_path_ignores_headers_it_does_not_include(tmp_path):
    d = _csrc(tmp_path)
    first = build._library_path("k", d)
    (d / "unused.cuh").write_text("// edited\n")
    assert build._library_path("k", d) == first
    assert first.name.startswith("libk_") and first.parent == build.BUILD_DIR


def test_port_sources_include_the_shared_hopper_header():
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan_bwd",
                 "ssd_wide_bwd"):
        assert "hopper.cuh" in [f.name for f in
                                build._sources(build.CSRC / f"{name}.cu")]
