"""How the port's CUDA sources are keyed for their build (no compiler needed):
a library's digest follows its source and the shared headers under `csrc/`,
so an edited header rebuilds every source that may include it."""

import re

import pytest

from anystereo_tpu_torch.ops.kernels import build


@pytest.mark.parametrize("edit", ["source", "header", "other source"])
def test_library_digest_follows_source_and_shared_headers(tmp_path, monkeypatch, edit):
    """Editing the source or a shared header gives the library a new path
    (so it is built again); editing another source leaves it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "h.cuh").write_text("// h\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("a")
    target = csrc / {"source": "a.cu", "header": "h.cuh", "other source": "b.cu"}[edit]
    target.write_text(target.read_text() + "// edited\n")
    after = build.library_path("a")
    assert (after != before) == (edit != "other source")
    assert after.parent == build.BUILD_DIR and after.name.startswith("liba-")


def test_quoted_includes_are_shared_headers():
    """Every quoted include of a source names a `.cuh` beside it, which the
    digest covers and `nvcc` finds next to the source."""
    found = set()
    for src in sorted(build.CSRC.glob("*.cu")):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert name.endswith(".cuh") and (build.CSRC / name).is_file(), (src.name, name)
            found.add(name)
    assert "async_copy.cuh" in found
