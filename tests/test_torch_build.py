"""``asr_chinese_e2e_tpu_torch/ops/_build.py::build`` on the CPU, with a
stand-in for nvcc: the ranks of a cold start share one build directory and
may build at once, so the objects and the library go to a temporary
directory and the library is renamed into place. Two builds at once give
one complete library, a reader never sees a half-written one, no temporary
file is left behind, and a failed compile leaves no library.
"""

import sys
import threading
import time

import pytest

from asr_chinese_e2e_tpu_torch.ops import _build

LIBRARY = b"library:" + b"x" * 4096

# writes its ``-o`` file in two halves with a pause between them, as a slow
# compiler or linker would; exits 1 when a source path contains "broken"
FAKE_NVCC = f"""#!{sys.executable}
import sys, time
args = sys.argv[1:]
if any("broken" in a for a in args):
    sys.exit(1)
out = args[args.index("-o") + 1]
data = {LIBRARY!r} if "-shared" in args else b"object"
with open(out, "wb") as f:
    f.write(data[: len(data) // 2])
    f.flush()
    time.sleep(0.2)
    f.write(data[len(data) // 2:])
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc


def test_concurrent_builds_give_one_complete_library(fake_build):
    path = _build.library_path()
    results, seen, done = [], [], threading.Event()

    def reader():  # reads the library whenever it is there, once more at the end
        while True:
            finished = done.is_set()
            if path.exists():
                seen.append(path.read_bytes())
            if finished:
                return
            time.sleep(0.005)

    watch = threading.Thread(target=reader)
    builders = [threading.Thread(target=lambda: results.append(_build.build()))
                for _ in range(2)]
    watch.start()
    for t in builders:
        t.start()
    for t in builders:
        t.join()
    done.set()
    watch.join()
    assert results == [path, path]
    assert path.read_bytes() == LIBRARY
    assert seen and all(data == LIBRARY for data in seen)
    assert [p.name for p in path.parent.iterdir()] == [_build.LIB_NAME]
    assert _build.build() == path  # on disk: no second compile


def test_failed_compile_leaves_no_library(fake_build):
    (fake_build / "broken.cu").write_text("// does not compile\n")
    path = _build.library_path()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not path.exists()
    assert list(path.parent.iterdir()) == []
