"""The kernel build (``repro_torch.kernels._build``) under threads.

A thread pool whose workers make their first kernel call together (the
Mandelbrot example's 8 render threads) must run each ``nvcc`` once and
leave no temporary file.  ``nvcc`` is a fake here: a shell script that
sleeps, writes its ``-o`` file and logs its call.
"""
import threading

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "fake nvcc"; exit 0; fi
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$out" >> "{log}"
sleep 0.3
echo "built" > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    _build._compiler_id.cache_clear()
    yield build_dir, log
    _build._compiler_id.cache_clear()


def test_threads_first_build_runs_nvcc_once(fake_nvcc):
    build_dir, log = fake_nvcc
    paths, errors = [], []
    barrier = threading.Barrier(8)

    def first_call():
        try:
            barrier.wait(timeout=30)
            paths.append(_build.build(["mandelbrot"])["mandelbrot"])
        except Exception as e:  # read below: any thread's failure fails the test
            errors.append(e)

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    calls = log.read_text().splitlines()
    assert len(calls) == 1, calls
    assert len(set(paths)) == 1 and len(paths) == 8
    files = sorted(p.name for p in build_dir.iterdir())
    assert files == [paths[0].name], files
    assert paths[0].read_text() == "built\n"
    assert not list(build_dir.glob("*.tmp"))


def test_temporary_file_names_the_thread(fake_nvcc):
    build_dir, log = fake_nvcc
    _build.build(["mandelbrot"])
    (tmp,) = log.read_text().splitlines()
    assert tmp.endswith(f".{threading.get_ident()}.tmp")
