"""The reference's own test files of serving's data plane, replay and the
docs, unchanged and in place, against the port (``_torch_reference.py``,
``_torch_alias.py``): one subprocess per file, with its own timeout."""
import pytest

from _torch_reference import assert_reference_file

FILES = (
    "test_serving.py",
    "test_workload.py",
    "test_replay.py",
    "test_docs.py",
)


@pytest.mark.parametrize("path", FILES)
def test_reference_file_passes_on_the_port(path, tmp_path):
    assert_reference_file(path, tmp_path)
