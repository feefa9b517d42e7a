"""The reference's own test files of real processes, fault tolerance, the
chunk calculus and the windows, unchanged and in place, against the port
(``_torch_reference.py``, ``_torch_alias.py``): one subprocess per file,
with its own timeout.  ``test_device.py`` runs its tests only on the
card, in the ``cuda`` case."""
import pytest

from _torch_reference import DEVICE_CARD_DESELECT, DEVICE_CARD_LEAST, assert_reference_file, run
from _torch_support import require_card

FILES = (
    "test_pt.py",
    "test_fault_tolerance.py",
    "test_chunk_calculus.py",
    "test_kvstore_window.py",
    "test_device.py",
)


@pytest.mark.parametrize("path", FILES)
def test_reference_file_passes_on_the_port(path, tmp_path):
    assert_reference_file(path, tmp_path)


@pytest.mark.cuda
def test_device_file_passes_on_the_card(tmp_path):
    """tests/test_device.py on the card, where the port's DeviceWindow
    exists, without the five tests ``DEVICE_CARD_DESELECT`` names."""
    require_card()
    got = run("test_device.py", tmp_path, DEVICE_CARD_DESELECT, timeout=900)
    print(f"test_device.py through the alias on the card: {got['counts']}")
    assert got["rc"] == 0, got["output"]
    assert got["check"] and got["check"]["ok"], (got["check"], got["output"])
    assert got["counts"].get("passed", 0) >= DEVICE_CARD_LEAST, got["counts"]
