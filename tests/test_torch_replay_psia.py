"""The replay fixture at the paper's PSIA size, from both packages.

``fixtures/torch_replay_psia.json`` is written by the JAX package
(``python tests/_torch_replay_cases.py``) and read by ``chip_smoke.py`` on
the card's machine, which has no JAX.  Here the gss entry -- a sim trace
of 288,000 images over 288 PEs of the 2:1 mix, its calibrated percent
error and the full-N ranking of all 13 techniques -- is made anew by
``repro`` and by ``repro_torch`` and must equal the committed file.
"""
import json

import pytest

from _torch_replay_cases import (
    FIXTURE, FIXTURE_VERSION, PSIA_TECHNIQUES, pkg, psia_entry)


@pytest.fixture(scope="module")
def fixture():
    data = json.loads(FIXTURE.read_text())
    assert data["version"] == FIXTURE_VERSION
    assert tuple(data["traces"]) == PSIA_TECHNIQUES
    return data


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_psia_gss_entry_equals_the_fixture(package, fixture):
    entry = psia_entry(pkg(package), "gss")
    assert entry == fixture["traces"]["gss"]
    assert len(entry["ranking"]) == 13
    assert entry["ranking"][0][0] == "ss" and entry["ranking"][-1][0] == "static"
