"""The model-plane examples' ports (``examples/*_torch.py``) on the CPU
(``--device cpu``), each run in a subprocess, beside the reference where
a line is compared: quickstart, serving and end-to-end training with a
checkpoint and its resume."""
import math
import re

from _torch_support import run_examples


def test_quickstart_matches_reference():
    port, ref = run_examples(("quickstart_torch.py", ("--device", "cpu")),
                             ("quickstart.py", ()))
    p_lines, r_lines = port.splitlines(), ref.splitlines()
    assert p_lines[:2] == r_lines[:2]  # the chunk calculus, byte for byte
    claims = [re.search(r"(\d+) claims partition", out)[1] for out in (port, ref)]
    assert claims[0] == claims[1]
    assert p_lines[-1] == "quickstart OK"
    first, last = map(float, re.search(r"^loss: ([\d.]+) -> ([\d.]+)$", port, re.M).groups())
    ref_first = float(re.search(r"^loss: ([\d.]+) ->", ref, re.M)[1])
    assert last < first
    # both packages start above ln 128 (their inits' logits are not zero):
    # the port's first loss is held to the reference's
    assert abs(first - ref_first) < 0.15 and first > math.log(128)


def test_serve_dls_matches_reference():
    port, ref = run_examples(("serve_dls_torch.py", ("--device", "cpu")),
                             ("serve_dls.py", ()))
    p_lines, r_lines = port.splitlines(), ref.splitlines()
    assert p_lines[0] == r_lines[0]  # the request stream: p50 and max
    batchers = [ln for ln in p_lines if "makespan=" in ln]
    assert [ln.split(":")[0].split("->")[0].strip() for ln in batchers] == [
        "gss", "fac2", "ss", "auto"]
    chosen = re.match(r"auto->(\w+)", batchers[-1])[1]
    from repro_torch.core import TECHNIQUES

    assert chosen in TECHNIQUES
    assert p_lines[-1] == r_lines[-1] == "[serve_dls] real generation OK: (4, 12)"


def test_train_e2e_checkpoints_and_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    args = ("--preset", "small", "--ckpt", ckpt, "--device", "cpu")
    (first,) = run_examples(("train_e2e_torch.py", (*args, "--steps", 26)))
    m = re.search(r"^\[e2e\] loss ([\d.]+) -> ([\d.]+) over (\d+) steps this run$", first, re.M)
    assert int(m[3]) == 26 and float(m[2]) < float(m[1])
    assert "resumed" not in first
    # the periodic checkpoint (every 25 steps) and the final one
    assert sorted(p.name for p in ckpt.glob("step_*")) == ["step_000000025", "step_000000026"]
    (second,) = run_examples(("train_e2e_torch.py", (*args, "--steps", 30)))
    # the trainer saves at its last step too: the re-run resumes there
    assert re.search(r"^\[trainer\] resumed at step 26,", second, re.M)
    assert re.search(r"over 4 steps this run$", second, re.M)
