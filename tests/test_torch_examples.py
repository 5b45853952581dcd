"""The port's examples against the reference's: ``quickstart_torch`` and
``policy_authoring_torch`` with ``--cpu`` print the decision lines the
reference's ``examples/quickstart.py`` and ``examples/policy_authoring.py``
print (the in-graph tier's name aside: ``jaxc`` there, ``torch`` here),
and without ``--cpu`` on a machine with no card they stop with
``DeviceError`` instead of running elsewhere.
"""

import os
import re
import subprocess
import sys

import pytest

from repro_torch.device import DeviceError, have_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import policy_authoring_torch  # noqa: E402
import quickstart_torch  # noqa: E402

EXAMPLES = {"quickstart": quickstart_torch,
            "policy_authoring": policy_authoring_torch}
# the lines that carry a decision, a rejection or the state a decision left
DECISION = re.compile(r" -> |REJECT|decisions counted|after reload|histogram")


def _normal(line: str) -> str:
    return re.sub(r"in-graph \([^)]*\)", "in-graph", line).rstrip()


def _reference_lines(name: str) -> list:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "examples", f"{name}.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return [_normal(ln) for ln in r.stdout.splitlines() if DECISION.search(ln)]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_cpu_run_prints_the_reference_decisions(name, capsys):
    run = EXAMPLES[name].main(["--cpu"])
    lines = run["lines"]
    assert run["kernels"] == []
    out = capsys.readouterr().out
    printed = [_normal(ln) for ln in out.splitlines() if DECISION.search(ln)]
    assert [_normal(ln) for ln in lines] == printed
    assert printed == _reference_lines(name)


@pytest.mark.skipif(have_cuda(), reason="checks the machine without a card")
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_without_cpu_flag_needs_the_card(name):
    with pytest.raises(DeviceError):
        EXAMPLES[name].main([])
