"""Smoke-run every ``examples/torch/*.py`` (the port's twins of
``examples/*.py``) on the CPU, and hold what they print against the
reference's examples.

Each twin runs in this process as a script (``runpy`` as ``__main__``,
``sys.argv`` set) with its fastest flags plus ``--device cpu``
(``train_lm`` with a fresh ``--ckpt-dir``: a directory holding a
checkpoint resumes from it), once for the module: the comparisons
reuse its output. ``network_explore --spec`` runs in a subprocess, as a
shell pipes it. The reference's examples run in this process too:
``dse_explore`` and ``network_explore`` print the same lines
(``dse_explore``'s TPU heading says, in the port, whose model it is);
``quickstart``'s sections 1-4 print the same lines, and the port's tiny
training run's loss falls.
"""

import ast
import contextlib
import io
import os
import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

from repro_torch.core.study import Study

REPO = pathlib.Path(__file__).resolve().parents[1]
TWINS = REPO / "examples" / "torch"
CPU = ["--device", "cpu"]

#: every twin and its CI-fast invocation (those of tests/test_examples.py).
#: Adding a twin without registering it here fails
#: test_all_torch_examples_are_covered.
EXAMPLES = {
    "quickstart.py": ["--smoke"],
    "dse_explore.py": ["--m", "64", "--k", "2048", "--n", "147", "--pareto"],
    "network_explore.py": ["--arch", "smollm-135m", "--shape", "decode_32k"],
    "serve_decode.py": ["--arch", "smollm-135m", "--gen-tokens", "8"],
    "train_lm.py": ["--steps", "3", "--smoke"],
}
#: the twin's line that differs from the reference's: its heading names the
#: advisor's TPU model
TPU_HEADING = ("TPU mesh axis of 16 (the 'tiers'):",
               "TPU mesh axis of 16 (the 'tiers'; the advisor's TPU v5e model, not this device):")


def _script(path, args, monkeypatch) -> list:
    """``path ARGS`` run in this process as ``__main__``: its stdout's lines."""
    monkeypatch.setattr(sys, "argv", [str(path), *args])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(path), run_name="__main__")
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """``twin(name)``: the stdout lines of ``examples/torch/<name>`` at its
    registered flags and ``--device cpu``, run once for the module."""
    ckpt = tmp_path_factory.mktemp("train_lm") / "ckpt"
    done = {}

    def run(name):
        if name not in done:
            args = EXAMPLES[name] + (["--ckpt-dir", str(ckpt)] if name == "train_lm.py" else [])
            # one thread: the suite's workers share the cores, and the tiny
            # models' ops oversubscribed take 10-20x as long
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                with pytest.MonkeyPatch.context() as mp:
                    done[name] = _script(TWINS / name, [*args, *CPU], mp)
            finally:
                torch.set_num_threads(threads)
        return done[name]

    return run


def _reference(name, args, monkeypatch):
    """The reference's ``examples/<name>`` run here, its stdout's lines."""
    return _script(REPO / "examples" / name, args, monkeypatch)


def test_all_torch_examples_are_covered():
    on_disk = {p.name for p in TWINS.glob("*.py")}
    assert on_disk == set(EXAMPLES)
    # one twin for each of the reference's examples, named alike
    assert on_disk == {p.name for p in (REPO / "examples").glob("*.py")}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_torch_example_runs_clean(name, twin):
    assert twin(name), f"{name} printed nothing"


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_torch_example_imports_the_port_only(name):
    src = (TWINS / name).read_text()
    assert "repro_torch" in src and "jax" not in src
    assert not [ln for ln in src.splitlines()
                if ln.lstrip().startswith(("import repro", "from repro"))
                and not ln.lstrip().startswith(("import repro_torch", "from repro_torch"))]
    # tensors go to the card unless the caller says otherwise
    assert 'ap.add_argument("--device", default="cuda"' in src


def test_dse_explore_prints_the_reference_lines(monkeypatch, twin):
    want = _reference("dse_explore.py", EXAMPLES["dse_explore.py"], monkeypatch)
    got = twin("dse_explore.py")
    assert want.count(TPU_HEADING[0]) == 1 and got.count(TPU_HEADING[1]) == 1
    assert got == [TPU_HEADING[1] if ln == TPU_HEADING[0] else ln for ln in want]


def test_network_explore_prints_the_reference_lines(monkeypatch, twin):
    want = _reference("network_explore.py", EXAMPLES["network_explore.py"], monkeypatch)
    assert twin("network_explore.py") == want


def test_network_explore_spec_round_trips(monkeypatch):
    """``--spec`` in a subprocess, as ``... --spec | python -m repro_torch
    run -`` takes it; the spec hashes as the reference example's."""
    from repro.core.cache import study_hash as ref_hash
    from repro.core.study import Study as RefStudy
    from repro_torch.core.cache import study_hash

    args = ["--arch", "smollm-135m", "--shape", "decode_32k", "--spec"]
    proc = subprocess.run(
        [sys.executable, str(TWINS / "network_explore.py"), *args, *CPU],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    study = Study.from_json(proc.stdout)
    assert study.workload.arch == "smollm-135m" and study.analysis.kind == "schedule"
    assert study.analysis.device == "cpu" and study.analysis.backend == "torch"
    assert Study.from_json(study.to_json()) == study
    ref = RefStudy.from_json("\n".join(_reference("network_explore.py", args, monkeypatch)))
    assert study_hash(study) == ref_hash(ref)


def test_quickstart_sections_1_to_4_and_its_loss_falls(monkeypatch, twin):
    import repro.launch.train

    # the reference's section 5 trains with JAX: not compared, so not run
    monkeypatch.setattr(repro.launch.train, "train_loop",
                        lambda *a, **k: (None, [1.0, 0.5], None))
    want = _reference("quickstart.py", ["--smoke"], monkeypatch)
    got = twin("quickstart.py")
    n = 7  # sections 1-4: two tau lines, l*, the simulator, two advisor lines, the roofline
    assert want[n].startswith("tiny LM loss")
    assert got[:n] == want[:n]
    first, last = (float(x) for x in got[-1].removeprefix("tiny LM loss: ").split(" -> "))
    assert last < first


def test_train_lm_and_serve_decode_report(twin):
    lines = twin("train_lm.py")
    assert lines[0] == "training smollm-135m-smoke (4L d128) for 3 steps"
    assert lines[-1].startswith("loss: ") and "over 3 steps" in lines[-1]
    serve = twin("serve_decode.py")
    assert serve[0].startswith("smollm-135m-smoke: prefill ")
    assert serve[1].startswith("sample tokens: [") and len(ast.literal_eval(serve[1][15:])) == 8
