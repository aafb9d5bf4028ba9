"""The SDS prior as a file found by its kind's name (inputs.load_prior): a
prior under another name, in another directory, runs a cell to the same
compared numbers; the weights a prior makes from a seed; and a
configuration that names a missing prior is refused before set-up."""
import hashlib
import os

import pytest

from harness_tiny import metrics, tiny

SEED = 2 ** 31 + 4242
# the SHA-256 of the tiny Zero123 weights at SEED, names and float32 bytes in
# the names' order: any change to the weights' draws or their order moves it
TINY_DIGEST = \
    "00a6e1a5a4062e74e7016253dc22bfb5154bfdcc8b5cb1d04301b23c13fbebf8"

STANDIN = '''"""The Zero123 prior under another name."""
import importlib.util
import os

from benchmark import inputs

_spec = importlib.util.spec_from_file_location(
    "zero123_prior", os.path.join(os.path.dirname(inputs.__file__),
                                  "guidance", "zero123.py"))
_prior = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_prior)
CALLS = []


def _counted(name):
    def call(*args, **kwargs):
        CALLS.append(name)
        return getattr(_prior, name)(*args, **kwargs)
    return call


TINY_SPEC, spec = _prior.TINY_SPEC, _prior.spec
for _name in ("state", "program", "reference", "release", "conditioning",
              "views", "loss"):
    globals()[_name] = _counted(_name)
'''


def run(cell, cfg):
    from benchmark import harness
    return harness.run_cell(cell, SEED, 0.1, False, "cpu", cfg=cfg,
                            metrics=metrics())


def test_a_prior_under_another_name_runs_the_cell(tmp_path, monkeypatch):
    from benchmark import inputs
    cell, cfg = tiny("snoopy_sds.e300")
    want = run(cell, cfg)["compared"]
    (tmp_path / "standin.py").write_text(STANDIN)
    monkeypatch.setattr(inputs, "PRIORS", str(tmp_path))
    cfg["guidance"]["model"] = ["standin"]
    cell["standin_spec"] = cell.pop("zero123_spec")
    calls = []
    load = inputs.load_prior

    def recorded(kind):
        mod = load(kind)
        calls.append(mod.CALLS)
        return mod
    monkeypatch.setattr(inputs, "load_prior", recorded)
    r = run(cell, cfg)
    assert r["correct"], r["compared"]
    assert r["compared"] == want
    used = {name for c in calls for name in c}
    assert used == {"state", "program", "reference", "release",
                    "conditioning", "views", "loss"}


def test_tiny_weights_are_the_seeds():
    from benchmark import inputs
    prior = inputs.load_prior("zero123")
    state = inputs.prior_state("zero123", prior.TINY_SPEC, SEED, "cpu")
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == TINY_DIGEST


def test_a_missing_prior_is_refused_before_set_up(monkeypatch):
    from benchmark import harness, inputs
    cell, cfg = tiny("snoopy_sds.e300")
    cfg["guidance"]["model"] = ["nosuchprior"]

    def set_up(*args, **kwargs):
        raise AssertionError("set-up ran")
    monkeypatch.setattr(harness, "run_program", set_up)
    with pytest.raises(FileNotFoundError) as e:
        run(cell, cfg)
    assert os.path.join(inputs.PRIORS, "nosuchprior.py") in str(e.value)
