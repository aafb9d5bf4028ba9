"""The port's run tooling (morpheus_tpu_torch/scripts/) driven with a fake
trainer, as tests/test_supervisor.py drives the JAX supervisor: the circuit
breaker escalates MORPHEUS_DEGRADE and opens, checkpoint progress resets its
counter, an external SIGTERM stays progress-neutral, and - the repair of the
port's copy - a trainer that hangs and dies on the watchdog's own signal
(TERM, or KILL 15 s later) is counted, so the breaker opens at
STALL_GIVE_UP_AFTER instead of relaunching forever (the JAX script counts
every rc-143 death as neutral). train_scenes.py launches
`python -m morpheus_tpu_torch` per config and exits 1 when one fails."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "morpheus_tpu_torch" / "scripts"
SCRIPT = SCRIPTS / "run_full_budget.sh"


def _run_supervisor(ws, trainer_cmd, timeout=120, env_extra=None):
    env = dict(os.environ)
    env.update({
        "TRAINER_CMD": trainer_cmd,
        "PROBE_CMD": "true",       # no card probe
        "SLEEP_RETRY": "0",
        "SLEEP_PROBE": "0",
        "WATCH_S": "1",
        "STALL_S": "3600",
        "DEGRADE1_AFTER": "2",
        "DEGRADE2_AFTER": "4",
        "GIVE_UP_AFTER": "6",
    })
    env.update(env_extra or {})
    return subprocess.run(
        ["bash", str(SCRIPT), "unused.yaml", str(ws)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_breaker_escalates_and_opens(tmp_path):
    ws = tmp_path / "ws"
    ws.mkdir()
    attempts = ws / "attempts.txt"
    cmd = f"sh -c 'echo $MORPHEUS_DEGRADE >> {attempts}; exit 1'"
    r = _run_supervisor(ws, cmd)
    assert r.returncode == 1
    # noprog before each launch: 0,1 -> L0; 2,3 -> L1; 4,5 -> L2; then open
    assert attempts.read_text().split() == ["0", "0", "1", "1", "2", "2"]
    log = (ws / "supervisor.log").read_text()
    assert "circuit breaker OPEN" in log
    assert log.count("launching trainer") == 6


def test_progress_resets_counter(tmp_path):
    ws = tmp_path / "ws"
    (ws / "models").mkdir(parents=True)
    attempts = ws / "attempts.txt"
    cmd = (
        "sh -c '"
        f"n=$(ls {ws}/models | wc -l); "
        f"touch {ws}/models/model_ep_$(printf %04d $((n + 1))).pkl; "
        f"echo $MORPHEUS_DEGRADE >> {attempts}; "
        "if [ $n -ge 2 ]; then exit 0; fi; exit 1'"
    )
    r = _run_supervisor(ws, cmd)
    assert r.returncode == 0
    assert attempts.read_text().split() == ["0", "0", "0"]
    log = (ws / "supervisor.log").read_text()
    assert "run COMPLETE" in log
    assert "circuit breaker OPEN" not in log


def test_external_sigterm_deaths_are_progress_neutral(tmp_path):
    """rc 143 from a SIGTERM the supervisor did not send: 4 consecutive
    checkpoint-less deaths neither degrade nor open the breaker."""
    ws = tmp_path / "ws"
    ws.mkdir()
    attempts = tmp_path / "attempts.txt"
    cmd = ("sh -c '"
           f"echo $MORPHEUS_DEGRADE >> {attempts}; "
           f"n=$(wc -l < {attempts}); "
           "if [ $n -ge 5 ]; then exit 0; fi; exit 143'")
    r = _run_supervisor(ws, cmd)
    assert r.returncode == 0
    assert attempts.read_text().split() == ["0"] * 5
    assert "killed=1" not in (ws / "wallclock.txt").read_text()


@pytest.mark.parametrize("dies_on", ["TERM", "KILL"])
def test_watchdog_kills_are_counted_and_open_the_breaker(tmp_path, dies_on):
    """The repair: a trainer that hangs (no CPU, no file) at every launch is
    killed by the tier-1 watchdog; it dies on the TERM (rc 143, which the
    JAX script counts as neutral and relaunches forever) or, ignoring TERM,
    on the KILL 15 s later (rc 137). Each kill counts, the degrade ladder
    stays at 0, and the breaker opens after STALL_GIVE_UP_AFTER kills."""
    ws = tmp_path / "ws"
    ws.mkdir()
    attempts = tmp_path / "attempts.txt"
    hang = ("exec sleep 600" if dies_on == "TERM"
            else "trap \"\" TERM; while :; do sleep 1; done")
    cmd = (f"exec sh -c 'echo $MORPHEUS_DEGRADE >> {attempts}; {hang}'")
    r = _run_supervisor(ws, cmd, timeout=150,
                        env_extra={"STALL_S": "2", "STALL_GIVE_UP_AFTER": "2"})
    assert r.returncode == 1
    assert attempts.read_text().split() == ["0", "0"]
    log = (ws / "supervisor.log").read_text()
    assert log.count("stall: no cpu/file progress") == 2
    assert "circuit breaker OPEN: 0 consecutive failures and 2 watchdog" \
        in log
    rc = "143" if dies_on == "TERM" else "137"
    rows = (ws / "wallclock.txt").read_text().splitlines()
    assert len(rows) == 2
    assert all(f"rc={rc} " in r and r.endswith("killed=1") for r in rows)


def test_watchdog_kill_then_progress_completes(tmp_path):
    """Checkpoint progress resets the kill count: under a cap of two kills,
    a run that hangs, makes progress, hangs again and then completes is
    relaunched to its end."""
    ws = tmp_path / "ws"
    (ws / "models").mkdir(parents=True)
    attempts = tmp_path / "attempts.txt"
    cmd = ("exec sh -c '"
           f"echo x >> {attempts}; n=$(wc -l < {attempts}); "
           f"if [ $n -eq 2 ]; then touch {ws}/models/model_ep_0001.pkl; "
           "exit 1; fi; if [ $n -ge 4 ]; then exit 0; fi; exec sleep 600'")
    r = _run_supervisor(ws, cmd, timeout=150,
                        env_extra={"STALL_S": "2", "STALL_GIVE_UP_AFTER": "2"})
    # kill (1), progress (reset), kill (1), complete
    assert r.returncode == 0, (ws / "supervisor.log").read_text()
    assert len(attempts.read_text().split()) == 4
    assert "run COMPLETE" in (ws / "supervisor.log").read_text()


def test_train_scenes_exits_1_when_one_config_fails(tmp_path, monkeypatch,
                                                   capsys):
    """The fan-out runs every config, `--parallel` at a time, as
    `python -m morpheus_tpu_torch --config <cfg> <extra>`, and exits 1 when
    any trainer fails (here the trainer is replaced by a process that
    exits 3 for bad.yaml); the real launch of a config that does not exist
    fails and is counted."""
    from morpheus_tpu_torch.scripts import train_scenes
    launched = []
    real_popen = subprocess.Popen

    def fake_popen(cmd, env=None):
        launched.append(cmd)
        assert cmd[1:4] == ["-m", "morpheus_tpu_torch", "--config"]
        assert str(REPO) in env["PYTHONPATH"].split(os.pathsep)
        code = 3 if cmd[4] == "bad.yaml" else 0
        return real_popen([sys.executable, "-c", f"raise SystemExit({code})"])

    monkeypatch.setattr(train_scenes.subprocess, "Popen", fake_popen)
    assert train_scenes.main(["a.yaml", "bad.yaml", "c.yaml", "--parallel",
                              "2", "--extra", "--device", "cpu"]) == 1
    assert [c[4:] for c in launched] == [[n, "--device", "cpu"] for n in
                                         ("a.yaml", "bad.yaml", "c.yaml")]
    assert "[fail] exit 3" in capsys.readouterr().out
    assert train_scenes.main(["a.yaml", "c.yaml"]) == 0
    monkeypatch.undo()

    r = subprocess.run([sys.executable, str(SCRIPTS / "train_scenes.py"),
                        str(tmp_path / "missing.yaml"), "--extra",
                        "--device", "cpu"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1, r.stderr
    assert "[fail] exit 1" in r.stdout
    assert "missing.yaml" in r.stderr
