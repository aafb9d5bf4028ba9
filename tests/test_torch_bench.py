"""The port's bench (morpheus_tpu_torch/bench.py) against the JAX package's
bench.py: the same operating point (BENCH_POINT_CFG), the same active
levels and occupancy cadence there and at the late point, the epoch loop's
110 real steps; a tiny bench run on the CPU printing every documented
field; and the card-freeing pauses (_pause_full_run, _pause_ab_run), driven
with fake process trees as tests/test_bench_pause.py drives bench.py's,
including a data-parallel rank whose command line does not name the
package, and the pid that morpheus_tpu_torch/scripts/run_ab.sh publishes."""
import copy
import json
import math
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import bench as jbench  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from morpheus_tpu.config import merge_defaults as jax_merge  # noqa: E402
from morpheus_tpu.data import dataset as jax_dataset  # noqa: E402
from morpheus_tpu.data.synthetic import make_synthetic_scene  # noqa: E402
from morpheus_tpu.ops import occupancy as jocc  # noqa: E402
from morpheus_tpu.train import trainer as jax_trainer  # noqa: E402
from morpheus_tpu_torch import bench  # noqa: E402
from morpheus_tpu_torch.ops import occupancy as tocc  # noqa: E402
from morpheus_tpu_torch.train.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

# the bench point cut to CPU size: 4 levels of up to 2^10 rows, 64 rays,
# a 16^3 occupancy grid; the cadence, budgets and payloads kept
TINY = {"model": {"grid_num_levels": 4, "grid_log2_hashmap_size": 10,
                  "grid_desired_resolution": 32},
        "train": {"real_ray_num": 64},
        "tpu": {"occ_resolution": 16, "march_steps": 64,
                "max_samples_per_ray": 16}}

# the fields every bench line carries (the module doc), and the SDS ones
REAL_FIELDS = ("value", "vs_baseline", "steps_per_sec",
               "rays_per_sec_isolated", "rays_per_sec_late",
               "rays_per_sec_epoch_loop", "compile_s", "kernel_build_s",
               "loss", "step_gflops")
SDS_FIELDS = ("sds_step_ms_s05", "sds_step_ms_s02",
              "sds_step_ms_bf16_s05_late")

# the smallest guidance spec with every layer type (tests/torch_parity.py)
SDS_SPEC = dict(image_size=16, unet_channels=32, unet_mult=(1, 2),
                unet_heads=2, context_dim=16, clip_width=32, clip_layers=1,
                clip_heads=2, clip_patch=14, vae_ch=32, vae_mult=(1, 2),
                vae_res_blocks=1)


def test_bench_point_cfg_matches_jax():
    assert bench.BENCH_POINT_CFG == jbench.BENCH_POINT_CFG
    # every key of the merged point is one of the JAX merge's
    jcfg = jax_merge(copy.deepcopy(jbench.BENCH_POINT_CFG))
    tcfg = bench.bench_config()
    assert {s: set(v) for s, v in tcfg.items()} == {
        s: set(v) for s, v in jcfg.items()}
    for s in jbench.BENCH_POINT_CFG:
        for k in jbench.BENCH_POINT_CFG[s]:
            assert tcfg[s][k] == jcfg[s][k]


@pytest.fixture(scope="module")
def pair():
    """A JAX trainer and a port trainer of the bench point at full grid
    width (16 levels) on an 8-frame 16^2 scene."""
    jcfg = jax_merge(copy.deepcopy(jbench.BENCH_POINT_CFG))
    jcfg["tpu"]["occ_resolution"] = 16
    jtr = jax_trainer.Trainer(jcfg, jax_dataset.DeformDataset(
        jcfg, make_synthetic_scene(num_frames=8, H=16, W=16)))
    tcfg = bench.bench_config({"tpu": {"occ_resolution": 16}})
    ttr = Trainer(tcfg, bench.make_dataset(tcfg, 8, 16), device="cpu")
    return jtr, ttr


def _record(module, monkeypatch, bump):
    """Replace module's two occupancy updates by recorders that add `bump`
    to the grid (1 sampled, 2 warm-up) and keep each call's keywords."""
    calls = []

    def sampled(occ, *a, **kw):
        calls.append({k: kw[k] for k in ("sample_fraction", "update_index")})
        return occ._replace(occs=occ.occs + bump(1.0))

    def warm(occ, *a, **kw):
        calls.append({"warm": True})
        return occ._replace(occs=occ.occs + bump(2.0))
    monkeypatch.setattr(module, "update_occupancy_sampled", sampled)
    monkeypatch.setattr(module, "update_occupancy", warm)
    return calls


@pytest.mark.parametrize("epoch,levels", [(300, 10), (1900, 16)])
def test_bench_point_levels_and_occupancy_match_jax(pair, epoch, levels,
                                                    monkeypatch):
    """At epochs 300 and 1900 (global step epoch * 110): the active levels
    equal the JAX trainer's (10 and all 16, the step's field cut to them);
    over 17 steps the refresh fires on the same steps as JAX's, every 16th,
    sampled (past the warm-up) on 1/16 of the cells with the same update
    index."""
    jtr, ttr = pair
    jtr.epoch = epoch
    step = epoch * bench.STEPS_PER_EPOCH
    bench.set_point(ttr, epoch, step)
    assert ttr._active_levels() == jtr._active_levels()
    assert (ttr.step_field.spec.active_levels or 16) == levels
    assert (ttr.global_step, ttr.host_step) == (step, step)

    jcalls = _record(jocc, monkeypatch, lambda v: jnp.float32(v))
    tcalls = _record(tocc, monkeypatch, lambda v: v)
    fired = []
    for s in range(step, step + 17):
        jcalls.clear()
        tcalls.clear()
        j0 = jtr.state.occ
        j1 = jtr._maybe_update_occ(j0, jtr.state.params, None, s,
                                   jnp.float32(0.5))
        t1 = ttr._maybe_update_occ(ttr.occ, s, torch.tensor(0.5),
                                   ttr.draws)
        jk = float(j1.occs[0] - j0.occs[0])
        tk = float(t1.occs[0] - ttr.occ.occs[0])
        assert tk == jk, s
        if tk:
            # JAX traces both branches of its cond; the one that ran is
            # the sampled update at this step's index
            want = {"sample_fraction": 0.0625, "update_index": s // 16}
            assert tcalls == [want] and want in jcalls
            fired.append(s)
    assert fired == [s for s in range(step, step + 17) if s % 16 == 0]
    assert len(fired) == 1


def test_epoch_loop_runs_110_real_steps(pair, monkeypatch):
    """train_one_epoch at the bench's real_freq 10 and n_iters 10 runs 110
    real steps (the virtual slots run real steps without guidance) and
    advances the host step by as many, as the JAX trainer's epoch does
    (its chained dispatch counted by its step count); epoch_loop_step_s
    runs three such epochs. Under tpu.chain_steps (on here, the default)
    every one of them is the port's chained step."""
    jtr, ttr = pair
    steps = []

    def real_step(epoch):
        steps.append(epoch)
        return torch.tensor(0.0)
    assert ttr.chain
    monkeypatch.setattr(ttr, "chained_real_step", real_step)
    monkeypatch.setattr(ttr, "real_step", lambda epoch: 1 / 0)
    monkeypatch.setitem(ttr.config, "train", dict(ttr.config["train"],
                                                  real_freq=10, n_iters=10))
    bench.set_point(ttr, 300, 33000)
    ttr.train_one_epoch()
    assert len(steps) == 110 and ttr.host_step == 33110

    jsteps = []

    def make_real_step(al):
        return lambda state, k, ep: (jsteps.append(1), (state, 0.0))[1]

    def make_chained(al, n):
        def chained(state, key, ep):
            jsteps.extend([1] * n)
            return state, key, 0.0
        return chained
    monkeypatch.setattr(jtr, "_make_real_step", make_real_step)
    monkeypatch.setattr(jtr, "_make_real_steps_chained", make_chained)
    monkeypatch.setattr(jtr, "_make_ema_step", lambda: lambda s: s)
    monkeypatch.setattr(jtr, "_jit_cache", {})
    monkeypatch.setattr(jtr, "config", copy.deepcopy(jtr.config))
    jtr.config["train"].update(real_freq=10, n_iters=10)
    jtr.epoch = 300
    jtr._host_step = 33000
    jtr.train_one_epoch()
    assert len(jsteps) == len(steps) and jtr._host_step == ttr.host_step

    steps.clear()
    assert bench.epoch_loop_step_s(ttr, 300, 33000) > 0
    assert len(steps) == 3 * 110


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


def test_tiny_bench_prints_every_field():
    """The bench on the CPU: 8 frames at 16^2, a 4-level grid, 2 timed steps
    each, BENCH_SDS=0. The headline line first, then a superset of it with
    every SDS variant in sds_skipped; every field finite; no card, so no
    mfu_vs_bf16_peak and a note that says why."""
    lines = []
    out = bench.run_bench(bench.bench_config(TINY), "cpu", frames=8, hw=16,
                          warmup=1, n_chain=2, n_isolated=2, n_late=2,
                          loop_real_freq=1, loop_iters=1, sds_mode="0",
                          emit=lines.append)
    assert len(lines) == 2
    head, last = (json.loads(x) for x in lines)
    assert last == out and head.items() <= last.items()
    assert last["metric"] == "rays_per_sec_per_chip"
    assert last["unit"] == "rays/s" and last["device"] == "cpu"
    for k in REAL_FIELDS:
        assert _finite(last[k]), k
    for k in REAL_FIELDS[:7] + ("step_gflops",):
        assert last[k] > 0, k
    assert last["kernel_build_s"] == 0.0
    assert last["vs_baseline"] == pytest.approx(last["value"] / 30000.0)
    assert last["steps_per_sec"] == pytest.approx(last["value"] / 64)
    assert "mfu_vs_bf16_peak" not in last
    assert "mfu_vs_bf16_peak" in last["notes"]
    assert last["sds_skipped"] == {k: "BENCH_SDS=0" for k in SDS_FIELDS}
    assert "xla_cost_bytes_gb" not in last


def test_tiny_bench_sds_variants():
    """BENCH_SDS=all on the CPU with the smallest guidance spec at 16^2
    (scale 0.5: 64 rays, 0.2: 9): every SDS field finite and positive,
    nothing skipped; a zero budget skips each variant with its reason."""
    from morpheus_tpu_torch.guidance.zero123 import Zero123Spec
    kw = dict(frames=8, hw=16, warmup=1, n_chain=1, n_isolated=1, n_late=1,
              loop_real_freq=1, loop_iters=1, sds_hw=16,
              sds_spec=Zero123Spec(**SDS_SPEC), sds_warmup=1, sds_n=1,
              emit=lambda line: None)
    out = bench.run_bench(bench.bench_config(TINY), "cpu", sds_mode="all",
                          **kw)
    for k in SDS_FIELDS + ("sds_step_ms_bf16_s05", "sds_step_ms_bf16_s02"):
        assert _finite(out[k]) and out[k] > 0, k
    assert "sds_skipped" not in out
    out = bench.run_bench(bench.bench_config(TINY), "cpu", sds_mode="1",
                          budget_s=0.0, **kw)
    assert out["sds_skipped"] == {k: "over 0s budget" for k in SDS_FIELDS}


def test_bench_value_times_the_chained_step(monkeypatch):
    """bench.run_bench's value: chained steps back to back (2 that capture
    and settle, then n_chain timed), as bench.py's value times
    tpu.chain_steps; rays_per_sec_isolated: eager steps, each synchronised."""
    calls = []
    real = bench.run_steps

    def run_steps(trainer, n, sync_each=False, chained=False):
        calls.append((n, sync_each, chained))
        return real(trainer, n, sync_each, chained)
    monkeypatch.setattr(bench, "run_steps", run_steps)
    out = bench.run_bench(bench.bench_config(TINY), "cpu", frames=8, hw=16,
                          warmup=1, n_chain=3, n_isolated=2, n_late=1,
                          loop_real_freq=1, loop_iters=1, sds_mode="0",
                          emit=lambda line: None)
    assert calls[:4] == [(1, False, False), (2, True, False), (2, False, True),
                         (3, False, True)]
    assert all(not c for _, _, c in calls[4:])
    assert _finite(out["value"]) and out["value"] > 0


def test_count_flops_matches_a_hand_count_of_one_layer():
    """FlopCounterMode's count of one MLP layer's forward and backward (the
    input's and the weight's gradients): 2*N*I*O each, 6*N*I*O in all; a
    custom autograd function around a plain copy counts 0."""
    N, I, O = 128, 64, 32
    lin = torch.nn.Linear(I, O)
    x = torch.randn(N, I, requires_grad=True)

    def fwd_bwd():
        lin(x).sum().backward()
    assert bench.count_flops(fwd_bwd) == 6 * N * I * O
    assert bench.count_flops(lambda: lin(x)) == 2 * N * I * O

    class Copy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a.clone()

        @staticmethod
        def backward(ctx, g):
            return g.clone()
    assert bench.count_flops(lambda: Copy.apply(x).sum().backward()) == 0


# ---- card ownership ---------------------------------------------------------

def _state(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return "gone"


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def _kids_named(pid, word):
    return [p for p in bench._children(pid) if word in bench._cmdline(p)]


def test_pause_full_run_terms_trainer_and_its_ranks(tmp_path, monkeypatch):
    """A fake supervisor (its command line names run_full_budget) with a
    `morpheus_tpu_torch` trainer child that has started a rank whose
    command line does not name the package: the supervisor is stopped, the
    trainer and the rank are TERMed, and resume continues the supervisor,
    which then reaps its trainer and exits."""
    rank = tmp_path / "rank_sleeper.py"
    rank.write_text("import time\ntime.sleep(600)\n")
    trainer = tmp_path / "trainer.py"
    trainer.write_text(
        "import subprocess, sys, time\n"
        f"subprocess.Popen([sys.executable, {str(rank)!r}])\n"
        "time.sleep(600)\n")
    script = tmp_path / "fake_run_full_budget.sh"
    script.write_text(
        "#!/bin/bash\n"
        f"{sys.executable} {trainer} morpheus_tpu_torch &\n"
        "wait\n")
    sup = subprocess.Popen(["bash", str(script)])
    try:
        assert _wait(lambda: _kids_named(sup.pid, "morpheus_tpu_torch"))
        (tr,) = _kids_named(sup.pid, "morpheus_tpu_torch")
        assert _wait(lambda: _kids_named(tr, "rank_sleeper"))
        (rk,) = _kids_named(tr, "rank_sleeper")
        assert "morpheus_tpu_torch" not in bench._cmdline(rk)

        pidfile = tmp_path / "fullrun.pid"
        pidfile.write_text(str(sup.pid))
        monkeypatch.setenv("MORPHEUS_PAUSE_GUARD_S", "120")
        resume = bench._pause_full_run(pidfile=str(pidfile))
        assert resume is not None
        assert _state(sup.pid) == "T", "the supervisor must be stopped"
        # both gone (zombies until reaped: their command lines are empty)
        assert "morpheus_tpu_torch" not in bench._cmdline(tr)
        assert _wait(lambda: "rank_sleeper" not in bench._cmdline(rk))

        resume()
        assert _wait(lambda: _state(sup.pid) != "T")
        sup.wait(timeout=10)
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()


def test_pause_full_run_of_a_supervisor_gone_before_the_stop(tmp_path,
                                                             monkeypatch):
    """A supervisor that exits between the pid check and the stop (here a
    reaped process whose command line reads as the supervisor's through a
    patched _cmdline): _pause_full_run raises nothing, returns None, leaves
    no live guard and no resume hook at exit."""
    import atexit
    gone = subprocess.Popen(["true"])
    gone.wait()
    pidfile = tmp_path / "fullrun.pid"
    pidfile.write_text(str(gone.pid))
    monkeypatch.setattr(bench, "_cmdline", lambda pid: (
        "bash run_full_budget.sh" if pid == gone.pid else ""))
    guards, hooks = [], []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        guards.append(real_popen(*a, **kw))
        return guards[-1]
    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(atexit, "register", hooks.append)
    monkeypatch.setattr(atexit, "unregister", hooks.remove)
    monkeypatch.setenv("MORPHEUS_PAUSE_GUARD_S", "120")
    assert bench._pause_full_run(pidfile=str(pidfile)) is None
    assert len(guards) == 1 and guards[0].poll() is not None
    assert hooks == []


def test_pauses_leave_foreign_pids_alone(tmp_path, monkeypatch):
    """A recycled pid is never signalled: this process is alive but names
    neither run_full_budget nor the package; a missing file is no pause;
    the default pid files are read from $TMPDIR or the named variables."""
    pidfile = tmp_path / "x.pid"
    pidfile.write_text(str(os.getpid()))
    assert bench._pause_full_run(pidfile=str(pidfile)) is None
    assert bench._pause_ab_run(pidfile=str(pidfile)) is None
    assert bench._pause_full_run(pidfile=str(tmp_path / "missing")) is None
    assert bench._pause_ab_run(pidfile=str(tmp_path / "missing")) is None
    monkeypatch.setenv("MORPHEUS_AB_PIDFILE", str(pidfile))
    assert bench._pidfile("MORPHEUS_AB_PIDFILE", "ab_run.pid") == str(pidfile)
    monkeypatch.delenv("MORPHEUS_FULLRUN_PIDFILE", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert bench._pidfile("MORPHEUS_FULLRUN_PIDFILE", "fullrun.pid") == \
        str(tmp_path / "fullrun.pid")


def test_run_ab_publishes_its_arm_and_the_pause_stops_it(tmp_path,
                                                          monkeypatch):
    """morpheus_tpu_torch/scripts/run_ab.sh with a fake `python` on PATH:
    the live arm's pid (a `python -m morpheus_tpu_torch ...` command line)
    is in MORPHEUS_AB_PIDFILE; _pause_ab_run stops it and its rank, resume
    continues both; the file is gone once the arms end."""
    fake = tmp_path / "bin"
    fake.mkdir()
    done = tmp_path / "done"
    (fake / "python").write_text(
        "#!/bin/bash\n"
        "sleep 600 &\n"
        f"while [ ! -e {done} ]; do sleep 0.05; done\n"
        "kill $!\n")
    (fake / "python").chmod(0o755)
    pidfile = tmp_path / "ab_run.pid"
    # the script runs from two levels above its own directory: a copy in
    # a tree of its own keeps its workspaces (exp/torch/<arm>) out of the
    # repository
    root = tmp_path / "tree"
    (root / "morpheus_tpu_torch" / "scripts").mkdir(parents=True)
    script = root / "morpheus_tpu_torch" / "scripts" / "run_ab.sh"
    shutil.copy(REPO / "morpheus_tpu_torch" / "scripts" / "run_ab.sh",
                script)
    for arm in ("ab_exact", "ab_shipped"):
        (root / "exp" / "torch" / arm).mkdir(parents=True)
        (root / "exp" / "torch" / arm / "metric_3d.txt").write_text(
            f"Ep_1: {arm}\n")
    env = dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}",
               MORPHEUS_AB_PIDFILE=str(pidfile), MORPHEUS_AB_RESUME="1")
    proc = subprocess.Popen(
        ["bash", str(script)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        assert _wait(lambda: pidfile.exists() and pidfile.read_text().strip())
        arm = int(pidfile.read_text())
        assert "-m morpheus_tpu_torch --config configs/ab_exact.yaml" in \
            bench._cmdline(arm)
        assert _wait(lambda: _kids_named(arm, "sleep 600"))
        (rk,) = _kids_named(arm, "sleep 600")
        monkeypatch.setenv("MORPHEUS_PAUSE_GUARD_S", "120")
        resume = bench._pause_ab_run(pidfile=str(pidfile))
        assert resume is not None
        assert _state(arm) == "T" and _state(rk) == "T"
        resume()
        assert _wait(lambda: _state(arm) not in ("T", "gone")
                     and _state(rk) not in ("T", "gone"))
        done.write_text("")
        text, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, text
        assert "=== ab_exact done" in text and "=== ab_shipped done" in text
        assert "Ep_1: ab_shipped" in text
        assert not pidfile.exists()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_main_keeps_the_pause_switch():
    import inspect
    src = inspect.getsource(bench.main)
    assert "MORPHEUS_BENCH_NO_PAUSE" in src
    assert "_pause_full_run" in src and "_pause_ab_run" in src
