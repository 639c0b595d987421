"""The port's single-process checkpoint, on the CPU: the cases of the JAX
package's checkpoint tests (``tests/test_models.py``) against the port's
own ``models/checkpoint.py``, a CLI killed after its first promoted save
and started again, and one trajectory across the packages.

On the CPU a step is deterministic, so a restored run continues the
uninterrupted one bit for bit; the trajectory across packages is held to
1e-6 relative (fp32 sums in different orders).
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeshare_tpu.models.common import run_training as jax_run_training
from kubeshare_tpu.ops.fused_adam import fused_adam as jax_fused_adam
from kubeshare_tpu_torch.attach import RemoteTensor
from kubeshare_tpu_torch.models import checkpoint as ck
from kubeshare_tpu_torch.models import common, mnist, tinymlp
from kubeshare_tpu_torch.ops.fused_adam import fused_adam
from kubeshare_tpu_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _setup(model, seed=0):
    """Params, optimizer state, step function and batch of ``model`` on
    the CPU, as ``run_training`` makes them."""
    params = common.to_device(model.init(seed), "cpu")
    opt = fused_adam(LR)
    return (params, opt.init(params), common.make_train_step(model.loss_fn,
                                                             opt),
            common.to_device(model.batch_fn(seed + 1), "cpu"))


def _likes(model):
    """Like-trees with values unlike any saved (restore discards them)."""
    params, state, _, _ = _setup(model, seed=9)
    return params, state


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _cli(model, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    return [sys.executable, "-m", f"kubeshare_tpu_torch.models.{model}",
            "--device", "cpu", *args], env


def test_checkpoint_save_resume_roundtrip(tmp_path):
    """6 steps straight against 3, a save, a restore into garbage-valued
    like-trees and 3 more: the same params, bit for bit."""
    p1, s1, step, batch = _setup(mnist)
    for _ in range(6):
        p1, s1, _ = step(p1, s1, batch)

    p2, s2, _, _ = _setup(mnist)
    for _ in range(3):
        p2, s2, _ = step(p2, s2, batch)
    ck.save_checkpoint(tmp_path / "ckpt", p2, s2, step=3)
    like_p, like_s = _likes(mnist)
    p3, s3, at = ck.load_checkpoint(tmp_path / "ckpt", like_p, like_s)
    assert at == 3
    for _ in range(3):
        p3, s3, _ = step(p3, s3, batch)
    _assert_trees_equal(p1, p3)
    _assert_trees_equal(s1, s3)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(tmp_path / "nope", like_p, like_s)


def _roundtrip(tmp_path, params, opt_state, step=5):
    """Save, then load into zero-valued like-trees: the loaded trees."""
    ck.save_checkpoint(tmp_path / "ckpt", params, opt_state, step=step)
    like = tree_map(torch.zeros_like, (params, opt_state))
    p, s, at = ck.load_checkpoint(tmp_path / "ckpt", *like)
    assert at == step
    _assert_trees_equal(opt_state, s)
    _assert_trees_equal(params, p)
    return p, s


def test_checkpoint_roundtrips_adam_slots_and_count(tmp_path):
    """Fused Adam's two moment trees and its count, a float32 scalar on
    the parameters' device, keep their values and dtypes."""
    params, state, step, _ = _setup(tinymlp)
    for i in range(4):
        batch = common.to_device(tinymlp.batch_fn(i), "cpu")
        params, state, _ = step(params, state, batch)
    _, s = _roundtrip(tmp_path, params, state)
    assert s["count"].dtype == torch.float32 and s["count"].shape == ()
    assert float(s["count"]) == 4.0
    assert float(s["nu"]["fc1"]["w"].abs().max()) > 0


def test_checkpoint_roundtrips_mixed_dtypes_and_empty_leaves(tmp_path):
    """bf16 moments, an int32 count, fp32 params and a zero-length leaf
    (the layout format keeps it as it is)."""
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
              "h": torch.ones((2, 2), dtype=torch.bfloat16)}
    opt_state = {"mu": {"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16),
                        "h": torch.zeros((2, 2), dtype=torch.bfloat16)},
                 "count": torch.tensor(7, dtype=torch.int32),
                 "empty": torch.zeros((0, 4))}
    _, s = _roundtrip(tmp_path, params, opt_state, step=7)
    assert s["empty"].shape == (0, 4)
    assert s["mu"]["w"].dtype == torch.bfloat16
    assert s["count"].dtype == torch.int32 and int(s["count"]) == 7


def test_numpy_like_trees_restore_to_host_tensors(tmp_path):
    """Like-trees of numpy arrays (an ``init()`` as it comes) give CPU
    tensors of their dtypes."""
    params = common.to_device(tinymlp.init(3), "cpu")
    ck.save_checkpoint(tmp_path / "ckpt", params, {}, step=2)
    p, s, at = ck.load_checkpoint(tmp_path / "ckpt", tinymlp.init(0), {})
    assert at == 2 and s == {}
    _assert_trees_equal(params, p)


class _Shim:
    """A proxy-mode shim whose ``fetch`` returns the buffer's host array
    and records the fetch."""

    def __init__(self):
        self.fetched = []

    def fetch(self, buf):
        self.fetched.append(buf.name)
        return buf.value


class _Buf:
    def __init__(self, name, value):
        self.name, self.value = name, value
        self.shape, self.dtype = value.shape, "float32"


def test_proxy_mode_leaves_are_read_to_host_on_save(tmp_path):
    """A ``RemoteTensor`` leaf is fetched from the proxy and saved as its
    bytes, as the JAX package materializes its remote arrays."""
    shim = _Shim()
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    params = {"w": RemoteTensor(shim, _Buf("w", w)),
              "b": torch.ones(3)}
    ck.save_checkpoint(tmp_path / "ckpt", params, {}, step=1)
    assert shim.fetched == ["w"]
    p, _, _ = ck.load_checkpoint(tmp_path / "ckpt",
                                 {"w": torch.zeros(2, 3),
                                  "b": torch.zeros(3)}, {})
    np.testing.assert_array_equal(p["w"].numpy(), w)
    assert torch.equal(p["b"], torch.ones(3))


def test_cli_resume_skips_done_steps(tmp_path):
    """``--checkpoint`` on the model CLI: a rerun with the same arguments
    resumes and runs only the steps left, here none."""
    cmd, env = _cli("tinymlp", "--steps", "6", "--checkpoint",
                    str(tmp_path / "ck"))
    out1 = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120, check=True)
    assert "tinymlp: 6 steps in" in out1.stdout
    assert "resumed" not in out1.stdout
    out2 = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120, check=True)
    assert "tinymlp: resumed at step 6" in out2.stdout
    assert "tinymlp: 0 steps in" in out2.stdout   # all done


def test_async_checkpoint_writer_matches_sync(tmp_path):
    """The async writer commits the state the sync path does; a newer save
    supersedes the one in flight, and close() commits the last."""
    p, s, step, batch = _setup(mnist)
    with ck.AsyncCheckpointWriter() as w:
        for i in range(1, 4):
            p, s, _ = step(p, s, batch)            # in place on p and s
            w.save(tmp_path / "async", p, s, step=i)
    ck.save_checkpoint(tmp_path / "sync", p, s, step=3)
    like_p, like_s = _likes(mnist)
    pa, sa, at = ck.load_checkpoint(tmp_path / "async", like_p, like_s)
    ps, ss, st = ck.load_checkpoint(tmp_path / "sync", like_p, like_s)
    assert at == st == 3
    _assert_trees_equal((pa, sa), (ps, ss))
    _assert_trees_equal((pa, sa), (p, s))


def test_async_save_snapshots_before_the_next_in_place_step(tmp_path):
    """``save`` copies the state off the live buffers before it returns:
    the step after it, which updates p, m and v in place, does not reach
    the checkpoint."""
    p, s, step, batch = _setup(tinymlp)
    p, s, _ = step(p, s, batch)
    want = tree_map(torch.clone, (p, s))
    with ck.AsyncCheckpointWriter() as w:
        w.save(tmp_path / "ck", p, s, step=1)
        for _ in range(3):
            p, s, _ = step(p, s, batch)
    got_p, got_s, _ = ck.load_checkpoint(tmp_path / "ck", *_likes(tinymlp))
    _assert_trees_equal((got_p, got_s), want)


def test_run_training_overlapped_checkpoints_resume(tmp_path):
    """``checkpoint_every`` saves through the async writer inside the
    timed loop; the committed state resumes exactly, with no warm-up."""
    ckpt = str(tmp_path / "ck")
    r1 = common.run_training(tinymlp.init, tinymlp.loss_fn, tinymlp.batch_fn,
                             4, checkpoint=ckpt, checkpoint_every=2,
                             warmup=1, device="cpu")
    assert r1.steps == 4 and r1.start_step == 0 and r1.warmup_steps == 1
    r2 = common.run_training(tinymlp.init, tinymlp.loss_fn, tinymlp.batch_fn,
                             4, checkpoint=ckpt, checkpoint_every=2,
                             warmup=1, device="cpu")
    assert r2.steps == 0 and r2.start_step == 4 and r2.warmup_steps == 0
    r3 = common.run_training(tinymlp.init, tinymlp.loss_fn, tinymlp.batch_fn,
                             7, checkpoint=ckpt, checkpoint_every=2,
                             warmup=1, device="cpu")
    # 3 steps left: the final save covers step 7, which no in-loop save did
    assert r3.steps == 3 and r3.start_step == 4
    _, state, at = ck.load_checkpoint(ckpt, *_likes(tinymlp))
    assert at == 7 and float(state["count"]) == 1 + 7


class _HeldSave:
    """``_dcp()`` whose ``save`` waits for ``release`` before it writes:
    a write held in flight."""

    def __init__(self):
        self.release = threading.Event()
        self.dcp = ck._dcp()

    def save(self, *args, **kwargs):
        assert self.release.wait(60)
        self.dcp.save(*args, **kwargs)

    def load(self, *args, **kwargs):
        self.dcp.load(*args, **kwargs)


def _partial(path: Path, p, s, step: int) -> None:
    """A directory as a killed write leaves it: DCP's data files, and no
    ``.metadata``, which DCP writes last."""
    ck._dcp().save(ck._state_dict(p, s, step), checkpoint_id=str(path),
                   no_dist=True)
    (path / ".metadata").unlink()
    assert any(path.iterdir())


def test_async_writer_durability_and_staging_fallback(tmp_path,
                                                      monkeypatch):
    """The previous good checkpoint survives a save in flight, and the
    writer's thread promotes a save as soon as its write has committed.
    A crash inside the promote's renames still restores: load falls back
    to the committed staging directory."""
    p, s, _, _ = _setup(mnist)
    like = _likes(mnist)
    ckpt = tmp_path / "ck"

    w = ck.AsyncCheckpointWriter()
    w.save(ckpt, p, s, step=1)
    w.wait()                               # written, committed, promoted
    held = _HeldSave()
    monkeypatch.setattr(ck, "_dcp", lambda: held)
    w.save(ckpt, p, s, step=2)             # held before its first byte
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 1, "the main checkpoint must stay whole during a write"
    held.release.set()
    w.close()
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 2
    assert sorted(os.listdir(tmp_path)) == ["ck"]

    # the promote's window: only the committed staging sibling exists
    ck2 = tmp_path / "ck2"
    ck._write(str(ck2), ck._state_dict(p, s, 7))
    os.rename(ck2, str(ck2) + ".staging")
    _, _, at = ck.load_checkpoint(ck2, *like)
    assert at == 7


def test_a_failed_write_raises_at_the_next_call(tmp_path, monkeypatch):
    def broken(path, state):
        raise OSError("disk full")

    p, s, _, _ = _setup(tinymlp)
    monkeypatch.setattr(ck, "_write", broken)
    w = ck.AsyncCheckpointWriter()
    w.save(tmp_path / "ck", p, s, step=1)            # returns: in flight
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.close()                                        # nothing left to raise
    assert not os.path.exists(tmp_path / "ck")


def test_a_failed_dcp_write_keeps_the_good_checkpoint(tmp_path,
                                                      monkeypatch):
    """A write that fails inside DCP reaches the writer as DCP's
    ``CheckpointException``, a ``BaseException``: the next call raises
    it, nothing is promoted, the earlier checkpoint still loads, and a
    later save goes through."""
    from torch.distributed.checkpoint import FileSystemWriter
    from torch.distributed.checkpoint.api import CheckpointException

    p, s, _, _ = _setup(tinymlp)
    like = _likes(tinymlp)
    ckpt = tmp_path / "ck"
    w = ck.AsyncCheckpointWriter()
    w.save(ckpt, p, s, step=1)
    w.wait()

    def no_space(self, plan, planner):
        raise OSError(28, "No space left on device")

    with monkeypatch.context() as m:
        m.setattr(FileSystemWriter, "write_data", no_space)
        w.save(ckpt, p, s, step=2)
        with pytest.raises(CheckpointException):
            w.wait()
        w.save(ckpt, p, s, step=3)                   # fails the same way
        with pytest.raises(CheckpointException):
            w.close()
        with pytest.raises(CheckpointException):
            ck.save_checkpoint(ckpt, p, s, step=4)
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 1
    assert not os.path.exists(str(ckpt) + ".staging")
    w.save(ckpt, p, s, step=5)
    w.close()
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 5
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_a_partial_write_is_never_loaded(tmp_path):
    """Directories that a write killed half-way leaves (data files, no
    ``.metadata``) count as missing: with no committed checkpoint the CLI
    starts fresh, and beside a committed one it resumes from that."""
    p, s, _, _ = _setup(tinymlp)
    like = _likes(tinymlp)
    ckpt = tmp_path / "ck"
    _partial(Path(str(ckpt) + ".staging"), p, s, 3)
    _partial(Path(str(ckpt) + ".staging.tmp"), p, s, 4)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(ckpt, *like)
    _partial(ckpt, p, s, 5)
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(ckpt, *like)

    cmd, env = _cli("tinymlp", "--steps", "2", "--checkpoint", str(ckpt))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=120, check=True)
    assert "resumed" not in out.stdout
    assert "tinymlp: 2 steps in" in out.stdout
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 2

    _partial(Path(str(ckpt) + ".staging"), p, s, 3)
    cmd, env = _cli("tinymlp", "--steps", "4", "--checkpoint", str(ckpt))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=120, check=True)
    assert "tinymlp: resumed at step 2" in out.stdout
    assert "tinymlp: 2 steps in" in out.stdout
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 4
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_a_save_after_resuming_from_staging_keeps_that_state(tmp_path,
                                                             monkeypatch):
    """A pod that resumed from the staging sibling (a crash between the
    promote's renames) keeps that state through its next save: a save
    that fails leaves it loadable, and one that succeeds replaces it."""
    from torch.distributed.checkpoint import FileSystemWriter

    p, s, _, _ = _setup(tinymlp)
    like = _likes(tinymlp)
    ckpt = tmp_path / "ck"
    ck.save_checkpoint(ckpt, p, s, step=6)
    os.rename(ckpt, str(ckpt) + ".staging")

    def no_space(self, plan, planner):
        raise OSError(28, "No space left on device")

    with monkeypatch.context() as m:
        m.setattr(FileSystemWriter, "write_data", no_space)
        with pytest.raises(BaseException, match="No space"):
            ck.save_checkpoint(ckpt, p, s, step=8)
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 6
    ck.save_checkpoint(ckpt, p, s, step=8)
    _, _, at = ck.load_checkpoint(ckpt, *like)
    assert at == 8
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def _wait_for_dir(path: Path, proc, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not path.is_dir():
        assert proc.poll() is None, "the run ended before its first save"
        assert time.monotonic() < deadline, "no promoted save"
        time.sleep(0.01)


def test_a_killed_cli_resumes_at_its_saved_step(tmp_path):
    """The opportunistic tier's sweep: ``--checkpoint-every`` on mnist,
    SIGKILLed once its first save is promoted, then started again with
    the same arguments. It resumes at the checkpoint's step with no
    warm-up, runs the steps left, and ends on the uninterrupted run's
    params and Adam state, bit for bit (the CPU's steps are
    deterministic)."""
    steps, every = 30, 5
    kill_ck, full_ck = tmp_path / "killed", tmp_path / "full"
    cmd, env = _cli("mnist", "--steps", str(steps), "--checkpoint",
                    str(kill_ck), "--checkpoint-every", str(every))
    full_cmd, _ = _cli("mnist", "--steps", str(steps), "--checkpoint",
                       str(full_ck), "--checkpoint-every", str(every))
    full = subprocess.Popen(full_cmd, env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    victim = subprocess.Popen(cmd, env=env, cwd=ROOT,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    try:
        _wait_for_dir(kill_ck, victim)
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        full_out, full_err = full.communicate(timeout=300)
    finally:
        for proc in (victim, full):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert full.returncode == 0, full_err
    like = _likes(mnist)
    _, _, saved = ck.load_checkpoint(kill_ck, *like)
    assert saved > 0 and saved % every == 0 and saved < steps

    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"mnist: resumed at step {saved} from {kill_ck}, 0 warm-up " \
        "steps" in out.stdout
    assert f"mnist: {steps - saved} steps in" in out.stdout
    p, s, at = ck.load_checkpoint(kill_ck, *like)
    fp, fs, fat = ck.load_checkpoint(full_ck, *like)
    assert at == fat == steps
    assert float(s["count"]) == float(fs["count"]) == 2 + steps
    _assert_trees_equal((p, s), (fp, fs))
    assert out.stdout.split("final loss")[-1] == \
        full_out.split("final loss")[-1]


def test_a_trajectory_across_the_packages(tmp_path):
    """The JAX ``run_training`` for 6 steps against the port's 3 steps, a
    checkpoint, a restore and 3 more, from the same params and batch
    (tinymlp, fp32, fused Adam on both, 2 warm-up steps each): the final
    losses agree to 1e-6 relative."""
    params = tinymlp.init(4)
    batch = tinymlp.batch_fn(5)
    from kubeshare_tpu.models import tinymlp as jtiny

    jres = jax_run_training(
        lambda key: jax.tree_util.tree_map(jnp.asarray, params),
        jtiny.loss_fn, lambda key: tuple(jnp.asarray(a) for a in batch),
        6, optimizer=jax_fused_adam(LR))
    ckpt = str(tmp_path / "ck")
    run = lambda n: common.run_training(
        lambda seed: params, tinymlp.loss_fn, lambda seed: batch, n,
        learning_rate=LR, checkpoint=ckpt, device="cpu")
    first, second = run(3), run(6)
    assert (first.steps, second.start_step, second.steps) == (3, 3, 3)
    assert second.warmup_steps == 0
    assert second.final_loss == pytest.approx(jres.final_loss, rel=1e-6)
    assert second.final_loss < first.first_loss
