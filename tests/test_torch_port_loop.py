"""The PyTorch port's train loop held against the JAX package's on the CPU.

One initial checkpoint, written by the port's writer from the JAX
package's initial weights (`from_jax_variables`), starts both loops:
`monkeynet_tpu.tasks.train_loop.train` reads it through its `load_any`, the
port's `train(device="cpu")` through `Trainer.load_state_dict`. Both run 2
epochs of 2 steps over the same stacked-PNG dataset at the train-test
widths of tests/torch_port_common.py (16^2 frames, batch 4), then both
resume from the port's epoch-0 checkpoint.

Tolerances: `log.txt` prints 5 decimals, so its losses are held to 1e-4
relative plus one unit of the last printed digit (1e-5). Final parameters
use the bound of test_torch_port_train.py's Adam test, per step: where
noise flips the sign of a near-zero gradient an Adam step can differ by
2 * lr, so after n steps a parameter is held to 2 * lr * n (plus 1e-6), and
so are the batch-norm running statistics, which such parameters feed; at
least 98% of the parameter entries must agree to 1e-6.

The resumed run past the replayed epoch is held to the JAX package's own
spread. The port's CPU steps are not the same bit for bit at every thread
count (PyTorch's CPU reductions split by thread; the JAX package's steps
were the same at 1, 2, 4 and 8 threads), so the epoch-0 checkpoint both
resumes start from changes with the thread count by rounding, and by up to
2 * lr in the biases of convolutions that feed a batch norm. The train
step's gradient has kinks: a ReLU input at 9e-5 in the generator's
refinement block crosses zero under a relative change of 1e-6 in the
parameters, which moves the kp detector's gradient by 6%. From one such
checkpoint to the next, the JAX package's resumed run crosses a kink or
not. Over 28 resumes (1, 2, 4 and 8 threads, each from the checkpoint as
written and from six copies with every parameter scaled by 1 + 1e-7 *
noise) its rows 0 to 3 after the resume part from each other by up to 0,
1e-5, 1e-5 and 9e-5, and over 8 resumed steps by 1e-5, 9e-5, 2.6e-4,
1.2e-4, 2.0e-4 and 3.0e-4 at rows 2 to 7 (at most 8.7e-5 a step past row
1), while the port's rows agree within one printed unit. So the replayed
epoch's two rows (0 and 1) keep the tolerance above, and a later row r is
held to 1e-4 relative plus 1e-5 + RESUME_SPREAD_PER_STEP * (r - 1). In the
resumed run's final parameters RESUMED_SHARE of the entries, not 98%, must
agree to 1e-6: a crossed kink moves whole tensors a little (shares of
0.9145-0.9148 where the run crossed one, 0.9914-0.9922 where not, at
this test's 4 resumed steps; down to 0.537 over 8); the 2 * lr * n bound
on every entry stays.
"""

from __future__ import annotations

import copy
import os
import re

import numpy as np
import pytest

import jax
import torch

import monkeynet_tpu.tasks.build as jbuild
import monkeynet_tpu.tasks.train as jtrain
import monkeynet_tpu.tasks.train_loop as jloop
import monkeynet_tpu_torch.tasks.train_loop as tloop
from monkeynet_tpu.data.dataset import FramesDataset as JFramesDataset
from monkeynet_tpu.utils.checkpoint import load_any
from monkeynet_tpu_torch.data.dataset import FramesDataset as TFramesDataset
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.tasks.train import MODEL_NAMES, Trainer
from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, save_checkpoint
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import (
    init_models_once,
    jax_variables,
    port_train_models,
    train_config,
)

HW = 16
EPOCHS = 2
STEPS_PER_EPOCH = 2
LOG_LINE = re.compile(r"^(\d+)\) (.*); steps/s - [\d.na]+$")
# The JAX package's resumed rows past the replayed epoch, and the share of
# the resumed run's parameter entries within 1e-6 (module docstring).
RESUME_SPREAD_PER_STEP = 1.5e-4
RESUMED_SHARE = 0.85


def _config(root):
    config = train_config()
    config["dataset_params"] = {
        "root_dir": root,
        "image_shape": [HW, HW, 3],
        "augmentation_params": {
            "flip_param": {"time_flip": True, "horizontal_flip": True},
            "crop_param": {"size": [HW, HW]},
        },
    }
    config["train_params"].update(num_epochs=EPOCHS, epoch_milestones=[1])
    config["train_params"]["log_params"] = {"log_freq_iter": 1, "cpk_freq_epoch": 1}
    config["visualizer_params"] = {"kp_size": 1, "draw_border": True}
    return config


def _recording(loader_cls, drawn):
    """A loader class that records the epochs its stream yields (the JAX
    package's train() does not report them)."""

    class Recording(loader_cls):
        def stream(self, num_epochs):
            for ep, batch in super().stream(num_epochs):
                if ep not in drawn:
                    drawn.append(ep)
                yield ep, batch

    return Recording


def _restore_adam_moments_unshared(opt_state, step, mu, nu):
    """`restore_adam_moments` with a buffer of its own for every counted
    transform. The JAX package's version puts one `count` array into both
    the Adam state and the schedule state, and its train step donates the
    state, so resuming from a torch checkpoint that carries optimizer state
    fails there with "Attempt to donate the same buffer twice". The values
    are the same; only the buffers are copied."""
    restored = _RESTORE_ADAM_MOMENTS(opt_state, step, mu, nu)
    return jax.tree.map(lambda a: a.copy(), restored)


_RESTORE_ADAM_MOMENTS = jtrain.restore_adam_moments


def loop_runs(mkdir, num_epochs=EPOCHS, perturb=None):
    """Both packages' fresh runs and resumed runs (two JAX train() calls),
    in directories from `mkdir(name)`. `perturb(path)`, where given, returns
    the checkpoint both resumes start from in place of the port's epoch-0
    checkpoint at `path` (scripts/resume_spread_probe.py scales its
    parameters)."""
    root = mkdir("videos")
    for split, n in (("train", 4 * STEPS_PER_EPOCH), ("test", 1)):
        os.makedirs(root / split)
        for i in range(n):
            video = np.random.RandomState(i).rand(5, HW, HW, 3).astype(np.float32)
            write_stacked_png(str(root / split / f"{i:03d}.png"), video)
    config = _config(str(root))
    config["train_params"]["num_epochs"] = num_epochs
    jds = JFramesDataset(is_train=True, **config["dataset_params"])
    tds = TFramesDataset(is_train=True, **config["dataset_params"])
    dirs = {name: str(mkdir(name)) for name in ("jax", "port", "jax_resumed", "port_resumed")}
    init = str(mkdir("init") / checkpoint_name(0))
    resume_from = os.path.join(dirs["port"], checkpoint_name(0))
    out = {"config": config, "dirs": dirs, "resume_from": resume_from,
           "jax_drawn": []}
    with pytest.MonkeyPatch.context() as mp:
        init_models = init_models_once()
        mp.setattr(jbuild, "init_models", init_models)
        mp.setattr(jloop, "init_models", init_models)
        mp.setattr(jtrain, "restore_adam_moments", _restore_adam_moments_unshared)
        _, out["params"], out["batch_stats"] = jax_variables(config, image_hw=(HW, HW))
        trainer = Trainer(port_train_models(config, out["params"], out["batch_stats"]),
                          config["train_params"], device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
        save_checkpoint(init, {**trainer.state_dict(), "epoch": 0, "it": 0})

        out["jax_state"] = jloop.train(config, dirs["jax"], jds, checkpoint=init)
        out["port_run"] = tloop.train(config, dirs["port"], tds, checkpoint=init, device="cpu")

        if perturb is not None:
            resume_from = out["resume_from"] = perturb(resume_from)
        mp.setattr(jloop, "DataLoader", _recording(jloop.DataLoader, out["jax_drawn"]))
        out["jax_resumed"] = jloop.train(config, dirs["jax_resumed"], jds, checkpoint=resume_from)
        out["port_resumed"] = tloop.train(config, dirs["port_resumed"], tds,
                                          checkpoint=resume_from, device="cpu")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return loop_runs(tmp_path_factory.mktemp)


def _log_rows(log_dir):
    """{iteration: [loss values]} of a log.txt, without steps/s."""
    rows = {}
    with open(os.path.join(log_dir, "log.txt")) as f:
        for line in f.read().strip().splitlines():
            m = LOG_LINE.match(line)
            assert m, line
            names_values = [part.split(" - ") for part in m.group(2).split("; ")]
            rows[int(m.group(1))] = ([n for n, _ in names_values],
                                     [float(v) for _, v in names_values])
    return rows


def _assert_logs_match(jax_dir, port_dir, want_iterations, atol=None):
    """`atol`: {iteration: absolute tolerance}; 1e-5 where it names none."""
    want, got = _log_rows(jax_dir), _log_rows(port_dir)
    assert sorted(got) == sorted(want) == want_iterations
    for it in want:
        assert got[it][0] == want[it][0]
        np.testing.assert_allclose(got[it][1], want[it][1], rtol=1e-4,
                                   atol=(atol or {}).get(it, 1e-5), err_msg=f"iteration {it}")


def _assert_params_match(jax_state, trainer, steps, lr, share=0.98):
    tol = 2 * lr * steps + 1e-6
    gaps = []
    for name in MODEL_NAMES:
        want = from_jax_variables(jax.tree.map(np.asarray, jax_state.params[name]),
                                  jax.tree.map(np.asarray, jax_state.batch_stats.get(name, {})))
        got = trainer.models[name].state_dict()
        assert set(got) == set(want)
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            gap = (got[key] - w).abs()
            assert gap.max().item() <= tol, f"{name}.{key}: {gap.max().item()} > {tol}"
            if "running_" not in key:
                gaps.append(gap.flatten())
    # A sign flip moves single entries; a wrong gradient would move whole
    # tensors. 99.2% of the entries agree to 1e-6 in the fresh run here.
    assert (torch.cat(gaps) <= 1e-6).float().mean() >= share


def test_loop_logs_match_jax(runs):
    """Every log.txt line of the fresh run: the same iterations, names and
    losses."""
    _assert_logs_match(runs["dirs"]["jax"], runs["dirs"]["port"],
                       list(range(EPOCHS * STEPS_PER_EPOCH)))


def test_loop_final_parameters_match_jax(runs):
    lr = runs["config"]["train_params"]["lr"]
    assert runs["port_run"].steps == EPOCHS * STEPS_PER_EPOCH
    assert runs["port_run"].epochs == list(range(EPOCHS))
    _assert_params_match(runs["jax_state"], runs["port_run"].trainer, runs["port_run"].steps, lr)


def test_loop_writes_checkpoints_and_gifs(runs):
    port_dir = runs["dirs"]["port"]
    for epoch in range(EPOCHS):
        assert os.path.exists(os.path.join(port_dir, checkpoint_name(epoch)))
    assert not [f for f in os.listdir(port_dir) if f.endswith(".tmp")]
    gifs = sorted(os.listdir(os.path.join(port_dir, "train-vis")))
    assert gifs == [f"{it:08d}-rec.gif" for it in range(EPOCHS * STEPS_PER_EPOCH)]


def test_jax_load_any_reads_the_port_checkpoint(runs):
    """The JAX package's reader of torch checkpoints takes the port's file:
    every network, its Adam moments and step, and the epoch counters."""
    params, batch_stats = runs["params"], runs["batch_stats"]
    templates = {name: {"params": params[name],
                        **({"batch_stats": batch_stats[name]} if name in batch_stats else {})}
                 for name in MODEL_NAMES}
    loaded = load_any(runs["resume_from"], templates)
    saved = torch.load(runs["resume_from"], map_location="cpu", weights_only=True)
    assert loaded["epoch"] == 0 and loaded["it"] == STEPS_PER_EPOCH - 1
    for name in MODEL_NAMES:
        assert loaded[f"optimizer_{name}"]["step"] == STEPS_PER_EPOCH
        back = from_jax_variables(loaded[name]["params"], loaded[name].get("batch_stats", {}))
        for key, value in back.items():
            if not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(value, saved[name][key], rtol=0, atol=0)


def test_resume_matches_jax(runs):
    """Both packages resume from the port's epoch-0 checkpoint: they train
    epoch 0 again (the checkpoint's epoch), log from the saved iteration on,
    and agree on every loss and the final parameters: the replayed epoch's
    rows as the fresh run's, later rows and the parameters within the JAX
    package's own spread (module docstring)."""
    assert runs["jax_drawn"] == runs["port_resumed"].epochs == [0, 1]
    first = STEPS_PER_EPOCH - 1  # the checkpoint's `it`: its last logged iteration
    iterations = list(range(first, first + EPOCHS * STEPS_PER_EPOCH))
    atol = {it: 1e-5 + RESUME_SPREAD_PER_STEP * (it - first - 1)
            for it in iterations if it - first >= STEPS_PER_EPOCH}
    _assert_logs_match(runs["dirs"]["jax_resumed"], runs["dirs"]["port_resumed"], iterations,
                       atol)
    lr = runs["config"]["train_params"]["lr"]
    steps = STEPS_PER_EPOCH + runs["port_resumed"].steps
    _assert_params_match(runs["jax_resumed"], runs["port_resumed"].trainer, steps, lr,
                         share=RESUMED_SHARE)


def test_resume_restores_the_trainer_exactly(runs):
    """A trainer loaded from a checkpoint holds the saved parameters,
    statistics, Adam moments and steps, and scheduler positions bit for
    bit; a milestone crossed before the save keeps its lower rate."""
    saved = torch.load(runs["resume_from"], map_location="cpu", weights_only=True)
    config = runs["config"]
    trainer = Trainer(port_train_models(config, runs["params"], runs["batch_stats"]),
                      config["train_params"], device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    trainer.load_state_dict(saved)
    state = trainer.state_dict()
    for name in MODEL_NAMES:
        for key, value in saved[name].items():
            assert torch.equal(state[name][key], value), f"{name}.{key}"
        opt, want = state[f"optimizer_{name}"], saved[f"optimizer_{name}"]
        for idx, entry in want["state"].items():
            for key, value in entry.items():
                assert torch.equal(opt["state"][idx][key], value), f"{name} {idx} {key}"
        assert state[f"scheduler_{name}"] == saved[f"scheduler_{name}"]
        # epoch_milestones [1]: the rate fell after the first epoch's steps
        lr = config["train_params"]["lr"]
        assert trainer.optimizers[name].param_groups[0]["lr"] == pytest.approx(lr * 0.1)


def test_resume_without_scheduler_state_takes_the_adam_step(runs):
    """A checkpoint without scheduler entries (the reference's form) puts
    each MultiStepLR at its optimizer's step, as the JAX package puts its
    schedule."""
    saved = torch.load(runs["resume_from"], map_location="cpu", weights_only=True)
    config = runs["config"]
    trainer = Trainer(port_train_models(config, runs["params"], runs["batch_stats"]),
                      config["train_params"], device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    trainer.load_state_dict({k: v for k, v in saved.items() if not k.startswith("scheduler_")})
    for name in MODEL_NAMES:
        assert trainer.schedulers[name].last_epoch == STEPS_PER_EPOCH


def test_train_refuses_missing_cuda_and_several_devices(runs, monkeypatch):
    """More devices than the cards present raises and names both counts
    (on a machine whose CUDA check answers yes, with one card); no card at
    all raises before anything else."""
    config = runs["config"]
    dataset = TFramesDataset(is_train=True, **config["dataset_params"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1"):
        tloop.train(config, runs["dirs"]["port"], dataset, num_devices=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.train(config, runs["dirs"]["port"], dataset)


def test_cli_trains_on_the_cpu_and_refuses_the_rest(runs, tmp_path, monkeypatch, capsys):
    """`python -m monkeynet_tpu_torch.run`: train (on the CPU, the card's
    check answered with the CPU device) into a timestamped directory, with a
    profiler trace of steps 10-20; refuse the missing card, and an eval mode
    without a checkpoint."""
    import yaml

    from monkeynet_tpu_torch import run
    from monkeynet_tpu_torch.utils import device as device_mod

    config = copy.deepcopy(runs["config"])
    config["train_params"]["num_epochs"] = 6  # 12 steps: past the profiled 10-20
    config["train_params"]["log_params"] = {"log_freq_iter": 100, "cpk_freq_epoch": 100}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(config))
    require_device = device_mod.require_device
    monkeypatch.setattr(device_mod, "require_device", lambda device: torch.device("cpu"))
    assert run.main(["--config", str(path), "--log_dir", str(tmp_path / "log"),
                     "--profile", str(tmp_path / "trace")]) == 0
    with pytest.raises(ValueError, match="checkpoint is required"):
        run.main(["--config", str(path), "--mode", "transfer", "--log_dir", str(tmp_path / "l")])
    monkeypatch.setattr(device_mod, "require_device", require_device)
    assert "12 steps in" in capsys.readouterr().out
    (log_dir,) = (tmp_path / "log").iterdir()
    assert log_dir.name.startswith("tiny ")
    # epoch 0 hits cpk_freq_epoch; the exit save writes the last epoch
    assert sorted(p.name for p in log_dir.iterdir()) == \
        sorted(["tiny.yaml", "log.txt", "train-vis", checkpoint_name(0), checkpoint_name(5)])
    assert (tmp_path / "trace" / "train_trace.json").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--config", str(path), "--log_dir", str(tmp_path / "log2")])
