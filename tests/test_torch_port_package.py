"""Package-level checks of the PyTorch port: its state_dict names against the
JAX package's checkpoint converter, its imports, and that its entry points
never fall back to the CPU on their own."""

import ast
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from monkeynet_tpu.tasks.build import init_models
from monkeynet_tpu.utils.config import load_config as jax_load_config
from monkeynet_tpu.utils.torch_import import import_state_dict
from monkeynet_tpu_torch.tasks import animate as tanimate
from monkeynet_tpu_torch.tasks.build import build_models
from monkeynet_tpu_torch.utils.config import load_config, validate_config
from monkeynet_tpu_torch.utils.weights import from_jax_variables

from .torch_port_common import tiny_config

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "monkeynet_tpu_torch"


def _config(name):
    if name == "tiny":
        return tiny_config(), (32, 32, 3)
    return load_config(str(REPO / "configs" / f"{name}.yaml")), (64, 64, 3)


@pytest.mark.parametrize("name", ["tiny", "taichi"])
def test_state_dict_keys_round_trip_through_torch_import(name):
    """The JAX package's importer of reference checkpoints consumes every key
    of the port's state_dict, fills every JAX variable, and the values come
    back unchanged through from_jax_variables. The JAX side's shapes come
    from jax.eval_shape, so nothing is initialised there."""
    config, image_shape = _config(name)
    params, batch_stats = jax.eval_shape(
        lambda rng: init_models(config, rng, image_shape)[1:], jax.random.PRNGKey(0)
    )
    generator, kp_detector = build_models(config, device="cpu", seed=3)
    for model_name, model in (("generator", generator), ("kp_detector", kp_detector)):
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        template = jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype),
            {"params": params[model_name], "batch_stats": batch_stats[model_name]},
        )
        imported = import_state_dict(template, sd)  # raises on any unmatched key
        back = from_jax_variables(imported["params"], imported["batch_stats"])
        assert set(back) == set(sd)
        for key, value in back.items():
            np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)
        model.load_state_dict(back)  # strict: names and shapes both match


def test_published_layouts():
    generator, kp_detector = build_models(tiny_config(), device="cpu")
    sd = generator.state_dict()
    w = sd["dense_motion_module.group_blocks.0.conv.weight"]
    # (out, in/groups, 1, kh, kw): 5 groups (K+1) of 4 channels (heatmap + RGB)
    assert w.shape == (20, 4, 1, 1, 1)
    assert "refinement_module.conv-last.weight" in sd
    assert "appearance_encoder.down_blocks.0.norm.num_batches_tracked" in sd
    assert "predictor.decoder.conv.weight" in kp_detector.state_dict()


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax, flax, the
    msgpack package (the port decodes flax's files itself) or the JAX
    package, nor what the card's machine lacks: sklearn, imageio,
    matplotlib."""
    banned = {"jax", "jaxlib", "flax", "optax", "chex", "monkeynet_tpu", "msgpack", "sklearn",
              "imageio", "matplotlib"}
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """The default device is CUDA; without a card the entry points raise
    instead of running on the CPU."""
    generator, kp_detector = build_models(tiny_config(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_models(tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tanimate.TransferEngine(generator, kp_detector)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tanimate.Animator(generator)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where CUDA is
    missing, and also when it stands alone without the repository."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            (tmp_path / script).write_text((REPO / script).read_text())
        proc = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_build_models_is_seeded():
    a, _ = build_models(tiny_config(), device="cpu", seed=5)
    b, _ = build_models(tiny_config(), device="cpu", seed=5)
    c, _ = build_models(tiny_config(), device="cpu", seed=6)
    key = "appearance_encoder.down_blocks.0.conv.weight"
    assert torch.equal(a.state_dict()[key], b.state_dict()[key])
    assert not torch.equal(a.state_dict()[key], c.state_dict()[key])


def test_config_loads_as_the_jax_package_does():
    path = str(REPO / "configs" / "taichi.yaml")
    config = load_config(path)
    assert config == jax_load_config(path)
    bad = copy.deepcopy(config)
    bad["train_params"]["loss_weights"]["reconstruction"] = [1, 2]
    with pytest.raises(ValueError, match="num_blocks \\+ 1"):
        validate_config(bad)
    json.dumps(config)  # plain data, no custom YAML types
