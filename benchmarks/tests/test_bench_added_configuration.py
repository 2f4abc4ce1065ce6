"""A configuration and a train cell added to a copy of the benchmark's data by
new files and appended entries alone, with moving-gif's options at tiny
widths (monkey-net's config/moving-gif.yaml: detector, dense motion and
keypoint embedding at scale 0.5, a difference term in the mask embedding, a
generator one block deeper than its dense motion, no remat). The fixture,
the dry runs, the span selection, the sound run and the train faults take it
as they take the committed cells, with no file of the benchmark edited."""

from __future__ import annotations

import copy
import json
import shutil

import pytest

from benchmarks import flops, harness, kernels
from benchmarks.tests import fixture, test_bench_dry_runs, test_bench_faults, test_bench_spans

CONFIG, CELL = "mgif_fixture", "mgif_fixture.train"
MODEL_PARAMS = {
    "common_params": {"num_kp": 4, "kp_variance": "matrix", "num_channels": 3},
    "kp_detector_params": {"temperature": 0.1, "block_expansion": 4, "max_features": 16,
                           "num_blocks": 3, "clip_variance": 0.001, "scale_factor": 0.5},
    "generator_params": {
        "block_expansion": 4, "max_features": 16, "num_blocks": 3, "num_refinement_blocks": 1,
        "dense_motion_params": {
            "block_expansion": 4, "max_features": 16, "num_blocks": 2, "use_mask": True,
            "use_correction": True,
            "mask_embedding_params": {"use_heatmap": True, "use_deformed_source_image": True,
                                      "heatmap_type": "difference", "norm_const": 100,
                                      "use_difference": True},
            "num_group_blocks": 2, "scale_factor": 0.5},
        "kp_embedding_params": {"use_heatmap": True, "norm_const": 100,
                                "heatmap_type": "difference", "scale_factor": 0.5}},
    "discriminator_params": {"kp_embedding_params": {"norm_const": 100}, "block_expansion": 4,
                             "max_features": 16, "num_blocks": 2},
}


def _added_spec(spec: dict) -> dict:
    """BENCHMARK.json with the configuration and the cell appended to its
    lists: the cell joins `train_samples_per_s` and every per-layer metric
    that lists a train cell."""
    spec = copy.deepcopy(spec)
    train_cells = set(fixture.cells("train"))
    spec["configs"].append({"name": CONFIG, "source": "https://example.org/mgif_fixture",
                            "file": f"benchmarks/configs/{CONFIG}.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "train_dispatches",
                              "chips": 1, "why": "test"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "train_samples_per_s":
            metric["workloads"].append(CELL)
    for metric in spec["per_layer"]:
        if train_cells & set(metric.get("workloads", ())):
            metric["workloads"].append(CELL)
    return spec


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A copy of the benchmark's data with the configuration and cell added."""
    src = tmp_path_factory.mktemp("source")
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(fixture.REPO / "benchmarks" / sub, src / "benchmarks" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((fixture.REPO / "BENCHMARK.json").read_text())
    (src / "BENCHMARK.json").write_text(json.dumps(_added_spec(spec)))
    vox = json.loads((fixture.REPO / "benchmarks" / "configs" / "vox256.json").read_text())
    train_params = dict(vox["train_params"], batch_size=64, remat=False)
    (src / "benchmarks" / "configs" / f"{CONFIG}.json").write_text(json.dumps(
        {"name": CONFIG, "image_size": [128, 128], "model_params": MODEL_PARAMS,
         "train_params": train_params}))
    shutil.copy(src / "benchmarks" / "limits" / "vox256.train.json",
                src / "benchmarks" / "limits" / f"{CELL}.json")
    return src


@pytest.fixture(scope="module")
def root(source, tmp_path_factory):
    return fixture.make_root(tmp_path_factory.mktemp("bench"), source=source)


@pytest.fixture(scope="module")
def float32_root(source, tmp_path_factory):
    return fixture.float32(fixture.make_root(tmp_path_factory.mktemp("faults"), source=source))


def test_make_root_writes_every_configuration(root):
    spec = harness.Spec(root)
    assert fixture.cells(root=root)[-1] == CELL
    assert fixture.cells("train", root) == [*fixture.cells("train"), CELL]
    sizes = {e["name"]: json.loads((root / e["file"]).read_text())["image_size"]
             for e in spec.data["configs"]}
    assert (sizes["taichi64"], sizes["vox256"], sizes[CONFIG]) == ([32, 32], [64, 64], [32, 32])
    mp = spec.config(spec.cell(CELL))["model_params"]
    assert mp["generator_params"]["num_blocks"] == 3
    assert mp["generator_params"]["dense_motion_params"]["num_blocks"] == 2
    assert mp["generator_params"]["dense_motion_params"]["mask_embedding_params"][
        "use_difference"] is True


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_takes_the_cell(root, trace):
    test_bench_dry_runs.test_dry_run(root, CELL, trace)


def test_span_selection_takes_the_cell(root, source):
    assert fixture.span_metrics(CELL, source) == fixture.span_metrics("vox256.train")
    assert fixture.span_metrics(CELL, source)
    test_bench_spans.test_traced_dry_run_reports_the_span_metrics(root, CELL)


def test_sound_run_takes_the_cell(float32_root):
    test_bench_faults.test_sound_run_is_correct(float32_root, CELL)


@pytest.mark.parametrize("fault", [
    "test_state_left_unchanged", "test_half_the_batch_left_out",
    "test_a_gradient_left_out_where_it_is_produced",
    "test_an_answer_altered_where_it_is_produced"])
def test_train_faults_take_the_cell(float32_root, monkeypatch, fault):
    getattr(test_bench_faults, fault)(float32_root, monkeypatch, CELL)


def test_counts_on_meta(source):
    cfg = json.loads((source / "benchmarks" / "configs" / f"{CONFIG}.json").read_text())
    mp, tp, hw = cfg["model_params"], cfg["train_params"], tuple(cfg["image_size"])
    assert flops.train_step_flops(mp, tp, hw, tp["batch_size"]) > 0
    ops = kernels.path_ops(mp, hw, "train_step", batch=tp["batch_size"], remat=tp["remat"])
    names = [op for op, _ in ops]
    assert all(names.count(op) > 0 for op in ("warp_fwd", "warp_dsrc", "warp_dgrid", "combine"))
    assert all(b > 0 for b in kernels.bytes_by_op(ops, kernels.itemsize_of(
        tp["compute_dtype"])).values())
