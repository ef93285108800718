"""The port's command line (``python -m lightgbm_tpu_torch``,
``lightgbm_tpu_torch/cli.py``) on the CPU (``device_type=cpu``), against
the JAX package's (``lightgbm_tpu/cli.py``) on ``tests/test_cli.py``'s
golden binary files.

The conf file and ``key=value`` parsing equal JAX's; ``task=train``
grows JAX's trees (structure exact, leaf values within 1e-5) up to tree
0's last split, a float32 tie between two features (ROADMAP.md Queue
3); ``task=predict`` of one model file writes JAX's predictions (within
1e-12), every predict kind equal to the bit to
``lt.Booster(model_file=).predict``, the
two-round streamed file byte-equal to the in-memory one; the golden
model predicts the reference CLI's recorded output (``pred_binary.txt``,
rtol 1e-6); snapshots are byte-equal to the text of the run at their
iteration and continued training adds its trees; ``task=refit`` refits
JAX's leaves (within 1e-5, the refit tests' tolerance);
``task=pipeline`` runs one cycle; ``task=serve`` builds the engine the
params ask for on the CPU; without ``device_type=cpu`` and without a
card every task refuses; one subprocess run of ``python -m
lightgbm_tpu_torch``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu import cli as jcli
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.io.model_text import load_model_from_file

from golden_common import DATASETS, write_tsv
from test_torch_pipeline import parity_to_first_tie

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "device_type=cpu"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    Xtr, ytr, Xte, yte = DATASETS["binary"]["make"]()
    train, test = str(d / "bin.train"), str(d / "bin.test")
    write_tsv(train, Xtr, ytr)
    write_tsv(test, Xte, yte)
    return dict(train=train, test=test, Xte=Xte, yte=yte)


@pytest.fixture(scope="module")
def trained(files, tmp_path_factory):
    """One conf file trained by both CLIs, and the port's model predicted
    by both: {"port": (model, predictions), "jax": (model, predictions
    of the port's model)}."""
    d = tmp_path_factory.mktemp("trained")
    conf = d / "train.conf"
    conf.write_text("# reference-style conf\n"
                    "task = train\n"
                    "objective = binary\n"
                    f"data = {files['train']}\n"
                    "num_trees = 10\n"
                    "num_leaves = 15\n"
                    "metric = binary_logloss   # trailing comment\n"
                    "verbosity = -1\n")
    out = {}
    for name, mod, extra in (("port", cli, [CPU]), ("jax", jcli, [])):
        model = str(d / f"{name}_model.txt")
        preds = str(d / f"{name}_preds.txt")
        assert mod.main([f"config={conf}", f"output_model={model}"]
                        + extra) == 0
        mod.main(["task=predict", f"data={files['test']}",
                  f"input_model={out['port'][0] if out else model}",
                  f"output_result={preds}", "verbosity=-1"] + extra)
        out[name] = (model, preds)
    return out


def _nodes(t):
    return (int(t.num_leaves), list(t.split_feature), list(t.threshold),
            list(t.decision_type), list(t.left_child), list(t.right_child))


def _same_trees(port_file, jax_file):
    """The parity standard up to the first float32 tie
    (``test_torch_pipeline.parity_to_first_tie``)."""
    texts = []
    for path in (port_file, jax_file):
        with open(path) as fh:
            texts.append(fh.read())
    return parity_to_first_tie(*texts)


def test_config_parsing_matches_jax(tmp_path):
    conf = tmp_path / "x.conf"
    conf.write_text("a = 1  # comment\n# whole line\nb=two\n\nnoequals\n"
                    "c = x=y\n")
    assert cli.parse_config_file(str(conf)) == \
        jcli.parse_config_file(str(conf)) == {"a": "1", "b": "two",
                                              "c": "x=y"}
    for argv in ([f"config={conf}", "b=cli", "d=4", "stray"],
                 [f"config_file={conf}", " a = 9 "], ["task=predict"]):
        assert cli.parse_cli_params(argv) == jcli.parse_cli_params(argv)
    assert cli.parse_cli_params([f"config={conf}", "b=cli"])["b"] == "cli"


def test_train_then_predict_matches_jax_cli(files, trained):
    (pm, pp), (jm, jp) = trained["port"], trained["jax"]
    # tree 0's last split (node 13, 15 leaves on 600 rows) is a float32
    # tie between two features (ROADMAP.md Queue 3); the trees after it
    # grow from other scores
    assert _same_trees(pm, jm) == (0, (0, 13))
    # the predict task: both CLIs on the port's model file
    port, jax = np.loadtxt(pp), np.loadtxt(jp)
    assert port.shape == (files["Xte"].shape[0],)
    np.testing.assert_allclose(port, jax, rtol=1e-12, atol=1e-15)
    y = files["yte"]
    assert port[y == 1].mean() > port[y == 0].mean()


@pytest.mark.parametrize("kind,kw", [
    ("predict", {}), ("predict_raw_score=true", {"raw_score": True}),
    ("predict_leaf_index=true", {"pred_leaf": True}),
    ("predict_contrib=true", {"pred_contrib": True}),
    ("num_iteration_predict=4", {"num_iteration": 4})])
def test_predict_kinds_equal_the_booster(files, trained, tmp_path, kind,
                                         kw):
    model = trained["port"][0]
    out = str(tmp_path / "p.txt")
    extra = [] if kind == "predict" else [kind]
    cli.main(["task=predict", f"data={files['test']}",
              f"input_model={model}", f"output_result={out}",
              "verbosity=-1", CPU] + extra)
    want = lt.Booster(model_file=model, device="cpu").predict(
        files["Xte"], **kw)
    got = np.loadtxt(out, ndmin=2 if np.ndim(want) == 2 else 1)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_two_round_predict_equals_in_memory(files, trained, tmp_path):
    model = trained["port"][0]
    outs = []
    for extra in ([], ["two_round=true"]):
        out = str(tmp_path / f"p{len(outs)}.txt")
        cli.main(["task=predict", f"data={files['test']}",
                  f"input_model={model}", f"output_result={out}",
                  "verbosity=-1", CPU] + extra)
        with open(out, "rb") as fh:
            outs.append(fh.read())
    assert outs[0] == outs[1]


def test_predict_matches_reference_cli_output(files, tmp_path):
    out = str(tmp_path / "preds.txt")
    cli.main(["task=predict", f"data={files['test']}",
              f"input_model={os.path.join(FIXDIR, 'model_binary.txt')}",
              f"output_result={out}", "verbosity=-1", CPU])
    ref = np.loadtxt(os.path.join(FIXDIR, "pred_binary.txt"))
    np.testing.assert_allclose(np.loadtxt(out), ref, rtol=1e-6, atol=1e-6)


def test_snapshots_and_continued_training(files, tmp_path):
    model = str(tmp_path / "model.txt")
    args = ["task=train", "objective=binary", f"data={files['train']}",
            "num_leaves=7", "verbosity=-1", "metric=binary_logloss", CPU]
    cli.main(args + ["num_trees=8", "snapshot_freq=4",
                     f"output_model={model}"])
    full = load_model_from_file(model)
    assert len(full.models) == 8
    for it in (4, 8):
        snap = load_model_from_file(f"{model}.snapshot_iter_{it}")
        assert [_nodes(t) for t in snap.models] == \
            [_nodes(t) for t in full.models[:it]]
    model2 = str(tmp_path / "model2.txt")
    cli.main(args + ["num_trees=5", f"input_model={model}",
                     f"output_model={model2}"])
    m2 = load_model_from_file(model2)
    assert len(m2.models) == 13
    # the file's 8 trees are kept to the bit
    assert [(_nodes(t), list(t.leaf_value)) for t in m2.models[:8]] == \
        [(_nodes(t), list(t.leaf_value)) for t in full.models]


def test_refit_task_matches_jax_cli(files, trained, tmp_path):
    jmodel = trained["jax"][0]      # one model text refit by both CLIs
    outs = []
    for name, mod, extra in (("port", cli, [CPU]), ("jax", jcli, [])):
        out = str(tmp_path / f"{name}_refit.txt")
        mod.main(["task=refit", f"data={files['test']}",
                  f"input_model={jmodel}", f"output_model={out}",
                  "refit_decay_rate=0.5", "verbosity=-1"] + extra)
        outs.append(out)
    assert _same_trees(*outs) == (10, None)
    a = load_model_from_file(jmodel).models
    b = load_model_from_file(outs[0]).models
    assert any(not np.allclose(x.leaf_value, y.leaf_value)
               for x, y in zip(a, b))


def test_pipeline_task_runs_one_cycle(trained, tmp_path, monkeypatch):
    from lightgbm_tpu_torch.pipeline import driver
    seen = {}
    real = driver.run_pipeline

    def spy(params):
        seen["summary"] = real(params)
        return seen["summary"]

    monkeypatch.setattr(driver, "run_pipeline", spy)
    monkeypatch.setattr("lightgbm_tpu_torch.pipeline.run_pipeline", spy)
    cli.main(["task=pipeline", f"input_model={trained['jax'][0]}",
              "pipeline_cycles=1", "pipeline_window_rows=300",
              "pipeline_holdout_rows=100", "pipeline_stage_requests=8",
              "pipeline_canary_stages=0.5",
              "pipeline_latency_slo_pct=1000", "serving_buckets=1,64,512",
              f"pipeline_dir={tmp_path / 'cands'}", "verbosity=-1", CPU])
    s = seen["summary"]
    assert s["cycles"] == 1 and s["history"][0]["status"] in (
        "promoted", "rolled_back")
    assert os.listdir(str(tmp_path / "cands")) == ["cand_00001"]


@pytest.mark.parametrize("replicas", [1, 2])
def test_serve_task_builds_its_engine(trained, monkeypatch, replicas):
    from lightgbm_tpu_torch.serving import http
    seen = {}

    def fake_serve_forever(engine, host, port):
        seen.update(engine=engine, host=host, port=port)
        engine.stop()

    monkeypatch.setattr(http, "serve_forever", fake_serve_forever)
    cli.main(["task=serve", f"input_model={trained['port'][0]}",
              f"serving_replicas={replicas}", "serving_port=0", CPU])
    eng = seen["engine"]
    assert eng.device == torch.device("cpu")
    assert type(eng).__name__ == ("FleetEngine" if replicas > 1
                                  else "ServingEngine")
    assert seen["port"] == 0


@pytest.mark.parametrize("task", ["train", "predict", "refit", "serve",
                                  "pipeline"])
def test_tasks_need_a_card_without_device_type_cpu(files, trained, task,
                                                   tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = [f"task={task}", f"data={files['train']}",
            f"input_model={trained['port'][0]}", "objective=binary",
            "num_trees=1", f"output_model={tmp_path / 'm.txt'}",
            f"output_result={tmp_path / 'p.txt'}", "verbosity=-1",
            "pipeline_cycles=1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(args)


def test_unknown_task_is_fatal():
    with pytest.raises(lt.LightGBMError, match="Unknown task"):
        cli.main(["task=frobnicate"])


def test_python_dash_m_subprocess(files, tmp_path):
    model = str(tmp_path / "m.txt")
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
         "objective=binary", f"data={files['train']}", "num_trees=3",
         "num_leaves=7", f"output_model={model}", CPU],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "Finished training" in run.stdout + run.stderr
    assert "lightgbm_tpu." not in run.stdout + run.stderr
    with open(model) as fh:
        got = fh.read()
    twin = lt.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1}, lt.Dataset(files["train"]), 3,
                    device="cpu").model_to_string()
    assert got.split("\nparameters:\n")[0] == \
        twin.split("\nparameters:\n")[0]
