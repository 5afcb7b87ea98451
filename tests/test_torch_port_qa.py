"""The port's video-QA harness (``videocad_tpu_torch/qa/``, ``cli/eval_qa``,
``cli/qa_analysis``) against the JAX package's on the same inputs.

Only the keyless backends run (``mock``, seeded ``random`` and test
clients); the REST clients are built by ``create_client`` and never
called. Outputs are compared as bytes of the files both write.
"""

import dataclasses
import filecmp
import json
import os
import random

import numpy as np
import pytest

from videocad_tpu import qa as jax_qa
from videocad_tpu.cli import eval_qa as jax_eval_cli
from videocad_tpu.cli import qa_analysis as jax_analysis_cli
from videocad_tpu.qa import harness as jax_harness
from videocad_tpu_torch import qa as port_qa
from videocad_tpu_torch.cli import eval_qa as port_eval_cli
from videocad_tpu_torch.cli import qa_analysis as port_analysis_cli
from videocad_tpu_torch.qa import harness as port_harness

PACKAGES = {"port": port_qa, "jax": jax_qa}


@pytest.fixture()
def qa_file(tmp_path):
    """Twelve items in the fixture format of ``tests/test_qa.py``, one image
    reference and one option image each, answers on every option, three
    templates."""
    from PIL import Image

    rng = np.random.default_rng(0)
    items = []
    for i in range(12):
        refs = {}
        for name in ("img_0", "opt"):
            path = tmp_path / f"{name}_{i}.png"
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                            ).save(path)
            refs[name] = str(path)
        items.append({
            "id": 100 + i,
            "question": {"text": f"What is shape <img_0> number {i}?",
                         "image_refs": {"img_0": refs["img_0"]}},
            "options": [{"id": "a", "text": "cube"},
                        {"id": "b", "text": 3 + i},
                        {"id": "c", "path": refs["opt"]}],
            "answer": "abc"[i % 3],
            "template": ("shape", "count", "view")[i % 3],
        })
    path = tmp_path / "qa.json"
    path.write_text(json.dumps(items))
    return str(path)


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def test_dataset_ranges_content_and_answer_recovery(qa_file):
    for question_range in (None, (0, 12), (2, 5), (11, 40), (5, 5)):
        ours = port_qa.QADataset(qa_file, question_range)
        theirs = jax_qa.QADataset(qa_file, question_range)
        assert len(ours) == len(theirs)
        assert [dataclasses.asdict(i) for i in ours.items] == \
            [dataclasses.asdict(i) for i in theirs.items]
        assert sorted(ours.by_id) == sorted(theirs.by_id)
    ours, theirs = port_qa.QADataset(qa_file), jax_qa.QADataset(qa_file)
    for a, b in zip(ours.items, theirs.items):
        content = port_harness.build_content(a)
        assert content == jax_harness.build_content(b)
        assert port_harness.AnthropicClient._convert_content(content) == \
            jax_harness.AnthropicClient._convert_content(content)
    assert ours.get(103).option_ids == ["a", "b", "c"]
    rng = np.random.default_rng(1)
    answers = [" B ", "b", "the answer is c.", "option: c", "xyz", "", "C",
               "a or b"] + ["".join(rng.choice(list("abcxyz :."), 6))
                            for _ in range(40)]
    for seed in range(3):
        mine, yours = random.Random(seed), random.Random(seed)
        for raw in answers:
            assert port_qa.recover_answer_id(raw, ["a", "b", "c"], mine) == \
                jax_qa.recover_answer_id(raw, ["a", "b", "c"], yours)


def _client(pkg, kind):
    """A keyless test client of ``pkg``: free text to recover an id from,
    or an error on every third question."""
    harness = port_harness if pkg is port_qa else jax_harness

    class Chatty(harness.BaseClient):
        name = "chatty"

        def complete(self, item):
            return ["I pick b.", "zzz", "C"][item.id % 3]

    class Flaky(harness.BaseClient):
        name = "flaky"

        def complete(self, item):
            if item.id % 3 == 0:
                raise ConnectionError("no route to host")
            return item.option_ids[-1]

    return {"chatty": Chatty, "flaky": Flaky}[kind]()


@pytest.mark.parametrize("backend", ["mock", "random", "chatty", "flaky"])
def test_pipelines_write_equal_results(qa_file, tmp_path, backend, capsys):
    for name, pkg in PACKAGES.items():
        dataset = pkg.QADataset(qa_file)
        client = (pkg.create_client("x", mock_mode=True) if backend == "mock"
                  else pkg.create_client("random-7", seed=7)
                  if backend == "random" else _client(pkg, backend))
        pipeline = pkg.EvaluationPipeline(dataset, str(tmp_path / name),
                                          client, "1-12", save_freq=5,
                                          seed=3)
        metrics = pipeline.run()
        if backend == "mock":   # right exactly where the first option is
            assert [o["correct"] for o in pipeline.outputs] == \
                [int(i.answer == "a") for i in dataset.items]
            assert metrics["shape"] == 100.0 and metrics["count"] == 0.0
    out = capsys.readouterr().out
    assert out.count("Error on question") in (0, 8)
    _same_dirs(tmp_path / "port" / backend, tmp_path / "jax" / backend)


def test_resume_skips_answered_and_retries_unknown(qa_file, tmp_path):
    """Existing results are kept, unknown answers asked again, and a second
    run of a finished file asks nothing."""
    for name, pkg in PACKAGES.items():
        dataset = pkg.QADataset(qa_file)
        out_dir = tmp_path / name
        pkg.EvaluationPipeline(dataset, str(out_dir), _client(pkg, "flaky"),
                               seed=1).run()
        asked = []

        class Counting(pkg.MockClient):
            name = "flaky"

            def complete(self, item):
                asked.append(item.id)
                return super().complete(item)

        pkg.EvaluationPipeline(dataset, str(out_dir), Counting(),
                               seed=1).run()
        assert asked == [102, 105, 108, 111]     # the unknowns only
        asked.clear()
        pkg.EvaluationPipeline(dataset, str(out_dir), Counting(),
                               seed=1).run()
        assert asked == []
    _same_dirs(tmp_path / "port" / "flaky", tmp_path / "jax" / "flaky")


@pytest.mark.parametrize("model", [
    "gpt-4.1", "o3-mini", "openai/x", "claude-3-7-sonnet", "anthropic-x",
    "gemini-2.5-pro", "google/gemma", "qwen-vl-max", "glm-4v", "internvl3",
    "OpenGVLab/InternVL", "GPT-4o", "llama-3", "random", "random-9"])
def test_create_client_routes_like_the_jax_package(model, monkeypatch):
    for _, _, env_var, _ in jax_harness.PROVIDER_ROUTES:
        monkeypatch.delenv(env_var, raising=False)
    assert port_harness.PROVIDER_ROUTES == jax_harness.PROVIDER_ROUTES

    def built(pkg, **kw):
        try:
            client = pkg.create_client(model, **kw)
        except ValueError as e:
            return ("ValueError", str(e))
        return (type(client).__name__, client.name,
                getattr(client, "base_url", None),
                getattr(client, "api_key", None))

    for kw in ({}, {"api_key": "k1"}, {"mock_mode": True}, {"seed": 4}):
        assert built(port_qa, **kw) == built(jax_qa, **kw)
    monkeypatch.setenv("OPENAI_API_KEY", "k2")
    monkeypatch.setenv("ANTHROPIC_API_KEY", "k3")
    assert built(port_qa) == built(jax_qa)


def test_majority_vote_and_model_dir_aggregation(qa_file, tmp_path):
    rng = np.random.default_rng(2)
    outputs = []
    for q in range(100, 112):
        for _ in range(int(rng.integers(1, 6))):
            answer = str(rng.choice(["a", "b", "c", "unknown_answer_code"]))
            outputs.append({"model": "m", "answer": answer, "question_id": q,
                            "correct": int(answer == "a")})
    for name, pkg in PACKAGES.items():
        model_dir = tmp_path / name / "m"
        model_dir.mkdir(parents=True)
        for run in range(3):
            part = outputs[run::3]
            (model_dir / f"model_results_r{run}.json").write_text(
                json.dumps(part))
        (model_dir / "model_answers_r0.json").write_text("{}")
    results = {}
    for name, pkg in PACKAGES.items():
        dataset = pkg.QADataset(qa_file)
        loaded = pkg.load_all_outputs(str(tmp_path / name / "m"), dataset,
                                      random.Random(5))
        results[name] = (
            loaded,
            pkg.group_outputs([dict(o) for o in outputs], 100, 111,
                              random.Random(6)),
            pkg.majority_vote_accuracy(dataset, loaded, 0, 1200,
                                       random.Random(7)),
            pkg.template_accuracies(outputs, dataset),
            [pkg.eval_model_dir(str(tmp_path / name / "m"), dataset,
                                str(tmp_path / name / "res.json"), seed)
             for seed in (0, 1)])
    assert results["port"] == results["jax"]
    assert results["port"][2]["num_questions"] > 0
    assert filecmp.cmp(tmp_path / "port" / "res.json",
                       tmp_path / "jax" / "res.json", shallow=False)


def test_qa_clis_equal_the_jax_package(qa_file, tmp_path, capsys):
    printed = {}
    for name, (eval_cli, analysis_cli) in {
            "port": (port_eval_cli, port_analysis_cli),
            "jax": (jax_eval_cli, jax_analysis_cli)}.items():
        out_dir = str(tmp_path / name / "results")
        assert eval_cli.parse_range("3-7") == (2, 7)
        assert eval_cli.parse_range("") is None
        with pytest.raises(ValueError, match="expected START-END"):
            eval_cli.parse_range("3")
        eval_cli.main(["--qa_dataset_path", qa_file, "--output_dir", out_dir,
                       "--model_name", "random,random-2", "--seed", "4",
                       "--question_range", "1-12"])
        eval_cli.main(["--qa_dataset_path", qa_file, "--output_dir", out_dir,
                       "--mock_mode", "--question_range", "2-9"])
        mock_dir = os.path.join(out_dir, "mock")
        source = os.path.join(mock_dir, "model_results_2-9.json")
        for copy in ("r2", "r3"):
            with open(source) as f, open(os.path.join(
                    mock_dir, f"model_results_{copy}.json"), "w") as g:
                g.write(f.read())
        analysis_cli.main(["--qa_dataset_path", qa_file, "--model_dirs",
                           mock_dir, os.path.join(out_dir, "random"),
                           "--results_path",
                           str(tmp_path / name / "res_final.json")])
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    for model in ("random", "mock"):
        _same_dirs(tmp_path / "port" / "results" / model,
                   tmp_path / "jax" / "results" / model)
    assert filecmp.cmp(tmp_path / "port" / "res_final.json",
                       tmp_path / "jax" / "res_final.json", shallow=False)
    final = json.loads((tmp_path / "port" / "res_final.json").read_text())
    # Items 2-9 voted three times; the mock is right on the a-answers.
    assert final[0]["model"] == "mock" and final[0]["num_questions"] == 8
    assert final[0]["num_correct"] == 2
