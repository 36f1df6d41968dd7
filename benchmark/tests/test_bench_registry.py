import importlib.util
import json
import os
import shutil

import pytest

from benchmark import registry

HERE = registry.HERE


def _names(sub, ext):
    return sorted(f[: -len(ext)] for f in os.listdir(os.path.join(HERE, sub)) if f.endswith(ext))


@pytest.mark.parametrize("name", _names("configs", ".json"))
def test_every_config_is_found(name):
    cfg = registry.config(name)
    assert cfg["name"] == name
    registry.counts(cfg["family"]).dims(cfg)
    assert registry.reference(cfg["family"]).Reference
    assert registry.system(cfg["family"]).Session


@pytest.mark.parametrize("name", _names("traffic", ".json"))
def test_every_mix_is_found(name):
    assert registry.traffic(name)["name"] == name


@pytest.mark.parametrize("name", _names("metrics", ".py"))
def test_every_metric_is_found(name):
    m = registry.metric(name)
    assert isinstance(m.UNIT, str) and callable(m.read)


def test_benchmark_json_names_files_that_exist():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        assert registry.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        registry.config(w["config"]), registry.traffic(w["traffic"]), registry.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert registry.metric(m["name"]).UNIT == m["unit"]


def test_a_new_file_is_taken_without_an_edit(tmp_path):
    """A copy of the benchmark, with a new config, mix and metric added as
    files: its registry finds each by name."""
    copy = tmp_path / "benchmark"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = registry.config("deepseek7b-q4_0")
    cfg["name"] = "new-model"
    (copy / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "new-mix.json").write_text(json.dumps(dict(registry.traffic("chat"), name="new-mix")))
    (copy / "metrics" / "new.metric.py").write_text("UNIT = 'ms'\n\ndef read(run):\n    return 1.0\n")
    spec = importlib.util.spec_from_file_location("copied_registry", copy / "registry.py")
    reg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reg)
    assert reg.config("new-model")["name"] == "new-model"
    assert reg.traffic("new-mix")["name"] == "new-mix"
    assert reg.metric("new.metric").read(None) == 1.0
    (copy / "metrics" / "new.py").write_text("UNIT = 'ms'\n\ndef read(run):\n    return 2.0\n")
    assert reg.metric("new.other").read(None) == 2.0


def test_a_split_quantity_shares_its_reader():
    assert registry.metric("device_idle.chat") is registry.metric("device_idle.rag") is registry.metric("device_idle")
    with pytest.raises(FileNotFoundError):
        registry.metric("no_such_metric")


def test_names_are_checked():
    with pytest.raises(ValueError):
        registry.config("../BENCHMARK")
