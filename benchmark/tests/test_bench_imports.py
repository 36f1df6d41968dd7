"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the port."""

import io
import subprocess
import sys
import types

from benchmark import registry, run
from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "llama_swift_tpu"}

RUN = """
import sys
from benchmark import run
from benchmark.tests import tiny
res = run.run_cell("deepseek7b-q4_0.chat", 9, 1.5, True, device="cpu", cfg=tiny.config(), mix=tiny.mix(),
                   limits=tiny.LIMITS, log=lambda *a: None)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE = """
import sys
from benchmark import registry
for fam in {families}:
    registry.reference(fam)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_names(RUN)
    assert "llama_swift_torch" in names and "torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    fams = sorted({registry.config(c["name"])["family"] for c in registry.benchmark()["configs"]})
    names = _top_names(REFERENCE.format(families=fams))
    assert "torch" in names
    assert not names & (FORBIDDEN | {"llama_swift_torch"})


def _tiny_result(seed):
    return run.run_cell("deepseek7b-q4_0.chat", seed, 1.5, False, device="cpu", cfg=tiny.config(),
                        mix=tiny.mix(), limits=tiny.LIMITS, log=lambda *a: None)


def test_jax_loaded_after_the_window_prints_no_result(monkeypatch):
    """A metric reader that loads JAX (here a stand-in module named ``jax``)
    after the window's own check: the run prints no result and fails."""
    reader = registry.metric("output_tok_s")

    def read(r):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return reader.read(r)

    monkeypatch.setattr(registry, "metric", lambda name: types.SimpleNamespace(UNIT="tokens/s", read=read))
    res = _tiny_result(31)
    out, err = io.StringIO(), io.StringIO()
    assert run.report(res, out=out, err=err) != 0
    assert out.getvalue() == ""
    assert "jax" in err.getvalue()


def test_a_clean_run_prints_its_result_last():
    import json

    out, err = io.StringIO(), io.StringIO()
    assert run.report(_tiny_result(32), out=out, err=err) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and "output_tok_s" in line["metrics"]
    assert err.getvalue().strip().splitlines()[-1].startswith("[bench] check ")
