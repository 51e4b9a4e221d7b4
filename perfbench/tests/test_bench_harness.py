"""The harness on the CPU at tiny sizes: each driver's result line, the
reference against the port, a cell, configuration and metric added as
new files only, the exits without a card or with JAX loaded."""

import hashlib
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from perfbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("bench"))


def _run(root, workload, trace, seed=2**33 + 1, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tiny.run_main(root, ["--workload", workload, "--seed", str(seed),
                                  "--seconds", "1", "--trace", str(trace)],
                           device="cpu", **kw)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _shape(res, trace):
    keys = list(res)
    assert [k for k in keys if k != "breakdown"] == KEYS
    assert keys[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_seg_driver_line_and_reference(checkout):
    rc, res = _run(checkout, "tiny.seg", 0)
    assert rc == 0
    _shape(res, 0)
    assert set(res["metrics"]) == {"setup_s", "train_samples_per_s",
                                   "peak_mem_gb"}
    # the port's twins on the CPU against the plain reference: the first
    # step's gradient to float32 rounding
    assert res["checks"]["grad_gap"]["value"] < 1e-3
    assert res["checks"]["loss_gap"]["value"] < 1e-3
    rc, res = _run(checkout, "tiny.seg", 1)
    assert rc == 0
    _shape(res, 1)
    assert "step_mfu.train" in res["metrics"]


def test_det_driver_line_and_reference(checkout):
    restore = tiny.det_geometry()
    try:
        rc, res = _run(checkout, "tiny.det", 0)
        assert rc == 0
        _shape(res, 0)
        assert set(res["metrics"]) == {"setup_s", "infer_samples_per_s",
                                       "latency_p95_ms", "peak_mem_gb"}
        assert res["checks"]["decode_gap"]["value"] < 1e-4
        assert res["checks"]["nms_mismatch"]["value"] == 0.0
        # in float32 the port's heads are the reference's to rounding
        tiny.TINY_DET_CFG["dtype"] = "float32"
        root32 = tiny.make_checkout(checkout.parent / "f32")
        rc, res = _run(root32, "tiny.det", 0)
        assert rc == 0 and res["checks"]["head_gap"]["value"] < 1e-4
    finally:
        tiny.TINY_DET_CFG["dtype"] = tiny.DTYPE
        restore()


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_as_new_files(tmp_path):
    root = tiny.make_checkout(tmp_path)
    before = _digests(root)
    bench_file = root / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    cfg = json.loads((root / "perfbench/configs/tiny_linkunet.json")
                     .read_text())
    cfg["cr"] = 0.0625
    (root / "perfbench/configs/dummy_net.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "perfbench/traffic/tiny_semkitti.json")
                    .read_text())
    tr["pool_batches"] = 4
    (root / "perfbench/traffic/dummy_mix.json").write_text(json.dumps(tr))
    (root / "perfbench/metrics/dummy.samples_traced.py").write_text(
        '"""Samples in the window."""\n\n\ndef read(run):\n'
        '    return float(run.attempted)\n')
    # the one edit: BENCHMARK.json gains the entries
    bench["configs"].append({"name": "dummy_net", "source": "test",
                             "file": "perfbench/configs/dummy_net.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_net",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy.samples_traced",
                               "unit": "samples", "better": "higher",
                               "source": "program_counter", "layer": "input",
                               "moves": "train_samples_per_s",
                               "workloads": ["dummy.cell"]})
    bench["end_to_end"][1]["workloads"].append("dummy.cell")
    bench_file.write_text(json.dumps(bench))
    rc, res = _run(root, "dummy.cell", 1)
    assert rc == 0
    assert res["metrics"]["dummy.samples_traced"]["value"] == res["attempted"]
    after = _digests(root)
    changed = [p for p in before if before[p] != after.get(p)]
    assert changed == [bench_file]


def test_forbidden_modules_by_whole_top_level_name(checkout, monkeypatch):
    from perfbench import harness
    monkeypatch.setitem(sys.modules, "link_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "link_tpu.ops", object())
    assert harness.forbidden_modules() == ["jax", "link_tpu"]


def test_a_run_that_loaded_jax_prints_no_result(checkout, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    rc, res = _run(checkout, "tiny.seg", 0)
    assert rc != 0 and res is None


def test_no_card_no_result(checkout):
    # on this CPU-only machine the run stops before any work
    proc = subprocess.run([sys.executable, str(checkout / "perfbench/run.py"),
                           "--workload", "seg_train.linkunet.b2", "--seed",
                           "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import perfbench.reference.linkunet, "
            "perfbench.reference.centerpoint, perfbench.reference.sparse; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'link_tpu_torch', 'link_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tiny.REPO))
    assert out.stdout.strip() == "[]", out.stderr
    for f in (tiny.REPO / "perfbench/reference").glob("*.py"):
        text = f.read_text()
        assert "link_tpu" not in text.replace("link_tpu_torch", "") or \
            "import" not in text
        assert "import link_tpu_torch" not in text
        assert "from link_tpu_torch" not in text
