"""Everything is found by its name in BENCHMARK.json: a configuration, a
traffic mix, a driver and a per-layer metric added as files to a copy of
the benchmark run with no edit to any file that was there."""
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

DRIVER = '''
def run(ctx):
    t0 = ctx.open_window()
    ctx.close_window()
    return {"attempted": ctx.traffic["n"], "failed": 0,
            "metrics": {"dummy_rate": ctx.config["width"] * 1.5},
            "records": {"seen": ctx.traffic["n"]},
            "checks": {"gap": (0.0, ctx.traffic["limit"])}, "memory_peak_bytes": 0}
'''
METRIC = '''
def read(run):
    return float(run.records["seen"]) * 2
'''


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    (b / "configs" / "dummy.json").write_text(json.dumps({"width": 4}))
    (b / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"driver": "dummy_driver", "n": 7, "limit": 1.0}))
    (b / "drivers" / "dummy_driver.py").write_text(DRIVER)
    (b / "metrics" / "dummy.count.py").write_text(METRIC)
    spec["configs"].append({"name": "dummy", "source": "https://example.org", "reduced": [],
                            "file": "benchmark/configs/dummy.json", "why": "test"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy_mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "dummy_rate", "unit": "x/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["dummy-cell"]})
    spec["per_layer"].append({"name": "dummy.count", "unit": "n", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "dummy_rate", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); from benchmark import harness; "
            "print(json.dumps([harness.run(['--workload', 'dummy-cell', '--seed', '5', "
            "'--seconds', '1', '--trace', t], test={'device': 'cpu'}) for t in '01']))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and plain["attempted"] == 7
    assert plain["metrics"]["dummy_rate"]["value"] == 6.0
    assert set(plain["metrics"]) == {"dummy_rate", "setup_s"}
    assert traced["metrics"] == {"dummy.count": {"value": 14.0, "unit": "n"}}
    assert list(plain)[-1] == "checks"
