"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository. Tests that need a CUDA card carry the
``card`` marker and skip, with a reason, where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


PARKED = ("fcd1-96k-tabs2.frames", "fcd2-192k-merged-tabs2.frames")

# per-layer metrics that only the parked frames cells report
PARKED_PER_LAYER = [
    {"name": "drain.wall_ms", "unit": "ms", "better": "lower",
     "source": "program_counter", "layer": "FEC drain",
     "moves": "stream_msps", "workloads": list(PARKED)},
    {"name": "kA_viterbi_roofline", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "FEC kernel A",
     "moves": "stream_msps", "workloads": list(PARKED)},
]


def parked_benchmark(path: Path) -> Path:
    """A copy of ``BENCHMARK.json`` at ``path`` with the entries of the
    parked cells, whose files are in ``portbench/`` but which
    ``BENCHMARK.json`` does not list: the 96 kS/s frames cell (its
    ``stream_msps`` spread too widely for any bound on a shared host) and
    the 192 kS/s cell. A parked cell reports what its configuration's
    listed cells report, and the metrics of ``PARKED_PER_LAYER``."""
    import json

    from portbench.cells import BENCHMARK

    bench = json.loads(BENCHMARK.read_text())
    listed = {c["name"] for c in bench["configs"]}
    for cell in PARKED:
        config, _, traffic = cell.partition(".")
        if config not in listed:
            listed.add(config)
            bench["configs"].append({
                "name": config, "source": "-",
                "file": f"portbench/configs/{config}.json", "reduced": [],
                "why": "-"})
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "-"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += list(PARKED)
    for m in bench["per_layer"]:
        configs = {w.partition(".")[0] for w in m["workloads"]}
        m["workloads"] += [c for c in PARKED
                           if c.partition(".")[0] in configs]
    bench["per_layer"] += PARKED_PER_LAYER
    path.write_text(json.dumps(bench))
    return path
