"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the cell's capture from the seed, builds its configuration's stages
and a ``jsdr_tpu_torch.runtime.executor.Session`` on the card, warms up,
runs ``Session.run`` for ``--seconds`` on the benchmark's own chunk
source, checks what the window produced against the plain reference, and
prints one JSON line: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics read from a profiled stretch of
the window. The numbers of the check, each beside its limit, end the
standard error and the result line. ``--control 1`` judges the
reference computed in bfloat16 in the program's place (for setting
limits; the benchmark's own runs never do).

A machine with no CUDA card, or with fewer cards than the cell asks for,
gets an error and no result. So does a process in which JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = Path(__file__).resolve().parent / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "jsdr_tpu")


def _environment() -> None:
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds: the port's kernels build under
    ``build/jsdr_tpu_torch/`` at the root (its own fixed path); anything
    else that caches goes under ``portbench/.cache/``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _environment()
    if not (ROOT / "jsdr_tpu_torch").is_dir():
        return _fail(f"the port (jsdr_tpu_torch) is not in {ROOT}: this "
                     "checkout holds only the benchmark")
    sys.path.insert(0, str(ROOT))
    from portbench.cells import load_cell

    cell = load_cell(a.workload)
    # the deployment's thread setting (configuration), before torch loads
    threads = str(cell.config["torch_threads"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = threads
    import torch

    torch.set_num_threads(cell.config["torch_threads"])
    from portbench import harness

    if not torch.cuda.is_available():
        return _fail("no CUDA card (torch.cuda.is_available() is False); "
                     "the benchmark measures the port on a card and does "
                     "not fall back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{a.workload} asks for {cell.chips} cards, "
                     f"{torch.cuda.device_count()} present")
    res = harness.run(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                      T_START, control=bool(a.control))
    bad = forbidden_modules()
    if bad:
        return _fail(f"the run loaded {bad}; the port's benchmark loads "
                     "neither JAX nor the JAX package")
    check = res.pop("check")
    for name, value, limit in check:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips,
                       "memory_peak_bytes": res["memory_peak_bytes"]}}
    tr = res["trace"]
    if tr is not None:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tr.as_json()
    line["info"] = {"blocks": res["blocks"], "window_s": res["window_s"],
                    "check_s": res["check_seconds"],
                    "per_second_msps": res["per_second"]}
    line["check"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in check}
    print(harness.result_json(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
