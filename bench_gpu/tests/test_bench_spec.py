"""Every piece that BENCHMARK.json names is found by its name, and the file
keeps the benchmark contract's shape."""

import json
import re

import pytest

from bench_gpu import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench_gpu"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_by_name(cell):
    w = spec.workload(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    # a cell on four cards runs one rank a card: its configuration states
    # them, and each of its chunks divides over them
    assert cfg["chips"] == w["chips"]
    assert cfg.get("chunk", cfg["tuples"]) % w["chips"] == 0
    assert spec.entry(cfg["entry"]).Caller
    assert traffic["rotation"] and traffic["message_bytes"] > 0
    assert all(0 <= e["batch"] < traffic["distinct_batches"]
               for e in traffic["rotation"])
    kinds = {m["name"] for m in spec.metrics_for(cell, "end_to_end")}
    assert {"setup_s", "verifies_per_s"} <= kinds
    assert spec.metrics_for(cell, "per_layer")


def test_four_chip_cells():
    """At most a quarter of the cells (and always one) take four cards."""
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"bench_gpu/configs/{c['name']}.json"
    cfg = spec.config(c["name"])
    assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    assert 1 <= len(c["why"]) <= 200
    assert cfg["reduced"] == c["reduced"]
    assert c["name"] in {w["config"] for w in B["workloads"]}


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.reader(m["name"]).read)
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        assert m["layer"] and "\n" not in m["layer"]


@pytest.mark.parametrize("key", sorted(spec.kernel_work()))
def test_kernel_work_files(key):
    w = spec.kernel_work()[key]
    assert w["products_per_lane"] > 0 and w["mads_per_product"] == 648
    assert w["els_read"] > 0 and w["els_written"] > 0
    assert w["bytes_per_el"] == 144
    re.compile(w["kernel_regex"])


def test_every_kernel_of_the_port_has_a_work_file():
    from bn254_tpu_torch.kernels import fused

    assert set(fused.KERNELS) | {"montmul"} == set(spec.kernel_work())


def test_work_regexes_name_one_kernel_each():
    rows = ["void coop_kernel<bn254::CoopMillerDblBody, 8>(long const*, "
            "long*, long)",
            "void coop_kernel<bn254::CoopMillerDblBody2, 64>(long const*, "
            "long*, long)",
            "el_pow_step_mul_kernel(long const*, long*, long)",
            "(anonymous namespace)::montmul_kernel(long const*, long const*, "
            "long*, long)"]
    work = spec.kernel_work()
    for row, key in zip(rows, ["miller_dbl_body", "miller_dbl_body2",
                               "el_pow_step_mul", "montmul"]):
        hits = [k for k, w in work.items() if re.search(w["kernel_regex"], row)]
        assert hits == [key]
