"""The manifest and the data files it names."""
import json
import pathlib

import pytest

from benchlib import harness, manifest, work

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAN = manifest.load(ROOT)


def test_names_and_units_use_the_allowed_characters():
    assert manifest.problems(MAN) == []


def test_a_bad_name_or_unit_is_found():
    bad = json.loads(json.dumps(MAN))
    bad["per_layer"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "clouds per s"
    found = manifest.problems(bad)
    assert any("has space" in p for p in found)
    assert any("clouds per s" in p for p in found)


def test_each_metric_moves_a_metric_of_every_cell_that_lists_it():
    for m in MAN["per_layer"]:
        for c in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  manifest.end_to_end(MAN, c)}


def test_a_metric_whose_moves_a_listed_cell_lacks_is_found():
    bad = json.loads(json.dumps(MAN))
    bad["per_layer"][0]["workloads"] = ["model1.fleet_serve"]
    assert manifest.problems(bad)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric(cell):
    e2e = {m["name"] for m in manifest.end_to_end(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(MAN, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MAN["end_to_end"] + MAN["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(manifest.reader(metric))


@pytest.mark.parametrize("reader", sorted(
    p.stem for p in (manifest.BENCH / "metrics").glob("*.py")))
def test_every_reader_file_loads(reader):
    assert callable(manifest.reader(reader))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_config_and_traffic(cell):
    w = manifest.cell(MAN, cell)
    cfg = manifest.config(ROOT, MAN, w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == []
    assert callable(harness._runner(manifest.traffic(w["traffic"])["kind"]))


def test_paths_hold_the_command_and_every_file():
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")
    for c in MAN["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(MAN["paths"][0] + "/")


@pytest.mark.parametrize("name,macs", [("model1", 948054016),
                                       ("model2", 3791923200)])
def test_multiply_adds_a_cloud(name, macs):
    cfg = manifest.config(ROOT, MAN, name)
    assert work.macs_per_cloud(cfg) == macs
    assert round(macs / 1e9, 2) == {"model1": 0.95, "model2": 3.79}[name]


def test_mlp_least_time_counts_the_layers_function_not_its_kernels():
    cfg = {"n_points": 6, "head": [8, 3],
           "layers": [{"n_centers": 2, "n_neighbors": 2, "mlp": [4, 8]}]}
    rows, macs = 4, 4 * 8
    # each of the 6 points' int8 features, the int8 weights, a float32
    # pooled row a center: not a row a neighbour
    sa_bytes = 6 * 4 + 4 * 8 + 4 * 2 * 8
    head_bytes = 8 + 8 * 3 + 4 * 3
    want = (max(2 * rows * macs / work.INT8_OPS_PER_S,
                sa_bytes / work.HBM_BYTES_PER_S)
            + max(2 * 24 / work.INT8_OPS_PER_S,
                  head_bytes / work.HBM_BYTES_PER_S))
    assert work.mlp_least_seconds(cfg, 1) == pytest.approx(want)


@pytest.mark.parametrize("name", ["model1", "model2"])
def test_the_cells_mlps_are_compute_bound_at_their_batch(name):
    cfg = manifest.config(ROOT, MAN, name)
    ops = 2 * 128 * work.macs_per_cloud(cfg) / work.INT8_OPS_PER_S
    assert ops <= work.mlp_least_seconds(cfg, 128) < 1.01 * ops


@pytest.mark.parametrize("split", ["device_idle_pct.offline",
                                   "device_idle_pct.serve"])
def test_a_split_metric_is_read_by_its_shared_reader(split):
    from types import SimpleNamespace
    trace = SimpleNamespace(busy_s=3.0, window_s=4.0)
    assert manifest.reader(split)(SimpleNamespace(trace_reading=trace)) \
        == pytest.approx(25.0)


@pytest.mark.parametrize("table", ["fused_mlp", "geometry", "planning"])
def test_kernel_tables_name_their_layer(table):
    t = manifest.kernel_table(table)
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert t["layer"] in layers and t["patterns"]
