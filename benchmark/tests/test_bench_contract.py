"""BENCHMARK.json as the harness reads it: every cell loads from data
files alone, everything it names is found by name, every metric has its
reader, and every cell that lists a per-layer metric reports the
end-to-end metric it moves."""

import re

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_and_units(spec):
    metrics = spec["end_to_end"] + spec["per_layer"]
    for entry in spec["configs"] + spec["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


def test_cells_load_from_data(spec):
    import importlib
    for w in spec["workloads"]:
        c = run.load_cell(spec, w["name"])
        lp = run.loop(c.params["loop"])
        assert callable(lp.setup) and callable(lp.window)
        gen = importlib.import_module(
            f"benchmark.gen.mix.{c.conf['pods']['generator']}")
        assert callable(gen.make)
        assert any(m["name"] != "setup_s" for m in c.end_to_end)
        assert c.per_layer


def test_every_metric_has_a_reader(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_a_new_cell_needs_only_new_files(spec, tmp_path, monkeypatch):
    """A configuration, a mix, a loop and a metric added as files are
    found by their names, with no edit to a file that is there."""
    bench = tmp_path / "benchmark"
    for sub in ("traffic", "loops", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "traffic" / "trickle.json").write_text(
        '{"loop": "trickle", "pods_per_episode": 5}')
    (bench / "loops" / "trickle.py").write_text(
        "def setup(w, span):\n    pass\n\n\n"
        "def window(w, seconds, span):\n    return {}\n")
    (bench / "metrics" / "trickle_s.py").write_text(
        "def read(run):\n    return 1.5\n")
    monkeypatch.setattr(run, "BENCH", bench)
    spec["workloads"].append({"name": "density-5k.trickle",
                              "config": "density-5k", "traffic": "trickle",
                              "chips": 1, "why": "test"})
    c = run.load_cell(spec, "density-5k.trickle")
    assert c.params["pods_per_episode"] == 5
    assert run.loop(c.params["loop"]).window(None, 1, None) == {}
    assert run.reader("trickle_s")(None) == 1.5


def test_moves_is_reported_where_listed(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)
