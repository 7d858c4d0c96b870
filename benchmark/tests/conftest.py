"""Shared fixtures of the benchmark's own tests. The card is looked for
inside a fixture, never while a module is imported."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return "cuda"


@pytest.fixture
def spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def tiny_spec(spec, tmp_path):
    """BENCHMARK.json with each configuration cut to 30 nodes."""
    for c in spec["configs"]:
        with open(ROOT / c["file"]) as f:
            conf = json.load(f)
        conf["cluster"]["nodes"] = 30
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(conf))
        c["file"] = str(path)
    return spec


@pytest.fixture
def tiny():
    """The tiny runs' numbers: 300 pods an episode, and a short wait for
    pods a planted fault leaves pending."""
    return {"pods_per_episode": 300, "settle_s": 3.0}
