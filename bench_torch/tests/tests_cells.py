"""The cells the tests cover: every cell of BENCHMARK.json."""
import json
from pathlib import Path

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text()
)["workloads"]]
