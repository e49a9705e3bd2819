"""What a cell is, read from the data files that define it.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``perfbench/configs/<config>.json`` (the sizes as they
run), the mix ``perfbench/traffic/<traffic>.json`` (its parameters, and
the ``driver`` that runs it), the limits of its correctness check
``perfbench/limits/<workload>.json``, and each per-layer metric
``perfbench/metrics/<metric>.py``. Nothing here names a cell: a new cell
is new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: Dict[str, Any]        # the configuration file's object
    mix: Dict[str, Any]         # the traffic file's object
    limits: Dict[str, float]    # compared number -> its limit
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], cell: str, cells_of: Dict[str, set]
             ) -> bool:
    """Whether a metric is reported in ``cell``: its ``workloads`` where
    it lists them, else every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return cell in cells_of.get(moves, set())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = _load_json(root / conf_entry["file"])
    mix = _load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(HERE / "limits" / f"{name}.json")
    cells_of = {m["name"]: set(m.get("workloads", cells))
                for m in bench["end_to_end"]}
    e2e = [m for m in bench["end_to_end"] if name in cells_of[m["name"]]]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, cells_of)]
    return Cell(name=name, chips=int(w["chips"]), conf=conf, mix=mix,
                limits={k: float(v) for k, v in limits.items()
                        if not k.startswith("_")},
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``perfbench/metrics/<name>.py``'s ``read``, loaded by path (a
    metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(conf: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file: every layer
    alike (one attention mixer, then the dense or MoE MLP)."""
    from repro_torch.models import LayerSpec, ModelConfig, MoESpec
    moe = None
    if conf.get("moe"):
        m = conf["moe"]
        moe = MoESpec(num_experts=m["num_experts"], top_k=m["top_k"],
                      expert_d_ff=m["expert_d_ff"],
                      capacity_factor=float(m["capacity_factor"]))
    layer = LayerSpec(kind="attn", window=conf.get("window"),
                      mlp=conf["mlp"])
    return ModelConfig(
        name=conf["name"], family=conf["family"],
        n_layers=conf["n_layers"], d_model=conf["d_model"],
        n_heads=conf["n_heads"], n_kv_heads=conf["n_kv_heads"],
        head_dim=conf["head_dim"], d_ff=conf["d_ff"], vocab=conf["vocab"],
        layout=tuple(layer for _ in range(conf["n_layers"])), moe=moe,
        qkv_bias=conf["qkv_bias"], rope_theta=conf["rope_theta"],
        rotary_pct=conf["rotary_pct"], norm=conf["norm"], act=conf["act"],
        pos=conf["pos"], tie_embeddings=conf["tie_embeddings"],
        attn_impl=conf["attn_impl"], dtype=conf["dtype"])
