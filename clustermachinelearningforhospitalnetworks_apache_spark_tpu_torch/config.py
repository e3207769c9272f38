"""Pipeline configuration: the JAX package's ``config.py``, which mirrors
the reference script's ``CONFIG`` dict (``mllearnforhospitalnetwork.py
:40-50``) as a frozen dataclass loadable from JSON or command-line flags.

``mesh`` is a :class:`MeshConfig`, the shape of the (data, model) device
mesh that ``parallel.build_mesh`` lays out (the reference's ``hdfsMaster``
cluster URL, superseded by it and dropped on load), read from a JSON
config's ``mesh`` key and from ``--mesh-data`` / ``--mesh-model``, so a JAX
package config file loads unchanged and ``to_dict()`` equals the
reference's.  The device is not a config field: entry points take
``device=`` (the console entry ``--device``), default the card, and
``mesh=`` where they run over a mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

#: the reference's camelCase ``CONFIG`` keys, accepted by ``from_dict``
_ALIASES = {
    "appName": "app_name",
    "hdfsInputPath": "input_path",
    "checkpointLocation": "checkpoint_location",
    "outputTable": "output_table",
    "trainingWindowStart": "training_window_start",
    "trainingWindowEnd": "training_window_end",
    "modelSavePath": "model_save_path",
    "losThreshold": "los_threshold",
}

#: the reference's cluster-master key, superseded by ``mesh`` and dropped
_MESH_KEYS = ("hdfsMaster",)


@dataclass(frozen=True)
class MeshConfig:
    """Shape of the device mesh (the JAX package's ``MeshConfig``).

    ``data`` is the row axis (Spark's executor data parallelism), ``-1``
    meaning every device the model axis leaves; ``model`` splits KMeans'
    centers; ``dcn_hosts`` > 1 makes the data axis host-major across
    processes (``parallel.build_hybrid_mesh``)."""

    data: int = -1
    model: int = 1
    dcn_hosts: int = 1

    def axis_names(self) -> tuple[str, ...]:
        return ("data", "model")


@dataclass(frozen=True)
class PipelineConfig:
    app_name: str = "HospitalResourceDemandPrediction"        # :41 appName
    input_path: str = "./data/hospitals/incoming"             # :42 hdfsInputPath
    checkpoint_location: str = "./data/checkpoints/hospital"  # :43 checkpointLocation
    output_table: str = "hospital_unbounded_table"            # :44 the table the window query reads
    training_window_start: str = "2025-03-31 22:00:00"        # :45
    training_window_end: str = "2025-03-31 23:00:00"          # :46
    model_save_path: str = "./data/models/hospital"           # :48 modelSavePath
    los_threshold: float = 5.0            # :49 LOS_binary = LOS > threshold
    watermark_minutes: float = 10.0       # withWatermark("event_time", "10 minutes") :81
    train_fraction: float = 0.7           # randomSplit([0.7, 0.3], seed=42) :139
    split_seed: int = 42
    mesh: MeshConfig = field(default_factory=MeshConfig)   # supersedes :47 hdfsMaster
    plot_dir: str = "./data/plots"        # PNGs in place of plt.show() :215,:223
    tree_max_depth: int = 5               # Spark's DT/RF defaults
    rf_num_trees: int = 20

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PipelineConfig":
        d = dict(d)
        if isinstance(d.get("mesh"), Mapping):
            d["mesh"] = MeshConfig(**d["mesh"])
        for old, new in _ALIASES.items():
            if old in d:
                d[new] = d.pop(old)
        for k in _MESH_KEYS:
            d.pop(k, None)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_flags(cls, argv: Sequence[str] | None = None) -> "PipelineConfig":
        """``--key=value`` for every field, over ``--config`` (a JSON file)
        when given; ``--mesh-data`` / ``--mesh-model`` set the mesh's axes."""
        p = argparse.ArgumentParser(description="hospital pipeline config")
        p.add_argument("--config", help="JSON config file", default=None)
        p.add_argument("--mesh-data", type=int, default=None)
        p.add_argument("--mesh-model", type=int, default=None)
        for f in dataclasses.fields(cls):
            if f.name == "mesh":
                continue
            p.add_argument("--" + f.name.replace("_", "-"), type=type(f.default), default=None)
        ns = p.parse_args(argv)
        base = cls.from_json(ns.config) if ns.config else cls()
        over = {
            k: v for k, v in vars(ns).items()
            if v is not None and k not in ("config", "mesh_data", "mesh_model")
        }
        cfg = base.replace(**over) if over else base
        if ns.mesh_data is not None or ns.mesh_model is not None:
            cfg = cfg.replace(mesh=MeshConfig(
                data=ns.mesh_data if ns.mesh_data is not None else cfg.mesh.data,
                model=ns.mesh_model if ns.mesh_model is not None else cfg.mesh.model,
            ))
        return cfg
