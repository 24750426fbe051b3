"""YAML configuration system.

Re-designs the reference's snakeyaml-bean config
(``conf/geoflink-conf.yml`` tagged ``!!GeoFlink.utils.ConfigType`` →
``utils/ConfigType.java`` bean → ``utils/Params.java`` validation with hard
failures on missing/invalid keys, Params.java:75+). Same YAML schema as
the JAX package's loader (the reference's conf files load unchanged,
minus the Java type tag), the same validation strictness, and the same
extensions: ``backend`` and ``deviceMesh``.

The backend is ``cuda`` (the default: the operators run on the card) or
``cpu``: the torch device type an operator is given.
``deviceMesh`` is the job's mesh shape: the streaming job shards its
operators over that many of the backend's devices (``parallel/``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml

_FORMATS = {"GeoJSON", "WKT", "CSV", "TSV"}
_AGGREGATES = {"ALL", "SUM", "AVG", "MIN", "MAX"}
_WINDOW_TYPES = {"TIME", "COUNT"}
_BACKENDS = ("cuda", "cpu")


class ConfigError(ValueError):
    pass


@dataclass
class StreamConfig:
    """One input stream section (inputStream1/2 in geoflink-conf.yml:10-45)."""

    topic_name: str = ""
    format: str = "GeoJSON"
    date_format: Optional[str] = None
    geojson_schema_attr: List[str] = field(default_factory=lambda: ["oID", "timestamp"])
    csv_tsv_schema_attr: List[int] = field(default_factory=lambda: [0, 1, 2, 3])
    grid_bbox: List[float] = field(default_factory=lambda: [0.0, 0.0, 1.0, 1.0])
    num_grid_cells: int = 100
    cell_length: float = 0.0
    delimiter: str = ","
    charset: str = "UTF-8"

    @classmethod
    def from_dict(cls, d: Dict[str, Any], name: str) -> "StreamConfig":
        fmt = d.get("format", "GeoJSON")
        if fmt not in _FORMATS:
            raise ConfigError(f"{name}.format must be one of {_FORMATS}, got {fmt!r}")
        bbox = d.get("gridBBox")
        if not bbox or len(bbox) != 4:
            raise ConfigError(f"{name}.gridBBox must be [minX, minY, maxX, maxY]")
        if not (bbox[0] < bbox[2] and bbox[1] < bbox[3]):
            raise ConfigError(f"{name}.gridBBox is degenerate: {bbox}")
        ncells = int(d.get("numGridCells", 0) or 0)
        clen = float(d.get("cellLength", 0) or 0)
        if ncells <= 0 and clen <= 0:
            raise ConfigError(f"{name}: one of numGridCells/cellLength must be > 0")
        date_format = d.get("dateFormat")
        if date_format in ("null", "None", ""):
            date_format = None
        return cls(
            topic_name=d.get("topicName", ""),
            format=fmt,
            date_format=date_format,
            geojson_schema_attr=list(d.get("geoJSONSchemaAttr", ["oID", "timestamp"])),
            csv_tsv_schema_attr=[int(i) for i in d.get("csvTsvSchemaAttr", [0, 1, 2, 3])],
            grid_bbox=[float(v) for v in bbox],
            num_grid_cells=ncells,
            cell_length=clen,
            delimiter=d.get("delimiter", ","),
            charset=d.get("charset", "UTF-8"),
        )

    def make_grid(self):
        """The port's ``UniformGrid`` over ``gridBBox``: ``cellLength``
        when it is set, else ``numGridCells`` a side."""
        from spatialflink_tpu_torch.grid import UniformGrid

        min_x, min_y, max_x, max_y = self.grid_bbox
        if self.cell_length > 0:
            return UniformGrid.from_cell_length(
                self.cell_length, min_x, max_x, min_y, max_y
            )
        return UniformGrid(self.num_grid_cells, min_x, max_x, min_y, max_y)


@dataclass
class QueryConfig:
    """query: section (geoflink-conf.yml:52-77)."""

    option: int = 1
    parallelism: int = 1
    approximate: bool = False
    radius: float = 0.0
    aggregate_function: str = "SUM"
    k: int = 1
    omega_duration: int = 1
    traj_ids: List[str] = field(default_factory=list)
    query_points: List[List[float]] = field(default_factory=list)
    query_polygons: List[List[List[float]]] = field(default_factory=list)
    query_linestrings: List[List[List[float]]] = field(default_factory=list)
    traj_deletion_threshold: int = 0
    out_of_order_tuples: int = 0
    incremental: bool = False  # extension: pane/ListState-carry execution

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QueryConfig":
        agg = d.get("aggregateFunction", "SUM")
        if agg not in _AGGREGATES:
            raise ConfigError(f"query.aggregateFunction must be in {_AGGREGATES}")
        k = int(d.get("k", 1))
        if k < 1:
            raise ConfigError("query.k must be >= 1")
        th = d.get("thresholds", {}) or {}
        return cls(
            option=int(d.get("option", 1)),
            parallelism=int(d.get("parallelism", 1)),
            approximate=bool(d.get("approximate", False)),
            radius=float(d.get("radius", 0.0)),
            aggregate_function=agg,
            k=k,
            omega_duration=int(d.get("omegaDuration", 1)),
            traj_ids=[str(t) for t in d.get("trajIDs", [])],
            query_points=[[float(c) for c in p] for p in d.get("queryPoints", [])],
            query_polygons=[
                [[float(c) for c in pt] for pt in poly]
                for poly in d.get("queryPolygons", [])
            ],
            query_linestrings=[
                [[float(c) for c in pt] for pt in ls]
                for ls in d.get("queryLineStrings", [])
            ],
            traj_deletion_threshold=int(th.get("trajDeletion", 0)),
            out_of_order_tuples=int(th.get("outOfOrderTuples", 0)),
            incremental=bool(d.get("incremental", False)),
        )


@dataclass
class WindowConfig:
    """window: section (geoflink-conf.yml:79-82). interval/step in seconds."""

    type: str = "TIME"
    interval: float = 5.0
    step: float = 5.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WindowConfig":
        wtype = d.get("type", "TIME")
        if wtype not in _WINDOW_TYPES:
            raise ConfigError(f"window.type must be in {_WINDOW_TYPES}")
        interval = float(d.get("interval", 5))
        step = float(d.get("step", interval))
        if interval <= 0 or step <= 0:
            raise ConfigError("window.interval/step must be positive")
        return cls(type=wtype, interval=interval, step=step)

    @property
    def interval_ms(self) -> int:
        return int(self.interval * 1000)

    @property
    def step_ms(self) -> int:
        return int(self.step * 1000)


@dataclass
class Params:
    """Validated top-level parameters (utils/Params.java)."""

    cluster_mode: bool = False
    kafka_bootstrap_servers: str = ""
    input_stream1: StreamConfig = field(default_factory=StreamConfig)
    input_stream2: Optional[StreamConfig] = None
    output_topic: str = ""
    output_delimiter: str = ","
    query: QueryConfig = field(default_factory=QueryConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    # Extensions: the execution backend and the device mesh.
    backend: str = "cuda"
    device_mesh: List[int] = field(default_factory=lambda: [1])

    @classmethod
    def load(cls, path: str) -> "Params":
        with open(path) as f:
            text = f.read()
        return cls.loads(text)

    @classmethod
    def loads(cls, text: str) -> "Params":
        # Strip the Java bean type tag if present (geoflink-conf.yml:1).
        lines = [
            ln for ln in text.splitlines() if not ln.strip().startswith("!!")
        ]
        raw = yaml.safe_load("\n".join(lines)) or {}
        if "inputStream1" not in raw:
            raise ConfigError("missing required section: inputStream1")
        out_raw = raw.get("outputStream", {}) or {}
        backend = str(raw.get("backend", "cuda")).lower()
        if backend not in _BACKENDS:
            raise ConfigError(
                f"backend must be {' or '.join(_BACKENDS)}, got {backend!r}")
        return cls(
            cluster_mode=bool(raw.get("clusterMode", False)),
            kafka_bootstrap_servers=str(raw.get("kafkaBootStrapServers", "")),
            input_stream1=StreamConfig.from_dict(raw["inputStream1"], "inputStream1"),
            input_stream2=(
                StreamConfig.from_dict(raw["inputStream2"], "inputStream2")
                if raw.get("inputStream2")
                else None
            ),
            output_topic=out_raw.get("topicName", ""),
            output_delimiter=out_raw.get("delimiter", ","),
            query=QueryConfig.from_dict(raw.get("query", {}) or {}),
            window=WindowConfig.from_dict(raw.get("window", {}) or {}),
            backend=backend,
            device_mesh=[int(v) for v in raw.get("deviceMesh", [1])],
        )
