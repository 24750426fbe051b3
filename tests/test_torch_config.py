"""The port's YAML configuration (``spatialflink_tpu_torch/config.py``)
against the JAX package's loader (``tests/test_config.py`` is the
oracle): every case of that file through the port, each parsed section
equal field for field to the JAX loader's, and the backend extension
the port changes: ``backend: cuda | cpu``, ``cuda`` by default, ``tpu``
refused naming both accepted values (the JAX loader pins the reverse,
``tests/test_config.py:96-101``).
"""

import dataclasses

import pytest
from test_config import REFERENCE_YML

from spatialflink_tpu import config as jconfig

from spatialflink_tpu_torch import config as tconfig
from spatialflink_tpu_torch.config import ConfigError, Params


def _fields(obj):
    """A parsed section as plain values, nested sections included (the
    backend left out: the two loaders name different devices)."""
    return {k: v for k, v in dataclasses.asdict(obj).items()
            if k != "backend"}


def _jax(text):
    return jconfig.Params.loads(text.replace("backend: cuda",
                                             "backend: tpu"))


def test_reference_yml_loads():
    p = Params.loads(REFERENCE_YML)
    assert p.cluster_mode is False
    assert p.input_stream1.topic_name == "TaxiDrive17MillionGeoJSON"
    assert p.input_stream1.grid_bbox == [115.5, 39.6, 117.6, 41.1]
    assert p.query.k == 100
    assert p.query.parallelism == 15
    assert p.query.query_points[0] == [116.14319, 40.07271]
    assert len(p.query.query_polygons[0]) == 5
    assert p.query.traj_deletion_threshold == 1000
    assert p.window.interval_ms == 5000 and p.window.step_ms == 5000
    assert p.backend == "cuda"  # the port's default: the card
    assert p.device_mesh == [1]


@pytest.mark.parametrize("section", ["input_stream1", "query", "window"])
def test_sections_equal_the_jax_loader(section):
    got = getattr(Params.loads(REFERENCE_YML), section)
    want = getattr(jconfig.Params.loads(REFERENCE_YML), section)
    assert _fields(got) == _fields(want)
    assert type(got).__name__ == type(want).__name__


def test_grid_from_config():
    p = Params.loads(REFERENCE_YML)
    g = p.input_stream1.make_grid()
    assert g.n == 100
    assert g.min_x == 115.5
    assert type(g).__module__ == "spatialflink_tpu_torch.grid"


@pytest.mark.parametrize("cells", ["numGridCells: 100\n  cellLength: 0",
                                   "numGridCells: 0\n  cellLength: 0.021",
                                   "numGridCells: 37\n  cellLength: 0"])
def test_make_grid_equals_the_jax_grid(cells):
    text = REFERENCE_YML.replace("numGridCells: 100\n  cellLength: 0", cells)
    g = Params.loads(text).input_stream1.make_grid()
    j = jconfig.Params.loads(text).input_stream1.make_grid()
    for name in ("n", "min_x", "max_x", "min_y", "max_y", "cell_length",
                 "num_cells"):
        assert getattr(g, name) == getattr(j, name), name


def test_missing_input_stream_fails():
    with pytest.raises(ConfigError, match="inputStream1"):
        Params.loads("clusterMode: False")


def test_bad_format_fails():
    bad = REFERENCE_YML.replace('format: "GeoJSON"', 'format: "XML"')
    with pytest.raises(ConfigError, match="format"):
        Params.loads(bad)


def test_degenerate_bbox_fails():
    bad = REFERENCE_YML.replace(
        "gridBBox: [115.5, 39.6, 117.6, 41.1]",
        "gridBBox: [115.5, 39.6, 115.5, 41.1]")
    with pytest.raises(ConfigError, match="degenerate"):
        Params.loads(bad)


def test_bad_aggregate_fails():
    bad = REFERENCE_YML.replace('aggregateFunction: "SUM"',
                                'aggregateFunction: "MEDIAN"')
    with pytest.raises(ConfigError, match="aggregateFunction"):
        Params.loads(bad)


@pytest.mark.parametrize("edit,match", [
    (("k: 100", "k: 0"), "query.k"),
    (('type: "TIME"', 'type: "SESSION"'), "window.type"),
    (("interval: 5", "interval: -1"), "interval/step"),
    (("numGridCells: 100", "numGridCells: 0"), "numGridCells/cellLength"),
    (("gridBBox: [115.5, 39.6, 117.6, 41.1]", "gridBBox: [1, 2, 3]"),
     "gridBBox"),
])
def test_strictness_equals_the_jax_loader(edit, match):
    bad = REFERENCE_YML.replace(*edit)
    with pytest.raises(ConfigError, match=match) as got:
        Params.loads(bad)
    with pytest.raises(jconfig.ConfigError) as want:
        jconfig.Params.loads(bad)
    assert str(got.value) == str(want.value)


def test_backend_extension():
    p = Params.loads(REFERENCE_YML + "\nbackend: cpu\ndeviceMesh: [2, 4]\n")
    assert p.backend == "cpu"
    assert p.device_mesh == [2, 4]
    p = Params.loads(REFERENCE_YML + "\nbackend: CUDA\n")
    assert p.backend == "cuda"
    assert _fields(p) == _fields(_jax(REFERENCE_YML + "\nbackend: cuda\n"))


def test_backend_tpu_is_refused_naming_both_values():
    with pytest.raises(ConfigError, match="backend") as err:
        Params.loads(REFERENCE_YML + "\nbackend: tpu\n")
    msg = str(err.value)
    assert "cuda or cpu" in msg and "'tpu'" in msg
    assert "tpu or cpu" not in msg
    # The JAX loader keeps its own pair: it refuses cuda.
    with pytest.raises(jconfig.ConfigError, match="tpu or cpu"):
        jconfig.Params.loads(REFERENCE_YML + "\nbackend: cuda\n")


def test_type_tag_stripped_and_file_load(tmp_path):
    path = tmp_path / "geoflink-conf.yml"
    path.write_text(REFERENCE_YML)
    assert REFERENCE_YML.startswith("!!GeoFlink")
    assert Params.load(str(path)) == Params.loads(REFERENCE_YML)


def test_public_names_equal_the_jax_module():
    public = {n for n in vars(jconfig) if not n.startswith("_")
              and getattr(getattr(jconfig, n), "__module__", None)
              == jconfig.__name__}
    assert public <= set(vars(tconfig))
    for name in public:
        assert getattr(tconfig, name).__module__ == tconfig.__name__
