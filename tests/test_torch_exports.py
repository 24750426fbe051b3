"""The PyTorch port's package surface against the JAX package's.

- Every name a JAX package ``__init__`` exports is, at the same package
  path of the port, either exported (by an object of the port, not of
  the JAX package) or listed in ``spatialflink_tpu_torch.NOT_EXPORTED``
  with the ROADMAP item it waits for or why it is absent; the listed
  names are really absent, and importing every port package imports no
  JAX.
- ``PointPointKNNQuery.run_wire_panes``, ``select_wire_digest_step``
  and ``select_wire_decoder`` take the JAX signatures' ``cand`` and
  ``interpret`` in the JAX positions: the reference's positional call
  binds as there, ``cand`` is validated, and ``interpret=True`` is
  accepted on the CPU, where it changes nothing, and raises on a card.
"""

import ast
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spatialflink_tpu.operators.knn_query import PointPointKNNQuery as JKnn
from spatialflink_tpu.ops import wire_codec as jwc
from spatialflink_tpu.ops import wire_knn as jwk

import spatialflink_tpu_torch as port
from spatialflink_tpu_torch import pipeline as tpipeline
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import QueryConfiguration
from spatialflink_tpu_torch.operators.knn_query import PointPointKNNQuery
from spatialflink_tpu_torch.ops import wire_codec as twc
from spatialflink_tpu_torch.ops import wire_knn as twk
from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGES = ["", "models", "ops", "streams", "utils", "apps", "operators",
                "mn", "sncb", "parallel"]


def jax_exports(path):
    """Names the JAX package ``__init__`` at ``path`` imports, read from
    its source (importing it would not tell re-exports from submodules)."""
    init = REPO / "spatialflink_tpu" / path / "__init__.py"
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("spatialflink_tpu"):
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("path", JAX_PACKAGES)
def test_every_jax_export_resolves_or_waits(path):
    names = jax_exports(path)
    assert names
    waiting = port.NOT_EXPORTED.get(path, {})
    if "*" in waiting:
        assert not (REPO / "spatialflink_tpu_torch" / path).exists()
        return
    pkg = importlib.import_module(
        "spatialflink_tpu_torch" + ("." + path if path else ""))
    # A waiting entry that names a module of the JAX package, not one of
    # its exports: the JAX file exists and the port's does not.
    modules = {name for name in waiting if name not in names}
    for name in modules:
        assert (REPO / "spatialflink_tpu" / path / f"{name}.py").exists()
        assert not (REPO / "spatialflink_tpu_torch" / path
                    / f"{name}.py").exists(), name
    for name in names:
        if name in waiting:
            # Absent, or a submodule of that name (ops/join_kernel.py).
            assert waiting[name] and not callable(getattr(pkg, name, None)), \
                name
            continue
        obj = getattr(pkg, name)
        if not hasattr(obj, "__module__"):
            # A constant (mn.BUCKETS_MS): the port's own equal copy.
            jobj = getattr(importlib.import_module(
                "spatialflink_tpu" + ("." + path if path else "")), name)
            assert obj == jobj and obj is not jobj, name
            continue
        assert obj.__module__.startswith("spatialflink_tpu_torch"), name
    assert set(waiting) - modules <= set(names)


def test_waiting_table_names_an_item_for_each_entry():
    for path, entries in port.NOT_EXPORTED.items():
        assert path in JAX_PACKAGES
        for name, why in entries.items():
            assert why.startswith(("A1", "no counterpart", "deliberately")), \
                (path, name)


def test_port_packages_import_no_jax():
    code = (
        "import sys\n"
        "import spatialflink_tpu_torch, spatialflink_tpu_torch.models, "
        "spatialflink_tpu_torch.ops, spatialflink_tpu_torch.streams, "
        "spatialflink_tpu_torch.utils, spatialflink_tpu_torch.apps, "
        "spatialflink_tpu_torch.operators, "
        "spatialflink_tpu_torch.utils.crs, "
        "spatialflink_tpu_torch.streams.deserialization, "
        "spatialflink_tpu_torch.streams.shapefile, "
        "spatialflink_tpu_torch.sncb, spatialflink_tpu_torch.mn, "
        "spatialflink_tpu_torch.sncb.runners, "
        "spatialflink_tpu_torch.sncb.mobility, "
        "spatialflink_tpu_torch.mn.queries, "
        "spatialflink_tpu_torch.telemetry, spatialflink_tpu_torch.faults, "
        "spatialflink_tpu_torch.ablation, spatialflink_tpu_torch.checkpoint, "
        "spatialflink_tpu_torch.driver, spatialflink_tpu_torch.state, "
        "spatialflink_tpu_torch.streams.sinks, "
        "spatialflink_tpu_torch.overload, spatialflink_tpu_torch.slo, "
        "spatialflink_tpu_torch.qserve, "
        "spatialflink_tpu_torch.ops.query_registry, "
        "spatialflink_tpu_torch.envvars, spatialflink_tpu_torch.config, "
        "spatialflink_tpu_torch.native, "
        "spatialflink_tpu_torch.streams.kafka, "
        "spatialflink_tpu_torch.streams.kafka_wire, "
        "spatialflink_tpu_torch.dag, spatialflink_tpu_torch.streaming_job, "
        "spatialflink_tpu_torch.parallel, "
        "spatialflink_tpu_torch.parallel.sharded, "
        "spatialflink_tpu_torch.parallel.partition, "
        "spatialflink_tpu_torch.parallel.halo, "
        "spatialflink_tpu_torch.parallel.multihost, "
        "spatialflink_tpu_torch.parallel.multihost_dryrun, "
        "spatialflink_tpu_torch.ops.halo\n"
        "assert spatialflink_tpu_torch.native.available()\n"
        "from spatialflink_tpu_torch.models import Point, MultiPoint, "
        "GeometryCollection\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spatialflink_tpu' or m.startswith('spatialflink_tpu.')]\n"
        "assert not bad, bad\n"
        "print(spatialflink_tpu_torch.UniformGrid(4, 0, 1, 0, 1))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("UniformGrid(n=4")


def test_sinks_and_driver_exported_and_their_fault_points_threaded():
    """The sinks are exported where the JAX package exports them (and
    off ``NOT_EXPORTED``), the driver's names at the top; the four fault
    points of the driver and the sinks are threaded: each is hit in its
    module and listed in the port's table of threaded points, no longer
    among those waiting for an item."""
    import spatialflink_tpu_torch.faults as tfaults
    from spatialflink_tpu_torch import driver, streams
    from spatialflink_tpu_torch.streams import sinks

    assert "streams" not in port.NOT_EXPORTED
    for name in ("CollectSink", "CsvFileSink", "PrintSink",
                 "TransactionalFileSink", "MultiSink", "LatencySink"):
        assert getattr(streams, name) is getattr(sinks, name)
    for name in ("WindowedDataflowDriver", "RetryPolicy", "strict_driver"):
        assert getattr(port, name) is getattr(driver, name)
    threaded, waiting = tfaults.__doc__.split("The other points wait")
    sites = {"sink.write": sinks, "dag.commit": sinks,
             "driver.window": driver, "source.stall": driver,
             "pipeline.ship": driver, "pipeline.fetch": driver}
    for point, mod in sites.items():
        assert f'faults.hit("{point}")' in Path(mod.__file__).read_text()
        assert f"``{point}``" in threaded and f"``{point}``" not in waiting
        assert "ROADMAP" not in tfaults.INJECTION_POINTS[point]


def test_overload_admit_threaded_and_the_slice_modules_at_their_paths():
    """``overload.admit`` is hit in the port's ``overload.py`` and listed
    as threaded; ``overload`` and ``slo`` sit at the JAX package's module
    paths with its public names (neither ``__init__`` re-exports them),
    and no source of the port raises naming A11.3."""
    import spatialflink_tpu_torch.faults as tfaults
    from spatialflink_tpu import overload as jov
    from spatialflink_tpu import slo as jslo
    from spatialflink_tpu_torch import overload, slo

    threaded, waiting = tfaults.__doc__.split("The other points wait")
    assert 'faults.hit("overload.admit")' in \
        Path(overload.__file__).read_text()
    assert "``overload.admit``" in threaded
    assert "``overload.admit``" not in waiting
    assert "ROADMAP" not in tfaults.INJECTION_POINTS["overload.admit"]
    for jmod, tmod in ((jov, overload), (jslo, slo)):
        public = {n for n in vars(jmod) if not n.startswith("_")
                  and not inspect.ismodule(getattr(jmod, n))
                  and getattr(getattr(jmod, n), "__module__",
                              jmod.__name__) == jmod.__name__}
        assert public <= set(vars(tmod)), public - set(vars(tmod))
    for name in ("overload", "slo"):
        assert name not in jax_exports("") and name not in port.NOT_EXPORTED.get(
            "", {})
    hits = [str(p) for p in (REPO / "spatialflink_tpu_torch").rglob("*.py")
            if "A11.3" in p.read_text()]
    assert hits == []


def test_job_surface_modules_at_their_jax_paths():
    """A11.4a: ``envvars``, ``config``, ``native``, ``streams/kafka`` and
    ``streams/kafka_wire`` sit at the JAX package's module paths with its
    public names, each the port's own object (no ``__init__`` of either
    package re-exports them); their functions take the JAX parameters in
    the JAX order, the config dataclasses the JAX fields and defaults
    (the backend's default aside); the ``kafka.fetch`` and
    ``kafka.leader`` fault points are threaded."""
    import dataclasses

    import spatialflink_tpu_torch.faults as tfaults

    pairs = {}
    for path in ("envvars", "config", "native", "streams.kafka",
                 "streams.kafka_wire"):
        pairs[path] = (importlib.import_module("spatialflink_tpu." + path),
                       importlib.import_module("spatialflink_tpu_torch."
                                               + path))
    for path, (jmod, tmod) in pairs.items():
        public = _public(jmod)
        assert public and public <= _public(tmod), (path,
                                                     public - _public(tmod))
        for name in sorted(public):
            jobj, tobj = getattr(jmod, name), getattr(tmod, name)
            if inspect.isfunction(jobj):
                _same_order(jobj, tobj)
            elif inspect.isclass(jobj):
                assert tobj.__module__ == tmod.__name__, name
                if dataclasses.is_dataclass(jobj):
                    # The same fields with the same defaults, but the
                    # backend: the port's is "cuda" where JAX's is "tpu".
                    jf = [(f.name, f.default) for f in
                          dataclasses.fields(jobj)]
                    tf = [(f.name, f.default) for f in
                          dataclasses.fields(tobj)]
                    assert [f for f in jf if f[0] != "backend"] == \
                        [f for f in tf if f[0] != "backend"], name
                    assert [f[0] for f in jf] == [f[0] for f in tf], name
                    continue
                for attr, fn in vars(jobj).items():
                    if inspect.isfunction(fn) and (
                            not attr.startswith("_") or attr == "__init__"):
                        _same_order(fn, getattr(tobj, attr))
        name = path.rsplit(".", 1)[-1]
        assert name not in jax_exports("") + jax_exports("streams")
    threaded, waiting = tfaults.__doc__.split("The other points wait")
    for point, mod in (("kafka.fetch", "streams.kafka"),
                       ("kafka.leader", "streams.kafka_wire")):
        assert f'faults.hit("{point}")' in \
            Path(pairs[mod][1].__file__).read_text()
        assert f"``{point}``" in threaded and f"``{point}``" not in waiting
        assert "ROADMAP" not in tfaults.INJECTION_POINTS[point]


def test_every_not_ported_message_names_its_item():
    """No ``NotImplementedError`` is left in the port but the JAX
    package's own (a protocol feature neither package has, raised with
    the JAX text): the float64 mode covers every entry point, so none
    names ROADMAP item A14 in any form (``precision.not_ported`` is
    gone with A14.2c); A12.3 is ported, and no source names any part of
    A11.4 or of A12 in any form: no sharded program refuses a mesh that
    spans processes."""
    import re

    import spatialflink_tpu_torch.precision as tprecision

    assert not hasattr(tprecision, "not_ported")
    assert not hasattr(tprecision, "require_f32")
    port = REPO / "spatialflink_tpu_torch"
    for path in port.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"A11\.4", text), path
        assert not re.search(r"A12", text), path
        assert not re.search(r"A14\.2c|not_ported|require_f32", text), path
        for m in re.finditer(r"(raise|return) NotImplementedError\(", text):
            body = text[m.end():m.end() + 300].split("\n\n")[0]
            assert not re.search(r"A1[24]|WAITING_COMPONENTS", body), path
            first = re.search(r'"([^"]{12,})"', body).group(1)
            jpath = REPO / "spatialflink_tpu" / path.relative_to(port)
            assert jpath.exists() and first in jpath.read_text(), \
                (path, body)


def _public(mod):
    """Names ``mod`` defines itself (functions, classes, constants)."""
    return {n for n in vars(mod) if not n.startswith("_")
            and not inspect.ismodule(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", mod.__name__)
            == mod.__name__}


#: Parameters the port drops (its mesh programs split the JAX kernels'
#: in-body collectives into phases, ``parallel/sharded.py``) or adds last.
_DROPPED = ("axis_name", "index_base")
_ADDED = ("device",)


def _same_order(jfn, tfn):
    j = [(p.name, p.default) for p in
         inspect.signature(jfn).parameters.values()
         if p.name not in _DROPPED]
    t = [(p.name, p.default) for p in
         inspect.signature(tfn).parameters.values()]
    assert t[:len(j)] == j, (jfn, j, t)
    assert all(name in _ADDED for name, _ in t[len(j):]), (jfn, t)


def test_qserve_modules_at_their_jax_paths_in_the_jax_order():
    """``qserve.py`` and ``ops/query_registry.py`` sit at the JAX
    package's module paths with its public names, their functions and
    methods take the JAX parameters in the JAX order (the registry's
    ``axis_name`` / ``index_base`` dropped, the operator's ``device``
    last), the ``qserve.register`` fault point is threaded, and no
    source of the port waits on A9 any more."""
    import dataclasses

    import spatialflink_tpu_torch.faults as tfaults
    from spatialflink_tpu import qserve as jqs
    from spatialflink_tpu.ops import query_registry as jqr
    from spatialflink_tpu_torch import qserve
    from spatialflink_tpu_torch.ops import query_registry

    for jmod, tmod in ((jqs, qserve), (jqr, query_registry)):
        public = _public(jmod)
        assert public <= _public(tmod), public - _public(tmod)
        for name in sorted(public):
            jobj, tobj = getattr(jmod, name), getattr(tmod, name)
            if inspect.isfunction(jobj):
                _same_order(jobj, tobj)
            elif inspect.isclass(jobj):
                if dataclasses.is_dataclass(jobj):
                    assert [(f.name, f.default) for f in
                            dataclasses.fields(jobj)] == \
                        [(f.name, f.default) for f in
                         dataclasses.fields(tobj)], name
                elif hasattr(jobj, "_fields"):
                    assert jobj._fields == tobj._fields, name
                for attr, fn in vars(jobj).items():
                    if inspect.isfunction(fn) and (
                            not attr.startswith("_") or attr == "__init__"):
                        _same_order(fn, getattr(tobj, attr))
            else:
                assert jobj == tobj, name
    threaded, waiting = tfaults.__doc__.split("The other points wait")
    assert 'faults.hit("qserve.register")' in \
        Path(qserve.__file__).read_text()
    assert "``qserve.register``" in threaded
    assert "``qserve.register``" not in waiting
    assert "ROADMAP" not in tfaults.INJECTION_POINTS["qserve.register"]
    hits = [str(p) for p in (REPO / "spatialflink_tpu_torch").rglob("*.py")
            if "A9" in p.read_text()]
    assert hits == []


# ---------------------------------------------------------------------------
# C4: cand and interpret in the JAX positions

BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
WF = WireFormat.for_grid(UniformGrid(**BEIJING))
NSEG, K, RADIUS = 256, 5, 0.5
Q = Point(x=116.4, y=40.19)


def _panes(seed=3, n=3000):
    rng = np.random.default_rng(seed)
    ch = {"ts": np.sort(rng.integers(0, 3000, n)).astype(np.int64),
          "x": rng.uniform(115.5, 117.6, n), "y": rng.uniform(39.6, 41.1, n),
          "oid": rng.integers(0, NSEG, n)}
    return list(wire_panes([ch], WF, 1000, 0))


def _op():
    return PointPointKNNQuery(QueryConfiguration(window_size=2.0,
                                                 slide_step=1.0),
                              UniformGrid(**BEIJING), device="cpu")


def _params(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


def test_signatures_keep_the_jax_order():
    assert _params(PointPointKNNQuery.run_wire_panes) == \
        _params(JKnn.run_wire_panes)
    for name in ("cand", "interpret", "strategy"):
        t = inspect.signature(twk.select_wire_digest_step).parameters[name]
        j = inspect.signature(jwk.select_wire_digest_step).parameters[name]
        assert (t.kind, t.default) == (j.kind, j.default), name
    t = list(inspect.signature(twc.select_wire_decoder).parameters)
    j = list(inspect.signature(jwc.select_wire_decoder).parameters)
    assert t[:2] == j[:2] == ["strategy", "interpret"]


def _windows(out):
    return [(s, e, o.tolist(), d.view(np.uint32).tolist(), nv)
            for s, e, o, d, nv in out]


@pytest.mark.parametrize("flush", [True, False])
def test_reference_positional_call_binds_as_in_jax(flush):
    panes = _panes()
    args = (panes, Q, RADIUS, K, NSEG, WF, 0, "auto", 8192, False, flush)
    bound = inspect.signature(PointPointKNNQuery.run_wire_panes).bind(
        None, *args).arguments
    jbound = inspect.signature(JKnn.run_wire_panes).bind(None, *args)
    assert list(bound.items())[1:] == list(jbound.arguments.items())[1:]
    got = _windows(_op().run_wire_panes(*args))
    want = _windows(_op().run_wire_panes(panes, Q, RADIUS, K, NSEG, WF,
                                         flush_at_end=flush))
    assert got == want and got
    other = _windows(_op().run_wire_panes(panes, Q, RADIUS, K, NSEG, WF,
                                          flush_at_end=not flush))
    assert len(other) != len(got)  # the 11th argument is flush_at_end


@pytest.mark.parametrize("cand", [0, -1, 1.5, True, "8192", None])
def test_cand_must_be_a_positive_int(cand):
    with pytest.raises(ValueError, match="cand"):
        next(_op().run_wire_panes(_panes(), Q, RADIUS, K, NSEG, WF,
                                  cand=cand))
    wire = torch.from_numpy(_panes()[0])
    with pytest.raises(ValueError, match="cand"):
        twk.select_wire_digest_step(wire, wire.shape[1], np.float32([1, 1]),
                                    WF.scale, WF.origin, 0.5,
                                    num_segments=NSEG, cand=cand)


def test_cand_changes_no_result():
    panes = _panes(seed=4)
    a = _windows(_op().run_wire_panes(panes, Q, RADIUS, K, NSEG, WF, cand=1))
    b = _windows(_op().run_wire_panes(panes, Q, RADIUS, K, NSEG, WF,
                                      cand=np.int64(1 << 20)))
    assert a == b and a


def test_interpret_selects_the_plain_versions():
    # On the CPU every step already is its kernel's plain version, so
    # interpret=True is accepted and changes nothing: the same windows,
    # kinds "torch" for the digest and the codec, no kernel launched.
    panes = _panes(seed=5)
    launches = (twk.wire_digest.launches, twc.decode_wire_pane.launches)
    want = _windows(_op().run_wire_panes(panes, Q, RADIUS, K, NSEG, WF))
    op = _op()
    got = _windows(op.run_wire_panes(panes, Q, RADIUS, K, NSEG, WF,
                                     interpret=True))
    assert got == want and op.last_wire_digest_kind == "torch"
    tpipeline.install(tpipeline.PipelinePolicy(depth=2, fetch_lag=1,
                                               codec="delta"))
    try:
        op = _op()
        got = _windows(op.run_wire_panes(panes, Q, RADIUS, K, NSEG, WF, 0,
                                         "auto", 8192, True))
    finally:
        tpipeline.uninstall()
    assert got == want and op.last_wire_codec_kind == "torch"
    assert (twk.wire_digest.launches,
            twc.decode_wire_pane.launches) == launches
    kind, decode = twc.select_wire_decoder(
        "auto", interpret=True, sample_args=(torch.zeros(1),), n=8,
        num_segments=NSEG)
    assert (kind, decode) == ("torch", twc.decode_wire_pane)


def test_interpret_raises_off_the_cpu():
    # The card always runs the hand kernels: interpret=True on any tensor
    # that is not on the CPU raises, in both selectors and the operator's
    # own check, before anything runs.
    twk.check_interpret(False, "cuda")
    twk.check_interpret(True, "cpu")
    with pytest.raises(ValueError, match="interpret"):
        twk.check_interpret(True, "cuda")
    wire = torch.empty((3, 8), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError, match="interpret"):
        twk.select_wire_digest_step(
            wire, 8, np.float32([116.4, 40.19]), WF.scale, WF.origin, 0.5,
            num_segments=NSEG, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        twc.select_wire_decoder("auto", interpret=True, sample_args=(wire,),
                                n=8, num_segments=NSEG)


def test_interpret_rejects_the_kernel_strategy():
    wire = torch.from_numpy(_panes()[0])
    for strategy in ("cuda", "pallas"):
        with pytest.raises(ValueError):
            twk.select_wire_digest_step(
                wire, wire.shape[1], np.float32([116.4, 40.19]), WF.scale,
                WF.origin, 0.5, num_segments=NSEG, interpret=True,
                strategy=strategy)
        with pytest.raises(ValueError):
            twc.select_wire_decoder(strategy, interpret=True,
                                    sample_args=(wire,), n=8,
                                    num_segments=NSEG)
    kind, _ = twk.select_wire_digest_step(
        wire, wire.shape[1], np.float32([116.4, 40.19]), WF.scale, WF.origin,
        0.5, num_segments=NSEG, interpret=True, strategy="torch")
    assert kind == "torch"


def test_dag_and_streaming_job_at_their_jax_paths_in_the_jax_order():
    """A11.4b: ``dag`` and ``streaming_job`` sit at the JAX package's
    module paths with its public names, each the port's own object; their
    functions and methods take the JAX parameters in the JAX order, with
    ``device`` last where a node or a run reaches the card; the
    ``dag.node`` fault point is threaded (hit in ``dag.py``, listed as
    threaded, no ROADMAP item); and the checkpoint no longer waits on the
    DAG."""
    import dataclasses

    import spatialflink_tpu_torch.faults as tfaults
    from spatialflink_tpu_torch import checkpoint as tck

    for path in ("dag", "streaming_job"):
        jmod = importlib.import_module("spatialflink_tpu." + path)
        tmod = importlib.import_module("spatialflink_tpu_torch." + path)
        public = _public(jmod)
        assert public and public <= _public(tmod), (path,
                                                     public - _public(tmod))
        for name in sorted(public):
            jobj, tobj = getattr(jmod, name), getattr(tmod, name)
            if inspect.isfunction(jobj):
                _same_order(jobj, tobj)
            elif inspect.isclass(jobj):
                assert tobj.__module__ == tmod.__name__, name
                if dataclasses.is_dataclass(jobj):
                    assert [f.name for f in dataclasses.fields(jobj)] == \
                        [f.name for f in dataclasses.fields(tobj)], name
                    continue
                for attr, fn in vars(jobj).items():
                    if inspect.isfunction(fn) and (
                            not attr.startswith("_") or attr == "__init__"):
                        _same_order(fn, getattr(tobj, attr))
        assert path not in jax_exports("")
    threaded, waiting = tfaults.__doc__.split("The other points wait")
    assert 'faults.hit("dag.node")' in \
        (REPO / "spatialflink_tpu_torch" / "dag.py").read_text()
    assert "``dag.node``" in threaded and "``dag.node``" not in waiting
    assert "ROADMAP" not in tfaults.INJECTION_POINTS["dag.node"]
    assert set(tck.WAITING_COMPONENTS) == set()


# ---------------------------------------------------------------------------
# The public surface: every public function, class, method and parameter of
# the JAX package has a port counterpart, or an allowlisted reason.

#: JAX-package surface the port deliberately lacks: (module path, name,
#: parameter or None) → the reason, which the JAX source bears out.
SURFACE_ALLOWLIST = {
    ("ops/pallas_digest.py", None, None):
        "B1's Pallas kernel: kernels/csrc/wire_digest.cu replaces it",
    ("ops/pallas_join.py", None, None):
        "B3's Pallas kernel: kernels/csrc/join_extract.cu replaces it",
    ("ops/pallas_kernels.py", None, None):
        "B4's Pallas kernel: kernels/csrc/polyline_min_dist.cu replaces it",
    ("runtime.py", None, None):
        "it configures the JAX compile cache, which the port has not",
    ("ops/join.py", "sort_by_cell", None):
        "the XLA gather join's right-side sort; B3's bucket planes need "
        "none",
    ("ops/join.py", "join_kernel", None):
        "the XLA gather join (the CPU fallback of the TPU strategy); B3 "
        "replaces it on the card, its plain version on the CPU",
    ("ops/join.py", "join_kernel_compact", None):
        "the XLA gather join, compacted; B3 replaces it",
    ("ops/join.py", "join_window_bucketed", None):
        "the XLA dense-bucket join the JAX package runs off the TPU; B3's "
        "plain version is the port's CPU route",
    ("ops/join.py", "join_window_compact", None):
        "the XLA gather join at high bucket capacity; B3 replaces it",
    ("ops/join.py", "pallas_join_supported", None):
        "a TPU-backend probe for the Pallas join; the port's route is the "
        "tensor's device",
    ("ops/select.py", "first_k_onehot", None):
        "the TPU's one-hot select strategy (TPU gathers are slow); the "
        "port keeps the prefix-sum select",
    ("ops/select.py", "onehot_select_preferred", None):
        "the TPU-backend probe of the one-hot select strategy",
    ("ops/compaction.py", "compact_probe_preferred", None):
        "the backend probe between the TPU's row-gather probe and the "
        "compacted one",
    ("ops/wire_codec.py", "extract_streams", None):
        "the XLA bit-extraction half that the Pallas fast path swaps out; "
        "B2 (kernels/csrc/wire_codec.cu) is the whole decode",
    ("ops/wire_codec.py", "make_pallas_extract", None):
        "the Pallas builder of B2's TPU kernel",
    ("ops/wire_codec.py", "functools_partial_decode", None):
        "binds the Pallas or XLA extraction into the decode; the port has "
        "one decode a device",
    ("ops/wire_codec.py", "decode_wire_pane", "extract"):
        "the Pallas/XLA extraction strategy argument",
    ("ops/wire_knn.py", "wire_digest_xla", None):
        "the XLA strategy of the wire digest; B1's plain version is the "
        "port's CPU route",
    ("ops/wire_knn.py", "wire_digest_pallas_step", None):
        "the Pallas strategy step of B1's TPU kernel",
    ("ops/wire_knn.py", "make_wire_digest_step", None):
        "binds the Pallas or XLA strategy for jax.jit / lax.scan",
    ("ops/wire_knn.py", "select_wire_digest_step", "max_cand"):
        "the Pallas digest's VMEM candidate cap; the hand kernel has no "
        "candidate buffer",
    ("operators/base.py", "jitted", "*static"):
        "jax.jit's static argument names; PyTorch runs eagerly",
    ("operators/join_query.py", "grid_hash_join_batches", "offsets"):
        "the XLA gather join's neighbour offsets; B3 walks the "
        "neighbourhood itself",
    ("operators/join_query.py", "grid_hash_join_batches", "backend"):
        "the Pallas/XLA backend choice; the port's route is the device",
    ("ops/range.py", "range_query_polylines_kernel", "line_chunk"):
        "the lax.map block of the XLA form; one B4 launch takes every "
        "line",
    ("telemetry.py", "Telemetry.record_kernel_time", "lower_ctx"):
        "the abstract arguments JAX lowers for its XLA cost analysis",
    ("ops/query_registry.py", "registry_bucket_query", "index_base"):
        "the shard's offset inside a shard_map body; the port's mesh "
        "programs split the collectives into phases "
        "(parallel/sharded.py)",
}

#: Parameters dropped everywhere, with the reason.
SURFACE_DROPPED = {
    "axis_name": "the shard_map axis of an in-body collective; the port's "
                 "mesh programs split the collectives into phases "
                 "(parallel/sharded.py)",
}


def _jax_surface():
    """(module path, name, method, parameters) of every public
    module-level function, class and class method of the JAX package,
    read from the sources' ASTs (no JAX module is imported)."""
    out = []
    for path in sorted((REPO / "spatialflink_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "spatialflink_tpu").as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ClassDef) \
                    and not node.name.startswith("_"):
                out.append((rel, node.name, None, None))
                out += [(rel, node.name, m.name, m) for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")]
            elif isinstance(node, ast.FunctionDef) \
                    and not node.name.startswith("_"):
                out.append((rel, node.name, None, node))
    return out


def _ast_params(fn_node):
    a = fn_node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _port_params(obj):
    kinds = {inspect.Parameter.VAR_POSITIONAL: "*",
             inspect.Parameter.VAR_KEYWORD: "**"}
    return {kinds.get(p.kind, "") + p.name
            for p in inspect.signature(obj).parameters.values()}


def test_every_public_jax_name_and_parameter_has_a_port_counterpart():
    """Every public module-level function, class, class method and
    parameter of the JAX package exists at the same path of the port,
    unless ``SURFACE_ALLOWLIST`` (or ``SURFACE_DROPPED`` for a parameter)
    names it with its reason. Each allowlisted entry exists in the JAX
    package and is really absent from the port, so the list shrinks as
    the port grows."""
    gaps = set()
    for rel, name, meth, node in _jax_surface():
        modname = "spatialflink_tpu_torch." + rel[:-3].replace("/", ".")
        modname = modname.removesuffix(".__init__")
        try:
            mod = importlib.import_module(modname)
        except ModuleNotFoundError:
            gaps.add((rel, None, None))
            continue
        obj = getattr(mod, name, None)
        qual = name if meth is None else f"{name}.{meth}"
        if obj is not None and meth is not None:
            obj = getattr(obj, meth, None)
        if obj is None:
            gaps.add((rel, qual, None))
            continue
        if node is None or not callable(obj):  # a class, a property
            continue
        have = _port_params(obj)
        gaps |= {(rel, qual, p) for p in _ast_params(node)
                 if p not in have and p not in SURFACE_DROPPED}
    assert gaps == set(SURFACE_ALLOWLIST), (
        sorted(gaps - set(SURFACE_ALLOWLIST)),
        sorted(set(SURFACE_ALLOWLIST) - gaps))
    assert all(len(why) > 20 for why in SURFACE_ALLOWLIST.values())


def test_ported_helpers_match_jax():
    """The helpers ported to close the surface: equal to the JAX
    package's on the same inputs."""
    from spatialflink_tpu.grid import UniformGrid as JGrid
    from spatialflink_tpu.models.batch import PointBatch as JBatch
    from spatialflink_tpu.utils import helper as jhelper

    from spatialflink_tpu_torch.models.batch import PointBatch
    from spatialflink_tpu_torch.utils import helper as thelper

    for v, w in ((7, 5), (123456, 3), (0, 1)):
        assert thelper.pad_leading_zeroes(v, w) == \
            jhelper.pad_leading_zeroes(v, w)
    assert thelper.pad_leading_zeroes(42) == jhelper.pad_leading_zeroes(42)
    polys = thelper.generate_query_polygons(30, 115.5, 39.6, 117.6, 41.1,
                                            seed=9)
    jpolys = jhelper.generate_query_polygons(30, 115.5, 39.6, 117.6, 41.1,
                                             seed=9)
    assert thelper.cells_of_polygon_set(UniformGrid(**BEIJING), polys) == \
        jhelper.cells_of_polygon_set(JGrid(**BEIJING), jpolys)
    rng = np.random.default_rng(3)
    xy = rng.uniform(116, 117, (300, 2))
    ts = np.arange(300, dtype=np.int64)
    oid = rng.integers(0, 50, 300).astype(np.int32)
    mask = rng.random(512) < 0.5
    got = PointBatch.from_arrays(xy, ts, oid).with_cells(
        UniformGrid(**BEIJING)).compact(mask)
    want = JBatch.from_arrays(xy, ts, oid).with_cells(
        JGrid(**BEIJING)).compact(mask)
    for f in ("xy", "ts", "oid", "valid", "cell"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.count == want.count > 0
