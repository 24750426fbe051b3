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
    for name in names:
        if name in waiting:
            # Absent, or a submodule of that name (ops/join_kernel.py).
            assert waiting[name] and not callable(getattr(pkg, name, None)), \
                name
            continue
        obj = getattr(pkg, name)
        assert getattr(obj, "__module__", "").startswith(
            "spatialflink_tpu_torch"), name
    assert set(waiting) <= set(names)


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
        "spatialflink_tpu_torch.streams.shapefile\n"
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
