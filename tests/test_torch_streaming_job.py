"""The port's config-driven entry point
(``spatialflink_tpu_torch/streaming_job.py``) against the JAX package's
``streaming_job`` CLI, on the CPU (``backend: cpu`` in every YAML).

The JAX CLI tests are the oracles: ``tests/test_io_and_state.py``'s
(range, kNN and tStats, Kafka to Kafka over a real socket to
``tests/test_kafka_wire.py``'s ``FakeBroker``, the checkpointed kill and
resume, the kNN and join kill and resume, the argument checks),
``tests/test_coverage_gaps.py``'s remaining options and the
``query.incremental`` flag, and ``tests/test_qserve.py``'s option 9. Each
case runs the port's CLI and the JAX CLI on the same YAML and CSV and
holds the port's output to the JAX output: byte-identical where the two
compute alike (tStats, tAggregate, the kNN pane carry), and otherwise
line for line with every field equal but a float32 distance, which may
sit one float32 ulp apart (the JAX CLI runs inside
``jax.enable_x64(False)``, float32 as the port always computes, and its
jitted programs contract x² + y² into an FMA; the port's standing 1-ulp
rule); the join's lines are compared as a multiset, its emission order
being block-major in the JAX package (``tests/test_pallas_join.py:108``'s
set rule). Option 10 is in ``tests/test_torch_dag.py``.

Then the port's own: ``deviceMesh`` sharding on the CPU with the
unsharded output and raising above the visible cards, a mesh of one
running unsharded, and the card default raising with no card.
"""

import os
import sys

import jax
import numpy as np
import pytest

from spatialflink_tpu.streaming_job import main as jmain

from spatialflink_tpu_torch import overload, qserve
from spatialflink_tpu_torch.faults import InjectedFault, faults
from spatialflink_tpu_torch.streaming_job import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _clean():
    from spatialflink_tpu import overload as jov
    from spatialflink_tpu import qserve as jqs
    from spatialflink_tpu.faults import faults as jfaults

    yield
    for f in (faults, jfaults):
        f.disarm()
    for mod in (qserve, jqs, overload, jov):
        mod.uninstall()


def _yaml(option, radius=2.0, k=3, interval=10, step=10, points=((5.0, 5.0),),
          extra=""):
    pts = "\n".join(f"    - [{x}, {y}]" for x, y in points)
    return f"""
backend: cpu
inputStream1:
  topicName: t
  format: CSV
  csvTsvSchemaAttr: [0, 1, 2, 3]
  gridBBox: [0.0, 0.0, 10.0, 10.0]
  numGridCells: 20
  delimiter: ","
query:
  option: {option}
  radius: {radius}
  k: {k}
  aggregateFunction: "SUM"
{extra}  queryPoints:
{pts}
window:
  type: "TIME"
  interval: {interval}
  step: {step}
"""


def _jax_cli(argv):
    """The JAX CLI in float32, as the port computes."""
    with jax.enable_x64(False):
        return jmain(argv)


def assert_lines_close(got: bytes, want: bytes, multiset=False):
    """Every line equal field for field, but a float field may differ by
    one float32 ulp; ``multiset`` compares the lines sorted by their
    non-distance fields, then the distance (a join repeats an objID pair
    once per matching point pair)."""
    g, w = got.decode().splitlines(), want.decode().splitlines()
    assert len(g) == len(w), (len(g), len(w))
    if multiset:
        def key(ln):
            head, d = ln.rsplit(",", 1)
            return head, float(d)

        g, w = sorted(g, key=key), sorted(w, key=key)
    for a, b in zip(g, w):
        fa, fb = a.split(","), b.split(",")
        assert len(fa) == len(fb), (a, b)
        for x, y in zip(fa, fb):
            if x == y:
                continue
            x, y = float(x), float(y)
            ulp = np.spacing(np.float32(max(abs(x), abs(y))))
            assert abs(x - y) <= ulp, (a, b)


def _both(tmp_path, yml_text, csv, name, extra_args=()):
    """Run the port's and the JAX CLI on one YAML and CSV; returns both
    outputs' bytes."""
    conf = tmp_path / f"{name}.yml"
    conf.write_text(yml_text)
    outs = []
    for tag, fn in (("t", main), ("j", _jax_cli)):
        out = tmp_path / f"{name}_{tag}.csv"
        assert fn(["--config", str(conf), "--source", f"csv:{csv}",
                   "--output", str(out), *extra_args]) == 0
        outs.append(out.read_bytes())
    return outs


def _range_csv(tmp_path):
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(
        f"dev{i % 3},{i * 500},{5.0 if i % 4 == 0 else 9.5},5.0"
        for i in range(100)))
    return csv


def test_streaming_job_cli_range(tmp_path):
    got, want = _both(tmp_path, _yaml(1), _range_csv(tmp_path), "range")
    assert len(got.decode().strip().splitlines()) == 25
    assert got == want


def test_streaming_job_cli_knn_and_tstats(tmp_path):
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(f"dev{i % 3},{i * 500},{4 + 0.01 * i},5.0"
                             for i in range(60)))
    for opt in (3, 6):
        got, want = _both(tmp_path, _yaml(opt, radius=5.0, k=2), csv,
                          f"o{opt}")
        assert got.strip()
        assert_lines_close(got, want)


def test_streaming_job_cli_kafka_to_kafka(tmp_path, monkeypatch):
    """CSV records produced to a broker topic → ``--source kafka`` →
    windowed range query → ``--output kafka`` → results fetched back,
    over a real socket to ``FakeBroker``; the port's records equal the
    JAX CLI's from the same topic."""
    import builtins

    sys.path.insert(0, TESTS)
    from test_kafka_wire import FakeBroker

    from spatialflink_tpu_torch.streams import kafka_wire as kw

    real_import = builtins.__import__

    def no_libs(name, *a, **k):
        if name in ("kafka", "confluent_kafka"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_libs)
    broker = FakeBroker()
    bs = f"127.0.0.1:{broker.port}"
    try:
        producer = kw.KafkaWireClient(bs)
        lines = []
        for i in range(100):
            x, y = (5.0, 5.0) if i % 4 == 0 else (0.5 + (i % 9), 0.5)
            lines.append((f"d{i % 7},{i * 100},{x},{y}".encode(), None, 0))
        producer.produce("gps-in", 0, lines)
        producer.close()
        got = {}
        for tag, fn in (("t", main), ("j", _jax_cli)):
            conf = tmp_path / f"conf_{tag}.yml"
            conf.write_text(_yaml(1).replace(
                "  topicName: t\n", "  topicName: gps-in\n")
                + f"outputStream:\n  topicName: out-{tag}\n"
                + f'kafkaBootStrapServers: "{bs}"\n')
            assert fn(["--config", str(conf), "--source", "kafka",
                       "--output", "kafka", "--max-records", "100"]) == 0
            consumer = kw.KafkaWireClient(bs)
            msgs, _ = consumer.fetch(f"out-{tag}", 0, 0)
            consumer.close()
            got[tag] = [m[3] for m in msgs]  # (offset, ts, key, value)
        assert len(got["t"]) == 25 and all(got["t"])
        assert got["t"] == got["j"]
    finally:
        broker.close()


def test_streaming_job_cli_checkpointed_kill_and_resume(tmp_path):
    csv = _range_csv(tmp_path)
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(1))
    clean = tmp_path / "clean.csv"
    assert main(["--config", str(conf), "--source", f"csv:{csv}",
                 "--output", str(clean),
                 "--checkpoint", str(tmp_path / "ck_clean.bin"),
                 "--checkpoint-every", "1"]) == 0
    want = clean.read_bytes()
    assert want
    jout = tmp_path / "jax.csv"
    assert _jax_cli(["--config", str(conf), "--source", f"csv:{csv}",
                     "--output", str(jout),
                     "--checkpoint", str(tmp_path / "ck_jax.bin"),
                     "--checkpoint-every", "1"]) == 0
    assert want == jout.read_bytes()
    out = tmp_path / "out.csv"
    args = ["--config", str(conf), "--source", f"csv:{csv}",
            "--output", str(out), "--checkpoint", str(tmp_path / "ck.bin"),
            "--checkpoint-every", "1"]
    faults.arm([{"point": "window.feed", "at": 50, "times": 10_000}])
    try:
        with pytest.raises(InjectedFault):
            main(args)
    finally:
        faults.disarm()
    assert out.read_bytes() != want
    assert main(args) == 0
    assert out.read_bytes() == want


@pytest.mark.parametrize("option,fault_at", [(3, 40), (5, 40)])
def test_streaming_job_knn_join_kill_and_resume(tmp_path, option, fault_at):
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(option, radius=3.0))
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(
        f"dev{i % 5},{i * 500},{4.0 + (i % 7) * 0.4},{4.0 + (i % 5) * 0.5}"
        for i in range(100)))
    clean = tmp_path / "clean.csv"
    assert main(["--config", str(conf), "--source", f"csv:{csv}",
                 "--output", str(clean),
                 "--checkpoint", str(tmp_path / "ck_clean.bin"),
                 "--checkpoint-every", "1"]) == 0
    want = clean.read_bytes()
    assert want
    jout = tmp_path / "jax.csv"
    assert _jax_cli(["--config", str(conf), "--source", f"csv:{csv}",
                     "--output", str(jout)]) == 0
    assert_lines_close(want, jout.read_bytes(), multiset=option == 5)
    out = tmp_path / "out.csv"
    args = ["--config", str(conf), "--source", f"csv:{csv}",
            "--output", str(out), "--checkpoint", str(tmp_path / "ck.bin"),
            "--checkpoint-every", "1"]
    faults.arm([{"point": "window.feed", "at": fault_at, "times": 10_000}])
    try:
        with pytest.raises(InjectedFault):
            main(args)
    finally:
        faults.disarm()
    assert out.read_bytes() != want
    assert main(args) == 0
    assert out.read_bytes() == want


def test_streaming_job_checkpoint_arg_validation(tmp_path):
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(1))
    with pytest.raises(SystemExit, match="file --output"):
        main(["--config", str(conf), "--source", "synthetic",
              "--checkpoint", str(tmp_path / "ck.bin")])
    with pytest.raises(SystemExit, match="replayable"):
        main(["--config", str(conf), "--source", "synthetic",
              "--output", str(tmp_path / "o.csv"),
              "--checkpoint", str(tmp_path / "ck.bin")])
    conf.write_text(_yaml(7))
    with pytest.raises(SystemExit, match="options"):
        main(["--config", str(conf), "--source", "csv:unused",
              "--output", str(tmp_path / "o.csv"),
              "--checkpoint", str(tmp_path / "ck.bin")])


@pytest.mark.parametrize("opt", [2, 5, 7, 8])
def test_streaming_job_remaining_options(tmp_path, opt):
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(
        f"dev{i % 3},{(i % 40) * 250},{4 + 0.02 * (i % 40)},"
        f"{5 + 0.01 * (i % 40)}" for i in range(80)))
    got, want = _both(tmp_path, _yaml(opt, radius=3.0, k=2,
                                      points=((5.0, 5.0), (4.5, 5.2))),
                      csv, f"o{opt}")
    assert got.strip(), f"option {opt} produced no output"
    if opt == 7:
        assert got == want
    else:
        assert_lines_close(got, want, multiset=opt == 5)


@pytest.mark.parametrize("opt", [1, 3, 5])
def test_streaming_job_incremental_flag_matches_full(tmp_path, opt):
    """``query.incremental: true`` routes options 1, 3 and 5 through the
    carry paths (option 5 through ``PointPointJoinQuery.query_panes``):
    equal to the full recompute line for line (order-insensitive), and to
    the JAX CLI's incremental run."""
    csv = tmp_path / "in.csv"
    csv.write_text("\n".join(
        f"dev{i % 5},{i * 120},{3 + 0.05 * (i % 60)},{4 + 0.03 * (i % 60)}"
        for i in range(160)))
    outs = {}
    for inc in ("false", "true"):
        got, want = _both(
            tmp_path, _yaml(opt, radius=3.0, k=4, step=5,
                            extra=f"  incremental: {inc}\n"),
            csv, f"o{opt}_{inc}")
        assert_lines_close(got, want, multiset=True)
        outs[inc] = sorted(got.decode().strip().splitlines())
    assert outs["false"] == outs["true"]
    assert outs["true"]


def test_streaming_job_option9_serves_and_checkpoints(tmp_path,
                                                      monkeypatch):
    """Option 9 with ``--checkpoint``: per-tenant egress equal to the JAX
    CLI's; re-running against the completed checkpoint is an exactly-once
    no-op."""
    rng = np.random.default_rng(5)
    csv = tmp_path / "pts.csv"
    csv.write_text("\n".join(
        f"o{i % 7},{i * 100},{rng.uniform(0.5, 9.5):.4f},"
        f"{rng.uniform(0.5, 9.5):.4f}" for i in range(90)) + "\n")
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(9, radius=1.5, k=4, interval=2, step=1,
                          points=((4.0, 4.0),)).replace(
        "numGridCells: 20", "numGridCells: 10"))
    monkeypatch.delenv("SFT_QSERVE", raising=False)
    out = tmp_path / "served.csv"
    ck = tmp_path / "ck.bin"
    args = ["--config", str(conf), "--source", f"csv:{csv}",
            "--output", str(out), "--checkpoint", str(ck),
            "--checkpoint-every", "2"]
    assert main(args) == 0
    want = out.read_bytes()
    assert want
    first = want.decode().splitlines()[0].split(",")
    assert first[0] == "default" and first[1] in ("range0", "knn0")
    jout = tmp_path / "jax.csv"
    assert _jax_cli(["--config", str(conf), "--source", f"csv:{csv}",
                     "--output", str(jout), "--checkpoint",
                     str(tmp_path / "jck.bin"), "--checkpoint-every",
                     "2"]) == 0
    assert_lines_close(want, jout.read_bytes())
    qserve.uninstall()
    assert main(args) == 0
    assert out.read_bytes() == want


def test_device_mesh_above_one_card_raises_naming_a12(tmp_path):
    """``deviceMesh`` is ported: on ``backend: cpu`` a (2, 1) mesh runs
    sharded with the unsharded output; on ``backend: cuda`` a mesh above
    the visible cards raises "need N devices, have M", as JAX's
    ``make_mesh`` (tests/test_torch_parallel_operators.py holds more)."""
    import torch

    csv = _range_csv(tmp_path)
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(1) + "deviceMesh: [2, 1]\n")
    assert main(["--config", str(conf), "--source", f"csv:{csv}",
                 "--output", str(tmp_path / "m.csv")]) == 0
    conf.write_text(_yaml(1) + "deviceMesh: [1, 1]\n")
    assert main(["--config", str(conf), "--source", f"csv:{csv}",
                 "--output", str(tmp_path / "o.csv")]) == 0
    assert len((tmp_path / "o.csv").read_text().splitlines()) == 25
    assert (tmp_path / "m.csv").read_text() == \
        (tmp_path / "o.csv").read_text()
    n = torch.cuda.device_count()
    conf.write_text(_yaml(1).replace("backend: cpu", "backend: cuda")
                    + f"deviceMesh: [{2 * max(n, 1)}]\n")
    with pytest.raises((ValueError, RuntimeError),
                       match="need|is_available"):
        main(["--config", str(conf), "--source", f"csv:{csv}",
              "--output", str(tmp_path / "c.csv")])


def test_card_backend_raises_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda backend exists")
    csv = _range_csv(tmp_path)
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(1).replace("backend: cpu", "backend: cuda"))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--config", str(conf), "--source", f"csv:{csv}",
              "--output", str(tmp_path / "o.csv")])


def test_cli_module_entry_point(tmp_path):
    """``python -m spatialflink_tpu_torch.streaming_job`` runs the job."""
    import subprocess

    csv = _range_csv(tmp_path)
    conf = tmp_path / "conf.yml"
    conf.write_text(_yaml(1))
    out = tmp_path / "o.csv"
    p = subprocess.run(
        [sys.executable, "-m", "spatialflink_tpu_torch.streaming_job",
         "--config", str(conf), "--source", f"csv:{csv}", "--output",
         str(out)], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "25 result records" in p.stderr
    assert len(out.read_text().splitlines()) == 25
