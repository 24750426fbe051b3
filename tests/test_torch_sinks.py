"""The port's stream sinks (``spatialflink_tpu_torch/streams/sinks.py``)
against the JAX package's (``spatialflink_tpu/streams/sinks.py``).

The same records through both packages' sinks give the same bytes, the
same printed lines and the same committed markers; the exactly-once
``TransactionalFileSink`` cases of ``tests/test_driver.py`` (a torn
``partial_write`` repaired on restore, committed bytes lost out of band,
an exception path that publishes nothing, the header counted in the
marker) and the ``MultiSink`` cases of ``tests/test_dag.py`` (a crash
between two sub-commits at ``dag.commit``, a marker ahead of its file, a
sink added since the checkpoint) hold for the port, each side by side
with the JAX sink on the same sequence. Every test leaves both packages'
fault injectors disarmed.
"""

import pytest

from spatialflink_tpu.checkpoint import (
    CheckpointCorruptError as JCorrupt,
)
from spatialflink_tpu.faults import InjectedFault as JInjected
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.streams import sinks as jsinks

from spatialflink_tpu_torch import streams as tstreams
from spatialflink_tpu_torch.checkpoint import CheckpointCorruptError
from spatialflink_tpu_torch.faults import InjectedFault, faults
from spatialflink_tpu_torch.streams import sinks


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


#: Each package's (sinks module, faults, InjectedFault, corrupt error).
PACKAGES = {
    "port": (sinks, faults, InjectedFault, CheckpointCorruptError),
    "jax": (jsinks, jfaults, JInjected, JCorrupt),
}


def test_streams_package_exports_the_sinks():
    for name in ("CollectSink", "CsvFileSink", "PrintSink",
                 "TransactionalFileSink", "MultiSink", "LatencySink"):
        assert getattr(tstreams, name) is getattr(sinks, name)
        assert getattr(sinks, name).__module__.startswith(
            "spatialflink_tpu_torch")


RECORDS = [("o1", 100, 1.5), ("o2", 200, 2.0 / 3.0), ("o3", 300, 1e-7)]


def _fmt(rec):
    return f"{rec[0]},{rec[1]},{rec[2]!r}"


@pytest.mark.parametrize("flush_every", [1, 2])
def test_csv_file_sink_bytes_equal_jax(tmp_path, flush_every):
    out = {}
    for name, (mod, *_rest) in PACKAGES.items():
        path = tmp_path / f"{name}.csv"
        with mod.CsvFileSink(str(path), formatter=_fmt, header="id,ts,d\n",
                             flush_every=flush_every) as s:
            for rec in RECORDS:
                s(rec)
        assert s.count == len(RECORDS)
        out[name] = path.read_bytes()
    assert out["port"] == out["jax"] == (
        b"id,ts,d\n" + b"".join(_fmt(r).encode() + b"\n" for r in RECORDS))


def test_collect_and_print_sinks_equal_jax(capsys):
    printed = {}
    for name, (mod, *_rest) in PACKAGES.items():
        c = mod.CollectSink()
        p = mod.PrintSink(prefix="> ")
        for rec in RECORDS:
            c(rec)
            p(rec)
        assert c.items == RECORDS and len(c) == 3 and p.count == 3
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] == "".join(
        f"> {r}\n" for r in RECORDS)


def test_latency_sink_percentiles():
    import time

    s = sinks.LatencySink(lambda item: item)
    assert s.percentile(50) == 0.0
    now = time.time()
    for ago in (0.010, 0.020, 0.030):
        s(now - ago)
    s(None)  # an item without a reference time is skipped
    assert len(s.latencies_ms) == 3
    assert 10.0 <= s.percentile(0) <= s.percentile(50) <= s.percentile(100)
    assert s.percentile(100) < 10_000.0


# -- TransactionalFileSink: tests/test_driver.py's cases, both packages ------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_partial_write_is_repaired_on_restore(tmp_path, pkg):
    """A torn (fsync'd) half-append dies mid-commit; restore from the
    checkpointed marker truncates it and the replay regenerates the
    records: no gap, no duplicate."""
    mod, fl, injected, _ = PACKAGES[pkg]
    path = str(tmp_path / "out.csv")
    s = mod.TransactionalFileSink(path)
    s.reset()
    s.stage("one")
    marker = s.commit()
    s.stage("two")
    s.stage("three")
    fl.arm([{"point": "sink.write", "kind": "partial_write"}])
    with pytest.raises(injected):
        s.commit()
    fl.disarm()
    torn = open(path, "rb").read()
    assert torn == b"one\ntwo\nt"  # half of the 10 staged bytes landed
    s2 = mod.TransactionalFileSink(path)
    s2.restore(marker)
    assert open(path, "rb").read() == b"one\n"
    s2.stage("two")
    s2.stage("three")
    assert s2.commit() == {"bytes": 14, "records": 3}
    assert open(path, "rb").read() == b"one\ntwo\nthree\n"


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_missing_committed_bytes_is_corrupt(tmp_path, pkg):
    mod, _, _, corrupt = PACKAGES[pkg]
    path = str(tmp_path / "out.csv")
    s = mod.TransactionalFileSink(path)
    s.reset()
    s.stage("a" * 100)
    marker = s.commit()
    with open(path, "wb") as f:
        f.write(b"a" * 10)  # committed egress lost out of band
    with pytest.raises(corrupt, match="out-of-band"):
        mod.TransactionalFileSink(path).restore(marker)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_exception_path_never_publishes_staged_records(tmp_path, pkg):
    mod = PACKAGES[pkg][0]
    path = str(tmp_path / "out.csv")
    with pytest.raises(RuntimeError, match="boom"):
        with mod.TransactionalFileSink(path) as s:
            s.reset()
            s.stage("doomed")
            raise RuntimeError("boom")
    assert open(path, "rb").read() == b""


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_header_counts_into_committed_bytes(tmp_path, pkg):
    mod = PACKAGES[pkg][0]
    path = str(tmp_path / "out.csv")
    s = mod.TransactionalFileSink(path, header="h1,h2")
    s.reset()
    s.stage("1,2")
    marker = s.commit()
    assert open(path).read() == "h1,h2\n1,2\n"
    s2 = mod.TransactionalFileSink(path, header="h1,h2")
    s2.restore(marker)
    assert open(path).read() == "h1,h2\n1,2\n"


def test_empty_epoch_restores_to_an_empty_file(tmp_path):
    # Nothing committed and the file gone: recreated empty, as in JAX.
    for name, (mod, *_rest) in PACKAGES.items():
        path = tmp_path / f"{name}.csv"
        mod.TransactionalFileSink(str(path)).restore({"bytes": 0})
        assert path.read_bytes() == b""


@pytest.mark.parametrize("epochs", [[["a"], ["b", "c"], []],
                                    [[], ["x" * 50], ["y"] * 7],
                                    [["1,2,3"]] * 4])
def test_commit_sequences_equal_jax(tmp_path, epochs):
    """The same staged epochs through both sinks: the same file bytes and
    the same marker after every commit; ``close`` commits the tail."""
    got = {}
    for name, (mod, *_rest) in PACKAGES.items():
        path = tmp_path / f"{name}.csv"
        s = mod.TransactionalFileSink(str(path), formatter=str.upper)
        s.reset()
        markers = []
        for epoch in epochs:
            for rec in epoch:
                s(rec)
            assert s.pending == len(epoch)
            markers.append(s.commit())
        s.stage("tail")
        s.close()
        got[name] = (markers, s.commits, path.read_bytes())
    assert got["port"] == got["jax"]
    assert got["port"][2].endswith(b"TAIL\n")


# -- MultiSink: tests/test_dag.py's cases, both packages -----------------------


def _pair(mod, tmp_path, names=("a", "b")):
    return mod.MultiSink({n: mod.TransactionalFileSink(
        str(tmp_path / f"{n}.csv")) for n in names})


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_multisink_torn_tail_on_a_newer_marker_on_b(tmp_path, pkg):
    """A crash between two sub-commits (``dag.commit`` fires before each
    sub-append) leaves sink a with a tail past the checkpointed marker
    and b without: restore truncates a, keeps b, and the replay
    regenerates both."""
    mod, fl, injected, _ = PACKAGES[pkg]
    ms = _pair(mod, tmp_path)
    ms.reset()
    ms.stage("a", "a1")
    ms.stage("b", "b1")
    marker = ms.commit()
    ms.stage("a", "a2")
    ms.stage("b", "b2")
    assert ms.pending == 2
    fl.arm([{"point": "dag.commit", "at": 2, "times": 10_000}])
    with pytest.raises(injected):
        ms.commit()
    fl.disarm()
    assert (tmp_path / "a.csv").read_bytes() == b"a1\na2\n"  # torn
    assert (tmp_path / "b.csv").read_bytes() == b"b1\n"
    ms2 = _pair(mod, tmp_path)
    ms2.restore(marker)
    assert (tmp_path / "a.csv").read_bytes() == b"a1\n"  # truncated
    assert (tmp_path / "b.csv").read_bytes() == b"b1\n"  # kept
    ms2.stage("a", "a2")
    ms2.stage("b", "b2")
    assert ms2.commit() == ms2.state() == {"sinks": {
        "a": {"bytes": 6, "records": 2}, "b": {"bytes": 6, "records": 2}}}
    assert (tmp_path / "a.csv").read_bytes() == b"a1\na2\n"
    assert (tmp_path / "b.csv").read_bytes() == b"b1\nb2\n"


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_multisink_marker_ahead_of_file_is_loud(tmp_path, pkg):
    mod, _, _, corrupt = PACKAGES[pkg]
    ms = _pair(mod, tmp_path)
    ms.reset()
    ms.stage("a", "a1")
    ms.stage("b", "b1")
    marker = ms.commit()
    (tmp_path / "b.csv").write_bytes(b"")
    with pytest.raises(corrupt, match="b.csv"):
        _pair(mod, tmp_path).restore(marker)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_multisink_sink_added_since_checkpoint_resets(tmp_path, pkg):
    mod = PACKAGES[pkg][0]
    ms = _pair(mod, tmp_path)
    ms.reset()
    ms.stage("a", "a1")
    marker = ms.commit()
    ms3 = _pair(mod, tmp_path, ("a", "b", "c"))
    ms3.restore(marker)
    assert (tmp_path / "c.csv").read_bytes() == b""
    assert ms3["a"].committed_bytes == 3
    ms3.close()


def test_multisink_commit_points_hit_in_name_order(tmp_path):
    # dag.commit fires once per sub-sink, in sorted name order, in both
    # packages: the third hit is the third name's append.
    counts = {}
    for name, (mod, fl, injected, _) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        ms = _pair(mod, d, ("c", "a", "b"))
        ms.reset()
        for n in "abc":
            ms.stage(n, n * 3)
        fl.arm([{"point": "dag.commit", "at": 3}])
        with pytest.raises(injected):
            ms.commit()
        counts[name] = ([(d / f"{n}.csv").read_bytes() for n in "abc"],
                        fl.counts["dag.commit"])
        fl.disarm()
    assert counts["port"] == counts["jax"] == ([b"aaa\n", b"bbb\n", b""], 3)


def test_sink_fault_point_is_disarmed_free(tmp_path, monkeypatch):
    # With no plan, a commit never calls hit(): the guard is one
    # attribute check.
    calls = []
    monkeypatch.setattr(faults, "hit", lambda p: calls.append(p))
    s = sinks.TransactionalFileSink(str(tmp_path / "o.csv"))
    s.reset()
    s.stage("x")
    s.commit()
    ms = _pair(sinks, tmp_path)
    ms.reset()
    ms.stage("a", "y")
    ms.commit()
    assert calls == []
    assert (tmp_path / "o.csv").read_bytes() == b"x\n"
    assert (tmp_path / "a.csv").read_bytes() == b"y\n"


def test_first_commit_without_reset_keeps_staged_records(tmp_path):
    """Queue C6: a standalone sink's first commit starts the file afresh
    (an implicit ``reset()``). The JAX sink's reset also empties the
    staging buffer, so records staged before that first commit are lost
    and the marker counts none; the port's keeps them. The driver always
    resets a fresh sink before its loop, so driven runs are unaffected."""
    out = {}
    for name, (mod, *_rest) in PACKAGES.items():
        path = tmp_path / f"{name}.csv"
        s = mod.TransactionalFileSink(str(path), header="h")
        s.stage("x")
        s.stage("y")
        out[name] = (s.commit(), path.read_bytes())
    assert out["jax"] == ({"bytes": 2, "records": 0}, b"h\n")
    assert out["port"] == ({"bytes": 6, "records": 2}, b"h\nx\ny\n")
