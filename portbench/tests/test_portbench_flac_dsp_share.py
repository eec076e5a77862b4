"""``flac.dsp_device_share`` on the CPU profile of ``test_portbench_program_spans``
(a live Fleet with two FLAC stations): the host route's lanes counted on the
``aukit.flac.dsp`` records, the share 0% where every lane's DSP ran in
numpy (no card), 100% and 75% on given counts, and None without the
program's counters, as at a commit that keeps none."""

import pytest
from test_portbench_program_spans import TRACED, profiled, read, sums  # noqa: F401


def test_share_reads_the_dsp_records(profiled):  # noqa: F811
    view, cell, records = profiled
    counts = sums(records, TRACED)["aukit.flac.dsp"][2]
    assert counts["dsp_lanes_host"] > 0 and "dsp_lanes_device" not in counts
    assert read("flac.dsp_device_share", view, cell) == 0.0


@pytest.mark.parametrize("on_card,on_host,want", [(4, 0, 100.0), (3, 1, 75.0), (0, 0, None)])
def test_share_of_given_counts(profiled, monkeypatch, on_card, on_host, want):  # noqa: F811
    from portbench.harness import program_spans

    view, cell, _records = profiled
    counts = {"dsp_lanes_device": on_card, "dsp_lanes_host": on_host}
    monkeypatch.setattr(program_spans, "spans_per_tick", lambda trace, cell: {
        "aukit.flac.dsp": {"ms": 1.0, "self_ms": 1.0, "count": 1.0,
                           "counts": {k: v for k, v in counts.items() if v}}})
    assert read("flac.dsp_device_share", view, cell) == want


def test_share_is_none_without_the_programs_spans(profiled, monkeypatch):  # noqa: F811
    from portbench.harness import program_spans

    view, cell, _records = profiled
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert read("flac.dsp_device_share", view, cell) is None
