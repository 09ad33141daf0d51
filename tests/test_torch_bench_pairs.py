"""fgnn_tpu_torch.tools.bench_pairs: the pairs' summary, and no run
without a card."""
import pytest

from fgnn_tpu_torch.tools import bench_pairs


def _runs(other, this):
    return {side: [{"metrics": {"epoch_time": t, "peak_device_gib": 1.0}}
                   for t in times]
            for side, times in (("other", other), ("this", this))}


def test_summary_counts_wins_ties_and_quartiles():
    s = bench_pairs.summary(_runs([2.0, 2.2, 2.1, 2.3], [1.5, 2.2, 1.6, 2.4]))
    e = s["epoch_time"]
    assert (e["pairs"], e["this_won"], e["ties"]) == (4, 2, 1)
    assert s["other"]["epoch_time"]["median"] == pytest.approx(2.15)
    assert s["this"]["epoch_time"]["median"] == pytest.approx(1.9)
    assert e["median_difference"] == pytest.approx(0.25)
    assert e["other_quartile_distance"] == pytest.approx(2.225 - 2.075)
    assert s["this"]["peak_device_gib"]["median"] == 1.0


def test_no_card_no_run(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(bench_pairs, "timed", pytest.fail)
    rc = bench_pairs.main(["--other", str(tmp_path), "--cells",
                           "gcn_hbm_syn1M"])
    assert rc == 1 and "no CUDA device" in capsys.readouterr().err
